"""The port's native host loader (cs744_ddp_tpu_torch/data/native.py), its
staging arena, the staging supervisor (ft/supervisor.py) and
``cifar10.has_real_data``, on the CPU.

  * Every wrapper byte-equal to the reference package's
    ``cs744_ddp_tpu.data.native`` on the same seeded inputs (``out=``
    included) and to the port's own NumPy versions; the f32 outputs equal
    the device path's ``normalize_affine`` bit for bit.
  * No fallback: a source that does not compile, a wrong ``fl_version``
    or a missing compiler raises, and so does every wrapper when the
    library cannot be had.
  * ``StagingArena`` round-robins its slots and fences each (a fake event
    records its ``synchronize`` calls); fewer than 2 slots are refused.
  * The supervisor's ``Watchdog``, ``call_with_retry`` and checksums
    behave as the reference's (tests/test_ft.py's cases, on both).
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch

from cs744_ddp_tpu.data import cifar10 as jcifar
from cs744_ddp_tpu.data import native as jnative
from cs744_ddp_tpu.ft import supervisor as jsup
from cs744_ddp_tpu_torch.data import augment as aug
from cs744_ddp_tpu_torch.data import cifar10 as tcifar
from cs744_ddp_tpu_torch.data import native
from cs744_ddp_tpu_torch.ft import supervisor as tsup


def _inputs(seed, n=100, k=37):
    rng = np.random.default_rng(seed)
    ds = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    idx = rng.integers(0, n, k)
    offsets = rng.integers(0, 9, (k, 2), dtype=np.int32)
    flips = rng.integers(0, 2, k, dtype=np.uint8)
    return ds, idx, offsets, flips


# name -> (port call, reference call, NumPy reference) on (ds, idx, off, fl)
WRAPPERS = {
    "gather": (lambda d, i, o, f: native.gather(d, i),
               lambda d, i, o, f: jnative.gather(d, i),
               lambda d, i, o, f: native._np_gather(d, i)),
    "augment": (lambda d, i, o, f: native.augment(d[i], o, f),
                lambda d, i, o, f: jnative.augment(d[i], o, f),
                lambda d, i, o, f: native._np_augment(d[i], o, f)),
    "augment_u8": (lambda d, i, o, f: native.augment_u8(d[i], o, f),
                   lambda d, i, o, f: jnative.augment_u8(d[i], o, f),
                   lambda d, i, o, f: native._np_augment_u8(d[i], o, f)),
    "gather_augment_u8": (
        lambda d, i, o, f: native.gather_augment_u8(d, i, o, f),
        lambda d, i, o, f: jnative.gather_augment_u8(d, i, o, f),
        lambda d, i, o, f: native._np_gather_augment_u8(d, i, o, f)),
    "normalize": (lambda d, i, o, f: native.normalize(d[i]),
                  lambda d, i, o, f: jnative.normalize(d[i]),
                  lambda d, i, o, f: native._np_normalize(d[i])),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_is_byte_equal_to_reference_and_numpy(name, seed):
    """Exact: the same library source, the same arguments."""
    assert jnative.available()
    args = _inputs(seed)
    port, ref, plain = WRAPPERS[name]
    got = port(*args)
    want = ref(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == plain(*args).tobytes()


@pytest.mark.parametrize("name", ["gather", "augment_u8", "gather_augment_u8"])
def test_out_is_written_in_place_as_the_reference_writes_it(name):
    ds, idx, off, fl = _inputs(3)
    k = len(idx)
    arena = np.full((2, k, 32, 32, 3), 7, np.uint8)
    ref_out = np.zeros((k, 32, 32, 3), np.uint8)
    call = {"gather": lambda m, out: m.gather(ds, idx, out=out),
            "augment_u8": lambda m, out: m.augment_u8(ds[idx], off, fl,
                                                      out=out),
            "gather_augment_u8": lambda m, out: m.gather_augment_u8(
                ds, idx, off, fl, out=out)}[name]
    row = arena[1]
    assert call(native, row) is row
    call(jnative, ref_out)
    np.testing.assert_array_equal(arena[1], ref_out)
    assert (arena[0] == 7).all()            # the other row is untouched


@pytest.mark.parametrize("bad", [
    np.zeros((37, 32, 32, 3), np.float32),   # dtype
    np.zeros((36, 32, 32, 3), np.uint8),     # rows
    np.zeros((37, 32, 32, 6), np.uint8)[..., ::2],   # strided view
    None])                                   # read-only
def test_out_is_checked_and_never_copied(bad):
    ds, idx, off, fl = _inputs(4)
    if bad is None:
        bad = np.zeros((len(idx), 32, 32, 3), np.uint8)
        bad.setflags(write=False)
    for call in (lambda: native.gather(ds, idx, out=bad),
                 lambda: native.augment_u8(ds[idx], off, fl, out=bad),
                 lambda: native.gather_augment_u8(ds, idx, off, fl,
                                                  out=bad)):
        with pytest.raises(ValueError, match="out must be"):
            call()


def test_inputs_are_checked_before_a_pointer_is_passed():
    ds, idx, off, fl = _inputs(5)
    with pytest.raises(IndexError, match="indices"):
        native.gather(ds, np.array([0, 100]))
    with pytest.raises(IndexError, match="indices"):
        native.gather_augment_u8(ds, np.array([-1]), off[:1], fl[:1])
    with pytest.raises(ValueError, match="offsets"):
        native.augment(ds[:2], np.array([[0, 9], [0, 0]]), fl[:2])
    with pytest.raises(ValueError, match="offsets must be"):
        native.augment_u8(ds[:2], off[:3], fl[:3])
    with pytest.raises(ValueError, match="uint8"):
        native.normalize(ds[:2].astype(np.float32))


def test_device_affine_normalize_is_the_library_f32_bit_for_bit():
    """Every pixel value in every channel: the window's normalize on the
    device (train/step.py, ``augment="host_u8"``) and the library's f32
    agree exactly; the device path's (x/255 - mean)/std stays within an
    f32 ulp of them."""
    img = np.zeros((1, 32, 32, 3), np.uint8)
    img.reshape(-1, 3)[:256] = np.arange(256, dtype=np.uint8)[:, None]
    want = native.normalize(img)
    x = torch.from_numpy(img)
    got = aug.normalize_affine(x, aug.affine_stats("cpu")).numpy()
    assert got.tobytes() == want.tobytes()
    np.testing.assert_allclose(aug.normalize(x).numpy(), want, rtol=0,
                               atol=1e-6)


# -- the build: no silent fallback -------------------------------------------

def _source_copy(tmp_path, edit=None):
    src = tmp_path / "fastloader.cpp"
    text = native.SOURCE.read_text()
    if edit is not None:
        text = edit(text)
    src.write_text(text)
    return src


def test_build_names_the_library_by_its_source_and_leaves_no_temp(tmp_path):
    src = _source_copy(tmp_path)
    out = native.build(src, tmp_path / "kernels")
    assert out == native.library_path(src, tmp_path / "kernels")
    assert out.name.startswith("libfastloader-") and out.exists()
    assert sorted(p.name for p in out.parent.iterdir()) == [out.name]
    lib = native.load_library(src, tmp_path / "kernels")
    assert lib.fl_version() == native.EXPECTED_VERSION
    assert native.load_library(src, tmp_path / "kernels") is lib
    edited = _source_copy(tmp_path, lambda t: t + "\n// edited\n")
    assert native.library_path(edited, tmp_path / "kernels") != out


def test_a_source_that_does_not_compile_raises_with_the_compiler_output(
        tmp_path):
    src = _source_copy(tmp_path, lambda t: t.replace(
        "int fl_version() { return 3; }", "int fl_version() { return 3 }"))
    with pytest.raises(native.NativeLoaderError, match="error"):
        native.load_library(src, tmp_path / "kernels")
    assert not any((tmp_path / "kernels").iterdir())


def test_a_wrong_abi_version_raises(tmp_path):
    src = _source_copy(tmp_path, lambda t: t.replace(
        "int fl_version() { return 3; }", "int fl_version() { return 2; }"))
    with pytest.raises(native.NativeLoaderError, match="ABI version 2"):
        native.load_library(src, tmp_path / "kernels")


def test_no_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(native.NativeLoaderError, match="not found"):
        native.load_library(_source_copy(tmp_path), tmp_path / "kernels")


def test_every_wrapper_raises_when_the_library_cannot_be_had(monkeypatch):
    """Nothing falls back to the NumPy versions."""
    def broken(*a, **k):
        raise native.NativeLoaderError("no library")
    monkeypatch.setattr(native, "load_library", broken)
    ds, idx, off, fl = _inputs(6)
    for name, (port, _, _) in WRAPPERS.items():
        with pytest.raises(native.NativeLoaderError, match="no library"):
            port(ds, idx, off, fl)


def test_the_makefile_flags_are_the_build_flags():
    """The library the port builds is native/Makefile's."""
    make = (native.SOURCE.parent / "Makefile").read_text()
    assert "CXXFLAGS ?= " + " ".join(f for f in native.CXX_FLAGS
                                     if f != "-shared") in make
    assert "-shared" in make and "-lpthread" in make


# -- the staging arena --------------------------------------------------------

class FakeEvent:
    def __init__(self, log, name, delay=0.0):
        self.log, self.name, self.delay = log, name, delay

    def synchronize(self):
        time.sleep(self.delay)
        self.log.append(self.name)


def test_arena_round_robins_and_fences_each_slot():
    arena = native.StagingArena(3, 2, 4)
    assert arena.nslots == 3 and arena.chunk_batches == 2
    log = []
    slots = []
    for i in range(3):
        slot, buf = arena.acquire()
        slots.append(slot)
        assert buf.shape == (2, 4, 32, 32, 3) and buf.dtype == np.uint8
        buf[:] = slot                      # the tensor holds what was written
        assert (arena.tensor(slot).numpy() == slot).all()
        assert np.shares_memory(buf, arena.buffer(slot))
        arena.retire(slot, FakeEvent(log, f"copy{slot}"))
    assert slots == [0, 1, 2] and log == []
    assert arena.acquire()[0] == 0 and log == ["copy0"]
    assert arena.acquire()[0] == 1 and log == ["copy0", "copy1"]
    arena.retire(1, None)                  # nothing in flight: no wait
    assert arena.acquire()[0] == 2 and log == ["copy0", "copy1", "copy2"]
    assert arena.acquire()[0] == 0 and log == ["copy0", "copy1", "copy2"]
    assert not arena.tensor(0).is_pinned()


def test_arena_fence_watchdog_reports_a_slow_transfer():
    arena = native.StagingArena(2, 1, 1)
    log, overran = [], []
    arena.retire(0, FakeEvent(log, "slow", delay=0.15))
    assert arena.acquire(fence_timeout_s=0.02,
                         on_timeout=overran.append)[0] == 0
    assert log == ["slow"] and len(overran) == 1 and overran[0] >= 0.02


def test_arena_refuses_fewer_than_two_slots():
    with pytest.raises(ValueError, match=">= 2 slots"):
        native.StagingArena(1, 5, 8)
    with pytest.raises(ValueError, match=">= 2 slots"):
        jnative.StagingArena(1, 5, 8)


# -- the supervisor, against the reference's ---------------------------------

@pytest.mark.parametrize("sup", [tsup, jsup], ids=["port", "reference"])
def test_watchdog_fires_once_and_only_on_overrun(sup):
    fired = []
    with sup.Watchdog(0.02, on_timeout=fired.append) as wd:
        time.sleep(0.15)
        body_done = True
    assert body_done and wd.fired and len(fired) == 1 and fired[0] >= 0.02
    with sup.Watchdog(5.0, on_timeout=fired.append) as wd:
        pass
    assert not wd.fired
    with sup.Watchdog(None, on_timeout=fired.append):
        pass
    assert len(fired) == 1


def _retry_trace(sup, fail_times, attempts):
    calls, retries, naps = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) <= fail_times:
            raise OSError(f"transient {len(calls)}")
        return "ok"

    try:
        out = sup.call_with_retry(
            flaky, attempts=attempts, backoff_base_s=0.05,
            on_retry=lambda a, e: retries.append((a, str(e))),
            sleep=naps.append)
    except OSError as e:
        out = f"raised {e}"
    return out, len(calls), retries, naps


@pytest.mark.parametrize("fail_times,attempts", [(0, 1), (2, 4), (3, 3)])
def test_call_with_retry_matches_reference(fail_times, attempts):
    got = _retry_trace(tsup, fail_times, attempts)
    assert got == _retry_trace(jsup, fail_times, attempts)
    if fail_times == 2:
        assert got == ("ok", 3, [(0, "transient 1"), (1, "transient 2")],
                       [0.05, 0.1])
    for sup in (tsup, jsup):
        with pytest.raises(ValueError, match="attempts"):
            sup.call_with_retry(lambda: 1, attempts=0, backoff_base_s=0.0)


def test_checksums_match_reference_and_catch_one_flipped_byte():
    rows = [np.arange(64, dtype=np.uint8).reshape(8, 8) + i
            for i in range(3)]
    sums = tsup.batch_checksums(rows)
    assert sums == jsup.batch_checksums(rows)
    assert tsup.verify_checksums(rows, sums) == []
    rows[1][3, 4] ^= 0x40
    assert tsup.verify_checksums(rows, sums) == \
        jsup.verify_checksums(rows, sums) == [1]
    rows[1][3, 4] ^= 0x40
    assert tsup.verify_checksums(rows, sums) == []
    assert issubclass(tsup.StagingStalled, RuntimeError)


# -- has_real_data -----------------------------------------------------------

def test_has_real_data_is_the_reference_check(tmp_path):
    assert not tcifar.has_real_data(str(tmp_path))
    assert tcifar.has_real_data(str(tmp_path)) == \
        jcifar.has_real_data(str(tmp_path))
    os.makedirs(tmp_path / "cifar-10-batches-py")
    assert tcifar.has_real_data(str(tmp_path))
    assert jcifar.has_real_data(str(tmp_path))
    shutil.rmtree(tmp_path / "cifar-10-batches-py")
    assert not tcifar.has_real_data(str(tmp_path))
