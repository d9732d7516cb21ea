"""The port's data modules (cs744_ddp_tpu_torch/data) against the reference
package's, on the CPU."""

import os

import numpy as np
import pytest
import torch

from cs744_ddp_tpu.data import augment as jaug
from cs744_ddp_tpu.data import cifar10 as jcifar
from cs744_ddp_tpu.data import sharding as jsharding
from cs744_ddp_tpu_torch.data import augment as taug
from cs744_ddp_tpu_torch.data import cifar10 as tcifar
from cs744_ddp_tpu_torch.data import sharding as tsharding

ASSETS = os.path.join(os.path.dirname(__file__), "assets")


@pytest.mark.parametrize("n,seed", [(64, 0), (37, 1), (200, 7)])
def test_synthetic_split_is_byte_identical(n, seed):
    a, b = tcifar._synthetic_split(n, seed), jcifar._synthetic_split(n, seed)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
    assert tcifar._class_templates().tobytes() == \
        jcifar._class_templates().tobytes()
    for name in ("MEAN", "STD"):
        np.testing.assert_array_equal(getattr(tcifar, name),
                                      getattr(jcifar, name))
    assert (tcifar.TRAIN_SIZE, tcifar.TEST_SIZE) == \
        (jcifar.TRAIN_SIZE, jcifar.TEST_SIZE)


def test_pickle_loader_reads_fixture_identically():
    t_train, t_test, t_real = tcifar.load(ASSETS)
    j_train, j_test, j_real = jcifar.load(ASSETS)
    assert t_real and j_real
    for a, b in zip(t_train + t_test, j_train + j_test):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_load_falls_back_to_synthetic(tmp_path):
    train, test, real = tcifar.load(str(tmp_path))
    assert not real
    assert train.images.shape == (50_000, 32, 32, 3)
    assert test.labels.shape == (10_000,)


@pytest.mark.parametrize("n", [50_000, 1003, 5])
@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_global_epoch_indices_match(n, world):
    for epoch, reshuffle in ((0, False), (3, True)):
        kw = dict(seed=0, epoch=epoch, reshuffle_each_epoch=reshuffle)
        np.testing.assert_array_equal(
            tsharding.global_epoch_indices(n, world, **kw),
            jsharding.global_epoch_indices(n, world, **kw))
    np.testing.assert_array_equal(
        tsharding.canonical_epoch_order(n, pad_to=2 * n + 3),
        jsharding.canonical_epoch_order(n, pad_to=2 * n + 3))


def test_normalize_matches():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    got = taug.normalize(torch.from_numpy(u8)).numpy()
    np.testing.assert_allclose(got, np.asarray(jaug.normalize(u8)),
                               rtol=0, atol=1e-6)


def test_crop_flip_equals_numpy_pad_crop_flip():
    rng = np.random.default_rng(1)
    n = 16
    u8 = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    offs = rng.integers(0, 9, (n, 2))
    flips = rng.random(n) < 0.5
    offs[0], offs[1], flips[:2] = (0, 0), (8, 8), (True, False)
    got = taug.crop_flip(torch.from_numpy(u8), torch.from_numpy(offs),
                         torch.from_numpy(flips)).numpy()
    padded = np.pad(u8, ((0, 0), (4, 4), (4, 4), (0, 0)))
    for i in range(n):
        r, c = offs[i]
        want = padded[i, r:r + 32, c:c + 32]
        if flips[i]:
            want = want[:, ::-1]
        np.testing.assert_array_equal(got[i], want)


def test_augment_is_seeded_and_in_range():
    """The draw is keyed by (seed, rank, epoch, batch index): the same key
    gives the same batch, another batch index another one."""
    u8 = torch.from_numpy(tcifar._synthetic_split(8, 0).images.copy())
    key = taug.stream_key(5, 0)
    epoch, idx = torch.tensor(0), torch.tensor(3)
    a = taug.augment(u8, key, epoch, idx)
    b = taug.augment(u8, key, torch.tensor(0), torch.tensor(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, taug.augment(u8, key, epoch, torch.tensor(4)))
    offsets, flips = taug.draws(8, key, epoch, idx)
    want = taug.normalize(taug.crop_flip(u8, offsets, flips))
    torch.testing.assert_close(a, want, rtol=0, atol=0)
    assert a.shape == (8, 32, 32, 3) and a.dtype == torch.float32
    lo = taug.normalize(torch.zeros((1, 1, 1, 3), dtype=torch.uint8))
    hi = taug.normalize(torch.full((1, 1, 1, 3), 255, dtype=torch.uint8))
    assert bool(((a >= lo.min()) & (a <= hi.max())).all())
    x = taug.to_model_input(a)
    assert x.shape == (8, 3, 32, 32)
    assert x.is_contiguous(memory_format=torch.channels_last)
