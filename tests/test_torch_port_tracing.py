"""The port's profiler ranges and trace counts (obs/telemetry.py's
``profiler_range``, train/loop.py's windowed epoch, train/step.py's
``GraphStep``), on the CPU, and one test marked ``gpu`` on the card.

  * A windowed epoch under ``torch.profiler`` holds ``cs744.stage_epoch``
    and ``cs744.tail_step`` once, and ``cs744.window_dispatch``,
    ``cs744.window_fetch`` and ``cs744.after_window`` once a window, the
    first two inside the ``train_window`` span's range; no range leaves a
    shadow on a device timeline.
  * ``Trainer.trace_counts()`` differences over an epoch: windows + 1
    round trips, one eager window step a full batch, one eager tail step,
    no capture on the CPU, a restage only where the order changes.
  * With no profiler, spans and ranges are the shared no-op span; the
    JSONL stream is the same with a profiler on.
  * The run-directory report loads with torch blocked.
  * On the card (``gpu``): one capture in the first epoch and none after,
    and no ``cs744.`` event on the device's timeline.  Run it there with
    ``python -m pytest --noconftest -p no:cacheprovider -m gpu -rs
    tests/test_torch_port_tracing.py``.
"""

import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cs744_ddp_tpu_torch.models import vgg as tvgg
from cs744_ddp_tpu_torch.obs import telemetry as ttel
from cs744_ddp_tpu_torch.ops import sgd as tsgd
from cs744_ddp_tpu_torch.train.loop import Trainer

import torch_dist_worker as worker

REPO = Path(__file__).resolve().parents[1]
# 320 training images in batches of 12: 26 full batches, two windows (20
# and 6 steps) and an 8-row tail.
BATCH, FULL, WINDOWS = 12, 26, 2


def _trainer(**kw):
    tvgg.CFG["VGGT"] = worker.NARROW_VGG
    args = dict(global_batch=BATCH, data_dir=worker.ASSETS, device="cpu",
                augment=False, sgd_cfg=tsgd.SGDConfig(lr=0.01),
                limit_eval_batches=1, log=lambda s: None)
    args.update(kw)
    return Trainer("vggt", "single", **args)


def _ranges(prof):
    """The ``cs744.`` ranges of a profile: (start, end, name), by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(ttel.PROFILER_PREFIX):
            start = e.start_ns()
            out.append((start, start + e.duration_ns(),
                        name[len(ttel.PROFILER_PREFIX):]))
    return sorted(out)


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.fixture(scope="module")
def traced_epoch():
    trainer = _trainer()
    trainer.train_model(0)
    before = trainer.trace_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_model(1)
    return trainer, before, trainer.trace_counts(), _ranges(prof)


def test_epoch_ranges_once_a_window_and_once_an_epoch(traced_epoch):
    *_, ranges = traced_epoch
    counts = Counter(name for _, _, name in ranges)
    for name in ("window_dispatch", "window_fetch", "after_window",
                 "train_window"):
        assert counts[name] == WINDOWS, name
    assert counts["stage_epoch"] == counts["tail_step"] == 1


def test_epoch_ranges_nest_as_the_loop_runs(traced_epoch):
    *_, ranges = traced_epoch
    by = {}
    for r in ranges:
        by.setdefault(r[2], []).append(r)
    for win, disp, fetch, after in zip(by["train_window"],
                                       by["window_dispatch"],
                                       by["window_fetch"],
                                       by["after_window"]):
        assert _inside(disp, win) and _inside(fetch, win)
        assert not _inside(after, win)
        assert disp[1] <= fetch[0] <= fetch[1] <= after[0]
    (stage,), (tail,) = by["stage_epoch"], by["tail_step"]
    assert stage[1] <= by["window_dispatch"][0][0]
    assert by["after_window"][-1][1] <= tail[0]
    # The tail's own fetch is under tail_step, not a window's fetch.
    assert not any(_inside(f, tail) for f in by["window_fetch"])


def test_trace_counts_over_an_epoch(traced_epoch):
    _, before, after, _ = traced_epoch
    diff = {k: after[k] - before[k] for k in after}
    assert diff == {"host_round_trips": WINDOWS + 1, "replays": FULL,
                    "captures": 0, "eager_steps": 1, "restages": 0}


@pytest.mark.parametrize("reshuffle,restages", [(False, 0), (True, 1)])
def test_restage_counted_where_the_order_changes(reshuffle, restages):
    trainer = _trainer(limit_train_batches=3,
                       reshuffle_each_epoch=reshuffle)
    first = trainer.trace_counts()
    trainer.train_model(0)
    second = trainer.trace_counts()
    trainer.train_model(1)
    third = trainer.trace_counts()
    assert first == dict.fromkeys(first, 0)
    assert second["restages"] == 1 and second["replays"] == 3
    assert third["restages"] - second["restages"] == restages
    # No tail under the limit: windows only, one fetch each.
    assert third["eager_steps"] == 0 and third["host_round_trips"] == 2


def test_per_step_path_counts_eager_steps():
    trainer = _trainer(limit_train_batches=3, profile_phases=True)
    trainer.train_model(0)
    counts = trainer.trace_counts()
    assert counts["eager_steps"] == 3 and counts["replays"] == 0
    # A forward and a step fetch a batch.
    assert counts["host_round_trips"] == 6


def test_no_profiler_no_range():
    assert not torch._C._autograd._profiler_enabled()
    assert ttel.profiler_range("window_dispatch") is ttel._NULL_SPAN
    assert ttel.NULL.span("train_window", start=0) is ttel._NULL_SPAN


@pytest.mark.parametrize("recorder", ["null", "memory"])
def test_spans_are_ranges_under_a_profiler(recorder):
    tel = ttel.NULL if recorder == "null" else ttel.Telemetry()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tel.span("outer", batches=2):
            with ttel.profiler_range("inner"):
                torch.ones(4).add_(1)
        with pytest.raises(ValueError):
            with tel.span("failed"):
                raise ValueError("the range still closes")
    outer, inner, failed = _ranges(prof)
    assert (outer[2], inner[2], failed[2]) == ("outer", "inner", "failed")
    assert _inside(inner, outer) and outer[1] <= failed[0]
    assert all(e.device_type() != torch.autograd.DeviceType.CUDA
               for e in prof.profiler.kineto_results.events()
               if e.name().startswith(ttel.PROFILER_PREFIX))
    assert ttel.profiler_range("after") is ttel._NULL_SPAN


def test_jsonl_stream_is_the_same_with_a_profiler_on():
    def records(profiled):
        tel = ttel.Telemetry()
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                with tel.span("train_window", start=0, batches=20):
                    tel.counter("host_round_trips", 1, site="window_drain")
        else:
            with tel.span("train_window", start=0, batches=20):
                tel.counter("host_round_trips", 1, site="window_drain")
        return [{k: v for k, v in r.items() if k not in ("t", "dur_s")}
                for r in tel.records]

    assert records(True) == records(False)


def test_report_loads_with_torch_blocked():
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "from cs744_ddp_tpu_torch.obs import report, telemetry\n"
            "assert telemetry.profiler_range('x') is telemetry._NULL_SPAN\n"
            "assert telemetry.NULL.span('x') is telemetry._NULL_SPAN\n"
            "print('loaded', report.__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "loaded cs744_ddp_tpu_torch.obs.report" in out.stdout


@pytest.mark.gpu
def test_on_the_card_ranges_leave_no_device_shadow():
    """On the card the window is replays of one captured graph: one capture
    in the first epoch and none after, one replay a full batch, and no
    ``cs744.`` event on the device's timeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the window is a CUDA graph)")
    trainer = _trainer(device="cuda")
    trainer.train_model(0)
    before = trainer.trace_counts()
    assert before["captures"] == 1 and before["replays"] == FULL
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_model(1)
    after = trainer.trace_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "host_round_trips": WINDOWS + 1, "replays": FULL, "captures": 0,
        "eager_steps": 1, "restages": 0}
    events = list(prof.profiler.kineto_results.events())
    on_device = [e.name() for e in events
                 if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert on_device
    assert not [n for n in on_device if n.startswith(ttel.PROFILER_PREFIX)]
    counts = Counter(name for _, _, name in _ranges(prof))
    assert counts["window_dispatch"] == counts["after_window"] == WINDOWS
