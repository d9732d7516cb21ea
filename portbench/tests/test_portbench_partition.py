"""The partition of a traced epoch's idle time by the program's ranges
(``partition.summarize``), the pending metrics that read it, and the run
that wires both into the harness, on made-up events and on the CPU."""

import argparse
from types import SimpleNamespace

import pytest

from portbench import partition, run, trace
from portbench.tests.cells import narrow_models, small_spec  # noqa: F401
from portbench.tests.test_portbench_yardstick import _Event

PENDING = ("tail_idle_ms.train", "window_edge_idle_ms.train",
           "replay_gap_ms.train", "round_trips_per_epoch.train")


def _cpu(n, s, e, c=0):
    return _Event(n=n, s=s, e=e, gpu=False, c=c)


def _gpu(n, s, e, c):
    return _Event(n=n, s=s, e=e, gpu=True, c=c)


# A window: the staging, a fill and a graph replay of two kernels, the
# fetch's copy, the host's work after it, an eager tail with its copy.
HARNESS = [_cpu("portbench.window", 0, 200), _cpu("portbench.epoch", 0, 180),
           _cpu("portbench.rank_barrier", 180, 200),
           _gpu("portbench.epoch", 7, 153, 0)]
LAUNCHES = [_cpu("cudaLaunchKernel", 6, 6.5, 1),
            _cpu("cudaGraphLaunch", 8, 9, 2),
            _cpu("cudaMemcpyAsync", 55, 56, 3),
            _cpu("cudaLaunchKernel", 100, 101, 4),
            _cpu("cudaMemcpyAsync", 150, 151, 5)]
KERNELS = [_gpu("void at::native::fill_kernel", 7, 8, 1),
           _gpu("sm90_xmma_fprop_implicit_gemm", 10, 20, 2),
           _gpu("void at::native::reduce_kernel", 22, 40, 2),
           _gpu("Memcpy DtoH (Device -> Pinned)", 56, 57, 3),
           _gpu("void at::native::elementwise_kernel", 110, 130, 4),
           _gpu("Memcpy DtoH (Device -> Pinned)", 152, 153, 5)]
RANGES = [_cpu("cs744.stage_epoch", 0, 5), _cpu("cs744.train_window", 5, 60),
          _cpu("cs744.window_dispatch", 5, 20),
          _cpu("cs744.window_fetch", 20, 60),
          _cpu("cs744.after_window", 60, 80),
          _cpu("cs744.tail_step", 80, 175)]
SHADOWS = [_gpu("cs744.window_dispatch", 7, 20, 0),
           _gpu("cs744.tail_step", 110, 153, 0)]


def test_ranges_and_shadows_leave_the_harness_numbers_as_they_were():
    plain = trace.summarize(HARNESS + LAUNCHES + KERNELS)
    got = partition.summarize(HARNESS + LAUNCHES + KERNELS + RANGES
                              + SHADOWS)
    for key in ("wall_us", "busy_us", "families", "kernels"):
        assert got[key] == plain[key], key
    assert got["busy_us"] == 51
    # Read as kernels, the shadows would have filled the gaps they span.
    swollen = trace.summarize(HARNESS + LAUNCHES + KERNELS + SHADOWS)
    assert swollen["busy_us"] > plain["busy_us"]


def test_gaps_named_by_the_innermost_range_around_their_launch():
    got = partition.summarize(HARNESS + LAUNCHES + KERNELS + RANGES
                              + SHADOWS)
    assert got["gaps"] == {
        "window_dispatch: idle before eager kernel": [7, 1],
        "window_dispatch: idle before graph replay": [4, 2],
        "window_fetch: idle before copy": [16, 1],
        "tail_step: idle before eager kernel": [53, 1],
        "tail_step: idle before copy": [22, 1],
        "rank_barrier: idle before window end": [47, 1]}
    assert got["partition"] == {"tail": 75, "replay": 4, "window_edge": 23,
                                "harness": 47}
    assert sum(got["partition"].values()) == got["wall_us"] - got["busy_us"]
    assert got["ranges"]["train_window"] == [1, 55, 0]
    assert got["ranges"]["window_dispatch"] == [1, 15, 15]
    assert got["ranges"]["tail_step"] == [1, 95, 95]
    assert got["misstamped"] == 0


def test_a_drift_between_the_clocks_moves_no_gap_to_another_part():
    """Device times 30% early by the end: the tail's first gap now centres
    under the window's fetch, but its launch is still under the tail."""
    drifted = [_gpu(k.n, 0.7 * k.s, 0.7 * k.e, k.c) for k in KERNELS]
    got = partition.summarize(HARNESS + LAUNCHES + drifted + RANGES)
    want = partition.summarize(HARNESS + LAUNCHES + KERNELS + RANGES)
    assert {k: v[1] for k, v in got["gaps"].items()} == \
        {k: v[1] for k, v in want["gaps"].items()}
    assert got["partition"] == pytest.approx(
        {"tail": 52.5, "replay": 2.8, "window_edge": 16.1, "harness": 92.9})
    assert got["misstamped"] == 3


def test_without_the_programs_ranges_the_gaps_are_the_harness_gaps():
    """But for the last gap, named by the window's end where the harness
    names it by its middle."""
    events = HARNESS + LAUNCHES + KERNELS
    got = partition.summarize(events)
    want = trace.summarize(events)["gaps"]
    want["rank_barrier: idle before window end"] = \
        want.pop("epoch: idle before window end")
    assert got["gaps"] == want
    assert got["ranges"] == {}
    assert sum(got["partition"].values()) == got["wall_us"] - got["busy_us"]


def test_counts_kernels_stamped_before_their_launch():
    early = [_gpu("void at::native::fill_kernel", 1, 2, 2),   # 7 us early
             _gpu("void at::native::fill_kernel", 3, 4, 2)]   # 5 us: not
    got = partition.summarize(HARNESS + LAUNCHES + KERNELS + RANGES + early)
    assert got["misstamped"] == 1


def _ctx(*summaries):
    return SimpleNamespace(traces=list(summaries), trace=summaries[0])


@pytest.fixture(scope="module")
def pending():
    return run.load_metrics(partition.PENDING)


def test_pending_metrics_read_a_summary(pending):
    assert set(pending) == set(PENDING)
    a = partition.summarize(HARNESS + LAUNCHES + KERNELS + RANGES)
    a["trace_counts"] = {"host_round_trips": 2, "replays": 5, "captures": 0,
                         "eager_steps": 1, "restages": 0}
    b = dict(a, partition={"tail": 25, "replay": 8, "window_edge": 3,
                           "harness": 0})
    got = {n: pending[n].read(_ctx(a, b)) for n in PENDING}
    assert got == {"tail_idle_ms.train": 0.05,
                   "window_edge_idle_ms.train": 0.013,
                   "replay_gap_ms.train": 0.006,
                   "round_trips_per_epoch.train": 2.0}
    idle_ms = (a["wall_us"] - a["busy_us"]) / 1e3
    one = {n: pending[n].read(_ctx(a)) for n in PENDING[:3]}
    assert sum(one.values()) + a["partition"]["harness"] / 1e3 == \
        pytest.approx(idle_ms)


def test_pending_metrics_read_nothing_from_a_program_without_ranges(pending):
    old = trace.summarize(HARNESS + LAUNCHES + KERNELS)
    old.update(bnpool_runs={}, collectives_per_step={})
    assert all(pending[n].read(_ctx(old)) is None for n in PENDING)


def test_pending_metrics_are_declared_as_the_harness_reads_them(pending):
    for name, reader in pending.items():
        assert reader.MOVES == "train_images_per_s"
        assert reader.SOURCE == "device_trace"
        assert reader.BETTER == "lower"
        assert reader.LAYER in ("host loop (train/loop.py)",
                                "window (train/step.py TrainWindow, "
                                "GraphStep)")


class _Trainer:
    """Enough of a Trainer for ``traced_epoch``: an epoch of one window and
    a tail, with ``extra`` added to its counts."""

    rank, group = 0, None
    device = SimpleNamespace(type="cpu")

    def __init__(self, **extra):
        self.counts = dict.fromkeys(
            ("host_round_trips", "replays", "captures", "eager_steps",
             "restages"), 0)
        self.extra = extra

    def trace_counts(self):
        return dict(self.counts)

    def train_model(self, epoch):
        from cs744_ddp_tpu_torch.obs.telemetry import profiler_range
        with profiler_range("window_dispatch"):
            pass
        for key, n in dict({"host_round_trips": 2, "replays": 4,
                            "eager_steps": 1}, **self.extra).items():
            self.counts[key] += n


@pytest.mark.parametrize("extra", [{}, {"captures": 1}, {"restages": 1},
                                   {"host_round_trips": 1}])
def test_traced_epoch_refuses_an_unsteady_epoch(extra):
    """A capture, a restaging or a round trip beyond one a window and one
    an eager step would put their work in the parts."""
    trainer = _Trainer(**extra)
    if not extra:
        got = partition.traced_epoch(trainer, 1, lambda *a: False)
        assert got["trace_counts"]["host_round_trips"] == 2
        assert got["ranges"]["window_dispatch"][0] == 1
        assert got["harness_agrees"] is True
        return
    with pytest.raises(RuntimeError, match="not a steady one"):
        partition.traced_epoch(trainer, 1, lambda *a: False)


def _args(seed=2 ** 31 + 13, seconds=0.2):
    return argparse.Namespace(seed=seed, seconds=seconds, trace=1)


def test_wired_run_reports_the_pending_metrics(narrow_models):
    before = run.load_metrics, run.measure
    with partition.wired():
        res = run.measure(small_spec(), _args(), device_type="cpu")
    assert (run.load_metrics, run.measure) == before
    assert res["correct"] is True, res["checks"]
    metrics = res["metrics"]
    assert set(PENDING) <= set(metrics)
    # 72 images in batches of 16: one window of four and an 8-row tail.
    assert metrics["round_trips_per_epoch.train"]["value"] == 2.0
    # No device timeline on the CPU: the epoch is one gap to the end.
    for name in PENDING[:3]:
        assert metrics[name]["value"] == 0.0


def test_wired_run_over_four_gloo_ranks():
    """The four-chip cell's path: every spawned rank runs the wired traced
    epoch."""
    spec = small_spec(world=4, batch=8, images=40, cell="vgg11_bf16_ddp_w4")
    spec["traffic"]["precision"] = "f32"
    spec["cell"]["limits"] = small_spec()["cell"]["limits"]
    with partition.wired():
        res = run.measure(spec, _args(seconds=0.1), device_type="cpu",
                          deadline_s=240)
    assert res["correct"] is True, res["checks"]
    # Ten images a rank in batches of two: one window of five, no tail.
    assert res["metrics"]["round_trips_per_epoch.train"]["value"] == 1.0
    assert res["metrics"]["tail_idle_ms.train"]["value"] == 0.0
