r"""What does ``--telemetry-out`` cost the windowed step on the card?

    python -m cs744_ddp_tpu_torch.utils.profile_telemetry \
        [--precision f32 bf16] [--steps 100] [--pairs 2]

For each precision: three VGG-11 ``allreduce`` Trainers on a world-1 group
(batch 256, augmentation on, the windowed path with the metric ring): two
with telemetry off (``NULL``; the second, ``control``, tells the spread
between two instances from the recorder's cost) and one writing a run
directory in a temporary directory (``Telemetry(dir)``, as
``--telemetry-out`` does).  Each trains one epoch of ``--steps`` steps
first (warm-up and capture); then whole epochs in turns (off, on, control,
control, on, off, ``--pairs`` times), and each epoch's steady step is the
mean of its steps 21.. as the timers record them (the host clock from a
window's launch to its one fetch).  Beside them: the host round trips and
the bnpool kernels' runs (counted on the device) of one epoch each way,
which telemetry must not change.

Run it in a process that has started no profiler: a ``torch.profiler``
session leaves the CUDA-event and host timings that follow it slower.
One JSON line per precision, then a line per precision for reading, with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile

import torch

from ..obs import NULL, Telemetry
from ..ops import bnpool
from ..train import loop

BATCH = 256


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"{torch.cuda.get_device_name(0)}, power limit unread ({e})"


def epoch(trainer: loop.Trainer, n: int) -> dict:
    """Epoch ``n`` trained: its steady step ms, host round trips and
    kernel runs."""
    trips = trainer.host_round_trips
    bnpool.reset_launch_counts()
    timers = trainer.train_model(n)
    torch.cuda.synchronize()
    runs = {k: v for k, v in bnpool.executed_counts().items() if v}
    return {"ms": 1e3 * statistics.mean(timers.steady_step_times),
            "round_trips": trainer.host_round_trips - trips, "runs": runs}


def measure(precision: str, steps: int, pairs: int, out_dir: str) -> dict:
    telemetry = Telemetry(out_dir)
    trainers = {
        name: loop.Trainer("vgg11", "allreduce", precision=precision,
                           global_batch=BATCH, limit_train_batches=steps,
                           log=lambda s: None, telemetry=tel)
        for name, tel in (("off", NULL), ("on", telemetry),
                          ("control", NULL))}
    for tr in trainers.values():
        epoch(tr, 0)
    got = {name: [] for name in trainers}
    order = ["off", "on", "control", "control", "on", "off"] * pairs
    for i, name in enumerate(order):
        got[name].append(epoch(trainers[name], 1 + i))
    telemetry.finalize(global_batch=BATCH)
    ms = {name: [e["ms"] for e in runs] for name, runs in got.items()}
    mean = {name: statistics.mean(v) for name, v in ms.items()}
    every = [e for runs in got.values() for e in runs]
    same = {k: {e[k] == every[0][k] for e in every} == {True}
            for k in ("round_trips", "runs")}
    return {"precision": precision, "steps": steps, "order": order,
            **{f"{name}_ms": v for name, v in ms.items()},
            **{f"{name}_mean_ms": v for name, v in mean.items()},
            "delta_ms": mean["on"] - mean["off"],
            "ratio": mean["on"] / mean["off"],
            "control_delta_ms": mean["control"] - mean["off"],
            "on_vs_control_ms": mean["on"] - mean["control"],
            "round_trips": got["on"][0]["round_trips"],
            "runs": got["on"][0]["runs"], "same": same}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--precision", nargs="+", default=["f32", "bf16"],
                        choices=sorted(loop.PRECISIONS))
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--pairs", type=int, default=2)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_telemetry measures the card: no CUDA "
                         "device")
    card_line = card()
    results = []
    for precision in args.precision:
        with tempfile.TemporaryDirectory() as out_dir:
            results.append(measure(precision, args.steps, args.pairs,
                                   out_dir))
        print(json.dumps(results[-1]), flush=True)
    for r in results:
        print(f"[telemetry cost] vgg11 {r['precision']} allreduce, world 1, "
              f"windowed, steps 21-{r['steps']} of whole epochs in turns "
              f"{'/'.join(r['order'])}: "
              + "; ".join(f"{name} {r[name + '_mean_ms']:.4f} ms ("
                          + ", ".join(f"{v:.4f}" for v in r[name + "_ms"])
                          + ")" for name in ("off", "on", "control"))
              + f"; on - off {r['delta_ms']:+.4f} ms a step, on / off "
              f"{r['ratio']:.4f}; control - off "
              f"{r['control_delta_ms']:+.4f} ms, on - control "
              f"{r['on_vs_control_ms']:+.4f} ms; "
              f"an epoch's host round trips {r['round_trips']} and kernel "
              f"runs {r['runs']}, the same off and on: {r['same']}  "
              f"[{card_line}]")


if __name__ == "__main__":
    main()
