"""Run one cell of the benchmark once and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout.  The cell (``workloads/<cell>.json``) names
its configuration (``configs/<config>.json``), its training job
(``traffic/<traffic>.json``) and its limits.  The run:

  1. refuses, with no result, a host whose CUDA devices are fewer than
     the cell's chips;
  2. builds the program's CUDA kernels into ``build/kernels/`` of the
     checkout (a compile cache: only a checkout's first run compiles);
  3. per rank (the ranks of a multi-chip cell are processes of their own,
     one a card, over NCCL): makes the training split from ``--seed``
     on the card and writes it under ``TMPDIR`` in the program's files
     (the traffic's recipe, ``recipes/<recipe>.py``), builds the
     program's ``Trainer`` on it, trains its first steps through the
     window's own call and reads them for the comparison, and warms one
     whole epoch;
  4. measures whole epochs of ``Trainer.train_model`` until ``--seconds``
     have passed (``--trace 1``: then traces one more epoch);
  5. on rank 0, after the program is freed, runs the plain reference over
     the same first steps and compares.

The last line of standard output is the result, a JSON object; every
other line goes to standard error, and its last lines are the numbers
compared, each beside its limit.  ``setup_s`` runs from the start of this
process to the first timed step.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import launch, plugins
from .plugins import NAME


def process_start_time() -> float:
    """This process's start, seconds since the epoch (from ``/proc``; the
    current time where the kernel does not give it)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_PROCESS = process_start_time()

ROOT = plugins.ROOT
CHECKOUT = ROOT.parent
DEADLINE_S = 330.0
END_TO_END = ("train_images_per_s", "setup_s")


def _log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration and traffic, by name, and
    the ``root`` under which its plug-ins are found (``plugins.py``)."""
    cell = load_json("workloads", name, root)
    return {"name": name, "cell": cell,
            "config": load_json("configs", cell["config"], root),
            "traffic": load_json("traffic", cell["traffic"], root),
            "root": Path(root)}


def load_metrics(root: Path = ROOT) -> Dict[str, object]:
    """Every per-layer metric's reader (``metrics/<name>.py``), by name."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        name = path.name[:-3]
        if not NAME.match(name) or name.startswith("_"):
            continue
        out[name] = plugins.exec_file(path, f"portbench_metric_{len(out)}")
    return out


class Context:
    """What a per-layer metric reads: the cell (and the ``root`` of its
    plug-ins, for the yardstick), the measured rate in examples a second
    (``images_per_s``: an example is what the traffic's recipe counts),
    the ranks' traced epochs (rank 0's first), each with the program's
    ``counters`` over it."""

    def __init__(self, spec: dict, images_per_s: float, traces: List[dict],
                 per_rank_batch: int, rank_rows: int):
        self.config = spec["config"]
        self.traffic = spec["traffic"]
        self.root = spec["root"]
        self.chips = spec["cell"]["chips"]
        self.images_per_s = images_per_s
        self.traces = traces
        self.trace = traces[0]
        # The traced epoch's steps, each its per-rank rows.
        full, tail = divmod(rank_rows, per_rank_batch)
        self.step_batches = [per_rank_batch] * full + ([tail] if tail else [])
        # Steps of a full per-rank batch that the traced epoch's rows make.
        self.steps = rank_rows / per_rank_batch


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(spec: dict, args, data_dir: str, device_type: str,
               deadline_s: float, rank_target=None) -> List[dict]:
    """Every rank's dict: in this process at world 1, else in one spawned
    process a rank running ``rank_target`` (``launch.rank_entry``)."""
    world = spec["traffic"]["world"]
    if world == 1:
        from . import worker
        return [worker.run_rank(0, 1, spec, args.seed, args.seconds,
                                bool(args.trace), data_dir, device_type)]
    import multiprocessing as mp
    import queue
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=rank_target or launch.rank_entry,
                         args=(r, world, spec, args.seed, args.seconds,
                               bool(args.trace), data_dir, device_type, port,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, dict] = {}
    try:
        end = time.time() + deadline_s
        while len(got) < world:
            try:
                out = results.get(timeout=max(1.0, end - time.time()))
            except queue.Empty:
                raise RuntimeError(f"{world - len(got)} rank(s) sent no "
                                   f"result in {deadline_s:.0f} s") from None
            if out.get("no_card"):
                raise launch.NoCard(out["error"])
            if "error" in out:
                raise RuntimeError(f"rank {out['rank']} failed:\n"
                                   f"{out['error']}")
            got[out["rank"]] = out
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"rank processes exited with {bad}")
    return [got[r] for r in range(world)]


def measure(spec: dict, args, device_type: str = "cuda",
            deadline_s: Optional[float] = None, rank_target=None) -> dict:
    """One run of ``spec``'s cell: the result line as a dict, its last key
    ``checks``.  ``deadline_s``: how long the ranks of a multi-chip cell
    may take (else the traffic's ``deadline_s``, else ``DEADLINE_S``).
    ``rank_target``: what a spawned rank runs (the tests plant faults
    through it)."""
    chips = spec["cell"]["chips"]
    world = spec["traffic"]["world"]
    if world != chips:
        raise ValueError(f"a cell runs one rank a chip: world {world}, "
                         f"chips {chips}")
    if deadline_s is None:
        deadline_s = spec["traffic"].get("deadline_s", DEADLINE_S)
    if device_type == "cuda":
        from cs744_ddp_tpu_torch.ops import _build
        t = time.time()
        built = _build.build()
        _log(f"kernels: {_build.SOURCES} "
             + (f"compiled in {sum(built.values()):.3f} s" if built
                else "found in the build directory")
             + f" ({time.time() - t:.3f} s)")
    data_dir = tempfile.mkdtemp(prefix="portbench-data-")
    try:
        ranks = _run_ranks(spec, args, data_dir, device_type, deadline_s,
                           rank_target)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    from . import check, trace
    from .reference.steps import Readings
    r0 = ranks[0]
    rate = sum(r["examples"] for r in ranks) / r0["window_s"]
    setup_s = r0["t0_wall"] - T_PROCESS
    _log(f"setup: {setup_s:.3f} s from process start; rank 0 "
         + ", ".join(f"{k} {v:.3f} s" for k, v in r0["marks"].items()))
    _log(f"window: {r0['epochs']} epoch(s), {r0['steps']} steps a rank, "
         f"{sum(r['examples'] for r in ranks)} examples in "
         f"{r0['window_s']:.4f} s (epochs "
         f"{[round(e, 4) for e in r0['epoch_s']]}); reference "
         f"{r0['reference_s']:.3f} s; program log "
         f"{r0['last_log']}")
    forbidden = sorted({m for r in ranks for m in r["forbidden"]})
    values = check.numbers(Readings(**r0["program"]),
                           Readings(**r0["reference"]))
    correct, rows = check.judge(values, spec["cell"]["limits"])
    correct = correct and all(r["finite"] for r in ranks)
    device = {"platform": "gpu" if device_type == "cuda" else device_type,
              "kind": r0.get("device_kind", device_type), "count": chips,
              "memory_peak_bytes": max(r.get("memory_peak_bytes", 0)
                                       for r in ranks)}
    steps = sum(r["steps"] for r in ranks) // world
    result = {"correct": correct, "attempted": steps,
              "failed": 0 if all(r["finite"] for r in ranks) else steps}
    if args.trace:
        traces = [r["trace"] for r in ranks]
        ctx = Context(spec, rate, traces, r0["per_rank_batch"],
                      r0["rank_rows"])
        metrics = {}
        for name, reader in load_metrics(spec["root"]).items():
            value = reader.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
        device["busy_s"] = sum(t["busy_us"] for t in traces) / 1e6 / world
        device["window_s"] = sum(t["wall_us"] for t in traces) / 1e6 / world
        result["metrics"] = metrics
        result["device"] = device
        result["breakdown"] = trace.breakdown(traces[0])
        _log(f"traced epoch, rank 0: families (us) "
             f"{ {k: round(v, 1) for k, v in traces[0]['families'].items()} }"
             f"; bnpool runs {traces[0]['counters'].get('bnpool')}; "
             f"collectives a step {traces[0]['collectives_per_step']}; "
             f"counters {traces[0]['counters']}")
    else:
        result["metrics"] = {
            "train_images_per_s": {"value": rate, "unit": "images/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        result["device"] = device
    result["checks"] = {name: [value, limit] for name, value, limit in rows}
    result["_forbidden"] = forbidden
    return result


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    t_main = time.time()
    if args.seed < 0:
        parser.error("--seed must be a non-negative whole number")
    spec = load_cell(args.workload)
    from .launch import NoCard, check_cards, forbidden_modules
    t_torch = time.time()
    if spec["traffic"]["world"] == 1:
        # Ranks in processes of their own check the cards there, so that
        # this process need not import torch before it starts them.
        try:
            check_cards(1)
        except NoCard as e:
            _log(str(e))
            return 2
    here = str(CHECKOUT / "build" / "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(here, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(here, "triton")
    os.environ["USE_FLAX"] = "0"
    _log(f"process start to main {t_main - T_PROCESS:.3f} s, card check "
         f"{time.time() - t_torch:.3f} s")
    try:
        result = measure(spec, args)
    except NoCard as e:
        _log(str(e))
        return 2
    forbidden = sorted(set(result.pop("_forbidden"))
                       | set(forbidden_modules()))
    if forbidden:
        _log(f"modules loaded that the run may not load: {forbidden}: no "
             f"result")
        return 3
    for name, (value, limit) in result["checks"].items():
        print(f"[check] {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(f"[check] correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
