"""The readings the limits of a cell are set from (not run by the
benchmark's runs).

    python -m portbench.calibrate --workload <cell> --seeds a,b,...
        [--fault-seeds c,d,...] [--faults half_batch,no_exchange]

For each seed, in one process a rank (the ranks of a multi-chip cell in
processes of their own, one a card): the cell's split made from the seed;
the program's first steps read as a benchmark run reads them
(``worker.checked_steps``, a fresh Trainer each); on the fault seeds the
same again with each fault planted in the program (``faults.py``); and on
rank 0 the plain reference in f32 and the control, the reference in the
precision below the cell's (TF32 for f32, fp8 for bf16).  It prints one
JSON line a seed with every number of ``check.numbers`` for the program,
the control and each fault, then the largest of the program's, the
smallest of the control's and of each fault's, by number.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List

from . import check, faults, plugins, run, worker
from .reference.steps import Readings

CONTROL = {"f32": "tf32", "bf16": "fp8"}


def _argworst(prog, ref) -> int:
    med = sorted(ref)[len(ref) // 2]
    gaps = [abs(p - r) / max(r, med) for p, r in zip(prog, ref)]
    return gaps.index(max(gaps))


def calibrate_rank(rank: int, world: int, spec: dict, seeds: List[int],
                   fault_seeds: List[int], fault_names: List[str],
                   data_root: str, device_type: str, port, results) -> None:
    try:
        import torch
        from cs744_ddp_tpu_torch.parallel.mesh import (
            destroy_distributed, initialize_distributed)
        if world > 1:
            import torch.distributed as dist
            device = initialize_distributed(
                num_processes=world, rank=rank,
                init_method=f"tcp://localhost:{port}", device=device_type)
        else:
            device = torch.device(device_type)
        steps = spec["traffic"]["checked_steps"]
        control = CONTROL[spec["traffic"]["precision"]]
        arch, _ = plugins.cell(spec)
        for seed in seeds:
            t = time.time()
            data_dir = os.path.join(data_root, str(seed))
            if rank == 0:
                worker.make_data(spec, seed, data_dir, device)
            if world > 1:
                dist.barrier()
            modes = ["program"] + (fault_names if seed in fault_seeds
                                   else [])
            got: Dict[str, Readings] = {}
            for mode in modes:
                plant = contextlib.nullcontext() if mode == "program" \
                    else faults.FAULTS[mode]()
                with plant:
                    trainer = worker.build_trainer(spec, seed, data_dir,
                                                   device, [])
                    got[mode] = worker.checked_steps(trainer, steps, arch)
                    del trainer
                    gc.collect()
            if world > 1:
                dist.barrier()
            if rank == 0:
                ref = worker.reference_readings(spec, seed, data_dir, device)
                got["control"] = worker.reference_readings(
                    spec, seed, data_dir, device, control)
                rec = {"seed": seed, "seconds": time.time() - t,
                       "reference_raw": ref._asdict()}
                names = [leaf.name for leaf in arch.leaves(spec["config"])]
                for mode, readings in got.items():
                    rec[mode] = check.numbers(readings, ref)
                    rec[mode + "_raw"] = readings._asdict()
                    rec[mode + "_worst"] = {
                        k: names[_argworst(getattr(readings, k),
                                           getattr(ref, k))]
                        for k in ("grad1", "change")}
                results.put(rec)
                shutil.rmtree(data_dir, ignore_errors=True)
        if world > 1:
            dist.barrier()
            destroy_distributed()
        results.put({"rank": rank, "done": True})
    except BaseException:  # noqa: BLE001 - reported, then re-raised
        import traceback
        results.put({"rank": rank, "error": traceback.format_exc()})
        raise


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--faults", default="half_batch")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    spec = run.load_cell(args.workload)
    world = spec["traffic"]["world"]
    seeds = [int(s) for s in args.seeds.split(",")]
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    fault_names = [f for f in args.faults.split(",") if f]
    import multiprocessing as mp
    import queue
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    data_root = tempfile.mkdtemp(prefix="portbench-calibrate-")
    port = run._free_port()
    procs = [ctx.Process(target=calibrate_rank,
                         args=(r, world, spec, seeds, fault_seeds,
                               fault_names, data_root, args.device, port,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    recs, done = [], 0
    try:
        while done < world:
            try:
                out = results.get(timeout=600)
            except queue.Empty:
                print("no word from the ranks in 600 s", file=sys.stderr)
                return 1
            if "error" in out:
                print(out["error"], file=sys.stderr)
                return 1
            if out.get("done"):
                done += 1
                continue
            recs.append(out)
            print(json.dumps(out), flush=True)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
        shutil.rmtree(data_root, ignore_errors=True)
    summary = {"workload": args.workload, "seeds": len(recs)}
    modes = {m for r in recs for m in r
             if m not in ("seed", "seconds", "reference_raw")
             and not m.endswith(("_worst", "_raw"))}
    for mode in sorted(modes):
        rows = [r[mode] for r in recs if mode in r]
        pick = max if mode == "program" else min
        summary[mode] = {k: pick(row[k] for row in rows) for k in rows[0]}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
