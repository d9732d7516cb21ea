"""One rank of a cell: the program's Trainer built from the run's data and
seed, its first steps read for the comparison, an epoch of warm-up, the
measured window of whole epochs, optionally one traced epoch, and on rank
0 the plain reference and the comparison.

The program is ``cs744_ddp_tpu_torch``, imported here as a library: its
``Trainer`` (``train/loop.py``), whose ``train_model(epoch)`` trains the
staged epoch in 20-step windows of replays of one captured CUDA graph and
the ragged tail as one eager step.  Every epoch ends in a fetch, so a
window of whole epochs ends with no work queued.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

from . import data, trace
from .launch import NoCard, check_cards, forbidden_modules
from .reference import steps as refsteps


def _state_leaves(trainer):
    model = trainer.state.model
    params = list(model.parameters())
    stats = [b for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    return params, stats


def checked_steps(trainer, steps: int) -> refsteps.Readings:
    """The Trainer's first ``steps`` steps of epoch 0, through the window's
    own call (the first captures the step on the card and replays it
    once), read as the comparison reads them: each step's loss from the
    window's drained rows, the first gradient from the momentum after one
    step (v = g + wd p0), the change of the BN running statistics after
    it, and the change of the parameters after the last."""
    import torch
    window = trainer.train_window()
    params, stats = _state_leaves(trainer)
    p0 = [p.detach().clone() for p in params]
    s0 = [s.clone() for s in stats]
    wd = trainer.sgd_cfg.weight_decay
    losses: List[float] = []
    start = 0
    for w in (1, steps - 1):
        if w < 1:
            continue
        fetched = window(0, start, w).cpu().numpy()
        losses += [float(v) for v in window.columns(fetched, start, w).loss]
        if start == 0:
            with torch.no_grad():
                grad1 = refsteps.norms(
                    v - wd * p for v, p in
                    zip(trainer.state.opt_state.momentum, p0))
                stats1 = refsteps.norms(s - a for s, a in zip(stats, s0))
        start += w
    return refsteps.Readings(
        losses, grad1, refsteps.norms(p - a for p, a in zip(params, p0)),
        stats1)


def build_trainer(spec: dict, seed: int, data_dir: str, device, logs: list):
    from cs744_ddp_tpu_torch.ops.sgd import SGDConfig
    from cs744_ddp_tpu_torch.train.loop import Trainer
    traffic = spec["traffic"]
    return Trainer(
        model=spec["config"]["port_model"], strategy=traffic["strategy"],
        precision=traffic["precision"], global_batch=traffic["global_batch"],
        data_dir=data_dir, device=device, seed=seed,
        augment=traffic["augment"], sgd_cfg=SGDConfig(**traffic["sgd"]),
        reshuffle_each_epoch=traffic["reshuffle_each_epoch"],
        log=logs.append)


def make_data(spec: dict, seed: int, data_dir: str, device) -> None:
    ds = spec["traffic"]["dataset"]
    train = data.synthetic_split(ds["train_images"], seed, device)
    test = data.synthetic_split(ds["test_images"], seed + 1, device)
    data.write_cifar10(data_dir, train, test)


def reference_readings(spec: dict, seed: int, data_dir: str, device,
                       precision: str = "f32") -> refsteps.Readings:
    split = data.read_cifar10(data_dir)
    return refsteps.run(split.images, split.labels, spec["config"],
                        spec["traffic"], seed, spec["traffic"]["checked_steps"],
                        device, precision)


class _Stop:
    """The ranks' agreement to end the window after an epoch: every rank
    stops once any has measured ``seconds``."""

    def __init__(self, world: int, device):
        self.world, self.device = world, device

    def __call__(self, elapsed: float, seconds: float) -> bool:
        if self.world == 1:
            return elapsed >= seconds
        import torch
        import torch.distributed as dist
        flag = torch.tensor([float(elapsed >= seconds)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())


def _traced_epoch(trainer, epoch: int, stop: _Stop) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from cs744_ddp_tpu_torch.ops import bnpool
    before = bnpool.executed_counts()
    activities = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(trainer.device)
    with profile(activities=activities) as prof:
        with record_function(trace.SPAN + "window"):
            with record_function(trace.SPAN + "epoch"):
                trainer.train_model(epoch)
            with record_function(trace.SPAN + "rank_barrier"):
                stop(0.0, 1.0)
    after = bnpool.executed_counts()
    summary = trace.summarize(prof.profiler.kineto_results.events())
    summary["bnpool_runs"] = {k: after[k] - before[k] for k in after}
    summary["collectives_per_step"] = {} if trainer.group is None else \
        dict(trainer.group.step_counts)
    return summary


def run_rank(rank: int, world: int, spec: dict, seed: int, seconds: float,
             traced: bool, data_dir: str, device_type: str = "cuda",
             port: Optional[int] = None) -> Dict:
    """This rank's part of one run; the dict goes to the process that
    prints the result."""
    t_import = time.time()
    import torch
    from cs744_ddp_tpu_torch.parallel.mesh import (destroy_distributed,
                                                   initialize_distributed)
    marks = {"import": time.time() - t_import}
    if world > 1:
        import torch.distributed as dist
        if device_type == "cuda":
            check_cards(world)
        device = initialize_distributed(
            num_processes=world, rank=rank,
            init_method=f"tcp://localhost:{port}", device=device_type)
    else:
        device = torch.device(device_type)
        if device_type == "cuda":
            torch.cuda.set_device(0)
            device = torch.device("cuda", 0)
            torch.zeros((), device=device)      # the context, timed apart
    marks["device"] = time.time() - t_import - marks["import"]
    t = time.time()
    if rank == 0:
        make_data(spec, seed, data_dir, device)
    if world > 1:
        dist.barrier()
    marks["data"] = time.time() - t
    t = time.time()
    logs: List[str] = []
    trainer = build_trainer(spec, seed, data_dir, device, logs)
    marks["trainer"] = time.time() - t
    t = time.time()
    steps = spec["traffic"]["checked_steps"]
    prog = checked_steps(trainer, steps)
    marks["checked_steps"] = time.time() - t
    t = time.time()
    trainer.train_model(0, start_step=steps)
    marks["warm_epoch"] = time.time() - t
    stop = _Stop(world, device)
    stop(0.0, 1.0)                       # every rank here before the clock
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0_wall, t0 = time.time(), time.perf_counter()
    epoch, ends = 1, []
    while True:
        trainer.train_model(epoch)
        epoch += 1
        ends.append(time.perf_counter() - t0)
        if stop(ends[-1], seconds):
            break
    window_s = time.perf_counter() - t0
    epochs = epoch - 1
    rows = len(trainer.train_split.labels)
    rank_rows = -(-rows // world)
    out = {"rank": rank, "t0_wall": t0_wall, "window_s": window_s,
           "epochs": epochs, "images": epochs * rank_rows,
           "steps": epochs * -(-rank_rows // trainer.per_rank_batch),
           "marks": marks, "per_rank_batch": trainer.per_rank_batch,
           "epoch_s": [b - a for a, b in zip([0.0] + ends, ends)],
           "rank_rows": rank_rows, "program": prog._asdict(),
           "finite": bool(all(torch.isfinite(p).all()
                              for p in trainer.state.model.parameters()))}
    if device.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_reserved(device)
        out["device_kind"] = torch.cuda.get_device_name(device)
    if traced:
        out["trace"] = _traced_epoch(trainer, epoch, stop)
    out["last_log"] = logs[-2:]
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    if world > 1:
        destroy_distributed()
    if rank == 0:
        t = time.time()
        out["reference"] = reference_readings(spec, seed, data_dir,
                                              device)._asdict()
        out["reference_s"] = time.time() - t
    out["forbidden"] = forbidden_modules()
    return out


def rank_main(rank: int, world: int, spec: dict, seed: int, seconds: float,
              traced: bool, data_dir: str, device_type: str, port: int,
              results) -> None:
    """A spawned rank: its dict, or the error that ended it, on
    ``results``."""
    try:
        results.put(run_rank(rank, world, spec, seed, seconds, traced,
                             data_dir, device_type, port))
    except NoCard as e:
        results.put({"rank": rank, "error": str(e), "no_card": True})
    except BaseException:  # noqa: BLE001 - reported, then re-raised
        import traceback
        results.put({"rank": rank, "error": traceback.format_exc()})
        raise
