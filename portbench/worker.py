"""One rank of a cell: the program's Trainer built from the run's data and
seed, its first steps read for the comparison, an epoch of warm-up, the
measured window of whole epochs, optionally one traced epoch, and on rank
0 the plain reference and the comparison.  What depends on the model and
the data comes from the cell's plug-ins (``plugins.py``).

The program is ``cs744_ddp_tpu_torch``, imported here as a library: its
``Trainer`` (``train/loop.py``), whose ``train_model(epoch)`` trains the
staged epoch in 20-step windows of replays of one captured CUDA graph and
the ragged tail as one eager step.  Every epoch ends in a fetch, so a
window of whole epochs ends with no work queued.
"""

from __future__ import annotations

import gc
import importlib
import pkgutil
import time
from typing import Dict, List, Optional

from . import plugins, trace
from .launch import NoCard, check_cards, forbidden_modules
from .reference import steps as refsteps


def _state_leaves(trainer, arch):
    """The parameters, and the buffers whose names end in one of the
    architecture's ``CHECKED_STATE`` suffixes, in registration order."""
    model = trainer.state.model
    params = list(model.parameters())
    names = tuple(getattr(arch, "CHECKED_STATE", ()))
    stats = [b for n, b in model.named_buffers() if n.endswith(names)]
    return params, stats


def checked_steps(trainer, steps: int, arch) -> refsteps.Readings:
    """The Trainer's first ``steps`` steps of epoch 0, through the window's
    own call (the first captures the step on the card and replays it
    once), read as the comparison reads them: each step's loss from the
    window's drained rows, the first gradient from the momentum after one
    step (v = g + wd p0), the change of the state that ``arch`` names (the
    BN running statistics) after it, and the change of the parameters
    after the last."""
    import torch
    window = trainer.train_window()
    params, stats = _state_leaves(trainer, arch)
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


# Trainer keywords that a traffic's ``program`` object may never give: the
# harness's own, and those that change the epoch the rate counts or the
# step the comparison checks.
PROGRAM_REFUSED = frozenset({
    "model", "strategy", "precision", "global_batch", "data_dir", "device",
    "seed", "augment", "sgd_cfg", "reshuffle_each_epoch", "log",
    "limit_train_batches", "compress_rank", "profile_phases", "ft",
    "elastic", "host_augment", "telemetry"})
# Those it may give whatever the architecture: eval, which a run never
# reaches.
PROGRAM_KEYS = ("limit_eval_batches",)


def program_keywords(arch, traffic: dict) -> dict:
    """The traffic's optional ``program`` object, the Trainer's extra
    keyword arguments: each key in ``PROGRAM_KEYS`` or in the
    architecture's own ``PROGRAM_KEYS``, and none in ``PROGRAM_REFUSED``;
    any other is refused."""
    given = traffic.get("program", {})
    allowed = set(PROGRAM_KEYS) | set(getattr(arch, "PROGRAM_KEYS", ()))
    bad = sorted(k for k in given
                 if k in PROGRAM_REFUSED or k not in allowed)
    if bad:
        raise ValueError(f"the traffic's program keys {bad} are refused: "
                         f"a run takes {sorted(allowed - PROGRAM_REFUSED)}")
    return dict(given)


def build_trainer(spec: dict, seed: int, data_dir: str, device, logs: list):
    """The program's Trainer for the cell, with ``program_keywords``."""
    from cs744_ddp_tpu_torch.ops.sgd import SGDConfig
    from cs744_ddp_tpu_torch.train.loop import Trainer
    traffic = spec["traffic"]
    extra = program_keywords(plugins.cell(spec)[0], traffic)
    return Trainer(
        model=spec["config"]["port_model"], strategy=traffic["strategy"],
        precision=traffic["precision"], global_batch=traffic["global_batch"],
        data_dir=data_dir, device=device, seed=seed,
        augment=traffic["augment"], sgd_cfg=SGDConfig(**traffic["sgd"]),
        reshuffle_each_epoch=traffic["reshuffle_each_epoch"],
        log=logs.append, **extra)


def make_data(spec: dict, seed: int, data_dir: str, device) -> None:
    _, recipe = plugins.cell(spec)
    recipe.make(spec["traffic"]["dataset"], seed, data_dir, device)


def reference_readings(spec: dict, seed: int, data_dir: str, device,
                       precision: str = "f32") -> refsteps.Readings:
    arch, recipe = plugins.cell(spec)
    return refsteps.run(arch, recipe, recipe.read(data_dir), spec["config"],
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


def _counts(trainer) -> Dict[str, Dict[str, int]]:
    """The program's counts so far: the Trainer's ``trace_counts()``, and
    ``executed_counts()`` of every ``cs744_ddp_tpu_torch.ops`` submodule
    that has one, by the submodule's name."""
    from cs744_ddp_tpu_torch import ops
    out = {"trainer": trainer.trace_counts()}
    for info in pkgutil.iter_modules(ops.__path__):
        if info.name.startswith("_"):
            continue
        module = importlib.import_module(f"{ops.__name__}.{info.name}")
        if hasattr(module, "executed_counts"):
            out[info.name] = module.executed_counts()
    return out


def steps_run(before: dict, after: dict) -> int:
    """The training steps the program ran between two of its
    ``trace_counts()``: its window's calls (graph replays on the card) and
    its eager steps."""
    return sum(after[k] - before[k] for k in ("replays", "eager_steps"))


def check_plan(ran: int, epochs: int, plan: int) -> None:
    """Refuse a run whose program trained other than ``plan`` steps an
    epoch (the recipe's examples a rank in batches of the per-rank rows),
    which is what the rate and the per-step metrics count."""
    if ran != epochs * plan:
        raise RuntimeError(
            f"the program trained {ran} steps in {epochs} epoch(s); the "
            f"recipe's epoch is {plan} steps a rank: the examples counted "
            f"are not those trained")


def _traced_epoch(trainer, epoch: int, stop: _Stop, plan: int) -> dict:
    """One more whole epoch under the profiler: ``trace.summarize`` of it,
    with ``counters`` (each of ``_counts``' sources, its change over the
    epoch) and ``collectives_per_step``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    before = _counts(trainer)
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
    after = _counts(trainer)
    check_plan(steps_run(before["trainer"], after["trainer"]), 1, plan)
    summary = trace.summarize(prof.profiler.kineto_results.events())
    summary["counters"] = {
        source: {k: v - before[source][k] for k, v in now.items()}
        for source, now in after.items()}
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
    arch, recipe = plugins.cell(spec)
    refsteps.chunk_rows(arch, spec["traffic"])    # refused before any work
    program_keywords(arch, spec["traffic"])
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
    prog = checked_steps(trainer, steps, arch)
    marks["checked_steps"] = time.time() - t
    t = time.time()
    trainer.train_model(0, start_step=steps)
    marks["warm_epoch"] = time.time() - t
    stop = _Stop(world, device)
    stop(0.0, 1.0)                       # every rank here before the clock
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rank_rows = -(-recipe.examples(spec["traffic"]["dataset"]) // world)
    plan = -(-rank_rows // trainer.per_rank_batch)
    before = trainer.trace_counts()
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
    steps = steps_run(before, trainer.trace_counts())
    check_plan(steps, epochs, plan)
    out = {"rank": rank, "t0_wall": t0_wall, "window_s": window_s,
           "epochs": epochs, "examples": epochs * rank_rows, "steps": steps,
           "marks": marks, "per_rank_batch": trainer.per_rank_batch,
           "epoch_s": [b - a for a, b in zip([0.0] + ends, ends)],
           "rank_rows": rank_rows, "program": prog._asdict(),
           "finite": bool(all(torch.isfinite(p).all()
                              for p in trainer.state.model.parameters()))}
    if device.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_reserved(device)
        out["device_kind"] = torch.cuda.get_device_name(device)
    if traced:
        out["trace"] = _traced_epoch(trainer, epoch, stop, plan)
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
