"""One rank of a multi-process run of the PyTorch port over gloo, for
tests/test_torch_port_strategies.py and tests/test_torch_port_dist.py.

    python tests/torch_dist_worker.py SPEC.json RANK

It imports torch, numpy and the port, never JAX.  ``SPEC.json`` holds the
world size, a ``file://`` rendezvous path, an output directory and a list
of tasks, which the rank runs in order (one process pays torch's import
once for all of them):

  * ``strategies`` — every tier on this rank's gradients and comm state
    (an ``.npz`` in the port's layout); writes the mean gradients, the new
    residuals and Q factors;
  * ``step``       — the Trainer's train step on a narrow VGG (or the
    zoo model ``model``), its weights, batches and, for a compressed tier,
    its comm state (``comm``) given, for each named strategy; writes the
    losses, the final state_dict and the final comm state;
  * ``counts``     — one train step of full-width VGG-11 per strategy;
    writes the step's collective counts, and for ``overlap`` how many
    buckets were launched when the gradient of ``blocks.0.conv.weight``
    arrived;
  * ``single``     — whether ``single`` refuses this world;
  * ``window``     — for each named strategy, a narrow VGG trained by the
    Trainer's windowed path and by its per-step path (``profile_phases``)
    on the fixture data, augmentation on; writes both states (parameters,
    buffers, momentum, comm residuals), losses and collective counts.
  * ``resume``     — for each named strategy, with ``loop.WINDOW`` set to
    ``window``: one uninterrupted epoch of a narrow VGG (``run(1)``); the
    same epoch preempted by the chaos plan's ``preempt`` site into a
    checkpoint directory; and a fresh Trainer resumed from it; writes the
    uninterrupted and the resumed states, the state at the save, the save's
    (epoch, step) and the log lines;
  * ``guard``      — for each named strategy, a narrow VGG trained under
    ``--nonfinite skip`` with NaN gradients planned at batch ``bad``;
    writes the ring's rows, the skipped count and whether the state is
    finite.
  * ``host``       — ``host_augment``, ``loop.WINDOW`` set to ``window``,
    the split cut to its first ``examples`` rows: a narrow VGG trained one
    epoch by the host windowed path and by the host per-step path; writes
    the window buffer's rows after each assembly and the ragged tail's f32
    batch (this rank's rows of the host stream), both states and losses.
  * ``elastic``    — ``loop.WINDOW`` set to ``window``: a narrow VGG
    ``Trainer(elastic=protocol)`` of ``strategy`` trained ``epochs`` by
    ``run`` (into ``dir`` when given), under the chaos plan ``chaos`` with
    ``slow_rank_stall_s`` ``stall``; with ``plant``, each rank's comm
    residuals set to a distinct ramp first.  Writes the state by name,
    the last epoch's losses, the log, ``rank_death``, the fired chaos
    entries, the straggler's flags, the resume plan, the collective
    counts and the epoch sidecar.

``start`` starts the ranks; ``Ranks.wait`` waits for them, killing them
at the time limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Dict, List

import numpy as np

NARROW_VGG = [8, "M", 16, "M", 32, "M", 64, "M", 512, "M"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


class Ranks:
    """The processes of one world, started by ``start``."""

    def __init__(self, world: int, procs: List[subprocess.Popen]):
        self.world = world
        self.procs = procs

    def wait(self, timeout: float = 300) -> List[str]:
        """Wait for every rank; their outputs.  Raises if one fails or the
        time runs out, and leaves no process behind."""
        outs: List[str] = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=timeout)[0].decode())
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(self.procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of world {self.world} exited "
                                   f"{p.returncode}:\n{out}")
        return outs


def start(spec: dict, tmp_dir: str) -> Ranks:
    """Start ``spec["world"]`` ranks running ``spec``'s tasks."""
    path = os.path.join(tmp_dir, f"spec_w{spec['world']}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("PYTHONPATH", None)
    return Ranks(spec["world"], [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), path, str(r)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(spec["world"])])


def _named(npz, prefix: str, names: List[str]):
    import torch
    out = []
    for n in names:
        t = torch.from_numpy(np.array(npz[prefix + n]))
        if t.dim() == 4:                 # the model's conv layout
            t = t.contiguous(memory_format=torch.channels_last)
        out.append(t)
    return out


def task_strategies(task: dict, group, rank: int, outdir: str) -> None:
    import torch
    from cs744_ddp_tpu_torch.parallel import strategies

    names = task["names"]
    data = np.load(task["inputs"])
    results: Dict[str, np.ndarray] = {}
    for tier in task["tiers"]:
        grads = _named(data, f"g{rank}/", names)
        strat = strategies.get_strategy(tier)
        if getattr(strat, "stateful", False):
            comm = {"residual": _named(data, f"r{rank}/", names)}
            if tier == "powersgd":
                comm["q"] = {n: torch.from_numpy(np.array(data[f"q{rank}/{n}"]))
                             for n in task["q_names"]}
            out, new = strat(grads, group, comm)
            for n, r in zip(names, new["residual"]):
                results[f"{tier}/res/{n}"] = r.numpy()
            for n, q in new.get("q", {}).items():
                results[f"{tier}/q/{n}"] = q.numpy()
        else:
            out = strat(grads, group)
        for n, o in zip(names, out):
            results[f"{tier}/out/{n}"] = o.contiguous().numpy()
        results[f"{tier}/counts"] = np.array(
            [group.step_counts[k] for k in group.KINDS])
        group.reset_step()
    np.savez(os.path.join(outdir, f"strategies_r{rank}.npz"), **results)


def task_step(task: dict, group, rank: int, outdir: str) -> None:
    import torch
    from cs744_ddp_tpu_torch.models import vgg
    from cs744_ddp_tpu_torch.ops.sgd import SGDConfig
    from cs744_ddp_tpu_torch.train.loop import Trainer

    vgg.CFG["VGGT"] = NARROW_VGG
    weights = np.load(task["weights"])
    batches = np.load(task["batches"])
    comm = np.load(task["comm"]) if "comm" in task else None
    world, per = group.world, task["global_batch"] // group.world
    results = {}
    for name in task["strategies"]:
        tr = Trainer(task.get("model", "vggt"), name,
                     global_batch=task["global_batch"],
                     data_dir=ASSETS, device="cpu", augment=False,
                     sgd_cfg=SGDConfig(lr=task["lr"]), log=lambda s: None)
        assert (tr.world, tr.rank) == (world, rank)
        tr.state.model.load_state_dict(
            {k: torch.from_numpy(np.array(v)) for k, v in weights.items()})
        names = [n for n, _ in tr.state.model.named_parameters()]
        state_comm = tr.state.opt_state.comm
        if comm is not None and state_comm is not None:
            with torch.no_grad():
                for n, r in zip(names, state_comm["residual"]):
                    r.copy_(torch.from_numpy(comm[f"r{rank}/{n}"]))
                for n, q in state_comm.get("q", {}).items():
                    q.copy_(torch.from_numpy(comm[f"q{rank}/{n}"]))
        losses = []
        for s in range(task["steps"]):
            rows = slice(rank * per, (rank + 1) * per)
            x = torch.from_numpy(batches["images"][s][rows].copy())
            y = torch.from_numpy(batches["labels"][s][rows].astype(np.int64))
            losses.append(float(tr.train_step(tr.state, x, y, 0, s)))
        results[f"{name}/losses"] = np.array(losses)
        for k, v in tr.state.model.state_dict().items():
            results[f"{name}/sd/{k}"] = v.contiguous().numpy()
        if state_comm is not None:
            for n, r in zip(names, state_comm["residual"]):
                results[f"{name}/res/{n}"] = r.contiguous().numpy()
            for n, q in state_comm.get("q", {}).items():
                results[f"{name}/q/{n}"] = q.numpy()
    np.savez(os.path.join(outdir, f"step_r{rank}.npz"), **results)


def task_counts(task: dict, group, rank: int, outdir: str) -> None:
    import torch
    from cs744_ddp_tpu_torch.models import get_model
    from cs744_ddp_tpu_torch.ops.sgd import SGDConfig
    from cs744_ddp_tpu_torch.parallel import strategies
    from cs744_ddp_tpu_torch.train import step as steplib

    rng = np.random.default_rng(rank)
    x = torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), np.uint8))
    y = torch.from_numpy(rng.integers(0, 10, 2).astype(np.int64))
    results = {}
    for name in task["strategies"]:
        model = get_model("vgg11").to(memory_format=torch.channels_last)
        launched_at_block0 = []
        # Registered before the step's own hooks, so it runs first.
        model.blocks[0].conv.weight.register_hook(
            lambda g: launched_at_block0.append(
                group.total_counts["all_reduce"]))
        strat = strategies.get_strategy(name)
        state = steplib.init_train_state(model, strat)
        step = steplib.make_train_step(model, strat, SGDConfig(),
                                       augment=False, group=group)
        before = group.total_counts["all_reduce"]
        loss = float(step(state, x, y))
        assert np.isfinite(loss), loss
        results[f"{name}/counts"] = np.array(
            [group.step_counts[k] for k in group.KINDS])
        results[f"{name}/launched_before_block0"] = np.array(
            launched_at_block0[0] - before)
    np.savez(os.path.join(outdir, f"counts_r{rank}.npz"), **results)


def task_single(task: dict, group, rank: int, outdir: str) -> None:
    from cs744_ddp_tpu_torch.train.loop import Trainer

    try:
        Trainer("vgg11", "single", device="cpu", data_dir=ASSETS)
        refused = ""
    except ValueError as e:
        refused = str(e)
    with open(os.path.join(outdir, f"single_r{rank}.json"), "w") as f:
        json.dump({"refused": refused}, f)


def task_window(task: dict, group, rank: int, outdir: str) -> None:
    from cs744_ddp_tpu_torch.models import vgg
    from cs744_ddp_tpu_torch.ops.sgd import SGDConfig
    from cs744_ddp_tpu_torch.train.loop import Trainer
    from cs744_ddp_tpu_torch.train.step import state_tensors

    vgg.CFG["VGGT"] = NARROW_VGG
    results = {}
    for name in task["strategies"]:
        for path, per_step in (("window", False), ("per-step", True)):
            tr = Trainer("vggt", name, global_batch=task["global_batch"],
                         data_dir=ASSETS, device="cpu",
                         sgd_cfg=SGDConfig(lr=task["lr"]),
                         limit_train_batches=task["steps"],
                         profile_phases=per_step, log=lambda s: None)
            tr.train_model(0)
            pre = f"{name}/{path}/"
            for i, t in enumerate(state_tensors(tr.state)):
                results[f"{pre}state/{i}"] = t.contiguous().numpy()
            results[pre + "losses"] = np.array(tr.last_epoch_timers.losses)
            results[pre + "counts"] = np.array(
                [tr.group.total_counts[k] for k in tr.group.KINDS])
    np.savez(os.path.join(outdir, f"window_r{rank}.npz"), **results)


def task_resume(task: dict, group, rank: int, outdir: str) -> None:
    from cs744_ddp_tpu_torch.ft import ChaosPlan, FTConfig
    from cs744_ddp_tpu_torch.models import vgg
    from cs744_ddp_tpu_torch.ops.sgd import SGDConfig
    from cs744_ddp_tpu_torch.train import loop
    from cs744_ddp_tpu_torch.train.checkpoint import CheckpointManager
    from cs744_ddp_tpu_torch.train.step import state_tensors

    vgg.CFG["VGGT"] = NARROW_VGG
    loop.WINDOW = task["window"]
    results = {}
    for name in task["strategies"]:
        def trainer(log=lambda s: None, ft=None):
            return loop.Trainer(
                "vggt", name, global_batch=task["global_batch"],
                data_dir=ASSETS, device="cpu",
                sgd_cfg=SGDConfig(lr=task["lr"]),
                limit_train_batches=task["steps"], limit_eval_batches=1,
                log=log, ft=ft)

        ck = os.path.join(task["dir"], name)
        lines: List[str] = []
        base = trainer()
        base.run(1)
        cut = trainer(lines.append, FTConfig(
            chaos=ChaosPlan.parse([f"preempt:{task['preempt']}"])))
        cut.run(1, checkpoint_dir=ck)
        at_save = [t.clone() for t in state_tensors(cut.state)]
        results[f"{name}/saved_at"] = np.array(
            CheckpointManager(ck).latest_mid_epoch())
        resumed = trainer(lines.append)
        resumed.run(1, checkpoint_dir=ck)
        results[f"{name}/preempted"] = np.array(
            [cut.preempted, resumed.preempted])
        for path, tensors in (("base", state_tensors(base.state)),
                              ("resumed", state_tensors(resumed.state)),
                              ("at_save", at_save)):
            for i, t in enumerate(tensors):
                results[f"{name}/{path}/{i}"] = t.contiguous().numpy()
        results[f"{name}/log"] = np.array(lines)
    np.savez(os.path.join(outdir, f"resume_r{rank}.npz"), **results)


def task_guard(task: dict, group, rank: int, outdir: str) -> None:
    import torch
    from cs744_ddp_tpu_torch.ft import ChaosPlan, FTConfig
    from cs744_ddp_tpu_torch.models import vgg
    from cs744_ddp_tpu_torch.obs import ringbuf
    from cs744_ddp_tpu_torch.ops.sgd import SGDConfig
    from cs744_ddp_tpu_torch.train.loop import Trainer
    from cs744_ddp_tpu_torch.train.step import state_tensors

    vgg.CFG["VGGT"] = NARROW_VGG
    results = {}
    for name in task["strategies"]:
        tr = Trainer("vggt", name, global_batch=task["global_batch"],
                     data_dir=ASSETS, device="cpu",
                     sgd_cfg=SGDConfig(lr=task["lr"]),
                     limit_train_batches=task["steps"], log=lambda s: None,
                     ft=FTConfig(nonfinite="skip", chaos=ChaosPlan.parse(
                         [f"nonfinite_grad:{task['bad']}"])))
        tr.train_model(0)
        ring = tr.train_window().ring
        results[f"{name}/rows"] = ringbuf.drain_rows(
            ring.buf.numpy(), ring.writes, task["steps"])
        results[f"{name}/skipped"] = np.array(tr.nonfinite_skipped)
        results[f"{name}/finite"] = np.array(all(
            bool(torch.isfinite(t.float()).all())
            for t in state_tensors(tr.state)))
    np.savez(os.path.join(outdir, f"guard_r{rank}.npz"), **results)


def task_host(task: dict, group, rank: int, outdir: str) -> None:
    from cs744_ddp_tpu_torch.data.cifar10 import Split
    from cs744_ddp_tpu_torch.models import vgg
    from cs744_ddp_tpu_torch.ops.sgd import SGDConfig
    from cs744_ddp_tpu_torch.train import loop
    from cs744_ddp_tpu_torch.train.step import state_tensors

    vgg.CFG["VGGT"] = NARROW_VGG
    loop.WINDOW = task["window"]
    results = {}
    for path, per_step in (("window", False), ("per-step", True)):
        tr = loop.Trainer("vggt", task["strategy"],
                          global_batch=task["global_batch"], data_dir=ASSETS,
                          device="cpu", sgd_cfg=SGDConfig(lr=task["lr"]),
                          host_augment=True, profile_phases=per_step,
                          log=lambda s: None)
        n = task["examples"]
        tr.train_split = Split(tr.train_split.images[:n],
                               tr.train_split.labels[:n])
        rows, tails = [], []
        assemble, step_fetch = tr._assemble, tr._step_fetch

        def record_assemble(chunks, start, tr=tr, assemble=assemble):
            w = assemble(chunks, start)
            rows.append(tr.train_window().images[:w].clone().numpy())
            return w

        def record_step(x, y, epoch, it, step_fetch=step_fetch):
            if x.shape[0] < tr.per_rank_batch:
                tails.append(x.clone().numpy())
            return step_fetch(x, y, epoch, it)

        tr._assemble, tr._step_fetch = record_assemble, record_step
        tr.train_model(0)
        pre = f"{path}/"
        if rows:
            results[pre + "rows"] = np.concatenate(rows)
        results[pre + "tail"] = tails[0]
        results[pre + "losses"] = np.array(tr.last_epoch_timers.losses)
        for i, t in enumerate(state_tensors(tr.state)):
            results[f"{pre}state/{i}"] = t.contiguous().numpy()
    np.savez(os.path.join(outdir, f"host_r{rank}.npz"), **results)


def planted_residuals(shapes: List[tuple], rank: int) -> List[np.ndarray]:
    """A ramp per residual, offset by ``rank + 1``: distinct on every rank
    and exact in f32 and in any sum of two."""
    return [np.arange(int(np.prod(sh)), dtype=np.float32).reshape(sh) / 64.0
            + np.float32(rank + 1) for sh in shapes]


def task_elastic(task: dict, group, rank: int, outdir: str) -> None:
    import torch
    from cs744_ddp_tpu_torch.elastic import ElasticConfig
    from cs744_ddp_tpu_torch.ft import ChaosPlan, FTConfig
    from cs744_ddp_tpu_torch.models import vgg
    from cs744_ddp_tpu_torch.train import loop
    from cs744_ddp_tpu_torch.train.checkpoint import read_epoch_meta
    from cs744_ddp_tpu_torch.train.step import named_state_tensors

    vgg.CFG["VGGT"] = NARROW_VGG
    loop.WINDOW = task["window"]
    ft = None
    if task.get("chaos"):
        ft = FTConfig(chaos=ChaosPlan.parse(task["chaos"]),
                      slow_rank_stall_s=task.get("stall", 0.25))
    lines: List[str] = []
    tr = loop.Trainer(
        "vggt", task["strategy"], global_batch=task["global_batch"],
        data_dir=ASSETS, device="cpu", seed=task["seed"],
        limit_train_batches=task.get("limit"), limit_eval_batches=1,
        log=lines.append, ft=ft,
        elastic=ElasticConfig(task["protocol"], task["microshards"]))
    comm = tr.state.opt_state.comm
    if task.get("plant"):
        with torch.no_grad():
            for r, v in zip(comm["residual"], planted_residuals(
                    [tuple(r.shape) for r in comm["residual"]], rank)):
                r.copy_(torch.from_numpy(v))
    tr.run(task["epochs"], checkpoint_dir=task.get("dir"))
    out = {f"state/{k}": t.contiguous().numpy()
           for k, t in named_state_tensors(tr.state).items()}
    out["losses"] = np.array(tr.last_epoch_timers.losses
                             if tr.last_epoch_timers else [])
    out["log"] = np.array(lines)
    out["rank_death"] = np.array(tr.rank_death or [], dtype=np.int64)
    out["fired"] = np.array(json.dumps(getattr(tr.chaos, "fired", [])))
    out["flags"] = np.array(json.dumps(
        {} if tr._straggler is None else tr._straggler.flag_counts))
    out["plan"] = np.array(json.dumps(
        None if tr.resume_plan is None else tr.resume_plan._asdict()))
    out["counts"] = np.array([tr.group.total_counts[k]
                              for k in tr.group.KINDS])
    out["sidecar"] = np.array(json.dumps(
        read_epoch_meta(task["dir"]) if task.get("dir") else None))
    np.savez(os.path.join(outdir, f"elastic_{task['name']}_r{rank}.npz"),
             **out)


TASKS = {"strategies": task_strategies, "step": task_step,
         "counts": task_counts, "single": task_single,
         "window": task_window, "resume": task_resume, "guard": task_guard,
         "host": task_host, "elastic": task_elastic}


def main() -> None:
    spec_path, rank = sys.argv[1], int(sys.argv[2])
    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from cs744_ddp_tpu_torch.parallel import Group, initialize_distributed

    initialize_distributed(None, spec["world"], rank, device="cpu",
                           init_method=spec["rdzv"])
    try:
        group = Group(torch.device("cpu"))
        for task in spec["tasks"]:
            TASKS[task["kind"]](task, group, rank, spec["out"])
            group.reset_step()
        assert "jax" not in sys.modules
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
