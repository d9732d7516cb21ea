"""Command line of the port: train any model of the zoo (VGG-11, the
reference's, by default; VGG-13/16/19, ResNet-18/34) on CIFAR-10 in f32 or
bf16 mixed precision, with any gradient-sync strategy, one process per
GPU, with the reference training script's print schedule.

    python -m cs744_ddp_tpu_torch.cli                            # allreduce, 1 GPU
    python -m cs744_ddp_tpu_torch.cli --model resnet18 --precision bf16
    python -m cs744_ddp_tpu_torch.cli --num-devices 4 --strategy ddp
    python -m cs744_ddp_tpu_torch.cli --device cpu --num-devices 2
    python -m cs744_ddp_tpu_torch.cli --profile-phases          # fwd/bwd split
    # save every epoch, resume on the rerun; SIGTERM saves mid-epoch:
    python -m cs744_ddp_tpu_torch.cli --epochs 3 --checkpoint-dir ckpt
    python -m cs744_ddp_tpu_torch.cli --nonfinite skip --chaos nonfinite_grad:30
    # one process per node, the reference's launch:
    python -m cs744_ddp_tpu_torch.cli --master HOST --num-nodes 2 --rank 0

Each epoch is trained in 20-step windows, on the card as replays of one
captured CUDA graph of the step, with one device-to-host fetch per window
(``--profile-phases`` takes the per-step path instead).
``--num-devices N`` spawns N local ranks: one per GPU over NCCL, or with
``--device cpu`` N processes over gloo.  Without it the process is one rank
of ``--num-nodes`` (a world-1 group when that is 1).  Without
``cifar-10-batches-py`` under ``--data-dir`` the deterministic synthetic
stand-in is used.

``--checkpoint-dir`` saves the whole training state after every epoch and
resumes from it when the same command runs again (another configuration
is refused); SIGTERM or SIGINT stops the run at the next window boundary
with an emergency save, from which the rerun resumes, bitwise equal to an
uninterrupted run (with ``--deterministic`` on the card).  A SIGTERM to
one rank of a multi-rank run alone leaves the others waiting at their
next collective: signal every rank.  ``--nonfinite`` guards every step
against a NaN/Inf loss or gradient; ``--chaos`` injects faults.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .device import resolve_device
from .ft import FTConfig, POLICIES, ChaosPlan, check_sites
from .models import get_model
from .ops import _build
from .ops.sgd import SGDConfig
from .parallel.mesh import DEFAULT_PORT, initialize_distributed
from .train.loop import GLOBAL_BATCH, PRECISIONS, STRATEGIES, Trainer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m cs744_ddp_tpu_torch.cli",
        description="Train a VGG or ResNet on CIFAR-10 (PyTorch/CUDA "
                    "port).")
    p.add_argument("--master", "--coordinator", dest="master", default=None,
                   help="rendezvous host of a multi-process run "
                        "(reference --master)")
    p.add_argument("--num-nodes", "--num-processes", dest="num_nodes",
                   type=int, default=1,
                   help="number of launched processes (reference "
                        "--num-nodes); with --num-devices, of nodes")
    p.add_argument("--rank", "--process-id", dest="rank", type=int,
                   default=0, help="this process's (node's) rank "
                                   "(reference --rank)")
    p.add_argument("--port", type=int, default=DEFAULT_PORT,
                   help="rendezvous port (reference hardcodes 6585)")
    p.add_argument("--num-devices", type=int, default=None,
                   help="spawn this many local ranks: one per GPU (NCCL), "
                        "or processes with --device cpu (gloo)")
    p.add_argument("--strategy", default="allreduce", choices=STRATEGIES,
                   help="gradient-sync strategy")
    p.add_argument("--compress-rank", type=int, default=None,
                   help="PowerSGD approximation rank (default 4)")
    p.add_argument("--model", default="vgg11",
                   help="vgg11/13/16/19, resnet18/34, or any name "
                        "registered with models.register_model (validated "
                        "by the model zoo, not argparse)")
    p.add_argument("--precision", default="f32", choices=sorted(PRECISIONS),
                   help="f32 = reference parity; bf16 = mixed precision "
                        "(bf16 activations, convolutions and matmuls; f32 "
                        "master weights, optimizer, BN statistics and "
                        "loss)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=GLOBAL_BATCH,
                   help="global batch size, split across the ranks")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--no-augment", action="store_true",
                   help="normalize only: no random crop/flip")
    p.add_argument("--profile-phases", action="store_true",
                   help="the per-step path: one eager step per batch, its "
                        "loss fetched, with a forward-only program timed "
                        "before it to report the reference's fwd/bwd "
                        "split.  It pays a launch per kernel and a fetch "
                        "per step, which the default windowed path (CUDA "
                        "graph replays, one fetch per 20 steps) does not, "
                        "so its times run above the default mode's")
    p.add_argument("--metrics-ring", type=int, default=None, metavar="N",
                   help="device-resident metric ring capacity for the "
                        "windowed path (obs/ringbuf.py): per-step "
                        "loss/grad-norm/ok rows are written on the device "
                        "and drained ONCE per window instead of per step. "
                        "Default on (capacity 64); 0 disables (one fetch "
                        "of the window's losses instead); N >= 20 sets the "
                        "capacity")
    p.add_argument("--limit-train-batches", type=int, default=None)
    p.add_argument("--limit-eval-batches", type=int, default=None)
    p.add_argument("--data-dir", default="./data")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--save", default=None, metavar="DIR",
                   help="write each rank's final model state_dict to "
                        "DIR/rank<r>.pt (not after a preemption)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save the training state (parameters, BN "
                        "statistics, momentum, comm state) after each "
                        "epoch and resume from the newest save; SIGTERM "
                        "or SIGINT saves mid-epoch at the next window "
                        "boundary and exits 0")
    p.add_argument("--deterministic", action="store_true",
                   help="deterministic cuDNN algorithms, so that a resumed "
                        "run is bitwise equal to an uninterrupted one on "
                        "the card (the CPU is deterministic anyway)")
    p.add_argument("--nonfinite", default="off", choices=POLICIES,
                   help="per-step finiteness guard on the loss and the "
                        "global gradient norm, inside the captured step: "
                        "halt = raise (the bad update is never applied), "
                        "skip = keep the prior state and continue, "
                        "restore = also roll back to the last checkpoint "
                        "snapshot; off (default) builds no guard")
    p.add_argument("--chaos", action="append", default=None,
                   metavar="SITE:step[:seed]",
                   help="inject a deterministic fault once at the given "
                        "step (repeatable): nonfinite_grad (NaN gradients "
                        "at that batch; requires --nonfinite other than "
                        "off) or preempt (SIGTERM at the first window "
                        "boundary at or after it; requires "
                        "--checkpoint-dir)")
    return p.parse_args(argv)


def ft_config_from_args(args: argparse.Namespace) -> Optional[FTConfig]:
    """FTConfig when the guard or a chaos plan is asked for, else None
    (the Trainer's ft=None path: no guard built).  Refuses, as the
    reference does, NaN injection without a guard and a chaos preemption
    without a checkpoint directory, and any site the port cannot fire."""
    if args.nonfinite == "off" and not args.chaos:
        return None
    try:
        plan = ChaosPlan.parse(args.chaos)
        check_sites(plan)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if plan.steps("nonfinite_grad") and args.nonfinite == "off":
        raise SystemExit("--chaos nonfinite_grad requires --nonfinite "
                         "halt, skip or restore")
    if plan.steps("preempt") and args.checkpoint_dir is None:
        raise SystemExit("--chaos preempt requires --checkpoint-dir")
    return FTConfig(nonfinite=args.nonfinite, chaos=plan)


def _train(args: argparse.Namespace) -> None:
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
    trainer = Trainer(
        args.model, args.strategy, precision=args.precision,
        compress_rank=args.compress_rank,
        global_batch=args.batch_size, data_dir=args.data_dir,
        device=args.device, augment=not args.no_augment,
        sgd_cfg=SGDConfig(lr=args.lr, momentum=args.momentum,
                          weight_decay=args.weight_decay),
        limit_train_batches=args.limit_train_batches,
        limit_eval_batches=args.limit_eval_batches,
        profile_phases=args.profile_phases, metrics_ring=args.metrics_ring,
        ft=ft_config_from_args(args))
    trainer.run(args.epochs, checkpoint_dir=args.checkpoint_dir)
    if args.save and not trainer.preempted:
        os.makedirs(args.save, exist_ok=True)
        torch.save(trainer.state.model.state_dict(),
                   os.path.join(args.save, f"rank{trainer.rank}.pt"))


def _spawned_rank(local: int, args: argparse.Namespace) -> None:
    """One of ``--num-devices`` local ranks."""
    world = args.num_nodes * args.num_devices
    if resolve_device(args.device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // args.num_devices))
    initialize_distributed(args.master or "127.0.0.1", world,
                           args.rank * args.num_devices + local, args.port,
                           args.device, local_rank=local)
    try:
        _train(args)
    finally:
        dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    get_model(args.model)     # an unknown name fails here, not in each rank
    ft_config_from_args(args)     # so does a refused fault-tolerance config
    if args.num_devices is None:
        if args.num_nodes > 1:
            initialize_distributed(args.master, args.num_nodes, args.rank,
                                   args.port, args.device)
        try:
            _train(args)
        finally:
            if dist.is_initialized():     # also the Trainer's world-1 group
                dist.destroy_process_group()
        return
    if args.num_devices < 1:
        raise SystemExit("--num-devices must be >= 1")
    if args.num_nodes > 1 and args.master is None:
        raise SystemExit("a multi-node run requires --master")
    device = resolve_device(args.device)
    if device.type == "cuda":
        if args.num_devices > torch.cuda.device_count():
            raise SystemExit(f"--num-devices {args.num_devices}: only "
                             f"{torch.cuda.device_count()} GPUs present")
        _build.build()      # once here, not once per rank
    torch.multiprocessing.spawn(_spawned_rank, args=(args,),
                                nprocs=args.num_devices, join=True)


if __name__ == "__main__":
    main()
