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
    # the crop/flip in the C++ host pipeline, staging supervised:
    python -m cs744_ddp_tpu_torch.cli --host-augment --chaos producer_crash:30
    # elastic: a rank death at world 2 shrinks the run to world 1, bitwise:
    python -m cs744_ddp_tpu_torch.cli --num-devices 2 --elastic strong \
        --checkpoint-dir ckpt --chaos rank_death:25:1
    # one process per node, the reference's launch:
    python -m cs744_ddp_tpu_torch.cli --master HOST --num-nodes 2 --rank 0
    # the run's telemetry, and a torch.profiler trace of its first epoch:
    python -m cs744_ddp_tpu_torch.cli --telemetry-out run --profile-dir prof
    python tools/telemetry_report.py run
    # serve instead of training: a seeded open-loop request trace through
    # the micro-batcher and a ladder of captured CUDA graphs:
    python -m cs744_ddp_tpu_torch.cli --serve-demo --serve-load 20 \
        --serve-load 2000 --telemetry-out run
    # the serving tier: two replicas behind the router and the socket
    # front-end, the seeded tiered trace replayed over a real socket:
    python -m cs744_ddp_tpu_torch.cli --serve-frontend --serve-replicas 2 \
        --serve-load 200 --serve-load 2000 --telemetry-out run
    # train to serve: publish each epoch's weights; a serving process
    # watching the directory hot-swaps each version between dispatches:
    python -m cs744_ddp_tpu_torch.cli --epochs 3 --publish-dir pub
    python -m cs744_ddp_tpu_torch.cli --serve-frontend --serve-publish-dir pub

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

``--host-augment`` runs the random crop and flip in the C++ host pipeline
(``native/fastloader.cpp``, built into ``build/kernels/`` at first use; a
failed build raises): a producer thread stages each window's uint8
batches through pinned memory in chunks, copied to the card while the
previous window trains.  The ``--ft-*`` flags supervise that staging.
``--require-real-data`` refuses the synthetic stand-in.

``--elastic weak|strong`` (with ``--checkpoint-dir``) trains under the
elastic coordinator (``elastic/coordinator.py``): each membership
generation is a fresh launch of one process per member GPU (gloo
processes with ``--device cpu``) on a fresh rendezvous port; a
``rank_death`` saves an emergency checkpoint and the next generation
resumes it at a smaller world.  ``--resume-world M`` starts at world M (a
checkpoint of any world is re-planned onto it).  The last line is
``elastic report: {json}``.

``--telemetry-out DIR`` writes the reference's run directory from rank 0:
``manifest.json`` (the run header; at the end also ``cuda_kernels``, what
``ops/_build.py`` built or found built, and under ``--elastic`` the
``elastic_report``), ``events.jsonl`` (step events, spans, counters,
gauges) and ``summary.json`` (written however the run ends), which
``tools/telemetry_report.py`` renders.  Under ``--elastic`` each
generation's rank 0 appends to the same directory and this process writes
the summary over all of them.  ``--profile-dir DIR`` traces the first
trained epoch with ``torch.profiler`` into ``DIR/trace_epoch<E>_rank0.json``
(a Chrome trace).

``--serve-demo`` serves instead of training (``serve/``): it captures one
CUDA graph per batch bucket of ``--serve-buckets`` and pipeline slot for
``--model`` (seed-initialized from ``--serve-seed``), replays the seeded
synthetic request trace at each ``--serve-load`` through the
micro-batcher, and prints one JSON line, ``{"startup": ..., "demo":
{"<load>rps": ...}}``; under ``--telemetry-out`` the run directory holds
the serving spans and gauges, which ``tools/telemetry_report.py`` renders
under ``== serving ==``.

``--serve-frontend`` serves through the serving tier instead:
``--serve-replicas`` engine replicas (replica i on GPU ``i % count``, two
of them sharing a card when there are fewer cards; the CPU under
``--device cpu``), each capturing its ladder before any serves, behind the
least-loaded router and the socket front-end on ``--serve-port``; the
seeded tiered trace is replayed over a real socket at each
``--serve-load``, and one JSON line ``{"address", "startup", "router",
"load"}`` is printed.  Each replica's continuous-batching SLO scheduler
keeps two dispatches in flight (``--serve-pipeline off``: one) and sheds
requests that would miss their deadline (``--serve-shed off``: serves
them late).  ``--chaos`` takes the replica sites there (``replica_death``,
``slow_replica``, ``dispatch_fault``: ``SITE:dispatch:replica``).
``--serve-trace-client DIR`` records the load client's trace spans, which
``tools/trace_waterfall.py`` (or ``python -m cs744_ddp_tpu_torch.obs.
aggregate``) merges with the server's ``--telemetry-out``.  With
``--telemetry-out`` the streaming SLO alert engine (``obs/alerts.py``)
rides the server telemetry as a tap (``--serve-alerts off``: not), and
its summary, the rules that fired, lands under ``"alerts"`` in the JSON
line and the manifest, which ``tools/telemetry_report.py`` renders under
``== alerts ==``.

``--publish-dir DIR`` publishes the serving half of the trained state
(parameters and BN statistics) every ``--publish-every`` epochs as a
versioned CCWB1 bundle (``publish/``; rank 0), in the reference's format
and layout; ``--serve-frontend --serve-publish-dir DIR`` polls DIR every
``--serve-publish-poll-ms`` and installs each new version into every
replica between dispatches, by a copy into the tensors its CUDA graphs
read: no recapture, and each reply names the version that computed it.
The JSON line then holds ``"publish"``, the watcher's report.  The
publish chaos sites (``publish_torn``, ``publish_stale``) need
``--publish-dir``; ``swap_mid_batch`` needs ``--serve-publish-dir``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .device import resolve_device
from .data import cifar10, native
from .elastic import ElasticConfig, ElasticCoordinator, Generation
from .ft import FTConfig, POLICIES, ChaosPlan, check_sites
from .models import get_model
from .obs import NULL, AlertEngine, Telemetry, read_run
from .ops import _build
from .ops.sgd import SGDConfig
from .parallel.mesh import (DEFAULT_PORT, destroy_distributed,
                            initialize_distributed, probe_devices)
from .train.loop import (GLOBAL_BATCH, PRECISIONS, STRATEGIES, Trainer,
                         elastic_config)

# The file in the checkpoint directory where rank 0 of an elastic
# generation reports how the generation ended.
GENERATION_REPORT = "elastic_generation.json"


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
    p.add_argument("--host-augment", action="store_true",
                   help="run the train transform in the C++ host pipeline "
                        "(data/native.py, the reference's DataLoader-worker "
                        "model), staged as uint8 window buffers and "
                        "trained as windows of graph replays (per-batch "
                        "f32 under --profile-phases); default keeps the "
                        "transform on the device")
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
    p.add_argument("--require-real-data", action="store_true",
                   help="fail loudly if --data-dir holds no real CIFAR-10 "
                        "pickle batches instead of silently training on the "
                        "deterministic synthetic fallback (the right mode "
                        "for any run whose accuracy numbers will be read "
                        "as CIFAR-10 results)")
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
    p.add_argument("--publish-dir", default=None,
                   help="publish the serving weights (params + BN stats) "
                        "as a versioned crc-checksummed bundle into this "
                        "directory every --publish-every completed epochs; "
                        "a serving process started with "
                        "--serve-publish-dir on the same directory "
                        "hot-swaps each version between dispatches with "
                        "no recapture (publish/)")
    p.add_argument("--publish-every", type=int, default=1, metavar="K",
                   help="publish every K completed epochs (default 1); "
                        "only meaningful with --publish-dir")
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
                        "--checkpoint-dir); with --host-augment also the "
                        "staging sites producer_crash, put_delay, "
                        "put_fail and corrupt_slot.  Rank-level sites "
                        "(the third field is the target RANK, not a seed "
                        "— SITE:step:rank): rank_death, slow_rank; "
                        "coordinator_loss fires on recovery progress "
                        "(requires --elastic); publish-level sites (step "
                        "counts the publisher's own publishes, third field "
                        "is a payload seed): publish_torn (bundle "
                        "corrupted after rename — rejected on crc, old "
                        "version keeps serving), publish_stale "
                        "(re-announces the previous version — skipped) "
                        "(require --publish-dir); under --serve-frontend "
                        "the replica sites replica_death, slow_replica, "
                        "dispatch_fault and swap_mid_batch (a pending "
                        "publish races a live dispatch: the racing "
                        "dispatch is answered by the OLD weights, the "
                        "next by the new; requires --serve-publish-dir) "
                        "(SITE:dispatch:replica), and no other")
    p.add_argument("--ft-put-timeout", type=float, default=30.0,
                   metavar="SECONDS",
                   help="watchdog deadline on each staged chunk device_put")
    p.add_argument("--ft-put-retries", type=int, default=3,
                   help="attempts per chunk device_put (exponential "
                        "backoff between attempts)")
    p.add_argument("--ft-stall-timeout", type=float, default=120.0,
                   metavar="SECONDS",
                   help="consumer-side staging stall deadline; exceeding "
                        "it triggers producer restart, then degraded "
                        "synchronous staging (stream bit-identical)")
    p.add_argument("--ft-verify-chunks", action="store_true",
                   help="checksum every staged batch at fill time and "
                        "re-stage any row whose bytes changed by transfer "
                        "time (auto-enabled by corrupt_slot chaos)")
    p.add_argument("--elastic", default="off",
                   choices=["off", "weak", "strong"],
                   help="weak = pinned per-chip batch (global batch scales "
                        "with the world; deterministic, example-measured "
                        "resume); strong = pinned global batch re-bucketed "
                        "across the world with bitwise world-invariant "
                        "math (microshard step, elastic/step_elastic.py)")
    p.add_argument("--telemetry-out", default=None, metavar="DIR",
                   help="write structured run telemetry to this directory "
                        "(rank 0): manifest.json (run header), events.jsonl "
                        "(per-step events, spans, gauges, counters) and "
                        "summary.json (steady-state percentiles); render "
                        "with tools/telemetry_report.py.  Off by default "
                        "(no file written)")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="trace the first trained epoch with torch.profiler "
                        "(CPU and CUDA activity) into a Chrome trace JSON "
                        "in this directory (rank 0)")
    p.add_argument("--resume-world", type=int, default=None, metavar="M",
                   help="run/resume at world size M (overrides "
                        "--num-devices): checkpointed progress from any "
                        "previous world is re-planned onto M under the "
                        "--elastic protocol")
    sv = p.add_argument_group(
        "serving (serve/)",
        "single-GPU inference: a ladder of captured CUDA graphs over batch "
        "buckets + micro-batching; --serve-demo replays a seeded open-loop "
        "request trace and prints the stats sheet as one JSON line instead "
        "of training")
    sv.add_argument("--serve-demo", action="store_true",
                    help="serve mode: capture the rung ladder for --model, "
                         "replay the seeded synthetic request trace at each "
                         "--serve-load, print startup + latency/throughput "
                         "JSON")
    sv.add_argument("--serve-buckets", default="1,8,32,128,256",
                    help="comma list of batch buckets for the ladder")
    sv.add_argument("--serve-precision", default="f32",
                    choices=["f32", "bf16"])
    sv.add_argument("--serve-requests", type=int, default=200,
                    help="requests per offered-load replay")
    sv.add_argument("--serve-load", action="append", type=float,
                    default=None, metavar="RPS",
                    help="offered load in requests/sec (repeatable; "
                         "default one replay at 20 rps)")
    sv.add_argument("--serve-max-wait-ms", type=float, default=5.0,
                    help="micro-batcher deadline: max time the oldest "
                         "queued request waits before dispatch")
    sv.add_argument("--serve-cache-dir", default=None,
                    help="refused: a CUDA graph has no serialized form, so "
                         "the port keeps no warm-start executable cache "
                         "(each start captures the ladder)")
    sv.add_argument("--serve-seed", type=int, default=0,
                    help="seed for the synthetic request trace AND the "
                         "demo model init")
    sv.add_argument("--serve-frontend", action="store_true",
                    help="serve mode: start --serve-replicas device-pinned "
                         "engine replicas behind the least-loaded router "
                         "and the socket front-end, replay the seeded "
                         "TIERED trace over a real socket at each "
                         "--serve-load, print goodput/SLO-attainment JSON")
    sv.add_argument("--serve-replicas", type=int, default=1, metavar="N",
                    help="engine replicas, one per GPU (round-robin when N "
                         "exceeds the GPU count)")
    sv.add_argument("--serve-slo-ms", type=float, default=None,
                    metavar="MS",
                    help="flatten the trace to ONE tier with this SLO "
                         "(default: the 3-tier 75/200/600 ms mixture)")
    sv.add_argument("--serve-port", type=int, default=0, metavar="PORT",
                    help="front-end TCP port (0 = ephemeral; the bound "
                         "address is in the output JSON — python -m "
                         "cs744_ddp_tpu_torch.serve.load replays against "
                         "it)")
    sv.add_argument("--serve-pipeline", default="on", choices=["on", "off"],
                    help="double-buffered dispatch pipeline in each "
                         "replica's scheduler: stage + issue batch N+1 "
                         "while batch N computes (off = the serial "
                         "dispatch-fence-reply loop; only with "
                         "--serve-frontend)")
    sv.add_argument("--serve-shed", default="on", choices=["on", "off"],
                    help="deadline-aware load shedding in the scheduler "
                         "(off = serve everything, late replies included "
                         "— the no-shed ablation)")
    sv.add_argument("--serve-publish-dir", default=None, metavar="DIR",
                    help="watch DIR for published weight bundles (a "
                         "--publish-dir training run's output) and "
                         "hot-swap every replica to each new version "
                         "between dispatches — zero restarts, zero "
                         "recaptures; replies carry the serving "
                         "model_version (only with --serve-frontend)")
    sv.add_argument("--serve-publish-poll-ms", type=float, default=50.0,
                    metavar="MS",
                    help="publish-directory poll interval for "
                         "--serve-publish-dir (default 50 ms)")
    sv.add_argument("--serve-trace-client", default=None, metavar="DIR",
                    help="write the in-process load client's distributed-"
                         "trace spans (events.jsonl) to DIR — a second "
                         "stream for tools/trace_waterfall.py; server "
                         "spans ride --telemetry-out (only with "
                         "--serve-frontend)")
    sv.add_argument("--serve-alerts", default="on", choices=["on", "off"],
                    help="attach the streaming SLO alert engine "
                         "(obs/alerts.py) to the server telemetry; the "
                         "fired-rule summary lands in the manifest and "
                         "the output JSON (default on; needs "
                         "--telemetry-out; only with --serve-frontend)")
    return p.parse_args(argv)


def ft_config_from_args(args: argparse.Namespace) -> Optional[FTConfig]:
    """FTConfig when any fault-tolerance flag is set, else None (the
    Trainer's ft=None path: no guard built, staging unsupervised).
    Refuses, as the reference does, NaN injection without a guard and a
    chaos preemption without a checkpoint directory, and any site the run
    would not fire (a staging site needs --host-augment, a publish site
    --publish-dir; a replica site fires under --serve-frontend, and only
    the replica sites do, swap_mid_batch with --serve-publish-dir)."""
    if (args.nonfinite == "off" and not args.chaos
            and args.ft_put_timeout == 30.0 and args.ft_put_retries == 3
            and args.ft_stall_timeout == 120.0
            and not args.ft_verify_chunks):
        return None
    try:
        plan = ChaosPlan.parse(args.chaos)
        publish = (args.serve_publish_dir if args.serve_frontend
                   else args.publish_dir)
        check_sites(plan, args.host_augment, args.elastic != "off",
                    serving=args.serve_frontend, publish=publish is not None)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if plan.steps("nonfinite_grad") and args.nonfinite == "off":
        raise SystemExit("--chaos nonfinite_grad requires --nonfinite "
                         "halt, skip or restore")
    if plan.steps("preempt") and args.checkpoint_dir is None:
        raise SystemExit("--chaos preempt requires --checkpoint-dir")
    return FTConfig(nonfinite=args.nonfinite, chaos=plan,
                    put_timeout_s=args.ft_put_timeout,
                    put_retries=args.ft_put_retries,
                    stall_timeout_s=args.ft_stall_timeout,
                    verify_chunks=args.ft_verify_chunks)


def _rank_telemetry(args: argparse.Namespace, rank: int):
    """The recorder of global rank ``rank``: ``--telemetry-out``'s on rank
    0, NULL elsewhere (one stream, as the reference's one controller
    writes)."""
    if args.telemetry_out is None or rank != 0:
        return NULL
    return Telemetry(args.telemetry_out)


def _finish_telemetry(telemetry, args: argparse.Namespace,
                      **manifest) -> None:
    """The end of a run's record, however the run ended: the kernel build
    (and ``manifest``) joins the manifest, and the summary is written."""
    telemetry.update_manifest({"cuda_kernels": _build.build_report(),
                               **manifest})
    telemetry.finalize(global_batch=args.batch_size)


def _train(args: argparse.Namespace, ft: Optional[FTConfig] = None,
           telemetry=NULL) -> Trainer:
    """Build the Trainer the flags describe (``ft``: the fault-tolerance
    config, default the flags'), run it (with ``--profile-dir``), and
    ``--save`` unless it was stopped by a preemption or a rank death."""
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
        ft=ft_config_from_args(args) if ft is None else ft,
        host_augment=args.host_augment,
        elastic=None if args.elastic == "off" else args.elastic,
        telemetry=telemetry)
    trainer.run(args.epochs, checkpoint_dir=args.checkpoint_dir,
                profile_dir=args.profile_dir, publish_dir=args.publish_dir,
                publish_every=args.publish_every)
    if args.save and not trainer.preempted and trainer.rank_death is None:
        os.makedirs(args.save, exist_ok=True)
        torch.save(trainer.state.model.state_dict(),
                   os.path.join(args.save, f"rank{trainer.rank}.pt"))
    return trainer


def _spawned_rank(local: int, args: argparse.Namespace) -> None:
    """One of ``--num-devices`` local ranks."""
    world = args.num_nodes * args.num_devices
    rank = args.rank * args.num_devices + local
    if resolve_device(args.device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // args.num_devices))
    initialize_distributed(args.master or "127.0.0.1", world, rank,
                           args.port, args.device, local_rank=local)
    telemetry = _rank_telemetry(args, rank)
    try:
        _train(args, telemetry=telemetry)
    finally:
        _finish_telemetry(telemetry, args)
        destroy_distributed()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _elastic_threads(args: argparse.Namespace, world: int) -> int:
    """A CPU rank's thread count.  The CPU's weight-gradient reductions
    give other bits on another thread count, so under strong scaling every
    rank of every generation takes the same count, whatever the world:
    the cores over the microshards (a world never exceeds them)."""
    if args.elastic == "strong":
        return max(1, (os.cpu_count() or 1) // ElasticConfig().microshards)
    return max(1, (os.cpu_count() or 1) // world)


def _elastic_rank(local: int, args: argparse.Namespace, world: int,
                  members: Tuple[int, ...], chaos: List[str],
                  port: int) -> None:
    """Rank ``local`` of one elastic generation, on local device
    ``members[local]``; rank 0 writes the generation's report and appends
    to ``--telemetry-out`` (the coordinator's process writes the
    summary)."""
    device = resolve_device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(_elastic_threads(args, world))
    initialize_distributed("127.0.0.1", world, local, port, args.device,
                           local_rank=members[local])
    try:
        ft = ft_config_from_args(args)
        if ft is not None:
            ft = ft._replace(chaos=ChaosPlan.parse(chaos))
        trainer = _train(args, ft, _rank_telemetry(args, local))
        report = {"rank_death": trainer.rank_death,
                  "fired": getattr(trainer.chaos, "fired", [])}
        del trainer
        if dist.get_rank() == 0:
            path = os.path.join(args.checkpoint_dir, GENERATION_REPORT)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(report, f)
            os.replace(tmp, path)
    finally:
        destroy_distributed()


def _launch_generation(args: argparse.Namespace, world: int,
                       members: Tuple[int, ...], epochs: int,
                       checkpoint_dir: str, chaos: List[str]) -> Generation:
    """One membership generation: ``world`` processes on a fresh
    rendezvous port, joined; rank 0's report."""
    path = os.path.join(checkpoint_dir, GENERATION_REPORT)
    if os.path.exists(path):
        os.unlink(path)
    gen_args = argparse.Namespace(**{**vars(args), "epochs": epochs,
                                     "checkpoint_dir": checkpoint_dir})
    torch.multiprocessing.spawn(
        _elastic_rank, args=(gen_args, world, tuple(members), chaos,
                             _free_port()), nprocs=world, join=True)
    with open(path) as f:
        report = json.load(f)
    death = report["rank_death"]
    return Generation(None if death is None else tuple(death),
                      tuple(tuple(e) for e in report["fired"]))


def elastic_main(args: argparse.Namespace) -> dict:
    """--elastic: train under the ``ElasticCoordinator``'s degradation
    ladder, one launch of ``world`` local processes per generation;
    ``--resume-world M`` starts (or resumes a checkpointed run) at world
    M.  Requires --checkpoint-dir: recovery and resize both go through the
    emergency checkpoint.  Prints and returns the coordinator's report,
    which joins the ``--telemetry-out`` manifest."""
    if args.checkpoint_dir is None:
        raise SystemExit("--elastic requires --checkpoint-dir (recovery "
                         "and world-resize resume go through checkpoints)")
    if args.num_nodes > 1:
        raise SystemExit("--elastic runs the ranks of one host: its "
                         "coordinator launches every generation's processes "
                         "itself (as the reference's coordinator builds "
                         "every world in one process); --num-nodes must "
                         "be 1")
    device = resolve_device(args.device)
    world = args.resume_world or args.num_devices or (
        torch.cuda.device_count() if device.type == "cuda" else 1)
    if world < 1:
        raise SystemExit("--resume-world must be >= 1")
    if device.type == "cuda":
        if world > torch.cuda.device_count():
            raise SystemExit(f"elastic world {world}: only "
                             f"{torch.cuda.device_count()} GPUs present")
        _build.build()      # once here, not once per rank
    ft = ft_config_from_args(args)
    coord = ElasticCoordinator(
        lambda w, members, epochs, ckdir, chaos: _launch_generation(
            args, w, members, epochs, ckdir, chaos),
        world=world, global_batch=args.batch_size, protocol=args.elastic,
        chaos=ft.chaos if ft is not None else ChaosPlan.parse(None),
        probe=lambda members: probe_devices(members, device.type))
    report = None
    try:
        coord.run(args.epochs, checkpoint_dir=args.checkpoint_dir)
        report = coord.report()
    finally:
        if args.telemetry_out is not None:
            # The generations' rank 0 processes wrote the manifest and the
            # events; the report and the summary over all of them are this
            # process's.
            telemetry = Telemetry(args.telemetry_out)
            telemetry.manifest = read_run(args.telemetry_out)[0]
            _finish_telemetry(telemetry, args, elastic_report=report)
    print("elastic report: " + json.dumps(report))
    return report


def serve_main(args: argparse.Namespace, telemetry) -> None:
    """--serve-demo: capture the ladder, replay the seeded trace at each
    offered load, print ONE JSON line (startup report + per-load stats)."""
    from .serve import InferenceEngine, demo

    buckets = demo.parse_buckets(args.serve_buckets)
    engine = InferenceEngine(
        args.model, buckets=buckets, precisions=(args.serve_precision,),
        seed=args.serve_seed, telemetry=telemetry, device=args.device)
    telemetry.write_manifest({
        "mode": "serve", "model": args.model, "buckets": list(buckets),
        "precision": args.serve_precision,
        "max_wait_ms": args.serve_max_wait_ms,
        "requests": args.serve_requests, "seed": args.serve_seed,
    })
    startup = engine.startup()
    stats = {}
    for rps in args.serve_load or [20.0]:
        stats[f"{rps:g}rps"] = demo.run_demo(
            engine, n_requests=args.serve_requests, offered_rps=rps,
            seed=args.serve_seed, max_wait_ms=args.serve_max_wait_ms,
            precision=args.serve_precision)
    print(json.dumps({"startup": startup, "demo": stats}))


def serve_frontend_main(args: argparse.Namespace, telemetry) -> dict:
    """--serve-frontend: the replicated serving tier end to end — N
    device-pinned engine replicas behind the least-loaded router and the
    socket front-end; replay the seeded tiered trace over a REAL socket at
    each offered load, print ONE JSON line (address, startup, router and
    per-load goodput/attainment stats; with --serve-publish-dir the
    weight watcher's report under "publish", with the alert engine its
    summary under "alerts") and return it."""
    from .ft import NULL_CHAOS
    from .serve import demo
    from .serve.frontend import FrontendClient, ServingFrontend
    from .serve.replica import EngineReplica
    from .serve.router import ReplicaRouter

    ft = ft_config_from_args(args)
    chaos = ft.chaos if ft is not None else NULL_CHAOS
    buckets = demo.parse_buckets(args.serve_buckets)
    shed = args.serve_shed == "on"
    pipeline = args.serve_pipeline == "on"
    device = resolve_device(args.device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count)
                   for i in range(max(1, args.serve_replicas))]
    else:
        devices = [device] * max(1, args.serve_replicas)
    alerts = None
    if telemetry.enabled and args.serve_alerts == "on":
        alerts = AlertEngine(telemetry)
        telemetry.add_tap(alerts.observe)
    client_tel = None
    if args.serve_trace_client is not None:
        client_tel = Telemetry(args.serve_trace_client)
        client_tel.write_manifest({"mode": "serve-frontend-client"})
    replicas = [
        EngineReplica(i, args.model, device=dev, buckets=buckets,
                      precision=args.serve_precision, seed=args.serve_seed,
                      telemetry=telemetry, chaos=chaos, shed=shed,
                      pipeline=pipeline)
        for i, dev in enumerate(devices)]
    telemetry.write_manifest({
        "mode": "serve-frontend", "model": args.model,
        "buckets": list(buckets), "precision": args.serve_precision,
        "replicas": len(replicas),
        "devices": [str(d) for d in devices], "shed": shed,
        "pipeline": pipeline, "slo_ms": args.serve_slo_ms,
        "requests": args.serve_requests, "seed": args.serve_seed,
        "chaos": chaos.spec() if chaos.enabled else [],
    })
    # Every ladder is captured before any worker starts: no capture runs
    # while another thread replays.
    startup = {f"replica{r.index}": r.startup() for r in replicas}
    tiers = demo.DEFAULT_TIERS if args.serve_slo_ms is None \
        else ((0, 1, float(args.serve_slo_ms)),)
    router = ReplicaRouter(replicas, telemetry=telemetry)
    watcher = None
    if args.serve_publish_dir is not None:
        from .publish import WeightWatcher
        watcher = WeightWatcher(
            args.serve_publish_dir, replicas, telemetry=telemetry,
            chaos=chaos, poll_interval_s=args.serve_publish_poll_ms / 1e3)
    stats = {}
    sizes = tuple(s for s in demo.SIZE_CHOICES if s <= buckets[-1])
    address = None
    # Leaving the router stops every replica, which waits for every
    # fence its worker owes (a dead replica's orphaned dispatches too).
    with router:
        if watcher is not None:
            watcher.start()
        try:
            with ServingFrontend(router, port=args.serve_port,
                                 telemetry=telemetry) as frontend:
                address = frontend.address
                pool = demo.request_pool()
                for rps in args.serve_load or [20.0]:
                    trace = demo.synthetic_load_trace(
                        args.serve_requests, offered_rps=rps,
                        seed=args.serve_seed, size_choices=sizes,
                        tiers=tiers)
                    with FrontendClient(address,
                                        telemetry=client_tel) as client:
                        stats[f"{rps:g}rps"] = demo.replay_load(
                            client, trace, pool=pool, seed=args.serve_seed)
        finally:
            if watcher is not None:
                watcher.stop()
            if client_tel is not None:
                client_tel.finalize()
    out = {"address": list(address), "startup": startup,
           "router": router.stats(), "load": stats}
    if watcher is not None:
        out["publish"] = watcher.report()
    if alerts is not None:
        out["alerts"] = alerts.summary()
    if telemetry.enabled:
        telemetry.update_manifest({"router": out["router"]})
        if watcher is not None:
            telemetry.update_manifest({"publish": out["publish"]})
        if alerts is not None:
            telemetry.update_manifest({"alerts": out["alerts"]})
    print(json.dumps(out))
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.serve_demo or args.serve_frontend:
        if args.serve_cache_dir is not None:
            raise SystemExit("--serve-cache-dir: a CUDA graph has no "
                             "serialized form, so the port keeps no "
                             "warm-start executable cache")
        telemetry = (Telemetry(args.telemetry_out)
                     if args.telemetry_out is not None else NULL)
        try:
            if args.serve_frontend:
                serve_frontend_main(args, telemetry)
            else:
                serve_main(args, telemetry)
        finally:
            telemetry.finalize()
        return
    if args.require_real_data and not cifar10.has_real_data(args.data_dir):
        raise SystemExit(
            f"--require-real-data: no CIFAR-10 pickle batches under "
            f"{args.data_dir!r} (expected "
            f"{args.data_dir}/cifar-10-batches-py/data_batch_*); "
            "refusing to fall back to the synthetic stand-in")
    get_model(args.model)     # an unknown name fails here, not in each rank
    ft = ft_config_from_args(args)    # so does a refused ft config
    if args.publish_every < 1:
        raise SystemExit(f"--publish-every must be >= 1, got "
                         f"{args.publish_every}")
    if args.resume_world is not None and args.elastic == "off":
        raise SystemExit("--resume-world requires --elastic (weak|strong): "
                         "without a declared protocol there is no defined "
                         "mapping of saved progress onto a new world size")
    if args.elastic != "off":
        try:                  # and a refused elastic config
            elastic_config(args.elastic, args.batch_size,
                           host_augment=args.host_augment,
                           profile_phases=args.profile_phases,
                           nonfinite_guard=ft is not None
                           and ft.nonfinite != "off")
        except ValueError as e:
            raise SystemExit(str(e)) from None
        elastic_main(args)
        return
    if args.num_devices is None:
        if args.num_nodes > 1:
            initialize_distributed(args.master, args.num_nodes, args.rank,
                                   args.port, args.device)
        telemetry = _rank_telemetry(args, args.rank)
        try:
            _train(args, telemetry=telemetry)
        finally:
            _finish_telemetry(telemetry, args)
            if dist.is_initialized():     # also the Trainer's world-1 group
                destroy_distributed()
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
    if args.host_augment:
        native.build()
    torch.multiprocessing.spawn(_spawned_rank, args=(args,),
                                nprocs=args.num_devices, join=True)


if __name__ == "__main__":
    main()
