#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``cs744_ddp_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-only [--root DIR]

Phases, in order; any failure exits non-zero:
  1. build   — compile the CUDA kernels from ``cs744_ddp_tpu_torch/ops/csrc``
               into ``build/kernels/`` (nvcc, sm_90a) and load them;
  2. check   — each kernel against its plain PyTorch version on the card, at
               the five VGG-11 pool-block shapes at batch 256, 128 and 64
               (the per-rank shapes at world 1, 2 and 4) and at one
               ragged shape (a short last block, C not a multiple of 32) in
               f32 (rtol 5e-4 / atol 1e-4: reduction order is the only
               difference), the sums bitwise equal run to run; the same
               shapes in bf16 (sums as in f32; dx within rtol 1e-2 of
               |dx_ref| + 1e-5 of max|dx_ref|, a few bf16 ulps, except at
               pool routings that flip: at most 2e-4 of the elements, each
               in a window whose two largest bf16 values are a near-tie);
               and the sums captured in a CUDA graph, replayed on another
               stream beside an eager call, bitwise equal to the eager
               sums; the forward kernels at the same shapes in both
               dtypes: xhat and pooled bitwise the plain version's given
               the kernel's statistics, the statistics bitwise run to run
               and within 1e-5 of batch_stats in each channel's scale;
  3. time    — per shape, the backward kernels and the forward kernels
               (statistics; normalize -> ReLU -> pool): kernel time
               (median of CUDA-event timings, L2 flushed before each
               launch), its device time alone (median
               of the profiler's kernel records, each launch after the
               flush and a read pass that leaves the L2 clean), its byte
               bound and the share of it each time reaches, the plain
               version's time, the backward of the unfused library chain
               (batch_norm -> relu -> max_pool2d) as a reference point, and
               a digest of dx's bytes (to compare two checkouts' kernels
               bit for bit); in f32, then in bf16 (lines tagged ``bf16``;
               the bound counts 2-byte xhat, dp and dx); per step the
               forward kernels together against the forward's byte bound
               (x read once, xhat and the pooled output written: 287.9 MB
               in f32, 143.9 MB in bf16 at batch 256) and the plain
               forward;
  4. train   — ``Trainer("vgg11", "single", global_batch=256)`` trains
               one whole augmented epoch on the synthetic split through its
               default windowed path (195 steps in 20-step windows, each
               step a replay of the captured CUDA graph, one fetch per
               window, then the ragged 80-row batch as one eager step) and
               evaluates 5 batches: finite losses that fall from the first
               window to the second, each kernel run 5 times per step as
               the kernels count it on the device (warm-up steps and
               replays; the wrappers' host count sees the warm-up, the
               capture and the tail), at most windows + 2 host round
               trips, ``torch.profiler`` over one more window showing
               5 x 20 runs of each kernel, and the model's logits agreeing
               with a CPU run on a small batch.  Then, in the same call,
               the per-step path (``profile_phases=True``, 40 steps), the
               phase split (``measure_phase_split``),
               ``max_memory_allocated``, the counter-keyed draws on the
               card against the CPU's, and, with deterministic cuDNN, a
               fresh Trainer's first window of 20 steps (warm-up and
               capture included) run under
               ``torch.cuda.set_sync_debug_mode("error")`` and bitwise
               equal to 20 per-step eager steps;
  5. strategies — every gradient-sync tier at world 1 over NCCL (a world-1
               group in this process), VGG-11 at batch 256, 40 augmented
               steps each through the windowed path: finite losses that
               fall from the first 20-step window to the second, the
               collective counts of every step (replay accounting), each
               kernel run 5 times per step (counted on the device),
               ``torch.profiler`` over one more replayed window showing
               5 x 20 runs of each kernel, and the steady step time and
               images/s, beside the per-step path's, run in the same call;
               then, with deterministic cuDNN, each stateless tier bitwise
               equal to ``single`` after 20 windowed steps, and
               ``compress-int8`` and ``powersgd`` as in phase 4's bitwise
               and sync-debug check.
               With two or more GPUs, every tier also trains 40 steps on
               2 and ``min(4, count)`` NCCL ranks (the CLI's
               ``--num-devices``): the reference's dataset-size lines for
               that world, falling losses, rank 0's steady step time, and
               bitwise equal parameters on every rank at the end;
  6. models  — the model zoo and bf16 mixed precision, batch 256, full
               width, augmentation on:
               VGG-11 bf16 ``single``, 40 windowed and 40 per-step steps:
               falling losses, each bnpool kernel (its bf16 variant) run 5
               times a step on the device (215 windowed: 3 warm-up steps
               and 40 replays; 200 per-step), the profiler's 100/100 over
               one more window, the logits of fresh weights against a CPU
               run (train, then eval mode; within twice the CPU's own
               bf16-vs-f32 distance + 1e-3);
               ResNet-18 f32 ``allreduce`` on a world-1 NCCL group (the
               BASELINE.json config #5 on one card), 40 windowed and 40
               per-step steps: falling losses, 62 all-reduces a step, 0
               bnpool runs, fresh weights' logits against the CPU (rtol /
               atol 1e-3);
               ResNet-18 ``ddp``: as many all-reduces a step as
               ``bucketing.make_plan`` makes buckets of its 62 gradients;
               ResNet-18 bf16 ``allreduce``, 40 windowed steps, falling
               losses; ResNet-34 f32 and bf16 ``single``, 40 windowed steps,
               finite losses; each run's steady step, images/s and
               ``max_memory_allocated`` above what was held before it;
               with deterministic cuDNN the
               bitwise windowed = per-step check of phase 4 for VGG-11
               bf16 ``single`` and ResNet-18 f32 ``allreduce``; with two or
               more GPUs, ResNet-18 ``allreduce`` on ``min(4, count)``
               NCCL ranks through the CLI (``--model resnet18``);
  7. ft      — checkpoints, preemption and the non-finite guard on
               VGG-11 f32 ``single``, batch 256, full width, augmentation
               on, 60 batches (three windows) and 2 eval batches, with
               deterministic cuDNN: ``run(2)`` against ``run(1)`` saved
               plus a fresh Trainer's resumed ``run(2)``, bitwise; a chaos
               ``preempt:25`` stopping at the boundary at 40 with an
               emergency save and a fresh Trainer resuming there, bitwise
               equal to one uninterrupted epoch, each bnpool kernel run 5
               times a step on the device in both halves; ``--nonfinite
               skip`` with no fault bitwise equal to the unguarded run.
               Then NaN gradients at batch 30 under ``skip`` for
               ``single``, ``compress-int8`` and ``powersgd`` (world-1
               NCCL): the ring's ok column 0 at batch 30 only, one update
               skipped, finite losses and state; ``halt`` raises; a fresh
               guarded Trainer's first window with a planned fault under
               sync-debug "error"; the steady step with the guard off and
               on, f32 and bf16, in turns; a checkpoint's bytes and the
               wall time of its save, restore and emergency save for
               VGG-11 and ResNet-34 f32.  With two or more GPUs, the CLI
               on 2 NCCL ranks, ``compress-int8 --deterministic
               --checkpoint-dir D --chaos preempt:25``, then the same
               command again: every rank's ``--save`` bitwise equal to an
               uninterrupted 2-rank run's;
  8. host    — ``--host-augment`` on VGG-11 ``single``, batch 256, full
               width, ``host_chunks`` 4: the native loader built from
               ``native/fastloader.cpp`` and loaded; one whole epoch
               through ``run(1)`` (195 windowed steps from chunk-staged
               C++-augmented buffers, the 80-row tail as one eager f32
               step, 5 eval batches): falling losses, each kernel run 5
               times a step on the device, at most windows + 2 host round
               trips, each window's chunk_wait; the device's idle share
               over a 60-step host epoch (``torch.profiler``); with
               deterministic cuDNN, 40 windowed steps bitwise equal to 40
               per-step f32 steps and to ``host_chunks`` 1, the window
               buffer's sha256 on the card equal to the CPU's
               ``gather_augment_u8`` stream and its normalize on the card
               equal to ``native.augment``'s f32; ``put_fail``,
               ``producer_crash`` once (a restart) and twice (degraded) and
               ``corrupt_slot`` with ``verify_chunks`` over 60 steps, each
               bitwise the healthy run; and the steady step of the
               host-augment and the device-augment windowed paths, f32 and
               bf16, whole 100-step epochs in turns;
  9. elastic — ``--elastic strong`` on VGG-11 f32, batch 256 in S = 4
               microshards of 64, ``allreduce``, augmentation on,
               deterministic cuDNN: a world-1 strong Trainer's 60-step
               windowed epoch (each step a replay of the captured
               microshard step): falling finite losses, one
               ``all_gather`` a step and no other collective, each
               bnpool kernel run 20 times a step on the device, the
               steady step and images/s against the non-elastic windowed
               step of the same tree (whole epochs in turns); virtual
               worlds 2 and 4 on the card (each rank's rows from its
               microshards, concatenated in rank order in place of the
               gather) bitwise the world-1 Trainer's state after 20
               steps; the CLI (``--num-devices 1 --elastic strong
               --checkpoint-dir D --chaos preempt:25``, then the same
               command without the fault) bitwise an uninterrupted CLI
               run, whose ``--telemetry-out`` directory renders the
               ``elastic`` section (strong, 4 microshards; rank 0's step
               time); with two or more GPUs the CLI at world 2 with
               ``--chaos rank_death:25:1``, shrinking to world 1 and
               ending bitwise that uninterrupted world-1 run, and the CLI
               at world ``min(4, count)`` bitwise it too;
 10. telemetry — the cost of ``--telemetry-out`` first, in a fresh process
               that has started no profiler
               (``utils/profile_telemetry.py``): VGG-11 ``allreduce``
               windowed, batch 256, steady steps off, on and of a second
               Trainer with it off in turns, f32 and bf16, recorded, and
               an epoch's host round trips and bnpool runs the same off
               and on (a limit).  Then the
               port's CLI in this process, VGG-11 f32 ``allreduce``,
               batch 256, windowed, ``--limit-train-batches 60
               --limit-eval-batches 4 --telemetry-out D --profile-dir P``,
               and VGG-11 ``--precision bf16`` with ``--telemetry-out``:
               ``manifest.json`` names the card (``backend`` cuda,
               ``device_kind``) and the kernels' build; ``events.jsonl``
               holds one step event per trained step, each with a finite
               ``grad_sqnorm`` and its ``step_index``; ``summary.json``
               equals ``summarize_events`` of the events; the
               ``host_round_trips`` counter totals at most windows + 2;
               ``device_memory`` and ``memory`` gauges nonzero; the
               all-reduce counters equal the ``Group``'s 34 a step and
               the gradients' MiB; the f32 run's profiler trace holds the
               bnpool kernels, as many runs of each as the kernels counted
               on the device in that epoch (5 x (3 warm-up steps + 60
               replays)); each run directory rendered (see "Rendering"
               below) with 60 steps;
 11. serve   — the serving engine (``serve/``), VGG-11 at full width,
               seed-0 weights, buckets {1, 8, 32, 128, 256}, f32 and bf16:
               the ladder's capture time per rung (the cold start: a CUDA
               graph has no serialized form) and its peak
               ``max_memory_allocated``; in every bucket a request's rows
               bitwise the same alone and with batchmates before or after
               it at every fill; against the eager forward at the exact
               size n in {1, 3, 8, 20, 100, 200} (f32 rtol/atol 1e-4,
               bf16 1e-2; which n are bitwise is printed); against the
               same weights on the CPU (``logits_vs_cpu``'s bounds,
               ``correct`` equal; an unlabeled request gives loss 0 and
               correct 0); two bucket-256 dispatches in flight bitwise the
               serial ones, a third issue waiting on the first slot's
               fence, and no synchronizing call on the dispatch path
               (sync-debug "error"); recorded: each bucket's median
               ``infer_counts`` and images/s and the graph replay alone
               (CUDA events), bucket 256 two in flight against serial,
               ``run_demo`` at 20 and 2000 rps (400 requests); then the
               CLI ``--serve-demo --telemetry-out D`` on the card, its
               last line and the serving gauges of its run directory,
               rendered with the ``serving`` and ``traces`` sections and
               no ``slo``; and no bnpool kernel run over the whole phase;
 12. serve_tier — the serving tier (``serve/``: scheduler, replicas,
               router, socket front-end): two VGG-11 f32 ``EngineReplica``s
               at full width, seed-0 weights, buckets {1, 8, 32, 128,
               256}, replica i on card ``i % count`` (both on ``cuda:0``
               on one card), recording into an in-memory ``Telemetry``,
               each ladder captured before any worker starts (capture
               seconds and peak ``max_memory_allocated`` printed), a few
               dispatches of every bucket to warm each replica's service
               model; then behind the router and a ``ServingFrontend`` on
               localhost a ``FrontendClient`` replays the seeded
               ``synthetic_load_trace`` (400 requests, ``DEFAULT_TIERS``)
               under ``torch.profiler`` (``utils/profile_serve_tier.py::
               run_load``) at 200 rps with the pipelined workers under
               sync-debug "error" (no synchronizing call on the dispatch
               path), at 2000 rps, and the same 2000-rps trace with the
               serial workers: every request exactly one reply, none an
               error; each ok or late reply's logits bitwise its serving
               replica's serial ``infer_counts`` of the request padded to
               the bucket that served it (the replica and bucket read from
               the ``serve_service_ms`` records), and within rtol/atol
               1e-4 of the request alone (how many bitwise is printed: the
               bits depend on the bucket); the two 2000-rps runs bitwise
               equal wherever a request rode in the same bucket, and a
               request that rode in another bitwise both replicas' serial
               dispatch in each of its buckets; recorded per load:
               client round-trip p50, p95 and p99 by tier, attainment,
               ok/late/shed/overload counts, achieved rps and images/s,
               the driver's lag, the router's routed and failovers, the
               device's busy share by card (the union of the kernels'
               intervals over the wall), the replicas' host busy share
               (their service clock over the wall), the CPU share of each
               group of threads, and the dispatches: by replica and
               bucket, images a dispatch, the median host time of a
               staging.  Then chaos
               through the router: ``dispatch_fault`` (errors only for its
               batch, the rest bitwise serial), ``slow_replica`` (each
               tier-0 request of 75 ms submitted more than its SLO before
               the stall's end sheds or is late, with reasons; at least
               one is, in at most 3 tries), ``replica_death`` (every
               request ok on the
               survivor, each future resolved once, the dead engine's
               in-flight dispatch fenced); then the CLI
               ``--serve-frontend --serve-replicas 2 --telemetry-out D``
               on the card, its last line and run directory, rendered
               with the ``slo``, ``pipeline`` and ``waterfall`` sections;
               and no bnpool kernel run over the whole phase;
 13. publish — train to serve (``publish/``): ``Trainer("vgg11",
               "single", global_batch=256)`` at full width runs 2 epochs
               of 40 windowed steps with ``run(publish_dir=)``, publishing
               each epoch's weights as CCWB1 bundles v1 and v2: falling
               finite losses, each bnpool kernel run 5 times a step on the
               device (3 warm-up steps and 80 replays), each bundle
               36,946,472 bytes in 50 leaves and bitwise the trainer's
               serving leaves at its epoch, the publish wall time.  Then
               two f32 ``EngineReplica``s on ``cuda:0`` behind the router
               and the socket front-end, at seed-0 weights, install v1
               through a ``WeightWatcher`` (50 ms poll); 400 requests of
               one tier (10 s SLO) at 200 rps with no swap, then with a
               version published 1 s into the replay, installed rolling
               and then all at once: every request one reply, each ok;
               each replica's dispatches on one version each, never an
               older one than the last; each reply bitwise the serial
               dispatch, padded to its bucket, of a third engine on the
               card with the reply's version installed through
               ``install_weights``, and within 1e-4 of the eager forward;
               v1 and v2 answering differently; the same CUDA graphs and
               weight addresses after the swaps; printed: p50 and p99
               with and without a swap, the publish and the publish to
               installed lag, ``swap_ms`` by replica.  The same at bf16
               for one replica (bitwise its own serial dispatch, 1e-2 of
               the bf16 eager forward).  Chaos on replica 0:
               ``publish_stale`` skipped, ``publish_torn`` rejected with
               the old version serving bitwise, ``swap_mid_batch`` (the
               racing dispatch wholly on the old version, the next on
               the new, the probe's time on the worker thread printed);
               and no bnpool kernel run in the serving half.  Then the
               training's and the serving half's in-memory recorders,
               each written to a directory with no ``summary.json``,
               rendered: both with the ``publish`` section, the training's
               with its 80 steps;
 14. obs     — serving observability and the cost model: the CLI
               ``--serve-frontend --serve-alerts on --telemetry-out S
               --serve-trace-client C``, one VGG-11 replica on the card,
               400 requests at 200 rps: every request one reply, no alert
               fired, the manifest's ``alerts`` the last line's, none on a
               replay of its records (the rules' time a record printed);
               the cost-model prior (``cost_model_weights`` of a VGG-11
               engine of the same buckets) is counted before it starts,
               so nothing else runs beside it; then ``python -m
               cs744_ddp_tpu_torch.obs.aggregate S C --json`` with that
               prior (the CPU tests hold it equal to
               ``tools/trace_waterfall.py``'s report): the client's
               clock skew from at least 10 pairs, at least 10 complete
               waterfalls spanning both processes, each with
               ``device_compute`` and its stage sum within the client's
               round trip plus the skew bound; printed: per-stage p50/p99,
               the client round trip's, and ``measured_over_prior`` by
               bucket.  The same CLI with two replicas, ``--chaos
               slow_replica:0:0 --serve-shed off --serve-slo-ms 0.01``:
               every request served, and exactly ``SLO_BURN`` and
               ``STRAGGLER`` fired.  Both server directories rendered:
               the drill's ``alerts`` section lists exactly the fired
               rules, the clean run's has none.  Then the VGG-11 ``single`` train step
               at batch 256 in f32 and bf16: ``step_flops_per_image``
               (``Trainer.step_cost``, the cost model on meta tensors),
               the steady step of one 20-step window of replays,
               ``mfu_fields``, ``attribute`` (f32 against the f32 peak,
               ``max_memory_allocated`` of the window as its peak), and
               each bnpool kernel run 5 times a step on the device in that
               window;
 15. audit   — static analysis: ``python -m cs744_ddp_tpu_torch.cli
               --verify-static`` (the lints, the lock graph, the wire
               schema, the VGG-11 zoo traced on meta tensors and audited,
               the round-trip certificate, the memory self-check) exits 0
               and prints ``[audit] CLEAN`` (its wall time printed); then
               the CLI in this process, VGG-11 f32 ``single``, batch 256,
               one whole windowed epoch (195 steps and the 80-row tail) and
               2 eval batches, ``--audit strict --telemetry-out D``: the
               manifest's ``audit`` clean, ``collective_totals.chain_depth``
               a number (0), the ``host_round_trips`` counter equal to
               ``dispatch.epoch_round_trip_bound("window", 195, 20,
               tail_batch=True, include_eval=True)`` exactly, each bnpool
               kernel run 5 times a step on the device, the audit's peak
               (the window's static bound) printed beside
               ``max_memory_allocated`` over the run above what was held
               before it, and their ratio, both under
               ``H100_HBM_CAPACITY_BYTES``; the run directory rendered with
               the ``audit`` section (``CLEAN``, its programs) and the
               ``memory`` section (the gauges against each program's
               ``peak_mib``).  Then, on a world-1 NCCL group, ``allreduce`` and
               ``ddp``: the real ``Group``'s counts, bytes and link record
               of one eager step and of one replay of the captured step
               equal to the audit's counted step of the same strategy;
 16. moe     — the expert layer's grouped products (``ops/moe.py``, the
               library's grouped GEMM) at the Moonlight cell's shapes
               (2048 -> 2816 and 1408 -> 2048 over 8 held experts, in the
               294,912-row buffer of 6 x 8,192 tokens): forward, dX and dW
               through autograd against the plain version on the card
               under mean, uneven, empty-group and one-hot loads (each
               group within a bf16 rounding, rows past the groups and an
               empty group's dW exactly zero); at the mean and one-hot
               loads each product's CUDA-event ms, its library kernels'
               device ms alone and its FLOP bound; then Moonlight at the
               published widths (one dense and two expert layers, bf16,
               4 x 2,048 tokens a step) trains one windowed epoch with the
               products' device counters zeroed just before: their runs
               a step, ``flops`` and ``rows`` as the steps imply, and
               the row kernels' ``row_rows`` (7 x ``rows``) and
               ``row_capacity`` (7 launches a layer-step of the static
               rows); before it the row kernels
               (``ops/csrc/moe_rows.cu``) at the cell's shapes (49,152
               tokens' top 6, hidden 2048, expert width 1408) under
               uniform routing's 36,864 held rows and the heaviest seen
               in the cell, 42,416: each checked against its plain
               version, its CUDA-event ms, its device ms alone beside
               its byte bound at 3.35 TB/s, and the plain version's ms;
 17. report  — the ``kernels`` JSON line (each kernel in f32, with the
               main path's runs, and in bf16, with the VGG-11 bf16 path's;
               ``launches_by_path`` also holds the host, elastic, serve,
               serve_tier, publish, obs and audit paths' runs; then the
               grouped products of phase moe, route ``library``), the
               card's name and power limit, and as the last line
               ``{"ok": true, "device": {...}}``.

Rendering: each run directory above goes through ``python -m
cs744_ddp_tpu_torch.obs.report DIR`` and then ``DIR --json`` in a process
of its own: each exits 0 with nothing on stderr; the render holds the
sections that the phase's records imply (and not those they rule out),
its ``steps recorded N (S steady)`` line counts the directory's step
events and the summary's steady steps, and ``--json`` prints
``summary.json`` (or ``summarize_events`` of the records where the
directory has none).  One ``[report]`` line a directory gives its
sections, each command's wall and ``render()``'s alone.  The CPU tests
hold the module's output equal to the JAX package's
``tools/telemetry_report.py``, which needs JAX and is not run here.

``--time-only`` runs phases 1 and 3 and stops; ``--moe`` runs phases 1
and 16 and prints their ``kernels`` line.  ``--root DIR`` times the
kernels of the checkout at DIR instead (for example the parent commit,
unpacked with ``git archive``), so that two versions are compared in one
run on one card.  ``--tune-dx`` runs phase 1, then times the dx kernel at
the five VGG-11 pool shapes in both dtypes over a range of partitions
(threads a block x windows a thread, ``tune_dx``), checks that each gives
the same dx bits, marks ``bnpool.dx_partition``'s choice, and stops.

Without a CUDA device it exits with code 2 and prints no result.  It
imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
# f32 operations per element of xhat, counted from the kernels' source.
# Sums, per window: mul, add, max per element (12), the window max (3),
# the first maximal element (3 compares, 3 selects), the gate and two sums
# (4): 25.  dx (window_dx), per window: mul, add, max per element (12), the
# window max (3), the first-maximum compare, the gate and its select per
# element (12), the formula's three products and two differences per
# element (20): 47, 11.75 per element.
SUMS_OPS_PER_ELEM = 7
DX_OPS_PER_ELEM = 12
# The forward kernels, per element of x: the statistics' add and
# multiply-add (f32: the two passes' add, subtract and multiply-add), 3;
# normalize -> ReLU -> pool's subtract, multiply, two roundings, multiply,
# add, the ReLU and the window's compare, 8.
STATS_OPS_PER_ELEM = 3
NORM_POOL_OPS_PER_ELEM = 8
BATCH = 256
CLEAN_REPS = 20
# The kernels' names in a profiler trace, by wrapper.
KERNEL_FRAGMENT = {"bnpool_sums": "sums_kernel", "bnpool_dx": "dx_kernel",
                   "bnpool_stats": "stats_kernel",
                   "bnpool_norm_pool": "norm_pool_kernel"}
# Partitions tune_dx tries: threads a block x windows a thread.
TUNE_THREADS = (64, 128, 256)
TUNE_WINDOWS = (1, 2, 4, 8)
# [N, C, H, W] of the five pool blocks of VGG-11 at batch 256 (s0..s4).
SHAPES = [(BATCH, 64, 32, 32), (BATCH, 128, 16, 16), (BATCH, 256, 8, 8),
          (BATCH, 512, 4, 4), (BATCH, 512, 2, 2)]
# The same blocks at the per-rank batches of worlds 2 and 4.
CHECK_SHAPES = SHAPES + [(n, c, h, w) for n in (BATCH // 2, BATCH // 4)
                         for _, c, h, w in SHAPES]
# 387 pooled rows of 3 windows and 24 channel vectors (16 of the 256
# threads idle): in f32 129 blocks, whose first 32 add up the partials
# 4 float4 columns each, the last of them 0 (48 columns in all).
RAGGED = (129, 96, 6, 6)
TRAIN_STEPS = 40
FT_STEPS = 60                   # phase ft: three 20-step windows
HOST_STEPS = 40                 # phase host: the bitwise path checks
HOST_FT_STEPS = 60              # phase host: staging chaos
HOST_TIME_STEPS = 100           # phase host: timing, steps 21-100 steady
ELASTIC_STEPS = 60              # phase elastic: three 20-step windows
MICROSHARDS = 4
EVAL_FT = 2
EPOCH_ROWS = 50000              # the training split: 195 batches + 80 rows
EVAL_BATCHES = 5
RTOL, ATOL = 5e-4, 1e-4
# bf16 dx against its plain version: rtol of |dx_ref| (2.5 bf16 ulps) and
# atol as a share of max|dx_ref|, far below the mean-correction terms
# (~1e-3 of a routed |dx|) that every element carries.  Elements outside
# that bound are routing flips: at most FLIP_SHARE of them, each in a
# window whose two largest values differ by less than NEAR_TIE relatively.
BF16_RTOL, BF16_ATOL_SHARE = 1e-2, 1e-5
FLIP_SHARE, NEAR_TIE = 2e-4, 2e-2
TIERS = ("gather", "allreduce", "ddp", "overlap", "compress-bf16",
         "compress-int8", "powersgd")
STATELESS = TIERS[:4]
BITWISE_STEPS = 20
PROFILE_PAD_S = 0.25            # idle host time traced around a window
WINDOW = 20
# Collectives per VGG-11 step (34 parameters, two 25 MiB buckets, 9
# low-rank leaves), by kind.
STEP_COUNTS = {
    "gather": {"gather": 34, "scatter": 34}, "allreduce": {"all_reduce": 34},
    "ddp": {"all_reduce": 2}, "overlap": {"all_reduce": 2},
    "compress-bf16": {"all_reduce": 34},
    "compress-int8": {"all_reduce": 34, "all_reduce_max": 1},
    "powersgd": {"all_reduce": 2 * 9 + 25}}


# Phase moe: the expert layer's grouped products (ops/moe.py) at the
# Moonlight cell's shapes: gate-and-up (2048 -> 2 x 1408) and down
# (1408 -> 2048) over the 8 experts a chip holds, in the buffer a layer
# allocates for 6 x 8,192 tokens (each token's 6 experts: 294,912 rows).
MOE_ROWS = 6 * 8192 * 6
MOE_GROUPS = 8
MOE_WIDTHS = ((2048, 2816), (1408, 2048))
# Rows of each held expert; "mean" is uniform routing's 4,608 an expert.
MOE_LOADS = {"mean": [4608] * 8,
             "uneven": [9000, 13, 4608, 0, 12000, 517, 64, 10662],
             "empty": [0, 0, 20000, 0, 0, 16864, 0, 0],
             "one_hot": [0, 0, 0, 36864, 0, 0, 0, 0]}
MOE_TIMED = ("mean", "one_hot")
# Library against the plain version on the same bf16 operands: both round
# f32 sums once to bf16 (dW: the library's bf16 against f32), so the
# relative L2 gap of a group stays within a bf16 rounding; a row of
# another group or an offset off by a tile reads as about 1.
MOE_RTOL = 4e-3
BF16_PEAK_FLOPS = 989.4e12      # H100 SXM dense bf16
# The library's grouped GEMM in a trace: CUTLASS's grouped kernel and the
# kernel that lays out the groups' problems from the device offsets (the
# names portbench's grouped_mm_roofline_pct.train reads).
GMM_FRAGMENTS = ("GroupProblemShape", "prepare_grouped_gemm_data")
# The row kernels of phase moe at the cell's shapes: 6 x 8,192 tokens' top
# 6 (MOE_ROWS rows), hidden 2048, expert width 1408; held rows a
# layer-step: uniform routing's 36,864 and the heaviest load the cell has
# shown, 42,416 (PERF.md section 4), placed at random among the rows.
MOE_TOKENS, MOE_TOP_K, MOE_HIDDEN, MOE_WIDTH = 6 * 8192, 6, 2048, 1408
MOE_ROW_LOADS = {"mean": 36864, "heaviest": 42416}
# The main path of phase moe: Moonlight at the published widths with one
# dense and two expert layers, bf16, 4 sequences of 2,048 tokens a step,
# one epoch of 24 sequences (6 steps: one captured window).
MOE_LAYERS, MOE_SEQ, MOE_BATCH, MOE_SEQS = 3, 2048, 4, 24


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        out = f"{torch.cuda.get_device_name(0)}, power limit unread ({e})"
    return out


def inputs(shape, dtype, seed):
    """A block's backward inputs from its forward: x with injected exact
    ties (values rounded to halves), gamma, beta, and a random dP."""
    from cs744_ddp_tpu_torch.ops import bnpool
    n, c, h, w = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, h, w, c), generator=g, device="cuda") * 2 + 0.3
    tie = torch.rand((n, h, w, c), generator=g, device="cuda") < 0.3
    x = torch.where(tie, torch.round(x * 2) / 2, x).to(dtype)
    x = x.permute(0, 3, 1, 2)                     # channels_last
    gamma = torch.randn(c, generator=g, device="cuda") * 0.5 + 1.0
    beta = torch.randn(c, generator=g, device="cuda") * 0.2
    _, xhat, _, _, inv = bnpool.bn_relu_pool_forward(x, gamma, beta)
    dp = torch.randn((n, h // 2, w // 2, c), generator=g,
                     device="cuda").to(dtype).permute(0, 3, 1, 2)
    return x, xhat.to(dtype), dp, gamma, beta, inv


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` in ms, L2 flushed before each call."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, fragment, flush, evict) -> float:
    """Median device duration in ms of the kernel whose name holds
    ``fragment``, over CLEAN_REPS calls of ``fn`` (each launching it once),
    from torch.profiler's kernel records: no host time is inside.  Before
    each call ``flush`` is zeroed and ``evict`` (larger than the L2) is
    read, so the L2 holds no dirty line and no line of the kernel's
    inputs.  The trace holds PROFILE_PAD_S of idle time on each side, as
    ``window_profile``'s does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(CLEAN_REPS):
            flush.zero_()
            evict.sum()
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and fragment in e.name]
    check(len(times) == CLEAN_REPS, f"the profiler saw {len(times)} "
          f"{fragment} runs of {CLEAN_REPS}")
    return statistics.median(times) / 1e3


def digest(t: torch.Tensor) -> str:
    """The first 16 hex digits of the sha256 of ``t``'s bytes in NHWC
    order."""
    import hashlib
    raw = t.permute(0, 2, 3, 1).contiguous().cpu().view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


def phase_build():
    from cs744_ddp_tpu_torch.ops import _build
    t0 = time.perf_counter()
    compiled = _build.build(log=print)
    _build.library("bnpool.cu")
    print(f"[build] {compiled or 'cached'}; total "
          f"{time.perf_counter() - t0:.2f} s")


def check_sums_bitwise(bnpool, xhat, dp, gamma, beta, label):
    """The sums of two calls bitwise equal; the first call's sums."""
    sums = bnpool.bnpool_sums(xhat, dp, gamma, beta)
    check(torch.equal(sums, bnpool.bnpool_sums(xhat, dp, gamma, beta)),
          f"{label}: sums not bitwise reproducible")
    return sums


def check_sums_in_graph(bnpool, xhat, dp, gamma, beta, label):
    """The sums captured in a CUDA graph on one stream and replayed on
    another, beside an eager call on the current stream, bitwise equal to
    the eager sums."""
    eager = bnpool.bnpool_sums(xhat, dp, gamma, beta)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        captured = bnpool.bnpool_sums(xhat, dp, gamma, beta)
    replay = torch.cuda.Stream()
    for _ in range(3):
        replay.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(replay):
            graph.replay()
        alongside = bnpool.bnpool_sums(xhat, dp, gamma, beta)
        torch.cuda.synchronize()
        check(torch.equal(captured, eager) and torch.equal(alongside, eager),
              f"{label}: sums in a CUDA graph differ from eager sums")
    print(f"[check] {label}: sums captured in a CUDA graph and replayed on "
          f"another stream beside an eager call: bitwise equal  ok")


def phase_check(errs):
    from cs744_ddp_tpu_torch.ops import bnpool
    for k, shape in enumerate(CHECK_SHAPES + [RAGGED]):
        _, xhat, dp, gamma, beta, inv = inputs(shape, torch.float32, k)
        got = bnpool.bnpool_backward(xhat, dp, gamma, beta, inv)
        want = bnpool.bnpool_backward_reference(xhat, dp, gamma, beta, inv)
        for a, b, name in zip(got, want, ("dx", "sum_dy", "sum_dy_xhat")):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL,
                                       msg=lambda m: f"{shape} {name}: {m}")
        sums_ref = bnpool.bnpool_sums_reference(xhat, dp, gamma, beta)
        sums = check_sums_bitwise(bnpool, xhat, dp, gamma, beta,
                                  f"f32 {shape}")
        dx = bnpool.bnpool_dx(xhat, dp, gamma, beta, inv, sums_ref)
        dx_ref = bnpool.bnpool_dx_reference(xhat, dp, gamma, beta, inv,
                                            sums_ref)
        e_sums = float((sums - sums_ref).abs().max())
        e_dx = float((dx - dx_ref).abs().max())
        errs["bnpool_sums"] = max(errs["bnpool_sums"], e_sums)
        errs["bnpool_dx"] = max(errs["bnpool_dx"], e_dx)
        torch.cuda.synchronize()
        print(f"[check] f32 {shape}: max|sums err| {e_sums:.3e} (bitwise "
              f"run to run)  max|dx err| {e_dx:.3e}  ok")
    check_sums_in_graph(bnpool, xhat, dp, gamma, beta, f"f32 {RAGGED}")
    for dtype in (torch.float32, torch.bfloat16):
        for k, shape in enumerate(CHECK_SHAPES + [RAGGED]):
            check_forward(bnpool, shape, dtype, 200 + k, errs)

    for k, shape in enumerate(CHECK_SHAPES + [RAGGED]):
        _, xhat, dp, gamma, beta, inv = inputs(shape, torch.bfloat16, 99 + k)
        sums_ref = bnpool.bnpool_sums_reference(xhat, dp, gamma, beta)
        sums = check_sums_bitwise(bnpool, xhat, dp, gamma, beta,
                                  f"bf16 {shape}")
        torch.testing.assert_close(
            sums, sums_ref, rtol=RTOL, atol=ATOL,
            msg=lambda m: f"bf16 {shape} sums: {m}")
        e_sums = float((sums - sums_ref).abs().max())
        dx = bnpool.bnpool_backward(xhat, dp, gamma, beta, inv)[0].float()
        dx_ref = bnpool.bnpool_backward_reference(xhat, dp, gamma, beta,
                                                  inv)[0].float()
        e_dx, flips, worst = check_bf16_dx(bnpool, xhat, gamma, beta, dx,
                                           dx_ref, f"bf16 {shape}")
        errs["bnpool_sums_bf16"] = max(errs["bnpool_sums_bf16"], e_sums)
        errs["bnpool_dx_bf16"] = max(errs["bnpool_dx_bf16"], e_dx)
        torch.cuda.synchronize()
        print(f"[check] bf16 {shape}: max|sums err| {e_sums:.3e} (bitwise "
              f"run to run); max|dx err| {e_dx:.3e} outside routing flips "
              f"(at most {worst:.3f} of the bound); {flips} dx flip(s) of "
              f"{dx.numel()} elements, each at a near-tie  ok")


def check_forward(bnpool, shape, dtype, seed, errs):
    """The forward kernels at one shape against their plain version: xhat
    and pooled bitwise normalize_relu_pool's with the kernel's own
    statistics; the statistics bitwise run to run and within 1e-5 of
    batch_stats, relative to each channel's |mean| + std (mean) and var
    (f32) or E[x^2] (bf16; its one pass cancels that much)."""
    x, _, _, gamma, beta, _ = inputs(shape, dtype, seed)
    pooled, xhat, mean, var, inv = bnpool.bn_relu_pool_forward(x, gamma,
                                                               beta)
    want_pooled, want_xhat = bnpool.normalize_relu_pool(x, mean, inv, gamma,
                                                        beta)
    check(torch.equal(xhat, want_xhat.to(dtype))
          and torch.equal(pooled, want_pooled),
          f"{dtype} {shape}: forward kernels' xhat or pooled differ from "
          f"the plain version's with the same statistics")
    again = bnpool.bnpool_stats(x)
    check(all(torch.equal(a, b) for a, b in zip(again, (mean, var, inv))),
          f"{dtype} {shape}: statistics not bitwise reproducible")
    m32, v32, _ = bnpool.batch_stats(x)
    xf = x.float()
    scale = (m32.abs() + v32.sqrt(),
             v32 if dtype == torch.float32 else xf.square().mean((0, 2, 3)))
    err = max(float(((mean - m32).abs() / scale[0]).max()),
              float(((var - v32).abs() / scale[1]).max()))
    check(err <= 1e-5, f"{dtype} {shape}: statistics {err:.3e} from "
          f"batch_stats")
    suffix = "" if dtype == torch.float32 else "_bf16"
    errs["bnpool_stats" + suffix] = max(errs["bnpool_stats" + suffix], err)
    errs["bnpool_norm_pool" + suffix] = 0.0
    tag = "f32" if dtype == torch.float32 else "bf16"
    print(f"[check] {tag} {shape} forward: xhat and pooled bitwise the "
          f"plain version's with the kernel's statistics; statistics "
          f"bitwise run to run, {err:.3e} from batch_stats in scale  ok")


def check_bf16_dx(bnpool, xhat, gamma, beta, dx, dx_ref, label):
    """bf16 dx (as f32) against its plain version: every element within
    BF16_RTOL * |dx_ref| + BF16_ATOL_SHARE * max|dx_ref|, except routing
    flips, which must be few and each in a near-tie window.  Returns the
    largest error outside flips, the number of flipped elements and the
    largest share of the bound reached outside them."""
    err = (dx - dx_ref).abs()
    bound = BF16_RTOL * dx_ref.abs() + BF16_ATOL_SHARE * dx_ref.abs().max()
    flipped = err > bound
    flips = int(flipped.sum())
    check(flips <= FLIP_SHARE * dx.numel(),
          f"{label}: {flips} dx elements outside rtol {BF16_RTOL} / atol "
          f"{BF16_ATOL_SHARE} of max|dx_ref|")
    # The window's two largest y, as the routing compares them.
    z = (xhat.float() * gamma.view(1, -1, 1, 1) + beta.view(1, -1, 1, 1))
    y = z.to(torch.bfloat16).float().clamp_min(0)
    top = torch.stack(bnpool._quadrants(y)).sort(dim=0).values
    near = (top[-1] - top[-2]).abs() < NEAR_TIE * (top[-1].abs() + 1e-9)
    in_flip = torch.stack(bnpool._quadrants(flipped)).any(dim=0)
    check(not bool((in_flip & ~near).any()),
          f"{label}: a dx element outside the bound is in no near-tie "
          f"window")
    kept = ~flipped
    return (float(err[kept].max()), flips,
            float((err[kept] / bound[kept]).max()))


def chain_backward(x, gamma, beta, dp):
    """The unfused library chain's backward, as a closure to time."""
    import torch.nn.functional as F
    xg = x.detach().clone().requires_grad_(True)
    g = gamma.detach().clone().requires_grad_(True)
    b = beta.detach().clone().requires_grad_(True)
    out = F.max_pool2d(F.relu(F.batch_norm(xg, None, None, g, b, True)), 2, 2)
    return lambda: torch.autograd.grad(out, (xg, g, b), dp,
                                       retain_graph=True)


def phase_time(card_line):
    """Both dtypes' times: {dtype name: per-kernel totals}.  Every CUDA-event
    timing (kernels, plain versions, the library chain) comes before the
    first profiler session (``device_ms``): once one has run, each launch
    costs the host more, and the event timings hold host time."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    evict = torch.ones(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    rows = {name: event_times(dtype, flush) for name, dtype in dtypes.items()}
    for name, dtype in dtypes.items():
        add_device_times(rows[name], dtype, flush, evict)
    return {name: report_times(card_line, dtype, rows[name])
            for name, dtype in dtypes.items()}


def time_work(bnpool, xhat, dp, gamma, beta, inv, sums):
    """Each kernel's call, its plain version's, and the bytes and f32
    operations its bound counts (xhat, dp and dx at the dtype's size)."""
    vec = gamma.nbytes + beta.nbytes
    return {
        "bnpool_sums": (
            lambda: bnpool.bnpool_sums(xhat, dp, gamma, beta),
            lambda: bnpool.bnpool_sums_reference(xhat, dp, gamma, beta),
            xhat.nbytes + dp.nbytes + vec + sums.nbytes,
            SUMS_OPS_PER_ELEM * xhat.numel()),
        "bnpool_dx": (
            lambda: bnpool.bnpool_dx(xhat, dp, gamma, beta, inv, sums),
            lambda: bnpool.bnpool_dx_reference(xhat, dp, gamma, beta,
                                               inv, sums),
            2 * xhat.nbytes + dp.nbytes + vec + inv.nbytes + sums.nbytes,
            DX_OPS_PER_ELEM * xhat.numel())}


def forward_work(bnpool, x, gamma, beta):
    """The forward kernels' calls, their plain parts' (``batch_stats``;
    ``normalize_relu_pool`` and the cast of xhat to x's dtype, as the plain
    forward ran them in the step), and each kernel's bytes (x read once;
    xhat and the pooled output written; the channel vectors) and f32
    operations; {} where ``bnpool`` has no forward kernels (``--root`` on
    a checkout from before them)."""
    if not hasattr(bnpool, "bnpool_stats"):
        return {}
    mean, _, inv = bnpool.bnpool_stats(x)
    c = x.shape[1]

    def plain_norm_pool():
        pooled, xhat = bnpool.normalize_relu_pool(x, mean, inv, gamma, beta)
        return pooled, xhat.to(x.dtype)

    return {
        "bnpool_stats": (
            lambda: bnpool.bnpool_stats(x),
            lambda: bnpool.batch_stats(x),
            x.nbytes + 3 * c * 4, STATS_OPS_PER_ELEM * x.numel()),
        "bnpool_norm_pool": (
            lambda: bnpool.bnpool_norm_pool(x, mean, inv, gamma, beta),
            plain_norm_pool,
            2 * x.nbytes + x.nbytes // 4 + 4 * c * 4,
            NORM_POOL_OPS_PER_ELEM * x.numel())}


def forward_bytes(x) -> int:
    """The least the forward moves: x read once, xhat and the pooled
    output written, gamma and beta read, mean, var and inv written."""
    return 2 * x.nbytes + x.nbytes // 4 + 5 * x.shape[1] * 4


def event_times(dtype, flush):
    """Phase 3's CUDA-event column at one dtype, per VGG-11 pool shape:
    each kernel's time (``time_ms``), its plain version's, its bound, the
    unfused library chain's backward, and the digest of dx."""
    from cs744_ddp_tpu_torch.ops import bnpool
    rows = []
    for k, shape in enumerate(SHAPES):
        x, xhat, dp, gamma, beta, inv = inputs(shape, dtype, k)
        sums = bnpool.bnpool_sums(xhat, dp, gamma, beta)
        row = {"shape": shape}
        work = {**time_work(bnpool, xhat, dp, gamma, beta, inv, sums),
                **forward_work(bnpool, x, gamma, beta)}
        for name, (kernel, plain, nbytes, ops) in work.items():
            row[name] = dict(
                ms=time_ms(kernel, 20, flush),
                plain_ms=time_ms(plain, 5, flush),
                bound_ms=max(nbytes / HBM_BYTES_PER_S,
                             ops / F32_OPS_PER_S) * 1e3,
                bytes=nbytes, ops=ops)
        row["forward_bytes"] = forward_bytes(x)
        row["chain_ms"] = time_ms(chain_backward(x, gamma, beta, dp), 10,
                                  flush)
        row["digest"] = digest(bnpool.bnpool_dx(xhat, dp, gamma, beta, inv,
                                                sums))
        rows.append(row)
    return rows


def add_device_times(rows, dtype, flush, evict):
    """Phase 3's profiler column: each kernel's device time alone
    (``device_ms``) at each row's shape, on the same inputs."""
    from cs744_ddp_tpu_torch.ops import bnpool
    for k, row in enumerate(rows):
        x, xhat, dp, gamma, beta, inv = inputs(row["shape"], dtype, k)
        sums = bnpool.bnpool_sums(xhat, dp, gamma, beta)
        work = {**time_work(bnpool, xhat, dp, gamma, beta, inv, sums),
                **forward_work(bnpool, x, gamma, beta)}
        for name, (kernel, _, _, _) in work.items():
            row[name]["device_ms"] = device_ms(kernel, KERNEL_FRAGMENT[name],
                                               flush, evict)


def report_times(card_line, dtype, rows):
    """Phase 3's lines at one dtype (the f32 lines untagged, the bf16
    lines tagged ``bf16``): per shape both timings and both shares of the
    bound, the plain version, the library chain and dx's digest; then per
    step (5 blocks).  Returns the per-kernel totals."""
    tag = "" if dtype == torch.float32 else " bf16"
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bytes", "ops")
    tot = {k: dict.fromkeys(keys, 0.0) for k in KERNEL_FRAGMENT
           if k in rows[0]}
    chain_total = 0.0
    fwd_bytes = sum(row["forward_bytes"] for row in rows)
    for row in rows:
        parts = []
        for name, t in tot.items():
            r = row[name]
            for key in keys:
                t[key] += r[key]
            parts.append(
                f"{name} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
                f"{100 * r['bound_ms'] / r['ms']:.1f}% of it; device alone "
                f"{r['device_ms']:.4f} ms, "
                f"{100 * r['bound_ms'] / r['device_ms']:.1f}% of it; plain "
                f"{r['plain_ms']:.4f})")
        chain_total += row["chain_ms"]
        print(f"[time]{tag} {row['shape']}: " + "; ".join(parts)
              + f"; unfused library chain backward {row['chain_ms']:.4f} ms; "
              f"dx sha256 {row['digest']}  [{card_line}]")
    for name, t in tot.items():
        print(f"[time]{tag} per step (5 blocks) {name}: {t['ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bytes'] / 1e6:.1f} MB, "
              f"{100 * t['bound_ms'] / t['ms']:.1f}% of it); device alone "
              f"{t['device_ms']:.4f} ms "
              f"({100 * t['bound_ms'] / t['device_ms']:.1f}% of it); plain "
              f"{t['plain_ms']:.4f} ms  [{card_line}]")
    print(f"[time]{tag} per step (5 blocks) kernels together "
          f"{tot['bnpool_sums']['ms'] + tot['bnpool_dx']['ms']:.4f} ms vs "
          f"unfused library chain backward {chain_total:.4f} ms  "
          f"[{card_line}]")
    if "bnpool_stats" not in tot:
        return tot
    fwd = {key: tot["bnpool_stats"][key] + tot["bnpool_norm_pool"][key]
           for key in keys}
    bound_ms = fwd_bytes / HBM_BYTES_PER_S * 1e3
    tot["forward"] = dict(fwd, bound_ms=bound_ms, bytes=fwd_bytes)
    print(f"[time]{tag} per step (5 blocks) forward kernels together: "
          f"{fwd['ms']:.4f} ms; device alone {fwd['device_ms']:.4f} ms "
          f"(stats {tot['bnpool_stats']['device_ms']:.4f}, norm_pool "
          f"{tot['bnpool_norm_pool']['device_ms']:.4f}); the forward's "
          f"bound {bound_ms:.4f} ms ({fwd_bytes / 1e6:.1f} MB: x read "
          f"once, xhat and pooled written), {100 * bound_ms / fwd['ms']:.1f}"
          f"% of it, device alone {100 * bound_ms / fwd['device_ms']:.1f}%;"
          f" plain forward {fwd['plain_ms']:.4f} ms  [{card_line}]")
    return tot


def tune_dx(card_line):
    """The dx kernel's device time alone (``device_ms``) at the five VGG-11
    pool shapes in both dtypes, at each partition of TUNE_THREADS x
    TUNE_WINDOWS and at ``bnpool.dx_partition``'s rule for each of
    TUNE_WINDOWS windows a thread, launched through the C entry point
    (these launches count nowhere); dx bitwise equal to the wrapper's at
    every partition.  Per step, the rule at each count of windows a thread
    beside its default (``bnpool._DX_WINDOWS``), which the wrapper
    uses."""
    from cs744_ddp_tpu_torch.ops import _build, bnpool
    lib = _build.library("bnpool.cu")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    evict = torch.ones(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    ran = torch.zeros(1, dtype=torch.int64, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        tag = "" if dtype == torch.float32 else " bf16"
        fn = getattr(lib, f"bnpool_dx_{bnpool._SUFFIX[dtype]}")
        rule = dict.fromkeys(TUNE_WINDOWS + ("default",), 0.0)
        for k, shape in enumerate(SHAPES):
            _, xhat, dp, gamma, beta, inv = inputs(shape, dtype, k)
            n, c, h, w = shape
            item = xhat.element_size()
            sums = bnpool.bnpool_sums(xhat, dp, gamma, beta)
            want = bnpool.bnpool_dx(xhat, dp, gamma, beta, inv, sums)
            dx = torch.empty_like(want)
            vectors, windows = c // (16 // item), n * (h // 2) * (w // 2)

            def launch(threads, blocks):
                err = fn(xhat.data_ptr(), dp.data_ptr(), gamma.data_ptr(),
                         beta.data_ptr(), inv.data_ptr(), sums.data_ptr(),
                         dx.data_ptr(), n, h, w, c, threads, blocks,
                         ran.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
                _build.check(lib, err, "bnpool_dx")

            def per_thread(threads, blocks):
                lanes = min(vectors, threads)
                tiles = blocks // -(-vectors // lanes)
                return -(-windows // (threads // lanes * tiles))

            rules = {per: bnpool.dx_partition(n, c, h, w, item,
                                              per_thread=per)
                     for per in TUNE_WINDOWS}
            rules["default"] = bnpool.dx_partition(n, c, h, w, item)
            grids = set(rules.values()) | {
                (t, -(-vectors // min(vectors, t)) * -(-windows // (
                    t // min(vectors, t) * per)))
                for t in TUNE_THREADS for per in TUNE_WINDOWS}
            times = {}
            for threads, blocks in sorted(grids):
                dx.fill_(float("nan"))
                times[threads, blocks] = device_ms(
                    lambda: launch(threads, blocks), "dx_kernel", flush,
                    evict)
                check(torch.equal(dx, want), f"{shape}{tag}: dx at "
                      f"{threads} threads x {blocks} blocks differs from "
                      f"the wrapper's")
            for per, grid in rules.items():
                rule[per] += times[grid]
            cells = [f"{t}x{b} ({per_thread(t, b)} a thread) {ms:.4f}"
                     + ("*" if (t, b) == rules["default"] else "")
                     for (t, b), ms in sorted(times.items())]
            print(f"[tune]{tag} {shape} dx device ms by threads x blocks, "
                  f"* = dx_partition, dx bitwise equal at each: "
                  + "; ".join(cells) + f"  [{card_line}]")
        print(f"[tune]{tag} per step (5 blocks), dx_partition's rule at "
              f"each count of windows a thread and at its default (at most "
              f"{bnpool._DX_WINDOWS[item]}): "
              + "; ".join(f"{per}: {ms:.4f} ms" for per, ms in rule.items())
              + f"  [{card_line}]")


def steady(timers):
    """(steady step ms, images/s) of an epoch's timers."""
    return (1e3 * statistics.mean(timers.steady_step_times),
            timers.steady_images_per_sec(BATCH))


def check_losses(label, losses, steps):
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"{label}: losses {losses}")
    first, second = (statistics.mean(losses[:20]),
                     statistics.mean(losses[20:40]))
    check(second < first, f"{label}: loss did not fall: {first} -> {second}")
    return first, second


def kernel_counts():
    """(runs counted by the kernels on the device, launches counted by the
    wrappers on the host) since the last reset."""
    from cs744_ddp_tpu_torch.ops import bnpool
    return bnpool.executed_counts(), bnpool.launch_counts()


def train_tier(tier, steps, log=lambda s: None, model="vgg11", **kw):
    """A fresh Trainer of ``model`` (VGG-11 by default) and ``tier`` trained
    ``steps`` augmented steps from the same seed (windowed unless
    ``profile_phases=True``), and the kernels' runs and launches in that
    training, counted from 0."""
    from cs744_ddp_tpu_torch.ops import bnpool
    from cs744_ddp_tpu_torch.train.loop import Trainer

    trainer = Trainer(model=model, strategy=tier, global_batch=BATCH,
                      augment=True, limit_train_batches=steps, log=log, **kw)
    bnpool.reset_launch_counts()
    trainer.train_model(0)
    torch.cuda.synchronize()
    return (trainer, *kernel_counts())


def variants(precision, n, forward=None):
    """Each kernel variant's expected count: ``n`` for the ``precision``
    variants of the backward kernels, ``forward`` (by default ``n`` too:
    a training step runs each kernel once a pool block) for those of the
    forward kernels, 0 for the others."""
    from cs744_ddp_tpu_torch.ops import bnpool
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    want = dict.fromkeys(bnpool.KERNELS, 0)
    want.update({bnpool.kernel_name(k, dtype): n for k in bnpool.BACKWARD})
    want.update({bnpool.kernel_name(k, dtype): n if forward is None
                 else forward for k in bnpool.FORWARD})
    return want


def check_runs(label, runs, launches, steps, replayed, precision="f32"):
    """Each kernel's ``precision`` variant ran 5 times a step on the
    device (runs), the other variants never; the wrappers launched 5 a
    step eagerly, and on the windowed path (``replayed`` steps) 5 for each
    warm-up step and 5 into the captured graph.  The per-step path
    (``replayed`` 0, ``profile_phases``) runs the forward-only program
    before each step: the forward kernels 5 more times a step."""
    from cs744_ddp_tpu_torch.train.step import WARMUP_ITERS
    eager = steps - replayed
    if replayed:
        eager += WARMUP_ITERS
    fwd_only = 0 if replayed else 5 * steps
    runs_n = 5 * (eager + replayed)
    launches_n = 5 * (eager + (1 if replayed else 0))
    want_runs = variants(precision, runs_n, runs_n + fwd_only)
    want_launches = variants(precision, launches_n, launches_n + fwd_only)
    check(runs == want_runs, f"{label}: kernels ran {runs} times on the "
          f"device, want {want_runs}")
    check(launches == want_launches, f"{label}: wrappers launched "
          f"{launches}, want {want_launches}")


def check_bitwise_paths(tier, model="vgg11", precision="f32"):
    """With deterministic cuDNN (set by the caller): 20 windowed steps
    bitwise equal to 20 per-step eager steps, losses and every tensor the
    step carries.  The windowed Trainer is fresh and its one window (the
    warm-up, the capture and 20 replays) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: no host sync in it."""
    from cs744_ddp_tpu_torch.train.loop import Trainer
    from cs744_ddp_tpu_torch.train.step import state_tensors

    win = Trainer(model=model, strategy=tier, precision=precision,
                  global_batch=BATCH, augment=True,
                  limit_train_batches=BITWISE_STEPS, log=lambda s: None)
    window = win.train_window()       # stages the epoch: host copies
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = window(0, 0, BITWISE_STEPS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    losses = window.losses_of(out.cpu().numpy(), 0, BITWISE_STEPS)
    per = train_tier(tier, BITWISE_STEPS, model=model, precision=precision,
                     profile_phases=True)[0]
    check([float(v) for v in losses] == per.last_epoch_timers.losses,
          f"{model} {precision} {tier}: windowed losses differ from the "
          f"per-step path's")
    a, b = state_tensors(win.state), state_tensors(per.state)
    check(len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)),
          f"{model} {precision} {tier}: windowed state differs from the "
          f"per-step path's")
    label = tier if (model, precision) == ("vgg11", "f32") else \
        f"{model} {precision} {tier}"
    print(f"[bitwise] {label}, deterministic cuDNN: {BITWISE_STEPS} windowed "
          f"steps (graph replays) bitwise equal to {BITWISE_STEPS} per-step "
          f"eager steps ({len(a)} tensors and the losses); the fresh "
          f"Trainer's window, warm-up and capture included, under "
          f"torch.cuda.set_sync_debug_mode('error'): no host sync  ok")


def window_profile(trainer, w=WINDOW, per_step=5):
    """One more replayed window of ``w`` steps under ``torch.profiler``,
    CUDA activity only, no schedule: the runs of each bnpool kernel
    variant in the trace and counted on the device, all device events in
    the trace, and the collectives the replay accounting added.  Each
    kernel's variant of the trainer's precision must show ``per_step`` * w
    runs both ways (5 on a VGG-11, 0 on a ResNet), the others none.

    Kineto drops as out of range the records it stamps outside the
    trace's span, and it has stamped a replayed window's first kernels
    tens of ms before their launch call.  So no schedule is used (its
    warm-up step would put the window's start inside one trace), and the
    trace holds ``PROFILE_PAD_S`` of idle time on each side of the window
    (``utils/profile_window_counts.py`` measures all three)."""
    from collections import Counter
    from cs744_ddp_tpu_torch.ops import bnpool
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    window = trainer.train_window()
    want = variants("bf16" if trainer.compute_dtype == torch.bfloat16
                    else "f32", per_step * w)
    before = Counter(trainer.group.total_counts) if trainer.group else None
    bnpool.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        window(0, 0, w).cpu()
        time.sleep(PROFILE_PAD_S)
    runs = bnpool.executed_counts()
    names = Counter(e.name for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    seen = bnpool.profiled_runs(names)
    check(seen == want and runs == want,
          f"a {w}-step window: torch.profiler saw {seen} kernel runs, the "
          f"device counted {runs}, want {want}")
    added = None if before is None else \
        dict(trainer.group.total_counts - before)
    return seen, sum(names.values()), added


def phase_train(card_line):
    from cs744_ddp_tpu_torch.data import augment as aug
    from cs744_ddp_tpu_torch.models import get_model
    from cs744_ddp_tpu_torch.ops import bnpool
    from cs744_ddp_tpu_torch.train.loop import Trainer

    # The main path: one whole epoch as the CLI trains it, the ragged last
    # batch included.
    trainer = Trainer(model="vgg11", strategy="single", global_batch=BATCH,
                      augment=True, limit_eval_batches=EVAL_BATCHES)
    torch.cuda.reset_peak_memory_stats()
    bnpool.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.run(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs, launches = kernel_counts()
    max_mem = torch.cuda.max_memory_allocated()
    full, tail_rows = divmod(EPOCH_ROWS, BATCH)
    staged = trainer.train_window().images.shape[0]
    check(staged == full, f"the epoch staged {staged} full batches")
    steps = full + 1
    losses = trainer.last_epoch_timers.losses
    first, second = check_losses("single", losses, steps)
    check_runs("single, windowed epoch", runs, launches, steps, full)
    windows = -(-full // WINDOW)
    check(trainer.host_round_trips <= windows + 2,
          f"{trainer.host_round_trips} host round trips for {windows} "
          f"windows, the tail and an eval")
    step_ms, ips = steady(trainer.last_epoch_timers)
    print(f"[train] windowed path: one epoch, {full} steps in {windows} "
          f"windows of graph replays + the ragged tail of "
          f"{tail_rows} rows as one eager step (loss "
          f"{losses[-1]:.4f}) + {EVAL_BATCHES} eval batches in {wall:.2f} s; "
          f"mean loss {first:.4f} (steps 1-20) -> {second:.4f} (21-40); "
          f"kernel runs counted on the device {runs} (5 a step: "
          f"3 warm-up steps, {full} replays, the tail), wrapper launches "
          f"{launches} (warm-up, capture, tail); host round trips "
          f"{trainer.host_round_trips}; max_memory_allocated "
          f"{max_mem / 2 ** 20:.1f} MiB")
    print(f"[train] windowed path: steady step {step_ms:.3f} ms, "
          f"{ips:.1f} images/s (steps 21-{full}, batch {BATCH}, f32, TF32 "
          f"off)  [{card_line}]")
    seen, events, _ = window_profile(trainer)
    print(f"[train] torch.profiler over one more {WINDOW}-step window: "
          f"{seen} kernel runs ({events} device events), as counted on the "
          f"device  ok")

    per, per_runs, per_launches = train_tier("single", TRAIN_STEPS,
                                             profile_phases=True)
    check_losses("single per-step", per.last_epoch_timers.losses,
                 TRAIN_STEPS)
    check_runs("single, per-step path", per_runs, per_launches,
               TRAIN_STEPS, 0)
    check(per.host_round_trips >= TRAIN_STEPS,
          f"per-step path: {per.host_round_trips} host round trips")
    per_ms, per_ips = steady(per.last_epoch_timers)
    fwd_ms = 1e3 * statistics.mean(per.last_epoch_timers.steady_forward_times)
    print(f"[train] per-step path: steady step {per_ms:.3f} ms, "
          f"{per_ips:.1f} images/s, forward-only program {fwd_ms:.3f} ms "
          f"(steps 21-40); host round trips {per.host_round_trips}; "
          f"kernel runs {per_runs}  [{card_line}]")

    # The model's forward on the card against the same weights on the CPU
    # (plain versions there), on a small batch: train-mode logits (batch
    # statistics, fused op) and eval-mode logits (running statistics).
    model = trainer.state.model
    cpu = get_model("vgg11").to(memory_format=torch.channels_last)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((32, 32, 32, 3), generator=g, device="cuda")
    x = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        for train in (True, False):
            model.train(train)
            cpu.train(train)
            got, want = model(x).cpu(), cpu(x.cpu())
            check(got.shape == (32, 10) and bool(torch.isfinite(got).all()),
                  f"logits {tuple(got.shape)} not finite")
            # Summation order through 8 conv+BN layers (GPU vs CPU, f32).
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    print("[train] logits on the card agree with the CPU (train and eval "
          "mode, batch 32)  ok")

    split = trainer.measure_phase_split(window_iters=TRAIN_STEPS, windows=3)
    print(f"[train] phase split (windowed, slope between windows of "
          f"{split['window_iters']} and {split['window_iters'] // 2} steps, "
          f"min of 3): forward {split['forward_ms_per_iter']:.3f} ms, "
          f"backward + update {split['backward_ms_per_iter']:.3f} ms, step "
          f"{split['step_ms_per_iter']:.3f} ms per step; fixed cost of a "
          f"train window {split['dispatch_ms_step_window']:.3f} ms  "
          f"[{card_line}]")
    bnpool.reset_launch_counts()
    trainer.fwd_window()(0, 0, WINDOW).cpu()
    fwd_runs = bnpool.executed_counts()
    check(fwd_runs == variants("f32", 0, 5 * WINDOW),
          f"a {WINDOW}-step forward-only window ran the kernels {fwd_runs} "
          f"times on the device")
    print(f"[train] forward-only window ({WINDOW} replays, captured by the "
          f"phase split): kernel runs {fwd_runs}, the forward kernels "
          f"alone  ok")

    key = aug.stream_key(trainer.seed, 0)
    batch = torch.from_numpy(trainer.train_split.images[:BATCH].copy())
    on_card = aug.draws(BATCH, key, torch.tensor(3, device="cuda"),
                        torch.tensor(17, device="cuda"))
    on_cpu = aug.draws(BATCH, key, torch.tensor(3), torch.tensor(17))
    check(all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)),
          "counter-keyed draws differ between the card and the CPU")
    check(torch.equal(aug.crop_flip(batch.cuda(), *on_card).cpu(),
                      aug.crop_flip(batch, *on_cpu)),
          "crop/flip differs between the card and the CPU")
    print(f"[train] counter-keyed draws and crops of one batch of {BATCH}: "
          f"the card's equal the CPU's  ok")

    torch.backends.cudnn.deterministic = True
    try:
        check_bitwise_paths("single")
    finally:
        torch.backends.cudnn.deterministic = False
    return runs, launches, {"single/window (epoch)": runs,
                            "single/per-step": per_runs,
                            "single/forward-only window": fwd_runs}


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_cli(args):
    """``python -m cs744_ddp_tpu_torch.cli ARGS`` started in a session of
    its own (a timeout kills the ranks it spawned); ``finish_cli`` waits
    for it."""
    cmd = [sys.executable, "-m", "cs744_ddp_tpu_torch.cli"] + list(args)
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True,
                            env={**os.environ, "PYTHONFAULTHANDLER": "1"},
                            cwd=os.path.dirname(os.path.abspath(__file__)))


def finish_cli(proc, label, timeout=600):
    """A started CLI's stdout, or a failure.  On a timeout every process
    of its session first dumps its threads' Python stacks (faulthandler,
    on SIGABRT), and the failure carries the output's tails."""
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGABRT)
        try:
            stdout, stderr = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            stdout, stderr = proc.communicate()
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        raise SmokeFailure(f"{label}: no end in {timeout} s:\n"
                           f"{stdout[-4000:]}\n{stderr[-12000:]}")
    check(proc.returncode == 0, f"{label} failed:\n"
          f"{stdout[-3000:]}\n{stderr[-3000:]}")
    return stdout


def kill_cli(proc):
    """Kill a started CLI's session, if it still runs."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()


def run_cli(args, label, timeout=600):
    """``start_cli`` and ``finish_cli``: the CLI's stdout, or a
    failure."""
    return finish_cli(start_cli(args), label, timeout)


# The report's section headers (``obs/report.py``), by a short name.
REPORT_SECTIONS = {
    "manifest": "== run manifest ==", "steps": "== steady-state steps ==",
    "spans": "== spans (total wall clock) ==",
    "counters": "== counters (final) ==", "serving": "== serving ==",
    "elastic": "== elastic ==", "audit": "== program audit ==",
    "memory": "== memory (measured vs certified) ==",
    "traces": "== traces (request causality) ==",
    "slo": "== slo (tiered attainment) ==",
    "publish": "== publish (weight hot-swap) ==",
    "pipeline": "== dispatch pipeline ==",
    "waterfall": "== waterfall (distributed traces, this stream) ==",
    "alerts": "== alerts ==", "gauges": "== gauges (last value) =="}


def report_alert_rules(text):
    """The rule ids a render's ``== alerts ==`` section lists."""
    lines = text.splitlines()
    if REPORT_SECTIONS["alerts"] not in lines:
        return []
    rules = []
    for line in lines[lines.index(REPORT_SECTIONS["alerts"]) + 1:]:
        if not line:
            break
        rules.append(line.split()[0])
    return rules


def write_run_dir(tel, run_dir):
    """An in-memory ``Telemetry``'s manifest (if it has one) and records
    as a run directory with no ``summary.json``."""
    from cs744_ddp_tpu_torch.obs.telemetry import atomic_write_json
    os.makedirs(run_dir)
    if tel.manifest is not None:
        atomic_write_json(os.path.join(run_dir, "manifest.json"),
                          tel.manifest)
    with open(os.path.join(run_dir, "events.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in tel.records)


def render_run_dir(label, run_dir, sections, absent=(), steps=None):
    """``python -m cs744_ddp_tpu_torch.obs.report RUN_DIR``, then with
    ``--json``: each exits 0 with nothing on stderr; the render holds the
    headers of ``sections`` in order and none of ``absent``; its step line
    counts the directory's step events (``steps`` of them, when given) and
    the summary's steady steps; ``--json`` prints ``summary.json``, or
    ``summarize_events`` of the records where the directory has none.
    Prints a ``[report]`` line: the headers, each command's wall and the
    render's alone in this process.  Returns the render."""
    from cs744_ddp_tpu_torch.obs import read_run, report, summarize_events

    manifest, events, summary = read_run(run_dir)
    if summary is None:
        summary = summarize_events(
            events, global_batch=(manifest or {}).get("global_batch"))
    nsteps = sum(e.get("kind") == "step" for e in events)
    check(steps is None or nsteps == steps,
          f"{label}: {nsteps} step events, want {steps}")
    out, wall = {}, {}
    for mode, extra in (("text", []), ("json", ["--json"])):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "cs744_ddp_tpu_torch.obs.report",
             run_dir] + extra, capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        wall[mode] = time.perf_counter() - t0
        check(proc.returncode == 0 and proc.stderr == "",
              f"{label}: the report {' '.join(extra)} exited "
              f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        out[mode] = proc.stdout
    t0 = time.perf_counter()
    text = report.render(run_dir)
    alone = time.perf_counter() - t0
    check(out["text"] == text + "\n",
          f"{label}: the module's output is not render()'s")
    found = [line for line in text.splitlines()
             if line in REPORT_SECTIONS.values()]
    want = [REPORT_SECTIONS[s] for s in sections]
    check([h for h in found if h in want] == want
          and not {REPORT_SECTIONS[s] for s in absent} & set(found),
          f"{label}: report sections {found}, want {want}, none of "
          f"{list(absent)}")
    check(f"  steps recorded         {nsteps} "
          f"({summary['num_steady_steps']} steady)" in text.splitlines(),
          f"{label}: no step line of {nsteps} step events, "
          f"{summary['num_steady_steps']} steady, in\n{text[:3000]}")
    check(json.loads(out["json"]) == json.loads(json.dumps(summary)),
          f"{label}: report --json is not the directory's summary")
    names = [s for h in found for s, v in REPORT_SECTIONS.items() if v == h]
    kept = os.path.exists(os.path.join(run_dir, "summary.json"))
    print(f"[report] {label}: python -m cs744_ddp_tpu_torch.obs.report "
          f"({len(events)} records, {nsteps} steps, "
          f"{summary['num_steady_steps']} steady"
          f"{'' if kept else ', no summary.json'}): sections {names}; "
          f"--json = the summary; wall {wall['text']:.3f} s, --json "
          f"{wall['json']:.3f} s, render() alone {1e3 * alone:.3f} ms  ok")
    return text


def spawn_world(world, tier, out_dir, card_line, model="vgg11"):
    """``world`` NCCL ranks of the CLI (``--num-devices``) training
    ``tier`` on ``model`` 40 steps: the reference's dataset-size lines for
    that world, finite losses that fall from the first 20-step window to
    the second, and every rank's final parameters bitwise equal to rank
    0's."""
    import re
    save = os.path.join(out_dir, f"{model}_{tier}_w{world}")
    t0 = time.perf_counter()
    stdout = run_cli(["--num-devices", str(world), "--strategy", tier,
                      "--model", model,
                      "--limit-train-batches", str(TRAIN_STEPS),
                      "--limit-eval-batches", "2", "--port",
                      str(free_port()), "--save", save],
                     f"{world} NCCL ranks of {tier}")
    wall = time.perf_counter() - t0
    per = BATCH // world
    for line in (f"Size of training set is {-(-(-(-50000 // world)) // per)}",
                 f"Size of test set is {-(-10000 // per)}"):
        check(line in stdout.splitlines(),
              f"{tier} at world {world}: no line {line!r}")
    losses = [float(v) for v in re.findall(
        r"Training loss after \d+ iterations is (\S+)", stdout)]
    check(len(losses) == 2 and all(math.isfinite(v) for v in losses)
          and losses[1] < losses[0],
          f"{tier} at world {world}: window losses {losses}")
    step_s = float(re.search(r"Average Pass time in iter 40 is (\S+)",
                             stdout).group(1))
    sds = [torch.load(os.path.join(save, f"rank{r}.pt"), map_location="cpu")
           for r in range(world)]
    for r, sd in enumerate(sds[1:], 1):
        for k, v in sd.items():
            check(torch.equal(v, sds[0][k]),
                  f"{tier} at world {world}: rank {r} differs in {k}")
    phase, label = ("strategies", tier) if model == "vgg11" else \
        ("models", f"{model} {tier}")
    print(f"[{phase}] {label:13s} world {world} NCCL ({world} processes): "
          f"steady step {1e3 * step_s:.3f} ms, {BATCH / step_s:.1f} images/s "
          f"(rank 0's steps 21-40, global batch {BATCH}); loss "
          f"{losses[0]:.4f} -> {losses[1]:.4f}; parameters and BN "
          f"statistics bitwise equal on every rank; {wall:.1f} s  ok  "
          f"[{card_line}]")


def phase_strategies(card_line):
    """Every tier at world 1 over NCCL; see the module docstring.  No
    group exists before the first Trainer: it makes the world-1 group
    itself, as it does for a user who started no launcher."""
    import torch.distributed as dist

    check(not dist.is_initialized(), "a process group exists already")
    launches = {}
    for tier in TIERS:
        t0 = time.perf_counter()
        trainer, runs, launched = train_tier(tier, TRAIN_STEPS)
        check(dist.get_backend() == "nccl" and trainer.world == 1,
              f"{tier}: expected a world-1 NCCL group, got "
              f"{dist.get_backend()} at world {trainer.world}")
        launches[f"{tier}/window"] = runs
        first, second = check_losses(tier, trainer.last_epoch_timers.losses,
                                     TRAIN_STEPS)
        want = {k: n * TRAIN_STEPS for k, n in STEP_COUNTS[tier].items()}
        counts = dict(trainer.group.total_counts)
        check(counts == want, f"{tier}: collectives {counts} in "
              f"{TRAIN_STEPS} steps, want {want}")
        check_runs(f"{tier}, windowed", runs, launched, TRAIN_STEPS,
                   TRAIN_STEPS)
        seen, events, added = window_profile(trainer)
        want_window = {k: n * WINDOW for k, n in STEP_COUNTS[tier].items()}
        check(added == want_window, f"{tier}: a {WINDOW}-step window added "
              f"collectives {added}, want {want_window}")
        step_ms, ips = steady(trainer.last_epoch_timers)
        wall = time.perf_counter() - t0

        per, per_runs, per_launched = train_tier(tier, TRAIN_STEPS,
                                                 profile_phases=True)
        launches[f"{tier}/per-step"] = per_runs
        check_losses(f"{tier} per-step", per.last_epoch_timers.losses,
                     TRAIN_STEPS)
        per_counts = dict(per.group.total_counts)
        check(per_counts == want, f"{tier} per-step: collectives "
              f"{per_counts} in {TRAIN_STEPS} steps, want {want}")
        check_runs(f"{tier}, per-step", per_runs, per_launched, TRAIN_STEPS,
                   0)
        per_ms, per_ips = steady(per.last_epoch_timers)
        print(f"[strategies] {tier:13s} world 1 NCCL: windowed steady step "
              f"{step_ms:.3f} ms, {ips:.1f} images/s; per-step path "
              f"{per_ms:.3f} ms, {per_ips:.1f} images/s (steps 21-40, "
              f"batch {BATCH}); loss {first:.4f} -> {second:.4f}; "
              f"collectives per step {STEP_COUNTS[tier]}; kernel runs "
              f"{runs}; profiler over a {WINDOW}-step window {seen} "
              f"({events} device events); {wall:.1f} s  [{card_line}]")

    torch.backends.cudnn.deterministic = True
    try:
        want = train_tier("single", BITWISE_STEPS)[0].state.model.state_dict()
        for tier in ("single",) + STATELESS:     # single: run to run
            got = train_tier(tier, BITWISE_STEPS)[0].state.model.state_dict()
            for k, v in want.items():
                check(torch.equal(got[k], v),
                      f"{tier} at world 1 differs from single in {k}")
            print(f"[strategies] {tier} at world 1, deterministic cuDNN: "
                  f"parameters and BN statistics after {BITWISE_STEPS} "
                  f"windowed steps bitwise equal to single  ok")
        for tier in ("compress-int8", "powersgd"):
            check_bitwise_paths(tier)
    finally:
        torch.backends.cudnn.deterministic = False
    dist.destroy_process_group()

    count = torch.cuda.device_count()
    if count >= 2:
        with tempfile.TemporaryDirectory() as out_dir:
            for world in sorted({2, min(4, count)}):
                for tier in TIERS:
                    spawn_world(world, tier, out_dir, card_line)
    else:
        print(f"[strategies] world > 1 was not run on this machine: "
              f"{count} GPU")
    return launches


def logits_vs_cpu(name, precision):
    """A freshly initialized ``name``'s logits on the card against the
    same weights on the CPU, on a batch of 32, in train mode (batch
    statistics; the fused op on a VGG) and then eval mode (the running
    statistics that step left).  Fresh weights, not a trained run's: 60
    steps at lr 0.1 leave a model that predicts near-uniformly (loss
    ~2.4), whose logits would test little.

    f32: rtol / atol 1e-3 (summation order through 8-20 conv + BN
    layers).  bf16: the card's logits may be no further from the CPU's
    bf16 logits than twice the CPU's own bf16-vs-f32 distance, plus 1e-3
    (bf16 keeps 8 significant bits, and the two devices round after sums
    taken in other orders: a bound in units of bf16 rounding, as
    tests/test_torch_port_precision.py holds the port to the reference;
    measured 0.94x in train mode and 1.15x in eval mode on VGG-11)."""
    from cs744_ddp_tpu_torch.models import get_model
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    cpu = get_model(name, seed=1).to(memory_format=torch.channels_last)
    cpu32 = get_model(name, seed=1).to(memory_format=torch.channels_last)
    card_model = get_model(name, seed=1).to(
        "cuda", memory_format=torch.channels_last)
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((32, 32, 32, 3), generator=g, device="cuda")
    x = x.permute(0, 3, 1, 2)
    diffs, gauges, spread = [], [], 0.0
    with torch.no_grad():
        for train in (True, False):
            for m in (card_model, cpu, cpu32):
                m.train(train)
            got = card_model(x.to(dtype)).float().cpu()
            want = cpu(x.cpu().to(dtype)).float()
            gauge = float((want - cpu32(x.cpu())).abs().max())
            check(got.shape == (32, 10) and bool(torch.isfinite(got).all()),
                  f"{name} {precision}: logits {tuple(got.shape)} not "
                  f"finite")
            diff = float((got - want).abs().max())
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
            else:
                check(diff <= 2 * gauge + 1e-3,
                      f"{name} bf16 logits: the card is {diff} from the "
                      f"CPU, whose bf16 is {gauge} from its f32")
            diffs.append(diff)
            gauges.append(gauge)
            spread = max(spread, float(want.std(dim=0).max()))
    bound = "rtol / atol 1e-3" if dtype == torch.float32 else \
        "at most 2x the CPU's bf16-vs-f32 distance + 1e-3"
    print(f"[models] {name} {precision} logits on the card agree with the "
          f"CPU (fresh weights, batch 32, train then eval mode, {bound}): "
          f"max |diff| {diffs[0]:.3e}, {diffs[1]:.3e}; largest spread of a "
          f"logit over the batch {spread:.3e}"
          + (f"; the CPU's bf16 vs its f32 {gauges[0]:.3e}, {gauges[1]:.3e}"
             if dtype == torch.bfloat16 else "") + "  ok")


def models_run(label, tier, steps, card_line, *, falling=True, **kw):
    """A fresh Trainer of ``tier`` trained ``steps`` steps (``kw``: model,
    precision, profile_phases), its losses checked, and its line printed:
    steady step and images/s (steps 21 on), loss of the first two windows,
    kernel runs counted on the device, max_memory_allocated.  Returns the
    trainer, the kernels' runs and launches, and (step ms, images/s)."""
    gc.collect()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, runs, launched = train_tier(tier, steps, **kw)
    mem = torch.cuda.max_memory_allocated() - before
    losses = trainer.last_epoch_timers.losses
    if falling:
        first, second = check_losses(label, losses, steps)
    else:
        check(len(losses) == steps and all(math.isfinite(v) for v in losses),
              f"{label}: losses {losses}")
        first, second = (statistics.mean(losses[:WINDOW]),
                         statistics.mean(losses[WINDOW:2 * WINDOW]))
    step_ms, ips = steady(trainer.last_epoch_timers)
    print(f"[models] {label}: steady step {step_ms:.3f} ms, {ips:.1f} "
          f"images/s (steps 21-{steps}, batch {BATCH}); mean loss "
          f"{first:.4f} (steps 1-20) -> {second:.4f} (21-40); kernel runs "
          f"counted on the device {runs}; max_memory_allocated "
          f"{mem / 2 ** 20:.1f} MiB above the {before / 2 ** 20:.1f} MiB "
          f"held before the run; {time.perf_counter() - t0:.1f} s  "
          f"[{card_line}]")
    return trainer, runs, launched, (step_ms, ips)


def phase_models(card_line):
    """The model zoo and bf16 mixed precision; see the module docstring.
    Returns the VGG-11 bf16 windowed path's kernel runs and launches, and
    the runs of every path of this phase."""
    import torch.distributed as dist
    from cs744_ddp_tpu_torch.models import get_model
    from cs744_ddp_tpu_torch.parallel import bucketing

    zero = variants("f32", 0)
    paths = {}
    # VGG-11 in bf16: both kernels in bf16 inside the captured step.
    label = "vgg11 bf16 single"
    tr, runs, launched, _ = models_run(f"{label}, windowed", "single",
                                       TRAIN_STEPS, card_line,
                                       precision="bf16")
    check_runs(f"{label}, windowed", runs, launched, TRAIN_STEPS,
               TRAIN_STEPS, "bf16")
    bf16_path = (runs, launched)
    seen, events, _ = window_profile(tr)
    print(f"[models] {label}: torch.profiler over one more {WINDOW}-step "
          f"window: {seen} kernel runs ({events} device events), as counted "
          f"on the device  ok")
    logits_vs_cpu("vgg11", "bf16")
    per, per_runs, per_launched, _ = models_run(
        f"{label}, per-step", "single", TRAIN_STEPS, card_line,
        precision="bf16", profile_phases=True)
    check_runs(f"{label}, per-step", per_runs, per_launched, TRAIN_STEPS, 0,
               "bf16")
    paths[f"{label}/window"] = runs
    paths[f"{label}/per-step"] = per_runs
    del tr, per

    # ResNet-18, BASELINE.json config #5 on one card: allreduce on a
    # world-1 NCCL group.  No pool block, so no bnpool kernel runs.
    check(not dist.is_initialized(), "a process group exists already")
    per_step = {"all_reduce": 62}
    for path, kw in (("windowed", {}), ("per-step",
                                        {"profile_phases": True})):
        label = f"resnet18 f32 allreduce, {path}"
        tr, runs, launched, _ = models_run(label, "allreduce", TRAIN_STEPS,
                                           card_line, model="resnet18", **kw)
        check(dist.get_backend() == "nccl" and tr.world == 1,
              f"{label}: expected a world-1 NCCL group")
        want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
        check(dict(tr.group.total_counts) == want,
              f"{label}: collectives {dict(tr.group.total_counts)}, want "
              f"{want}")
        check(runs == zero and launched == zero,
              f"{label}: bnpool kernels ran {runs}, launched {launched}")
        paths[f"resnet18 f32 allreduce/{path}"] = runs
        if path == "windowed":
            seen, events, added = window_profile(tr, per_step=0)
            check(added == {"all_reduce": 62 * WINDOW},
                  f"{label}: a window added collectives {added}")
            print(f"[models] {label}: collectives per step {per_step}; "
                  f"torch.profiler over one more window: bnpool runs "
                  f"{seen} of {events} device events  ok")
            logits_vs_cpu("resnet18", "f32")
        del tr
    plan = bucketing.make_plan(list(get_model("resnet18").parameters()))
    label = "resnet18 f32 ddp, windowed"
    tr, runs, _, _ = models_run(label, "ddp", TRAIN_STEPS, card_line,
                                model="resnet18")
    want = {"all_reduce": plan.num_buckets * TRAIN_STEPS}
    check(dict(tr.group.total_counts) == want and runs == zero,
          f"{label}: collectives {dict(tr.group.total_counts)}, want "
          f"{want}; bnpool runs {runs}")
    print(f"[models] {label}: {plan.num_buckets} all-reduces per step, the "
          f"buckets of bucketing.make_plan over the 62 gradients at "
          f"{bucketing.DEFAULT_BUCKET_BYTES // 2 ** 20} MiB (leaves per "
          f"bucket {[len(b) for b in plan.buckets]})  ok")
    del tr
    tr, runs, _, _ = models_run("resnet18 bf16 allreduce, windowed",
                                "allreduce", TRAIN_STEPS, card_line,
                                model="resnet18", precision="bf16")
    check(dict(tr.group.total_counts) == {"all_reduce": 62 * TRAIN_STEPS}
          and runs == zero, f"resnet18 bf16: collectives "
          f"{dict(tr.group.total_counts)}, bnpool runs {runs}")
    paths["resnet18 bf16 allreduce/windowed"] = runs
    del tr
    for precision in ("f32", "bf16"):
        label = f"resnet34 {precision} single, windowed"
        tr, runs, _, _ = models_run(label, "single", TRAIN_STEPS, card_line,
                                    falling=False, model="resnet34",
                                    precision=precision)
        check(runs == zero, f"{label}: bnpool runs {runs}")
        paths[f"resnet34 {precision} single/windowed"] = runs
        del tr

    torch.backends.cudnn.deterministic = True
    try:
        check_bitwise_paths("single", "vgg11", "bf16")
        check_bitwise_paths("allreduce", "resnet18", "f32")
    finally:
        torch.backends.cudnn.deterministic = False
    dist.destroy_process_group()

    count = torch.cuda.device_count()
    if count >= 2:
        with tempfile.TemporaryDirectory() as out_dir:
            spawn_world(min(4, count), "allreduce", out_dir, card_line,
                        model="resnet18")
    else:
        print(f"[models] resnet18 allreduce at world > 1 was not run on "
              f"this machine: {count} GPU")
    return bf16_path, paths


def ft_trainer(tier="single", model="vgg11", precision="f32",
               log=lambda s: None, **kw):
    """A fresh Trainer of phase ft: ``FT_STEPS`` augmented batches (three
    20-step windows, no ragged tail), ``EVAL_FT`` eval batches."""
    from cs744_ddp_tpu_torch.train.loop import Trainer
    return Trainer(model=model, strategy=tier, precision=precision,
                   global_batch=BATCH, augment=True,
                   limit_train_batches=FT_STEPS, limit_eval_batches=EVAL_FT,
                   log=log, **kw)


def check_same_state(label, got, want):
    from cs744_ddp_tpu_torch.train.step import named_state_tensors
    a, b = named_state_tensors(got.state), named_state_tensors(want.state)
    check(list(a) == list(b), f"{label}: other tensors")
    for k in a:
        check(torch.equal(a[k], b[k]), f"{label}: {k} differs")
    return len(a)


def ring_rows(trainer, steps):
    """The metric ring's rows of the last ``steps`` steps (host copy)."""
    from cs744_ddp_tpu_torch.obs import ringbuf
    ring = trainer.train_window().ring
    return ringbuf.drain_rows(ring.buf.cpu().numpy(), ring.writes, steps)


def check_guard_flags(label, trainer, steps, bad):
    """The ring's ok column 0 at exactly batch ``bad`` and 1 elsewhere,
    its markers the batches, one update skipped, finite losses and
    state."""
    from cs744_ddp_tpu_torch.train.step import state_tensors
    rows = ring_rows(trainer, steps)
    want = [0.0 if i == bad else 1.0 for i in range(steps)]
    check(rows[:, 3].tolist() == list(range(steps))
          and rows[:, 2].tolist() == want,
          f"{label}: ok column {rows[:, 2].tolist()} at batches "
          f"{rows[:, 3].tolist()}, want 0 at {bad} only")
    check(trainer.nonfinite_skipped == 1, f"{label}: "
          f"{trainer.nonfinite_skipped} updates skipped, want 1")
    check(bool(np.isfinite(rows[:, 0]).all()) and all(
        bool(torch.isfinite(t.float()).all())
        for t in state_tensors(trainer.state)),
        f"{label}: a loss or a state tensor is not finite")


def save_costs(card_line):
    """Bytes and wall times of a checkpoint for VGG-11 f32 and ResNet-34
    f32 (the zoo's largest state), ``single``: the epoch save (the copy
    to the host and the fsynced file), the restore (read and ``copy_``
    into the Trainer's tensors on the card) and the emergency save."""
    from cs744_ddp_tpu_torch.train.checkpoint import CheckpointManager
    for model in ("vgg11", "resnet34"):
        tr = ft_trainer(model=model)
        with tempfile.TemporaryDirectory() as d:
            mngr = CheckpointManager(d, config=tr.checkpoint_config())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr._save(mngr, 0)
            save_s = time.perf_counter() - t0
            nbytes = os.path.getsize(os.path.join(d, "epoch_0.pt"))
            t0 = time.perf_counter()
            tensors, _ = mngr.restore()
            tr.load_checkpoint(tensors)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            tr._save(mngr, 0, 40)
            mid_s = time.perf_counter() - t0
        state = sum(t.numel() * t.element_size() for t in tensors.values())
        print(f"[ft] checkpoint of {model} f32 single: {nbytes} bytes on "
              f"disk ({state} of tensors, {len(tensors)} of them); save "
              f"{1e3 * save_s:.1f} ms, restore {1e3 * restore_s:.1f} ms, "
              f"emergency save {1e3 * mid_s:.1f} ms (wall, host copy and "
              f"fsync included)  [{card_line}]")
        del tr, tensors


def guard_cost(card_line):
    """The steady windowed step of VGG-11 ``single`` with the guard off
    and with ``--nonfinite skip`` (no fault), f32 then bf16, timed in
    turns (off, on, on, off) by ``steady_state_throughput``."""
    from cs744_ddp_tpu_torch.ft import FTConfig
    for precision in ("f32", "bf16"):
        pair = {"off": ft_trainer(precision=precision),
                "on": ft_trainer(precision=precision,
                                 ft=FTConfig(nonfinite="skip"))}
        ms = {"off": [], "on": []}
        for which in ("off", "on", "on", "off"):
            ips, _ = pair[which].steady_state_throughput(
                max_iters=2 * WINDOW, window_iters=WINDOW)
            ms[which].append(1e3 * BATCH / ips)
        off, on = statistics.mean(ms["off"]), statistics.mean(ms["on"])
        print(f"[ft] guard cost, vgg11 {precision} single windowed: steady "
              f"step {off:.4f} ms off ({ms['off'][0]:.4f}, "
              f"{ms['off'][1]:.4f}), {on:.4f} ms on ({ms['on'][0]:.4f}, "
              f"{ms['on'][1]:.4f}); on - off {on - off:+.4f} ms a step  "
              f"[{card_line}]")
        del pair


def phase_ft(card_line):
    """Checkpoints, preemption and the non-finite guard; see the module
    docstring.  Returns each path's kernel runs."""
    import torch.distributed as dist
    from cs744_ddp_tpu_torch.ft import ChaosPlan, FTConfig, NonFiniteError
    from cs744_ddp_tpu_torch.ops import bnpool
    from cs744_ddp_tpu_torch.train.checkpoint import CheckpointManager
    from cs744_ddp_tpu_torch.train.step import WARMUP_ITERS

    check(not dist.is_initialized(), "a process group exists already")
    t_phase = time.perf_counter()
    paths = {}
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # 1. Resume after an epoch.
            base2 = ft_trainer()
            base2.run(2)
            ft_trainer().run(1, checkpoint_dir=os.path.join(tmp, "epoch"))
            lines = []
            resumed = ft_trainer(log=lines.append)
            resumed.run(2, checkpoint_dir=os.path.join(tmp, "epoch"))
            check("Resumed from checkpoint: epoch 1" in lines,
                  f"epoch resume: no resume line in {lines[:4]}")
            n = check_same_state("epoch resume", resumed, base2)
            print(f"[ft] epoch resume: run(1) saved, a fresh Trainer's "
                  f"run(2) resumed from epoch 1: {n} tensors bitwise equal "
                  f"to run(2) uninterrupted ({FT_STEPS} steps an epoch, "
                  f"deterministic cuDNN)  ok")
            del base2, resumed

            # 2. Resume mid-epoch after a chaos SIGTERM at batch 25.
            base1 = ft_trainer()
            base1.run(1)
            mid = os.path.join(tmp, "mid")
            lines = []
            bnpool.reset_launch_counts()
            cut = ft_trainer(log=lines.append, ft=FTConfig(
                chaos=ChaosPlan.parse(["preempt:25"])))
            cut.run(1, checkpoint_dir=mid)
            first = bnpool.executed_counts()
            check(cut.preempted and CheckpointManager(mid)
                  .latest_mid_epoch() == (0, 40),
                  f"preempt:25: preempted {cut.preempted}, saved at "
                  f"{CheckpointManager(mid).latest_mid_epoch()}, want "
                  f"(0, 40); {lines[-3:]}")
            bnpool.reset_launch_counts()
            resumed = ft_trainer(log=lines.append)
            resumed.run(1, checkpoint_dir=mid)
            second = bnpool.executed_counts()
            check("Resumed from mid-epoch checkpoint: epoch 0, step 40"
                  in lines, f"mid-epoch resume: {lines[-6:]}")
            n = check_same_state("mid-epoch resume", resumed, base1)
            for label, runs, steps in (("first half", first, 40),
                                       ("second half", second, 20)):
                want = variants("f32", 5 * (WARMUP_ITERS + steps))
                check(runs == want, f"mid-epoch resume, {label}: kernel "
                      f"runs {runs}, want {want}")
                paths[f"ft single/{label} ({steps} steps)"] = runs
            print(f"[ft] mid-epoch resume: preempt:25 stopped at the "
                  f"boundary at 40 with an emergency save; a fresh Trainer "
                  f"resumed at (0, 40): {n} tensors bitwise equal to one "
                  f"uninterrupted epoch; kernel runs counted on the device "
                  f"{first} (3 warm-up steps + 40 replays) and {second} "
                  f"(3 + 20)  ok")
            del cut, resumed

            # 3. The guard: no fault, then NaN gradients at batch 30.
            bnpool.reset_launch_counts()
            guarded = ft_trainer(ft=FTConfig(nonfinite="skip"))
            guarded.run(1)
            paths["ft single skip/window"] = bnpool.executed_counts()
            n = check_same_state("guard on, no fault", guarded, base1)
            check(guarded.last_epoch_timers.losses ==
                  base1.last_epoch_timers.losses, "guard on, no fault: "
                  "other losses")
            print(f"[ft] --nonfinite skip, no fault: {FT_STEPS} steps, "
                  f"{n} tensors and the losses bitwise equal to the "
                  f"unguarded run  ok")
            del guarded, base1
    finally:
        torch.backends.cudnn.deterministic = False

    bad = 30
    plan = [f"nonfinite_grad:{bad}"]
    for tier in ("single", "compress-int8", "powersgd"):
        bnpool.reset_launch_counts()
        tr = ft_trainer(tier, ft=FTConfig(nonfinite="skip",
                                          chaos=ChaosPlan.parse(plan)))
        tr.train_model(0)
        paths[f"ft {tier} skip nonfinite_grad/window"] = \
            bnpool.executed_counts()
        check_guard_flags(tier, tr, FT_STEPS, bad)
        print(f"[ft] {tier:13s} nonfinite_grad:{bad} under skip: ring ok "
              f"column 0 at batch {bad} only, 1 update skipped, losses and "
              f"state finite  ok")
        del tr
    tr = ft_trainer(ft=FTConfig(nonfinite="halt",
                                chaos=ChaosPlan.parse(plan)))
    try:
        tr.train_model(0)
        raise SmokeFailure("halt: no NonFiniteError")
    except NonFiniteError as e:
        print(f"[ft] halt: NonFiniteError ({e})  ok")
    del tr
    # No host sync in a fresh guarded Trainer's first window, capture
    # included, with a planned fault in it.
    tr = ft_trainer(ft=FTConfig(nonfinite="skip", chaos=ChaosPlan.parse(
        ["nonfinite_grad:10"])))
    window = tr.train_window()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = window(0, 0, WINDOW)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ok = window.columns(out.cpu().numpy(), 0, WINDOW)[1]
    check(ok.tolist() == [0.0 if i == 10 else 1.0 for i in range(WINDOW)],
          f"sync-debug window: ok column {ok.tolist()}")
    print("[ft] a fresh guarded Trainer's first window (warm-up, capture, "
          "20 replays, NaN at batch 10) under "
          "torch.cuda.set_sync_debug_mode('error'): no host sync; ok 0 at "
          "batch 10 only  ok")
    del tr, window
    if dist.is_initialized():
        dist.destroy_process_group()

    guard_cost(card_line)
    save_costs(card_line)

    count = torch.cuda.device_count()
    if count >= 2:
        ft_world2(card_line)
    else:
        print(f"[ft] the 2-rank CLI preemption was not run on this "
              f"machine: {count} GPU")
    print(f"[ft] phase ft: {time.perf_counter() - t_phase:.1f} s")
    return paths


def ft_world2(card_line):
    """The CLI on 2 NCCL ranks, ``compress-int8``, deterministic cuDNN:
    preempted by ``--chaos preempt:25`` into a checkpoint directory, the
    same command again resumes; every rank's ``--save`` bitwise equal to
    an uninterrupted 2-rank run's."""
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--num-devices", "2", "--strategy", "compress-int8",
                  "--deterministic", "--limit-train-batches", str(FT_STEPS),
                  "--limit-eval-batches", str(EVAL_FT)]
        ck = os.path.join(tmp, "ck")
        cut = common + ["--checkpoint-dir", ck, "--save",
                        os.path.join(tmp, "cut")]
        out = run_cli(cut + ["--chaos", "preempt:25", "--port",
                             str(free_port())], "2-rank preempt")
        check("emergency checkpoint saved" in out, f"2-rank preempt: "
              f"{out[-2000:]}")
        out = run_cli(cut + ["--port", str(free_port())], "2-rank resume")
        check("Resumed from mid-epoch checkpoint: epoch 0, step 40" in out,
              f"2-rank resume: {out[-2000:]}")
        run_cli(common + ["--save", os.path.join(tmp, "full"), "--port",
                          str(free_port())], "2-rank uninterrupted")
        for r in range(2):
            got = torch.load(os.path.join(tmp, "cut", f"rank{r}.pt"))
            want = torch.load(os.path.join(tmp, "full", f"rank{r}.pt"))
            for k, v in want.items():
                check(torch.equal(got[k], v), f"2-rank resume: rank {r} "
                      f"differs in {k}")
    print(f"[ft] compress-int8 on 2 NCCL ranks through the CLI: preempt:25 "
          f"saved at 40, the rerun resumed; every rank's --save bitwise "
          f"equal to an uninterrupted run's  ok  [{card_line}]")


def host_trainer(steps, precision="f32", **kw):
    """A fresh VGG-11 ``single`` Trainer of phase host: ``--host-augment``,
    ``steps`` augmented batches, ``host_chunks`` 4 unless given."""
    from cs744_ddp_tpu_torch.train.loop import Trainer
    kw = {"host_augment": True, "host_chunks": 4, **kw}
    return Trainer(model="vgg11", strategy="single", precision=precision,
                   global_batch=BATCH, augment=True,
                   limit_train_batches=steps, log=lambda s: None, **kw)


def idle_share(run):
    """(device idle share of the wall time, wall s) while ``run()`` trains
    and fetches, from ``torch.profiler``: busy is the union of the device
    records other than host-to-device copies (the copy engines run beside
    the kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from cs744_ddp_tpu_torch.utils.profile_step import busy_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA and "HtoD" not in e.name]
    check(bool(spans), "the profiler recorded no device work")
    return 1 - busy_us(spans) / wall_us, wall_us / 1e6


def window_stream_digest(trainer, epoch, start, w):
    """(sha256 of the window buffer's rows 0..w-1 on the card, sha256 of
    the same batches from ``native.gather_augment_u8`` on the CPU, the
    card's affine normalize of those rows equal to ``native.augment``'s
    f32 bit for bit)."""
    import hashlib
    from cs744_ddp_tpu_torch.data import augment as aug, native
    window = trainer.train_window()
    got = window.images[:w]
    cols = list(trainer._rank_cols(epoch))[start:start + w]
    split = trainer.train_split
    want = np.stack([native.gather_augment_u8(
        split.images, c, *trainer._host_rank_params(len(c), epoch, start + i))
        for i, c in enumerate(cols)])
    f32 = np.stack([native.augment(
        split.images[c], *trainer._host_rank_params(len(c), epoch, start + i))
        for i, c in enumerate(cols)])
    on_card = aug.normalize_affine(got, aug.affine_stats(got.device)).cpu()
    same_f32 = torch.equal(on_card, torch.from_numpy(f32))
    return (hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16],
            hashlib.sha256(want.tobytes()).hexdigest()[:16], same_f32)


def host_step_times(card_line, precision):
    """The steady step (steps 21-``HOST_TIME_STEPS``, ms) of the
    device-augment windowed path and of the host windowed path, VGG-11
    ``single`` in ``precision``, each Trainer warmed by one epoch, then
    timed in turns (device, host, host, device) over whole epochs, the
    host's producer started anew each epoch as in training."""
    from cs744_ddp_tpu_torch.train.loop import Trainer
    pair = {"device": Trainer(model="vgg11", strategy="single",
                              precision=precision, global_batch=BATCH,
                              augment=True,
                              limit_train_batches=HOST_TIME_STEPS,
                              log=lambda s: None),
            "host": host_trainer(HOST_TIME_STEPS, precision)}
    for tr in pair.values():
        tr.train_model(0)
    from cs744_ddp_tpu_torch.ops import bnpool
    ms = {"device": [], "host": []}
    waits = []
    for i, which in enumerate(("device", "host", "host", "device")):
        bnpool.reset_launch_counts()
        timers = pair[which].train_model(1 + i)
        torch.cuda.synchronize()
        ms[which].append(steady(timers)[0])
        if which == "host":
            waits.append(pair["host"].last_chunk_waits)
            runs = bnpool.executed_counts()
            check(runs == variants(precision, 5 * HOST_TIME_STEPS),
                  f"vgg11 {precision} host windowed: kernel runs {runs}, "
                  f"want 5 a step")
    dev, host = statistics.mean(ms["device"]), statistics.mean(ms["host"])
    print(f"[host] vgg11 {precision} single, steady step (steps 21-"
          f"{HOST_TIME_STEPS}, whole epochs in turns device, host, host, "
          f"device): device-augment windowed {dev:.4f} ms "
          f"({ms['device'][0]:.4f}, {ms['device'][1]:.4f}), host-augment "
          f"windowed {host:.4f} ms "
          f"({ms['host'][0]:.4f}, {ms['host'][1]:.4f}); host / device "
          f"{host / dev:.4f}; chunk_wait per window (s) "
          f"{[[round(v, 6) for v in w] for w in waits]}; kernel runs "
          f"of a host epoch {runs}  [{card_line}]")
    return runs


def phase_host(card_line):
    """The host-augment path; see the module docstring.  Returns each
    path's kernel runs."""
    import torch.distributed as dist
    from cs744_ddp_tpu_torch.data import native
    from cs744_ddp_tpu_torch.ft import ChaosPlan, FTConfig
    from cs744_ddp_tpu_torch.ops import bnpool
    from cs744_ddp_tpu_torch.train.loop import Trainer
    from cs744_ddp_tpu_torch.train.step import state_tensors

    check(not dist.is_initialized(), "a process group exists already")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    native.load_library()
    print(f"[host] native loader: {native.library_path().name} built from "
          f"native/fastloader.cpp and loaded in "
          f"{time.perf_counter() - t0:.2f} s (fl_version "
          f"{native.EXPECTED_VERSION})  [{card_line}]")
    paths = {}

    # 1. One whole epoch, as `--host-augment` trains it.
    trainer = Trainer(model="vgg11", strategy="single", global_batch=BATCH,
                      augment=True, limit_eval_batches=EVAL_BATCHES,
                      host_augment=True, host_chunks=4, log=lambda s: None)
    bnpool.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.run(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs, launches = kernel_counts()
    full, tail_rows = divmod(EPOCH_ROWS, BATCH)
    steps = full + 1
    losses = trainer.last_epoch_timers.losses
    first, second = check_losses("host single", losses, steps)
    check_runs("host single, windowed epoch", runs, launches, steps, full)
    windows = -(-full // WINDOW)
    check(trainer.host_round_trips <= windows + 2,
          f"host: {trainer.host_round_trips} host round trips for "
          f"{windows} windows, the tail and an eval")
    check(len(trainer.last_chunk_waits) == windows,
          f"host: {len(trainer.last_chunk_waits)} chunk waits")
    step_ms, ips = steady(trainer.last_epoch_timers)
    paths["host single/window (epoch)"] = runs
    h2d = WINDOW * BATCH * (32 * 32 * 3 + 8)
    print(f"[host] --host-augment windowed path: one epoch, {full} steps in "
          f"{windows} windows of graph replays from chunk-staged C++-"
          f"augmented buffers (4 chunks a window, {h2d} bytes to the card a "
          f"window) + the ragged tail of {tail_rows} rows as one eager f32 "
          f"step + {EVAL_BATCHES} eval batches in {wall:.2f} s; mean loss "
          f"{first:.4f} (steps 1-20) -> {second:.4f} (21-40); kernel runs "
          f"counted on the device {runs}, wrapper launches {launches}; host "
          f"round trips {trainer.host_round_trips}; steady step "
          f"{step_ms:.3f} ms, {ips:.1f} images/s  [{card_line}]")
    phases = {k: round(v, 4)
              for k, v in trainer.last_producer_times.items()}
    print(f"[host] chunk_wait per window (s): "
          f"{[round(v, 6) for v in trainer.last_chunk_waits]}; the "
          f"producer's seconds by phase: {phases}  [{card_line}]")
    del trainer

    # 2. The device's idle share over an epoch of three windows, the
    # window already captured, the producer started anew as every epoch.
    tr = host_trainer(HOST_FT_STEPS)
    tr.train_model(0)
    idle, wall = idle_share(lambda: tr.train_model(1))
    print(f"[host] device idle share over a {HOST_FT_STEPS}-step host "
          f"windowed epoch (capture done; the producer starts with the "
          f"epoch): {100 * idle:.1f}% of {wall:.3f} s; chunk_wait per window "
          f"(s) {[round(v, 6) for v in tr.last_chunk_waits]}  [{card_line}]")
    del tr

    torch.backends.cudnn.deterministic = True
    try:
        # 3. Windowed = per-step, chunks 4 = 1, the stream on the card.
        win = host_trainer(HOST_STEPS)
        bnpool.reset_launch_counts()
        win.train_model(0)
        paths["host single/window"] = bnpool.executed_counts()
        bnpool.reset_launch_counts()
        per = host_trainer(HOST_STEPS, profile_phases=True)
        per.train_model(0)
        paths["host single/per-step"] = bnpool.executed_counts()
        check(paths["host single/per-step"] == variants(
                  "f32", 5 * HOST_STEPS, 10 * HOST_STEPS),
              f"host per-step: kernel runs {paths['host single/per-step']}")
        one = host_trainer(HOST_STEPS, host_chunks=1)
        one.train_model(0)
        for label, other in (("per-step path", per), ("host_chunks 1", one)):
            check(win.last_epoch_timers.losses ==
                  other.last_epoch_timers.losses,
                  f"host windowed vs {label}: losses differ")
            a, b = state_tensors(win.state), state_tensors(other.state)
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"host windowed vs {label}: state differs")
        per_ms, per_ips = steady(per.last_epoch_timers)
        print(f"[host] per-step host path (--profile-phases, f32 batches "
              f"made and copied on the producer thread): steady step "
              f"{per_ms:.3f} ms, {per_ips:.1f} images/s (steps 21-"
              f"{HOST_STEPS}, deterministic cuDNN); host round trips "
              f"{per.host_round_trips}  [{card_line}]")
        print(f"[bitwise] host: {HOST_STEPS} windowed steps (host_chunks 4) "
              f"bitwise equal to {HOST_STEPS} per-step f32 steps and to "
              f"host_chunks 1 ({len(a)} tensors and the losses; "
              f"deterministic cuDNN); per-step kernel runs "
              f"{paths['host single/per-step']}  ok  [{card_line}]")
        got, want, same_f32 = window_stream_digest(win, 0, WINDOW, WINDOW)
        check(got == want, f"host stream: the card's window buffer sha256 "
              f"{got}, the CPU's gather_augment_u8 {want}")
        check(same_f32, "host stream: the card's affine normalize of the "
              "window differs from native.augment's f32")
        print(f"[host] stream on the card: the window buffer of batches "
              f"{WINDOW}-{2 * WINDOW - 1} sha256 {got} = the CPU "
              f"gather_augment_u8 stream's; its normalize on the card equals "
              f"native.augment's f32 bit for bit  ok  [{card_line}]")
        del win, per, one

        # 4. Staging chaos, each bitwise the healthy run.
        healthy = host_trainer(HOST_FT_STEPS)
        healthy.train_model(0)
        # (spec, FTConfig fields, producer failures, degraded, a log line)
        cases = (("put_fail:25", {"backoff_base_s": 0.001}, 0, False,
                  "retrying with backoff"),
                 ("producer_crash:30", {}, 1, False, "restarting the "
                  "producer from step 20"),
                 ("producer_crash:30,producer_crash:30", {}, 2, True,
                  "degrading to synchronous"),
                 ("corrupt_slot:33", {"verify_chunks": True}, 0, False,
                  "staged batch 33 failed its checksum"))
        for spec, kw, failures, degraded, line in cases:
            lines = []
            tr = host_trainer(HOST_FT_STEPS, ft=FTConfig(
                chaos=ChaosPlan.parse(spec.split(",")), **kw))
            tr.log = lines.append
            tr.train_model(0)
            check(tr.producer_failures == failures
                  and tr.staging_degraded == degraded
                  and any(line in ln for ln in lines),
                  f"chaos {spec}: producer failures {tr.producer_failures},"
                  f" degraded {tr.staging_degraded}, log {lines}")
            check(tr.last_epoch_timers.losses ==
                  healthy.last_epoch_timers.losses,
                  f"chaos {spec}: losses differ from the healthy run")
            check_same_state(f"chaos {spec}", tr, healthy)
            print(f"[host] chaos {spec}: producer failures "
                  f"{tr.producer_failures}, degraded {tr.staging_degraded}; "
                  f"{HOST_FT_STEPS} steps bitwise equal to the healthy run; "
                  f"log {[ln for ln in lines if 'ft:' in ln or 'chaos' in ln]}"
                  f"  ok  [{card_line}]")
            del tr
        del healthy
    finally:
        torch.backends.cudnn.deterministic = False

    # 5. Host against device augmentation, f32 and bf16, in turns.
    host_step_times(card_line, "f32")
    paths["host vgg11 bf16 single/window"] = host_step_times(card_line,
                                                             "bf16")
    print(f"[host] phase host: {time.perf_counter() - t_phase:.1f} s  "
          f"[{card_line}]")
    return paths


def elastic_trainer(steps=ELASTIC_STEPS, elastic="strong", **kw):
    """A fresh VGG-11 ``allreduce`` Trainer of phase elastic on a world-1
    NCCL group: ``steps`` augmented batches, strong scaling at S = 4
    (``elastic=None``: the non-elastic step of the same tree)."""
    from cs744_ddp_tpu_torch.train.loop import Trainer
    return Trainer(model="vgg11", strategy="allreduce", global_batch=BATCH,
                   augment=True, limit_train_batches=steps,
                   limit_eval_batches=EVAL_FT, log=lambda s: None,
                   elastic=elastic, **kw)


def virtual_world_state(world, steps):
    """A fresh strong Trainer's model trained ``steps`` eager steps by
    ``world`` virtual ranks on this card: rank r's rows from its k
    microshards (its contiguous columns of the canonical batch), the rows
    concatenated in rank order in place of the gather, then one combine.
    The trained Trainer, and the kernels' runs in those steps."""
    from cs744_ddp_tpu_torch.elastic import MicroshardStep
    from cs744_ddp_tpu_torch.ops import bnpool
    tr = elastic_trainer(steps)
    staged = tr._stage_train_epoch(0)
    ranks = [MicroshardStep(tr.state.model, tr.sgd_cfg,
                            microshards=MICROSHARDS, world=world, rank=r,
                            augment=True, seed=tr.seed)
             for r in range(world)]
    per = BATCH // world
    epoch = torch.zeros((), dtype=torch.int64, device=tr.device)
    bnpool.reset_launch_counts()
    for b in range(steps):
        idx = torch.full((), b, dtype=torch.int64, device=tr.device)
        rows = [ranks[r].local_rows(staged.images[b, r * per:(r + 1) * per],
                                    staged.labels[b, r * per:(r + 1) * per],
                                    epoch, idx).clone()
                for r in range(world)]
        ranks[0].combine(tr.state, torch.cat(rows))
    torch.cuda.synchronize()
    return tr, bnpool.executed_counts()


def cli_save(tmp, name, args, label, timeout=600):
    """The elastic CLI with ``--save`` into ``tmp/name``; its stdout and
    rank 0's saved state_dict."""
    out = run_cli(["--elastic", "strong", "--limit-train-batches",
                   str(ELASTIC_STEPS), "--limit-eval-batches", str(EVAL_FT),
                   "--checkpoint-dir", os.path.join(tmp, "ck_" + name),
                   "--save", os.path.join(tmp, name)] + args, label,
                  timeout=timeout)
    path = os.path.join(tmp, name, "rank0.pt")
    return out, torch.load(path, map_location="cpu") \
        if os.path.exists(path) else None


def check_same_save(label, got, want):
    check(got is not None and list(got) == list(want),
          f"{label}: no --save or other keys")
    for k, v in want.items():
        check(torch.equal(got[k], v), f"{label}: {k} differs")
    return len(want)


def elastic_cli(card_line):
    """Phase elastic's CLI runs (steps 3 and 4 of the module docstring):
    at world 1 a ``preempt:25`` run, the command again without the fault,
    and an uninterrupted run, the resumed ``--save`` bitwise the
    uninterrupted one's; with two or more GPUs the world-2 ladder
    (``rank_death:25:1``) and an uninterrupted run at world
    ``min(4, count)``, each ``--save`` bitwise the world-1 run's."""
    with tempfile.TemporaryDirectory() as tmp:
        one = ["--num-devices", "1"]
        out, _ = cli_save(tmp, "cut", one + ["--chaos", "preempt:25"],
                          "elastic CLI preempt")
        check("Preempted at epoch 0 step 40; emergency checkpoint saved"
              in out and "elastic report: " in out,
              f"elastic CLI preempt: {out[-2000:]}")
        out, cut = cli_save(tmp, "cut", one, "elastic CLI resume")
        check("Resumed from mid-epoch checkpoint: epoch 0, step 40" in
              out, f"elastic CLI resume: {out[-2000:]}")
        run_dir = os.path.join(tmp, "run_full")
        _, full = cli_save(tmp, "full", one + ["--telemetry-out", run_dir],
                           "elastic CLI uninterrupted")
        n = check_same_save("elastic CLI resume", cut, full)
        text = render_run_dir("elastic cli --telemetry-out", run_dir, (
            "manifest", "steps", "spans", "counters", "elastic", "gauges"),
            steps=ELASTIC_STEPS)
        check(f"  protocol               strong (microshards {MICROSHARDS})"
              in text.splitlines() and "    rank 0    x" in text,
              f"elastic cli: the report's elastic section in\n{text}")
        print(f"[elastic] CLI --num-devices 1 --elastic strong "
              f"--chaos preempt:25: saved at 40; the command again "
              f"resumed there; --save bitwise equal to an uninterrupted "
              f"run's ({n} tensors)  ok  [{card_line}]")
        count = torch.cuda.device_count()
        if count < 2:
            print(f"[elastic] the world-2 rank_death ladder through the "
                  f"CLI was not run on this machine: {count} GPU")
            return
        t0 = time.perf_counter()
        out, died = cli_save(tmp, "ladder", [
            "--num-devices", "2", "--chaos", "rank_death:25:1"],
            "elastic CLI ladder")
        check("shrinking world 2 -> 1" in out,
              f"elastic CLI ladder: {out[-2000:]}")
        n = check_same_save("elastic CLI ladder", died, full)
        print(f"[elastic] CLI --num-devices 2 --elastic strong "
              f"--chaos rank_death:25:1: rank 1 died at 40, shrinking "
              f"world 2 -> 1, resumed; --save bitwise equal to the "
              f"uninterrupted world-1 run's ({n} tensors); "
              f"{time.perf_counter() - t0:.1f} s  ok  [{card_line}]")
        world = min(4, count)
        out, wide = cli_save(tmp, f"w{world}",
                             ["--num-devices", str(world)],
                             f"elastic CLI world {world}")
        n = check_same_save(f"elastic CLI world {world}", wide, full)
        print(f"[elastic] CLI --num-devices {world} --elastic strong "
              f"({world} NCCL processes): --save bitwise equal to the "
              f"world-1 run's ({n} tensors)  ok  [{card_line}]")


def phase_elastic(card_line):
    """``--elastic strong``; see the module docstring.  Returns each
    path's kernel runs."""
    import torch.distributed as dist
    from cs744_ddp_tpu_torch.elastic import MicroshardStep
    from cs744_ddp_tpu_torch.ops import bnpool
    from cs744_ddp_tpu_torch.train.step import WARMUP_ITERS

    check(not dist.is_initialized(), "a process group exists already")
    t_phase = time.perf_counter()
    paths = {}
    torch.backends.cudnn.deterministic = True
    try:
        # 1. The main path: a 60-step windowed epoch of the strong step.
        strong = elastic_trainer()
        check(isinstance(strong.train_window().body, MicroshardStep),
              "the strong Trainer's window does not run the microshard "
              "step")
        bnpool.reset_launch_counts()
        strong.train_model(0)
        torch.cuda.synchronize()
        runs, launches = kernel_counts()
        paths[f"elastic/window ({ELASTIC_STEPS} steps, S={MICROSHARDS})"] \
            = runs
        first, second = check_losses("elastic", strong.last_epoch_timers
                                     .losses, ELASTIC_STEPS)
        per_step = 5 * MICROSHARDS
        want_runs = variants("f32", per_step * (WARMUP_ITERS +
                                                ELASTIC_STEPS))
        want_launches = variants("f32", per_step * (WARMUP_ITERS + 1))
        check(runs == want_runs, f"elastic: kernels ran {runs} times on the "
              f"device, want {want_runs}")
        check(launches == want_launches, f"elastic: wrappers launched "
              f"{launches}, want {want_launches}")
        counts = dict(strong.group.total_counts)
        check(counts == {"all_gather": ELASTIC_STEPS} and
              dict(strong.group.step_counts) == {"all_gather": 1},
              f"elastic: collectives {counts}, last step "
              f"{dict(strong.group.step_counts)}")
        body = strong.train_window().body
        gather_bytes = 4 * body.row_len * MICROSHARDS
        plain = elastic_trainer(elastic=None)
        plain.train_model(0)
        ms = {"strong": [], "plain": []}
        for i, (which, tr) in enumerate((("strong", strong),
                                         ("plain", plain),
                                         ("plain", plain),
                                         ("strong", strong))):
            timers = tr.train_model(1 + i)
            torch.cuda.synchronize()
            ms[which].append(steady(timers)[0])
        s_ms, p_ms = (statistics.mean(ms[k]) for k in ("strong", "plain"))
        print(f"[elastic] vgg11 f32 allreduce --elastic strong, world 1 "
              f"NCCL, S={MICROSHARDS} microshards of {BATCH // MICROSHARDS}:"
              f" {ELASTIC_STEPS} windowed steps (graph replays), loss "
              f"{first:.4f} -> {second:.4f}; collectives {counts} "
              f"(1 all_gather a step); kernel runs {runs} "
              f"({per_step} a step on the device: {WARMUP_ITERS} warm-up "
              f"steps + {ELASTIC_STEPS} replays), wrapper launches "
              f"{launches}; gather {gather_bytes} bytes a step "
              f"({MICROSHARDS} rows of {body.row_len} f32)  ok  "
              f"[{card_line}]")
        print(f"[elastic] steady step (steps 21-{ELASTIC_STEPS}, whole "
              f"epochs in turns strong, plain, plain, strong; deterministic "
              f"cuDNN): strong {s_ms:.4f} ms ({ms['strong'][0]:.4f}, "
              f"{ms['strong'][1]:.4f}), {BATCH / s_ms * 1e3:.1f} images/s; "
              f"non-elastic allreduce {p_ms:.4f} ms ({ms['plain'][0]:.4f}, "
              f"{ms['plain'][1]:.4f}), {BATCH / p_ms * 1e3:.1f} images/s; "
              f"strong / non-elastic {s_ms / p_ms:.4f}  [{card_line}]")
        del strong, plain
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()

        # 2. Virtual worlds 2 and 4 against the world-1 Trainer.
        ref = elastic_trainer(BITWISE_STEPS)
        ref.train_model(0)
        torch.cuda.synchronize()
        want = ref.state
        for world in (2, 4):
            got, vruns = virtual_world_state(world, BITWISE_STEPS)
            n = check_same_state(f"elastic virtual world {world}", got, ref)
            check(vruns == variants("f32", per_step * BITWISE_STEPS),
                  f"elastic virtual world {world}: kernel runs {vruns}")
            paths[f"elastic/virtual world {world} ({BITWISE_STEPS} eager "
                  f"steps)"] = vruns
            print(f"[bitwise] elastic virtual world {world} on one card "
                  f"({world} ranks of {MICROSHARDS // world} microshard(s), "
                  f"rows concatenated in rank order): {BITWISE_STEPS} eager "
                  f"steps bitwise equal to the world-1 strong Trainer's "
                  f"{BITWISE_STEPS} windowed steps ({n} tensors); kernel "
                  f"runs {vruns}  ok")
            del got
        del ref, want
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()

        elastic_cli(card_line)
    finally:
        torch.backends.cudnn.deterministic = False
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[elastic] phase elastic: {time.perf_counter() - t_phase:.1f} s")
    return paths


TELEMETRY_STEPS = 60             # phase telemetry: three 20-step windows
TELEMETRY_EVAL = 4


def check_run_dir(label, run_dir, precision):
    """A ``--telemetry-out`` directory of a VGG-11 ``allreduce`` run of
    ``TELEMETRY_STEPS`` windowed steps against the limits of phase
    telemetry; its host round trips."""
    from cs744_ddp_tpu_torch.models import get_model
    from cs744_ddp_tpu_torch.obs import read_run, summarize_events

    manifest, events, summary = read_run(run_dir)
    check(manifest is not None and manifest["backend"] == "cuda"
          and manifest["device_kind"] == torch.cuda.get_device_name(0)
          and manifest["precision"] == precision
          and manifest["cuda_kernels"]["bnpool.cu"]["loaded"],
          f"{label}: manifest {manifest}")
    steps = [e for e in events if e["kind"] == "step"]
    check([e["iter"] for e in steps] == list(range(1, TELEMETRY_STEPS + 1))
          and [e.get("step_index") for e in steps]
          == list(range(TELEMETRY_STEPS))
          and all(math.isfinite(e["grad_sqnorm"]) for e in steps),
          f"{label}: step events {steps[:3]} ... ({len(steps)})")
    check(summary == summarize_events(events, global_batch=BATCH),
          f"{label}: summary.json is not summarize_events of the events")
    counters = summary["counters"]
    windows = -(-TELEMETRY_STEPS // WINDOW)
    trips = counters.get("host_round_trips", 0)
    check(0 < trips <= windows + 2, f"{label}: {trips} host round trips")
    gauges = {}
    for e in events:
        if e["kind"] == "gauge":
            gauges.setdefault(e["name"], []).append(e["value"])
    check(gauges.get("device_memory") and all(
        g["bytes_in_use"] > 0 and g["peak_bytes_in_use"] > 0
        and g["bytes_limit"] > 0 for g in gauges["device_memory"])
        and gauges.get("memory") and all(
            g["device_live_mib"] > 0 and g["host_rss_peak_mib"] > 0
            for g in gauges["memory"]),
        f"{label}: memory gauges {gauges.get('device_memory')} "
        f"{gauges.get('memory', [])[-1:]}")
    grad_bytes = sum(p.numel() * 4 for p in get_model("vgg11").parameters())
    want = STEP_COUNTS["allreduce"]["all_reduce"]
    check(counters.get("collective_all-reduce_count") == want
          and counters.get("collective_all-reduce_result_mib")
          == round(grad_bytes / 2 ** 20, 2),
          f"{label}: collective counters {counters}, want {want} "
          f"all-reduces of {grad_bytes} bytes")
    return trips, len(steps), summary


def trace_runs(path):
    """Each bnpool kernel variant's runs in a Chrome trace of
    ``torch.profiler``, and all device kernels in it."""
    from collections import Counter
    from cs744_ddp_tpu_torch.ops import bnpool
    with open(path) as f:
        trace = json.load(f)
    names = Counter(e.get("name", "") for e in trace["traceEvents"]
                    if e.get("cat") == "kernel")
    return bnpool.profiled_runs(names), sum(names.values())


def phase_telemetry(card_line):
    """``--telemetry-out`` and ``--profile-dir``; see the module
    docstring.  Returns each path's kernel runs."""
    import contextlib
    import io
    import torch.distributed as dist
    from cs744_ddp_tpu_torch import cli
    from cs744_ddp_tpu_torch.ops import bnpool
    from cs744_ddp_tpu_torch.train.step import WARMUP_ITERS
    from cs744_ddp_tpu_torch.utils.metrics import Stopwatch

    check(not dist.is_initialized(), "a process group exists already")
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "cs744_ddp_tpu_torch.utils.profile_telemetry"],
        capture_output=True, text=True, timeout=900, cwd=root)
    check(proc.returncode == 0, f"profile_telemetry failed:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            r = json.loads(line)
            check(r["same"] == {"round_trips": True, "runs": True},
                  f"telemetry {r['precision']}: round trips or kernel runs "
                  f"differ off and on: {r}")
        else:
            print(line)
    paths = {}
    want_runs = 5 * (WARMUP_ITERS + TELEMETRY_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        for precision in ("f32", "bf16"):
            run_dir = os.path.join(tmp, f"run_{precision}")
            argv = ["--strategy", "allreduce", "--precision", precision,
                    "--limit-train-batches", str(TELEMETRY_STEPS),
                    "--limit-eval-batches", str(TELEMETRY_EVAL),
                    "--telemetry-out", run_dir]
            prof_dir = os.path.join(tmp, "profile")
            if precision == "f32":
                argv += ["--profile-dir", prof_dir]
            bnpool.reset_launch_counts()
            out = io.StringIO()
            with contextlib.redirect_stdout(out), Stopwatch() as wall:
                cli.main(argv)
            runs = bnpool.executed_counts()
            label = f"telemetry cli {precision}"
            check(runs == variants(precision, want_runs),
                  f"{label}: kernels ran {runs} times on the device, want "
                  f"{variants(precision, want_runs)}")
            check("Test set: Average loss" in out.getvalue(),
                  f"{label}: no test line in\n{out.getvalue()[-2000:]}")
            trips, nsteps, summary = check_run_dir(label, run_dir, precision)
            render_run_dir(label, run_dir, ("manifest", "steps", "spans",
                                            "counters", "memory", "gauges"),
                           steps=TELEMETRY_STEPS)
            paths[f"telemetry/cli {precision} ({TELEMETRY_STEPS} steps)"] \
                = runs
            steady_ms = 1e3 * summary["steady_step_time_s"]["mean"]
            print(f"[telemetry] cli vgg11 {precision} allreduce, batch "
                  f"{BATCH}, --limit-train-batches {TELEMETRY_STEPS} "
                  f"--telemetry-out: {nsteps} step events with finite "
                  f"grad_sqnorm and step_index 0..{nsteps - 1}, "
                  f"summary.json = summarize_events, host_round_trips "
                  f"{trips} (windows + 2 = "
                  f"{-(-TELEMETRY_STEPS // WINDOW) + 2}), device_memory and "
                  f"memory gauges, collective_all-reduce_count "
                  f"{summary['counters']['collective_all-reduce_count']}; "
                  f"kernel runs {runs}; steady step {steady_ms:.4f} ms "
                  f"(summary mean), {summary['steady_images_per_sec']:.1f} "
                  f"images/s; the CLI's wall {wall.elapsed:.1f} s  ok  "
                  f"[{card_line}]")
            if precision == "f32":
                traces = os.listdir(prof_dir)
                check(traces == ["trace_epoch0_rank0.json"],
                      f"--profile-dir wrote {traces}")
                path = os.path.join(prof_dir, traces[0])
                seen, kernels = trace_runs(path)
                check(seen == runs, f"the profiled epoch's trace holds "
                      f"{seen} bnpool runs, the device counted {runs}")
                print(f"[telemetry] --profile-dir: {traces[0]} "
                      f"({os.path.getsize(path)} bytes, {kernels} device "
                      f"kernels) holds the bnpool kernels {seen}, the runs "
                      f"counted on the device in the profiled epoch  ok")
    check(not dist.is_initialized(), "the CLI left a process group")
    print(f"[telemetry] phase telemetry: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return paths


SERVE_BUCKETS = (1, 8, 32, 128, 256)
SERVE_DIRECT_N = (1, 3, 8, 20, 100, 200)
SERVE_CPU_N = (1, 20, 100)
SERVE_TIMING_REPS = 30           # dispatches a bucket, median
SERVE_REPLAY_REPS = 20           # graph replays a bucket, CUDA events
SERVE_PIPE_REPS = 40             # bucket-256 dispatches, serial and two deep
SERVE_DEMO_REQUESTS = 400
SERVE_DEMO_LOADS = (20.0, 2000.0)
SERVE_CLI_REQUESTS = 100
# The serving forward against an eager forward at the exact size
# (tests/test_torch_port_precision.py's bounds against the reference).
SERVE_RTOL = {"f32": 1e-4, "bf16": 1e-2}


def serve_requests(pool, rng, n):
    """``n`` images (and labels) drawn from ``pool``."""
    idx = rng.integers(0, len(pool.images), size=n)
    return pool.images[idx], pool.labels[idx]


def serve_invariance(engine, prec, pool, rng):
    """In every bucket, the rows of a request of the bucket's smallest
    fill, alone (with pad rows), are bitwise the same with other requests
    before or after it, at every fill of the bucket.  Returns the number
    of dispatches compared."""
    prev, compared = 0, 0
    for b in engine.buckets:
        k = prev + 1
        x, _ = serve_requests(pool, rng, k)
        alone = engine.infer(x, precision=prec)
        for m in range(k + 1, b + 1):
            y, _ = serve_requests(pool, rng, m - k)
            first = engine.infer(np.concatenate([x, y]), precision=prec)
            last = engine.infer(np.concatenate([y, x]), precision=prec)
            check(np.array_equal(first[:k], alone)
                  and np.array_equal(last[m - k:], alone),
                  f"serve {prec} bucket {b}: a request of {k} rows changes "
                  f"with {m - k} batchmates")
            compared += 2
        prev = b
    return compared


def serve_direct(engine, prec, pool, rng):
    """Against the eager forward at the exact size n; which n are
    bitwise."""
    fwd = engine._forward[prec]
    rtol = SERVE_RTOL[prec]
    bitwise, worst = [], 0.0
    for n in SERVE_DIRECT_N:
        x, y = serve_requests(pool, rng, n)
        logits, loss, correct = engine.infer_counts(x, y, precision=prec)
        want = fwd(torch.from_numpy(x).cuda(),
                   torch.from_numpy(y.astype(np.int64)).cuda())
        want_logits = want[0].cpu().numpy()
        check(logits.shape == (n, 10) and np.isfinite(logits).all(),
              f"serve {prec} n={n}: logits {logits.shape}")
        np.testing.assert_allclose(logits, want_logits, rtol=rtol, atol=rtol)
        np.testing.assert_allclose(loss, float(want[1]), rtol=rtol)
        worst = max(worst, float(np.abs(logits - want_logits).max()))
        if np.array_equal(logits, want_logits):
            bitwise.append(n)
    return bitwise, worst


def serve_vs_cpu(engine, cpu_engine, prec, pool, rng):
    """The card's logits against the same weights on the CPU, to
    ``logits_vs_cpu``'s bounds; ``correct`` equal.  Returns the largest
    difference and, in bf16, the CPU's own bf16-vs-f32 distance."""
    worst, gauge_max = 0.0, 0.0
    for n in SERVE_CPU_N:
        x, y = serve_requests(pool, rng, n)
        got, loss, correct = engine.infer_counts(x, y, precision=prec)
        want, want_loss, want_correct = cpu_engine.infer_counts(
            x, y, precision=prec)
        diff = float(np.abs(got - want).max())
        if prec == "f32":
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
        else:
            gauge = float(np.abs(want - cpu_engine.infer(x)).max())
            check(diff <= 2 * gauge + 1e-3,
                  f"serve bf16 n={n}: the card is {diff} from the CPU, whose "
                  f"bf16 is {gauge} from its f32")
            gauge_max = max(gauge_max, gauge)
        check(correct == want_correct,
              f"serve {prec} n={n}: correct {correct} on the card, "
              f"{want_correct} on the CPU")
        worst = max(worst, diff)
    x, _ = serve_requests(pool, rng, 5)
    _, loss, correct = engine.infer_counts(x, precision=prec)
    check(loss == 0.0 and correct == 0,
          f"serve {prec}: an unlabeled request gives loss {loss}, correct "
          f"{correct}")
    return worst, gauge_max


def serve_pipeline(engine, pool, rng):
    """Two bucket-256 dispatches in flight give the serial bits; a third
    issue waits on the first slot's fence.  Under sync-debug "error": the
    dispatch path makes no synchronizing call."""
    b = engine.max_batch
    batches = [serve_requests(pool, rng, b) for _ in range(3)]
    serial = [engine.infer_counts(x, y) for x, y in batches]
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = [engine.infer_counts_async(x, y) for x, y in batches[:2]]
        two = [engine.complete(hd)[:3] for hd in h]
        h = [engine.infer_counts_async(x, y) for x, y in batches]
        harvested = h[0].result is not None and h[1].result is None
        three = [engine.complete(hd)[:3] for hd in h]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for label, got in (("two in flight", two), ("three issued", three)):
        for (gl, gs, gc), (wl, ws, wc) in zip(got, serial):
            check(np.array_equal(gl, wl) and gs == ws and gc == wc,
                  f"serve: {label} differ from the serial dispatches")
    check(harvested, "serve: a third issue with two in flight did not wait "
          "on the first slot's fence")


def serve_times(engine, prec, pool, rng):
    """Per bucket: the median wall time of ``infer_counts`` (stage,
    replay, fetch) and the graph replay alone by CUDA events."""
    rows = {}
    for b in engine.buckets:
        x, y = serve_requests(pool, rng, b)
        for _ in range(3):
            engine.infer_counts(x, y, precision=prec)
        walls = []
        for _ in range(SERVE_TIMING_REPS):
            t0 = time.perf_counter()
            engine.infer_counts(x, y, precision=prec)
            walls.append(time.perf_counter() - t0)
        run = engine._rung(b, prec, engine._slots[0])
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.cuda.stream(engine._stream):
            run()
            start.record()
            for _ in range(SERVE_REPLAY_REPS):
                run()
            end.record()
        end.synchronize()
        ms = 1e3 * statistics.median(walls)
        rows[b] = (ms, start.elapsed_time(end) / SERVE_REPLAY_REPS)
    return rows


def serve_pipe_times(engine, pool, rng):
    """Bucket-256 dispatches, serial against two in flight, in turns
    (serial, pipelined, pipelined, serial): ms a dispatch of each."""
    b = engine.max_batch
    batches = [serve_requests(pool, rng, b) for _ in range(4)]

    def serial():
        for i in range(SERVE_PIPE_REPS):
            engine.infer_counts(*batches[i % 4])

    def piped():
        prev = engine.infer_counts_async(*batches[0])
        for i in range(1, SERVE_PIPE_REPS):
            nxt = engine.infer_counts_async(*batches[i % 4])
            engine.complete(prev)
            prev = nxt
        engine.complete(prev)

    out = {"serial": [], "two in flight": []}
    for name, fn in (("serial", serial), ("two in flight", piped),
                     ("two in flight", piped), ("serial", serial)):
        t0 = time.perf_counter()
        fn()
        out[name].append(1e3 * (time.perf_counter() - t0) / SERVE_PIPE_REPS)
    return out


def phase_serve(card_line):
    """The serving engine on the card; see the module docstring.  Returns
    each kernel variant's runs over the phase (all 0)."""
    from cs744_ddp_tpu_torch.obs import percentile, read_run
    from cs744_ddp_tpu_torch.ops import bnpool
    from cs744_ddp_tpu_torch.serve import InferenceEngine, demo

    t_phase = time.perf_counter()
    runs_before = bnpool.executed_counts()
    pool = demo.request_pool()
    rng = np.random.default_rng(11)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    engine = InferenceEngine("vgg11", buckets=SERVE_BUCKETS,
                             precisions=("f32", "bf16"), seed=0)
    report = engine.startup()
    torch.cuda.synchronize()
    ladder_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    check(report["backend"] == "cuda" and not report["warm"]
          and all(v["source"] == "capture"
                  for v in report["per_bucket"].values()),
          f"serve startup report {report}")
    per = ", ".join(f"{k} {v['seconds']:.3f}"
                    for k, v in report["per_bucket"].items())
    print(f"[serve] ladder vgg11 buckets {SERVE_BUCKETS} f32+bf16, 2 "
          f"pipeline slots ({2 * len(report['per_bucket'])} graphs): "
          f"startup {report['startup_s']:.3f} s (capture s a rung, both "
          f"slots: {per}); peak max_memory_allocated "
          f"{ladder_mib:.1f} MiB above the {base / 2 ** 20:.1f} MiB held "
          f"before  [{card_line}]")
    cpu_engine = InferenceEngine("vgg11", buckets=SERVE_BUCKETS,
                                 precisions=("f32", "bf16"), seed=0,
                                 device="cpu")
    for prec in ("f32", "bf16"):
        compared = serve_invariance(engine, prec, pool, rng)
        print(f"[serve] {prec} batchmate invariance: in every bucket a "
              f"request's rows bitwise the same alone and with batchmates "
              f"before or after it at every fill ({compared} dispatches)  "
              f"ok")
        bitwise, worst = serve_direct(engine, prec, pool, rng)
        print(f"[serve] {prec} against the eager forward at the exact size "
              f"n in {SERVE_DIRECT_N} (rtol/atol {SERVE_RTOL[prec]}): max "
              f"|diff| {worst:.3e}; bitwise at n = {bitwise}, not at "
              f"{[n for n in SERVE_DIRECT_N if n not in bitwise]}  ok")
        worst, gauge = serve_vs_cpu(engine, cpu_engine, prec, pool, rng)
        bound = ("rtol/atol 1e-3" if prec == "f32" else
                 f"2x the CPU's bf16-vs-f32 {gauge:.3e} + 1e-3")
        print(f"[serve] {prec} against the CPU, same weights, n in "
              f"{SERVE_CPU_N} ({bound}): max |diff| {worst:.3e}, correct "
              f"equal; an unlabeled request gives loss 0, correct 0  ok")
    del cpu_engine
    serve_pipeline(engine, pool, rng)
    print("[serve] two bucket-256 dispatches in flight (infer_counts_async "
          "x2, complete x2) bitwise the serial ones; a third issue waited "
          "on the first slot's fence; no synchronizing call under "
          "sync-debug \"error\"  ok")
    for prec in ("f32", "bf16"):
        rows = serve_times(engine, prec, pool, rng)
        for b, (ms, replay_ms) in rows.items():
            print(f"[serve time] {prec} bucket {b}: infer_counts median "
                  f"{ms:.4f} ms ({b / ms * 1e3:.1f} images/s), graph "
                  f"replay alone {replay_ms:.4f} ms (CUDA events, "
                  f"{SERVE_REPLAY_REPS} replays)  [{card_line}]")
    pipe = serve_pipe_times(engine, pool, rng)
    print(f"[serve time] f32 bucket {engine.max_batch}, "
          f"{SERVE_PIPE_REPS} dispatches in turns: serial "
          f"{pipe['serial']} ms a dispatch, two in flight "
          f"{pipe['two in flight']} ms a dispatch  [{card_line}]")
    for rps in SERVE_DEMO_LOADS:
        st = demo.run_demo(engine, n_requests=SERVE_DEMO_REQUESTS,
                           offered_rps=rps, seed=0)
        check(st["completed"] + st["rejected"] == SERVE_DEMO_REQUESTS
              and st["completed"] > 0,
              f"serve demo at {rps:g} rps: {st}")
        lat = st["latency_ms"]
        print(f"[serve demo] f32 {SERVE_DEMO_REQUESTS} requests at "
              f"{rps:g} rps offered: p50 {lat['p50']} ms, p95 "
              f"{lat['p95']} ms, p99 {lat['p99']} ms; achieved "
              f"{st['achieved_rps']} rps, {st['images_per_sec']} images/s, "
              f"rejected {st['rejected']}, driver_lag_ms_max "
              f"{st['driver_lag_ms_max']}  [{card_line}]")
    del engine
    with tempfile.TemporaryDirectory() as tmp:
        out = run_cli(["--serve-demo", "--serve-requests",
                       str(SERVE_CLI_REQUESTS), "--telemetry-out", tmp],
                      "serve cli", timeout=300)
        last = json.loads(out.strip().splitlines()[-1])
        st = last["demo"]["20rps"]
        check(set(last) == {"startup", "demo"}
              and last["startup"]["backend"] == "cuda"
              and st["completed"] + st["rejected"] == SERVE_CLI_REQUESTS,
              f"serve cli: last line {last}")
        # The "== serving ==" section's inputs, against the last line.
        manifest, events, summary = read_run(tmp)
        lat = {}
        depth = 0
        for e in events:
            if e["kind"] == "gauge" and e["name"] == "serve_latency_ms":
                lat.setdefault(e["bucket"], []).append(e["value"])
            depth += e["kind"] == "gauge" and e["name"] == "queue_depth"
        check(manifest["mode"] == "serve" and summary is not None
              and depth > 0 and sum(map(len, lat.values()))
              == st["completed"],
              f"serve cli: run directory {manifest}, {len(events)} events")
        print(f"[serve] cli --serve-demo --telemetry-out (the card, "
              f"{SERVE_CLI_REQUESTS} requests at 20 rps): last line parses, "
              f"startup {last['startup']['startup_s']} s, p99 "
              f"{st['latency_ms']['p99']} ms; the run directory's serving "
              f"gauges: latency by bucket "
              + ", ".join(f"{b} x{len(v)} p50 {percentile(v, 50):.3f} ms"
                          for b, v in sorted(lat.items()))
              + f", {depth} queue_depth samples  ok")
        render_run_dir("serve cli --serve-demo", tmp, (
            "manifest", "steps", "spans", "counters", "serving", "traces",
            "gauges"), absent=("slo", "alerts"), steps=0)
    runs = bnpool.executed_counts()
    diff = {k: runs[k] - runs_before[k] for k in runs}
    check(not any(diff.values()),
          f"serve: the bnpool kernels ran {diff} times")
    print(f"[serve] bnpool runs over the phase {diff}; phase serve: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"serve": diff}


SERVE_TIER_MODEL = "vgg11"
SERVE_TIER_REPLICAS = 2
SERVE_TIER_REQUESTS = 400
SERVE_TIER_RTOL = 1e-4          # a reply against its replica's serial dispatch
SERVE_TIER_WARM = 3             # dispatches a bucket a replica, before timing
SERVE_TIER_CHAOS = 24           # requests of the fault and failover runs
SERVE_TIER_CLI_REQUESTS = 100


def serve_tier_load(replicas, rps, pool, tel, card_line, label,
                    sync_debug=False):
    """One open-loop replay of the seeded tiered trace at ``rps`` through
    the router and the socket front-end, by a ``FrontendClient``, under
    ``torch.profiler`` (``profile_serve_tier.run_load``); checks that every
    request got one reply and none an error, prints the load's line and
    returns the recorder's entries and each trace's (replica, bucket)."""
    from cs744_ddp_tpu_torch.serve import demo
    from cs744_ddp_tpu_torch.utils import profile_serve_tier as pst

    sizes = tuple(s for s in demo.SIZE_CHOICES
                  if s <= replicas[0].engine.max_batch)
    trace = demo.synthetic_load_trace(SERVE_TIER_REQUESTS, offered_rps=rps,
                                      seed=0, size_choices=sizes)
    out = pst.run_load(replicas, trace, pool=pool, seed=0, telemetry=tel,
                       sync_debug=sync_debug)
    st, sent = out["stats"], out["sent"]
    check(st["replies"] == SERVE_TIER_REQUESTS and st["unresolved"] == 0
          and all("reply" in e for e in sent)
          and st["unique_traces"] == st["traced"]
          and all(e["reply"]["trace"] in out["served"] for e in sent
                  if e["reply"]["status"] in ("ok", "late")),
          f"serve_tier {label}: not every request got one reply: {st}")
    check(not any(e["reply"]["status"] == "error" for e in sent),
          f"serve_tier {label}: error replies "
          f"{[e['reply'] for e in sent if e['reply']['status'] == 'error'][:3]}")
    print(f"[serve_tier load] {label}, {len(replicas)} replica(s): "
          f"{pst.describe(out, SERVE_BUCKETS)}  [{card_line}]")
    return sent, out["served"]


def serve_tier_bits(replicas, sent, served, label):
    """Each ok or late reply's logits against its serving replica's serial
    ``infer_counts`` of that request alone, within SERVE_TIER_RTOL (which
    of them are bitwise is counted: the bits depend on the bucket), and
    bitwise the serial dispatch of the request padded to the bucket that
    served it (a request's rows do not depend on their batchmates).  The
    workers are stopped.  Returns ``{index: (bucket, logits)}`` and the
    count bitwise the request alone."""
    got, alone_bitwise = {}, 0
    for i, e in enumerate(sent):
        rep = e["reply"]
        if rep["status"] not in ("ok", "late"):
            continue
        index, bucket = served[rep["trace"]]
        engine = replicas[index].engine
        images = e["images"]
        want = engine.infer_counts(images)[0]
        check(rep["logits"].shape == want.shape
              and np.isfinite(rep["logits"]).all(),
              f"serve_tier {label}: request {i} logits "
              f"{rep['logits'].shape}")
        np.testing.assert_allclose(rep["logits"], want, rtol=SERVE_TIER_RTOL,
                                   atol=SERVE_TIER_RTOL)
        alone_bitwise += np.array_equal(rep["logits"], want)
        pad = np.zeros((bucket - len(images),) + images.shape[1:], np.uint8)
        rung = engine.infer_counts(np.concatenate([images, pad]))[0]
        check(np.array_equal(rep["logits"], rung[:len(images)]),
              f"serve_tier {label}: request {i} ({len(images)} images) "
              f"differs from its bucket-{bucket} rung's serial dispatch")
        got[i] = (bucket, rep["logits"])
    return got, alone_bitwise


def _once_futures(reqs):
    """Each request's Future replaced by one that counts its resolutions."""
    from concurrent.futures import Future

    class Once(Future):
        sets = 0

        def set_result(self, result):
            self.sets += 1
            super().set_result(result)
    for r in reqs:
        r.future = Once()
    return reqs


def serve_tier_chaos(replicas, pool, rng, card_line):
    """``dispatch_fault``, ``slow_replica`` and then ``replica_death``
    (which leaves replica 0 dead), each at a dispatch a few past the
    replica's count so far, through the router."""
    from cs744_ddp_tpu_torch.ft import ChaosPlan
    from cs744_ddp_tpu_torch.serve import ReplicaRouter, make_request

    r0 = replicas[0]
    max_b = r0.engine.max_batch

    def burst(router, sizes):
        """Requests placed 2 ms apart, so that each replica dispatches
        several times; at most 960 images in all, so that the survivor's
        1024-image queue takes every failover."""
        reqs = _once_futures([make_request(serve_requests(pool, rng, n)[0],
                                           max_batch=max_b)
                              for n in sizes])
        for r in reqs:
            router._place(r)
            time.sleep(0.002)
        return reqs, [r.future.result(120) for r in reqs]

    sizes = [int(n) for n in rng.choice(
        [n for n in (1, 3, 8, 40) if n <= max_b], SERVE_TIER_CHAOS)]
    # dispatch_fault: that dispatch's requests get errors, the rest the
    # serial bits.
    at = r0.scheduler._dispatches + 1
    r0.chaos = ChaosPlan.parse([f"dispatch_fault:{at}:0"])
    with ReplicaRouter(replicas) as router:
        reqs, replies = burst(router, sizes)
    check(("dispatch_fault", at) in r0.chaos.fired,
          f"serve_tier: dispatch_fault:{at}:0 did not fire")
    errs = [(r, p) for r, p in zip(reqs, replies) if p.status == "error"]
    check(errs and all(p.replica == 0 and f"dispatch {at} " in p.reason
                       for _, p in errs)
          and sum(r.n for r, _ in errs) <= max_b
          and all(p.status == "ok" for p in replies if p.status != "error")
          and all(r.future.sets == 1 for r in reqs),
          f"serve_tier dispatch_fault: replies "
          f"{[(p.status, p.replica, p.reason) for p in replies]}")
    bitwise = 0
    for r, p in zip(reqs, replies):
        if p.status == "ok":
            want = replicas[p.replica].engine.infer_counts(r.images)[0]
            np.testing.assert_allclose(p.logits, want, rtol=SERVE_TIER_RTOL,
                                       atol=SERVE_TIER_RTOL)
            bitwise += np.array_equal(p.logits, want)
    print(f"[serve_tier chaos] dispatch_fault:{at}:0: {len(errs)} "
          f"request(s) of that dispatch ({sum(r.n for r, _ in errs)} "
          f"images) got error replies ({errs[0][1].reason!r}); the other "
          f"{len(reqs) - len(errs)} ok, within rtol/atol {SERVE_TIER_RTOL} "
          f"of their replica's serial dispatch ({bitwise} bitwise); each "
          f"future resolved once  ok")
    # slow_replica: tier-0 requests queued behind the stall shed or late.
    # The stall starts when the replica notes the firing and sleeps at
    # least slow_stall_s; nothing is dispatched before it ends.  A request
    # whose submit returned more than its SLO before that end cannot meet
    # its deadline, so it must shed or be late.  One submitted later (the
    # host paused this thread past the stall) proves nothing either way;
    # if none of the 8 was provably behind the stall, the scenario runs
    # again at the next dispatch, at most 3 times.
    slo_ms = 75.0
    stall_t0 = {}
    note = r0._note_chaos

    def stamped_note(site, dispatch_no):
        stall_t0.setdefault((site, dispatch_no), time.monotonic())
        note(site, dispatch_no)
    r0._note_chaos = stamped_note
    try:
        for attempt in range(1, 4):
            at = r0.scheduler._dispatches
            r0.chaos = ChaosPlan.parse([f"slow_replica:{at}:0"])
            with r0:
                first = r0.scheduler.submit(
                    serve_requests(pool, rng, max_b)[0])
                t_end = time.time() + 60
                while ("slow_replica", at) not in r0.chaos.fired:
                    check(time.time() < t_end,
                          "serve_tier: slow_replica never fired")
                    time.sleep(0.001)
                tight = []
                for _ in range(8):
                    f = r0.scheduler.submit(serve_requests(pool, rng, 1)[0],
                                            tier=0, slo_ms=slo_ms)
                    tight.append((f, time.monotonic()))
                p0 = first.result(120)
                ps = [(f.result(120), t) for f, t in tight]
            stall_end = stall_t0[("slow_replica", at)] + r0.slow_stall_s
            behind = [p for p, t in ps if t + slo_ms / 1e3 < stall_end]
            lead_ms = [round(1e3 * (stall_end - t), 3) for _, t in ps]
            check(p0.status == "ok"
                  and p0.service_ms >= 1e3 * r0.slow_stall_s
                  and all(p.status in ("shed", "late") for p in behind)
                  and all(p.status in ("ok", "shed", "late") for p, _ in ps)
                  and all(p.reason for p, _ in ps if p.status == "shed"),
                  f"serve_tier slow_replica: {p0.status} {p0.service_ms} "
                  f"ms; {len(behind)} of 8 submitted > {slo_ms} ms before "
                  f"the stall's end; {[(p.status, p.reason) for p, _ in ps]}"
                  f", submitted this many ms before its end: {lead_ms}")
            print(f"[serve_tier chaos] slow_replica:{at}:0 ({r0.slow_stall_s}"
                  f" s stall, attempt {attempt}): the stalled dispatch served"
                  f" in {p0.service_ms} ms; 8 tier-0 requests ({slo_ms} ms "
                  f"SLO), {len(behind)} submitted more than their SLO before "
                  f"the stall's end: "
                  f"{[(p.status, p.reason) for p, _ in ps]}  ok")
            if behind:
                break
        check(behind, "serve_tier slow_replica: in 3 attempts no tier-0 "
                      "request was submitted more than its SLO before the "
                      "stall's end")
    finally:
        r0._note_chaos = note
    # replica_death: failover without a lost or doubled reply; the dead
    # worker's in-flight dispatch fenced before it ends.
    at = r0.scheduler._dispatches + 1
    r0.chaos = ChaosPlan.parse([f"replica_death:{at}:0"])
    with ReplicaRouter(replicas) as router:
        reqs, replies = burst(router, sizes)
        alive = [rep.alive for rep in replicas]
    stats = router.stats()
    check(("replica_death", at) in r0.chaos.fired and alive == [False, True]
          and stats["failovers"] >= 1
          and all(p.status == "ok" for p in replies)
          and all(r.future.sets == 1 for r in reqs)
          and all(slot.handle is None for slot in r0.engine._slots),
          f"serve_tier replica_death: alive {alive}, {stats}, "
          f"{[(p.status, p.replica) for p in replies]}")
    for r, p in zip(reqs, replies):
        np.testing.assert_allclose(
            p.logits, replicas[p.replica].engine.infer_counts(r.images)[0],
            rtol=SERVE_TIER_RTOL, atol=SERVE_TIER_RTOL)
    print(f"[serve_tier chaos] replica_death:{at}:0: replica 0 dead, "
          f"{stats['failovers']} failovers, all {len(reqs)} requests ok "
          f"(served by replica {sorted({p.replica for p in replies})}), "
          f"each future resolved once, the dead engine's slots all read "
          f"back (its in-flight dispatch fenced)  ok")


def phase_serve_tier(card_line):
    """The serving tier on the card; see the module docstring.  Returns
    each kernel variant's runs over the phase (all 0)."""
    from cs744_ddp_tpu_torch.obs import Telemetry, read_run
    from cs744_ddp_tpu_torch.ops import bnpool
    from cs744_ddp_tpu_torch.serve import EngineReplica, demo
    from cs744_ddp_tpu_torch.utils import profile_serve_tier as pst

    t_phase = time.perf_counter()
    runs_before = bnpool.executed_counts()
    pool = demo.request_pool()
    rng = np.random.default_rng(12)
    devices = pst.devices(SERVE_TIER_REPLICAS)
    tel = Telemetry()
    gc.collect()
    torch.cuda.synchronize()
    base = {}
    for d in set(devices):
        torch.cuda.reset_peak_memory_stats(d)
        base[d] = torch.cuda.memory_allocated(d)
    replicas = [EngineReplica(i, SERVE_TIER_MODEL, device=d,
                              buckets=SERVE_BUCKETS, seed=0, telemetry=tel)
                for i, d in enumerate(devices)]
    reports = [rep.startup() for rep in replicas]
    for d in set(devices):
        torch.cuda.synchronize(d)
    peak = {str(d): (torch.cuda.max_memory_allocated(d) - base[d]) / 2 ** 20
            for d in base}
    for rep, report in zip(replicas, reports):
        check(report["backend"] == "cuda"
              and all(v["source"] == "capture"
                      for v in report["per_bucket"].values()),
              f"serve_tier replica {rep.index} startup {report}")
        per = ", ".join(f"{k} {v['seconds']:.3f}"
                        for k, v in report["per_bucket"].items())
        print(f"[serve_tier] replica {rep.index} on {rep.engine.device}: "
              f"{SERVE_TIER_MODEL} f32 ladder {SERVE_BUCKETS} x 2 slots captured in "
              f"{report['startup_s']:.3f} s (s a rung: {per})  [{card_line}]")
    print(f"[serve_tier] peak max_memory_allocated above what was held, by "
          f"card, both ladders: "
          f"{ {k: round(v, 1) for k, v in peak.items()} } MiB  [{card_line}]")
    pst.warm(replicas, pool, rng, SERVE_TIER_WARM)
    runs, images = {}, {}
    for label, rps, pipeline, sync_debug in (
            ("200 rps pipeline on (sync-debug \"error\")", 200.0, True,
             True),
            ("2000 rps pipeline on", 2000.0, True, False),
            ("2000 rps pipeline off", 2000.0, False, False)):
        for rep in replicas:
            rep.scheduler.pipeline = pipeline
        sent, served = serve_tier_load(replicas, rps, pool, tel, card_line,
                                       label, sync_debug=sync_debug)
        got, bitwise = serve_tier_bits(replicas, sent, served, label)
        runs[label] = got
        images[label] = [e["images"] for e in sent]
        print(f"[serve_tier] {label}: {len(got)} ok or late replies, each "
              f"bitwise its replica's serial dispatch of the request padded "
              f"to the bucket that served it, and within rtol/atol "
              f"{SERVE_TIER_RTOL} of the request alone ({bitwise} bitwise)"
              + ("; no synchronizing call on the dispatch path (sync-debug "
                 "\"error\", pipelined workers)" if sync_debug else "")
              + "  ok")
    on, off = runs["2000 rps pipeline on"], runs["2000 rps pipeline off"]
    both = sorted(set(on) & set(off))
    check(len(both) > 0 and all(
        np.array_equal(images["2000 rps pipeline on"][i],
                       images["2000 rps pipeline off"][i]) for i in both),
          "serve_tier: the two 2000-rps runs served no request in common, "
          "or other images")
    same_bucket = [i for i in both if on[i][0] == off[i][0]]
    check(all(np.array_equal(on[i][1], off[i][1]) for i in same_bucket),
          "serve_tier: pipeline on and off give other bits in one bucket")
    # Which bucket a request rides in depends on the queue that the
    # arrival timing leaves at each free slot, so how many requests share
    # a bucket across the two runs varies from host to host.  A request
    # that moved is held, in each run's bucket, against both replicas'
    # serial dispatch: no request served in both runs escapes a bitwise
    # comparison of the two modes, whatever the timing.
    moved = [i for i in both if on[i][0] != off[i][0]]
    for i in moved:
        request = images["2000 rps pipeline off"][i]
        for bucket, logits in (on[i], off[i]):
            pad = np.zeros((bucket - len(request),) + request.shape[1:],
                           np.uint8)
            batch = np.concatenate([request, pad])
            for rep in replicas:
                rung = rep.engine.infer_counts(batch)[0]
                check(np.array_equal(logits, rung[:len(request)]),
                      f"serve_tier: request {i} differs in bucket {bucket} "
                      f"from replica {rep.index}'s serial dispatch")
    equal = sum(np.array_equal(on[i][1], off[i][1]) for i in both)
    print(f"[serve_tier] pipeline on and off over the same 2000-rps trace: "
          f"of the {len(both)} requests served in both runs, the "
          f"{len(same_bucket)} that rode in the same bucket bitwise equal, "
          f"the {len(moved)} that rode in another each bitwise every "
          f"replica's serial dispatch in both its buckets; {equal} of "
          f"{len(both)} bitwise equal in all  ok")
    for rep in replicas:
        rep.scheduler.pipeline = True
    serve_tier_chaos(replicas, pool, rng, card_line)
    del replicas
    gc.collect()
    with tempfile.TemporaryDirectory() as tmp:
        out = run_cli(["--serve-frontend", "--serve-replicas",
                       str(SERVE_TIER_REPLICAS), "--serve-requests",
                       str(SERVE_TIER_CLI_REQUESTS), "--serve-load", "200",
                       "--telemetry-out", tmp], "serve_tier cli",
                      timeout=300)
        last = json.loads(out.strip().splitlines()[-1])
        st = last["load"]["200rps"]
        manifest, events, summary = read_run(tmp)
        check(set(last) == {"address", "startup", "router", "load",
                            "alerts"}
              and all(r["backend"] == "cuda"
                      for r in last["startup"].values())
              and st["replies"] == SERVE_TIER_CLI_REQUESTS
              and st["unresolved"] == 0
              and manifest["mode"] == "serve-frontend"
              and manifest["replicas"] == SERVE_TIER_REPLICAS
              and summary is not None,
              f"serve_tier cli: last line {last}; manifest {manifest}")
        print(f"[serve_tier] cli --serve-frontend --serve-replicas "
              f"{SERVE_TIER_REPLICAS} --telemetry-out (the card, devices "
              f"{manifest['devices']}): last line parses, "
              f"{SERVE_TIER_CLI_REQUESTS} replies at 200 rps, attainment "
              f"{st['attainment']}, routed {last['router']['routed']}; "
              f"{len(events)} events  ok")
        render_run_dir("serve_tier cli --serve-frontend", tmp, (
            "manifest", "steps", "spans", "counters", "serving", "traces",
            "slo", "pipeline", "waterfall", "gauges"), steps=0)
    runs = bnpool.executed_counts()
    diff = {k: runs[k] - runs_before[k] for k in runs}
    check(not any(diff.values()),
          f"serve_tier: the bnpool kernels ran {diff} times")
    print(f"[serve_tier] bnpool runs over the phase {diff}; phase "
          f"serve_tier: {time.perf_counter() - t_phase:.1f} s")
    return {"serve_tier": diff}


PUBLISH_STEPS = 40             # phase publish: steps an epoch, 2 windows
PUBLISH_EPOCHS = 2
PUBLISH_EVAL = 2
PUBLISH_BYTES = 36946472        # VGG-11's 50 serving leaves, f32
PUBLISH_REQUESTS = 400
PUBLISH_RPS = 200.0
PUBLISH_SLO_MS = 10000.0        # one tier: every request must come back ok
PUBLISH_AT_S = 1.0              # into a replay, the mid-replay publish
PUBLISH_POLL_S = 0.05           # the watcher's poll (the CLI's default)


def _ladder(engine):
    """What a recapture would change: each rung's CUDA graph and each
    captured weight's address."""
    return ({k: id(getattr(v, "__self__", v))
             for k, v in engine._rungs.items()},
            {k: v.data_ptr() for k, v in engine._weights.items()})


def _to_card(sd, device):
    return {k: v.to(device) for k, v in sd.items()}


def publish_replay(replicas, pool, tel, label, publish=None):
    """One open-loop replay of PUBLISH_REQUESTS requests of one tier
    (PUBLISH_SLO_MS) at PUBLISH_RPS through the router and the socket
    front-end; with ``publish`` (a callable returning the version it
    published), called PUBLISH_AT_S into the replay on another thread.
    Checks one reply a request, every one ok, and each dispatch of a
    replica on one version, never an older one than the dispatch before
    it.  Returns (sent, served, lag record or None, replay output)."""
    import threading

    from cs744_ddp_tpu_torch.serve import demo
    from cs744_ddp_tpu_torch.utils import profile_serve_tier as pst

    sizes = tuple(s for s in demo.SIZE_CHOICES
                  if s <= replicas[0].engine.max_batch)
    trace = demo.synthetic_load_trace(
        PUBLISH_REQUESTS, offered_rps=PUBLISH_RPS, seed=0,
        size_choices=sizes, tiers=((0, 1, PUBLISH_SLO_MS),))
    lag = {}

    def mid():
        time.sleep(PUBLISH_AT_S)
        lag.update(publish())

    first = len(tel.records)
    thread = threading.Thread(target=mid) if publish else None
    if thread is not None:
        thread.start()
    try:
        out = pst.run_load(replicas, trace, pool=pool, seed=0, telemetry=tel,
                           profile=False)
    finally:
        if thread is not None:
            thread.join()
    st, sent = out["stats"], out["sent"]
    check(st["replies"] == PUBLISH_REQUESTS and st["unresolved"] == 0
          and st["unique_traces"] == st["traced"]
          and all(e["reply"]["status"] == "ok" for e in sent)
          and all(e["reply"]["trace"] in out["served"] for e in sent),
          f"publish {label}: not every request got one ok reply: {st}; "
          f"{sorted({e['reply']['status'] for e in sent})}")
    version = {e["reply"]["trace"]: e["reply"]["model_version"] for e in sent}
    last = {}
    for r in tel.records[first:]:
        if r.get("name") != "serve_service_ms":
            continue
        vs = {version[t] for t in r["traces"] if t in version}
        check(len(vs) == 1 and min(vs) >= last.get(r["replica"], -1),
              f"publish {label}: replica {r['replica']} dispatch of versions "
              f"{vs} after version {last.get(r['replica'])}")
        last[r["replica"]] = vs.pop()
    return sent, out["served"], lag, out


def publish_bits(sent, served, states, ref, label, precision="f32",
                 engines=None):
    """Each reply against what its tagged version computes: bitwise the
    serial dispatch of the request padded to the bucket that served it, on
    ``ref`` (or, with ``engines``, on the serving replica's own engine)
    with that version installed through ``install_weights``, and within
    SERVE_RTOL of ``ref``'s eager forward of the request alone.  The
    workers are stopped.  Returns {version: replies} and the largest
    difference from the eager forward."""
    by_version = {}
    for e in sent:
        by_version.setdefault(e["reply"]["model_version"], []).append(e)
    worst = 0.0
    for v, entries in sorted(by_version.items()):
        check(v in states, f"publish {label}: a reply of version {v}")
        ref.install_weights(_to_card(states[v], ref.device), v)
        for eng in (engines or {}).values():
            eng.install_weights(_to_card(states[v], eng.device), v)
        for e in entries:
            rep, images = e["reply"], e["images"]
            index, bucket = served[rep["trace"]]
            eng = (engines or {}).get(index, ref)
            pad = np.zeros((bucket - len(images),) + images.shape[1:],
                           np.uint8)
            rung = eng.infer_counts(np.concatenate([images, pad]),
                                    precision=precision)[0]
            check(np.array_equal(rep["logits"], rung[:len(images)]),
                  f"publish {label}: a reply of version {v} ({len(images)} "
                  f"images, bucket {bucket}) differs from that version's "
                  f"serial dispatch")
            want = ref._forward[precision](
                torch.from_numpy(images).to(ref.device),
                torch.full((len(images),), -1, dtype=torch.int64,
                           device=ref.device))[0].cpu().numpy()
            tol = SERVE_RTOL[precision]
            np.testing.assert_allclose(rep["logits"], want, rtol=tol,
                                       atol=tol)
            worst = max(worst, float(np.abs(rep["logits"] - want).max()))
    return {v: len(es) for v, es in by_version.items()}, worst


def _latency(sent):
    from cs744_ddp_tpu_torch.obs import percentile
    ms = [1e3 * (e["t1"] - e["t0"]) for e in sent]
    return percentile(ms, 50), percentile(ms, 99)


def phase_publish(card_line):
    """Train, publish and hot-swap on the card; see the module docstring.
    Returns each kernel variant's runs over the phase."""
    with tempfile.TemporaryDirectory(prefix="publish_smoke_") as tmp:
        return _phase_publish(card_line, tmp)


def _phase_publish(card_line, tmp):
    from cs744_ddp_tpu_torch.ft import NULL_CHAOS, ChaosPlan
    from cs744_ddp_tpu_torch.models import convert
    from cs744_ddp_tpu_torch.obs import Telemetry
    from cs744_ddp_tpu_torch.ops import bnpool
    from cs744_ddp_tpu_torch.publish import (WeightPublisher, WeightWatcher,
                                             read_bundle)
    from cs744_ddp_tpu_torch.serve import EngineReplica, InferenceEngine, demo
    from cs744_ddp_tpu_torch.train.loop import Trainer
    from cs744_ddp_tpu_torch.train.step import WARMUP_ITERS

    t_phase = time.perf_counter()
    device = torch.device("cuda", 0)
    runs_before = bnpool.executed_counts()
    # -- 1. train and publish --------------------------------------------
    train_dir = os.path.join(tmp, "train")
    snaps, losses = [], []
    tel_train = Telemetry()

    def on_log(line):
        if line.startswith("Published weights"):
            # The state this publish read, copied for the checks below.
            snaps.append({k: v.detach().cpu().clone() for k, v in
                          trainer.state.model.state_dict().items()})
            losses.append(list(trainer.last_epoch_timers.losses))
            print(f"[publish] {line}  [{card_line}]")

    trainer = Trainer("vgg11", "single", global_batch=BATCH, augment=True,
                      limit_train_batches=PUBLISH_STEPS,
                      limit_eval_batches=PUBLISH_EVAL, log=on_log,
                      telemetry=tel_train)
    trainer.run(PUBLISH_EPOCHS, publish_dir=train_dir)
    torch.cuda.synchronize()
    runs = bnpool.executed_counts()
    train_runs = {k: runs[k] - runs_before[k] for k in runs}
    want = variants("f32", 5 * (WARMUP_ITERS + PUBLISH_EPOCHS * PUBLISH_STEPS))
    check(train_runs == want, f"publish: the training ran the bnpool kernels "
          f"{train_runs} times on the device, want {want}")
    check(len(snaps) == PUBLISH_EPOCHS, f"publish: {len(snaps)} publishes")
    first, second = check_losses("publish epoch 1", losses[0], PUBLISH_STEPS)
    check(all(math.isfinite(v) for v in losses[1])
          and statistics.mean(losses[1]) < first,
          f"publish: epoch 2 losses {losses[1]}")
    walls = [r["dur_s"] for r in tel_train.records
             if r.get("kind") == "span" and r.get("name") == "publish"]
    for e, sd in enumerate(snaps, start=1):
        man, leaves = read_bundle(os.path.join(train_dir, f"v{e:06d}.ccwb"))
        want_leaves, treedef = convert.serving_leaves(sd)
        nbytes = sum(int(r["nbytes"]) for r in man["leaves"])
        check(man["version"] == e and man["treedef"] == treedef
              and nbytes == PUBLISH_BYTES and len(leaves) == 50
              and man["fingerprint"]["model"] == "vgg11"
              and all(np.array_equal(a, b)
                      for a, b in zip(leaves, want_leaves)),
              f"publish: bundle v{e} ({nbytes} B) is not the trainer's "
              f"serving leaves at epoch {e}")
    print(f"[publish] vgg11 f32 single, batch {BATCH}, {PUBLISH_EPOCHS} "
          f"epochs of {PUBLISH_STEPS} windowed steps, publishing each: "
          f"losses {first:.4f} -> {second:.4f} (epoch 1), mean "
          f"{statistics.mean(losses[1]):.4f} (epoch 2); bnpool runs on the "
          f"device {train_runs} (5 a step: {WARMUP_ITERS} warm-up steps and "
          f"{PUBLISH_EPOCHS * PUBLISH_STEPS} replays); bundles v1, v2 "
          f"{PUBLISH_BYTES} B, 50 leaves, each bitwise the trainer's "
          f"serving leaves at its epoch; publish wall "
          f"{[round(1e3 * w, 3) for w in walls]} ms  ok  [{card_line}]")
    del trainer
    gc.collect()
    states = {}
    # -- 2. hot-swap under load ------------------------------------------
    runs_serve = bnpool.executed_counts()
    pool = demo.request_pool()
    tel = Telemetry()
    sdir = os.path.join(tmp, "serve")
    pub = WeightPublisher(sdir, fingerprint={"model": "vgg11"})

    def publish(sd):
        rec = pub.publish(sd)
        states[rec["version"]] = sd
        return rec

    replicas = [EngineReplica(i, "vgg11", device=device,
                              buckets=SERVE_BUCKETS, seed=0, telemetry=tel)
                for i in range(SERVE_TIER_REPLICAS)]
    for rep in replicas:
        rep.startup()
    ref = InferenceEngine("vgg11", buckets=SERVE_BUCKETS, device=device)
    ref.startup()
    watcher = WeightWatcher(sdir, replicas, telemetry=tel,
                            poll_interval_s=PUBLISH_POLL_S)
    publish(snaps[0])
    check(watcher.poll_once() == "installed"
          and [r.engine.weights_version for r in replicas] == [1, 1],
          "publish: v1 not installed")
    ladders = [_ladder(r.engine) for r in replicas]
    probe = pool.images[:8]
    answers = {}
    for v, sd in ((1, snaps[0]), (2, snaps[1])):
        ref.install_weights(_to_card(sd, device), v)
        answers[v] = ref.infer(probe)
    check(not np.array_equal(answers[1], answers[2]),
          "publish: v1 and v2 answer the same")
    sent, served, _, out = publish_replay(replicas, pool, tel, "no swap")
    check({e["reply"]["model_version"] for e in sent} == {1},
          "publish: a reply not of v1 with no swap")
    counts, worst = publish_bits(sent, served, states, ref, "no swap")
    p50, p99 = _latency(sent)
    print(f"[publish load] {PUBLISH_REQUESTS} requests at {PUBLISH_RPS:g} "
          f"rps, no swap: p50 {p50:.3f} ms p99 {p99:.3f} ms (client round "
          f"trip); versions {counts}; each reply bitwise its version's "
          f"serial dispatch, within {worst:.2e} of the eager forward  ok  "
          f"[{card_line}]")
    for mode, rolling, sd in (("rolling", True, snaps[1]),
                              ("all-at-once", False, snaps[0])):
        watcher.rolling = rolling
        before = len(watcher.report()["swap_ms"])

        def swap(sd=sd):
            t0 = time.perf_counter()
            rec = publish(sd)
            t1 = time.perf_counter()
            while watcher.installed_version < rec["version"]:
                time.sleep(0.0002)
            return {"version": rec["version"],
                    "publish_ms": 1e3 * (t1 - t0),
                    "lag_ms": 1e3 * (time.perf_counter() - t1)}

        watcher.start()
        try:
            sent, served, lag, out = publish_replay(
                replicas, pool, tel, f"swap {mode}", publish=swap)
        finally:
            watcher.stop()
        versions = {e["reply"]["model_version"] for e in sent}
        check(versions == {lag["version"] - 1, lag["version"]},
              f"publish {mode}: reply versions {versions}")
        counts, worst = publish_bits(sent, served, states, ref,
                                     f"swap {mode}")
        check([_ladder(r.engine) for r in replicas] == ladders,
              f"publish {mode}: a rung or a weight's address changed")
        swap_ms = watcher.report()["swap_ms"][before:]
        p50, p99 = _latency(sent)
        print(f"[publish load] {PUBLISH_REQUESTS} requests at "
              f"{PUBLISH_RPS:g} rps, v{lag['version']} published "
              f"{PUBLISH_AT_S:g} s in ({mode}): p50 {p50:.3f} ms p99 "
              f"{p99:.3f} ms (client round trip); replies by version "
              f"{counts}; publish {lag['publish_ms']:.3f} ms, publish to "
              f"installed {lag['lag_ms']:.3f} ms (poll {PUBLISH_POLL_S} s); "
              f"swap_ms by replica {[round(x, 3) for x in swap_ms]}; each "
              f"reply bitwise its version's serial dispatch on a third "
              f"engine, within {worst:.2e} of the eager forward; the same "
              f"{len(ladders[0][0])} graphs and weight addresses  ok  "
              f"[{card_line}]")
    # -- bf16: one replica -----------------------------------------------
    bdir = os.path.join(tmp, "bf16")
    bpub = WeightPublisher(bdir, fingerprint={"model": "vgg11"})
    rb = EngineReplica(0, "vgg11", device=device, buckets=SERVE_BUCKETS,
                       precision="bf16", seed=0, telemetry=tel)
    rb.startup()
    bwatch = WeightWatcher(bdir, [rb], telemetry=tel,
                           poll_interval_s=PUBLISH_POLL_S)
    bstates = {1: snaps[0], 2: snaps[1]}
    bpub.publish(snaps[0])
    check(bwatch.poll_once() == "installed", "publish bf16: v1")
    bladder = _ladder(rb.engine)

    def bswap():
        rec = bpub.publish(snaps[1])
        while bwatch.installed_version < rec["version"]:
            time.sleep(0.0002)
        return {"version": rec["version"]}

    bwatch.start()
    try:
        sent, served, _, _ = publish_replay([rb], pool, tel, "bf16 swap",
                                            publish=bswap)
    finally:
        bwatch.stop()
    counts, worst = publish_bits(sent, served, bstates, ref, "bf16 swap",
                                 precision="bf16", engines={0: rb.engine})
    check(set(counts) == {1, 2} and _ladder(rb.engine) == bladder,
          f"publish bf16: versions {counts}, or a rung changed")
    p50, p99 = _latency(sent)
    print(f"[publish load] bf16, one replica, v2 published mid-replay: "
          f"p50 {p50:.3f} ms p99 {p99:.3f} ms; replies by version {counts}; "
          f"each bitwise its own serial dispatch at its version, within "
          f"{worst:.2e} of the bf16 eager forward; the same graphs  ok  "
          f"[{card_line}]")
    del rb, bwatch
    # -- 3. chaos, on replica 0 --------------------------------------------
    r0 = replicas[0]
    cdir = os.path.join(tmp, "chaos")
    cpub = WeightPublisher(cdir, fingerprint={"model": "vgg11"},
                           chaos=ChaosPlan.parse(["publish_stale:1",
                                                  "publish_torn:2:7"]))
    cwatch = WeightWatcher(cdir, [r0], telemetry=tel)
    cpub.publish(snaps[1])
    check(cwatch.poll_once() == "installed", "publish chaos: v1")
    stale = cpub.publish(snaps[0])
    check(stale["stale"] and stale["version"] == 1
          and cwatch.poll_once() == "stale"
          and r0.engine.weights_version == 1,
          f"publish_stale: {stale}, {cwatch.report()}")
    before = r0.engine.infer(probe)
    torn = cpub.publish(snaps[0])
    check(torn["torn"] and cwatch.poll_once() == "rejected"
          and r0.engine.weights_version == 1
          and np.array_equal(r0.engine.infer(probe), before)
          and np.array_equal(before, answers[2]),
          f"publish_torn: {torn}, {cwatch.report()}")
    print(f"[publish chaos] publish_stale:1 skipped ({stale['file']}); "
          f"publish_torn:2:7 rejected on crc; v1 keeps serving bitwise  ok")
    cpub.publish(snaps[0])                                       # v3
    at = r0.scheduler._dispatches + 1
    plan = r0.chaos = ChaosPlan.parse([f"swap_mid_batch:{at}:0"])
    probe_ms = []
    inner = r0.swap_probe

    def timed_probe():
        t0 = time.perf_counter()
        inner()
        probe_ms.append(1e3 * (time.perf_counter() - t0))
    r0.swap_probe = timed_probe
    with r0:
        replies = [r0.scheduler.submit(probe, slo_ms=None).result(120)
                   for _ in range(4)]
    r0.chaos = NULL_CHAOS
    ref.install_weights(_to_card(snaps[0], device), 3)
    check(("swap_mid_batch", at) in plan.fired
          and [p.model_version for p in replies] == [1, 1, 3, 3]
          and np.array_equal(replies[0].logits, replies[1].logits)
          and np.array_equal(replies[1].logits, answers[2])
          and np.array_equal(replies[2].logits, ref.infer(probe))
          and len(probe_ms) == 1,
          f"swap_mid_batch:{at}:0: versions "
          f"{[p.model_version for p in replies]}, probe {probe_ms}")
    print(f"[publish chaos] swap_mid_batch:{at}:0: the racing dispatch "
          f"answered wholly on v1, the next on v3; the probe read, checked "
          f"and staged v3 on the worker thread in {probe_ms[0]:.3f} ms: "
          f"service {[p.service_ms for p in replies]} ms by dispatch (the "
          f"second raced)  ok  [{card_line}]")
    runs = bnpool.executed_counts()
    serve_runs = {k: runs[k] - runs_serve[k] for k in runs}
    check(not any(serve_runs.values()),
          f"publish: the serving half ran the bnpool kernels {serve_runs}")
    # The two in-memory recorders, written out as run directories.
    for name, rec, sections, absent, steps in (
            ("training", tel_train, ("manifest", "steps", "spans",
                                     "counters", "memory", "publish",
                                     "gauges"), ("slo",),
             PUBLISH_EPOCHS * PUBLISH_STEPS),
            ("serving", tel, ("steps", "spans", "counters", "serving", "slo",
                              "publish", "pipeline", "gauges"),
             ("manifest",), 0)):
        run_dir = os.path.join(tmp, f"run_{name}")
        write_run_dir(rec, run_dir)
        render_run_dir(f"publish {name} records", run_dir, sections,
                       absent=absent, steps=steps)
    del replicas, ref, r0
    gc.collect()
    phase = {k: runs[k] - runs_before[k] for k in runs}
    print(f"[publish] bnpool runs: training {train_runs}, serving "
          f"{serve_runs}; phase publish: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"publish": phase}


OBS_REQUESTS = 400
OBS_RPS = "200"
OBS_SLOW_SLO_MS = "0.01"        # the drill's SLO: no request can meet it


def obs_cli(tmp, name, args):
    """The serving front-end CLI started on the card with the alert
    engine on, its telemetry in ``tmp/name`` and its load client's in
    ``tmp/name_client``: (the process, the two directories)."""
    srv = os.path.join(tmp, name)
    client = os.path.join(tmp, f"{name}_client")
    proc = start_cli(["--serve-frontend", "--serve-alerts", "on",
                      "--serve-requests", str(OBS_REQUESTS), "--serve-load",
                      OBS_RPS, "--telemetry-out", srv,
                      "--serve-trace-client", client] + args)
    return proc, srv, client


def obs_cli_result(proc, srv, label):
    """A started ``obs_cli``'s last line and load stats, once every
    request had its reply and the manifest holds the last line's
    alerts."""
    from cs744_ddp_tpu_torch.obs import read_run
    out = finish_cli(proc, label, timeout=300)
    last = json.loads(out.strip().splitlines()[-1])
    st = last["load"][f"{OBS_RPS}rps"]
    check(st["replies"] == OBS_REQUESTS and st["unresolved"] == 0
          and all(c["error"] == 0 for c in st["by_tier"].values()),
          f"{label}: load {st}")
    manifest = read_run(srv)[0]
    check(manifest["alerts"] == last["alerts"],
          f"{label}: manifest alerts {manifest.get('alerts')}, last line "
          f"{last['alerts']}")
    return last, st


def obs_waterfalls(srv, client, prior_file, card_line):
    """``python -m cs744_ddp_tpu_torch.obs.aggregate`` over the two
    directories, and what its report must hold."""
    from cs744_ddp_tpu_torch.obs import percentile
    proc = subprocess.run(
        [sys.executable, "-m", "cs744_ddp_tpu_torch.obs.aggregate", srv,
         client, "--json", "--max-waterfalls", str(10 * OBS_REQUESTS),
         "--prior-flops", prior_file], capture_output=True, text=True,
        timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"obs waterfall {proc.args}: "
          f"{proc.stderr[-3000:]}")
    mine = json.loads(proc.stdout)
    cli = mine["processes"][os.path.basename(client)]
    bound_ms = 2e3 * cli["rtt_bound_s"]
    spanning = [w for w in mine["waterfalls"] if w["complete"]
                and len(w["procs"]) == 2]
    check(cli["skew_estimated"] and cli["skew_pairs"] >= 10
          and len(spanning) >= 10
          and all("device_compute" in w["stages"]
                  and w["sum_ms"] <= w["client_ms"] + bound_ms
                  for w in spanning),
          f"obs waterfalls: client {cli}, {len(spanning)} spanning")
    client_ms = [w["client_ms"] for w in spanning]
    stages = ", ".join(f"{s} {a['p50']}/{a['p99']}"
                       for s, a in mine["stage_ms"].items())
    print(f"[obs] waterfalls (obs.aggregate): "
          f"client skew from {cli['skew_pairs']} pairs, offset "
          f"{1e3 * cli['clock_offset_s']:+.3f} ms +/- "
          f"{1e3 * cli['rtt_bound_s']:.3f} ms; {mine['complete']} complete, "
          f"{len(spanning)} spanning both processes, each with "
          f"device_compute and its stage sum within the client round trip "
          f"+ {bound_ms:.3f} ms; client round trip p50 "
          f"{percentile(client_ms, 50):.3f} ms, p99 "
          f"{percentile(client_ms, 99):.3f} ms; stage p50/p99 ms: {stages}; "
          f"critical path {mine['critical_path']['dominant']}  "
          f"[{card_line}]")
    prior = {b: r["measured_over_prior"]
             for b, r in mine["cost_prior"]["by_bucket"].items()}
    print(f"[obs] device compute against the cost-model prior "
          f"(cost_model_weights of the replica's engine): "
          f"measured_over_prior by bucket {prior}, rate "
          f"{mine['cost_prior']['rate_ms_per_flop']:.6g} ms a flop  "
          f"[{card_line}]")


def obs_attribution(precision, card_line):
    """The VGG-11 ``single`` train step at batch 256: its analytic FLOPs,
    one 20-step window of replays timed, ``mfu_fields`` and
    ``attribute``; the kernels' runs on the device in that window."""
    from types import SimpleNamespace
    from cs744_ddp_tpu_torch.analysis.costmodel import (
        H100_BF16_PEAK_FLOPS, H100_F32_PEAK_FLOPS)
    from cs744_ddp_tpu_torch.obs.attribution import attribute
    from cs744_ddp_tpu_torch.ops import bnpool
    from cs744_ddp_tpu_torch.train.loop import Trainer
    from cs744_ddp_tpu_torch.utils.metrics import mfu_fields

    trainer = Trainer("vgg11", "single", global_batch=BATCH,
                      precision=precision, limit_train_batches=2 * WINDOW,
                      log=lambda s: None)
    per_image = trainer.step_flops_per_image()
    report = trainer.step_cost()
    check(per_image is not None and per_image == report.flops / BATCH,
          f"obs {precision}: step_flops_per_image {per_image}")
    window = trainer.train_window()
    window(0, 0, WINDOW).cpu()          # warm-up steps and the capture
    before = bnpool.executed_counts()   # synchronizes
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    window(1, 0, WINDOW).cpu()
    step_s = (time.perf_counter() - t0) / WINDOW
    peak = torch.cuda.max_memory_allocated()
    after = bnpool.executed_counts()
    runs = {k: after[k] - before[k] for k in after}
    check(runs == variants(precision, 5 * WINDOW),
          f"obs {precision}: the kernels ran {runs} times in a "
          f"{WINDOW}-step window")
    mfu = mfu_fields(BATCH / step_s, per_image)
    peak_flops = H100_F32_PEAK_FLOPS if precision == "f32" \
        else H100_BF16_PEAK_FLOPS
    attr = attribute(report, measured_s=step_s, peak_flops=peak_flops,
                     mem_report=SimpleNamespace(peak_bytes=peak))
    print(f"[obs] vgg11 {precision} single, batch {BATCH}: "
          f"step_flops_per_image {per_image:.0f}; steady step "
          f"{1e3 * step_s:.3f} ms (one {WINDOW}-step window of replays); "
          f"mfu_fields {mfu}; attribute (peak {peak_flops:.4g}) {attr}; "
          f"bnpool runs on the device in the window {runs}  [{card_line}]")
    return runs


def phase_obs(card_line):
    """Serving observability and the cost model on the card; see the
    module docstring.  Returns each kernel variant's runs over the
    phase."""
    from cs744_ddp_tpu_torch.obs import AlertEngine, read_run
    from cs744_ddp_tpu_torch.ops import bnpool
    from cs744_ddp_tpu_torch.serve import InferenceEngine, cost_model_weights

    t_phase = time.perf_counter()
    runs_before = bnpool.executed_counts()
    # The prior, counted on meta tensors before the clean run starts, so
    # that nothing else runs on the card or the host beside it.
    engine = InferenceEngine("vgg11", buckets=SERVE_BUCKETS)
    weights = cost_model_weights(engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="obs_smoke_") as tmp:
        t0 = time.perf_counter()
        proc, srv, client = obs_cli(tmp, "server", [])
        try:
            clean, st = obs_cli_result(proc, srv, "obs clean")
        finally:
            kill_cli(proc)
        t_clean = time.perf_counter() - t0
        check(clean["alerts"]["fired"] == [],
              f"obs clean run: alerts fired {clean['alerts']}")
        prior_file = os.path.join(tmp, "prior_flops.json")
        with open(prior_file, "w") as f:
            json.dump(weights, f)
        # While the drill serves: the clean run's records replayed through
        # the rules, and its waterfalls (host work only; the drill's
        # latencies are not reported, only its rules and replies).
        proc, drill_srv, _ = obs_cli(
            tmp, "drill", ["--serve-replicas", "2", "--chaos",
                           "slow_replica:0:0", "--serve-shed", "off",
                           "--serve-slo-ms", OBS_SLOW_SLO_MS])
        try:
            events = read_run(srv)[1]
            t0 = time.perf_counter()
            replay = AlertEngine().run(events)
            tap_us = 1e6 * (time.perf_counter() - t0) / len(events)
            check(replay == [], f"obs clean run replayed: {replay}")
            print(f"[obs] cli --serve-frontend --serve-alerts on, 1 "
                  f"replica, {OBS_REQUESTS} requests at {OBS_RPS} rps "
                  f"({t_clean:.1f} s): attainment {st['attainment']}, shed "
                  f"{st['shed']}; alerts fired {clean['alerts']['fired']}, "
                  f"and none replaying its {len(events)} records "
                  f"({tap_us:.2f} us a record on this host, "
                  f"{tap_us * len(events) / OBS_REQUESTS:.1f} us a "
                  f"request)  ok  [{card_line}]")
            print(f"[obs] cost_model_weights (GFLOP a dispatch, by "
                  f"bucket): "
                  f"{ {b: round(f / 1e9, 4) for b, f in weights.items()} }"
                  f"  [{card_line}]")
            obs_waterfalls(srv, client, prior_file, card_line)
            drill, st = obs_cli_result(proc, drill_srv, "obs slow_replica")
        finally:
            kill_cli(proc)
        served = sum(c["ok"] + c["late"] for c in st["by_tier"].values())
        last_attrs = {k: v["last_attrs"]
                      for k, v in drill["alerts"]["by_rule"].items()}
        check(drill["alerts"]["fired"] == ["SLO_BURN", "STRAGGLER"]
              and served == OBS_REQUESTS,
              f"obs slow_replica drill: alerts {drill['alerts']}, "
              f"{served} served")
        print(f"[obs] cli --serve-replicas 2 --chaos slow_replica:0:0 "
              f"--serve-shed off --serve-slo-ms {OBS_SLOW_SLO_MS} (ended "
              f"{time.perf_counter() - t_phase:.1f} s into the phase): "
              f"{served} of {OBS_REQUESTS} served; alerts fired "
              f"{drill['alerts']['fired']} ({last_attrs})  ok  "
              f"[{card_line}]")
        for name, run_dir, fired in (
                ("clean", srv, clean["alerts"]["fired"]),
                ("slow_replica drill", drill_srv, drill["alerts"]["fired"])):
            alerts = ("alerts",) if fired else ()
            text = render_run_dir(
                f"obs {name} server", run_dir,
                ("manifest", "steps", "spans", "counters", "serving",
                 "traces", "slo", "pipeline", "waterfall") + alerts
                + ("gauges",), absent=() if fired else ("alerts",),
                steps=0)
            check(report_alert_rules(text) == sorted(fired),
                  f"obs {name}: the report's alerts "
                  f"{report_alert_rules(text)}, fired {fired}")
    for precision in ("f32", "bf16"):
        obs_attribution(precision, card_line)
    runs = bnpool.executed_counts()
    phase = {k: runs[k] - runs_before[k] for k in runs}
    print(f"[obs] bnpool runs over the phase {phase}; phase obs: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"obs": phase}


AUDIT_EVAL = 2
AUDIT_EPOCH_STEPS = EPOCH_ROWS // BATCH      # 195 full batches and a tail


def audit_group_record(strategy, card_line):
    """One eager step and one replay of the captured step of a world-1
    NCCL ``Trainer``: the ``Group``'s counts, bytes and links each time
    against the audit's counted step of ``strategy`` at world 1."""
    from collections import Counter
    from cs744_ddp_tpu_torch.analysis import audit, stats
    from cs744_ddp_tpu_torch.train.loop import Trainer

    program = audit.train_program("vgg11", strategy, "step", world=1,
                                  global_batch=BATCH, window=WINDOW)
    counted = audit.trace_program(program)[0].links
    want_counts = Counter(c.kind for c in counted if c.counted)
    want_bytes = Counter()
    for c in counted:
        if c.counted:
            want_bytes[c.kind] += c.nbytes
    trainer = Trainer("vgg11", strategy, global_batch=BATCH,
                      limit_train_batches=WINDOW, log=lambda s: None)
    group = trainer.group
    x = torch.zeros((BATCH, 32, 32, 3), dtype=torch.uint8, device="cuda")
    y = torch.zeros((BATCH,), dtype=torch.int64, device="cuda")
    trainer.train_step(trainer.state, x, y)
    torch.cuda.synchronize()
    seen = {"eager": (Counter(group.step_counts), Counter(group.step_bytes),
                      list(group.step_links))}
    trainer.train_window()(0, 0, 1).cpu()
    seen["replay"] = (Counter(group.step_counts), Counter(group.step_bytes),
                      list(group.step_links))
    for how, (counts, nbytes, links) in seen.items():
        check(counts == want_counts and nbytes == want_bytes
              and links == counted,
              f"audit {strategy} {how}: Group {dict(counts)} "
              f"{dict(nbytes)} {links[:3]}..., counted {dict(want_counts)} "
              f"{dict(want_bytes)} {counted[:3]}...")
    print(f"[audit] {strategy} world-1 NCCL Group, one eager step and one "
          f"replay: {dict(want_counts)}, {sum(want_bytes.values())} bytes, "
          f"{len(counted)} records in {stats.collective_chain_depth(counted)}"
          f" links ({stats.collective_chain_depth(counted, False)} with the "
          f"BN and loss mean) = the audit's counted step  ok  [{card_line}]")


def phase_audit(card_line):
    """Static analysis on the card; see the module docstring.  Returns
    each kernel variant's runs over the phase."""
    from cs744_ddp_tpu_torch import cli
    from cs744_ddp_tpu_torch.analysis import audit as auditlib
    from cs744_ddp_tpu_torch.analysis import dispatch
    from cs744_ddp_tpu_torch.analysis.costmodel import \
        H100_HBM_CAPACITY_BYTES
    from cs744_ddp_tpu_torch.obs import read_run
    from cs744_ddp_tpu_torch.ops import bnpool

    t_phase = time.perf_counter()
    runs_before = bnpool.executed_counts()
    t0 = time.perf_counter()
    out = run_cli(["--verify-static"], "audit --verify-static", timeout=600)
    wall = time.perf_counter() - t0
    lines = out.strip().splitlines()
    summary = json.loads(lines[-1])
    check(summary["clean"] and lines[-2].startswith("[audit] CLEAN:"),
          f"audit --verify-static: {lines[-2]} {lines[-1][:2000]}")
    print(f"[audit] cli --verify-static ({wall:.1f} s): {lines[-2]}; lint "
          f"findings {summary['lint_findings']}, lock graph "
          f"{len(summary['lock_graph']['nodes'])} locks "
          f"{len(summary['lock_graph']['edges'])} edges, memory "
          f"{summary['memory']}  ok  [{card_line}]")

    with tempfile.TemporaryDirectory(prefix="audit_smoke_") as tmp:
        run = os.path.join(tmp, "run")
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = bnpool.executed_counts()
        t0 = time.perf_counter()
        cli.main(["--strategy", "single", "--limit-eval-batches",
                  str(AUDIT_EVAL), "--audit", "strict", "--telemetry-out",
                  run])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        after = bnpool.executed_counts()
        manifest, events, tsummary = read_run(run)
        text = render_run_dir("audit cli --audit strict", run, (
            "manifest", "steps", "spans", "counters", "audit", "memory",
            "gauges"))
    runs = {k: after[k] - before[k] for k in after}
    from cs744_ddp_tpu_torch.train.step import WARMUP_ITERS
    want = variants("f32", 5 * (WARMUP_ITERS + AUDIT_EPOCH_STEPS + 1))
    check(runs == want, f"audit run: kernels ran {runs}, want {want}")
    audit = manifest.get("audit") or {}
    programs = audit.get("programs") or {}
    check(audit.get("clean") and set(programs) == {
        "train/step/single", "train/window/single",
        "train/host_window/single", "eval/window"}
        and all(p.get("peak_mib") for p in programs.values()),
        f"audit run: manifest audit {audit}")
    check(f"  CLEAN: {len(programs)} programs, 0 findings, 0 waived"
          in text.splitlines(), f"audit run: the report's audit section "
          f"in\n{text}")
    depth = tsummary["gauges"]["collective_totals"]["chain_depth"]
    check(depth == programs["train/window/single"]["chain_depth"] == 0,
          f"audit run: chain_depth {depth}")
    bound = dispatch.epoch_round_trip_bound(
        "window", AUDIT_EPOCH_STEPS, WINDOW, tail_batch=True,
        include_eval=True)
    trips = dispatch.count_runtime_trips(events)
    check(dispatch.total_runtime_trips(events) == sum(trips.values())
          == bound, f"audit run: round trips {trips}, bound {bound}")
    check(any(e.get("kind") == "gauge" and e.get("name") == "memory"
              for e in events), "audit run: no memory gauge")
    # The certificate the manifest rounds to MiB, in bytes.
    static = auditlib.trace_program(auditlib.train_program(
        "vgg11", "single", "window", world=1, global_batch=BATCH,
        window=WINDOW))[0].mem.peak_bytes
    check(round(static / 2**20, 3) ==
          programs["train/window/single"]["peak_mib"],
          f"audit run: static peak {static} B, manifest "
          f"{programs['train/window/single']}")
    check(peak < H100_HBM_CAPACITY_BYTES
          and static < H100_HBM_CAPACITY_BYTES,
          f"audit run: max_memory_allocated {peak}, static {static}")
    print(f"[audit] cli --audit strict --telemetry-out, vgg11 f32 single, "
          f"one windowed epoch ({AUDIT_EPOCH_STEPS} steps and the tail) "
          f"and {AUDIT_EVAL} eval batches ({wall:.1f} s): audit clean over "
          f"{sorted(programs)}; chain_depth {depth}; host round trips "
          f"{trips} = bound {bound}; bnpool runs {runs}; static peak of "
          f"train/window/single {static} B "
          f"({static / 2**20:.3f} MiB) against max_memory_allocated "
          f"{peak - held} B ({(peak - held) / 2**20:.3f} MiB) above the "
          f"{held} B held before the run: measured / static "
          f"{(peak - held) / static:.4f}; both under "
          f"{H100_HBM_CAPACITY_BYTES} B  ok  [{card_line}]")
    for strategy in ("allreduce", "ddp"):
        audit_group_record(strategy, card_line)
    runs = bnpool.executed_counts()
    phase = {k: runs[k] - runs_before[k] for k in runs}
    print(f"[audit] bnpool runs over the phase {phase}; phase audit: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"audit": phase}


def moe_operands(k, n, counts, seed):
    """x [MOE_ROWS, k] and dy [MOE_ROWS, n] bf16, w [G, k, n] an f32
    master, and the int32 offsets of ``counts`` on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(MOE_ROWS, k, generator=g, device="cuda").bfloat16()
    w = torch.randn(MOE_GROUPS, k, n, generator=g, device="cuda") * 0.02
    dy = torch.randn(MOE_ROWS, n, generator=g, device="cuda").bfloat16()
    offsets = torch.zeros(MOE_GROUPS + 1, dtype=torch.int32)
    offsets[1:] = torch.cumsum(torch.tensor(counts), 0)
    return x, w, dy, offsets.cuda()


def _rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


def check_grouped(k, n, load, errs):
    """``moe.grouped_mm``'s forward, dX and dW through autograd against
    the plain version on the card, group by group; rows past the groups
    and the dW of an empty group exactly zero."""
    from cs744_ddp_tpu_torch.ops import moe
    counts = MOE_LOADS[load]
    x, w, dy, offsets = moe_operands(k, n, counts, k + n + len(load))
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = moe.grouped_mm(xr, wr, offsets)
    dx, dw = torch.autograd.grad(y, (xr, wr), dy)
    check(dw.dtype == torch.float32, f"moe {load} {k}x{n}: dW {dw.dtype}")
    wb = w.bfloat16()
    plain = {"fwd": moe.grouped_mm_reference(x, wb, offsets),
             "dx": moe.grouped_mm_reference(dy, wb.transpose(1, 2), offsets),
             "dw": moe.grouped_dw_reference(x, dy, offsets, MOE_GROUPS)}
    total, lo, worst = sum(counts), 0, {}
    for name, t in (("fwd", y), ("dx", dx)):
        check(int(torch.count_nonzero(t[total:])) == 0,
              f"moe {load} {k}x{n}: {name} rows past the groups not zero")
    for g, c in enumerate(counts):
        if c == 0:
            check(int(torch.count_nonzero(dw[g])) == 0,
                  f"moe {load} {k}x{n}: dW of empty group {g} not zero")
            continue
        rows = slice(lo, lo + c)
        for name, got, want in (("fwd", y[rows], plain["fwd"][rows]),
                                ("dx", dx[rows], plain["dx"][rows]),
                                ("dw", dw[g], plain["dw"][g])):
            rel = _rel(got, want)
            worst[name] = max(worst.get(name, 0.0), rel)
            check(rel < MOE_RTOL, f"moe {load} {k}x{n}: {name} of group "
                  f"{g} ({c} rows) {rel:.3e} from the plain version")
        lo += c
    for name, rel in worst.items():
        errs[name] = max(errs[name], rel)
    print(f"[moe] check {load} K={k} N={n} rows={total}: worst relative "
          f"gap {json.dumps({v: float(f'{r:.3e}') for v, r in worst.items()})}"
          f" (limit {MOE_RTOL})")


def library_ms(fn, flush, evict, names):
    """Median per call of the device time in the library's grouped-GEMM
    kernels (``GMM_FRAGMENTS``), from torch.profiler's kernel records over
    CLEAN_REPS calls, each after the L2 flush and eviction of
    ``device_ms``; every kernel name seen is added to ``names``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(CLEAN_REPS):
            flush.zero_()
            evict.sum()
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    us = 0.0
    runs = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        names.add(e.name)
        if any(f in e.name for f in GMM_FRAGMENTS):
            us += e.time_range.elapsed_us()
            runs += "GroupProblemShape" in e.name
    check(runs >= CLEAN_REPS, f"the profiler saw {runs} grouped-GEMM "
          f"kernels in {CLEAN_REPS} calls; kernels: {sorted(names)}")
    return us / CLEAN_REPS / 1e3


def time_grouped(k, n, load, flush, evict, names):
    """Each product's CUDA-event ms (with the zeroing of the rows past the
    groups), its library kernels' device ms alone, its FLOP bound at the
    bf16 peak, and the plain version's ms."""
    from cs744_ddp_tpu_torch.ops import moe
    counts = MOE_LOADS[load]
    x, w, dy, offsets = moe_operands(k, n, counts, k + n)
    wb = w.bfloat16()
    wt = wb.transpose(1, 2)
    work = {"fwd": (lambda: moe._mm(x, wb, offsets, "fwd"),
                    lambda: moe.grouped_mm_reference(x, wb, offsets)),
            "dx": (lambda: moe._mm(dy, wt, offsets, "dx"),
                   lambda: moe.grouped_mm_reference(dy, wt, offsets)),
            "dw": (lambda: moe._dw(x, dy, offsets, MOE_GROUPS),
                   lambda: moe.grouped_dw_reference(x, dy, offsets,
                                                    MOE_GROUPS))}
    bound = 2 * sum(counts) * k * n / BF16_PEAK_FLOPS * 1e3
    out = {v: dict(ms=time_ms(fn, CLEAN_REPS, flush),
                   plain_ms=time_ms(plain, 3, flush), bound_ms=bound)
           for v, (fn, plain) in work.items()}
    for v, (fn, _) in work.items():
        out[v]["device_ms"] = library_ms(fn, flush, evict, names)
    print(f"[moe] time {load} K={k} N={n} rows={sum(counts)}: " + "; ".join(
        f"{v} {r['ms']:.4f} ms, device alone {r['device_ms']:.4f} "
        f"({100 * r['bound_ms'] / r['device_ms']:.2f}% of peak), plain "
        f"{r['plain_ms']:.4f}" for v, r in out.items()))
    return out


def moe_routing(held, seed):
    """(token, offsets, inv, weight) on the card: ``held`` of the
    MOE_ROWS flat rows, at random, spread evenly over the held experts,
    the rest of no group; router weights in (0, 2.446)."""
    from cs744_ddp_tpu_torch.ops import moe
    gen = torch.Generator().manual_seed(seed)
    group = torch.full((MOE_ROWS,), MOE_GROUPS, dtype=torch.int64)
    group[torch.randperm(MOE_ROWS, generator=gen)[:held]] = \
        torch.arange(held) % MOE_GROUPS
    order, offsets, inv = moe.sort_rows(group.cuda(), MOE_GROUPS)
    weight = torch.where(group < MOE_GROUPS,
                         torch.rand(MOE_ROWS, generator=gen) * 2.446, 0.0)
    token = torch.div(order, MOE_TOP_K, rounding_mode="floor")
    return token, offsets, inv, weight.cuda().index_select(0, order)


def _bf16_ulps(a, b) -> int:
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def time_rows(load, flush, evict):
    """The row kernels at ``MOE_ROW_LOADS[load]`` held rows: each checked
    against its plain version on the held rows (gathers bitwise, bf16
    outputs within one bf16 step, f32 sums within 1e-5 of the plain
    version's norm), then its
    CUDA-event ms, its device ms alone, its byte bound (each input byte the
    held rows need read once, each output byte written once) at 3.35 TB/s
    and the plain version's ms.  {kernel: numbers}."""
    from cs744_ddp_tpu_torch.ops import moe
    held = MOE_ROW_LOADS[load]
    token, offsets, inv, weight = moe_routing(held, 23)
    g = torch.Generator(device="cuda").manual_seed(24)
    t, h, i = MOE_TOKENS, MOE_HIDDEN, MOE_WIDTH
    x = torch.randn(t, h, generator=g, device="cuda").bfloat16()
    dout = torch.randn(t, h, generator=g, device="cuda")
    gu = (torch.randn(MOE_ROWS, 2 * i, generator=g, device="cuda") * 2
          ).bfloat16()
    dh_unit = (torch.randn(MOE_ROWS, i, generator=g, device="cuda") * 0.1
               ).bfloat16()
    ys = torch.randn(MOE_ROWS, h, generator=g, device="cuda").bfloat16()
    bf16 = torch.bfloat16
    distinct = int(token[:held].unique().numel())
    work = {
        "gather_rows": (
            lambda: moe.gather_rows(x, token, offsets, bf16),
            lambda: moe.gather_rows_reference(x, token, offsets, bf16),
            distinct * h * 2 + held * (h * 2 + 8)),
        "gather_rows_f32": (
            lambda: moe.gather_rows(dout, token, offsets, bf16),
            lambda: moe.gather_rows_reference(dout, token, offsets, bf16),
            distinct * h * 4 + held * (h * 2 + 8)),
        "swiglu_rows": (
            lambda: moe.swiglu_rows(gu, i, offsets),
            lambda: moe.swiglu_rows_reference(gu, i, offsets),
            held * 3 * i * 2),
        "combine_tokens": (
            lambda: moe.combine_tokens(ys, weight, token, inv, offsets, t),
            lambda: moe.combine_tokens_reference(ys, weight, token, inv,
                                                 offsets, t),
            held * (h * 2 + 4) + MOE_ROWS * 4 + t * h * 4),
        "combine_token_grads": (
            lambda: moe.combine_token_grads(ys, token, inv, offsets, t,
                                            bf16),
            lambda: moe.combine_token_grads_reference(ys, token, inv,
                                                      offsets, t, bf16),
            held * h * 2 + MOE_ROWS * 4 + t * h * 2),
        "rows_backward": (
            lambda: moe.rows_backward(gu, dh_unit, weight, offsets),
            lambda: moe.rows_backward_reference(gu, dh_unit, weight,
                                                offsets),
            held * (6 * i * 2 + 4) + MOE_ROWS * 4)}
    gaps = {}
    for name, (fn, plain, _) in work.items():
        got, want = fn(), plain()
        if name.startswith("combine_token"):
            got, want = [got], [want]
        elif not isinstance(got, tuple):
            got, want = [got[:held]], [want[:held]]
        else:
            got = [got[0]] + [v[:held] for v in got[1:]]
            want = [want[0]] + [v[:held] for v in want[1:]]
        for a, b in zip(got, want):
            check(bool(torch.isfinite(a).all()), f"moe rows {load}: {name} "
                  f"not finite")
            if a.dtype == torch.float32:
                gap = _rel(a, b)
                check(gap < 1e-5, f"moe rows {load}: {name} {gap:.3e} from "
                      f"the plain version")
            else:
                gap = _bf16_ulps(a, b)
                check(gap <= (0 if name.startswith("gather") else 1),
                      f"moe rows {load}: {name} {gap} bf16 steps from the "
                      f"plain version")
            gaps[name] = max(gaps.get(name, 0), gap)
        del got, want
    out = {}
    for name, (fn, plain, nbytes) in work.items():
        fragment = moe.PROFILED[name.replace("_f32", "")]
        out[name] = dict(
            ms=time_ms(fn, CLEAN_REPS, flush),
            device_ms=device_ms(fn, fragment, flush, evict),
            plain_ms=time_ms(plain, 3, flush),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
            gap=gaps[name])
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[moe] rows {load} held={held} of {MOE_ROWS} (distinct tokens "
          f"{distinct}): " + "; ".join(
              f"{v} {r['ms']:.4f} ms, device alone {r['device_ms']:.4f} "
              f"(bound {r['bound_ms']:.4f}, "
              f"{100 * r['bound_ms'] / r['device_ms']:.1f}%), plain "
              f"{r['plain_ms']:.4f}, gap {r['gap']}"
              for v, r in out.items()))
    return out


def moe_main_path():
    """Moonlight at the published widths (``MOE_LAYERS`` layers) trains one
    bf16 epoch through the Trainer's windowed path, the products' counters
    zeroed just before: each product's runs a step on the device (2
    forward, 1 recomputed forward, 2 dX, 2 dW an expert layer) over the
    warm-up steps and the replays, ``flops`` 11 x 2048 x 2816 a held row,
    and finite weights after it."""
    from cs744_ddp_tpu_torch import models
    from cs744_ddp_tpu_torch.data import tokens
    from cs744_ddp_tpu_torch.models import moonlight
    from cs744_ddp_tpu_torch.ops import moe
    from cs744_ddp_tpu_torch.ops.sgd import SGDConfig
    from cs744_ddp_tpu_torch.train import step as tstep
    from cs744_ddp_tpu_torch.train.loop import Trainer

    config = moonlight.MoonlightConfig(num_hidden_layers=MOE_LAYERS,
                                       held_experts=MOE_GROUPS,
                                       vocab_size=20480)
    models.register_model("moonlight-smoke", moonlight.factory(config))
    seqs = np.random.default_rng(0).integers(
        0, config.vocab_size, (MOE_SEQS + 2, MOE_SEQ + 1)).astype(np.int32)
    logs = []
    with tempfile.TemporaryDirectory() as tmp:
        tokens.write(tmp, seqs[:MOE_SEQS], seqs[MOE_SEQS:])
        trainer = Trainer("moonlight-smoke", "single", precision="bf16",
                          global_batch=MOE_BATCH, data_dir=tmp,
                          device="cuda", seed=3, augment=False,
                          sgd_cfg=SGDConfig(lr=0.001), log=logs.append)
        before = trainer.trace_counts()
        moe.reset_counts()
        t0 = time.perf_counter()
        trainer.train_model(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs = moe.executed_counts()
        after = trainer.trace_counts()
    d = {k: after[k] - before[k] for k in after}
    steps = tstep.WARMUP_ITERS * d["captures"] + d["replays"] \
        + d["eager_steps"]
    layers = MOE_LAYERS - config.first_k_dense_replace
    want = {"fwd": 2 * layers * steps, "fwd_recompute": layers * steps,
            "dx": 2 * layers * steps, "dw": 2 * layers * steps}
    check(steps == MOE_SEQS // MOE_BATCH + tstep.WARMUP_ITERS,
          f"moe main path: {steps} steps run, counts {d}")
    check({v: runs[v] for v in want} == want,
          f"moe main path: runs {runs}, want {want}")
    check(0 < runs["rows_max"] <= runs["rows"]
          and runs["flops"] == 11 * 2048 * 2816 * runs["rows"],
          f"moe main path: rows and flops {runs}")
    slots = MOE_BATCH * MOE_SEQ * config.num_experts_per_tok
    check(runs["row_rows"] == 7 * runs["rows"]
          and runs["row_capacity"] == 7 * layers * steps * slots,
          f"moe main path: row kernels' rows {runs}, want 7 launches a "
          f"layer-step of {slots} static rows")
    launched = moe.launch_counts()
    check(all(torch.isfinite(p).all()
              for p in trainer.state.model.parameters()),
          "moe main path: non-finite weights")
    print(f"[moe] main path: {steps} steps ({d['captures']} capture, "
          f"{tstep.WARMUP_ITERS} warm-up steps, {d['replays']} replays, "
          f"{d['eager_steps']} eager) in {wall:.2f} s; counted on the "
          f"device {json.dumps(runs)}; row kernels' launches {launched}; "
          f"log {logs[-1:] if logs else []}")
    return runs, steps, launched


def phase_moe(card_line):
    """The expert layer's grouped products: checked against the plain
    version at the cell's shapes under every load of ``MOE_LOADS``,
    timed at the mean and one-hot loads, then the main path's run.
    Returns the ``kernels`` line's rows for forward, dX and dW."""
    errs = {"fwd": 0.0, "dx": 0.0, "dw": 0.0}
    for k, n in MOE_WIDTHS:
        for load in MOE_LOADS:
            check_grouped(k, n, load, errs)
            gc.collect()
            torch.cuda.empty_cache()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    evict = torch.ones(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    names = set()
    times = {(load, k, n): time_grouped(k, n, load, flush, evict, names)
             for load in MOE_TIMED for k, n in MOE_WIDTHS}
    print(f"[moe] kernels seen while timing: {sorted(names)}")
    gc.collect()
    torch.cuda.empty_cache()
    row_times = {load: time_rows(load, flush, evict)
                 for load in MOE_ROW_LOADS}
    del flush, evict
    gc.collect()
    torch.cuda.empty_cache()
    runs, steps, launched = moe_main_path()
    rows = []
    for v in ("fwd", "dx", "dw"):
        mean = [times[("mean", k, n)][v] for k, n in MOE_WIDTHS]
        rows.append({
            "name": f"grouped_mm_{v}", "route": "library",
            "source": "cs744_ddp_tpu_torch/ops/moe.py (torch._grouped_mm)",
            "replaces": "none: the JAX package runs no expert layer",
            "launches": runs[v], "max_abs_err": None,
            "max_rel_err": errs[v],
            "ms": sum(r["ms"] for r in mean),
            "device_ms": sum(r["device_ms"] for r in mean),
            "plain_ms": sum(r["plain_ms"] for r in mean),
            "bound_ms": sum(r["bound_ms"] for r in mean),
            "bound_by": "operations",
            "library_ms": sum(r["ms"] for r in mean),
            "wrapper_launches": None,
            "launches_by_path": {"moe_main": runs[v]}})
    for name, r in row_times["mean"].items():
        wrapper = name.replace("_f32", "")
        rows.append({
            "name": f"moe_{name}", "route": "cuda",
            "source": "cs744_ddp_tpu_torch/ops/csrc/moe_rows.cu",
            "replaces": "none: the JAX package runs no expert layer",
            "launches": launched[wrapper], "max_abs_err": None,
            "max_rel_err": None, "max_bf16_steps": r["gap"],
            "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "wrapper_launches": launched[wrapper],
            "launches_by_path": {"moe_main": launched[wrapper]},
            "heaviest": {k: row_times["heaviest"][name][k]
                         for k in ("ms", "device_ms", "plain_ms",
                                   "bound_ms")}})
    print(f"[moe] {card_line}: ms, device_ms, plain_ms and bound_ms are one "
          f"expert layer's two products of each kind (gate-and-up and "
          f"down) at the mean load, {sum(MOE_LOADS['mean'])} held rows; "
          f"launches the runs counted on the device in the main path's "
          f"{steps} steps; the moe_* row kernels one launch each at "
          f"{MOE_ROW_LOADS['mean']} held rows (\"heaviest\": "
          f"{MOE_ROW_LOADS['heaviest']}), launches their wrappers' in the "
          f"main path (eager and captured, each once)")
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--time-only", action="store_true",
                        help="build and time the kernels, nothing else")
    parser.add_argument("--root", help="time the kernels of the checkout at "
                        "this directory (implies --time-only)")
    parser.add_argument("--tune-dx", action="store_true",
                        help="build, time the dx kernel over partitions, "
                        "nothing else")
    parser.add_argument("--moe", action="store_true",
                        help="build, then run phase moe alone (the expert "
                        "layer's grouped products and Moonlight's path)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; nothing was run",
              file=sys.stderr)
        return 2
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    card_line = card()
    print(f"card: {card_line}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    t_all = time.perf_counter()

    phase_build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.tune_dx:
        tune_dx(card_line)
        return 0
    if args.moe:
        print(json.dumps({"kernels": phase_moe(card_line)}))
        return 0
    if args.time_only or args.root:
        from cs744_ddp_tpu_torch.ops import bnpool
        print(f"[time] kernels of {os.path.dirname(bnpool.__file__)}")
        phase_time(card_line)
        return 0
    from cs744_ddp_tpu_torch.ops import bnpool
    errs = dict.fromkeys(bnpool.KERNELS, 0.0)
    phase_check(errs)
    times = phase_time(card_line)
    launches, wrapper_launches, by_path = phase_train(card_line)
    by_path.update(phase_strategies(card_line))
    (bf16_runs, bf16_launches), model_paths = phase_models(card_line)
    by_path.update(model_paths)
    by_path.update(phase_ft(card_line))
    by_path.update(phase_host(card_line))
    by_path.update(phase_elastic(card_line))
    by_path.update(phase_telemetry(card_line))
    by_path.update(phase_serve(card_line))
    by_path.update(phase_serve_tier(card_line))
    by_path.update(phase_publish(card_line))
    by_path.update(phase_obs(card_line))
    by_path.update(phase_audit(card_line))
    moe_rows = phase_moe(card_line)

    fused = ("none: cs744_ddp_tpu/ops/bnpool_pallas.py::_fwd_impl is plain "
             "JAX, fused by XLA")
    replaces = {"bnpool_sums": "cs744_ddp_tpu/ops/bnpool_pallas.py:147",
                "bnpool_dx": "cs744_ddp_tpu/ops/bnpool_pallas.py:184",
                "bnpool_stats": fused, "bnpool_norm_pool": fused}
    kernels = []
    for dtype, runs, wrapper in (("f32", launches, wrapper_launches),
                                 ("bf16", bf16_runs, bf16_launches)):
        tot = times[dtype]
        suffix = "" if dtype == "f32" else "_bf16"
        kernels += [{
            "name": name + suffix, "route": "cuda",
            "source": "cs744_ddp_tpu_torch/ops/csrc/bnpool.cu",
            "replaces": replaces[name], "launches": runs[name + suffix],
            "max_abs_err": errs[name + suffix], "ms": tot[name]["ms"],
            "device_ms": tot[name]["device_ms"],
            "plain_ms": tot[name]["plain_ms"],
            "bound_ms": tot[name]["bound_ms"],
            "bound_by": ("bytes" if tot[name]["bytes"] / HBM_BYTES_PER_S
                         >= tot[name]["ops"] / F32_OPS_PER_S
                         else "operations"),
            "library_ms": None, "wrapper_launches": wrapper[name + suffix],
            "launches_by_path": {p: n[name + suffix]
                                 for p, n in by_path.items()}}
            for name in bnpool.BACKWARD + bnpool.FORWARD]
    kernels += moe_rows
    print(f"[done] {time.perf_counter() - t_all:.1f} s; ms, device_ms, "
          f"plain_ms and bound_ms are per training step (5 pool blocks; "
          f"device_ms the device time alone, L2 clean); launches are "
          f"the kernels' runs counted on the device in the main path's run "
          f"(f32: single, one windowed epoch; bf16: vgg11 bf16 single, "
          f"{TRAIN_STEPS} windowed steps), wrapper_launches the wrappers' "
          f"host count there (eager launches and the capture), "
          f"launches_by_path each path's runs of that variant, counted on "
          f"the device for each dtype apart (the paths' steps in their "
          f"names, else {TRAIN_STEPS}; host paths: the epoch's 195 steps "
          f"and tail, {HOST_STEPS} steps, and a captured {HOST_TIME_STEPS}-"
          f"step bf16 epoch; elastic: {5 * MICROSHARDS} runs a step, "
          f"{ELASTIC_STEPS} replays and the virtual worlds' "
          f"{BITWISE_STEPS} eager steps; serve and serve_tier: the serving "
          f"phases, which run none; publish: {PUBLISH_EPOCHS} windowed "
          f"epochs of {PUBLISH_STEPS} steps, and serving that runs none; "
          f"obs: two {WINDOW}-step windows of replays and 3 warm-up "
          f"steps each in f32 and in bf16; audit: the audited CLI epoch "
          f"(3 warm-up steps, {AUDIT_EPOCH_STEPS} replays, the tail) and "
          f"the Group checks' eager step, 3 warm-up steps and one replay "
          f"for each of two tiers; "
          f"window: 3 warm-up steps and graph "
          f"replays, per-step: eager); the bf16 max_abs_err of dx is over "
          f"the "
          f"elements "
          f"outside the near-tie routing flips that phase 2 bounds")
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
