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
               sums;
  3. time    — per shape: kernel time (median of CUDA-event timings, L2
               flushed before each launch), its device time alone (median
               of the profiler's kernel records, each launch after the
               flush and a read pass that leaves the L2 clean), its byte
               bound and the share of it each time reaches, the plain
               version's time, the backward of the unfused library chain
               (batch_norm -> relu -> max_pool2d) as a reference point, and
               a digest of dx's bytes (to compare two checkouts' kernels
               bit for bit); in f32, then in bf16 (lines tagged ``bf16``;
               the bound counts 2-byte xhat, dp and dx);
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
  8. report  — the ``kernels`` JSON line (each kernel in f32, with the
               main path's runs, and in bf16, with the VGG-11 bf16 path's),
               the card's name and power limit, and as the last line
               ``{"ok": true, "device": {...}}``.

``--time-only`` runs phases 1 and 3 and stops.  ``--root DIR`` times the
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
BATCH = 256
CLEAN_REPS = 20
# The kernels' names in a profiler trace, by wrapper.
KERNEL_FRAGMENT = {"bnpool_sums": "sums_kernel", "bnpool_dx": "dx_kernel"}
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
        work = time_work(bnpool, xhat, dp, gamma, beta, inv, sums)
        for name, (kernel, plain, nbytes, ops) in work.items():
            row[name] = dict(
                ms=time_ms(kernel, 20, flush),
                plain_ms=time_ms(plain, 5, flush),
                bound_ms=max(nbytes / HBM_BYTES_PER_S,
                             ops / F32_OPS_PER_S) * 1e3,
                bytes=nbytes, ops=ops)
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
        _, xhat, dp, gamma, beta, inv = inputs(row["shape"], dtype, k)
        sums = bnpool.bnpool_sums(xhat, dp, gamma, beta)
        work = time_work(bnpool, xhat, dp, gamma, beta, inv, sums)
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
    tot = {k: dict.fromkeys(keys, 0.0) for k in ("bnpool_sums", "bnpool_dx")}
    chain_total = 0.0
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


def variants(precision, n):
    """Each kernel variant's expected count: ``n`` for the two variants of
    ``precision``, 0 for the others."""
    from cs744_ddp_tpu_torch.ops import bnpool
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    want = dict.fromkeys(bnpool.KERNELS, 0)
    want.update({bnpool.kernel_name(k, dtype): n
                 for k in ("bnpool_sums", "bnpool_dx")})
    return want


def check_runs(label, runs, launches, steps, replayed, precision="f32"):
    """Each kernel's ``precision`` variant ran 5 times a step on the
    device (runs), the other variants never; the wrappers launched 5 a
    step eagerly, and on the windowed path (``replayed`` steps) 5 for each
    warm-up step and 5 into the captured graph."""
    from cs744_ddp_tpu_torch.train.step import WARMUP_ITERS
    eager = steps - replayed
    if replayed:
        eager += WARMUP_ITERS
    want_runs = variants(precision, 5 * (eager + replayed))
    want_launches = variants(precision, 5 * (eager + (1 if replayed else 0)))
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
                            "single/per-step": per_runs}


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cli(args, label, timeout=600):
    """``python -m cs744_ddp_tpu_torch.cli ARGS`` in a session of its own
    (a timeout kills the ranks it spawned); its stdout, or a failure."""
    cmd = [sys.executable, "-m", "cs744_ddp_tpu_torch.cli"] + list(args)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SmokeFailure(f"{label}: no end in {timeout} s")
    check(proc.returncode == 0, f"{label} failed:\n"
          f"{stdout[-3000:]}\n{stderr[-3000:]}")
    return stdout


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--time-only", action="store_true",
                        help="build and time the kernels, nothing else")
    parser.add_argument("--root", help="time the kernels of the checkout at "
                        "this directory (implies --time-only)")
    parser.add_argument("--tune-dx", action="store_true",
                        help="build, time the dx kernel over partitions, "
                        "nothing else")
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
    if args.time_only or args.root:
        from cs744_ddp_tpu_torch.ops import bnpool
        print(f"[time] kernels of {os.path.dirname(bnpool.__file__)}")
        phase_time(card_line)
        return 0
    errs = {"bnpool_sums": 0.0, "bnpool_dx": 0.0,
            "bnpool_sums_bf16": 0.0, "bnpool_dx_bf16": 0.0}
    phase_check(errs)
    times = phase_time(card_line)
    launches, wrapper_launches, by_path = phase_train(card_line)
    by_path.update(phase_strategies(card_line))
    (bf16_runs, bf16_launches), model_paths = phase_models(card_line)
    by_path.update(model_paths)
    by_path.update(phase_ft(card_line))

    replaces = {"bnpool_sums": "cs744_ddp_tpu/ops/bnpool_pallas.py:147",
                "bnpool_dx": "cs744_ddp_tpu/ops/bnpool_pallas.py:184"}
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
            for name in ("bnpool_sums", "bnpool_dx")]
    print(f"[done] {time.perf_counter() - t_all:.1f} s; ms, device_ms, "
          f"plain_ms and bound_ms are per training step (5 pool blocks; "
          f"device_ms the device time alone, L2 clean); launches are "
          f"the kernels' runs counted on the device in the main path's run "
          f"(f32: single, one windowed epoch; bf16: vgg11 bf16 single, "
          f"{TRAIN_STEPS} windowed steps), wrapper_launches the wrappers' "
          f"host count there (eager launches and the capture), "
          f"launches_by_path each path's runs of that variant, counted on "
          f"the device for each dtype apart (the others {TRAIN_STEPS} "
          f"steps; window: 3 warm-up steps and graph replays, per-step: "
          f"eager); the bf16 max_abs_err of dx is over the elements "
          f"outside the near-tie routing flips that phase 2 bounds")
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
