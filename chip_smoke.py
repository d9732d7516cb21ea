#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``cs744_ddp_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-only [--root DIR]

Phases, in order; any failure exits non-zero:
  1. build   — compile the CUDA kernels from ``cs744_ddp_tpu_torch/ops/csrc``
               into ``build/kernels/`` (nvcc, sm_90a) and load them;
  2. check   — each kernel against its plain PyTorch version on the card, at
               the five VGG-11 pool-block shapes at batch 256 and at one
               ragged shape (a short last block, C not a multiple of 32) in
               f32 (rtol 5e-4 / atol 1e-4: reduction order is the only
               difference), the sums bitwise equal run to run, plus bf16 at
               the first and last shapes (at most 2e-4 of dx elements differ
               by > 0.05, each at a near-tie); and the sums captured in a
               CUDA graph, replayed on another stream beside an eager call,
               bitwise equal to the eager sums;
  3. time    — per shape: kernel time (median of CUDA-event timings, L2
               flushed before each launch), its byte bound and the share of
               it reached, the plain version's time, and the backward of the
               unfused library chain (batch_norm -> relu -> max_pool2d) as a
               reference point;
  4. train   — ``Trainer("vgg11", "single", global_batch=256)`` runs 40
               augmented steps and a 5-batch eval on the synthetic split:
               finite losses that fall from the first 20-step window to the
               second, each kernel launched 5 times per step, and the
               model's logits agreeing with a CPU run on a small batch;
  5. report  — the ``kernels`` JSON line, the card's name and power limit,
               and as the last line ``{"ok": true, "device": {...}}``.

``--time-only`` runs phases 1 and 3 and stops.  ``--root DIR`` times the
kernels of the checkout at DIR instead (for example the parent commit,
unpacked with ``git archive``), so that two versions are compared in one
run on one card.

Without a CUDA device it exits with code 2 and prints no result.  It
imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
# f32 operations per element of xhat, counted from the kernels' source.
# Sums, per window: mul, add, max per element (12), the window max (3),
# the first maximal element (3 compares, 3 selects), the gate and two sums
# (4): 25.  dx: the routing per element plus the dx formula.
SUMS_OPS_PER_ELEM = 7
DX_OPS_PER_ELEM = 12
BATCH = 256
# [N, C, H, W] of the five pool blocks of VGG-11 at batch 256 (s0..s4).
SHAPES = [(BATCH, 64, 32, 32), (BATCH, 128, 16, 16), (BATCH, 256, 8, 8),
          (BATCH, 512, 4, 4), (BATCH, 512, 2, 2)]
# 387 pooled rows of 3 windows and 24 channel vectors (16 of the 256
# threads idle): in f32 129 blocks, whose first 32 add up the partials
# 4 float4 columns each, the last of them 0 (48 columns in all).
RAGGED = (129, 96, 6, 6)
TRAIN_STEPS = 40
EVAL_BATCHES = 5
RTOL, ATOL = 5e-4, 1e-4


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
    for k, shape in enumerate(SHAPES + [RAGGED]):
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

    for shape in (SHAPES[0], SHAPES[-1]):
        _, xhat, dp, gamma, beta, inv = inputs(shape, torch.bfloat16, 99)
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
        flips = ((dx - dx_ref).abs() > 0.05).nonzero()
        check(len(flips) <= 2e-4 * dx.numel(),
              f"bf16 {shape}: {len(flips)} dx elements differ by > 0.05")
        z = (xhat.float() * gamma.view(1, -1, 1, 1)
             + beta.view(1, -1, 1, 1))
        y = z.to(torch.bfloat16).float().clamp_min(0)
        for n, c, h, w in flips[:64].tolist():
            win = y[n, c, h // 2 * 2:h // 2 * 2 + 2,
                    w // 2 * 2:w // 2 * 2 + 2].flatten().sort().values
            rel = float((win[-1] - win[-2]).abs() / (win[-1].abs() + 1e-9))
            check(rel < 2e-2, f"bf16 flip at {(n, c, h, w)} is no near-tie")
        torch.cuda.synchronize()
        print(f"[check] bf16 {shape}: max|sums err| {e_sums:.3e} (bitwise "
              f"run to run); {len(flips)} dx flip(s) of {dx.numel()} "
              f"elements  ok")


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
    from cs744_ddp_tpu_torch.ops import bnpool
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    tot = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0.0, ops=0.0)
           for k in ("bnpool_sums", "bnpool_dx")}
    chain_total = 0.0
    for k, shape in enumerate(SHAPES):
        x, xhat, dp, gamma, beta, inv = inputs(shape, torch.float32, k)
        sums = bnpool.bnpool_sums(xhat, dp, gamma, beta)
        vec = gamma.nbytes + beta.nbytes
        work = {
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
        parts = []
        for name, (kernel, plain, nbytes, ops) in work.items():
            ms = time_ms(kernel, 20, flush)
            plain_ms = time_ms(plain, 5, flush)
            bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
            t = tot[name]
            t["ms"] += ms
            t["plain_ms"] += plain_ms
            t["bound_ms"] += bound_ms
            t["bytes"] += nbytes
            t["ops"] += ops
            parts.append(f"{name} {ms:.4f} ms (bound {bound_ms:.4f}, "
                         f"{100 * bound_ms / ms:.1f}% of it; plain "
                         f"{plain_ms:.4f})")
        chain_ms = time_ms(chain_backward(x, gamma, beta, dp), 10, flush)
        chain_total += chain_ms
        torch.cuda.synchronize()
        print(f"[time] {shape}: " + "; ".join(parts)
              + f"; unfused library chain backward {chain_ms:.4f} ms  "
              f"[{card_line}]")
    for name, t in tot.items():
        print(f"[time] per step (5 blocks) {name}: {t['ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bytes'] / 1e6:.1f} MB, "
              f"{100 * t['bound_ms'] / t['ms']:.1f}% of it), plain "
              f"{t['plain_ms']:.4f} ms  [{card_line}]")
    print(f"[time] per step (5 blocks) kernels together "
          f"{tot['bnpool_sums']['ms'] + tot['bnpool_dx']['ms']:.4f} ms vs "
          f"unfused library chain backward {chain_total:.4f} ms  "
          f"[{card_line}]")
    return tot


def phase_train(card_line):
    from cs744_ddp_tpu_torch.models import get_model
    from cs744_ddp_tpu_torch.ops import bnpool
    from cs744_ddp_tpu_torch.train.loop import Trainer

    trainer = Trainer(model="vgg11", strategy="single", global_batch=BATCH,
                      augment=True, limit_train_batches=TRAIN_STEPS,
                      limit_eval_batches=EVAL_BATCHES)
    bnpool.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.run(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"bnpool_sums": bnpool.bnpool_sums.launches,
                "bnpool_dx": bnpool.bnpool_dx.launches}
    timers = trainer.last_epoch_timers
    losses = timers.losses
    check(len(losses) == TRAIN_STEPS, f"{len(losses)} steps trained")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    first, second = (statistics.mean(losses[:20]),
                     statistics.mean(losses[20:40]))
    check(second < first, f"loss did not fall: {first} -> {second}")
    for name, n in launches.items():
        check(n == 5 * TRAIN_STEPS,
              f"{name} launched {n} times in {TRAIN_STEPS} steps")
    step_ms = 1e3 * statistics.mean(timers.steady_step_times)
    ips = timers.steady_images_per_sec(BATCH)
    print(f"[train] {TRAIN_STEPS} steps + {EVAL_BATCHES} eval batches in "
          f"{wall:.2f} s; mean loss {first:.4f} (steps 1-20) -> "
          f"{second:.4f} (21-40); launches {launches}")
    print(f"[train] steady step {step_ms:.3f} ms, {ips:.1f} images/s "
          f"(steps 21-40, batch {BATCH}, f32, TF32 off)  [{card_line}]")

    # The model's forward on the card against the same weights on the CPU
    # (plain versions there), on a small batch: train-mode logits (batch
    # statistics, fused op) and eval-mode logits (running statistics).
    model = trainer.state.model
    cpu = get_model("vgg11").to(memory_format=torch.channels_last)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((32, 32, 32, 3), generator=g, device="cuda")
    x = x.permute(0, 3, 1, 2)
    for train in (True, False):
        model.train(train)
        cpu.train(train)
        with torch.no_grad():
            got, want = model(x).cpu(), cpu(x.cpu())
        check(got.shape == (32, 10) and bool(torch.isfinite(got).all()),
              f"logits {tuple(got.shape)} not finite")
        # Summation order through 8 conv+BN layers (GPU vs CPU, f32).
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    print("[train] logits on the card agree with the CPU (train and eval "
          "mode, batch 32)  ok")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--time-only", action="store_true",
                        help="build and time the kernels, nothing else")
    parser.add_argument("--root", help="time the kernels of the checkout at "
                        "this directory (implies --time-only)")
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
    if args.time_only or args.root:
        from cs744_ddp_tpu_torch.ops import bnpool
        print(f"[time] kernels of {os.path.dirname(bnpool.__file__)}")
        phase_time(card_line)
        return 0
    errs = {"bnpool_sums": 0.0, "bnpool_dx": 0.0}
    phase_check(errs)
    tot = phase_time(card_line)
    launches = phase_train(card_line)

    replaces = {"bnpool_sums": "cs744_ddp_tpu/ops/bnpool_pallas.py:147",
                "bnpool_dx": "cs744_ddp_tpu/ops/bnpool_pallas.py:184"}
    kernels = [{
        "name": name, "route": "cuda",
        "source": "cs744_ddp_tpu_torch/ops/csrc/bnpool.cu",
        "replaces": replaces[name], "launches": launches[name],
        "max_abs_err": errs[name], "ms": tot[name]["ms"],
        "plain_ms": tot[name]["plain_ms"], "bound_ms": tot[name]["bound_ms"],
        "bound_by": ("bytes" if tot[name]["bytes"] / HBM_BYTES_PER_S
                     >= tot[name]["ops"] / F32_OPS_PER_S else "operations"),
        "library_ms": None} for name in ("bnpool_sums", "bnpool_dx")]
    print(f"[done] {time.perf_counter() - t_all:.1f} s; ms, plain_ms and "
          f"bound_ms are per training step (5 pool blocks)")
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
