"""Timing/metrics with the reference training script's reporting schedule.

Step time (forward, backward and update) is averaged over 20-iteration
windows, the first window is left out of the timing report (warmup), and the
running loss is printed every 20 iterations.  When the caller also times
the forward pass (the Trainer's ``profile_phases`` mode), the reference's
"Forward Pass" and "Backward Pass" lines are printed too; the backward
bucket absorbs sync and update, as the reference's does.  The caller fences
each timed region so the timers measure device work, not the enqueue: a
value fetch (``float(loss)``, the window's ring) or
``torch.cuda.synchronize()``.

With a telemetry recorder (``obs/telemetry.py``) every recorded iteration
is also a step event; the print schedule is the same with it or without.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from ..obs import NULL

WINDOW = 20  # report every 20 iterations, skip the first window's timing


class WindowedTimers:
    """Per-phase accumulators over 20-iteration windows, warmup
    excluded.

    ``telemetry`` mirrors every recorded iteration into the structured
    event log BESIDE the prints, never instead of them (the default
    ``NULL`` recorder costs one attribute check a step)."""

    def __init__(self, log: Callable[[str], None] = print, *,
                 telemetry=NULL, epoch: int = 0):
        self.log = log
        self.telemetry = telemetry
        self.epoch = epoch
        self.iter_number = 1
        self.epoch_loss = 0.0
        self.forward_time = 0.0
        self.backward_time = 0.0
        self.total_time = 0.0
        # The full per-iteration loss trajectory.
        self.losses: List[float] = []
        # Steady-state samples (first window excluded) for throughput.
        self.steady_step_times: List[float] = []
        self.steady_forward_times: List[float] = []

    def record(self, loss: float, step_time: float,
               forward_time: Optional[float] = None, *,
               steady: bool = True, extra: Optional[dict] = None) -> None:
        """Record one iteration.  ``forward_time``, when given, is a
        separately timed forward pass of the same batch; backward is
        ``step_time - forward_time``.  ``steady=False`` keeps the sample in
        the print schedule and totals but out of the steady-state
        statistics (the ragged final batch, which is smaller than the
        rest).  ``extra`` joins the telemetry step event (the ring's
        ``grad_sqnorm`` and ``step_index``); the prints never see it."""
        self.epoch_loss += loss
        self.losses.append(loss)
        self.total_time += step_time
        warmup = self.iter_number <= WINDOW
        if self.telemetry.enabled:
            self.telemetry.step(
                epoch=self.epoch, iter=self.iter_number, loss=float(loss),
                step_time=step_time, forward_time=forward_time,
                steady=not warmup and steady, **(extra or {}))
        if forward_time is not None:
            self.forward_time += forward_time
            self.backward_time += step_time - forward_time
            if not warmup and steady:
                self.steady_forward_times.append(forward_time)
        if not warmup and steady:
            self.steady_step_times.append(step_time)

        if self.iter_number % WINDOW == 0:
            self.log(f"Training loss after {self.iter_number} iterations is "
                     f"{self.epoch_loss / WINDOW}")
            self.epoch_loss = 0.0
            if self.iter_number != WINDOW:  # warmup window: no timing line
                if forward_time is not None:
                    self.log(f"Forward Pass time in iter {self.iter_number} "
                             f"is {self.forward_time / WINDOW}")
                    self.log(f"Backward Pass time in iter {self.iter_number} "
                             f"is {self.backward_time / WINDOW}")
                self.log(f"Average Pass time in iter {self.iter_number} is "
                         f"{self.total_time / WINDOW}")
            self.forward_time = 0.0
            self.backward_time = 0.0
            self.total_time = 0.0
        self.iter_number += 1

    def steady_images_per_sec(self, global_batch: int) -> Optional[float]:
        if not self.steady_step_times:
            return None
        return global_batch * len(self.steady_step_times) / sum(
            self.steady_step_times)


class Stopwatch:
    """Wall time of a ``with`` block, in ``elapsed`` seconds."""

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self.t0
        return False


def mfu_fields(ips_per_chip: float, flops_per_image, **kw) -> dict:
    """tflops/MFU fields for one card's throughput.  Delegates to
    ``analysis.costmodel.mfu_fields``, the one copy of the peak constant
    and the rounding, so the numbers cannot drift between reports."""
    from ..analysis.costmodel import mfu_fields as _mfu
    return _mfu(ips_per_chip, flops_per_image, **kw)
