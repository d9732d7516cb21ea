"""Timing/metrics with the reference training script's reporting schedule.

Step time (forward, backward and update) is averaged over 20-iteration
windows, the first window is left out of the timing report (warmup), and the
running loss is printed every 20 iterations.  The caller fences each timed
region so the timers measure device work, not the enqueue: a value fetch
(``float(loss)``) or ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

from typing import Callable, List, Optional

WINDOW = 20  # report every 20 iterations, skip the first window's timing


class WindowedTimers:
    """Step-time and loss accumulators over 20-iteration windows, warmup
    excluded."""

    def __init__(self, log: Callable[[str], None] = print):
        self.log = log
        self.iter_number = 1
        self.epoch_loss = 0.0
        self.total_time = 0.0
        # The full per-iteration loss trajectory.
        self.losses: List[float] = []
        # Steady-state samples (first window excluded) for throughput.
        self.steady_step_times: List[float] = []

    def record(self, loss: float, step_time: float, *,
               steady: bool = True) -> None:
        """Record one iteration.  ``steady=False`` keeps the sample in the
        print schedule and totals but out of the steady-state statistics
        (the ragged final batch, which is smaller than the rest)."""
        self.epoch_loss += loss
        self.losses.append(loss)
        self.total_time += step_time
        warmup = self.iter_number <= WINDOW
        if not warmup and steady:
            self.steady_step_times.append(step_time)

        if self.iter_number % WINDOW == 0:
            self.log(f"Training loss after {self.iter_number} iterations is "
                     f"{self.epoch_loss / WINDOW}")
            self.epoch_loss = 0.0
            if self.iter_number != WINDOW:  # warmup window: no timing line
                self.log(f"Average Pass time in iter {self.iter_number} is "
                         f"{self.total_time / WINDOW}")
            self.total_time = 0.0
        self.iter_number += 1

    def steady_images_per_sec(self, global_batch: int) -> Optional[float]:
        if not self.steady_step_times:
            return None
        return global_batch * len(self.steady_step_times) / sum(
            self.steady_step_times)
