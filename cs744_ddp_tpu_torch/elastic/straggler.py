"""Straggler detection over per-rank step-time gauges: the reference
package's ``elastic/straggler.py``, unchanged.

One EWMA of step time per rank; a rank is flagged when its smoothed time
exceeds ``threshold`` x the median of the OTHER ranks' EWMAs (median, not
mean: a single extreme straggler must not drag the baseline up to meet
itself).  Detection-only.  In the port each rank is a process that times
its own window and the ranks exchange their times at the window boundary
(``train/loop.py::Trainer._rank_boundary``), so every rank's detector sees
the same observations; the ``slow_rank`` chaos site stalls one rank and
adds the stall to its own gauge, which must be the only thing that trips
the threshold.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class StragglerDetector:
    """EWMA-vs-peers step-time outlier detection, one stream per rank."""

    def __init__(self, world: int, *, alpha: float = 0.3,
                 threshold: float = 2.0, min_steps: int = 3):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if threshold <= 1.0:
            raise ValueError(f"threshold must be > 1, got {threshold}")
        self.world = world
        self.alpha = alpha
        self.threshold = threshold
        self.min_steps = min_steps
        self._ewma: List[Optional[float]] = [None] * world
        self._count = [0] * world
        self.flag_counts: Dict[int, int] = {}

    def ewma(self, rank: int) -> Optional[float]:
        return self._ewma[rank]

    def observe(self, rank: int, step_time_s: float) -> None:
        if not (0 <= rank < self.world):
            raise ValueError(f"rank {rank} out of range for world "
                             f"{self.world}")
        prev = self._ewma[rank]
        self._ewma[rank] = step_time_s if prev is None else (
            self.alpha * step_time_s + (1.0 - self.alpha) * prev)
        self._count[rank] += 1

    @staticmethod
    def _median(xs: List[float]) -> float:
        xs = sorted(xs)
        n = len(xs)
        mid = n // 2
        return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])

    def check(self) -> List[int]:
        """Ranks currently straggling (world 1 has no peers to lag)."""
        flagged = []
        for r in range(self.world):
            if self._count[r] < self.min_steps:
                continue
            peers = [self._ewma[p] for p in range(self.world)
                     if p != r and self._ewma[p] is not None
                     and self._count[p] >= self.min_steps]
            if not peers:
                continue
            med = self._median(peers)
            if med > 0 and self._ewma[r] > self.threshold * med:
                flagged.append(r)
                self.flag_counts[r] = self.flag_counts.get(r, 0) + 1
        return flagged

    def summary(self) -> dict:
        """Telemetry/report-shaped view of the detector state."""
        return {
            "world": self.world,
            "threshold": self.threshold,
            "ewma_step_s": {str(r): self._ewma[r]
                            for r in range(self.world)
                            if self._ewma[r] is not None},
            "flag_counts": {str(r): c for r, c in
                            sorted(self.flag_counts.items())},
        }
