"""Device-resident metric ring: the reference package's ``obs/ringbuf.py``.

A fixed-capacity f32 ring of shape ``(capacity, N_METRICS)`` on the device
plus an int64 write counter, both persistent tensors that the train window
writes in place: every step writes one row at ``counter % capacity`` with
``index_copy_`` and increments the counter, inside the captured graph on
the card, with no host sync.  The host fetches the whole buffer ONCE per
window and reconstructs the per-step rows, absolute step indices included,
from the ``marker`` column.

Columns (``METRICS``):

- ``loss``         — the step's loss, meaned over the ranks;
- ``grad_sqnorm``  — the sum over parameters of sum(g*g) of the post-sync
                     gradients, the same on every rank;
- ``ok``           — 1.0 (the non-finite guard is not ported yet);
- ``marker``       — the absolute batch index as f32, exact below 2**24
                     (checked at drain).

The counter counts TOTAL writes; the host tracks the same total
(``Ring.writes``), so a drain needs no second fetch and detects overwrite.
``drain_rows``, ``marker_steps`` and ``split_columns`` are numpy copies of
the reference's host functions, with the same refusals.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

METRICS = ("loss", "grad_sqnorm", "ok", "marker")
N_METRICS = len(METRICS)
DEFAULT_CAPACITY = 64          # >= WINDOW (20) with slack for ragged tails
_MARKER_EXACT = float(2 ** 24)  # largest exactly-representable f32 int


class Ring:
    """The device buffer and write counter, and the host's count of the
    writes issued (``writes``), which the window keeps in step."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, device=None):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.buf = torch.zeros((capacity, N_METRICS), dtype=torch.float32,
                               device=device)
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.writes = 0

    @property
    def capacity(self) -> int:
        return self.buf.shape[0]

    @torch.no_grad()
    def write(self, values) -> None:
        """Write one row (``N_METRICS`` 0-d tensors or numbers) at the
        current slot and advance the counter, in place, on the device.
        Numbers become device fills, not host-to-device copies, so that the
        write can be captured in a CUDA graph."""
        if len(values) != N_METRICS:
            raise ValueError(f"expected {N_METRICS} metrics, "
                             f"got {len(values)}")
        dev = self.buf.device
        row = torch.stack([
            v.to(torch.float32).reshape(()) if torch.is_tensor(v)
            else torch.full((), float(v), dtype=torch.float32, device=dev)
            for v in values]).reshape(1, N_METRICS)
        self.buf.index_copy_(0, (self.count % self.capacity).reshape(1), row)
        self.count.add_(1)


def drain_rows(buf_host, writes_total: int, count: int) -> np.ndarray:
    """Last ``count`` written rows in write order, from a host copy of the
    buffer.  ``writes_total`` is the host-tracked cumulative write count.
    Handles wraparound; refuses overwritten reads."""
    buf = np.asarray(buf_host)
    cap = buf.shape[0]
    if count > cap:
        raise ValueError(
            f"drain of {count} rows exceeds ring capacity {cap}: rows were "
            "overwritten before the drain (raise --metrics-ring)")
    if count > writes_total:
        raise ValueError(
            f"drain of {count} rows exceeds total writes {writes_total}")
    idx = np.arange(writes_total - count, writes_total) % cap
    return buf[idx]


def marker_steps(rows: np.ndarray) -> np.ndarray:
    """Absolute step indices from the marker column, validated exact."""
    markers = rows[:, METRICS.index("marker")]
    if markers.size and float(np.max(markers)) >= _MARKER_EXACT:
        raise ValueError("ring marker exceeded exact-f32 integer range")
    return markers.astype(np.int64)


def split_columns(rows: np.ndarray) -> Tuple[np.ndarray, ...]:
    """(loss, grad_sqnorm, ok, steps) column views of drained rows."""
    return (rows[:, 0], rows[:, 1], rows[:, 2], marker_steps(rows))
