"""Double-buffered uint8 request staging (the serving ingest path) -- the
reference package's ``serve/ingest.py``.

Reuses the training pipeline's ``native.StagingArena``: two host buffers
sized to the largest bucket (pinned on the card, so that their copies to
the device run asynchronously), handed out round-robin with a per-slot
transfer fence, so assembling request batch k+1 overlaps the device
transfer of batch k instead of waiting behind it.  Pad rows are zeroed at
fill time (the engine masks them out by label; zeroing keeps the staged
bytes deterministic so bucketed dispatch is reproducible byte for byte).

The reference probes whether its CPU client aliases an arena row it puts
on the device; that probe has no counterpart here.  The rows are copied
(``copy_``) into a device-owned destination, so no transfer ever aliases
the arena's host memory (``native.StagingArena``'s docstring).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data import native


class StagedIngest:
    """Bounded double-buffered uint8 staging onto ``device``.

    On the card each copy runs on a copy stream of its own and ``stage``
    returns the ``torch.cuda.Event`` recorded after it, which the caller's
    compute stream waits on before it reads the destination; the same
    event is the arena slot's fence, so the slot's host memory is not
    refilled before the copy has read it.  On the CPU the copy is
    synchronous and ``stage`` returns None."""

    def __init__(self, max_batch: int, nslots: int = 2, device=None):
        self._max_batch = max_batch
        self._device = torch.device("cpu" if device is None else device)
        cuda = self._device.type == "cuda"
        self._arena = native.StagingArena(nslots, 1, max_batch, pin=cuda)
        self._stream = torch.cuda.Stream(self._device) if cuda else None
        self._events = ([torch.cuda.Event() for _ in range(nslots)]
                        if cuda else None)

    @property
    def nslots(self) -> int:
        return self._arena.nslots

    def stage(self, images: np.ndarray, bucket: int,
              dst: torch.Tensor) -> Optional[torch.cuda.Event]:
        """Fill the next arena slot with ``images`` padded to ``bucket``
        rows (zeros) and copy rows ``[:bucket]`` into ``dst`` (uint8
        [bucket, 32, 32, 3] on the device).  Returns the copy's event on
        the card, None on the CPU."""
        n = len(images)
        if not (0 < n <= bucket <= self._max_batch):
            raise ValueError(f"cannot stage {n} images into bucket "
                             f"{bucket} (max {self._max_batch})")
        slot, buf = self._arena.acquire()
        row = buf[0]
        row[:n] = images
        if n < bucket:
            row[n:bucket] = 0
        src = self._arena.tensor(slot)[0, :bucket]
        if self._stream is None:
            dst.copy_(src)
            self._arena.retire(slot, None)
            return None
        event = self._events[slot]
        with torch.cuda.stream(self._stream):
            dst.copy_(src, non_blocking=True)
            event.record(self._stream)
        self._arena.retire(slot, event)
        return event
