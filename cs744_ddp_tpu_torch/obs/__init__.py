"""Observability of the training loop: the device-resident metric ring
(``ringbuf``), drained once per window."""

from . import ringbuf

__all__ = ["ringbuf"]
