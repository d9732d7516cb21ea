"""Staging supervision primitives: watchdogs, bounded retry, checksums.

A copy of the reference package's ``ft/supervisor.py``.  The chunked
host-to-device staging pipeline (``train/loop.py``, ``--host-augment``)
has three ways to die that a bare ``queue.get`` never surfaces: the
producer thread crashes, a chunk's host-to-device copy stalls forever (a
wedged copy engine, a PCIe hiccup), or staged bytes get silently
corrupted (a buffer-reuse bug).  The primitives here make each one
*detected* and *bounded*:

* ``Watchdog``        — detection-only timer around a blocking call.  It
                        cannot interrupt a wedged native call (nothing in
                        Python can), so it fires a callback (a log line)
                        while the consumer-side stall deadline remains the
                        hard recovery trigger.
* ``call_with_retry`` — bounded attempts with exponential backoff for
                        transient put failures.
* ``StagingStalled``  — raised by the consumer when no staged item has
                        arrived within the deadline although the producer
                        looks alive; handled exactly like a producer
                        crash (restart once, then degrade).
* ``batch_checksums`` / ``verify_checksums`` — crc32 over each staged
                        arena row, computed at fill time and re-verified
                        immediately before the put; a mismatch means the
                        bytes changed underneath us and the row is
                        deterministically re-staged from the dataset.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, List, Optional, Sequence

import numpy as np


class StagingStalled(RuntimeError):
    """Consumer-side stall deadline expired with the producer still alive."""


class WatchdogTimeout(RuntimeError):
    """For a caller of ``Watchdog`` that opts into raising on overrun."""


class Watchdog:
    """Context manager that invokes ``on_timeout(elapsed_s)`` once if the
    body runs longer than ``timeout_s``.  Detection only — the body keeps
    running; ``fired`` tells the caller it overran."""

    def __init__(self, timeout_s: Optional[float],
                 on_timeout: Optional[Callable[[float], None]] = None):
        self._timeout_s = timeout_s
        self._on_timeout = on_timeout
        self._timer: Optional[threading.Timer] = None
        self._t0 = 0.0
        # ``_fire`` runs on the Timer thread while ``__exit__`` and readers
        # run on the caller's; ``Timer.cancel`` does NOT wait for an
        # in-flight callback, so without the lock and the cancelled flag a
        # watchdog could fire (and report a timeout) AFTER its body
        # already completed — the lock makes cancel-vs-fire atomic.
        self._lock = threading.Lock()
        self._cancelled = False
        self.fired = False

    def _fire(self):
        with self._lock:
            if self._cancelled:
                return
            self.fired = True
            if self._on_timeout is not None:
                self._on_timeout(time.perf_counter() - self._t0)

    def __enter__(self) -> "Watchdog":
        self._t0 = time.perf_counter()
        with self._lock:
            self.fired = False
            self._cancelled = False
        if self._timeout_s is not None and self._timeout_s > 0:
            self._timer = threading.Timer(self._timeout_s, self._fire)
            self._timer.daemon = True
            self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer is not None:
            self._timer.cancel()
        with self._lock:
            # After this point an in-flight ``_fire`` can no longer set
            # ``fired`` or invoke the callback.
            self._cancelled = True
        return False


def call_with_retry(fn: Callable, *, attempts: int, backoff_base_s: float,
                    on_retry: Optional[Callable[[int, BaseException], None]]
                    = None,
                    sleep: Callable[[float], None] = time.sleep):
    """Run ``fn()`` with up to ``attempts`` tries and exponential backoff
    (``backoff_base_s * 2**try``) between them.  ``on_retry(i, exc)`` is
    called before each re-attempt; the final failure propagates."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    for a in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - the retry layer is broad
            if a == attempts - 1:
                raise
            if on_retry is not None:
                on_retry(a, e)
            sleep(backoff_base_s * (2 ** a))


def batch_checksums(rows) -> List[int]:
    """crc32 per staged batch row (C-contiguous uint8 views)."""
    return [zlib.crc32(np.ascontiguousarray(r)) for r in rows]


def verify_checksums(rows, expected: Sequence[int]) -> List[int]:
    """Indices of rows whose bytes no longer match their fill-time crc32."""
    got = batch_checksums(rows)
    return [i for i, (g, e) in enumerate(zip(got, expected)) if g != e]
