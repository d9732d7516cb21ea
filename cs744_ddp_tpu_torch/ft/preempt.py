"""Preemption guard: turn SIGTERM/SIGINT into a clean mid-epoch save.

A copy of the reference package's ``ft/preempt.py``.  On a shared
cluster preemption is routine: the scheduler sends SIGTERM and gives the
process a grace window.  The guard installs handlers that only set a
flag; the training loop polls the flag at step/window boundaries (so the
in-flight dispatch always completes) and raises ``PreemptedError``, which
``Trainer.run`` catches to write an emergency *step-level* checkpoint.
Handlers never do real work — everything heavy happens on the main thread
at a known-consistent point.

``install`` is a no-op off the main thread (Python only delivers signals
to the main thread, and ``signal.signal`` raises elsewhere), and the
previous handlers are restored by ``uninstall`` so library callers — and
pytest — keep their Ctrl-C behaviour outside ``run()``.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional


class PreemptedError(Exception):
    """Raised at a step boundary after SIGTERM/SIGINT; carries the exact
    resume point (epoch, step = batches already trained this epoch)."""

    def __init__(self, epoch: int, step: int):
        super().__init__(f"preempted at epoch {epoch} step {step}")
        self.epoch = epoch
        self.step = step


class PreemptionGuard:
    _SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, log=None):
        self._event = threading.Event()
        self._prev: dict = {}
        self._log = log
        self.signum: Optional[int] = None

    def _handler(self, signum, frame):
        self.signum = signum
        self._event.set()
        if self._log is not None:
            name = signal.Signals(signum).name
            self._log(f"{name} received; will checkpoint at the next step "
                      f"boundary and exit")

    def install(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in self._SIGNALS:
            self._prev[sig] = signal.signal(sig, self._handler)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def check(self, epoch: int, step: int) -> None:
        """Raise ``PreemptedError`` if a preemption signal has arrived."""
        if self._event.is_set():
            raise PreemptedError(epoch, step)
