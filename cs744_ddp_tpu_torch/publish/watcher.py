"""Serving-side weight watcher: poll the publish directory, validate,
stage, and swap — between dispatches, never during one.  The reference
package's ``publish/watcher.py``, over the port's CUDA-graph replicas.

``WeightWatcher`` owns the whole install pipeline for a set of live
``EngineReplica``s:

1. follow the directory's ``LATEST`` pointer (cheap: one small json read
   per poll; unchanged pointer -> no work);
2. skip stale/duplicate versions (``publish_stale`` drill);
3. fully read + crc-verify the bundle (``publish_torn`` -> rejected, the
   old version keeps serving untouched);
4. validate the bundle's pytree structure and per-leaf (shape, dtype)
   against each engine's OWN abstract signature (``_key_fields
   ["abstract"]``, in the reference's layout) — the names, shapes and
   dtypes its CUDA graphs were captured over, so a valid install never
   needs a recapture;
5. rebuild the engine's state from the leaves
   (``models/convert.py::state_dict_from_leaves``) and stage it onto each
   replica's card HERE, on the watcher's thread with that card current
   (a replica on ``cuda:1`` never stages through ``cuda:0``), on the
   watcher's own side stream for that card, off the serving worker's
   critical path; the side stream is synchronized before the flip is
   queued, so the engine's stream reads finished copies, and the staged
   tensors live in the flip closure until it has run (``install_weights``
   synchronizes its stream after its copies);
6. hand each replica's scheduler a flip closure via
   ``request_install`` — the worker runs it at its next loop boundary,
   when no dispatch is in flight, so a batch never sees torn weights
   and every reply's ``model_version`` tag is exact.  The flip
   ``copy_``s into the tensors the graphs captured: the same graphs and
   the same addresses serve every version.

Rolling vs all-at-once: with ``rolling=True`` (default) replicas are
swapped one at a time, each install awaited before the next is queued,
so serving capacity never drops to zero; ``rolling=False`` queues every
replica's flip at once (each still lands at that replica's own dispatch
boundary) — ``chip_smoke.py`` phase ``publish`` runs both.

The ``swap_mid_batch`` chaos site calls ``poll_once(wait=False)`` from
INSIDE a dispatch hook (via ``EngineReplica.swap_probe``).  That path
must never block: it uses a non-blocking lock acquire (a concurrent
poll just reports "busy") and never waits on install futures — the
racing dispatch completes on the old weights, the flip lands at the
next boundary.  That one chaos path reads, validates and stages on the
worker thread, before the racing dispatch is issued: what it costs that
dispatch is recorded in PERF.md (``chip_smoke.py`` phase ``publish``).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

from ..ft.chaos import NULL_CHAOS
from ..models import convert
from ..obs import NULL
from . import bundle as bundlelib


class WeightWatcher:
    """Poll, validate, stage and swap for one publish directory."""

    # Lock discipline: every field mutated under self._lock.
    _lock_owned = ("_installed_version", "_pointer", "_counts",
                   "_swap_ms", "_thread", "_stop", "_streams")

    def __init__(self, directory: str, replicas: Sequence, *,
                 telemetry=None, chaos=NULL_CHAOS, rolling: bool = True,
                 poll_interval_s: float = 0.05,
                 install_timeout_s: float = 30.0,
                 attach_probes: bool = True):
        self.directory = directory
        self.replicas = list(replicas)
        self.telemetry = telemetry if telemetry is not None else NULL
        self.chaos = chaos
        self.rolling = bool(rolling)
        self.poll_interval_s = float(poll_interval_s)
        self.install_timeout_s = float(install_timeout_s)
        self._lock = threading.Lock()
        self._installed_version = 0
        self._pointer: Optional[dict] = None   # last LATEST content seen
        self._counts: Dict[str, int] = {
            "polls": 0, "installed": 0, "rejected": 0, "stale": 0}
        self._swap_ms: List[float] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        # One staging stream a card, made at its first install.
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        if attach_probes:
            for r in self.replicas:
                r.swap_probe = self._probe

    # -- the poll/install pipeline ----------------------------------------

    def _probe(self) -> None:
        """The swap_mid_batch entry point — called inside a dispatch hook
        on the scheduler WORKER thread, so it must never block (waiting
        on an install future would deadlock the worker against itself)."""
        self.poll_once(wait=False)

    def poll_once(self, wait: bool = True) -> str:
        """One poll of the publish directory.  Returns what happened:
        "none" (pointer unchanged / nothing published), "busy" (another
        poll in progress, non-blocking path only), "stale" (version
        already installed or older — skipped), "rejected" (torn bundle
        or signature mismatch — old version keeps serving), "pending"
        (installs queued, not awaited — ``wait=False``), or
        "installed" (every replica flipped)."""
        if not self._lock.acquire(blocking=wait):
            return "busy"
        try:
            return self._poll_locked(wait)
        finally:
            self._lock.release()

    def _poll_locked(self, wait: bool) -> str:
        # Caller (poll_once) holds _lock via the non-blocking acquire;
        # the _locked suffix carries that contract.
        tel = self.telemetry
        self._counts["polls"] += 1
        try:
            latest = bundlelib.read_latest(self.directory)
        except bundlelib.BundleError:
            # A malformed pointer is a real fault (it is written
            # atomically); reject, keep serving.
            self._reject_locked(tel, "pointer")
            return "rejected"
        if latest is None or latest == self._pointer:
            return "none"
        self._pointer = dict(latest)
        version = int(latest["version"])
        if tel.enabled:
            # The watcher-side freshness signal (the reference's
            # PUBLISH_LAG alert rule tracks it): newest LATEST version
            # seen vs what this watcher has installed.
            tel.gauge("publish_latest_seen", version,
                      installed=self._installed_version)
        if version <= self._installed_version:
            self._counts["stale"] += 1
            if tel.enabled:
                tel.counter("publish_stale_skipped", version=version,
                            installed=self._installed_version)
            return "stale"

        path = os.path.join(self.directory, latest["file"])
        try:
            manifest, leaves = bundlelib.read_bundle(path)
        except (bundlelib.BundleError, OSError) as e:
            self._reject_locked(tel, "crc", version=version, error=str(e))
            return "rejected"
        err = self._validate(manifest, leaves)
        if err:
            self._reject_locked(tel, "signature", version=version, error=err)
            return "rejected"

        status = self._install_all_locked(manifest, leaves, version, wait)
        if tel.enabled and status == "installed":
            tel.counter("publish_installed", version=version)
            tel.gauge("installed_version", version)
        return status

    def _reject_locked(self, tel, why: str, **attrs) -> None:
        self._counts["rejected"] += 1
        if tel.enabled:
            tel.counter("publish_rejected", why=why, **attrs)

    def _validate(self, manifest: dict, leaves) -> str:
        """Bundle vs every engine's abstract signature; "" when clean."""
        sig = (manifest["treedef"], bundlelib.leaf_signature(leaves))
        fp_model = manifest.get("fingerprint", {}).get("model")
        for r in self.replicas:
            eng = r.engine
            treedef, eleaves = eng._key_fields["abstract"]
            want = (treedef, tuple((tuple(s), d) for s, d in eleaves))
            if sig != want:
                return (f"bundle signature does not match replica "
                        f"{r.index}'s abstract model signature")
            if fp_model is not None and fp_model != eng.model_name:
                return (f"bundle fingerprint model {fp_model!r} != "
                        f"engine model {eng.model_name!r}")
        return ""

    def _install_all_locked(self, manifest, leaves, version: int,
                            wait: bool) -> str:
        # The engine's state rebuilt from the leaves once, on the host
        # (the bundle's treedef string was validation only); pinned when
        # a replica is on a card, so that its copies run asynchronously.
        host = convert.state_dict_from_leaves(
            leaves, self.replicas[0].engine._weights)
        if any(r.engine.device.type == "cuda" for r in self.replicas):
            host = {k: v if v.is_cuda else v.pin_memory()
                    for k, v in host.items()}
        futures = []
        for r in self.replicas:
            eng = r.engine
            staged = self._stage_locked(eng, host)

            def flip(eng=eng, staged=staged):
                eng.install_weights(staged, version, assume_staged=True)

            t0 = time.perf_counter()
            fut = r.scheduler.request_install(flip)
            futures.append((r, t0, fut))
            if wait and self.rolling:
                self._await_locked(r, t0, fut)
                futures.pop()
        if wait:
            for r, t0, fut in futures:
                self._await_locked(r, t0, fut)
        # The version is claimed as installed once every flip is queued:
        # each scheduler runs it at its next boundary (or inline at
        # stop()), and re-queueing on the next poll would double-install.
        self._installed_version = version
        self._counts["installed"] += 1
        return "installed" if wait else "pending"

    def _stage_locked(self, eng, host):
        """``host`` on ``eng``'s device, each ``num_batches_tracked`` the
        engine's own.  On a card: copied on this watcher's stream for that
        card, with the card current, and that stream synchronized (the
        caller holds ``_lock``)."""
        own = {k: eng._weights[k] for k in host
               if k.endswith("num_batches_tracked")}
        if eng.device.type != "cuda":
            return {**host, **own}
        with torch.cuda.device(eng.device):
            side = self._streams.get(eng.device)
            if side is None:
                side = self._streams[eng.device] = torch.cuda.Stream(
                    eng.device)
            with torch.cuda.stream(side):
                staged = {k: own[k] if k in own
                          else v.to(eng.device, non_blocking=True)
                          for k, v in host.items()}
            side.synchronize()
        return staged

    def _await_locked(self, replica, t0: float, fut) -> None:
        fut.result(timeout=self.install_timeout_s)
        ms = (time.perf_counter() - t0) * 1e3
        self._swap_ms.append(ms)
        if self.telemetry.enabled:
            self.telemetry.gauge("swap_ms", ms, replica=replica.index)

    # -- background polling ------------------------------------------------

    def start(self) -> "WeightWatcher":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop = False
            self._thread = threading.Thread(
                target=self._run, name="weight-watcher", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._stop = True
            t = self._thread
            self._thread = None
        if t is not None:
            t.join(timeout=self.install_timeout_s)

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._stop:
                    return
            self.poll_once(wait=True)
            time.sleep(self.poll_interval_s)

    # -- reporting ---------------------------------------------------------

    @property
    def installed_version(self) -> int:
        with self._lock:
            return self._installed_version

    def report(self) -> dict:
        with self._lock:
            return {"installed_version": self._installed_version,
                    "swap_ms": list(self._swap_ms),
                    **dict(self._counts)}
