"""Training-side weight publisher: the trainer's state -> atomic bundle --
the reference package's ``publish/publisher.py``.

``WeightPublisher.publish(state)`` flattens the serving half of the
trainer's state (parameters + BatchNorm running statistics) into the
reference's leaves (``models/convert.py::serving_leaves``), writes a
versioned bundle (``v000001.ccwb``) via tmp + ``os.replace`` —
complete-or-absent, same discipline as the checkpoint metadata sidecars —
then atomically updates the ``LATEST`` pointer.  A serving-side
``WeightWatcher`` polling the directory can therefore never observe a
half-written bundle through the pointer; the only torn-bundle path is
real corruption, which the per-leaf crc32 catches at read time.

On the card the state is read back into pinned buffers on a side stream,
after the work queued so far, and the host waits on that copy's event
alone: no device-wide synchronize, and no waiting ``.cpu()``, which would
hold up other threads' pinned copies until the device is idle.

Versions are monotonic: auto-assigned as ``LATEST.version + 1`` (1 when
the directory is empty), so a publisher restarted against an existing
directory continues the sequence instead of re-issuing version 1.

Chaos (``ft/`` harness, keyed by this publisher's 0-based publish
index):

* ``publish_torn:K[:seed]``  — publish K's bundle file has seeded bytes
  of its leaf payload flipped AFTER the atomic rename (the on-disk file
  is structurally valid but fails crc) — the watcher-must-reject drill;
* ``publish_stale:K[:seed]`` — publish K re-announces the PREVIOUS
  version number (a duplicate/late publisher) — the watcher-must-skip
  drill.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from ..ft.chaos import NULL_CHAOS
from ..models import convert
from ..obs import NULL
from . import bundle as bundlelib


class WeightPublisher:
    """Atomic versioned publisher into one watched directory."""

    def __init__(self, directory: str, *, fingerprint: Optional[Dict] = None,
                 telemetry=None, chaos=NULL_CHAOS):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.fingerprint = dict(fingerprint or {})
        self.telemetry = telemetry if telemetry is not None else NULL
        self.chaos = chaos
        self._publishes = 0          # chaos step counter (0-based)
        self._pinned: Dict[str, torch.Tensor] = {}   # host buffers, by name
        self._stream: Optional[torch.cuda.Stream] = None

    def latest_version(self) -> int:
        latest = bundlelib.read_latest(self.directory)
        return int(latest["version"]) if latest else 0

    def _bundle_path(self, version: int) -> str:
        return os.path.join(self.directory, f"v{version:06d}.ccwb")

    def _to_host(self, sd: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """``sd`` on the host.  CUDA tensors are copied into this
        publisher's pinned buffers on its side stream, after the work
        queued on the current stream; the host then waits on that copy's
        event alone."""
        on_card = [t for t in sd.values() if t.is_cuda]
        if not on_card:
            return {k: v.detach() for k, v in sd.items()}
        device = on_card[0].device
        with torch.cuda.device(device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            self._stream.wait_stream(torch.cuda.current_stream(device))
            out = {}
            with torch.cuda.stream(self._stream):
                for k, t in sd.items():
                    buf = self._pinned.get(k)
                    if buf is None or buf.shape != t.shape \
                            or buf.dtype != t.dtype:
                        buf = torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=True)
                        self._pinned[k] = buf
                    buf.copy_(t.detach(), non_blocking=True)
                    out[k] = buf
            done = torch.cuda.Event(blocking=True)
            done.record(self._stream)
        done.synchronize()
        return out

    def _flatten_state(self, state):
        """(leaves, treedef string) of the serving half of ``state``: a
        ``TrainState`` (its ``model``), an ``nn.Module`` or a state_dict —
        EXACTLY the flatten the engine keys its abstract signature on."""
        model = getattr(state, "model", state)
        sd = model.state_dict() if hasattr(model, "state_dict") else state
        return convert.serving_leaves(self._to_host(sd))

    def publish(self, state, *, version: Optional[int] = None) -> dict:
        """Publish ``state`` (parameters + BN statistics); returns a record
        of what landed on disk: version, file, bytes, leaves, and which
        chaos faults (if any) were injected into THIS publish."""
        publish_no = self._publishes
        self._publishes += 1
        ch = self.chaos
        prev = self.latest_version()
        stale = ch.enabled and ch.fire("publish_stale", publish_no)
        if version is None:
            # A stale publish re-announces the previous version (or 1
            # when nothing precedes it — then it is merely a duplicate).
            version = prev if stale and prev > 0 else prev + 1
        version = int(version)

        leaves, treedef = self._flatten_state(state)
        path = self._bundle_path(version)
        if stale and prev > 0:
            # A duplicate publisher would not overwrite the original
            # bundle byte-for-byte — it lands its own file and re-points
            # LATEST at the old version, so the watcher sees a CHANGED
            # pointer carrying an already-installed version (the skip
            # drill), not a no-op.
            path = os.path.join(self.directory, f"v{version:06d}.dup.ccwb")
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            manifest = bundlelib.write_bundle(
                tmp, leaves, version=version, treedef=treedef,
                fingerprint=self.fingerprint)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

        torn = ch.enabled and ch.fire("publish_torn", publish_no)
        if torn:
            self._tear(path, publish_no)

        # Pointer update LAST, atomically: the watcher only ever follows
        # the pointer, so it can never race the bundle write itself.
        latest_path = os.path.join(self.directory, bundlelib.LATEST)
        tmp = f"{latest_path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"version": version,
                           "file": os.path.basename(path)}, f)
            os.replace(tmp, latest_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

        nbytes = bundlelib.bundle_nbytes(manifest)
        tel = self.telemetry
        if tel.enabled:
            tel.counter("publish_count")
            tel.gauge("publish_version", version, bytes=nbytes,
                      leaves=len(leaves))
            if torn or stale:
                tel.counter("publish_chaos_injected",
                            torn=torn, stale=stale)
        return {"version": version, "file": path, "bytes": nbytes,
                "leaves": len(leaves), "torn": torn, "stale": stale}

    def _tear(self, path: str, publish_no: int) -> None:
        """Flip seeded payload bytes of the published file in place (past
        the manifest, so the header still parses and the failure is a
        leaf crc mismatch — the realistic torn-write signature)."""
        rng = self.chaos.rng("publish_torn", publish_no)
        manifest = bundlelib.read_manifest(path)
        size = os.path.getsize(path)
        payload = bundlelib.bundle_nbytes(manifest)
        start = size - payload
        offsets = sorted(set(
            int(o) for o in rng.integers(start, size, size=8)))
        with open(path, "r+b") as f:
            for off in offsets:
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ 0xFF]))
