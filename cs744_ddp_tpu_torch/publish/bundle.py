"""Self-describing versioned weight bundle (the publish wire format) -- a
copy of the reference package's ``publish/bundle.py`` (numpy only): given
the same leaves, version, treedef string and fingerprint, both write the
same bytes, so each package's watcher reads the other's bundles.

One bundle file carries one model's full weight set (params + BatchNorm
state) as a flat leaf sequence:

    b"CCWB1\\n"  |  u32 manifest length  |  manifest JSON  |  leaf bytes

The manifest is the bundle's self-description — version, publisher
fingerprint (model/strategy/precision/seed/...), the pytree structure as
``str(treedef)``, and one record per leaf (shape, dtype, nbytes, crc32).
Leaf payloads follow back to back in manifest order, each independently
crc32-checksummed (zlib), so a torn or corrupted publish is rejected at
READ time with the exact leaf named — never installed, never partially
installed.

A deliberately boring custom container instead of ``np.savez``: the
serving-side validator needs per-leaf integrity (one flipped byte in leaf
k must fail leaf k's crc, which the ``publish_torn`` chaos site and its
CI pin depend on), and zip-member corruption fails opaquely and
all-or-nothing.  No pickling anywhere — the reader builds arrays straight
from the described shape/dtype, so a bundle is safe to read from an
untrusted directory.

``str(treedef)`` is a VALIDATION token, not a serialization: the
installer compares it against the engine's own treedef string (the port
renders the reference's ``PyTreeDef`` string without JAX,
``models/convert.py::serving_leaves``) and then rebuilds the state from
the ENGINE's own names (``convert.state_dict_from_leaves``) — a bundle
can never smuggle a foreign structure into a replica.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

MAGIC = b"CCWB1\n"
FORMAT = 1

_U32 = struct.Struct("<I")


class BundleError(RuntimeError):
    """A bundle failed validation (bad magic, truncation, crc mismatch,
    malformed manifest) — the watcher's reject signal."""


def leaf_signature(leaves: Sequence[np.ndarray]
                   ) -> Tuple[Tuple[Tuple[int, ...], str], ...]:
    """(shape, dtype-string) per leaf — the shape half of the engine's
    abstract signature (``InferenceEngine._key_fields["abstract"]``)."""
    return tuple((tuple(l.shape), str(l.dtype)) for l in leaves)


def write_bundle(path: str, leaves: Sequence[np.ndarray], *,
                 version: int, treedef: str,
                 fingerprint: Dict | None = None) -> dict:
    """Write one bundle file at ``path`` (NOT atomic — the publisher owns
    the tmp+rename dance); returns the manifest written."""
    leaves = [np.ascontiguousarray(l) for l in leaves]
    records = []
    for l in leaves:
        raw = l.tobytes()
        records.append({"shape": list(l.shape), "dtype": str(l.dtype),
                        "nbytes": len(raw), "crc32": zlib.crc32(raw)})
    manifest = {
        "format": FORMAT,
        "version": int(version),
        "treedef": treedef,
        "fingerprint": dict(fingerprint or {}),
        "leaves": records,
    }
    head = json.dumps(manifest).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(_U32.pack(len(head)))
        f.write(head)
        for l in leaves:
            f.write(l.tobytes())
    return manifest


def read_manifest(path: str) -> dict:
    """The manifest alone (no payload read/verify) — what the watcher
    peeks at to decide staleness before paying for the full read."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise BundleError(f"{path}: bad magic {magic!r}")
        raw = f.read(_U32.size)
        if len(raw) != _U32.size:
            raise BundleError(f"{path}: truncated manifest length")
        (n,) = _U32.unpack(raw)
        head = f.read(n)
    if len(head) != n:
        raise BundleError(f"{path}: truncated manifest ({len(head)}/{n} B)")
    try:
        manifest = json.loads(head.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise BundleError(f"{path}: malformed manifest ({e})") from None
    if manifest.get("format") != FORMAT:
        raise BundleError(f"{path}: unknown bundle format "
                          f"{manifest.get('format')!r}")
    return manifest


def read_bundle(path: str) -> Tuple[dict, List[np.ndarray]]:
    """Read and FULLY VERIFY one bundle: every leaf's byte count and
    crc32 must match its manifest record.  Returns (manifest, leaves);
    raises :class:`BundleError` naming the first bad leaf — a torn
    publish is rejected here, before any replica sees it."""
    manifest = read_manifest(path)
    leaves: List[np.ndarray] = []
    with open(path, "rb") as f:
        # Re-skip the header by its on-disk length field, not by
        # re-encoding the manifest (json key order round-trips, but the
        # payload offset must not depend on that).
        f.read(len(MAGIC))
        (n,) = _U32.unpack(f.read(_U32.size))
        f.read(n)
        for i, rec in enumerate(manifest["leaves"]):
            raw = f.read(int(rec["nbytes"]))
            if len(raw) != int(rec["nbytes"]):
                raise BundleError(
                    f"{path}: leaf {i} truncated "
                    f"({len(raw)}/{rec['nbytes']} B)")
            if zlib.crc32(raw) != int(rec["crc32"]):
                raise BundleError(
                    f"{path}: leaf {i} crc32 mismatch (torn or corrupted "
                    f"publish)")
            leaves.append(np.frombuffer(raw, dtype=np.dtype(rec["dtype"]))
                          .reshape(tuple(rec["shape"])))
        if f.read(1):
            raise BundleError(f"{path}: trailing bytes after last leaf")
    return manifest, leaves


def bundle_nbytes(manifest: dict) -> int:
    return sum(int(r["nbytes"]) for r in manifest["leaves"])


# -- the LATEST pointer ------------------------------------------------------


LATEST = "LATEST"


def read_latest(directory: str) -> dict | None:
    """The publish directory's ``LATEST`` pointer ({"version", "file"})
    or None when nothing has been published yet.  A torn pointer raises
    :class:`BundleError` — the pointer is written atomically, so a
    malformed one is a real fault, not a race."""
    path = os.path.join(directory, LATEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        raw = f.read()
    try:
        latest = json.loads(raw)
    except json.JSONDecodeError as e:
        raise BundleError(f"{path}: malformed LATEST pointer ({e})") \
            from None
    if not isinstance(latest, dict) or "version" not in latest \
            or "file" not in latest:
        raise BundleError(f"{path}: LATEST pointer missing version/file")
    return latest
