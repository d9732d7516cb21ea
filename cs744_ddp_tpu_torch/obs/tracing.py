"""Cross-process trace context + the wire-extension codec -- the
reference package's ``obs/tracing.py``, framework-free and copied
unchanged, so that the port's frames are byte-identical to the
reference's.

A request that crosses process boundaries (client -> frontend ->
scheduler -> replica engine) leaves spans in EACH process's own
``events.jsonl``.  To stitch those into one end-to-end waterfall
(the reference's ``obs/aggregate.py``, which ``tools/trace_waterfall.py``
runs over any run directory) every hop needs a shared identity:

* ``trace_id``        — one 64-bit id for the whole request, minted by
  whichever process sees it first (usually the client).
* ``span_id``         — this hop's own 64-bit id.
* ``parent_span_id``  — the upstream hop's ``span_id`` (0 at the root),
  giving the aggregator the parent/child edges without any global state.
* ``origin``          — a short producer tag (``client``, ``frontend``,
  ``sched``, ...) so orphaned spans remain attributable when a process
  dies mid-request (chaos ``replica_death``).

On the wire the context rides in an OPTIONAL TRAILING EXTENSION BLOCK
appended after the fixed-layout body of the length-prefixed frames
(``serve/frontend.py``).  The block is magic-byte + version gated and
TLV-encoded, so old peers (which validate ``len(body)`` against the
fixed layout only up to the declared payload) never see it, and new
peers skip unknown tags by length — the forward-compat path future
fields ride on.  Encoding with ``ctx=None`` is byte-identical to the
extension-free format: tracing off costs zero wire bytes.
"""

from __future__ import annotations

import random
import struct
from typing import Dict, NamedTuple, Optional, Tuple

# Process-local id source.  SystemRandom: fork-safe and collision-free
# across the N OS processes whose logs the aggregator later merges —
# a seeded RNG would mint the SAME ids in every worker.
_ID_RNG = random.SystemRandom()


def new_id() -> int:
    """A nonzero random 64-bit id (0 is reserved for "no parent")."""
    while True:
        v = _ID_RNG.getrandbits(64)
        if v:
            return v


class TraceContext(NamedTuple):
    """One hop's identity inside a distributed trace (immutable)."""

    trace_id: int
    span_id: int
    parent_span_id: int = 0
    origin: str = ""

    @classmethod
    def new_root(cls, origin: str) -> "TraceContext":
        """Fresh trace: new trace_id, new span_id, no parent."""
        return cls(new_id(), new_id(), 0, origin)

    def child(self, origin: str) -> "TraceContext":
        """The next hop: same trace, new span, parented on this span."""
        return TraceContext(self.trace_id, new_id(), self.span_id, origin)

    def attrs(self) -> Dict[str, object]:
        """Span attributes for ``Telemetry.span``/``span_event`` — the
        join keys ``obs/aggregate.py`` groups and parents by."""
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_span_id": self.parent_span_id,
                "origin": self.origin}


# -- wire extension block ---------------------------------------------------
#
#   magic u8 (0xE1) | version u8 (1) | repeated { tag u8 | len u16 LE |
#   payload[len] }
#
# Unknown tags are skipped by length (forward compat); an unknown
# version or a torn block degrades to "no extension" rather than a
# decode error — tracing must never break serving.

EXT_MAGIC = 0xE1
EXT_VERSION = 1

TAG_TRACE = 1           # <QQQ> trace/span/parent ids + origin utf-8
TAG_SERVER_TIMES = 2    # <dd> t_recv, t_send on the server's clock

_EXT_HEAD = struct.Struct("<BB")
_TLV_HEAD = struct.Struct("<BH")
_TRACE_IDS = struct.Struct("<QQQ")
_TIMES = struct.Struct("<dd")


def pack_ext(fields: Dict[int, bytes]) -> bytes:
    """Encode a tag->payload map as one extension block ('' if empty)."""
    if not fields:
        return b""
    parts = [_EXT_HEAD.pack(EXT_MAGIC, EXT_VERSION)]
    for tag, payload in sorted(fields.items()):
        if len(payload) > 0xFFFF:
            raise ValueError(f"extension field {tag} too large")
        parts.append(_TLV_HEAD.pack(tag, len(payload)))
        parts.append(payload)
    return b"".join(parts)


# Tags this build understands; anything else is a forward-compat skip.
KNOWN_TAGS = frozenset({TAG_TRACE, TAG_SERVER_TIMES})


def unpack_ext_ex(buf: bytes) -> Tuple[Dict[int, bytes], int, int]:
    """Decode an extension block -> ``(fields, skipped_unknown, torn)``.
    Unknown tags are still CARRIED in ``fields`` (skipped by length,
    uninterpreted — a relay must not strip a newer peer's data) but
    counted, as is a torn trailing field (dropped).  A missing or
    unversioned block yields ``({}, 0, 0)``.  Never raises — tracing
    must never break serving."""
    if len(buf) < _EXT_HEAD.size:
        return {}, 0, 0
    magic, version = _EXT_HEAD.unpack_from(buf, 0)
    if magic != EXT_MAGIC or version != EXT_VERSION:
        return {}, 0, 0
    fields: Dict[int, bytes] = {}
    skipped = torn = 0
    off = _EXT_HEAD.size
    while off + _TLV_HEAD.size <= len(buf):
        tag, n = _TLV_HEAD.unpack_from(buf, off)
        off += _TLV_HEAD.size
        if off + n > len(buf):    # torn trailing field — drop it
            torn += 1
            break
        if tag not in KNOWN_TAGS:
            skipped += 1
        fields[tag] = buf[off:off + n]
        off += n
    return fields, skipped, torn


def unpack_ext(buf: bytes) -> Dict[int, bytes]:
    """Decode an extension block, skipping unknown tags; a missing,
    unversioned, or torn block yields ``{}`` (never raises)."""
    return unpack_ext_ex(buf)[0]


def pack_trace(ctx: TraceContext) -> bytes:
    origin = ctx.origin.encode("utf-8")[:255]
    return _TRACE_IDS.pack(ctx.trace_id, ctx.span_id,
                           ctx.parent_span_id) + origin


def unpack_trace(payload: bytes) -> Optional[TraceContext]:
    if len(payload) < _TRACE_IDS.size:
        return None
    trace_id, span_id, parent = _TRACE_IDS.unpack_from(payload, 0)
    if not trace_id:
        return None
    origin = payload[_TRACE_IDS.size:].decode("utf-8", "replace")
    return TraceContext(trace_id, span_id, parent, origin)


def pack_server_times(t_recv: float, t_send: float) -> bytes:
    return _TIMES.pack(t_recv, t_send)


def unpack_server_times(payload: bytes) -> Optional[Tuple[float, float]]:
    if len(payload) < _TIMES.size:
        return None
    return _TIMES.unpack_from(payload, 0)  # type: ignore[return-value]
