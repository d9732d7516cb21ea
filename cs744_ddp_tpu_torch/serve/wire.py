"""Single-source wire-protocol schema table -- the reference package's
``serve/wire.py``, copied: the port speaks the same protocol byte for
byte, so its clients and front-ends interoperate with the reference's.

The serving wire protocol is hand-rolled (``serve/frontend.py``: fixed
little-endian struct headers behind a u32 length prefix, variable
payloads counted by a header field, plus the TLV extension block from
``obs/tracing.py``).  Drift between an encoder and a decoder -- or
between this process and a remote peer built from an older tree -- is
the failure no single test sees: each side round-trips against itself.

This module is the protocol's ONE declarative description.  Everything
here is a plain literal (no ``struct`` objects, no imports from the
codec modules), so ``verify_runtime()`` can cross-check the live codec
constants of the port's ``frontend`` and ``obs.tracing`` against it.
The reference's static extraction of the same table
(``analysis/wire_schema.py``) belongs to the port's static analysis
(ROADMAP queue 1 item 6).  Changing the protocol means changing THIS
file plus the codec.

Versioning: the fixed layouts are frozen (old/new peers interop);
anything new rides the TLV extension block under a fresh tag.  Register
the tag here first.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

SCHEMA_VERSION = 1

# -- framing ----------------------------------------------------------------

LENGTH_PREFIX_FMT = "<I"          # u32 frame length, little-endian

# -- fixed-layout frame headers --------------------------------------------


class FrameSchema(NamedTuple):
    """One fixed-layout frame header + its counted variable payload."""

    name: str                     # "request" / "reply"
    fmt: str                      # struct format of the fixed header
    fields: Tuple[str, ...]       # one name per format code, in order
    count_field: str              # header field counting payload items
    item_bytes: int               # bytes per counted payload item
    ext_ok: bool                  # may carry a trailing extension block


REQUEST = FrameSchema(
    name="request",
    fmt="<IBBdH",
    fields=("req_id", "msg", "tier", "slo_ms", "n"),
    count_field="n",
    item_bytes=32 * 32 * 3,       # one u8 HWC CIFAR image
    ext_ok=True,
)

REPLY = FrameSchema(
    name="reply",
    fmt="<IBBQdddiH",
    fields=("req_id", "status", "reason", "trace", "retry_after_ms",
            "queue_wait_ms", "service_ms", "model_version", "n"),
    count_field="n",
    item_bytes=10 * 4,            # one f32[10] logits row
    ext_ok=True,
)

FRAMES = (REQUEST, REPLY)

MSG_INFER = 1

STATUS_CODES = {"ok": 0, "late": 1, "shed": 2, "overload": 3, "error": 4}
REASON_CODES = {"": 0, "deadline": 1, "predicted_miss": 2, "queue_full": 3,
                "internal": 4}

# -- TLV extension block ----------------------------------------------------

EXT_MAGIC = 0xE1
EXT_VERSION = 1
EXT_HEADER_FMT = "<BB"            # magic u8 | version u8
TLV_HEADER_FMT = "<BH"            # tag u8 | len u16


class TLVSchema(NamedTuple):
    """One registered extension field."""

    tag: int
    name: str
    fmt: str                      # struct format of the fixed prefix
    trailing: str                 # "" or a description of trailing bytes


EXT_FIELDS = (
    TLVSchema(tag=1, name="trace", fmt="<QQQ",
              trailing="origin utf-8 (<= 255 B)"),
    TLVSchema(tag=2, name="server_times", fmt="<dd", trailing=""),
)

# Every struct format a codec module is ALLOWED to own, by constant name
# (the registry the reference's static checker resolves each
# ``struct.Struct("...")`` assignment of the codec sources against).
REGISTERED_FORMATS: Dict[str, str] = {
    "_LEN": LENGTH_PREFIX_FMT,
    "_REQ": REQUEST.fmt,
    "_REP": REPLY.fmt,
    "_EXT_HEAD": EXT_HEADER_FMT,
    "_TLV_HEAD": TLV_HEADER_FMT,
    "_TRACE_IDS": EXT_FIELDS[0].fmt,
    "_TIMES": EXT_FIELDS[1].fmt,
}

# Registered TAG_* constants, by name.
REGISTERED_TAGS: Dict[str, int] = {
    "TAG_TRACE": EXT_FIELDS[0].tag,
    "TAG_SERVER_TIMES": EXT_FIELDS[1].tag,
}


def schema_summary() -> dict:
    """JSON-ready schema description."""
    return {
        "schema_version": SCHEMA_VERSION,
        "length_prefix": LENGTH_PREFIX_FMT,
        "frames": [{"name": f.name, "fmt": f.fmt, "fields": list(f.fields),
                    "count_field": f.count_field,
                    "item_bytes": f.item_bytes} for f in FRAMES],
        "ext": {"magic": EXT_MAGIC, "version": EXT_VERSION,
                "fields": [{"tag": t.tag, "name": t.name, "fmt": t.fmt,
                            "trailing": t.trailing} for t in EXT_FIELDS]},
        "status_codes": dict(STATUS_CODES),
        "reason_codes": dict(REASON_CODES),
    }


def verify_runtime() -> List[str]:
    """Cross-check the LIVE codec constants (the port's ``frontend`` and
    ``obs.tracing``) against this table; returns mismatch descriptions
    ([] = clean)."""
    from ..obs import tracing
    from . import frontend

    problems: List[str] = []

    def chk(what: str, got, want) -> None:
        if got != want:
            problems.append(f"{what}: runtime {got!r} != schema {want!r}")

    chk("request fmt", frontend._REQ.format, REQUEST.fmt)
    chk("reply fmt", frontend._REP.format, REPLY.fmt)
    chk("length prefix", frontend._LEN.format, LENGTH_PREFIX_FMT)
    chk("image bytes", frontend.IMAGE_BYTES, REQUEST.item_bytes)
    chk("MSG_INFER", frontend.MSG_INFER, MSG_INFER)
    chk("status codes", frontend.STATUS_CODES, STATUS_CODES)
    chk("reason codes", frontend.REASON_CODES, REASON_CODES)
    chk("ext magic", tracing.EXT_MAGIC, EXT_MAGIC)
    chk("ext version", tracing.EXT_VERSION, EXT_VERSION)
    chk("ext header fmt", tracing._EXT_HEAD.format, EXT_HEADER_FMT)
    chk("tlv header fmt", tracing._TLV_HEAD.format, TLV_HEADER_FMT)
    chk("TAG_TRACE", tracing.TAG_TRACE, REGISTERED_TAGS["TAG_TRACE"])
    chk("TAG_SERVER_TIMES", tracing.TAG_SERVER_TIMES,
        REGISTERED_TAGS["TAG_SERVER_TIMES"])
    chk("trace payload fmt", tracing._TRACE_IDS.format, EXT_FIELDS[0].fmt)
    chk("times payload fmt", tracing._TIMES.format, EXT_FIELDS[1].fmt)
    return problems
