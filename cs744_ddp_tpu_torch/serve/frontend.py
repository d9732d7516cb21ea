"""Socket front-end: length-prefixed binary protocol over TCP -- the
reference package's ``serve/frontend.py``, framework-free and copied, so
that every frame is byte-identical to the reference's and either
package's client talks to either package's front-end.

Wire format (all little-endian, u32 frame-length prefix per message):

* request  = ``<IBBdH`` header (req_id u32, msg u8 = 1, tier u8,
  slo_ms f64 — <= 0 means no deadline, n u16) + n x 3072 raw u8 bytes
  (n CIFAR images, HWC 32x32x3).
* reply    = ``<IBBQdddiH`` header (req_id u32, status u8, reason u8,
  trace u64, retry_after_ms f64, queue_wait_ms f64, service_ms f64,
  model_version i32 — the engine weights version that served the
  request (publish/ hot-swap A/B pin), -1 when it never reached a
  dispatch, n u16) + n x 10 f32 logits when status is ok/late.

Both frames may carry an OPTIONAL TRAILING EXTENSION BLOCK
(``obs/tracing.py``: magic+version byte then TLV fields, unknown tags
skipped by length).  Requests use it for the distributed
``TraceContext``; replies for the server's recv/send timestamps (the
client side of clock-skew estimation).  Encoding without a context is
byte-identical to the extension-free format, and the decoders accept
extension-free frames — old and new peers mix freely in either
direction; trailing bytes that are NOT a versioned extension block
still fail decode (torn frames must not pass silently).

Statuses: 0 ok, 1 late (served past deadline), 2 shed, 3 overload
(rejected at admission — ``retry_after_ms`` carries the backpressure
hint), 4 error.  Every request gets exactly one reply; replies are
written as each Future resolves, so they can return OUT OF ORDER —
clients match on ``req_id``.

A decoded request's images are a read-only view of the frame
(``np.frombuffer``).  The scheduler's batch assembly copies them
(``np.concatenate``) and the engine's staging copies that into its
pinned arena, so no tensor is ever made over the frame itself.

``ServingFrontend`` serves any backend exposing
``submit(images, labels=None, *, tier, slo_ms) -> Future[Reply]`` and
raising ``QueueFull`` — an ``SLOScheduler``, a ``ReplicaRouter``, or a
stub.  ``FrontendClient`` (socket) and ``LoopbackClient`` (in-process,
same reply dicts) are the two client shapes tests and the load
driver (``serve/load.py``) drive.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs import NULL
from ..obs.tracing import (TAG_SERVER_TIMES, TAG_TRACE, TraceContext,
                           pack_ext, pack_server_times, pack_trace,
                           unpack_ext_ex, unpack_server_times, unpack_trace)
from .batcher import QueueFull

IMAGE_BYTES = 32 * 32 * 3
MSG_INFER = 1

_LEN = struct.Struct("<I")
_REQ = struct.Struct("<IBBdH")
_REP = struct.Struct("<IBBQdddiH")

STATUS_CODES = {"ok": 0, "late": 1, "shed": 2, "overload": 3, "error": 4}
STATUS_NAMES = {v: k for k, v in STATUS_CODES.items()}
REASON_CODES = {"": 0, "deadline": 1, "predicted_miss": 2, "queue_full": 3,
                "internal": 4}
REASON_NAMES = {v: k for k, v in REASON_CODES.items()}

# 4 KiB of slack past the fixed layout for trailing extension blocks.
MAX_FRAME = _REQ.size + 65535 * IMAGE_BYTES + 4096


# -- codec ------------------------------------------------------------------


def _split_ext(body: bytes, fixed: int, what: str,
               telemetry=None) -> Tuple[bytes, dict]:
    """Split a frame body into (fixed-layout bytes, decoded extension
    fields).  Trailing bytes must be a versioned extension block
    (``unpack_ext_ex`` magic-gates them) — anything else is a torn frame
    and still fails decode, exactly as the pre-extension codec did.
    Unknown tags and dropped torn fields are counted into the
    ``wire_ext_skipped`` counter when a telemetry sink is supplied —
    a newer peer's fields silently falling on the floor is exactly the
    cross-version drift the operator needs to see."""
    if len(body) < fixed:
        raise ValueError(f"{what} body {len(body)} B < {fixed} B")
    tail = body[fixed:]
    if not tail:
        return body, {}
    fields, skipped, torn = unpack_ext_ex(tail)
    if not fields:
        raise ValueError(f"{what} body {len(body)} B != {fixed} B "
                         "(trailing bytes are not an extension block)")
    if (skipped or torn) and telemetry is not None \
            and getattr(telemetry, "enabled", False):
        telemetry.counter("wire_ext_skipped", skipped + torn,
                          unknown=skipped, torn=torn, frame=what)
    return body[:fixed], fields


def encode_request(req_id: int, images: np.ndarray, *, tier: int = 0,
                   slo_ms: Optional[float] = None,
                   ctx: Optional[TraceContext] = None) -> bytes:
    images = np.ascontiguousarray(images, np.uint8)
    n = int(images.shape[0])
    if not 0 < n <= 65535:
        raise ValueError(f"bad request size {n}")
    slo = -1.0 if slo_ms is None else float(slo_ms)
    ext = b"" if ctx is None else pack_ext({TAG_TRACE: pack_trace(ctx)})
    return _REQ.pack(req_id & 0xFFFFFFFF, MSG_INFER, int(tier) & 0xFF,
                     slo, n) + images.tobytes() + ext


def decode_request_ex(payload: bytes, telemetry=None
                      ) -> Tuple[int, np.ndarray, int, Optional[float],
                                 Optional[TraceContext]]:
    """Decode a request frame -> (req_id, images, tier, slo_ms, ctx).
    ``ctx`` is None for extension-free (old-client) frames."""
    if len(payload) < _REQ.size:
        raise ValueError(f"short request frame ({len(payload)} B)")
    req_id, msg, tier, slo, n = _REQ.unpack_from(payload)
    if msg != MSG_INFER:
        raise ValueError(f"unknown message type {msg}")
    body, fields = _split_ext(payload[_REQ.size:], n * IMAGE_BYTES,
                              "request", telemetry)
    images = np.frombuffer(body, np.uint8).reshape(n, 32, 32, 3)
    ctx = unpack_trace(fields[TAG_TRACE]) if TAG_TRACE in fields else None
    return req_id, images, tier, (None if slo <= 0 else slo), ctx


def decode_request(payload: bytes
                   ) -> Tuple[int, np.ndarray, int, Optional[float]]:
    """The extension-free 4-tuple surface (extension fields tolerated and
    dropped)."""
    req_id, images, tier, slo_ms, _ctx = decode_request_ex(payload)
    return req_id, images, tier, slo_ms


def encode_reply(req_id: int, reply, *, t_recv: Optional[float] = None,
                 t_send: Optional[float] = None) -> bytes:
    """``reply`` is a ``scheduler.Reply`` or an equivalent dict."""
    get = reply.get if isinstance(reply, dict) else \
        lambda k, d=None: getattr(reply, k, d)
    status = STATUS_CODES[get("status")]
    logits = get("logits")
    blob = b""
    n = 0
    if logits is not None and status in (0, 1):
        logits = np.ascontiguousarray(logits, np.float32)
        n = int(logits.shape[0])
        blob = logits.tobytes()
    reason = get("reason") or ""
    rcode = REASON_CODES.get(reason.split(":")[0],
                             REASON_CODES["internal"] if reason else 0)
    mv = get("model_version")
    ext = b"" if t_recv is None or t_send is None else \
        pack_ext({TAG_SERVER_TIMES: pack_server_times(t_recv, t_send)})
    return _REP.pack(req_id & 0xFFFFFFFF, status, rcode,
                     int(get("trace") or 0), float(get("retry_after_ms") or 0.0),
                     float(get("queue_wait_ms") or 0.0),
                     float(get("service_ms") or 0.0),
                     -1 if mv is None else int(mv), n) + blob + ext


def decode_reply(payload: bytes, telemetry=None) -> dict:
    if len(payload) < _REP.size:
        raise ValueError(f"short reply frame ({len(payload)} B)")
    req_id, status, rcode, trace, retry, qw, svc, mv, n = \
        _REP.unpack_from(payload)
    body, fields = _split_ext(payload[_REP.size:], n * 40, "reply",
                              telemetry)
    logits = None
    if n:
        logits = np.frombuffer(body, np.float32).reshape(n, 10).copy()
    rep = {"req_id": req_id, "status": STATUS_NAMES.get(status, "error"),
           "reason": REASON_NAMES.get(rcode, "internal"), "trace": trace,
           "retry_after_ms": retry, "queue_wait_ms": qw, "service_ms": svc,
           "model_version": mv, "logits": logits}
    if TAG_SERVER_TIMES in fields:
        times = unpack_server_times(fields[TAG_SERVER_TIMES])
        if times is not None:
            rep["t_recv"], rep["t_send"] = times
    return rep


def reply_to_dict(reply) -> dict:
    """Normalize a ``scheduler.Reply`` to the client-side reply dict."""
    return {"req_id": None, "status": reply.status, "reason": reply.reason,
            "trace": reply.trace, "retry_after_ms": reply.retry_after_ms,
            "queue_wait_ms": reply.queue_wait_ms,
            "service_ms": reply.service_ms,
            "model_version": getattr(reply, "model_version", -1),
            "logits": reply.logits}


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def read_frame(sock: socket.socket) -> Optional[bytes]:
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (length,) = _LEN.unpack(head)
    if length > MAX_FRAME:
        raise ValueError(f"frame of {length} B exceeds {MAX_FRAME}")
    return _recv_exact(sock, length)


def write_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


# -- server -----------------------------------------------------------------


class ServingFrontend:
    """Threaded acceptor feeding the admission queue.

    One thread per connection; replies are written from Future
    done-callbacks under a per-connection send lock (the scheduler's
    worker resolves Futures out of admission order).  ``QueueFull`` at
    admission becomes an overload reply carrying the backpressure
    retry-after hint; any other admission failure becomes an explicit
    error reply — the no-silent-drop contract extends to the wire.
    """

    _lock_owned = ("_conns", "_threads", "_running")

    def __init__(self, backend, *, host: str = "127.0.0.1", port: int = 0,
                 telemetry=None):
        self.backend = backend
        self.telemetry = telemetry if telemetry is not None else NULL
        self._host = host
        self._port = port
        self._listener: Optional[socket.socket] = None
        self._acceptor: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._conns: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        self._running = False

    @property
    def address(self) -> Tuple[str, int]:
        if self._listener is None:
            raise RuntimeError("frontend not started")
        return self._listener.getsockname()[:2]

    def start(self) -> "ServingFrontend":
        if self._listener is not None:
            raise RuntimeError("frontend already started")
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self._host, self._port))
        ls.listen(64)
        self._listener = ls
        with self._lock:
            self._running = True
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          name="serve-accept", daemon=True)
        self._acceptor.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._running = False
            conns = list(self._conns)
            threads = list(self._threads)
        if self._listener is not None:
            # Closing a listening socket does not wake a thread blocked in
            # its accept() on Linux; shutting it down does (the acceptor's
            # join then returns at once, not at its timeout).
            for end in (lambda: self._listener.shutdown(socket.SHUT_RDWR),
                        self._listener.close):
                try:
                    end()
                except OSError:
                    pass
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self._acceptor is not None:
            self._acceptor.join(timeout=5.0)
            self._acceptor = None
        for t in threads:
            t.join(timeout=5.0)
        with self._lock:
            self._conns = []
            self._threads = []
        self._listener = None

    def __enter__(self) -> "ServingFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return           # listener closed by stop()
            with self._lock:
                if not self._running:
                    conn.close()
                    return
                t = threading.Thread(target=self._serve_conn, args=(conn,),
                                     name="serve-conn", daemon=True)
                self._conns.append(conn)
                self._threads.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        tel = self.telemetry
        send_lock = threading.Lock()
        try:
            while True:
                try:
                    payload = read_frame(conn)
                except (OSError, ValueError):
                    return
                if payload is None:
                    return
                t_recv = time.time()
                try:
                    req_id, images, tier, slo_ms, ctx = \
                        decode_request_ex(payload, tel)
                except ValueError:
                    return       # malformed frame: drop the connection
                # The frontend hop's own context: child of the client's
                # when the request carried one, else a fresh root (old
                # clients stay traceable server-side).  NULL recorder ->
                # no context, no allocations.
                sctx = None
                if tel.enabled:
                    sctx = ctx.child("frontend") if ctx is not None \
                        else TraceContext.new_root("frontend")
                    tel.span_event("wire_decode", t_recv,
                                   time.time() - t_recv,
                                   **sctx.child("frontend").attrs())
                try:
                    if sctx is not None:
                        fut = self.backend.submit(images, tier=tier,
                                                  slo_ms=slo_ms, ctx=sctx)
                    else:
                        fut = self.backend.submit(images, tier=tier,
                                                  slo_ms=slo_ms)
                except QueueFull as e:
                    if tel.enabled:
                        tel.counter("frontend_overload", tier=tier)
                    self._reply_now(conn, send_lock, req_id, {
                        "status": "overload", "reason": "queue_full",
                        "retry_after_ms": getattr(e, "retry_after_ms", 0.0),
                    }, t_recv=t_recv, ctx=sctx)
                    continue
                except (RuntimeError, ValueError) as e:
                    self._reply_now(conn, send_lock, req_id, {
                        "status": "error", "reason": "internal",
                    }, t_recv=t_recv, ctx=sctx)
                    del e
                    continue
                if tel.enabled:
                    tel.counter("frontend_accepted", tier=tier)
                fut.add_done_callback(
                    lambda f, rid=req_id, lk=send_lock, c=conn, tr=t_recv,
                    sc=sctx: self._on_reply(c, lk, rid, f, t_recv=tr,
                                            ctx=sc))
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _on_reply(self, conn, send_lock, req_id: int, fut, *,
                  t_recv: Optional[float] = None, ctx=None) -> None:
        try:
            reply = fut.result()
        except Exception:
            reply = {"status": "error", "reason": "internal"}
        self._reply_now(conn, send_lock, req_id, reply,
                        t_recv=t_recv, ctx=ctx)

    def _reply_now(self, conn, send_lock, req_id: int, reply, *,
                   t_recv: Optional[float] = None, ctx=None) -> None:
        """Encode + send one reply; when traced, stamp the server's
        recv/send window into the wire extension AND emit the
        ``frontend_request`` span the skew estimator matches against
        the client's ``trace_client`` span."""
        tel = self.telemetry
        if ctx is None or not tel.enabled:
            self._send(conn, send_lock, encode_reply(req_id, reply))
            return
        t0 = time.time()
        payload = encode_reply(req_id, reply, t_recv=t_recv, t_send=t0)
        tel.span_event("reply_encode", t0, time.time() - t0,
                       **ctx.child("frontend").attrs())
        self._send(conn, send_lock, payload)
        get = reply.get if isinstance(reply, dict) else \
            lambda k, d=None: getattr(reply, k, d)
        attrs = ctx.attrs()
        if get("trace"):
            attrs["trace"] = get("trace")
        attrs["status"] = get("status")
        tel.span_event("frontend_request", t_recv,
                       time.time() - t_recv, **attrs)

    @staticmethod
    def _send(conn, send_lock, payload: bytes) -> None:
        try:
            with send_lock:
                write_frame(conn, payload)
        except OSError:
            pass                 # client went away; reply is undeliverable


# -- clients ----------------------------------------------------------------


def _trace_client_reply(tel, ctx: TraceContext, t1: float, fut) -> None:
    """Future done-callback: emit the client round-trip span (t1..t4 on
    the CLIENT clock) carrying the trace context plus whatever join keys
    the reply brought back (batcher trace id, server recv/send times)."""
    try:
        rep = fut.result()
    except Exception:
        rep = None
    t4 = time.time()
    attrs = ctx.attrs()
    if isinstance(rep, dict):
        if rep.get("trace"):
            attrs["trace"] = rep["trace"]
        if "t_recv" in rep:
            attrs["server_t_recv"] = rep["t_recv"]
            attrs["server_t_send"] = rep["t_send"]
        attrs["status"] = rep.get("status")
    tel.span_event("trace_client", t1, t4 - t1, **attrs)


class FrontendClient:
    """Socket client: pipelined submits, replies matched by ``req_id``
    from a reader thread; each submit returns a Future of a reply dict."""

    _lock_owned = ("_futs", "_next_id")

    def __init__(self, address: Tuple[str, int], *, timeout: float = 60.0,
                 telemetry=None):
        self.timeout = timeout
        self.telemetry = telemetry if telemetry is not None else NULL
        self._sock = socket.create_connection(address, timeout=timeout)
        self._lock = threading.Lock()
        self._futs: Dict[int, Future] = {}
        self._next_id = 1
        self._reader = threading.Thread(target=self._read_loop,
                                        name="serve-client", daemon=True)
        self._reader.start()

    def submit(self, images, *, tier: int = 0,
               slo_ms: Optional[float] = None) -> Future:
        fut = Future()
        tel = self.telemetry
        # A telemetry-carrying client is a TRACING client: it mints the
        # root context every downstream hop parents under and records
        # the t1..t4 round-trip the skew estimator pairs with the
        # server's frontend_request window.
        ctx = TraceContext.new_root("client") if tel.enabled else None
        with self._lock:
            req_id = self._next_id
            self._next_id += 1
            self._futs[req_id] = fut
        t1 = time.time()
        try:
            write_frame(self._sock, encode_request(req_id, images,
                                                   tier=tier, slo_ms=slo_ms,
                                                   ctx=ctx))
        except OSError as e:
            with self._lock:
                self._futs.pop(req_id, None)
            raise ConnectionError(f"frontend connection lost: {e}") from e
        if ctx is not None:
            fut.add_done_callback(
                lambda f, c=ctx, t0=t1: _trace_client_reply(tel, c, t0, f))
        return fut

    def request(self, images, *, tier: int = 0,
                slo_ms: Optional[float] = None) -> dict:
        return self.submit(images, tier=tier, slo_ms=slo_ms) \
            .result(timeout=self.timeout)

    def _read_loop(self) -> None:
        while True:
            try:
                payload = read_frame(self._sock)
            except (OSError, ValueError):
                payload = None
            if payload is None:
                break
            try:
                reply = decode_reply(payload, self.telemetry)
            except ValueError:
                break
            with self._lock:
                fut = self._futs.pop(reply["req_id"], None)
            if fut is not None and not fut.done():
                fut.set_result(reply)
        with self._lock:
            dangling = list(self._futs.values())
            self._futs = {}
        for fut in dangling:
            if not fut.done():
                fut.set_result({"req_id": None, "status": "error",
                                "reason": "internal", "trace": 0,
                                "retry_after_ms": 0.0, "queue_wait_ms": 0.0,
                                "service_ms": 0.0, "model_version": -1,
                                "logits": None})

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._reader.join(timeout=5.0)

    def __enter__(self) -> "FrontendClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class LoopbackClient:
    """In-process client with the same submit/reply-dict surface as
    ``FrontendClient`` — what bench and the demo replay drive when no
    socket is wanted.  Overload is returned as a reply dict (like the
    wire does), not raised."""

    def __init__(self, backend, *, telemetry=None):
        self.backend = backend
        self.telemetry = telemetry if telemetry is not None else NULL

    def submit(self, images, *, tier: int = 0,
               slo_ms: Optional[float] = None) -> Future:
        tel = self.telemetry
        ctx = TraceContext.new_root("client") if tel.enabled else None
        t1 = time.time()
        try:
            if ctx is not None:
                fut = self.backend.submit(images, tier=tier, slo_ms=slo_ms,
                                          ctx=ctx.child("frontend"))
            else:
                fut = self.backend.submit(images, tier=tier, slo_ms=slo_ms)
        except QueueFull as e:
            done = Future()
            done.set_result({"req_id": None, "status": "overload",
                             "reason": "queue_full", "trace": 0,
                             "retry_after_ms": getattr(e, "retry_after_ms",
                                                       0.0),
                             "queue_wait_ms": 0.0, "service_ms": 0.0,
                             "model_version": -1, "logits": None})
            return done
        except (RuntimeError, ValueError) as e:
            done = Future()
            done.set_result({"req_id": None, "status": "error",
                             "reason": f"internal: {e}", "trace": 0,
                             "retry_after_ms": 0.0, "queue_wait_ms": 0.0,
                             "service_ms": 0.0, "model_version": -1,
                             "logits": None})
            return done
        out = Future()
        fut.add_done_callback(
            lambda f: out.set_result(reply_to_dict(f.result())))
        if ctx is not None:
            out.add_done_callback(
                lambda f, c=ctx, t0=t1: _trace_client_reply(tel, c, t0, f))
        return out

    def request(self, images, *, tier: int = 0,
                slo_ms: Optional[float] = None) -> dict:
        return self.submit(images, tier=tier, slo_ms=slo_ms).result()

    def close(self) -> None:
        pass
