"""gRPC over the port's own HTTP/2 (``serve/h2.py``, ``serve/hpack.py``):
the transport under the risk, wallet and router servers and every gRPC
client of the port, in pure Python over the standard library, the same
here and on the card's machine, which has no grpcio. It speaks the
protocol grpcio speaks on an insecure channel, so either side talks to
grpcio or grpc-go peers; it exposes the small part of grpcio's surface the
port calls, so call sites read as they did.

Server (``Server``):

- generic handlers keyed ``/<service>/<method>`` (``add_service`` with
  ``unary(fn)`` or ``stream_stream(fn)``); ``fn(request_bytes, context)``
  returns the response bytes (or a message with ``SerializeToString``), a
  stream handler ``fn(request_iterator, context)`` yields them;
- ``add_insecure_port("[::]:<port>")`` returns the bound port (0 picks a
  free one); ``start()``; ``stop(grace)`` returns an event with ``wait()``:
  it closes the listener, sends GOAWAY, lets the streams in flight finish
  within ``grace`` and then cancels the rest;
- threads: one accept thread per listener, one reader thread per
  connection (started by the accept thread), a handler pool of
  ``max_workers`` threads (32 by default, as grpcio's executor), all
  started by ``start()``, so no serving thread ever starts a thread;
- the 5-byte message prefix; a compressed message is refused (INTERNAL:
  no ``grpc-encoding`` is offered); a message over 4 MiB gets
  RESOURCE_EXHAUSTED, an unknown method UNIMPLEMENTED, a call whose
  ``grpc-timeout`` has passed DEADLINE_EXCEEDED, a handler that raises
  UNKNOWN, with grpcio's details for each; ``grpc-status`` and the
  percent-encoded ``grpc-message`` in trailers, a trailers-only response
  for an error;
- ``ServicerContext``: ``invocation_metadata()`` (``-bin`` values
  base64-decoded, padded or not), ``time_remaining()`` (from
  ``grpc-timeout`` in any of its six units; None without one),
  ``set_trailing_metadata()``, ``abort(code, details)``, ``peer()``.

Client (``insecure_channel(target, options)``):

- ``channel.unary_unary(path)`` is a callable ``(request, timeout=,
  metadata=)`` giving the response bytes, with ``.with_call(...)`` and
  ``.future(...)``, whose ``result(timeout)`` raises ``FutureTimeoutError``;
  ``channel.stream_stream(path)`` sends its requests, then returns the
  responses;
- a failed call raises ``RpcError`` with ``code()``, ``details()`` and
  ``trailing_metadata()``; the codes are ``StatusCode``, whose names and
  numbers are grpcio's;
- one thread per channel, started with it, dials and times out futures;
  each connection has its reader thread, started by that thread. A call
  waits while the channel connects; a dead connection turns its calls into
  UNAVAILABLE, and the next call redials at once. A failed dial fails calls
  fast with UNAVAILABLE until the backoff has passed, as grpcio's
  ``grpc.initial_reconnect_backoff_ms``, ``grpc.max_reconnect_backoff_ms``
  (growing 1.6 times a failure, jittered by a fifth) and
  ``grpc.min_reconnect_backoff_ms`` (the least time a dial may take) set
  it.
"""

from __future__ import annotations

import base64
import enum
import heapq
import itertools
import logging
import math
import queue
import random
import socket
import threading
import time

from igaming_platform_tpu_torch.serve import h2

logger = logging.getLogger(__name__)

MAX_MESSAGE = 4 * 1024 * 1024  # grpcio's default receive limit
DEFAULT_MAX_WORKERS = 32
USER_AGENT = "igaming-platform-torch-grpc/1"


class StatusCode(enum.Enum):
    """gRPC status codes: the names and numbers of ``grpc.StatusCode``."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


_CODES = {c.value: c for c in StatusCode}


class RpcError(Exception):
    """A call that ended with a status other than OK."""

    def __init__(self, code: StatusCode, details: str, trailing=(), initial=()):
        super().__init__(f"<RpcError {code.name}: {details}>")
        self._code, self._details = code, details
        self._trailing, self._initial = tuple(trailing), tuple(initial)

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details

    def trailing_metadata(self) -> tuple:
        return self._trailing

    def initial_metadata(self) -> tuple:
        return self._initial


class FutureTimeoutError(Exception):
    """``result(timeout)`` ran out before the call ended."""


class FutureCancelledError(Exception):
    """The future was cancelled."""


# ---------------------------------------------------------------------------
# Metadata, timeouts, status messages

_UNITS = (("n", 1e-9), ("u", 1e-6), ("m", 1e-3), ("S", 1.0), ("M", 60.0), ("H", 3600.0))
_UNIT_SCALE = dict(_UNITS)
# Headers that are the protocol's, not the application's metadata.
_RESERVED = frozenset(("te", "content-type", "grpc-timeout", "grpc-encoding",
                       "grpc-accept-encoding", "grpc-status", "grpc-message",
                       "grpc-status-details-bin", "grpc-previous-rpc-attempts"))


def encode_timeout(seconds: float) -> str:
    """A ``grpc-timeout`` value: at most 8 digits, in the finest unit that
    holds them, rounded up."""
    seconds = max(0.0, seconds)
    for unit, scale in _UNITS:
        value = math.ceil(seconds / scale - 1e-9)
        if value < 100_000_000:
            return f"{max(0, value)}{unit}"
    return "99999999H"


def decode_timeout(value: str) -> float | None:
    """Seconds of a ``grpc-timeout`` value; None if malformed."""
    if not 2 <= len(value) <= 9 or value[-1] not in _UNIT_SCALE or not value[:-1].isdigit():
        return None
    return int(value[:-1]) * _UNIT_SCALE[value[-1]]


def _b64decode(value: str) -> bytes:
    return base64.b64decode(value + "=" * (-len(value) % 4))


def encode_metadata(metadata) -> list[tuple[str, str]]:
    out = []
    for key, value in metadata or ():
        key = key.lower()
        if key.endswith("-bin"):
            raw = value if isinstance(value, (bytes, bytearray)) else str(value).encode()
            value = base64.b64encode(raw).decode().rstrip("=")
        out.append((key, str(value)))
    return out


def decode_metadata(headers) -> tuple:
    out = []
    for key, value in headers:
        if key[0] == ":" or key in _RESERVED:
            continue
        out.append((key, _b64decode(value) if key.endswith("-bin") else value))
    return tuple(out)


def percent_encode(details: str) -> str:
    raw = details.encode("utf-8")
    if all(0x20 <= b <= 0x7e and b != 0x25 for b in raw):
        return details
    return "".join(chr(b) if 0x20 <= b <= 0x7e and b != 0x25 else f"%{b:02X}" for b in raw)


def percent_decode(value: str) -> str:
    if "%" not in value:
        return value
    raw, out, i = value.encode("latin-1"), bytearray(), 0
    while i < len(raw):
        if raw[i] == 0x25 and _is_hex(raw[i + 1:i + 3]):
            out.append(int(raw[i + 1:i + 3], 16))
            i += 3
        else:
            out.append(raw[i])
            i += 1
    return out.decode("utf-8", errors="replace")


def _is_hex(pair: bytes) -> bool:
    return len(pair) == 2 and all(chr(c) in "0123456789abcdefABCDEF" for c in pair)


def _frame_message(payload: bytes) -> bytes:
    return b"\x00" + len(payload).to_bytes(4, "big") + payload


def _as_bytes(resp) -> bytes:
    if isinstance(resp, (bytes, bytearray, memoryview)):
        return bytes(resp)
    return resp.SerializeToString()


def _trailers(code: StatusCode, details: str, trailing) -> list[tuple[str, str]]:
    out = [("grpc-status", str(code.value))]
    if details:
        out.append(("grpc-message", percent_encode(details)))
    out.extend(encode_metadata(trailing))
    return out


class _Reader:
    """Splits a stream's DATA into length-prefixed messages."""

    __slots__ = ("buf",)

    def __init__(self):
        self.buf = bytearray()

    def feed(self, data: bytes) -> list[bytes]:
        """The whole messages ``data`` completes. ValueError(code, details)
        for one over the limit or compressed."""
        if not self.buf and len(data) >= 5:
            n = int.from_bytes(data[1:5], "big")
            if len(data) == 5 + n and not data[0] and n <= MAX_MESSAGE:
                return [data[5:]]
        self.buf += data
        out = []
        while len(self.buf) >= 5:
            n = int.from_bytes(self.buf[1:5], "big")
            if n > MAX_MESSAGE:
                raise ValueError(StatusCode.RESOURCE_EXHAUSTED,
                                 f"Received message larger than max ({n} vs. {MAX_MESSAGE})")
            if self.buf[0]:
                raise ValueError(StatusCode.INTERNAL,
                                 "Compressed message without grpc-encoding")
            if len(self.buf) < 5 + n:
                break
            out.append(bytes(self.buf[5:5 + n]))
            del self.buf[:5 + n]
        return out


# ---------------------------------------------------------------------------
# Server


class _Abort(Exception):
    def __init__(self, code: StatusCode, details: str):
        super().__init__(details)
        self.code, self.details = code, details


def unary(fn):
    """A unary-unary method: ``fn(request_bytes, context)``."""
    return ("unary", fn)


def stream_stream(fn):
    """A stream-stream method: ``fn(request_iterator, context)`` yields the
    responses."""
    return ("stream", fn)


_END = object()
_RESPONSE_HEADERS = ((":status", "200"), ("content-type", "application/grpc"))


class _ServerStream:
    __slots__ = ("sid", "conn", "kind", "fn", "metadata", "deadline", "reader", "requests",
                 "queue", "trailing", "finished", "cancelled", "remote_open", "headers_sent")

    def __init__(self, sid, conn, kind, fn, metadata, deadline):
        self.sid, self.conn, self.kind, self.fn = sid, conn, kind, fn
        self.metadata, self.deadline = metadata, deadline
        self.reader = _Reader()
        self.requests: list[bytes] = []
        self.queue = queue.SimpleQueue() if kind == "stream" else None
        self.trailing: tuple = ()
        self.finished = self.cancelled = self.headers_sent = False
        self.remote_open = True


class ServicerContext:
    """What a handler sees of its call."""

    def __init__(self, stream: _ServerStream):
        self._stream = stream

    def invocation_metadata(self) -> tuple:
        return self._stream.metadata

    def time_remaining(self) -> float | None:
        deadline = self._stream.deadline
        return None if deadline is None else max(0.0, deadline - time.monotonic())

    def set_trailing_metadata(self, metadata) -> None:
        self._stream.trailing = tuple(metadata)

    def abort(self, code: StatusCode, details: str = ""):
        raise _Abort(code, details)

    def peer(self) -> str:
        return self._stream.conn.peer


class _ServerConnection(h2.Connection):
    def __init__(self, server: "Server", sock: socket.socket, peer: str):
        super().__init__(sock, client=False)
        self.server, self.peer = server, peer
        self.streams: dict[int, _ServerStream] = {}
        self._lock = threading.Lock()
        self.goaway_last: int | None = None

    def on_headers(self, sid, headers, end_stream):
        st = self.streams.get(sid)
        if st is not None:  # the request's trailers
            if end_stream:
                self._end_request(st)
            return
        if sid % 2 == 0 or sid <= self.last_peer_stream:
            raise h2.ConnectionError_(h2.PROTOCOL_ERROR, f"stream {sid} reopened or even")
        self.last_peer_stream = sid
        if self.goaway_last is not None and sid > self.goaway_last:
            self.send_control(h2.rst_stream(sid, h2.REFUSED_STREAM))
            return
        path, deadline, encoding = None, None, None
        for key, value in headers:
            if key == ":path":
                path = value
            elif key == "grpc-timeout":
                seconds = decode_timeout(value)
                if seconds is not None:
                    deadline = time.monotonic() + seconds
            elif key == "grpc-encoding":
                encoding = value
        server = self.server
        kind, fn = server._handlers.get(path, (None, None))
        st = _ServerStream(sid, self, kind, fn, decode_metadata(headers), deadline)
        self.streams[sid] = st
        self.open_send_window(sid)
        if not end_stream:
            self.open_recv_window(sid)
        server._stream_started()
        if fn is None:
            self._finish(st, None, StatusCode.UNIMPLEMENTED, "Method not found!")
        elif encoding not in (None, "identity"):
            self._finish(st, None, StatusCode.UNIMPLEMENTED,
                         f"Compression algorithm '{encoding}' is not supported")
        elif kind == "stream":
            server._jobs.put((self._run_stream, st))
        if end_stream:
            self._end_request(st)

    def on_data(self, sid, data, end_stream):
        st = self.streams.get(sid)
        if st is None:
            return
        if not st.finished:
            try:
                messages = st.reader.feed(data)
            except ValueError as exc:
                self._finish(st, None, *exc.args)
                messages = []
            if st.queue is not None:
                for m in messages:
                    st.queue.put(m)
            else:
                st.requests += messages
        if end_stream:
            self._end_request(st)

    def _end_request(self, st: _ServerStream) -> None:
        st.remote_open = False
        if st.finished:
            self._retire(st)
        elif st.kind == "stream":
            st.queue.put(_END)
        elif len(st.requests) != 1 or st.reader.buf:
            self._finish(st, None, StatusCode.INTERNAL,
                         f"Expected one request message, got {len(st.requests)}")
        else:
            self.server._jobs.put((self._run_unary, st))

    def on_reset(self, sid, code):
        st = self.streams.get(sid)
        if st is None:
            return
        st.remote_open = False
        self._cancel(st)

    def on_closed(self, error):
        for st in list(self.streams.values()):
            st.remote_open = False
            self._cancel(st)
        self.server._connection_closed(self)

    def _cancel(self, st: _ServerStream) -> None:
        with self._lock:
            if st.finished:
                return
            st.finished = st.cancelled = True
        if st.queue is not None:
            st.queue.put(_END)
        self._retire(st)

    def cancel_all(self) -> None:
        for st in list(self.streams.values()):
            if not st.finished:
                st.remote_open = False
                self.reset(st.sid, h2.CANCEL)
                self._cancel(st)

    def _expired(self, st: _ServerStream) -> bool:
        return st.deadline is not None and time.monotonic() >= st.deadline

    def _run_unary(self, st: _ServerStream) -> None:
        if st.finished:
            return
        if self._expired(st):
            self._finish(st, None, StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
            return
        context = ServicerContext(st)
        try:
            payload = _as_bytes(st.fn(st.requests[0], context))
        except _Abort as abort:
            self._finish(st, None, abort.code, abort.details, st.trailing)
            return
        except Exception as exc:  # noqa: BLE001 — the call's UNKNOWN, as grpcio reports it
            logger.exception("exception calling %s", st.fn)
            self._finish(st, None, StatusCode.UNKNOWN, f"Exception calling application: {exc}")
            return
        self._finish(st, payload, StatusCode.OK, "", st.trailing)

    def _run_stream(self, st: _ServerStream) -> None:
        context = ServicerContext(st)

        def requests():
            while True:
                item = st.queue.get()
                if item is _END:
                    return
                yield item

        try:
            for resp in st.fn(requests(), context):
                if st.finished:
                    return
                headers = None if st.headers_sent else _RESPONSE_HEADERS
                st.headers_sent = True
                self.send_message(st.sid, headers, _frame_message(_as_bytes(resp)), None,
                                  end_stream=False)
        except _Abort as abort:
            self._finish(st, None, abort.code, abort.details, st.trailing)
            return
        except h2.StreamGone:
            self._cancel(st)
            return
        except Exception as exc:  # noqa: BLE001 — the call's UNKNOWN, as grpcio reports it
            logger.exception("exception iterating %s", st.fn)
            self._finish(st, None, StatusCode.UNKNOWN, f"Exception iterating responses: {exc}")
            return
        self._finish(st, None, StatusCode.OK, "", st.trailing)

    def _finish(self, st: _ServerStream, payload: bytes | None, code: StatusCode, details: str,
                trailing=()) -> None:
        """The call's answer: the response and OK trailers, or a status."""
        with self._lock:
            if st.finished:
                return
            st.finished = True
        if code is StatusCode.OK and self._expired(st):
            payload, code, details, trailing = None, StatusCode.DEADLINE_EXCEEDED, \
                "Deadline Exceeded", ()
        try:
            trailers = _trailers(code, details, trailing)
            if payload is not None:
                self.send_message(st.sid, None if st.headers_sent else _RESPONSE_HEADERS,
                                  _frame_message(payload), trailers)
            elif st.headers_sent:
                self.send_headers(st.sid, trailers, True)
            else:  # trailers-only
                self.send_headers(st.sid, [*_RESPONSE_HEADERS, *trailers], True)
        except h2.StreamGone:
            pass
        finally:
            self._retire(st)

    def _retire(self, st: _ServerStream) -> None:
        if self.streams.pop(st.sid, None) is None:
            return
        if st.remote_open:
            # Answered before the request ended: ask the client to stop
            # sending (RFC 9113 section 8.1).
            self.reset(st.sid, h2.NO_ERROR)
        else:
            self.forget_stream(st.sid)
        self.server._stream_done()
        if self.goaway_last is not None and not self.streams:
            self.close()


def _peer(addr) -> str:
    host, port = addr[0], addr[1]
    if host.startswith("::ffff:") and "." in host:
        return f"ipv4:{host[7:]}:{port}"
    return f"ipv6:[{host}]:{port}" if ":" in host else f"ipv4:{host}:{port}"


def _split_address(address: str) -> tuple[str, int]:
    host, _, port = address.rpartition(":")
    return host.strip("[]"), int(port)


class Server:
    """A gRPC server (see the module docstring)."""

    def __init__(self, max_workers: int = DEFAULT_MAX_WORKERS):
        self.max_workers = max_workers
        self._handlers: dict[str, tuple] = {}
        self._listeners: list[socket.socket] = []
        self._conns: set[_ServerConnection] = set()
        self._cv = threading.Condition()
        self._active = 0
        self._jobs: queue.SimpleQueue = queue.SimpleQueue()
        self._started = False
        self._stopped: threading.Event | None = None

    def add_service(self, service: str, methods: dict) -> None:
        """``methods``: name -> ``unary(fn)`` or ``stream_stream(fn)``."""
        for name, handler in methods.items():
            self._handlers[f"/{service}/{name}"] = handler

    def add_insecure_port(self, address: str) -> int:
        """Listen on ``address`` (``[::]:<port>`` listens on every address,
        IPv4 too); the bound port."""
        host, port = _split_address(address)
        if host in ("", "::", "0.0.0.0"):
            candidates = ([(socket.AF_INET6, ("::", port))] if host != "0.0.0.0" else []) + [
                (socket.AF_INET, ("0.0.0.0", port))]
        else:
            candidates = [(info[0], info[4]) for info in socket.getaddrinfo(
                host, port, type=socket.SOCK_STREAM, flags=socket.AI_PASSIVE)]
        last: OSError | None = None
        for family, addr in candidates:
            sock = socket.socket(family, socket.SOCK_STREAM)
            try:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                if family == socket.AF_INET6:
                    sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_V6ONLY, 0)
                sock.bind(addr)
                sock.listen(128)
            except OSError as exc:
                sock.close()
                last = exc
                continue
            self._listeners.append(sock)
            if self._started:
                self._start_accept(sock)
            return sock.getsockname()[1]
        raise RuntimeError(f"cannot bind {address}: {last}")

    def start(self) -> None:
        """The handler pool, then an accept thread per listener."""
        if self._started:
            return
        self._started = True
        for i in range(self.max_workers):
            threading.Thread(target=self._work, name=f"grpc-worker-{i}", daemon=True).start()
        for sock in self._listeners:
            self._start_accept(sock)

    def _start_accept(self, sock: socket.socket) -> None:
        threading.Thread(target=self._accept, args=(sock,), name="grpc-accept",
                         daemon=True).start()

    def _work(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            fn, arg = job
            try:
                fn(arg)
            except Exception:  # noqa: BLE001 — a worker outlives any one call
                logger.exception("gRPC worker")

    def _accept(self, lsock: socket.socket) -> None:
        while True:
            try:
                sock, addr = lsock.accept()
            except OSError:
                return
            if self._stopped is not None:
                sock.close()
                continue
            try:
                conn = _ServerConnection(self, sock, _peer(addr))
                conn.write(conn.local_settings())
            except (OSError, h2.StreamGone):
                sock.close()
                continue
            with self._cv:
                self._conns.add(conn)
            threading.Thread(target=conn.read_loop, name="grpc-conn", daemon=True).start()

    def _stream_started(self) -> None:
        with self._cv:
            self._active += 1

    def _stream_done(self) -> None:
        with self._cv:
            self._active -= 1
            if self._active <= 0:
                self._cv.notify_all()

    def _connection_closed(self, conn) -> None:
        with self._cv:
            self._conns.discard(conn)
            self._cv.notify_all()

    def stop(self, grace: float | None = None) -> threading.Event:
        """Stop listening, send GOAWAY, let the streams in flight finish
        within ``grace`` seconds, then cancel the rest; the event is set when
        done (at once for a ``grace`` of None or 0)."""
        with self._cv:
            if self._stopped is not None:
                return self._stopped
            self._stopped = threading.Event()
        done = self._stopped
        if not grace:
            self._shutdown(0.0)
        else:
            threading.Thread(target=self._shutdown, args=(grace,), name="grpc-stop",
                             daemon=True).start()
        return done

    def _shutdown(self, grace: float) -> None:
        for sock in self._listeners:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()
        with self._cv:
            conns = list(self._conns)
        # Two GOAWAYs, as RFC 9113 section 6.8 advises: the first (the largest
        # stream id, and a PING) tells the client to open no new stream; the
        # second, once the PING's ACK is back (a round trip later), names the
        # last stream processed, so a call the client sent before it saw the
        # first is served, not refused.
        acks = []
        for conn in conns:
            conn.send_goaway(h2.NO_ERROR, last_stream_id=h2.MAX_WINDOW)
            acks.append(conn.ping(b"goaway\x00\x00"))
        end = time.monotonic() + min(grace, 1.0)
        for acked in acks:
            acked.wait(max(0.0, end - time.monotonic()))
        for conn in conns:
            conn.goaway_last = conn.last_peer_stream
            conn.send_goaway(h2.NO_ERROR)
            if not conn.streams:
                conn.close()
        end = time.monotonic() + grace
        with self._cv:
            while self._active > 0 and time.monotonic() < end:
                self._cv.wait(end - time.monotonic())
            conns = list(self._conns)
        for conn in conns:
            conn.cancel_all()
            conn.close()
        for _ in range(self.max_workers if self._started else 0):
            self._jobs.put(None)
        self._stopped.set()


# ---------------------------------------------------------------------------
# Client

_HTTP_TO_GRPC = {400: StatusCode.INTERNAL, 401: StatusCode.UNAUTHENTICATED,
                 403: StatusCode.PERMISSION_DENIED, 404: StatusCode.UNIMPLEMENTED,
                 429: StatusCode.UNAVAILABLE, 502: StatusCode.UNAVAILABLE,
                 503: StatusCode.UNAVAILABLE, 504: StatusCode.UNAVAILABLE}


class _Call:
    """One client call, and its future."""

    def __init__(self, deserializer, deadline: float | None):
        self._deserializer = deserializer
        self._deadline = deadline
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._callbacks: list = []
        self._code: StatusCode | None = None
        self._details = ""
        self._initial: tuple = ()
        self._trailing: tuple = ()
        self._status: tuple | None = None  # (code, details) of the trailers
        self._messages: list[bytes] = []
        self._reader = _Reader()
        self._headers_seen = False
        self._user_cancelled = False
        self.sid: int | None = None
        self.conn: "_ClientConnection | None" = None

    # -- events from the connection's reader ----------------------------------

    def _on_headers(self, headers, end_stream: bool) -> None:
        if self._headers_seen or end_stream:
            status, message, http = None, "", None
            for key, value in headers:
                if key == "grpc-status":
                    status = int(value) if value.isdigit() else None
                elif key == "grpc-message":
                    message = percent_decode(value)
                elif key == ":status":
                    http = int(value) if value.isdigit() else None
            if status is not None:
                self._status = (_CODES.get(status, StatusCode.UNKNOWN), message)
            elif http not in (None, 200):
                self._status = (_HTTP_TO_GRPC.get(http, StatusCode.UNKNOWN),
                                f"Received http2 header with status: {http}")
            self._trailing = decode_metadata(headers)
        else:
            self._initial = decode_metadata(headers)
        self._headers_seen = True

    def _on_data(self, data: bytes) -> bool:
        """False when the response broke a limit (the call has failed)."""
        try:
            self._messages += self._reader.feed(data)
        except ValueError as exc:
            self._set(*exc.args)
            return False
        return True

    def _on_end(self, unary: bool) -> None:
        if self._status is None:
            self._set(StatusCode.INTERNAL, "Server closed the stream without sending trailers")
        elif self._status[0] is not StatusCode.OK:
            self._set(*self._status, self._trailing)
        elif unary and len(self._messages) != 1:
            self._set(StatusCode.INTERNAL,
                      f"Expected one response message, got {len(self._messages)}")
        else:
            self._set(StatusCode.OK, self._status[1], self._trailing)

    # -- completion --------------------------------------------------------------

    def _set(self, code: StatusCode, details: str, trailing=()) -> bool:
        with self._lock:
            if self._code is not None:
                return False
            self._code, self._details = code, details
            if trailing:
                self._trailing = tuple(trailing)
            callbacks, self._callbacks = self._callbacks, []
        self._event.set()
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — a callback's fault is its own
                logger.exception("gRPC done callback")
        return True

    def _abandon(self, code: StatusCode, details: str) -> bool:
        """End the call here and reset its stream."""
        if not self._set(code, details):
            return False
        conn, sid = self.conn, self.sid
        if conn is not None and sid is not None:
            conn.abandon(sid)
        return True

    def _expire(self) -> None:
        self._abandon(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")

    def _wait(self, timeout: float | None) -> bool:
        end = None if timeout is None else time.monotonic() + timeout
        while not self._event.is_set():
            limit = end
            if self._deadline is not None and (limit is None or self._deadline < limit):
                limit = self._deadline
            now = time.monotonic()
            if limit is not None and now >= limit:
                if self._deadline is not None and now >= self._deadline:
                    self._expire()
                    return True
                return False
            self._event.wait(None if limit is None else limit - now)
        return True

    def _error(self) -> RpcError:
        return RpcError(self._code, self._details, self._trailing, self._initial)

    def _response(self):
        message = self._messages[0]
        return self._deserializer(message) if self._deserializer else message

    # -- the future's surface ------------------------------------------------------

    def result(self, timeout: float | None = None):
        if not self._wait(timeout):
            raise FutureTimeoutError()
        if self._user_cancelled:
            raise FutureCancelledError()
        if self._code is not StatusCode.OK:
            raise self._error()
        return self._response()

    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> bool:
        if self._abandon(StatusCode.CANCELLED, "Locally cancelled by application!"):
            self._user_cancelled = True
            return True
        return False

    def add_done_callback(self, fn) -> None:
        with self._lock:
            if self._code is None:
                self._callbacks.append(fn)
                return
        fn(self)

    def code(self) -> StatusCode | None:
        return self._code

    def details(self) -> str:
        return self._details

    def trailing_metadata(self) -> tuple:
        return self._trailing

    def initial_metadata(self) -> tuple:
        return self._initial


class _ClientConnection(h2.Connection):
    def __init__(self, channel: "Channel", sock: socket.socket):
        super().__init__(sock, client=True)
        self.channel = channel
        self.calls: dict[int, tuple[_Call, bool]] = {}
        self._next_sid = 1

    def start(self, call: _Call, unary: bool, headers, message: bytes | None) -> None:
        """Open a stream for ``call`` (ids go out in order, so the id is
        taken and the HEADERS written under the write lock), then send
        ``message``, which ends a unary call's stream; StreamGone if the
        connection can take no new stream."""
        end = unary
        with self._wlock:
            if self.closed or self.goaway_received is not None:
                raise h2.StreamGone("connection is closing")
            sid = self._next_sid
            if sid > h2.MAX_WINDOW:
                raise h2.StreamGone("stream ids exhausted")
            self._next_sid += 2
            call.sid, call.conn = sid, self
            self.calls[sid] = (call, unary)
            self.open_recv_window(sid)
            with self._flow:
                window = self.peer_initial_window
                whole = message is not None and len(message) <= min(
                    window, self._send_conn_window, self.peer_max_frame)
                self._send_windows[sid] = window - (len(message) if whole else 0)
                if whole:
                    self._send_conn_window -= len(message)
            out = [self._take_ctl(),
                   self.header_frames(sid, headers, end and message is None)]
            if whole:
                out.append(h2.frame(h2.DATA, h2.FLAG_END_STREAM if end else 0, sid, message))
            self._sendall(b"".join(out))
        self._drain_ctl()
        if message is not None and not whole:
            self.send_data(sid, message, end)

    def abandon(self, sid: int) -> None:
        if self.calls.pop(sid, None) is not None:
            self.reset(sid, h2.CANCEL)
        self._maybe_close()

    def _maybe_close(self) -> None:
        if self.goaway_received is not None and not self.calls:
            self.close()

    def on_headers(self, sid, headers, end_stream):
        entry = self.calls.get(sid)
        if entry is None:
            return
        entry[0]._on_headers(headers, end_stream)
        if end_stream:
            self._end(sid)

    def on_data(self, sid, data, end_stream):
        entry = self.calls.get(sid)
        if entry is None:
            return
        if not entry[0]._on_data(data):
            self.abandon(sid)
            return
        if end_stream:
            self._end(sid)

    def _end(self, sid: int) -> None:
        entry = self.calls.pop(sid, None)
        self.forget_stream(sid)
        if entry is not None:
            entry[0]._on_end(entry[1])
        self._maybe_close()

    def on_reset(self, sid, code):
        entry = self.calls.pop(sid, None)
        if entry is None:
            return
        call = entry[0]
        if code == h2.NO_ERROR and call._status is not None:
            call._on_end(entry[1])
        elif code == h2.REFUSED_STREAM:
            call._set(StatusCode.UNAVAILABLE, "Stream refused by the server")
        elif code == h2.CANCEL:
            call._set(StatusCode.CANCELLED, "Received RST_STREAM with error code 8")
        else:
            call._set(StatusCode.INTERNAL, f"Received RST_STREAM with error code {code}")
        self._maybe_close()

    def on_goaway(self, last_stream_id, code, debug):
        for sid in [s for s in self.calls if s > last_stream_id]:
            call = self.calls.pop(sid)[0]
            call._set(StatusCode.UNAVAILABLE, "the server is going away")
        self.channel._drop(self)
        self._maybe_close()

    def on_closed(self, error):
        reason = f"Socket closed ({error})" if error is not None else "Socket closed"
        for sid in list(self.calls):
            entry = self.calls.pop(sid, None)
            if entry is not None:
                entry[0]._set(StatusCode.UNAVAILABLE, reason)
        self.channel._drop(self)


IDLE, CONNECTING, READY, TRANSIENT_FAILURE = "IDLE", "CONNECTING", "READY", "TRANSIENT_FAILURE"


class Channel:
    """A client channel to one target (see the module docstring)."""

    def __init__(self, target: str, options=None):
        opts = dict(options or ())
        self.target = target
        self._host, self._port = _split_address(target)
        self._initial_backoff = opts.get("grpc.initial_reconnect_backoff_ms", 1000) / 1e3
        self._max_backoff = opts.get("grpc.max_reconnect_backoff_ms", 120_000) / 1e3
        self._min_connect = opts.get("grpc.min_reconnect_backoff_ms", 20_000) / 1e3
        self._cv = threading.Condition()
        self._conn: _ClientConnection | None = None
        self.state = IDLE
        self._backoff: float | None = None
        self._next_attempt = 0.0
        self._last_error = ""
        self._attempt = 0
        self._want = False
        self._closed = False
        self._timers: list = []
        self._seq = itertools.count()
        self._rng = random.Random()
        threading.Thread(target=self._run, name=f"grpc-channel {target}", daemon=True).start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- the channel's thread: dials and deadlines --------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while not (self._closed or self._want or self._due()):
                    self._cv.wait(self._timeout())
                if self._closed:
                    return
                expired = []
                now = time.monotonic()
                while self._timers and self._timers[0][0] <= now:
                    expired.append(heapq.heappop(self._timers)[2])
                want = self._want
            for call in expired:
                call._expire()
            if want:
                self._dial()

    def _due(self) -> bool:
        return bool(self._timers) and self._timers[0][0] <= time.monotonic()

    def _timeout(self) -> float | None:
        return None if not self._timers else max(0.0, self._timers[0][0] - time.monotonic())

    def _dial(self) -> None:
        timeout = max(self._min_connect, self._backoff or self._initial_backoff)
        try:
            sock = self._connect(timeout)
        except OSError as exc:
            with self._cv:
                self._backoff = (self._initial_backoff if self._backoff is None
                                 else min(self._backoff * 1.6, self._max_backoff))
                jitter = 1.0 + self._rng.uniform(-0.2, 0.2)
                self._next_attempt = time.monotonic() + self._backoff * jitter
                self._last_error = (f"failed to connect to all addresses; last error: "
                                    f"{self.target}: {exc}")
                self.state = TRANSIENT_FAILURE
                self._want = False
                self._attempt += 1
                self._cv.notify_all()
            return
        conn = _ClientConnection(self, sock)
        try:
            conn.write(h2.PREFACE + conn.local_settings())
        except h2.StreamGone as exc:
            with self._cv:
                self._last_error = str(exc)
                self.state = IDLE
                self._want = False
                self._attempt += 1
                self._cv.notify_all()
            return
        threading.Thread(target=conn.read_loop, name="grpc-client-conn", daemon=True).start()
        with self._cv:
            if self._closed:
                conn.close()
                return
            self._conn = conn
            self.state = READY
            self._backoff = None
            self._want = False
            self._attempt += 1
            self._cv.notify_all()

    def _connect(self, timeout: float) -> socket.socket:
        last: OSError = OSError("no address")
        for family, stype, proto, _, addr in socket.getaddrinfo(self._host, self._port,
                                                                type=socket.SOCK_STREAM):
            sock = socket.socket(family, stype, proto)
            sock.settimeout(timeout)
            try:
                sock.connect(addr)
            except OSError as exc:
                sock.close()
                last = exc
                continue
            sock.settimeout(None)
            return sock
        raise last

    def _drop(self, conn: _ClientConnection) -> None:
        """``conn`` closed or is going away: the next call dials anew."""
        with self._cv:
            if self._conn is conn:
                self._conn = None
                self.state = IDLE

    # -- calls ---------------------------------------------------------------------

    def _connection(self, deadline: float | None) -> _ClientConnection:
        with self._cv:
            attempt = None
            while True:
                if self._closed:
                    raise RpcError(StatusCode.CANCELLED, "Channel closed!")
                conn = self._conn
                if conn is not None and not conn.closed and conn.goaway_received is None:
                    return conn
                if conn is not None:
                    self._conn, self.state = None, IDLE
                now = time.monotonic()
                if self.state == TRANSIENT_FAILURE and (
                        now < self._next_attempt or attempt is not None):
                    raise RpcError(StatusCode.UNAVAILABLE, self._last_error)
                if attempt is not None and self._attempt != attempt and self.state == IDLE:
                    raise RpcError(StatusCode.UNAVAILABLE, self._last_error or "connection lost")
                if self.state != CONNECTING:
                    self.state = CONNECTING
                    self._want = True
                    self._cv.notify_all()
                if attempt is None:
                    attempt = self._attempt
                if deadline is not None and now >= deadline:
                    raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
                self._cv.wait(None if deadline is None else deadline - now)

    def _headers(self, path: str, deadline: float | None, metadata) -> list:
        headers = [(":method", "POST"), (":scheme", "http"), (":path", path),
                   (":authority", self.target), ("te", "trailers"),
                   ("content-type", "application/grpc"), ("user-agent", USER_AGENT)]
        if deadline is not None:
            headers.append(("grpc-timeout", encode_timeout(deadline - time.monotonic())))
        if metadata:
            headers += encode_metadata(metadata)
        return headers

    def _start(self, path: str, unary: bool, payload: bytes | None, timeout, metadata,
               deserializer) -> _Call:
        deadline = None if timeout is None else time.monotonic() + timeout
        call = _Call(deserializer, deadline)
        try:
            conn = self._connection(deadline)
            conn.start(call, unary, self._headers(path, deadline, metadata),
                       None if payload is None else _frame_message(payload))
        except RpcError as exc:
            call._set(exc.code(), exc.details())
        except h2.StreamGone as exc:
            call._set(StatusCode.UNAVAILABLE, str(exc))
        return call

    def _add_timer(self, call: _Call) -> None:
        with self._cv:
            heapq.heappush(self._timers, (call._deadline, next(self._seq), call))
            if self._timers[0][2] is call:
                self._cv.notify_all()

    def unary_unary(self, path: str, request_serializer=None, response_deserializer=None):
        return _UnaryUnary(self, path, request_serializer, response_deserializer)

    def stream_stream(self, path: str, request_serializer=None, response_deserializer=None):
        return _StreamStream(self, path, request_serializer, response_deserializer)

    def close(self) -> None:
        with self._cv:
            if self._closed:
                return
            self._closed = True
            conn, self._conn = self._conn, None
            timers, self._timers = self._timers, []
            self._cv.notify_all()
        if conn is not None:
            for sid in list(conn.calls):
                entry = conn.calls.pop(sid, None)
                if entry is not None:
                    entry[0]._set(StatusCode.CANCELLED, "Channel closed!")
            conn.close()
        for _, _, call in timers:
            call._set(StatusCode.CANCELLED, "Channel closed!")


class _UnaryUnary:
    def __init__(self, channel: Channel, path: str, serializer, deserializer):
        self._channel, self._path = channel, path
        self._serializer, self._deserializer = serializer, deserializer

    def _start(self, request, timeout, metadata) -> _Call:
        payload = self._serializer(request) if self._serializer else bytes(request)
        return self._channel._start(self._path, True, payload, timeout, metadata,
                                    self._deserializer)

    def with_call(self, request, timeout: float | None = None, metadata=None, **_):
        call = self._start(request, timeout, metadata)
        call._wait(None)
        if call._code is not StatusCode.OK:
            raise call._error()
        return call._response(), call

    def __call__(self, request, timeout: float | None = None, metadata=None, **kw):
        return self.with_call(request, timeout, metadata, **kw)[0]

    def future(self, request, timeout: float | None = None, metadata=None, **_) -> _Call:
        call = self._start(request, timeout, metadata)
        if call._deadline is not None and not call.done():
            self._channel._add_timer(call)
        return call


class _StreamStream:
    """Sends every request, then returns the responses."""

    def __init__(self, channel: Channel, path: str, serializer, deserializer):
        self._channel, self._path = channel, path
        self._serializer, self._deserializer = serializer, deserializer

    def __call__(self, request_iterator, timeout: float | None = None, metadata=None, **_):
        call = self._channel._start(self._path, False, None, timeout, metadata, None)
        conn = call.conn
        if conn is not None and not call.done():
            try:
                for request in request_iterator:
                    payload = self._serializer(request) if self._serializer else bytes(request)
                    conn.send_data(call.sid, _frame_message(payload), False)
                conn.send_data(call.sid, b"", True)
            except h2.StreamGone:
                pass  # the call's own status says why
        call._wait(None)
        if call._code is not StatusCode.OK:
            raise call._error()
        return iter([self._deserializer(m) if self._deserializer else m
                     for m in call._messages])


def insecure_channel(target: str, options=None) -> Channel:
    """A channel to ``host:port`` over cleartext HTTP/2."""
    return Channel(target, options)
