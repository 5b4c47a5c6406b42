"""HTTP/2 framing and connection state (RFC 9113), cleartext with prior
knowledge, as grpcio's ``insecure_channel`` speaks it: the layer under the
port's gRPC transport (``serve/grpc_wire.py``).

``Connection`` owns one socket (``TCP_NODELAY`` set) and is shared by the
client and server sides; a subclass receives the streams' events through
``on_headers``, ``on_data``, ``on_reset``, ``on_goaway`` and ``on_closed``,
all called on the connection's one reader thread (``read_loop``). It
handles the rest itself:

- the client preface, SETTINGS and their ACK, PING and its ACK;
- HEADERS with CONTINUATION, the PADDED and PRIORITY flags honoured, one
  HPACK decoder (``serve/hpack.py``) for the connection, fed every header
  block in order, and one encoder;
- DATA with padding; RST_STREAM; GOAWAY, sent with the last stream the
  peer opened;
- both flow-control windows in both directions. A sender blocks in
  ``send_data`` until the peer's connection and stream windows admit a
  chunk, in frames no larger than the peer's SETTINGS_MAX_FRAME_SIZE; the
  reader credits WINDOW_UPDATE and SETTINGS_INITIAL_WINDOW_SIZE changes
  and wakes it. As a receiver the connection announces RECV_WINDOW for
  each stream and RECV_CONNECTION_WINDOW for itself, and sends a
  WINDOW_UPDATE whenever half a window has been consumed; a peer that
  overruns a window gets FLOW_CONTROL_ERROR.

Frames go out under one write lock. The reader never waits for it: the
frames it owes the peer (SETTINGS and PING ACKs, WINDOW_UPDATEs, resets)
queue as control frames, and whichever thread holds or next takes the lock
sends them first, so a reader is never blocked behind a writer that is
itself waiting for the peer to read.
"""

from __future__ import annotations

import socket
import struct
import threading

from igaming_platform_tpu_torch.serve.hpack import Decoder, Encoder, HpackError

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, GOAWAY, WINDOW_UPDATE, \
    CONTINUATION = range(10)
FLAG_END_STREAM = 0x1
FLAG_ACK = 0x1
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

SETTINGS_HEADER_TABLE_SIZE = 0x1
SETTINGS_ENABLE_PUSH = 0x2
SETTINGS_MAX_CONCURRENT_STREAMS = 0x3
SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5
SETTINGS_MAX_HEADER_LIST_SIZE = 0x6

NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR, SETTINGS_TIMEOUT, STREAM_CLOSED, \
    FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL, COMPRESSION_ERROR = range(10)

DEFAULT_WINDOW = 65_535
DEFAULT_MAX_FRAME = 16_384
MAX_WINDOW = (1 << 31) - 1
# What this side announces: a stream window of 8 MiB (above gRPC's 4 MiB
# message limit, so a peer sends a whole message without waiting for a
# WINDOW_UPDATE), a connection window of 64 MiB, frames of up to 16 MiB.
RECV_WINDOW = 1 << 23
RECV_CONNECTION_WINDOW = 1 << 26
RECV_MAX_FRAME = (1 << 24) - 1
MAX_HEADER_BLOCK = 1 << 20

_HEAD = struct.Struct(">BHBBI")


class ConnectionError_(Exception):
    """A connection error: the connection ends with GOAWAY(code)."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class StreamGone(Exception):
    """The stream (or its connection) closed while a sender waited."""


def frame(ftype: int, flags: int, stream_id: int, payload: bytes = b"") -> bytes:
    n = len(payload)
    return _HEAD.pack(n >> 16, n & 0xffff, ftype, flags, stream_id) + payload


def settings_frame(pairs) -> bytes:
    return frame(SETTINGS, 0, 0, b"".join(struct.pack(">HI", k, v) for k, v in pairs))


def window_update(stream_id: int, increment: int) -> bytes:
    return frame(WINDOW_UPDATE, 0, stream_id, struct.pack(">I", increment))


def rst_stream(stream_id: int, code: int) -> bytes:
    return frame(RST_STREAM, 0, stream_id, struct.pack(">I", code))


def goaway(last_stream_id: int, code: int, debug: bytes = b"") -> bytes:
    return frame(GOAWAY, 0, 0, struct.pack(">II", last_stream_id, code) + debug)


def tune_socket(sock: socket.socket) -> None:
    """TCP_NODELAY: a small frame must not wait for a delayed ACK."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class Connection:
    """One HTTP/2 connection over a connected socket (see the module
    docstring). ``client`` picks the side: the client writes the preface,
    the server reads it."""

    def __init__(self, sock: socket.socket, client: bool):
        tune_socket(sock)
        self.sock = sock
        self.client = client
        self._rfile = sock.makefile("rb", buffering=1 << 16)
        self._wlock = threading.Lock()
        self._ctl: list[bytes] = []
        self._ctl_lock = threading.Lock()  # never held across a wait
        self._encoder = Encoder()
        self._decoder = Decoder()
        # Send side: the peer's windows and frame size.
        self._flow = threading.Condition()
        self.peer_max_frame = DEFAULT_MAX_FRAME
        self.peer_initial_window = DEFAULT_WINDOW
        self._send_conn_window = DEFAULT_WINDOW
        self._send_windows: dict[int, int] = {}
        # Receive side: what is left of the windows announced, and what was
        # consumed since the last WINDOW_UPDATE.
        self._recv_conn_left = RECV_CONNECTION_WINDOW
        self._recv_conn_unacked = 0
        self._recv: dict[int, list[int]] = {}  # stream -> [left, unacked]
        self.closed = False
        self.last_peer_stream = 0  # the highest stream id the peer opened
        self.goaway_received: int | None = None  # last stream id of the peer's GOAWAY
        self.goaway_sent = False
        self._pings: dict[bytes, threading.Event] = {}  # PINGs sent, by payload

    # -- writing -------------------------------------------------------------

    def _take_ctl(self) -> bytes:
        if not self._ctl:
            return b""
        with self._ctl_lock:
            ctl, self._ctl = self._ctl, []
        return b"".join(ctl)

    def _drain_ctl(self) -> None:
        while self._ctl and self._wlock.acquire(blocking=False):
            try:
                ctl = self._take_ctl()
                if ctl:
                    self._sendall(ctl)
            finally:
                self._wlock.release()

    def _sendall(self, data: bytes) -> None:
        try:
            self.sock.sendall(data)
        except OSError as exc:
            self.close()
            raise StreamGone(f"connection lost: {exc}") from exc

    def send_control(self, data: bytes) -> None:
        """A frame the reader owes the peer: sent now if the write lock is
        free, else by its holder."""
        with self._ctl_lock:
            self._ctl.append(data)
        try:
            self._drain_ctl()
        except StreamGone:
            pass

    def write(self, data: bytes) -> None:
        """Frames, after any control frames queued."""
        with self._wlock:
            self._sendall(self._take_ctl() + data)
        self._drain_ctl()

    def header_frames(self, stream_id: int, headers, end_stream: bool) -> bytes:
        """HEADERS (and CONTINUATION) frames for ``headers``; the caller
        holds the write lock (the encoder's blocks go out in order)."""
        block = self._encoder.encode(headers)
        limit = self.peer_max_frame
        flags = FLAG_END_STREAM if end_stream else 0
        if len(block) <= limit:
            return frame(HEADERS, flags | FLAG_END_HEADERS, stream_id, block)
        parts = [block[i:i + limit] for i in range(0, len(block), limit)]
        out = [frame(HEADERS, flags, stream_id, parts[0])]
        out += [frame(CONTINUATION, 0, stream_id, p) for p in parts[1:-1]]
        out.append(frame(CONTINUATION, FLAG_END_HEADERS, stream_id, parts[-1]))
        return b"".join(out)

    def send_headers(self, stream_id: int, headers, end_stream: bool) -> None:
        with self._wlock:
            self._sendall(self._take_ctl() + self.header_frames(stream_id, headers, end_stream))
        self._drain_ctl()

    def open_send_window(self, stream_id: int) -> None:
        with self._flow:
            self._send_windows[stream_id] = self.peer_initial_window

    def open_recv_window(self, stream_id: int) -> None:
        self._recv[stream_id] = [RECV_WINDOW, 0]

    def forget_stream(self, stream_id: int) -> None:
        """The stream is done in both directions: drop its windows."""
        self._recv.pop(stream_id, None)
        with self._flow:
            if self._send_windows.pop(stream_id, None) is not None:
                self._flow.notify_all()

    def reserve(self, stream_id: int, want: int) -> int:
        """Up to ``want`` octets of both send windows (and one frame), taken;
        waits while either is spent. StreamGone if the stream or connection
        closes."""
        with self._flow:
            while True:
                if self.closed:
                    raise StreamGone("connection closed")
                window = self._send_windows.get(stream_id)
                if window is None:
                    raise StreamGone(f"stream {stream_id} closed")
                n = min(want, window, self._send_conn_window, self.peer_max_frame)
                if n > 0 or want == 0:
                    self._send_windows[stream_id] = window - n
                    self._send_conn_window -= n
                    return n
                self._flow.wait()

    def send_data(self, stream_id: int, data: bytes, end_stream: bool) -> None:
        """``data`` as DATA frames within the peer's windows, the last one
        with END_STREAM when asked."""
        view = memoryview(data)
        pos, total = 0, len(data)
        while True:
            n = self.reserve(stream_id, total - pos)
            last = pos + n >= total
            self.write(frame(DATA, FLAG_END_STREAM if (last and end_stream) else 0, stream_id,
                             bytes(view[pos:pos + n])))
            pos += n
            if last:
                return

    def send_message(self, stream_id: int, headers, data: bytes, trailers,
                     end_stream: bool = True) -> None:
        """Headers (or None), ``data`` and trailers (or None): one write when
        the windows admit the data in one frame, else the data in frames as
        the windows open. Without trailers, ``end_stream`` ends the stream
        with the data."""
        end_with_data = trailers is None and end_stream
        with self._flow:
            window = self._send_windows.get(stream_id, 0)
            whole = (not self.closed and len(data) <= min(window, self._send_conn_window,
                                                          self.peer_max_frame))
            if whole:
                self._send_windows[stream_id] = window - len(data)
                self._send_conn_window -= len(data)
        if whole:
            with self._wlock:
                out = [self._take_ctl()]
                if headers is not None:
                    out.append(self.header_frames(stream_id, headers, False))
                out.append(frame(DATA, FLAG_END_STREAM if end_with_data else 0, stream_id, data))
                if trailers is not None:
                    out.append(self.header_frames(stream_id, trailers, True))
                self._sendall(b"".join(out))
            self._drain_ctl()
            return
        if headers is not None:
            self.send_headers(stream_id, headers, False)
        self.send_data(stream_id, data, end_with_data)
        if trailers is not None:
            self.send_headers(stream_id, trailers, True)

    def reset(self, stream_id: int, code: int) -> None:
        self.forget_stream(stream_id)
        self.send_control(rst_stream(stream_id, code))

    def send_goaway(self, code: int = NO_ERROR, debug: bytes = b"",
                    last_stream_id: int | None = None) -> None:
        """GOAWAY naming the last stream this side will process (by default
        the last the peer opened)."""
        self.goaway_sent = True
        self.send_control(goaway(self.last_peer_stream if last_stream_id is None
                                 else last_stream_id, code, debug))

    def ping(self, payload: bytes) -> threading.Event:
        """Send a PING; the event is set when its ACK comes back."""
        acked = self._pings[payload] = threading.Event()
        self.send_control(frame(PING, 0, 0, payload))
        return acked

    def local_settings(self) -> bytes:
        pairs = [(SETTINGS_INITIAL_WINDOW_SIZE, RECV_WINDOW),
                 (SETTINGS_MAX_FRAME_SIZE, RECV_MAX_FRAME)]
        if self.client:
            pairs.insert(0, (SETTINGS_ENABLE_PUSH, 0))
        return (settings_frame(pairs)
                + window_update(0, RECV_CONNECTION_WINDOW - DEFAULT_WINDOW))

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        with self._flow:
            self._flow.notify_all()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    # -- reading -------------------------------------------------------------

    def _read(self, n: int) -> bytes:
        data = self._rfile.read(n)
        if data is None or len(data) < n:
            raise EOFError
        return data

    def read_loop(self) -> None:
        """Read and dispatch frames until the peer closes or breaks the
        protocol; ``on_closed`` is called last, with the error if any."""
        error: BaseException | None = None
        try:
            if not self.client:
                if self._read(len(PREFACE)) != PREFACE:
                    raise ConnectionError_(PROTOCOL_ERROR, "bad client preface")
            while True:
                hi, lo, ftype, flags, stream_id = _HEAD.unpack(self._read(9))
                length = hi << 16 | lo
                stream_id &= 0x7fffffff
                if length > RECV_MAX_FRAME:
                    raise ConnectionError_(FRAME_SIZE_ERROR, f"frame of {length} octets")
                payload = self._read(length) if length else b""
                if ftype == HEADERS:
                    self._headers(flags, stream_id, payload)
                elif ftype == DATA:
                    self._data(flags, stream_id, payload)
                else:
                    self._control(ftype, flags, stream_id, payload)
        except (EOFError, OSError, ValueError) as exc:
            # ValueError: a read on a socket another thread closed.
            error = exc if not self.closed else None
        except ConnectionError_ as exc:
            error = exc
            try:
                self.send_goaway(exc.code, str(exc).encode())
            except StreamGone:
                pass
        except HpackError as exc:
            error = exc
            try:
                self.send_goaway(COMPRESSION_ERROR, str(exc).encode())
            except StreamGone:
                pass
        finally:
            self.close()
            self.on_closed(error)

    @staticmethod
    def _unpad(flags: int, payload: bytes) -> bytes:
        if not flags & FLAG_PADDED:
            return payload
        if not payload or payload[0] >= len(payload):
            raise ConnectionError_(PROTOCOL_ERROR, "padding longer than the frame")
        return payload[1:len(payload) - payload[0]]

    def _headers(self, flags: int, stream_id: int, payload: bytes) -> None:
        if stream_id == 0:
            raise ConnectionError_(PROTOCOL_ERROR, "HEADERS on stream 0")
        end_stream = bool(flags & FLAG_END_STREAM)
        block = self._unpad(flags, payload)
        if flags & FLAG_PRIORITY:
            if len(block) < 5:
                raise ConnectionError_(PROTOCOL_ERROR, "short PRIORITY fields")
            block = block[5:]
        parts = [block]
        size = len(block)
        while not flags & FLAG_END_HEADERS:
            hi, lo, ftype, flags, sid = _HEAD.unpack(self._read(9))
            length = hi << 16 | lo
            if ftype != CONTINUATION or (sid & 0x7fffffff) != stream_id:
                raise ConnectionError_(PROTOCOL_ERROR, "a header block broken by another frame")
            if length > RECV_MAX_FRAME:
                raise ConnectionError_(FRAME_SIZE_ERROR, f"frame of {length} octets")
            size += length
            if size > MAX_HEADER_BLOCK:
                raise ConnectionError_(PROTOCOL_ERROR, "header block too large")
            parts.append(self._read(length) if length else b"")
        headers = self._decoder.decode(b"".join(parts) if len(parts) > 1 else block)
        self.on_headers(stream_id, headers, end_stream)

    def _data(self, flags: int, stream_id: int, payload: bytes) -> None:
        if stream_id == 0:
            raise ConnectionError_(PROTOCOL_ERROR, "DATA on stream 0")
        n = len(payload)
        self._recv_conn_left -= n
        if self._recv_conn_left < 0:
            raise ConnectionError_(FLOW_CONTROL_ERROR, "connection window overrun")
        self._recv_conn_unacked += n
        if self._recv_conn_unacked >= RECV_CONNECTION_WINDOW // 2:
            self.send_control(window_update(0, self._recv_conn_unacked))
            self._recv_conn_left += self._recv_conn_unacked
            self._recv_conn_unacked = 0
        end_stream = bool(flags & FLAG_END_STREAM)
        win = self._recv.get(stream_id)
        if win is not None:
            win[0] -= n
            if win[0] < 0:
                self.reset(stream_id, FLOW_CONTROL_ERROR)
                self.on_reset(stream_id, FLOW_CONTROL_ERROR)
                return
            win[1] += n
            if end_stream:
                del self._recv[stream_id]
            elif win[1] >= RECV_WINDOW // 2:
                self.send_control(window_update(stream_id, win[1]))
                win[0] += win[1]
                win[1] = 0
        self.on_data(stream_id, self._unpad(flags, payload), end_stream)

    def _control(self, ftype: int, flags: int, stream_id: int, payload: bytes) -> None:
        if ftype == SETTINGS:
            if stream_id:
                raise ConnectionError_(PROTOCOL_ERROR, "SETTINGS on a stream")
            if flags & FLAG_ACK:
                return
            if len(payload) % 6:
                raise ConnectionError_(FRAME_SIZE_ERROR, "SETTINGS length")
            for i in range(0, len(payload), 6):
                key, value = struct.unpack_from(">HI", payload, i)
                self._setting(key, value)
            self.send_control(frame(SETTINGS, FLAG_ACK, 0))
        elif ftype == WINDOW_UPDATE:
            if len(payload) != 4:
                raise ConnectionError_(FRAME_SIZE_ERROR, "WINDOW_UPDATE length")
            increment = struct.unpack(">I", payload)[0] & 0x7fffffff
            with self._flow:
                if stream_id == 0:
                    if increment == 0:
                        raise ConnectionError_(PROTOCOL_ERROR, "WINDOW_UPDATE of 0")
                    self._send_conn_window += increment
                    if self._send_conn_window > MAX_WINDOW:
                        raise ConnectionError_(FLOW_CONTROL_ERROR, "connection window overflow")
                elif stream_id in self._send_windows:
                    window = self._send_windows[stream_id] + increment
                    if increment == 0 or window > MAX_WINDOW:
                        self._send_windows.pop(stream_id)
                        self.send_control(rst_stream(stream_id, PROTOCOL_ERROR if increment == 0
                                                     else FLOW_CONTROL_ERROR))
                    else:
                        self._send_windows[stream_id] = window
                self._flow.notify_all()
        elif ftype == PING:
            if len(payload) != 8 or stream_id:
                raise ConnectionError_(FRAME_SIZE_ERROR, "PING")
            if not flags & FLAG_ACK:
                self.send_control(frame(PING, FLAG_ACK, 0, payload))
            elif payload in self._pings:
                self._pings.pop(payload).set()
        elif ftype == RST_STREAM:
            if len(payload) != 4 or stream_id == 0:
                raise ConnectionError_(PROTOCOL_ERROR, "RST_STREAM")
            code = struct.unpack(">I", payload)[0]
            self.forget_stream(stream_id)
            self.on_reset(stream_id, code)
        elif ftype == GOAWAY:
            if len(payload) < 8:
                raise ConnectionError_(FRAME_SIZE_ERROR, "GOAWAY")
            last, code = struct.unpack_from(">II", payload)
            self.goaway_received = last & 0x7fffffff
            self.on_goaway(self.goaway_received, code, payload[8:])
        elif ftype == PUSH_PROMISE:
            raise ConnectionError_(PROTOCOL_ERROR, "PUSH_PROMISE is not enabled")
        elif ftype == CONTINUATION:
            raise ConnectionError_(PROTOCOL_ERROR, "CONTINUATION without HEADERS")
        # PRIORITY and frames of unknown types are ignored.

    def _setting(self, key: int, value: int) -> None:
        if key == SETTINGS_INITIAL_WINDOW_SIZE:
            if value > MAX_WINDOW:
                raise ConnectionError_(FLOW_CONTROL_ERROR, "initial window above 2^31-1")
            with self._flow:
                delta = value - self.peer_initial_window
                self.peer_initial_window = value
                for sid in self._send_windows:
                    self._send_windows[sid] += delta
                self._flow.notify_all()
        elif key == SETTINGS_MAX_FRAME_SIZE:
            if not DEFAULT_MAX_FRAME <= value <= (1 << 24) - 1:
                raise ConnectionError_(PROTOCOL_ERROR, f"max frame size {value}")
            self.peer_max_frame = value
        elif key == SETTINGS_ENABLE_PUSH and value > 1:
            raise ConnectionError_(PROTOCOL_ERROR, "ENABLE_PUSH above 1")

    # -- events, for the subclass ---------------------------------------------

    def on_headers(self, stream_id: int, headers: list, end_stream: bool) -> None:
        raise NotImplementedError

    def on_data(self, stream_id: int, data: bytes, end_stream: bool) -> None:
        raise NotImplementedError

    def on_reset(self, stream_id: int, code: int) -> None:
        pass

    def on_goaway(self, last_stream_id: int, code: int, debug: bytes) -> None:
        pass

    def on_closed(self, error: BaseException | None) -> None:
        pass
