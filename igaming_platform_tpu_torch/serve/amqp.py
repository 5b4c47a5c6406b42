"""AMQP 0-9-1 transport: real RabbitMQ publisher/consumer adapters.

The reference's event backbone is a real AMQP client over RabbitMQ —
durable topic exchanges, persistent delivery with publisher-confirm
await (pkg/events/publisher.go:147-152, :178-209),
reconnect-with-backoff (:91-108), prefetch-bounded consumers (:279-284),
manual ack / nack-requeue / reject-no-requeue (:342-376). No AMQP client
library ships in this image, so this module implements the AMQP 0-9-1
wire protocol directly on a socket — frames, class/method encoding,
content headers, PLAIN auth — and exposes:

- :class:`AmqpPublisher` — the `events.Publisher` surface over a broker
  URL: durable topic exchange declaration, `delivery_mode=2` persistent
  messages, confirm-mode publishes that block until the broker acks,
  and automatic reconnect + topology redeclaration on connection loss.
- :class:`AmqpConsumer` — the `events.Consumer` surface: per-queue
  subscription with `basic.qos` prefetch, manual `basic.ack`, a
  `basic.reject(requeue=false)` on malformed payloads (poison messages
  go to the broker's dead-letter config, not back to the queue) and
  `basic.nack(requeue=true)` on handler errors, with a bounded
  redelivery count enforced client-side.

The port's copy of ``igaming_platform_tpu/serve/amqp.py``, over the
port's ``serve/events.py``: the same frames byte for byte (the client
properties name the same product), held to the JAX client by
tests/test_torch_amqp.py against both packages' in-process fake AMQP
*server* (serve/amqp_testing.py), which speaks the protocol over a real
socket.
"""

from __future__ import annotations

import logging
import random
import socket
import struct
import threading
import time
import urllib.parse
from dataclasses import dataclass

from igaming_platform_tpu_torch.serve.events import Event, EventHandler

logger = logging.getLogger(__name__)

PROTOCOL_HEADER = b"AMQP\x00\x00\x09\x01"

FRAME_METHOD = 1
FRAME_HEADER = 2
FRAME_BODY = 3
FRAME_HEARTBEAT = 8
FRAME_END = 0xCE

# class ids
CLS_CONNECTION = 10
CLS_CHANNEL = 20
CLS_EXCHANGE = 40
CLS_QUEUE = 50
CLS_BASIC = 60
CLS_CONFIRM = 85

# (class, method) ids used here
CONNECTION_START = (10, 10)
CONNECTION_START_OK = (10, 11)
CONNECTION_TUNE = (10, 30)
CONNECTION_TUNE_OK = (10, 31)
CONNECTION_OPEN = (10, 40)
CONNECTION_OPEN_OK = (10, 41)
CONNECTION_CLOSE = (10, 50)
CONNECTION_CLOSE_OK = (10, 51)
CHANNEL_OPEN = (20, 10)
CHANNEL_OPEN_OK = (20, 11)
CHANNEL_CLOSE = (20, 40)
CHANNEL_CLOSE_OK = (20, 41)
EXCHANGE_DECLARE = (40, 10)
EXCHANGE_DECLARE_OK = (40, 11)
QUEUE_DECLARE = (50, 10)
QUEUE_DECLARE_OK = (50, 11)
QUEUE_BIND = (50, 20)
QUEUE_BIND_OK = (50, 21)
BASIC_QOS = (60, 10)
BASIC_QOS_OK = (60, 11)
BASIC_CONSUME = (60, 20)
BASIC_CONSUME_OK = (60, 21)
BASIC_PUBLISH = (60, 40)
BASIC_DELIVER = (60, 60)
BASIC_ACK = (60, 80)
BASIC_REJECT = (60, 90)
BASIC_NACK = (60, 120)
CONFIRM_SELECT = (85, 10)
CONFIRM_SELECT_OK = (85, 11)


class AmqpError(RuntimeError):
    pass


class AmqpConnectionClosed(AmqpError):
    pass


# ---------------------------------------------------------------------------
# Wire encoding primitives
# ---------------------------------------------------------------------------


def _shortstr(s: str | bytes) -> bytes:
    b = s.encode() if isinstance(s, str) else s
    if len(b) > 255:
        raise ValueError("shortstr too long")
    return bytes([len(b)]) + b


def _longstr(s: str | bytes) -> bytes:
    b = s.encode() if isinstance(s, str) else s
    return struct.pack(">I", len(b)) + b


def _table(d: dict) -> bytes:
    """Encode a field table (string values only — all this client needs)."""
    body = b""
    for k, v in d.items():
        body += _shortstr(k)
        if isinstance(v, bool):
            body += b"t" + (b"\x01" if v else b"\x00")
        elif isinstance(v, int):
            body += b"I" + struct.pack(">i", v)
        else:
            body += b"S" + _longstr(str(v))
    return _longstr(body)


class _Reader:
    """Cursor over a frame payload."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1  # analysis: single-writer — per-frame parse cursor; a _Reader never crosses threads
        return v

    def u16(self) -> int:
        (v,) = struct.unpack_from(">H", self.buf, self.pos)
        self.pos += 2
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from(">I", self.buf, self.pos)
        self.pos += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from(">Q", self.buf, self.pos)
        self.pos += 8
        return v

    def shortstr(self) -> str:
        n = self.u8()
        v = self.buf[self.pos : self.pos + n]
        self.pos += n
        return v.decode()

    def longstr(self) -> bytes:
        n = self.u32()
        v = self.buf[self.pos : self.pos + n]
        self.pos += n
        return v

    def skip_table(self) -> None:
        n = self.u32()
        self.pos += n


# ---------------------------------------------------------------------------
# Connection
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AmqpUrl:
    host: str
    port: int
    user: str
    password: str
    vhost: str

    @classmethod
    def parse(cls, url: str) -> "AmqpUrl":
        u = urllib.parse.urlparse(url)
        if u.scheme not in ("amqp", ""):
            raise ValueError(f"not an amqp url: {url}")
        vhost = urllib.parse.unquote(u.path.lstrip("/")) or "/"
        return cls(
            host=u.hostname or "localhost",
            port=u.port or 5672,
            user=urllib.parse.unquote(u.username or "guest"),
            password=urllib.parse.unquote(u.password or "guest"),
            vhost=vhost,
        )


class AmqpConnection:
    """One socket + one channel, synchronous method calls.

    The publisher and each consumer hold their OWN connection (the
    reference does the same — separate dialer per role), so a blocking
    confirm-wait on the publisher never stalls consumer acks.
    """

    def __init__(self, url: str, *, connect_timeout: float = 5.0):
        self.url = AmqpUrl.parse(url)
        self._sock: socket.socket | None = None
        self._recv_buf = b""
        self._lock = threading.Lock()
        self._frame_max = 131072
        self.connect_timeout = connect_timeout

    # -- frame IO -----------------------------------------------------------

    def _send_frame(self, ftype: int, channel: int, payload: bytes) -> None:
        frame = struct.pack(">BHI", ftype, channel, len(payload)) + payload + bytes([FRAME_END])
        try:
            self._sock.sendall(frame)
        except (OSError, AttributeError) as exc:
            raise AmqpConnectionClosed(f"send failed: {exc}") from exc

    def send_method(self, channel: int, cm: tuple[int, int], args: bytes = b"") -> None:
        self._send_frame(FRAME_METHOD, channel, struct.pack(">HH", *cm) + args)

    def _recv_exact(self, n: int) -> bytes:
        while len(self._recv_buf) < n:
            try:
                chunk = self._sock.recv(65536)
            except socket.timeout as exc:
                raise AmqpError("read timeout") from exc
            except (OSError, AttributeError) as exc:
                raise AmqpConnectionClosed(f"recv failed: {exc}") from exc
            if not chunk:
                raise AmqpConnectionClosed("connection closed by peer")
            self._recv_buf += chunk  # analysis: single-writer — phased ownership: main reads during the handshake, only the consume loop after
        out, self._recv_buf = self._recv_buf[:n], self._recv_buf[n:]
        return out

    def recv_frame(self) -> tuple[int, int, bytes]:
        ftype, channel, size = struct.unpack(">BHI", self._recv_exact(7))
        payload = self._recv_exact(size)
        end = self._recv_exact(1)
        if end[0] != FRAME_END:
            raise AmqpError(f"bad frame end: {end!r}")
        return ftype, channel, payload

    def recv_method(self, expect: tuple[int, int] | None = None) -> tuple[tuple[int, int], _Reader]:
        """Read frames until a method frame arrives (heartbeats answered)."""
        while True:
            ftype, _, payload = self.recv_frame()
            if ftype == FRAME_HEARTBEAT:
                self._send_frame(FRAME_HEARTBEAT, 0, b"")
                continue
            if ftype != FRAME_METHOD:
                raise AmqpError(f"unexpected frame type {ftype}")
            r = _Reader(payload)
            cm = (r.u16(), r.u16())
            if cm == CONNECTION_CLOSE:
                code = r.u16()
                reason = r.shortstr()
                try:
                    self.send_method(0, CONNECTION_CLOSE_OK)
                except AmqpConnectionClosed:
                    pass
                raise AmqpConnectionClosed(f"server closed connection: {code} {reason}")
            if cm == CHANNEL_CLOSE:
                code = r.u16()
                reason = r.shortstr()
                try:
                    self.send_method(1, CHANNEL_CLOSE_OK)
                except AmqpConnectionClosed:
                    pass
                raise AmqpError(f"server closed channel: {code} {reason}")
            if expect is not None and cm != expect:
                raise AmqpError(f"expected {expect}, got {cm}")
            return cm, r

    # -- lifecycle ----------------------------------------------------------

    def connect(self) -> None:
        sock = socket.create_connection(
            (self.url.host, self.url.port), timeout=self.connect_timeout
        )
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._recv_buf = b""
        self._sock.sendall(PROTOCOL_HEADER)

        self.recv_method(CONNECTION_START)  # fields ignored: PLAIN/en_US assumed
        props = _table({
            "product": "igaming-platform-tpu",
            "platform": "python",
            "capabilities": "",
        })
        response = b"\x00" + self.url.user.encode() + b"\x00" + self.url.password.encode()
        self.send_method(
            0, CONNECTION_START_OK,
            props + _shortstr("PLAIN") + _longstr(response) + _shortstr("en_US"),
        )
        _, r = self.recv_method(CONNECTION_TUNE)
        channel_max = r.u16()
        frame_max = r.u32()
        self._frame_max = min(frame_max or 131072, 131072)
        # heartbeat 0: this client relies on TCP failure + publish timeouts
        # (the Go reference also leaves heartbeat handling to the library).
        self.send_method(
            0, CONNECTION_TUNE_OK,
            struct.pack(">HIH", channel_max, self._frame_max, 0),
        )
        self.send_method(0, CONNECTION_OPEN, _shortstr(self.url.vhost) + _shortstr("") + b"\x00")
        self.recv_method(CONNECTION_OPEN_OK)

        self.send_method(1, CHANNEL_OPEN, _shortstr(""))
        self.recv_method(CHANNEL_OPEN_OK)

    def close(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:  # noqa: CC04 — teardown of a failed connect; nothing to record
                pass

    @property
    def connected(self) -> bool:
        return self._sock is not None

    # -- topology -----------------------------------------------------------

    def declare_exchange(self, name: str, kind: str = "topic", durable: bool = True) -> None:
        """exchange.declare — durable topic (publisher.go:124-138)."""
        flags = 0x02 if durable else 0x00
        self.send_method(
            1, EXCHANGE_DECLARE,
            struct.pack(">H", 0) + _shortstr(name) + _shortstr(kind)
            + bytes([flags]) + _table({}),
        )
        self.recv_method(EXCHANGE_DECLARE_OK)

    def declare_queue(self, name: str, durable: bool = True) -> None:
        flags = 0x02 if durable else 0x00
        self.send_method(
            1, QUEUE_DECLARE,
            struct.pack(">H", 0) + _shortstr(name) + bytes([flags]) + _table({}),
        )
        self.recv_method(QUEUE_DECLARE_OK)

    def bind_queue(self, queue_name: str, exchange: str, routing_key: str) -> None:
        self.send_method(
            1, QUEUE_BIND,
            struct.pack(">H", 0) + _shortstr(queue_name) + _shortstr(exchange)
            + _shortstr(routing_key) + b"\x00" + _table({}),
        )
        self.recv_method(QUEUE_BIND_OK)

    def confirm_select(self) -> None:
        """confirm.select — publisher-confirm mode (publisher.go:147-152)."""
        self.send_method(1, CONFIRM_SELECT, b"\x00")
        self.recv_method(CONFIRM_SELECT_OK)

    def qos(self, prefetch: int) -> None:
        """basic.qos — bound unacked deliveries (publisher.go:279-284)."""
        self.send_method(1, BASIC_QOS, struct.pack(">IHB", 0, prefetch, 0))
        self.recv_method(BASIC_QOS_OK)

    # -- publish ------------------------------------------------------------

    def publish(
        self, exchange: str, routing_key: str, body: bytes,
        *, persistent: bool = True, content_type: str = "application/json",
    ) -> None:
        """basic.publish + content header + body frames (one message)."""
        self.send_method(
            1, BASIC_PUBLISH,
            struct.pack(">H", 0) + _shortstr(exchange) + _shortstr(routing_key) + b"\x00",
        )
        # Property flags: content-type (bit 15) + delivery-mode (bit 12).
        flags = (1 << 15) | (1 << 12)
        props = _shortstr(content_type) + bytes([2 if persistent else 1])
        header = struct.pack(">HHQ", CLS_BASIC, 0, len(body)) + struct.pack(">H", flags) + props
        self._send_frame(FRAME_HEADER, 1, header)
        max_body = self._frame_max - 8
        for off in range(0, len(body), max_body):
            self._send_frame(FRAME_BODY, 1, body[off : off + max_body])
        if not body:
            self._send_frame(FRAME_BODY, 1, b"")

    def wait_confirm(self) -> bool:
        """Block until the broker acks (or nacks) outstanding publishes."""
        cm, r = self.recv_method()
        if cm == BASIC_ACK:
            return True
        if cm == BASIC_NACK:
            return False
        raise AmqpError(f"expected basic.ack/nack, got {cm}")

    # -- consume ------------------------------------------------------------

    def consume(self, queue_name: str, consumer_tag: str = "") -> str:
        self.send_method(
            1, BASIC_CONSUME,
            struct.pack(">H", 0) + _shortstr(queue_name) + _shortstr(consumer_tag)
            + b"\x00" + _table({}),  # no-local/no-ack/exclusive/no-wait all 0
        )
        _, r = self.recv_method(BASIC_CONSUME_OK)
        return r.shortstr()

    def next_delivery(self, timeout: float | None = None):
        """Wait for one basic.deliver; returns (delivery_tag, redelivered,
        routing_key, body) or None on timeout."""
        if self._sock is None:
            raise AmqpConnectionClosed("not connected")
        # The timeout may only fire while ZERO bytes of the next frame have
        # been consumed — timing out between a frame's header and payload
        # would desync the stream (the next read would parse mid-payload
        # bytes as a header). So: one timed recv to learn whether anything
        # arrived, then fully blocking reads for the complete frame.
        if not self._recv_buf:
            self._sock.settimeout(timeout)
            try:
                chunk = self._sock.recv(65536)
            except socket.timeout:
                return None
            except (OSError, AttributeError) as exc:
                raise AmqpConnectionClosed(f"recv failed: {exc}") from exc
            finally:
                if self._sock is not None:
                    self._sock.settimeout(None)
            if not chunk:
                raise AmqpConnectionClosed("connection closed by peer")
            self._recv_buf += chunk
        cm, r = self.recv_method()
        if cm != BASIC_DELIVER:
            raise AmqpError(f"expected basic.deliver, got {cm}")
        r.shortstr()  # consumer tag
        delivery_tag = r.u64()
        redelivered = r.u8() != 0
        r.shortstr()  # exchange
        routing_key = r.shortstr()
        # content header
        ftype, _, payload = self.recv_frame()
        if ftype != FRAME_HEADER:
            raise AmqpError("expected content header")
        hr = _Reader(payload)
        hr.u16()  # class
        hr.u16()  # weight
        body_size = hr.u64()
        body = b""
        while len(body) < body_size:
            ftype, _, payload = self.recv_frame()
            if ftype != FRAME_BODY:
                raise AmqpError("expected body frame")
            body += payload
        return delivery_tag, redelivered, routing_key, body

    def ack(self, delivery_tag: int) -> None:
        self.send_method(1, BASIC_ACK, struct.pack(">QB", delivery_tag, 0))

    def nack(self, delivery_tag: int, requeue: bool = True) -> None:
        """basic.nack — handler failed, redeliver (publisher.go:366-371)."""
        self.send_method(1, BASIC_NACK, struct.pack(">QB", delivery_tag, 0x02 if requeue else 0))

    def reject(self, delivery_tag: int, requeue: bool = False) -> None:
        """basic.reject — poison message, do NOT requeue (publisher.go:354-360)."""
        self.send_method(1, BASIC_REJECT, struct.pack(">QB", delivery_tag, 1 if requeue else 0))


# ---------------------------------------------------------------------------
# Publisher / Consumer adapters (events.py protocol surface)
# ---------------------------------------------------------------------------


class AmqpPublisher:
    """Durable-topic publisher with confirms + reconnect.

    Mirrors RabbitMQPublisher (publisher.go:73-218): declares the three
    durable topic exchanges on connect, publishes persistent messages
    with routing key = event type, and blocks until the broker confirms.
    On connection loss it reconnects with linear backoff and replays the
    failed publish (at-least-once; consumers dedupe on envelope id).
    """

    def __init__(
        self, url: str, exchanges: tuple[str, ...] = (),
        *, max_retries: int = 5, retry_delay: float = 0.5,
    ):
        self.url = url
        self.exchanges = tuple(exchanges)
        self.max_retries = max_retries
        self.retry_delay = retry_delay
        self._conn = AmqpConnection(url)
        self._lock = threading.Lock()
        self.published = 0
        self.reconnects = 0
        # Supervisor feed (serve/supervisor.py): called with (ok, exc)
        # after every publish_raw outcome so the `amqp` breaker tracks
        # broker health without the publisher knowing about breakers.
        self.on_publish_result = None
        try:
            self._connect()
        except (AmqpError, OSError) as exc:
            # Broker not up yet (normal container start ordering): stay
            # disconnected — publish_raw() reconnects with backoff, and
            # the outbox relay retries rows until delivery succeeds.
            logger.warning("AMQP broker unavailable at startup (%s); will retry",
                           exc, exc_info=True)

    def _connect(self) -> None:
        self._conn.close()
        self._conn = AmqpConnection(self.url)
        self._conn.connect()
        for ex in self.exchanges:
            self._conn.declare_exchange(ex, "topic", durable=True)
        # Bootstrap the full canonical topology (queues + bindings), not
        # just exchanges: a confirm on a bindingless exchange means the
        # broker ACCEPTED and DISCARDED the message — outbox rows would be
        # marked published while events emitted before the first consumer
        # attaches are lost. Durable queues make publish-before-consume
        # safe on a fresh broker.
        from igaming_platform_tpu_torch.serve.events import CANONICAL_BINDINGS

        for qname, exchange, pattern in CANONICAL_BINDINGS:
            if exchange in self.exchanges or not self.exchanges:
                self._conn.declare_exchange(exchange, "topic", durable=True)
                self._conn.declare_queue(qname, durable=True)
                self._conn.bind_queue(qname, exchange, pattern)
        self._conn.confirm_select()

    def publish(self, exchange: str, event: Event) -> None:
        self.publish_with_routing(exchange, event.type, event)

    def publish_with_routing(self, exchange: str, routing_key: str, event: Event) -> None:
        self.publish_raw(exchange, routing_key, event.to_json())

    def publish_raw(self, exchange: str, routing_key: str, payload: str) -> None:
        """Raw-payload publish with confirm + reconnect — the surface the
        transactional-outbox relay targets (outbox.py OutboxRelay)."""
        from igaming_platform_tpu_torch.serve import chaos

        body = payload.encode()
        last: Exception | None = None
        # The lock serializes channel use per ATTEMPT, not across the
        # whole retry loop: holding it through the backoff sleep would
        # convoy every other publishing thread behind one broker outage
        # (flagged by CC02 — blocking call under lock).
        for attempt in range(1 + self.max_retries):
            try:
                chaos.fire("amqp.publish")
                with self._lock:
                    if not self._conn.connected:
                        raise AmqpConnectionClosed("not connected")
                    self._conn.publish(exchange, routing_key, body, persistent=True)
                    if not self._conn.wait_confirm():
                        raise AmqpError("broker nacked publish")
                    self.published += 1
                self._note_result(True, None)
                return
            except (AmqpConnectionClosed, AmqpError, OSError,  # noqa: CC04 — retry loop; exhausted retries raise AmqpError below
                    chaos.ChaosError) as exc:
                last = exc
                if attempt == self.max_retries:
                    break
                # Linear backoff reconnect (publisher.go:91-108), with
                # jitter: N publishers behind one flapping broker must
                # not re-dial in lockstep (CC05).
                time.sleep(self.retry_delay * (attempt + 1)
                           * random.uniform(0.5, 1.5))
                try:
                    with self._lock:
                        self._connect()
                        self.reconnects += 1
                except (AmqpError, OSError) as rexc:  # noqa: CC04 — reconnect attempt inside the retry loop; final failure raises
                    last = rexc
        self._note_result(False, last)
        raise AmqpError(f"publish failed after {self.max_retries} retries: {last}")

    def _note_result(self, ok: bool, exc: Exception | None) -> None:
        hook = self.on_publish_result
        if hook is None:
            return
        try:
            hook(ok, exc)
        except Exception:  # noqa: BLE001 — breaker feed must not fail publishing
            pass

    def close(self) -> None:
        self._conn.close()


class AmqpConsumer:
    """Prefetch-bounded consumer with ack/nack/reject discipline.

    Mirrors RabbitMQConsumer (publisher.go:237-376): each subscribed
    queue gets its own connection + consume loop thread, `basic.qos`
    bounds in-flight deliveries, malformed payloads are rejected without
    requeue (poison), handler errors nack with requeue up to
    ``max_redelivery`` times (then reject — the client-side cap the Go
    code leaves to a DLX policy).
    """

    def __init__(
        self, url: str, *, prefetch: int = 64, max_redelivery: int = 5,
        reconnect_delay: float = 0.5,
    ):
        self.url = url
        self.prefetch = prefetch
        self.max_redelivery = max_redelivery
        self.reconnect_delay = reconnect_delay
        self._handlers: dict[str, EventHandler] = {}
        self._threads: list[threading.Thread] = []
        self._conns: dict[str, AmqpConnection] = {}
        self._stop = threading.Event()
        self._redeliveries: dict[str, int] = {}
        self.processed = 0
        self.rejected = 0
        self.nacked = 0

    def subscribe(self, queue_name: str, handler: EventHandler) -> None:
        self._handlers[queue_name] = handler

    def start(self) -> None:
        self._stop.clear()
        for qname, handler in self._handlers.items():
            t = threading.Thread(
                target=self._consume_loop, args=(qname, handler),
                name=f"amqp-consumer-{qname}", daemon=True,
            )
            self._threads.append(t)
            t.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        for conn in self._conns.values():
            conn.close()
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads.clear()

    def _open(self, qname: str) -> AmqpConnection:
        from igaming_platform_tpu_torch.serve.events import CANONICAL_BINDINGS

        conn = AmqpConnection(self.url)
        conn.connect()
        conn.declare_queue(qname, durable=True)
        # Bind per the canonical topology so a FRESH broker routes exactly
        # like default_broker() — without this, events published to the
        # exchanges would be dropped before any consumer attaches.
        for q, exchange, pattern in CANONICAL_BINDINGS:
            if q == qname:
                conn.declare_exchange(exchange, "topic", durable=True)
                conn.bind_queue(qname, exchange, pattern)
        conn.qos(self.prefetch)
        conn.consume(qname)
        self._conns[qname] = conn
        return conn

    def _consume_loop(self, qname: str, handler: EventHandler) -> None:
        conn: AmqpConnection | None = None
        while not self._stop.is_set():
            try:
                if conn is None or not conn.connected:
                    conn = self._open(qname)
                delivery = conn.next_delivery(timeout=0.25)
                if delivery is None:
                    continue
                tag, redelivered, routing_key, body = delivery
                self._process(conn, tag, body, handler)
            except (AmqpConnectionClosed, OSError):  # noqa: CC04 — consumer reconnect loop; redial below is the handling
                if self._stop.is_set():
                    return
                if conn is not None:
                    conn.close()
                conn = None
                time.sleep(self.reconnect_delay * random.uniform(0.5, 1.5))
            except AmqpError as exc:
                logger.warning("consumer %s protocol error: %s", qname, exc)
                if conn is not None:
                    conn.close()
                conn = None
                time.sleep(self.reconnect_delay * random.uniform(0.5, 1.5))

    def _process(
        self, conn: AmqpConnection, tag: int, body: bytes, handler: EventHandler
    ) -> None:
        try:
            event = Event.from_json(body.decode())
        except Exception:  # noqa: BLE001 — poison message
            conn.reject(tag, requeue=False)
            self.rejected += 1
            return
        try:
            handler(event)
        except Exception:  # noqa: BLE001 — handler failure => redeliver
            count = self._redeliveries.get(event.id, 0) + 1
            self._redeliveries[event.id] = count
            if count >= self.max_redelivery:
                conn.reject(tag, requeue=False)
                self.rejected += 1
                self._redeliveries.pop(event.id, None)
            else:
                conn.nack(tag, requeue=True)
                self.nacked += 1
            return
        conn.ack(tag)
        self.processed += 1
        self._redeliveries.pop(event.id, None)
        if len(self._redeliveries) > 65536:  # bound poison-tracking memory
            self._redeliveries.clear()
