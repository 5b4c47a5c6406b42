"""Event backbone, in-process transport: topic exchanges, queues, consumers.

A copy of the in-process half of ``igaming_platform_tpu/serve/events.py``
(the reference's RabbitMQ event layer, publisher.go):

- the canonical event types, 3 exchanges and 4 queues (``core/enums.py``);
- the envelope {id, type, source, aggregate_id, timestamp, version, data,
  metadata} (publisher.go:47-56), with its JSON round trip;
- AMQP topic-routing semantics (``*`` one word, ``#`` zero or more);
- consumer behaviour: reject-no-requeue on malformed payloads, nack-requeue
  on handler error (publisher.go:342-376);
- at-least-once dedupe on the envelope id (``DeliveryDeduper``).

The AMQP wire client is not ported yet (``ROADMAP.md``): an ``amqp://``
transport raises ``NotImplementedError`` and never falls back to the
in-process broker. The store-backed deduper is not ported either.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable

from igaming_platform_tpu_torch.core.enums import (
    EXCHANGE_BONUS,
    EXCHANGE_RISK,
    EXCHANGE_WALLET,
    QUEUE_ANALYTICS,
    QUEUE_BONUS_PROCESSOR,
    QUEUE_NOTIFICATIONS,
    QUEUE_RISK_SCORING,
)


@dataclass
class Event:
    """Domain event envelope (publisher.go:47-70)."""

    type: str
    source: str = ""
    aggregate_id: str = ""
    data: dict = field(default_factory=dict)
    metadata: dict = field(default_factory=dict)
    id: str = field(default_factory=lambda: str(uuid.uuid4()))
    timestamp: float = field(default_factory=time.time)
    version: int = 1

    def to_json(self) -> str:
        return json.dumps(
            {
                "id": self.id,
                "type": self.type,
                "source": self.source,
                "aggregate_id": self.aggregate_id,
                "timestamp": self.timestamp,
                "version": self.version,
                "data": self.data,
                "metadata": self.metadata,
            }
        )

    @classmethod
    def from_json(cls, raw: str) -> "Event":
        obj = json.loads(raw)
        return cls(
            type=obj["type"],
            source=obj.get("source", ""),
            aggregate_id=obj.get("aggregate_id", ""),
            data=obj.get("data", {}),
            metadata=obj.get("metadata", {}),
            id=obj.get("id", str(uuid.uuid4())),
            timestamp=obj.get("timestamp", time.time()),
            version=obj.get("version", 1),
        )


def topic_matches(pattern: str, routing_key: str) -> bool:
    """AMQP topic matching: ``*`` = exactly one word, ``#`` = zero+ words."""
    def match(p: list[str], k: list[str]) -> bool:
        if not p:
            return not k
        if p[0] == "#":
            return any(match(p[1:], k[i:]) for i in range(len(k) + 1))
        if not k:
            return False
        if p[0] == "*" or p[0] == k[0]:
            return match(p[1:], k[1:])
        return False

    return match(pattern.split("."), routing_key.split("."))


EventHandler = Callable[[Event], None]


class InMemoryBroker:
    """Topic exchanges + bound queues, in one process."""

    def __init__(self):
        self._lock = threading.RLock()
        self._exchanges: set[str] = set()
        self._queues: dict[str, queue.Queue] = {}
        self._bindings: dict[str, list[tuple[str, str]]] = {}  # exchange -> [(pattern, queue)]
        self.dead_letters: list[tuple[str, str]] = []  # (queue, raw payload)
        self.published_count = 0

    def declare_exchange(self, name: str) -> None:
        with self._lock:
            self._exchanges.add(name)
            self._bindings.setdefault(name, [])

    def declare_queue(self, name: str) -> None:
        with self._lock:
            self._queues.setdefault(name, queue.Queue())

    def bind(self, queue_name: str, exchange: str, pattern: str) -> None:
        with self._lock:
            self.declare_exchange(exchange)
            self.declare_queue(queue_name)
            self._bindings[exchange].append((pattern, queue_name))

    def publish_raw(self, exchange: str, routing_key: str, payload: str) -> None:
        with self._lock:
            if exchange not in self._exchanges:
                raise KeyError(f"exchange not declared: {exchange}")
            targets = [q for pat, q in self._bindings[exchange] if topic_matches(pat, routing_key)]
        for q in targets:
            self._queues[q].put(payload)
        self.published_count += 1

    def queue_depth(self, queue_name: str) -> int:
        return self._queues[queue_name].qsize()

    def get(self, queue_name: str, timeout: float | None = None) -> str | None:
        try:
            return self._queues[queue_name].get(timeout=timeout)
        except queue.Empty:
            return None

    def requeue(self, queue_name: str, payload: str) -> None:
        self._queues[queue_name].put(payload)


# The reference topology as data: 3 exchanges, 4 queues, binding patterns
# (publisher.go:35-44). The risk-scoring queue sees every wallet money
# movement, the bonus processor reacts to transactions/bets, analytics sees
# everything, notifications get risk + bonus events.
CANONICAL_BINDINGS: tuple[tuple[str, str, str], ...] = (
    (QUEUE_RISK_SCORING, EXCHANGE_WALLET, "#"),
    (QUEUE_BONUS_PROCESSOR, EXCHANGE_WALLET, "transaction.*"),
    (QUEUE_BONUS_PROCESSOR, EXCHANGE_WALLET, "bet.*"),
    (QUEUE_ANALYTICS, EXCHANGE_WALLET, "#"),
    (QUEUE_ANALYTICS, EXCHANGE_BONUS, "#"),
    (QUEUE_ANALYTICS, EXCHANGE_RISK, "#"),
    (QUEUE_NOTIFICATIONS, EXCHANGE_RISK, "#"),
    (QUEUE_NOTIFICATIONS, EXCHANGE_BONUS, "bonus.*"),
)


def default_broker() -> InMemoryBroker:
    """The canonical topology over the in-process broker."""
    b = InMemoryBroker()
    for ex in (EXCHANGE_WALLET, EXCHANGE_BONUS, EXCHANGE_RISK):
        b.declare_exchange(ex)
    for qname, exchange, pattern in CANONICAL_BINDINGS:
        b.bind(qname, exchange, pattern)
    return b


class DeliveryDeduper:
    """Bounded seen-id set for at-least-once consumers: a handler whose
    effect is not idempotent (feature updates, wagering progress) gates on
    it before acting on a delivery."""

    def __init__(self, capacity: int = 65_536):
        self._seen: OrderedDict[str, None] = OrderedDict()
        self._capacity = capacity
        self._lock = threading.Lock()

    def is_duplicate(self, event_id: str) -> bool:
        """Record the id; True if it was already seen (redelivery)."""
        return not self.claim(event_id)

    def claim(self, event_id: str) -> bool:
        """Atomically claim an id for processing; False if already claimed.
        :meth:`release` undoes a claim when the handler fails, so the
        nack+requeue retry is not misread as a duplicate."""
        with self._lock:
            if event_id in self._seen:
                return False
            self._seen[event_id] = None
            if len(self._seen) > self._capacity:
                self._seen.popitem(last=False)
            return True

    def release(self, event_id: str) -> None:
        """Undo a claim after the handler failed, re-arming the retry."""
        with self._lock:
            self._seen.pop(event_id, None)


class Publisher:
    """Publisher facade (Publish routes by event type, publisher.go:160-162)."""

    def __init__(self, broker: InMemoryBroker):
        self.broker = broker

    def publish(self, exchange: str, event: Event) -> None:
        self.publish_with_routing(exchange, event.type, event)

    def publish_with_routing(self, exchange: str, routing_key: str, event: Event) -> None:
        self.broker.publish_raw(exchange, routing_key, event.to_json())

    def publish_raw(self, exchange: str, routing_key: str, payload: str) -> None:
        self.broker.publish_raw(exchange, routing_key, payload)


class Consumer:
    """Queue consumer with the reference's ack/nack discipline
    (publisher.go:342-376): malformed -> drop to dead-letters, handler error
    -> requeue (bounded by ``max_redelivery`` to avoid poison loops)."""

    def __init__(self, broker: InMemoryBroker, prefetch: int = 64, max_redelivery: int = 5):
        self.broker = broker
        self.prefetch = prefetch
        self.max_redelivery = max_redelivery
        self._handlers: dict[str, EventHandler] = {}
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._redelivery: dict[str, int] = {}

    def subscribe(self, queue_name: str, handler: EventHandler) -> None:
        self.broker.declare_queue(queue_name)
        self._handlers[queue_name] = handler

    def start(self) -> None:
        for qname, handler in self._handlers.items():
            t = threading.Thread(
                target=self._consume_loop, args=(qname, handler), name=f"consumer-{qname}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)

    def drain(self, queue_name: str, handler: EventHandler | None = None, max_events: int | None = None) -> int:
        """Synchronously process everything currently queued."""
        handler = handler or self._handlers[queue_name]
        n = 0
        while max_events is None or n < max_events:
            raw = self.broker.get(queue_name, timeout=0)
            if raw is None:
                break
            self._process(queue_name, handler, raw)
            n += 1
        return n

    def _consume_loop(self, qname: str, handler: EventHandler) -> None:
        while not self._stop.is_set():
            raw = self.broker.get(qname, timeout=0.1)
            if raw is None:
                continue
            self._process(qname, handler, raw)

    def _process(self, qname: str, handler: EventHandler, raw: str) -> None:
        try:
            event = Event.from_json(raw)
        except (json.JSONDecodeError, KeyError, TypeError):
            # Poison message: reject, never requeue (publisher.go:354-360).
            self.broker.dead_letters.append((qname, raw))
            return
        try:
            handler(event)
            self._redelivery.pop(event.id, None)
        except Exception:  # noqa: BLE001 - handler failure => nack+requeue
            count = self._redelivery.get(event.id, 0) + 1
            self._redelivery[event.id] = count
            if count <= self.max_redelivery:
                self.broker.requeue(qname, raw)
            else:
                self.broker.dead_letters.append((qname, raw))


# -- typed event constructors (publisher.go:397-468) -------------------------


def new_transaction_event(event_type: str, tx: dict) -> Event:
    return Event(
        type=event_type,
        source="wallet-service",
        aggregate_id=str(tx.get("account_id", "")),
        data={
            "transaction_id": tx.get("id", ""),
            "account_id": tx.get("account_id", ""),
            "type": tx.get("type", ""),
            "amount": tx.get("amount", 0),
            "balance_before": tx.get("balance_before", 0),
            "balance_after": tx.get("balance_after", 0),
            "status": tx.get("status", ""),
            "game_id": tx.get("game_id", ""),
            "round_id": tx.get("round_id", ""),
            # Wagering contribution is weighted per game category
            # (bonus_engine.go:485-514), so the event says what was played.
            "game_category": tx.get("game_category", ""),
            "risk_score": tx.get("risk_score", 0),
        },
    )


def new_bonus_event(event_type: str, bonus: dict) -> Event:
    return Event(
        type=event_type,
        source="bonus-service",
        aggregate_id=str(bonus.get("account_id", "")),
        data={
            "bonus_id": bonus.get("id", ""),
            "account_id": bonus.get("account_id", ""),
            "rule_id": bonus.get("rule_id", ""),
            "type": bonus.get("type", ""),
            "amount": bonus.get("amount", 0),
            "wagering_required": bonus.get("wagering_required", 0),
            "wagering_progress": bonus.get("wagering_progress", 0),
        },
    )


def new_risk_event(event_type: str, risk: dict) -> Event:
    return Event(
        type=event_type,
        source="risk-service",
        aggregate_id=str(risk.get("account_id", "")),
        data={
            "account_id": risk.get("account_id", ""),
            "transaction_id": risk.get("transaction_id", ""),
            "score": risk.get("score", 0),
            "action": risk.get("action", ""),
            "reason_codes": risk.get("reason_codes", []),
        },
    )


# -- transport selection ------------------------------------------------------


def is_amqp_url(transport) -> bool:
    return isinstance(transport, str) and transport.startswith("amqp://")


def _in_process(transport) -> InMemoryBroker:
    """The transport as an in-process broker; any URL fails loudly."""
    if is_amqp_url(transport):
        raise NotImplementedError(
            "the AMQP transport is not ported yet (ROADMAP.md, Queue 1); "
            "pass an InMemoryBroker")
    if isinstance(transport, str):
        raise ValueError(
            f"unsupported event transport URL {transport!r}: only amqp:// is "
            "supported (amqps:// TLS termination belongs to a sidecar/proxy)")
    return transport


def make_publisher(transport) -> Publisher:
    """Publisher for a transport: an ``InMemoryBroker`` instance."""
    return Publisher(_in_process(transport))


def make_consumer(transport, prefetch: int = 64, max_redelivery: int = 5) -> Consumer:
    """Consumer for a transport: an ``InMemoryBroker`` instance."""
    return Consumer(_in_process(transport), prefetch=prefetch, max_redelivery=max_redelivery)


def resolve_transport(broker, rabbitmq_url: str):
    """An explicit broker wins; otherwise EVENT_TRANSPORT=amqp selects the
    service's RABBITMQ_URL (which make_publisher/make_consumer refuse until
    the AMQP client is ported), and the default is a fresh in-process broker
    with the canonical topology."""
    if broker is not None:
        return broker
    mode = os.environ.get("EVENT_TRANSPORT", "memory").strip().lower()
    if mode == "amqp":
        if not is_amqp_url(rabbitmq_url):
            _in_process(rabbitmq_url)
        return rabbitmq_url
    if mode != "memory":
        # A typo ('AMQP ', 'rabbitmq') must not silently become a private
        # in-process broker that delivers to nobody.
        raise ValueError(
            f"unknown EVENT_TRANSPORT {mode!r}: expected 'memory' or 'amqp'"
        )
    return default_broker()
