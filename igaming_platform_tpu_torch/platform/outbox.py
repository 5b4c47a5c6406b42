"""Transactional outbox: stage events with the state change, deliver async.

The reference declares the pattern in its schema — an ``event_outbox`` table
with an unpublished-rows index (deploy/init-db.sql:177-188) — but no code
writes to or drains it: wallet events are published directly to RabbitMQ
after the DB commit (wallet_service.go:319-323), so a crash or a broker
outage in that window silently drops the event. Here the pattern is
actually wired:

- ``OutboxPublisher`` is a Publisher-shaped adapter the WalletService can
  use as its ``events`` seam: ``publish()`` stages the serialized event
  into the same store that holds the transaction row. For SQLite-backed
  wallets the completion update and the event stage commit in ONE
  database transaction (repository.update_with_event, used by
  wallet._complete_and_publish) — a crash cannot mark the money movement
  completed without durably staging its event;
- ``OutboxRelay`` drains unpublished rows to the broker in row order,
  marking each published only after the broker accepts it (the
  publisher-confirm analog, publisher.go:200-209). Delivery is therefore
  at-least-once: a crash between publish and mark re-delivers on restart,
  never drops. Consumers dedupe on the event envelope ``id``.

Broker-outage behavior mirrors the consumer side's nack-requeue
(publisher.go:354-371): a failed publish leaves the row unpublished and the
relay backs off and retries; rows are never discarded.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Protocol

from igaming_platform_tpu_torch.serve.events import Event


class OutboxStore(Protocol):
    """The three outbox operations (implemented by SQLiteStore and
    InMemoryOutbox)."""

    def outbox_add(self, exchange: str, routing_key: str, payload: str) -> None: ...
    def outbox_drain(self) -> Iterable[tuple[int, str, str, str]]: ...
    def outbox_mark_published(self, row_id: int) -> None: ...


class InMemoryOutbox:
    """Outbox semantics without a durable store — gives in-memory
    deployments the same staged-then-delivered event flow so tests and
    the single-binary app behave identically across backends."""

    def __init__(self):
        self._rows: list[tuple[int, str, str, str]] = []
        self._next_id = 1
        self._lock = threading.Lock()

    def outbox_add(self, exchange: str, routing_key: str, payload: str) -> None:
        with self._lock:
            self._rows.append((self._next_id, exchange, routing_key, payload))
            self._next_id += 1

    def outbox_drain(self) -> list[tuple[int, str, str, str]]:
        with self._lock:
            return list(self._rows)

    def outbox_mark_published(self, row_id: int) -> None:
        # Published rows are removed outright (no durability to preserve
        # in-memory); rows are marked in drain order, so the scan almost
        # always hits index 0.
        with self._lock:
            for i, row in enumerate(self._rows):
                if row[0] == row_id:
                    self._rows.pop(i)
                    break


class OutboxPublisher:
    """Publisher-shaped adapter: stages into the outbox instead of the wire.

    Drop-in for the ``events`` seam of WalletService/BonusEngine — same
    ``publish``/``publish_with_routing`` surface as serve.events.Publisher.
    """

    def __init__(self, outbox: OutboxStore):
        self.outbox = outbox

    def publish(self, exchange: str, event: Event) -> None:
        self.publish_with_routing(exchange, event.type, event)

    def publish_with_routing(self, exchange: str, routing_key: str, event: Event) -> None:
        self.outbox.outbox_add(exchange, routing_key, event.to_json())


class OutboxRelay:
    """Drains unpublished outbox rows to the broker, in insertion order.

    ``target`` is anything with ``publish_raw(exchange, routing_key,
    payload)`` (InMemoryBroker, or a RabbitMQ adapter). A publish failure
    stops the current drain (preserving order), leaves the row unpublished,
    and backs off exponentially up to ``max_backoff_s``.
    """

    def __init__(
        self,
        outbox: OutboxStore,
        target,
        poll_interval_s: float = 0.05,
        max_backoff_s: float = 5.0,
        purge_interval_s: float = 60.0,
        purge_retention_s: float = 3600.0,
    ):
        self.outbox = outbox
        self.target = target
        self.poll_interval_s = poll_interval_s
        self.max_backoff_s = max_backoff_s
        self.purge_interval_s = purge_interval_s
        self.purge_retention_s = purge_retention_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._backoff = 0.0
        self._last_purge = time.monotonic()
        self.published_total = 0
        self.failed_total = 0

    # -- synchronous drain (tests, pump loops) -------------------------------

    def flush(self) -> int:
        """Publish every unpublished row now; returns the number delivered.

        Stops at the first failure — publish OR store error — so downstream
        consumers never observe event N+1 before event N from the same
        store. Never raises: a row that fails stays unpublished and is
        retried on the next drain.
        """
        try:
            rows = list(self.outbox.outbox_drain())
        except Exception:  # noqa: BLE001 — store hiccup: retry next poll
            self.failed_total += 1
            self._bump_backoff()
            return 0
        published = 0
        for row_id, exchange, routing_key, payload in rows:
            try:
                self.target.publish_raw(exchange, routing_key, payload)
                # Mark AFTER the broker accepted it: crash between the two
                # re-delivers (at-least-once), never drops. A mark failure
                # also stops the drain — the row re-delivers later.
                self.outbox.outbox_mark_published(row_id)
            except Exception:  # noqa: BLE001 — broker/store down: retry later
                self.failed_total += 1
                self._bump_backoff()
                self.published_total += published
                return published
            published += 1
        self.published_total += published
        self._backoff = 0.0
        return published

    def _bump_backoff(self) -> None:
        self._backoff = min(max(self._backoff * 2, self.poll_interval_s), self.max_backoff_s)

    # -- background mode ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="outbox-relay", daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if drain:
            self.flush()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.flush()
            self._maybe_purge()
            self._stop.wait(self.poll_interval_s + self._backoff)

    def _maybe_purge(self) -> None:
        """Durable stores keep published rows; reclaim them past retention
        so event_outbox doesn't grow one row per money movement forever."""
        purge = getattr(self.outbox, "outbox_purge_published", None)
        if purge is None:
            return
        now = time.monotonic()
        if now - self._last_purge < self.purge_interval_s:
            return
        self._last_purge = now
        try:
            purge(self.purge_retention_s)
        except Exception:  # noqa: BLE001 — housekeeping must not kill the relay
            pass
