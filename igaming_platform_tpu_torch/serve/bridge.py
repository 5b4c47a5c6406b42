"""Event-stream scoring bridge: queue -> features and histories -> scores -> risk events.

The port's counterpart of ``igaming_platform_tpu/serve/bridge.py``: consume
the wallet's Bet/Deposit/Withdraw events, score each on the pre-transaction
feature state, fold it into the feature store and into the bonus-abuse
detector's histories (the only writer of those histories), and publish risk
events for blocked and high-score transactions. Used live (``drain`` or a
consumer thread) and offline (``replay``, BASELINE config 2).

``replay`` takes the columnar path whenever the store has
``gather_columns`` and ``update_columns`` (the native store), and the
object path otherwise, as the JAX bridge does.
"""

from __future__ import annotations

import time
from typing import Iterable

import numpy as np

from igaming_platform_tpu_torch.core.enums import (
    ACTION_BLOCK,
    EXCHANGE_RISK,
    QUEUE_RISK_SCORING,
    EventType,
    decode_reason_mask,
)
from igaming_platform_tpu_torch.serve.batcher import CollectorPipeline
from igaming_platform_tpu_torch.serve.events import (
    DeliveryDeduper,
    Event,
    InMemoryBroker,
    make_consumer,
    make_publisher,
    new_risk_event,
)
from igaming_platform_tpu_torch.serve.feature_store import TransactionEvent
from igaming_platform_tpu_torch.serve.scorer import ScoreRequest, TorchScoringEngine

_MONEY_EVENT_TYPES = {
    EventType.TRANSACTION_COMPLETED.value,
    EventType.DEPOSIT_RECEIVED.value,
    EventType.WITHDRAWAL_REQUESTED.value,
    EventType.WITHDRAWAL_COMPLETED.value,
    EventType.BET_PLACED.value,
}


class ScoringBridge:
    """Queue -> feature update -> batched scoring -> risk events."""

    def __init__(
        self,
        engine: TorchScoringEngine,
        broker: InMemoryBroker,
        *,
        abuse_detector=None,
        publish_risk_events: bool = True,
        high_score_threshold: int = 70,
    ):
        self.engine = engine
        self.broker = broker
        self.publisher = make_publisher(broker)
        self.abuse_detector = abuse_detector
        self.publish_risk_events = publish_risk_events
        self.high_score_threshold = high_score_threshold
        self.events_processed = 0
        self.events_skipped = 0
        self.events_deduped = 0
        # Deliveries are at-least-once: dedupe on the envelope id so a
        # redelivery cannot double-count velocity features.
        self._dedupe = DeliveryDeduper()
        self._consumer = make_consumer(broker)
        self._consumer.subscribe(QUEUE_RISK_SCORING, self._handle_event)

    def start(self) -> None:
        self._consumer.start()

    def stop(self) -> None:
        self._consumer.stop()

    def drain(self, max_events: int | None = None) -> int:
        """Synchronously process queued events."""
        return self._consumer.drain(QUEUE_RISK_SCORING, max_events=max_events)

    # -- event handling ------------------------------------------------------

    def _event_to_request(self, event: Event) -> ScoreRequest | None:
        """Money events scored by the risk pipeline (deposit/withdraw/bet).
        Wins and bonus movements are ingested but not risk-gated, as at the
        wallet's call sites."""
        if event.type not in _MONEY_EVENT_TYPES:
            return None
        data = event.data
        account_id = str(data.get("account_id") or event.aggregate_id)
        if not account_id:
            return None
        tx_type = str(data.get("type", "deposit"))
        if tx_type not in ("deposit", "withdraw", "bet"):
            return None
        return ScoreRequest(
            account_id=account_id,
            amount=int(data.get("amount", 0)),
            tx_type=tx_type,
            game_id=str(data.get("game_id", "")),
            ip=str(data.get("ip", "")),
            device_id=str(data.get("device_id", "")),
        )

    def _ingest_only(self, event: Event) -> bool:
        """Fold a non-scored money event (e.g. win) into the features."""
        if event.type not in _MONEY_EVENT_TYPES:
            return False
        data = event.data
        account_id = str(data.get("account_id") or event.aggregate_id)
        tx_type = str(data.get("type", ""))
        if not account_id or tx_type not in ("win", "refund", "bonus_grant", "bonus_wager"):
            return False
        req = ScoreRequest(
            account_id=account_id, amount=int(data.get("amount", 0)), tx_type=tx_type,
            device_id=str(data.get("device_id", "")), ip=str(data.get("ip", "")),
        )
        self._ingest(event, req)
        return True

    def _handle_event(self, event: Event) -> None:
        # The claim is taken before the side effects (so a redelivery cannot
        # double-count) and released if the handler fails (so the consumer's
        # requeue is not misread as a duplicate). Events without an id are
        # processed as they are.
        claimed = bool(event.id) and self._dedupe.claim(event.id)
        if event.id and not claimed:
            self.events_deduped += 1
            return
        try:
            self._process_event(event)
        except BaseException:
            if claimed:
                self._dedupe.release(event.id)
            raise

    def _process_event(self, event: Event) -> None:
        req = self._event_to_request(event)
        if req is None:
            if self._ingest_only(event):
                self.events_processed += 1
            else:
                self.events_skipped += 1
            return
        # Score first, then write back: the reference risk-gates on the
        # pre-transaction state (engine.go:262 vs :486-488).
        resp = self.engine.score(req)
        self._ingest(event, req)
        self.events_processed += 1
        self._publish_outcomes(event, req, resp.score, resp.action,
                               [r.value for r in resp.reason_codes])

    def _ingest(self, event: Event, req: ScoreRequest) -> None:
        self._write_back([TransactionEvent(
            account_id=req.account_id, amount=req.amount, tx_type=req.tx_type,
            ip=req.ip, device_id=req.device_id, timestamp=event.timestamp,
        )])

    def _write_back(self, tx_events: list[TransactionEvent]) -> None:
        """Post-score write-back into the feature store and the abuse histories."""
        for te in tx_events:
            self.engine.update_features(te)
        if self.abuse_detector is not None:
            for te in tx_events:
                self.abuse_detector.record_event(
                    te.account_id, te.amount, te.tx_type,
                    device_id=te.device_id, timestamp=te.timestamp,
                )

    def _publish_outcomes(self, event: Event, req: ScoreRequest, score: int, action: str,
                          reasons: list[str]) -> None:
        if not self.publish_risk_events:
            return
        payload = {
            "account_id": req.account_id,
            "transaction_id": str(event.data.get("transaction_id", "")),
            "score": score,
            "action": action,
            "reason_codes": reasons,
        }
        if action == "block":
            self.publisher.publish(EXCHANGE_RISK, new_risk_event(EventType.RISK_BLOCKED.value, payload))
            self.publisher.publish(EXCHANGE_RISK, new_risk_event(EventType.FRAUD_DETECTED.value, payload))
        elif score >= self.high_score_threshold:
            self.publisher.publish(EXCHANGE_RISK, new_risk_event(EventType.RISK_SCORE_HIGH.value, payload))

    # -- offline replay (BASELINE config 2) ----------------------------------

    def replay(
        self,
        events: Iterable[Event],
        batch_size: int | None = None,
        pipeline_depth: int = 4,
    ) -> dict:
        """Replay a trace through feature update + batched scoring.

        The trace is cut into direct device batches of at most the engine's
        ``batch_size``; results are post-processed as arrays, and only rows
        that publish (blocked / high score) are built as objects. A collector
        thread reads back batch k while the host gathers batch k+1; batch
        k+1's gather still follows batch k's write-back, so every row is
        scored on its pre-transaction state. ``pipeline_depth`` bounds the
        batches in flight (0 = synchronous).
        """
        batch_size = min(batch_size or self.engine.batch_size, self.engine.batch_size)
        store = self.engine.features
        columnar = hasattr(store, "gather_columns") and hasattr(store, "update_columns")
        pending: list[tuple[Event, ScoreRequest]] = []
        counts = {"scored": 0, "blocked": 0}
        start = time.monotonic()

        def postprocess(item) -> None:
            chunk, handle = item
            host = self.engine._readback(handle)  # packed [5, B]: one transfer
            scores, actions, masks = host["score"], host["action"], host["reason_mask"]
            is_blocked = actions == ACTION_BLOCK
            counts["blocked"] += int(is_blocked.sum())
            if self.publish_risk_events:
                notable = np.nonzero(is_blocked | (scores >= self.high_score_threshold))[0]
                for i in notable:
                    ev, req = chunk[i]
                    action = "block" if is_blocked[i] else "review"
                    reasons = [r.value for r in decode_reason_mask(int(masks[i]))]
                    self._publish_outcomes(ev, req, int(scores[i]), action, reasons)
            counts["scored"] += len(chunk)

        pipeline = (
            CollectorPipeline(postprocess, pipeline_depth, name="replay-collector")
            if pipeline_depth > 0
            else None
        )

        def flush():
            if not pending:
                return
            chunk = pending[:]
            pending.clear()
            if columnar:
                self._flush_columnar(chunk, pipeline, postprocess)
                return
            x, bl = store.gather_batch([r for _, r in chunk])
            handle = self.engine._launch(x, bl, self.engine.get_params())
            if pipeline is not None:
                pipeline.put((chunk, handle))  # blocks at depth: backpressure
            else:
                postprocess((chunk, handle))
            self._write_back([
                TransactionEvent(
                    account_id=req.account_id, amount=req.amount, tx_type=req.tx_type,
                    ip=req.ip, device_id=req.device_id, timestamp=ev.timestamp,
                )
                for ev, req in chunk
            ])

        try:
            for event in events:
                req = self._event_to_request(event)
                if req is None:
                    if not self._ingest_only(event):
                        self.events_skipped += 1
                    continue
                pending.append((event, req))
                if len(pending) >= batch_size:
                    flush()
            flush()
        except BaseException:
            # Producer failed: still reap the collector (drain + join).
            if pipeline is not None:
                pipeline.close(raise_errors=False)
            raise
        if pipeline is not None:
            pipeline.close()  # drains remaining batches; re-raises collector errors
        elapsed = time.monotonic() - start
        return {
            "events_scored": counts["scored"],
            "blocked": counts["blocked"],
            "elapsed_s": elapsed,
            "txns_per_sec": counts["scored"] / elapsed if elapsed > 0 else 0.0,
        }

    def _flush_columnar(self, chunk, pipeline, postprocess) -> None:
        """One replay chunk through a columnar store (the JAX bridge's
        ``_replay_columnar``): the chunk's fields as parallel columns, one
        native gather and one native ingest for the whole chunk, scored on
        the pre-transaction state and written back after."""
        store = self.engine.features
        accts = [req.account_id for _, req in chunk]
        amts = [req.amount for _, req in chunk]
        types = [req.tx_type for _, req in chunk]
        ips = [req.ip for _, req in chunk]
        devs = [req.device_id for _, req in chunk]
        ts = [ev.timestamp for ev, _ in chunk]
        x, bl = store.gather_columns(accts, amts, types, ips=ips, devices=devs)
        handle = self.engine._launch(x, bl, self.engine.get_params())
        if pipeline is not None:
            pipeline.put((chunk, handle))  # blocks at depth: backpressure
        else:
            postprocess((chunk, handle))
        store.update_columns(accts, amts, types, ips, devs, ts)
        if self.abuse_detector is not None:
            for i in range(len(ts)):
                self.abuse_detector.record_event(accts[i], amts[i], types[i],
                                                 device_id=devs[i], timestamp=ts[i])
