"""Port parity: serve/events.py and serve/bridge.py, the event-stream path.

One seeded wallet event stream (money events with shared and blacklisted
devices, wins and bonus movements, non-money events, a redelivered
duplicate) goes through the JAX package's ``ScoringBridge`` over a
``TPUScoringEngine`` (mock backend, Python store) and through the port's
over a ``device="cpu"`` ``TorchScoringEngine``, each with an abuse detector.
Both stores see one pinned clock. Counts, published risk events, feature
rows and abuse histories must be equal, live (``drain``) and in ``replay``;
and in ``replay`` over both packages' native stores, where both bridges
take their columnar path.
"""

import types

import numpy as np
import pytest

import igaming_platform_tpu.serve.feature_store as jfs
import igaming_platform_tpu.serve.native_store as jns
from igaming_platform_tpu.core.config import BatcherConfig as JBatcherConfig
from igaming_platform_tpu.serve.abuse import SequenceAbuseDetector as JDetector
from igaming_platform_tpu.serve.bridge import ScoringBridge as JBridge
from igaming_platform_tpu.serve.events import default_broker as jdefault_broker
from igaming_platform_tpu.serve.scorer import TPUScoringEngine
from igaming_platform_tpu_torch.core.config import BatcherConfig
from igaming_platform_tpu_torch.core.enums import EXCHANGE_WALLET, QUEUE_NOTIFICATIONS
from igaming_platform_tpu_torch.serve import events
from igaming_platform_tpu_torch.serve.abuse import SequenceAbuseDetector
from igaming_platform_tpu_torch.serve.bridge import ScoringBridge
from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore
from igaming_platform_tpu_torch.serve.native_store import NativeFeatureStore
from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine
from torch_front_common import no_jax_hostprof  # noqa: F401 — a fixture

NOW = 1_700_000_000.0
MONEY = ("deposit", "withdraw", "bet", "win", "bonus_grant", "bonus_wager", "refund")


def _stream(seed=0, n=400):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        acct = f"acct{rng.integers(30)}"
        kind = rng.choice(["transaction.completed", "bet.placed", "deposit.received",
                           "account.created"], p=[0.6, 0.2, 0.15, 0.05])
        tx = {"id": f"tx{i}", "account_id": acct, "amount": int(rng.integers(100, 900_000)),
              "type": str(rng.choice(MONEY)), "status": "completed"}
        ev = events.new_transaction_event(str(kind), tx)
        ev.data["device_id"] = f"dev{rng.integers(15)}"
        ev.timestamp = NOW - 7200 + 18.0 * i
        out.append(ev)
    out.append(out[5])  # a redelivery: same envelope id
    return out


def _bridges(monkeypatch, detector_kw, native=False):
    clock = types.SimpleNamespace(time=lambda: NOW)
    monkeypatch.setattr(jfs, "time", clock)
    monkeypatch.setattr(jns, "time", clock)
    stores = ((jns.NativeFeatureStore(max_accounts=100), NativeFeatureStore(
        max_accounts=100, clock=lambda: NOW)) if native
        else (None, InMemoryFeatureStore(clock=lambda: NOW)))
    jeng = TPUScoringEngine(feature_store=stores[0], batcher_config=JBatcherConfig(
        batch_size=64, latency_tiers=(), max_wait_ms=1))
    teng = TorchScoringEngine(device="cpu", feature_store=stores[1],
                              batcher_config=BatcherConfig(batch_size=64, latency_tiers=(),
                                                           max_wait_ms=1))
    for eng in (jeng, teng):
        eng.features.add_to_blacklist("device", "dev3")
        eng.set_thresholds(55, 30)
    jb = JBridge(jeng, jdefault_broker(), high_score_threshold=35,
                 abuse_detector=JDetector(**detector_kw))
    tb = ScoringBridge(teng, events.default_broker(), high_score_threshold=35,
                       abuse_detector=SequenceAbuseDetector(device="cpu", **detector_kw))
    return jb, tb


def _published(broker):
    out = []
    while (raw := broker.get(QUEUE_NOTIFICATIONS, timeout=0)) is not None:
        ev = events.Event.from_json(raw)
        out.append((ev.type, ev.data))
    return out


def _assert_same_state(jb, tb, accounts):
    for acct in accounts:
        for tx_type in ("deposit", "bet"):
            rows = [np.zeros(30, np.float32) for _ in range(2)]
            jb.engine.features.fill_row(rows[0], acct, 5000, tx_type, now=NOW)
            tb.engine.features.fill_row(rows[1], acct, 5000, tx_type, now=NOW)
            np.testing.assert_array_equal(rows[1].view(np.int32), rows[0].view(np.int32))
    np.testing.assert_array_equal(tb.abuse_detector._history_matrix(accounts, 64),
                                  jb.abuse_detector._history_matrix(accounts, 64))


@pytest.mark.usefixtures("no_jax_hostprof")
@pytest.mark.parametrize("mode", ["drain", "replay", "replay_native"])
def test_bridge_matches_jax(monkeypatch, mode):
    jb, tb = _bridges(monkeypatch, dict(policy="heuristic"), native=mode == "replay_native")
    stream = _stream()
    try:
        if mode == "drain":
            for b in (jb, tb):
                for ev in stream:
                    b.broker.publish_raw(EXCHANGE_WALLET, ev.type, ev.to_json())
            assert tb.drain() == jb.drain() == len(stream)
            assert tb.events_deduped == jb.events_deduped == 1
        else:
            got, want = tb.replay(stream, batch_size=32), jb.replay(stream, batch_size=32)
            assert (got["events_scored"], got["blocked"]) == (want["events_scored"],
                                                             want["blocked"])
            assert got["events_scored"] > 100
        counts = [(b.events_processed, b.events_skipped) for b in (jb, tb)]
        assert counts[0] == counts[1] and counts[1][1] > 0
        published = [_published(b.broker) for b in (jb, tb)]
        assert published[1] == published[0]
        assert {t for t, _ in published[1]} == {"risk.blocked", "fraud.detected",
                                                "risk.score.high"}
        accounts = [f"acct{a}" for a in range(30)]
        _assert_same_state(jb, tb, accounts)
        assert tb.abuse_detector.check_batch(accounts).tolist() == \
            jb.abuse_detector.check_batch(accounts).tolist()
    finally:
        jb.engine.close()
        tb.engine.close()


def test_transports_and_envelope(monkeypatch):
    broker = events.default_broker()
    # An amqp:// URL takes the wire client (tests/test_torch_amqp.py drives
    # it); a consumer connects only when started.
    from igaming_platform_tpu_torch.serve.amqp import AmqpConsumer

    assert isinstance(events.make_consumer("amqp://guest@localhost:5672/"), AmqpConsumer)
    with pytest.raises(ValueError, match="unsupported event transport"):
        events.make_publisher("redis://localhost")
    assert events.resolve_transport(broker, "") is broker
    monkeypatch.setenv("EVENT_TRANSPORT", "rabbit")
    with pytest.raises(ValueError, match="unknown EVENT_TRANSPORT"):
        events.resolve_transport(None, "")
    ev = events.new_bonus_event("bonus.granted", {"id": "b1", "account_id": "a", "amount": 5})
    assert events.Event.from_json(ev.to_json()) == ev
    assert events.topic_matches("bet.*", "bet.placed")
    assert events.topic_matches("#", "a.b.c") and not events.topic_matches("bet.*", "bet.a.b")
