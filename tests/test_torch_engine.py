"""Port parity: the feature store, the batcher and TorchScoringEngine on the CPU.

- The port's ``InMemoryFeatureStore`` gathers the same bits as the JAX
  package's after the same event stream, with the clock pinned.
- ``TorchScoringEngine(device="cpu", ml_backend="mlp+gbdt")`` answers
  ``score_batch`` and ``score`` as the JAX package's ``make_score_fn``
  scores the rows the engine gathered (each response carries its row), at
  the tolerances of tests/test_torch_ensemble.py.
- Thresholds are an input: ``set_thresholds`` changes actions and rebuilds
  nothing. ``swap_params`` changes what is served.
- With no ``device`` argument and no card, the engine raises.
"""

import threading

import numpy as np
import pytest
import torch
from test_torch_ensemble import assert_outputs_match
from test_torch_gbdt import _forest
from test_torch_models import mlp_tree

from igaming_platform_tpu.core.config import ScoringConfig as JScoringConfig
from igaming_platform_tpu.models.ensemble import make_score_fn as jmake_score_fn
from igaming_platform_tpu.serve.feature_store import InMemoryFeatureStore as JStore
from igaming_platform_tpu.serve.feature_store import TransactionEvent as JEvent
from igaming_platform_tpu_torch.convert import from_jax_params
from igaming_platform_tpu_torch.core.config import BatcherConfig
from igaming_platform_tpu_torch.core.enums import REASON_BIT_ORDER, Action
from igaming_platform_tpu_torch.models.ensemble import make_score_fn
from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore, TransactionEvent
from igaming_platform_tpu_torch.serve.scorer import (
    ScoreRequest,
    TorchScoringEngine,
    _stack_packed,
    _unpack_host,
)

T0 = 1_700_000_000.0
N_ACCOUNTS = 40
TX_TYPES = ("deposit", "withdraw", "bet", "win")
ACTION_CODES = {Action.APPROVE.value: 1, Action.REVIEW.value: 2, Action.BLOCK.value: 3}


def _events(seed, n=600):
    """An event stream over the last two days before T0, oldest first."""
    rng = np.random.default_rng(seed)
    ts = np.sort(T0 - rng.random(n) * rng.choice([600.0, 7200.0, 172800.0], n))
    for i in range(n):
        yield dict(account_id=f"acct{rng.integers(N_ACCOUNTS)}",
                   amount=int(rng.integers(100, 500_000)),
                   tx_type=TX_TYPES[rng.integers(4)],
                   ip=f"10.0.{rng.integers(4)}.{rng.integers(30)}",
                   device_id=f"dev{rng.integers(12)}", timestamp=float(ts[i]))


def _fill(store, event_cls):
    for ev in _events(0):
        store.update(event_cls(**ev))
    for k in range(0, N_ACCOUNTS, 7):
        for _ in range(k % 5 + 1):
            store.record_bonus_claim(f"acct{k}", wager_complete_rate=0.25)
    store.add_to_blacklist("device", "dev3")
    store.add_to_blacklist("ip", "10.0.1.7")
    return store


def _requests(seed, n):
    rng = np.random.default_rng(seed)
    return [ScoreRequest(account_id=f"acct{rng.integers(N_ACCOUNTS + 5)}",
                         amount=int(rng.integers(100, 2_000_000)),
                         tx_type=TX_TYPES[rng.integers(3)],
                         ip=f"10.0.{rng.integers(4)}.{rng.integers(30)}",
                         device_id=f"dev{rng.integers(12)}",
                         ip_flags=tuple(int(v) for v in rng.random(3) < 0.1)
                         if rng.random() < 0.5 else None)
            for _ in range(n)]


def _trees(mlp_seed=10):
    return {"mlp": mlp_tree(mlp_seed), "gbdt": _forest(11)}


def test_feature_store_gathers_same_bits():
    jstore, tstore = _fill(JStore(), JEvent), _fill(InMemoryFeatureStore(), TransactionEvent)
    reqs = _requests(1, 300)
    for now in (T0, T0 + 45.0, T0 + 3601.0):
        jx, jbl = jstore.gather_batch(reqs, now=now)
        tx, tbl = tstore.gather_batch(reqs, now=now)
        assert tx.dtype == np.float32
        np.testing.assert_array_equal(tx.view(np.int32), jx.view(np.int32))
        np.testing.assert_array_equal(tbl, jbl)
    assert tbl.any() and (tx[:, 5] > 0).any()


@pytest.fixture
def engine():
    eng = TorchScoringEngine(
        ml_backend="mlp+gbdt", device="cpu",
        params=from_jax_params("mlp+gbdt", _trees()),
        batcher_config=BatcherConfig(batch_size=256, latency_tiers=(64,), max_wait_ms=5.0),
        feature_store=_fill(InMemoryFeatureStore(), TransactionEvent))
    try:
        yield eng
    finally:
        eng.close()


def _as_outputs(responses):
    """Responses -> the score fn's dict of [N] tensors, plus the gathered rows."""
    masks = [sum(1 << REASON_BIT_ORDER.index(c) for c in r.reason_codes) for r in responses]
    got = {
        "score": torch.tensor([r.score for r in responses], dtype=torch.int32),
        "action": torch.tensor([ACTION_CODES[r.action] for r in responses], dtype=torch.int32),
        "rule_score": torch.tensor([r.rule_score for r in responses], dtype=torch.int32),
        "ml_score": torch.tensor([r.ml_score for r in responses], dtype=torch.float32),
        "reason_mask": torch.tensor(masks, dtype=torch.int32),
    }
    return got, np.stack([r.features.to_array() for r in responses])


def _jax_scores(engine, reqs, x):
    bl = np.array([engine.features.check_blacklist(r.device_id, r.fingerprint, r.ip)
                   for r in reqs])
    return jmake_score_fn(JScoringConfig(), "mlp+gbdt")(_trees(), x, bl)


def test_engine_shape_ladder(engine):
    assert engine._shapes == [64, 256]
    assert [engine._pick_shape(n) for n in (1, 64, 65, 256)] == [64, 64, 256, 256]


def test_score_batch_crosses_chunks(engine):
    reqs = _requests(2, 600)
    steps = engine.device_steps
    responses = engine.score_batch(reqs)
    assert len(responses) == 600
    assert engine.device_steps - steps == 3  # 256 + 256 + 88 rows
    got, x = _as_outputs(responses)
    assert_outputs_match(got, _jax_scores(engine, reqs, x), "engine score_batch")
    assert len({r.response_time_ms for r in responses}) == 1


def test_score_through_batcher(engine):
    reqs = _requests(3, 24)
    out = [None] * len(reqs)

    def one(i):
        out[i] = engine.score(reqs[i], timeout=30.0)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert all(r is not None and r.response_time_ms > 0 for r in out)
    got, x = _as_outputs(out)
    assert_outputs_match(got, _jax_scores(engine, reqs, x), "engine score()")
    assert 1 <= engine._batcher.batches_run <= len(reqs)


def test_set_thresholds_flips_actions_without_rebuild(engine):
    fn = engine._score_fn
    reqs = _requests(4, 300)
    assert Action.APPROVE.value in {r.action for r in engine.score_batch(reqs)}
    engine.set_thresholds(1, 0)
    assert engine.get_thresholds() == (1, 0)
    responses = engine.score_batch(reqs)
    assert engine._score_fn is fn
    for r in responses:
        assert r.action == (Action.BLOCK.value if r.score >= 1 else Action.REVIEW.value)


def test_score_arrays_and_swap_params(engine):
    reqs = _requests(5, 64)
    x, bl = engine.features.gather_batch(reqs, now=T0)
    before = engine.score_arrays(x, bl)["ml_score"].clone()
    want = _jax_scores(engine, reqs, x)["ml_score"]
    np.testing.assert_allclose(before.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    engine.swap_params(from_jax_params("mlp+gbdt", _trees(mlp_seed=99)))
    after = engine.score_arrays(x, bl)["ml_score"]
    assert not torch.equal(before, after)
    assert engine.get_params()["mlp"] is not None


def test_packed_result_round_trip():
    out = make_score_fn(JScoringConfig(), "mock", device="cpu")(
        None, np.abs(np.random.default_rng(6).normal(size=(9, 30))).astype(np.float32) * 10,
        np.zeros(9, dtype=bool))
    packed = _stack_packed(out)
    assert packed.shape == (5, 9) and packed.dtype == torch.int32
    host = _unpack_host(packed.numpy())
    for key, value in out.items():
        np.testing.assert_array_equal(host[key], value.numpy())


def test_engine_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchScoringEngine(ml_backend="mock")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_score_fn(JScoringConfig(), "mock")
