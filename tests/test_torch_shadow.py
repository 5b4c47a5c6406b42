"""Port parity: serve/shadow.py, the shadow scorer, and the engine's shadow seam.

On the CPU, with params carried from seeded JAX trees:

- a production engine with a candidate in shadow, fused (scored in the
  step's own enqueue) and split (``SHADOW_FUSED=0``: the shadow's worker
  scores the device copy of the batch), on the float32 and int8 row wires:
  the candidate's outputs bit-equal to offline scoring of the same rows by
  an engine serving the candidate, the divergence stats equal between the
  two layouts, and production's answers equal to an engine without a
  shadow; the JAX package's shadow on its own engine gives the same
  window stats;
- a candidate that raises and a queue that overflows: production's answers
  unchanged, the failures and drops counted;
- a candidate change drops the queued batches of the old one as stale;
- the session step's shadow variant: the candidate's outputs equal a
  session engine serving the candidate over the same stream, the rings
  bit-equal, and the session head run once per step (its forward kernel's
  launches equal the session steps on the card).
"""

import threading

import numpy as np
import pytest
from test_torch_models import mlp_tree

from igaming_platform_tpu.core.config import BatcherConfig as JBatcherConfig
from igaming_platform_tpu.serve.scorer import TPUScoringEngine
from igaming_platform_tpu.serve.shadow import ShadowScorer as JShadowScorer
from igaming_platform_tpu_torch.convert import from_jax_params
from igaming_platform_tpu_torch.core.config import BatcherConfig
from igaming_platform_tpu_torch.core.enums import SESSION_PATTERN_BIT
from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore, TransactionEvent
from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine
from igaming_platform_tpu_torch.serve.shadow import ShadowScorer

T0 = 1_700_000_000.0
KEYS = ("score", "action", "reason_mask", "rule_score", "ml_score")
KW = dict(batch_size=64, latency_tiers=(8, 32), max_wait_ms=1.0)


def _tree(seed):
    return {"mlp": mlp_tree(seed, hidden=(16, 16))}


def _rows(n: int, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = np.zeros((n, 30), dtype=np.float32)
    x[:, 0] = rng.integers(100, 80_000, n)
    x[:, 1] = rng.integers(0, 40, n)
    x[:, 2] = rng.uniform(0, 1, n)
    x[:, 5] = rng.integers(0, 5000, n)
    x[:, 26] = rng.integers(100, 2_000_000, n)
    return x


def _engine(tree, **kw):
    return TorchScoringEngine(ml_backend="mlp", params=from_jax_params("mlp", tree), device="cpu",
                              batcher_config=BatcherConfig(**{**KW, **kw.pop("bcfg", {})}), **kw)


def _run(engine, x, bl):
    """Score [N, 30] rows through the engine's row launch, chunked as the
    wire paths chunk: the result dict of host arrays."""
    parts = [engine._readback(engine._launch(x[lo:lo + engine.batch_size],
                                             bl[lo:lo + engine.batch_size], engine.get_params()))
             for lo in range(0, x.shape[0], engine.batch_size)]
    return {k: np.concatenate([p[k] for p in parts]) for k in KEYS}


def _assert_bit_equal(got, want, label):
    for k in KEYS[:4]:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{label} {k}")
    np.testing.assert_array_equal(np.asarray(got["ml_score"], np.float32).view(np.uint32),
                                  np.asarray(want["ml_score"], np.float32).view(np.uint32),
                                  err_msg=f"{label} ml_score")


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_shadow_equals_offline_candidate_scoring(wire, monkeypatch):
    monkeypatch.setenv("WIRE_DTYPE", wire)
    p0, p1 = _tree(0), _tree(1)
    x = _rows(150)
    bl = np.random.default_rng(6).random(150) < 0.1
    ref_eng, plain = _engine(p1), _engine(p0)
    ref, base = _run(ref_eng, x, bl), _run(plain, x, bl)
    ref_eng.close()
    plain.close()

    stats = {}
    for mode in ("fused", "split"):
        monkeypatch.setenv("SHADOW_FUSED", "1" if mode == "fused" else "0")
        eng = _engine(p0)
        results = []
        sh = ShadowScorer(eng, from_jax_params("mlp", p1),
                          on_result=lambda c, p, n: results.append((c, p, n)))
        eng.shadow = sh
        try:
            prod = _run(eng, x, bl)
            assert sh.drain(30.0)
            rep = sh.report()
            assert rep["errors"] == 0 and rep["window"]["rows"] == 150
            assert (rep["fused_batches"] > 0) == (mode == "fused")
            assert (sh.split_steps > 0) == (mode == "split")
            cand = {k: np.concatenate([c[k] for c, _, _ in results]) for k in KEYS}
            _assert_bit_equal(cand, ref, f"{wire} {mode} candidate")
            _assert_bit_equal(prod, base, f"{wire} {mode} production")
            stats[mode] = rep["window"]
            assert rep["candidate_fp"] != rep["production_fp"]
        finally:
            sh.close()
            eng.close()
    assert stats["fused"] == stats["split"]
    assert stats["fused"]["action_flips"] > 0 or stats["fused"]["ml_delta_max"] > 0

    # The JAX shadow over its own engine, fed the same rows: the same window.
    jeng = TPUScoringEngine(ml_backend="mlp", params=p0, batcher_config=JBatcherConfig(**KW))
    jsh = JShadowScorer(jeng, p1)
    jeng.shadow = jsh
    try:
        for lo in range(0, 150, 64):
            jeng._run_device(x[lo:lo + 64], bl[lo:lo + 64])
        assert jsh.drain(30.0)
        jwin = jsh.report()["window"]
        assert {k: jwin[k] for k in ("rows", "batches", "action_flips", "flips_by_direction",
                                     "score_delta_max")} == \
            {k: stats["fused"][k] for k in ("rows", "batches", "action_flips",
                                            "flips_by_direction", "score_delta_max")}
        assert abs(jwin["ml_delta_mean"] - stats["fused"]["ml_delta_mean"]) <= 1e-6
        assert set(jsh.report()) == set(sh.report())
    finally:
        jsh.close()
        jeng.close()


@pytest.mark.parametrize("fault", ["raises", "overflows"])
def test_failing_or_overflowing_shadow_never_touches_production(fault, monkeypatch):
    x = _rows(150, seed=7)
    bl = np.zeros(150, bool)
    plain = _engine(_tree(0))
    base = _run(plain, x, bl)
    plain.close()
    for mode in ("1", "0"):
        monkeypatch.setenv("SHADOW_FUSED", mode)
        eng = _engine(_tree(0))
        if fault == "raises":  # a candidate whose first layer takes 29 features
            bad = _tree(1)
            bad["mlp"]["layers"][0]["w"] = bad["mlp"]["layers"][0]["w"][:29]
            sh = ShadowScorer(eng, from_jax_params("mlp", bad))
        else:
            sh = ShadowScorer(eng, from_jax_params("mlp", _tree(1)), queue_max_rows=40)
        eng.shadow = sh
        try:
            _assert_bit_equal(_run(eng, x, bl), base, f"{fault} SHADOW_FUSED={mode}")
            assert sh.drain(30.0)
            rep = sh.report()
            if fault == "raises":
                assert rep["errors"] == 3 and rep["total"]["rows"] == 0
            else:
                assert rep["rows_dropped"] > 0 and rep["errors"] == 0
                assert rep["total"]["rows"] + rep["rows_dropped"] == 150
        finally:
            sh.close()
            eng.close()


def test_candidate_change_drops_stale_batches():
    eng = _engine(_tree(0))
    gate, entered = threading.Event(), threading.Event()

    def hold(c, p, n):
        entered.set()
        gate.wait(30.0)

    sh = ShadowScorer(eng, from_jax_params("mlp", _tree(1)), on_result=hold)
    eng.shadow = sh
    x = _rows(150, seed=8)
    try:
        eng._readback(eng._launch(x[:64], np.zeros(64, bool), eng.get_params()))
        assert entered.wait(30.0)  # the worker holds the first batch
        _run(eng, x[64:], np.zeros(86, bool))
        fp = sh.set_candidate(from_jax_params("mlp", _tree(2)))
        assert fp == sh.report()["candidate_fp"] and sh.window_rows() == 0
        gate.set()
        assert sh.drain(30.0)
        rep = sh.report()
        assert rep["total"]["rows"] == 64 and rep["window"]["rows"] == 0 and rep["errors"] == 0
    finally:
        gate.set()
        sh.close()
        eng.close()


def _session_engine(tree, store, monkeypatch):
    monkeypatch.setenv("SESSION_EVENTS", "6")
    monkeypatch.setenv("SESSION_MIN_EVENTS", "2")
    monkeypatch.setenv("SESSION_FLAG_THRESHOLD", "0.175")
    monkeypatch.setenv("SESSION_HEAD", "transformer")
    eng = _engine(tree, feature_store=store, feature_cache=64, session_state=True,
                  bcfg=dict(batch_size=16, latency_tiers=(8,)))
    eng.ensure_cache()
    return eng


def _store():
    store = InMemoryFeatureStore(clock=lambda: T0)
    for i in range(60):
        store.update(TransactionEvent(f"s{i % 5}", 1000 + 37 * i, ("deposit", "bet")[i % 2],
                                      timestamp=T0 - 3000 + 40 * i))
    return store


@pytest.mark.parametrize("fused", ["1", "0"])
def test_session_shadow_equals_candidate_session_engine(fused, monkeypatch):
    monkeypatch.setenv("FUSED", fused)
    p0, p1 = _tree(0), _tree(1)
    ids = [f"s{i % 5}" for i in range(45)]
    amounts = [200.0 + 13 * i for i in range(45)]
    types = ["bet", "deposit", "bet"] * 15
    ref_eng = _session_engine(p1, _store(), monkeypatch)
    ref = [ref_eng.score_columns_cached(ids[i:i + 15], amounts[i:i + 15], types[i:i + 15],
                                        now=T0 + 30.0 * i) for i in range(0, 45, 15)]
    eng = _session_engine(p0, _store(), monkeypatch)
    mgr = eng.session
    calls = []
    head = mgr.head_fn
    mgr.head_fn = lambda *a: (calls.append(1), head(*a))[1]
    eng._session_fns.clear()  # rebuilt on first use with the counting head
    results = []
    sh = ShadowScorer(eng, from_jax_params("mlp", p1),
                      on_result=lambda c, p, n: results.append(c))
    eng.shadow = sh
    try:
        steps0 = eng.device_steps
        for i in range(0, 45, 15):
            eng.score_columns_cached(ids[i:i + 15], amounts[i:i + 15], types[i:i + 15],
                                     now=T0 + 30.0 * i)
        assert sh.drain(30.0)
        rep = sh.report()
        assert rep["errors"] == 0
        assert len(calls) == eng.device_steps - steps0 == 3  # the head once a step
        if fused == "0":  # index rows on the split layout: counted as skipped
            assert rep["rows_skipped_no_snapshot"] == 45 and not results
            return
        assert rep["fused_batches"] == 3 and rep["window"]["rows"] == 45
        cand = {k: np.concatenate([c[k] for c in results]) for k in KEYS}
        want = {k: np.concatenate([r[k] for r in ref]) for k in KEYS}
        _assert_bit_equal(cand, want, "session shadow")
        assert ((cand["reason_mask"] >> SESSION_PATTERN_BIT) & 1).any()  # some rows folded
        for name in ("session_ring", "session_cursor", "session_length"):
            np.testing.assert_array_equal(getattr(mgr, name).numpy(),
                                          getattr(ref_eng.session, name).numpy(), err_msg=name)
    finally:
        sh.close()
        eng.close()
        ref_eng.close()
