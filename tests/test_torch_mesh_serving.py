"""Port parity: the engine over a mesh, slot-sharded state and sequence sharding.

JAX serves over its 8 virtual CPU devices; the port over a logical mesh of
``cpu`` shards of the same shape. Held:

- the row step of the routed (data x expert), data-sharded and
  model-sharded engines against the JAX engine on the same mesh and the
  same padded batch: integer columns exact outside floor-boundary rows,
  ``ml_score`` atol 1e-6; a data-only split bit-equal to the port's
  unsharded engine (a row's bits do not depend on its batch);
- slot-sharded ``IDX1`` with session state over ``data=4`` (the twin of
  ``tests/test_mesh_state_sharding.py``): every call against the JAX
  sharded engine, and the table, ring, cursor and length, gathered,
  bit-equal to the port's unsharded engine and to JAX's; per-shard bytes
  a quarter of the table;
- ring and Ulysses attention against JAX's (``tests/test_sequence.py``'s
  bars, rtol 2e-4 atol 2e-5), Ulysses against the port's dense attention
  bit for bit, and in float64 at amplitude 3, where the float32 dense
  reference misses its own bar; the sharded abuse detector against the
  dense one (the twin of ``tests/test_serve.py``'s long-history case).
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_ensemble import jax_tree
from test_torch_parallel import _routed_tree
from test_torch_session_state import (
    THRESHOLDS,
    T0,
    _host_sprob,
    _seed_stores,
    assert_session_outputs_match,
)
from torch_front_common import checked_rows

from igaming_platform_tpu.core.config import BatcherConfig as JBatcherConfig
from igaming_platform_tpu.models import sequence as jseq
from igaming_platform_tpu.parallel import mesh as jmesh
from igaming_platform_tpu.serve.abuse import SequenceAbuseDetector as JDetector
from igaming_platform_tpu.serve.feature_store import InMemoryFeatureStore as JStore
from igaming_platform_tpu.serve.scorer import TPUScoringEngine
from igaming_platform_tpu.train.data import sample_features
from igaming_platform_tpu_torch.convert import from_jax_params, sequence_from_tree
from igaming_platform_tpu_torch.core.config import BatcherConfig
from igaming_platform_tpu_torch.models import sequence as pseq
from igaming_platform_tpu_torch.parallel import mesh as pmesh
from igaming_platform_tpu_torch.serve.abuse import SequenceAbuseDetector
from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore
from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine


def meshes(**axes):
    n = int(np.prod(list(axes.values())))
    return (jmesh.create_mesh(jmesh.MeshSpec(**axes), devices=jax.devices()[:n]),
            pmesh.create_mesh(pmesh.MeshSpec(**axes), devices=["cpu"] * n))


@pytest.fixture
def quiet_planes(monkeypatch):
    for knob in ("SLO", "DRIFT", "RUNTIME_TELEMETRY"):  # JAX planes the port does not have
        monkeypatch.setenv(knob, "0")


ENGINE_CASES = [("routed", dict(data=2, expert=4)), ("routed", dict(data=2)),
                ("mock", dict(data=8)),
                ("mlp+gbdt", dict(data=2, model=2, expert=2)),
                ("multitask", dict(data=4, model=2))]


@pytest.mark.parametrize("backend,axes", ENGINE_CASES)
def test_mesh_engine_row_step_matches_jax(backend, axes, quiet_planes):
    tree = _routed_tree(3, (64, 64), (64, 64)) if backend == "routed" else jax_tree(backend)
    jm, pm = meshes(**axes)
    bcfg = dict(batch_size=64, latency_tiers=(8, 16), max_wait_ms=1.0)
    jeng = TPUScoringEngine(ml_backend=backend, params=tree or None, mesh=jm,
                            batcher_config=JBatcherConfig(**bcfg))
    port = from_jax_params(backend, tree) if tree else None
    peng = TorchScoringEngine(ml_backend=backend, params=port, mesh=pm, device="cpu",
                              batcher_config=BatcherConfig(**bcfg))
    plain = TorchScoringEngine(ml_backend=backend, params=port, device="cpu",
                               batcher_config=BatcherConfig(**bcfg))
    try:
        divisor = axes.get("data", 1) * (axes.get("expert", 1) if backend == "routed" else 1)
        assert peng._shapes == jeng._shapes == sorted(
            s for s in (8, 16, 64) if s == 64 or s % divisor == 0)
        rng = np.random.default_rng(4)
        for n in (5, 16, 64):
            x = sample_features(rng, n)
            bl = rng.random(n) < 0.1
            want = {k: v[:n] for k, v in jeng._run_device(x, bl)[0].items()}
            got = peng._readback(peng._launch(x, bl, peng.get_params()))
            ref = plain._readback(plain._launch(x, bl, plain.get_params()))
            np.testing.assert_allclose(got["ml_score"], want["ml_score"], rtol=0, atol=1e-6)
            ok = checked_rows(got, want)
            for key in ("score", "action"):
                np.testing.assert_array_equal(got[key][ok], want[key][ok])
            for key in ("rule_score", "reason_mask"):
                np.testing.assert_array_equal(got[key] & ~(1 << 8), want[key] & ~(1 << 8))
            if not peng._model_sharded:
                for key in got:
                    np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
            print(f"{backend} n={n}: {int((~ok).sum())} floor-boundary rows")
        assert peng.params_fingerprint == plain.params_fingerprint
    finally:
        jeng.close()
        peng.close()
        plain.close()


@pytest.mark.parametrize("axes,blocks", [(dict(data=2), [32, 32]), (dict(data=2, expert=4), [64])])
def test_routed_rows_split_over_data(axes, blocks, monkeypatch):
    """The routed step over a data axis scores each data shard's block of
    rows as its own call: ``data_sharded`` splits them where the expert
    axis is not full, ``routed_ensemble_forward`` (one call over the whole
    batch) where it is."""
    from igaming_platform_tpu_torch.models import ensemble

    seen = []
    real = ensemble.routed_ml

    def spy(params, x_raw, mesh=None):
        seen.append(x_raw.clone())
        return real(params, x_raw, mesh)

    monkeypatch.setattr(ensemble, "routed_ml", spy)
    _, pm = meshes(**axes)
    eng = TorchScoringEngine(ml_backend="routed", params=from_jax_params("routed", _routed_tree()),
                             mesh=pm, device="cpu", warmup=False,
                             batcher_config=BatcherConfig(batch_size=64, latency_tiers=()))
    try:
        x = sample_features(np.random.default_rng(9), 64)
        eng._readback(eng._launch(x, np.zeros(64, bool), eng.get_params()))
    finally:
        eng.close()
    assert [len(b) for b in seen] == blocks
    torch.testing.assert_close(torch.cat(seen), torch.as_tensor(x, dtype=torch.float32),
                               rtol=0, atol=0)


def test_mesh_engine_refusals():
    _, pm = meshes(data=2, expert=4)
    port = from_jax_params("routed", _routed_tree())
    with pytest.raises(ValueError, match="not divisible by the mesh row split"):
        TorchScoringEngine(ml_backend="routed", params=port, mesh=pm, device="cpu",
                           batcher_config=BatcherConfig(batch_size=36), warmup=False)
    with pytest.raises(ValueError, match="not divisible by data axis"):
        TorchScoringEngine(mesh=pm, device="cpu", batcher_config=BatcherConfig(batch_size=33),
                           warmup=False)
    with pytest.raises(ValueError, match="needs params"):
        TorchScoringEngine(ml_backend="routed", params={"router": port["router"]}, device="cpu",
                           warmup=False)


@pytest.fixture(scope="module")
def sharded_engines():
    """JAX and port engines over ``data=4`` with an 8-slot cache and
    session state, and a port engine without a mesh."""
    with pytest.MonkeyPatch.context() as mp:
        for knob in ("SLO", "DRIFT", "RUNTIME_TELEMETRY"):
            mp.setenv(knob, "0")
        mp.setenv("SESSION_HEAD", "pattern")
        mp.setenv("SESSION_FLAG_THRESHOLD", str(THRESHOLDS["pattern"]))
        mp.setenv("SESSION_EVENTS", "6")
        mp.setenv("SESSION_MIN_EVENTS", "3")
        stores = (JStore(), InMemoryFeatureStore(clock=lambda: T0),
                  InMemoryFeatureStore(clock=lambda: T0))
        _seed_stores(stores[:2], 23)
        _seed_stores((JStore(), stores[2]), 23)
        jm, pm = meshes(data=4)
        # The paramless mock backend, as the JAX suite runs it: the JAX
        # program's own matmuls change bits with the shard's row count.
        kw = dict(batch_size=8, latency_tiers=(4,), max_wait_ms=1.0)
        jeng = TPUScoringEngine(ml_backend="mock", feature_store=stores[0],
                                batcher_config=JBatcherConfig(**kw), feature_cache=8,
                                session_state=True, mesh=jm)
        engines = [TorchScoringEngine(ml_backend="mock",
                                      feature_store=store, device="cpu", feature_cache=8,
                                      session_state=True, batcher_config=BatcherConfig(**kw),
                                      mesh=mesh)
                   for store, mesh in ((stores[1], pm), (stores[2], None))]
        for e in (jeng, *engines):
            e.ensure_cache()
        yield jeng, engines[0], engines[1]
        for e in (jeng, *engines):
            e.close()


def _state(eng):
    ring, cur, ln = eng.session.ring_state()
    table = eng.cache.table
    table = table.full() if hasattr(table, "full") else table
    return [t.numpy() for t in (table, ring, cur, ln)]


def test_slot_sharded_index_session_matches_jax_and_unsharded(sharded_engines):
    """Eight rounds over 23 accounts through 8 slots on 4 shards: CLOCK
    evicts and rehydrates; one account a call (the JAX CLOCK fault never
    met, tests/test_torch_device_cache.py). Every answer equals the JAX
    sharded engine's and the port's unsharded one's, and so do the gathered
    table and ring state."""
    jeng, sharded, plain = sharded_engines
    assert sharded.cache.plan.n_shards == 4 and sharded.session.plan is not None
    rng = np.random.default_rng(3)
    for r in range(8):
        now = T0 + 60.0 * r
        for a in rng.integers(0, 23, 4):
            k = int(rng.integers(1, 4))
            ids, amounts = [f"acct{a}"] * k, [int(m) for m in rng.integers(100, 900_000, k)]
            types = [("deposit", "withdraw", "bet", "win", "")[t] for t in rng.integers(0, 5, k)]
            near = np.abs(_host_sprob(jeng, ids, amounts, types, now)
                          - THRESHOLDS["pattern"]) < 1e-4
            want = jeng.score_columns_cached(ids, amounts, types, now=now)
            got = sharded.score_columns_cached(ids, amounts, types, now=now)
            assert_session_outputs_match(got, want, near, f"acct{a} at {now - T0}")
            assert sharded.cache.stats() == jeng.cache.stats()
            ref = plain.score_columns_cached(ids, amounts, types, now=now)
            for key in got:
                np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert jeng.cache.stats()["evictions"] > 0
    for got, ref in zip(_state(sharded), _state(plain)):
        np.testing.assert_array_equal(got, ref)
    jring = [np.asarray(jeng.session.session_ring), np.asarray(jeng.session.session_cursor),
             np.asarray(jeng.session.session_length)]
    for got, want in zip(_state(sharded)[1:], jring):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_state(sharded)[0], np.asarray(jeng.cache.table))
    stats = sharded.cache.shard_stats()
    assert stats == {**jeng.cache.shard_stats(), "hbm_bytes": stats["hbm_bytes"]}
    # Each shard holds its 2 slots and one scratch row: 3/8 of the table.
    assert stats["hbm_bytes"] == [3 * (30 * 4 + 1)] * 4
    assert sharded.session.shard_stats()["shards"] == 4


def test_capacity_rounds_up_and_state_sharding_off(monkeypatch):
    _, pm = meshes(data=4)
    eng = TorchScoringEngine(device="cpu", mesh=pm, feature_cache=10, warmup=False,
                             batcher_config=BatcherConfig(batch_size=8))
    try:
        assert eng.ensure_cache().capacity == 12
    finally:
        eng.close()
    monkeypatch.setenv("STATE_SHARDING", "0")
    eng = TorchScoringEngine(device="cpu", mesh=pm, feature_cache=10, warmup=False,
                             batcher_config=BatcherConfig(batch_size=8))
    try:
        assert eng.ensure_cache().plan is None and eng.cache.capacity == 10
    finally:
        eng.close()


CFG = jseq.SeqConfig(d_model=32, n_heads=8, n_layers=2, d_ff=64)


@pytest.mark.parametrize("mode,axes,batch,seq", [
    ("ring", dict(data=1, seq=8), 2, 64), ("ulysses", dict(data=1, seq=8), 2, 64),
    ("ring", dict(data=2, seq=4), 4, 32), ("ulysses", dict(data=2, seq=4), 4, 32)])
def test_sharded_attention_matches_jax(mode, axes, batch, seq):
    params = jseq.init_sequence_model(jax.random.key(0), CFG)
    x = np.array(jax.random.normal(jax.random.key(1), (batch, seq, jseq.EVENT_DIM)), np.float32)
    jm, pm = meshes(**axes)
    want = np.asarray(jax.jit(lambda p, xx: jseq.sequence_forward(
        p, xx, CFG, mesh=jm, seq_mode=mode)["abuse_logit"])(params, x))
    model = sequence_from_tree(jax.tree.map(np.asarray, params), pseq.SeqConfig(
        d_model=32, n_heads=8, n_layers=2, d_ff=64))
    with torch.no_grad():
        got = model(torch.from_numpy(x), pm, mode)["abuse_logit"].numpy()
        dense = model(torch.from_numpy(x))["abuse_logit"].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    if mode == "ulysses":
        np.testing.assert_array_equal(got, dense)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sharded_attention_float64_at_amplitude_3(mode):
    """At amplitude 3 the float32 dense reference misses its own bar
    (ROADMAP.md Queue 3); in float64 the ring's online softmax and the
    Ulysses exchange agree with dense attention to rounding."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 8, 64, 16)) * 3.0) for _ in range(3))
    _, pm = meshes(data=2, seq=4)
    got = pseq.sharded_attention(q, k, v, pm, mode)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / 4.0
    want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


def test_ulysses_rejects_bad_head_split():
    _, pm = meshes(data=1, seq=8)
    det = SequenceAbuseDetector(device="cpu", mesh=pm, seq_mode="ulysses")
    det.record_event("a", 100, "bet", timestamp=1.0)
    with pytest.raises(ValueError, match="not divisible"):
        det.check_batch(["a"])


def test_sharded_detector_matches_dense_and_jax():
    """The serving detector at long history (S=512) over data=2 x seq=4 in
    ring mode, on identical event streams, against the port's dense
    detector and the JAX ring detector; the batch pads to the data axis."""
    jm, pm = meshes(data=2, seq=4)
    jring = JDetector(max_history=512, mesh=jm, seq_mode="ring")
    model = sequence_from_tree(jax.tree.map(np.asarray, jring.params), pseq.SeqConfig(
        d_model=64, n_heads=2, n_layers=2, d_ff=128))
    ring = SequenceAbuseDetector(model, max_history=512, mesh=pm, seq_mode="ring", device="cpu")
    dense = SequenceAbuseDetector(model, max_history=512, device="cpu")
    accounts = [f"lc-{i}" for i in range(3)]
    for det in (jring, ring, dense):
        r = np.random.default_rng(7)
        for _ in range(700):
            acct = accounts[int(r.integers(0, len(accounts)))]
            det.record_event(acct, int(r.integers(100, 50_000)),
                             ("deposit", "bet", "win")[int(r.integers(0, 3))],
                             timestamp=1_000_000.0 + float(r.random()))
    s_ring = ring.check_batch(accounts, seq_len=512)
    assert s_ring.shape == (3,)
    np.testing.assert_allclose(s_ring, dense.check_batch(accounts, seq_len=512),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(s_ring, jring.check_batch(accounts, seq_len=512),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("env,error", [
    ({"MESH_DEVICES": "2"}, "MESH_DEVICES=2 but only 0 devices visible"),
    ({"MESH_DEVICES": "-1"}, None),
    ({"ML_BACKEND": "routed"}, "ML_BACKEND=routed requires a checkpoint bundle"),
    ({}, None)])
def test_server_boot_knobs(env, error, monkeypatch):
    """The server's mesh and routed knobs, read as the JAX server reads
    them: MESH_DEVICES past the visible CUDA devices fails the boot (none
    here; -1 takes all, which here is none: no mesh), a routed boot without
    its bundle fails, with ``init_routed_params`` it resolves."""
    from igaming_platform_tpu_torch.core.config import RiskServiceConfig
    from igaming_platform_tpu_torch.models.ensemble import init_routed_params
    from igaming_platform_tpu_torch.serve import server

    if torch.cuda.is_available():
        pytest.skip("counts CUDA devices; this case is for a machine without a card")
    for k in ("MESH_DEVICES", "MESH_SEQ", "MESH_EXPERT", "ML_BACKEND", "FRAUD_MODEL_PATH"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    config = RiskServiceConfig.from_env()
    assert config.mesh_devices == int(env.get("MESH_DEVICES", 0))
    if error is not None:
        with pytest.raises(RuntimeError, match=error):
            server.serving_mesh(config)
            server.resolve_model_boot(config)
        return
    assert server.serving_mesh(config) is None
    backend, params = server.resolve_model_boot(
        RiskServiceConfig(ml_backend="routed"), params=init_routed_params(1))
    assert backend == "routed" and params["router"].shape == (30, 4)
