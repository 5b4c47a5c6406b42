"""Port parity: serve/session_state.py, the stateful session plane.

The same seeded numpy inputs go through the JAX package's functions and the
port's on the CPU:

- the fused step (``make_session_step``) for both heads, from one ring state
  with wrapped cursors, duplicate accounts in one chunk (one of them more
  often than the ring holds) and pad rows on the scratch slot: windows
  bit-equal, the head's probability within 1e-6 (``pattern``) or 1e-6
  (``transformer``), packed integer outputs exact and ``ml_score`` within
  1e-6, except the rows whose probability lies within 1e-4 of the
  threshold (counted and printed) or whose score sits on a floor boundary
  (tests/test_torch_ensemble.py); ring, cursor and length bit-equal;
- the host side of a chunk (``prepare_chunk``): events, occurrence ranks,
  post-append lengths, sequence numbers and every ``SessionChunkAudit``
  hash byte-equal;
- two engines with a small feature cache (eviction churn) and session state
  on, fed the same calls: answers as above, cache and session counts
  equal, the device rings and tables bit-equal; then every window the
  port's ring holds equal to its host index;
- the committed transformer-head params bit-equal to
  ``init_session_head_params()``.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_ensemble import jax_tree
from test_torch_rules_mock import _raw_batch
from torch_front_common import checked_rows

from igaming_platform_tpu.core.config import BatcherConfig as JBatcherConfig
from igaming_platform_tpu.core.config import ScoringConfig as JScoringConfig
from igaming_platform_tpu.models.ensemble import make_score_fn as jmake_score_fn
from igaming_platform_tpu.serve import session_state as jss
from igaming_platform_tpu.serve.feature_store import InMemoryFeatureStore as JStore
from igaming_platform_tpu.serve.feature_store import TransactionEvent as JEvent
from igaming_platform_tpu.serve.scorer import TPUScoringEngine
from igaming_platform_tpu.serve.wire import TX_TYPE_CODES
from igaming_platform_tpu_torch.convert import from_jax_params
from igaming_platform_tpu_torch.core.config import BatcherConfig, ScoringConfig
from igaming_platform_tpu_torch.core.enums import SESSION_PATTERN_BIT
from igaming_platform_tpu_torch.models.ensemble import make_score_fn
from igaming_platform_tpu_torch.serve import session_state as tss
from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore, TransactionEvent
from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine

T0 = 1_700_000_000.0
# Head -> the flag threshold the cases use: the pinned transformer head
# scores these 6-event windows between about 0.15 and 0.26, never near the
# default 0.7, so its cases fold at 0.175; the pattern head's cycling
# windows score near 1.
THRESHOLDS = {"pattern": 0.7, "transformer": 0.175}
SPROB_ATOL = 1e-6
KEYS = ("score", "action", "reason_mask", "rule_score", "ml_score")


def _unpack(packed) -> dict:
    a = np.asarray(packed)
    return {"score": a[0], "action": a[1], "reason_mask": a[2], "rule_score": a[3],
            "ml_score": a[4].view(np.float32)}


def assert_session_outputs_match(got: dict, want: dict, near: np.ndarray, label: str) -> int:
    """Integer columns exact and ml_score within 1e-6 on every row but those
    near the threshold (``near``) or on a floor boundary; returns how many
    rows were excused."""
    ok = ~near & checked_rows(got, want)
    np.testing.assert_allclose(got["ml_score"][~near], want["ml_score"][~near], rtol=0,
                               atol=1e-6, err_msg=f"{label} ml_score")
    for k in KEYS[:4]:
        np.testing.assert_array_equal(got[k][ok], want[k][ok], err_msg=f"{label} {k}")
    excused = int((~ok).sum())
    print(f"{label}: {excused} of {ok.size} rows excused ({int(near.sum())} near the threshold)")
    return excused


def _heads(head: str):
    """(JAX head_fn, JAX sparams, port head_fn, port sparams)."""
    if head == "pattern":
        return (lambda sp, w, lp: jss.pattern_scores(w, lp)), None, \
            (lambda sp, w, lp: tss.pattern_scores(w, lp)), None
    return jss.transformer_scores, jss.init_session_head_params(), tss.transformer_scores, \
        tss.session_head_params(torch.device("cpu"))


def _ring_state(rng, capacity: int, n: int):
    """A ring with every fill level and cursor, some slots holding a
    machine-paced bet/deposit cycle; the scratch slot empty."""
    ring = np.zeros((capacity + 1, n, tss.EVENT_WIDTH), np.float32)
    length = rng.integers(0, n + 1, capacity + 1).astype(np.int32)
    cursor = rng.integers(0, n, capacity + 1).astype(np.int32)
    for s in range(capacity):
        cyc = s % 3 == 0
        amounts = np.full(n, 4000) if cyc else rng.integers(100, 500_000, n)
        codes = np.tile([2, 0], n)[:n] if cyc else rng.integers(0, 5, n)
        dts = np.full(n, 45.0) if cyc else rng.random(n) * 3000
        ring[s] = tss.encode_events_host(amounts, codes, dts)
    length[capacity] = cursor[capacity] = 0
    ring[capacity] = 0
    return ring, cursor, length


def _step_case(head, backend):
    """One fused-step case: a ring with wrapped cursors, 33 real rows (slot 3
    nine times, more than the ring's 6; slots 5 and 7 twice; the rest once)
    and 7 pad rows on the scratch slot; the JAX step's arguments and the
    port's."""
    rng = np.random.default_rng(len(head) + len(backend))
    capacity, n_ev, min_ev, shape = 12, 6, 3, 40
    thr = THRESHOLDS[head]
    ring, cursor, length = _ring_state(rng, capacity, n_ev)
    table = _raw_batch(5, capacity)
    flags = rng.random(capacity) < 0.2
    sidx_real = rng.permutation(np.concatenate([np.full(9, 3), [5, 5, 7, 7],
                                                rng.choice([0, 1, 2, 4, 6, 8, 9, 10, 11], 20)]))
    n = sidx_real.shape[0]
    occ_real = tss.occurrence_rank_host(sidx_real)
    np.testing.assert_array_equal(occ_real, jss.occurrence_rank_host(sidx_real))
    sidx = np.concatenate([sidx_real, np.full(shape - n, capacity)]).astype(np.int32)
    idxs = np.where(sidx < capacity, sidx, 0).astype(np.int32)
    occ = np.concatenate([occ_real, np.arange(shape - n)]).astype(np.int32)
    amounts = np.zeros(shape, np.float32)
    amounts[:n] = rng.integers(100, 2_000_000, n)
    types = np.full(shape, 4, np.int32)
    types[:n] = rng.integers(0, 5, n)
    dts = rng.random(n) * 100
    # A cycling slot's first row continues its cycle: same amount and gap,
    # the other type of the two.
    cyc = (sidx_real % 3 == 0) & (occ_real == 0)
    amounts[:n][cyc], dts[cyc] = 4000, 45.0
    types[:n][cyc] = 2 - 2 * ((cursor[sidx_real[cyc]] - 1) % n_ev % 2 == 0)
    events = np.zeros((shape, tss.EVENT_WIDTH), np.float32)
    events[:n] = tss.encode_events_host(amounts[:n], types[:n], dts)
    bl = np.zeros(shape, bool)
    bl[:n] = rng.random(n) < 0.05
    thresholds = np.array([70, 40], np.int32)
    jhead, jsp, thead, tsp = _heads(head)
    tree = jax_tree(backend)
    t = {k: torch.from_numpy(v.copy()) for k, v in
         (("ring", ring), ("cur", cursor), ("len", length))}
    cast = {"idxs": idxs, "sidx": sidx}
    args = [torch.from_numpy(a.astype(np.int64)) for a in cast.values()] + [
        torch.from_numpy(a) for a in (occ, amounts, types, events, bl)]
    app = torch.from_numpy(tss.surviving_appends(sidx_real, occ_real, n_ev))
    assert app.numel() == n - 3  # three of slot 3's nine writes are overwritten
    step_kw = dict(capacity=capacity, n_events=n_ev, min_events=min_ev, flag_threshold=thr)
    return {
        "n": n, "thr": thr, "min_ev": min_ev, "n_ev": n_ev, "sidx": sidx, "tree": tree,
        "jhead": jhead, "jsp": jsp, "thead": thead, "tsp": tsp, "step_kw": step_kw,
        "jargs": (tree, jsp, table, flags, ring, cursor, length, idxs, sidx, occ, amounts,
                  types, events, bl, thresholds),
        "targs": (from_jax_params(backend, tree) if tree else None, tsp,
                  torch.from_numpy(table), torch.from_numpy(flags), t["ring"], t["cur"],
                  t["len"], *args, torch.from_numpy(thresholds), app),
        "ring": ring, "cursor": cursor, "length": length, "events": events, "t": t, "args": args,
    }


@pytest.mark.parametrize("backend", ["mock", "mlp+gbdt"])
@pytest.mark.parametrize("head", ["pattern", "transformer"])
def test_session_step_matches_jax(head, backend):
    c = _step_case(head, backend)
    thr, n_ev, min_ev, sidx = c["thr"], c["n_ev"], c["min_ev"], c["sidx"]
    jhead, jsp, thead, tsp = c["jhead"], c["jsp"], c["thead"], c["tsp"]
    jstep = jss.make_session_step(jmake_score_fn(JScoringConfig(), backend), JScoringConfig(),
                                  jhead, **c["step_kw"])
    jout = jax.jit(jstep)(*c["jargs"])
    want, jring, jcur, jlen = (np.asarray(a) for a in jout)

    tstep = tss.make_session_step(make_score_fn(ScoringConfig(), backend, device="cpu"),
                                  ScoringConfig(), thead, **c["step_kw"])
    t, args = c["t"], c["args"]
    with torch.inference_mode():
        # The windows and the head's probability, before the step appends.
        jwin, jlp = jss.build_windows(c["ring"], c["cursor"], c["length"], sidx, c["events"],
                                      n_ev)
        twin, tlp = tss.build_windows(t["ring"], t["cur"], t["len"], args[1], args[5], n_ev)
        np.testing.assert_array_equal(twin.numpy(), np.asarray(jwin))
        np.testing.assert_array_equal(tlp.numpy(), np.asarray(jlp))
        jprob = np.asarray(jhead(jsp, jwin, jlp), np.float32)
        tprob = thead(tsp, twin, tlp).numpy()
        np.testing.assert_allclose(tprob, jprob, rtol=0, atol=SPROB_ATOL)
        packed, ring2, cur2, len2 = tstep(*c["targs"])
    assert ring2 is t["ring"] and cur2 is t["cur"] and len2 is t["len"]  # in place
    np.testing.assert_array_equal(ring2.numpy(), jring)
    np.testing.assert_array_equal(cur2.numpy(), jcur)
    np.testing.assert_array_equal(len2.numpy(), jlen)
    warm = (jlp >= min_ev) & (sidx < c["step_kw"]["capacity"])
    assert 0 < int((warm & (jprob >= thr)).sum()) < int(warm.sum())  # some rows fold, some not
    near = np.abs(jprob - thr) < 1e-4
    assert_session_outputs_match(_unpack(packed), _unpack(want), near, f"{head}/{backend}")


@pytest.mark.parametrize("head", ["pattern", "transformer"])
def test_session_step_sketch_and_shadow_variants_match_jax(head):
    """``make_session_step(sketch=True, shadow=True)``: the sketch of the
    composed rows and the candidate's packed result (folded with the same
    head result) against the JAX variant's; production's result and the
    ring as the plain step's."""
    from test_torch_drift import assert_sketch_equal

    backend = "mlp+gbdt"
    c = _step_case(head, backend)
    cand_tree = jax_tree("mlp+gbdt")
    cand_tree["gbdt"] = dict(cand_tree["gbdt"], bias=np.float32(0.4))
    cand_tree["mlp"] = {"layers": [dict(layer, b=layer["b"] + np.float32(0.05))
                                   for layer in cand_tree["mlp"]["layers"]]}
    n = c["n"]
    jstep = jss.make_session_step(jmake_score_fn(JScoringConfig(), backend), JScoringConfig(),
                                  c["jhead"], sketch=True, shadow=True, **c["step_kw"])
    jout = [np.asarray(a) for a in jax.jit(jstep)(*c["jargs"], cand_tree, np.int32(n))]
    tstep = tss.make_session_step(make_score_fn(ScoringConfig(), backend, device="cpu"),
                                  ScoringConfig(), c["thead"], sketch=True, shadow=True,
                                  **c["step_kw"])
    with torch.inference_mode():
        tout = tstep(*c["targs"], from_jax_params(backend, cand_tree), n)
    assert len(tout) == len(jout) == 6
    for name, got, want in zip(("ring", "cursor", "length"), tout[1:4], jout[1:4]):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    jwin, jlp = jss.build_windows(c["ring"], c["cursor"], c["length"], c["sidx"], c["events"],
                                  c["n_ev"])
    near = np.abs(np.asarray(c["jhead"](c["jsp"], jwin, jlp), np.float32) - c["thr"]) < 1e-4
    assert_session_outputs_match(_unpack(tout[0]), _unpack(jout[0]), near, f"{head} production")
    assert_session_outputs_match(_unpack(tout[5]), _unpack(jout[5]), near, f"{head} shadow")
    assert not np.array_equal(tout[5].numpy(), tout[0].numpy())  # the candidate differs
    assert_sketch_equal(tout[4].numpy(), jout[4], f"{head} sketch")
    assert tout[4][0] == n


def test_prepare_chunk_and_audit_match_jax():
    """Host side of three chunks with duplicates: events, ranks, lengths,
    sequence numbers and every lazy hash byte-equal to the JAX package's."""
    rng = np.random.default_rng(4)
    jm = jss.SessionStateManager(8, n_events=5, min_events=2, flag_threshold=0.5)
    tm = tss.SessionStateManager(8, device="cpu", n_events=5, min_events=2, flag_threshold=0.5)
    for c in range(3):
        ids = [f"a{i}" for i in rng.integers(0, 6, 14)]
        amounts = rng.integers(0, 10**6, 14).astype(np.float32)
        codes = rng.integers(0, 5, 14).astype(np.int32)
        got = tm.prepare_chunk(ids, amounts, codes, T0 + 17.5 * c)
        want = jm.prepare_chunk(ids, amounts, codes, T0 + 17.5 * c)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)
        assert [got[4][i] for i in range(14)] == [want[4][i] for i in range(14)]
    for a in (f"a{i}" for i in range(6)):
        np.testing.assert_array_equal(tm.twin_window(a), jm.twin_window(a))
        assert tm.twin_meta(a) == jm.twin_meta(a)
    ev = tss.encode_events_host([900, 0, 2**25 + 1], [2, 0, 4], [45.0, 0.0, 1.5])
    assert tss.window_hash(ev) == jss.window_hash(ev)


def _seed_stores(stores, n_accounts: int) -> None:
    rng = np.random.default_rng(9)
    for a in range(n_accounts):
        for k in range(int(rng.integers(0, 5))):
            ev = dict(account_id=f"acct{a}", amount=int(rng.integers(100, 400_000)),
                      tx_type=("deposit", "bet", "win", "withdraw")[k % 4],
                      ip=f"ip{rng.integers(0, 9)}", device_id=f"dev{a % 7}",
                      timestamp=T0 - float(rng.random() * 90_000))
            stores[0].update(JEvent(**ev))
            stores[1].update(TransactionEvent(**ev))


@pytest.fixture(scope="module", params=["pattern", "transformer"])
def engines(request, monkeypatch_module):
    for knob in ("SLO", "DRIFT", "RUNTIME_TELEMETRY"):  # JAX planes the port does not have
        monkeypatch_module.setenv(knob, "0")
    monkeypatch_module.setenv("SESSION_HEAD", request.param)
    monkeypatch_module.setenv("SESSION_FLAG_THRESHOLD", str(THRESHOLDS[request.param]))
    monkeypatch_module.setenv("SESSION_EVENTS", "6")
    monkeypatch_module.setenv("SESSION_MIN_EVENTS", "3")
    stores = (JStore(), InMemoryFeatureStore(clock=lambda: T0))
    _seed_stores(stores, 23)
    tree = jax_tree("mlp+gbdt")
    kw = dict(batch_size=8, latency_tiers=(4,), max_wait_ms=1.0)
    jeng = TPUScoringEngine(ml_backend="mlp+gbdt", params=tree, feature_store=stores[0],
                            batcher_config=JBatcherConfig(**kw), feature_cache=8,
                            session_state=True)
    teng = TorchScoringEngine(ml_backend="mlp+gbdt", params=from_jax_params("mlp+gbdt", tree),
                              feature_store=stores[1], device="cpu", feature_cache=8,
                              session_state=True, batcher_config=BatcherConfig(**kw))
    jeng.ensure_cache()
    teng.ensure_cache()
    yield request.param, jeng, teng, stores
    jeng.close()
    teng.close()


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def _host_sprob(jeng, ids, amounts, types, now) -> np.ndarray:
    """Each row's head probability, from the JAX engine's host index before
    the chunk (every row of an account sees the chunk-start window)."""
    mgr = jeng.session
    codes = [TX_TYPE_CODES.get(t, 4) for t in types]
    meta = {a: mgr.twin_meta(a) for a in set(ids)}
    dts = [max(0.0, now - meta[a]["last_ts"]) if meta[a]["seq"] else 0.0 for a in ids]
    events = jss.encode_events_host(np.asarray(amounts, np.float32), codes, dts)
    windows = np.zeros((len(ids), mgr.n_events, jss.EVENT_WIDTH), np.float32)
    lens = np.zeros(len(ids), np.int32)
    for i, a in enumerate(ids):
        hist = mgr.twin_window(a)[-(mgr.n_events - 1):] if meta[a]["seq"] else windows[i, :0]
        windows[i, :hist.shape[0]] = hist
        windows[i, hist.shape[0]] = events[i]
        lens[i] = hist.shape[0] + 1
    return np.asarray(mgr.head_fn(mgr.head_params, windows, lens), np.float32)


def _call(jeng, teng, head, ids, amounts, types, now) -> tuple[int, int]:
    """One call to both engines; (rows excused, rows folded)."""
    near = np.abs(_host_sprob(jeng, ids, amounts, types, now) - THRESHOLDS[head]) < 1e-4
    want = jeng.score_columns_cached(ids, amounts, types, now=now)
    got = teng.score_columns_cached(ids, amounts, types, now=now)
    excused = assert_session_outputs_match(got, want, near, f"{head} {ids[0]} at {now - T0}")
    assert teng.cache.stats() == jeng.cache.stats()
    return excused, int(((got["reason_mask"] >> SESSION_PATTERN_BIT) & 1).sum())


def test_engines_agree_through_eviction_and_rehydration(engines):
    """Ten rounds over 23 accounts through an 8-slot cache: CLOCK evicts and
    rehydrates every round. Each call scores one account (one to three
    rows, or nine, more than its ring holds), so no call can meet the JAX
    package's CLOCK fault (tests/test_torch_device_cache.py); three accounts
    keep a bet/deposit cycle a minute apart; a store write between rounds
    folds a dirty row. Then the port alone takes calls of eight accounts
    each, and every resident window still equals the host index."""
    head, jeng, teng, stores = engines
    rng = np.random.default_rng(11)
    excused = folds = 0
    for r in range(10):
        now = T0 + 60.0 * r
        if r == 6:  # a write-back: the next lookup folds it
            for store, cls in zip(stores, (JEvent, TransactionEvent)):
                store.update(cls(account_id="acct1", amount=777, tx_type="bet", timestamp=now))
        calls = [([a], [4000], [("bet", "deposit")[r % 2]]) for a in ("acct1", "acct2", "acct3")]
        for a in rng.integers(4, 23, 3):
            k = 9 if r == 4 else int(rng.integers(1, 4))
            calls.append(([f"acct{a}"] * k, [int(m) for m in rng.integers(100, 900_000, k)],
                          [("deposit", "withdraw", "bet", "win", "")[t]
                           for t in rng.integers(0, 5, k)]))
        for ids, amounts, types in calls:
            e, f = _call(jeng, teng, head, ids, amounts, types, now)
            excused, folds = excused + e, folds + f
    js, ts = jeng.session.snapshot(), teng.session.snapshot()
    for k in ("appends", "rehydrations", "admissions", "rows", "accounts_tracked"):
        assert ts[k] == js[k], k
    assert js["rehydrations"] > 0 and jeng.cache.stats()["evictions"] > 0
    assert js["rows"]["warm"] > 0 and folds > 0
    print(f"{head}: {folds} rows folded, {excused} rows excused")
    for name in ("session_ring", "session_cursor", "session_length"):
        np.testing.assert_array_equal(getattr(teng.session, name).numpy(),
                                      np.asarray(getattr(jeng.session, name)), err_msg=name)
    np.testing.assert_array_equal(teng.cache.table.numpy(), np.asarray(jeng.cache.table))
    for c in range(5):
        ids = [f"acct{a}" for a in rng.permutation(23)[:8]]
        teng.score_columns_cached(ids, [5000] * 8, ["bet"] * 8, now=T0 + 900.0 + c)
    for a, slot in teng.cache._slots.items():
        np.testing.assert_array_equal(teng.session.device_window(slot),
                                      teng.session.twin_window(a))


def test_committed_head_params_equal_the_jax_draw():
    want = jax.tree.map(np.asarray, jss.init_session_head_params())
    got = tss.session_head_tree()
    flat_w, tree_w = jax.tree_util.tree_flatten(want)
    flat_g, tree_g = jax.tree_util.tree_flatten(got)
    assert tree_g == tree_w
    for g, w in zip(flat_g, flat_w):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
