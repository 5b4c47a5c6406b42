"""Port parity: serve/ledger.py, the decision ledger, and its note seams.

The same seeded records and requests go through the JAX package's ledger
(``igaming_platform_tpu/serve/ledger.py``) and the port's, with the clock
and identity seams pinned alike in both (tests/torch_ledger_common.py):

- the codec: bytes equal to JAX's for decision records with and without a
  snapshot, blacklisted or not, in the heuristic tier or not, with and
  without the session tail, and for outcome and promotion records; the
  three goldens round-trip; a future version and a corrupt body rejected;
- the WAL: each package reads the other's directory into equal entries;
  torn-tail recovery equal to JAX's on the same cut file; rotation order;
- the drainer, in both packages under the same scenario: spill and
  catch-up, breaker feed and recovery, partial consumption, cursor
  persistence; the ClickHouse payload equal to JAX's;
- the seams: every CPU-engine path notes every row it answered, with a
  snapshot where JAX records one, records equal to the JAX engine's in
  every integer and string field (score and action excused on rows within
  1e-4 of a floor boundary whose ml_score differs; ml_score atol 1e-6;
  params_fp equal where both packages hash the same tree, the mock's; a
  trace_id wherever the JAX record has one);
  the fingerprint captured at dispatch across a ``swap_params``, and the
  thresholds across a ``set_thresholds``; decision ids on responses and in
  ScoreTransaction's trailing metadata; the writer's own time counted;
- chaos ``ledger.append`` faults never fail scoring and are counted; a
  full queue drops, counts and never blocks; the server's ``LEDGER_DIR``,
  ``/debug/ledgerz`` and ``/debug/outcomes``.

Every ledger a test opens is closed in it: no writer or drainer thread
outlives its test.
"""

import itertools
import json
import os
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from test_torch_ensemble import jax_tree
from test_torch_gbdt import _forest
from torch_front_common import checked_rows
from torch_ledger_common import (
    LEDGERS,
    T0,
    FakeSink,
    engines,
    fields,
    pin_ledgers,
    record,
    requests,
    seed_stores,
)

from igaming_platform_tpu.serve import chaos as jchaos
from igaming_platform_tpu.serve import ledger as jl
from igaming_platform_tpu.serve.supervisor import OPEN, CircuitBreaker
from igaming_platform_tpu_torch.convert import from_jax_params
from igaming_platform_tpu_torch.obs.metrics import ServiceMetrics
from igaming_platform_tpu_torch.serve import chaos as pchaos
from igaming_platform_tpu_torch.serve import ledger as pl

GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture(autouse=True)
def _clean_globals():
    yield
    jchaos.clear()
    pchaos.clear()


# ---------------------------------------------------------------------------
# The codec


@pytest.mark.parametrize("features,blacklisted,tier,session",
                         list(itertools.product((True, False), (True, False),
                                                ("device", "heuristic"), (True, False))))
def test_record_bytes_equal_jax(features, blacklisted, tier, session):
    for i in (0, 7, 11):
        want = record(jl, i, features, tier, blacklisted, session)
        got = record(pl, i, features, tier, blacklisted, session)
        blob = pl.encode_record(got)
        assert blob == jl.encode_record(want)
        for back in (pl.decode_record(jl.encode_record(want)), jl.decode_record(blob)):
            assert fields(back) == fields(got)
            assert back.ml_score_bits == got.ml_score_bits
            assert (back.features is None) == (not features)
            if features:
                np.testing.assert_array_equal(back.features, got.features)
        assert pl.decode_record(blob).feature_hash == want.feature_hash


@pytest.mark.parametrize("kind", ["decision_record_v1", "outcome_record_v1",
                                  "promotion_record_v1", "outcome", "promotion"])
def test_side_records_and_goldens_equal_jax(kind):
    if kind.endswith("_v1"):
        blob = (GOLDEN / f"{kind}.bin").read_bytes()
        got_kind, got = pl.decode_entry(blob)
        assert pl.encode_entry(got) == blob, "schema drift: re-encode differs from the golden"
        assert jl.decode_entry(blob)[0] == got_kind
        return
    for i in range(5):
        if kind == "outcome":
            args = dict(decision_id=f"d-x-{i:07x}.{i}", label=i % 2,
                        source=("chargeback", "manual_review", "")[i % 3], ts_unix=T0 + i)
            cls = "OutcomeRecord"
        else:
            args = dict(event=("promote", "rollback")[i % 2], old_fp=f"{i:016x}",
                        new_fp=f"{i + 9:016x}", model_version="mlp+gbdt", reason="gate " * i,
                        gates_json=json.dumps({"auc": 0.9 + i / 100}), ts_unix=T0 + i)
            cls = "PromotionRecord"
        blob = pl.encode_entry(getattr(pl, cls)(**args))
        assert blob == jl.encode_entry(getattr(jl, cls)(**args))
        assert pl.decode_entry(blob) == (kind, getattr(pl, cls)(**args))


def test_future_version_and_corruption_rejected():
    blob = (GOLDEN / "decision_record_v1.bin").read_bytes()
    for bad, match in ((bytes([9]) + blob[1:], "unknown"), (b"", "empty")):
        with pytest.raises(pl.LedgerSchemaError, match=match):
            pl.decode_entry(bad)
    with pytest.raises(pl.LedgerSchemaError, match="unknown DecisionRecord schema"):
        pl.decode_record(bytes([9]) + blob[1:])
    corrupt = bytearray(blob)
    corrupt[-1] ^= 0xFF
    with pytest.raises(pl.LedgerSchemaError, match="hash mismatch"):
        pl.decode_record(bytes(corrupt))


# ---------------------------------------------------------------------------
# The WAL


def _entries(mod, i0: int = 0):
    """Decisions of every flag combination, an outcome and a promotion."""
    out = [record(mod, i0 + i, features=i % 3 != 1, tier=("device", "heuristic")[i % 2],
                  session=i % 4 == 3) for i in range(8)]
    out.insert(3, mod.OutcomeRecord(decision_id=out[0].decision_id, label=1,
                                    source="chargeback", ts_unix=T0))
    out.append(mod.PromotionRecord(event="promote", old_fp="0" * 16, new_fp="1" * 16,
                                   model_version="mlp+gbdt", reason="gates", gates_json="{}",
                                   ts_unix=T0))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_read_across_packages(tmp_path, writer):
    wmod = LEDGERS[writer]
    rmod = LEDGERS["port" if writer == "jax" else "jax"]
    d = str(tmp_path / "wal")
    led = wmod.DecisionLedger(d)
    try:
        assert led._append_ready(_entries(wmod))
        assert led.flush(5.0)
    finally:
        led.close()
    got = list(rmod.iter_entries(d))
    want = _entries(rmod)
    assert [k for k, _ in got] == ["decision"] * 3 + ["outcome"] + ["decision"] * 5 + ["promotion"]
    assert [rmod.encode_entry(r) for _, r in got] == [rmod.encode_entry(r) for r in want]
    assert [r.decision_id for r in rmod.iter_records(d)] == [
        r.decision_id for r in want if isinstance(r, rmod.DecisionRecord)]
    assert len(list(rmod.iter_outcomes(d))) == len(list(rmod.iter_promotions(d))) == 1


def test_torn_tail_recovery_equal_to_jax(tmp_path):
    d = str(tmp_path / "torn")
    led = pl.DecisionLedger(d)
    try:
        for i in range(7):
            assert led.append_record(record(pl, i))
        assert led.flush(5.0)
    finally:
        led.close()
    _seq, path = pl.ledger_segments(d)[-1]
    size = os.path.getsize(path)
    with open(path, "ab") as f:  # a frame whose header promises more bytes than exist
        f.write(b"\x40\x00\x00\x00\x99\x99\x99\x99partial")
    assert pl.recover_segment(path) == jl.recover_segment(path) == (size, 7, True)
    assert [r.decision_id for r in pl.iter_records(d)] == [
        r.decision_id for r in jl.iter_records(d)]
    led = pl.DecisionLedger(d)  # recovery truncates in place
    try:
        assert os.path.getsize(path) == size
        assert led.append_record(record(pl, 7))
        assert led.flush(5.0)
    finally:
        led.close()
    assert [r.decision_id for r in jl.iter_records(d)] == [f"d-test-{i:07x}.0" for i in range(8)]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_rotation_order(tmp_path, pkg):
    mod = LEDGERS[pkg]
    d = str(tmp_path / "rot")
    led = mod.DecisionLedger(d, segment_bytes=600)
    try:
        for i in range(25):
            led.append_record(record(mod, i))
        assert led.flush(5.0)
    finally:
        led.close()
    assert len(pl.ledger_segments(d)) > 2 and pl.ledger_segments(d) == jl.ledger_segments(d)
    want = [f"d-test-{i:07x}.0" for i in range(25)]
    assert [r.decision_id for r in pl.iter_records(d)] == want
    assert [r.decision_id for r in jl.iter_records(d)] == want
    led = mod.DecisionLedger(d)
    try:
        assert led.stats()["durable_records"] == 25
    finally:
        led.close()


# ---------------------------------------------------------------------------
# The drainer: the same scenario through both packages' ledgers


def _wait(cond, timeout: float = 5.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)


class _FlakySink(FakeSink):
    def send(self, records):
        if self.sends % 3 == 1:
            self.sends += 1
            raise RuntimeError("intermittent sink flap (test)")
        super().send(records)


def _drain_spill(mod, d):
    sink = FakeSink()
    sink.fail = True  # outage first: the small hand-off queue overflows
    led = mod.DecisionLedger(d, sink=sink, sink_queue_max=4, sink_batch=8)
    try:
        for i in range(40):
            led.append_record(record(mod, i))
        assert led.flush(5.0)
        _wait(lambda: sink.sends > 0)
        sink.fail = False  # the drainer catches up from the WAL
        assert led.drain_sink(10.0)
    finally:
        led.close()
    s = led.stats()["sink"]
    assert s["spill_events"] >= 1 and s["queue_high_water"] >= 40 and s["lag"] == 0
    return sorted(sink.ids())


def _drain_breaker(mod, d):
    sink = FakeSink()
    sink.fail = True
    breaker = CircuitBreaker("ledger", failure_threshold=2, open_s=0.1)
    led = mod.DecisionLedger(d, sink=sink, breaker=breaker, sink_batch=8)
    try:
        for i in range(10):
            led.append_record(record(mod, i))
        assert led.flush(5.0)
        _wait(lambda: breaker.state == OPEN)
        assert breaker.state == OPEN and led.stats()["sink"]["lag"] == 10
        sink.fail = False  # the half-open probe drains the backlog
        assert led.drain_sink(10.0)
    finally:
        led.close()
    assert led.stats()["sink"]["failures"] >= 2
    return sorted(sink.ids())


def _drain_partial(mod, d):
    sink = _FlakySink()
    led = mod.DecisionLedger(d, sink=sink, sink_batch=8)
    try:
        for lo in range(0, 100, 20):  # five 20-frame writes, drained 8 at a time
            led._append_ready([record(mod, i) for i in range(lo, lo + 20)])
        assert led.flush(5.0) and led.drain_sink(15.0)
    finally:
        led.close()
    return sorted(set(sink.ids()))


def _drain_cursor(mod, d):
    sent = []
    for lo, hi in ((0, 5), (5, 8)):
        sink = FakeSink()
        led = mod.DecisionLedger(d, sink=sink)  # the second reads sink.cursor
        try:
            for i in range(lo, hi):
                led.append_record(record(mod, i))
            assert led.flush(5.0) and led.drain_sink(5.0)
        finally:
            led.close()
        sent.append(sorted(sink.ids()))
    return sent


@pytest.mark.parametrize("pkg,scenario", list(itertools.product(
    ("jax", "port"), ("spill", "breaker", "partial", "cursor"))))
def test_sink_drain_scenarios(tmp_path, pkg, scenario):
    got = globals()[f"_drain_{scenario}"](LEDGERS[pkg], str(tmp_path / scenario))
    ids = [f"d-test-{i:07x}.0" for i in range(100)]
    want = {"spill": ids[:40], "breaker": ids[:10], "partial": ids,
            "cursor": [ids[:5], ids[5:8]]}[scenario]
    assert got == want


def test_clickhouse_insert_equal_jax():
    class Client:
        def __init__(self):
            self.sql = []

        def query(self, sql):
            self.sql.append(sql)
            return []

    clients = (Client(), Client())
    jl.ClickHouseDecisionSink(clients[0]).send([record(jl, i) for i in range(3)])
    pl.ClickHouseDecisionSink(clients[1]).send([record(pl, i) for i in range(3)])
    assert clients[1].sql == clients[0].sql and len(clients[1].sql) == 2
    assert clients[1].sql[1].startswith("INSERT INTO risk_decisions FORMAT JSONEachRow\n")
    assert isinstance(pl.ClickHouseDecisionSink("http://127.0.0.1:1").client, pl.ClickHouseClient)


def test_sink_from_env(monkeypatch, tmp_path):
    monkeypatch.delenv("LEDGER_SINK", raising=False)
    assert pl.sink_from_env() is None
    monkeypatch.setenv("LEDGER_SINK", "clickhouse")
    assert isinstance(pl.sink_from_env(), pl.ClickHouseDecisionSink)
    monkeypatch.setenv("LEDGER_SINK", "pg")
    monkeypatch.setenv("LEDGER_PG_URL", "postgres://u@127.0.0.1:1/ledger")
    assert isinstance(pl.sink_from_env(), pl.PgDecisionSink)
    monkeypatch.setenv("LEDGER_SINK", "kafka")
    with pytest.raises(ValueError):
        pl.sink_from_env()
    metrics = ServiceMetrics("risk")
    ledger = pl.DecisionLedger(str(tmp_path), metrics=metrics)
    try:
        assert ledger._metrics is metrics
    finally:
        ledger.close()


# ---------------------------------------------------------------------------
# The seams: the port's CPU engine against the JAX engine


@pytest.fixture(scope="module", params=["mock", "mlp+gbdt"])
def pair(request):
    with pytest.MonkeyPatch.context() as mp:
        pin_ledgers(mp)
        stores = seed_stores()
        jeng, teng = engines(jax_tree(request.param), request.param, stores)
        try:
            yield request.param, jeng, teng
        finally:
            jeng.close()
            teng.close()


def _drive(eng, path: str, reqs) -> list:
    """Run ``path`` on ``eng``; returns the decision ids it answered with."""
    if path == "batch":
        return [r.decision_id for r in eng.score_batch(reqs)]
    if path == "single":
        return [eng.score(r).decision_id for r in reqs[:5]]
    eng._pipeline_enabled = path == "wire_pipeline"
    eng.score_batch_wire([r.account_id for r in reqs], [r.amount for r in reqs],
                         [r.tx_type for r in reqs], devices=[r.device_id for r in reqs])
    return []


def _bound(eng, mod, d):
    led = mod.DecisionLedger(d)
    eng.ledger = led
    return led


def assert_records_match(got: list, want: list, same_fp: bool) -> None:
    """Records of the port against the JAX engine's: every field equal but
    ``params_fp`` (unless both hash one tree), ``trace_id`` (each a fresh
    random id, set exactly where the other is) and, on floor-boundary rows, score
    and action; ml_score within 1e-6; snapshots bit-equal."""
    assert len(got) == len(want) > 0
    ml = [np.array([r.ml_score for r in recs], np.float32) for recs in (got, want)]
    np.testing.assert_allclose(ml[0], ml[1], rtol=0, atol=1e-6)
    ok = checked_rows({"ml_score": ml[0]}, {"ml_score": ml[1],
                                            "rule_score": np.array([r.rule_score for r in want])})
    for g, w, checked in zip(got, want, ok):
        assert bool(g.trace_id) == bool(w.trace_id)
        skip = {"trace_id"} | ({"params_fp"} if not same_fp else set())
        skip |= set() if checked else {"score", "action"}
        assert {k: v for k, v in fields(g).items() if k not in skip} == {
            k: v for k, v in fields(w).items() if k not in skip}, g.decision_id
        assert (g.features is None) == (w.features is None)
        if g.features is not None:
            np.testing.assert_array_equal(g.features.view(np.int32), w.features.view(np.int32))


@pytest.mark.parametrize("path", ["batch", "single", "wire_lockstep", "wire_pipeline"])
def test_engine_paths_note_like_jax(pair, path, tmp_path, monkeypatch):
    backend, jeng, teng = pair
    jreqs, treqs = requests(40)
    recs = []
    for mod, eng, reqs in ((jl, jeng, jreqs), (pl, teng, treqs)):
        pin_ledgers(monkeypatch)
        d = str(tmp_path / mod.__name__)
        led = _bound(eng, mod, d)
        try:
            ids = _drive(eng, path, reqs)
            assert led.flush(5.0)
        finally:
            eng.ledger = None
            led.close()
        got = list(pl.iter_records(d))
        assert led.stats()["records_dropped"] == 0
        if ids:  # every answered row carries its record's id
            assert ids == [r.decision_id for r in got]
        recs.append(got)
    jrecs, trecs = recs
    assert_records_match(trecs, jrecs, same_fp=backend == "mock")
    wire = {"batch": "batch", "single": "single"}.get(path, "wire_row")
    assert {r.wire_mode for r in trecs} == {wire} and {r.tier for r in trecs} == {"device"}
    assert {r.params_fp for r in trecs} == {teng.params_fingerprint}
    assert all(r.features is not None for r in trecs)
    n_prefixes = len({r.decision_id.rsplit(".", 1)[0] for r in trecs})
    assert n_prefixes == {"batch": 2, "single": 5}.get(path, 1)  # 40 rows: two 32-row chunks


@pytest.mark.parametrize("session", [False, True])
def test_index_path_notes_like_jax(session, tmp_path, monkeypatch):
    pin_ledgers(monkeypatch)
    monkeypatch.setenv("SESSION_EVENTS", "6")
    monkeypatch.setenv("SESSION_MIN_EVENTS", "3")
    stores = seed_stores()
    jeng, teng = engines(jax_tree("mlp+gbdt"), "mlp+gbdt", stores, batch=8, tiers=(4,),
                         feature_cache=16, session_state=session)
    rng = np.random.default_rng(8)
    calls = []  # one account a call: no CLOCK reclaim in either package
    for k in range(6):
        n = (1, 3, 9)[k % 3]
        calls.append(([f"lg-{k % 4}"] * n, [int(a) for a in rng.integers(100, 9000, n)],
                      ["bet", "deposit"] * (n // 2) + ["win"] * (n % 2), T0 + 60.0 * k))
    recs = []
    try:
        for mod, eng in ((jl, jeng), (pl, teng)):
            pin_ledgers(monkeypatch)
            eng.ensure_cache()
            d = str(tmp_path / mod.__name__)
            led = _bound(eng, mod, d)
            try:
                for ids, amounts, types, now in calls:
                    eng.score_columns_cached(ids, amounts, types, now=now)
                assert led.flush(5.0)
            finally:
                eng.ledger = None
                led.close()
            recs.append(list(pl.iter_records(d)))
    finally:
        jeng.close()
        teng.close()
    jrecs, trecs = recs
    assert_records_match(trecs, jrecs, same_fp=False)
    assert all(r.features is None and r.wire_mode == "index" for r in trecs)
    prefixes = [r.decision_id.rsplit(".", 1)[0] for r in trecs]
    # With session state one note a chunk (9 rows: chunks of 8 and 1), else one a call.
    assert len(set(prefixes)) == (8 if session else 6)
    assert all(bool(r.session_hash) == session for r in trecs)


@pytest.mark.parametrize("path", ["batch", "single", "wire_lockstep", "wire_pipeline",
                                  "session"])
def test_dispatch_fingerprint_across_swap(path, tmp_path, monkeypatch):
    """A swap that lands between a batch's dispatch and its note leaves the
    fingerprint that scored it on every record."""
    pin_ledgers(monkeypatch)
    monkeypatch.setenv("SESSION_EVENTS", "6")
    stores = seed_stores()
    _, teng = engines(jax_tree("mlp+gbdt"), "mlp+gbdt", stores,
                      feature_cache=32 if path == "session" else None,
                      session_state=path == "session")
    other = from_jax_params("mlp+gbdt", {**jax_tree("mlp+gbdt"), "gbdt": _forest(12)})
    d = str(tmp_path / "swap")
    led = _bound(teng, pl, d)
    before = teng.params_fingerprint
    name = "_launch_cached" if path == "session" else (
        "_launch_padded" if path == "wire_pipeline" else "_launch")
    launch = getattr(teng, name)

    def launch_then_swap(*a, **k):
        out = launch(*a, **k)
        if teng.params_fingerprint == before:
            teng.swap_params(other)
        return out

    monkeypatch.setattr(teng, name, launch_then_swap)
    try:
        if path == "session":
            teng.score_columns_cached(["lg-1", "lg-2"], [500, 700], ["bet", "bet"], now=T0)
        else:
            _drive(teng, path, requests(40)[1])
        assert led.flush(5.0)
    finally:
        teng.ledger = None
        led.close()
        teng.close()
    recs = list(pl.iter_records(d))
    assert teng.params_fingerprint != before
    assert recs and recs[0].params_fp == before


@pytest.mark.parametrize("path", ["batch", "single", "wire_lockstep", "wire_pipeline",
                                  "session"])
def test_dispatch_thresholds_across_update(path, tmp_path, monkeypatch):
    """New thresholds set between a batch's dispatch and its note leave the
    thresholds that scored it on every record: each record's action is the
    one its own score and thresholds give."""
    pin_ledgers(monkeypatch)
    monkeypatch.setenv("SESSION_EVENTS", "6")
    stores = seed_stores()
    _, teng = engines(jax_tree("mlp+gbdt"), "mlp+gbdt", stores,
                      feature_cache=32 if path == "session" else None,
                      session_state=path == "session")
    teng.set_thresholds(1, 0)  # every row blocks or reviews; at (101, 100) every row approves
    d = str(tmp_path / "thr")
    led = _bound(teng, pl, d)
    name = "_launch_cached" if path == "session" else (
        "_launch_padded" if path == "wire_pipeline" else "_launch")
    launch = getattr(teng, name)

    def launch_then_update(*a, **k):
        out = launch(*a, **k)
        teng.set_thresholds(101, 100)  # after the first launch; later ones score with these
        return out

    monkeypatch.setattr(teng, name, launch_then_update)
    try:
        if path == "session":
            teng.score_columns_cached(["lg-1", "lg-2"], [500, 700], ["bet", "bet"], now=T0)
        else:
            _drive(teng, path, requests(40)[1])
        assert led.flush(5.0)
    finally:
        teng.ledger = None
        led.close()
        teng.close()
    recs = list(pl.iter_records(d))
    assert recs and teng.get_thresholds() == (101, 100)
    assert (recs[0].block_threshold, recs[0].review_threshold) == (1, 0)
    for r in recs:
        want = (3 if r.score >= r.block_threshold else
                2 if r.score >= r.review_threshold else 1)
        assert r.action == want, r.decision_id


def test_writer_time_counted(tmp_path):
    """``stats`` counts the writer's wall and CPU seconds and the records it
    encoded, the figures phase 10 of chip_smoke.py reads a record's cost from."""
    led = pl.DecisionLedger(str(tmp_path / "w"))
    try:
        assert led._append_ready([record(pl, i, features=True) for i in range(50)])
        assert led.flush(5.0)
        s = led.stats()
    finally:
        led.close()
    assert s["encoded_records"] == s["records_appended"] == 50
    assert 0.0 < s["encode_cpu_s"] <= s["writer_cpu_s"]
    assert s["writer_busy_s"] > 0.0


def test_chaos_append_faults_never_fail_scoring(tmp_path, monkeypatch):
    pin_ledgers(monkeypatch)
    breaker = CircuitBreaker("ledger", failure_threshold=2, open_s=5.0)
    pchaos.install("seed=3;ledger.append=error:p=1.0")
    _, teng = engines({}, "mock", seed_stores())
    led = pl.DecisionLedger(str(tmp_path / "chaos"), breaker=breaker)
    teng.ledger = led
    try:
        reqs = requests(20)[1]
        for _ in range(3):  # every append hits the injected filesystem fault
            assert len(teng.score_batch(reqs)) == 20
        led.flush(5.0)
        stats = led.stats()
        assert stats["records_dropped"] >= 20 and stats["append_errors"] >= 1
        assert stats["records_appended"] == 0 and breaker.state == OPEN
    finally:
        led.close()
        teng.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_queue_overflow_drops_counted_never_blocks(tmp_path, pkg):
    mod = LEDGERS[pkg]
    led = mod.DecisionLedger(str(tmp_path / "q"), queue_max_rows=8)
    (jchaos if pkg == "jax" else pchaos).install("seed=9;ledger.append=delay:p=1.0:ms=50")
    try:
        t0 = time.monotonic()
        for i in range(64):
            led.append_record(record(mod, i))
        assert time.monotonic() - t0 < 2.0  # O(1) appends, no blocking
        led.flush(10.0)
        stats = led.stats()
        assert stats["records_dropped"] > 0
        assert stats["records_appended"] + stats["records_dropped"] == 64
    finally:
        led.close()


def test_server_ledger_dir_and_endpoints(tmp_path, monkeypatch):
    from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
    from igaming_platform_tpu_torch.serve import risk_codec as codec
    from igaming_platform_tpu_torch.serve import server
    from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore

    def call(port, path, body=None):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=None if body is None else json.dumps(body).encode(),
                                     method="GET" if body is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())

    monkeypatch.setenv("DRIFT", "0")
    monkeypatch.setenv("LEDGER_DIR", str(tmp_path / "srv"))
    config = RiskServiceConfig(batcher=BatcherConfig(batch_size=16, max_wait_ms=1.0))
    srv = server.RiskServer(server.assemble_risk_service(
        config, feature_store=InMemoryFeatureStore(clock=lambda: T0), device="cpu"),
        grpc_port=0, http_port=0)
    try:
        assert srv.engine.ledger is srv.ledger is not None
        payload = codec.encode(codec.SCORE_TRANSACTION_REQUEST, {
            "account_id": "a1", "amount": 5000, "transaction_type": "deposit"})
        body, trailing = srv.service.call_with_trailing("ScoreTransaction", payload)
        assert codec.decode(codec.SCORE_TRANSACTION_RESPONSE, body)["score"] >= 0
        (key, did), = trailing
        assert key == "risk-decision-id" and srv.ledger.knows_decision(did)
        import grpc  # the binding sets the same pair as gRPC trailing metadata

        with grpc.insecure_channel(f"127.0.0.1:{srv.grpc_port}") as ch:
            _, rpc = ch.unary_unary("/risk.v1.RiskService/ScoreTransaction").with_call(
                payload, timeout=30)
        (key2, did2), = [(k, v) for k, v in rpc.trailing_metadata() if k.startswith("risk-")]
        assert key2 == key and did2 != did and srv.ledger.knows_decision(did2)
        for bad in ({"outcomes": "x"}, {"outcomes": [{"label": 1}]}, {"decision_id": ""}):
            assert call(srv.http_port, "/debug/outcomes", bad)[0] == 400
        status, out = call(srv.http_port, "/debug/outcomes", {"outcomes": [
            {"decision_id": did, "label": 1, "source": "chargeback"},
            {"decision_id": "d-elsewhere-0000001.0", "label": 0}]})
        assert status == 200 and out == {"accepted": 2, "unknown": 1, "submitted": 2}
        assert srv.ledger.flush(5.0)
        status, ledgerz = call(srv.http_port, "/debug/ledgerz")
        assert status == 200 and ledgerz["records_appended"] == 4 and ledgerz["outcome_records"] == 2
    finally:
        srv.shutdown(grace=1.0)
    assert not srv.ledger._writer.is_alive()
    outcomes = list(pl.iter_outcomes(str(tmp_path / "srv")))
    assert [(o.decision_id, o.label) for o in outcomes] == [(did, 1), ("d-elsewhere-0000001.0", 0)]
    monkeypatch.delenv("LEDGER_DIR")
    off = server.RiskServer(server.assemble_risk_service(
        config, feature_store=InMemoryFeatureStore(clock=lambda: T0), device="cpu"),
        grpc_port=-1, http_port=0)
    try:
        assert call(off.http_port, "/debug/ledgerz")[0] == 404
        assert call(off.http_port, "/debug/outcomes", {"decision_id": "x"})[0] == 404
    finally:
        off.shutdown(grace=1.0)
