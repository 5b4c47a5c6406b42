"""Port parity: serve/router.py, obs/fleetview.py and the fleet drift rollup.

- The hash ring: owners of 10,000 keys equal to JAX's, through eviction and
  readmission (the twin of ``tests/test_hash_ring.py``), and the pod ring,
  the latency window and the client picker likewise.
- The router: the port's ``ScoringRouter`` over grpcio in front of three
  port replicas, beside the JAX router in front of three JAX replicas
  (mock engines, empty history, the twin of ``tests/test_router_fleet.py``):
  affinity (each replica scores exactly the accounts it owns, the same
  counts on both sides), a ScoreBatch split by owner and merged in order
  (equal to one replica's answer and to the JAX router's, field for field
  apart from ``response_time_ms``), pass-through statuses, health-driven
  eviction and readmission, a killed replica's failover, hedging.
- ``FleetView``: port and JAX exposition text parse and merge alike, mixed
  bucket layouts are refused, a dead or hung sidecar goes stale without
  blocking (the twin of ``tests/test_slo_fleetview.py``), and the view
  over port sidecars sums their histograms.
- ``fleet_drift_block`` equal to JAX's on the same payloads (the twin of
  ``tests/test_drift_fleet.py``).
"""

from __future__ import annotations

import json
import random
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import grpc
import numpy as np
import pytest
from torch_front_common import jax_hostprof_off, jax_native_libs, time_limit  # noqa: F401

from igaming_platform_tpu.core.config import BatcherConfig as JBatcherConfig
from igaming_platform_tpu.obs import drift as jdrift
from igaming_platform_tpu.obs import fleetview as jfv
from igaming_platform_tpu.obs.metrics import Histogram as JHistogram
from igaming_platform_tpu.serve import grpc_server as jgrpc
from igaming_platform_tpu.serve import router as jrouter
from igaming_platform_tpu.serve.scorer import TPUScoringEngine
from igaming_platform_tpu.train.fraudgen import generate_labeled
from igaming_platform_tpu_torch.core.config import BatcherConfig
from igaming_platform_tpu_torch.obs import drift as pdrift
from igaming_platform_tpu_torch.obs import fleetview as pfv
from igaming_platform_tpu_torch.obs.metrics import Histogram, ServiceMetrics
from igaming_platform_tpu_torch.serve import grpc_server as pgrpc
from igaming_platform_tpu_torch.serve import router as prouter
from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine

from risk.v1 import risk_pb2

KEYS = [f"acct-{i}" for i in range(10_000)]


@pytest.mark.parametrize("n,vnodes,evict", [
    (4, 64, ("r1",)), (10, 64, ("r3", "r7")), (7, 16, ("r0", "r6", "r2"))])
def test_ring_owners_match_jax_through_eviction_and_readmission(n, vnodes, evict):
    ids = [f"r{i}" for i in range(n)]
    jr, pr = jrouter.HashRing(ids, vnodes=vnodes), prouter.HashRing(reversed(ids), vnodes=vnodes)

    def owners(ring):
        return [tuple(ring.owners(k, 3)) for k in KEYS]

    first = owners(pr)
    assert first == owners(jr)
    for rid in evict:
        jr.evict(rid)
        pr.evict(rid)
        assert owners(pr) == owners(jr)
        assert pr.active == jr.active and pr.members == jr.members
    moved = sum(a[0] != b[0] for a, b in zip(first, owners(pr)))
    assert moved == sum(o[0] in evict for o in first)
    for rid in evict:
        jr.readmit(rid)
        pr.readmit(rid)
    assert owners(pr) == first == owners(jr)
    assert pr.snapshot() == jr.snapshot()
    assert prouter._ring_hash("lg-42") == jrouter._ring_hash("lg-42")


def test_pod_ring_latency_window_and_picker_match_jax():
    pods = {"p0": ("a", "b"), "p1": ("c",), "p2": ("d", "e")}
    pod_of = {m: p for p, ms in pods.items() for m in ms}
    rings = []
    for mod in (jrouter, prouter):
        ring = mod.HashRing(pods)
        pr = mod.PodRing(ring, pod_of, pods)
        pr.evict("a")
        pr.evict("c")
        rings.append((ring, pr))
    (jr, jp), (pr, pp) = rings
    assert [jr.owner(k) for k in KEYS[:2000]] == [pr.owner(k) for k in KEYS[:2000]]
    assert jp.out_members() == pp.out_members() and pr.active == jr.active
    rng = np.random.default_rng(0)
    jw, pw = jrouter.LatencyWindow(window=64), prouter.LatencyWindow(window=64)
    for ms in rng.exponential(40.0, 300):
        jw.observe_ms(float(ms))
        pw.observe_ms(float(ms))
        assert pw.hedge_deadline_s() == jw.hedge_deadline_s()
    addrs = [f"h{i}:5005{i}" for i in range(5)]
    jpick, ppick = jrouter.AccountAffinityPicker(addrs), prouter.AccountAffinityPicker(addrs)
    assert ppick.partition(KEYS[:3000]) == jpick.partition(KEYS[:3000])
    assert ppick.failover_addrs("whale-9") == jpick.failover_addrs("whale-9")


def test_endpoint_without_grpcio_raises(monkeypatch):
    """With grpcio hidden, a replica endpoint dials through the port's own
    transport and its health probe answers (it raised before the port had
    one)."""
    from igaming_platform_tpu_torch.serve import risk_codec

    monkeypatch.setitem(sys.modules, "grpc", None)
    health = pgrpc.HealthServicer()
    server, port = pgrpc.serve_methods(pgrpc.RISK_SERVICE, {}, health, 0)
    endpoint = prouter.ReplicaEndpoint("r0", f"localhost:{port}")
    try:
        resp = endpoint.health(risk_codec.encode(risk_codec.HEALTH_CHECK_REQUEST, {"service": ""}),
                               timeout=10)
        assert risk_codec.decode(risk_codec.HEALTH_CHECK_RESPONSE, resp)["status"] == pgrpc.SERVING
    finally:
        endpoint.close()
        server.stop(0).wait()
    assert prouter.HashRing(["r0"]).owner("x") == "r0"


# ---------------------------------------------------------------------------
# The router over replica fleets


class _SlowEngine:
    """An engine whose ``score`` stalls: the straggler a hedge is for."""

    def __init__(self, inner, delay_s: float):
        self._inner = inner
        self._delay_s = delay_s

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner"], name)

    def score(self, req, timeout: float = 30.0, **kw):
        time.sleep(self._delay_s)
        return self._inner.score(req, timeout=timeout, **kw)


class _Replica:
    def __init__(self, side: str, rid: str, delay_s: float = 0.0):
        self.side, self.rid = side, rid
        if side == "port":
            self.engine = TorchScoringEngine(
                device="cpu", batcher_config=BatcherConfig(batch_size=32, max_wait_ms=1.0))
            served = _SlowEngine(self.engine, delay_s) if delay_s else self.engine
            self.service = pgrpc.RiskGrpcService(served)
            self.server, self.health, self.port = pgrpc.serve_risk(self.service, 0)
        else:
            self.engine = TPUScoringEngine(
                batcher_config=JBatcherConfig(batch_size=32, max_wait_ms=1.0))
            served = _SlowEngine(self.engine, delay_s) if delay_s else self.engine
            self.service = jgrpc.RiskGrpcService(served)
            self.server, self.health, self.port = jgrpc.serve_risk(self.service, 0)
        self.addr = f"localhost:{self.port}"
        self.stopped = False

    def kill(self):
        if not self.stopped:
            self.server.stop(0)
            self.stopped = True

    def close(self):
        self.kill()
        if self.side == "port":
            self.service.close()
        self.engine.close()


def _router(side, replicas, **kw):
    mod = prouter if side == "port" else jrouter
    kw.setdefault("health_interval_s", 0.1)
    kw.setdefault("failure_threshold", 2)
    kw.setdefault("rng", random.Random(7))
    router = mod.ScoringRouter({r.rid: (r.addr, None) for r in replicas}, **kw)
    server, _health, port = mod.serve_router(router, 0)
    return router, server, f"localhost:{port}"


def _stubs(addr):
    ch = grpc.insecure_channel(addr)
    txn = ch.unary_unary("/risk.v1.RiskService/ScoreTransaction",
                         request_serializer=risk_pb2.ScoreTransactionRequest.SerializeToString,
                         response_deserializer=risk_pb2.ScoreTransactionResponse.FromString)
    batch = ch.unary_unary("/risk.v1.RiskService/ScoreBatch",
                           request_serializer=risk_pb2.ScoreBatchRequest.SerializeToString,
                           response_deserializer=risk_pb2.ScoreBatchResponse.FromString)
    return ch, txn, batch


def _fields(resp):
    return (resp.score, resp.action, list(resp.reason_codes), resp.rule_score,
            round(resp.ml_score, 6))


@pytest.fixture(scope="module")
def fleets():
    """Three port replicas and three JAX replicas, mock engines."""
    with pytest.MonkeyPatch.context() as mp, jax_hostprof_off():
        for knob, value in (("SLO", "0"), ("DRIFT", "0"), ("RUNTIME_TELEMETRY", "0"),
                            ("BURN_SHED", "0"), ("BULK_P99_SLO_MS", "0"),
                            ("DEADLINE_DEFAULT_MS", "600000")):
            mp.setenv(knob, value)
        jax_native_libs()
        out = {side: [_Replica(side, f"r{i}") for i in range(3)] for side in ("port", "jax")}
        yield out
        for reps in out.values():
            for r in reps:
                r.close()


def test_router_affinity_split_and_statuses_match_jax(fleets, time_limit):  # noqa: F811
    results = {}
    for side, replicas in fleets.items():
        router, server, addr = _router(side, replicas, hedge=False)
        ch, txn, batch = _stubs(addr)
        try:
            before = {r.rid: r.service.metrics.txns_scored_total.value() for r in replicas}
            accounts = [f"aff-{i}" for i in range(40)]
            singles = [_fields(txn(risk_pb2.ScoreTransactionRequest(
                account_id=a, amount=1500 + 7 * i, transaction_type="deposit"), timeout=10))
                for i, a in enumerate(accounts)]
            owned = {r.rid: sum(router.ring.owner(a) == r.rid for a in accounts)
                     for r in replicas}
            scored = {r.rid: r.service.metrics.txns_scored_total.value() - before[r.rid]
                      for r in replicas}
            assert scored == owned and router.stats["retries"] == 0
            txs = [risk_pb2.ScoreTransactionRequest(
                account_id=f"split-{i}", amount=1000 + 137 * i,
                transaction_type=("deposit", "bet", "withdraw")[i % 3]) for i in range(30)]
            assert len({router.ring.owner(t.account_id) for t in txs}) > 1
            via = batch(risk_pb2.ScoreBatchRequest(transactions=txs), timeout=15)
            ch0, _, batch0 = _stubs(replicas[0].addr)
            direct = batch0(risk_pb2.ScoreBatchRequest(transactions=txs), timeout=15)
            ch0.close()
            assert [_fields(r) for r in via.results] == [_fields(r) for r in direct.results]
            raw = ch.unary_unary("/risk.v1.RiskService/ScoreBatch")
            with pytest.raises(grpc.RpcError) as info:
                raw(b"\x00garbage-not-a-proto", timeout=10)
            results[side] = (singles, [_fields(r) for r in via.results], scored,
                             info.value.code())
        finally:
            ch.close()
            router.close()
            server.stop(0)
    assert results["port"] == results["jax"]
    assert results["port"][3] == grpc.StatusCode.INVALID_ARGUMENT


def test_health_eviction_and_readmission(fleets, time_limit):  # noqa: F811
    replicas = fleets["port"]
    router, server, _ = _router("port", replicas, hedge=False, health_interval_s=0.05)
    try:
        target = replicas[2]
        target.health.set("", pgrpc.NOT_SERVING)
        deadline = time.monotonic() + 5.0
        while target.rid in router.ring.active and time.monotonic() < deadline:
            time.sleep(0.02)
        assert target.rid not in router.ring.active
        assert router.replicas[target.rid].state == "brownout"
        assert router.metrics.ring_replicas.value(state="brownout") == 1
        target.health.set("", pgrpc.SERVING)
        deadline = time.monotonic() + 5.0
        while target.rid not in router.ring.active and time.monotonic() < deadline:
            time.sleep(0.02)
        assert target.rid in router.ring.active
        assert router.metrics.ring_replicas.value(state="serving") == 3
    finally:
        router.close()
        server.stop(0)


def test_killed_replica_fails_over(time_limit, monkeypatch):  # noqa: F811
    for knob in ("SLO", "DRIFT", "RUNTIME_TELEMETRY", "BURN_SHED", "BULK_P99_SLO_MS"):
        monkeypatch.setenv(knob, "0")
    replicas = [_Replica("port", f"r{i}") for i in range(3)]
    router, server, addr = _router("port", replicas, hedge=False)
    ch, txn, _ = _stubs(addr)
    try:
        victim = replicas[1]
        accounts = [f"kill-{i}" for i in range(24)]
        stranded = [a for a in accounts if router.ring.owner(a) == victim.rid]
        assert stranded
        base = {a: _fields(txn(risk_pb2.ScoreTransactionRequest(
            account_id=a, amount=4200, transaction_type="deposit"), timeout=10))
            for a in stranded}
        victim.kill()
        outcomes = []
        for a in stranded * 3:
            try:
                assert _fields(txn(risk_pb2.ScoreTransactionRequest(
                    account_id=a, amount=4200, transaction_type="deposit"),
                    timeout=10)) == base[a]
                outcomes.append("OK")
            except grpc.RpcError as exc:
                outcomes.append(exc.code().name)
        assert set(outcomes) <= {"OK", "UNAVAILABLE"} and outcomes.count("OK") > 0
        deadline = time.monotonic() + 5.0
        while victim.rid in router.ring.active and time.monotonic() < deadline:
            time.sleep(0.05)
        assert victim.rid not in router.ring.active
        assert router.stats["retries"] > 0
        assert router.metrics.router_retries_total.value(reason="unavailable") > 0
    finally:
        ch.close()
        router.close()
        server.stop(0)
        for r in replicas:
            r.close()


@pytest.mark.parametrize("delays,winner", [((0.0, 0.0, 1.0), "hedge"), ((0.25, 2.0), "primary")])
def test_hedging_accounts_each_outcome_once(delays, winner, time_limit, monkeypatch):  # noqa: F811
    for knob in ("SLO", "DRIFT", "RUNTIME_TELEMETRY", "BURN_SHED", "BULK_P99_SLO_MS"):
        monkeypatch.setenv(knob, "0")
    replicas = [_Replica("port", f"r{i}", d) for i, d in enumerate(delays)]
    slow = f"r{int(np.argmax(delays))}" if winner == "hedge" else "r0"
    latency = prouter.LatencyWindow(default_ms=60.0 if winner == "hedge" else 50.0,
                                    min_samples=10_000)
    router, server, addr = _router("port", replicas, hedge=True, latency=latency,
                                   rng=random.Random(3))
    ch, txn, _ = _stubs(addr)
    try:
        acct = next(f"hedge-{i}" for i in range(400) if router.ring.owner(f"hedge-{i}") == slow)
        t0 = time.monotonic()
        resp = txn(risk_pb2.ScoreTransactionRequest(account_id=acct, amount=900,
                                                    transaction_type="bet"), timeout=10)
        assert 0 <= resp.score <= 100
        m = router.metrics.hedge_total
        assert router.stats["hedges_launched"] == 1 == m.value(outcome="launched")
        if winner == "hedge":
            assert time.monotonic() - t0 < 0.9
            assert router.stats["hedge_wins"] == 1 and m.value(outcome="win_hedge") == 1
        else:
            assert router.stats["primary_wins"] == 1 and m.value(outcome="win_primary") == 1
        assert (m.value(outcome="win_hedge") + m.value(outcome="win_primary")
                + m.value(outcome="both_failed")) == m.value(outcome="launched")
    finally:
        ch.close()
        router.close()
        server.stop(0)
        for r in replicas:
            r.close()


# ---------------------------------------------------------------------------
# The fleet view and the fleet drift rollup


def _texts(seed: int, buckets=(1, 10, 100)) -> tuple[str, str]:
    """The same observations rendered by the port's and the JAX package's
    histogram."""
    out = []
    for cls in (Histogram, JHistogram):
        rng = np.random.default_rng(seed)
        h = cls("risk_stage_latency_ms", "t", buckets=buckets)
        for i, v in enumerate(rng.uniform(0.1, 300.0, 40)):
            h.observe(float(v), exemplar=f"t{seed}-{i}", stage=("score.dispatch", "s2")[i % 2])
        out.append("\n".join(h.render()))
    return out[0], out[1]


def _snap(s):
    return (s.buckets, s.counts, s.sum, s.count, s.exemplars)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleetview_merge_matches_jax(seed):
    texts = [_texts(seed + k) for k in range(3)]
    merged = {}
    for side, (parse, merge) in (("port", (pfv.parse_histograms, pfv.merge_histograms)),
                                 ("jax", (jfv.parse_histograms, jfv.merge_histograms))):
        fams = [parse(t[0] if side == "port" else t[1])["risk_stage_latency_ms"]
                for t in texts]
        merged[side] = {key: _snap(merge([f[key] for f in fams])) for key in fams[0]}
    assert merged["port"] == merged["jax"]
    a, b = _texts(9, (1, 10, 100))[0], _texts(9, (1, 5, 100))[0]
    snaps = [next(iter(pfv.parse_histograms(t)["risk_stage_latency_ms"].values())) for t in (a, b)]
    with pytest.raises(ValueError, match="bucket layout mismatch"):
        pfv.merge_histograms(snaps)


def _sidecar(routes: dict, hang: bool = False):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if hang:
                time.sleep(30)
                return
            if self.path not in routes:
                self.send_response(404)
                self.end_headers()
                return
            body = routes[self.path]
            data = (body if isinstance(body, str) else json.dumps(body)).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"127.0.0.1:{httpd.server_address[1]}"


def test_fleetview_sums_replicas_and_never_blocks(time_limit):  # noqa: F811
    """Merged counts equal the sum of the replicas'; a dead and a hung
    sidecar go stale within the horizon, and a snapshot never scrapes."""
    texts = [_texts(s)[0] for s in (3, 4)]
    sides = [_sidecar({"/metrics": t, "/debug/supervisorz": {"state": "serving"}})
             for t in texts]
    hung, hung_addr = _sidecar({}, hang=True)
    dead, dead_addr = _sidecar({})
    dead.shutdown()
    dead.server_close()
    metrics = ServiceMetrics("risk")
    view = pfv.FleetView({"r0": sides[0][1], "r1": sides[1][1], "r2": dead_addr,
                          "r3": hung_addr}, interval_s=0.2, timeout_s=0.3, stale_after_s=1.0,
                         metrics=metrics)
    try:
        t0 = time.monotonic()
        view.scrape_once()
        assert time.monotonic() - t0 < 4.0
        t0 = time.monotonic()
        snap = view.snapshot()
        assert time.monotonic() - t0 < 0.5
        by = {r["replica"]: r for r in snap["replicas"]}
        assert not by["r0"]["stale"] and not by["r1"]["stale"]
        assert by["r2"]["stale"] and by["r3"]["stale"] and by["r2"]["last_error"]
        per = [pfv.parse_histograms(t)["risk_stage_latency_ms"] for t in texts]
        for stage, block in snap["fleet_stage_latency_ms"].items():
            key = (("stage", stage),)
            assert block["count"] == sum(p[key].count for p in per) > 0
        assert metrics.fleet_replicas_scraped.value(freshness="fresh") == 2
        assert metrics.fleet_scrape_failures_total.value(replica="r2") >= 1
    finally:
        view.stop()
        for httpd, _ in sides:
            httpd.shutdown()
            httpd.server_close()
        hung.shutdown()
        hung.server_close()


def _sketch_vec(seed: int, n: int):
    rng = np.random.default_rng(seed)
    x, _y, _k = generate_labeled(rng, n)
    return jdrift.np_sketch(x, rng.integers(0, 101, n), rng.integers(1, 4, n))


def _driftz(seed, n, ref=None, edges_fp=None):
    payload = {"edges": {"fingerprint": edges_fp or jdrift.edges_fingerprint()},
               "window": {"rows": n, "vec": _sketch_vec(seed, n).tolist()},
               "alerts": {"input": False, "score": False, "calibration": False},
               "input": {"max_feature_psi": 0.01}}
    if ref is not None:
        payload["reference"] = ref.meta()
        payload["reference_state"] = ref.to_json()
    return payload


@pytest.mark.parametrize("case", ["same_ref", "mixed_edges", "ref_mismatch", "dead_replica"])
def test_fleet_drift_block_matches_jax(case):
    ref_a = jdrift.DriftReference.from_sketch(_sketch_vec(99, 600), source="a")
    ref_b = jdrift.DriftReference.from_sketch(_sketch_vec(98, 300), source="b")
    payloads = {
        "same_ref": [(f"r{i}", _driftz(i, 100 * (i + 1), ref_a)) for i in range(3)],
        "mixed_edges": [("r0", _driftz(1, 100)), ("r1", _driftz(2, 100)),
                        ("r2", _driftz(5, 50, edges_fp="feedfacefeedface"))],
        "ref_mismatch": [("r0", _driftz(3, 100, ref_a)), ("r1", _driftz(4, 100, ref_b))],
        "dead_replica": [("r0", _driftz(6, 120)), ("r1", None)],
    }[case]
    want = jdrift.fleet_drift_block(payloads)
    got = pdrift.fleet_drift_block(payloads)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert pdrift.edges_fingerprint() == jdrift.edges_fingerprint()
    if case == "same_ref":
        assert got["rows"] == 600 and "fleet_psi" in got
