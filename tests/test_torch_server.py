"""Port parity: serve/grpc_server.py and serve/server.py, the risk.v1 front.

The JAX package's RiskGrpcService and the port's, each behind its own
``serve_risk`` on the CPU over grpcio, get the same stores (the same seeded
events with fixed timestamps, the clock pinned), the same params (carried by
convert.py) and the same detector histories, on the ``mock`` and
``mlp+gbdt`` backends, with ``WIRE_MODE=index`` (each engine's feature cache
built at warmup, its clock pinned too), and on ``mlp+gbdt`` also with the
bf16 and int8 row wires (``WIRE_DTYPE``). The port's service runs its drift
observatory (on by default); the JAX one runs without its SLO, drift and
runtime-telemetry planes. Every RPC of the slice goes to both
as request bytes built with ``risk_pb2``, and ScoreBatch also as index-mode
frames (``IDX1``, built with the JAX package's ``encode_index_batch``), one
of them truncated. Both answers are parsed with ``risk_pb2``;
response_time_ms and computed_at are zeroed; ml_score is held with
tests/test_torch_ensemble.py::assert_outputs_match and abuse_score to the
detector's atol 1e-5 (tests/test_torch_abuse.py), then set equal; every
other byte must be equal. One case drives the port's byte handlers with no
transport (``RiskGrpcService.call``).

The sidecar's /debug/driftz and /debug/shadowz answer with the keys the JAX
server's pages have (its ``DriftEngine.snapshot()`` and
``{"shadow": ShadowScorer.report()}``), and POST /debug/driftz pins, saves
and loads a reference.
"""

import sys
import types

import grpc
import numpy as np
import pytest
import torch
from test_torch_abuse import _feed
from test_torch_ensemble import assert_outputs_match, jax_tree
from test_torch_rules_mock import _raw_batch
from test_torch_sequence import SERVE_CFG, seq_tree
from torch_front_common import (
    T0,
    checked_rows,
    event_columns,
    fill,
    jax_hostprof_off,
    jax_native_libs,
    pin_jax_clock,
    requests,
)

from igaming_platform_tpu.core.config import BatcherConfig as JBatcherConfig
from igaming_platform_tpu.models.sequence import SeqConfig as JSeqConfig
from igaming_platform_tpu.proto_gen.risk.v1 import risk_pb2
from igaming_platform_tpu.serve import device_cache as jax_device_cache
from igaming_platform_tpu.serve import grpc_server as jgrpc
from igaming_platform_tpu.serve import wire as jax_wire
from igaming_platform_tpu.serve.abuse import SequenceAbuseDetector as JDetector
from igaming_platform_tpu.serve.native_store import NativeFeatureStore as JaxNativeStore
from igaming_platform_tpu.serve.scorer import TPUScoringEngine
from igaming_platform_tpu_torch.convert import from_jax_params
from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
from igaming_platform_tpu_torch.serve import grpc_server, server
from igaming_platform_tpu_torch.serve.native_store import NativeFeatureStore
from igaming_platform_tpu_torch.serve.wire import RawProtoMessage

N_ACCOUNTS = 50
ABUSE_ATOL = 1e-5


def _boot(backend, mp):
    """Both services over grpcio, with equal stores, params and histories:
    the JAX one with ``DRIFT=0``, the port's with its default drift engine."""
    cols = event_columns(7, N_ACCOUNTS, 1200)
    jstore, tstore = JaxNativeStore(max_accounts=500), NativeFeatureStore(max_accounts=500,
                                                                          clock=lambda: T0)
    fill([jstore, tstore], cols, bonus_accounts=[f"acct{a}" for a in range(0, N_ACCOUNTS, 3)],
         blacklist=[("device", "dev4"), ("ip", "ip9"), ("fingerprint", "fp2")])
    tree = jax_tree(backend)
    seq, model = seq_tree(SERVE_CFG, seed=3)
    jdet = JDetector(params=seq, cfg=JSeqConfig(**SERVE_CFG))
    jengine = TPUScoringEngine(ml_backend=backend, params=tree or None, feature_store=jstore,
                               batcher_config=JBatcherConfig(batch_size=64, max_wait_ms=1.0))
    jservice = jgrpc.RiskGrpcService(jengine, abuse_detector=jdet.check)
    mp.delenv("DRIFT")
    config = RiskServiceConfig(batcher=BatcherConfig(batch_size=64, max_wait_ms=1.0))
    assembled = server.assemble_risk_service(
        config, ml_backend=backend, params=from_jax_params(backend, tree), feature_store=tstore,
        abuse_params=model, device="cpu")
    abuse_accounts = _feed([jdet, assembled.abuse])
    jserver, _, jport = jgrpc.serve_risk(jservice, 0)
    tserver, _, tport = grpc_server.serve_risk(assembled.service, 0)
    channels = [grpc.insecure_channel(f"localhost:{p}") for p in (jport, tport)]
    stubs = [grpc_server.make_risk_stub(c) for c in channels]
    assert assembled.service.drift is not None and assembled.engine.drift is not None
    return {"stubs": stubs, "ports": (jport, tport), "service": assembled.service,
            "abuse_accounts": abuse_accounts,
            "close": lambda: ([c.close() for c in channels], jserver.stop(0), tserver.stop(0),
                              jengine.close(), assembled.engine.close(),
                              assembled.service.close())}


@pytest.fixture(scope="module")
def services(request):
    """Both services booted under settings that no host load can change:
    the JAX native libraries loaded (a concurrent first build can leave
    them unloaded in a worker), the JAX host profiler off, a default
    deadline no slow host reaches, and no shed driven by latency."""
    jax_native_libs()
    with pytest.MonkeyPatch.context() as mp, jax_hostprof_off():
        for knob in ("SLO", "DRIFT", "RUNTIME_TELEMETRY"):  # JAX planes, off for its service
            mp.setenv(knob, "0")
        mp.setenv("DEADLINE_DEFAULT_MS", "600000")
        mp.setenv("BURN_SHED", "0")
        mp.setenv("BULK_P99_SLO_MS", "0")
        mp.setenv("WIRE_MODE", "index")
        backend, _, wire = request.param.partition("/")
        mp.setenv("WIRE_DTYPE", wire or "float32")
        pin_jax_clock(mp)
        mp.setattr(jax_device_cache, "time", types.SimpleNamespace(time=lambda: T0))
        booted = _boot(backend, mp)
        yield request.param, booted
        booted["close"]()


def _via_grpc(stub, method, payload):
    try:
        return "OK", getattr(stub, method)(payload, timeout=60)
    except grpc.RpcError as exc:
        return exc.code().name, None


def _via_bytes(service, method, payload):
    try:
        return "OK", service.call(method, payload)
    except grpc_server.RpcAbort as exc:
        return exc.code.name, None


def _score_columns(rows):
    return {"score": np.array([r.score for r in rows]), "action": np.array([r.action for r in rows]),
            "rule_score": np.array([r.rule_score for r in rows]),
            "ml_score": np.array([r.ml_score for r in rows], np.float32),
            "reason_mask": np.array([sum(1 << _BIT[c] for c in r.reason_codes) for r in rows])}


def _bit_of_reason():
    from igaming_platform_tpu.core.enums import REASON_BIT_ORDER

    return {code.value: bit for bit, code in enumerate(REASON_BIT_ORDER)}


_BIT = _bit_of_reason()


def _assert_same(method, want_bytes, got_bytes, label):
    """Both answers parsed with risk_pb2, clock fields zeroed, float model
    outputs held to their tolerances and set equal, then every byte equal."""
    cls = getattr(risk_pb2, f"{method}Response")
    want, got = cls.FromString(want_bytes), cls.FromString(got_bytes)
    rows = {"ScoreTransaction": lambda m: [m], "ScoreBatch": lambda m: list(m.results)}.get(method)
    if rows is not None:
        wrows, grows = rows(want), rows(got)
        assert len(wrows) == len(grows)
        wcols, gcols = _score_columns(wrows), _score_columns(grows)
        assert_outputs_match({k: torch.from_numpy(v) for k, v in gcols.items()}, wcols, label)
        for w, g, exact in zip(wrows, grows, checked_rows(gcols, wcols)):
            w.response_time_ms = g.response_time_ms = 0
            g.ml_score = w.ml_score
            if not exact:  # within 1e-4 of a floor boundary: excused above
                g.score, g.action = w.score, w.action
    elif method == "CheckBonusAbuse":
        assert abs(got.abuse_score - want.abuse_score) <= ABUSE_ATOL, label
        got.abuse_score = want.abuse_score
    elif method == "GetFeatures":
        want.computed_at.Clear()
        got.computed_at.Clear()
    assert got.SerializeToString() == want.SerializeToString(), label


def _index_frame(txs) -> RawProtoMessage:
    """An index-mode ScoreBatch frame of ``txs``, as a message whose bytes
    are the frame."""
    return RawProtoMessage(jax_wire.encode_index_batch(
        [t.account_id for t in txs], [t.amount for t in txs],
        [t.transaction_type or "deposit" for t in txs], ips=[t.ip_address for t in txs],
        devices=[t.device_id for t in txs], fingerprints=[t.fingerprint for t in txs]))


def _exchanges(accounts):
    """(method, request message) in the order sent: every RPC of the slice,
    thresholds changed midway and restored."""
    txs = [risk_pb2.ScoreTransactionRequest(**r) for r in requests(8, 150, N_ACCOUNTS)]
    out = [("ScoreTransaction", t) for t in txs[:10]]
    out.append(("ScoreBatch", risk_pb2.ScoreBatchRequest(transactions=txs)))
    out.append(("ScoreBatch", _index_frame(txs)))
    out += [("CheckBonusAbuse", risk_pb2.CheckBonusAbuseRequest(account_id=a, bonus_id="b1"))
            for a in accounts[:4] + accounts[-1:]]
    out += [("AddToBlacklist", risk_pb2.AddToBlacklistRequest(type=t, value=v, reason="r"))
            for t, v in (("device", "dev11"), ("ip", "ip3"), ("email", "x@y"))]
    out += [("CheckBlacklist", risk_pb2.CheckBlacklistRequest(**kw))
            for kw in ({"device_id": "dev11"}, {"ip_address": "ip3"}, {"fingerprint": "fp2"},
                       {"device_id": "dev1", "email": "e"})]
    out += [("GetFeatures", risk_pb2.GetFeaturesRequest(account_id=a))
            for a in ("acct1", "acct7", "nobody")]
    out.append(("UpdateThresholds", risk_pb2.UpdateThresholdsRequest(block_threshold=30,
                                                                     review_threshold=10)))
    out.append(("GetThresholds", risk_pb2.GetThresholdsRequest()))
    out += [("ScoreTransaction", t) for t in txs[10:14]]
    out.append(("ScoreBatch", risk_pb2.ScoreBatchRequest(transactions=txs[:70])))
    out.append(("ScoreBatch", _index_frame(txs[40:120])))
    out.append(("ScoreBatch", RawProtoMessage(_index_frame(txs[:9]).SerializeToString()[:-3])))
    out.append(("UpdateThresholds", risk_pb2.UpdateThresholdsRequest(block_threshold=80,
                                                                     review_threshold=50)))
    return out


@pytest.mark.parametrize("services,transport", [("mock", "grpc"), ("mlp+gbdt", "grpc"),
                                                ("mlp+gbdt", "bytes"), ("mlp+gbdt/bf16", "bytes"),
                                                ("mlp+gbdt/int8", "bytes")],
                         indirect=["services"])
def test_port_answers_as_the_jax_server(services, transport):
    backend, booted = services
    wire_bytes = {"": 4, "bf16": 2, "int8": 1}[backend.partition("/")[2]]
    assert booted["service"].engine._wire_dtype.itemsize == wire_bytes
    jstub, tstub = booted["stubs"]
    codes = []
    for i, (method, msg) in enumerate(_exchanges(booted["abuse_accounts"])):
        payload = msg.SerializeToString()
        want = _via_grpc(jstub, method, payload)
        got = (_via_grpc(tstub, method, payload) if transport == "grpc"
               else _via_bytes(booted["service"], method, payload))
        label = f"{backend} {transport} #{i} {method}"
        assert got[0] == want[0], label
        codes.append(got[0])
        if want[0] == "OK":
            _assert_same(method, want[1], got[1], label)
    assert codes.count("INVALID_ARGUMENT") == 2 and codes.count("OK") == len(codes) - 2
    assert booted["service"].engine.cache.stats()["hits"] > 0


def test_unported_methods_and_missing_grpc(monkeypatch):
    """Only a method risk.v1 does not have answers UNIMPLEMENTED: PredictLTV
    and GetPlayerSegment answer (tests/test_torch_ltv.py holds them to the
    JAX service); without grpcio ``serve_risk`` serves them over the port's
    own transport (it raised before the port had one)."""
    service = grpc_server.RiskGrpcService(engine=types.SimpleNamespace(device="cpu"))
    with pytest.raises(grpc_server.RpcAbort) as exc:
        service.call("Nope", b"")
    assert exc.value.code is grpc_server.StatusCode.UNIMPLEMENTED
    for method in ("PredictLTV", "GetPlayerSegment"):
        assert service.call(method, b"")
    assert {c.name: c.value for c in grpc_server.StatusCode} == {
        c.name: c.value[0] for c in grpc.StatusCode}
    monkeypatch.setitem(sys.modules, "grpc", None)
    from igaming_platform_tpu_torch.serve import grpc_wire
    from igaming_platform_tpu_torch.serve import risk_codec as codec

    server, _, port = grpc_server.serve_risk(service, 0)
    channel = grpc_wire.insecure_channel(f"localhost:{port}")
    try:
        stub = grpc_server.make_risk_stub(channel)
        for method, message in (("PredictLTV", codec.PREDICT_LTV_RESPONSE),
                                ("GetPlayerSegment", codec.GET_PLAYER_SEGMENT_RESPONSE)):
            got = codec.decode(message, getattr(stub, method)(b"", timeout=30))
            want = codec.decode(message, service.call(method, b""))
            got.pop("predicted_at", None)  # the answer's own clock
            want.pop("predicted_at", None)
            assert got == want
        with pytest.raises(grpc_wire.RpcError) as missing:
            channel.unary_unary("/risk.v1.RiskService/Nope")(b"", timeout=30)
        assert missing.value.code() is grpc_server.StatusCode.UNIMPLEMENTED
    finally:
        channel.close()
        server.stop(0).wait()


def test_index_mode_sidecar_pages(monkeypatch):
    """WIRE_MODE=index and SESSION_STATE=1 through ``assemble_risk_service``
    over the Python store (no native decoder): a protobuf ScoreBatch goes
    through the columnar index path and answers as the same rows in an IDX1
    frame; a ScoreTransaction is counted as session bypass; /debug/cachez
    and /debug/sessionz serve ``cache.stats()`` and ``session.snapshot()``,
    and 404 on a server without them."""
    import json
    import urllib.error
    import urllib.request

    from igaming_platform_tpu_torch.serve.feature_store import (
        InMemoryFeatureStore,
        TransactionEvent,
    )

    def page(port, path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            return exc.code, None

    # BURN_SHED=0: a slow host's ScoreBatch latency must not shed this
    # test's bulk call (the SLO plane is on by default).
    for knob, value in (("WIRE_MODE", "index"), ("SESSION_STATE", "1"),
                        ("FEATURE_CACHE_CAPACITY", "256"), ("BURN_SHED", "0")):
        monkeypatch.setenv(knob, value)
    config = RiskServiceConfig(batcher=BatcherConfig(batch_size=64, max_wait_ms=1.0))
    store = InMemoryFeatureStore(clock=lambda: T0)
    for a, m, k, ip, dev, ts in zip(*event_columns(7, N_ACCOUNTS, 400)):
        store.update(TransactionEvent(a, m, k, ip=ip, device_id=dev, timestamp=ts))
    servers = [server.RiskServer(server.assemble_risk_service(
        config, feature_store=store, device="cpu", session_state=on), grpc_port=-1, http_port=0)
        for on in (True, False)]
    try:
        svc = servers[0].service
        txs = [risk_pb2.ScoreTransactionRequest(**r) for r in requests(9, 90, N_ACCOUNTS)]
        via_proto = risk_pb2.ScoreBatchResponse.FromString(svc.call(
            "ScoreBatch", risk_pb2.ScoreBatchRequest(transactions=txs).SerializeToString()))
        svc.call("ScoreTransaction", txs[0].SerializeToString())
        status, sessionz = page(servers[0].http_port, "/debug/sessionz")
        assert status == 200 and sessionz == svc.engine.session.snapshot()
        assert sessionz["appends"] == 90 and sessionz["rows"]["bypass"] == 1
        via_frame = risk_pb2.ScoreBatchResponse.FromString(
            svc.call("ScoreBatch", _index_frame(txs).SerializeToString()))
        for r in list(via_proto.results) + list(via_frame.results):
            r.response_time_ms = 0
            assert not r.HasField("features")  # no echo: the rows never reach the host
        # The second pass appends each account's second event: the rows
        # differ only by session state (reason bits of cold windows).
        assert [r.rule_score for r in via_frame.results] == [r.rule_score for r in via_proto.results]
        status, cachez = page(servers[0].http_port, "/debug/cachez")
        cache = svc.engine.cache
        assert status == 200 and cachez == {**cache.stats(), "shards": cache.shard_stats(),
                                             "session_shards": svc.engine.session.shard_stats()}
        assert cachez["hits"] >= 90 and cachez["capacity"] == 256
        assert page(servers[1].http_port, "/debug/sessionz")[0] == 404
        assert page(servers[1].http_port, "/debug/cachez")[0] == 200  # index mode: a cache
    finally:
        for srv in servers:
            srv.shutdown(grace=1.0)


def _keys(tree):
    """The nested key structure of a JSON payload (dicts by key, lists by
    their first element)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree:
        return [_keys(tree[0])]
    return None


def test_drift_and_shadow_sidecar_pages(monkeypatch, tmp_path):
    """/debug/driftz and /debug/shadowz against the JAX server's payloads'
    keys, after traffic and a pinned reference; POST /debug/driftz pins,
    saves and loads; the pages 404 without a drift engine or a shadow; the
    shutdown drains and closes the drift engine."""
    import json
    import urllib.error
    import urllib.request

    from igaming_platform_tpu.core.config import ScoringConfig as JScoringConfig
    from igaming_platform_tpu.obs import drift as jdrift
    from igaming_platform_tpu.serve.shadow import ShadowScorer as JShadowScorer
    from igaming_platform_tpu_torch.obs import drift as tdrift
    from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore
    from igaming_platform_tpu_torch.serve.shadow import ShadowScorer

    def call(port, path, body=None):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=None if body is None else json.dumps(body).encode(),
                                     method="GET" if body is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())

    monkeypatch.delenv("DRIFT", raising=False)
    monkeypatch.setenv("DRIFT_MIN_ROWS", "10")
    tree = jax_tree("mlp+gbdt")
    config = RiskServiceConfig(batcher=BatcherConfig(batch_size=64, max_wait_ms=1.0))
    srv = server.RiskServer(server.assemble_risk_service(
        config, ml_backend="mlp+gbdt", params=from_jax_params("mlp+gbdt", tree),
        feature_store=InMemoryFeatureStore(clock=lambda: T0), device="cpu"),
        grpc_port=-1, http_port=0)
    jde = jdrift.DriftEngine(jdrift.DriftConfig(min_rows=10))
    jsh = JShadowScorer(types.SimpleNamespace(config=JScoringConfig(), ml_backend="mlp+gbdt",
                                              params_fingerprint="f"), tree)
    try:
        port, drift = srv.http_port, srv.service.drift
        assert call(port, "/debug/shadowz")[0] == 404
        txs = [risk_pb2.ScoreTransactionRequest(**r) for r in requests(10, 90, N_ACCOUNTS)]
        payload = risk_pb2.ScoreBatchRequest(transactions=txs).SerializeToString()
        srv.service.call("ScoreBatch", payload)
        assert drift.drain(10.0)
        assert call(port, "/debug/driftz", {"action": "save", "path": "x"})[0] == 400
        assert call(port, "/debug/driftz", {"action": "nope"})[0] == 400
        status, pinned = call(port, "/debug/driftz", {"action": "pin_reference"})
        assert status == 200 and pinned["ok"] and pinned["reference"]["rows"] == 90
        path = str(tmp_path / "ref.json")
        assert call(port, "/debug/driftz", {"action": "save", "path": path})[0] == 200
        assert jdrift.DriftReference.load(path).fingerprint() == pinned["reference"]["fingerprint"]
        assert call(port, "/debug/driftz", {"action": "load", "path": path})[0] == 200
        srv.engine.shadow = ShadowScorer(srv.engine, from_jax_params("mlp+gbdt", tree))
        srv.service.call("ScoreBatch", payload)
        assert drift.drain(10.0) and srv.engine.shadow.drain(10.0)
        status, driftz = call(port, "/debug/driftz")
        assert status == 200 and driftz["window"]["rows"] == 180
        x = _raw_batch(48, 90)
        jde.submit(jdrift.np_sketch(x, np.zeros(90), np.ones(90)), 90)
        assert jde.drain(10.0)
        jde.pin_reference()
        assert _keys(driftz) == _keys(json.loads(json.dumps(jde.snapshot())))
        status, shadowz = call(port, "/debug/shadowz")
        assert status == 200 and shadowz["shadow"]["window"]["rows"] == 90
        assert shadowz["shadow"]["window"]["action_flips"] == 0  # the candidate is production
        assert _keys(shadowz) == _keys({"shadow": json.loads(json.dumps(jsh.report()))})
    finally:
        jde.close()
        jsh.close()
        shadow = srv.engine.shadow
        srv.shutdown(grace=1.0)
        if shadow is not None:
            shadow.close()
    assert tdrift.get_default() is None and srv.service.drift is None
    monkeypatch.setenv("DRIFT", "0")
    off = server.RiskServer(server.assemble_risk_service(
        config, feature_store=InMemoryFeatureStore(clock=lambda: T0), device="cpu"),
        grpc_port=-1, http_port=0)
    try:
        assert call(off.http_port, "/debug/driftz")[0] == 404
        assert call(off.http_port, "/debug/driftz", {"action": "pin_reference"})[0] == 404
    finally:
        off.shutdown(grace=1.0)
