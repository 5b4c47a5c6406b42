"""The port's own gRPC transport: serve/hpack.py, serve/h2.py, serve/grpc_wire.py.

HPACK: the Huffman table of RFC 7541 Appendix B is canonical (rebuilt from
its code lengths alone, Kraft sum exactly 1 with EOS) and round-trips every
octet; the request and response sequences of Appendix C.3-C.6 decode to
their header lists, with the dynamic table's entries and size after each.

Against grpcio 1.76 as the reference peer, on ephemeral ports: every risk.v1
RPC (tests/test_torch_server.py's exchanges over equal stores), health,
reflection and every wallet.v1 RPC (tests/test_torch_wallet_server.py's
script) from the port's client to the JAX server and to the port's server
answer as grpcio's client is answered by the JAX server, bytes (time fields
zeroed), statuses, details and trailing metadata, the error paths and their
pushback included; grpcio's client to the port's server is held the same way
in those files. Edges, from both clients and to both servers: a
16,384-row ScoreBatch (across flow control both ways), a message over 4 MiB
(RESOURCE_EXHAUSTED), an expired deadline (DEADLINE_EXCEEDED, also from the
server when the request carries an expired ``grpc-timeout``),
``risk-deadline-ms`` metadata reaching serve/deadline.py, 32 concurrent
callers on one channel, ``graceful_stop`` finishing a call in flight and
refusing new ones, and a router replica killed and restarted redialled
within the configured backoff. With grpcio hidden, the risk and wallet
servers boot on their ``GRPC_PORT`` in a subprocess and answer over the wire
(SIGTERM drains them), and ``serve_router`` serves.
"""

import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent import futures
from fractions import Fraction
from pathlib import Path

import grpc
import pytest

from igaming_platform_tpu.proto_gen.grpc.reflection.v1alpha import reflection_pb2 as rp
from igaming_platform_tpu.proto_gen.risk.v1 import risk_pb2
from igaming_platform_tpu.serve.reflection import reflection_handler
from igaming_platform_tpu_torch.serve import grpc_server, grpc_wire, h2, hpack
from igaming_platform_tpu_torch.serve import risk_codec as codec
from igaming_platform_tpu_torch.serve import router as prouter
from test_torch_reflection import KINDS, NAMES, SERVICE_NAME
from test_torch_server import N_ACCOUNTS, _assert_same, _exchanges, services  # noqa: F401
from test_torch_wallet_server import _run
from torch_front_common import pinned_wallet, requests

REPO = Path(__file__).resolve().parent.parent
RISK = "/risk.v1.RiskService/"
MiB = 1 << 20

# ---------------------------------------------------------------------------
# HPACK


def test_huffman_table_is_canonical():
    """The codes follow from the lengths alone: sorted by (length, octet),
    each code is the previous plus one, shifted to its length; the lengths'
    Kraft sum is exactly 1, EOS included, and EOS is the all-ones code."""
    codes = hpack.HUFFMAN_CODES
    assert len(codes) == 257
    code, prev = -1, min(n for _, n in codes)
    rebuilt = {}
    for sym in sorted(range(257), key=lambda s: (codes[s][1], s)):
        n = codes[sym][1]
        code = (code + 1) << (n - prev)
        prev = n
        rebuilt[sym] = (code, n)
    assert [rebuilt[s] for s in range(257)] == list(codes)
    assert sum(Fraction(1, 2 ** n) for _, n in codes) == 1
    assert codes[hpack.EOS] == ((1 << 30) - 1, 30)


def test_huffman_round_trip_every_octet():
    for octet in range(256):
        one = bytes((octet,))
        assert hpack.huffman_decode(hpack.huffman_encode(one)) == one
    rng = random.Random(7)
    for n in (0, 1, 7, 256, 4096):
        data = bytes(range(256)) + bytes(rng.randrange(256) for _ in range(n))
        assert hpack.huffman_decode(hpack.huffman_encode(data)) == data
    assert hpack.huffman_encode(b"www.example.com").hex() == "f1e3c2e5f23a6ba0ab90f4ff"
    for bad in (b"\xff\xff\xff\xff", b"\x00\x7f"[:1] + b"\xfe"):  # EOS; padding with a zero
        with pytest.raises(hpack.HpackError):
            hpack.huffman_decode(bad)


_REQ = [[(":method", "GET"), (":scheme", "http"), (":path", "/"),
         (":authority", "www.example.com")],
        [(":method", "GET"), (":scheme", "http"), (":path", "/"),
         (":authority", "www.example.com"), ("cache-control", "no-cache")],
        [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
         (":authority", "www.example.com"), ("custom-key", "custom-value")]]
_REQ_TABLES = [([(":authority", "www.example.com")], 57),
               ([("cache-control", "no-cache"), (":authority", "www.example.com")], 110),
               ([("custom-key", "custom-value"), ("cache-control", "no-cache"),
                 (":authority", "www.example.com")], 164)]
_DATE1, _DATE2 = "Mon, 21 Oct 2013 20:13:21 GMT", "Mon, 21 Oct 2013 20:13:22 GMT"
_LOC = "https://www.example.com"
_COOKIE = "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1"
_RESP = [[(":status", "302"), ("cache-control", "private"), ("date", _DATE1), ("location", _LOC)],
         [(":status", "307"), ("cache-control", "private"), ("date", _DATE1), ("location", _LOC)],
         [(":status", "200"), ("cache-control", "private"), ("date", _DATE2), ("location", _LOC),
          ("content-encoding", "gzip"), ("set-cookie", _COOKIE)]]
_RESP_TABLES = [([("location", _LOC), ("date", _DATE1), ("cache-control", "private"),
                  (":status", "302")], 222),
                ([(":status", "307"), ("location", _LOC), ("date", _DATE1),
                  ("cache-control", "private")], 222),
                ([("set-cookie", _COOKIE), ("content-encoding", "gzip"), ("date", _DATE2)], 215)]
RFC7541 = {
    "C.3": (4096, _REQ, _REQ_TABLES, [
        "828684410f7777772e6578616d706c652e636f6d", "828684be58086e6f2d6361636865",
        "828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565"]),
    "C.4": (4096, _REQ, _REQ_TABLES, [
        "828684418cf1e3c2e5f23a6ba0ab90f4ff", "828684be5886a8eb10649cbf",
        "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf"]),
    "C.5": (256, _RESP, _RESP_TABLES, [
        "4803333032580770726976617465611d4d6f6e2c203231204f637420323031332032303a31333a3231"
        "20474d546e1768747470733a2f2f7777772e6578616d706c652e636f6d",
        "4803333037c1c0bf",
        "88c1611d4d6f6e2c203231204f637420323031332032303a31333a323220474d54c05a04677a6970"
        "7738666f6f3d4153444a4b48514b425a584f5157454f50495541585157454f49553b206d61782d61"
        "67653d333630303b2076657273696f6e3d31"]),
    "C.6": (256, _RESP, _RESP_TABLES, [
        "488264025885aec3771a4b6196d07abe941054d444a8200595040b8166e082a62d1bff6e919d29ad"
        "171863c78f0b97c8e9ae82ae43d3",
        "4883640effc1c0bf",
        "88c16196d07abe941054d444a8200595040b8166e084a62d1bffc05a839bd9ab77ad94e7821dd7f2"
        "e6c7b335dfdfcd5b3960d5af27087f3672c1ab270fb5291f9587316065c003ed4ee5b1063d5007"]),
}


@pytest.mark.parametrize("section", sorted(RFC7541))
def test_rfc7541_examples(section):
    """Each block of the section decodes to its header list; the dynamic
    table holds the section's entries (newest first) and size after each,
    evictions included (C.5/C.6 run with a 256-octet table)."""
    size, lists, tables, blocks = RFC7541[section]
    decoder = hpack.Decoder(max_allowed=4096)
    decoder.max_size = size
    for block, want, (table, table_size) in zip(blocks, lists, tables):
        assert decoder.decode(bytes.fromhex(block)) == want
        assert (decoder.dynamic, decoder.size) == (table, table_size)
    encoder = hpack.Encoder()
    for headers in lists:  # the encoder's literals decode in any order of blocks
        assert hpack.Decoder().decode(encoder.encode(headers)) == headers


# ---------------------------------------------------------------------------
# Clients against servers


def _metadata(md) -> tuple:
    return tuple((m[0], m[1]) for m in md or ())


def _outcome(fn, payload, timeout=60, metadata=None):
    """(status name, response bytes or None, details, trailing metadata) of
    one call through either client."""
    try:
        resp, call = fn.with_call(payload, timeout=timeout, metadata=metadata)
        return "OK", resp, "", _metadata(call.trailing_metadata())
    except (grpc.RpcError, grpc_wire.RpcError) as exc:
        return exc.code().name, None, exc.details(), _metadata(exc.trailing_metadata())


def _clients(ports):
    """{(client, server): channel} for grpcio's client and the port's, to the
    JAX server and the port's."""
    return {(client, side): mod.insecure_channel(f"localhost:{port}")
            for client, mod in (("grpcio", grpc), ("wire", grpc_wire))
            for side, port in zip(("jax", "port"), ports)}


def _expired_at_the_server(channel, payload):
    """A call whose ``grpc-timeout`` has passed when it arrives, answered by
    the server: the port's client with its own expiry held back."""
    call = channel._start(RISK + "ScoreTransaction", True, payload, 1e-9, (), None)
    call._deadline = None
    call._wait(30)
    return call.code().name


def _burst(fn, payloads, n_threads=32):
    with futures.ThreadPoolExecutor(n_threads) as pool:
        return list(pool.map(lambda p: fn(p, timeout=60), payloads))


@pytest.mark.parametrize("services", ["mock", "mlp+gbdt"], indirect=True)
def test_risk_rpcs_from_each_client(services):
    """Every exchange of tests/test_torch_server.py, health, and the error
    paths through the port's client to both servers, held to grpcio's client
    against the JAX server; on ``mock`` also the edges."""
    backend, booted = services
    channels = _clients(booted["ports"])
    try:
        exchanges = _exchanges(booted["abuse_accounts"])
        exchanges.append(("ScoreTransaction", risk_pb2.ScoreTransactionRequest(
            account_id="acct3", amount=5000, transaction_type="deposit")))
        for i, (method, msg) in enumerate(exchanges):
            payload = msg.SerializeToString()
            want = _outcome(channels["grpcio", "jax"].unary_unary(RISK + method), payload)
            for key in (("wire", "jax"), ("wire", "port")):
                got = _outcome(channels[key].unary_unary(RISK + method), payload)
                label = f"{backend} {key} #{i} {method}"
                assert got[0] == want[0], (label, got, want)
                if want[0] != "OK":
                    assert got[2:] == want[2:], (label, got, want)
                if want[0] == "OK":
                    _assert_same(method, want[1], got[1], label)
        health = codec.encode(codec.HEALTH_CHECK_REQUEST, {"service": ""})
        shed = risk_pb2.ScoreTransactionRequest(account_id="acct1", amount=10,
                                                transaction_type="bet").SerializeToString()
        for key, channel in channels.items():
            check = grpc_server.make_health_stub(channel).Check
            assert check(health, timeout=30) == codec.encode(
                codec.HEALTH_CHECK_RESPONSE, {"status": grpc_server.SERVING}), key
            # risk-deadline-ms reaches serve/deadline.py: a spent budget is
            # shed at admission, with the pushback hint, from either server.
            code, _, details, trailing = _outcome(
                channel.unary_unary(RISK + "ScoreTransaction"), shed,
                metadata=(("risk-deadline-ms", "0"),))
            assert (code, details, trailing) == (
                "DEADLINE_EXCEEDED", "DEADLINE_SHED: request budget (0 ms, source=metadata) "
                "already spent at admission", (("grpc-retry-pushback-ms", "250"),)), key
            code, _, details, _ = _outcome(channel.unary_unary(RISK + "Nope"), b"")
            assert (code, details) == ("UNIMPLEMENTED", "Method not found!"), key
        if backend == "mock":
            _edges(booted, channels)
    finally:
        for channel in channels.values():
            channel.close()


def _edges(booted, channels):
    txs = requests(9, 16_384, N_ACCOUNTS)
    big = risk_pb2.ScoreBatchRequest(
        transactions=[risk_pb2.ScoreTransactionRequest(**t) for t in txs]).SerializeToString()
    assert len(big) > 10 * h2.DEFAULT_WINDOW
    want = _outcome(channels["grpcio", "jax"].unary_unary(RISK + "ScoreBatch"), big)
    assert want[0] == "OK" and len(want[1]) > 8 * h2.DEFAULT_WINDOW
    for key in (("grpcio", "port"), ("wire", "jax"), ("wire", "port")):
        got = _outcome(channels[key].unary_unary(RISK + "ScoreBatch"), big)
        assert got[0] == "OK", (key, got[:1], got[2])
        _assert_same("ScoreBatch", want[1], got[1], f"16,384 rows {key}")
    oversize = b"\x0a" + b"\xff" * (4 * MiB + 16)
    single = risk_pb2.ScoreTransactionRequest(account_id="acct5", amount=100,
                                              transaction_type="deposit").SerializeToString()
    for key, channel in channels.items():
        code = _outcome(channel.unary_unary(RISK + "ScoreBatch"), oversize)[0]
        assert code == "RESOURCE_EXHAUSTED", key
        code = _outcome(channel.unary_unary(RISK + "ScoreTransaction"), single, timeout=1e-6)[0]
        assert code == "DEADLINE_EXCEEDED", key
        if key[0] == "wire":
            assert _expired_at_the_server(channel, single) == "DEADLINE_EXCEEDED", key
    # 32 callers at once on one channel, each answer as the service answers
    # the same request in-process (response_time_ms aside).
    singles = [risk_pb2.ScoreTransactionRequest(**t).SerializeToString()
               for t in requests(10, 64, N_ACCOUNTS)]
    in_process = [booted["service"].call("ScoreTransaction", p) for p in singles]
    for key in (("grpcio", "port"), ("wire", "port"), ("wire", "jax")):
        got = _burst(channels[key].unary_unary(RISK + "ScoreTransaction"), singles)
        for i, (w, g) in enumerate(zip(in_process, got)):
            _assert_same("ScoreTransaction", w, g, f"burst {key} #{i}")


def test_reflection_and_wallet_from_the_ports_client(tmp_path):
    """Reflection's every request kind, several on one stream, and the
    wallet.v1 script: the port's client gets from either server what
    grpcio's client gets from the JAX server."""
    jserver = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    jserver.add_generic_rpc_handlers((reflection_handler(NAMES),))
    jport = jserver.add_insecure_port("localhost:0")
    jserver.start()
    service = grpc_server.RiskGrpcService(engine=type("E", (), {"device": "cpu"})())
    pserver, _, pport = grpc_server.serve_risk(service, 0)
    channels = _clients((jport, pport))
    try:
        path = f"/{SERVICE_NAME}/ServerReflectionInfo"
        for kind, kws in sorted(KINDS.items()):
            reqs = [rp.ServerReflectionRequest(host="h", **kw).SerializeToString() for kw in kws]
            want = list(channels["grpcio", "jax"].stream_stream(path)(iter(reqs), timeout=30))
            assert len(want) == len(reqs), kind
            for key in (("wire", "jax"), ("wire", "port")):
                assert list(channels[key].stream_stream(path)(iter(reqs), timeout=30)) == want
    finally:
        for channel in channels.values():
            channel.close()
        jserver.stop(0).wait()
        pserver.stop(0).wait()
        service.close()
    runs = {}
    with pinned_wallet() as reset:
        for side, transport in (("jax", "grpcio"), ("jax", "wire"), ("port", "wire")):
            reset()
            (tmp_path / transport).mkdir(exist_ok=True)
            runs[side, transport] = _run(side, "sqlite", transport, tmp_path / transport)
    want = runs["jax", "grpcio"]
    assert {code for _, code, *_ in want} >= {"OK", "NOT_FOUND", "FAILED_PRECONDITION"}
    for key in (("jax", "wire"), ("port", "wire")):
        assert len(runs[key]) == len(want)
        for i, (g, w) in enumerate(zip(runs[key], want)):
            assert g == w, (key, i, g, w)


# ---------------------------------------------------------------------------
# Stopping, redialling


def _slow_server(port=0, delay_s=0.6, seen=None):
    health = grpc_server.HealthServicer()

    def slow(payload, context):
        if seen is not None:
            seen.append(payload)
        time.sleep(delay_s)
        return payload[::-1]

    server, bound = grpc_server.serve_methods(grpc_server.RISK_SERVICE, {"ScoreBatch": slow},
                                              health, port)
    return server, health, bound


def _until(condition, timeout_s: float = 30.0) -> None:
    end = time.monotonic() + timeout_s
    while not condition():
        assert time.monotonic() < end, "timed out"
        time.sleep(0.005)


@pytest.mark.parametrize("client", ["grpcio", "wire"])
def test_graceful_stop_finishes_in_flight_and_refuses_new(client):
    seen = []
    server, health, port = _slow_server(seen=seen)
    mod = grpc if client == "grpcio" else grpc_wire
    channel = mod.insecure_channel(f"localhost:{port}")
    try:
        fn = channel.unary_unary(RISK + "ScoreBatch")
        assert fn(b"warm", timeout=30) == b"mraw"
        in_flight = fn.future(b"abc", timeout=30)
        _until(lambda: b"abc" in seen)  # the call is in the handler's hands
        stopper = threading.Thread(target=grpc_server.graceful_stop, args=(server, health, 10.0))
        stopper.start()
        _until(lambda: server._stopped is not None
               and all(c.goaway_last is not None for c in list(server._conns)))
        assert _outcome(fn, b"late", timeout=5)[0] == "UNAVAILABLE"
        assert in_flight.result(timeout=30) == b"cba"
        stopper.join(30)
        assert not stopper.is_alive() and health.status("") == grpc_server.NOT_SERVING
    finally:
        channel.close()
        server.stop(0).wait()


def test_replica_redialled_within_backoff():
    """The router's endpoint (250 ms initial backoff, 1 s at most): its
    replica killed, its probes fail fast with UNAVAILABLE; restarted on the
    same port, it is dialled again within the longest backoff."""
    server, _, port = _slow_server(delay_s=0.0)
    endpoint = prouter.ReplicaEndpoint("r0", f"localhost:{port}")
    probe = codec.encode(codec.HEALTH_CHECK_REQUEST, {"service": ""})
    try:
        assert endpoint.health(probe, timeout=10)
        server.stop(0).wait()
        fails = []
        for _ in range(20):
            fails.append(_outcome(endpoint.health, probe, timeout=2)[0])
            time.sleep(0.05)
        assert set(fails) == {"UNAVAILABLE"}
        server, _, _ = _slow_server(port, delay_s=0.0)
        restarted = time.monotonic()
        while _outcome(endpoint.health, probe, timeout=2)[0] != "OK":
            assert time.monotonic() - restarted < 1.0 * 1.2 + 0.5, "not redialled in time"
            time.sleep(0.01)
    finally:
        endpoint.close()
        server.stop(0).wait()


# ---------------------------------------------------------------------------
# Without grpcio


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_HIDDEN = ("import runpy, sys; sys.path.insert(0, {repo!r}); sys.modules['grpc'] = None; "
           "runpy.run_module({module!r}, run_name='__main__')")


@pytest.mark.parametrize("module", ["igaming_platform_tpu_torch.serve.server",
                                    "igaming_platform_tpu_torch.platform.server"])
def test_boots_and_answers_without_grpcio(module, tmp_path):
    """``python -m`` of the risk (or wallet) server with ``grpc`` unimportable
    binds its default gRPC port (GRPC_PORT set to a free one) on the CPU,
    answers over the port's client, and drains on SIGTERM."""
    grpc_port = _free_port()
    env = dict(os.environ, GRPC_PORT=str(grpc_port), HTTP_PORT=str(_free_port()),
               SERVE_DEVICE_FALLBACK="cpu", FEATURE_STORE="python", DEVICE_PROBE_BUDGET_S="5",
               DATABASE_URL=f"sqlite://{tmp_path}/wallet.db", RISK_SERVICE_ADDR="",
               HOSTPROF="0")
    log = open(tmp_path / "server.log", "w+")
    proc = subprocess.Popen([sys.executable, "-c", _HIDDEN.format(repo=str(REPO), module=module)],
                            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=tmp_path)
    channel = grpc_wire.insecure_channel(f"localhost:{grpc_port}")
    try:
        end = time.monotonic() + 240
        while "server up" not in (tmp_path / "server.log").read_text():
            assert proc.poll() is None and time.monotonic() < end, (
                tmp_path / "server.log").read_text()[-3000:]
            time.sleep(0.2)
        if module.endswith("serve.server"):
            resp = grpc_server.make_risk_stub(channel).ScoreTransaction(codec.encode(
                codec.SCORE_TRANSACTION_REQUEST, {"account_id": "a1", "amount": 5000,
                                                  "transaction_type": "deposit"}), timeout=60)
            assert 0 <= codec.decode(codec.SCORE_TRANSACTION_RESPONSE, resp)["score"] <= 100
        else:
            from igaming_platform_tpu_torch.serve import wallet_codec as wc

            resp = grpc_server.make_wallet_stub(channel).CreateAccount(
                wc.encode(wc.CREATE_ACCOUNT_REQUEST, {"player_id": "p1"}), timeout=60)
            assert wc.decode(wc.CREATE_ACCOUNT_RESPONSE, resp)["account"]["player_id"] == "p1"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(120) == 0
        assert "shutting down" in (tmp_path / "server.log").read_text()
    finally:
        channel.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        log.close()


def test_router_serves_without_grpcio(monkeypatch):
    """``serve_router`` in front of a port replica, grpcio hidden: a
    ScoreTransaction through the router over the wire answers as the replica
    does."""
    from igaming_platform_tpu_torch.core.config import BatcherConfig
    from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine

    monkeypatch.setitem(sys.modules, "grpc", None)
    engine = TorchScoringEngine(device="cpu",
                                batcher_config=BatcherConfig(batch_size=32, max_wait_ms=1.0))
    service = grpc_server.RiskGrpcService(engine)
    replica, _, rport = grpc_server.serve_risk(service, 0)
    router = prouter.ScoringRouter({"r0": (f"localhost:{rport}", None)}, health_interval_s=0.1,
                                   hedge=False)
    server, _, port = prouter.serve_router(router, 0)
    channel = grpc_wire.insecure_channel(f"localhost:{port}")
    try:
        payload = codec.encode(codec.SCORE_TRANSACTION_REQUEST, {
            "account_id": "a7", "amount": 700, "transaction_type": "bet"})
        got = codec.decode(codec.SCORE_TRANSACTION_RESPONSE,
                           channel.unary_unary(RISK + "ScoreTransaction")(payload, timeout=60))
        want = codec.decode(codec.SCORE_TRANSACTION_RESPONSE,
                            service.call("ScoreTransaction", payload))
        got["response_time_ms"] = want["response_time_ms"] = 0
        assert got == want
    finally:
        channel.close()
        server.stop(0).wait()
        router.close()
        replica.stop(0).wait()
        service.close()
        engine.close()

