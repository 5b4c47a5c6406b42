"""Port parity: wallet.v1 on bytes (``serve/wallet_codec.py``,
``WalletGrpcService``), ``serve_wallet`` and ``platform/server.py``.

The JAX ``WalletGrpcService`` (through its own RPC wrapper, with
tests/torch_front_common.py's ``JaxContext``) and the port's
(``call(method, bytes)``), each over its own store (SQLite, or the
Postgres store on its own package's rig), get the same script of all ten
wallet.v1 RPCs, built with ``wallet_pb2``: accounts by id and by player,
the four money movements and a refund, history with type, time and
negative paging filters, negative amounts, and every refusal the wallet
has. Identifiers and clocks are pinned in both packages
(``torch_front_common.pinned_wallet``), so every response must be
byte-equal to protobuf's ``SerializeToString`` of the JAX answer and every
refusal must carry the same status and details. The same script runs over
grpcio, each package behind its own ``serve_wallet``. Every domain error
class maps to the JAX status and details. ``WalletServer`` of both
packages, over SQLite and over the rigs, serves the same ``/metrics``
families (requests, transactions, volume, reconciliation) after the same
RPCs, and the same ``/health``, ``/ready`` and ``/debug/reconciliation``.
"""

import json
import urllib.request

import grpc
import pytest
from torch_front_common import (  # noqa: F401 - time_limit is a fixture
    FixedGate,
    JaxAborted,
    JaxContext,
    pinned_wallet,
    time_limit,
)

from igaming_platform_tpu.core.config import WalletServiceConfig as JWalletConfig
from igaming_platform_tpu.obs.metrics import ServiceMetrics as JMetrics
from igaming_platform_tpu.platform import domain as jdomain
from igaming_platform_tpu.platform import pg_testing as jrig
from igaming_platform_tpu.platform import repository as jrepo
from igaming_platform_tpu.platform import wallet as jwallet
from igaming_platform_tpu.proto_gen.wallet.v1 import wallet_pb2 as pb
from igaming_platform_tpu.serve import grpc_server as jgrpc
from igaming_platform_tpu_torch.core.config import WalletServiceConfig
from igaming_platform_tpu_torch.platform import domain as tdomain
from igaming_platform_tpu_torch.platform import pg_testing as trig
from igaming_platform_tpu_torch.platform import repository as trepo
from igaming_platform_tpu_torch.platform import server as tserver
from igaming_platform_tpu_torch.platform import wallet as twallet
from igaming_platform_tpu_torch.serve import grpc_server as tgrpc
from igaming_platform_tpu_torch.serve import wallet_codec

pytestmark = pytest.mark.usefixtures("time_limit")

SIDES = {"jax": (jrig, jrepo, jwallet), "port": (trig, trepo, twallet)}


def _script() -> list:
    """(method, request bytes or a callable of the ids so far) for every RPC
    of the script; ids are read from the CreateAccount answers."""
    def ts(seconds, nanos=0):
        return {"seconds": seconds, "nanos": nanos}

    steps = [("CreateAccount", pb.CreateAccountRequest(player_id="007")),
             ("CreateAccount", pb.CreateAccountRequest(player_id="p-eur", currency="EUR")),
             ("CreateAccount", pb.CreateAccountRequest(player_id="p-sus"))]
    money = [("Deposit", lambda ids: pb.DepositRequest(
                 account_id=ids[0], amount=50_000, idempotency_key="d1", payment_method="card",
                 reference="ref-1", ip_address="1.2.3.4", device_id="dev", fingerprint="fp")),
             ("Deposit", lambda ids: pb.DepositRequest(account_id=ids[0], amount=50_000,
                                                       idempotency_key="d1")),
             ("Deposit", lambda ids: pb.DepositRequest(account_id=ids[1], amount=-500,
                                                       idempotency_key="neg")),
             ("Deposit", lambda ids: pb.DepositRequest(account_id=ids[1], amount=12_022,
                                                       idempotency_key="blocked")),
             ("Deposit", lambda ids: pb.DepositRequest(account_id=ids[1], amount=12_093,
                                                       idempotency_key="review")),
             ("Bet", lambda ids: pb.BetRequest(account_id=ids[0], amount=7_000,
                                               idempotency_key="b1", game_id="g", round_id="r1",
                                               game_category="slots", session_id="s")),
             ("Win", lambda ids: pb.WinRequest(account_id=ids[0], amount=9_000,
                                               idempotency_key="w1", game_id="g", round_id="r1",
                                               win_type="jackpot", metadata={"k": "v"})),
             ("Withdraw", lambda ids: pb.WithdrawRequest(account_id=ids[0], amount=10**12,
                                                         idempotency_key="x1")),
             ("Withdraw", lambda ids: pb.WithdrawRequest(account_id=ids[0], amount=4_000,
                                                         idempotency_key="x2",
                                                         payout_method="bank")),
             ("Bet", lambda ids: pb.BetRequest(account_id="nobody", amount=5,
                                               idempotency_key="b9")),
             ("Deposit", lambda ids: pb.DepositRequest(account_id=ids[2], amount=100,
                                                       idempotency_key="sus"))]
    reads = [("GetAccount", lambda ids: pb.GetAccountRequest(account_id=ids[1])),
             ("GetAccount", lambda ids: pb.GetAccountRequest(player_id="007")),
             ("GetAccount", lambda ids: pb.GetAccountRequest(player_id="")),
             ("GetAccount", lambda ids: pb.GetAccountRequest()),
             ("GetAccount", lambda ids: pb.GetAccountRequest(account_id="missing")),
             ("GetBalance", lambda ids: pb.GetBalanceRequest(account_id=ids[0])),
             ("GetBalance", lambda ids: pb.GetBalanceRequest(account_id="missing")),
             ("GetTransaction", lambda ids: pb.GetTransactionRequest(transaction_id="missing")),
             ("GetTransactionHistory", lambda ids: pb.GetTransactionHistoryRequest(
                 account_id=ids[0])),
             ("GetTransactionHistory", lambda ids: pb.GetTransactionHistoryRequest(
                 account_id=ids[0], limit=-3, offset=-1, types=["bet", "deposit"])),
             ("GetTransactionHistory", lambda ids: pb.GetTransactionHistoryRequest(
                 account_id=ids[0], limit=2, offset=1, game_id="g", to=ts(1_700_000_001),
                 **{"from": ts(1_699_999_999, 999_999_999)})),
             ("GetTransactionHistory", lambda ids: pb.GetTransactionHistoryRequest(
                 account_id=ids[0], **{"from": ts(1_800_000_000)}))]
    return steps + money + reads


def _refund_and_lookup(ids, first_tx):
    return [("Refund", pb.RefundRequest(account_id=ids[0], original_transaction_id=first_tx,
                                        idempotency_key="rf1", reason="test")),
            ("Refund", pb.RefundRequest(account_id=ids[0], original_transaction_id="missing",
                                        idempotency_key="rf2")),
            ("GetTransaction", pb.GetTransactionRequest(transaction_id=first_tx))]


def _make_service(side: str, store, metrics=None):
    _, _, wallet_mod = SIDES[side]
    svc = wallet_mod.WalletService(store.accounts, store.transactions, store.ledger,
                                   events=wallet_mod.OutboxPublisher(store), risk=FixedGate(),
                                   audit=store.audit)
    if side == "jax":
        return jgrpc.WalletGrpcService(svc, metrics=metrics or JMetrics("wallet"))
    return tgrpc.WalletGrpcService(svc, metrics=metrics)


def _caller(side: str, transport: str, svc):
    """(method, request message) -> (status name, response bytes, details).
    ``transport`` "grpcio" calls the side's server through grpcio's client,
    "wire" through the port's own (``serve/grpc_wire.py``)."""
    if transport in ("grpcio", "wire"):
        from igaming_platform_tpu_torch.serve import grpc_wire

        serve = jgrpc.serve_wallet if side == "jax" else tgrpc.serve_wallet
        server, health, port = serve(svc, 0)
        client = grpc if transport == "grpcio" else grpc_wire
        channel = client.insecure_channel(f"localhost:{port}")

        def call(method, msg):
            fn = channel.unary_unary(f"/wallet.v1.WalletService/{method}")
            try:
                return "OK", fn(msg.SerializeToString(), timeout=30), ""
            except client.RpcError as exc:
                return exc.code().name, b"", exc.details()

        def close():
            channel.close()
            server.stop(0).wait()

        return call, close
    if side == "jax":
        def call(method, msg):
            handler = jgrpc._rpc(svc.metrics, method, getattr(svc, method))
            try:
                return "OK", handler(msg, JaxContext()).SerializeToString(), ""
            except JaxAborted as exc:
                return exc.args[0], b"", exc.args[1]
    else:
        def call(method, msg):
            try:
                return "OK", svc.call(method, msg.SerializeToString()), ""
            except tgrpc.RpcAbort as exc:
                return exc.code.name, b"", exc.details

    return call, lambda: None


def _run(side: str, store_kind: str, transport: str, tmp_path) -> list:
    rig_mod, repo_mod, _ = SIDES[side]
    rig = None
    if store_kind == "postgres":
        rig = rig_mod.PgSqliteServer(str(tmp_path / f"{side}.db"))
        store = repo_mod.store_from_url(rig.url)
    else:
        store = repo_mod.SQLiteStore(str(tmp_path / f"{side}.db"))
    svc = _make_service(side, store)
    call, close = _caller(side, transport, svc)
    out, ids = [], []
    try:
        for method, req in _script():
            msg = req(ids) if callable(req) else req
            res = call(method, msg)
            out.append((method, *res))
            if method == "CreateAccount":
                ids.append(pb.CreateAccountResponse.FromString(res[1]).account.id)
                if len(ids) == 3:
                    status = type(store.accounts.get_by_id(ids[2]).status)
                    store.accounts.update_status(ids[2], status("suspended"))
        first_tx = pb.DepositResponse.FromString(out[3][2]).transaction.id
        for method, msg in _refund_and_lookup(ids, first_tx):
            out.append((method, *call(method, msg)))
    finally:
        close()
        store.close()
        if rig is not None:
            rig.close()
    return out


@pytest.mark.parametrize("store_kind,transport", [("sqlite", "bytes"), ("postgres", "bytes"),
                                                  ("sqlite", "grpcio")])
def test_wallet_rpcs_byte_equal(store_kind, transport, tmp_path):
    """All ten RPCs: each answer byte-equal to the JAX service's protobuf
    bytes, each refusal the same status and details."""
    got = {}
    with pinned_wallet() as reset:
        for side in ("jax", "port"):
            reset()
            got[side] = _run(side, store_kind, transport, tmp_path)
    for i, (g, w) in enumerate(zip(got["port"], got["jax"])):
        assert g == w, (i, g, w)
    assert len(got["port"]) == len(got["jax"])
    methods = {m for m, code, *_ in got["port"] if code == "OK"}
    assert methods == set(wallet_codec.METHOD_NAMES)
    codes = {code for _, code, *_ in got["port"]}
    assert {"OK", "NOT_FOUND", "FAILED_PRECONDITION", "INVALID_ARGUMENT",
            "PERMISSION_DENIED"} <= codes


ERRORS = [("AccountNotFoundError", ("acct",)), ("AccountSuspendedError", ("acct",)),
          ("InsufficientBalanceError", ("short",)), ("DuplicateTransactionError", ("k",)),
          ("InvalidAmountError", ("-1",)), ("ConcurrentUpdateError", ("acct",)),
          ("RiskBlockedError", (97, ["VELOCITY_1M"])), ("RiskReviewError", (95, [])),
          ("RiskUnavailableError", ("down",)), ("BonusRestrictionError", ("wager",)),
          ("WalletError", ("other",))]


@pytest.mark.parametrize("name,args", ERRORS)
def test_domain_error_map(name, args):
    """Every domain error class: the JAX status and details."""
    with pytest.raises(jgrpc.RpcAbort) as want:
        jgrpc.WalletGrpcService(None)._domain_error(None, getattr(jdomain, name)(*args))
    got = tgrpc.WalletGrpcService(None)._domain_error(getattr(tdomain, name)(*args))
    assert (got.code.name, got.details) == (want.value.code.name, want.value.details)


def _exposition(port: int) -> dict:
    text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30).read().decode()
    keep = ("wallet_transactions_total", "wallet_transaction_amount_cents_total",
            "wallet_reconciliation_", "wallet_grpc_requests_total", "wallet_grpc_errors_total")
    return {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith(keep)}


@pytest.mark.parametrize("store_kind", ["sqlite", "postgres"])
def test_wallet_server_metrics_match_jax(store_kind, tmp_path, monkeypatch):
    """Both packages' WalletServer (the port's without gRPC, driven through
    its service; the JAX one over grpcio): the same RPCs give the same
    /metrics families, /health, /ready and /debug/reconciliation."""
    from igaming_platform_tpu.platform.server import WalletServer as JWalletServer

    monkeypatch.delenv("OTEL_EXPORTER_OTLP_ENDPOINT", raising=False)
    out = {}
    with pinned_wallet() as reset:
        for side in ("jax", "port"):
            reset()
            rig_mod = SIDES[side][0]
            rig = (rig_mod.PgSqliteServer(str(tmp_path / f"{side}.db"))
                   if store_kind == "postgres" else None)
            url = rig.url if rig is not None else f"sqlite://{tmp_path / side}.db"
            cfg_cls = JWalletConfig if side == "jax" else WalletServiceConfig
            cfg = cfg_cls(database_url=url, risk_service_addr="")
            if side == "jax":
                srv = JWalletServer(cfg, risk_gate=FixedGate(), grpc_port=0, http_port=0)
                channel = grpc.insecure_channel(f"localhost:{srv.grpc_port}")
                call = _grpc_call(channel)
            else:
                srv = tserver.WalletServer(cfg, risk_gate=FixedGate(), grpc_port=None,
                                           http_port=0)
                channel = None
                call = _bytes_call(srv.grpc_service)
            try:
                ids = [pb.CreateAccountResponse.FromString(call("CreateAccount", pb.CreateAccountRequest(
                    player_id=f"p{i}"))).account.id for i in range(4)]
                for i in range(24):
                    acct, kind = ids[i % 4], ("Deposit", "Bet", "Win", "Withdraw")[i % 4]
                    req = getattr(pb, f"{kind}Request")(account_id=acct, amount=1_000 + 997 * i,
                                                        idempotency_key=f"m{i}")
                    call(kind, req)
                call("GetBalance", pb.GetBalanceRequest(account_id="missing"))
                base = f"http://127.0.0.1:{srv.http_port}"
                recon = json.loads(urllib.request.urlopen(f"{base}/debug/reconciliation",
                                                          timeout=30).read())
                health = urllib.request.urlopen(f"{base}/health", timeout=30).read()
                ready = urllib.request.urlopen(f"{base}/ready", timeout=30).read()
                out[side] = (_exposition(srv.http_port), recon["checked"], recon["mismatched"],
                             health, ready)
            finally:
                if channel is not None:
                    channel.close()
                srv.shutdown(grace=1)
                if rig is not None:
                    rig.close()
    assert out["port"] == out["jax"]
    assert out["port"][1] == 4 and out["port"][2] == 0
    assert out["port"][0]['wallet_transactions_total{type="deposit"}'] > 0


def _grpc_call(channel):
    def call(method, msg):
        try:
            return channel.unary_unary(f"/wallet.v1.WalletService/{method}")(
                msg.SerializeToString(), timeout=30)
        except grpc.RpcError:
            return b""
    return call


def _bytes_call(service):
    def call(method, msg):
        try:
            return service.call(method, msg.SerializeToString())
        except tgrpc.RpcAbort:
            return b""
    return call
