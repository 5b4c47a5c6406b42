"""Port parity: serve/reflection.py, gRPC server reflection without protobuf.

Over grpcio on the CPU, the JAX package's reflection handler and the one the
port's ``serve_risk`` registers answer tests/test_reflection.py's seven
request kinds (risk.v1 symbols: the JAX process's descriptor pool may also
hold wallet.v1, which the risk server does not serve) with the same bytes,
read raw off both sockets. The port's byte handler (which the port's own
transport serves, here and on the card) gives those bytes too, and its
descriptor file is what tools/export_reflection_descriptors.py writes. The
wallet server's reflection (``serve_wallet``, wallet.v1 and health) answers
as the JAX wallet server's registration does, byte for byte.
"""

import types
from concurrent import futures

import grpc
import pytest

from igaming_platform_tpu.proto_gen.grpc.reflection.v1alpha import reflection_pb2 as rp
from igaming_platform_tpu.proto_gen.risk.v1 import risk_pb2 as _risk_pb2  # noqa: F401
from igaming_platform_tpu.proto_gen.wallet.v1 import wallet_pb2 as _wallet_pb2  # noqa: F401
from igaming_platform_tpu.serve import grpc_server as _jgrpc  # noqa: F401 — health.proto
from igaming_platform_tpu.serve.reflection import SERVICE_NAME, reflection_handler
from igaming_platform_tpu_torch.serve import grpc_server, reflection
from tools import export_reflection_descriptors

NAMES = ("risk.v1.RiskService", "grpc.health.v1.Health")


def _symbols(*symbols):
    return [dict(file_containing_symbol=s) for s in symbols]


KINDS = {
    "list_services": [dict(list_services=""), dict(list_services="*")],
    "file_containing_symbol": _symbols("risk.v1.RiskService", "grpc.health.v1.Health",
                                       "grpc.reflection.v1alpha.ServerReflection"),
    "method_and_message_symbols": _symbols(
        "risk.v1.RiskService.ScoreTransaction", "risk.v1.ScoreTransactionRequest",
        "risk.v1.ScoreTransactionRequest.amount", "google.protobuf.Timestamp",
        "risk.v1.ScoreTransactionRequest.MetadataEntry", "grpc.health.v1.Health.Check"),
    "file_by_filename": [dict(file_by_filename=f) for f in (
        "risk/v1/risk.proto", "google/protobuf/timestamp.proto", "grpc/health/v1/health.proto",
        "grpc/reflection/v1alpha/reflection.proto", "no/such.proto")],
    "unknown_symbol": _symbols("no.such.Service", "risk.v1", "") + [
        dict(file_containing_extension=rp.ExtensionRequest(
            containing_type="risk.v1.ScoreTransactionRequest", extension_number=100)),
        dict(all_extension_numbers_of_type="risk.v1.ScoreTransactionRequest"),
        dict(all_extension_numbers_of_type="no.such.Message")],
    "empty_request": [{}],
    "bogus_leaf": _symbols("risk.v1.RiskService.NoSuchMethod",
                           "risk.v1.ScoreTransactionRequest.no_such_field",
                           "risk.v1.NoSuchMessage.whatever", "risk.v1.Action.NO_SUCH_VALUE"),
    "enum_value": _symbols("risk.v1.Action.ACTION_APPROVE", "risk.v1.ACTION_APPROVE",
                           "grpc.health.v1.HealthCheckResponse.SERVING"),
}


def _raw_call(channel):
    """ServerReflectionInfo with no (de)serializers: bytes in, bytes out."""
    return channel.stream_stream(f"/{SERVICE_NAME}/ServerReflectionInfo")


@pytest.fixture(scope="module")
def servers():
    jserver = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    jserver.add_generic_rpc_handlers((reflection_handler(NAMES),))
    jport = jserver.add_insecure_port("localhost:0")
    jserver.start()
    service = grpc_server.RiskGrpcService(engine=types.SimpleNamespace(device="cpu"))
    pserver, _, pport = grpc_server.serve_risk(service, 0)
    channels = [grpc.insecure_channel(f"localhost:{p}") for p in (jport, pport)]
    yield [_raw_call(c) for c in channels]
    for c in channels:
        c.close()
    jserver.stop(0).wait()
    pserver.stop(0).wait()
    service.close()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_reflection_bytes_equal_jax(servers, kind):
    requests = [rp.ServerReflectionRequest(host=h, **kw).SerializeToString()
                for kw in KINDS[kind] for h in ("h", "")]
    want, got = (list(call(iter(requests), timeout=30)) for call in servers)
    assert len(got) == len(want) == len(requests)
    assert got == want, kind
    handler = reflection.ReflectionService(NAMES)
    assert [handler.respond(r) for r in requests] == want
    parsed = [rp.ServerReflectionResponse.FromString(b) for b in got]
    codes = [p.error_response.error_code for p in parsed]
    if kind == "bogus_leaf":
        assert set(codes) == {5}  # NOT_FOUND, never the parent's file
    elif kind == "unknown_symbol":
        assert codes == [5] * 8 + [0, 0, 5, 5]
    elif kind == "empty_request":
        assert codes == [12, 12]
    else:
        assert set(codes) == {0} if kind != "file_by_filename" else codes[-2:] == [5, 5]


def test_descriptor_file_is_the_tools_output():
    blobs = reflection.load_descriptors()
    assert blobs == export_reflection_descriptors.descriptor_blobs()
    assert reflection.DESCRIPTORS.read_bytes() == export_reflection_descriptors.encode(blobs)


WALLET_NAMES = ("wallet.v1.WalletService", "grpc.health.v1.Health")
WALLET_KINDS = {
    "list_services": [dict(list_services=""), dict(list_services="*")],
    "symbols": _symbols("wallet.v1.WalletService", "wallet.v1.WalletService.Deposit",
                        "wallet.v1.DepositRequest", "google.protobuf.Timestamp",
                        "grpc.health.v1.Health", "risk.v1.RiskService"),
    "files": [dict(file_by_filename=f) for f in (
        "wallet/v1/wallet.proto", "google/protobuf/timestamp.proto", "grpc/health/v1/health.proto",
        "no/such.proto")],
    "bogus": _symbols("wallet.v1.WalletService.NoSuchMethod", "wallet.v1.NoSuchMessage",
                      "wallet.v1"),
}


@pytest.fixture(scope="module")
def wallet_servers():
    jserver = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    jserver.add_generic_rpc_handlers((reflection_handler(WALLET_NAMES),))
    jport = jserver.add_insecure_port("localhost:0")
    jserver.start()
    service = grpc_server.WalletGrpcService(wallet=types.SimpleNamespace())
    pserver, _, pport = grpc_server.serve_wallet(service, 0)
    channels = [grpc.insecure_channel(f"localhost:{p}") for p in (jport, pport)]
    yield [_raw_call(c) for c in channels]
    for c in channels:
        c.close()
    jserver.stop(0).wait()
    pserver.stop(0).wait()


@pytest.mark.parametrize("kind", sorted(WALLET_KINDS))
def test_wallet_reflection_bytes_equal_jax(wallet_servers, kind):
    """``grpcurl list`` and describe against the port's wallet server."""
    requests = [rp.ServerReflectionRequest(host="h", **kw).SerializeToString()
                for kw in WALLET_KINDS[kind]]
    want, got = (list(call(iter(requests), timeout=30)) for call in wallet_servers)
    assert got == want and len(got) == len(requests), kind
    assert [reflection.ReflectionService(WALLET_NAMES).respond(r) for r in requests] == want
    parsed = [rp.ServerReflectionResponse.FromString(b) for b in got]
    if kind == "list_services":
        assert [s.name for s in parsed[0].list_services_response.service] == [
            *WALLET_NAMES, SERVICE_NAME]
    elif kind == "bogus":
        assert {p.error_response.error_code for p in parsed} == {5}
