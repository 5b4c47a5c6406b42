"""Port parity: serve/native_store.py and its build (serve/_native_build.py).

The port's NativeFeatureStore and the JAX package's, fed the same seeded
events with fixed timestamps and one pinned clock, give bit-equal outputs
from decode_gather, gather_columns, gather_batch and fill_row. The port's
native store agrees with the port's InMemoryFeatureStore where the JAX
tests say the two agree (tests/test_native_store.py). The port builds its
own library under build/native/, never into native/lib/, and a build that
fails raises.
"""

import numpy as np
import pytest
from torch_front_common import T0, event_columns, fill, pin_jax_clock, requests

from igaming_platform_tpu.proto_gen.risk.v1 import risk_pb2
from igaming_platform_tpu.serve.native_store import NativeFeatureStore as JaxNativeStore
from igaming_platform_tpu.serve.scorer import ScoreRequest as JaxRequest
from igaming_platform_tpu_torch.core.features import NUM_FEATURES, F
from igaming_platform_tpu_torch.serve import _native_build
from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore, TransactionEvent
from igaming_platform_tpu_torch.serve.native_store import NativeFeatureStore, best_feature_store
from igaming_platform_tpu_torch.serve.scorer import ScoreRequest

N_ACCOUNTS = 60


@pytest.fixture(scope="module")
def stores():
    cols = event_columns(1, N_ACCOUNTS, 1500)
    jax_store = JaxNativeStore(max_accounts=500)
    port = NativeFeatureStore(max_accounts=500, clock=lambda: T0)
    fill([jax_store, port], cols, bonus_accounts=[f"acct{a}" for a in range(0, N_ACCOUNTS, 4)],
         blacklist=[("device", "dev3"), ("ip", "ip7"), ("fingerprint", "fp1")])
    return jax_store, port


@pytest.mark.parametrize("now", [T0, T0 + 4000.0, T0 + 100_000.0])
@pytest.mark.parametrize("method", ["decode_gather", "gather_columns", "gather_batch",
                                    "fill_row"])
def test_native_store_matches_jax(stores, monkeypatch, method, now):
    """Bit-equal rows and flags; ``now`` given to the port, the JAX module's
    clock pinned, at the fill's own time and past the 1 h and 24 h windows."""
    jax_store, port = stores
    pin_jax_clock(monkeypatch, now)
    reqs = requests(2, 300, N_ACCOUNTS)
    if method == "decode_gather":
        payload = risk_pb2.ScoreBatchRequest(
            transactions=[risk_pb2.ScoreTransactionRequest(**r) for r in reqs]).SerializeToString()
        got, want = port.decode_gather(payload, now=now), jax_store.decode_gather(payload)
    elif method == "gather_columns":
        cols = ([r["account_id"] for r in reqs], [r["amount"] for r in reqs],
                [r["transaction_type"] for r in reqs])
        kw = dict(ips=[r["ip_address"] for r in reqs], devices=[r["device_id"] for r in reqs],
                  fingerprints=[r["fingerprint"] for r in reqs])
        got, want = port.gather_columns(*cols, now=now, **kw), jax_store.gather_columns(*cols, **kw)
    elif method == "gather_batch":
        rows = [dict(account_id=r["account_id"], amount=r["amount"], tx_type=r["transaction_type"],
                     ip=r["ip_address"], device_id=r["device_id"], fingerprint=r["fingerprint"],
                     ip_flags=(i % 2, i % 3 == 0, 0) if i % 5 else None)
                for i, r in enumerate(reqs)]
        got = port.gather_batch([ScoreRequest(**r) for r in rows], now=now)
        want = jax_store.gather_batch([JaxRequest(**r) for r in rows])
    else:
        got, want = np.zeros((2, NUM_FEATURES), np.float32), np.zeros((2, NUM_FEATURES), np.float32)
        port.fill_row(got[0], "acct5", 900, "withdraw", now=now)
        jax_store.fill_row(want[0], "acct5", 900, "withdraw")
        port.fill_row(got[1], "nobody", 10, "bet", now=now)
        jax_store.fill_row(want[1], "nobody", 10, "bet")
        got, want = (got, np.zeros(0)), (want, np.zeros(0))
    np.testing.assert_array_equal(got[0].view(np.uint32), want[0].view(np.uint32))
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape[0] in (2, len(reqs)) and got[0].any()
    assert port.velocity("acct5", now=now) == jax_store.velocity("acct5", now=now)


def _seed(store):
    for amount, kind, ip, dev, dt in ((5000, "deposit", "1.1.1.1", "d1", 100),
                                      (2000, "bet", "1.1.1.1", "d2", 50),
                                      (1000, "win", "2.2.2.2", "d2", 40)):
        store.update(TransactionEvent("acct", amount, kind, ip=ip, device_id=dev,
                                      timestamp=T0 - dt))


def test_native_matches_python_store():
    """As the JAX tests hold their two stores: HLL estimates within 1 at tiny
    cardinality, every other feature within rel 1e-6; the same windows, bonus
    flag and blacklist answers."""
    py, nat = InMemoryFeatureStore(clock=lambda: T0), NativeFeatureStore(max_accounts=100,
                                                                         clock=lambda: T0)
    for store in (py, nat):
        _seed(store)
        store.update(TransactionEvent("bonus", 100, "deposit", timestamp=T0 - 10))
        for _ in range(5):  # claims after the first event, as the JAX test orders them
            store.record_bonus_claim("bonus", wager_complete_rate=0.25)
        store.add_to_blacklist("device", "bad")
    rows = np.zeros((2, 3, NUM_FEATURES), np.float32)
    for out, store in zip(rows, (py, nat)):
        store.fill_row(out[0], "acct", 700, "withdraw", now=T0)
        store.fill_row(out[1], "bonus", 0, "bet", now=T0)
        store.fill_row(out[2], "acct", 0, "bet", now=T0 + 7200)
    hll = [int(F.UNIQUE_DEVICES_24H), int(F.UNIQUE_IPS_24H)]
    other = [i for i in range(NUM_FEATURES) if i not in hll]
    assert np.abs(rows[0][:, hll] - rows[1][:, hll]).max() <= 1
    np.testing.assert_allclose(rows[1][:, other], rows[0][:, other], rtol=1e-6)
    assert rows[1][1, F.BONUS_ONLY_PLAYER] == 1.0 and rows[1][2, F.TX_COUNT_1H] == 0
    assert nat.velocity("acct", now=T0) == py.velocity("acct", now=T0) == (2, 3, 3)
    assert nat.check_blacklist(device_id="bad") and not nat.check_blacklist(ip="bad")
    with pytest.raises(ValueError):
        nat.add_to_blacklist("email", "x")
    assert isinstance(best_feature_store(max_accounts=10), NativeFeatureStore)


def test_builds_under_build_and_a_failed_build_raises(tmp_path, monkeypatch):
    """The library lives in build/native/, keyed by source and flags; a
    source that does not compile raises with the compiler's message."""
    path = _native_build.library_path("feature_store")
    assert path.parent == _native_build.ROOT / "build" / "native" and path.exists()
    (tmp_path / "broken.cpp").write_text("int main( {\n")
    monkeypatch.setattr(_native_build, "NATIVE_SRC", tmp_path)
    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="native build of broken failed"):
        _native_build.load("broken")
    assert not (tmp_path / "out" / "libbroken.so").exists()
