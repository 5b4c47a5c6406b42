"""Port parity: the Redis feature store, the ClickHouse source, the
batch-feature refresh and a risk server booted with ``BATCH_FEATURE_DB``.

``serve/redis_store.py``, ``serve/clickhouse.py`` and
``serve/batch_refresh.py`` of the port against the JAX package's:
``RedisFeatureStore`` over tests/test_redis_store.py's ``FakeRedis`` (one
each, fed the same events, batch loads and blacklist), every row, velocity
and blacklist answer and the fakes' whole state equal; ``clickhouse_source``
and ``ClickHouseClient`` against tests/test_clickhouse.py's fake server (the
requests and the loaded features equal, the errors of both kinds);
``wallet_store_source`` over ``sqlite://`` and ``postgres://`` equal to the
JAX source; the refresh job of both packages into their native stores with
equal rows, and into the port's native store behind a warm device feature
cache, every refreshed resident row marked dirty and copied in by the next
lookup; the risk servers of both packages booted on the CPU with
``BATCH_FEATURE_DB`` answering GetFeatures and ScoreBatch alike.
``FEATURE_STORE=redis`` raises without the redis library, as in JAX.
"""

import dataclasses
import time
import types

import grpc
import numpy as np
import pytest
from test_clickhouse import _FakeClickHouse
from test_redis_store import FakeRedis
from torch_front_common import (  # noqa: F401 - time_limit is a fixture
    T0,
    checked_rows,
    event_columns,
    jax_hostprof_off,
    jax_native_libs,
    seeded_wallet_db,
    time_limit,
)

from igaming_platform_tpu.core.config import BatcherConfig as JBatcherConfig
from igaming_platform_tpu.core.config import RiskServiceConfig as JConfig
from igaming_platform_tpu.platform import pg_testing as jrig
from igaming_platform_tpu.proto_gen.risk.v1 import risk_pb2
from igaming_platform_tpu.serve import batch_refresh as jrefresh
from igaming_platform_tpu.serve import clickhouse as jch
from igaming_platform_tpu.serve import feature_store as jfs
from igaming_platform_tpu.serve import native_store as jnative
from igaming_platform_tpu.serve import redis_store as jredis
from igaming_platform_tpu.serve import scorer as jscorer
from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
from igaming_platform_tpu_torch.platform import pg_testing
from igaming_platform_tpu_torch.serve import batch_refresh as trefresh
from igaming_platform_tpu_torch.serve import clickhouse as tch
from igaming_platform_tpu_torch.serve import feature_store as tfs
from igaming_platform_tpu_torch.serve import grpc_server, server
from igaming_platform_tpu_torch.serve import native_store as tnative
from igaming_platform_tpu_torch.serve import redis_store as tredis
from igaming_platform_tpu_torch.serve import scorer as tscorer
from igaming_platform_tpu_torch.serve.device_cache import DeviceFeatureCache

pytestmark = pytest.mark.usefixtures("time_limit")

SIDES = {"jax": (jredis, jfs, jscorer, jch, jrefresh, jnative),
         "port": (tredis, tfs, tscorer, tch, trefresh, tnative)}


def _features(batch: dict) -> dict:
    return {a: dataclasses.asdict(bf) for a, bf in batch.items()}


# -- Redis ------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2])
def test_redis_store_matches_jax(seed):
    """The same events, batch loads and blacklist into each package's Redis
    store over its own fake: rows, velocities, blacklist answers, a gathered
    batch and the fakes' keys and values equal."""
    accts, amounts, kinds, ips, devices, ts = event_columns(seed, 20, 300)
    stores, fakes, out = {}, {}, {}
    for side, (redis_mod, fs_mod, scorer_mod, *_) in SIDES.items():
        fakes[side] = FakeRedis()
        store = stores[side] = redis_mod.RedisFeatureStore(client=fakes[side])
        for ev in zip(accts, amounts, kinds, ips, devices, ts):
            store.update(fs_mod.TransactionEvent(*ev[:3], ip=ev[3], device_id=ev[4],
                                                 timestamp=ev[5]))
        for i in range(0, 20, 3):
            store.load_batch_features(f"acct{i}", total_deposits=1000 * i, total_withdrawals=7 * i,
                                      deposit_count=i, withdraw_count=i // 2, total_bets=300 * i,
                                      total_wins=100 * i, bet_count=3 * i, win_count=i,
                                      bonus_claim_count=i % 2 or None,
                                      created_at=T0 - 86400.0 * i if i else None)
        store.add_to_blacklist("device", "dev4")
        store.add_to_blacklist("ip", "ip9")
        rows = np.zeros((22, 30), np.float32)
        for i in range(22):
            store.fill_row(rows[i], f"acct{i}", 500 * i, ("bet", "deposit", "withdraw")[i % 3],
                           now=T0)
        reqs = [scorer_mod.ScoreRequest(f"acct{i}", amount=100 + i, tx_type="bet",
                                        device_id=f"dev{i}", ip=f"ip{i}") for i in range(12)]
        x, bl = store.gather_batch(reqs, now=T0 + 30)
        out[side] = (rows, x, bl, [store.velocity(f"acct{i}", now=T0) for i in range(22)],
                     [store.check_blacklist(device_id=f"dev{i}", ip=f"ip{i}") for i in range(12)])
        with pytest.raises(ValueError):
            store.add_to_blacklist("email", "x")
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert vars(fakes["port"]) == vars(fakes["jax"])
    assert out["port"][2].any() and out["port"][0][:, 10].any()


def test_feature_store_redis_needs_the_library(monkeypatch):
    """FEATURE_STORE=redis: RuntimeError without the redis library in both
    packages (no fallback); the config reads the JAX package's env names."""
    assert not tredis.redis_available() and not jredis.redis_available()
    with pytest.raises(RuntimeError, match="redis client library"):
        server.make_feature_store("redis", "redis://127.0.0.1:1")
    with pytest.raises(RuntimeError, match="redis client library"):
        jredis.RedisFeatureStore("redis://127.0.0.1:1")
    with pytest.raises(ValueError):
        server.make_feature_store("memcached")
    env = {"REDIS_URL": "redis://cache:6380", "CLICKHOUSE_URL": "http://ch:8123",
           "BATCH_FEATURE_DB": "postgres://u@db/wallet", "BATCH_FEATURE_INTERVAL_S": "12.5",
           "FEATURE_STORE": "redis"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = RiskServiceConfig.from_env(), JConfig.from_env()
    for name in ("redis_url", "clickhouse_url", "batch_feature_db", "batch_feature_interval_s",
                 "feature_store"):
        assert getattr(got, name) == getattr(want, name), name
    monkeypatch.setenv("FEATURE_STORE", "redis")
    with pytest.raises(RuntimeError, match="redis client library"):
        server.assemble_risk_service(device="cpu", warmup=False)


# -- ClickHouse -------------------------------------------------------------------


@pytest.mark.parametrize("case", ["rows", "http_error", "unreachable"])
def test_clickhouse_matches_jax(case):
    """Both packages' client and source against one fake server: the same
    requests, the same BatchFeatures, the same error class for an HTTP
    error and an unreachable server."""
    rows = [{"account_id": "a-1", "total_deposits": 150_000, "total_withdrawals": 20_000,
             "deposit_count": 3, "withdraw_count": 1, "total_bets": 90_000,
             "total_wins": 70_000, "bet_count": 45, "win_count": 20,
             "account_created_at": 1_700_000_000.123456, "bonus_claim_count": 2},
            {"account_id": 7, "total_deposits": 500, "deposit_count": 1},
            {"account_id": "a-3", "account_created_at": None}]
    fake = _FakeClickHouse(rows=rows, status=500 if case == "http_error" else 200)
    url = "http://127.0.0.1:1" if case == "unreachable" else fake.url
    got = {}
    try:
        for side, (*_, ch_mod, _refresh, _native) in SIDES.items():
            client = ch_mod.ClickHouseClient(url, database="risk", user="u", password="p",
                                             timeout_s=5.0)
            try:
                got[side] = ("ok", _features(ch_mod.clickhouse_source(client, "ev")()),
                             client.ping())
            except ch_mod.ClickHouseError as exc:
                got[side] = ("error", str(exc)[:8], client.ping())
    finally:
        fake.close()
    assert got["port"] == got["jax"]
    if case == "rows":
        assert got["port"][1]["7"]["bonus_claim_count"] is None
        assert fake.requests[0] == fake.requests[2] and "FROM ev" in fake.requests[0]["sql"]
        assert tch.BATCH_FEATURES_SQL == jch.BATCH_FEATURES_SQL
    else:
        assert got["port"][0] == "error" and got["port"][2] is False


# -- the wallet-store source and the refresh job --------------------------------------


@pytest.mark.parametrize("scheme", ["sqlite", "postgres"])
def test_wallet_store_source_and_refresh_match_jax(scheme, tmp_path):
    """wallet_store_source over either backend equal to the JAX source; both
    packages' refresh jobs into their native stores, rows equal."""
    path = str(tmp_path / "wallet.db")
    ids = seeded_wallet_db(path)
    rigs = ([m.PgSqliteServer(path) for m in (pg_testing, jrig)] if scheme == "postgres"
            else [])
    urls = [r.url for r in rigs] or [f"sqlite://{path}", path]
    try:
        scans = [trefresh.wallet_store_source(urls[0])(), jrefresh.wallet_store_source(urls[1])()]
        assert _features(scans[0]) == _features(scans[1]) and len(scans[0]) > 20
        rows = []
        for (*_, refresh_mod, native_mod), url in zip((SIDES["port"], SIDES["jax"]), urls):
            store = native_mod.NativeFeatureStore(max_accounts=1000)
            job = refresh_mod.BatchFeatureRefreshJob(store, refresh_mod.wallet_store_source(url))
            assert job.refresh_once() == len(scans[0]) and job.last_refresh_at > 0
            x = np.zeros((len(ids), 30), np.float32)
            for i, a in enumerate(ids):
                store.fill_row(x[i], a, 1000, "deposit", now=T0 + 86400.0 * 400)
            rows.append(x)
        np.testing.assert_array_equal(rows[0].view(np.int32), rows[1].view(np.int32))
    finally:
        for r in rigs:
            r.close()


def test_refresh_marks_device_cache_rows_dirty(tmp_path):
    """A refresh under a warm device feature cache: every resident account it
    touched is dirty, and the next lookup copies its new row in, equal to
    the store's own gather; the ticker retries fast until a scan succeeds."""
    path = str(tmp_path / "wallet.db")
    ids = seeded_wallet_db(path)
    store = tnative.NativeFeatureStore(max_accounts=1000, clock=lambda: T0)
    cache = DeviceFeatureCache(store, capacity=64, device="cpu")
    store.delta_listener = cache.note_update
    before = cache.table[cache.lookup(ids)].clone()
    job = trefresh.BatchFeatureRefreshJob(store, trefresh.wallet_store_source(path))
    touched = set(trefresh.wallet_store_source(path)())
    assert job.refresh_once() == len(touched)
    assert cache._dirty == touched & set(ids)
    slots = cache.lookup(ids)
    assert not cache._dirty
    want = np.stack([cache._gather_base_rows([a], T0)[0] for a in ids])
    np.testing.assert_array_equal(cache.table[slots].numpy(), want)
    assert (cache.table[slots] != before).any()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("source down")
        return {}

    ticker = trefresh.BatchFeatureRefreshJob(store, flaky, interval_s=0.05)
    ticker.start()
    try:
        deadline = time.monotonic() + 10
        while ticker.last_refresh_at == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        ticker.stop()
    assert len(calls) >= 3 and ticker.last_refresh_at > 0


# -- the risk server booted with BATCH_FEATURE_DB --------------------------------------


def test_risk_server_boots_with_batch_feature_db(tmp_path, monkeypatch):
    """Both packages' risk servers booted on the CPU with BATCH_FEATURE_DB
    over one wallet store (clocks pinned, mock backend, the Python store):
    the batch columns reach GetFeatures and ScoreBatch alike."""
    path = str(tmp_path / "wallet.db")
    ids = seeded_wallet_db(path)
    jax_native_libs()
    for knob in ("SLO", "DRIFT", "RUNTIME_TELEMETRY", "SUPERVISOR", "HOSTPROF"):
        monkeypatch.setenv(knob, "0")
    for knob in ("LEDGER_DIR", "ONLINE_LOOP", "CHAOS_PLAN", "WIRE_MODE", "CLICKHOUSE_URL"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("DEADLINE_DEFAULT_MS", "600000")
    monkeypatch.setenv("BURN_SHED", "0")
    monkeypatch.setenv("BULK_P99_SLO_MS", "0")
    monkeypatch.setattr(jfs, "time", types.SimpleNamespace(time=lambda: T0))
    from igaming_platform_tpu.serve.server import RiskServer as JRiskServer

    jcfg = JConfig(batch_feature_db=path, feature_store="python",
                   batcher=JBatcherConfig(batch_size=64, max_wait_ms=1.0))
    tcfg = RiskServiceConfig(batch_feature_db=f"sqlite://{path}", feature_store="python",
                             batcher=BatcherConfig(batch_size=64, max_wait_ms=1.0))
    with jax_hostprof_off():
        jsrv = JRiskServer(jcfg, grpc_port=0, http_port=0)
        tsrv = server.RiskServer(server.assemble_risk_service(
            tcfg, device="cpu", abuse_policy="heuristic",
            feature_store=tfs.InMemoryFeatureStore(clock=lambda: T0)), grpc_port=0, http_port=0)
        channels = [grpc.insecure_channel(f"localhost:{p}") for p in (jsrv.grpc_port,
                                                                        tsrv.grpc_port)]
        try:
            assert jsrv.batch_refresh.last_refresh_count == tsrv.batch_refresh.last_refresh_count
            stubs = [grpc_server.make_risk_stub(c) for c in channels]
            feats = [[stub.GetFeatures(risk_pb2.GetFeaturesRequest(
                account_id=a).SerializeToString(), timeout=60) for a in ids] for stub in stubs]
            fields = [[risk_pb2.GetFeaturesResponse.FromString(b).features for b in f]
                      for f in feats]
            assert fields[1] == fields[0] and any(f.total_deposits for f in fields[0])
            req = risk_pb2.ScoreBatchRequest(transactions=[risk_pb2.ScoreTransactionRequest(
                account_id=a, amount=1000 * (i + 1), transaction_type=("deposit", "bet")[i % 2])
                for i, a in enumerate(ids * 3)]).SerializeToString()
            got = [risk_pb2.ScoreBatchResponse.FromString(s.ScoreBatch(req, timeout=60)).results
                   for s in stubs]
            cols = [{"score": np.array([r.score for r in g]),
                     "action": np.array([r.action for r in g]),
                     "rule_score": np.array([r.rule_score for r in g]),
                     "ml_score": np.array([r.ml_score for r in g], np.float32)} for g in got]
            np.testing.assert_allclose(cols[1]["ml_score"], cols[0]["ml_score"], atol=1e-5)
            ok = checked_rows(cols[1], cols[0])
            for k in ("score", "action", "rule_score"):
                np.testing.assert_array_equal(cols[1][k][ok], cols[0][k][ok])
            assert [r.features for r in got[1]] == [r.features for r in got[0]]
        finally:
            for c in channels:
                c.close()
            tsrv.shutdown(grace=1)
            jsrv.shutdown(grace=1)
