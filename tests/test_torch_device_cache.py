"""Port parity: serve/device_cache.py and the engine's cached path.

- ``DeviceFeatureCache``: the JAX package's cache and the port's, over
  stores holding the same seeded events, take the same operations (lookups
  with repeats, store writes through ``delta_listener``, ``note_update``,
  ``set_account_flag``, time moving past ``max_age_s``). After each: the
  same slots, counts and residency, and the table and flags column
  bit-equal.
- Where they part: CLOCK never reclaims a slot that an earlier row of the
  same lookup resolved to. The JAX package's loop does, once its sweep has
  cleared every bit, and returns one slot for two accounts; the port keeps
  them apart, and a lookup of more distinct accounts than slots raises.
- The cached path (``score_columns_cached``) is bit-identical to the port's
  own host gather scored through the row path for the same ``now``, also
  while CLOCK evicts, and answers as the JAX engine's cached path
  (tests/test_torch_ensemble.py's tolerances), on ``mock`` and
  ``mlp+gbdt``.
"""

import types

import numpy as np
import pytest
from test_torch_ensemble import assert_outputs_match, jax_tree

from igaming_platform_tpu.core.config import BatcherConfig as JBatcherConfig
from igaming_platform_tpu.serve import device_cache as jdc
from igaming_platform_tpu.serve.feature_store import InMemoryFeatureStore as JStore
from igaming_platform_tpu.serve.feature_store import TransactionEvent as JEvent
from igaming_platform_tpu.serve.scorer import TPUScoringEngine
from igaming_platform_tpu_torch.convert import from_jax_params
from igaming_platform_tpu_torch.core.config import BatcherConfig
from igaming_platform_tpu_torch.serve.device_cache import DeviceFeatureCache
from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore, TransactionEvent
from igaming_platform_tpu_torch.serve.scorer import RESULT_KEYS, ScoreRequest, TorchScoringEngine

T0 = 1_700_000_000.0
N_ACCOUNTS = 30


def _stores(clock):
    """The JAX store and the port's, with the same seeded events."""
    rng = np.random.default_rng(3)
    jstore, tstore = JStore(), InMemoryFeatureStore(clock=lambda: clock[0])
    for a in range(N_ACCOUNTS):
        for k in range(int(rng.integers(1, 5))):
            ev = dict(account_id=f"acct{a}", amount=int(rng.integers(100, 300_000)),
                      tx_type=("deposit", "bet", "win", "withdraw")[k % 4],
                      ip=f"ip{rng.integers(0, 9)}", device_id=f"dev{a % 5}",
                      timestamp=T0 - float(rng.random() * 5000))
            jstore.update(JEvent(**ev))
            tstore.update(TransactionEvent(**ev))
    return jstore, tstore


def _ops(scenario: str):
    """(op, args) sequences; ``now`` moves with ``tick``."""
    ids = [f"acct{a}" for a in range(N_ACCOUNTS)]
    if scenario == "clock":
        return [("lookup", ids[:4]), ("lookup", ids[2:6] + ids[2:4]), ("lookup", ids[:3]),
                ("lookup", ids[6:10]), ("lookup", ids[1:2] * 3 + ids[9:12])]
    if scenario == "dirty":
        return [("lookup", ids[:6]), ("update", "acct2"), ("note", "acct29"), ("tick", 40.0),
                ("lookup", ids[:1]), ("update", "acct3"), ("update", "acct29"),
                ("lookup", ids[3:5] + ids[20:22])]
    if scenario == "max_age":
        return [("lookup", ids[:5]), ("tick", 60.0), ("lookup", ids[3:8]), ("tick", 60.0),
                ("lookup", ids[:8]), ("tick", 5.0), ("lookup", ids[:8])]
    return [("lookup", ids[:3]), ("flag", "acct1", True), ("flag", "acct17", True),
            ("flag", "acct1", False), ("lookup", ids[:5] + ids[17:18])]


@pytest.mark.parametrize("scenario", ["clock", "dirty", "max_age", "flags"])
def test_cache_matches_jax(scenario, monkeypatch):
    clock = [T0]
    monkeypatch.setattr(jdc, "time", types.SimpleNamespace(time=lambda: clock[0]))
    jstore, tstore = _stores(clock)
    capacity = 4 if scenario == "clock" else 8
    max_age = 100.0 if scenario == "max_age" else None
    jcache = jdc.DeviceFeatureCache(jstore, capacity=capacity, max_age_s=max_age)
    tcache = DeviceFeatureCache(tstore, capacity=capacity, device="cpu", max_age_s=max_age)
    jstore.delta_listener, tstore.delta_listener = jcache.note_update, tcache.note_update
    for step, (op, *args) in enumerate(_ops(scenario)):
        if op == "tick":
            clock[0] += args[0]
            continue
        if op == "lookup":
            want = jcache.lookup(args[0], now=clock[0])
            got = tcache.lookup(args[0])  # the store's clock is ``now``
            np.testing.assert_array_equal(got, want, err_msg=f"{scenario} #{step}")
        elif op == "update":
            ev = dict(account_id=args[0], amount=999, tx_type="bet", timestamp=clock[0])
            jstore.update(JEvent(**ev))
            tstore.update(TransactionEvent(**ev))
        elif op == "note":
            jcache.note_update(args[0])
            tcache.note_update(args[0])
        else:
            jcache.set_account_flag(*args)
            tcache.set_account_flag(*args)
        assert tcache.stats() == jcache.stats(), f"{scenario} #{step}"
        assert tcache._slots == jcache._slots and tcache._dirty == jcache._dirty
        np.testing.assert_array_equal(tcache.table.numpy(), np.asarray(jcache.table))
        np.testing.assert_array_equal(tcache.flags.numpy(), np.asarray(jcache.flags))
    stats = tcache.stats()
    assert stats["occupancy"] <= capacity
    if scenario == "clock":
        assert stats["evictions"] > 0
    if scenario in ("dirty", "max_age"):
        assert stats["deltas_applied"] > stats["misses"]
    assert tcache.shard_stats() == {"sharded": False, "shards": 1, "rows_per_shard": capacity,
                                    "occupancy": [stats["occupancy"]],
                                    "hbm_bytes": [capacity * 121]}
    with pytest.raises(NotImplementedError):
        tcache.bind_metrics(object())


def test_clock_never_reclaims_a_slot_its_own_lookup_reads():
    """Four resident accounts, every reference bit set; then a lookup of a
    resident account and a new one. The sweep clears every bit and comes
    back to the first slot: the JAX package reclaims it for the new account
    though the lookup's first row reads it; the port reclaims the next."""
    clock = [T0]
    jstore, tstore = _stores(clock)
    jcache = jdc.DeviceFeatureCache(jstore, capacity=4)
    tcache = DeviceFeatureCache(tstore, capacity=4, device="cpu")
    ids = [f"acct{a}" for a in range(6)]
    for cache in (jcache, tcache):
        cache.lookup(ids[:4], now=T0)
    want = jcache.lookup([ids[0], ids[4]], now=T0)
    got = tcache.lookup([ids[0], ids[4]], now=T0)
    assert want[0] == want[1] == 0  # the reference's two accounts on one slot
    assert got.tolist() == [0, 1] and not tcache.contains(ids[1])
    rows, _ = tcache._gather_base_rows([ids[0], ids[4]], T0), None
    np.testing.assert_array_equal(tcache.table.numpy()[got], rows)
    with pytest.raises(ValueError, match="more distinct accounts"):
        tcache.lookup(ids[:5], now=T0)


@pytest.mark.parametrize("backend", ["mock", "mlp+gbdt"])
def test_cached_path_matches_host_gather_and_jax(backend, monkeypatch):
    for knob in ("SLO", "DRIFT", "RUNTIME_TELEMETRY"):  # JAX planes the port does not have
        monkeypatch.setenv(knob, "0")
    clock = [T0]
    jstore, tstore = _stores(clock)
    for store in (jstore, tstore):
        store.add_to_blacklist("device", "dev3")
    tree = jax_tree(backend)
    kw = dict(batch_size=16, latency_tiers=(8,), max_wait_ms=1.0)
    # The JAX engine holds every account (its CLOCK could otherwise give two
    # of a chunk's accounts one slot); the port's evicts as it goes.
    jeng = TPUScoringEngine(ml_backend=backend, params=tree or None, feature_store=jstore,
                            batcher_config=JBatcherConfig(**kw), feature_cache=40)
    teng = TorchScoringEngine(ml_backend=backend, params=from_jax_params(backend, tree),
                              feature_store=tstore, device="cpu", feature_cache=16,
                              batcher_config=BatcherConfig(**kw))
    try:
        assert teng.cache is not None  # built eagerly at warmup
        rng = np.random.default_rng(5)
        # One ``now`` for every chunk: a resident row is the account's row as
        # of its last delta, which equals a host gather at that ``now``.
        now = T0
        for c in range(4):
            n = (3, 16, 37, 9)[c]
            ids = [f"acct{a}" for a in rng.integers(0, N_ACCOUNTS + 3, n)]
            amounts = [int(a) for a in rng.integers(0, 2_000_000, n)]
            kinds = [("deposit", "withdraw", "bet", "win", "refund")[k]
                     for k in rng.integers(0, 5, n)]
            devices = [f"dev{d}" for d in rng.integers(0, 6, n)]
            if c == 2:  # a write-back: the next lookup folds the dirty row
                for store, cls in ((jstore, JEvent), (tstore, TransactionEvent)):
                    store.update(cls(account_id="acct4", amount=5, tx_type="bet", timestamp=now))
            got = teng.score_columns_cached(ids, amounts, kinds, devices=devices, now=now)
            # The host gather of the same rows at the same ``now``, through
            # the row path in the same chunks: bit for bit.
            x, bl = tstore.gather_batch([ScoreRequest(account_id=a, amount=m, tx_type=k, device_id=d)
                                         for a, m, k, d in zip(ids, amounts, kinds, devices)],
                                        now=now)
            host = {k: [] for k in RESULT_KEYS}
            for lo in range(0, n, teng.batch_size):
                out = teng._readback(teng._launch(x[lo:lo + 16], bl[lo:lo + 16], teng.get_params()))
                for k in RESULT_KEYS:
                    host[k].append(out[k])
            for k in RESULT_KEYS:
                np.testing.assert_array_equal(got[k].view(np.int32),
                                              np.concatenate(host[k]).view(np.int32), err_msg=k)
            want = jeng.score_columns_cached(ids, amounts, kinds, devices=devices, now=now)
            assert_outputs_match({k: _tensor(v) for k, v in got.items()}, want,
                                 f"{backend} chunk {c}")
        assert teng.cache.stats()["evictions"] > 0 and jeng.cache.stats()["evictions"] == 0
        with pytest.raises(ValueError, match="smaller than the batch size"):
            TorchScoringEngine(feature_store=tstore, device="cpu", feature_cache=8,
                               batcher_config=BatcherConfig(**kw)).close()
    finally:
        jeng.close()
        teng.close()


def _tensor(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))
