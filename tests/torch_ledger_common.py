"""Shared helpers of the decision-ledger parity tests (tests/test_torch_ledger.py,
tests/test_torch_replay.py): the same record built in both packages, a fake
sink, the ledger's clock and identity seams pinned in both, seeded stores
whose clocks are pinned, and the engines of both packages over them."""

import types

import numpy as np

from igaming_platform_tpu.core.config import BatcherConfig as JBatcherConfig
from igaming_platform_tpu.serve import feature_store as jax_feature_store
from igaming_platform_tpu.serve import ledger as jl
from igaming_platform_tpu.serve.feature_store import InMemoryFeatureStore as JStore
from igaming_platform_tpu.serve.feature_store import TransactionEvent as JEvent
from igaming_platform_tpu.serve.scorer import ScoreRequest as JRequest
from igaming_platform_tpu.serve.scorer import TPUScoringEngine
from igaming_platform_tpu_torch.convert import from_jax_params
from igaming_platform_tpu_torch.core.config import BatcherConfig
from igaming_platform_tpu_torch.serve import ledger as pl
from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore, TransactionEvent
from igaming_platform_tpu_torch.serve.scorer import ScoreRequest, TorchScoringEngine

T0 = 1_700_000_000.0
LEDGERS = {"jax": jl, "port": pl}
# Every field of a decision record but the feature snapshot and ml_score.
FIELDS = ("decision_id", "account_id", "trace_id", "model_version", "params_fp", "wire_mode",
          "serving_state", "tier", "score", "action", "reason_mask", "rule_score", "amount",
          "tx_type", "block_threshold", "review_threshold", "ts_unix", "blacklisted",
          "session_len", "session_seq", "session_hash")


def record(mod, i: int = 0, features: bool = True, tier: str = "device",
           blacklisted: bool | None = None, session: bool = False):
    """A seeded decision record of package ``mod`` (``jl`` or ``pl``)."""
    rng = np.random.default_rng(i)
    return mod.DecisionRecord(
        decision_id=f"d-test-{i:07x}.0", account_id=f"acct-{i}",
        trace_id="0af7651916cd43dd8448eb211c80319c" if i % 3 else "",
        model_version=("mock", "mlp+gbdt", "multitask")[i % 3],
        params_fp=f"{rng.integers(0, 2**63):016x}", wire_mode=("batch", "single", "wire_row",
                                                              "index")[i % 4],
        serving_state=("serving", "degraded", "unknown")[i % 3], tier=tier,
        score=40 + i, action=1 + i % 3, reason_mask=int(rng.integers(0, 2**20)), rule_score=40,
        ml_score_bits=int(np.float32(rng.random()).view(np.uint32)),
        amount=int(rng.integers(0, 10**9)), tx_type=("deposit", "withdraw", "bet", "win", "")[i % 5],
        block_threshold=80, review_threshold=50, ts_unix=T0 + i * 0.25,
        blacklisted=bool(i % 2) if blacklisted is None else blacklisted,
        features=rng.normal(size=30).astype(np.float32) if features else None,
        session_len=(i % 16) + 1 if session else 0, session_seq=i + 1 if session else 0,
        session_hash=f"{rng.integers(0, 2**63):016x}" if session else "")


def fields(rec) -> dict:
    return {k: getattr(rec, k) for k in FIELDS}


class FakeSink:
    """A decision sink that records what it was sent, and fails on demand."""

    def __init__(self):
        self.batches: list[list] = []
        self.fail = False
        self.sends = 0

    def ids(self) -> list[str]:
        return [r.decision_id for b in self.batches for r in b]

    def send(self, records):
        self.sends += 1
        if self.fail:
            raise RuntimeError("sink down (test)")
        self.batches.append(list(records))


def pin_ledgers(monkeypatch) -> None:
    """The ledgers' clock and identity seams pinned alike in both packages
    (a fixed note time, one process token, batch sequence from 0), the JAX
    store's clock at T0, and the JAX planes the port does not have off."""
    for mod in LEDGERS.values():
        monkeypatch.setattr(mod, "wall_clock", lambda: T0 + 0.5)
        monkeypatch.setattr(mod, "_TOKEN", "tok0000000")
        monkeypatch.setattr(mod, "_BATCH_SEQ", 0)
    monkeypatch.setattr(jax_feature_store, "time", types.SimpleNamespace(time=lambda: T0))
    for knob in ("SLO", "DRIFT", "RUNTIME_TELEMETRY"):
        monkeypatch.setenv(knob, "0")


def seed_stores(n_accounts: int = 12, n_events: int = 60):
    """The JAX store and the port's (its clock pinned at T0), fed the same
    events before T0, with a blacklisted device."""
    stores = (JStore(), InMemoryFeatureStore(clock=lambda: T0))
    rng = np.random.default_rng(4)
    for i in range(n_events):
        ev = dict(account_id=f"lg-{i % n_accounts}", amount=int(rng.integers(100, 400_000)),
                  tx_type=("deposit", "bet", "withdraw", "win")[i % 4],
                  ip=f"10.1.{i % 9}.{i % 7}", device_id=f"dev-{i % 5}",
                  timestamp=T0 - float(rng.random() * 90_000))
        stores[0].update(JEvent(**ev))
        stores[1].update(TransactionEvent(**ev))
    for store in stores:
        store.add_to_blacklist("device", "dev-3")
    return stores


def requests(n: int, seed: int = 5, n_accounts: int = 12):
    """The same ScoreRequest fields for both packages."""
    rng = np.random.default_rng(seed)
    rows = [dict(account_id=f"lg-{rng.integers(0, n_accounts + 2)}",
                 amount=int(rng.integers(100, 2_000_000)),
                 tx_type=("deposit", "bet", "withdraw")[rng.integers(3)],
                 device_id=f"dev-{rng.integers(0, 6)}") for _ in range(n)]
    return [JRequest(**r) for r in rows], [ScoreRequest(**r) for r in rows]


def engines(tree: dict, backend: str, stores, batch: int = 32, tiers=(8,), **kw):
    """(JAX engine, port CPU engine) over ``stores``, the same ladder."""
    cfg = dict(batch_size=batch, latency_tiers=tiers, max_wait_ms=1.0)
    jeng = TPUScoringEngine(ml_backend=backend, params=tree or None, feature_store=stores[0],
                            batcher_config=JBatcherConfig(**cfg), **kw)
    teng = TorchScoringEngine(ml_backend=backend,
                              params=from_jax_params(backend, tree) if tree else None,
                              feature_store=stores[1], device="cpu",
                              batcher_config=BatcherConfig(**cfg), **kw)
    return jeng, teng
