"""Shared helpers of the serving-front parity tests (tests/test_torch_wire.py,
test_torch_native_store.py, test_torch_pipeline.py, test_torch_server.py):
seeded event columns with fixed timestamps, one clock pinned for the JAX
package's native store and the port's, and the masks under which two
risk.v1 responses are compared."""

import types

import numpy as np
import pytest

from igaming_platform_tpu.serve import native_store as jax_native_store

T0 = 1_700_000_000.0
TX_TYPES = ("deposit", "withdraw", "bet", "win")


def event_columns(seed: int, n_accounts: int, n_events: int) -> tuple:
    """(accounts, amounts, types, ips, devices, timestamps): events of the
    last two days before T0, some accounts without any, some devices shared."""
    rng = np.random.default_rng(seed)
    accts = [f"acct{a}" for a in rng.integers(0, n_accounts, n_events)]
    amounts = [int(a) for a in rng.integers(100, 500_000, n_events)]
    kinds = [TX_TYPES[k] for k in rng.choice(4, n_events, p=[0.3, 0.1, 0.5, 0.1])]
    ips = [f"ip{i}" if i else "" for i in rng.integers(0, 40, n_events)]
    devices = [f"dev{d}" for d in rng.integers(0, 30, n_events)]
    ts = sorted(T0 - rng.random(n_events) * rng.choice([200.0, 3000.0, 150_000.0], n_events))
    return accts, amounts, kinds, ips, devices, [float(t) for t in ts]


def fill(stores, cols, bonus_accounts=(), blacklist=()) -> None:
    """The same events, bonus claims and blacklist entries into every store."""
    for store in stores:
        store.update_columns(*cols)
        for i, acct in enumerate(bonus_accounts):
            store.record_bonus_claim(acct, wager_complete_rate=0.1 * (i % 10))
        for kind, value in blacklist:
            store.add_to_blacklist(kind, value)


def pin_jax_clock(monkeypatch, now: float = T0) -> None:
    """The JAX package's native store reads ``time.time()`` wherever a call
    gives no time: pin that module's clock only."""
    monkeypatch.setattr(jax_native_store, "time", types.SimpleNamespace(time=lambda: now))


@pytest.fixture
def no_jax_hostprof():
    """The JAX package's host profiler off for one test, then the very
    profiler the process had put back. Its GC callback takes the profiler's
    lock, which the same thread may already hold while it allocates a new
    stage's accumulator (``igaming_platform_tpu/obs/hostprof.py``,
    ``_on_span``): the JAX engine's batcher thread then waits on itself for
    good. A fresh profiler allocates every stage anew, so the process's own
    one comes back, its stages kept, and later tests meet no more of those
    allocations than they would without this fixture. The profiler computes
    nothing a port test compares."""
    from igaming_platform_tpu.obs import hostprof

    with hostprof._DEFAULT_LOCK:
        saved = hostprof._DEFAULT
        was_installed = saved is not None and saved._installed
        if saved is not None:
            saved.uninstall()
        hostprof._DEFAULT = hostprof.HostProfiler(enabled=False)
    try:
        yield
    finally:
        with hostprof._DEFAULT_LOCK:
            hostprof._DEFAULT.uninstall()
            hostprof._DEFAULT = saved
            if was_installed:
                saved.install()


def requests(seed: int, n: int, n_accounts: int) -> list[dict]:
    """ScoreTransactionRequest fields, some on unknown accounts, devices or
    types, some with the proto3 default transaction type."""
    rng = np.random.default_rng(seed)
    kinds = ("deposit", "withdraw", "bet", "", "refund")
    return [{"account_id": f"acct{rng.integers(0, n_accounts + 5)}",
             "amount": int(rng.integers(0, 2_000_000)),
             "transaction_type": kinds[rng.integers(5)],
             "ip_address": f"ip{rng.integers(0, 40)}", "device_id": f"dev{rng.integers(0, 35)}",
             "fingerprint": f"fp{rng.integers(0, 3)}", "currency": "EUR",
             "player_id": f"p{rng.integers(0, 9)}"}
            for _ in range(n)]


def checked_rows(got: dict, want: dict) -> np.ndarray:
    """The rows whose score and action are held exactly: all but those
    within 1e-4 of a floor boundary whose ml_score differs (as
    tests/test_torch_ensemble.py::assert_outputs_match excuses them)."""
    pre = 0.4 * want["rule_score"] + 60.0 * want["ml_score"].astype(np.float64) + 1e-4
    same_ml = (np.asarray(got["ml_score"], np.float32).view(np.int32)
               == np.asarray(want["ml_score"], np.float32).view(np.int32))
    return (np.abs(pre - np.round(pre)) > 1e-4) | same_ml
