"""Shared helpers of the serving-front parity tests (tests/test_torch_wire.py,
test_torch_native_store.py, test_torch_pipeline.py, test_torch_server.py):
seeded event columns with fixed timestamps, one clock pinned for the JAX
package's native store and the port's, and the masks under which two
risk.v1 responses are compared."""

import contextlib
import time
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


@contextlib.contextmanager
def _hostprof_off(hostprof):
    """``hostprof`` (either package's module) with its default profiler off
    inside the block, then the very profiler the process had put back."""
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


@contextlib.contextmanager
def jax_hostprof_off():
    """The JAX package's host profiler off inside the block, then the very
    profiler the process had put back. Its GC callback takes the profiler's
    lock, which the same thread may already hold while it allocates a new
    stage's accumulator (``igaming_platform_tpu/obs/hostprof.py``,
    ``_on_span``): the JAX engine's batcher thread then waits on itself for
    good. A fresh profiler allocates every stage anew, so the process's own
    one comes back, its stages kept, and later tests meet no more of those
    allocations than they would without this block."""
    from igaming_platform_tpu.obs import hostprof

    with _hostprof_off(hostprof):
        yield


@pytest.fixture
def no_jax_hostprof():
    """``jax_hostprof_off`` for one test, with the port's host profiler off
    too, so that what the two packages expose stays comparable
    (tests/test_torch_hostprof.py holds the profilers to each other)."""
    from igaming_platform_tpu_torch.obs import hostprof

    with jax_hostprof_off(), _hostprof_off(hostprof):
        yield


def jax_native_libs(timeout_s: float = 120.0) -> None:
    """The JAX package's native feature store and wire codec, loaded. A
    fresh checkout has no ``native/lib/``: each test process that needs a
    library runs ``native/build.sh``, and under xdist several do at once,
    so one can dlopen a library another is still writing ("file too
    short"). The JAX loaders then mark the library unavailable for the
    whole process, and the JAX service answers ScoreBatch with INTERNAL
    ("native wire codec unavailable"). Retry the load until the concurrent
    build has finished."""
    from igaming_platform_tpu.serve import native_store as jstore
    from igaming_platform_tpu.serve import wire as jwire

    deadline = time.monotonic() + timeout_s
    while not (jstore.native_available() and jwire.native_wire_available()):
        assert time.monotonic() < deadline, "the JAX package's native libraries do not load"
        time.sleep(0.5)
        jstore._lib_attempted = False
        jwire._load_failed = False


@contextlib.contextmanager
def port_sidecar(monkeypatch):
    """A port ``RiskServer`` on the CPU (mock backend, the Python store, no
    gRPC, the sidecar on a free port), under settings no host load can
    change: a default deadline no slow host reaches, no latency-driven
    shed. Yields (server, the sidecar's base URL); shut down after."""
    from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
    from igaming_platform_tpu_torch.serve import server as pserver
    from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore

    for knob in ("SUPERVISOR", "LEDGER_DIR", "ONLINE_LOOP", "CHAOS_PLAN", "WIRE_MODE",
                 "HOSTPROF_HZ"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("DEADLINE_DEFAULT_MS", "600000")
    monkeypatch.setenv("BURN_SHED", "0")
    monkeypatch.setenv("BULK_P99_SLO_MS", "0")
    config = RiskServiceConfig(batcher=BatcherConfig(batch_size=64, latency_tiers=(16,),
                                                     max_wait_ms=1.0))
    assembled = pserver.assemble_risk_service(config, feature_store=InMemoryFeatureStore(),
                                              device="cpu")
    server = pserver.RiskServer(assembled, grpc_port=-1, http_port=0)
    try:
        yield server, f"http://127.0.0.1:{server.http_port}"
    finally:
        server.shutdown(grace=1.0)


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


# ---------------------------------------------------------------------------
# The operations plane (tests/test_torch_metrics.py, test_torch_tracing.py)


class JaxAborted(Exception):
    """What the JAX package's RPC wrapper raises through ``JaxContext``."""


class JaxContext:
    """The part of a grpcio servicer context the JAX package's RPC wrapper
    uses: invocation metadata in, trailing metadata out, abort as raise."""

    def __init__(self, metadata=()):
        self.metadata = tuple(metadata)
        self.trailing = ()

    def invocation_metadata(self):
        return self.metadata

    def time_remaining(self):
        return None

    def set_trailing_metadata(self, pairs):
        self.trailing = tuple(pairs)

    def abort(self, code, details):
        raise JaxAborted(code.name, details)


def ltv_rows(account_id: str):
    """A fixed 25-feature LTV row per account (both services' source)."""
    rng = np.random.default_rng(sum(account_id.encode()))
    return rng.gamma(2.0, 50.0, 25).astype(np.float32)


class PlanePair:
    """The JAX package's RiskGrpcService and the port's, each over a
    supervised engine (``backend``, the same params), the same native-store
    events with pinned clocks and a decision ledger in ``tmp_path``, with
    their SLO and drift planes on (the JAX runtime telemetry off: the port
    has none; no latency-driven shed). ``call(side, method, request_bytes, metadata)`` runs one RPC
    through that package's RPC wrapper and returns its status code name."""

    def __init__(self, monkeypatch, tmp_path, backend: str = "mlp+gbdt", n_accounts: int = 40):
        from test_torch_ensemble import jax_tree

        from igaming_platform_tpu.core.config import BatcherConfig as JBatcherConfig
        from igaming_platform_tpu.serve import grpc_server as jgrpc
        from igaming_platform_tpu.serve import ledger as jl
        from igaming_platform_tpu.serve import supervisor as jsup
        from igaming_platform_tpu.serve.native_store import NativeFeatureStore as JaxStore
        from igaming_platform_tpu.serve.scorer import TPUScoringEngine
        from igaming_platform_tpu_torch.convert import from_jax_params
        from igaming_platform_tpu_torch.core.config import BatcherConfig
        from igaming_platform_tpu_torch.serve import grpc_server as pgrpc
        from igaming_platform_tpu_torch.serve import ledger as pl
        from igaming_platform_tpu_torch.serve import supervisor as psup
        from igaming_platform_tpu_torch.serve.native_store import NativeFeatureStore
        from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine

        for knob in ("SLO", "DRIFT", "SUPERVISOR", "HOST_PIPELINE", "WIRE_MODE", "WIRE_DTYPE",
                     "CHAOS_PLAN", "DEADLINE_DEFAULT_MS", "SLO_OBJECTIVE_MS"):
            monkeypatch.delenv(knob, raising=False)
        monkeypatch.setenv("RUNTIME_TELEMETRY", "0")
        # No shed that depends on the host's latency: the burn-shed gate
        # and the bulk gate's p99 feedback off in both.
        monkeypatch.setenv("BURN_SHED", "0")
        monkeypatch.setenv("BULK_P99_SLO_MS", "0")
        pin_jax_clock(monkeypatch)
        jax_native_libs()
        self.jgrpc, self.pgrpc = jgrpc, pgrpc
        stores = (JaxStore(max_accounts=400), NativeFeatureStore(max_accounts=400,
                                                                 clock=lambda: T0))
        fill(stores, event_columns(5, n_accounts, 900),
             bonus_accounts=[f"acct{a}" for a in range(0, n_accounts, 4)],
             blacklist=[("device", "dev4")])
        tree = jax_tree(backend)
        cfg = dict(batch_size=64, latency_tiers=(16,), max_wait_ms=1.0)
        jeng = jsup.SupervisedScoringEngine(
            lambda: TPUScoringEngine(ml_backend=backend, params=tree or None,
                                     feature_store=stores[0],
                                     batcher_config=JBatcherConfig(**cfg)),
            supervisor=jsup.ServingSupervisor())
        peng = psup.SupervisedScoringEngine(
            lambda: TorchScoringEngine(ml_backend=backend, params=from_jax_params(backend, tree),
                                       feature_store=stores[1], device="cpu",
                                       batcher_config=BatcherConfig(**cfg)),
            supervisor=psup.ServingSupervisor())
        self.engines = (jeng, peng)
        self.services = (jgrpc.RiskGrpcService(jeng, ltv_source=ltv_rows),
                         pgrpc.RiskGrpcService(peng, ltv_source=ltv_rows))
        self.ledgers = []
        for side, (mod, svc, eng) in enumerate(zip((jl, pl), self.services, self.engines)):
            ledger = mod.DecisionLedger(str(tmp_path / f"ledger{side}"), metrics=svc.metrics)
            eng.inner.ledger = ledger
            self.ledgers.append(ledger)
        self._closed = False

    def call(self, side: int, method: str, payload: bytes, metadata=()) -> str:
        if side == 0:
            from igaming_platform_tpu.proto_gen.risk.v1 import risk_pb2

            svc = self.services[0]
            request = (bytes(payload) if method == "ScoreBatch"
                       else getattr(risk_pb2, f"{method}Request").FromString(payload))
            handler = self.jgrpc._rpc(svc.metrics, method, getattr(svc, method))
            try:
                handler(request, JaxContext(metadata))
                return "OK"
            except JaxAborted as exc:
                return exc.args[0]
        try:
            self.services[1].call(method, payload, metadata)
            return "OK"
        except self.pgrpc.RpcAbort as exc:
            return exc.code.name

    def settle(self) -> None:
        """Every ledger record written, every queued sketch folded."""
        for ledger in self.ledgers:
            ledger.flush(10.0)
        for svc in self.services:
            if svc.drift is not None:
                svc.drift.drain(10.0)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for eng, ledger in zip(self.engines, self.ledgers):
            eng.close()
            ledger.close()
        from igaming_platform_tpu.obs import drift as jdrift
        from igaming_platform_tpu.obs import slo as jslo

        self.services[1].close()
        for mod in (jdrift, jslo):
            mod.uninstall()


# -- the wallet side's identifiers and clocks (tests/test_torch_pg.py,
# test_torch_stores.py, test_torch_wallet_server.py) ----------------------------

WALLET_NOW = T0 + 0.123456  # a float whose text round trip is not trivial


def _wallet_clock_modules():
    from igaming_platform_tpu.platform import domain as jdomain
    from igaming_platform_tpu.platform import migrations as jmig
    from igaming_platform_tpu.platform import pg_store as jpg
    from igaming_platform_tpu.platform import repository as jrepo
    from igaming_platform_tpu.serve import events as jevents
    from igaming_platform_tpu_torch.platform import domain as tdomain
    from igaming_platform_tpu_torch.platform import migrations as tmig
    from igaming_platform_tpu_torch.platform import pg_store as tpg
    from igaming_platform_tpu_torch.platform import repository as trepo
    from igaming_platform_tpu_torch.serve import events as tevents

    modules = (jdomain, jmig, jpg, jrepo, jevents, tdomain, tmig, tpg, trepo, tevents)
    classes = [c for m in (jdomain, jevents, tdomain, tevents) for c in vars(m).values()
               if isinstance(c, type) and hasattr(c, "__dataclass_fields__")
               and c.__module__ == m.__name__]
    return modules, classes


@contextlib.contextmanager
def pinned_wallet(now: float = WALLET_NOW):
    """Every identifier and wall-clock read of both packages' wallet paths
    pinned: ``uuid.uuid4`` counts from 1 (``reset()``, the yielded callable,
    restarts it between the two packages' runs), and ``time.time`` reads
    ``now`` in the domain, repository, Postgres store, migration and event
    modules and in their dataclasses' ``time.time`` default factories, which
    were bound when the classes were made (patching a module's ``time`` does
    not reach them)."""
    import uuid

    counter = [0]

    def next_uuid():
        counter[0] += 1
        return uuid.UUID(int=counter[0])

    clock = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                     if not k.startswith("_")})
    clock.time = lambda: now
    modules, classes = _wallet_clock_modules()
    cells = [cell for c in classes for cell in (c.__init__.__closure__ or ())
             if cell.cell_contents is time.time]
    saved = [(m, m.time) for m in modules]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(uuid, "uuid4", next_uuid)
        for m in modules:
            m.time = clock
        for cell in cells:
            cell.cell_contents = clock.time
        try:
            yield lambda: counter.__setitem__(0, 0)
        finally:
            for cell in cells:
                cell.cell_contents = time.time
            for m, t in saved:
                m.time = t


class FixedGate:
    """A risk gate whose score is a hash of the operation: the same answers
    in both packages' wallets, with blocks and reviews among them."""

    def score_transaction(self, account_id, amount, tx_type, game_id="", ip="", device_id="",
                          fingerprint=""):
        score = (amount * 7 + len(account_id) + len(tx_type)) % 100
        action = "block" if score >= 97 else "review" if score >= 94 else "approve"
        return score, action, ["VELOCITY_1M"] if action != "approve" else []


TEST_LIMIT_S = 120


@pytest.fixture
def time_limit():
    """A time limit of the test's own: SIGALRM raises TimeoutError in the
    test's thread (pytest's main thread) after TEST_LIMIT_S, so a socket
    that never answers fails one test instead of holding the whole run to
    its clock."""
    import signal

    def fire(signum, frame):
        raise TimeoutError(f"the test ran past its {TEST_LIMIT_S} s limit")

    previous = signal.signal(signal.SIGALRM, fire)
    signal.alarm(TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def seeded_wallet_db(path: str, n_accounts: int = 30, n_ops: int = 240, seed: int = 5) -> list:
    """A wallet store at ``path`` (the port's SQLiteStore) with ``n_accounts``
    accounts and ``n_ops`` seeded deposits, bets, wins and withdrawals,
    through the port's wallet under ``FixedGate``; returns the account ids."""
    from igaming_platform_tpu_torch.platform.repository import SQLiteStore
    from igaming_platform_tpu_torch.platform.wallet import WalletService

    rng = np.random.default_rng(seed)
    store = SQLiteStore(path)
    try:
        svc = WalletService(store.accounts, store.transactions, store.ledger, risk=FixedGate())
        ids = [svc.create_account(f"acct{i}").id for i in range(n_accounts)]
        for i in range(n_ops):
            acct = ids[int(rng.integers(n_accounts))]
            kind = ("deposit", "bet", "win", "withdraw")[int(rng.choice(4, p=[.4, .35, .15, .1]))]
            try:
                getattr(svc, kind)(acct, int(rng.integers(100, 50_000)), f"s{i}")
            except Exception:  # noqa: BLE001 - refusals are part of the history
                pass
    finally:
        store.close()
    return ids
