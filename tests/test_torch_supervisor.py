"""Port parity: serve/supervisor.py, the self-healing supervisor.

- ``CircuitBreaker`` and ``ServingSupervisor`` in both packages under one
  script and one fake clock: the same state sequences and snapshots.
- One ``CHAOS_PLAN`` (``feature_store.gather`` or ``device.readback``
  errors) against the JAX package's ``SupervisedScoringEngine`` and the
  port's, over the same stores (clocks pinned), with a decision ledger each:
  the same breaker states and serving states after every call, degraded
  answers equal and flagged (the ``DEGRADED_CPU_HEURISTIC`` reason, the
  ``+degraded-heuristic`` model version, ledger tier ``heuristic``), and the
  same recovery once the plan is cleared.
- A ``device.readback`` wedge past the watchdog: ``DeviceWedgedError``,
  then a rebuild through the factory, the device breaker OPEN, HALF_OPEN,
  CLOSED in both packages, and the rebuilt engine's answers equal the first
  engine's.
- BROWNOUT: UNAVAILABLE with the ``grpc-retry-pushback-ms`` trailer through
  each package's RPC wrapper, and health NOT_SERVING.
- A factory that raises on the rebuild leaves the port's degraded tier
  answering and the breaker half-open, and is not called again by later
  probes (the JAX package's probe times out on the closed engine and
  rebuilds again, a loop the port does not inherit); a half-open probe
  always gets a verdict.
"""

import threading
import time

import numpy as np
import pytest
from torch_front_common import JaxAborted, JaxContext
from torch_front_common import no_jax_hostprof  # noqa: F401 — a fixture
from torch_ledger_common import pin_ledgers, requests, seed_stores

from igaming_platform_tpu.core.config import BatcherConfig as JBatcherConfig
from igaming_platform_tpu.proto_gen.risk.v1 import risk_pb2
from igaming_platform_tpu.serve import chaos as jchaos
from igaming_platform_tpu.serve import grpc_server as jgrpc
from igaming_platform_tpu.serve import ledger as jl
from igaming_platform_tpu.serve import supervisor as jsup
from igaming_platform_tpu.serve.scorer import TPUScoringEngine
from igaming_platform_tpu_torch.core.config import BatcherConfig
from igaming_platform_tpu_torch.serve import chaos as pchaos
from igaming_platform_tpu_torch.serve import grpc_server as pgrpc
from igaming_platform_tpu_torch.serve import ledger as pl
from igaming_platform_tpu_torch.serve import supervisor as psup
from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine

PKGS = ((jsup, jchaos, jl), (psup, pchaos, pl))


@pytest.fixture(autouse=True)
def _no_chaos(no_jax_hostprof):
    for mod in (jchaos, pchaos):
        mod.clear()
    yield
    for mod in (jchaos, pchaos):
        mod.clear()


def _states(sup) -> tuple:
    return sup.state, tuple(sorted((d, b.state_name) for d, b in sup.breakers.items()))


def test_breakers_and_serving_states_match_jax():
    now = [0.0]
    seen = []
    for mod, _, _ in PKGS:
        br = mod.CircuitBreaker("dep", failure_threshold=3, open_s=2.0, clock=lambda: now[0])
        sup = mod.ServingSupervisor(failure_threshold=2, open_s=60.0)
        trace = []
        now[0] = 0.0
        for step in ("fail", "fail", "allow", "fail", "allow", "t2.5", "allow", "allow",
                     "ok", "fatal", "t5", "allow", "fail", "force", "t100", "allow", "probe",
                     "reset"):
            if step == "fail":
                br.record_failure("e")
            elif step == "fatal":
                br.record_failure("e", fatal=True)
            elif step == "ok":
                br.record_success()
            elif step == "allow":
                trace.append(br.allow())
            elif step == "force":
                br.force_open("operator")
            elif step == "probe":
                br.clear_forced()
            elif step == "reset":
                br.reset()
            else:
                now[0] = float(step[1:])
            snap = br.snapshot()
            snap.pop("open_age_s")
            trace.append((br.state_name, snap))
        for dep, action in (("feature_store", "fail"), ("feature_store", "fail"),
                            ("device", "open"), ("feature_store", "clear"), ("device", "probe"),
                            ("brownout", "force"), ("degraded_tier", "fail"),
                            ("degraded_tier", "fail"), ("brownout", "clear"),
                            ("degraded_tier", "clear"), ("device", "clear"), ("ledger", "open")):
            if dep == "brownout" and action == "force":
                sup.force_brownout("operator")
            elif dep == "brownout":
                sup.clear_brownout()
            elif action == "fail":
                sup.breaker(dep).record_failure("x")
            else:
                sup.force_breaker(dep, action)
            trace.append(_states(sup))
        with pytest.raises(ValueError):
            sup.force_breaker("device", "explode")
        seen.append(trace)
    assert seen[1] == seen[0]
    states = {t[0] for t in seen[1] if isinstance(t, tuple) and len(t) == 2 and t[0] in (
        "serving", "degraded", "brownout")}
    assert states == {"serving", "degraded", "brownout"}


def _pair(tmp_path, monkeypatch, factory_calls=None, raise_on_rebuild=False, watchdog_s=20.0):
    """(JAX supervised engine, port supervised engine, ledgers), mock backend
    over the same stores, each with a ledger."""
    pin_ledgers(monkeypatch)
    stores = seed_stores()
    cfg = dict(batch_size=16, latency_tiers=(8,), max_wait_ms=1.0)
    built = []
    for i, (mod, _, led_mod) in enumerate(PKGS):
        calls = [0]

        def factory(i=i, calls=calls):
            calls[0] += 1
            if raise_on_rebuild and calls[0] > 1:
                raise RuntimeError("rebuild failed: device lost")
            if i == 0:
                return TPUScoringEngine(feature_store=stores[0],
                                        batcher_config=JBatcherConfig(**cfg))
            return TorchScoringEngine(feature_store=stores[1], device="cpu",
                                      batcher_config=BatcherConfig(**cfg))

        sup = mod.ServingSupervisor(failure_threshold=2, open_s=0.3)
        eng = mod.SupervisedScoringEngine(factory, supervisor=sup, watchdog_s=watchdog_s)
        ledger = led_mod.DecisionLedger(str(tmp_path / f"led{i}"), fsync_interval_ms=1)
        eng.inner.ledger = ledger
        if factory_calls is not None:
            factory_calls.append(calls)
        built.append((eng, sup, ledger))
    return built


def _close(built):
    """Close every engine, then its ledger (the WAL flushed); idempotent."""
    for eng, _, ledger in built:
        if not getattr(eng, "_test_closed", False):
            eng.close()
            eng.__dict__["_test_closed"] = True
        ledger.close()


def _answer(resp) -> tuple:
    return (resp.score, resp.action, [r.value for r in resp.reason_codes], resp.rule_score,
            np.float32(resp.ml_score).tobytes())


@pytest.mark.parametrize("plan", ["feature_store.gather=error:p=1.0",
                                  "device.readback=error:p=1.0"])
def test_chaos_plan_same_transitions_and_degraded_answers(plan, tmp_path, monkeypatch):
    built = _pair(tmp_path, monkeypatch)
    jreqs, preqs = requests(10)
    try:
        trace = [[], []]
        for phase in ("healthy", "chaos", "recover"):
            if phase == "chaos":
                for _, mod, _ in PKGS:
                    mod.install(f"seed=3;{plan}")
            if phase == "recover":
                for _, mod, _ in PKGS:
                    mod.clear()
                time.sleep(0.35)  # past open_s: the next call is the half-open probe
            for k in range(4):
                for side, ((eng, sup, _), reqs) in enumerate(zip(built, (jreqs, preqs))):
                    resp = eng.score(reqs[k])
                    trace[side].append((phase, _answer(resp), eng.model_version, _states(sup)))
        assert trace[1] == trace[0]
        degraded = [t for t in trace[1] if "DEGRADED_CPU_HEURISTIC" in t[1][2]]
        # The suffix shows while a circuit is not closed; the reason code on
        # every degraded answer.
        assert degraded and "mock+degraded-heuristic" in {t[2] for t in degraded}
        assert trace[1][-1][3][0] == "serving"
        _close(built)
        records = [list(mod.iter_records(str(tmp_path / f"led{i}")))
                   for i, (_, _, mod) in enumerate(PKGS)]
        tiers = [[(r.tier, r.model_version, r.score) for r in recs] for recs in records]
        assert tiers[1] == tiers[0]
        assert ("heuristic", "mock+degraded-heuristic") in {t[:2] for t in tiers[1]}
    finally:
        _close(built)


def _watch_device(sup, into: list) -> None:
    br = sup.breaker("device")
    original = br.on_state_change

    def hook(b, state):
        into.append(state)
        original(b, state)

    br.on_state_change = hook


@pytest.mark.parametrize("raise_on_rebuild", [False, True])
def test_watchdog_trip_rebuild_half_open_closed(raise_on_rebuild, tmp_path, monkeypatch):
    calls: list = []
    built = _pair(tmp_path, monkeypatch, factory_calls=calls,
                  raise_on_rebuild=raise_on_rebuild, watchdog_s=0.4)
    jreqs, preqs = requests(6)
    outcome = []
    try:
        for side, ((eng, sup, _), reqs, (_, cmod, _)) in enumerate(zip(built, (jreqs, preqs),
                                                                       PKGS)):
            if raise_on_rebuild and side == 0:
                # The JAX package closes the old engine after a failed
                # rebuild too, but its closed batcher still admits the
                # probe, which times out and rebuilds again: a loop. The
                # port's closed batcher refuses it, a plain failure.
                outcome.append(None)
                continue
            transitions: list = []
            _watch_device(sup, transitions)
            first = _answer(eng.score(reqs[0]))
            # Two wedged readbacks: the batch's collect and its hedge.
            cmod.install("seed=5;device.readback=wedge:p=1.0:ms=900:count=2")
            with pytest.raises(psup.DeviceWedgedError if side else jsup.DeviceWedgedError):
                eng.score(reqs[1])
            assert "DEGRADED_CPU_HEURISTIC" in _answer(eng.score(reqs[2]))[2]
            deadline = time.monotonic() + 30
            while eng._rebuilding and time.monotonic() < deadline:
                time.sleep(0.02)
            cmod.clear()
            time.sleep(0.35)
            answers = [_answer(eng.score(reqs[0])) for _ in range(3)]
            time.sleep(0.35)
            answers.append(_answer(eng.score(reqs[0])))
            outcome.append((transitions, eng.rebuilds, calls[side][0], sup.state,
                            [a[2] for a in answers]))
            if not raise_on_rebuild:
                assert answers[-1] == first  # the rebuilt engine answers as the first did
        if not raise_on_rebuild:
            assert outcome[1] == outcome[0]
        transitions, rebuilds, factory_calls, state, reasons = outcome[1]
        if raise_on_rebuild:
            # The rebuild failed: degraded answers, the breaker probing
            # half-open then open again, and the factory never called again.
            assert rebuilds == 0 and factory_calls == 2 and state == "degraded"
            assert all("DEGRADED_CPU_HEURISTIC" in r for r in reasons)
            assert transitions[:2] == [psup.OPEN, psup.HALF_OPEN]
        else:
            assert rebuilds == 1 and factory_calls == 2 and state == "serving"
            assert transitions == [psup.OPEN, psup.HALF_OPEN, psup.CLOSED]
    finally:
        _close(built)


def test_brownout_unavailable_with_pushback(tmp_path, monkeypatch):
    built = _pair(tmp_path, monkeypatch)
    try:
        jeng, jsupv, _ = built[0]
        peng, psupv, _ = built[1]
        jservice, pservice = jgrpc.RiskGrpcService(jeng), pgrpc.RiskGrpcService(peng)
        jhealth, phealth = jgrpc.HealthServicer(), pgrpc.HealthServicer()
        jsupv.bind(health=jhealth, metrics=jservice.metrics)
        psupv.bind(health=phealth, metrics=pservice.metrics)
        req = risk_pb2.ScoreTransactionRequest(account_id="lg-1", amount=500,
                                               transaction_type="deposit")
        handler = jgrpc._rpc(jservice.metrics, "ScoreTransaction", jservice.ScoreTransaction)
        for sup in (jsupv, psupv):
            sup.force_brownout("test")
        ctx = JaxContext()
        with pytest.raises(JaxAborted) as jexc:
            handler(req, ctx)
        with pytest.raises(pgrpc.RpcAbort) as pexc:
            pservice.call("ScoreTransaction", req.SerializeToString())
        assert jexc.value.args[0] == pexc.value.code.name == "UNAVAILABLE"
        assert ctx.trailing == pexc.value.trailing == (("grpc-retry-pushback-ms", "250"),)
        assert (jhealth._status[""], phealth.status("")) == (jgrpc.NOT_SERVING,
                                                            pgrpc.NOT_SERVING)
        assert (pservice.metrics.serving_state.value(), jservice.metrics.serving_state.value()) \
            == (2, 2)
        assert (pservice.metrics.requests_total.value(method="ScoreTransaction",
                                                      code="UNAVAILABLE")
                == jservice.metrics.requests_total.value(method="ScoreTransaction",
                                                         code="UNAVAILABLE") == 1)
        for sup in (jsupv, psupv):
            sup.clear_brownout()
        assert jsupv.state == psupv.state == "serving"
        assert phealth.status("") == pgrpc.SERVING
        pservice.call("ScoreTransaction", req.SerializeToString())
        pservice.close()
    finally:
        _close(built)


def test_concurrent_wedge_trips_one_rebuild(tmp_path, monkeypatch):
    """Four callers wedged at once: each fails loudly, one rebuild runs."""
    calls: list = []
    built = _pair(tmp_path, monkeypatch, factory_calls=calls, watchdog_s=0.3)
    peng, psupv, _ = built[1]
    _, preqs = requests(4)
    try:
        pchaos.install("seed=1;device.readback=wedge:p=1.0:ms=700:count=8")
        errors = []

        def one(r):
            try:
                peng.score(r)
            except psup.DeviceWedgedError as exc:
                errors.append(exc)

        threads = [threading.Thread(target=one, args=(r,)) for r in preqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        deadline = time.monotonic() + 30
        while peng._rebuilding and time.monotonic() < deadline:
            time.sleep(0.02)
        assert errors and calls[1][0] == 2 and peng.rebuilds == 1
    finally:
        _close(built)


@pytest.mark.parametrize("probe", ["score_batch_wire_bytes", "expired_deadline", "malformed"])
def test_half_open_probe_always_gets_a_verdict(probe):
    """The port's breaker never sticks half-open: a ScoreBatch probe that
    passes closes it (the JAX wrapper notes no pass on that path), and a
    probe that ends without a verdict (a spent deadline, a malformed
    request) hands the probe back, so the next call probes."""
    from igaming_platform_tpu_torch.serve.deadline import Deadline, DeadlineExpired
    from igaming_platform_tpu_torch.serve.native_store import NativeFeatureStore
    from igaming_platform_tpu_torch.serve.scorer import ScoreRequest

    store = NativeFeatureStore(max_accounts=1000, clock=lambda: 1_700_000_000.0)
    sup = psup.ServingSupervisor(failure_threshold=2, open_s=60.0)
    eng = psup.SupervisedScoringEngine(
        lambda: TorchScoringEngine(feature_store=store, device="cpu",
                                   batcher_config=BatcherConfig(batch_size=16, max_wait_ms=1.0)),
        supervisor=sup)
    payload = risk_pb2.ScoreBatchRequest(transactions=[risk_pb2.ScoreTransactionRequest(
        account_id=f"a{i}", amount=100 * i, transaction_type="bet") for i in range(5)])
    try:
        device = sup.breaker("device")
        device.force_open("test")
        device.clear_forced()
        assert device.state == psup.HALF_OPEN
        if probe == "score_batch_wire_bytes":
            _, n = eng.score_batch_wire_bytes(payload.SerializeToString())
            assert n == 5
        elif probe == "expired_deadline":
            with pytest.raises(DeadlineExpired):
                eng.score(ScoreRequest("a1", amount=5), deadline=Deadline.after_ms(0))
            assert device.state == psup.HALF_OPEN
            eng.score(ScoreRequest("a1", amount=5))
        else:
            with pytest.raises(ValueError):
                eng.score_batch_wire_bytes(b"\xff\xff\xff")
            assert device.state == psup.HALF_OPEN
            eng.score_batch_wire_bytes(payload.SerializeToString())
        assert device.state == psup.CLOSED and sup.state == "serving"
    finally:
        eng.close()
