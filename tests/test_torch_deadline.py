"""Port parity: serve/deadline.py, the batcher over it, obs/perfmodel.py's
step model.

Both packages' schedulers run one submit script under one fake monotonic
clock (each module's ``time`` patched; every Deadline born on that clock):
the pop order across lanes, EDF and aging, the items shed as expired at
pop, at admission and with a spent budget, the expiry counts by stage and
lane, the lane depths and the tightest remaining budget are equal.
``plan_tick`` makes the same choices over the same step models, whose
predictions and stall thresholds are equal; ``BurnShedGate`` follows the
same alert sequence; the metadata parse, ``from_grpc`` and
``outbound_deadline_ms`` agree. Last, rows a port engine scores through its
scheduler (deadlines in every lane, from several threads) equal the
lockstep path's bit for bit: lanes reorder when rows dispatch, never what
they score.
"""

import threading
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from test_torch_ensemble import jax_tree

from igaming_platform_tpu.obs import perfmodel as jperf
from igaming_platform_tpu.serve import deadline as jdl
from igaming_platform_tpu_torch.convert import from_jax_params
from igaming_platform_tpu_torch.core.config import BatcherConfig
from igaming_platform_tpu_torch.obs import perfmodel as pperf
from igaming_platform_tpu_torch.serve import deadline as pdl
from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore
from igaming_platform_tpu_torch.serve.scorer import ScoreRequest, TorchScoringEngine


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t

    def advance_ms(self, ms: float) -> None:
        self.t += ms / 1000.0


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    for mod in (jdl, pdl):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=c.monotonic))
    return c


# (op, args): submit (name, lane, budget_ms or None), tick ms, pop, drain n.
SCENARIOS = {
    "edf": [("submit", "slack", "bulk", 500), ("submit", "tight", "bulk", 50),
            ("submit", "mid", "bulk", 200), ("submit", "none", "bulk", None),
            ("pop",), ("pop",), ("pop",), ("pop",)],
    "lanes": [step for i in range(3) for step in (
        ("submit", f"bg{i}", "background", 5000), ("submit", f"bulk{i}", "bulk", 5000),
        ("submit", f"int{i}", "interactive", 5000))] + [("pop",)] * 9,
    "aging": [("submit", "bulk-old", "bulk", 5000), ("submit", "bg-old", "background", 5000),
              ("tick", 30), ("submit", "int-a", "interactive", 5000),
              ("submit", "int-b", "interactive", 5000), ("pop",), ("tick", 80), ("pop",),
              ("pop",), ("pop",), ("submit", "int-c", "interactive", 40), ("drain", 8)],
    "expiry": [("submit", "dead", "bulk", 5), ("submit", "live", "bulk", 5000),
               ("submit", "dead-int", "interactive", 8), ("tick", 10), ("pop",),
               ("submit", "spent", "interactive", 0), ("submit", "late", "background", 20),
               ("tick", 25), ("drain", 4)],
}


def _run(mod, clock, script):
    """One scheduler through a script: the trace of everything observable."""
    sched = mod.DeadlineScheduler(max_queue=64)
    expired, depth = [], []
    sched.on_expired = lambda n, stage, lane: expired.append((n, stage, lane))
    sched.on_depth = lambda lane, d: depth.append((lane, d))
    futures, trace = {}, []
    for op, *args in script:
        if op == "submit":
            name, lane, budget = args
            ddl = (None if budget is None
                   else mod.Deadline(budget_ms=float(budget), born_at=clock.monotonic()))
            try:
                futures[name] = sched.submit(name, deadline=ddl, lane=lane)
            except mod.DeadlineExpired as exc:
                trace.append(("refused", name, exc.stage))
        elif op == "tick":
            clock.advance_ms(args[0])
        elif op == "pop":
            item = sched.poll(timeout=0)
            trace.append(("pop", None if item is None else item.payload))
        else:
            trace.append(("drain", [it.payload for it in sched.drain(args[0])]))
        trace.append(("tightest", sched.tightest_remaining_ms(), sched.depths()))
    shed = {n: type(f.exception(timeout=0)).__name__ for n, f in futures.items()
            if f.done() and f.exception(timeout=0) is not None}
    stages = {n: f.exception(timeout=0).stage for n, f in futures.items()
              if f.done() and f.exception(timeout=0) is not None}
    return trace, expired, depth, shed, stages


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scheduler_matches_jax(scenario, clock):
    start = clock.t
    want = _run(jdl, clock, SCENARIOS[scenario])
    clock.t = start
    got = _run(pdl, clock, SCENARIOS[scenario])
    assert got == want
    trace, expired, _, shed, _ = got
    pops = [e[1] for e in trace if e[0] == "pop"]
    if scenario == "lanes":
        assert pops == [f"int{i}" for i in range(3)] + [f"bulk{i}" for i in range(3)] + [
            f"bg{i}" for i in range(3)]
    if scenario == "aging":
        assert pops[0] == "bulk-old"  # aged past 25 ms: one pop ahead of interactive
    if scenario == "expiry":
        assert shed == {"dead": "DeadlineExpired", "dead-int": "DeadlineExpired",
                        "late": "DeadlineExpired"}
        assert ("refused", "spent", "admission") in trace
        assert sum(n for n, stage, _ in expired if stage == "dispatch") == 3


def _models(observations):
    jm, pm = jperf.OnlineStepModel(), pperf.OnlineStepModel()
    for shape, ms in observations:
        jm.observe(shape, ms)
        pm.observe(shape, ms)
    return jm, pm


@pytest.mark.parametrize("tightest", [None, 0.0, 3.0, 10.0, 40.0, 500.0])
def test_plan_tick_and_step_model_match_jax(tightest):
    obs = [(64, 2.0), (256, 8.0), (1024, 40.0), (64, 2.6), (256, 7.1), (256, float("nan"))]
    for observations in ([], obs[:1], obs):
        jm, pm = _models(observations)
        for model in ((None, None), (jm, pm)):
            want = jdl.plan_tick(shapes=(64, 256, 1024), tightest_ms=tightest, max_wait_ms=2.0,
                                 step_model=model[0])
            got = pdl.plan_tick(shapes=(64, 256, 1024), tightest_ms=tightest, max_wait_ms=2.0,
                                step_model=model[1])
            assert (got.max_rows, got.window_s, got.shape) == (
                want.max_rows, want.window_s, want.shape)
        for shape in (1, 64, 100, 256, 1024, 4096):
            assert pm.predict_ms(shape) == jm.predict_ms(shape)
            assert pm.stall_threshold_ms(shape) == jm.stall_threshold_ms(shape)
        assert pm.snapshot() == jm.snapshot()


def test_perfmodel_peaks_and_utilization():
    """``peak_for`` reads the card's name; ``utilization`` matches the JAX
    function's arithmetic (a device with no known peak gives null shares)."""
    assert pperf.peak_for("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert pperf.peak_for("cpu") is None and pperf.peak_for("Tesla T4") is None
    cost = {"flops": 3.2e9, "bytes": 5.5e7}
    for seconds in (1e-4, 2.5e-3, 0.0, float("nan")):
        want = jperf.utilization(cost, seconds, types.SimpleNamespace(device_kind="cpu"))
        assert pperf.utilization(cost, seconds, "cpu") == want
    got = pperf.utilization(cost, 1e-4, "NVIDIA H100 80GB HBM3")
    assert got["mfu"] == round(3.2e13 / 989e12, 4) and got["hbm_util"] == round(5.5e11 / 3.35e12, 4)


def test_burn_gate_parse_and_outbound_match_jax(clock):
    alerts = {"fast": False}
    gates = [mod.BurnShedGate(alerts_provider=lambda: alerts, enabled=True,
                              interactive_idle_s=0.05) for mod in (jdl, pdl)]
    seen = []
    for step, (fast, interactive, tick_ms) in enumerate(
            [(True, False, 0), (True, True, 0), (False, False, 10), (True, False, 10),
             (True, False, 60), (True, True, 0)]):
        alerts["fast"] = fast
        clock.advance_ms(tick_ms)
        row = []
        for gate in gates:
            if interactive:
                gate.note_interactive()
            shedding = gate.shedding()
            if shedding:
                gate.note_shed()
            row.append((shedding, gate.stats()))
        assert row[0] == row[1], step
        seen.append(row[1][0])
    assert seen == [False, True, False, True, False, True]

    for raw in (None, "", "abc", "nan", "inf", "-5", "0", "12.5", "1e12", 30, "250"):
        assert pdl.parse_deadline_ms(raw) == jdl.parse_deadline_ms(raw), raw

    class Ctx:
        def __init__(self, md, remaining):
            self.md, self.remaining = md, remaining

        def invocation_metadata(self):
            return self.md

        def time_remaining(self):
            return self.remaining

    for ctx in (None, Ctx((("risk-deadline-ms", "120"),), 5.0), Ctx((("x", "1"),), 0.25),
                Ctx((("risk-deadline-ms", "junk"),), None), Ctx((), 1e9)):
        want, got = jdl.from_grpc(ctx), pdl.from_grpc(ctx)
        assert (got.budget_ms, got.source) == (want.budget_ms, want.source)
    ddl = [mod.Deadline(budget_ms=80.0, born_at=clock.monotonic()) for mod in (jdl, pdl)]
    clock.advance_ms(30.5)
    assert pdl.outbound_deadline_ms(ddl[1]) == jdl.outbound_deadline_ms(ddl[0]) == 49
    assert pdl.outbound_deadline_ms(None) is None


@pytest.mark.parametrize("backend", ["mock", "mlp+gbdt"])
def test_scheduled_rows_bit_equal_lockstep(backend):
    """Rows scored through the port's scheduler (three lanes, deadlines,
    from eight threads, so batches mix lanes and reorder) equal the same
    rows through ``score_batch`` (the lockstep chunk path) bit for bit."""
    tree = jax_tree(backend)
    store = InMemoryFeatureStore(clock=lambda: 1_700_000_000.0)
    engine = TorchScoringEngine(
        ml_backend=backend, params=from_jax_params(backend, tree), feature_store=store,
        device="cpu", batcher_config=BatcherConfig(batch_size=32, max_wait_ms=2.0,
                                                   latency_tiers=(8,)))
    try:
        rng = np.random.default_rng(11)
        reqs = [ScoreRequest(account_id=f"lane-{i % 13}", amount=int(a),
                             tx_type=("deposit", "bet", "withdraw")[i % 3])
                for i, a in enumerate(rng.integers(100, 400_000, 120))]
        want = engine.score_batch(reqs)
        lanes = (pdl.LANE_INTERACTIVE, pdl.LANE_BULK, pdl.LANE_BACKGROUND)
        barrier = threading.Barrier(8)

        def one(i):
            if i < 8:
                barrier.wait()
            return engine.score(reqs[i], deadline=pdl.Deadline.after_ms(5_000 + 37 * (i % 7)),
                                lane=lanes[i % 3])

        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(one, range(len(reqs))))
        for g, w in zip(got, want):
            assert (g.score, g.action, g.rule_score, g.reason_codes) == (
                w.score, w.action, w.rule_score, w.reason_codes)
            assert np.float32(g.ml_score).tobytes() == np.float32(w.ml_score).tobytes()
        snap = engine.deadline_snapshot()
        assert snap["rows_scored"] == len(reqs) and snap["dead_dispatched"] == 0
        assert snap["expired_shed"] == 0 and snap["step_model"]["observations"] > 0
    finally:
        engine.close()
