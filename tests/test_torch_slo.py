"""Port parity: obs/slo.py, the SLO engine.

One synthetic stream of completed root spans (seeded: latencies around the
objective, stage totals, status codes, sheds, serving states, methods in
and out of scope) goes into the JAX package's ``SLOEngine`` and the port's,
each bound to its own ``ServiceMetrics``, under one fake clock with short
windows. After every second of the stream both agree on the burn rates, the
attainment, the alert state and its transitions, the budget attribution and
the per-state counts (``snapshot()``), and at the end on every ``slo_*``
series of the exposition. A shed never burns budget, whatever its code; the
stream's fast-window alert both raises and clears. The same spans through
each package's tracing root sink (``install``) reach the engine the same
way.
"""

import numpy as np
import pytest

from igaming_platform_tpu.obs import metrics as jmetrics
from igaming_platform_tpu.obs import slo as jslo
from igaming_platform_tpu.obs import tracing as jtracing
from igaming_platform_tpu_torch.obs import metrics as pmetrics
from igaming_platform_tpu_torch.obs import slo as pslo
from igaming_platform_tpu_torch.obs import tracing as ptracing

CODES = ("OK", "OK", "OK", "INTERNAL", "UNAVAILABLE", "DEADLINE_EXCEEDED", "RESOURCE_EXHAUSTED",
         "INVALID_ARGUMENT")
METHODS = ("ScoreTransaction", "ScoreBatch", "PredictLTV")
STATES = ("serving", "degraded", None)


def _stream(seed: int, seconds: int, per_second: int):
    """Per second, the spans' fields: (method, ms, code, shed, state, stages)."""
    rng = np.random.default_rng(seed)
    out = []
    for sec in range(seconds):
        # A burst of slow, failing traffic in the middle raises the fast alert.
        burst = seconds // 3 <= sec < seconds // 2
        rows = []
        for _ in range(per_second):
            ms = float(rng.gamma(2.0, 40.0 if burst else 8.0))
            code = CODES[rng.integers(0, len(CODES))] if rng.random() < 0.3 else "OK"
            stages = {"score.dispatch": round(ms * 0.4, 3), "score.readback": round(ms * 0.3, 3)}
            if rng.random() < 0.5:
                stages["score.queue"] = round(ms * 0.2, 3)
            rows.append((METHODS[rng.integers(0, 3)], ms, code, bool(rng.random() < 0.15),
                         STATES[rng.integers(0, 3)], stages))
        out.append(rows)
    return out


def _span(tracing, method, ms, code, shed, state, stages, t):
    attrs = {"code": code}
    if shed:
        attrs["shed"] = 1
    if state is not None:
        attrs["serving_state"] = state
    s = tracing.Span(name=f"rpc.{method}", start=t, end=t + ms / 1000.0, mono_start=t,
                     mono_end=t + ms / 1000.0, trace_id=f"{int(t * 1000):032x}",
                     span_id="0" * 15 + "1", attributes=attrs)
    s.stage_totals = dict(stages)
    s.root = s
    return s


def _slo_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if "_slo_" in ln]


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_engine_matches_jax(seed):
    now = [5000.0]
    cfg = dict(objective_ms=50.0, target=0.95, fast_window_s=5.0, slow_window_s=30.0,
               fast_burn_alert=4.0, slow_burn_alert=1.0)
    engines = []
    for slo_mod, metrics_mod in ((jslo, jmetrics), (pslo, pmetrics)):
        m = metrics_mod.ServiceMetrics("risk")
        engines.append((slo_mod.SLOEngine(slo_mod.SLOConfig(**cfg), metrics=m,
                                          state_provider=lambda: "serving",
                                          clock=lambda: now[0]), m))
    raised = cleared = 0
    for sec, rows in enumerate(_stream(seed, 24, 40)):
        for i, row in enumerate(rows):
            now[0] = 5000.0 + sec + i / len(rows)
            for (eng, _), tracing in zip(engines, (jtracing, ptracing)):
                eng.observe_root(_span(tracing, *row, now[0]))
        snaps = [eng.snapshot() for eng, _ in engines]
        assert snaps[1] == snaps[0], sec
        for ev in snaps[1]["alert_events"]:
            raised += ev["event"] == "raised" and ev["window"] == "fast"
            cleared += ev["event"] == "cleared" and ev["window"] == "fast"
        assert engines[1][0].alerts_active() == engines[0][0].alerts_active()
    assert raised and cleared, "the stream raises and clears the fast alert"
    assert _slo_lines(engines[1][1].registry.render_text()) == _slo_lines(
        engines[0][1].registry.render_text())


@pytest.mark.parametrize("code", ["DEADLINE_EXCEEDED", "RESOURCE_EXHAUSTED", "UNAVAILABLE"])
def test_sheds_stay_out_of_the_budget(code):
    """Through each package's root sink: a shed of any code burns nothing;
    the same code unshed burns exactly where the JAX engine's does."""
    now = [100.0]
    out = []
    for slo_mod, tracing in ((jslo, jtracing), (pslo, ptracing)):
        eng = slo_mod.install(slo_mod.SLOEngine(slo_mod.SLOConfig(), clock=lambda: now[0]))
        try:
            for shed in (True, False):
                with tracing.span("rpc.ScoreTransaction") as s:
                    s.attributes["code"] = code
                    if shed:
                        s.attributes["shed"] = 1
            out.append((eng.requests_total, eng.violations_total))
        finally:
            slo_mod.uninstall()
    assert out[1] == out[0]
    assert out[1] == (2, 0 if code == "RESOURCE_EXHAUSTED" else 1)
