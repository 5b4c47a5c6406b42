"""Fleet-grade SLO engine — burn rate, error budget, budget attribution.

The port's copy of ``igaming_platform_tpu/obs/slo.py`` (pure Python, kept apart so
the port imports nothing of the JAX package).

The north star is p99 < 50 ms; every request decomposes into stages
(obs/tracing.py), but that alone tracks no SLO *attainment*: are we burning error
budget, how fast, and which stage is eating it. This module is the
per-replica half of the SLO control plane (obs/fleetview.py aggregates
it fleet-wide):

- **Objective**: a latency bound (``SLO_OBJECTIVE_MS``, default 50) with
  an attainment target (``SLO_TARGET``, default 0.99 — i.e. "p99 under
  50 ms"). The error budget is the violating fraction the target allows
  (1 - target).
- **Multi-window burn rate** (the SRE-workbook shape): per-second
  buckets of (requests, violations) roll into a fast (~1 min) and a
  slow (~1 h) window; ``burn = violating_fraction / budget_fraction``,
  so burn 1.0 consumes exactly one budget over the SLO period and
  burn 10 consumes it 10x too fast. The fast window catches a fault in
  seconds; the slow window keeps a blip from paging.
- **Budget attribution**: on *violating* requests only, each stage's
  busy time (the root span's ``stage_totals`` from obs/tracing.py) is
  accumulated per window — "queue wait ate the budget" vs "dispatch
  did" is a ranked table, not a guess. The deadline plane's burn-shed
  gate (serve/deadline.py) reads the alerts.
- **Serving-state annotation**: every sample carries the supervisor's
  serving state at score time (serve/supervisor.py registers the
  provider), so degraded-tier latency is attributed honestly — a
  brownout's violations are visible as brownout violations, not mixed
  into the SERVING budget anonymously.

Wired through the tracing root-span sink (``install`` adds it next to
the flight recorder); scraped as ``risk_slo_*`` metrics and served as
JSON at ``/debug/sloz``.

Failed requests burn budget too: server-fault status codes (INTERNAL,
UNAVAILABLE, DEADLINE_EXCEEDED, ...) count as violations regardless of
latency. Client-fault codes (INVALID_ARGUMENT) and deliberate
backpressure (RESOURCE_EXHAUSTED sheds) do not — admission control
doing its job must not read as an outage.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

from igaming_platform_tpu_torch.obs import tracing

# RPC methods the scoring SLO covers; wallet RPCs and admin surfaces
# have their own latency profile and must not dilute the scoring budget.
_DEFAULT_METHODS = ("ScoreTransaction", "ScoreBatch")

# Status codes that burn budget even when the RPC was fast: the server
# failed the caller. Sheds (RESOURCE_EXHAUSTED) and caller mistakes
# (INVALID_ARGUMENT) are excluded — see module docstring.
_BUDGET_BURNING_CODES = frozenset({
    "INTERNAL", "UNKNOWN", "UNAVAILABLE", "DEADLINE_EXCEEDED",
    "DATA_LOSS", "ERROR",
})


@dataclass(frozen=True)
class SLOConfig:
    objective_ms: float = 50.0
    target: float = 0.99
    fast_window_s: float = 60.0
    slow_window_s: float = 3600.0
    # Burn thresholds that raise each window's alert. The classic page
    # condition is BOTH windows over threshold (the snapshot exposes it
    # as `page`); the fast alert alone is the soak/drill trip-wire.
    fast_burn_alert: float = 10.0
    slow_burn_alert: float = 1.0
    methods: tuple = _DEFAULT_METHODS

    @property
    def budget_fraction(self) -> float:
        return max(1e-9, 1.0 - self.target)

    @classmethod
    def from_env(cls) -> "SLOConfig":
        return cls(
            objective_ms=float(os.environ.get("SLO_OBJECTIVE_MS", "50")),
            target=float(os.environ.get("SLO_TARGET", "0.99")),
            fast_window_s=float(os.environ.get("SLO_FAST_WINDOW_S", "60")),
            slow_window_s=float(os.environ.get("SLO_SLOW_WINDOW_S", "3600")),
            fast_burn_alert=float(os.environ.get("SLO_FAST_BURN_ALERT", "10")),
            slow_burn_alert=float(os.environ.get("SLO_SLOW_BURN_ALERT", "1")),
            methods=tuple(
                m for m in os.environ.get(
                    "SLO_METHODS", ",".join(_DEFAULT_METHODS)).split(",") if m),
        )


@dataclass
class _Bucket:
    """One second of samples. stage_ms accumulates only over VIOLATING
    requests (budget attribution); by_state counts every sample by the
    serving state it was scored under."""

    total: int = 0
    bad: int = 0
    stage_ms: dict = field(default_factory=dict)
    by_state: dict = field(default_factory=dict)
    bad_by_state: dict = field(default_factory=dict)


# Process-global serving-state provider (serve/supervisor.py binds it,
# mirroring serve/ledger.set_state_provider) — engines read it lazily so
# install order between the supervisor and the gRPC service never matters.
_STATE_PROVIDER: Callable[[], str] | None = None


def set_state_provider(fn: Callable[[], str] | None) -> None:
    global _STATE_PROVIDER
    _STATE_PROVIDER = fn


def current_state() -> str | None:
    """The supervisor's serving state right now, or None when no
    supervisor registered (bare-engine deployments)."""
    fn = _STATE_PROVIDER
    if fn is None:
        return None
    try:
        return str(fn())
    except Exception:  # noqa: BLE001 — annotation must not fail the request
        return None


class SLOEngine:
    """Per-replica SLO accounting over per-second buckets.

    O(1) per request (one dict update under a short lock); window sums
    re-derive lazily when the clock crosses a second boundary and on
    snapshot, so gauges stay fresh without a per-request window scan.
    """

    def __init__(self, config: SLOConfig | None = None, *, metrics=None,
                 state_provider: Callable[[], str] | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 max_exemplars: int = 32):
        self.config = config or SLOConfig.from_env()
        self.metrics = metrics
        self.state_provider = state_provider
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: dict[int, _Bucket] = {}
        self._started_at = clock()
        self._last_refresh_sec = -1
        # Lifetime totals (survive bucket expiry; the artifact's "how
        # much budget did this run burn" figure).
        self.requests_total = 0
        self.violations_total = 0
        # Worst recent violations, trace-id keyed — the sloz page's
        # click-through into /debug/flightz.
        self._exemplars: deque = deque(maxlen=max_exemplars)
        # window -> alert currently active; events log (bounded) of
        # raise/clear transitions for artifacts.
        self._alerts = {"fast": False, "slow": False}
        self._events: deque = deque(maxlen=256)

    # -- ingestion -----------------------------------------------------------

    def observe_root(self, span) -> None:
        """Tracing root-span sink: one completed rpc.* root = one sample."""
        name = getattr(span, "name", "")
        if not name.startswith("rpc.") or name[4:] not in self.config.methods:
            return
        code = str(span.attributes.get("code", "OK"))
        state = span.attributes.get("serving_state") or self._state()
        # Deliberate sheds never burn budget, whatever their status code:
        # an expired-at-admission DEADLINE_EXCEEDED (serve/deadline.py)
        # is admission control doing its job — the root span carries the
        # `shed` attribute so it is distinguishable from the server
        # actually blowing a caller's deadline (which DOES burn).
        shed = bool(span.attributes.get("shed"))
        self.observe(
            span.duration_ms,
            stages=span.stage_totals,
            state=state,
            trace_id=span.trace_id,
            errored=(code in _BUDGET_BURNING_CODES) and not shed,
        )

    def _state(self) -> str:
        if self.state_provider is not None:
            try:
                return str(self.state_provider())
            except Exception:  # noqa: BLE001 — annotation must not fail the request
                return "unknown"
        return current_state() or "unknown"

    def observe(self, latency_ms: float, *, stages: dict | None = None,
                state: str | None = None, trace_id: str = "",
                errored: bool = False) -> None:
        state = state or "unknown"
        violating = errored or latency_ms > self.config.objective_ms
        now = self._clock()
        sec = int(now)
        top_stage = None
        with self._lock:
            bucket = self._buckets.get(sec)
            if bucket is None:
                bucket = self._buckets.setdefault(sec, _Bucket())
                self._prune(sec)
            bucket.total += 1
            bucket.by_state[state] = bucket.by_state.get(state, 0) + 1
            self.requests_total += 1
            if violating:
                bucket.bad += 1
                bucket.bad_by_state[state] = (
                    bucket.bad_by_state.get(state, 0) + 1)
                self.violations_total += 1
                for stage, ms in (stages or {}).items():
                    bucket.stage_ms[stage] = (
                        bucket.stage_ms.get(stage, 0.0) + ms)
                if stages:
                    top_stage = max(stages, key=stages.get)
                self._exemplars.append({
                    "t": round(now - self._started_at, 3),
                    "trace_id": trace_id,
                    "latency_ms": round(latency_ms, 3),
                    "errored": errored,
                    "state": state,
                    "top_stage": top_stage,
                })
        if self.metrics is not None:
            self.metrics.slo_requests_total.inc(state=state)
            if violating:
                self.metrics.slo_violations_total.inc(state=state)
                for stage, ms in (stages or {}).items():
                    self.metrics.slo_budget_stage_ms_total.inc(ms, stage=stage)
        # Refresh window gauges + alert state at most once per second —
        # the window scan (≤ slow_window_s buckets) stays off the
        # per-request path in steady state.
        if sec != self._last_refresh_sec:
            self._last_refresh_sec = sec
            self.refresh(now)

    def _prune(self, now_sec: int) -> None:
        """Caller holds the lock. Drop buckets older than the slow
        window (+1 s of slack for boundary samples)."""
        horizon = now_sec - int(self.config.slow_window_s) - 1
        if len(self._buckets) > self.config.slow_window_s + 2:
            for sec in [s for s in self._buckets if s < horizon]:
                del self._buckets[sec]

    # -- window math ---------------------------------------------------------

    def _window_counts(self, window_s: float, now: float) -> tuple[int, int]:
        """(total, bad) over buckets within ``window_s`` of ``now``.
        Caller holds the lock."""
        lo = now - window_s
        total = bad = 0
        for sec, bucket in self._buckets.items():
            if sec >= lo - 1 and sec <= now:
                total += bucket.total
                bad += bucket.bad
        return total, bad

    def burn_rate(self, window_s: float, now: float | None = None) -> float:
        now = self._clock() if now is None else now
        with self._lock:
            total, bad = self._window_counts(window_s, now)
        if total == 0:
            return 0.0
        return (bad / total) / self.config.budget_fraction

    def attainment(self, window_s: float, now: float | None = None) -> float:
        now = self._clock() if now is None else now
        with self._lock:
            total, bad = self._window_counts(window_s, now)
        if total == 0:
            return 1.0
        return 1.0 - bad / total

    def attribution(self, window_s: float, now: float | None = None) -> dict:
        """Ranked per-stage budget attribution over the window: stage ->
        {ms, share} across violating requests, plus the top consumer."""
        now = self._clock() if now is None else now
        lo = now - window_s
        agg: dict[str, float] = {}
        with self._lock:
            for sec, bucket in self._buckets.items():
                if sec >= lo - 1 and sec <= now:
                    for stage, ms in bucket.stage_ms.items():
                        agg[stage] = agg.get(stage, 0.0) + ms
        total_ms = sum(agg.values())
        ranked = sorted(agg.items(), key=lambda kv: kv[1], reverse=True)
        return {
            "stages": {
                stage: {"ms": round(ms, 3),
                        "share": round(ms / total_ms, 4) if total_ms else 0.0}
                for stage, ms in ranked
            },
            "top_stage": ranked[0][0] if ranked else None,
        }

    # -- alerts + snapshot ---------------------------------------------------

    def refresh(self, now: float | None = None) -> dict:
        """Recompute window burns, flip alert state, push gauges.
        Returns {window: burn}."""
        now = self._clock() if now is None else now
        burns = {
            "fast": self.burn_rate(self.config.fast_window_s, now),
            "slow": self.burn_rate(self.config.slow_window_s, now),
        }
        thresholds = {
            "fast": self.config.fast_burn_alert,
            "slow": self.config.slow_burn_alert,
        }
        for window, burn in burns.items():
            active = burn >= thresholds[window]
            fire_metric = False
            with self._lock:
                if active != self._alerts[window]:
                    self._alerts[window] = active
                    self._events.append({
                        "t": round(now - self._started_at, 3),
                        "window": window,
                        "event": "raised" if active else "cleared",
                        "burn": round(burn, 3),
                    })
                    fire_metric = active
            if self.metrics is not None:
                self.metrics.slo_burn_rate.set(burn, window=window)
                self.metrics.slo_attainment.set(
                    self.attainment(
                        self.config.fast_window_s if window == "fast"
                        else self.config.slow_window_s, now),
                    window=window)
                self.metrics.slo_alert.set(1.0 if active else 0.0,
                                           window=window)
                if fire_metric:
                    self.metrics.slo_alerts_total.inc(window=window)
        return burns

    def alerts_active(self) -> dict:
        with self._lock:
            return dict(self._alerts)

    def snapshot(self) -> dict:
        """The /debug/sloz payload."""
        now = self._clock()
        burns = self.refresh(now)
        with self._lock:
            alerts = dict(self._alerts)
            events = list(self._events)
            exemplars = list(self._exemplars)
            by_state: dict[str, dict[str, int]] = {}
            for bucket in self._buckets.values():
                for state, n in bucket.by_state.items():
                    row = by_state.setdefault(state, {"requests": 0, "violations": 0})
                    row["requests"] += n
                for state, n in bucket.bad_by_state.items():
                    by_state.setdefault(state, {"requests": 0, "violations": 0})[
                        "violations"] += n
            requests_total = self.requests_total
            violations_total = self.violations_total
        cfg = self.config
        return {
            "objective_ms": cfg.objective_ms,
            "target": cfg.target,
            "budget_fraction": cfg.budget_fraction,
            "methods": list(cfg.methods),
            "uptime_s": round(now - self._started_at, 3),
            "requests_total": requests_total,
            "violations_total": violations_total,
            "windows": {
                "fast": {
                    "window_s": cfg.fast_window_s,
                    "burn_rate": round(burns["fast"], 4),
                    "attainment": round(
                        self.attainment(cfg.fast_window_s, now), 6),
                    "alert_threshold": cfg.fast_burn_alert,
                    "alert": alerts["fast"],
                    "budget_attribution": self.attribution(
                        cfg.fast_window_s, now),
                },
                "slow": {
                    "window_s": cfg.slow_window_s,
                    "burn_rate": round(burns["slow"], 4),
                    "attainment": round(
                        self.attainment(cfg.slow_window_s, now), 6),
                    "alert_threshold": cfg.slow_burn_alert,
                    "alert": alerts["slow"],
                    "budget_attribution": self.attribution(
                        cfg.slow_window_s, now),
                },
            },
            # Classic multi-window page condition: both windows burning.
            "page": alerts["fast"] and alerts["slow"],
            "by_state": by_state,
            "alert_events": events,
            "violating_exemplars": exemplars,
        }

    def summary_block(self) -> dict:
        """Compact per-arm artifact block (bench.py / load_gen)."""
        snap = self.snapshot()
        fast = snap["windows"]["fast"]
        return {
            "objective_ms": snap["objective_ms"],
            "target": snap["target"],
            "requests": snap["requests_total"],
            "violations": snap["violations_total"],
            "attainment": (
                round(1.0 - snap["violations_total"] / snap["requests_total"], 6)
                if snap["requests_total"] else 1.0),
            "fast_burn_rate": fast["burn_rate"],
            "slow_burn_rate": snap["windows"]["slow"]["burn_rate"],
            "top_budget_stage": fast["budget_attribution"]["top_stage"]
            or snap["windows"]["slow"]["budget_attribution"]["top_stage"],
            "alerts": {"fast": fast["alert"],
                       "slow": snap["windows"]["slow"]["alert"]},
        }


# ---------------------------------------------------------------------------
# Process-default engine (the one /debug/sloz and bench arms read)

DEFAULT: SLOEngine | None = None


def install(engine: SLOEngine) -> SLOEngine:
    """Make ``engine`` the process default and bind it to the tracing
    root-sink fan-out (replacing any previously installed engine — one
    serving engine per process in every deployment shape, the same
    contract as the metrics span sink)."""
    global DEFAULT
    if DEFAULT is not None:
        tracing.remove_root_sink(DEFAULT.observe_root)
    DEFAULT = engine
    tracing.add_root_sink(engine.observe_root)
    return engine


def uninstall() -> None:
    global DEFAULT
    if DEFAULT is not None:
        tracing.remove_root_sink(DEFAULT.observe_root)
        DEFAULT = None


def get_default() -> SLOEngine | None:
    return DEFAULT
