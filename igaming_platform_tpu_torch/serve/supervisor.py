"""Self-healing serving supervisor: breakers, watchdog, degraded scoring.

The port's counterpart of ``igaming_platform_tpu/serve/supervisor.py``. The
serving front stays up through a device step that never returns, a
feature-store outage and a failing dependency: a fraud scorer degrades to a
CONSERVATIVE answer rather than go dark.

Three layers:

- :class:`CircuitBreaker`: per-dependency (device step, feature store,
  AMQP, ledger) failure counting with OPEN -> HALF_OPEN probe recovery;
  state lands in ``risk_breaker_state{dep}``.
- :class:`ServingSupervisor`: folds breaker states into the serving state
  machine **SERVING -> DEGRADED -> BROWNOUT**, exposed via the health
  service (BROWNOUT flips NOT_SERVING), ``/debug/supervisorz`` and the
  ``risk_serving_state`` gauge.
- :class:`SupervisedScoringEngine`: wraps the real engine behind the
  breakers. A **device-step watchdog** fails a wedged in-flight window
  loudly (:class:`DeviceWedgedError` -> UNAVAILABLE + retry-pushback
  metadata), and a background rebuild builds a new engine through the
  factory, which replays the warm-up (the forest and dense kernels launch
  again). While the device circuit is open, ``score``/``score_batch`` and
  the row wire paths answer from the CPU **heuristic tier** (same wire
  shape, flagged by the ``DEGRADED_CPU_HEURISTIC`` reason code, a model
  version suffix and ``risk_degraded_responses_total``; never an error).

On a card a kernel cannot be cancelled, so nothing here synchronizes the
device or a stream on the serving path: a wedged window is abandoned, its
engine closed on a thread of its own, and the rebuilt engine launches on a
new stream. While the old engine lives the card holds both engines'
tables. Chaos plans (``serve/chaos.py``) fire at the seams these breakers
guard (``device.dispatch``, ``device.readback``, ``feature_store.gather``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Callable

import numpy as np

from igaming_platform_tpu_torch.core.enums import (
    ACTION_APPROVE,
    ACTION_BLOCK,
    ACTION_REVIEW,
    REASON_BIT_ORDER,
    ReasonCode,
    action_from_code,
    decode_reason_mask,
)
from igaming_platform_tpu_torch.core.features import F, NUM_FEATURES, FeatureVector
from igaming_platform_tpu_torch.obs import tracing

logger = logging.getLogger(__name__)

# Breaker states (the ``risk_breaker_state{dep}`` gauge values).
CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_BREAKER_NAMES = {CLOSED: "closed", HALF_OPEN: "half_open", OPEN: "open"}

# Serving states (the ``risk_serving_state`` gauge values).
SERVING, DEGRADED, BROWNOUT = "serving", "degraded", "brownout"
STATE_CODE = {SERVING: 0, DEGRADED: 1, BROWNOUT: 2}

# Retry-pushback hint sent with UNAVAILABLE aborts: long enough for a
# breaker's open window to elapse, short enough that clients re-probe
# promptly once it does.
RETRY_PUSHBACK_MS = 250


class DeviceWedgedError(RuntimeError):
    """The device-step watchdog tripped: dispatch->readback exceeded the
    deadline (a device step that never returns). The in-flight window is failed
    LOUDLY — the gRPC layer maps this to UNAVAILABLE with retry-pushback
    metadata — while the supervisor tears down and rebuilds the engine."""


class ServingUnavailable(RuntimeError):
    """No servable answer on this path even degraded (BROWNOUT, or a wire
    path whose degraded fallback also failed). gRPC maps it to
    UNAVAILABLE + retry-pushback; it must never be silently retried
    in-process — capacity is exactly what the front is out of."""


# ---------------------------------------------------------------------------
# Circuit breaker


class CircuitBreaker:
    """Per-dependency failure tracking with half-open probe recovery.

    CLOSED -> (``failure_threshold`` consecutive failures, or one
    ``fatal``) -> OPEN -> (``open_s`` elapsed) -> HALF_OPEN ->
    (probe success) -> CLOSED / (probe failure) -> OPEN again.
    ``force_open`` pins the breaker open until ``clear_forced`` or
    ``reset`` (the operator override and the rebuild hold)."""

    def __init__(self, name: str, *, failure_threshold: int = 3,
                 open_s: float = 2.0, half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 on_state_change: Callable[["CircuitBreaker", int], None] | None = None):
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.open_s = open_s
        self.half_open_probes = max(1, half_open_probes)
        self.on_state_change = on_state_change
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probes_out = 0
        self._forced: str | None = None
        self.last_error: str | None = None
        self.opens_total = 0
        self.failures_total = 0

    # -- state transitions (callback fires OUTSIDE the lock) -----------------

    def _transition(self, state: int) -> Callable[[], None] | None:
        """Caller holds the lock; returns the deferred callback."""
        if state == self._state:
            return None
        if state == OPEN:
            self.opens_total += 1
            self._opened_at = self._clock()
        if state == HALF_OPEN:
            self._probes_out = 0
        self._state = state
        cb = self.on_state_change
        if cb is None:
            return None
        return lambda: cb(self, state)

    @staticmethod
    def _fire(deferred: Callable[[], None] | None) -> None:
        if deferred is not None:
            try:
                deferred()
            except Exception:  # noqa: BLE001 — state sinks must not fail serving
                logger.warning("breaker state sink failed", exc_info=True)

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    @property
    def state_name(self) -> str:
        return _BREAKER_NAMES[self.state]

    def allow(self) -> bool:
        """May a real dependency call go through right now? OPEN flips to
        HALF_OPEN once the open window elapses, admitting up to
        ``half_open_probes`` concurrent probe calls."""
        deferred = None
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._forced is not None or (
                        self._clock() - self._opened_at < self.open_s):
                    return False
                deferred = self._transition(HALF_OPEN)
            allowed = self._probes_out < self.half_open_probes
            if allowed:
                self._probes_out += 1
        self._fire(deferred)
        return allowed

    def record_success(self) -> None:
        deferred = None
        with self._lock:
            self._consecutive_failures = 0
            # A success closes from HALF_OPEN (the probe passed) and also
            # from un-forced OPEN: dependencies like the feature store are
            # exercised inline by the main path rather than gated by
            # allow(), so a real pass is valid health evidence whenever
            # it arrives. Forced holds (operator, rebuild) stay pinned.
            if self._state in (HALF_OPEN, OPEN) and self._forced is None:
                deferred = self._transition(CLOSED)
        self._fire(deferred)

    def record_failure(self, error: BaseException | str | None = None,
                       fatal: bool = False) -> None:
        deferred = None
        with self._lock:
            self.failures_total += 1
            self._consecutive_failures += 1
            if error is not None:
                self.last_error = repr(error)[:300]
            if (fatal or self._state == HALF_OPEN
                    or self._consecutive_failures >= self.failure_threshold):
                deferred = self._transition(OPEN)
        self._fire(deferred)

    def release_probe(self) -> None:
        """Hand back a half-open probe that ended without a verdict (the
        caller's deadline shed it, or its request was malformed): the next
        call may probe. The JAX breaker has no such release, so there a
        probe that ends so holds the breaker half-open for good."""
        with self._lock:
            if self._state == HALF_OPEN and self._probes_out > 0:
                self._probes_out -= 1

    def force_open(self, reason: str) -> None:
        """Pin open (operator override / engine-rebuild hold): no probes
        until ``clear_forced``/``reset``."""
        with self._lock:
            self._forced = reason
            self.last_error = reason
            deferred = self._transition(OPEN)
        self._fire(deferred)

    def clear_forced(self) -> None:
        """Release a forced-open hold into HALF_OPEN — the dependency must
        re-earn CLOSED through a probe, not be declared healthy."""
        with self._lock:
            if self._forced is None:
                return
            self._forced = None
            deferred = self._transition(HALF_OPEN)
        self._fire(deferred)

    def reset(self) -> None:
        """Operator 'clear': straight to CLOSED (runbook: after the
        dependency is confirmed healthy out-of-band)."""
        with self._lock:
            self._forced = None
            self._consecutive_failures = 0
            deferred = self._transition(CLOSED)
        self._fire(deferred)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": _BREAKER_NAMES[self._state],
                "consecutive_failures": self._consecutive_failures,
                "failures_total": self.failures_total,
                "opens_total": self.opens_total,
                "forced": self._forced,
                "last_error": self.last_error,
                "open_age_s": (
                    round(self._clock() - self._opened_at, 3)
                    if self._state == OPEN else None),
            }


# ---------------------------------------------------------------------------
# Serving state machine


class ServingSupervisor:
    """Folds per-dependency breakers into SERVING/DEGRADED/BROWNOUT.

    - **SERVING**: every dependency breaker CLOSED.
    - **DEGRADED**: a serving dependency (device / multihost / feature
      store) is OPEN or probing HALF_OPEN — answers still flow, through
      the heuristic tier or single-host-mesh mode, flagged not errored.
    - **BROWNOUT**: the degraded tier itself is failing (its breaker
      OPEN) or an operator forced it — scoring RPCs shed UNAVAILABLE
      with retry-pushback; health flips NOT_SERVING.
    """

    SERVING_DEPS = ("device", "multihost", "feature_store")

    def __init__(self, *, failure_threshold: int | None = None,
                 open_s: float | None = None,
                 on_state_change: Callable[[str], None] | None = None):
        if failure_threshold is None:
            failure_threshold = int(os.environ.get("BREAKER_FAILURE_THRESHOLD", "3"))
        if open_s is None:
            open_s = float(os.environ.get("BREAKER_OPEN_S", "2.0"))
        self._failure_threshold = failure_threshold
        self._open_s = open_s
        self._lock = threading.Lock()
        self._state = SERVING
        self._forced_brownout: str | None = None
        self._health = None
        self._metrics = None
        self.on_state_change = on_state_change
        self.breakers: dict[str, CircuitBreaker] = {}
        # `amqp` and `ledger` are non-serving dependencies: their outages
        # never degrade the serving state — events queue and decisions
        # drop-counted/spill respectively, scoring keeps answering.
        for dep in (*self.SERVING_DEPS, "amqp", "ledger", "degraded_tier"):
            self.breakers[dep] = CircuitBreaker(
                dep, failure_threshold=failure_threshold, open_s=open_s,
                on_state_change=self._on_breaker_change)

    def breaker(self, dep: str) -> CircuitBreaker:
        br = self.breakers.get(dep)
        if br is None:
            br = CircuitBreaker(
                dep, failure_threshold=self._failure_threshold,
                open_s=self._open_s, on_state_change=self._on_breaker_change)
            self.breakers[dep] = br
        return br

    # -- state ---------------------------------------------------------------

    def _compute_state(self) -> str:
        if self._forced_brownout is not None:
            return BROWNOUT
        if self.breakers["degraded_tier"].state == OPEN:
            return BROWNOUT
        for dep in self.SERVING_DEPS:
            if self.breakers[dep].state != CLOSED:
                return DEGRADED
        return SERVING

    def _on_breaker_change(self, breaker: CircuitBreaker, state: int) -> None:
        metrics = self._metrics
        if metrics is not None:
            metrics.breaker_state.set(state, dep=breaker.name)
        logger.warning("breaker %s -> %s (%s)", breaker.name,
                       _BREAKER_NAMES[state], breaker.last_error)
        self._recompute()

    def _recompute(self) -> None:
        with self._lock:
            new = self._compute_state()
            if new == self._state:
                return
            old, self._state = self._state, new
        logger.warning("serving state %s -> %s", old, new)
        metrics = self._metrics
        if metrics is not None:
            metrics.serving_state.set(STATE_CODE[new])
        self._apply_health(new)
        if self.on_state_change is not None:
            try:
                self.on_state_change(new)
            except Exception:  # noqa: BLE001 — state sinks must not fail serving
                logger.warning("serving-state sink failed", exc_info=True)

    def _apply_health(self, state: str) -> None:
        health = self._health
        if health is None:
            return
        from igaming_platform_tpu_torch.serve.grpc_server import NOT_SERVING as H_NOT
        from igaming_platform_tpu_torch.serve.grpc_server import SERVING as H_OK

        # DEGRADED keeps answering (that is its whole point), so health
        # stays SERVING; only BROWNOUT — nothing servable — goes dark.
        health.set("", H_NOT if state == BROWNOUT else H_OK)

    @property
    def state(self) -> str:
        with self._lock:
            # Recheck lazily: an OPEN breaker whose window elapsed flips
            # to HALF_OPEN only on the next allow(), so state is computed
            # from breaker states at read time.
            return self._state

    @property
    def state_code(self) -> int:
        return STATE_CODE[self.state]

    @property
    def metrics(self):
        """The bound ServiceMetrics registry (None until bind)."""
        return self._metrics

    def force_brownout(self, reason: str) -> None:
        with self._lock:
            self._forced_brownout = reason
        self._recompute()

    def clear_brownout(self) -> None:
        with self._lock:
            self._forced_brownout = None
        self._recompute()

    # -- wiring ----------------------------------------------------------------

    def bind(self, health=None, metrics=None) -> None:
        """Attach the health servicer and/or a ServiceMetrics registry;
        current state is pushed immediately so a freshly-scraped gauge
        never reads the default 0 while degraded."""
        # SLO-plane annotation (obs/slo.py): every scoring sample is
        # stamped with the serving state it was scored under, so a
        # degraded window's latency burns budget AS degraded latency —
        # same registration pattern as ledger.set_state_provider.
        from igaming_platform_tpu_torch.obs import slo as _slo

        _slo.set_state_provider(lambda: self.state)
        if health is not None:
            self._health = health
            self._apply_health(self.state)
        if metrics is not None:
            self._metrics = metrics
            metrics.serving_state.set(self.state_code)
            for dep, br in self.breakers.items():
                metrics.breaker_state.set(br.state, dep=dep)

    def force_breaker(self, dep: str, action: str) -> None:
        """Operator surface (POST /debug/breakers): ``open`` pins a
        breaker open, ``clear`` resets it, ``probe`` releases a forced
        hold into HALF_OPEN."""
        br = self.breaker(dep)
        if action == "open":
            br.force_open("operator force-open")
        elif action == "clear":
            br.reset()
        elif action == "probe":
            br.clear_forced()
        else:
            raise ValueError(f"unknown breaker action {action!r} "
                             "(use open|clear|probe)")

    def snapshot(self) -> dict:
        with self._lock:
            state = self._state
            forced = self._forced_brownout
        return {
            "state": state,
            "state_code": STATE_CODE[state],
            "forced_brownout": forced,
            "breakers": {d: b.snapshot() for d, b in self.breakers.items()},
        }


# ---------------------------------------------------------------------------
# Degraded scoring tier (the CPU heuristic fallback)


def heuristic_scores(x: np.ndarray, bl: np.ndarray, thresholds) -> dict[str, np.ndarray]:
    """Vectorized conservative scoring over a [N, 30] feature matrix, with
    the compiled step's result-dict contract: a blatant-pattern rule set
    that blocks the obvious fraud and approves the rest. ``thresholds`` is
    the host (block, review) pair."""
    x = np.asarray(x, dtype=np.float32)
    bl = np.asarray(bl, dtype=bool)
    n = x.shape[0]
    score = np.zeros((n,), dtype=np.float32)
    mask = np.zeros((n,), dtype=np.int32)

    def rule(cond: np.ndarray, points: float, code: ReasonCode) -> None:
        cond = np.asarray(cond, dtype=bool)
        score[cond] += points
        mask[cond] |= 1 << REASON_BIT_ORDER.index(code)

    rule(x[:, F.TX_COUNT_1M] > 10, 30.0, ReasonCode.HIGH_VELOCITY)
    rule((x[:, F.ACCOUNT_AGE_DAYS] < 1.0) & (x[:, F.TX_AMOUNT] > 50_000),
         25.0, ReasonCode.NEW_ACCOUNT_LARGE_TX)
    rule((x[:, F.TIME_SINCE_LAST_TX] < 30.0) & (x[:, F.TX_TYPE_WITHDRAW] > 0)
         & (x[:, F.DEPOSIT_COUNT] > 0),
         20.0, ReasonCode.RAPID_DEPOSIT_WITHDRAW)
    rule(x[:, F.BONUS_ONLY_PLAYER] > 0, 20.0, ReasonCode.BONUS_ABUSE)
    rule((x[:, F.IS_VPN] > 0) | (x[:, F.IS_TOR] > 0),
         10.0, ReasonCode.VPN_DETECTED)
    rule(bl, 80.0, ReasonCode.KNOWN_FRAUDSTER)

    score_i = np.clip(score, 0.0, 100.0).astype(np.int32)
    thr = np.asarray(thresholds, dtype=np.int32)
    action = np.where(score_i >= thr[0], ACTION_BLOCK,
                      np.where(score_i >= thr[1], ACTION_REVIEW,
                               ACTION_APPROVE)).astype(np.int32)
    return {
        "score": score_i,
        "action": action,
        "reason_mask": mask,
        "rule_score": score_i.copy(),
        "ml_score": (score_i / 100.0).astype(np.float32),
    }


class HeuristicScorer:
    """Per-request degraded tier: gathers features if the store is still
    healthy (device-only outage), context-only rows otherwise, then runs
    :func:`heuristic_scores`. Wire-compatible ScoreResponse objects, each
    flagged with the ``DEGRADED_CPU_HEURISTIC`` reason code."""

    def __init__(self, engine_ref: Callable[[], Any],
                 feature_store_breaker: CircuitBreaker):
        self._engine_ref = engine_ref
        self._fs_breaker = feature_store_breaker

    def gather(self, reqs: list) -> tuple[np.ndarray, np.ndarray]:
        engine = self._engine_ref()
        if self._fs_breaker.allow():
            try:
                x, bl = engine.features.gather_batch(reqs)
                self._fs_breaker.record_success()
                return np.asarray(x, np.float32), np.asarray(bl, bool)
            except Exception as exc:  # noqa: BLE001 — degrade to context-only rows
                self._fs_breaker.record_failure(exc)
        # Store down too: context-only rows (amount + tx-type one-hot).
        # Zero history scores conservative-low on the heuristic rules —
        # an answer, not an outage.
        x = np.zeros((len(reqs), NUM_FEATURES), dtype=np.float32)
        for i, r in enumerate(reqs):
            x[i, F.TX_AMOUNT] = r.amount
            x[i, F.TX_TYPE_DEPOSIT] = 1.0 if r.tx_type == "deposit" else 0.0
            x[i, F.TX_TYPE_WITHDRAW] = 1.0 if r.tx_type == "withdraw" else 0.0
            x[i, F.TX_TYPE_BET] = 1.0 if r.tx_type == "bet" else 0.0
        return x, np.zeros((len(reqs),), dtype=bool)

    def score_requests(self, reqs: list) -> list:
        from igaming_platform_tpu_torch.serve import ledger as ledger_mod
        from igaming_platform_tpu_torch.serve.scorer import ScoreResponse

        engine = self._engine_ref()
        start = time.monotonic()
        x, bl = self.gather(reqs)
        out = heuristic_scores(x, bl, engine.get_thresholds())
        elapsed_ms = (time.monotonic() - start) * 1000.0
        # Degraded decisions are ledgered like any other — tier
        # "heuristic" — so tools/replay.py can re-run them through the
        # SAME conservative scorer and prove the degraded window's
        # answers were defensible.
        prefix = ledger_mod.note_decisions(
            engine, out, n=len(reqs), wire_mode="single", tier="heuristic",
            x=x, bl=bl,
            account_ids=[r.account_id for r in reqs],
            amounts=[r.amount for r in reqs],
            tx_codes=[r.tx_type for r in reqs],
            model_version=f"{getattr(engine, 'ml_backend', 'unknown')}"
                          "+degraded-heuristic",
        )
        responses = []
        for i in range(len(reqs)):
            responses.append(ScoreResponse(
                score=int(out["score"][i]),
                action=action_from_code(int(out["action"][i])).value,
                reason_codes=decode_reason_mask(int(out["reason_mask"][i]))
                + [ReasonCode.DEGRADED_CPU_HEURISTIC],
                rule_score=int(out["rule_score"][i]),
                ml_score=float(out["ml_score"][i]),
                response_time_ms=elapsed_ms,
                features=FeatureVector.from_array(x[i]),
                decision_id=f"{prefix}.{i}" if prefix else "",
            ))
        return responses


# ---------------------------------------------------------------------------
# Supervised engine


class SupervisedScoringEngine:
    """The serving engine behind the supervisor's breakers.

    Wraps an engine built by ``engine_factory`` (a TorchScoringEngine) and
    proxies its full surface;
    the scoring entry points additionally run through:

    - the **device-step watchdog**: direct batch paths execute on a
      worker pool with a ``DEVICE_STEP_DEADLINE_S`` deadline, and the
      batcher path inherits it as the future timeout — a wedged
      dispatch->readback fails its in-flight window with
      :class:`DeviceWedgedError` (gRPC: UNAVAILABLE + retry-pushback),
      trips the device breaker, and triggers a background tear-down +
      rebuild through the factory (which replays the warm-up);
    - the **degraded tier**: while the device circuit is open, answers
      come from :class:`HeuristicScorer` — flagged, counted, never an
      error; half-open probes route single real calls back to the device
      and a success closes the circuit;
    - **BROWNOUT shedding**: when even the degraded tier is failing,
      scoring raises :class:`ServingUnavailable`.
    """

    def __init__(self, engine_factory: Callable[[], Any], *,
                 supervisor: ServingSupervisor | None = None,
                 watchdog_s: float | None = None, pool_workers: int = 16):
        if watchdog_s is None:
            watchdog_s = float(os.environ.get("DEVICE_STEP_DEADLINE_S", "30"))
        self._factory = engine_factory
        self._watchdog_s = watchdog_s
        self.supervisor = supervisor or ServingSupervisor()
        self._device = self.supervisor.breaker("device")
        self._degraded_tier = self.supervisor.breaker("degraded_tier")
        self._pool = ThreadPoolExecutor(
            max_workers=pool_workers, thread_name_prefix="supervised-score")
        self._pool_workers = pool_workers
        self._rebuild_lock = threading.Lock()
        self._rebuilding = False
        self.rebuilds = 0
        self._metrics = None
        self._inner = engine_factory()
        self.heuristic = HeuristicScorer(
            lambda: self._inner, self.supervisor.breaker("feature_store"))

    # -- proxy surface -------------------------------------------------------

    def __getattr__(self, name: str):
        # Only reached for attributes NOT on the wrapper; everything else
        # (params swap, feature store, thresholds, wire caps) follows the
        # CURRENT inner engine — including across rebuilds.
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    def __setattr__(self, name: str, value) -> None:
        # A write of an attribute the wrapper does not have but the inner
        # engine does (ledger, shadow, drift) goes to the inner engine, as
        # the read does: a caller holding the wrapper attaches its seams to
        # the engine that scores.
        inner = self.__dict__.get("_inner")
        if (inner is not None and name not in self.__dict__
                and not hasattr(type(self), name) and hasattr(inner, name)):
            setattr(inner, name, value)
        else:
            object.__setattr__(self, name, value)

    @property
    def score_observer(self):
        return self._inner.score_observer

    @score_observer.setter
    def score_observer(self, fn) -> None:
        self._inner.score_observer = fn

    @property
    def inner(self):
        return self._inner

    @property
    def degraded_active(self) -> bool:
        """True while answers may come from a degraded tier (device OR
        feature-store circuit not fully closed)."""
        return (self._device.state != CLOSED
                or self.supervisor.breaker("feature_store").state != CLOSED)

    @property
    def model_version(self) -> str:
        base = getattr(self._inner, "ml_backend", "unknown")
        return f"{base}+degraded-heuristic" if self.degraded_active else base

    def bind_supervisor_metrics(self, metrics) -> None:
        self._metrics = metrics
        self.supervisor.bind(metrics=metrics)

    # -- failure classification ----------------------------------------------

    def _classify(self, exc: BaseException) -> tuple[str, bool]:
        """(dependency, fatal). Timeouts are the wedge signal — fatal for
        the device breaker; chaos errors carry their seam."""
        from igaming_platform_tpu_torch.serve.chaos import ChaosError

        if isinstance(exc, (FutureTimeout, TimeoutError)):
            return "device", True
        if isinstance(exc, ChaosError):
            if exc.seam.startswith("feature_store"):
                return "feature_store", False
            if exc.seam.startswith("workchannel"):
                return "multihost", False
            if exc.seam.startswith("amqp"):
                return "amqp", False
            if exc.seam.startswith("ledger"):
                return "ledger", False
            return "device", False
        return "device", False

    def _record_failure(self, exc: BaseException) -> tuple[str, bool]:
        dep, fatal = self._classify(exc)
        self.supervisor.breaker(dep).record_failure(exc, fatal=fatal)
        if fatal and dep == "device":
            if self._metrics is not None:
                self._metrics.watchdog_trips_total.inc()
            self._start_rebuild(f"watchdog: {exc!r}")
        return dep, fatal

    def _note_pass(self) -> None:
        """A full real-path success: the device stepped AND the gather
        came from the store, so both breakers get the health evidence."""
        self._device.record_success()
        self.supervisor.breaker("feature_store").record_success()

    def _note_degraded(self, rows: int, tier: str = "heuristic") -> None:
        if self._metrics is not None:
            self._metrics.degraded_responses_total.inc(rows, tier=tier)
        tracing.set_root_attribute("degraded", tier)

    def _shed_brownout(self) -> None:
        raise ServingUnavailable(
            "BROWNOUT: degraded scoring tier is failing too — retry after "
            f"pushback ({self.supervisor.snapshot()['breakers']['degraded_tier']['last_error']})")

    # -- degraded tier -------------------------------------------------------

    def _degraded_requests(self, reqs: list) -> list:
        try:
            responses = self.heuristic.score_requests(reqs)
        except Exception as exc:  # noqa: BLE001 — heuristic failing => brownout
            self._degraded_tier.record_failure(exc)
            raise ServingUnavailable(
                f"degraded scoring tier failed: {exc!r}") from exc
        self._degraded_tier.record_success()
        self._note_degraded(len(reqs))
        return responses

    def _degraded_rows_to_wire(self, x: np.ndarray, bl: np.ndarray,
                               include_features: bool, start: float) -> bytes:
        from igaming_platform_tpu_torch.serve.wire import encode_score_batch

        try:
            out = heuristic_scores(x, bl, self._inner.get_thresholds())
            from igaming_platform_tpu_torch.serve import ledger as ledger_mod

            ledger_mod.note_decisions(
                self._inner, out, n=int(x.shape[0]), wire_mode="wire_row",
                tier="heuristic", x=np.asarray(x, np.float32), bl=bl,
                model_version=f"{getattr(self._inner, 'ml_backend', 'unknown')}"
                              "+degraded-heuristic")
            rtms = np.full((x.shape[0],),
                           int((time.monotonic() - start) * 1000.0), np.int64)
            payload = encode_score_batch(
                out["score"], out["action"], out["reason_mask"],
                out["rule_score"], out["ml_score"], rtms,
                np.asarray(x, np.float32) if include_features else None)
        except Exception as exc:  # noqa: BLE001 — heuristic failing => brownout
            self._degraded_tier.record_failure(exc)
            raise ServingUnavailable(
                f"degraded wire scoring failed: {exc!r}") from exc
        self._degraded_tier.record_success()
        self._note_degraded(int(x.shape[0]))
        return payload

    # -- guarded dispatch ----------------------------------------------------

    def _guard_batch(self, fn: Callable, *args, **kwargs):
        """Run a direct (non-batcher) scoring call under the watchdog
        deadline on the worker pool. A deadline overrun is the wedge
        signal: fail the window loudly and rebuild. The caller's span
        context rides along (tracing.carry): without it, a supervised
        engine's wire batches lose their RPC root — stage spans detach
        from /debug/flightz and the ledger's decision-id join key never
        lands on the flight entry."""
        parent = tracing.current_span()

        def run():
            with tracing.carry(parent):
                return fn(*args, **kwargs)

        future = self._pool.submit(run)
        try:
            return future.result(timeout=self._watchdog_s)
        except (FutureTimeout, TimeoutError) as exc:
            self._record_failure(exc)
            raise DeviceWedgedError(
                f"device step exceeded the {self._watchdog_s}s watchdog "
                "deadline; in-flight window failed, engine rebuild started"
            ) from exc

    # -- scoring entry points --------------------------------------------------

    def score(self, req, timeout: float = 30.0, **kwargs):
        """``kwargs`` (deadline=, lane= — serve/deadline.py) pass through
        to the inner engine's scheduler; the degraded heuristic tier is
        host-local and synchronous, so a deadline there is moot."""
        if self.supervisor.state == BROWNOUT:
            self._shed_brownout()
        if not self._device.allow():
            return self._degraded_requests([req])[0]
        try:
            resp = self._inner.score(req, timeout=min(timeout, self._watchdog_s),
                                     **kwargs)
        except Exception as exc:  # noqa: BLE001 — classified + degraded below
            from igaming_platform_tpu_torch.serve.deadline import DeadlineExpired

            if isinstance(exc, DeadlineExpired):
                # A deadline shed is the CALLER's status, not device
                # sickness: no breaker evidence, no degraded answer.
                self._device.release_probe()
                raise
            dep, fatal = self._record_failure(exc)
            if fatal:
                raise DeviceWedgedError(
                    f"single-txn score exceeded the {self._watchdog_s}s "
                    "watchdog deadline; engine rebuild started") from exc
            return self._degraded_requests([req])[0]
        self._note_pass()
        return resp

    def score_batch(self, reqs: list):
        if self.supervisor.state == BROWNOUT:
            self._shed_brownout()
        if not self._device.allow():
            return self._degraded_requests(list(reqs))
        try:
            responses = self._guard_batch(self._inner.score_batch, reqs)
        except DeviceWedgedError:
            raise
        except Exception as exc:  # noqa: BLE001 — classified + degraded below
            self._record_failure(exc)
            return self._degraded_requests(list(reqs))
        self._note_pass()
        return responses

    def score_batch_wire(self, account_ids, amounts, tx_types, **kwargs):
        if self.supervisor.state == BROWNOUT:
            self._shed_brownout()
        include_features = kwargs.get("include_features", True)
        if not self._device.allow():
            return self._degraded_wire_columns(
                account_ids, amounts, tx_types, kwargs, include_features)
        try:
            payload = self._guard_batch(
                self._inner.score_batch_wire, account_ids, amounts, tx_types,
                **kwargs)
        except DeviceWedgedError:
            raise
        except Exception as exc:  # noqa: BLE001 — classified + degraded below
            self._record_failure(exc)
            return self._degraded_wire_columns(
                account_ids, amounts, tx_types, kwargs, include_features)
        self._note_pass()
        return payload

    def _degraded_wire_columns(self, account_ids, amounts, tx_types,
                               kwargs, include_features: bool) -> bytes:
        from igaming_platform_tpu_torch.serve.scorer import ScoreRequest

        start = time.monotonic()
        reqs = [
            ScoreRequest(
                account_id=account_ids[i], amount=amounts[i],
                tx_type=tx_types[i],
                ip=(kwargs.get("ips") or [""] * len(account_ids))[i],
                device_id=(kwargs.get("devices") or [""] * len(account_ids))[i],
                fingerprint=(kwargs.get("fingerprints")
                             or [""] * len(account_ids))[i],
            )
            for i in range(len(account_ids))
        ]
        x, bl = self.heuristic.gather(reqs)
        return self._degraded_rows_to_wire(x, bl, include_features, start)

    def score_batch_wire_bytes(self, payload: bytes, **kwargs):
        if self.supervisor.state == BROWNOUT:
            self._shed_brownout()
        if not self._device.allow():
            return self._degraded_wire_bytes(payload, **kwargs)
        try:
            out = self._guard_batch(
                self._inner.score_batch_wire_bytes, payload, **kwargs)
        except DeviceWedgedError:
            raise
        except ValueError:
            # A malformed request: the caller's INVALID_ARGUMENT, not a failure.
            self._device.release_probe()
            raise
        except Exception as exc:  # noqa: BLE001 — classified + degraded below
            self._record_failure(exc)
            return self._degraded_wire_bytes(payload, **kwargs)
        # A pass closes a half-open device circuit, as on the other paths
        # (the JAX wrapper notes none here, so a ScoreBatch probe there
        # leaves the circuit half-open).
        self._note_pass()
        return out

    def _degraded_wire_bytes(self, payload: bytes,
                             include_features: bool = True):
        start = time.monotonic()
        try:
            # The native decode+gather is a host/store operation — usable
            # even with the device circuit open.
            x, bl = self._inner.features.decode_gather(payload)
        except ValueError:
            raise
        except Exception as exc:  # noqa: BLE001 — store down too: no wire answer
            self.supervisor.breaker("feature_store").record_failure(exc)
            raise ServingUnavailable(
                "degraded ScoreBatch needs the feature store for decode+"
                f"gather and it failed: {exc!r}") from exc
        return (self._degraded_rows_to_wire(x, bl, include_features, start),
                int(x.shape[0]))

    def score_batch_wire_index(self, payload: bytes):
        if self.supervisor.state == BROWNOUT:
            self._shed_brownout()
        if not self._device.allow():
            # Index mode's whole point is the device-resident table; with
            # the device circuit open there is nothing to serve it from.
            raise ServingUnavailable(
                "index-mode ScoreBatch unavailable while the device "
                "circuit is open; retry with backoff or fall back to "
                "row-mode requests")
        try:
            out = self._guard_batch(self._inner.score_batch_wire_index, payload)
        except DeviceWedgedError:
            raise
        except (ValueError, RuntimeError):
            self._device.release_probe()
            raise
        except Exception as exc:  # noqa: BLE001 — classified, then shed
            self._record_failure(exc)
            raise ServingUnavailable(
                f"index-mode ScoreBatch failed: {exc!r}") from exc
        self._note_pass()
        return out

    # -- rebuild ---------------------------------------------------------------

    def _start_rebuild(self, why: str) -> None:
        with self._rebuild_lock:
            if self._rebuilding:
                return
            self._rebuilding = True
        self._device.force_open(f"engine rebuild in progress: {why}")
        threading.Thread(target=self._rebuild, args=(why,),
                         name="engine-rebuild", daemon=True).start()

    def _rebuild(self, why: str) -> None:
        logger.warning("rebuilding scoring engine: %s", why)
        old = self._inner
        old_pool = self._pool
        try:
            new = self._factory()  # the constructor replays the warm-up
            self._rebind(new, old)
            self._inner = new
            # Fresh pool: workers wedged inside the old engine's device
            # calls must not eat the new engine's watchdog capacity.
            self._pool = ThreadPoolExecutor(
                max_workers=self._pool_workers,
                thread_name_prefix="supervised-score")
            old_pool.shutdown(wait=False)
            self.rebuilds += 1
            if self._metrics is not None:
                self._metrics.engine_rebuilds_total.inc()
            logger.warning("engine rebuild complete (%d total)", self.rebuilds)
        except Exception:  # noqa: BLE001 — rebuild failure leaves degraded tier serving
            logger.exception("engine rebuild failed; staying degraded")
            # The old engine stays the inner one but is retired: closed here,
            # on the rebuild's thread and before the breaker admits a probe,
            # so a probe fails at once (a plain failure) instead of timing out
            # on the wedged engine into another rebuild. The JAX package
            # closes it after the release and loops.
            self._close_quietly(old)
        else:
            # Old engine teardown may block on wedged device threads —
            # never on the serving path.
            threading.Thread(target=self._close_quietly, args=(old,),
                             name="engine-teardown", daemon=True).start()
        finally:
            with self._rebuild_lock:
                self._rebuilding = False
            # Probe before trusting: HALF_OPEN, not CLOSED.
            self._device.clear_forced()

    @staticmethod
    def _close_quietly(engine) -> None:
        try:
            engine.close()
        except Exception:  # noqa: BLE001 — teardown of a wedged engine is best-effort
            logger.warning("old engine teardown failed", exc_info=True)

    def _rebind(self, new, old) -> None:
        """Re-apply the serving layer's hooks to the rebuilt engine (the
        gRPC service bound them to the old one at construction)."""
        new.score_observer = getattr(old, "score_observer", None)
        # The decision ledger survives a rebuild: the WAL must not lose
        # the decisions of a freshly-healed engine.
        new.ledger = getattr(old, "ledger", None)
        # So does the shadow scorer — the online loop keeps accumulating
        # candidate evidence against the rebuilt engine's stream. It is
        # re-pointed at the rebuilt engine (shape ladder, thresholds)
        # and, if a candidate is sitting, the rebuilt engine re-warms
        # its fused shadow variants off-path.
        new.shadow = getattr(old, "shadow", None)
        # And the drift observatory: its rolling windows + pinned
        # reference outlive the engine; the rebuilt engine re-jits its
        # sketch kernels through the same bind seam.
        drift = getattr(old, "drift", None)
        if drift is not None and hasattr(new, "bind_drift"):
            new.bind_drift(drift)
        # Shadow re-point AFTER the drift rebind so the fused shadow
        # variants warm with the sketch branch compiled in.
        if new.shadow is not None and hasattr(new.shadow, "rebind_engine"):
            new.shadow.rebind_engine(new)
        old_b = getattr(old, "_batcher", None)
        new_b = getattr(new, "_batcher", None)
        if old_b is not None and new_b is not None:
            for hook in ("on_batch", "on_plan", "on_dispatch_deadlines"):
                setattr(new_b, hook, getattr(old_b, hook))
            for hook in ("on_expired", "on_depth"):
                setattr(new_b.scheduler, hook, getattr(old_b.scheduler, hook))
        sink = getattr(old, "_cache_metrics_sink", None)
        if sink is not None and hasattr(new, "bind_cache_metrics"):
            new.bind_cache_metrics(sink)
        sink = getattr(old, "_pipeline_metrics_sink", None)
        if sink is not None and hasattr(new, "bind_pipeline_metrics"):
            new.bind_pipeline_metrics(sink)
        sink = getattr(old, "_session_metrics_sink", None)
        if sink is not None and hasattr(new, "bind_session_metrics"):
            new.bind_session_metrics(sink)

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        self._inner.close()
