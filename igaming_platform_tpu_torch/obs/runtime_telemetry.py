"""Device-runtime telemetry: the signals the flight recorder is blind to.

The port's counterpart of ``igaming_platform_tpu/obs/runtime_telemetry.py``,
with its three signals, its knobs and its ``/debug/telemetryz`` page:

- **Compile events.** Eager PyTorch compiles no program, so the events the
  port counts are its own: each ``nvcc`` build and each library load of
  ``ops/_build.py`` and each ``g++`` build and load of
  ``serve/_native_build.py``, with their wall ms (``note_compile``). The
  process keeps them all, since the engine's warm-up builds its kernels
  before the service that installs the telemetry exists: a telemetry counts
  the events of the process before it at install, then each new one. The
  launch seam notes a *shape signature* at every launch, and
  ``compile_signatures_total`` fires exactly once per new (name, padded
  shape, dtype), as in JAX.

- **Dispatches.** Every compiled step the port launches, not every CUDA
  kernel inside it, goes through ``serve/scorer._device_dispatch``, which
  calls ``note_dispatch``: the global counter, the metric and the RPC root's
  ``dispatches`` attribute (``/debug/flightz``). The split drift sketch, the
  shadow scorer's own step, the session admission sync, the cache's delta
  copy and flag write and the abuse model count like the score steps.

- **Step-time anomalies.** ``StepTimeAnomalyDetector`` keeps an EWMA and
  EW-variance of each step stage's span time; a step beyond ``mean +
  k*sigma`` and an absolute floor stamps the flight entry (``anomaly``) and
  fires the profile trigger, which the server binds to its
  ``capture_profile`` with a cooldown: the first anomaly of an incident
  records a profile keyed by its trace id, later ones inside the cooldown
  only count.

``refresh_gauges`` reads the staging arena's buffers and the card's memory
(``torch.cuda.memory_stats``: in use and peak; the card's total as the
limit) on every ``/metrics`` scrape. ``RUNTIME_TELEMETRY=0`` turns the
plane off (``serve/grpc_server.py``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Callable

from igaming_platform_tpu_torch.obs import devtrace, tracing

logger = logging.getLogger(__name__)

# Stage spans whose durations feed the anomaly detectors.
_STEP_STAGES = ("score.dispatch", "score.readback", "score.device")
# Compile events kept for the page, newest last.
_MAX_EVENTS = 64


class CompileWatcher:
    """Compile accounting and shape signatures.

    ``note_signature`` is called on the launching thread right before a
    launch; a compile event on the same thread is attributed to it. It
    returns True exactly once per new signature."""

    def __init__(self, metrics=None, max_events: int = _MAX_EVENTS):
        self.metrics = metrics
        self._lock = threading.Lock()
        self._signatures: set[str] = set()
        self._local = threading.local()
        self.compiles_total = 0
        self.compile_wall_ms_total = 0.0
        self.new_signatures_total = 0
        self.events: deque = deque(maxlen=max_events)

    def on_compile(self, event: dict) -> None:
        """One build or load (``note_compile``'s record)."""
        sig = getattr(self._local, "pending_signature", None)
        with self._lock:
            self.compiles_total += 1
            self.compile_wall_ms_total += event["wall_ms"]
            self.events.append({**event, "signature": sig})
        if self.metrics is not None:
            self.metrics.compile_events_total.inc(kind=event["kind"])
            self.metrics.compile_wall_ms.observe(event["wall_ms"])

    def note_signature(self, name: str, shape=None, dtype=None) -> bool:
        """Record the shape signature about to launch; True iff new."""
        sig = f"{name}:{tuple(shape) if shape is not None else ()}:{dtype}"
        self._local.pending_signature = sig
        with self._lock:
            if sig in self._signatures:
                return False
            self._signatures.add(sig)
            self.new_signatures_total += 1
        if self.metrics is not None:
            self.metrics.compile_signatures_total.inc()
        return True

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "compiles_total": self.compiles_total,
                "compile_wall_ms_total": round(self.compile_wall_ms_total, 3),
                "signatures": self.new_signatures_total,
                "recent_events": list(self.events),
            }


class StepTimeAnomalyDetector:
    """EWMA and EW-variance step-time anomaly detection for one stage.

    A sample is anomalous when it exceeds ``mean + k*sigma`` and the floor
    ``min_ms``, once ``warmup`` samples have seeded the baseline."""

    def __init__(self, *, alpha: float = 0.15, k_sigma: float = 4.0, min_ms: float = 5.0,
                 warmup: int = 30):
        self.alpha = alpha
        self.k_sigma = k_sigma
        self.min_ms = min_ms
        self.warmup = warmup
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def observe(self, ms: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            delta = ms - self.mean
            self.mean += delta / self.n
            self.var += (delta * (ms - self.mean) - self.var) / self.n
            return False
        sigma = self.var ** 0.5
        anomalous = ms > self.min_ms and ms > self.mean + self.k_sigma * sigma
        # An anomalous sample moves the baseline with a damped weight, so a
        # sustained fault stays anomalous request after request.
        alpha = self.alpha * (0.1 if anomalous else 1.0)
        delta = ms - self.mean
        self.mean += alpha * delta
        self.var = (1 - alpha) * (self.var + alpha * delta * delta)
        return anomalous

    def snapshot(self) -> dict:
        return {"mean_ms": round(self.mean, 3), "sigma_ms": round(self.var ** 0.5, 3),
                "samples": self.n}


class RuntimeTelemetry:
    """The assembled plane: dispatch and compile accounting, and anomaly ->
    profile. Anomalies within ``cooldown_s`` of a capture only count."""

    def __init__(self, metrics=None, *, cooldown_s: float | None = None,
                 profile_enabled: bool | None = None):
        self.metrics = metrics
        self.compile_watcher = CompileWatcher(metrics)
        if cooldown_s is None:
            cooldown_s = float(os.environ.get("ANOMALY_PROFILE_COOLDOWN_S", "120"))
        if profile_enabled is None:
            profile_enabled = os.environ.get("ANOMALY_PROFILE", "1") != "0"
        self.cooldown_s = cooldown_s
        self.profile_enabled = profile_enabled
        self._lock = threading.Lock()
        # A leaf lock for the dispatch counter: launch seams may hold the
        # cache's or the session's lock.
        self._dispatch_lock = threading.Lock()
        self._detectors: dict[str, StepTimeAnomalyDetector] = {}
        self._detector_kwargs = dict(
            k_sigma=float(os.environ.get("ANOMALY_K_SIGMA", "4.0")),
            min_ms=float(os.environ.get("ANOMALY_MIN_STEP_MS", "5.0")),
            warmup=int(os.environ.get("ANOMALY_WARMUP_STEPS", "30")),
        )
        self.dispatches_total = 0
        self.anomalies_total = 0
        self.anomalies: deque = deque(maxlen=64)
        self.profile_captures: list[dict] = []
        # Results that came back before their record was made.
        self._early_results: dict[str, dict] = {}
        self._last_profile_at = float("-inf")
        self._profile_trigger: Callable[[str, str, float], dict | None] | None = None
        self._engine = None

    # -- wiring --------------------------------------------------------------

    def bind_profile_trigger(self, fn: Callable[[str, str, float], dict | None]) -> None:
        """fn(trace_id, stage, duration_ms) -> capture info or None. It runs
        on a serving thread and must not block (the server's starts a
        capture thread)."""
        self._profile_trigger = fn

    def bind_engine(self, engine) -> None:
        """The engine whose arena and device the gauges read."""
        self._engine = engine

    # -- intake --------------------------------------------------------------

    def note_dispatch(self, count: int = 1, step: tuple | None = None):
        """One launched step (``serve/scorer._device_dispatch``): the
        counter, the metric and the current RPC root's ``dispatches``.
        ``step`` (name, padded shape, device) gets its mark on an armed
        device timeline (``obs/devtrace.py``), made under the counter's
        lock; returns it, or ``devtrace.NO_STEP``."""
        with self._dispatch_lock:
            self.dispatches_total += count
            mark = (devtrace.step_mark(devtrace.ARMED, *step) if step is not None
                    else devtrace.NO_STEP)
        if self.metrics is not None:
            self.metrics.device_dispatches_total.inc(count)
        span = tracing.current_span()
        if span is not None:
            tracing.bump_root_attribute_of(span, "dispatches", count)
        return mark

    def observe_span(self, span) -> None:
        name = getattr(span, "name", "")
        if name not in _STEP_STAGES:
            return
        with self._lock:
            det = self._detectors.get(name)
            if det is None:
                det = self._detectors.setdefault(
                    name, StepTimeAnomalyDetector(**self._detector_kwargs))
            anomalous = det.observe(span.duration_ms)
        if anomalous:
            self._note_anomaly(span, name)

    def _note_anomaly(self, span, stage: str) -> None:
        with self._lock:
            self.anomalies_total += 1
            self.anomalies.append({
                "t_unix": round(time.time(), 3),
                "stage": stage,
                "duration_ms": round(span.duration_ms, 3),
                "trace_id": span.trace_id,
            })
        if self.metrics is not None:
            self.metrics.step_anomalies_total.inc(stage=stage)
        # The root completes after its stages: the recorder snapshots this.
        root = span.root if span.root is not None else span
        root.attributes.setdefault("anomaly", stage)
        self._maybe_profile(span.trace_id, stage, span.duration_ms)

    def _maybe_profile(self, trace_id: str, stage: str, duration_ms: float) -> None:
        trigger = self._profile_trigger
        if trigger is None or not self.profile_enabled:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._last_profile_at < self.cooldown_s:
                return
            self._last_profile_at = now
        try:
            info = trigger(trace_id, stage, duration_ms)
        except Exception:  # noqa: BLE001 — profiling must not fail scoring
            logger.warning("anomaly profile trigger failed", exc_info=True)
            return
        with self._lock:
            self.profile_captures.append({
                "t_unix": round(time.time(), 3),
                "trace_id": trace_id,
                "stage": stage,
                "duration_ms": round(duration_ms, 3),
                **(info or {}),
                **self._early_results.pop(trace_id, {}),
            })
        if self.metrics is not None:
            self.metrics.anomaly_profiles_total.inc()

    def note_capture_result(self, trace_id: str, info: dict) -> None:
        """A finished capture: its result folded into its record (kept until
        the record is made, when the capture's thread is first)."""
        with self._lock:
            for rec in reversed(self.profile_captures):
                if rec.get("trace_id") == trace_id:
                    rec.update(info)
                    return
            self._early_results[trace_id] = dict(info)

    # -- gauges and snapshot -------------------------------------------------

    def _arena_stats(self) -> dict | None:
        engine = self._engine
        pipeline = getattr(engine, "pipeline", None) if engine is not None else None
        if pipeline is not None and hasattr(pipeline, "arena_stats"):
            return pipeline.arena_stats()
        return None

    def refresh_gauges(self) -> None:
        """The arena's buffers and the card's memory onto the metrics; run on
        each /metrics scrape."""
        if self.metrics is None:
            return
        stats = self._arena_stats()
        if stats is not None:
            for kind in ("allocated", "reused", "idle"):
                self.metrics.arena_buffers.set(float(stats.get(kind, 0)), kind=kind)
        device = getattr(self._engine, "device", None)
        if device is None or getattr(device, "type", "") != "cuda":
            return  # the CPU reports no device memory
        import torch

        mem = torch.cuda.memory_stats(device)
        _, total = torch.cuda.mem_get_info(device)
        for value, kind in ((mem.get("allocated_bytes.all.current", 0), "in_use"),
                            (total, "limit"), (mem.get("allocated_bytes.all.peak", 0), "peak")):
            self.metrics.hbm_bytes.set(float(value), kind=kind)

    def snapshot(self) -> dict:
        with self._dispatch_lock:
            dispatches = self.dispatches_total
        with self._lock:
            out = {
                "dispatches_total": dispatches,
                "anomalies_total": self.anomalies_total,
                "recent_anomalies": list(self.anomalies),
                "profile_captures": list(self.profile_captures),
                "profile_cooldown_s": self.cooldown_s,
                "step_time": {name: det.snapshot() for name, det in self._detectors.items()},
            }
        out["compile"] = self.compile_watcher.snapshot()
        stats = self._arena_stats()
        if stats is not None:
            out["arena"] = stats
        return out


# ---------------------------------------------------------------------------
# The process's compile events and default telemetry

DEFAULT: RuntimeTelemetry | None = None
# Every build and load of the process, in order (few: one per source).
_COMPILE_LOCK = threading.Lock()
_COMPILE_LOG: list[dict] = []


def note_compile(kind: str, name: str, wall_ms: float) -> None:
    """One build (``nvcc_build``, ``native_build``) or library load
    (``library_load``, ``native_load``) of ``name``, ``wall_ms`` long."""
    event = {"t_unix": round(time.time(), 3), "kind": kind, "name": name,
             "wall_ms": round(float(wall_ms), 3)}
    with _COMPILE_LOCK:
        _COMPILE_LOG.append(event)
        t = DEFAULT
        if t is not None:
            t.compile_watcher.on_compile(event)


def compile_log() -> list[dict]:
    """The process's builds and loads so far."""
    with _COMPILE_LOCK:
        return list(_COMPILE_LOG)


def install(metrics=None) -> RuntimeTelemetry:
    """A new RuntimeTelemetry as the process default, bound to the span
    fan-out (replacing the previous one: the most recently built risk
    service owns it), with the process's compile events so far counted."""
    global DEFAULT
    telemetry = RuntimeTelemetry(metrics)
    with _COMPILE_LOCK:
        if DEFAULT is not None:
            tracing.remove_span_sink(DEFAULT.observe_span)
        for event in _COMPILE_LOG:
            telemetry.compile_watcher.on_compile(event)
        DEFAULT = telemetry
    tracing.add_span_sink(telemetry.observe_span)
    return telemetry


def uninstall() -> None:
    global DEFAULT
    with _COMPILE_LOCK:
        if DEFAULT is not None:
            tracing.remove_span_sink(DEFAULT.observe_span)
            DEFAULT = None


def get_default() -> RuntimeTelemetry | None:
    return DEFAULT


def note_compile_signature(name: str, shape=None, dtype=None) -> bool:
    """The launch seam's signature note on the default watcher; True iff
    new. False without a default."""
    t = DEFAULT
    if t is None:
        return False
    return t.compile_watcher.note_signature(name, shape, dtype)


def note_dispatch(count: int = 1, step: tuple | None = None):
    """One launched step on the default telemetry; without one, only the
    step's mark on an armed device timeline. Returns the step's mark (a
    context manager around the step's enqueue), or ``devtrace.NO_STEP``."""
    t = DEFAULT
    if t is not None:
        return t.note_dispatch(count, step)
    if step is None or devtrace.ARMED is None:
        return devtrace.NO_STEP
    with devtrace._LOCK:
        return devtrace.step_mark(devtrace.ARMED, *step)
