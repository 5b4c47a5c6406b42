"""Profiling / tracing hooks.

The port's copy of ``igaming_platform_tpu/obs/tracing.py``, with the same
span contracts, wired two ways:

- device side: ``torch.profiler`` capture (``device_trace`` writes a Chrome
  trace of CPU and CUDA activity) and named regions (``annotate``/``step``,
  ``torch.profiler.record_function``) that show on its timeline. A region
  costs one check of the profiler's state when no capture runs;
- host side: lightweight spans (``span``) collected into an in-process
  buffer exportable as JSON, the OTLP-shaped record without requiring an
  OTLP endpoint.

Spans form real traces: a ``span()`` opened while another span is active
on the same thread becomes its CHILD (same trace id, ``parent_id`` set),
and a remote parent can be adopted from a W3C ``traceparent`` header
(``parse_traceparent``/``format_traceparent``), the propagation contract
the risk service uses so client and server spans share one trace. A stage
running on another thread joins its request's trace through ``carry`` or
``span(parent=...)``. Each ROOT span accumulates the summed duration of its
descendant stages (``stage_totals``), which is what the flight recorder
(obs/flight.py) snapshots per request.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import re
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class Span:
    name: str
    start: float
    end: float = 0.0
    # Monotonic companion clock (time.perf_counter). ``start``/``end``
    # are wall stamps for display ("when did this happen"); DURATIONS
    # come from the monotonic pair — time.time() steps under NTP, and a
    # slew mid-span would mint a negative or inflated stage cost that
    # the µs/row accounting (obs/hostprof.py) would then publish as
    # fact. MX06 (obs scope) enforces this split going forward.
    mono_start: float = 0.0
    mono_end: float = 0.0
    trace_id: str = ""
    span_id: str = ""
    parent_id: str = ""
    attributes: dict = field(default_factory=dict)
    # Root spans only: summed child-stage durations (ms) by span name —
    # the per-request decomposition the flight recorder snapshots.
    stage_totals: dict | None = field(default=None, repr=False, compare=False)
    # Root spans only: (start, end) of each completed descendant stage,
    # on the MONOTONIC clock (same epoch as mono_start/mono_end).
    # With pipelined serving, stages of one request run CONCURRENTLY on
    # different worker threads, so the busy-time sum (stage_totals) can
    # exceed the request's wall time; the interval union of these
    # windows is the honest "time attributed to stages" figure, and
    # 1 - union/sum is the request's host-stage overlap ratio.
    stage_windows: list | None = field(default=None, repr=False, compare=False)
    root: "Span | None" = field(default=None, repr=False, compare=False)

    @property
    def duration_ms(self) -> float:
        if self.mono_end:
            return (self.mono_end - self.mono_start) * 1000.0
        return (self.end - self.start) * 1000.0


# -- W3C trace context -------------------------------------------------------

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """W3C ``traceparent`` header -> (trace_id, parent_span_id), or None
    when absent/malformed (a bad header must never fail a request)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip())
    if m is None:
        return None
    version, trace_id, span_id = m.group(1), m.group(2), m.group(3)
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str) -> str:
    """(trace_id, span_id) -> W3C ``traceparent`` header (sampled)."""
    return f"00-{trace_id}-{span_id}-01"


# Per-thread active span (contextvars: gRPC worker threads and the
# batcher's launcher/collector threads each carry their own chain).
_CURRENT: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
    "igaming_current_span", default=None)

# Cross-thread mirror of the active span per thread ident. A contextvar
# is only readable from its own thread; the hostprof stack sampler
# (obs/hostprof.py) needs to ask "what span is thread T inside right
# now?" from the SAMPLER thread to key folded stacks by stage, and the
# GC watch uses it to count rpc.* roots in flight during a pause.
# Plain dict with GIL-atomic get/set/del per key; entries are removed on
# span exit so an idle thread holds no stale span.
_ACTIVE_BY_THREAD: dict[int, Span] = {}


def active_span_of_thread(ident: int) -> Span | None:
    """The span thread ``ident`` is currently inside, from any thread."""
    return _ACTIVE_BY_THREAD.get(ident)


def active_spans_by_thread() -> dict[int, Span]:
    """Snapshot of every thread's active span (sampler/GC attribution)."""
    return dict(_ACTIVE_BY_THREAD)

# Roots accumulate stage_totals/stage_windows from EVERY thread their
# stages run on (pipeline workers included) — one cheap module lock
# serializes those two updates.
_STAGE_LOCK = threading.Lock()
# Bound per-root window accounting: a pathological request with more
# stages than this keeps its totals but stops collecting windows.
_MAX_STAGE_WINDOWS = 4096


def union_duration_ms(windows: list | None) -> float:
    """Total length (ms) of the UNION of (start, end) second intervals —
    wall time covered by at least one stage, immune to double-counting
    when stages overlap."""
    if not windows:
        return 0.0
    total = 0.0
    cur_start = cur_end = None
    for start, end in sorted(windows):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        elif end > cur_end:
            cur_end = end
    total += cur_end - cur_start
    return total * 1000.0

# Completion hooks. _SPAN_SINK fires for EVERY completed span (the metrics
# layer feeds per-stage latency histograms from it); _ROOT_SINK fires for
# completed ROOT spans only (the flight recorder). Both are best-effort:
# a failing sink must never fail the traced request. The _EXTRA_* lists
# let independent observers (the SLO engine, device-runtime telemetry)
# ride the same completion events without fighting over the primary
# slot — add/remove are idempotent, and extras fire AFTER the primary.
_SPAN_SINK: Callable[[Span], None] | None = None
_ROOT_SINK: Callable[[Span], None] | None = None
_EXTRA_SPAN_SINKS: list[Callable[[Span], None]] = []
_EXTRA_ROOT_SINKS: list[Callable[[Span], None]] = []


def set_span_sink(fn: Callable[[Span], None] | None) -> None:
    global _SPAN_SINK
    _SPAN_SINK = fn


def set_root_sink(fn: Callable[[Span], None] | None) -> None:
    global _ROOT_SINK
    _ROOT_SINK = fn


def add_span_sink(fn: Callable[[Span], None]) -> None:
    if fn not in _EXTRA_SPAN_SINKS:
        _EXTRA_SPAN_SINKS.append(fn)


def remove_span_sink(fn: Callable[[Span], None]) -> None:
    if fn in _EXTRA_SPAN_SINKS:
        _EXTRA_SPAN_SINKS.remove(fn)


def add_root_sink(fn: Callable[[Span], None]) -> None:
    if fn not in _EXTRA_ROOT_SINKS:
        _EXTRA_ROOT_SINKS.append(fn)


def remove_root_sink(fn: Callable[[Span], None]) -> None:
    if fn in _EXTRA_ROOT_SINKS:
        _EXTRA_ROOT_SINKS.remove(fn)


def current_span() -> Span | None:
    return _CURRENT.get()


def current_traceparent() -> str | None:
    """W3C header for the active span, or None outside any span — what
    gets injected into outbound hops (multihost work frames)."""
    s = _CURRENT.get()
    if s is None:
        return None
    return format_traceparent(s.trace_id, s.span_id)


def set_root_attribute(key: str, value) -> None:
    """Attach an attribute to the CURRENT trace's root span (e.g. the row
    count, known only deep in a handler). No-op outside a span."""
    s = _CURRENT.get()
    if s is not None and s.root is not None:
        s.root.attributes[key] = value


def bump_root_attribute_of(s: "Span | None", key: str, delta: float = 1) -> None:
    """Numerically increment an attribute on ``s``'s ROOT span, safely
    across threads (pipeline stage workers and the RPC handler both touch
    the same root). Used for per-request accounting like the device
    dispatches an RPC issued — the flight recorder snapshots the final
    value when the root completes."""
    if s is None:
        return
    root = s.root if s.root is not None else s
    with _STAGE_LOCK:
        root.attributes[key] = root.attributes.get(key, 0) + delta


class SpanCollector:
    """In-process span buffer (bounded ring)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._spans: list[Span] = []
        self._lock = threading.Lock()
        # Past capacity the OLDEST spans are evicted; that loss is counted
        # (and surfaced as <service>_spans_dropped_total via on_drop) so a
        # sampling gap in /debug/spans or the OTLP export is visible.
        self.dropped_total = 0
        self.on_drop: Callable[[int], None] | None = None

    def add(self, span: Span) -> None:
        dropped = 0
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self.capacity:
                dropped = len(self._spans) - self.capacity
                self._spans = self._spans[-self.capacity:]
                self.dropped_total += dropped
            on_drop = self.on_drop
        if dropped and on_drop is not None:
            try:
                on_drop(dropped)
            except Exception:  # noqa: BLE001 — metrics must not fail tracing
                pass

    def drain(self) -> list[Span]:
        with self._lock:
            out, self._spans = self._spans, []
            return out

    def to_json(self) -> str:
        with self._lock:
            return json.dumps([
                {
                    "name": s.name,
                    "trace_id": s.trace_id,
                    "span_id": s.span_id,
                    "parent_id": s.parent_id,
                    "start_unix_s": s.start,
                    "duration_ms": s.duration_ms,
                    "attributes": s.attributes,
                }
                for s in self._spans
            ])


DEFAULT_COLLECTOR = SpanCollector()


@contextlib.contextmanager
def span(name: str, collector: SpanCollector | None = None, *,
         traceparent: str | None = None, parent: Span | None = None,
         **attributes):
    """Host-side span around a serving stage.

    Nested use on one thread links parent/child automatically; a root
    span may instead adopt a remote parent from a ``traceparent`` header
    (client->front->follower propagation). An explicit ``parent``
    attaches a stage running on ANOTHER thread (a pipeline stage worker)
    to its request's span — same trace id, and its duration still lands
    in that root's stage accounting. Roots accumulate child-stage
    durations into ``stage_totals`` (plus their (start, end) windows for
    overlap accounting) and fire the flight-recorder sink.
    """
    collector = collector or DEFAULT_COLLECTOR
    ctx_parent = _CURRENT.get()
    if ctx_parent is None and parent is not None:
        ctx_parent = parent
    parent = ctx_parent
    trace_id = parent_id = ""
    if parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id
    elif traceparent is not None:
        parsed = parse_traceparent(traceparent)
        if parsed is not None:
            trace_id, parent_id = parsed
    if not trace_id:
        trace_id = uuid.uuid4().hex
    s = Span(name=name, start=time.time(), mono_start=time.perf_counter(),
             trace_id=trace_id,
             span_id=uuid.uuid4().hex[:16], parent_id=parent_id,
             attributes=attributes)
    if parent is None:
        s.stage_totals = {}
        s.stage_windows = []
        s.root = s
    else:
        s.root = parent.root if parent.root is not None else parent
    token = _CURRENT.set(s)
    ident = threading.get_ident()
    prior_active = _ACTIVE_BY_THREAD.get(ident)
    _ACTIVE_BY_THREAD[ident] = s
    try:
        yield s
    finally:
        _CURRENT.reset(token)
        if prior_active is not None:
            _ACTIVE_BY_THREAD[ident] = prior_active
        else:
            _ACTIVE_BY_THREAD.pop(ident, None)
        s.mono_end = time.perf_counter()
        s.end = time.time()
        collector.add(s)
        root = s.root
        if root is not None and root is not s and root.stage_totals is not None:
            with _STAGE_LOCK:
                root.stage_totals[s.name] = (
                    root.stage_totals.get(s.name, 0.0) + s.duration_ms)
                if (root.stage_windows is not None
                        and len(root.stage_windows) < _MAX_STAGE_WINDOWS):
                    root.stage_windows.append((s.mono_start, s.mono_end))
        if _SPAN_SINK is not None:
            try:
                _SPAN_SINK(s)
            except Exception:  # noqa: BLE001 — sinks must not fail requests
                pass
        for sink in tuple(_EXTRA_SPAN_SINKS):
            try:
                sink(s)
            except Exception:  # noqa: BLE001 — sinks must not fail requests
                pass
        if root is s:
            if _ROOT_SINK is not None:
                try:
                    _ROOT_SINK(s)
                except Exception:  # noqa: BLE001 — sinks must not fail requests
                    pass
            for sink in tuple(_EXTRA_ROOT_SINKS):
                try:
                    sink(s)
                except Exception:  # noqa: BLE001 — sinks must not fail requests
                    pass


@contextlib.contextmanager
def carry(parent: "Span | None"):
    """Re-enter a span context on ANOTHER thread (worker pools): stage
    spans opened inside nest under ``parent`` — same trace id, durations
    landing in its root's stage accounting — exactly as if they ran on
    the originating thread. The supervised engine's watchdog pool uses
    this so a guarded wire batch keeps its RPC root (stage attribution
    and the ledger's decision-id root attribute both depend on it)."""
    if parent is None:
        yield
        return
    token = _CURRENT.set(parent)
    ident = threading.get_ident()
    prior = _ACTIVE_BY_THREAD.get(ident)
    _ACTIVE_BY_THREAD[ident] = parent
    try:
        yield
    finally:
        _CURRENT.reset(token)
        if prior is not None:
            _ACTIVE_BY_THREAD[ident] = prior
        else:
            _ACTIVE_BY_THREAD.pop(ident, None)


def _profiler_active() -> bool:
    """True while a ``torch.profiler`` capture records (``device_trace`` or
    any other): only then does a region have a timeline to land on."""
    from torch.autograd import profiler as _autograd_profiler

    return _autograd_profiler._is_profiler_enabled


@contextlib.contextmanager
def annotate(name: str):
    """Named region on the device profile timeline. Outside a capture it
    costs one flag check: ``record_function`` is entered only while a
    profiler records."""
    if not _profiler_active():
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield


def step(name: str, step_num: int):
    """Training-step marker: a region named ``name#step_num`` on the
    profile timeline (no-op outside a capture)."""
    return annotate(f"{name}#{step_num}")


def prepare_device_trace() -> None:
    """Start and stop an empty CUDA capture on the calling thread. The
    profiler's CUDA tracer initialises on the thread that first records;
    started first on another thread (an HTTP handler's) it records no CUDA
    event, so a server calls this once on the thread that builds it."""
    import torch

    if torch.cuda.is_available():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            pass


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of host and CUDA activity for a
    block; the Chrome trace (``trace.json``) lands in ``log_dir``. Yields
    the profiler, whose ``events()`` the caller may count after the block."""
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
