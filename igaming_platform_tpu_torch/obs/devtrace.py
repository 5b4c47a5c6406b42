"""The port's own device timeline, for the automatic anomaly capture.

``torch.profiler`` records every operator of every thread, and stopping it
and writing its trace run under the interpreter: on an H100 that held the
serving threads for seconds. An anomaly capture needs far less: which steps
the engine launched and which hand kernels, when each ran on the card, and
the host spans around them. This module records just that.

While a ``DeviceTimeline`` is armed (``ARMED``; one at a time):

- every launched step (``serve/scorer._device_dispatch``) gets a step mark,
  a pair of timing CUDA events recorded on the step's stream around its
  enqueue, with its name, padded shape and the current trace id;
- every hand-kernel launch (``launch``, in the kernel wrappers) gets a
  kernel mark, a pair around the launch on its stream;
- on the CPU a mark carries ``perf_counter_ns`` stamps instead, and a
  wrapper's plain version (``plain``) is marked as its kernel would be.

While nothing is armed a launch pays one check of ``ARMED`` inside the
counter's lock it already took, and a dispatch one check inside the
dispatch counter's lock. A mark is made in the same locked section that
counts its launch or dispatch, and ``arm``/``disarm`` read the counters and
set ``ARMED`` under those locks: the marks of a window are exactly the
launches and dispatches counted in it.

Device times reach the host clock through one anchor event a card, recorded
on an idle stream when the timeline is armed and waited for on the arming
thread, for each card the process readied with ``prepare`` (a mark on
another card is written without its device time). ``write`` runs on the
capture's own thread: it waits for each event pair by ``query()`` (never
``synchronize``), merges the window's spans from the span ring
(``obs/tracing.py``), and writes a Chrome trace in slices of
``SLICE_EVENTS`` events, sleeping between slices, so no hold on the
interpreter is longer than about one switch interval. Kernel events carry
``"cat": "kernel"``, steps ``"step"``, spans ``"span"``; the trace's
``window`` object holds the counters' deltas over the window beside the
events' counts.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch

from igaming_platform_tpu_torch.obs import tracing

# The armed timeline, or None. Set and cleared under _LOCK (and the
# telemetry's dispatch lock, when one is bound).
ARMED: "DeviceTimeline | None" = None
# The kernel wrappers' launch counters share this lock with arm and disarm.
_LOCK = threading.Lock()
# Launch counters by kernel name: (wrapper, attribute).
_COUNTERS: dict[str, tuple[object, str]] = {}

SLICE_EVENTS = 32  # events encoded and written between two pauses (about 0.4 ms)
# Longer than a single-row request takes (about 11 ms on an H100 host), so
# that one request waits for at most one slice: with pauses of 2 ms, a
# request that overlapped a write waited for all its slices.
SLICE_PAUSE_S = 0.025
SPAN_POLL_S = 0.25  # how often a capture copies the span ring during its window
RESOLVE_TIMEOUT_S = 30.0  # how long the writer waits for a mark's events
# Timing events kept made (created and recorded once) per card, so a mark on
# a serving thread only records: a server fills the pool at boot
# (``prepare``), a capture's thread tops it up when it runs below a quarter,
# and the writer hands each event back.
POOL_EVENTS = 4096
_POOL: dict[int, list] = {}
_ENCODE = json.JSONEncoder(default=str, check_circular=False).encode
_SIDE: dict[int, object] = {}  # per card: the idle stream anchors and pool fills use

# Chrome trace process ids: the host spans, the CPU device, then cuda:i at 2 + i.
_HOST_PID, _CPU_PID, _CUDA_PID0 = 0, 1, 2


def register_counter(name: str, fn, attr: str = "launches") -> None:
    """Kernel ``name``'s launch counter is ``fn.<attr>`` (its wrapper's)."""
    _COUNTERS[name] = (fn, attr)


def counters() -> dict[str, int]:
    """Every registered launch counter's value, by kernel name."""
    return {name: int(getattr(fn, attr)) for name, (fn, attr) in _COUNTERS.items()}


class _Mark:
    """One launch or step: its name, device, args and a pair of stamps
    (CUDA events on a card, ``perf_counter_ns`` on the CPU)."""

    __slots__ = ("kind", "name", "device", "args", "stream", "start", "end", "t0", "t1",
                 "done", "failed")

    def __init__(self, kind: str, name: str, device, args: dict):
        self.kind, self.name, self.args = kind, name, args
        self.device = _device_index(device)
        self.stream = self.start = self.end = None
        self.t0 = self.t1 = 0
        self.done = self.failed = False

    def open(self) -> None:
        if self.device is None:
            self.t0 = time.perf_counter_ns()
            return
        self.stream = torch.cuda.current_stream(self.device)
        self.start = _event(self.device)
        self.start.record(self.stream)

    def close(self) -> None:
        if self.device is None:
            self.t1 = time.perf_counter_ns()
        elif self.start is not None:
            self.end = _event(self.device)
            self.end.record(self.stream)
        self.done = True

    def resolved(self) -> bool:
        """Its stamps can be read: closed, and on a card its end event has
        passed (the start, earlier on the same stream, has too)."""
        return self.done and (self.end is None or self.end.query())


class _Step(_Mark):
    """A step mark: opened and closed around the step's enqueue."""

    __slots__ = ()

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class _NoStep:
    """The step mark while nothing is armed: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_STEP = _NoStep()


def _event(device: int):
    """A timing event for ``device``: from its pool, else a new one."""
    try:
        return _POOL[device].pop()
    except (KeyError, IndexError):
        return torch.cuda.Event(enable_timing=True)


def _side_stream(device: int):
    stream = _SIDE.get(device)
    if stream is None:
        with torch.cuda.device(device):
            stream = _SIDE[device] = torch.cuda.Stream()
    return stream


def _fill_pool(device: int, n: int = POOL_EVENTS) -> None:
    """Top ``device``'s pool up to ``n`` events, each recorded once on the
    idle side stream (an event's CUDA handle is made at its first record)."""
    free = _POOL.setdefault(device, [])
    stream = _side_stream(device)
    for _ in range(n - len(free)):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        free.append(ev)


def _release(device: int, *events) -> None:
    """Hand passed events back to ``device``'s pool (beyond its size they
    are dropped)."""
    free = _POOL.setdefault(device, [])
    for ev in events:
        if ev is not None and len(free) < POOL_EVENTS:
            free.append(ev)


def prepare(device) -> None:
    """Ready ``device`` for captures (a CUDA device; nothing for the CPU):
    make its event pool, so that a capture's first arming does not, and have
    every capture anchor it. A server calls it at boot for its card; no
    other card gets a CUDA context from a capture."""
    index = _device_index(device)
    if index is not None:
        _fill_pool(index)


def _device_index(device) -> int | None:
    """A CUDA device's index, None for the CPU (host stamps)."""
    if device is None:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None else device.index


def _trace_id() -> str:
    s = tracing.current_span()
    return s.trace_id if s is not None else ""


def launch(fn, attr: str, name: str, device, entry, *args) -> int:
    """``entry(*args)``, one kernel launch through a resolved entry point,
    counted on ``fn.<attr>`` as it launches and, while a timeline is armed,
    marked on the launch's stream. A launch that raises or returns an error
    code is taken back off the count and its mark dropped. Returns the code."""
    with _LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)
        tl = ARMED
        mark = None if tl is None else tl._add(
            _Mark("kernel", name, device, {"route": "cuda", "trace_id": _trace_id()}))
    rc = -1
    try:
        if mark is not None:
            mark.open()
        rc = entry(*args)
    finally:
        if rc != 0:
            with _LOCK:
                setattr(fn, attr, getattr(fn, attr) - 1)
            if mark is not None:
                mark.failed = mark.done = True
        elif mark is not None:
            mark.close()
    return rc


def plain(name: str, fn, *args):
    """``fn(*args)``, a wrapper's plain version on the CPU, marked as
    ``name``'s kernel on the host clock while a timeline is armed."""
    if ARMED is None:
        return fn(*args)
    with _LOCK:
        tl = ARMED
        mark = None if tl is None else tl._add(
            _Mark("kernel", name, None, {"route": "plain", "trace_id": _trace_id()}))
    if mark is None:
        return fn(*args)
    mark.open()
    try:
        return fn(*args)
    finally:
        mark.close()


def step_mark(tl: "DeviceTimeline | None", name: str, shape, device):
    """The step mark of one dispatch counted while ``tl`` was armed (read
    under the dispatch counter's lock), or ``NO_STEP``."""
    if tl is None:
        return NO_STEP
    return tl._add(_Step("step", name, device, {
        "shape": [int(d) for d in shape], "trace_id": _trace_id()}))


class DeviceTimeline:
    """One capture window: arm, let traffic run, disarm, write.
    ``telemetry`` (a ``RuntimeTelemetry``) has its dispatch counter read
    with the launch counters at both ends; the spans come from
    ``tracing.DEFAULT_COLLECTOR``."""

    def __init__(self, telemetry=None):
        self.telemetry = telemetry
        self.collector = tracing.DEFAULT_COLLECTOR
        self.marks: list[_Mark] = []
        self._spans: dict[int, tracing.Span] = {}
        self.anchors: dict[int, tuple] = {}  # cuda index -> (event, host ns, uncertainty ns)
        self.t0_ns = self.t1_ns = 0
        self.counters0: dict[str, int] = {}
        self.counters1: dict[str, int] = {}
        self.dispatches0 = self.dispatches1 = None
        self.spans_dropped0 = 0

    def _add(self, mark: _Mark) -> _Mark:
        self.marks.append(mark)
        return mark

    def _locked(self):
        """_LOCK, then the telemetry's dispatch lock (the one order both are
        taken in)."""
        stack = contextlib.ExitStack()
        stack.enter_context(_LOCK)
        if self.telemetry is not None:
            stack.enter_context(self.telemetry._dispatch_lock)
        return stack

    def arm(self) -> None:
        """Record the anchor of each card readied by ``prepare`` and wait for
        it (on this thread), then read the counters and become ``ARMED``."""
        global ARMED
        for i in list(_POOL):
            _fill_pool(i)
            ev = _event(i)
            h0 = time.perf_counter_ns()
            ev.record(_side_stream(i))
            ev.synchronize()
            h1 = time.perf_counter_ns()
            self.anchors[i] = (ev, (h0 + h1) // 2, h1 - h0)
        self.spans_dropped0 = self.collector.dropped_total
        with self._locked():
            if ARMED is not None:
                raise RuntimeError("a device timeline is already armed")
            self.t0_ns = time.perf_counter_ns()
            self.counters0 = counters()
            if self.telemetry is not None:
                self.dispatches0 = self.telemetry.dispatches_total
            ARMED = self

    def disarm(self) -> None:
        global ARMED
        with self._locked():
            if ARMED is self:
                ARMED = None
            self.t1_ns = time.perf_counter_ns()
            self.counters1 = counters()
            if self.telemetry is not None:
                self.dispatches1 = self.telemetry.dispatches_total
        self.collect_spans()

    def collect_spans(self) -> None:
        """Keep the span ring's spans that overlap the window so far (the
        ring evicts its oldest: a capture copies it every ``SPAN_POLL_S``),
        and top the event pools up. The ring holds spans in the order they
        ended: it is read from its newest back to the window's start."""
        lo = self.t0_ns / 1e9
        hi = (self.t1_ns or time.perf_counter_ns()) / 1e9
        for s in reversed(self.collector.snapshot()):
            if s.mono_end < lo:
                break
            if s.mono_start <= hi:
                self._spans[id(s)] = s
        if ARMED is self:
            for i in self.anchors:
                if len(_POOL.get(i, ())) < POOL_EVENTS // 4:
                    _fill_pool(i)

    # -- the writer ----------------------------------------------------------

    def _resolve(self, timeout_s: float) -> int:
        """Wait (sleeping, never synchronising) until every mark's stamps
        can be read, at most ``timeout_s``; returns how many could not. Marks
        are taken in the order they were made, which on one stream is the
        order they pass."""
        marks = [m for m in self.marks if not m.failed]
        deadline = time.monotonic() + timeout_s
        i = 0
        while i < len(marks):
            if marks[i].resolved():
                i += 1
            elif time.monotonic() > deadline:
                return sum(not m.resolved() for m in marks[i:])
            else:
                time.sleep(0.005)
        return 0

    def _us(self, ns: int) -> float:
        return (ns - self.t0_ns) / 1e3

    def _mark_json(self, m: _Mark) -> str:
        """One mark as a Chrome trace event; its events go back to the pool."""
        ts, dur = 0.0, None
        if m.device is None:
            pid, tid, ts = _CPU_PID, 0, self._us(m.t0)
            if m.done:
                dur = (m.t1 - m.t0) / 1e3
        else:
            pid, tid = _CUDA_PID0 + m.device, int(m.stream.cuda_stream) if m.stream else 0
            anchor = self.anchors.get(m.device)
            if m.start is not None and m.end is not None and anchor is not None \
                    and m.end.query():
                event, host_ns, _ = anchor
                start_ms = event.elapsed_time(m.start)
                ts = self._us(host_ns) + start_ms * 1e3
                dur = (event.elapsed_time(m.end) - start_ms) * 1e3
                _release(m.device, m.start, m.end)
                m.start = m.end = None
        args = m.args if dur is not None else {**m.args, "incomplete": True}
        timing = f'"ts":{ts:.3f}' + (f',"dur":{dur:.3f}' if dur is not None else "")
        return (f'{{"name":{_ENCODE(m.name)},"cat":"{m.kind}","ph":"X","pid":{pid},'
                f'"tid":{tid},{timing},"args":{_ENCODE(args)}}}')

    def _span_json(self, s: tracing.Span) -> str:
        """One host span as a Chrome trace event, on a row per trace."""
        try:
            tid = int(s.trace_id[:6], 16)
        except ValueError:
            tid = 0
        args = {"trace_id": s.trace_id, "span_id": s.span_id, "parent_id": s.parent_id,
                **s.attributes}
        return (f'{{"name":{_ENCODE(s.name)},"cat":"span","ph":"X","pid":{_HOST_PID},'
                f'"tid":{tid},"ts":{(s.mono_start * 1e9 - self.t0_ns) / 1e3:.3f},'
                f'"dur":{max(0.0, (s.mono_end - s.mono_start) * 1e6):.3f},'
                f'"args":{_ENCODE(args)}}}')

    def window(self) -> dict:
        """The counters' deltas over the window beside the marks' counts."""
        kernels: dict[str, int] = {}
        steps: dict[str, int] = {}
        for m in self.marks:
            if m.failed:
                continue
            into = kernels if m.kind == "kernel" else steps
            into[m.name] = into.get(m.name, 0) + 1
        launches = {k: self.counters1.get(k, 0) - v for k, v in self.counters0.items()
                    if self.counters1.get(k, 0) != v}
        dispatches = (self.dispatches1 - self.dispatches0
                      if self.dispatches0 is not None and self.dispatches1 is not None else None)
        return {"seconds": (self.t1_ns - self.t0_ns) / 1e9, "launches": launches,
                "dispatches": dispatches, "kernel_events": kernels, "step_events": steps,
                "spans": len(self._spans),
                "spans_dropped": self.collector.dropped_total - self.spans_dropped0,
                "anchor_uncertainty_us": {f"cuda:{i}": a[2] / 2e3
                                          for i, a in self.anchors.items()}}

    def write(self, path: str, slice_events: int = SLICE_EVENTS) -> dict:
        """Write the window as a Chrome trace at ``path`` (through a
        temporary file, renamed when whole), ``slice_events`` events between
        two pauses of ``SLICE_PAUSE_S``. Returns the ``window`` object
        written."""
        unresolved = self._resolve(RESOLVE_TIMEOUT_S)
        window = self.window()
        names = {_HOST_PID: "host spans", _CPU_PID: "cpu"}
        names.update({_CUDA_PID0 + i: f"cuda:{i}" for i in self.anchors})
        meta = [_ENCODE({"name": "process_name", "ph": "M", "pid": pid, "args": {"name": name}})
                for pid, name in names.items()]
        # Each mark is released as it is written (its events destroyed a
        # slice at a time, not all at once).
        items, self.marks = [m for m in self.marks if not m.failed], []
        spans = sorted(self._spans.values(), key=lambda s: s.mono_start)
        n = len(meta) + len(items) + len(spans)
        slices = 0
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write('{"traceEvents": [')
            first = True
            for lo in range(0, n, slice_events):
                chunk = []
                for i in range(lo, min(n, lo + slice_events)):
                    if i < len(meta):
                        chunk.append(meta[i])
                    elif i < len(meta) + len(items):
                        chunk.append(self._mark_json(items[i - len(meta)]))
                        items[i - len(meta)] = None
                    else:
                        chunk.append(self._span_json(spans[i - len(meta) - len(items)]))
                text = ",".join(chunk)
                f.write(text if first else "," + text)
                first = False
                slices += 1
                time.sleep(SLICE_PAUSE_S)
            window.update(unresolved=unresolved, slices=slices, events=n)
            f.write('], "displayTimeUnit": "ms", "window": ' + json.dumps(window) + "}")
        os.replace(tmp, path)
        for i, (event, _, _) in self.anchors.items():
            _release(i, event)
        return window


def capture(log_dir: str, seconds: float, *, telemetry=None) -> dict:
    """Arm a timeline for ``seconds`` on the calling thread (which sleeps,
    copying the span ring every ``SPAN_POLL_S``), then write its
    ``trace.json`` into ``log_dir``; returns its ``window`` object. Raises
    while another timeline is armed."""
    tl = DeviceTimeline(telemetry)
    tl.arm()
    try:
        end = time.monotonic() + seconds
        while (left := end - time.monotonic()) > 0:
            time.sleep(min(SPAN_POLL_S, left))
            tl.collect_spans()
    finally:
        tl.disarm()
    return tl.write(os.path.join(log_dir, "trace.json"))
