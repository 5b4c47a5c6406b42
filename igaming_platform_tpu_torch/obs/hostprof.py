"""Host-plane cost observatory: where the host's microseconds went.

The port's counterpart of ``igaming_platform_tpu/obs/hostprof.py``, with the
same two tiers, knobs and pages:

Tier A (always on unless ``HOSTPROF=0``): per-stage µs/row accounting. Every
completed ``score.*`` stage span is folded, through a tracing span sink, into
per-stage cost-per-row distributions (cumulative totals and a bounded
reservoir of recent per-span samples); ``rpc.*`` roots feed the RPC block and
auto-register their handler thread for the sampler. A ``gc.callbacks`` hook
records collection counts and pause ms per generation, each pause attributed
to the ``rpc.*`` roots in flight when it hit, and the heap block reads
allocated blocks, per-generation counts and peak RSS.

Tier B (on demand, or ``HOSTPROF_HZ`` at boot): a stack sampler over the
threads registered with ``register_scoring_thread``; each sample is keyed by
the thread's active span and folded into collapsed stacks, exported as
folded text or speedscope JSON (``/debug/hostprofz?format=...``). A thread
that is not registered is never sampled.

Without the reference's deadlock. The JAX profiler's GC callback waits for
the profiler's lock; a collection can start on a thread that already holds
that lock (in ``_on_span``, ``_stage_block`` or the sampler's
``_sample_once``: since Python 3.12 a pending collection runs at the next
bytecode boundary, so any line inside the locked block will do), and that
thread then waits on itself for good. Here the GC callback never waits: it
tries the lock without blocking and, when it gets it, counts the collection
at once; when the lock is held (by its own thread or another), it appends
the collection's record to a ``collections.deque`` (an append is atomic
under the GIL), which the next holder of the lock folds in: a later
callback, or any reader, by ``popleft`` of as many records as the deque
held. Each record is counted once: directly under the lock, or appended
once and removed by the one ``popleft`` that returns it. The callback does
its work inside the collection, where what it allocates schedules no new
collection; a reader folding records one allocation at a time would make
collections as fast as it folds them (under ``gc.set_threshold(1)`` a
collection follows every allocation). The metrics' own locks could be the
ones the collected thread holds, so the callback never calls them: it keeps
each generation's unexported count and pauses, which readers export in one
call a generation (the ``/metrics`` scrape, ``gc_snapshot``, and a span once
4,096 pauses wait).
"""

from __future__ import annotations

import gc
import json
import os
import sys
import threading
import time
import weakref
from collections import deque

from igaming_platform_tpu_torch.obs import tracing

_STAGE_PREFIX = "score."
# Per-stage reservoir of recent per-span µs/row samples, bounded so a soak
# cannot grow the profiler.
_SAMPLE_RESERVOIR = 2048
# Folded-stack table bound: past it new stacks aggregate under "<other>".
_MAX_FOLDED_KEYS = 20000
_MAX_STACK_DEPTH = 48
# Bounded ring of recent GC pauses for the hostprofz page.
_GC_PAUSE_RING = 256
# Unexported GC pauses past which a completed span exports them.
_GC_EXPORT_BATCH = 4096


# ---------------------------------------------------------------------------
# Scoring-path thread registry (the sampler's contract)

_REGISTRY_LOCK = threading.Lock()
# ident -> (role, the registered thread): a registration belongs to the
# thread that held the ident when it was made. Threads that register rarely
# unregister, and the OS hands a finished thread's ident to a new one, which
# must not inherit its role (the sampler would profile it).
_THREAD_ROLES: dict[int, tuple[str, weakref.ref | None]] = {}


def _thread_of(ident: int) -> threading.Thread | None:
    if ident == threading.get_ident():
        return threading.current_thread()
    return next((t for t in threading.enumerate() if t.ident == ident), None)


def _holds(ident: int, entry: tuple[str, weakref.ref | None], live: dict) -> bool:
    return entry[1] is not None and entry[1]() is live.get(ident)


def register_scoring_thread(role: str, ident: int | None = None) -> int:
    """Register the calling (or given, live) thread as a scoring-path
    thread the sampler may profile; ``role`` prefixes its folded stacks.
    Idempotent; returns the registered ident. The registration ends with
    the thread."""
    if ident is None:
        ident = threading.get_ident()
    thread = _thread_of(ident)
    with _REGISTRY_LOCK:
        _THREAD_ROLES[ident] = (str(role), None if thread is None else weakref.ref(thread))
    return ident


def unregister_scoring_thread(ident: int | None = None) -> None:
    if ident is None:
        ident = threading.get_ident()
    with _REGISTRY_LOCK:
        _THREAD_ROLES.pop(ident, None)


def registered_threads() -> dict[int, str]:
    """Snapshot of {thread ident: role} over the registered threads still
    running; the registrations of finished threads are dropped."""
    live = {t.ident: t for t in threading.enumerate()}
    with _REGISTRY_LOCK:
        for ident, entry in list(_THREAD_ROLES.items()):
            if not _holds(ident, entry, live):
                del _THREAD_ROLES[ident]
        return {ident: role for ident, (role, _) in _THREAD_ROLES.items()}


# ---------------------------------------------------------------------------
# Tier B: the stack sampler


def _format_frame(frame) -> str:
    code = frame.f_code
    base = os.path.basename(code.co_filename)
    if base.endswith(".py"):
        base = base[:-3]
    return f"{base}.{code.co_name}"


class StackSampler:
    """Stack sampler over the registered scoring threads, at ``hz``.

    Folds each sample into ``role;span:<active span>;frame;...;leaf``. One
    run at a time: ``start`` answers False while one runs. Its thread is a
    daemon and reads only registered threads' frames."""

    def __init__(self):
        self._lock = threading.Lock()
        self._folded: dict[str, int] = {}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.hz = 0.0
        self.samples_total = 0
        self.threads_seen: set[str] = set()
        self._started_mono: float | None = None
        self.last_duration_s = 0.0

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self, hz: float) -> bool:
        """Begin sampling at ``hz``. False if already running or hz <= 0."""
        if not hz > 0:
            return False
        with self._lock:
            if self.running:
                return False
            self._stop.clear()
            self.hz = float(hz)
            self._started_mono = time.monotonic()
            self._thread = threading.Thread(target=self._run, name="hostprof-sampler",
                                            daemon=True)
            self._thread.start()
        return True

    def stop(self) -> dict:
        """Stop sampling; returns the summary block."""
        thread = self._thread
        self._stop.set()
        if thread is not None:
            thread.join(timeout=2.0)
        with self._lock:
            if self._started_mono is not None:
                self.last_duration_s = time.monotonic() - self._started_mono
                self._started_mono = None
            self._thread = None
        return self.snapshot()

    def reset(self) -> None:
        with self._lock:
            self._folded.clear()
            self.samples_total = 0
            self.threads_seen.clear()

    def _run(self) -> None:
        interval = 1.0 / self.hz
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                self._sample_once()
            except Exception:  # noqa: BLE001 — a sampler fault must never hurt serving
                pass
            # A fixed cadence: jitter would bias the histogram to quiet periods.
            self._stop.wait(max(0.001, interval - (time.monotonic() - t0)))

    def _sample_once(self) -> None:
        roles = registered_threads()
        if not roles:
            return
        frames = sys._current_frames()
        actives = tracing.active_spans_by_thread()
        # Every key is built before the lock is taken.
        keys: list[tuple[str, str]] = []
        for ident, role in roles.items():
            frame = frames.get(ident)
            if frame is None:
                continue
            parts: list[str] = []
            depth = 0
            while frame is not None and depth < _MAX_STACK_DEPTH:
                parts.append(_format_frame(frame))
                frame = frame.f_back
                depth += 1
            parts.reverse()  # root first, the flamegraph convention
            span = actives.get(ident)
            span_name = span.name if span is not None else "idle"
            keys.append((";".join([role, f"span:{span_name}", *parts]), role))
        del frames
        with self._lock:
            for key, role in keys:
                if key not in self._folded and len(self._folded) >= _MAX_FOLDED_KEYS:
                    key = "<other>"
                self._folded[key] = self._folded.get(key, 0) + 1
                self.samples_total += 1
                self.threads_seen.add(role)

    # -- exports ------------------------------------------------------------

    def folded(self) -> dict[str, int]:
        with self._lock:
            return dict(self._folded)

    @staticmethod
    def _rank(folded: dict[str, int], n: int) -> list[dict]:
        total = sum(folded.values()) or 1
        ranked = sorted(folded.items(), key=lambda kv: kv[1], reverse=True)
        return [{"stack": k, "samples": v, "share": round(v / total, 4)}
                for k, v in ranked[:n]]

    def top_stacks(self, n: int = 20) -> list[dict]:
        return self._rank(self.folded(), n)

    def to_folded_text(self) -> str:
        """Collapsed-stack text (``stack count`` a line), for flamegraph.pl
        or inferno."""
        folded = self.folded()
        return "\n".join(f"{stack} {count}" for stack, count in sorted(folded.items()))

    def to_speedscope(self) -> dict:
        """A speedscope.app "sampled" profile of the folded table."""
        folded = self.folded()
        frame_index: dict[str, int] = {}
        frames: list[dict] = []
        samples: list[list[int]] = []
        weights: list[int] = []
        for stack, count in sorted(folded.items()):
            idxs: list[int] = []
            for name in stack.split(";"):
                idx = frame_index.get(name)
                if idx is None:
                    idx = frame_index[name] = len(frames)
                    frames.append({"name": name})
                idxs.append(idx)
            samples.append(idxs)
            weights.append(count)
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "shared": {"frames": frames},
            "profiles": [{
                "type": "sampled",
                "name": "hostprof",
                "unit": "none",
                "startValue": 0,
                "endValue": sum(weights),
                "samples": samples,
                "weights": weights,
            }],
            "exporter": "igaming-platform-tpu hostprof",
        }

    def snapshot(self) -> dict:
        with self._lock:
            folded = dict(self._folded)
            samples_total = self.samples_total
            roles_seen = sorted(self.threads_seen)
            last_duration_s = self.last_duration_s
        return {
            "running": self.running,
            "hz": self.hz,
            "samples_total": samples_total,
            "distinct_stacks": len(folded),
            "roles_seen": roles_seen,
            "registered_threads": len(registered_threads()),
            "last_duration_s": round(last_duration_s, 3),
            "top_stacks": self._rank(folded, 20),
        }


# ---------------------------------------------------------------------------
# Tier A: µs/row stage accounting and the GC and heap watch


class _StageAcc:
    __slots__ = ("spans", "rows", "total_us", "samples")

    def __init__(self):
        self.spans = 0
        self.rows = 0
        self.total_us = 0.0
        self.samples: deque = deque(maxlen=_SAMPLE_RESERVOIR)


def _add(acc: _StageAcc, us: float, rows, per_row: float | None) -> None:
    acc.spans += 1
    acc.total_us += us
    if per_row is not None:
        acc.rows += rows
        acc.samples.append(per_row)


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _per_row_block(total_us: float, rows: int, samples: list[float]) -> dict | None:
    if rows <= 0:
        return None
    samples.sort()
    return {"mean": round(total_us / rows, 4), "p50": round(_percentile(samples, 0.50), 4),
            "p99": round(_percentile(samples, 0.99), 4)}


class HostProfiler:
    """Tier A accounting and the Tier B sampler, one object per process
    (``get_default``). Rides the tracing span fan-out and ``gc.callbacks``;
    never wraps serving code."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._stages: dict[str, _StageAcc] = {}
        self._rpc = _StageAcc()
        self.sampler = StackSampler()
        self.metrics = None
        self._installed = False
        self._gc_installed = False
        # Written only by the GC callback, which runs for one collection at
        # a time with the GIL held.
        self._gc_start_ns: dict[int, int] = {}
        # Records of collections that found the lock held (module docstring).
        self._gc_pending: deque = deque()
        # Per generation, counted collections and pauses not yet on metrics.
        self._gc_unexported: dict[int, list] = {}
        self._gc_unexported_n = 0
        self._gc_collections: dict[int, int] = {}
        self._gc_pause_ms_total: dict[int, float] = {}
        self._gc_pauses: deque = deque(maxlen=_GC_PAUSE_RING)
        self._gc_pauses_in_rpc = 0
        self._gc_pause_in_rpc_ms = 0.0

    # -- install -------------------------------------------------------------

    def install(self, metrics=None) -> "HostProfiler":
        if metrics is not None:
            self.bind_metrics(metrics)
        if not self.enabled or self._installed:
            return self
        self._installed = True
        tracing.add_span_sink(self._on_span)
        self.install_gc_watch()
        return self

    def uninstall(self) -> None:
        if self._installed:
            tracing.remove_span_sink(self._on_span)
            self._installed = False
        if self._gc_installed:
            try:
                gc.callbacks.remove(self._gc_callback)
            except ValueError:
                pass
            self._gc_installed = False
        if self.sampler.running:
            self.sampler.stop()

    def bind_metrics(self, metrics) -> None:
        """Attach a ServiceMetrics: stage costs and GC pauses land on
        /metrics beside the serving series."""
        self.metrics = metrics

    def install_gc_watch(self) -> None:
        if self._gc_installed:
            return
        self._gc_installed = True
        gc.callbacks.append(self._gc_callback)

    # -- Tier A intake -------------------------------------------------------

    def _on_span(self, span) -> None:
        """Span sink: every completed span lands here, on serving threads.
        O(1) and never raises."""
        if self._gc_unexported_n >= _GC_EXPORT_BATCH:
            self.fold_gc()
        name = span.name
        us = span.duration_ms * 1000.0
        if name.startswith("rpc."):
            # The span completes on the thread that served the RPC.
            ident = threading.get_ident()
            entry = _THREAD_ROLES.get(ident)
            if entry is None or not _holds(ident, entry, {ident: threading.current_thread()}):
                register_scoring_thread("grpc_handler", ident)
            rows = span.attributes.get("rows")
            per_row = us / rows if isinstance(rows, int) and rows > 0 else None
            with self._lock:
                _add(self._rpc, us, rows, per_row)
            return
        if not name.startswith(_STAGE_PREFIX):
            return
        stage = name[len(_STAGE_PREFIX):]
        rows = span.attributes.get("batch")
        per_row = us / rows if isinstance(rows, int) and rows > 0 else None
        with self._lock:
            acc = self._stages.get(stage)
            if acc is not None:
                _add(acc, us, rows, per_row)
        if acc is None:
            # A new stage's accumulator is built outside the lock.
            fresh = _StageAcc()
            with self._lock:
                _add(self._stages.setdefault(stage, fresh), us, rows, per_row)
        m = self.metrics
        if m is not None and per_row is not None:
            m.host_stage_us_per_row.observe(per_row, exemplar=span.trace_id, stage=stage)

    # -- GC watch ------------------------------------------------------------

    def _gc_callback(self, phase: str, info: dict) -> None:
        """Never waits (module docstring): counts the collection under the
        lock when it is free, else leaves its record for the lock's next
        holder."""
        try:
            gen = int(info.get("generation", 0))
            if phase == "start":
                self._gc_start_ns[gen] = time.perf_counter_ns()
                return
            start_ns = self._gc_start_ns.pop(gen, None)
            if start_ns is None:
                return
            pause_ms = (time.perf_counter_ns() - start_ns) / 1e6
            # Which rpc.* roots were in flight when the world stopped? The
            # GIL is held during a collection, so each of them waited.
            inflight: dict[str, str] = {}
            for span in tracing.active_spans_by_thread().values():
                root = span.root if span.root is not None else span
                if root.name.startswith("rpc."):
                    inflight[root.span_id] = root.trace_id
            record = (gen, pause_ms, info.get("collected"), inflight)
            if not self._lock.acquire(blocking=False):
                self._gc_pending.append(record)
                return
            try:
                self._fold_pending_locked()
                self._count_locked(record)
            finally:
                self._lock.release()
        except Exception:  # noqa: BLE001 — a GC hook must never break a collection
            pass

    def _count_locked(self, record) -> None:
        """One collection into the counters; the caller holds the lock."""
        gen, pause_ms, collected, inflight = record
        self._gc_collections[gen] = self._gc_collections.get(gen, 0) + 1
        self._gc_pause_ms_total[gen] = self._gc_pause_ms_total.get(gen, 0.0) + pause_ms
        self._gc_pauses.append({
            "generation": gen,
            "pause_ms": round(pause_ms, 4),
            "collected": collected,
            "inflight_rpcs": len(inflight),
            "trace_ids": sorted(inflight.values())[:4],
        })
        if inflight:
            self._gc_pauses_in_rpc += 1
            self._gc_pause_in_rpc_ms += pause_ms
        unexported = self._gc_unexported.get(gen)
        if unexported is None:
            unexported = self._gc_unexported[gen] = [0, []]
        unexported[0] += 1
        unexported[1].append(pause_ms)
        self._gc_unexported_n += 1

    def _fold_pending_locked(self) -> None:
        """Count the records the deque holds now; the caller holds the lock."""
        pending = self._gc_pending
        for _ in range(len(pending)):
            self._count_locked(pending.popleft())

    def fold_gc(self) -> int:
        """Fold the pending records into the counters and export the counted
        collections to the metrics (one call a generation); returns how
        many collections were exported."""
        with self._lock:
            self._fold_pending_locked()
            unexported, self._gc_unexported = self._gc_unexported, {}
            self._gc_unexported_n = 0
        m = self.metrics
        if m is not None:
            for gen, (n, pauses) in sorted(unexported.items()):
                m.gc_collections_total.inc(n, generation=str(gen))
                m.gc_pause_ms.observe_many(pauses, generation=str(gen))
        return sum(n for n, _ in unexported.values())

    # -- snapshots -----------------------------------------------------------

    @staticmethod
    def _heap_block() -> dict:
        block = {
            "allocated_blocks": sys.getallocatedblocks(),
            "gc_counts": list(gc.get_count()),
            "gc_thresholds": list(gc.get_threshold()),
        }
        try:
            import resource

            block["ru_maxrss_kb"] = int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
        except Exception:  # noqa: BLE001 — resource is POSIX-only
            block["ru_maxrss_kb"] = None
        return block

    def _stage_block(self) -> dict:
        with self._lock:
            snap = [(stage, acc.spans, acc.rows, acc.total_us, list(acc.samples))
                    for stage, acc in self._stages.items()]
            rpc = (self._rpc.spans, self._rpc.rows, self._rpc.total_us, list(self._rpc.samples))
        out: dict[str, dict] = {}
        for stage, spans, rows, total_us, samples in sorted(snap):
            out[stage] = {"spans": spans, "rows": rows, "total_us": round(total_us, 1),
                          "us_per_row": _per_row_block(total_us, rows, samples)}
        spans, rows, total_us, samples = rpc
        rpc_block = {"rpcs": spans, "rows": rows, "total_us": round(total_us, 1),
                     "us_per_row": _per_row_block(total_us, rows, samples)}
        return {"stages": out, "rpc": rpc_block}

    def gc_snapshot(self) -> dict:
        self.fold_gc()
        with self._lock:
            return {
                "collections": {str(g): n for g, n in sorted(self._gc_collections.items())},
                "pause_ms_total": {str(g): round(v, 3)
                                   for g, v in sorted(self._gc_pause_ms_total.items())},
                "pauses_in_rpc": self._gc_pauses_in_rpc,
                "pause_in_rpc_ms": round(self._gc_pause_in_rpc_ms, 3),
                "recent_pauses": list(self._gc_pauses)[-20:],
            }

    def snapshot(self) -> dict:
        block = self._stage_block()
        return {
            "enabled": self.enabled,
            **block,
            "gc": self.gc_snapshot(),
            "heap": self._heap_block(),
            "sampler": self.sampler.snapshot(),
        }

    def reset(self) -> None:
        """Zero the accounting (a measurement isolates its window)."""
        fresh = _StageAcc()
        with self._lock:
            self._gc_pending.clear()
            self._gc_unexported = {}
            self._gc_unexported_n = 0
            self._stages.clear()
            self._rpc = fresh
            self._gc_collections.clear()
            self._gc_pause_ms_total.clear()
            self._gc_pauses.clear()
            self._gc_pauses_in_rpc = 0
            self._gc_pause_in_rpc_ms = 0.0
        self.sampler.reset()

    def to_json(self) -> str:
        return json.dumps(self.snapshot())


# ---------------------------------------------------------------------------
# The process default (/debug/hostprofz)

_DEFAULT: HostProfiler | None = None
_DEFAULT_LOCK = threading.Lock()


def get_default() -> HostProfiler:
    """The process's profiler, created on first use: Tier A installed unless
    ``HOSTPROF=0``, the sampler started at ``HOSTPROF_HZ`` when positive."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            enabled = os.environ.get("HOSTPROF", "1") != "0"
            _DEFAULT = HostProfiler(enabled=enabled).install()
            try:
                boot_hz = float(os.environ.get("HOSTPROF_HZ", "0"))
            except ValueError:
                boot_hz = 0.0
            if enabled and boot_hz > 0:
                _DEFAULT.sampler.start(boot_hz)
        return _DEFAULT


def install(metrics=None) -> HostProfiler:
    """Idempotent: bind (or rebind) ``metrics`` onto the default profiler."""
    return get_default().install(metrics)


def reinstall_from_env() -> HostProfiler:
    """Tear down and rebuild the default from ``HOSTPROF``/``HOSTPROF_HZ`` as
    they are now (a measurement's on and off turns flip them)."""
    _reset_default_for_tests()
    return get_default()


def _reset_default_for_tests() -> None:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is not None:
            _DEFAULT.uninstall()
        _DEFAULT = None
