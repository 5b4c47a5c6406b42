"""Flight recorder — the last N fully-decomposed requests, always on.

The port's copy of ``igaming_platform_tpu/obs/flight.py`` (pure Python, kept apart so
the port imports nothing of the JAX package).

A bounded ring of per-request summaries (trace id, method, total
duration, per-stage decomposition from the root span's ``stage_totals``),
dumpable at ``/debug/flightz``. Unlike the span ring (a flat buffer of
every stage span), each flight entry is one REQUEST with its latency
already attributed to stages — the artifact an operator reads first when
a p99 breach fires, and the source the bench arms aggregate into their
per-stage breakdown blocks.

Wired by ``install()``: the tracing module's root-span sink records every
completed ``rpc.*`` root here. Recording is O(1) per request (dict build
+ deque append) — cheap enough to leave on in production.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque

from igaming_platform_tpu_torch.obs import tracing


class FlightRecorder:
    """Bounded ring of decomposed request summaries."""

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, capacity)
        self._entries: deque[dict] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()

    def record(self, entry: dict) -> None:
        with self._lock:
            self._entries.append(entry)

    def record_root_span(self, span) -> None:
        """Root-span sink: only rpc.* roots are requests; batch-level
        roots (batcher-thread stage spans) stay out of the ring.

        With the pipelined host engine, one request's stages run
        concurrently on stage-worker threads, so the busy-time sum
        (``stage_busy_ms``) can exceed the request wall time; the
        interval-union wall (``stage_wall_ms``) is the time actually
        attributed to stages, and ``stage_overlap_ratio`` = 1 − wall/busy
        is how much host-stage work ran concurrently."""
        if not span.name.startswith("rpc."):
            return
        busy_ms = sum((span.stage_totals or {}).values())
        wall_ms = tracing.union_duration_ms(span.stage_windows)
        # Host-cost join (obs/hostprof.py's per-RPC face): the same
        # decomposition as stages_ms, but in µs and — when the handler
        # stamped a `rows` root attribute — per row, so one decision id
        # joins trace, flight, ledger AND cost.
        rows = span.attributes.get("rows")
        rows = rows if isinstance(rows, int) and rows > 0 else None
        stage_us = {
            k: round(v * 1000.0, 1) for k, v in (span.stage_totals or {}).items()
        }
        host_cost = {
            "rows": rows,
            "stage_us": stage_us,
            "us_per_row": (
                {k: round(us / rows, 3) for k, us in stage_us.items()}
                if rows else None),
        }
        self.record({
            "method": span.name[4:],
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "start_unix_s": span.start,
            "duration_ms": round(span.duration_ms, 3),
            "stages_ms": {
                k: round(v, 3) for k, v in (span.stage_totals or {}).items()
            },
            "stage_busy_ms": round(busy_ms, 3),
            "stage_wall_ms": round(wall_ms, 3),
            "stage_overlap_ratio": (
                round(max(0.0, 1.0 - wall_ms / busy_ms), 4) if busy_ms > 0 else 0.0
            ),
            "host_cost": host_cost,
            **{k: v for k, v in span.attributes.items()},
        })

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def to_json(self) -> str:
        return json.dumps(self.snapshot())


DEFAULT_RECORDER = FlightRecorder(
    int(os.environ.get("FLIGHT_RECORDER_CAPACITY", "256")))


def install(recorder: FlightRecorder | None = None) -> FlightRecorder:
    """Bind the tracing root-span sink to a recorder (idempotent for the
    default). Called at gRPC-layer import so the recorder is always on."""
    recorder = recorder or DEFAULT_RECORDER
    tracing.set_root_sink(recorder.record_root_span)
    return recorder


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def stage_breakdown(entries: list[dict], method: str | None = None) -> dict:
    """Aggregate flight entries into a per-stage p50/p99 block (the BENCH
    artifact shape): stage percentiles, RPC percentiles, and the p50 of
    per-request stage coverage (sum of stage durations / RPC duration) —
    the "no unattributed latency hole" figure the acceptance
    criterion reads."""
    if method is not None:
        entries = [e for e in entries if e.get("method") == method]
    if not entries:
        return {"requests": 0, "stages": {}}
    durs = sorted(e["duration_ms"] for e in entries)
    stage_vals: dict[str, list[float]] = {}
    coverage: list[float] = []
    overlap: list[float] = []
    for e in entries:
        stages = e.get("stages_ms") or {}
        for name, ms in stages.items():
            stage_vals.setdefault(name, []).append(ms)
        if e["duration_ms"] > 0:
            # Coverage counts wall time attributed to stages. Under the
            # pipelined engine stages overlap, so the per-stage SUM
            # over-counts; prefer the recorded interval-union wall and
            # fall back to the sum for pre-overlap entries.
            attributed = e.get("stage_wall_ms")
            if not attributed:
                attributed = sum(stages.values())
            coverage.append(min(1.0, attributed / e["duration_ms"]))
        if e.get("stage_overlap_ratio") is not None:
            overlap.append(e["stage_overlap_ratio"])
    return {
        "requests": len(entries),
        "rpc_p50_ms": round(_percentile(durs, 0.50), 3),
        "rpc_p99_ms": round(_percentile(durs, 0.99), 3),
        "stages": {
            name: {
                "p50_ms": round(_percentile(sorted(vals), 0.50), 3),
                "p99_ms": round(_percentile(sorted(vals), 0.99), 3),
                "requests": len(vals),
            }
            for name, vals in sorted(stage_vals.items())
        },
        "stage_coverage_p50": (
            round(_percentile(sorted(coverage), 0.50), 4) if coverage else None),
        "stage_overlap_ratio_p50": (
            round(_percentile(sorted(overlap), 0.50), 4) if overlap else None),
        "sample_trace_id": entries[-1].get("trace_id", ""),
    }
