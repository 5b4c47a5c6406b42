"""Fleet aggregation plane — cross-replica rollups served at /debug/fleetz.

The fleet scales scoring out to N replicas behind the router; every replica
still answers observability questions alone (/metrics, /debug/flightz,
/debug/supervisorz, /debug/sloz). This module is the join: a jittered
ticker scrapes each replica's sidecar with bounded timeouts, merges the
per-stage latency histograms BUCKET-WISE (a fleet p99 computed from
per-replica p99s is wrong; from merged buckets it is exact to bucket
resolution), and serves one fleet snapshot:

- fleet p50/p99 per stage from the merged ``risk_stage_latency_ms``
  histograms, exemplars retained from the worst populated bucket so the
  fleet dashboard still click-throughs to a real trace id;
- per-replica SLO burn / alert state (scraped from ``/debug/sloz``);
- per-replica supervisor state and the router's ring snapshot;
- the slowest recent traces FLEET-WIDE: flight-ring entries from every
  replica joined on trace id (a trace that crossed the router and a
  replica shows as one trace with hops), ranked by duration.

Liveness contract (the part chaos drills gate on): a dead or SIGSTOP'd
replica must never block the plane. Scrapes run on worker threads with
hard timeouts; ``snapshot()`` only ever reads the last-good state under
a lock and stamps staleness (``age_s``, ``stale``) per replica — the
fleet view degrades to "r2's numbers are 14 s old", never to a hang.

Histogram layouts are part of the merge contract: replicas running
different bucket boundaries (a half-upgraded fleet) are REJECTED loudly
per-merge (ValueError, counted in scrape errors) rather than silently
summed into garbage percentiles.
"""

from __future__ import annotations

import json
import logging
import os
import random
import re
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Prometheus text-format histogram parsing + bucket-wise merge


_BUCKET_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)_bucket\{(?P<labels>[^}]*)\}\s+"
    r"(?P<value>[0-9.eE+-]+)"
    r"(?:\s+#\s+\{trace_id=\"(?P<ex_trace>[^\"]*)\"\}\s+"
    r"(?P<ex_value>[0-9.eE+-]+)\s+[0-9.eE+-]+)?\s*$")
_SUMCOUNT_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)_(?P<kind>sum|count)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>[0-9.eE+-]+)\s*$")
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


class HistogramSnapshot:
    """One (metric, labelset) histogram parsed off /metrics text.

    ``buckets`` is the ordered list of ``le`` boundary strings (``+Inf``
    last); ``counts`` the CUMULATIVE per-bucket counts; ``exemplars``
    maps bucket index -> (trace_id, value)."""

    def __init__(self, name: str, labels: tuple, buckets: list[str]):
        self.name = name
        self.labels = labels
        self.buckets = list(buckets)
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0
        self.exemplars: dict[int, tuple[str, float]] = {}

    def merge(self, other: "HistogramSnapshot") -> None:
        """Bucket-wise sum. Mixed layouts fail LOUDLY — summing
        mismatched boundaries silently fabricates percentiles."""
        if self.buckets != other.buckets:
            raise ValueError(
                f"histogram {self.name}{dict(self.labels)}: bucket layout "
                f"mismatch ({self.buckets} vs {other.buckets}) — refusing "
                "a bucket-wise merge across incompatible layouts")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count
        for i, ex in other.exemplars.items():
            mine = self.exemplars.get(i)
            # Keep the WORST (highest-valued) exemplar per bucket: the
            # one a latency investigation wants to click through to.
            if mine is None or ex[1] > mine[1]:
                self.exemplars[i] = ex

    def percentile(self, q: float) -> float:
        """Upper-bound percentile from cumulative buckets (the same
        estimator obs/metrics.Histogram.percentile uses)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        for le, c in zip(self.buckets, self.counts):
            if c >= target:
                return float("inf") if le == "+Inf" else float(le)
        return float("inf")

    def worst_exemplar(self) -> tuple[str, float] | None:
        """The exemplar from the highest POPULATED bucket that has one."""
        for i in range(len(self.buckets) - 1, -1, -1):
            if i in self.exemplars:
                return self.exemplars[i]
        return None


def parse_histograms(text: str) -> dict[str, dict[tuple, HistogramSnapshot]]:
    """Parse every histogram family out of Prometheus exposition text:
    {metric_name: {labelset (without ``le``): HistogramSnapshot}}."""
    out: dict[str, dict[tuple, HistogramSnapshot]] = {}
    order: dict[tuple, list[str]] = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        m = _BUCKET_RE.match(line)
        if m:
            labels = dict(_LABEL_RE.findall(m.group("labels")))
            le = labels.pop("le", None)
            if le is None:
                continue
            key = tuple(sorted(labels.items()))
            fam = out.setdefault(m.group("name"), {})
            snap = fam.get(key)
            if snap is None:
                snap = fam[key] = HistogramSnapshot(m.group("name"), key, [])
            snap.buckets.append(le)
            snap.counts.append(int(float(m.group("value"))))
            order.setdefault((m.group("name"), key), []).append(le)
            if m.group("ex_trace"):
                snap.exemplars[len(snap.buckets) - 1] = (
                    m.group("ex_trace"), float(m.group("ex_value")))
            continue
        m = _SUMCOUNT_RE.match(line)
        if m and m.group("name") in out:
            labels = dict(_LABEL_RE.findall(m.group("labels") or ""))
            key = tuple(sorted(labels.items()))
            snap = out[m.group("name")].get(key)
            if snap is None:
                continue
            if m.group("kind") == "sum":
                snap.sum = float(m.group("value"))
            else:
                snap.count = int(float(m.group("value")))
    return out


def merge_histograms(
        snaps: Iterable[HistogramSnapshot]) -> HistogramSnapshot | None:
    """Bucket-wise merge of same-layout snapshots (ValueError on mixed
    layouts). Returns None for an empty input."""
    merged: HistogramSnapshot | None = None
    for snap in snaps:
        if merged is None:
            merged = HistogramSnapshot(snap.name, snap.labels, snap.buckets)
        merged.merge(snap)
    return merged


# ---------------------------------------------------------------------------
# Host-cost rollup (/debug/hostprofz -> fleet view)


def fleet_host_stage_block(
        hostprofzs: list[tuple[str, dict | None]]) -> dict:
    """Merge per-replica hostprofz stage tables into one fleet view:
    summed spans/rows/µs per stage (totals and rows are additive; the
    fleet mean µs/row is total µs over total rows — exact, unlike
    averaging per-replica means), plus the fleet-wide hottest stage by
    total host µs and each replica's own hottest stage."""
    stages: dict[str, dict] = {}
    per_replica_hottest: dict[str, str | None] = {}
    reporting = 0
    for rid, payload in hostprofzs:
        table = (payload or {}).get("stages")
        if not isinstance(table, dict):
            continue
        reporting += 1
        hottest = None
        hottest_us = -1.0
        for stage, row in table.items():
            if not isinstance(row, dict):
                continue
            agg = stages.setdefault(stage, {
                "spans": 0, "rows": 0, "total_us": 0.0})
            agg["spans"] += int(row.get("spans") or 0)
            agg["rows"] += int(row.get("rows") or 0)
            total_us = float(row.get("total_us") or 0.0)
            agg["total_us"] += total_us
            if total_us > hottest_us:
                hottest, hottest_us = stage, total_us
        per_replica_hottest[rid] = hottest
    for agg in stages.values():
        agg["total_us"] = round(agg["total_us"], 1)
        agg["us_per_row_mean"] = (
            round(agg["total_us"] / agg["rows"], 4) if agg["rows"] else None)
    fleet_hottest = max(
        stages.items(), key=lambda kv: kv[1]["total_us"])[0] if stages else None
    return {
        "replicas_reporting": reporting,
        "stages": dict(sorted(stages.items())),
        "hottest_stage": fleet_hottest,
        "per_replica_hottest": per_replica_hottest,
    }


# ---------------------------------------------------------------------------
# The scraping plane


class _ReplicaState:
    """Last-good scrape per replica + staleness accounting."""

    def __init__(self, rid: str, http_addr: str):
        self.rid = rid
        self.http_addr = http_addr
        self.histograms: dict[str, dict[tuple, HistogramSnapshot]] = {}
        self.supervisorz: dict | None = None
        self.sloz: dict | None = None
        self.driftz: dict | None = None
        self.cachez: dict | None = None
        self.hostprofz: dict | None = None
        self.flight: list[dict] = []
        self.last_good_monotonic: float | None = None
        self.consecutive_failures = 0
        self.last_error: str | None = None


class FleetView:
    """Scrape-merge-serve. ``targets`` maps replica id -> HTTP sidecar
    address (host:port); pass a callable for fleets whose membership
    changes (restarted replicas keep their ports, so the router's static
    spec works too). ``ring_provider`` (the router's ``snapshot``) rides
    along into /debug/fleetz."""

    STAGE_HISTOGRAM = "risk_stage_latency_ms"

    def __init__(self, targets: dict[str, str] | Callable[[], dict[str, str]],
                 *, interval_s: float | None = None,
                 timeout_s: float | None = None,
                 stale_after_s: float | None = None,
                 metrics=None,
                 ring_provider: Callable[[], dict] | None = None,
                 rng: random.Random | None = None,
                 slowest_traces: int = 10):
        if interval_s is None:
            interval_s = float(os.environ.get("FLEETVIEW_INTERVAL_S", "1.0"))
        if timeout_s is None:
            timeout_s = float(os.environ.get("FLEETVIEW_TIMEOUT_S", "0.5"))
        if stale_after_s is None:
            stale_after_s = float(os.environ.get(
                "FLEETVIEW_STALE_AFTER_S", str(max(3.0, 3 * interval_s))))
        self._targets = targets
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.stale_after_s = stale_after_s
        self.metrics = metrics
        self.ring_provider = ring_provider
        self.slowest_traces = slowest_traces
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._replicas: dict[str, _ReplicaState] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # A SIGSTOP'd replica holds its scrape thread for the full
        # timeout; a small pool keeps one hung replica from serializing
        # the others' scrapes behind it.
        self._pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="fleetview-scrape")
        self.scrapes_total = 0
        self.scrape_errors_total = 0

    # -- scraping ------------------------------------------------------------

    def _resolve_targets(self) -> dict[str, str]:
        t = self._targets
        return dict(t() if callable(t) else t)

    def _fetch(self, addr: str, path: str) -> bytes:
        with urllib.request.urlopen(
                f"http://{addr}{path}", timeout=self.timeout_s) as resp:
            return resp.read()

    def _scrape_replica(self, state: _ReplicaState) -> None:
        t0 = time.monotonic()
        try:
            metrics_text = self._fetch(state.http_addr, "/metrics").decode()
            histograms = parse_histograms(metrics_text)
            # Debug surfaces are best-effort per-endpoint: a replica
            # without a supervisor (404) still contributes histograms.
            supervisorz = sloz = driftz = cachez = hostprofz = None
            flight: list[dict] = []
            for path, setter in (
                ("/debug/supervisorz", "supervisorz"),
                ("/debug/sloz", "sloz"),
                ("/debug/driftz", "driftz"),
                ("/debug/cachez", "cachez"),
                ("/debug/hostprofz", "hostprofz"),
                ("/debug/flightz", "flight"),
            ):
                try:
                    payload = json.loads(self._fetch(state.http_addr, path))
                except Exception:  # noqa: BLE001 — optional surface; histograms already landed
                    continue
                if setter == "supervisorz":
                    supervisorz = payload
                elif setter == "sloz":
                    sloz = payload
                elif setter == "driftz":
                    driftz = payload if isinstance(payload, dict) else None
                elif setter == "cachez":
                    cachez = payload if isinstance(payload, dict) else None
                elif setter == "hostprofz":
                    hostprofz = payload if isinstance(payload, dict) else None
                else:
                    flight = payload if isinstance(payload, list) else []
        except Exception as exc:  # noqa: BLE001 — a dead/hung replica must not kill the ticker
            with self._lock:
                state.consecutive_failures += 1
                state.last_error = repr(exc)[:200]
                self.scrape_errors_total += 1
            if self.metrics is not None:
                self.metrics.fleet_scrape_failures_total.inc(replica=state.rid)
            return
        with self._lock:
            state.histograms = histograms
            state.supervisorz = supervisorz
            state.sloz = sloz
            state.driftz = driftz
            state.cachez = cachez
            state.hostprofz = hostprofz
            state.flight = flight
            state.last_good_monotonic = time.monotonic()
            state.consecutive_failures = 0
            state.last_error = None
            self.scrapes_total += 1
        if self.metrics is not None:
            self.metrics.fleet_scrape_ms.observe(
                (time.monotonic() - t0) * 1000.0)

    def scrape_once(self) -> None:
        """One full scrape pass (what the ticker runs; tests call it
        directly). Bounded: a hung replica costs one pool worker for
        ``timeout_s`` per endpoint, never the caller."""
        targets = self._resolve_targets()
        with self._lock:
            for rid, addr in targets.items():
                st = self._replicas.get(rid)
                if st is None:
                    self._replicas[rid] = _ReplicaState(rid, addr)
                elif st.http_addr != addr:
                    st.http_addr = addr
            states = [self._replicas[rid] for rid in targets]
        futures = [self._pool.submit(self._scrape_replica, st)
                   for st in states]
        deadline = time.monotonic() + 4 * self.timeout_s + 1.0
        for fut in futures:
            fut.result(timeout=max(0.05, deadline - time.monotonic()))
        self._update_freshness_metrics()

    def _update_freshness_metrics(self) -> None:
        if self.metrics is None:
            return
        now = time.monotonic()
        fresh = stale = 0
        with self._lock:
            for st in self._replicas.values():
                if (st.last_good_monotonic is not None
                        and now - st.last_good_monotonic < self.stale_after_s
                        and st.consecutive_failures == 0):
                    fresh += 1
                else:
                    stale += 1
        self.metrics.fleet_replicas_scraped.set(fresh, freshness="fresh")
        self.metrics.fleet_replicas_scraped.set(stale, freshness="stale")

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 — ticker must survive any scrape pathology
                logger.warning("fleetview scrape pass failed", exc_info=True)
            # Jittered tick (0.7x-1.3x): a fleet of scrapers must not
            # hammer every replica sidecar in lockstep.
            self._stop.wait(self.interval_s * (0.7 + 0.6 * self._rng.random()))

    def start(self) -> "FleetView":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="fleetview-ticker", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._pool.shutdown(wait=False)

    # -- the fleet snapshot --------------------------------------------------

    def snapshot(self) -> dict:
        """The /debug/fleetz payload — ALWAYS from last-good state, never
        a live scrape: serving this must be O(merge), not O(network)."""
        now = time.monotonic()
        with self._lock:
            replicas = list(self._replicas.values())
            states: list[dict] = []
            per_replica_hists: list[tuple[str, dict]] = []
            flights: list[tuple[str, list[dict]]] = []
            driftzs: list[tuple[str, dict | None]] = []
            hostprofzs: list[tuple[str, dict | None]] = []
            merge_errors: list[str] = []
            for st in replicas:
                age = (None if st.last_good_monotonic is None
                       else now - st.last_good_monotonic)
                stale = (age is None or age > self.stale_after_s
                         or st.consecutive_failures > 0)
                sup = st.supervisorz or {}
                slo = st.sloz or {}
                windows = slo.get("windows", {})
                states.append({
                    "replica": st.rid,
                    "http_addr": st.http_addr,
                    "stale": stale,
                    "age_s": round(age, 3) if age is not None else None,
                    "consecutive_failures": st.consecutive_failures,
                    "last_error": st.last_error,
                    "serving_state": sup.get("state"),
                    "slo": {
                        "fast_burn_rate": windows.get("fast", {}).get("burn_rate"),
                        "slow_burn_rate": windows.get("slow", {}).get("burn_rate"),
                        "fast_alert": windows.get("fast", {}).get("alert"),
                        "slow_alert": windows.get("slow", {}).get("alert"),
                        "attainment_fast": windows.get("fast", {}).get("attainment"),
                        "top_budget_stage": windows.get("fast", {}).get(
                            "budget_attribution", {}).get("top_stage"),
                        "violations_total": slo.get("violations_total"),
                    } if slo else None,
                    # Slot-sharded state breakdown (/debug/cachez): the
                    # per-shard occupancy/HBM view the capacity plane
                    # reads fleet-wide.
                    "state_shards": ({
                        "capacity": st.cachez.get("capacity"),
                        "occupancy": st.cachez.get("occupancy"),
                        "shards": st.cachez.get("shards"),
                        "session": st.cachez.get("session_shards"),
                    } if st.cachez else None),
                })
                per_replica_hists.append((st.rid, st.histograms))
                flights.append((st.rid, st.flight))
                driftzs.append((st.rid, st.driftz))
                hostprofzs.append((st.rid, st.hostprofz))
        # Merge OUTSIDE the lock (pure compute over snapshotted refs).
        stages: dict[str, HistogramSnapshot] = {}
        for rid, hists in per_replica_hists:
            fam = hists.get(self.STAGE_HISTOGRAM, {})
            for key, snap in fam.items():
                stage = dict(key).get("stage", "")
                if not stage:
                    continue
                try:
                    if stage in stages:
                        stages[stage].merge(snap)
                    else:
                        stages[stage] = merge_histograms([snap])
                except ValueError as exc:
                    merge_errors.append(f"{rid}/{stage}: {exc}")
        stage_block = {}
        for stage, snap in sorted(stages.items()):
            ex = snap.worst_exemplar()
            stage_block[stage] = {
                "p50_ms": snap.percentile(0.50),
                "p99_ms": snap.percentile(0.99),
                "count": snap.count,
                "exemplar_trace_id": ex[0] if ex else None,
            }
        # Drift-state merge (obs/drift.py): the per-replica window
        # sketches sum bucket-wise into one fleet view; mixed histogram
        # edges are rejected loudly into merge_errors — the same
        # discipline as the stage-histogram merge above.
        from igaming_platform_tpu_torch.obs import drift as drift_mod

        try:
            fleet_drift = drift_mod.fleet_drift_block(driftzs)
            merge_errors.extend(
                f"drift/{err}" for err in fleet_drift.get("merge_errors", ()))
        except Exception as exc:  # noqa: BLE001 — the drift rollup must not take down the fleet page
            fleet_drift = {"error": repr(exc)[:200]}
        # Fleet capacity rollup: aggregate admissible slots + state HBM
        # over the replicas that reported /debug/cachez — the number a
        # pod-as-unit scheduler sizes admission against.
        reporting = [s["state_shards"] for s in states
                     if s.get("state_shards")]
        fleet_capacity = {
            "replicas_reporting": len(reporting),
            "capacity_slots": sum(r.get("capacity") or 0 for r in reporting),
            "hbm_bytes": sum(
                sum((r.get("shards") or {}).get("hbm_bytes", []) or [])
                + sum((r.get("session") or {}).get("hbm_bytes", []) or [])
                for r in reporting),
        }
        return {
            "generated_unix_s": round(time.time(), 3),
            "stale_after_s": self.stale_after_s,
            "replicas": states,
            "fleet_capacity": fleet_capacity,
            "fleet_stage_latency_ms": stage_block,
            "fleet_host_stage": fleet_host_stage_block(hostprofzs),
            "fleet_drift": fleet_drift,
            "histogram_merge_errors": merge_errors,
            "slowest_traces": self._slowest_traces(flights),
            "ring": self._ring(),
            "scrapes_total": self.scrapes_total,
            "scrape_errors_total": self.scrape_errors_total,
        }

    def _ring(self) -> dict | None:
        if self.ring_provider is None:
            return None
        try:
            return self.ring_provider()
        except Exception:  # noqa: BLE001 — ring detail is advisory on the fleet page
            return None

    def _slowest_traces(
            self, flights: list[tuple[str, list[dict]]]) -> list[dict]:
        """Join flight entries fleet-wide on trace id, rank by the
        slowest hop. A trace seen by both the router and a replica (or
        by two replicas after a failover) becomes ONE row with hops."""
        by_trace: dict[str, dict] = {}
        for rid, entries in flights:
            for entry in entries:
                tid = entry.get("trace_id", "")
                if not tid:
                    continue
                row = by_trace.setdefault(tid, {
                    "trace_id": tid, "duration_ms": 0.0,
                    "decision_id": None, "hops": [],
                })
                row["hops"].append({
                    "replica": rid,
                    "method": entry.get("method"),
                    "duration_ms": entry.get("duration_ms"),
                    "stages_ms": entry.get("stages_ms"),
                    "anomaly": entry.get("anomaly"),
                    "serving_state": entry.get("serving_state"),
                })
                row["duration_ms"] = max(
                    row["duration_ms"], entry.get("duration_ms") or 0.0)
                if entry.get("decision_id"):
                    row["decision_id"] = entry["decision_id"]
        ranked = sorted(by_trace.values(),
                        key=lambda r: r["duration_ms"], reverse=True)
        return ranked[:self.slowest_traces]
