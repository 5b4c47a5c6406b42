"""Prometheus-style metrics — implementing what the reference stubs.

The port's copy of ``igaming_platform_tpu/obs/metrics.py`` (pure Python, kept apart so
the port imports nothing of the JAX package).

The reference deploys Prometheus+Grafana but its metrics interceptors are
TODOs (wallet/cmd/main.go:306-311; risk/cmd/main.go:344-353 lists the
intended series without recording them). This registry records that exact
set — request counts, latency histograms, error counts, score distribution
— plus the BASELINE series (txns/sec, batch occupancy) and renders the
Prometheus text exposition format for the /metrics sidecar.

Dependency-free: counters/gauges/histograms over a lock, no client lib.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable

_DEFAULT_BUCKETS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500)


def _label_key(labels: dict[str, str]) -> tuple:
    return tuple(sorted(labels.items()))


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} counter"
        # Snapshot under the lock: a concurrent inc() during a /metrics
        # scrape must not race the dict iteration.
        with self._lock:
            values = sorted(self._values.items())
        for key, v in values:
            yield f"{self.name}{_fmt_labels(key)} {v}"


class Gauge:
    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = value

    def value(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} gauge"
        with self._lock:
            values = sorted(self._values.items())
        for key, v in values:
            yield f"{self.name}{_fmt_labels(key)} {v}"


class Histogram:
    def __init__(self, name: str, help_text: str = "", buckets: tuple = _DEFAULT_BUCKETS):
        self.name = name
        self.help = help_text
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}
        # Latest exemplar per (labelset, bucket index): (trace_id, value,
        # unix_ts). Rendered OpenMetrics-style on the bucket line, so a
        # p99 breach on the dashboard links straight to a trace id in the
        # flight recorder / Jaeger. len(buckets) indexes the +Inf bucket.
        self._exemplars: dict[tuple, dict[int, tuple[str, float, float]]] = {}
        self._lock = threading.Lock()

    def _bucket_index(self, value: float) -> int:
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                return i
        return len(self.buckets)

    def _note_exemplar(self, key: tuple, value: float, exemplar: str) -> None:
        """Caller holds the lock."""
        self._exemplars.setdefault(key, {})[self._bucket_index(value)] = (
            str(exemplar), float(value), time.time())

    def observe(self, value: float, exemplar: str | None = None, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1
            if exemplar is not None:
                self._note_exemplar(key, value, exemplar)

    def observe_many(self, values, exemplar: str | None = None, **labels: str) -> None:
        """Vectorized observe for batch paths: one lock hold + one
        histogram pass for N values (a per-row observe() on an 8192-row
        wire batch would put Python loops back on the hot path)."""
        import numpy as np

        arr = np.asarray(values, dtype=np.float64).ravel()
        if arr.size == 0:
            return
        key = _label_key(labels)
        # counts[i] = how many values <= buckets[i] (cumulative, matching
        # observe()'s per-bucket increments).
        le_counts = np.searchsorted(np.sort(arr), self.buckets, side="right")
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, c in enumerate(le_counts):
                counts[i] += int(c)
            self._sums[key] = self._sums.get(key, 0.0) + float(arr.sum())
            self._totals[key] = self._totals.get(key, 0) + int(arr.size)
            if exemplar is not None:
                # One exemplar per batch: the worst value is the one a
                # latency investigation wants to click through to.
                self._note_exemplar(key, float(arr.max()), exemplar)

    def percentile(self, q: float, **labels: str) -> float:
        """Approximate percentile from bucket boundaries (upper bound)."""
        key = _label_key(labels)
        with self._lock:
            total = self._totals.get(key, 0)
            if total == 0:
                return 0.0
            target = q * total
            counts = self._counts[key]
            for i, bound in enumerate(self.buckets):
                if counts[i] >= target:
                    return bound
            return float("inf")

    def count(self, **labels: str) -> int:
        # Same discipline as percentile()/render(): _totals is written
        # under _lock from scorer threads, so read it under _lock too.
        with self._lock:
            return self._totals.get(_label_key(labels), 0)

    @staticmethod
    def _exemplar_suffix(ex: tuple[str, float, float] | None) -> str:
        if ex is None:
            return ""
        trace_id, value, ts = ex
        return f' # {{trace_id="{trace_id}"}} {value} {round(ts, 3)}'

    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        with self._lock:
            snap = {
                key: (list(self._counts[key]), self._sums[key],
                      self._totals[key], dict(self._exemplars.get(key, {})))
                for key in self._totals
            }
        for key in sorted(snap):
            counts, _sum, _total, exemplars = snap[key]
            for i, (bound, c) in enumerate(zip(self.buckets, counts)):
                lk = key + (("le", str(bound)),)
                yield (f"{self.name}_bucket{_fmt_labels(tuple(sorted(lk)))} {c}"
                       f"{self._exemplar_suffix(exemplars.get(i))}")
            lk = key + (("le", "+Inf"),)
            yield (f"{self.name}_bucket{_fmt_labels(tuple(sorted(lk)))} {_total}"
                   f"{self._exemplar_suffix(exemplars.get(len(self.buckets)))}")
            yield f"{self.name}_sum{_fmt_labels(key)} {_sum}"
            yield f"{self.name}_count{_fmt_labels(key)} {_total}"


class Registry:
    def __init__(self):
        self._metrics: list = []
        self._lock = threading.Lock()

    def counter(self, name: str, help_text: str = "") -> Counter:
        m = Counter(name, help_text)
        with self._lock:
            self._metrics.append(m)
        return m

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        m = Gauge(name, help_text)
        with self._lock:
            self._metrics.append(m)
        return m

    def histogram(self, name: str, help_text: str = "", buckets: tuple = _DEFAULT_BUCKETS) -> Histogram:
        m = Histogram(name, help_text, buckets)
        with self._lock:
            self._metrics.append(m)
        return m

    def render_text(self) -> str:
        lines: list[str] = []
        with self._lock:
            for m in self._metrics:
                lines.extend(m.render())
        return "\n".join(lines) + "\n"


class ServiceMetrics:
    """The series the reference's stubs name (risk/cmd/main.go:344-353)."""

    def __init__(self, service: str, registry: Registry | None = None):
        self.registry = registry or Registry()
        self.requests_total = self.registry.counter(
            f"{service}_grpc_requests_total", "gRPC requests by method and code"
        )
        self.request_duration_ms = self.registry.histogram(
            f"{service}_grpc_request_duration_ms", "gRPC request latency (ms)"
        )
        self.errors_total = self.registry.counter(
            f"{service}_grpc_errors_total", "gRPC errors by method"
        )
        self.score_distribution = self.registry.histogram(
            f"{service}_risk_score", "Fraud score distribution",
            buckets=(10, 20, 30, 40, 50, 60, 70, 80, 90, 100),
        )
        self.txns_scored_total = self.registry.counter(
            f"{service}_txns_scored_total", "Transactions fraud-scored"
        )
        self.batch_occupancy = self.registry.histogram(
            f"{service}_batch_occupancy", "Rows per device batch",
            buckets=(1, 8, 32, 64, 128, 256, 512, 1024),
        )
        self.abuse_shed_total = self.registry.counter(
            f"{service}_abuse_shed_total",
            "CheckBonusAbuse requests shed with UNAVAILABLE "
            "(ABUSE_CPU_POLICY=shed on a degraded deployment)",
        )
        self.bulk_shed_total = self.registry.counter(
            f"{service}_bulk_shed_total",
            "Bulk ScoreBatch RPCs rejected RESOURCE_EXHAUSTED by admission "
            "control (BULK_MAX_INFLIGHT) so the single-txn fast lane keeps "
            "its latency SLO under overload",
        )
        self.bulk_gate_limit = self.registry.gauge(
            f"{service}_bulk_gate_limit",
            "Current bulk-admission in-flight limit (p99-feedback controller "
            "tightens it below BULK_MAX_INFLIGHT when single-txn latency "
            "breaches BULK_P99_SLO_MS)",
        )
        # Device-resident HBM feature cache (serve/device_cache.py): the
        # index-mode wire ships int32 slot indices instead of feature rows;
        # these series are the cache's health dashboard.
        self.feature_cache_hits_total = self.registry.counter(
            f"{service}_feature_cache_hits_total",
            "ScoreBatch rows served from the device-resident feature table",
        )
        self.feature_cache_misses_total = self.registry.counter(
            f"{service}_feature_cache_misses_total",
            "Rows host-gathered and promoted into the device table (cold "
            "account or capacity miss)",
        )
        self.feature_cache_evictions_total = self.registry.counter(
            f"{service}_feature_cache_evictions_total",
            "Resident rows reclaimed by the CLOCK hand to admit new accounts",
        )
        self.feature_cache_deltas_total = self.registry.counter(
            f"{service}_feature_cache_deltas_total",
            "Per-account delta rows folded into HBM by the jitted scatter",
        )
        self.feature_cache_occupancy = self.registry.gauge(
            f"{service}_feature_cache_occupancy",
            "Device feature-table slots currently resident",
        )
        # Slot-sharded state (parallel/state_sharding.py): per-shard
        # breakdowns, labels bounded by the mesh data-axis size (<= 8 on
        # a v5e-8 — MX05-clean).
        self.cache_shard_occupancy = self.registry.gauge(
            f"{service}_cache_shard_occupancy",
            "Resident feature-table slots per mesh shard ({shard} = "
            "data-axis index; one series when the table is replicated) "
            "— a skewed spread means the CLOCK hand is fighting a hot "
            "key range, see docs/operations.md 'Pod-as-unit fleet'",
        )
        # Per-shard state bytes ride the existing {service}_hbm_bytes
        # gauge (registered with the runtime-telemetry block below) as
        # {shard, table} series beside its backend {kind} series.
        # Business-level series backing the Grafana dashboards the reference
        # README promises (README.md:196-202) but ships no data for: per-type
        # transaction flow (bonus conversion = bonus_grant rate vs deposit
        # rate) and LTV segment assignment counts.
        self.transactions_total = self.registry.counter(
            f"{service}_transactions_total", "Completed transactions by type"
        )
        self.transaction_amount_cents = self.registry.counter(
            f"{service}_transaction_amount_cents_total", "Transaction volume in cents by type"
        )
        self.ltv_segment_total = self.registry.counter(
            f"{service}_ltv_segment_total", "LTV segment assignments by segment"
        )
        self.reconciliation_checked = self.registry.gauge(
            f"{service}_reconciliation_checked", "Accounts checked by the last reconciliation sweep"
        )
        self.reconciliation_mismatched = self.registry.gauge(
            f"{service}_reconciliation_mismatched", "Balance/ledger mismatches in the last sweep"
        )
        # Request-lifecycle tracing (obs/tracing.py): every stage span on
        # the serving path lands here by stage name, with the worst sample
        # per bucket carrying its trace id as an exemplar — a p99 breach
        # on the dashboard links straight to a flight-recorder entry.
        self.stage_latency_ms = self.registry.histogram(
            f"{service}_stage_latency_ms",
            "Serving-path stage latency (ms) by lifecycle stage "
            "(score.admission/decode/gather/cache_lookup/dispatch/"
            "readback/encode/queue, follower.device_step); bucket lines "
            "carry trace-id exemplars",
            buckets=(0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000),
        )
        self.batcher_queue_depth = self.registry.gauge(
            f"{service}_batcher_queue_depth",
            "Requests still waiting in the continuous batcher's queue at "
            "the moment a batch was assembled",
        )
        self.batcher_time_in_queue_ms = self.registry.histogram(
            f"{service}_batcher_time_in_queue_ms",
            "Per-request wait (ms) between batcher enqueue and batch "
            "assembly — the batching-window share of single-txn latency",
            buckets=(0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250),
        )
        # Deadline scheduler (serve/deadline.py + serve/batcher.py): the
        # admission→dispatch deadline plane. Labels are bounded
        # enumerations per MX05: lane ∈ {interactive, bulk, background},
        # stage ∈ {admission, dispatch, router}.
        self.deadline_remaining_ms = self.registry.histogram(
            f"{service}_deadline_remaining_ms",
            "Remaining per-request deadline budget (ms) at the moment its "
            "batch dispatched — the headroom the scheduler left the device "
            "step + readback + encode; mass near 0 means admitted requests "
            "are barely making it",
            buckets=(1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000),
        )
        self.deadline_expired_total = self.registry.counter(
            f"{service}_deadline_expired_total",
            "Requests shed because their deadline budget was already spent, "
            "by {stage}: admission = rejected at the RPC edge before any "
            "work, dispatch = expired while queued in the scheduler (shed "
            "at batch assembly, never scored dead), router = rejected at "
            "the L7 router hop — all DEADLINE_EXCEEDED + retry-pushback, "
            "counted as sheds, never SLO budget burn",
        )
        self.lane_depth = self.registry.gauge(
            f"{service}_lane_depth",
            "Queued requests per scheduler priority {lane} (interactive "
            "ScoreTransaction > bulk ScoreBatch > background jobs) at the "
            "last submit/assembly — the per-lane view of "
            "batcher_queue_depth",
        )
        self.batch_size_chosen = self.registry.histogram(
            f"{service}_batch_size_chosen",
            "Padded batch shape the deadline scheduler planned per tick "
            "against the tightest admitted deadline and the online "
            "step-time model — small tiers under tight budgets, the "
            "throughput shape when there is slack",
            buckets=(1, 8, 32, 64, 128, 256, 512, 1024, 2048, 4096),
        )
        # Pipelined host engine (serve/pipeline_engine.py): stage-worker
        # health for the wire batch paths.
        self.pipeline_inflight = self.registry.gauge(
            f"{service}_pipeline_inflight",
            "Device batches currently in flight in the staged host "
            "pipeline (dispatched, readback pending); bounded by the "
            "configured pipeline depth plus the batch each stage worker "
            "holds in hand",
        )
        self.pipeline_overlap_ratio = self.registry.gauge(
            f"{service}_pipeline_overlap_ratio",
            "Host-stage overlap ratio of the pipelined wire path "
            "(1 - active wall / summed stage busy time): 0 = stages run "
            "back-to-back, higher = gather/dispatch/readback/encode "
            "genuinely concurrent",
        )
        # Self-healing supervisor (serve/supervisor.py): the serving state
        # machine, per-dependency circuit breakers, and the degraded
        # scoring tier — the availability dashboard for chaos soaks.
        self.serving_state = self.registry.gauge(
            f"{service}_serving_state",
            "Serving state machine: 0=SERVING (all dependencies healthy), "
            "1=DEGRADED (a dependency circuit is open; answers flow via "
            "the heuristic tier / single-host mesh, flagged not errored), "
            "2=BROWNOUT (degraded tier failing too; scoring sheds "
            "UNAVAILABLE and health reports NOT_SERVING)",
        )
        self.breaker_state = self.registry.gauge(
            f"{service}_breaker_state",
            "Per-dependency circuit breaker state by {dep}: 0=closed, "
            "1=half_open (probing), 2=open (calls short-circuited)",
        )
        self.degraded_responses_total = self.registry.counter(
            f"{service}_degraded_responses_total",
            "Scoring responses served by a degraded tier by {tier} "
            "(heuristic = CPU conservative scorer while the device "
            "circuit is open; single_host = multihost front stepping "
            "locally while a follower resurrects) — flagged responses, "
            "never errors",
        )
        self.watchdog_trips_total = self.registry.counter(
            f"{service}_watchdog_trips_total",
            "Device-step watchdog expirations (dispatch->readback over "
            "DEVICE_STEP_DEADLINE_S): each fails its in-flight window "
            "with UNAVAILABLE + retry-pushback and triggers an engine "
            "rebuild with warmup replay",
        )
        self.engine_rebuilds_total = self.registry.counter(
            f"{service}_engine_rebuilds_total",
            "Scoring-engine tear-down+rebuild cycles completed after a "
            "watchdog trip (the wedged-tunnel recovery path)",
        )
        self.follower_resurrections_total = self.registry.counter(
            f"{service}_follower_resurrections_total",
            "Multihost followers that rejoined through the supervised "
            "reconnect loop (hello/fingerprint + param re-sync) after "
            "dying or wedging",
        )
        # Scale-out scoring fleet (serve/router.py): ring membership,
        # failover retries, and hedged-RPC accounting — the dashboard a
        # fleet chaos soak (FLEET_CHAOS artifacts) reads.
        self.ring_replicas = self.registry.gauge(
            f"{service}_ring_replicas",
            "Scoring replicas by ring {state}: serving and degraded "
            "replicas are IN the consistent-hash ring (degraded answers "
            "are flagged, not errored); brownout (replica health "
            "NOT_SERVING) and dead (probe/forward failures) replicas are "
            "evicted until the health watcher re-admits them",
        )
        self.router_retries_total = self.registry.counter(
            f"{service}_router_retries_total",
            "Router forward retries onto the next ring owner by {reason}: "
            "pushback = UNAVAILABLE carrying the server's "
            "grpc-retry-pushback-ms hint (honored with jitter), "
            "unavailable = UNAVAILABLE without a hint, link_drop = "
            "router->replica link fault (chaos seam router.forward)",
        )
        self.hedge_total = self.registry.counter(
            f"{service}_hedge_total",
            "Hedged ScoreTransaction RPCs by {outcome}: launched = a "
            "straggling primary crossed the latency-percentile hedge "
            "deadline and a copy went to the secondary ring owner; "
            "win_primary / win_hedge = which copy answered first (the "
            "loser is cancelled); both_failed = neither answered. Every "
            "launched hedge lands in exactly one terminal outcome",
        )
        # Durable decision ledger (serve/ledger.py): WAL append health,
        # fsync cadence cost, and the sink drain's backlog — the audit
        # pipeline's dashboard.
        self.ledger_records_total = self.registry.counter(
            f"{service}_ledger_records_total",
            "Decision records durably appended to the ledger WAL "
            "(CRC-framed, batched fsync off the scoring hot path)",
        )
        self.ledger_dropped_total = self.registry.counter(
            f"{service}_ledger_dropped_total",
            "Decision records dropped by {reason}: queue_full = the "
            "bounded append queue was full (scoring is never blocked), "
            "write_error = the WAL write failed (fs outage; the ledger "
            "breaker opens)",
        )
        self.ledger_fsync_ms = self.registry.histogram(
            f"{service}_ledger_fsync_ms",
            "Ledger WAL fsync latency (ms) — batched on a cadence "
            "(LEDGER_FSYNC_MS) so durability cost never rides a "
            "ScoreTransaction",
            buckets=(0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250),
        )
        self.ledger_sink_queue_depth = self.registry.gauge(
            f"{service}_ledger_sink_queue_depth",
            "Decision records durable in the WAL but not yet delivered "
            "to the analytical sink (the drain's lag; grows through a "
            "sink outage, shrinks as the cursor catches up from disk)",
        )
        self.ledger_sink_sent_total = self.registry.counter(
            f"{service}_ledger_sink_sent_total",
            "Decision records delivered to the ClickHouse/PG sink "
            "(at-least-once: a cursor replay after SIGKILL may re-send)",
        )
        # Fleet-wide SLO plane (obs/slo.py): attainment against the
        # latency objective, multi-window burn rate, and which stage
        # consumed the error budget on violating requests.
        self.slo_requests_total = self.registry.counter(
            f"{service}_slo_requests_total",
            "Scoring RPCs counted against the latency SLO by {state} "
            "(the supervisor serving state each sample was scored under)",
        )
        self.slo_violations_total = self.registry.counter(
            f"{service}_slo_violations_total",
            "SLO-violating scoring RPCs by {state}: latency above the "
            "objective (SLO_OBJECTIVE_MS) or a server-fault status — "
            "sheds and caller errors never burn budget",
        )
        self.slo_burn_rate = self.registry.gauge(
            f"{service}_slo_burn_rate",
            "Error-budget burn rate by {window} (fast ~1 min / slow "
            "~1 h): violating fraction over the window divided by the "
            "budget fraction (1 - SLO_TARGET); 1.0 = budget consumed "
            "exactly at the sustainable rate, 10 = 10x too fast",
        )
        self.slo_attainment = self.registry.gauge(
            f"{service}_slo_attainment",
            "Fraction of scoring RPCs meeting the latency objective over "
            "the {window} (1.0 with no traffic — an idle replica is not "
            "a violating replica)",
        )
        self.slo_alert = self.registry.gauge(
            f"{service}_slo_alert",
            "Burn-rate alert state by {window}: 1 while the window's "
            "burn rate is at/above its alert threshold "
            "(SLO_FAST_BURN_ALERT / SLO_SLOW_BURN_ALERT), else 0",
        )
        self.slo_alerts_total = self.registry.counter(
            f"{service}_slo_alerts_total",
            "Burn-rate alert RAISE transitions by {window} — one per "
            "incident, not one per violating request",
        )
        self.slo_budget_stage_ms_total = self.registry.counter(
            f"{service}_slo_budget_stage_ms_total",
            "Stage busy-time (ms) accumulated on SLO-VIOLATING requests "
            "by {stage} — the budget-attribution table: the stage with "
            "the largest share is where the budget went",
        )
        # Fleet aggregation plane (obs/fleetview.py): scrape health of
        # the cross-replica rollup served at /debug/fleetz.
        self.fleet_replicas_scraped = self.registry.gauge(
            f"{service}_fleet_replicas_scraped",
            "Replicas in the fleet view by {freshness}: fresh = last "
            "scrape within the staleness horizon, stale = dead/hung/"
            "failing replicas still shown from last-good state",
        )
        self.fleet_scrape_failures_total = self.registry.counter(
            f"{service}_fleet_scrape_failures_total",
            "Failed sidecar scrape passes by {replica} (bounded-timeout "
            "fetch of /metrics + debug surfaces; the plane keeps serving "
            "last-good state)",
        )
        self.fleet_scrape_ms = self.registry.histogram(
            f"{service}_fleet_scrape_ms",
            "Wall time (ms) of one successful replica sidecar scrape "
            "(all endpoints)",
            buckets=(1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000),
        )
        # Device-runtime telemetry (obs/runtime_telemetry.py): the
        # signals the flight recorder is blind to — recompiles, dispatch
        # amplification, step-time anomalies, HBM-side occupancy.
        self.compile_events_total = self.registry.counter(
            f"{service}_compile_events_total",
            "Device program compilations observed at the jax monitoring "
            "seam by {kind} — a non-zero steady-state rate is a "
            "recompile storm (shape drift or static-arg churn)",
        )
        self.compile_wall_ms = self.registry.histogram(
            f"{service}_compile_wall_ms",
            "Wall time (ms) of each backend compile — the latency cliff "
            "a recompiling request falls off",
            buckets=(1, 5, 25, 100, 500, 1000, 5000, 15000, 60000),
        )
        self.compile_signatures_total = self.registry.counter(
            f"{service}_compile_signatures_total",
            "Distinct launch shape signatures seen since boot — fires "
            "exactly once per new (fn, shape, dtype); growth after "
            "warmup means the batcher is feeding uncompiled shapes",
        )
        self.device_dispatches_total = self.registry.counter(
            f"{service}_device_dispatches_total",
            "Compiled-step dispatches (score.dispatch/score.device "
            "stages) — with txns_scored_total this is the "
            "dispatch-amplification ratio; per-request counts ride the "
            "flight entries' `dispatches` attribute",
        )
        self.step_anomalies_total = self.registry.counter(
            f"{service}_step_anomalies_total",
            "Device step-time EWMA anomalies by {stage}: a sample beyond "
            "mean + k*sigma (ANOMALY_K_SIGMA) and the absolute floor — "
            "each stamps its flight entry with the anomalous stage",
        )
        self.anomaly_profiles_total = self.registry.counter(
            f"{service}_anomaly_profiles_total",
            "Automatic device-profile captures triggered by step-time "
            "anomalies (cooldown-limited: one per "
            "ANOMALY_PROFILE_COOLDOWN_S, keyed by the anomalous trace id)",
        )
        self.arena_buffers = self.registry.gauge(
            f"{service}_arena_buffers",
            "Staging-arena buffer accounting by {kind}: allocated = "
            "fresh allocations since boot, reused = recycled handouts, "
            "idle = buffers parked on free lists (serve/arena.py); "
            "refreshed on every /metrics scrape",
        )
        self.hbm_bytes = self.registry.gauge(
            f"{service}_hbm_bytes",
            "Device memory: {kind} series (in_use/limit/peak) from the "
            "backend's memory_stats — absent on backends that do not "
            "report (CPU) — plus {shard, table} series for the "
            "slot-sharded state tables (feature_cache / session_ring "
            "bytes per mesh shard, the per-chip capacity accounting of "
            "docs/performance.md 'Sharded state')",
        )
        # Online learning loop (train/online.py, serve/shadow.py,
        # train/promote.py): shadow-scoring evidence, mined training
        # examples, and the promotion/rollback event stream.
        self.shadow_rows_total = self.registry.counter(
            f"{service}_shadow_rows_total",
            "Live rows handled by the shadow scorer by {outcome}: scored "
            "= candidate params re-scored them next to production, "
            "dropped = the bounded shadow queue was full (production is "
            "never blocked), skipped = no host feature snapshot "
            "(index-mode / heuristic-tier rows)",
        )
        self.shadow_action_flips_total = self.registry.counter(
            f"{service}_shadow_action_flips_total",
            "Shadow-scored rows whose candidate action differs from the "
            "action production actually took — the numerator of the "
            "promotion flip-rate gate",
        )
        self.shadow_score_divergence = self.registry.histogram(
            f"{service}_shadow_score_divergence",
            "Absolute candidate-vs-production risk-score divergence per "
            "shadow-scored row (0-100 scale)",
            buckets=(0, 1, 2, 5, 10, 20, 40, 60, 80, 100),
        )
        self.online_mined_total = self.registry.counter(
            f"{service}_online_mined_total",
            "Training examples mined from the decision WAL by {kind}: "
            "hard = hard negatives (scored risky, outcome legitimate) "
            "plus missed fraud, labeled = other outcome-labeled rows",
        )
        self.online_train_steps_total = self.registry.counter(
            f"{service}_online_train_steps_total",
            "Incremental learner steps taken by the online loop on the "
            "serving device budget (train/serve coexistence)",
        )
        self.promotions_total = self.registry.counter(
            f"{service}_promotions_total",
            "Param-set transitions on the serving engine by {event}: "
            "promote (all gates passed), rollback (post-promotion gate "
            "regressed), forced_promote / forced_rollback (operator "
            "knobs) — each also lands a PromotionRecord in the ledger",
        )
        self.promotion_gate_failures_total = self.registry.counter(
            f"{service}_promotion_gate_failures_total",
            "Candidate promotions held back by {gate} (train/gates.py "
            "bounds: probe-AUC floor, no-regression margin, shadow "
            "rows/flip-rate, SLO-quiet) — a persistently failing gate "
            "is the drift dashboard's first stop",
        )
        # Streaming drift & data-quality observatory (obs/drift.py):
        # on-path feature/score sketches compared against a pinned
        # reference, score calibration against mined outcomes, and the
        # raise/clear drift alerts the drift_quiet promotion gate reads.
        self.drift_rows_total = self.registry.counter(
            f"{service}_drift_rows_total",
            "Scored rows handled by the drift observatory by {outcome}: "
            "sketched = folded into the rolling window by the drift "
            "worker, dropped = the bounded sketch queue was full "
            "(scoring is never blocked), skipped = unsketchable rows "
            "(int8-compressed wire, heuristic tier)",
        )
        self.drift_window_rows = self.registry.gauge(
            f"{service}_drift_window_rows",
            "Rows currently inside the drift engine's rolling window "
            "(evaluation needs DRIFT_MIN_ROWS before it trusts PSI)",
        )
        self.drift_psi = self.registry.gauge(
            f"{service}_drift_psi",
            "Per-feature Population Stability Index of the rolling "
            "window vs the pinned reference by {feature} (bounded: the "
            "30-name feature schema); > DRIFT_PSI_ALERT raises the "
            "input drift alert",
        )
        self.drift_ks = self.registry.gauge(
            f"{service}_drift_ks",
            "Per-feature Kolmogorov-Smirnov statistic (binned, exact to "
            "bucket resolution) of the rolling window vs the pinned "
            "reference by {feature}",
        )
        self.drift_output_psi = self.registry.gauge(
            f"{service}_drift_output_psi",
            "PSI of the model OUTPUT distributions vs the pinned "
            "reference by {dist} (score = the 0-100 risk-score "
            "histogram, action = approve/review/block counts) — output "
            "shift with quiet inputs is concept drift",
        )
        self.drift_calibration_error = self.registry.gauge(
            f"{service}_drift_calibration_error",
            "Weighted |observed - reference| fraud rate across score "
            "bins over the calibration window (outcomes mined from the "
            "decision WAL); > DRIFT_CAL_ALERT raises the calibration "
            "drift alert",
        )
        self.drift_shadow_divergence = self.registry.gauge(
            f"{service}_drift_shadow_divergence",
            "Mean |candidate - production| score delta of shadow-scored "
            "rows over the drift window — candidate divergence trended "
            "next to input drift so a drifting candidate is visible "
            "before any promotion gate runs",
        )
        self.drift_alert = self.registry.gauge(
            f"{service}_drift_alert",
            "Drift alert state by {kind} (input / score / calibration): "
            "1 while the kind's divergence is at/above its raise "
            "threshold (hysteresis clears at half) — any active kind "
            "holds promotion via the drift_quiet gate",
        )
        self.drift_alerts_total = self.registry.counter(
            f"{service}_drift_alerts_total",
            "Drift alert RAISE transitions by {kind} — one per "
            "incident, not one per drifted batch",
        )
        # Stateful sequence scoring (serve/session_state.py): the
        # per-account session ring beside the feature cache, its fused
        # session head, and the honest cold/bypass accounting.
        self.session_rows_total = self.registry.counter(
            f"{service}_session_rows_total",
            "Rows scored while session state is enabled by {outcome}: "
            "warm = the post-append window reached SESSION_MIN_EVENTS "
            "and the session head spoke, cold = window still too short "
            "(SESSION_COLD reason bit set — the honest stateless "
            "fallback), bypass = scored on a non-session path (row wire "
            "mode, batcher, heuristic tier) so the window did not "
            "advance",
        )
        self.session_appends_total = self.registry.counter(
            f"{service}_session_appends_total",
            "Events appended to per-account session windows by the fused "
            "scoring step's donated in-place ring scatter (one per "
            "session-scored row)",
        )
        self.session_rehydrations_total = self.registry.counter(
            f"{service}_session_rehydrations_total",
            "Session windows restored into HBM from the host session "
            "index on feature-cache admission — an evicted account that "
            "returns gets its window back, never a silent cold start",
        )
        self.session_hbm_bytes = self.registry.gauge(
            f"{service}_session_hbm_bytes",
            "Device bytes held by the session ring (ring + cursors + "
            "lengths) — budget it against the feature table "
            "(docs/operations.md 'Session state')",
        )
        # Host-plane cost observatory (obs/hostprof.py): per-stage
        # µs/row cost distributions and the GC pause accounting — the
        # capacity-math series ("what does one row cost on the host, by
        # stage") behind /debug/hostprofz.
        self.host_stage_us_per_row = self.registry.histogram(
            f"{service}_host_stage_us_per_row",
            "Host cost per row (µs/row) by serving {stage} (decode/"
            "gather/cache_lookup/pad/dispatch/readback/session/"
            "ledger_note/encode), from the monotonic span clock; bucket "
            "lines carry trace-id exemplars — the per-row capacity "
            "figure docs/performance.md 'Reading a host flamegraph' "
            "explains",
            buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250),
        )
        self.gc_collections_total = self.registry.counter(
            f"{service}_gc_collections_total",
            "Python GC collections by {generation} — a hot gen-2 rate "
            "on a scoring replica means allocation churn is reaching "
            "the old generation and paying full-heap pauses",
        )
        self.gc_pause_ms = self.registry.histogram(
            f"{service}_gc_pause_ms",
            "Python GC stop-the-world pause (ms) by {generation}; the "
            "hostprofz page attributes each pause to the rpc.* roots "
            "in flight when it hit",
            buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100),
        )
        self.spans_dropped_total = self.registry.counter(
            f"{service}_spans_dropped_total",
            "Host spans evicted from the bounded span ring before export "
            "(a non-zero rate means /debug/spans and the OTLP drain are "
            "sampling, not complete)",
        )
        self.otlp_export_failures_total = self.registry.counter(
            f"{service}_otlp_export_failures_total",
            "OTLP/HTTP span export batches dropped on endpoint errors "
            "(spans are diagnostics: failures drop the batch, never block "
            "serving)",
        )

    def observe_rpc(self, method: str, start_time: float, code: str = "OK") -> None:
        self.requests_total.inc(method=method, code=code)
        self.request_duration_ms.observe((time.monotonic() - start_time) * 1000.0, method=method)
        if code != "OK":
            self.errors_total.inc(method=method)

    def observe_stage_span(self, span) -> None:
        """Span-sink adapter (obs/tracing.set_span_sink): stage spans feed
        the per-stage histogram keyed by span name; rpc.* roots are the
        whole-request spans already covered by request_duration_ms."""
        if span.name.startswith("rpc."):
            return
        self.stage_latency_ms.observe(
            span.duration_ms, exemplar=span.trace_id, stage=span.name)
