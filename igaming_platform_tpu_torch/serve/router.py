"""Scale-out scoring fleet: account-affinity router with health-aware
failover and hedged retries.

One self-healing front (serve/supervisor.py) is still one front. The
north star is millions of users, which means N scoring replicas behind a
router that survives any one of them dying — the replica-fanout shape of
"Scaling TensorFlow to 300 million predictions per second" with the
Podracer pod-as-unit-of-failure topology. Three pieces:

- :class:`HashRing` — consistent hashing of ``account_id`` onto the
  replica set, so each replica's HBM device cache (serve/device_cache.py)
  holds a DISJOINT hot set and fleet cache capacity scales linearly.
  The ring is deterministic across processes and restarts (blake2b, no
  PYTHONHASHSEED dependence); eviction *skips* a replica's vnodes rather
  than rebuilding the ring, so only the evicted replica's keys move
  (≤ ~1/N) and readmission restores the exact original mapping.

- :class:`FleetHealthWatcher` — consumes each replica's supervisor
  health: the gRPC health service (BROWNOUT flips NOT_SERVING) on
  every probe tick plus the ``/debug/supervisorz`` sidecar for the
  SERVING/DEGRADED detail. BROWNOUT and dead replicas are evicted from
  the ring; DEGRADED replicas keep serving (their answers are flagged,
  not errored); recovery re-admits automatically. Forward-path failures
  feed the same failure counter, so a dead replica is detected at
  traffic speed, not probe speed.

- :class:`ScoringRouter` — a thin L7 gRPC front exposing
  ``ScoreTransaction``/``ScoreBatch``: requests forward as raw wire
  bytes to the ring owner of their ``account_id``. ``UNAVAILABLE``
  retries onto the next ring owner, honoring the server's
  ``grpc-retry-pushback-ms`` trailing hint with jittered, bounded
  backoff (the client-side contract the supervisor's watchdog emits). Straggling
  ``ScoreTransaction`` RPCs hedge onto the deterministic secondary owner
  after a latency-percentile-derived deadline — first response wins, the
  loser is cancelled, and every hedge is accounted exactly once in
  ``risk_hedge_total{outcome}``.

The equivalent *client-side* picker (no extra hop) lives here too
(:class:`AccountAffinityPicker`): a client partitions its accounts by ring
owner and sends each replica only the accounts it owns.

This is the port's copy of ``igaming_platform_tpu/serve/router.py``. It
imports grpcio only when a replica endpoint is dialled or the router is
served (``_grpc``): the ring, the pod ring, the latency window and the
client picker import nothing of it, and constructing a ``ReplicaEndpoint``
without grpcio raises ``RuntimeError``. Requests are read and split with the
port's own codec (``serve/risk_codec.py``): a ScoreBatch splits into
sub-requests that carry each owner's transaction entries as they arrived,
and the responses merge entry by entry, in request order.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import logging
import os
import random
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable

from igaming_platform_tpu_torch.obs import tracing
from igaming_platform_tpu_torch.obs.metrics import ServiceMetrics
from igaming_platform_tpu_torch.serve import chaos
from igaming_platform_tpu_torch.serve import deadline as deadline_mod
from igaming_platform_tpu_torch.serve import risk_codec as codec
from igaming_platform_tpu_torch.serve.deadline import (
    DEADLINE_METADATA_KEY,
    Deadline,
    outbound_deadline_ms,
)
from igaming_platform_tpu_torch.serve.wire import INDEX_WIRE_MAGIC

logger = logging.getLogger(__name__)


def _grpc():
    """grpcio, imported where a replica is dialled or the router served; a
    RuntimeError where it is not installed (the card's machine)."""
    try:
        import grpc
    except ImportError as exc:
        raise RuntimeError("the scoring router's gRPC transport needs grpcio, which is not "
                           "installed") from exc
    return grpc


def _entries(buf: bytes) -> list[bytes]:
    """The raw field-1 entries (tag, length and message) of a ScoreBatch
    request or response, in order; other fields are skipped."""
    out, pos, end = [], 0, len(buf)
    while pos < end:
        start = pos
        key, pos = codec._read_varint(buf, pos, end)
        if key & 7 == 2:
            n, pos = codec._read_varint(buf, pos, end)
            pos += n
            if pos > end:
                raise ValueError("truncated length-delimited field")
            if key >> 3 == 1:
                out.append(bytes(buf[start:pos]))
        else:
            pos = codec._skip(buf, pos, end, key & 7)
    return out

# Replica states as the watcher sees them (the ``risk_ring_replicas``
# gauge's {state} label). "serving"/"degraded" are IN the ring;
# "brownout"/"dead" are evicted until they recover.
REPLICA_STATES = ("serving", "degraded", "brownout", "dead")
_IN_RING = ("serving", "degraded")


def _ring_hash(data: str) -> int:
    """Stable 64-bit ring position: blake2b, NOT hash() — the mapping
    must survive process restarts and match between the router and every
    client-side picker regardless of PYTHONHASHSEED."""
    return int.from_bytes(
        hashlib.blake2b(data.encode(), digest_size=8).digest(), "big")


class HashRing:
    """Consistent-hash ring with virtual nodes and skip-based eviction.

    Every known replica keeps its ``vnodes`` points on the ring forever;
    ``evict`` only removes the replica from the *active* set, so lookups
    skip its points. Consequences the property tests pin:

    - key→owner is a pure function of (replica ids, vnodes) — stable
      across processes and restarts;
    - evicting one replica of N moves only the keys it owned (~1/N),
      every other key keeps its owner;
    - ``owners(key, 2)[1]`` (the hedge target) is exactly the owner the
      key falls to if the primary is evicted — failover and hedging
      agree on where an account's state lives next.
    """

    def __init__(self, replica_ids: Iterable[str] = (), *, vnodes: int = 64):
        self._vnodes = max(1, int(vnodes))
        self._lock = threading.Lock()
        self._points: list[tuple[int, str]] = []
        self._members: set[str] = set()
        self._active: set[str] = set()
        for rid in replica_ids:
            self.add(rid)

    def add(self, rid: str) -> None:
        """Join a replica (idempotent; re-adding an evicted one readmits)."""
        with self._lock:
            if rid in self._members:
                self._active.add(rid)
                return
            self._members.add(rid)
            self._active.add(rid)
            for v in range(self._vnodes):
                bisect.insort(self._points, (_ring_hash(f"{rid}#{v}"), rid))

    def evict(self, rid: str) -> None:
        with self._lock:
            self._active.discard(rid)

    def readmit(self, rid: str) -> None:
        with self._lock:
            if rid in self._members:
                self._active.add(rid)

    @property
    def active(self) -> frozenset[str]:
        with self._lock:
            return frozenset(self._active)

    @property
    def members(self) -> frozenset[str]:
        with self._lock:
            return frozenset(self._members)

    def owners(self, key: str, n: int = 1,
               active_only: bool = True) -> list[str]:
        """First ``n`` distinct replicas clockwise from ``key``'s hash.
        ``active_only=False`` gives the fault-free mapping (what the
        property tests compare eviction against)."""
        h = _ring_hash(key)
        with self._lock:
            points = self._points
            eligible = self._active if active_only else self._members
            if not points or not eligible:
                return []
            out: list[str] = []
            start = bisect.bisect_right(points, (h, "￿"))
            for i in range(len(points)):
                rid = points[(start + i) % len(points)][1]
                if rid in eligible and rid not in out:
                    out.append(rid)
                    if len(out) >= n:
                        break
            return out

    def owner(self, key: str) -> str | None:
        got = self.owners(key, 1)
        return got[0] if got else None

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "members": sorted(self._members),
                "active": sorted(self._active),
                "vnodes": self._vnodes,
            }


class PodRing:
    """Pod-as-unit membership over :class:`HashRing` (the Podracer
    topology, PAPERS.md): the ring is keyed by POD ids — a mesh-backed
    replica group advertising aggregate capacity (its slot-sharded
    feature cache + session ring span the whole mesh,
    parallel/state_sharding.py) — and replica-level health transitions
    translate to pod transitions here. A pod leaves the ring only when
    its LAST in-ring member does: any healthy member is an entry point
    to the same mesh-resident state, so one dead host must not move the
    pod's keys. With the default one-replica-per-pod mapping (pod id ==
    replica id) this degenerates to exactly the one-replica-a-pod behavior and the
    golden ring owners are unchanged."""

    def __init__(self, ring: HashRing, pod_of: dict[str, str],
                 members: dict[str, tuple[str, ...]]):
        self._ring = ring
        self._pod_of = dict(pod_of)
        self._members = {p: frozenset(ms) for p, ms in members.items()}
        self._out: set[str] = set()
        self._lock = threading.Lock()

    def evict(self, rid: str) -> None:
        pod = self._pod_of.get(rid)
        if pod is None:
            self._ring.evict(rid)
            return
        with self._lock:
            self._out.add(rid)
            if self._members[pod] <= self._out:
                self._ring.evict(pod)

    def readmit(self, rid: str) -> None:
        pod = self._pod_of.get(rid)
        if pod is None:
            self._ring.readmit(rid)
            return
        with self._lock:
            self._out.discard(rid)
            self._ring.readmit(pod)

    def out_members(self) -> frozenset[str]:
        with self._lock:
            return frozenset(self._out)


# ---------------------------------------------------------------------------
# Replica endpoints + health watching


class ReplicaEndpoint:
    """One scoring replica as the router sees it: a stable ring identity
    plus the (re-dialable) gRPC address and optional HTTP sidecar."""

    def __init__(self, rid: str, addr: str, http_addr: str | None = None):
        self.id = rid
        self.addr = addr
        self.http_addr = http_addr
        self.state = "serving"
        self.consecutive_failures = 0
        self.last_error: str | None = None
        # Advertised capacity (advisory, scraped from /debug/cachez on
        # the deep probe tick): admissible feature-cache slots and the
        # per-shard HBM budget — summed per pod in the router snapshot.
        self.capacity_slots: int | None = None
        self.hbm_bytes: int | None = None
        self.state_shards: int | None = None
        self._build_stubs()

    def _build_stubs(self) -> None:
        grpc = _grpc()
        # Bounded reconnect backoff: a replica that was down for a while
        # must be re-dialed within ~1 s of coming back, or ring
        # readmission waits out gRPC's grown default backoff (measured:
        # ~9 s re-admission lag after a 13 s outage without this).
        self.channel = grpc.insecure_channel(self.addr, options=(
            ("grpc.initial_reconnect_backoff_ms", 250),
            ("grpc.min_reconnect_backoff_ms", 250),
            ("grpc.max_reconnect_backoff_ms", 1000),
        ))
        self.score_txn = self.channel.unary_unary(
            "/risk.v1.RiskService/ScoreTransaction",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        self.score_batch = self.channel.unary_unary(
            "/risk.v1.RiskService/ScoreBatch",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        self.health = self.channel.unary_unary("/grpc.health.v1.Health/Check")

    def redial(self, addr: str, http_addr: str | None = None) -> None:
        """Point this ring identity at a restarted replica process."""
        old = self.channel
        self.addr = addr
        if http_addr is not None:
            self.http_addr = http_addr
        self._build_stubs()
        old.close()

    def close(self) -> None:
        self.channel.close()


class FleetHealthWatcher:
    """Drives ring membership from replica health.

    Probe loop: every ``interval_s`` each replica gets a gRPC health
    Check (the supervisor flips it NOT_SERVING on BROWNOUT). A probe
    error counts one failure; ``failure_threshold`` consecutive failures
    mark the replica dead and evict it. NOT_SERVING evicts immediately
    (the replica itself says it cannot serve). A SERVING probe readmits
    and resets the count. Every ``supervisorz_every`` ticks the HTTP
    sidecar's ``/debug/supervisorz`` refines in-ring replicas to
    serving/degraded — degraded stays in the ring (flagged answers beat
    no answers) but is visible on the ``risk_ring_replicas`` gauge.

    ``note_forward_failure`` lets the data path feed the same counter so
    a dead replica under live load is evicted at traffic speed instead
    of waiting out probe ticks.
    """

    def __init__(self, ring: HashRing | PodRing,
                 replicas: dict[str, ReplicaEndpoint],
                 *, interval_s: float = 0.25, failure_threshold: int = 2,
                 probe_timeout_s: float = 0.5, supervisorz_every: int = 4,
                 metrics: ServiceMetrics | None = None,
                 on_transition: Callable[[str, str, str], None] | None = None):
        self.ring = ring
        self.replicas = replicas
        self.interval_s = interval_s
        self.failure_threshold = max(1, failure_threshold)
        self.probe_timeout_s = probe_timeout_s
        self.supervisorz_every = max(1, supervisorz_every)
        self.metrics = metrics
        self.on_transition = on_transition
        # Transition log for artifacts: (monotonic t, rid, old, new).
        self.events: list[tuple[float, str, str, str]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._ticks = 0
        self._update_metrics()

    # -- state transitions ---------------------------------------------------

    def _set_state(self, replica: ReplicaEndpoint, new: str,
                   why: str = "") -> None:
        old = replica.state
        if new == old:
            return
        replica.state = new
        if new in _IN_RING:
            self.ring.readmit(replica.id)
        else:
            self.ring.evict(replica.id)
        with self._lock:
            self.events.append((time.monotonic(), replica.id, old, new))
        logger.warning("fleet replica %s %s -> %s (%s)",
                       replica.id, old, new, why or replica.last_error)
        self._update_metrics()
        if self.on_transition is not None:
            try:
                self.on_transition(replica.id, old, new)
            except Exception:  # noqa: CC04 — transition sinks must not stop the watcher
                logger.warning("ring transition sink failed", exc_info=True)

    def _update_metrics(self) -> None:
        if self.metrics is None:
            return
        counts = {s: 0 for s in REPLICA_STATES}
        for r in self.replicas.values():
            counts[r.state] = counts.get(r.state, 0) + 1
        for state, n in counts.items():
            self.metrics.ring_replicas.set(n, state=state)

    # -- probes --------------------------------------------------------------

    def note_forward_failure(self, rid: str, exc: BaseException) -> None:
        """A data-path forward failed hard: same evidence as a failed
        probe, so detection is bounded by traffic, not the probe tick."""
        replica = self.replicas.get(rid)
        if replica is None:
            return
        replica.consecutive_failures += 1
        replica.last_error = repr(exc)[:200]
        if (replica.consecutive_failures >= self.failure_threshold
                and replica.state in _IN_RING):
            self._set_state(replica, "dead", "forward failures")

    def _probe(self, replica: ReplicaEndpoint) -> None:
        from igaming_platform_tpu_torch.serve.grpc_server import SERVING as H_SERVING

        grpc = _grpc()
        try:
            if chaos.fire("router.health") == "drop":
                # Deterministic link-fault injection: a dropped probe is
                # a probe that never answers.
                raise chaos.ChaosError("router.health", "probe dropped")
            resp = codec.decode(codec.HEALTH_CHECK_RESPONSE, replica.health(
                codec.encode(codec.HEALTH_CHECK_REQUEST, {"service": ""}),
                timeout=self.probe_timeout_s))
        except (grpc.RpcError, chaos.ChaosError) as exc:
            replica.consecutive_failures += 1
            replica.last_error = repr(exc)[:200]
            if replica.consecutive_failures >= self.failure_threshold:
                self._set_state(replica, "dead", "health probe failures")
            return
        replica.consecutive_failures = 0
        if resp["status"] != H_SERVING:
            # The replica itself says NOT_SERVING (supervisor BROWNOUT):
            # no failure count needed, out of the ring now.
            self._set_state(replica, "brownout", "health NOT_SERVING")
            return
        if replica.state in ("dead", "brownout"):
            self._set_state(replica, "serving", "health SERVING again")
        elif replica.state == "serving":
            pass  # steady state
        # degraded stays degraded until supervisorz says otherwise.

    def _probe_supervisorz(self, replica: ReplicaEndpoint) -> None:
        """Refine an in-ring replica's serving/degraded split from the
        supervisor snapshot. Best-effort: replicas without the HTTP
        sidecar (or a failed scrape) just keep their health-derived
        state — the gRPC probe remains the availability authority."""
        if replica.http_addr is None or replica.state not in _IN_RING:
            return
        try:
            with urllib.request.urlopen(
                    f"http://{replica.http_addr}/debug/supervisorz",
                    timeout=self.probe_timeout_s) as resp:
                snap = json.loads(resp.read())
        except Exception as exc:  # noqa: CC04 — sidecar scrape is advisory; gRPC probe owns failure counting
            replica.last_error = repr(exc)[:200]
            return
        state = snap.get("state")
        if state == "degraded" and replica.state == "serving":
            self._set_state(replica, "degraded", "supervisorz DEGRADED")
        elif state == "serving" and replica.state == "degraded":
            self._set_state(replica, "serving", "supervisorz SERVING")
        try:
            # Advertised capacity (advisory, same deep tick): admissible
            # slots + per-shard HBM from /debug/cachez, summed per pod
            # in the router snapshot — pod-as-unit scheduling needs the
            # pod's AGGREGATE capacity, not one chip's.
            with urllib.request.urlopen(
                    f"http://{replica.http_addr}/debug/cachez",
                    timeout=self.probe_timeout_s) as resp:
                cz = json.loads(resp.read())
            replica.capacity_slots = cz.get("capacity")
            shards = cz.get("shards") or {}
            replica.state_shards = shards.get("shards")
            hbm = shards.get("hbm_bytes") or []
            replica.hbm_bytes = int(sum(hbm)) if hbm else None
        except Exception:  # noqa: CC04 — capacity advertisement is advisory (404 without a cache); the gRPC probe owns failure counting
            pass

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._ticks += 1
            deep = self._ticks % self.supervisorz_every == 0
            for replica in list(self.replicas.values()):
                if self._stop.is_set():
                    return
                self._probe(replica)
                if deep:
                    self._probe_supervisorz(replica)
            self._stop.wait(self.interval_s)

    def start(self) -> "FleetHealthWatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="fleet-health-watcher", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def snapshot(self) -> dict:
        with self._lock:
            events = [
                {"t": round(t, 4), "replica": rid, "from": old, "to": new}
                for t, rid, old, new in self.events
            ]
        return {
            "replicas": {
                r.id: {
                    "addr": r.addr,
                    "state": r.state,
                    "consecutive_failures": r.consecutive_failures,
                    "last_error": r.last_error,
                }
                for r in self.replicas.values()
            },
            "transitions": events,
        }


# ---------------------------------------------------------------------------
# Hedge deadline: latency-percentile derived


class LatencyWindow:
    """Rolling window of forward latencies; the hedge deadline is the
    window's ``quantile`` clamped to [min_ms, max_ms] — straggler-only
    hedging, never a second copy of the median request."""

    def __init__(self, *, quantile: float = 0.95, window: int = 512,
                 default_ms: float = 75.0, min_ms: float = 5.0,
                 max_ms: float = 2000.0, min_samples: int = 20):
        self.quantile = quantile
        self.default_ms = default_ms
        self.min_ms = min_ms
        self.max_ms = max_ms
        self.min_samples = min_samples
        self._window = window
        self._lock = threading.Lock()
        self._samples: list[float] = []
        self._pos = 0

    def observe_ms(self, ms: float) -> None:
        with self._lock:
            if len(self._samples) < self._window:
                self._samples.append(float(ms))
            else:
                self._samples[self._pos] = float(ms)
                self._pos = (self._pos + 1) % self._window

    def hedge_deadline_s(self) -> float:
        with self._lock:
            n = len(self._samples)
            if n < self.min_samples:
                ms = self.default_ms
            else:
                ordered = sorted(self._samples)
                ms = ordered[min(n - 1, int(n * self.quantile))]
        return max(self.min_ms, min(self.max_ms, ms)) / 1000.0


# ---------------------------------------------------------------------------
# The router service


class RouterForwardError(RuntimeError):
    """Every eligible owner refused/failed the forward: the router sheds
    UNAVAILABLE with the standard retry-pushback hint."""


def _pushback_ms_from(exc) -> int | None:
    """The server's standard retry hint, off the trailing metadata."""
    try:
        trailing = exc.trailing_metadata() or ()
    except Exception:  # noqa: CC04 — a dead channel may carry no metadata; counted by the caller's retry path
        return None
    for key, value in trailing:
        if key == "grpc-retry-pushback-ms":
            try:
                return max(0, int(value))
            except ValueError:
                return None
    return None


class ScoringRouter:
    """risk.v1 ScoreTransaction/ScoreBatch over a replica ring.

    Handlers receive RAW request bytes (the server registers them with an
    identity deserializer) and forward raw bytes — the router never
    re-serializes a proto it didn't have to parse. ScoreTransaction
    parses only to read ``account_id``; protobuf ScoreBatch parses to
    split rows by ring owner (sub-batches forward concurrently and merge
    in order); index-mode frames route whole by their first account —
    affinity-building for index frames is the client picker's job.
    """

    raw_request_methods = ("ScoreTransaction", "ScoreBatch")

    def __init__(self, replicas: dict[str, tuple[str, str | None]] | list[str],
                 *, pods: dict[str, tuple[str, ...] | list[str]] | None = None,
                 metrics: ServiceMetrics | None = None,
                 vnodes: int = 64, hedge: bool | None = None,
                 max_attempts: int | None = None,
                 forward_timeout_s: float = 30.0,
                 health_interval_s: float | None = None,
                 failure_threshold: int | None = None,
                 latency: LatencyWindow | None = None,
                 rng: random.Random | None = None):
        if isinstance(replicas, (list, tuple)):
            replicas = {f"r{i}": (addr, None)
                        for i, addr in enumerate(replicas)}
        self.metrics = metrics or ServiceMetrics("risk")
        self.replicas = {
            rid: ReplicaEndpoint(rid, addr, http_addr)
            for rid, (addr, http_addr) in replicas.items()
        }
        # Pod-as-unit topology (Podracer, PAPERS.md): the ring hashes
        # accounts onto PODS — mesh-backed replica groups whose
        # slot-sharded state spans the whole mesh — not onto single
        # chips. ``pods`` maps pod id -> member replica ids; the default
        # (every replica its own pod, pod id == replica id) reproduces
        # the single-replica mapping bit-for-bit, so existing
        # fleets and the golden ring owners are unchanged.
        if pods is None:
            pods = {rid: (rid,) for rid in self.replicas}
        self.pods = {p: tuple(ms) for p, ms in pods.items()}
        unknown = sorted(m for ms in self.pods.values() for m in ms
                         if m not in self.replicas)
        if unknown:
            raise ValueError(f"pod members without endpoints: {unknown}")
        self.pod_of = {m: p for p, ms in self.pods.items() for m in ms}
        orphans = sorted(r for r in self.replicas if r not in self.pod_of)
        if orphans:
            raise ValueError(f"replicas assigned to no pod: {orphans}")
        self.ring = HashRing(self.pods, vnodes=vnodes)
        self.pod_ring = PodRing(self.ring, self.pod_of, self.pods)
        if hedge is None:
            hedge = os.environ.get("ROUTER_HEDGE", "1") != "0"
        self.hedge_enabled = hedge
        if max_attempts is None:
            max_attempts = int(os.environ.get("ROUTER_MAX_ATTEMPTS", "3"))
        self.max_attempts = max(1, max_attempts)
        if failure_threshold is None:
            failure_threshold = int(
                os.environ.get("ROUTER_FAILURE_THRESHOLD", "2"))
        self.forward_timeout_s = forward_timeout_s
        self.latency = latency or LatencyWindow(
            quantile=float(os.environ.get("ROUTER_HEDGE_QUANTILE", "0.95")),
            default_ms=float(os.environ.get("ROUTER_HEDGE_DEFAULT_MS", "75")),
        )
        # Seeded only for tests; production jitter wants real entropy.
        self._rng = rng or random.Random()
        self._rng_lock = threading.Lock()
        self.watcher = FleetHealthWatcher(
            self.pod_ring, self.replicas,
            interval_s=(health_interval_s if health_interval_s is not None
                        else float(os.environ.get(
                            "ROUTER_HEALTH_INTERVAL_S", "0.25"))),
            failure_threshold=failure_threshold, metrics=self.metrics)
        self._pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="router-fanout")
        # Retry/pushback/hedge accounting mirrored as plain counters so
        # harnesses read exact integers without scraping metric text.
        self.stats_lock = threading.Lock()
        self.stats = {
            "forwards": 0, "retries": 0, "pushbacks_honored": 0,
            "hedges_launched": 0, "hedge_wins": 0, "primary_wins": 0,
            "hedges_both_failed": 0, "link_drops": 0,
            "hedges_suppressed": 0, "deadline_sheds": 0,
        }

        # Fleet aggregation plane (obs/fleetview.py): built by
        # start_fleetview — None until then.
        self.fleetview = None
        self.http_server = None
        self.http_port = 0

    def start(self) -> "ScoringRouter":
        self.watcher.start()
        return self

    def start_fleetview(self, http_port: int = 0) -> int:
        """Start the cross-replica aggregation plane plus the router's
        own HTTP sidecar: ``/debug/fleetz`` (fleet rollup — merged stage
        histograms, per-replica SLO burn, slowest traces fleet-wide),
        ``/debug/routerz`` (ring/watcher/stats snapshot) and
        ``/metrics``. Returns the bound HTTP port. Replica targets
        resolve live so a restarted replica's sidecar is re-scraped at
        its (stable) address without re-wiring."""
        import json as _json
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from igaming_platform_tpu_torch.obs.fleetview import FleetView

        def targets() -> dict[str, str]:
            return {rid: r.http_addr for rid, r in self.replicas.items()
                    if r.http_addr}

        self.fleetview = FleetView(
            targets, metrics=self.metrics,
            ring_provider=self.snapshot).start()
        router_ref = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, code: int, body: str,
                      content_type: str = "application/json") -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/debug/fleetz":
                    # Always last-good state — never a live scrape: a
                    # dead or SIGSTOP'd replica shows stale-stamped,
                    # the endpoint never blocks on it.
                    self._send(200, _json.dumps(
                        router_ref.fleetview.snapshot()))
                elif self.path == "/debug/routerz":
                    self._send(200, _json.dumps(router_ref.snapshot()))
                elif self.path == "/metrics":
                    self._send(200,
                               router_ref.metrics.registry.render_text(),
                               "text/plain")
                else:
                    self._send(404, '{"error":"not found"}')

        httpd = ThreadingHTTPServer(("0.0.0.0", http_port), Handler)
        thread = threading.Thread(target=httpd.serve_forever,
                                  name="router-http-sidecar", daemon=True)
        thread.start()
        self.http_server = httpd
        self.http_port = httpd.server_address[1]
        return self.http_port

    def close(self) -> None:
        self.watcher.stop()
        if self.fleetview is not None:
            self.fleetview.stop()
        if self.http_server is not None:
            self.http_server.shutdown()
        self._pool.shutdown(wait=False)
        for r in self.replicas.values():
            r.close()

    def _bump(self, key: str, n: int = 1) -> None:
        with self.stats_lock:
            self.stats[key] += n

    def _jitter(self) -> float:
        with self._rng_lock:
            return 0.5 + self._rng.random()

    def _endpoint(self, owner: str) -> ReplicaEndpoint:
        """Resolve a ring owner (a POD id) to the member endpoint to
        dial: the first serving member, else the first in-ring
        (degraded) one, else the first member — a fully-dark pod still
        yields a dialable endpoint so the retry path produces honest
        failure evidence instead of a KeyError."""
        members = self.pods.get(owner)
        if not members:
            return self.replicas[owner]
        fallback = None
        for rid in members:
            r = self.replicas[rid]
            if r.state == "serving":
                return r
            if fallback is None and r.state in _IN_RING:
                fallback = r
        return fallback or self.replicas[members[0]]

    # -- retry/forward core --------------------------------------------------

    def _backoff_s(self, exc) -> float:
        """Jittered, bounded pre-retry wait: the server's pushback hint
        when present (that's the breaker's open window talking), a small
        default otherwise. Jitter (0.5x-1.5x) keeps a fleet of routers
        from re-probing a recovering replica in lockstep."""
        pushback_ms = _pushback_ms_from(exc)
        if pushback_ms is not None:
            self._bump("pushbacks_honored")
            self.metrics.router_retries_total.inc(reason="pushback")
            base_s = min(pushback_ms, 2000) / 1000.0
        else:
            self.metrics.router_retries_total.inc(reason="unavailable")
            base_s = 0.02
        return base_s * self._jitter()

    @staticmethod
    def _outbound_metadata(fallback: tuple = (),
                           deadline: Deadline | None = None) -> tuple:
        """Per-hop outbound metadata: the CURRENT span's traceparent when
        the router is inside one (so the replica's rpc span parents under
        the router's attempt span — router time and hedges become visible
        stages of the same trace), else the caller's forwarded header;
        plus ``risk-deadline-ms`` DECREMENTED by the time already spent
        at this hop — the replica sees the budget that is actually left,
        recomputed at every send (retries and hedges each get the honest
        remainder), floored at 0 so a spent budget sheds at the replica's
        admission instead of being scored dead."""
        tp = tracing.current_traceparent()
        md = [("traceparent", tp)] if tp else [
            kv for kv in fallback if kv[0] != DEADLINE_METADATA_KEY]
        ms = outbound_deadline_ms(deadline)
        if ms is not None:
            md.append((DEADLINE_METADATA_KEY, str(ms)))
        return tuple(md)

    def _forward(self, call_attr: str, payload: bytes, key: str,
                 timeout_s: float, metadata: tuple = (),
                 ddl: Deadline | None = None) -> bytes:
        """Forward to the ring owner of ``key``; UNAVAILABLE walks the
        ring to the next owner with a jittered (pushback-honoring) wait
        between attempts, bounded by ``max_attempts``. ``ddl`` is the
        caller's deadline — each attempt's outbound ``risk-deadline-ms``
        carries the remaining budget at THAT send."""
        grpc = _grpc()
        tried: set[str] = set()
        last_exc = None
        for attempt in range(self.max_attempts):
            owners = self.ring.owners(key, n=self.max_attempts)
            target = next((o for o in owners if o not in tried), None)
            if target is None:
                break
            replica = self._endpoint(target)
            self._bump("forwards")
            try:
                # Each attempt is a trace stage: fleet traces show which
                # replica answered, which attempts burned time, and the
                # stage histogram gains a `router.attempt` row.
                with tracing.span("router.attempt", replica=replica.id,
                                  attempt=attempt):
                    if chaos.fire("router.forward") == "drop":
                        self._bump("link_drops")
                        raise RouterForwardError(
                            f"router->{target} link dropped (chaos)")
                    return getattr(replica, call_attr)(
                        payload, timeout=timeout_s,
                        metadata=self._outbound_metadata(metadata, ddl))
            except grpc.RpcError as exc:
                if exc.code() != grpc.StatusCode.UNAVAILABLE:
                    raise  # the replica answered; its status is the answer
                tried.add(target)
                last_exc = exc
                # An UNAVAILABLE *with* a pushback hint is an ANSWERING
                # replica shedding (supervisor watchdog/brownout) — the
                # health probe will classify it; only a hintless failure
                # (dead socket, refused connection) is death evidence.
                if _pushback_ms_from(exc) is None:
                    self.watcher.note_forward_failure(replica.id, exc)
                if attempt + 1 >= self.max_attempts:
                    break
                time.sleep(self._backoff_s(exc))
            except (RouterForwardError, chaos.ChaosError) as exc:
                # A dropped/errored LINK is not replica-death evidence —
                # the replica may be healthy behind a flaky path, and one
                # drop is already absorbed by retrying the next owner.
                # Death comes from real RPC failures and health probes
                # (seam router.health covers the probe path).
                tried.add(target)
                self.metrics.router_retries_total.inc(reason="link_drop")
                if attempt + 1 >= self.max_attempts:
                    raise RouterForwardError(
                        f"all owners failed for key {key!r}: {exc}") from exc
            self._bump("retries")
        raise RouterForwardError(
            f"no serving owner for key {key!r} after "
            f"{len(tried) or self.max_attempts} attempts "
            f"(ring active={sorted(self.ring.active)}, last={last_exc!r})")

    # -- hedged single-transaction path --------------------------------------

    def _hedged_score_txn(self, payload: bytes, key: str, timeout_s: float,
                          metadata: tuple, ddl: Deadline | None = None) -> bytes:
        grpc = _grpc()
        owners = self.ring.owners(key, n=2)
        if len(owners) < 2:
            return self._forward("score_txn", payload, key, timeout_s,
                                 metadata, ddl)
        primary, secondary = self._endpoint(owners[0]), self._endpoint(owners[1])
        t0 = time.monotonic()
        self._bump("forwards")
        fut_primary = primary.score_txn.future(
            payload, timeout=timeout_s,
            metadata=self._outbound_metadata(metadata, ddl))
        hedge_s = self.latency.hedge_deadline_s()
        try:
            data = fut_primary.result(timeout=hedge_s)
        except grpc.FutureTimeoutError:
            pass  # straggler: hedge below
        except grpc.RpcError as exc:
            # A FAST failure is the retry path's job, not the hedge's.
            if exc.code() != grpc.StatusCode.UNAVAILABLE:
                raise
            if _pushback_ms_from(exc) is None:
                self.watcher.note_forward_failure(primary.id, exc)
            self._bump("retries")
            time.sleep(self._backoff_s(exc))
            return self._forward("score_txn", payload, key,
                                 timeout_s, metadata, ddl)
        else:
            self.latency.observe_ms((time.monotonic() - t0) * 1000.0)
            return data

        # Deadline-aware hedge budget rule: a hedge is only worth its
        # device time when the request's REMAINING budget still covers
        # the secondary's expected completion (the same p95-derived
        # figure the hedge trigger uses). Past that point the secondary
        # would answer a caller who already gave up — ride out the
        # primary instead and let its own deadline handling decide.
        if ddl is not None and ddl.remaining_ms() < hedge_s * 1000.0:
            self._bump("hedges_suppressed")
            self.metrics.hedge_total.inc(outcome="suppressed")
            remaining_s = max(0.01, min(timeout_s - hedge_s,
                                        ddl.remaining_ms() / 1000.0))
            try:
                data = fut_primary.result(timeout=remaining_s)
            except grpc.FutureTimeoutError as exc:
                fut_primary.cancel()
                raise RouterForwardError(
                    f"primary {primary.id} straggled past the request "
                    "deadline with no hedge budget left") from exc
            self.latency.observe_ms((time.monotonic() - t0) * 1000.0)
            return data

        # Hedge: the secondary owner races the straggling primary. The
        # race runs inside a `router.hedge` span whose outcome attribute
        # records who won — hedge outcomes become visible trace stages.
        self._bump("hedges_launched")
        self.metrics.hedge_total.inc(outcome="launched")
        tracing.set_root_attribute("hedged", secondary.id)
        self._bump("forwards")
        with tracing.span("router.hedge", replica=secondary.id) as hedge_span:
            fut_hedge = secondary.score_txn.future(
                payload, timeout=timeout_s,
                metadata=self._outbound_metadata(metadata, ddl))
            done = threading.Event()
            fut_primary.add_done_callback(lambda _f: done.set())
            fut_hedge.add_done_callback(lambda _f: done.set())
            deadline = time.monotonic() + timeout_s
            failed: set[str] = set()
            while time.monotonic() < deadline:
                done.wait(timeout=max(0.0, deadline - time.monotonic()))
                done.clear()
                for name, fut, loser in (
                    ("primary", fut_primary, fut_hedge),
                    ("hedge", fut_hedge, fut_primary),
                ):
                    if name in failed or not fut.done():
                        continue
                    try:
                        data = fut.result(timeout=0)
                    except (grpc.RpcError, grpc.FutureTimeoutError,
                            grpc.FutureCancelledError) as exc:
                        failed.add(name)
                        if isinstance(exc, grpc.RpcError):
                            rid = primary.id if name == "primary" else secondary.id
                            self.watcher.note_forward_failure(rid, exc)
                        continue
                    loser.cancel()
                    self.latency.observe_ms((time.monotonic() - t0) * 1000.0)
                    if name == "primary":
                        self._bump("primary_wins")
                        self.metrics.hedge_total.inc(outcome="win_primary")
                        hedge_span.attributes["outcome"] = "win_primary"
                    else:
                        self._bump("hedge_wins")
                        self.metrics.hedge_total.inc(outcome="win_hedge")
                        hedge_span.attributes["outcome"] = "win_hedge"
                    return data
                if {"primary", "hedge"} <= failed:
                    break
            fut_primary.cancel()
            fut_hedge.cancel()
            self._bump("hedges_both_failed")
            self.metrics.hedge_total.inc(outcome="both_failed")
            hedge_span.attributes["outcome"] = "both_failed"
        raise RouterForwardError(
            f"hedged ScoreTransaction failed on both owners "
            f"({primary.id}, {secondary.id}) for account {key!r}")

    # -- gRPC handlers -------------------------------------------------------

    def _timeout_for(self, context) -> float:
        remaining = context.time_remaining() if context is not None else None
        if remaining is None or remaining <= 0:
            return self.forward_timeout_s
        return min(self.forward_timeout_s, max(0.05, remaining - 0.05))

    @staticmethod
    def _propagate_metadata(context) -> tuple:
        """Forward the caller's W3C trace context so client -> router ->
        replica spans share one trace id."""
        if context is None:
            return ()
        try:
            for k, v in context.invocation_metadata() or ():
                if k == "traceparent":
                    return (("traceparent", v),)
        except Exception:  # noqa: CC04 — tracing must not fail the forward
            pass
        return ()

    def _abort(self, exc: Exception):
        from igaming_platform_tpu_torch.serve.grpc_server import (
            RpcAbort,
            StatusCode,
            _pushback_trailing,
        )

        return RpcAbort(StatusCode.UNAVAILABLE, str(exc),
                        trailing=_pushback_trailing())

    def _admit_deadline(self, context) -> Deadline | None:
        """The caller's deadline at the router hop: ``risk-deadline-ms``
        metadata or the gRPC context deadline — None when the caller sent
        neither (the router never invents one; replicas apply their own
        default at their admission). Already-expired requests shed HERE
        with DEADLINE_EXCEEDED + pushback: forwarding work no replica
        can finish in time just burns fleet capacity."""
        ddl = deadline_mod.from_grpc(
            context, default_ms=deadline_mod.DEADLINE_MAX_MS)
        if ddl.source == "default":
            return None
        if ddl.expired():
            from igaming_platform_tpu_torch.serve.grpc_server import (
                RpcAbort,
                StatusCode,
                _pushback_trailing,
            )

            self._bump("deadline_sheds")
            self.metrics.deadline_expired_total.inc(stage="router")
            raise RpcAbort(
                StatusCode.DEADLINE_EXCEEDED,
                "DEADLINE_SHED: request budget already spent at the "
                "router hop",
                trailing=_pushback_trailing(), shed=True)
        return ddl

    @staticmethod
    def _invalid(what: str, exc: Exception):
        from igaming_platform_tpu_torch.serve.grpc_server import RpcAbort, StatusCode

        return RpcAbort(StatusCode.INVALID_ARGUMENT, f"bad {what}: {exc}")

    def ScoreTransaction(self, request, context):  # noqa: N802
        buf = bytes(request)
        try:
            account_id = codec.decode(codec.SCORE_TRANSACTION_REQUEST, buf)["account_id"]
        except Exception as exc:  # noqa: BLE001 — malformed proto is the caller's INVALID_ARGUMENT
            raise self._invalid("ScoreTransactionRequest", exc) from exc
        metadata = self._propagate_metadata(context)
        timeout_s = self._timeout_for(context)
        ddl = self._admit_deadline(context)
        try:
            # Routing is a trace stage of the client's request: the time
            # between "router had the bytes" and "a replica answered" —
            # attempts and hedges nest under it.
            with tracing.span("router.route", method="ScoreTransaction"):
                if self.hedge_enabled:
                    data = self._hedged_score_txn(buf, account_id, timeout_s, metadata, ddl)
                else:
                    data = self._forward("score_txn", buf, account_id, timeout_s, metadata, ddl)
        except RouterForwardError as exc:
            raise self._abort(exc) from exc
        self.metrics.txns_scored_total.inc()
        return data

    def ScoreBatch(self, request, context):  # noqa: N802
        from igaming_platform_tpu_torch.serve.wire import decode_index_batch

        buf = bytes(request)
        metadata = self._propagate_metadata(context)
        timeout_s = self._timeout_for(context)
        ddl = self._admit_deadline(context)
        if buf[:4] == INDEX_WIRE_MAGIC:
            # Index frames are built per owner by the client picker; the
            # router routes a frame by its first account and fails over
            # whole, never splitting a frame it would have to re-encode.
            try:
                ids = decode_index_batch(buf)[0]
            except ValueError as exc:
                raise self._invalid("index-mode frame", exc) from exc
            key = ids[0] if ids else ""
            key = key.decode(errors="replace") if isinstance(key, (bytes, memoryview)) else key
            try:
                with tracing.span("router.route", method="ScoreBatch", mode="index"):
                    data = self._forward("score_batch", buf, key, timeout_s, metadata, ddl)
            except RouterForwardError as exc:
                raise self._abort(exc) from exc
            self.metrics.txns_scored_total.inc(len(ids))
            tracing.set_root_attribute("rows", len(ids))
            return data
        try:
            entries = _entries(buf)
            keys = [_entry_account(e) for e in entries]
        except Exception as exc:  # noqa: BLE001 — malformed proto is the caller's INVALID_ARGUMENT
            raise self._invalid("ScoreBatchRequest", exc) from exc
        tracing.set_root_attribute("rows", len(entries))
        groups: dict[str, list[int]] = {}
        for i, key in enumerate(keys):
            owner = self.ring.owner(key)
            if owner is None:
                raise self._abort(RouterForwardError("ring has no active replicas"))
            groups.setdefault(owner, []).append(i)
        try:
            with tracing.span("router.route", method="ScoreBatch", owners=len(groups)):
                if len(groups) <= 1:
                    data = self._forward("score_batch", buf, keys[0] if keys else "",
                                         timeout_s, metadata, ddl)
                    self.metrics.txns_scored_total.inc(len(entries))
                    return data
                data = self._split_batch(entries, keys, groups, timeout_s, metadata, ddl)
        except RouterForwardError as exc:
            raise self._abort(exc) from exc
        self.metrics.txns_scored_total.inc(len(entries))
        return data

    def _split_batch(self, entries: list[bytes], keys: list[str], groups: dict[str, list[int]],
                     timeout_s: float, metadata: tuple, ddl: Deadline | None = None) -> bytes:
        """Account-affinity split: each owner gets exactly its rows (their
        request entries as they arrived), the sub-batches fly
        concurrently, and the result entries merge back in request order.
        A sub-batch whose owner dies mid-flight retries onto the next ring
        owner like any other forward."""
        parent = tracing.current_span()

        def _one(owner: str, idxs: list[int]):
            # Re-enter the routing span on the fan-out thread so each
            # sub-forward's `router.attempt` stays in the client's trace.
            with tracing.carry(parent):
                payload = self._forward("score_batch", b"".join(entries[i] for i in idxs),
                                        keys[idxs[0]], timeout_s, metadata, ddl)
                return idxs, _entries(payload)

        futures = [self._pool.submit(_one, owner, idxs) for owner, idxs in groups.items()]
        merged: list = [None] * len(entries)
        for fut in futures:
            idxs, results = fut.result(timeout=timeout_s + 1.0)
            if len(results) != len(idxs):
                raise RouterForwardError(
                    f"sub-batch returned {len(results)} results for {len(idxs)} rows")
            for i, result in zip(idxs, results):
                merged[i] = result
        return b"".join(merged)

    def snapshot(self) -> dict:
        with self.stats_lock:
            stats = dict(self.stats)
        out_members = self.pod_ring.out_members()
        pods = {}
        for pod, members in self.pods.items():
            caps = [self.replicas[m].capacity_slots for m in members]
            hbms = [self.replicas[m].hbm_bytes for m in members]
            pods[pod] = {
                "members": {m: self.replicas[m].state for m in members},
                "in_ring": not set(members) <= out_members,
                # Aggregate advertisement: the pod's mesh holds ONE
                # slot-sharded state image, so capacity sums over the
                # members that reported (None until first deep scrape).
                "capacity_slots": (sum(c for c in caps if c is not None)
                                   or None),
                "hbm_bytes": (sum(b for b in hbms if b is not None)
                              or None),
            }
        return {
            "ring": self.ring.snapshot(),
            "pods": pods,
            "watcher": self.watcher.snapshot(),
            "stats": stats,
            "hedge_deadline_ms": round(
                self.latency.hedge_deadline_s() * 1000.0, 3),
        }


def _entry_account(entry: bytes) -> str:
    """The account_id of one raw ScoreBatch request entry."""
    n = len(entry)
    _, pos = codec._read_varint(entry, 0, n)
    _, pos = codec._read_varint(entry, pos, n)
    return codec.decode(codec.SCORE_TRANSACTION_REQUEST, entry, pos, n)["account_id"]


# ---------------------------------------------------------------------------
# Client-side picker (no extra hop): the same ring, driven by the client


class AccountAffinityPicker:
    """The router's ring without the router's hop: a client partitions its
    accounts by ring owner and sends each replica only the accounts it owns
    — identical affinity to the L7 router, zero added latency, at the cost
    of every client knowing the replica list. Failover mirrors the router:
    on UNAVAILABLE the caller asks :meth:`failover_addrs` for the next
    owners and retries there."""

    def __init__(self, addrs: list[str], *, vnodes: int = 64):
        self.addrs = dict(enumerate(addrs))
        self.ring = HashRing((f"r{i}" for i in self.addrs), vnodes=vnodes)

    def _addr(self, rid: str) -> str:
        return self.addrs[int(rid[1:])]

    def owner_addr(self, account_id: str) -> str:
        owner = self.ring.owner(account_id)
        if owner is None:
            raise RuntimeError("picker ring has no active replicas")
        return self._addr(owner)

    def failover_addrs(self, account_id: str, n: int = 3) -> list[str]:
        return [self._addr(rid)
                for rid in self.ring.owners(account_id, n=n)]

    def partition(self, account_ids: Iterable[str]) -> dict[str, list[str]]:
        """addr -> account_ids it owns (a client's payload building)."""
        out: dict[str, list[str]] = {}
        for acct in account_ids:
            out.setdefault(self.owner_addr(acct), []).append(acct)
        return out


# ---------------------------------------------------------------------------
# Server assembly


def serve_router(router: ScoringRouter, port: int, max_workers: int = 32,
                 http_port: int | None = None):
    """Start the router's gRPC front; returns (server, health, port). The
    health servicer reports NOT_SERVING when the ring has no active
    replicas: an empty fleet must fail its own health check.
    ``http_port`` (0 = ephemeral) also starts the fleet aggregation plane
    and its sidecar (``/debug/fleetz``); the bound port lands on
    ``router.http_port``. Raises RuntimeError without grpcio."""
    from concurrent import futures as _futures

    from igaming_platform_tpu_torch.serve import reflection
    from igaming_platform_tpu_torch.serve.grpc_server import (
        HealthServicer,
        RISK_SERVICE,
        _invoke_rpc,
        _rpc,
    )

    grpc = _grpc()
    health = HealthServicer()
    server = grpc.server(_futures.ThreadPoolExecutor(max_workers=max_workers))

    def handler(name):
        fn = getattr(router, name)
        return grpc.unary_unary_rpc_method_handler(_rpc(
            grpc, lambda payload, context: _invoke_rpc(router.metrics, name, fn, payload,
                                                       context)))

    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(
            RISK_SERVICE, {name: handler(name) for name in router.raw_request_methods}),
        grpc.method_handlers_generic_handler("grpc.health.v1.Health", {
            "Check": grpc.unary_unary_rpc_method_handler(_rpc(grpc, health.check))}),
        reflection.grpc_handler(grpc, (RISK_SERVICE, "grpc.health.v1.Health")),
    ))
    bound = server.add_insecure_port(f"[::]:{port}")
    server.start()
    router.start()
    if http_port is not None:
        router.start_fleetview(http_port)
    return server, health, bound
