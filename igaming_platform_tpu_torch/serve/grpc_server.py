"""The risk.v1 RiskService on request and response bytes, and its gRPC binding.

The port's counterpart of the risk half of
``igaming_platform_tpu/serve/grpc_server.py``. ``RiskGrpcService`` answers
all ten risk.v1 RPCs, ScoreTransaction, ScoreBatch, PredictLTV,
GetPlayerSegment, CheckBonusAbuse, AddToBlacklist, CheckBlacklist,
GetFeatures, UpdateThresholds and GetThresholds: each
handler takes the request's wire bytes and returns the response as a
``RawProtoMessage``, or raises ``RpcAbort`` with a status. Requests are
decoded and responses encoded by the port's own codec
(``serve/risk_codec.py``): ScoreBatch goes bytes to bytes through the native
store and encoder, or, for an index-mode frame (``IDX1``), through the
engine's device feature cache (``score_batch_wire_index``);
ScoreTransaction's answer goes through the same native encoder. So the
service needs no transport: ``call(method, payload, metadata=())`` drives it
directly, as ``chip_smoke.py`` does on a machine without grpcio, with the
invocation metadata a client would send (``risk-deadline-ms``,
``traceparent``), and ``call_with_trailing`` also returns the trailing
metadata a handler set: a ScoreTransaction whose decision a ledger noted
carries ``("risk-decision-id", id)``, the key a label backfill joins on, and
a shed carries ``("grpc-retry-pushback-ms", ...)``.

Every RPC runs inside the JAX service's wrapper: a root span ``rpc.<Method>``
parented by the caller's ``traceparent`` (stage spans nest under it and the
flight recorder, ``obs/flight.py``, keeps the completed root), the
supervisor's ``serving_state`` on it, ``observe_rpc`` with the status code,
and sheds (deadline, queue, burn, bulk) marked so the SLO engine
(``obs/slo.py``, installed unless ``SLO=0``) keeps them out of the error
budget. ScoreTransaction is admitted with its deadline (``risk-deadline-ms``,
else ``DEADLINE_DEFAULT_MS``, else ``SLO_OBJECTIVE_MS``; a spent one sheds
as DEADLINE_EXCEEDED) and scored through the engine's deadline scheduler;
ScoreBatch also sheds while the SLO's fast window burns
(``serve/deadline.BurnShedGate``). The supervisor's ``DeviceWedgedError``
and ``ServingUnavailable`` answer UNAVAILABLE with the pushback trailer. The
service's ``ServiceMetrics`` (``metrics=``, else its own) is bound to the
engine's score histogram, cache, session, pipeline and supervisor, to the
batcher's queue and deadline hooks and to the span sink.

PredictLTV and GetPlayerSegment score one account's 25 LTV features, from
the ``ltv_source`` callable (zeros when it has none), through
``models/ltv.py`` on the engine's device, as the JAX handlers do, each after
a background turn of the engine's dispatch lane gate; PredictLTV counts
``ltv_segment_total``.

``serve_risk`` binds it to grpcio with identity (de)serializers, and
``make_risk_stub`` gives a bytes-in, bytes-out client; ``serve_risk`` is the
one place the port imports ``grpc``, inside its body. It also registers
gRPC server reflection (``serve/reflection.py``) for ``risk.v1.RiskService``
and ``grpc.health.v1.Health``, as the JAX server does.

As in the JAX package, the service installs the process's drift engine
(``obs/drift.py``) and binds it to the engine unless ``DRIFT=0``: every
batch the engine scores is then sketched. ``close()`` unbinds, closes and
uninstalls it, and uninstalls the SLO engine it installed. The host
profiler (``obs/hostprof.py``) is installed when this module is imported and
fed the service's metrics; the runtime telemetry (``obs/runtime_telemetry.py``)
is installed and bound to the engine unless ``RUNTIME_TELEMETRY=0``.

``WalletGrpcService`` answers the ten wallet.v1 RPCs over
``platform/wallet.WalletService`` on bytes (``serve/wallet_codec.py``), with
the JAX service's domain error map and flow counters, inside the same RPC
wrapper (``_invoke_rpc``); ``serve_wallet`` binds it to grpcio and
``make_wallet_stub`` is its bytes client; like the JAX ``serve_wallet``, it
registers server reflection.
"""

from __future__ import annotations

import enum
import logging
import os
import threading
import time

import numpy as np

from igaming_platform_tpu_torch.core.enums import REASON_BIT_ORDER, ReasonCode
from igaming_platform_tpu_torch.core.features import NUM_FEATURES, F, FeatureVector
from igaming_platform_tpu_torch.models import ltv as ltv_mod
from igaming_platform_tpu_torch.obs import drift as drift_mod
from igaming_platform_tpu_torch.obs import flight as flight_mod
from igaming_platform_tpu_torch.obs import hostprof
from igaming_platform_tpu_torch.obs import runtime_telemetry as runtime_telemetry_mod
from igaming_platform_tpu_torch.obs import slo as slo_mod
from igaming_platform_tpu_torch.obs import tracing
from igaming_platform_tpu_torch.obs.metrics import ServiceMetrics
from igaming_platform_tpu_torch.obs.tracing import span
from igaming_platform_tpu_torch.serve import deadline as deadline_mod
from igaming_platform_tpu_torch.serve import reflection
from igaming_platform_tpu_torch.serve import risk_codec as codec
from igaming_platform_tpu_torch.serve import wallet_codec
from igaming_platform_tpu_torch.serve.abuse import AbuseShed
from igaming_platform_tpu_torch.serve.deadline import (
    LANE_BACKGROUND,
    BurnShedGate,
    DeadlineExpired,
    QueueFullError,
)
from igaming_platform_tpu_torch.serve.scorer import ScoreRequest
from igaming_platform_tpu_torch.serve.supervisor import (
    RETRY_PUSHBACK_MS,
    DeviceWedgedError,
    ServingUnavailable,
)
from igaming_platform_tpu_torch.serve.wire import INDEX_WIRE_MAGIC, RawProtoMessage

logger = logging.getLogger(__name__)

# The flight recorder is always on: every completed rpc.* root lands in its
# bounded ring (/debug/flightz).
flight_mod.install()
# The host profiler is always on unless HOSTPROF=0 (/debug/hostprofz).
hostprof.install()

# The risk.v1 methods the binding registers: all ten.
RISK_SERVICE = "risk.v1.RiskService"
RISK_METHOD_NAMES = ("ScoreTransaction", "ScoreBatch", "CheckBonusAbuse", "AddToBlacklist",
                     "CheckBlacklist", "GetFeatures", "UpdateThresholds", "GetThresholds",
                     "PredictLTV", "GetPlayerSegment")
_ACTION_CODES = {"approve": 1, "review": 2, "block": 3}


class StatusCode(enum.Enum):
    """gRPC status codes: the names and numbers of ``grpc.StatusCode``."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class CallContext:
    """The part of a grpcio servicer context a handler uses, for calls
    without a transport: the invocation metadata in, the trailing metadata
    out, no transport deadline (``time_remaining`` is None)."""

    def __init__(self, metadata=()):
        self._metadata = tuple(metadata)
        self.trailing: tuple[tuple[str, str], ...] = ()

    def invocation_metadata(self):
        return self._metadata

    def time_remaining(self):
        return None

    def set_trailing_metadata(self, pairs) -> None:
        self.trailing = tuple(pairs)


class RpcAbort(Exception):
    """Typed abort raised inside handlers; the binding maps it to a status.
    ``trailing`` metadata (the ``grpc-retry-pushback-ms`` hint of a shed)
    goes out with it; ``shed`` marks deliberate backpressure, which the SLO
    engine keeps out of the error budget."""

    def __init__(self, code: StatusCode, details: str, trailing: tuple = (),
                 shed: bool = False):
        super().__init__(details)
        self.code = code
        self.details = details
        self.trailing = tuple(trailing)
        self.shed = shed


def _pushback_trailing() -> tuple:
    return (("grpc-retry-pushback-ms", str(RETRY_PUSHBACK_MS)),)


def _traceparent_from_metadata(context) -> str | None:
    """The W3C ``traceparent`` of the call's metadata, or None (a missing or
    malformed header starts a new trace)."""
    if context is None:
        return None
    try:
        for key, value in context.invocation_metadata() or ():
            if key == "traceparent":
                return value
    except Exception:  # noqa: BLE001 — tracing must not fail the RPC
        pass
    return None


def _invoke_rpc(metrics: ServiceMetrics, method: str, handler, payload: bytes, context) -> bytes:
    """One RPC on bytes inside the root span ``rpc.<method>``, as the JAX
    services' ``_rpc`` wrapper runs it: metrics by status code, the
    supervisor's serving state, sheds marked; ``handler(payload, context)``
    returns the response bytes. A handler that fails otherwise is INTERNAL,
    as the reference's recovery interceptor maps it."""
    start = time.monotonic()
    with span(f"rpc.{method}", traceparent=_traceparent_from_metadata(context)) as root:
        state = slo_mod.current_state()
        if state is not None:
            root.attributes["serving_state"] = state
        try:
            resp = handler(payload, context)
        except RpcAbort as abort:
            exc = abort
        except DeadlineExpired as err:
            # The budget ran out while queued: the caller's own status, a
            # shed (the scheduler already counted it).
            exc = RpcAbort(StatusCode.DEADLINE_EXCEEDED, str(err),
                           trailing=_pushback_trailing(), shed=True)
        except QueueFullError as err:
            exc = RpcAbort(StatusCode.RESOURCE_EXHAUSTED, str(err),
                           trailing=_pushback_trailing(), shed=True)
        except (DeviceWedgedError, ServingUnavailable) as err:
            # Supervisor sheds: UNAVAILABLE with the pushback hint, so
            # clients back off one breaker window.
            exc = RpcAbort(StatusCode.UNAVAILABLE, str(err), trailing=_pushback_trailing())
        except Exception as err:  # noqa: BLE001 — recovery interceptor
            logger.exception("handler panic in %s", method)
            exc = RpcAbort(StatusCode.INTERNAL, f"internal error: {err}")
            exc.__cause__ = err
        else:
            metrics.observe_rpc(method, start)
            root.attributes["code"] = "OK"
            return resp
        metrics.observe_rpc(method, start, code=exc.code.name)
        root.attributes["code"] = exc.code.name
        if exc.shed:
            root.attributes["shed"] = 1
        if exc.trailing and context is not None:
            context.set_trailing_metadata(exc.trailing)
        raise exc


SERVING, NOT_SERVING = 1, 2  # grpc.health.v1 HealthCheckResponse.ServingStatus


class HealthServicer:
    """The grpc.health.v1 Check method, on bytes."""

    def __init__(self):
        self._status: dict[str, int] = {"": SERVING}
        self._lock = threading.Lock()

    def set(self, service: str, status: int) -> None:
        with self._lock:
            self._status[service] = status

    def status(self, service: str = "") -> int | None:
        with self._lock:
            return self._status.get(service)

    def set_all_not_serving(self) -> None:
        with self._lock:
            for k in self._status:
                self._status[k] = NOT_SERVING

    def check(self, request: bytes, context=None) -> bytes:
        service = codec.decode(codec.HEALTH_CHECK_REQUEST, request)["service"]
        with self._lock:
            status = self._status.get(service)
        if status is None:
            raise RpcAbort(StatusCode.NOT_FOUND, "unknown service")
        return codec.encode(codec.HEALTH_CHECK_RESPONSE, {"status": status})


class _AdaptiveBulkGate:
    """Bounded bulk-admission gate with p99 feedback.

    Holds at most ``limit`` ScoreBatch RPCs in flight. Every ``window``
    single-transaction latencies it takes the window's ~p99: over the SLO
    it tightens the limit by one (down to ``min_limit``); after
    ``relax_after`` windows under half the SLO it relaxes one step back.
    """

    def __init__(self, limit: int, *, p99_slo_ms: float = 50.0,
                 window: int = 32, min_limit: int = 1, relax_after: int = 4):
        self.max_limit = max(1, limit)
        self.limit = self.max_limit
        self.p99_slo_ms = p99_slo_ms
        self._window = window
        self._min = min_limit
        self._relax_after = relax_after
        self._good_windows = 0
        self._lat: list[float] = []
        self._held = 0
        self._cv = threading.Condition()
        self.on_limit_change = None  # callable(limit): the bulk_gate_limit gauge

    def acquire(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._held >= self.limit:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
            self._held += 1
            return True

    def release(self) -> None:
        with self._cv:
            self._held -= 1
            self._cv.notify()

    def _set_limit(self, limit: int) -> None:
        self.limit = limit
        if self.on_limit_change is not None:
            self.on_limit_change(limit)

    def observe_single_ms(self, ms: float) -> None:
        """Feed one single-transaction latency; adjusts the limit at window
        boundaries. Off when p99_slo_ms <= 0."""
        if self.p99_slo_ms <= 0:
            return
        with self._cv:
            self._lat.append(float(ms))
            if len(self._lat) < self._window:
                return
            lat = sorted(self._lat)
            self._lat = []
            p99 = lat[max(0, int(len(lat) * 0.99) - 1)]
            if p99 > self.p99_slo_ms:
                self._good_windows = 0
                if self.limit > self._min:
                    self._set_limit(self.limit - 1)
            elif p99 <= 0.5 * self.p99_slo_ms:
                self._good_windows += 1
                if self._good_windows >= self._relax_after and self.limit < self.max_limit:
                    self._set_limit(self.limit + 1)
                    self._good_windows = 0
                    self._cv.notify_all()
            else:
                self._good_windows = 0


class _FixedWindowRateLimiter:
    """Per-account fixed-window counter (the INCR+EXPIRE semantics of the
    reference's CheckRateLimit, redis_store.go:196-203), at the RPC edge."""

    def __init__(self, per_minute: int):
        self.per_minute = per_minute
        self._lock = threading.Lock()
        self._windows: dict[str, tuple[int, int]] = {}

    def allow(self, account_id: str) -> bool:
        if not self.per_minute:
            return True
        now_min = int(time.time() // 60)
        with self._lock:
            win, count = self._windows.get(account_id, (now_min, 0))
            if win != now_min:
                win, count = now_min, 0
            count += 1
            self._windows[account_id] = (win, count)
            if len(self._windows) > 100_000:  # bound memory: drop stale windows
                self._windows = {a: wc for a, wc in self._windows.items() if wc[0] == now_min}
            return count <= self.per_minute


def _feature_fields(f: FeatureVector) -> dict:
    """The FeatureVector fields GetFeatures sets (the reference leaves the
    IP, device and bet-shape fields out of this view)."""
    return {
        "tx_count_1m": int(f.tx_count_1m), "tx_count_5m": int(f.tx_count_5m),
        "tx_count_1h": int(f.tx_count_1h), "tx_sum_1h": int(f.tx_sum_1h),
        "tx_avg_1h": f.tx_avg_1h, "unique_devices_24h": int(f.unique_devices_24h),
        "unique_ips_24h": int(f.unique_ips_24h), "account_age_days": int(f.account_age_days),
        "total_deposits": int(f.total_deposits), "total_withdrawals": int(f.total_withdrawals),
        "net_deposit": int(f.net_deposit), "deposit_count": int(f.deposit_count),
        "withdraw_count": int(f.withdraw_count),
        "time_since_last_tx_sec": int(f.time_since_last_tx),
        "session_duration_sec": int(f.session_duration),
        "bonus_claim_count": int(f.bonus_claim_count),
        "bonus_wager_completion_rate": f.bonus_wager_rate,
        "bonus_only_player": f.bonus_only_player > 0,
    }


def _score_feature_fields(f: FeatureVector) -> dict:
    """Every FeatureVector field a ScoreTransactionResponse carries."""
    fields = _feature_fields(f)
    fields.update({
        "ip_country_changes_7d": int(f.ip_country_changes), "device_age_days": int(f.device_age_days),
        "avg_bet_size": f.avg_bet_size, "win_rate": f.win_rate, "is_vpn": f.is_vpn > 0,
        "is_proxy": f.is_proxy > 0, "is_tor": f.is_tor > 0,
        "disposable_email": f.disposable_email > 0,
    })
    return fields


class RiskGrpcService:
    """risk.v1.RiskService over the port's scoring engine and abuse detector."""

    def __init__(self, engine, abuse_detector=None, rate_limit_per_minute: int = 0,
                 ltv_source=None, metrics: ServiceMetrics | None = None):
        """
        engine: serve.scorer.TorchScoringEngine (or a SupervisedScoringEngine)
        abuse_detector: callable(account_id, bonus_id) -> (score, signals, linked)
        rate_limit_per_minute: per-account ScoreTransaction cap (0 disables)
        ltv_source: callable(account_id) -> 25 LTV features or None
        metrics: the ServiceMetrics registry to feed (a new "risk" one if None)
        """
        self.engine = engine
        self.abuse_detector = abuse_detector
        self.ltv_source = ltv_source
        self.metrics = metrics or ServiceMetrics("risk")
        hostprof.install(self.metrics)
        self._rate_limiter = _FixedWindowRateLimiter(rate_limit_per_minute)
        # Bulk ScoreBatch work is admitted through a bounded gate: past
        # BULK_MAX_INFLIGHT concurrent RPCs (after a short wait) it sheds
        # with RESOURCE_EXHAUSTED, so single transactions keep their p99.
        self._bulk_gate = _AdaptiveBulkGate(
            max(1, int(os.environ.get("BULK_MAX_INFLIGHT", "2"))),
            p99_slo_ms=float(os.environ.get("BULK_P99_SLO_MS", "50")),
        )
        self.metrics.bulk_gate_limit.set(self._bulk_gate.limit)
        self._bulk_gate.on_limit_change = self.metrics.bulk_gate_limit.set
        self._bulk_admit_wait_s = float(os.environ.get("BULK_ADMIT_WAIT_S", "0.02"))
        # The engine's observability seams, in this service's registry: the
        # score histogram of wire batches (host numpy, vectorized), the
        # cache, session, pipeline and supervisor families.
        if hasattr(engine, "score_observer"):
            engine.score_observer = self.metrics.score_distribution.observe_many
        for bind in ("bind_cache_metrics", "bind_pipeline_metrics", "bind_session_metrics",
                     "bind_supervisor_metrics"):
            if hasattr(engine, bind):
                getattr(engine, bind)(self.metrics)
        # Every completed stage span feeds risk_stage_latency_ms; span-ring
        # evictions count. The sinks are the process's: the most recently
        # built service owns them.
        tracing.set_span_sink(self.metrics.observe_stage_span)
        tracing.DEFAULT_COLLECTOR.on_drop = self.metrics.spans_dropped_total.inc
        # The SLO engine (SLO=0 opts out) rides the root-span sink.
        self.slo = None
        if os.environ.get("SLO", "1") != "0":
            self.slo = slo_mod.install(slo_mod.SLOEngine(metrics=self.metrics))
        else:
            slo_mod.uninstall()
        # The drift observatory (DRIFT=0 opts out): the process's default
        # engine, bound to the scoring engine, as the JAX service does.
        self.drift = None
        if os.environ.get("DRIFT", "1") != "0" and hasattr(engine, "bind_drift"):
            self.drift = drift_mod.install(drift_mod.DriftEngine(metrics=self.metrics))
            engine.bind_drift(self.drift)
        else:
            drift_mod.uninstall()
        # The runtime telemetry (RUNTIME_TELEMETRY=0 opts out): dispatches,
        # compile events and signatures, step-time anomalies. The server
        # binds the anomaly -> profile trigger on top.
        self.telemetry = None
        if os.environ.get("RUNTIME_TELEMETRY", "1") != "0":
            self.telemetry = runtime_telemetry_mod.install(self.metrics)
            self.telemetry.bind_engine(engine)
        else:
            runtime_telemetry_mod.uninstall()
        # While the SLO's fast window burns, bulk ScoreBatch admissions shed
        # so the interactive lane's p99 recovers.
        self.burn_gate = BurnShedGate()
        batcher = getattr(engine, "_batcher", None)
        if batcher is not None:
            batcher.on_batch = self._observe_batcher_batch
            batcher.on_plan = self.metrics.batch_size_chosen.observe
            batcher.on_dispatch_deadlines = self.metrics.deadline_remaining_ms.observe_many
            sched = batcher.scheduler
            sched.on_expired = (
                lambda n, stage, lane: self.metrics.deadline_expired_total.inc(n, stage=stage))
            sched.on_depth = lambda lane, depth: self.metrics.lane_depth.set(depth, lane=lane)

    def _observe_batcher_batch(self, waits_ms: list, depth: int) -> None:
        """Batcher hook: the time-in-queue histogram, the queue-depth gauge,
        and the queue wait as a ``score.queue`` stage."""
        self.metrics.batcher_queue_depth.set(depth)
        self.metrics.batcher_time_in_queue_ms.observe_many(waits_ms)
        self.metrics.stage_latency_ms.observe_many(waits_ms, stage="score.queue")

    def close(self) -> None:
        """Unbind the drift engine from the scoring engine, close it (its
        queued sketches are folded first) and uninstall it if it is still
        the process default; uninstall the SLO engine this service
        installed, and the runtime telemetry. Idempotent."""
        slo, self.slo = self.slo, None
        if slo is not None and slo_mod.get_default() is slo:
            slo_mod.uninstall()
        telemetry, self.telemetry = self.telemetry, None
        if telemetry is not None and runtime_telemetry_mod.get_default() is telemetry:
            runtime_telemetry_mod.uninstall()
        drift, self.drift = self.drift, None
        if drift is None:
            return
        if getattr(self.engine, "drift", None) is drift:
            self.engine.bind_drift(None)
        if drift_mod.get_default() is drift:
            drift_mod.uninstall()
        else:
            drift.close()

    def call(self, method: str, payload: bytes, metadata=()) -> bytes:
        """Answer one RPC on bytes, with no transport: the response bytes,
        or RpcAbort. ``metadata`` is the invocation metadata, (key, value)
        pairs as a gRPC client sends them."""
        return self._invoke(method, payload, CallContext(metadata))

    def call_with_trailing(self, method: str, payload: bytes,
                           metadata=()) -> tuple[bytes, tuple[tuple[str, str], ...]]:
        """``call``, and the trailing metadata pairs the handler set. An
        RpcAbort carries its own in ``.trailing``."""
        context = CallContext(metadata)
        return self._invoke(method, payload, context), context.trailing

    def _invoke(self, method: str, payload: bytes, context) -> bytes:
        """One RPC on bytes through ``_invoke_rpc``; ``context`` (a grpcio
        servicer context or a ``CallContext``) gives the invocation metadata
        and receives the trailing metadata."""
        if method not in RISK_METHOD_NAMES:
            raise RpcAbort(StatusCode.UNIMPLEMENTED, f"unknown method {method}")
        return _invoke_rpc(self.metrics, method,
                           lambda p, c: getattr(self, method)(p, c).SerializeToString(),
                           payload, context)

    # -- scoring --

    @staticmethod
    def _request_from_proto(req: dict) -> ScoreRequest:
        return ScoreRequest(
            account_id=req["account_id"],
            player_id=req["player_id"],
            amount=req["amount"],
            tx_type=req["transaction_type"] or "deposit",
            currency=req["currency"] or "USD",
            game_id=req["game_id"],
            ip=req["ip_address"],
            device_id=req["device_id"],
            fingerprint=req["fingerprint"],
            user_agent=req["user_agent"],
            session_id=req["session_id"],
        )

    @staticmethod
    def _score_to_bytes(resp) -> bytes:
        if ReasonCode.DEGRADED_CPU_HEURISTIC in resp.reason_codes:
            # The degraded tier's flag is no bit of the step's reason mask:
            # the whole answer goes through the field-by-field encoder.
            return codec.encode(codec.SCORE_TRANSACTION_RESPONSE, {
                "score": resp.score, "action": _ACTION_CODES[resp.action],
                "reason_codes": [r.value for r in resp.reason_codes],
                "rule_score": resp.rule_score, "ml_score": resp.ml_score,
                "response_time_ms": int(resp.response_time_ms),
                "features": _score_feature_fields(resp.features)})
        mask = sum(1 << REASON_BIT_ORDER.index(code) for code in resp.reason_codes)
        return codec.encode_score_response(
            resp.score, _ACTION_CODES[resp.action], mask, resp.rule_score, resp.ml_score,
            int(resp.response_time_ms), resp.features.to_array())

    def _admit_deadline(self, context, stage: str = "admission"):
        """The request's deadline (``risk-deadline-ms`` metadata, else the
        transport's, else ``DEADLINE_DEFAULT_MS``); an already spent one is
        shed here: scoring a row its caller will never receive only steals
        capacity."""
        ddl = deadline_mod.from_grpc(context)
        if ddl.expired():
            self.metrics.deadline_expired_total.inc(stage=stage)
            raise RpcAbort(
                StatusCode.DEADLINE_EXCEEDED,
                f"DEADLINE_SHED: request budget ({ddl.budget_ms:.0f} ms, source={ddl.source}) "
                "already spent at admission", trailing=_pushback_trailing(), shed=True)
        return ddl

    def ScoreTransaction(self, request: bytes, context=None):  # noqa: N802
        req = codec.decode(codec.SCORE_TRANSACTION_REQUEST, request)
        # Per-account scoring cap; the batch path is exempt.
        if not self._rate_limiter.allow(req["account_id"]):
            raise RpcAbort(StatusCode.RESOURCE_EXHAUSTED,
                           "RATE_LIMITED: per-account scoring rate limit exceeded")
        ddl = self._admit_deadline(context)
        # Arms the burn-shed loop: bulk sheds only while interactive traffic
        # exists to protect.
        self.burn_gate.note_interactive()
        resp = self.engine.score(self._request_from_proto(req), deadline=ddl)
        if ddl.source != "default" and ddl.expired():
            # An explicit deadline passed while this scored: the caller has
            # given up, so the answer is a shed, not a stale OK.
            self.metrics.deadline_expired_total.inc(stage="response")
            raise RpcAbort(
                StatusCode.DEADLINE_EXCEEDED,
                "DEADLINE_SHED: scored result ready after the request's budget "
                f"({ddl.budget_ms:.0f} ms) expired", trailing=_pushback_trailing(), shed=True)
        self.metrics.score_distribution.observe(resp.score)
        self.metrics.txns_scored_total.inc()
        trailing: list[tuple[str, str]] = []
        if resp.decision_id:
            # The ledger's join key, shared by the flight entry, the trace
            # root and the record, for callers that later post the
            # decision's outcome (POST /debug/outcomes).
            tracing.set_root_attribute("decision_id", resp.decision_id)
            trailing.append(("risk-decision-id", resp.decision_id))
        # The single-transaction latency is the SLO the bulk gate protects.
        self._bulk_gate.observe_single_ms(resp.response_time_ms)
        if ReasonCode.DEGRADED_CPU_HEURISTIC in resp.reason_codes:
            # A degraded answer is wire-compatible, and visible: the model
            # version's suffix goes out in the trailing metadata.
            trailing.append(("risk-model-version",
                             getattr(self.engine, "model_version", "degraded-heuristic")))
        if trailing and context is not None:
            context.set_trailing_metadata(tuple(trailing))
        return RawProtoMessage(self._score_to_bytes(resp))

    def ScoreBatch(self, request: bytes, context=None):  # noqa: N802
        ddl = self._admit_deadline(context)
        if ddl.source != "default" and ddl.remaining_ms() < 50.0:
            # Under 50 ms left cannot cover decode, score and encode.
            self.metrics.bulk_shed_total.inc()
            raise RpcAbort(StatusCode.RESOURCE_EXHAUSTED,
                           "BULK_SHED: deadline nearly exhausted before start",
                           trailing=_pushback_trailing(), shed=True)
        if self.burn_gate.shedding():
            self.burn_gate.note_shed()
            self.metrics.bulk_shed_total.inc()
            raise RpcAbort(
                StatusCode.RESOURCE_EXHAUSTED,
                "BULK_SHED: error budget burning (fast-window SLO alert active); bulk lane "
                "shedding until it clears", trailing=_pushback_trailing(), shed=True)
        with span("score.admission"):
            admitted = self._bulk_gate.acquire(timeout=self._bulk_admit_wait_s)
        if not admitted:
            self.metrics.bulk_shed_total.inc()
            raise RpcAbort(StatusCode.RESOURCE_EXHAUSTED,
                           "BULK_SHED: bulk admission limit reached; retry with backoff")
        try:
            payload, n = self._score_batch_admitted(bytes(request))
        finally:
            self._bulk_gate.release()
        self.metrics.txns_scored_total.inc(n)
        return RawProtoMessage(payload)

    def _score_batch_admitted(self, buf: bytes) -> tuple[bytes, int]:
        if buf[:4] == INDEX_WIRE_MAGIC:
            # An index-mode frame: slots and per-transaction context go to the
            # device feature table, never an [N, 30] matrix. The answer is
            # still a risk.v1 ScoreBatchResponse.
            try:
                payload, n = self.engine.score_batch_wire_index(buf)
            except ValueError as exc:
                raise RpcAbort(StatusCode.INVALID_ARGUMENT,
                               f"bad index-mode ScoreBatch frame: {exc}") from exc
            except RuntimeError as exc:
                raise RpcAbort(StatusCode.UNIMPLEMENTED,
                               f"index-mode ScoreBatch unavailable: {exc}") from exc
            tracing.set_root_attribute("rows", n)
            return payload, n
        if hasattr(self.engine.features, "decode_gather"):
            # One native call decodes and gathers, one encodes.
            try:
                payload, n = self.engine.score_batch_wire_bytes(buf)
            except ValueError as exc:
                raise RpcAbort(StatusCode.INVALID_ARGUMENT,
                               f"bad ScoreBatchRequest: {exc}") from exc
            tracing.set_root_attribute("rows", n)
            return payload, n
        try:
            with span("score.decode") as dsp:
                txs = codec.decode(codec.SCORE_BATCH_REQUEST, buf)["transactions"]
                # The rows are known once decoded: the host profiler's
                # decode µs/row needs them.
                dsp.attributes["batch"] = len(txs)
        except ValueError as exc:
            raise RpcAbort(StatusCode.INVALID_ARGUMENT, f"bad ScoreBatchRequest: {exc}") from exc
        tracing.set_root_attribute("rows", len(txs))
        payload = self.engine.score_batch_wire(
            [t["account_id"] for t in txs], [t["amount"] for t in txs],
            [t["transaction_type"] or "deposit" for t in txs],
            ips=[t["ip_address"] for t in txs], devices=[t["device_id"] for t in txs],
            fingerprints=[t["fingerprint"] for t in txs])
        return payload, len(txs)

    # -- LTV --

    def _background_dispatch_turn(self) -> None:
        """LTV device work rides the background lane of the dispatch gate:
        it yields to a launching interactive batch, bounded by the lane's
        aging budget."""
        gate = getattr(self.engine, "lane_gate", None)
        if gate is not None:
            gate.acquire(LANE_BACKGROUND)

    def _ltv(self, account_id: str) -> dict:
        """One account's LTV outputs (host numpy scalars): its features from
        ``ltv_source``, zeros when there is none, on the engine's device,
        after a background turn of the dispatch lane gate."""
        self._background_dispatch_turn()
        row = self.ltv_source(account_id) if self.ltv_source is not None else None
        x = (np.zeros((1, ltv_mod.NUM_LTV_FEATURES), np.float32) if row is None
             else np.asarray(row, np.float32).reshape(1, ltv_mod.NUM_LTV_FEATURES))
        out = ltv_mod.to_host(ltv_mod.predict_batch(x, self.engine.device))
        return {k: v[0] for k, v in out.items()}

    def PredictLTV(self, request: bytes, context=None):  # noqa: N802
        req = codec.decode(codec.PREDICT_LTV_REQUEST, request)
        out = self._ltv(req["account_id"])
        now_ns = time.time_ns()
        self.metrics.ltv_segment_total.inc(segment=str(int(out["segment"])))
        return RawProtoMessage(codec.encode(codec.PREDICT_LTV_RESPONSE, {
            "account_id": req["account_id"],
            "predicted_ltv": float(out["ltv"]),
            "segment": int(out["segment"]),
            "churn_risk": float(out["churn_risk"]),
            "predicted_active_days": int(out["survival_days"]),
            "confidence": float(out["confidence"]),
            "next_best_action": ltv_mod.ACTIONS[int(out["action"])],
            "predicted_at": {"seconds": now_ns // 10**9, "nanos": now_ns % 10**9},
        }))

    def GetPlayerSegment(self, request: bytes, context=None):  # noqa: N802
        req = codec.decode(codec.GET_PLAYER_SEGMENT_REQUEST, request)
        out = self._ltv(req["account_id"])
        return RawProtoMessage(codec.encode(codec.GET_PLAYER_SEGMENT_RESPONSE, {
            "account_id": req["account_id"],
            "segment": int(out["segment"]),
            "ltv": float(out["ltv"]),
            "churn_risk": float(out["churn_risk"]),
            "recommended_actions": [ltv_mod.ACTIONS[int(out["action"])]],
        }))

    # -- bonus abuse --

    def CheckBonusAbuse(self, request: bytes, context=None):  # noqa: N802
        req = codec.decode(codec.CHECK_BONUS_ABUSE_REQUEST, request)
        if self.abuse_detector is not None:
            try:
                score, signals, linked = self.abuse_detector(req["account_id"], req["bonus_id"])
            except AbuseShed as exc:
                # A loud shed with its own counter (errors_total is the
                # RPC wrapper's).
                self.metrics.abuse_shed_total.inc()
                raise RpcAbort(StatusCode.UNAVAILABLE, str(exc)) from exc
        else:
            # Scalar fallback: the bonus-only-player heuristic.
            row = np.zeros(NUM_FEATURES, dtype=np.float32)
            self.engine.features.fill_row(row, req["account_id"], 0, "bet")
            score = 0.8 if row[F.BONUS_ONLY_PLAYER] > 0 else 0.1
            signals = ["BONUS_ONLY_PLAYER"] if score > 0.5 else []
            linked = []
        return RawProtoMessage(codec.encode(codec.CHECK_BONUS_ABUSE_RESPONSE, {
            "is_abuser": score >= 0.5, "abuse_score": score, "signals": signals,
            "linked_accounts": linked}))

    # -- blacklist --

    def AddToBlacklist(self, request: bytes, context=None):  # noqa: N802
        req = codec.decode(codec.ADD_TO_BLACKLIST_REQUEST, request)
        try:
            self.engine.features.add_to_blacklist(req["type"], req["value"])
        except ValueError as exc:
            raise RpcAbort(StatusCode.INVALID_ARGUMENT, str(exc)) from exc
        return RawProtoMessage(codec.encode(codec.ADD_TO_BLACKLIST_RESPONSE, {
            "success": True, "id": f"{req['type']}:{req['value']}"}))

    def CheckBlacklist(self, request: bytes, context=None):  # noqa: N802
        req = codec.decode(codec.CHECK_BLACKLIST_REQUEST, request)
        hit = self.engine.features.check_blacklist(
            device_id=req["device_id"], fingerprint=req["fingerprint"], ip=req["ip_address"])
        return RawProtoMessage(codec.encode(codec.CHECK_BLACKLIST_RESPONSE,
                                            {"is_blacklisted": hit}))

    # -- features / thresholds --

    def GetFeatures(self, request: bytes, context=None):  # noqa: N802
        req = codec.decode(codec.GET_FEATURES_REQUEST, request)
        row = np.zeros(NUM_FEATURES, dtype=np.float32)
        self.engine.features.fill_row(row, req["account_id"], 0, "deposit")
        now_ns = time.time_ns()
        return RawProtoMessage(codec.encode(codec.GET_FEATURES_RESPONSE, {
            "account_id": req["account_id"],
            "features": _feature_fields(FeatureVector.from_array(row)),
            "computed_at": {"seconds": now_ns // 10**9, "nanos": now_ns % 10**9},
        }))

    def UpdateThresholds(self, request: bytes, context=None):  # noqa: N802
        req = codec.decode(codec.UPDATE_THRESHOLDS_REQUEST, request)
        self.engine.set_thresholds(req["block_threshold"], req["review_threshold"])
        return RawProtoMessage(codec.encode(codec.UPDATE_THRESHOLDS_RESPONSE, {
            "success": True, "block_threshold": req["block_threshold"],
            "review_threshold": req["review_threshold"]}))

    def GetThresholds(self, request: bytes, context=None):  # noqa: N802
        block, review = self.engine.get_thresholds()
        return RawProtoMessage(codec.encode(codec.GET_THRESHOLDS_RESPONSE, {
            "block_threshold": block, "review_threshold": review}))


# ---------------------------------------------------------------------------
# The wallet service
# ---------------------------------------------------------------------------


class WalletGrpcService:
    """wallet.v1.WalletService over ``platform/wallet.WalletService``, on
    request and response bytes (``serve/wallet_codec.py``), as the JAX
    ``WalletGrpcService`` answers it."""

    def __init__(self, wallet, metrics: ServiceMetrics | None = None):
        self.wallet = wallet
        self.metrics = metrics or ServiceMetrics("wallet")

    def call(self, method: str, payload: bytes, metadata=()) -> bytes:
        """Answer one RPC on bytes, with no transport: the response bytes,
        or RpcAbort."""
        return self._invoke(method, payload, CallContext(metadata))

    def _invoke(self, method: str, payload: bytes, context) -> bytes:
        if method not in wallet_codec.METHODS:
            raise RpcAbort(StatusCode.UNIMPLEMENTED, f"unknown method {method}")
        return _invoke_rpc(self.metrics, method, getattr(self, method), payload, context)

    @staticmethod
    def _request(method: str, payload: bytes) -> dict:
        try:
            return wallet_codec.decode(wallet_codec.METHODS[method][0], payload)
        except ValueError as exc:
            raise RpcAbort(StatusCode.INTERNAL, f"internal error: {exc}") from exc

    @staticmethod
    def _respond(method: str, msg: dict) -> bytes:
        return wallet_codec.encode(wallet_codec.METHODS[method][1], msg)

    def _record_txn(self, res) -> None:
        """Per-type flow counters (count and cents volume)."""
        tx = res.transaction
        self.metrics.transactions_total.inc(type=tx.type.value)
        self.metrics.transaction_amount_cents.inc(tx.amount, type=tx.type.value)

    @staticmethod
    def _tx(tx) -> dict:
        msg = {"id": tx.id, "account_id": tx.account_id, "idempotency_key": tx.idempotency_key,
               "type": tx.type.value, "amount": tx.amount, "balance_before": tx.balance_before,
               "balance_after": tx.balance_after, "status": tx.status.value,
               "reference": tx.reference, "game_id": tx.game_id or "",
               "round_id": tx.round_id or "", "risk_score": tx.risk_score or 0,
               "created_at": wallet_codec.timestamp(tx.created_at)}
        if tx.completed_at:
            msg["completed_at"] = wallet_codec.timestamp(tx.completed_at)
        return msg

    @staticmethod
    def _account(a) -> dict:
        return {"id": a.id, "player_id": a.player_id, "currency": a.currency,
                "balance": a.balance, "bonus": a.bonus, "status": a.status.value,
                "created_at": wallet_codec.timestamp(a.created_at),
                "updated_at": wallet_codec.timestamp(a.updated_at)}

    @staticmethod
    def _domain_error(exc) -> RpcAbort:
        """The JAX service's domain error -> status map; the details are
        ``"<code>: <message>"``."""
        from igaming_platform_tpu_torch.platform import domain as d

        code = {
            d.AccountNotFoundError: StatusCode.NOT_FOUND,
            d.AccountSuspendedError: StatusCode.FAILED_PRECONDITION,
            d.InsufficientBalanceError: StatusCode.FAILED_PRECONDITION,
            d.DuplicateTransactionError: StatusCode.ALREADY_EXISTS,
            d.InvalidAmountError: StatusCode.INVALID_ARGUMENT,
            d.ConcurrentUpdateError: StatusCode.ABORTED,
            d.RiskBlockedError: StatusCode.PERMISSION_DENIED,
            d.RiskReviewError: StatusCode.PERMISSION_DENIED,
            d.RiskUnavailableError: StatusCode.UNAVAILABLE,
            d.BonusRestrictionError: StatusCode.FAILED_PRECONDITION,
        }.get(type(exc), StatusCode.INTERNAL)
        return RpcAbort(code, f"{getattr(exc, 'code', 'WALLET_ERROR')}: {exc}")

    def _money(self, method: str, run, respond) -> bytes:
        """A money movement: ``run()`` under the domain error map, the flow
        counters, then ``respond(result)``'s fields."""
        from igaming_platform_tpu_torch.platform.domain import WalletError

        try:
            res = run()
        except WalletError as exc:
            raise self._domain_error(exc) from exc
        self._record_txn(res)
        return self._respond(method, {"transaction": self._tx(res.transaction),
                                      "new_balance": res.new_balance, **respond(res)})

    def CreateAccount(self, request: bytes, context=None) -> bytes:  # noqa: N802
        req = self._request("CreateAccount", request)
        acct = self.wallet.create_account(req["player_id"], req["currency"] or "USD")
        return self._respond("CreateAccount", {"account": self._account(acct)})

    def GetAccount(self, request: bytes, context=None) -> bytes:  # noqa: N802
        from igaming_platform_tpu_torch.platform.domain import AccountNotFoundError

        try:
            which, value = wallet_codec.decode_get_account(request)
        except ValueError as exc:
            raise RpcAbort(StatusCode.INTERNAL, f"internal error: {exc}") from exc
        try:
            if which == "player_id":
                acct = self.wallet.accounts.get_by_player_id(value)
                if acct is None:
                    raise AccountNotFoundError(value)
            else:
                acct = self.wallet.accounts.get_by_id(value if which else "")
        except AccountNotFoundError as exc:
            raise self._domain_error(exc) from exc
        return self._respond("GetAccount", {"account": self._account(acct)})

    def GetBalance(self, request: bytes, context=None) -> bytes:  # noqa: N802
        from igaming_platform_tpu_torch.platform.domain import AccountNotFoundError

        req = self._request("GetBalance", request)
        try:
            acct = self.wallet.get_balance(req["account_id"])
        except AccountNotFoundError as exc:
            raise self._domain_error(exc) from exc
        return self._respond("GetBalance", {
            "account_id": acct.id, "balance": acct.balance, "bonus": acct.bonus,
            "total": acct.total_balance, "withdrawable": acct.available_for_withdraw,
            "currency": acct.currency})

    def Deposit(self, request: bytes, context=None) -> bytes:  # noqa: N802
        r = self._request("Deposit", request)
        return self._money("Deposit", lambda: self.wallet.deposit(
            r["account_id"], r["amount"], r["idempotency_key"],
            payment_method=r["payment_method"], reference=r["reference"],
            ip=r["ip_address"], device_id=r["device_id"], fingerprint=r["fingerprint"]),
            lambda res: {"risk_score": res.risk_score or 0})

    def Withdraw(self, request: bytes, context=None) -> bytes:  # noqa: N802
        r = self._request("Withdraw", request)
        return self._money("Withdraw", lambda: self.wallet.withdraw(
            r["account_id"], r["amount"], r["idempotency_key"],
            payout_method=r["payout_method"], ip=r["ip_address"], device_id=r["device_id"]),
            lambda res: {"risk_score": res.risk_score or 0, "payout_status": "completed"})

    def Bet(self, request: bytes, context=None) -> bytes:  # noqa: N802
        r = self._request("Bet", request)
        return self._money("Bet", lambda: self.wallet.bet(
            r["account_id"], r["amount"], r["idempotency_key"], game_id=r["game_id"],
            round_id=r["round_id"], game_category=r["game_category"], ip=r["ip_address"],
            device_id=r["device_id"]),
            lambda res: {"risk_score": res.risk_score or 0, "real_deducted": res.real_deducted,
                         "bonus_deducted": res.bonus_deducted})

    def Win(self, request: bytes, context=None) -> bytes:  # noqa: N802
        r = self._request("Win", request)
        return self._money("Win", lambda: self.wallet.win(
            r["account_id"], r["amount"], r["idempotency_key"], game_id=r["game_id"],
            round_id=r["round_id"], bet_tx_id=r["bet_transaction_id"],
            win_type=r["win_type"] or "normal"), lambda res: {})

    def Refund(self, request: bytes, context=None) -> bytes:  # noqa: N802
        r = self._request("Refund", request)
        return self._money("Refund", lambda: self.wallet.refund(
            r["account_id"], r["original_transaction_id"], r["idempotency_key"],
            reason=r["reason"]), lambda res: {})

    def GetTransaction(self, request: bytes, context=None) -> bytes:  # noqa: N802
        req = self._request("GetTransaction", request)
        tx = self.wallet.transactions.get_by_id(req["transaction_id"])
        if tx is None:
            raise RpcAbort(StatusCode.NOT_FOUND, "transaction not found")
        return self._respond("GetTransaction", {"transaction": self._tx(tx)})

    def GetTransactionHistory(self, request: bytes, context=None) -> bytes:  # noqa: N802
        req = self._request("GetTransactionHistory", request)
        # Clamp both ends: a negative limit would reach SQLite as LIMIT -1
        # (unlimited). Filters apply before pagination; ``total`` is the
        # filtered count.
        limit = max(1, min(req["limit"] or 50, 100))
        offset = max(0, req["offset"])
        filters = dict(
            types=list(req["types"]) or None,
            from_ts=(wallet_codec.timestamp_seconds(req["from"])
                     if req["from"] is not None else None),
            to_ts=wallet_codec.timestamp_seconds(req["to"]) if req["to"] is not None else None,
            game_id=req["game_id"] or None,
        )
        txs = self.wallet.get_transaction_history(req["account_id"], limit, offset, **filters)
        total = self.wallet.count_transactions(req["account_id"], **filters)
        return self._respond("GetTransactionHistory", {
            "transactions": [self._tx(t) for t in txs], "total": total,
            "has_more": offset + len(txs) < total})


# ---------------------------------------------------------------------------
# The gRPC binding (grpcio, where it is installed)
# ---------------------------------------------------------------------------


def _rpc(grpc, fn):
    """A grpcio handler over a bytes handler ``fn(request, context)``: the
    handler sets trailing metadata on grpcio's context, and RpcAbort becomes
    its status."""

    def handler(request, context):
        try:
            return fn(request, context)
        except RpcAbort as abort:
            if abort.trailing:
                context.set_trailing_metadata(abort.trailing)
            context.abort(getattr(grpc.StatusCode, abort.code.name), abort.details)

    return handler


def serve_risk(service: RiskGrpcService, port: int, max_workers: int = 32):
    """Build and start the risk.v1 gRPC server (and grpc.health.v1) on
    ``port`` (0 picks a free one); returns (server, health, bound port).
    Raises RuntimeError when grpcio is not installed."""
    try:
        import grpc
    except ImportError as exc:
        raise RuntimeError(
            "serve_risk needs grpcio, which is not installed; without it, drive "
            "RiskGrpcService.call(method, request_bytes) directly") from exc
    from concurrent import futures

    health = HealthServicer()
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))

    def handlers(fn_of):
        # No (de)serializers: each handler takes and returns wire bytes.
        return {name: grpc.unary_unary_rpc_method_handler(_rpc(grpc, fn))
                for name, fn in fn_of.items()}

    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(RISK_SERVICE, handlers(
            {name: (lambda payload, context, name=name: service._invoke(name, payload, context))
             for name in RISK_METHOD_NAMES})),
        grpc.method_handlers_generic_handler("grpc.health.v1.Health",
                                             handlers({"Check": health.check})),
        reflection.grpc_handler(grpc, (RISK_SERVICE, "grpc.health.v1.Health")),
    ))
    bound = server.add_insecure_port(f"[::]:{port}")
    server.start()
    return server, health, bound


def make_risk_stub(channel):
    """A client of every risk.v1 method on ``channel`` (a grpcio channel):
    ``stub.<Method>(request_bytes, timeout=...)`` returns the response
    bytes."""

    class _Stub:
        pass

    stub = _Stub()
    for name in RISK_METHOD_NAMES:
        setattr(stub, name, channel.unary_unary(f"/{RISK_SERVICE}/{name}"))
    return stub


def serve_wallet(service: WalletGrpcService, port: int, max_workers: int = 32):
    """Build and start the wallet.v1 gRPC server (and grpc.health.v1) on
    ``port`` (0 picks a free one); returns (server, health, bound port).
    Raises RuntimeError when grpcio is not installed."""
    try:
        import grpc
    except ImportError as exc:
        raise RuntimeError(
            "serve_wallet needs grpcio, which is not installed; without it, drive "
            "WalletGrpcService.call(method, request_bytes) directly") from exc
    from concurrent import futures

    health = HealthServicer()
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))

    def handler(name):
        return grpc.unary_unary_rpc_method_handler(_rpc(
            grpc, lambda payload, context: service._invoke(name, payload, context)))

    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(
            wallet_codec.WALLET_SERVICE, {name: handler(name) for name in wallet_codec.METHODS}),
        grpc.method_handlers_generic_handler("grpc.health.v1.Health", {
            "Check": grpc.unary_unary_rpc_method_handler(_rpc(grpc, health.check))}),
        # grpcurl without protos, as the JAX wallet server registers it.
        reflection.grpc_handler(grpc, (wallet_codec.WALLET_SERVICE, "grpc.health.v1.Health")),
    ))
    bound = server.add_insecure_port(f"[::]:{port}")
    server.start()
    return server, health, bound


def make_wallet_stub(channel):
    """A client of every wallet.v1 method on ``channel`` (a grpcio channel):
    ``stub.<Method>(request_bytes, timeout=...)`` returns the response
    bytes."""

    class _Stub:
        pass

    stub = _Stub()
    for name in wallet_codec.METHODS:
        setattr(stub, name, channel.unary_unary(f"/{wallet_codec.WALLET_SERVICE}/{name}"))
    return stub


def graceful_stop(server, health: HealthServicer, grace: float = 30.0, engine=None) -> None:
    """NOT_SERVING before the drain, then the gRPC server with ``grace``
    (admitted handlers finish against the live engine), then the engine."""
    health.set_all_not_serving()
    if server is not None:
        server.stop(grace).wait()
    if engine is not None:
        engine.close()
