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
service needs no transport: ``call(method, payload)`` drives it directly, as
``chip_smoke.py`` does on a machine without grpcio, and
``call_with_trailing`` also returns the trailing metadata a handler set: a
ScoreTransaction whose decision a ledger noted carries
``("risk-decision-id", id)``, the key a label backfill joins on.

PredictLTV and GetPlayerSegment score one account's 25 LTV features, from
the ``ltv_source`` callable (zeros when it has none), through
``models/ltv.py`` on the engine's device, as the JAX handlers do; the JAX
service's background lane turn and its ``ltv_segment_total`` counter wait
for the port's lane gate and metrics (``ROADMAP.md``).

``serve_risk`` binds it to grpcio with identity (de)serializers, and
``make_risk_stub`` gives a bytes-in, bytes-out client; ``serve_risk`` is the
one place the port imports ``grpc``, inside its body.

As in the JAX package, the service installs the process's drift engine
(``obs/drift.py``) and binds it to the engine unless ``DRIFT=0``: every
batch the engine scores is then sketched. ``close()`` unbinds, closes and
uninstalls it. Not ported yet: deadline admission, the burn-shed gate, the
supervisor, the flight recorder, metrics and tracing, reflection and the
wallet service (``ROADMAP.md``).
"""

from __future__ import annotations

import enum
import logging
import os
import threading
import time

import numpy as np

from igaming_platform_tpu_torch.core.enums import REASON_BIT_ORDER
from igaming_platform_tpu_torch.core.features import NUM_FEATURES, F, FeatureVector
from igaming_platform_tpu_torch.models import ltv as ltv_mod
from igaming_platform_tpu_torch.obs import drift as drift_mod
from igaming_platform_tpu_torch.serve import risk_codec as codec
from igaming_platform_tpu_torch.serve.abuse import AbuseShed
from igaming_platform_tpu_torch.serve.scorer import ScoreRequest
from igaming_platform_tpu_torch.serve.wire import INDEX_WIRE_MAGIC, RawProtoMessage

logger = logging.getLogger(__name__)

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


class _TrailingCollector:
    """The part of a grpcio servicer context a handler uses here: it
    collects the trailing metadata for ``call_with_trailing``."""

    def __init__(self):
        self.trailing: tuple[tuple[str, str], ...] = ()

    def set_trailing_metadata(self, pairs) -> None:
        self.trailing = tuple(pairs)


class RpcAbort(Exception):
    """Typed abort raised inside handlers; the binding maps it to a status."""

    def __init__(self, code: StatusCode, details: str):
        super().__init__(details)
        self.code = code
        self.details = details


SERVING, NOT_SERVING = 1, 2  # grpc.health.v1 HealthCheckResponse.ServingStatus


class HealthServicer:
    """The grpc.health.v1 Check method, on bytes."""

    def __init__(self):
        self._status: dict[str, int] = {"": SERVING}
        self._lock = threading.Lock()

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
                    self.limit -= 1
            elif p99 <= 0.5 * self.p99_slo_ms:
                self._good_windows += 1
                if self._good_windows >= self._relax_after and self.limit < self.max_limit:
                    self.limit += 1
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


class RiskGrpcService:
    """risk.v1.RiskService over the port's scoring engine and abuse detector."""

    def __init__(self, engine, abuse_detector=None, rate_limit_per_minute: int = 0,
                 ltv_source=None):
        """
        engine: serve.scorer.TorchScoringEngine
        abuse_detector: callable(account_id, bonus_id) -> (score, signals, linked)
        rate_limit_per_minute: per-account ScoreTransaction cap (0 disables)
        ltv_source: callable(account_id) -> 25 LTV features or None
        """
        self.engine = engine
        self.abuse_detector = abuse_detector
        self.ltv_source = ltv_source
        self._rate_limiter = _FixedWindowRateLimiter(rate_limit_per_minute)
        # Bulk ScoreBatch work is admitted through a bounded gate: past
        # BULK_MAX_INFLIGHT concurrent RPCs (after a short wait) it sheds
        # with RESOURCE_EXHAUSTED, so single transactions keep their p99.
        self._bulk_gate = _AdaptiveBulkGate(
            max(1, int(os.environ.get("BULK_MAX_INFLIGHT", "2"))),
            p99_slo_ms=float(os.environ.get("BULK_P99_SLO_MS", "50")),
        )
        self._bulk_admit_wait_s = float(os.environ.get("BULK_ADMIT_WAIT_S", "0.02"))
        # The drift observatory (DRIFT=0 opts out): the process's default
        # engine, bound to the scoring engine, as the JAX service does.
        self.drift = None
        if os.environ.get("DRIFT", "1") != "0" and hasattr(engine, "bind_drift"):
            self.drift = drift_mod.install(drift_mod.DriftEngine())
            engine.bind_drift(self.drift)
        else:
            drift_mod.uninstall()

    def close(self) -> None:
        """Unbind the drift engine from the scoring engine, close it (its
        queued sketches are folded first) and uninstall it if it is still
        the process default. Idempotent."""
        drift, self.drift = self.drift, None
        if drift is None:
            return
        if getattr(self.engine, "drift", None) is drift:
            self.engine.bind_drift(None)
        if drift_mod.get_default() is drift:
            drift_mod.uninstall()
        else:
            drift.close()

    def call(self, method: str, payload: bytes) -> bytes:
        """Answer one RPC on bytes, with no transport: the response bytes,
        or RpcAbort. A handler that fails otherwise is INTERNAL, as the
        recovery interceptor of the reference maps it."""
        return self._invoke(method, payload, None)

    def call_with_trailing(self, method: str,
                           payload: bytes) -> tuple[bytes, tuple[tuple[str, str], ...]]:
        """``call``, and the trailing metadata pairs the handler set."""
        context = _TrailingCollector()
        return self._invoke(method, payload, context), context.trailing

    def _invoke(self, method: str, payload: bytes, context) -> bytes:
        """One RPC on bytes; ``context`` (a grpcio servicer context, a
        ``_TrailingCollector`` or None) receives the trailing metadata."""
        if method not in RISK_METHOD_NAMES:
            raise RpcAbort(StatusCode.UNIMPLEMENTED, f"unknown method {method}")
        try:
            return getattr(self, method)(payload, context).SerializeToString()
        except RpcAbort:
            raise
        except Exception as exc:  # noqa: BLE001 — recovery interceptor
            logger.exception("handler panic in %s", method)
            raise RpcAbort(StatusCode.INTERNAL, f"internal error: {exc}") from exc

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
        mask = sum(1 << REASON_BIT_ORDER.index(code) for code in resp.reason_codes)
        return codec.encode_score_response(
            resp.score, _ACTION_CODES[resp.action], mask, resp.rule_score, resp.ml_score,
            int(resp.response_time_ms), resp.features.to_array())

    def ScoreTransaction(self, request: bytes, context=None):  # noqa: N802
        req = codec.decode(codec.SCORE_TRANSACTION_REQUEST, request)
        # Per-account scoring cap; the batch path is exempt.
        if not self._rate_limiter.allow(req["account_id"]):
            raise RpcAbort(StatusCode.RESOURCE_EXHAUSTED,
                           "RATE_LIMITED: per-account scoring rate limit exceeded")
        resp = self.engine.score(self._request_from_proto(req))
        # The single-transaction latency is the SLO the bulk gate protects.
        self._bulk_gate.observe_single_ms(resp.response_time_ms)
        if resp.decision_id and context is not None:
            # The ledger's join key, for callers that later post the
            # decision's outcome (POST /debug/outcomes), without a change to
            # the response message.
            context.set_trailing_metadata((("risk-decision-id", resp.decision_id),))
        return RawProtoMessage(self._score_to_bytes(resp))

    def ScoreBatch(self, request: bytes, context=None):  # noqa: N802
        if not self._bulk_gate.acquire(timeout=self._bulk_admit_wait_s):
            raise RpcAbort(StatusCode.RESOURCE_EXHAUSTED,
                           "BULK_SHED: bulk admission limit reached; retry with backoff")
        try:
            return RawProtoMessage(self._score_batch_admitted(bytes(request)))
        finally:
            self._bulk_gate.release()

    def _score_batch_admitted(self, buf: bytes) -> bytes:
        if buf[:4] == INDEX_WIRE_MAGIC:
            # An index-mode frame: slots and per-transaction context go to the
            # device feature table, never an [N, 30] matrix. The answer is
            # still a risk.v1 ScoreBatchResponse.
            try:
                return self.engine.score_batch_wire_index(buf)[0]
            except ValueError as exc:
                raise RpcAbort(StatusCode.INVALID_ARGUMENT,
                               f"bad index-mode ScoreBatch frame: {exc}") from exc
            except RuntimeError as exc:
                raise RpcAbort(StatusCode.UNIMPLEMENTED,
                               f"index-mode ScoreBatch unavailable: {exc}") from exc
        if hasattr(self.engine.features, "decode_gather"):
            # One native call decodes and gathers, one encodes.
            try:
                return self.engine.score_batch_wire_bytes(buf)[0]
            except ValueError as exc:
                raise RpcAbort(StatusCode.INVALID_ARGUMENT,
                               f"bad ScoreBatchRequest: {exc}") from exc
        try:
            txs = codec.decode(codec.SCORE_BATCH_REQUEST, buf)["transactions"]
        except ValueError as exc:
            raise RpcAbort(StatusCode.INVALID_ARGUMENT, f"bad ScoreBatchRequest: {exc}") from exc
        return self.engine.score_batch_wire(
            [t["account_id"] for t in txs], [t["amount"] for t in txs],
            [t["transaction_type"] or "deposit" for t in txs],
            ips=[t["ip_address"] for t in txs], devices=[t["device_id"] for t in txs],
            fingerprints=[t["fingerprint"] for t in txs])

    # -- LTV --

    def _ltv(self, account_id: str) -> dict:
        """One account's LTV outputs (host numpy scalars): its features from
        ``ltv_source``, zeros when there is none, on the engine's device."""
        row = self.ltv_source(account_id) if self.ltv_source is not None else None
        x = (np.zeros((1, ltv_mod.NUM_LTV_FEATURES), np.float32) if row is None
             else np.asarray(row, np.float32).reshape(1, ltv_mod.NUM_LTV_FEATURES))
        out = ltv_mod.to_host(ltv_mod.predict_batch(x, self.engine.device))
        return {k: v[0] for k, v in out.items()}

    def PredictLTV(self, request: bytes, context=None):  # noqa: N802
        req = codec.decode(codec.PREDICT_LTV_REQUEST, request)
        out = self._ltv(req["account_id"])
        now_ns = time.time_ns()
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


def graceful_stop(server, health: HealthServicer, grace: float = 30.0, engine=None) -> None:
    """NOT_SERVING before the drain, then the gRPC server with ``grace``
    (admitted handlers finish against the live engine), then the engine."""
    health.set_all_not_serving()
    if server is not None:
        server.stop(grace).wait()
    if engine is not None:
        engine.close()
