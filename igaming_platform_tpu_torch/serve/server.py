"""The risk service process: assembly, gRPC binding, HTTP sidecar, main().

The port's counterpart of ``igaming_platform_tpu/serve/server.py``:
environment config, then the feature store, the scoring engine (warmed up
before it serves), the bonus-abuse detector, the event bridge and the
``RiskGrpcService`` (``assemble_risk_service``); then ``RiskServer`` binds
gRPC, when grpcio is installed and a port is asked for, and the HTTP
sidecar (/health, /ready, /debug/thresholds, /debug/score, /debug/cachez,
/debug/sessionz, /debug/driftz, /debug/ledgerz, /debug/outcomes,
/debug/shadowz and /debug/promotion), and shuts down on a signal: health
NOT_SERVING, drain, stop. The drift observatory is on unless
``DRIFT=0`` (``RiskGrpcService`` installs it; ``DRIFT_REF`` names a pinned
reference to load at boot); ``POST /debug/driftz`` pins the current window
as the reference, or loads or saves one. A shadow scorer is attached to the
engine by the online loop, or by its caller (``engine.shadow``). The engine
reads its cache and session knobs (``WIRE_MODE``, ``FEATURE_CACHE``,
``FEATURE_CACHE_CAPACITY``, ``FEATURE_CACHE_MAX_AGE_S``, ``SESSION_STATE``,
``SESSION_EVENTS``, ``SESSION_MIN_EVENTS``, ``SESSION_FLAG_THRESHOLD``,
``SESSION_HEAD``) from the environment;
``assemble_risk_service`` also takes ``feature_cache`` and
``session_state``.

``LEDGER_DIR`` opens the decision ledger (``serve/ledger.py``): every
decision the engine hands out is appended to a WAL there, in the JAX
server's format, with the sink ``LEDGER_SINK`` names (``clickhouse`` or
none); ``GET /debug/ledgerz`` shows its counters, ``POST /debug/outcomes``
appends label backfills (outcome records) joined by decision id, and the
ledger is closed after the engine drains on shutdown. Its WAL replays with
``python -m igaming_platform_tpu_torch.tools.replay``, on the device that
scored it.

``ONLINE_LOOP=1`` closes the learning loop in place (``train/online.py``):
a miner tails the WAL for outcome-labelled hard examples, a learner trains
a multitask candidate on the engine's device (on its own stream), a
``ShadowScorer`` scores it beside production (its results joined to the
drift engine's shadow window) and the ``PromotionController`` hot-swaps it
in, or back out, through the gates of ``train/gates.py`` (``PROMOTE_*``),
vaulting every tree it serves under ``<LEDGER_DIR>/params-vault``. It needs
``LEDGER_DIR`` and the ``multitask`` backend (``FRAUD_MODEL_PATH`` or
``ML_BACKEND``); either missing fails the boot. ``GET /debug/shadowz``
returns the loop's report; ``POST /debug/promotion`` takes ``{"action":
"pause"|"resume"|"rollback"|"inject_regression"|"tick"}``. On shutdown the
loop stops before the drain.

The operations plane is on by default, as in the JAX server:

- ``SUPERVISOR`` (on unless ``0``) wraps the engine in a
  ``SupervisedScoringEngine`` (``serve/supervisor.py``): breakers, the
  ``DEVICE_STEP_DEADLINE_S`` watchdog, a rebuild through the engine's
  factory (its warm-up launches every kernel of the path again) and the CPU
  heuristic tier while the device circuit is open; BROWNOUT turns health
  NOT_SERVING. ``GET /debug/supervisorz`` shows the breakers and ``POST
  /debug/breakers`` takes ``{"dep", "action": "open"|"clear"|"probe"}`` or
  ``{"brownout": "force"|"clear"}``;
- ``GET /metrics`` is the Prometheus text of the service's
  ``ServiceMetrics`` (``obs/metrics.py``, the JAX server's families);
- ``GET /debug/sloz`` (the SLO engine, ``SLO=0`` off), ``/debug/deadlinez``
  (lane depths, sheds, hedges and the step-time model), ``/debug/spans``
  (the span ring) and ``/debug/flightz`` (the last requests with their
  stage breakdown);
- ``GET /debug/profilez?seconds=S`` records a ``torch.profiler`` trace of
  host and CUDA activity for S seconds (clamped to 0.1-30; 409 while one
  runs) into a directory keyed by ``trace_id=`` when given, and answers how
  many kernel events it caught;
- ``OTEL_EXPORTER_OTLP_ENDPOINT`` exports the span ring over OTLP/HTTP;
- ``CHAOS_PLAN`` installs a fault plan before the engine is built (logged).

Run it as ``python -m igaming_platform_tpu_torch.serve.server``. It serves
on the card; with no card it refuses to boot unless
``SERVE_DEVICE_FALLBACK=cpu``, which serves on the host CPU with the abuse
path under ``ABUSE_CPU_POLICY`` (default ``heuristic``), as the reference
does. ``FRAUD_MODEL_PATH`` boots a trained multitask checkpoint from its
``.npz`` (``resolve_model_boot``). Not ported yet (``ROADMAP.md``): the host
profiler's, runtime telemetry's and reflection's pages, and the
batch-feature refresh.
"""

from __future__ import annotations

import json
import logging
import os
import re
import signal
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

from igaming_platform_tpu_torch.convert import from_jax_params, load_params_tree
from igaming_platform_tpu_torch.core.config import RiskServiceConfig
from igaming_platform_tpu_torch.core.features import NUM_FEATURES
from igaming_platform_tpu_torch.obs import drift as drift_mod
from igaming_platform_tpu_torch.obs import flight as flight_mod
from igaming_platform_tpu_torch.obs import slo as slo_mod
from igaming_platform_tpu_torch.obs import tracing
from igaming_platform_tpu_torch.obs.metrics import ServiceMetrics
from igaming_platform_tpu_torch.obs.otlp import exporter_from_env
from igaming_platform_tpu_torch.serve.abuse import SequenceAbuseDetector
from igaming_platform_tpu_torch.serve.bridge import ScoringBridge
from igaming_platform_tpu_torch.serve.events import InMemoryBroker, resolve_transport
from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore
from igaming_platform_tpu_torch.serve import chaos
from igaming_platform_tpu_torch.serve import ledger as ledger_mod
from igaming_platform_tpu_torch.serve.grpc_server import (
    HealthServicer,
    RiskGrpcService,
    graceful_stop,
    serve_risk,
)
from igaming_platform_tpu_torch.serve.native_store import NativeFeatureStore
from igaming_platform_tpu_torch.serve.scorer import ScoreRequest, TorchScoringEngine
from igaming_platform_tpu_torch.serve.supervisor import ServingSupervisor, SupervisedScoringEngine

logger = logging.getLogger(__name__)


def resolve_model_boot(config, ml_backend: str = "mock", params=None):
    """FRAUD_MODEL_PATH -> (ml_backend, params), then the ML_BACKEND
    override, with the JAX server's semantics: a checkpoint that loads boots
    the ``multitask`` backend; a path that does not exist, or one that does
    not load, degrades to the mock scorer with a warning (the reference's
    risk/cmd/main.go:62-63). The card reads a JAX checkpoint as an ``.npz``
    of its multitask tree (``convert.load_params_tree``'s layout, which
    ``python -m tools.export_params_npz`` writes from an Orbax checkpoint or
    a flax ``.msgpack``): an Orbax directory, a corrupt file or a tree that
    is not multitask does not load."""
    if params is None and config.fraud_model_path:
        path = config.fraud_model_path
        if not os.path.exists(path):
            logger.warning("model path %s not found; using mock scorer", path)
        elif os.path.isdir(path):
            logger.warning(
                "model path %s is a directory, not an .npz: convert an Orbax checkpoint with "
                "tools/export_params_npz.py (`python -m tools.export_params_npz %s OUT.npz`); "
                "using mock scorer", path, path)
        else:
            try:
                params = load_multitask(path)
                ml_backend = "multitask"
                logger.info("loaded fraud model from %s", path)
            except Exception:  # noqa: BLE001 — any failed load degrades, as in the JAX server
                logger.warning("failed to load model at %s; using mock scorer", path,
                               exc_info=True)
    if config.ml_backend:
        ml_backend = config.ml_backend
    return ml_backend, params


def load_multitask(path: str) -> dict:
    """The port's ``multitask`` params from an ``.npz`` holding a multitask
    tree under ``multitask``. Raises on anything else."""
    tree = load_params_tree(path)["multitask"]
    first = tree["trunk"]["layers"][0]["w"]
    if first.ndim != 2 or first.shape[0] != NUM_FEATURES:
        raise ValueError(f"{path}: the trunk's first layer takes {first.shape[0]} features, "
                         f"not {NUM_FEATURES}")
    return from_jax_params("multitask", {"multitask": tree})


def make_feature_store(kind: str):
    """The store FEATURE_STORE names: the native C++ one for "auto" and
    "native" (a library that does not build raises), the Python one for
    "python"."""
    if kind in ("auto", "native"):
        return NativeFeatureStore()
    if kind == "python":
        return InMemoryFeatureStore()
    raise NotImplementedError(f"FEATURE_STORE={kind!r} is not ported (use auto, native or python)")


@dataclass
class AssembledService:
    """An assembled risk service, before any transport is bound."""

    config: RiskServiceConfig
    engine: TorchScoringEngine | SupervisedScoringEngine
    abuse: SequenceAbuseDetector
    bridge: ScoringBridge
    service: RiskGrpcService
    ledger: ledger_mod.DecisionLedger | None = None
    online: object | None = None  # train.online.OnlineLoop, not started
    supervisor: ServingSupervisor | None = None
    metrics: ServiceMetrics | None = None

    @property
    def inner(self) -> TorchScoringEngine:
        """The scoring engine itself (inside the supervisor, when on)."""
        return getattr(self.engine, "inner", self.engine)


def assemble_risk_service(config: RiskServiceConfig | None = None, *, ml_backend: str = "mock",
                          params=None, feature_store=None, abuse_params=None,
                          broker: InMemoryBroker | None = None, device: str = "cuda",
                          abuse_policy: str = "model", warmup: bool = True,
                          feature_cache: bool | int | None = None,
                          session_state: bool | None = None) -> AssembledService:
    """Build the store (``config.feature_store``, unless one is given), the
    engine, the abuse detector (``abuse_policy``), the bridge and the
    RiskGrpcService, on ``device``. ``feature_cache`` and ``session_state``
    go to the engine (None: its environment knobs). ``CHAOS_PLAN`` is
    installed first, so the warm-up runs under it too; unless
    ``SUPERVISOR=0`` the engine is wrapped in a ``SupervisedScoringEngine``
    whose factory builds it again on a rebuild. With ``LEDGER_DIR`` set,
    opens the decision ledger there and binds it to the engine; whoever
    does not hand the assembly to a ``RiskServer`` closes it. With
    ``ONLINE_LOOP=1`` also builds the online loop, which the ``RiskServer``
    starts. Binds no transport."""
    config = config or RiskServiceConfig.from_env()
    plan = chaos.install_from_env()
    if plan is not None:
        logger.warning("CHAOS PLAN ACTIVE (seed=%d): %s", plan.seed, sorted(plan.specs))
    ml_backend, params = resolve_model_boot(config, ml_backend, params)
    ledger_dir = os.environ.get("LEDGER_DIR", "")
    online = os.environ.get("ONLINE_LOOP", "") == "1"
    if online:
        check_online_boot(ml_backend, ledger_dir)
    store = feature_store if feature_store is not None else make_feature_store(config.feature_store)

    def build_engine() -> TorchScoringEngine:
        return TorchScoringEngine(config.scoring, ml_backend=ml_backend, params=params,
                                  batcher_config=config.batcher, feature_store=store,
                                  device=device, warmup=warmup, feature_cache=feature_cache,
                                  session_state=session_state)

    supervisor = None
    if os.environ.get("SUPERVISOR", "1") != "0":
        supervisor = ServingSupervisor()
        engine = SupervisedScoringEngine(build_engine, supervisor=supervisor)
    else:
        engine = build_engine()
    inner = getattr(engine, "inner", engine)
    metrics = ServiceMetrics("risk")
    abuse = SequenceAbuseDetector(params=abuse_params, policy=abuse_policy, device=device)
    bridge = ScoringBridge(engine, resolve_transport(broker, config.rabbitmq_url),
                           abuse_detector=abuse)
    service = RiskGrpcService(engine, abuse_detector=abuse.check,
                              rate_limit_per_minute=config.rate_limit_per_minute,
                              metrics=metrics)
    ledger = None
    if ledger_dir:
        ledger = ledger_mod.DecisionLedger(
            ledger_dir, sink=ledger_mod.sink_from_env(),
            breaker=supervisor.breaker("ledger") if supervisor is not None else None,
            metrics=metrics)
        inner.ledger = ledger
        if supervisor is not None:
            ledger_mod.set_state_provider(lambda: supervisor.state)
        logger.info("decision ledger at %s (sink=%s)", ledger_dir,
                    os.environ.get("LEDGER_SINK", "") or "none")
    loop = make_online_loop(engine, ledger, ledger_dir, service) if online else None
    return AssembledService(config, engine, abuse, bridge, service, ledger, loop, supervisor,
                            metrics)


def check_online_boot(ml_backend: str, ledger_dir: str) -> None:
    """``ONLINE_LOOP=1``'s preconditions, checked before anything is built:
    a silently disabled learning loop is drift's best friend, so a config
    error fails the boot."""
    if not ledger_dir:
        raise RuntimeError("ONLINE_LOOP=1 requires LEDGER_DIR: the miner tails the decision "
                           "WAL for labeled hard examples")
    if ml_backend != "multitask":
        raise RuntimeError("ONLINE_LOOP=1 requires the trainable multitask backend "
                           f"(ML_BACKEND=multitask); got {ml_backend!r}")


def make_online_loop(engine: TorchScoringEngine, ledger, ledger_dir: str, service):
    """The online loop of ``ONLINE_LOOP=1`` over ``engine``, not started."""
    from igaming_platform_tpu_torch.serve.shadow import ShadowScorer
    from igaming_platform_tpu_torch.train.online import LedgerMiner, OnlineLearner, OnlineLoop
    from igaming_platform_tpu_torch.train.promote import PromotionController

    metrics = service.metrics
    shadow = ShadowScorer(engine, metrics=metrics)
    getattr(engine, "inner", engine).shadow = shadow
    # Candidate-against-production divergence trends in the drift engine's
    # windows, so a drifting candidate shows before any gate judges it.
    if service.drift is not None:
        shadow.on_result = service.drift.note_shadow_result
    controller = PromotionController(engine, shadow, ledger=ledger,
                                     vault_dir=os.path.join(ledger_dir, "params-vault"),
                                     metrics=metrics)
    return OnlineLoop(miner=LedgerMiner(ledger_dir, metrics=metrics),
                      learner=OnlineLearner(device=engine.device, metrics=metrics),
                      shadow=shadow, controller=controller)


class RiskServer:
    """An assembled risk service behind gRPC (optional) and the HTTP sidecar."""

    def __init__(self, assembled: AssembledService, *, grpc_port: int | None = None,
                 http_port: int | None = None):
        """``grpc_port`` None takes the config's; a negative one binds no
        gRPC (health then lives only on the sidecar). ``http_port`` 0 picks
        a free port."""
        self.engine = assembled.engine
        self.service = assembled.service
        self.bridge = assembled.bridge
        self.ledger = assembled.ledger
        self.online = assembled.online
        self.supervisor = assembled.supervisor
        self.metrics = self.service.metrics
        config = assembled.config
        grpc_port = config.grpc_port if grpc_port is None else grpc_port
        self.grpc_server, self.grpc_port = None, None
        self.health = HealthServicer()
        if grpc_port >= 0:
            self.grpc_server, self.health, self.grpc_port = serve_risk(self.service, grpc_port)
        if self.supervisor is not None:
            # BROWNOUT flips health NOT_SERVING; DEGRADED keeps answering.
            self.supervisor.bind(health=self.health, metrics=self.metrics)
        self.otlp = exporter_from_env("risk")
        if self.otlp is not None:
            self.otlp.on_failure = self.metrics.otlp_export_failures_total.inc
        # One /debug/profilez capture at a time, on a profiler readied here.
        self._profile_lock = threading.Lock()
        if self.inner.device.type == "cuda":
            tracing.prepare_device_trace()
        self._stopped = threading.Event()
        self._probe_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="device-probe")
        self.http_server, self.http_port = self._start_http(
            config.http_port if http_port is None else http_port)
        self.bridge.start()
        if self.online is not None:
            self.online.start()
            logger.info("online learning loop up (tick=%.1fs)", self.online.tick_s)
        logger.info("risk server up: grpc=%s http=%d", self.grpc_port, self.http_port)

    def device_alive(self, timeout_s: float = 2.0) -> bool:
        """A tiny op on the engine's device, read back within ``timeout_s``:
        a hung or lost device turns /ready false instead of hanging it."""

        def probe() -> bool:
            return int((torch.ones(1, device=self.engine.device) + 1).item()) == 2

        try:
            return self._probe_pool.submit(probe).result(timeout=timeout_s)
        except Exception:  # noqa: BLE001 — timeout or device error
            return False

    @property
    def inner(self) -> TorchScoringEngine:
        return getattr(self.engine, "inner", self.engine)

    def capture_profile(self, seconds: float, trace_id: str = "") -> dict:
        """A ``torch.profiler`` capture of host and CUDA activity for
        ``seconds`` (clamped to 0.1-30) while traffic keeps flowing, written
        as a Chrome trace into a new directory whose name carries
        ``trace_id``. One at a time: ``{"error"}`` while another runs. The
        answer counts the kernel events caught, by name, since the profiler
        can lose events in a long-lived process."""
        seconds = max(0.1, min(float(seconds), 30.0))
        if not self._profile_lock.acquire(blocking=False):
            return {"error": "profile capture already in progress"}
        try:
            suffix = re.sub(r"[^0-9a-zA-Z_-]", "", trace_id)[:32]
            log_dir = tempfile.mkdtemp(prefix=f"profilez-{suffix}-" if suffix else "profilez-",
                                       dir=os.environ.get("ANOMALY_PROFILE_DIR") or None)
            with tracing.device_trace(log_dir) as prof:
                time.sleep(seconds)
            kernels: dict[str, int] = {}
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    kernels[ev.name] = kernels.get(ev.name, 0) + 1
            return {"ok": True, "seconds": seconds, "log_dir": log_dir,
                    "trace": os.path.join(log_dir, "trace.json"),
                    "kernel_events": sum(kernels.values()), "kernels": kernels}
        except Exception as exc:  # noqa: BLE001 — a capture must not kill serving
            return {"error": f"profile capture failed: {exc}"}
        finally:
            self._profile_lock.release()

    # -- HTTP sidecar (main.go:160-202 equivalent) ---------------------------

    def _start_http(self, port: int):
        server_ref = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, code: int, body: str, content_type: str = "application/json"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                if self.path == "/metrics":
                    self._send(200, server_ref.metrics.registry.render_text(), "text/plain")
                elif self.path == "/debug/supervisorz":
                    sup = server_ref.supervisor
                    if sup is None:
                        self._send(404, '{"error":"supervisor disabled"}')
                        return
                    snap = sup.snapshot()
                    snap["rebuilds"] = getattr(server_ref.engine, "rebuilds", 0)
                    self._send(200, json.dumps(snap))
                elif self.path == "/debug/sloz":
                    slo_engine = slo_mod.get_default()
                    if slo_engine is None:
                        self._send(404, '{"error":"slo engine disabled"}')
                        return
                    self._send(200, json.dumps(slo_engine.snapshot()))
                elif self.path == "/debug/deadlinez":
                    snap = server_ref.inner.deadline_snapshot()
                    snap["burn_gate"] = server_ref.service.burn_gate.stats()
                    self._send(200, json.dumps(snap))
                elif self.path == "/debug/spans":
                    self._send(200, tracing.DEFAULT_COLLECTOR.to_json())
                elif self.path == "/debug/flightz":
                    self._send(200, flight_mod.DEFAULT_RECORDER.to_json())
                elif self.path.startswith("/debug/profilez"):
                    q = parse_qs(urlparse(self.path).query)
                    try:
                        seconds = float(q.get("seconds", ["2"])[0])
                    except ValueError:
                        self._send(400, '{"error":"bad seconds"}')
                        return
                    result = server_ref.capture_profile(seconds, q.get("trace_id", [""])[0])
                    self._send(409 if "error" in result else 200, json.dumps(result))
                elif self.path == "/health":
                    self._send(200, '{"status":"healthy"}')
                elif self.path == "/ready":
                    ready = not server_ref._stopped.is_set()
                    device_ok = server_ref.device_alive() if ready else False
                    self._send(200 if (ready and device_ok) else 503,
                               json.dumps({"ready": ready and device_ok, "device": device_ok}))
                elif self.path == "/debug/thresholds":
                    block, review = server_ref.engine.get_thresholds()
                    self._send(200, json.dumps({"block": block, "review": review}))
                elif self.path == "/debug/cachez":
                    cache = server_ref.inner.cache
                    if cache is None:
                        self._send(404, '{"error":"feature cache disabled"}')
                        return
                    snap = cache.stats()
                    snap["shards"] = cache.shard_stats()
                    if server_ref.inner.session is not None:
                        snap["session_shards"] = server_ref.inner.session.shard_stats()
                    self._send(200, json.dumps(snap))
                elif self.path == "/debug/sessionz":
                    session = server_ref.inner.session
                    if session is None:
                        self._send(404, '{"error":"session state disabled"}')
                        return
                    self._send(200, json.dumps(session.snapshot()))
                elif self.path == "/debug/driftz":
                    drift = drift_mod.get_default()
                    if drift is None:
                        self._send(404, '{"error":"drift observatory disabled"}')
                        return
                    self._send(200, json.dumps(drift.snapshot()))
                elif self.path == "/debug/ledgerz":
                    ledger = server_ref.ledger
                    if ledger is None:
                        self._send(404, '{"error":"ledger disabled"}')
                        return
                    self._send(200, json.dumps(ledger.stats()))
                elif self.path == "/debug/shadowz":
                    if server_ref.online is not None:
                        self._send(200, json.dumps(server_ref.online.report()))
                        return
                    shadow = server_ref.inner.shadow
                    if shadow is None:
                        self._send(404, '{"error":"no shadow scorer attached"}')
                        return
                    self._send(200, json.dumps({"shadow": shadow.report()}))
                else:
                    self._send(404, '{"error":"not found"}')

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length).decode() if length else "{}"
                try:
                    payload = json.loads(raw)
                except json.JSONDecodeError:
                    self._send(400, '{"error":"bad json"}')
                    return
                if self.path == "/debug/breakers":
                    self._breakers(payload)
                elif self.path == "/debug/thresholds":
                    server_ref.engine.set_thresholds(
                        int(payload.get("block", 80)), int(payload.get("review", 50)))
                    self._send(200, '{"ok":true}')
                elif self.path == "/debug/score":
                    resp = server_ref.engine.score(ScoreRequest(
                        account_id=str(payload.get("account_id", "debug")),
                        amount=int(payload.get("amount", 0)),
                        tx_type=str(payload.get("transaction_type", "deposit")),
                        ip=str(payload.get("ip", "")),
                        device_id=str(payload.get("device_id", "")),
                    ))
                    self._send(200, json.dumps({
                        "score": resp.score,
                        "action": resp.action,
                        "reasons": [r.value for r in resp.reason_codes],
                        "rule_score": resp.rule_score,
                        "ml_score": resp.ml_score,
                        "response_time_ms": resp.response_time_ms,
                    }))
                elif self.path == "/debug/driftz":
                    self._drift_action(payload)
                elif self.path == "/debug/outcomes":
                    self._outcomes(payload)
                elif self.path == "/debug/promotion":
                    self._promotion(payload)
                else:
                    self._send(404, '{"error":"not found"}')

            def _breakers(self, payload) -> None:
                """Operator force and clear: ``{"dep": ..., "action": "open" |
                "clear" | "probe"}`` or ``{"brownout": "force" | "clear"}``;
                answers the supervisor's snapshot."""
                sup = server_ref.supervisor
                if sup is None:
                    self._send(404, '{"error":"supervisor disabled"}')
                    return
                try:
                    if not isinstance(payload, dict):
                        raise ValueError("body must be a JSON object")
                    if "brownout" in payload:
                        if payload["brownout"] == "force":
                            sup.force_brownout("operator /debug/breakers")
                        else:
                            sup.clear_brownout()
                    else:
                        sup.force_breaker(str(payload.get("dep", "")),
                                          str(payload.get("action", "")))
                except (KeyError, ValueError) as exc:
                    self._send(400, json.dumps({"error": str(exc)}))
                    return
                self._send(200, json.dumps(sup.snapshot()))

            def _outcomes(self, payload) -> None:
                """Label backfill: ``{"decision_id", "label", "source"}`` or
                ``{"outcomes": [...]}`` of them, appended as outcome records.
                A malformed body is a 400; the answer counts accepted rows and
                decision ids this process did not issue (still appended: the
                WAL may hold them from before a restart)."""
                ledger = server_ref.ledger
                if ledger is None:
                    self._send(404, '{"error":"ledger disabled"}')
                    return
                if not isinstance(payload, dict):
                    self._send(400, '{"error":"body must be a JSON object"}')
                    return
                rows = payload.get("outcomes")
                if rows is None:
                    rows = [payload]
                if not isinstance(rows, list):
                    self._send(400, '{"error":"outcomes must be a list"}')
                    return
                for row in rows:
                    if not isinstance(row, dict) or not str(row.get("decision_id", "")):
                        self._send(400, json.dumps({
                            "error": "each outcome needs a non-empty decision_id",
                            "bad_row": repr(row)[:120]}))
                        return
                accepted = unknown = 0
                for row in rows:
                    did = str(row["decision_id"])
                    if not ledger.knows_decision(did):
                        unknown += 1
                    if ledger.append_outcome(ledger_mod.OutcomeRecord(
                            decision_id=did, label=1 if row.get("label") else 0,
                            source=str(row.get("source", "manual")),
                            ts_unix=ledger_mod.wall_clock())):
                        accepted += 1
                self._send(200, json.dumps({"accepted": accepted, "unknown": unknown,
                                            "submitted": len(rows)}))

            def _promotion(self, payload) -> None:
                """The promotion controller's knobs: {"action": "pause" |
                "resume" | "rollback" | "inject_regression" | "tick"}; answers
                the controller's report."""
                online = server_ref.online
                if online is None:
                    self._send(404, '{"error":"online loop disabled"}')
                    return
                ctl = online.controller
                action = str(payload.get("action", "")) if isinstance(payload, dict) else ""
                try:
                    if action == "pause":
                        ctl.pause()
                    elif action == "resume":
                        ctl.resume()
                    elif action == "rollback":
                        ctl.force_rollback(str(payload.get("reason", "operator /debug/promotion")))
                    elif action == "inject_regression":
                        ctl.inject_regression()
                    elif action == "tick":
                        online.tick()
                    else:
                        raise ValueError(f"unknown promotion action {action!r} (use "
                                         "pause|resume|rollback|inject_regression|tick)")
                except ValueError as exc:
                    self._send(400, json.dumps({"error": str(exc)}))
                    return
                self._send(200, json.dumps(ctl.report()))

            def _drift_action(self, payload: dict) -> None:
                """{"action": "pin_reference"} pins the current window;
                {"action": "load"|"save", "path": ...} reads or writes a
                reference file."""
                drift = drift_mod.get_default()
                if drift is None:
                    self._send(404, '{"error":"drift observatory disabled"}')
                    return
                action = str(payload.get("action", ""))
                try:
                    if action == "pin_reference":
                        min_rows = payload.get("min_rows")
                        ref = drift.pin_reference(
                            source=str(payload.get("source", "pinned-via-driftz")),
                            min_rows=int(min_rows) if min_rows is not None else None)
                    elif action == "load":
                        ref = drift.load_reference(str(payload["path"]))
                    elif action == "save":
                        ref = drift.reference
                        if ref is None:
                            raise ValueError("no reference pinned")
                        ref.save(str(payload["path"]))
                    else:
                        raise ValueError(f"unknown driftz action {action!r} (use "
                                         "pin_reference|load|save)")
                except (KeyError, ValueError, OSError) as exc:
                    self._send(400, json.dumps({"error": str(exc)}))
                    return
                self._send(200, json.dumps({"ok": True, "reference": ref.meta(),
                                            "alerts": drift.alerts_active()}))

        httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        thread = threading.Thread(target=httpd.serve_forever, name="http-sidecar", daemon=True)
        thread.start()
        return httpd, httpd.server_address[1]

    # -- lifecycle -----------------------------------------------------------

    def shutdown(self, grace: float = 30.0) -> None:
        """NOT_SERVING, stop the online loop, stop the bridge, drain gRPC, then close the engine
        (batcher and host pipeline), close the ledger (every admitted
        decision is noted by then; its WAL is flushed and its sink given a
        bounded catch-up), drain the shadow scorer and the drift engine
        (every scored batch folded), close the service (which closes the
        drift engine), then stop the sidecar."""
        self._stopped.set()
        if self.online is not None:
            # Stop the learner and the promotion ticker before the drain: a
            # hot swap mid-shutdown has nothing left to serve with.
            self.online.stop()
        self.bridge.stop()
        graceful_stop(self.grpc_server, self.health, grace, engine=self.engine)
        if self.ledger is not None:
            self.ledger.close()
        if self.inner.shadow is not None:
            self.inner.shadow.drain()
        if self.service.drift is not None:
            self.service.drift.drain()
        self.service.close()
        if self.otlp is not None:
            self.otlp.stop()
        self.http_server.shutdown()
        self.http_server.server_close()
        self._probe_pool.shutdown(wait=False)

    def wait_for_signal(self) -> None:
        done = threading.Event()

        def handler(signum, frame):
            logger.info("signal %d: shutting down", signum)
            done.set()

        signal.signal(signal.SIGINT, handler)
        signal.signal(signal.SIGTERM, handler)
        done.wait()
        self.shutdown()


def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    device, abuse_policy = "cuda", "model"
    if not torch.cuda.is_available():
        if os.environ.get("SERVE_DEVICE_FALLBACK", "").lower() != "cpu":
            logger.error("no CUDA device: refusing to boot a degraded server. "
                         "Set SERVE_DEVICE_FALLBACK=cpu to serve on the host CPU anyway.")
            raise SystemExit(1)
        device, abuse_policy = "cpu", os.environ.get("ABUSE_CPU_POLICY", "heuristic")
        logger.warning("no CUDA device: SERVE_DEVICE_FALLBACK=cpu set, serving on the host "
                       "CPU (abuse policy %s)", abuse_policy)
    server = RiskServer(assemble_risk_service(device=device, abuse_policy=abuse_policy))
    server.wait_for_signal()


if __name__ == "__main__":
    main()
