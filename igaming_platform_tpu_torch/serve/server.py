"""The risk service process: assembly, gRPC binding, HTTP sidecar, main().

The port's counterpart of ``igaming_platform_tpu/serve/server.py``:
environment config, then the feature store, the scoring engine (warmed up
before it serves), the bonus-abuse detector, the event bridge and the
``RiskGrpcService`` (``assemble_risk_service``); then ``RiskServer`` binds
gRPC on ``GRPC_PORT`` through the port's own transport
(``serve/grpc_wire.py``, no grpcio needed), and the HTTP sidecar (/health,
/ready, /debug/thresholds, /debug/score, /debug/cachez, /debug/sessionz,
/debug/driftz, /debug/ledgerz, /debug/outcomes,
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
  many device events it caught, by name, counted from the written trace by
  a child process. Stopping the profiler and writing its trace still hold
  the interpreter, 3.5-3.9 s after 1.5 s on an NVIDIA H100 80GB HBM3 at
  700 W (``chip_smoke.capture_stall_probe``);
- ``GET /debug/hostprofz`` is the host profiler (``obs/hostprof.py``,
  ``HOSTPROF=0`` off): the µs-per-row stage table, the GC pauses and the
  heap, ``?format=folded`` or ``?format=speedscope`` for the sampler's
  stacks; ``POST /debug/hostprofz`` takes ``{"action": "start", "hz"} |
  {"action": "stop"} | {"action": "reset"}`` (``HOSTPROF_HZ`` starts the
  sampler at boot);
- ``GET /debug/telemetryz`` is the runtime telemetry
  (``obs/runtime_telemetry.py``, ``RUNTIME_TELEMETRY=0`` off): dispatches,
  compile events and signatures, the step-time detectors and the anomaly
  profiles. A step-time anomaly (``ANOMALY_K_SIGMA``, ``ANOMALY_MIN_STEP_MS``,
  ``ANOMALY_WARMUP_STEPS``) records ``ANOMALY_PROFILE_SECONDS`` of the
  port's own device timeline (``obs/devtrace.py``:
  every launched step and hand-kernel launch with its device span, and the
  host spans around them) into a directory keyed by its trace id, one per
  ``ANOMALY_PROFILE_COOLDOWN_S`` (``ANOMALY_PROFILE=0`` counts only), without
  holding the serving threads;
- gRPC server reflection (``serve/reflection.py``) is registered with the
  gRPC binding;
- ``OTEL_EXPORTER_OTLP_ENDPOINT`` exports the span ring over OTLP/HTTP;
- ``CHAOS_PLAN`` installs a fault plan before the engine is built (logged).

Run it as ``python -m igaming_platform_tpu_torch.serve.server``. It serves
on the card. ``device_gate`` probes the card first from a killable
subprocess (``core/devices.py``, ``DEVICE_PROBE_BUDGET_S``); when it does
not answer the boot fails with the probe's label unless
``SERVE_DEVICE_FALLBACK=cpu``, which serves on the host CPU with the abuse
path under ``ABUSE_CPU_POLICY`` (default ``heuristic``), as the reference
does. ``FRAUD_MODEL_PATH`` boots a trained multitask checkpoint from its
``.npz`` (``resolve_model_boot``); ``ML_BACKEND=routed`` needs a bundle with
the router and every expert (``models/ensemble.init_routed_params`` makes
one for a dev boot).

The serving mesh: ``MESH_DEVICES=N`` shards the scoring batch over the
first N visible CUDA devices (-1: all; more than are visible fails the
boot), ``MESH_SEQ`` and ``MESH_EXPERT`` carve the ``seq`` and ``expert``
axes out of them; ``STATE_SHARDING`` and ``MODEL_SHARDING`` apply on it
(``serve/scorer.py``). A ``seq`` axis turns on ring attention for the abuse
detector. ``MULTIHOST_ROLE=front|follower`` runs one process of a
multi-host engine (``serve/multihost.py``): the front serves the full risk
server, its steps scored by every process over a gloo rendezvous
(``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``;
``MULTIHOST_FOLLOWER_PORTS`` on the front, ``MULTIHOST_WORK_PORT`` on a
follower); a role refuses ``SERVE_DEVICE_FALLBACK=cpu``.

The batch-feature refresh (``serve/batch_refresh.py``) runs as in the JAX
server: with ``CLICKHOUSE_URL=http…`` it scans ClickHouse
(``serve/clickhouse.py``), else with ``BATCH_FEATURE_DB`` (a SQLite path,
``sqlite://`` or ``postgres://`` URL) the wallet store; the server refreshes
once at boot, then every ``BATCH_FEATURE_INTERVAL_S`` (3600 s), retrying
fast until a first scan succeeds. With neither set there is no job.
``FEATURE_STORE=redis`` keeps the features at ``REDIS_URL``
(``serve/redis_store.py``; it needs the ``redis`` library, and raises
without it). ``LEDGER_SINK=pg`` drains the ledger into Postgres at
``LEDGER_PG_URL`` (else ``DATABASE_URL``).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import re
import signal
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

from igaming_platform_tpu_torch.convert import from_jax_params, load_params_tree
from igaming_platform_tpu_torch.core.config import RiskServiceConfig
from igaming_platform_tpu_torch.core.features import NUM_FEATURES
from igaming_platform_tpu_torch.obs import devtrace
from igaming_platform_tpu_torch.obs import drift as drift_mod
from igaming_platform_tpu_torch.obs import flight as flight_mod
from igaming_platform_tpu_torch.obs import hostprof
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
    if ml_backend == "routed":
        from igaming_platform_tpu_torch.models.ensemble import ROUTED_PARAM_KEYS

        missing = [k for k in ROUTED_PARAM_KEYS
                   if not isinstance(params, dict) or params.get(k) is None]
        if missing:
            raise RuntimeError(
                "ML_BACKEND=routed requires a checkpoint bundle with params for "
                f"{ROUTED_PARAM_KEYS}; missing {missing}. Build one from trained checkpoints "
                "(or models.ensemble.init_routed_params for dev boots).")
    return ml_backend, params


def serving_mesh(config: RiskServiceConfig):
    """The serving mesh ``MESH_DEVICES``/``MESH_SEQ``/``MESH_EXPERT`` ask for
    over the visible CUDA devices, or None (unset, or one device). Asking
    for more devices than are visible, or axes that do not divide them,
    fails the boot."""
    if not config.mesh_devices:
        return None
    from igaming_platform_tpu_torch.parallel.mesh import MeshSpec, create_mesh, devices_from_env

    devs = devices_from_env(config.mesh_devices)
    n = len(devs)
    seq, expert = max(1, config.mesh_seq), max(1, config.mesh_expert)
    if n % (seq * expert) != 0:
        raise RuntimeError(f"MESH_SEQ({seq}) * MESH_EXPERT({expert}) must divide "
                           f"MESH_DEVICES={n}")
    if n <= 1:
        return None
    mesh = create_mesh(MeshSpec(data=n // (seq * expert), seq=seq, expert=expert), devices=devs)
    logger.info("serving mesh: data=%d seq=%d expert=%d over %d devices",
                n // (seq * expert), seq, expert, n)
    return mesh


def capture_devices(engine) -> list:
    """The distinct devices ``engine`` launches on: its own, then each other
    device of its serving mesh, as ``jax.profiler`` traces every device of
    the process."""
    out = [torch.device(engine.device)]
    mesh = getattr(engine, "mesh", None)
    for device in (mesh.distinct_devices() if mesh is not None else ()):
        if torch.device(device) not in out:
            out.append(torch.device(device))
    return out


def load_multitask(path: str) -> dict:
    """The port's ``multitask`` params from an ``.npz`` holding a multitask
    tree under ``multitask``. Raises on anything else."""
    tree = load_params_tree(path)["multitask"]
    first = tree["trunk"]["layers"][0]["w"]
    if first.ndim != 2 or first.shape[0] != NUM_FEATURES:
        raise ValueError(f"{path}: the trunk's first layer takes {first.shape[0]} features, "
                         f"not {NUM_FEATURES}")
    return from_jax_params("multitask", {"multitask": tree})


def make_feature_store(kind: str, redis_url: str = "redis://localhost:6379"):
    """The store FEATURE_STORE names: the native C++ one for "auto" and
    "native" (a library that does not build raises), the Python one for
    "python", the Redis one at ``redis_url`` for "redis" (RuntimeError
    without the redis library)."""
    if kind in ("auto", "native"):
        return NativeFeatureStore()
    if kind == "python":
        return InMemoryFeatureStore()
    if kind == "redis":
        from igaming_platform_tpu_torch.serve.redis_store import RedisFeatureStore

        store = RedisFeatureStore(redis_url)
        logger.info("using Redis feature store at %s", redis_url)
        return store
    raise ValueError(f"FEATURE_STORE={kind!r} is not a store (auto, native, python or redis)")


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
                          session_state: bool | None = None, mesh=None,
                          engine_factory=None) -> AssembledService:
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
    starts. Binds no transport.

    ``mesh`` (else ``serving_mesh(config)``) serves the engine over a mesh,
    and the abuse detector in ring mode when it has a ``seq`` axis.
    ``engine_factory(scoring_cfg, ml_backend=, params=, batcher_config=,
    feature_store=)`` builds the engine instead (the multi-host front's);
    under the supervisor it is the rebuild factory, and a multihost
    engine's follower-state callbacks drive the ``multihost`` breaker."""
    config = config or RiskServiceConfig.from_env()
    if mesh is None and engine_factory is None:
        mesh = serving_mesh(config)
    plan = chaos.install_from_env()
    if plan is not None:
        logger.warning("CHAOS PLAN ACTIVE (seed=%d): %s", plan.seed, sorted(plan.specs))
    ml_backend, params = resolve_model_boot(config, ml_backend, params)
    ledger_dir = os.environ.get("LEDGER_DIR", "")
    online = os.environ.get("ONLINE_LOOP", "") == "1"
    if online:
        check_online_boot(ml_backend, ledger_dir)
    store = (feature_store if feature_store is not None
             else make_feature_store(config.feature_store, config.redis_url))

    def build_engine() -> TorchScoringEngine:
        if engine_factory is not None:
            return engine_factory(config.scoring, ml_backend=ml_backend, params=params,
                                  batcher_config=config.batcher, feature_store=store)
        return TorchScoringEngine(config.scoring, ml_backend=ml_backend, params=params,
                                  batcher_config=config.batcher, feature_store=store,
                                  device=device, warmup=warmup, feature_cache=feature_cache,
                                  session_state=session_state, mesh=mesh)

    supervisor = None
    if os.environ.get("SUPERVISOR", "1") != "0":
        supervisor = ServingSupervisor()
        engine = SupervisedScoringEngine(build_engine, supervisor=supervisor)
    else:
        engine = build_engine()
    inner = getattr(engine, "inner", engine)
    if supervisor is not None and hasattr(inner, "supervisor") and inner.supervisor is None:
        # A multihost front built by engine_factory: its follower-state
        # callbacks open and close the multihost breaker.
        inner.supervisor = supervisor
    metrics = ServiceMetrics("risk")
    # Sequence-parallel abuse scoring when the mesh has a ``seq`` axis.
    seq_sharded = mesh is not None and int(mesh.shape.get("seq", 1)) > 1
    abuse = SequenceAbuseDetector(params=abuse_params, policy=abuse_policy, device=device,
                                  mesh=mesh if seq_sharded else None,
                                  seq_mode="ring" if seq_sharded else "dense")
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
                                     metrics=metrics, slo_engine=service.slo)
    return OnlineLoop(miner=LedgerMiner(ledger_dir, metrics=metrics),
                      learner=OnlineLearner(device=engine.device, metrics=metrics),
                      shadow=shadow, controller=controller)


def start_batch_refresh(config: RiskServiceConfig, feature_store):
    """The batch-feature refresh job over ``feature_store``, refreshed once
    now (a failure is logged: the ticker retries it) and started; None when
    the config names no source. The source is ClickHouse when
    ``clickhouse_url`` is http (the reference's tcp:// default selects
    nothing), else the wallet store at ``batch_feature_db``."""
    from igaming_platform_tpu_torch.serve import batch_refresh

    if config.clickhouse_url.startswith("http"):
        from igaming_platform_tpu_torch.serve.clickhouse import clickhouse_source

        logger.info("batch features from ClickHouse at %s", config.clickhouse_url)
        source = clickhouse_source(config.clickhouse_url)
    elif config.batch_feature_db:
        source = batch_refresh.wallet_store_source(config.batch_feature_db)
    else:
        return None
    job = batch_refresh.BatchFeatureRefreshJob(feature_store, source,
                                               interval_s=config.batch_feature_interval_s)
    try:
        n = job.refresh_once()
        logger.info("batch features hydrated for %d accounts", n)
    except Exception:  # noqa: BLE001 — the ticker retries a failed first scan
        logger.warning("initial batch-feature refresh failed", exc_info=True)
    job.start()
    return job


def amqp_breaker_feed(breaker):
    """An ``AmqpPublisher.on_publish_result`` hook that feeds ``breaker``:
    a publish that succeeds records a success, one that fails after its
    retries a failure."""

    def feed(ok: bool, exc) -> None:
        if ok:
            breaker.record_success()
        else:
            breaker.record_failure(exc)

    return feed


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
            # An AMQP publisher reports each publish to the `amqp` breaker.
            if hasattr(self.bridge.publisher, "on_publish_result"):
                self.bridge.publisher.on_publish_result = amqp_breaker_feed(
                    self.supervisor.breaker("amqp"))
        self.otlp = exporter_from_env("risk")
        if self.otlp is not None:
            self.otlp.on_failure = self.metrics.otlp_export_failures_total.inc
        # One capture at a time (/debug/profilez or an anomaly's), on a
        # profiler readied here; anomaly captures run on one worker thread,
        # started here so that no serving thread starts it.
        self._profile_lock = threading.Lock()
        self._capture_jobs = queue.SimpleQueue()
        threading.Thread(target=self._capture_worker, args=(self._capture_jobs,),
                         name="anomaly-profile", daemon=True).start()
        # A step-time anomaly records a profile keyed by its trace id.
        self.telemetry = self.service.telemetry
        if self.telemetry is not None:
            self.telemetry.bind_profile_trigger(self._anomaly_profile_trigger)
        # Every card the engine launches on is readied for captures: the
        # engine's, and each other card of its serving mesh, so that no mark
        # makes its CUDA events on a serving thread or lacks an anchor.
        cards = [d for d in capture_devices(self.inner) if torch.device(d).type == "cuda"]
        if cards:
            tracing.prepare_device_trace()
        for card in cards:
            devtrace.prepare(card)
        self._stopped = threading.Event()
        self._probe_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="device-probe")
        self.http_server, self.http_port = self._start_http(
            config.http_port if http_port is None else http_port)
        self.bridge.start()
        if self.online is not None:
            self.online.start()
            logger.info("online learning loop up (tick=%.1fs)", self.online.tick_s)
        self.batch_refresh = start_batch_refresh(config, self.inner.features)
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

    def _capture_dir(self, trace_id: str) -> str:
        """A new directory for one capture, its name carrying ``trace_id``."""
        suffix = re.sub(r"[^0-9a-zA-Z_-]", "", trace_id)[:32]
        return tempfile.mkdtemp(prefix=f"profilez-{suffix}-" if suffix else "profilez-",
                                dir=os.environ.get("ANOMALY_PROFILE_DIR") or None)

    def capture_profile(self, seconds: float, trace_id: str = "") -> dict:
        """A ``torch.profiler`` capture of host and CUDA activity for
        ``seconds`` (clamped to 0.1-30) while traffic keeps flowing, written
        as a Chrome trace into a new directory whose name carries
        ``trace_id``. One at a time: ``{"error"}`` while another runs. The
        answer counts the device events caught, by name (the profiler can
        lose events in a long-lived process): a child process parses the
        written trace, so the count holds nothing here. Stopping the
        profiler and writing its trace do hold the interpreter: 1.5-1.7 s
        and 1.8-2.4 s after a 1.5 s capture of a launch-heavy thread on an
        NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.capture_stall_probe``,
        PERF.md §6)."""
        seconds = max(0.1, min(float(seconds), 30.0))
        if not self._profile_lock.acquire(blocking=False):
            return {"error": "profile capture already in progress"}
        try:
            log_dir = self._capture_dir(trace_id)
            with tracing.device_trace(log_dir):
                time.sleep(seconds)
            trace = os.path.join(log_dir, "trace.json")
            kernels = tracing.count_trace_events(trace)
            return {"ok": True, "seconds": seconds, "log_dir": log_dir, "trace": trace,
                    "kernel_events": sum(kernels.values()), "kernels": kernels}
        except Exception as exc:  # noqa: BLE001 — a capture must not kill serving
            return {"error": f"profile capture failed: {exc}"}
        finally:
            self._profile_lock.release()

    def _capture_timeline(self, seconds: float, trace_id: str) -> dict:
        """An anomaly capture, with the capture lock held (released here):
        the port's own device timeline (``obs/devtrace.py``) for ``seconds``
        (clamped to 0.1-30) on the calling thread, written as a Chrome trace
        (``trace.json``) into a new directory whose name carries
        ``trace_id``: every step launched and every hand-kernel launch with
        its device span, the host spans around them, and the launch and
        dispatch counters' deltas over the window."""
        seconds = max(0.1, min(float(seconds), 30.0))
        try:
            log_dir = self._capture_dir(trace_id)
            devtrace.capture(log_dir, seconds, telemetry=self.telemetry)
            return {"ok": True, "seconds": seconds, "log_dir": log_dir,
                    "trace": os.path.join(log_dir, "trace.json")}
        except Exception as exc:  # noqa: BLE001 — a capture must not kill serving
            return {"error": f"profile capture failed: {exc}"}
        finally:
            self._profile_lock.release()

    def _anomaly_profile_trigger(self, trace_id: str, stage: str, duration_ms: float) -> dict:
        """The runtime telemetry's anomaly hook, on a serving thread: takes
        the capture lock without waiting and hands a ``_capture_timeline`` of
        ``ANOMALY_PROFILE_SECONDS`` (default 1.5) keyed by the anomalous
        trace id to the capture worker thread, or, when another capture
        holds the lock, the JAX server's "already in progress" error. The
        result (the trace's path, as the JAX server's) is folded into the
        telemetry's capture record. The cooldown is the telemetry's."""
        seconds = float(os.environ.get("ANOMALY_PROFILE_SECONDS", "1.5"))
        held = self._profile_lock.acquire(blocking=False)
        self._capture_jobs.put((held, seconds, trace_id, stage, duration_ms))
        return {"seconds": seconds, "async": True}

    def _capture_worker(self, jobs: queue.SimpleQueue) -> None:
        """Anomaly captures, one after another, until a None job."""
        while (job := jobs.get()) is not None:
            held, seconds, trace_id, stage, duration_ms = job
            result = (self._capture_timeline(seconds, trace_id) if held
                      else {"error": "profile capture already in progress"})
            telemetry = self.telemetry
            if telemetry is not None:
                telemetry.note_capture_result(trace_id, result)
            if "error" in result:
                logger.warning("anomaly profile capture (%s, %s): %s", trace_id, stage,
                               result["error"])
            else:
                logger.warning("anomaly profile captured: stage=%s trace=%s duration_ms=%.1f "
                               "-> %s", stage, trace_id, duration_ms, result["log_dir"])

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
                    # Scrape-fresh: the arena and card memory gauges, and the
                    # GC pauses not yet folded.
                    if server_ref.telemetry is not None:
                        server_ref.telemetry.refresh_gauges()
                    hostprof.get_default().fold_gc()
                    self._send(200, server_ref.metrics.registry.render_text(), "text/plain")
                elif self.path == "/debug/telemetryz":
                    tel = server_ref.telemetry
                    if tel is None:
                        self._send(404, '{"error":"telemetry disabled"}')
                        return
                    self._send(200, json.dumps(tel.snapshot()))
                elif self.path.startswith("/debug/hostprofz"):
                    hp = hostprof.get_default()
                    fmt = parse_qs(urlparse(self.path).query).get("format", ["json"])[0]
                    if fmt == "folded":
                        self._send(200, hp.sampler.to_folded_text(), "text/plain")
                    elif fmt == "speedscope":
                        self._send(200, json.dumps(hp.sampler.to_speedscope()))
                    else:
                        self._send(200, hp.to_json())
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
                elif self.path == "/debug/hostprofz":
                    self._hostprof(payload)
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

            def _hostprof(self, payload) -> None:
                """Sampler control: ``{"action": "start", "hz": 97}`` (409
                while one runs or for a bad hz), ``{"action": "stop"}`` (the
                summary) and ``{"action": "reset"}`` (zeros the accounting)."""
                hp = hostprof.get_default()
                action = str(payload.get("action", "")) if isinstance(payload, dict) else ""
                if action == "start":
                    try:
                        hz = float(payload.get("hz", 97.0))
                    except (TypeError, ValueError):
                        self._send(400, '{"error":"bad hz"}')
                        return
                    if not hp.sampler.start(hz):
                        self._send(409, json.dumps({"error": "sampler already running or bad hz",
                                                    "sampler": hp.sampler.snapshot()}))
                        return
                    self._send(200, json.dumps({"ok": True, "sampler": hp.sampler.snapshot()}))
                elif action == "stop":
                    self._send(200, json.dumps({"ok": True, "sampler": hp.sampler.stop()}))
                elif action == "reset":
                    hp.reset()
                    self._send(200, '{"ok":true}')
                else:
                    self._send(400, json.dumps({"error": f"unknown hostprofz action {action!r} "
                                                         "(use start|stop|reset)"}))

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
        if self.batch_refresh is not None:
            self.batch_refresh.stop()
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
        self._capture_jobs.put(None)

    def wait_for_signal(self, done: threading.Event | None = None) -> None:
        """Serve until SIGINT or SIGTERM, then shut down; ``done`` is
        ``stop_on_signal``'s event when the boot installed it first."""
        (done or stop_on_signal()).wait()
        self.shutdown()


def stop_on_signal() -> threading.Event:
    """An event that SIGINT and SIGTERM set from now on. A boot installs it
    before it builds the server, so a signal sent as soon as "risk server
    up" is logged drains the server instead of killing the process."""
    done = threading.Event()

    def handler(signum, frame):
        logger.info("signal %d: shutting down", signum)
        done.set()

    signal.signal(signal.SIGINT, handler)
    signal.signal(signal.SIGTERM, handler)
    return done


def device_gate() -> str:
    """The device to serve on, after ``core/devices.ensure_responsive_device``
    probed the card from a killable subprocess (CUDA init, one launch, a
    synchronize; retried while it hangs, inside ``DEVICE_PROBE_BUDGET_S``):
    ``"cuda"`` when it answered; ``"cpu"`` when it did not and
    ``SERVE_DEVICE_FALLBACK=cpu`` asks to serve on the host anyway; else the
    boot fails (SystemExit 1) with the probe's label. Nothing falls back
    quietly."""
    from igaming_platform_tpu_torch.core.devices import ensure_responsive_device

    label = ensure_responsive_device()
    if not label:
        return "cuda"
    if os.environ.get("SERVE_DEVICE_FALLBACK", "").lower() == "cpu":
        logger.warning("device unavailable (%s): SERVE_DEVICE_FALLBACK=cpu set, serving on the "
                       "host CPU", label)
        return "cpu"
    logger.error("device unavailable (%s): refusing to boot a degraded server. Set "
                 "SERVE_DEVICE_FALLBACK=cpu to serve on the host CPU anyway.", label)
    raise SystemExit(1)


def _multihost_mesh():
    """The global mesh of a multihost role: every process's devices on
    ``data``, joined by the gloo rendezvous of the environment."""
    from igaming_platform_tpu_torch.parallel.distributed import global_mesh, initialize_from_env
    from igaming_platform_tpu_torch.parallel.mesh import MeshSpec

    if not initialize_from_env():
        raise RuntimeError("MULTIHOST_ROLE requires the distributed env contract "
                           "(COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID)")
    return global_mesh(MeshSpec(data=-1), local_devices=[torch.device("cuda", 0)])


def multihost_main(role: str) -> None:
    """``MULTIHOST_ROLE=front|follower``: one process of a multi-host engine
    (``serve/multihost.py``). A role never falls back to the CPU: one
    process pinned to its host while its peers use the card would score a
    different program."""
    if os.environ.get("SERVE_DEVICE_FALLBACK", "").lower() == "cpu":
        raise RuntimeError(
            "SERVE_DEVICE_FALLBACK=cpu is not valid with MULTIHOST_ROLE: a per-process CPU "
            "fallback would diverge the global mesh; fix the device or remove the fallback")
    if role not in ("front", "follower"):
        raise RuntimeError(f"MULTIHOST_ROLE={role!r} not recognized (front|follower)")
    config = RiskServiceConfig.from_env()
    if role == "follower":
        port_env = os.environ.get("MULTIHOST_WORK_PORT", "")
        if not port_env:
            raise RuntimeError("MULTIHOST_ROLE=follower requires MULTIHOST_WORK_PORT")
        device_gate()
        mesh = _multihost_mesh()
        ml_backend, params = resolve_model_boot(config)
        from igaming_platform_tpu_torch.serve.multihost import follower_serve

        logger.info("multihost follower: process %d/%d, work port %s", mesh.process_index,
                    mesh.process_count, port_env)
        otlp = exporter_from_env("risk-follower")
        try:
            follower_serve(int(port_env), config.scoring, ml_backend, params, mesh,
                           batcher_config=config.batcher)
        finally:
            if otlp is not None:
                otlp.stop()
        return
    ports = [int(p) for p in os.environ.get("MULTIHOST_FOLLOWER_PORTS", "").split(",") if p]
    if not ports:
        # An empty channel would make the first step wait for followers
        # that do not exist: a config error fails the boot.
        raise RuntimeError("MULTIHOST_ROLE=front requires MULTIHOST_FOLLOWER_PORTS "
                           "(comma-separated follower work ports)")
    device_gate()
    mesh = _multihost_mesh()
    from igaming_platform_tpu_torch.serve.multihost import multihost_engine

    def factory(scoring_cfg, *, ml_backend, params, batcher_config, feature_store):
        return multihost_engine(mesh, ports, config=scoring_cfg, ml_backend=ml_backend,
                                params=params, batcher_config=batcher_config,
                                feature_store=feature_store)

    if config.mesh_devices:
        # The multihost engine owns the devices: a second mesh from
        # MESH_DEVICES would run steps the followers never mirror.
        logger.warning("MULTIHOST_ROLE=front ignores MESH_DEVICES/MESH_SEQ/MESH_EXPERT: the "
                       "multihost mesh owns the devices")
        config = replace(config, mesh_devices=0)
    assembled = assemble_risk_service(config, engine_factory=factory)
    done = stop_on_signal()
    RiskServer(assembled).wait_for_signal(done)


def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    role = os.environ.get("MULTIHOST_ROLE", "").lower()
    if role:
        multihost_main(role)
        return
    device, abuse_policy = device_gate(), "model"
    if device == "cpu":
        abuse_policy = os.environ.get("ABUSE_CPU_POLICY", "heuristic")
        logger.warning("serving on the host CPU (abuse policy %s)", abuse_policy)
    assembled = assemble_risk_service(device=device, abuse_policy=abuse_policy)
    done = stop_on_signal()
    RiskServer(assembled).wait_for_signal(done)


if __name__ == "__main__":
    main()
