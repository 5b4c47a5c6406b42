"""The risk service process: assembly, gRPC binding, HTTP sidecar, main().

The port's counterpart of ``igaming_platform_tpu/serve/server.py``:
environment config, then the feature store, the scoring engine (warmed up
before it serves), the bonus-abuse detector, the event bridge and the
``RiskGrpcService`` (``assemble_risk_service``); then ``RiskServer`` binds
gRPC, when grpcio is installed and a port is asked for, and the HTTP
sidecar (/health, /ready, /debug/thresholds, /debug/score, /debug/cachez,
/debug/sessionz, /debug/driftz and /debug/shadowz), and shuts down on a
signal: health NOT_SERVING, drain, stop. The drift observatory is on unless
``DRIFT=0`` (``RiskGrpcService`` installs it; ``DRIFT_REF`` names a pinned
reference to load at boot); ``POST /debug/driftz`` pins the current window
as the reference, or loads or saves one. A shadow scorer is attached to the
engine by its caller (``engine.shadow``; in the JAX package the online
loop does it). The engine reads its cache and session knobs (``WIRE_MODE``,
``FEATURE_CACHE``, ``FEATURE_CACHE_CAPACITY``, ``FEATURE_CACHE_MAX_AGE_S``,
``SESSION_STATE``, ``SESSION_EVENTS``, ``SESSION_MIN_EVENTS``,
``SESSION_FLAG_THRESHOLD``, ``SESSION_HEAD``) from the environment;
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

Run it as ``python -m igaming_platform_tpu_torch.serve.server``. It serves
on the card; with no card it refuses to boot unless
``SERVE_DEVICE_FALLBACK=cpu``, which serves on the host CPU with the abuse
path under ``ABUSE_CPU_POLICY`` (default ``heuristic``), as the reference
does. ``FRAUD_MODEL_PATH`` boots a trained multitask checkpoint from its
``.npz`` (``resolve_model_boot``). The other /debug pages, /metrics, the
supervisor, the online loop and the batch-feature refresh are not ported
yet (``ROADMAP.md``).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from igaming_platform_tpu_torch.convert import from_jax_params, load_params_tree
from igaming_platform_tpu_torch.core.config import RiskServiceConfig
from igaming_platform_tpu_torch.core.features import NUM_FEATURES
from igaming_platform_tpu_torch.obs import drift as drift_mod
from igaming_platform_tpu_torch.serve.abuse import SequenceAbuseDetector
from igaming_platform_tpu_torch.serve.bridge import ScoringBridge
from igaming_platform_tpu_torch.serve.events import InMemoryBroker, resolve_transport
from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore
from igaming_platform_tpu_torch.serve import ledger as ledger_mod
from igaming_platform_tpu_torch.serve.grpc_server import (
    HealthServicer,
    RiskGrpcService,
    graceful_stop,
    serve_risk,
)
from igaming_platform_tpu_torch.serve.native_store import NativeFeatureStore
from igaming_platform_tpu_torch.serve.scorer import ScoreRequest, TorchScoringEngine

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
    engine: TorchScoringEngine
    abuse: SequenceAbuseDetector
    bridge: ScoringBridge
    service: RiskGrpcService
    ledger: ledger_mod.DecisionLedger | None = None


def assemble_risk_service(config: RiskServiceConfig | None = None, *, ml_backend: str = "mock",
                          params=None, feature_store=None, abuse_params=None,
                          broker: InMemoryBroker | None = None, device: str = "cuda",
                          abuse_policy: str = "model", warmup: bool = True,
                          feature_cache: bool | int | None = None,
                          session_state: bool | None = None) -> AssembledService:
    """Build the store (``config.feature_store``, unless one is given), the
    engine, the abuse detector (``abuse_policy``), the bridge and the
    RiskGrpcService, on ``device``. ``feature_cache`` and ``session_state``
    go to the engine (None: its environment knobs). With ``LEDGER_DIR`` set,
    opens the decision ledger there and binds it to the engine; whoever
    does not hand the assembly to a ``RiskServer`` closes it. Binds no
    transport."""
    config = config or RiskServiceConfig.from_env()
    ml_backend, params = resolve_model_boot(config, ml_backend, params)
    store = feature_store if feature_store is not None else make_feature_store(config.feature_store)
    engine = TorchScoringEngine(config.scoring, ml_backend=ml_backend, params=params,
                                batcher_config=config.batcher, feature_store=store,
                                device=device, warmup=warmup, feature_cache=feature_cache,
                                session_state=session_state)
    abuse = SequenceAbuseDetector(params=abuse_params, policy=abuse_policy, device=device)
    bridge = ScoringBridge(engine, resolve_transport(broker, config.rabbitmq_url),
                           abuse_detector=abuse)
    service = RiskGrpcService(engine, abuse_detector=abuse.check,
                              rate_limit_per_minute=config.rate_limit_per_minute)
    ledger = None
    ledger_dir = os.environ.get("LEDGER_DIR", "")
    if ledger_dir:
        ledger = ledger_mod.DecisionLedger(ledger_dir, sink=ledger_mod.sink_from_env())
        engine.ledger = ledger
        logger.info("decision ledger at %s (sink=%s)", ledger_dir,
                    os.environ.get("LEDGER_SINK", "") or "none")
    return AssembledService(config, engine, abuse, bridge, service, ledger)


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
        config = assembled.config
        grpc_port = config.grpc_port if grpc_port is None else grpc_port
        self.grpc_server, self.grpc_port = None, None
        self.health = HealthServicer()
        if grpc_port >= 0:
            self.grpc_server, self.health, self.grpc_port = serve_risk(self.service, grpc_port)
        self._stopped = threading.Event()
        self._probe_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="device-probe")
        self.http_server, self.http_port = self._start_http(
            config.http_port if http_port is None else http_port)
        self.bridge.start()
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

    # -- HTTP sidecar (main.go:160-202 equivalent) ---------------------------

    def _start_http(self, port: int):
        server_ref = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, code: int, body: str):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                if self.path == "/health":
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
                    cache = server_ref.engine.cache
                    if cache is None:
                        self._send(404, '{"error":"feature cache disabled"}')
                        return
                    snap = cache.stats()
                    snap["shards"] = cache.shard_stats()
                    if server_ref.engine.session is not None:
                        snap["session_shards"] = server_ref.engine.session.shard_stats()
                    self._send(200, json.dumps(snap))
                elif self.path == "/debug/sessionz":
                    session = server_ref.engine.session
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
                    shadow = server_ref.engine.shadow
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
                if self.path == "/debug/thresholds":
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
                else:
                    self._send(404, '{"error":"not found"}')

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
        """NOT_SERVING, stop the bridge, drain gRPC, then close the engine
        (batcher and host pipeline), close the ledger (every admitted
        decision is noted by then; its WAL is flushed and its sink given a
        bounded catch-up), drain the shadow scorer and the drift engine
        (every scored batch folded), close the service (which closes the
        drift engine), then stop the sidecar."""
        self._stopped.set()
        self.bridge.stop()
        graceful_stop(self.grpc_server, self.health, grace, engine=self.engine)
        if self.ledger is not None:
            self.ledger.close()
        if self.engine.shadow is not None:
            self.engine.shadow.drain()
        if self.service.drift is not None:
            self.service.drift.drain()
        self.service.close()
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
