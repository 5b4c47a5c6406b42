"""Wallet service process layer.

Equivalent of services/wallet/cmd/main.go:66-230: config ->
repositories (``DATABASE_URL``: Postgres, SQLite or in-memory) -> risk gate
(an in-process engine or a risk.v1 gRPC client) -> wallet service -> gRPC
server + health -> HTTP sidecar (/metrics, /health, /ready, /debug/spans,
/debug/reconciliation) -> graceful shutdown. The reference's commented-out
service wiring (main.go:112-134) is implemented.

The port's copy of ``igaming_platform_tpu/platform/server.py``. One
difference: ``grpc_port=None`` binds no gRPC server (the JAX server reads
None as "the config's port"); a caller without grpcio, as on the card's
machine, passes it and drives ``server.grpc_service.call(method, bytes)``.
Left out, the port's default binds ``GRPC_PORT`` and raises without grpcio.
``risk_gate`` defaults as in JAX: a ``GrpcRiskGate`` when
``RISK_SERVICE_ADDR`` is set; ``platform/risk_adapter.InProcessRiskGate``
over a ``TorchScoringEngine`` gates on the card in-process. Run it as
``DATABASE_URL=postgres://… python -m igaming_platform_tpu_torch.platform.server``.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from igaming_platform_tpu_torch.core.config import WalletServiceConfig
from igaming_platform_tpu_torch.obs.metrics import ServiceMetrics
from igaming_platform_tpu_torch.platform.repository import (
    InMemoryAccountRepository,
    InMemoryLedgerRepository,
    InMemoryTransactionRepository,
    store_from_url,
)
from igaming_platform_tpu_torch.platform.wallet import WalletConfig, WalletService
from igaming_platform_tpu_torch.platform.outbox import InMemoryOutbox, OutboxPublisher, OutboxRelay
from igaming_platform_tpu_torch.platform.reconcile import ReconciliationJob, Reconciler
from igaming_platform_tpu_torch.serve.events import InMemoryBroker, make_relay_target, resolve_transport
from igaming_platform_tpu_torch.serve.grpc_server import (
    HealthServicer,
    WalletGrpcService,
    graceful_stop,
    serve_wallet,
)

logger = logging.getLogger(__name__)

_CONFIG_PORT = object()  # grpc_port's default: the config's GRPC_PORT


class WalletServer:
    def __init__(
        self,
        config: WalletServiceConfig | None = None,
        *,
        risk_gate=None,
        broker: InMemoryBroker | None = None,
        grpc_port=_CONFIG_PORT,
        http_port: int | None = None,
    ):
        self.config = config or WalletServiceConfig.from_env()
        self.metrics = ServiceMetrics("wallet")
        # EVENT_TRANSPORT=amqp routes the outbox relay to the real RabbitMQ
        # at RABBITMQ_URL (serve/amqp.py wire client); default stays the
        # in-process broker so single-binary runs need no infra.
        self.broker = resolve_transport(broker, self.config.rabbitmq_url)

        self.store = store_from_url(self.config.database_url)
        if self.store is not None:
            accounts, transactions, ledger = (
                self.store.accounts, self.store.transactions, self.store.ledger
            )
        else:
            accounts = InMemoryAccountRepository()
            transactions = InMemoryTransactionRepository()
            ledger = InMemoryLedgerRepository()

        if risk_gate is None and self.config.risk_service_addr:
            from igaming_platform_tpu_torch.platform.risk_adapter import GrpcRiskGate

            risk_gate = GrpcRiskGate(self.config.risk_service_addr)

        # Transactional outbox: events stage durably with the money movement
        # (SQLite deployments share the store; in-memory gets the analog) and
        # a background relay delivers them at-least-once.
        self.outbox = self.store if self.store is not None else InMemoryOutbox()
        self.outbox_relay = OutboxRelay(self.outbox, make_relay_target(self.broker))
        self.outbox_relay.start()
        self.wallet = WalletService(
            accounts, transactions, ledger,
            events=OutboxPublisher(self.outbox),
            risk=risk_gate,
            audit=self.store.audit if self.store is not None else None,
            config=WalletConfig(
                risk_threshold_block=self.config.risk_threshold_block,
                risk_threshold_review=self.config.risk_threshold_review,
            ),
        )
        # Periodic ledger reconciliation sweep (postgres.go:371-390 run as a
        # real job; mismatches audit + export as gauges).
        self.reconciler = Reconciler(
            accounts, ledger,
            audit=self.store.audit if self.store is not None else None,
            metrics=self.metrics,
        )
        self.reconcile_job = ReconciliationJob(self.reconciler, interval_s=300.0)
        self.reconcile_job.start()
        self.grpc_service = WalletGrpcService(self.wallet, metrics=self.metrics)
        if grpc_port is None:
            self.grpc_server, self.health, self.grpc_port = None, HealthServicer(), None
        else:
            self.grpc_server, self.health, self.grpc_port = serve_wallet(
                self.grpc_service,
                self.config.grpc_port if grpc_port is _CONFIG_PORT else grpc_port,
            )
        self.http_server, self.http_port = self._start_http(
            http_port if http_port is not None else self.config.http_port
        )
        # OTLP span export to Jaeger when OTEL_EXPORTER_OTLP_ENDPOINT set.
        from igaming_platform_tpu_torch.obs.otlp import exporter_from_env

        self.otlp = exporter_from_env("wallet")
        if self.otlp is not None:
            # Export loss is a metric, not just a log line.
            self.otlp.on_failure = self.metrics.otlp_export_failures_total.inc
        self._stopped = threading.Event()
        logger.info("wallet server up: grpc=%s http=%d", self.grpc_port, self.http_port)

    def _start_http(self, port: int):
        server_ref = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, code: int, body: str, content_type: str = "application/json"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/metrics":
                    self._send(200, server_ref.metrics.registry.render_text(), "text/plain")
                elif self.path == "/health":
                    self._send(200, '{"status":"healthy"}')
                elif self.path == "/ready":
                    ready = not server_ref._stopped.is_set()
                    self._send(200 if ready else 503, json.dumps({"ready": ready}))
                elif self.path == "/debug/spans":
                    from igaming_platform_tpu_torch.obs.tracing import DEFAULT_COLLECTOR
                    self._send(200, DEFAULT_COLLECTOR.to_json())
                elif self.path == "/debug/reconciliation":
                    report = server_ref.reconciler.run_once()
                    self._send(200 if report.mismatched == 0 else 500,
                               json.dumps(report.to_dict()))
                else:
                    self._send(404, '{"error":"not found"}')

        httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        threading.Thread(target=httpd.serve_forever, name="wallet-http", daemon=True).start()
        return httpd, httpd.server_address[1]

    def shutdown(self, grace: float = 30.0) -> None:
        self._stopped.set()
        graceful_stop(self.grpc_server, self.health, grace)
        self.http_server.shutdown()
        self.http_server.server_close()
        self.reconcile_job.stop()
        # Final drain before the store closes so accepted ops' events ship.
        self.outbox_relay.stop(drain=True)
        if self.otlp is not None:
            self.otlp.stop()
        if self.store is not None:
            self.store.close()

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
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    server = WalletServer()
    server.wait_for_signal()


if __name__ == "__main__":
    main()
