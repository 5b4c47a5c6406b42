"""OTLP/HTTP span export — the Jaeger wiring the reference deploys but
never feeds.

The port's copy of ``igaming_platform_tpu/obs/otlp.py`` (pure Python, kept apart so
the port imports nothing of the JAX package).

The reference ships Jaeger with OTLP ports open and carries OTel as
indirect deps (go.mod:38-39), yet no code emits spans (SURVEY.md §5).
Here the host-side span ring (obs/tracing.py) drains to an OTLP/HTTP
endpoint as protobuf-JSON (`/v1/traces`, the encoding Jaeger's OTLP
receiver accepts) — no OTel SDK in the image, so the envelope is built
directly.

Enabled by OTEL_EXPORTER_OTLP_ENDPOINT (e.g. http://jaeger:4318); when
set, the risk service starts an exporter thread. While the exporter
runs it owns the collector's spans (drain), so /debug/spans shows only
spans since the last export flush.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import urllib.error
import urllib.request
import uuid

from igaming_platform_tpu_torch.obs.tracing import DEFAULT_COLLECTOR, Span, SpanCollector

logger = logging.getLogger(__name__)

ENDPOINT_ENV = "OTEL_EXPORTER_OTLP_ENDPOINT"


def _attr(key: str, value) -> dict:
    if isinstance(value, bool):
        v = {"boolValue": value}
    elif isinstance(value, int):
        v = {"intValue": str(value)}
    elif isinstance(value, float):
        v = {"doubleValue": value}
    else:
        v = {"stringValue": str(value)}
    return {"key": key, "value": v}


def encode_spans(spans: list[Span], service_name: str) -> dict:
    """ExportTraceServiceRequest as OTLP protobuf-JSON."""
    return {
        "resourceSpans": [{
            "resource": {"attributes": [_attr("service.name", service_name)]},
            "scopeSpans": [{
                "scope": {"name": "igaming-platform-tpu", "version": "1.0"},
                "spans": [
                    {
                        # OTLP wants 16-byte (32 hex) trace ids and 8-byte
                        # span ids; the collector's are that shape already,
                        # but legacy 16-hex trace ids are padded.
                        "traceId": (s.trace_id or uuid.uuid4().hex[:16]).ljust(32, "0"),
                        "spanId": getattr(s, "span_id", "") or uuid.uuid4().hex[:16],
                        "name": s.name,
                        "kind": 1,  # SPAN_KIND_INTERNAL
                        "startTimeUnixNano": str(int(s.start * 1e9)),
                        "endTimeUnixNano": str(int((s.end or s.start) * 1e9)),
                        "attributes": [_attr(k, v) for k, v in s.attributes.items()],
                        # Parent linkage: Jaeger renders the stage spans
                        # UNDER their rpc.* root (and, with traceparent
                        # propagation, under the remote caller's span).
                        **({"parentSpanId": s.parent_id}
                           if getattr(s, "parent_id", "") else {}),
                    }
                    for s in spans
                ],
            }],
        }]
    }


class OtlpExporter:
    """Background drain of a SpanCollector to an OTLP/HTTP endpoint.

    Export failures are logged and the batch is DROPPED (spans are
    diagnostics, not ledger data — unbounded buffering on a dead Jaeger
    would trade memory for telemetry)."""

    def __init__(
        self,
        endpoint: str,
        service_name: str,
        *,
        collector: SpanCollector | None = None,
        interval_s: float = 5.0,
        timeout_s: float = 5.0,
    ):
        self.endpoint = endpoint.rstrip("/") + "/v1/traces"
        self.service_name = service_name
        self.collector = collector or DEFAULT_COLLECTOR
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.exported_total = 0
        self.failed_batches = 0
        # Metrics hook: the service layer binds this to its
        # <service>_otlp_export_failures_total counter so export loss is
        # on /metrics, not only in logs.
        self.on_failure = None  # callable(n_failed_batches: int) | None
        # flush() runs on BOTH the exporter thread (_run) and the
        # caller's thread (stop()'s final drain, manual flushes); the
        # counter read-modify-writes need a guard or two concurrent
        # flushes lose updates.
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "OtlpExporter":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="otlp-exporter", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.flush()  # final drain so shutdown doesn't lose the tail

    def flush(self) -> int:
        spans = self.collector.drain()
        if not spans:
            return 0
        body = json.dumps(encode_spans(spans, self.service_name)).encode()
        req = urllib.request.Request(
            self.endpoint, data=body, method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
        except (urllib.error.URLError, OSError) as exc:
            with self._stats_lock:
                self.failed_batches += 1
            if self.on_failure is not None:
                try:
                    self.on_failure(1)
                except Exception:  # noqa: BLE001 — metrics must not kill export
                    pass
            logger.warning("OTLP export failed (%d spans dropped): %s", len(spans), exc)
            return 0
        with self._stats_lock:
            self.exported_total += len(spans)
        return len(spans)

    def _run(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(self.interval_s)  # noqa: CC05 — fixed-cadence export ticker, not a retry backoff
            try:
                self.flush()
            except Exception:  # noqa: BLE001 — exporter must not die
                logger.warning("OTLP flush crashed", exc_info=True)


def exporter_from_env(service_name: str) -> OtlpExporter | None:
    """Start an exporter when OTEL_EXPORTER_OTLP_ENDPOINT is set."""
    endpoint = os.environ.get(ENDPOINT_ENV, "").strip()
    if not endpoint:
        return None
    return OtlpExporter(endpoint, service_name).start()
