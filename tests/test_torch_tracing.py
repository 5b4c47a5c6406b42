"""Port parity: obs/tracing.py, obs/flight.py, obs/otlp.py and the engine's
stage spans.

One ScoreBatch (three chunks through the host pipeline) and one
ScoreTransaction go through the JAX package's RPC wrapper and the port's
``call`` (``tests/torch_front_common.py::PlanePair``: supervised CPU
engines, the same store and params, a decision ledger each), with a
``traceparent`` on the ScoreBatch. The spans each package collected form
the same trees: the same names, nesting and ``code`` attributes under each
``rpc.*`` root (the supervisor's pool and the pipeline's workers carry the
root across threads), and the same batch-level roots of the batcher's
thread. The roots adopt the caller's trace id and parent span id; the
flight entries have the same keys (``decision_id`` among them) and
``stage_breakdown`` the same stages; ``encode_spans`` of the spans is equal
but for ids and times. The W3C header parse and format agree on good and
malformed headers, and ``carry`` re-enters a span on another thread in both.
The JAX side runs with its host profiler off (``no_jax_hostprof``).
"""

import threading

import pytest
from torch_front_common import PlanePair, requests
from torch_front_common import no_jax_hostprof  # noqa: F401 — a fixture

from igaming_platform_tpu.obs import flight as jflight
from igaming_platform_tpu.obs import otlp as jotlp
from igaming_platform_tpu.obs import tracing as jtracing
from igaming_platform_tpu.proto_gen.risk.v1 import risk_pb2
from igaming_platform_tpu_torch.obs import flight as pflight
from igaming_platform_tpu_torch.obs import otlp as potlp
from igaming_platform_tpu_torch.obs import tracing as ptracing

TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
PARENT = "00f067aa0ba902b7"
PKGS = ((jtracing, jflight, jotlp), (ptracing, pflight, potlp))


def _tree(spans, root) -> tuple:
    """(name, code, sorted children) of ``root``: sibling order is thread
    timing, not structure."""
    kids = sorted(_tree(spans, s) for s in spans if s.parent_id == root.span_id)
    return root.name, root.attributes.get("code"), tuple(kids)


def _forest(spans) -> list:
    ids = {s.span_id for s in spans}
    return sorted(_tree(spans, s) for s in spans if s.parent_id not in ids)


def _scrub(doc):
    """An OTLP document with ids, times and random-valued attributes blanked."""
    for rs in doc["resourceSpans"]:
        for ss in rs["scopeSpans"]:
            for s in ss["spans"]:
                for key in ("traceId", "spanId", "parentSpanId", "startTimeUnixNano",
                            "endTimeUnixNano"):
                    if key in s:
                        s[key] = "-"
                s["attributes"] = sorted(
                    (a["key"], "-" if a["key"] == "decision_id" else a["value"])
                    for a in s["attributes"])
            ss["spans"].sort(key=lambda s: (s["name"], repr(s["attributes"])))
    return doc


def test_span_trees_flight_and_otlp_match_jax(tmp_path, monkeypatch, no_jax_hostprof):
    tx = risk_pb2.ScoreTransactionRequest(**requests(4, 1, 40)[0]).SerializeToString()
    batch = risk_pb2.ScoreBatchRequest(transactions=[
        risk_pb2.ScoreTransactionRequest(**r) for r in requests(8, 150, 40)]).SerializeToString()
    header = (("traceparent", f"00-{TRACE}-{PARENT}-01"),)
    pair = PlanePair(monkeypatch, tmp_path)
    try:
        for side in (0, 1):  # warm: the first calls build the pipeline
            pair.call(side, "ScoreBatch", batch)
            pair.call(side, "ScoreTransaction", tx)
        seen = []
        for side, (tracing, flight, otlp) in enumerate(PKGS):
            tracing.DEFAULT_COLLECTOR.drain()
            flight.DEFAULT_RECORDER.clear()
            assert pair.call(side, "ScoreBatch", batch, header) == "OK"
            assert pair.call(side, "ScoreTransaction", tx) == "OK"
            spans = tracing.DEFAULT_COLLECTOR.drain()
            entries = flight.DEFAULT_RECORDER.snapshot()
            seen.append((spans, entries, otlp.encode_spans(spans, "risk")))
    finally:
        pair.close()
    (jspans, jentries, jdoc), (pspans, pentries, pdoc) = seen
    assert _forest(pspans) == _forest(jspans)
    roots = {s.name: s for s in pspans if s.name.startswith("rpc.")}
    assert roots["rpc.ScoreBatch"].trace_id == TRACE
    assert roots["rpc.ScoreBatch"].parent_id == PARENT
    names = {s.name for s in pspans if s.trace_id == TRACE}
    assert {"score.admission", "score.decode", "score.dispatch", "score.readback",
            "score.encode"} <= names
    assert [e["method"] for e in pentries] == [e["method"] for e in jentries]
    assert [sorted(e) for e in pentries] == [sorted(e) for e in jentries]
    assert all(e.get("decision_id") for e in pentries)
    for method in ("ScoreBatch", "ScoreTransaction"):
        got = pflight.stage_breakdown(pentries, method)
        want = jflight.stage_breakdown(jentries, method)
        assert sorted(got) == sorted(want) and sorted(got["stages"]) == sorted(want["stages"])
    assert _scrub(pdoc) == _scrub(jdoc)


@pytest.mark.parametrize("header", [
    f"00-{TRACE}-{PARENT}-01", f"00-{TRACE}-{PARENT}-00", "ff-" + TRACE + "-" + PARENT + "-01",
    f"00-{'0' * 32}-{PARENT}-01", f"00-{TRACE}-{'0' * 16}-01", "garbage", "", None,
    f" 00-{TRACE}-{PARENT}-01 ", f"00-{TRACE.upper()}-{PARENT}-01"])
def test_traceparent_and_carry_match_jax(header):
    assert ptracing.parse_traceparent(header) == jtracing.parse_traceparent(header)
    parsed = ptracing.parse_traceparent(header)
    if parsed is not None:
        assert ptracing.format_traceparent(*parsed) == jtracing.format_traceparent(*parsed)
        assert ptracing.parse_traceparent(ptracing.format_traceparent(*parsed)) == parsed
    trees = []
    for tracing in (jtracing, ptracing):
        tracing.DEFAULT_COLLECTOR.drain()
        with tracing.span("rpc.ScoreTransaction", traceparent=header) as root:
            assert tracing.current_traceparent() == tracing.format_traceparent(
                root.trace_id, root.span_id)

            def work(parent=tracing.current_span(), tracing=tracing):
                with tracing.carry(parent), tracing.span("score.gather", batch=3):
                    tracing.set_root_attribute("rows", 3)

            t = threading.Thread(target=work)
            t.start()
            t.join()
            root.attributes["code"] = "OK"
        spans = tracing.DEFAULT_COLLECTOR.drain()
        assert root.stage_totals and "score.gather" in root.stage_totals
        assert (root.trace_id == parsed[0]) if parsed else len(root.trace_id) == 32
        trees.append((_forest(spans), root.attributes, parsed and root.parent_id))
    assert trees[1] == trees[0]


@pytest.mark.parametrize("in_span", [False, True])
def test_json_log_lines_match_jax(in_span):
    """``utils/logging.py``: the same JSON line as the JAX formatter, with
    the key-value context; inside a span the port's line also carries the
    span's trace id."""
    import contextlib
    import json
    import logging

    from igaming_platform_tpu.utils import logging as jlog
    from igaming_platform_tpu_torch.utils import logging as plog

    record = logging.LogRecord("risk", logging.WARNING, __file__, 7, "scored %d", (3,), None)
    record.kv = {"account": "acct1"}
    lines, root = [], None
    for mod in (jlog, plog):
        with contextlib.ExitStack() as stack:
            stack.enter_context(mod.log_context(rpc="ScoreBatch"))
            if in_span:
                root = stack.enter_context(ptracing.span("rpc.ScoreBatch"))
            lines.append(json.loads(mod.JSONFormatter(include_source=True).format(record)))
    jline, pline = lines
    assert pline.pop("trace_id", None) == (root.trace_id if in_span else None)
    assert pline == jline and jline["rpc"] == "ScoreBatch" and jline["account"] == "acct1"
