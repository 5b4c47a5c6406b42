"""Port parity: obs/runtime_telemetry.py and the launch chokepoint.

Every step a scoring path launches goes through the port's
``serve/scorer._device_dispatch``, as every jit launch of the JAX engine goes
through its own. Over the five paths of tests/test_fused_graph.py (row,
batch, wire lockstep, wire pipelined, index with session), with drift and a
live shadow bound, fused and split, the port's dispatch counter moves by
what the JAX engine's moves. The step-time detectors flag the same samples
of a duration series, signatures are new exactly once, the profile cooldown
holds, and ``/debug/telemetryz`` answers with the JAX page's keys.
"""

import json
import os
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
from test_fused_graph import NOW0, _drift, _engine, _mlp_params, _rows, _wait_ready
from torch_front_common import jax_native_libs, no_jax_hostprof, port_sidecar  # noqa: F401

from igaming_platform_tpu.obs import runtime_telemetry as jrt
from igaming_platform_tpu.obs import tracing as jtracing
from igaming_platform_tpu.serve.scorer import ScoreRequest as JRequest
from igaming_platform_tpu.serve.shadow import ShadowScorer as JShadow
from igaming_platform_tpu_torch.convert import from_jax_params
from igaming_platform_tpu_torch.core.config import BatcherConfig, ScoringConfig
from igaming_platform_tpu_torch.obs import drift as pdrift
from igaming_platform_tpu_torch.obs import runtime_telemetry as prt
from igaming_platform_tpu_torch.obs import tracing as ptracing
from igaming_platform_tpu_torch.serve.scorer import ScoreRequest, TorchScoringEngine
from igaming_platform_tpu_torch.serve.shadow import ShadowScorer

PATHS = ("row", "batch", "wire_lockstep", "wire_pipelined", "index_session")


def _paths(eng, request_cls, accts):
    reqs = [request_cls(f"dc-{i}", amount=900 + i) for i in range(10)]
    return {
        "row": lambda: eng.score(reqs[0]),
        "batch": lambda: eng.score_batch(list(reqs)),
        "wire_lockstep": lambda: eng._score_rows_encode(
            _rows(10), np.zeros((10,), bool), False, time.monotonic()),
        "wire_pipelined": lambda: eng._score_rows_to_wire(
            _rows(23), np.zeros((23,), bool), False, time.monotonic()),
        "index_session": lambda: eng.score_columns_cached(
            accts, [60.0] * 10, ["deposit"] * 10, now=NOW0 + 30),
    }


def _count_paths(telemetry, eng, shadow, drift, request_cls) -> dict:
    """Dispatches counted per path, after the cache slots are warm and every
    straggler of the shadow and drift workers has drained."""
    accts = [f"dc-{i}" for i in range(10)]
    eng.score_columns_cached(accts, [50.0] * 10, ["bet"] * 10, now=NOW0)
    counts = {}
    for name, run in _paths(eng, request_cls, accts).items():
        assert shadow.drain(30.0) and drift.drain(10.0)
        before = telemetry.dispatches_total
        run()
        assert shadow.drain(30.0) and drift.drain(10.0)
        counts[name] = telemetry.dispatches_total - before
    return counts


def _jax_counts(fused: bool) -> dict:
    prev = jrt.get_default()
    if prev is not None:
        jtracing.remove_span_sink(prev.observe_span)
    telemetry = jrt.RuntimeTelemetry()
    jrt.DEFAULT = telemetry
    eng = _engine(_mlp_params(0), fused=fused, batch=16, tiers=(8,), cache=32, session=True)
    eng.ensure_cache()
    drift = _drift()
    eng.bind_drift(drift)
    shadow = JShadow(eng, _mlp_params(1))
    eng.shadow = shadow
    try:
        if fused:
            assert _wait_ready(eng, ("packed", True, True))
            assert _wait_ready(eng, ("session", True, True))
        return _count_paths(telemetry, eng, shadow, drift, JRequest)
    finally:
        shadow.close()
        eng.close()
        drift.close()
        jrt.DEFAULT = prev
        if prev is not None:
            jtracing.add_span_sink(prev.observe_span)


def _port_counts(fused: bool, monkeypatch) -> dict:
    monkeypatch.setenv("FUSED", "1" if fused else "0")
    prev = prt.get_default()
    telemetry = prt.RuntimeTelemetry()
    prt.DEFAULT = telemetry
    eng = TorchScoringEngine(
        ScoringConfig(), ml_backend="mlp", params=from_jax_params("mlp", _mlp_params(0)),
        batcher_config=BatcherConfig(batch_size=16, latency_tiers=(8,), max_wait_ms=1.0),
        feature_cache=32, session_state=True, device="cpu")
    eng.ensure_cache()
    drift = pdrift.DriftEngine(pdrift.DriftConfig(min_rows=1, window_s=300.0))
    eng.bind_drift(drift)
    shadow = ShadowScorer(eng, from_jax_params("mlp", _mlp_params(1)))
    eng.shadow = shadow
    try:
        return _count_paths(telemetry, eng, shadow, drift, ScoreRequest)
    finally:
        shadow.close()
        eng.close()
        drift.close()
        prt.DEFAULT = prev


@pytest.mark.parametrize("fused", [True, False])
def test_dispatch_counts_per_path_match_jax(fused, monkeypatch, no_jax_hostprof):
    jax_native_libs()
    want = _jax_counts(fused)
    got = _port_counts(fused, monkeypatch)
    assert got == want, (fused, got, want)
    assert set(got) == set(PATHS) and all(v > 0 for v in got.values())


def _durations(seed: int) -> list[float]:
    """A steady step-time series with spikes, a sustained fault and a
    recovery."""
    rng = np.random.default_rng(seed)
    base = list(rng.normal(2.0, 0.2, 40).clip(0.5))
    base += [2.1, 30.0, 2.0, 1.9] + [25.0] * 5 + list(rng.normal(2.0, 0.3, 20).clip(0.5))
    base += [4.9, 6.0, 200.0]
    return [float(v) for v in base]


@pytest.mark.parametrize("seed", [0, 1])
def test_anomaly_flags_and_cooldown_match_jax(seed, monkeypatch):
    """The same duration series through both packages' telemetry (as step
    spans): the same flags, the same anomalies, the same profile captures
    under a cooldown, the same detector state."""
    clock = {"t": 1000.0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["t"])
    runs = {}
    for name, mod in (("jax", jrt), ("port", prt)):
        tel = mod.RuntimeTelemetry(cooldown_s=10.0, profile_enabled=True)
        fired = []
        tel.bind_profile_trigger(lambda trace, stage, ms, fired=fired: fired.append((trace, ms))
                                 or {"ok": True})
        flags = []
        clock["t"] = 1000.0
        for i, ms in enumerate(_durations(seed)):
            clock["t"] += 1.0
            det = tel._detectors.get("score.dispatch")
            before = tel.anomalies_total
            root = types.SimpleNamespace(attributes={}, root=None)
            tel.observe_span(types.SimpleNamespace(name="score.dispatch", duration_ms=ms,
                                                   trace_id=f"t{i}", root=root))
            flags.append(tel.anomalies_total > before)
            assert det is None or det is tel._detectors["score.dispatch"]
        snap = tel.snapshot()
        runs[name] = (flags, fired, snap["step_time"],
                      [(a["stage"], a["duration_ms"], a["trace_id"])
                       for a in snap["recent_anomalies"]],
                      [(c["trace_id"], c["ok"]) for c in snap["profile_captures"]])
    assert runs["port"] == runs["jax"]
    flags, fired = runs["port"][0], runs["port"][1]
    assert sum(flags) > len(fired) >= 2  # some anomalies only counted inside the cooldown


def test_signatures_and_compile_events_count_once(monkeypatch):
    """A signature is new exactly once, in both packages; each build or load
    the port notes is one compile event, the process's earlier ones counted
    when a telemetry is installed."""
    sigs = [("packed_step", (16, 30), "float32"), ("packed_step", (8, 30), "float32"),
            ("packed_step", (16, 30), "float32"), ("cached_step", (16,), "int64"),
            ("packed_step", (16, 30), "int8"), ("cached_step", (16,), "int64")]
    jw, pw = jrt.CompileWatcher(), prt.CompileWatcher()
    want = [jw.note_signature(*s) for s in sigs]
    got = [pw.note_signature(*s) for s in sigs]
    assert got == want == [True, True, False, True, True, False]
    assert pw.snapshot()["signatures"] == jw.snapshot()["signatures"] == 4

    monkeypatch.setattr(prt, "_COMPILE_LOG", [])
    monkeypatch.setattr(prt, "DEFAULT", None)
    prt.note_compile("nvcc_build", "gbdt_forest", 1234.5)
    prt.note_compile("library_load", "gbdt_forest", 0.5)
    tel = prt.install()
    try:
        prt.note_compile("native_load", "wire_codec", 0.25)
        snap = tel.compile_watcher.snapshot()
        assert snap["compiles_total"] == 3 == len(prt.compile_log())
        assert snap["compile_wall_ms_total"] == 1235.25
        assert [e["kind"] for e in snap["recent_events"]] == [
            "nvcc_build", "library_load", "native_load"]
        assert set(snap) == set(jrt.CompileWatcher().snapshot())
    finally:
        prt.uninstall()


def _keys(obj, prefix=""):
    """The nested key paths of a JSON object (list items by their first)."""
    out = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.add(prefix + k)
            out |= _keys(v, prefix + k + ".")
    elif isinstance(obj, list) and obj:
        out |= _keys(obj[0], prefix + "[].")
    return out


def test_telemetryz_page_has_the_jax_keys(monkeypatch, no_jax_hostprof):
    """GET /debug/telemetryz on a port server after some traffic: the keys of
    ``RuntimeTelemetry.snapshot()`` of the JAX package, the arena included;
    ``/metrics`` counts the dispatches and signatures; 404 with the plane
    off."""
    jtel = jrt.RuntimeTelemetry()
    jtel.bind_engine(types.SimpleNamespace(
        pipeline=types.SimpleNamespace(arena_stats=lambda: {"allocated": 1})))
    want = set(jtel.snapshot())
    with port_sidecar(monkeypatch) as (server, url):
        server.service.call("ScoreBatch", _batch_bytes(40))
        with urllib.request.urlopen(f"{url}/debug/telemetryz", timeout=30) as resp:
            page = json.loads(resp.read())
        with urllib.request.urlopen(f"{url}/metrics", timeout=30) as resp:
            metrics = resp.read().decode()
    assert set(page) == want
    assert page["dispatches_total"] > 0 and page["compile"]["signatures"] > 0
    assert "risk_device_dispatches_total " in metrics
    assert "risk_compile_signatures_total 0.0" not in metrics
    monkeypatch.setenv("RUNTIME_TELEMETRY", "0")
    with port_sidecar(monkeypatch) as (server, url):
        assert server.service.telemetry is None and prt.get_default() is None
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{url}/debug/telemetryz", timeout=30)
        assert exc.value.code == 404
    assert os.environ.get("RUNTIME_TELEMETRY") == "0"


def _batch_bytes(n: int) -> bytes:
    from igaming_platform_tpu_torch.serve import risk_codec as codec

    txs = [{"account_id": f"acct{i % 7}", "amount": 1000 + 17 * i, "transaction_type": "bet"}
           for i in range(n)]
    return codec.encode(codec.SCORE_BATCH_REQUEST, {"transactions": txs})


def test_root_span_carries_dispatches():
    """``note_dispatch`` inside an RPC root stamps its ``dispatches``, as the
    flight entry shows it."""
    tel = prt.RuntimeTelemetry()
    with ptracing.span("rpc.ScoreBatch") as root:
        with ptracing.span("score.dispatch"):
            tel.note_dispatch()
            tel.note_dispatch(2)
    assert root.attributes["dispatches"] == 3 and tel.dispatches_total == 3
