"""Port parity: obs/runtime_telemetry.py and the launch chokepoint.

Every step a scoring path launches goes through the port's
``serve/scorer._device_dispatch``, as every jit launch of the JAX engine goes
through its own. Over the five paths of tests/test_fused_graph.py (row,
batch, wire lockstep, wire pipelined, index with session), with drift and a
live shadow bound, fused and split, the port's dispatch counter moves by
what the JAX engine's moves. The step-time detectors flag the same samples
of a duration series, signatures are new exactly once, the profile cooldown
holds, and ``/debug/telemetryz`` answers with the JAX page's keys. An
armed device timeline (the automatic anomaly capture, obs/devtrace.py) marks
every launched step and every kernel wrapper's call, and its trace holds them
to the counters; the anomaly trigger returns before the writer runs.
"""

import json
import os
import threading
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
from igaming_platform_tpu_torch.obs import devtrace, perfmodel
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


def _trace_counts(path) -> tuple[dict, dict, dict]:
    """(kernel events by name, step events by name, the window object) of a
    device timeline's Chrome trace; every mark has a duration."""
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    by = {"kernel": {}, "step": {}}
    for ev in trace["traceEvents"]:
        if ev.get("cat") in by:
            assert ev["dur"] >= 0 and "incomplete" not in ev["args"], ev
            by[ev["cat"]][ev["name"]] = by[ev["cat"]].get(ev["name"], 0) + 1
    return by["kernel"], by["step"], trace["window"]


@pytest.mark.parametrize("marks", ["engine_and_detector", "synthetic"])
def test_armed_timeline_marks_every_step_and_kernel_call(marks, monkeypatch, tmp_path):
    """While a timeline is armed, the CPU engine's ``score_batch`` and the
    detector's ``check_batch`` (or a large synthetic window): one kernel
    event per wrapper call, by name, on the host clock (the CPU launches no
    kernel: every launch counter stays put), one step event per dispatch the
    counter counts, the root's trace id on each; the trace is valid JSON,
    written in more than one slice."""
    from igaming_platform_tpu_torch.models.sequence import SeqConfig
    from igaming_platform_tpu_torch.serve.abuse import SequenceAbuseDetector

    calls: dict = {}
    note_work = perfmodel.note_work
    monkeypatch.setattr(perfmodel, "note_work", lambda name, *a: (
        calls.__setitem__(name, calls.get(name, 0) + 1), note_work(name, *a))[1])
    tel = prt.RuntimeTelemetry()
    monkeypatch.setattr(prt, "DEFAULT", tel)
    if marks == "engine_and_detector":
        rng = np.random.default_rng(7)
        dims = (30, 16, 16, 1)
        tree = {"mlp": {"layers": [{"w": rng.normal(size=(a, b)).astype(np.float32) * 0.3,
                                    "b": rng.normal(size=(b,)).astype(np.float32) * 0.05}
                                   for a, b in zip(dims[:-1], dims[1:])]},
                "gbdt": {"feat": rng.integers(0, 30, (8, 3)).astype(np.int32),
                         "thr": rng.random((8, 3)).astype(np.float32),
                         "leaves": rng.normal(size=(8, 8)).astype(np.float32) * 0.1,
                         "bias": np.float32(0.1)}}
        eng = TorchScoringEngine(ScoringConfig(), ml_backend="mlp+gbdt",
                                 params=from_jax_params("mlp+gbdt", tree), device="cpu",
                                 batcher_config=BatcherConfig(batch_size=32, latency_tiers=(8,),
                                                              max_wait_ms=1.0))
        det = SequenceAbuseDetector(cfg=SeqConfig(d_model=16, n_heads=2, n_layers=2, d_ff=32),
                                    device="cpu")
        for i in range(6):
            det.record_event("acct1", 500 + i, "bet", timestamp=NOW0 + i)

        def drive():
            eng.score_batch([ScoreRequest(f"acct{i % 5}", amount=100 + 37 * i) for i in range(40)])
            det.check_batch(["acct1", "acct2", "acct3"])
    else:
        def drive():
            for i in range(3000):
                devtrace.plain("gbdt_forest", perfmodel.note_work, "gbdt_forest", 0.0, 0.0)
                with prt.note_dispatch(step=("packed_step", (8, 30), "cpu")):
                    pass
    launches0, dispatches0 = devtrace.counters(), tel.dispatches_total
    monkeypatch.setattr(devtrace, "SLICE_PAUSE_S", 0.0)  # hundreds of slices here
    tl = devtrace.DeviceTimeline(tel)
    tl.arm()
    calls.clear()
    with ptracing.span("rpc.Test") as root:
        drive()
    tl.disarm()
    if marks == "engine_and_detector":
        eng.close()
    window = tl.write(str(tmp_path / "trace.json"), slice_events=8)
    kernels, steps, written = _trace_counts(tmp_path / "trace.json")
    assert written == window and window["slices"] > 1 and window["unresolved"] == 0
    assert kernels == window["kernel_events"] == calls and {"gbdt_forest"} <= set(kernels)
    if marks == "engine_and_detector":
        assert {"dense", "dense_f32", "flash_attention_fwd"} <= set(kernels)
    assert sum(steps.values()) == window["dispatches"] == tel.dispatches_total - dispatches0 > 0
    assert devtrace.counters() == launches0 and window["launches"] == {}
    with open(tmp_path / "trace.json", encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert {ev["args"]["trace_id"] for ev in events if ev.get("cat") in ("kernel", "step")} \
        == {root.trace_id}
    assert "rpc.Test" in {ev["name"] for ev in events if ev.get("cat") == "span"}
    assert devtrace.ARMED is None


@pytest.mark.parametrize("fault", ["library", "entry", "refused"])
def test_failed_launch_leaves_counter_and_window(fault, monkeypatch, tmp_path):
    """A kernel launch whose library fails to load, whose entry point raises
    or whose kernel refuses it raises to its caller, and leaves the launch
    counters and an armed window as they were: the window still closes and
    its writer waits for no mark of it. (Here the dense wrapper's launch
    path runs on CPU tensors, with CUDA's device and stream stubbed.)"""
    import contextlib
    import ctypes

    import torch

    from igaming_platform_tpu_torch.ops import dense as dense_mod

    def entry(*args):
        if fault == "entry":
            raise ctypes.ArgumentError("argument 1: wrong type")
        return 2

    def lib():
        if fault == "library":
            raise OSError("dense_fixed: build failed")
        return types.SimpleNamespace(dense_bf16_launch=entry)

    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(dense_mod, "_lib", lib)
    x, w, b = torch.ones(4, 8), torch.ones(8, 3), torch.zeros(3)
    launches0 = devtrace.counters()
    tl = devtrace.DeviceTimeline()
    tl.arm()
    try:
        with pytest.raises((OSError, ctypes.ArgumentError, RuntimeError)):
            dense_mod._launch("dense_bf16_launch", dense_mod.dense, "dense", x, w, b)
    finally:
        tl.disarm()
    assert len(tl.marks) == (0 if fault == "library" else 1)
    window = tl.write(str(tmp_path / "trace.json"))
    kernels, steps, written = _trace_counts(tmp_path / "trace.json")
    assert devtrace.counters() == launches0 and devtrace.ARMED is None
    assert window == written and window["launches"] == {} and window["unresolved"] == 0
    assert kernels == window["kernel_events"] == {} and steps == {}


def test_anomaly_trigger_returns_at_once_and_records_the_trace(monkeypatch, tmp_path):
    """The server's anomaly trigger on a serving thread returns the JAX
    hook's record at once; while the capture's writer is held, the thread
    goes on serving; then the record gains ``ok``, ``log_dir`` and
    ``trace`` (the JAX server adds ``ok``, ``log_dir`` and a TensorBoard
    ``hint``), the directory carries the trace id and the trace's step
    events equal the dispatches counted in its window."""
    monkeypatch.setenv("ANOMALY_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("ANOMALY_PROFILE_SECONDS", "0.3")
    monkeypatch.delenv("ANOMALY_PROFILE", raising=False)
    held = threading.Event()
    write = devtrace.DeviceTimeline.write
    monkeypatch.setattr(devtrace.DeviceTimeline, "write",
                        lambda self, *a, **k: (held.wait(60), write(self, *a, **k))[1])
    trace_id = "4bf92f3577b34da6a3ce929d0e0e4736"
    jtel = jrt.RuntimeTelemetry(profile_enabled=True)
    jtel.bind_profile_trigger(lambda trace, stage, ms: {"seconds": 0.3, "async": True})
    jtel._maybe_profile(trace_id, "score.dispatch", 42.0)
    with port_sidecar(monkeypatch) as (server, url):
        tel = server.telemetry
        tel._maybe_profile(trace_id, "score.dispatch", 42.0)
        record = tel.profile_captures[-1]
        assert set(record) == set(jtel.profile_captures[-1]) and "trace" not in record
        server.service.call("ScoreBatch", _batch_bytes(40))
        assert "trace" not in record and server._profile_lock.locked()
        held.set()
        for _ in range(600):
            if "trace" in record or "error" in record:
                break
            time.sleep(0.05)
    assert set(record) == set(jtel.profile_captures[-1]) | {"ok", "log_dir", "trace"}, record
    assert trace_id[:32] in os.path.basename(record["log_dir"])
    _, steps, window = _trace_counts(record["trace"])
    assert sum(steps.values()) == window["dispatches"] > 0 and steps.get("packed_step")
