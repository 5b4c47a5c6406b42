"""Port parity: obs/hostprof.py, the host cost observatory, without the
reference's deadlock.

The same span sequence fed to both packages' profilers gives equal stage and
RPC blocks (µs-per-row means and percentiles) and equal metric observations;
the same GC callback sequence, under one fake clock, gives equal GC
accounting; the port's sampler never samples a thread it was not given;
``/debug/hostprofz`` answers with the JAX page's keys and takes its sampler
control. The deadlock, shown deterministically: an accumulator whose
constructor runs a collection inside ``_on_span`` (and a sample reservoir
whose iteration does, inside ``_stage_block``) hangs the JAX profiler, run
in a subprocess with a timeout, and the port's returns.
"""

import json
import os
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from torch_front_common import port_sidecar

from igaming_platform_tpu.obs import hostprof as jhp
from igaming_platform_tpu.obs import tracing as jtracing
from igaming_platform_tpu_torch.obs import hostprof as php
from igaming_platform_tpu_torch.obs import tracing as ptracing

REPO = Path(__file__).resolve().parent.parent
STAGES = ("decode", "gather", "pad", "dispatch", "readback", "encode", "ledger_note")


class _Recorder:
    """A ServiceMetrics stand-in recording every observation."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, family):
        rec = self

        class _Family:
            def observe(self, value, **labels):
                labels.pop("exemplar", None)
                rec.calls.append((family, round(value, 9), tuple(sorted(labels.items()))))

            def inc(self, value=1, **labels):
                rec.calls.append((family, value, tuple(sorted(labels.items()))))

        return _Family()


def _spans(seed: int) -> list:
    """A seeded sequence of stage spans and rpc roots (some without rows)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(400):
        if rng.random() < 0.2:
            rows = int(rng.integers(0, 5000)) if rng.random() < 0.8 else None
            out.append(types.SimpleNamespace(
                name=f"rpc.{('ScoreBatch', 'ScoreTransaction')[i % 2]}",
                duration_ms=float(rng.gamma(2.0, 3.0)),
                attributes={} if rows is None else {"rows": rows}, trace_id=f"t{i}"))
        else:
            batch = int(rng.integers(0, 4097))
            out.append(types.SimpleNamespace(
                name=f"score.{STAGES[int(rng.integers(len(STAGES)))]}",
                duration_ms=float(rng.gamma(1.5, 0.4)), attributes={"batch": batch},
                trace_id=f"t{i}"))
    out.append(types.SimpleNamespace(name="other.span", duration_ms=1.0, attributes={},
                                     trace_id="x"))
    return out


@pytest.fixture
def profilers():
    """A private profiler of each package, fed by hand (not installed), and
    the threads their rpc roots auto-register dropped afterwards."""
    before = (set(jhp.registered_threads()), set(php.registered_threads()))
    pair = (jhp.HostProfiler(enabled=True), php.HostProfiler(enabled=True))
    yield pair
    for mod, seen in zip((jhp, php), before):
        for ident in set(mod.registered_threads()) - seen:
            mod.unregister_scoring_thread(ident)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_span_sequence_gives_equal_blocks(profilers, seed):
    metrics = []
    for hp in profilers:
        hp.bind_metrics(_Recorder())
        for s in _spans(seed):
            hp._on_span(s)
        metrics.append(hp.metrics.calls)
    want, got = (hp._stage_block() for hp in profilers)
    assert got == want
    assert set(got["stages"]) == set(STAGES) and got["rpc"]["us_per_row"] is not None
    assert metrics[1] == metrics[0] and metrics[1]
    assert threading.get_ident() in php.registered_threads()


def _gc_series(metrics) -> dict:
    """The GC families of a registry's exposition: {sample: value}."""
    out = {}
    for line in metrics.registry.render_text().splitlines():
        if line.startswith("risk_gc_"):
            key, value = line.split(" # ")[0].rsplit(" ", 1)
            out[key] = float(value)
    return out


def test_gc_accounting_matches(profilers, monkeypatch):
    """The same start/stop callbacks under one fake clock, some with an rpc
    root in flight on this thread, some while the port's profiler lock is
    held (the record waits in the deque): equal collections, pause totals,
    pauses in an RPC and recent pauses (trace ids are each package's own),
    and equal GC series on each package's /metrics registry."""
    from igaming_platform_tpu.obs import metrics as jmetrics
    from igaming_platform_tpu_torch.obs import metrics as pmetrics

    rng = np.random.default_rng(5)
    events = []
    for i in range(60):
        gen = int(rng.integers(0, 3))
        events.append((i % 3 == 0, gen, int(rng.integers(1, 5000)), int(rng.integers(0, 90))))
    snaps, series = [], []
    for hp, tracing, mmod in zip(profilers, (jtracing, ptracing), (jmetrics, pmetrics)):
        hp.bind_metrics(mmod.ServiceMetrics("risk"))
        clock = {"ns": 10**12}

        def fake_ns(clock=clock):
            return clock["ns"]

        monkeypatch.setattr(time, "perf_counter_ns", fake_ns)
        for i, (in_rpc, gen, pause_us, collected) in enumerate(events):
            ctx = tracing.span("rpc.ScoreBatch") if in_rpc else tracing.span("score.idle")
            held = hp is profilers[1] and i % 7 == 3
            if held:
                hp._lock.acquire()
            with ctx:
                hp._gc_callback("start", {"generation": gen})
                clock["ns"] += pause_us * 1000
                hp._gc_callback("stop", {"generation": gen, "collected": collected})
            if held:
                assert len(hp._gc_pending) == 1
                hp._lock.release()
        monkeypatch.undo()
        snap = hp.gc_snapshot()
        for p in snap["recent_pauses"]:
            p["trace_ids"] = len(p["trace_ids"])
        snaps.append(snap)
        series.append(_gc_series(hp.metrics))
    assert snaps[1] == snaps[0]
    assert snaps[1]["pauses_in_rpc"] == 20 and not profilers[1]._gc_pending
    assert set(series[1]) == set(series[0]) and series[1]
    for key, want in series[0].items():
        assert series[1][key] == pytest.approx(want, rel=1e-12, abs=1e-9), key


def test_registration_ends_with_its_thread():
    """A finished thread's registration is dropped, and a new thread given
    its ident (the OS reuses them) does not inherit its role."""
    done = threading.Event()
    first = threading.Thread(target=lambda: (php.register_scoring_thread("batcher"),
                                             done.set()))
    first.start()
    first.join(timeout=5.0)
    assert done.is_set()
    old = first.ident
    reused = None
    for _ in range(50):  # a fresh thread usually takes the freed ident
        hold = threading.Event()
        t = threading.Thread(target=hold.wait, args=(5.0,))
        t.start()
        if t.ident == old:
            reused = t
            break
        hold.set()
        t.join(timeout=5.0)
    try:
        assert old not in php.registered_threads()
    finally:
        if reused is not None:
            hold.set()
            reused.join(timeout=5.0)
    php.register_scoring_thread("pipeline_stage")
    assert php.registered_threads()[threading.get_ident()] == "pipeline_stage"
    php.unregister_scoring_thread()


def test_sampler_never_touches_unregistered_threads():
    """A busy thread that was never registered is never sampled; a
    registered one is, under its role and active span."""
    hp = php.HostProfiler(enabled=True).install()
    stop, ready = threading.Event(), threading.Event()

    def busy(span_name):
        with ptracing.span(span_name):
            ready.set()
            while not stop.is_set():
                pass

    anon = threading.Thread(target=busy, args=("score.anon",), daemon=True)
    known = threading.Thread(target=busy, args=("score.known",), daemon=True)
    anon.start()
    assert ready.wait(5.0)
    ready.clear()
    known.start()
    assert ready.wait(5.0)
    php.register_scoring_thread("pipeline_stage", known.ident)
    try:
        assert hp.sampler.start(hz=250.0) and not hp.sampler.start(hz=250.0)
        time.sleep(0.3)
        summary = hp.sampler.stop()
    finally:
        stop.set()
        anon.join(timeout=5.0)
        known.join(timeout=5.0)
        php.unregister_scoring_thread(known.ident)
        hp.uninstall()
    folded = hp.sampler.folded()
    assert not any("span:score.anon" in k for k in folded)
    assert any(k.startswith("pipeline_stage;span:score.known;") for k in folded)
    assert summary["samples_total"] > 0 and "pipeline_stage" in summary["roles_seen"]


def _keys(obj, prefix=""):
    out = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.add(prefix + k)
            if k not in ("collections", "pause_ms_total", "stages"):  # keyed by data
                out |= _keys(v, prefix + k + ".")
    return out


def test_hostprofz_page_and_sampler_control(monkeypatch):
    """GET /debug/hostprofz answers with the keys of the JAX page
    (``HostProfiler.snapshot()``), ``?format=folded`` and ``speedscope``;
    POST starts (200, then 409), stops and resets the sampler and refuses a
    bad action (400); /metrics carries the stage µs-per-row series."""
    jax_page = jhp.HostProfiler(enabled=True)
    jax_page._on_span(types.SimpleNamespace(name="rpc.ScoreBatch", duration_ms=1.0,
                                            attributes={"rows": 4}, trace_id="t"))
    jhp.unregister_scoring_thread()
    want = _keys(jax_page.snapshot())
    from igaming_platform_tpu_torch.serve import risk_codec as codec

    batch = codec.encode(codec.SCORE_BATCH_REQUEST, {"transactions": [
        {"account_id": f"a{i % 5}", "amount": 500 + i, "transaction_type": "bet"}
        for i in range(90)]})

    def post(url, body):
        req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())

    with port_sidecar(monkeypatch) as (server, url):
        page = f"{url}/debug/hostprofz"
        assert post(page, {"action": "start", "hz": 199})[0] == 200
        assert post(page, {"action": "start", "hz": 199})[0] == 409
        for _ in range(3):
            server.service.call("ScoreBatch", batch)
        status, stopped = post(page, {"action": "stop"})
        assert status == 200 and stopped["sampler"]["running"] is False
        with urllib.request.urlopen(page, timeout=30) as resp:
            snap = json.loads(resp.read())
        with urllib.request.urlopen(f"{page}?format=folded", timeout=30) as resp:
            folded = resp.read().decode()
        with urllib.request.urlopen(f"{page}?format=speedscope", timeout=30) as resp:
            scope = json.loads(resp.read())
        with urllib.request.urlopen(f"{url}/metrics", timeout=30) as resp:
            metrics = resp.read().decode()
        assert post(page, {"action": "nope"})[0] == 400
        assert post(page, {"action": "reset"})[0] == 200
        with urllib.request.urlopen(page, timeout=30) as resp:
            after = json.loads(resp.read())
    assert _keys(snap) == want
    assert {"decode", "dispatch", "readback", "encode"} <= set(snap["stages"])
    assert snap["rpc"]["rows"] >= 270
    assert all(line.rsplit(" ", 1)[1].isdigit() for line in folded.splitlines())
    assert scope["profiles"][0]["type"] == "sampled"
    assert 'risk_host_stage_us_per_row_count{stage="decode"}' in metrics
    assert after["stages"] == {} and after["rpc"]["rpcs"] == 0


_DEADLOCK = r"""
import gc, sys, types
sys.path.insert(0, {repo!r})
import importlib
mod = importlib.import_module({module!r})
hp = mod.HostProfiler(enabled=True).install()
site = {site!r}
span = types.SimpleNamespace(name="score.decode", duration_ms=1.0, attributes={{"batch": 4}},
                             trace_id="t")
if site == "on_span":
    class Acc(mod._StageAcc):
        def __init__(self):
            gc.collect()  # a collection started while a new stage is allocated
            super().__init__()
    mod._StageAcc = Acc
else:
    hp._on_span(span)

    class Samples(list):
        def __iter__(self):
            gc.collect()  # a collection started while the stages are copied
            return super().__iter__()

    hp._stages["decode"].samples = Samples([0.25])
print("calling", flush=True)
if site == "on_span":
    hp._on_span(span)
else:
    hp._stage_block()
print("returned", hp.gc_snapshot()["collections"], flush=True)
"""


@pytest.mark.parametrize("site", ["on_span", "stage_block"])
def test_gc_inside_the_lock_hangs_jax_not_the_port(site):
    """A collection that starts while the profiler's lock is held: the JAX
    profiler's GC callback waits on that lock on the same thread for good
    (the subprocess is killed at its timeout, after "calling"), the port's
    takes no lock and returns, the collection counted."""
    def run(module, timeout):
        code = _DEADLOCK.format(repo=str(REPO), module=module, site=site)
        return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=timeout, env=dict(os.environ, JAX_PLATFORMS="cpu"))

    port = run("igaming_platform_tpu_torch.obs.hostprof", 60)
    assert port.returncode == 0, port.stderr
    lines = port.stdout.splitlines()
    assert lines[0] == "calling" and lines[1].startswith("returned {'")
    with pytest.raises(subprocess.TimeoutExpired) as hung:
        run("igaming_platform_tpu.obs.hostprof", 15)
    out = hung.value.stdout or b""
    out = out.decode() if isinstance(out, bytes) else out
    assert "calling" in out and "returned" not in out


def test_fold_is_exact_under_concurrent_readers(profilers):
    """Records appended by the GC callback while several threads fold are
    each counted once."""
    hp = profilers[1]
    n_threads, per_thread = 4, 500
    done = threading.Event()

    def reader():
        while not done.is_set():
            hp.fold_gc()

    readers = [threading.Thread(target=reader) for _ in range(n_threads)]
    for t in readers:
        t.start()
    try:
        for i in range(n_threads * per_thread):
            hp._gc_callback("start", {"generation": i % 3})
            hp._gc_callback("stop", {"generation": i % 3, "collected": 0})
    finally:
        done.set()
        for t in readers:
            t.join(timeout=10.0)
    snap = hp.gc_snapshot()
    assert sum(snap["collections"].values()) == n_threads * per_thread
