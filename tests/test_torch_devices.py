"""Port parity: core/devices.py, the card's liveness probe, and the server's
``device_gate``.

Under the same fake probe outcomes as tests/test_devices.py's cases (a hang
that recovers, a budget that runs out, an inherited failure, a reprobe that
restores children, a throttled reprobe, a fast failure, a reprobe that is
still hung), both probes make the same attempts, sleep the same delays and
return the same labels (the port says "device unresponsive" where the JAX
module says "device tunnel unresponsive"), and leave the same hand-down in
the environment. The port never pins anything to the CPU: no JAX knob, no
``CUDA_VISIBLE_DEVICES``, no default device changes. ``device_gate`` fails
the boot with the label unless ``SERVE_DEVICE_FALLBACK=cpu``.
"""

import os
import subprocess
import sys

import pytest
import torch

from igaming_platform_tpu.core import devices as jdev
from igaming_platform_tpu_torch.core import devices as pdev
from igaming_platform_tpu_torch.serve import server as pserver

ENV = ("BENCH_DEVICE_PROBED", "BENCH_DEVICE_FALLBACK", "DEVICE_PROBE_BUDGET_S",
       jdev._PREPIN_ENV, "SERVE_DEVICE_FALLBACK")
HUNG = {"jax": "cpu (device tunnel unresponsive)", "port": "cpu (device unresponsive)"}


def _same(label):
    return None if label is None else label.replace("device tunnel unresponsive",
                                                    "device unresponsive")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    # The JAX reprobe restores JAX_PLATFORMS from its pre-pin record: undone
    # after the test.
    monkeypatch.setenv("JAX_PLATFORMS", os.environ.get("JAX_PLATFORMS", "cpu"))
    monkeypatch.setattr(jdev, "_pin_cpu", lambda: None)
    for mod in (jdev, pdev):
        monkeypatch.setattr(mod, "_last_reprobe_at", 0.0)
    yield
    for var in ENV:
        os.environ.pop(var, None)


class _Probe:
    def __init__(self, returncode=0, stderr=b""):
        self.returncode, self.stderr = returncode, stderr


def _outcomes(case: str, side: str) -> list:
    """The fake outcomes of ``_probe_once`` (labels) or of ``subprocess.run``
    (``_Probe`` or an exception) per case."""
    hung = HUNG[side]
    return {
        "recovers": [hung, hung, None],
        "budget": [hung] * 20,
        "fast_failure": ["cpu (device init failed: rc=1)"],
        "reprobe_ok": [_Probe(0)],
        "reprobe_throttled": [subprocess.TimeoutExpired("probe", 20.0)] * 2,
        "reprobe_hung": [subprocess.TimeoutExpired("probe", 20.0)],
    }[case]


def _run(case: str, mod, side: str, monkeypatch) -> dict:
    """One case through ``mod``: what it returned, its attempts, sleeps and
    the environment it left."""
    for var in (*ENV, "JAX_PLATFORMS"):  # the JAX probe takes JAX_PLATFORMS=cpu as a choice
        monkeypatch.delenv(var, raising=False)
    outcomes, calls, sleeps = list(_outcomes(case, side)), [], []
    clock = {"now": 1000.0}
    monkeypatch.setattr(mod.time, "monotonic", lambda: clock["now"])

    def sleep(s):
        sleeps.append(s)
        clock["now"] += s

    monkeypatch.setattr(mod.time, "sleep", sleep)

    def probe_once(timeout):
        calls.append(timeout)
        clock["now"] += 1.0
        return outcomes[min(len(calls) - 1, len(outcomes) - 1)]

    def run(cmd, timeout, capture_output, env):
        calls.append(timeout)
        out = outcomes[min(len(calls) - 1, len(outcomes) - 1)]
        if isinstance(out, Exception):
            raise out
        return out

    monkeypatch.setattr(mod, "_probe_once", probe_once)
    monkeypatch.setattr(mod.subprocess, "run", run)
    if case == "budget":
        monkeypatch.setenv("DEVICE_PROBE_BUDGET_S", "35")
    elif case == "recovers":
        monkeypatch.setenv("DEVICE_PROBE_BUDGET_S", "600")
    if case.startswith("reprobe"):
        monkeypatch.setenv("BENCH_DEVICE_FALLBACK", HUNG[side])
        result = [mod.reprobe_recovered() for _ in range(2 if case == "reprobe_throttled" else 1)]
    else:
        result = _same(mod.ensure_responsive_device())
    return {"result": result, "calls": calls, "sleeps": sleeps,
            "env": {v: _same(os.environ.get(v)) for v in ENV if v != jdev._PREPIN_ENV}}


@pytest.mark.parametrize("case", ["recovers", "budget", "fast_failure", "reprobe_ok",
                                  "reprobe_throttled", "reprobe_hung", "inherited"])
def test_probe_matches_jax(case, monkeypatch):
    if case == "inherited":
        runs = {}
        for side, mod in (("jax", jdev), ("port", pdev)):
            monkeypatch.setenv("BENCH_DEVICE_FALLBACK", HUNG[side])
            monkeypatch.setattr(mod, "_probe_once", lambda t: pytest.fail("must not re-probe"))
            runs[side] = _same(mod.ensure_responsive_device())
        assert runs["port"] == runs["jax"] == "cpu (device unresponsive)"
        return
    want = _run(case, jdev, "jax", monkeypatch)
    got = _run(case, pdev, "port", monkeypatch)
    assert got == want, case
    assert got["calls"]


def test_probe_once_labels_match_jax(monkeypatch):
    """``_probe_once`` over the same subprocess outcomes: healthy, a hang, a
    fast failure with its last stderr line, a silent failure."""
    outcomes = [_Probe(0), subprocess.TimeoutExpired("p", 1.0),
                _Probe(1, b"Traceback\nRuntimeError: Found no NVIDIA driver on your system\n"),
                _Probe(3, b"")]
    for mod in (jdev, pdev):
        labels = []
        for out in outcomes:
            def run(cmd, timeout, capture_output, out=out):
                if isinstance(out, Exception):
                    raise out
                return out

            monkeypatch.setattr(mod.subprocess, "run", run)
            labels.append(_same(mod._probe_once(1.0)))
        if mod is jdev:
            want = labels
    assert labels == want
    assert labels[1:] == ["cpu (device unresponsive)",
                          "cpu (device init failed: RuntimeError: Found no NVIDIA driver on your "
                          "system)", "cpu (device init failed: rc=3)"]


def test_port_never_pins_and_gate_fails_loudly(monkeypatch):
    """A failed probe changes nothing of this process: the default device,
    CUDA_VISIBLE_DEVICES and the environment stay (bar the hand-down label).
    ``device_gate`` then raises SystemExit(1) unless
    ``SERVE_DEVICE_FALLBACK=cpu``, which serves on the CPU; a healthy probe
    serves on the card."""
    before = dict(os.environ)
    device = torch.empty(0).device
    monkeypatch.setattr(pdev, "_probe_once", lambda t: "cpu (device init failed: rc=1)")
    assert pdev.ensure_responsive_device() == "cpu (device init failed: rc=1)"
    after = dict(os.environ)
    assert after.pop("BENCH_DEVICE_FALLBACK") == "cpu (device init failed: rc=1)"
    assert after == before and torch.empty(0).device == device
    assert not hasattr(pdev, "_pin_cpu")
    with pytest.raises(SystemExit) as exc:
        pserver.device_gate()
    assert exc.value.code == 1
    monkeypatch.setenv("SERVE_DEVICE_FALLBACK", "cpu")
    assert pserver.device_gate() == "cpu"
    monkeypatch.delenv("BENCH_DEVICE_FALLBACK")
    monkeypatch.setattr(pdev, "_probe_once", lambda t: None)
    assert pserver.device_gate() == "cuda"


def test_real_probe_without_a_card_fails_fast():
    """The probe's subprocess, for real, with no card visible: a fast
    failure (no retry), its label naming the cause."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_DEVICE")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    code = ("import sys; sys.path.insert(0, %r); from igaming_platform_tpu_torch.core import "
            "devices as d; print(d.ensure_responsive_device(probe_timeout_s=60))"
            % str(pdev.__file__.rsplit("/igaming_platform_tpu_torch/", 1)[0]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, check=True).stdout.strip()
    assert out.startswith("cpu (device init failed: ") and "probes over" not in out


def test_a_signal_right_after_the_boot_drains():
    """A boot installs its SIGINT/SIGTERM handlers (``stop_on_signal``)
    before it builds the server, so a SIGTERM sent as soon as "risk server
    up" is logged, before the boot waits, drains the server (exit 0)
    instead of killing the process."""
    code = ("import os, signal, sys, types; sys.path.insert(0, %r); "
            "from igaming_platform_tpu_torch.serve import server; "
            "done = server.stop_on_signal(); os.kill(os.getpid(), signal.SIGTERM); "
            "fake = types.SimpleNamespace(shutdown=lambda: print('drained')); "
            "server.RiskServer.wait_for_signal(fake, done)"
            % str(pdev.__file__.rsplit("/igaming_platform_tpu_torch/", 1)[0]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=False)
    assert out.returncode == 0 and out.stdout.strip() == "drained", out.stderr[-2000:]


def test_compile_cache_is_the_kernel_build_dir(monkeypatch):
    """One cache: the kernel build directory on a card, none without one;
    the kernel libraries' key carries the toolchain."""
    from igaming_platform_tpu_torch.ops import _build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert pdev.enable_persistent_compile_cache() == str(_build.BUILD_DIR)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pdev.enable_persistent_compile_cache() is None
    assert pdev.host_fingerprint() == jdev.host_fingerprint()
    assert pdev.cache_dir_for("cuda", "/x") == jdev.cache_dir_for("cuda", "/x")
    key = _build.toolchain_key()
    assert "|" in key and _build.library_path("gbdt_forest").name.startswith("libgbdt_forest-")


@pytest.mark.parametrize("grid", [("cuda:0", "cuda:1", "cuda:0", "cuda:1"),
                                  ("cuda:0", "cuda:0"), None])
def test_mesh_server_readies_every_distinct_card(grid, monkeypatch):
    """A server whose engine serves over a mesh readies each distinct card of
    the mesh for captures, once, and no other (``devtrace.prepare``), as
    ``jax.profiler`` traces every device of the process; a server on the
    CPU without a mesh readies none."""
    from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
    from igaming_platform_tpu_torch.obs import devtrace, tracing
    from igaming_platform_tpu_torch.parallel.mesh import MeshSpec, create_mesh

    readied, traced = [], []
    monkeypatch.setattr(devtrace, "prepare", readied.append)
    monkeypatch.setattr(tracing, "prepare_device_trace", lambda: traced.append(1))
    config = RiskServiceConfig(batcher=BatcherConfig(batch_size=8, max_wait_ms=1.0))
    assembled = pserver.assemble_risk_service(config, device="cpu", warmup=False)
    if grid is not None:
        assembled.inner.mesh = create_mesh(MeshSpec(data=len(grid)), devices=list(grid))
    srv = pserver.RiskServer(assembled, grpc_port=-1, http_port=0)
    try:
        want = [] if grid is None else list(dict.fromkeys(torch.device(d) for d in grid))
        assert readied == want and len(traced) == (1 if want else 0)
        assert pserver.capture_devices(assembled.inner)[0] == torch.device("cpu")
    finally:
        assembled.inner.mesh = None
        srv.shutdown(grace=1.0)
