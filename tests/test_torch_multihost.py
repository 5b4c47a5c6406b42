"""Port parity: serve/multihost.py and parallel/distributed.py, two processes on gloo.

The front runs in the test's process, a follower in a child process, both
on the CPU (the roles' entry point refuses the CPU, so the tests drive
``multihost_engine`` and ``follower_serve`` directly). Held:

- every row step of the two-process front against the JAX single-process
  engine (integer columns exact outside floor-boundary rows, ``ml_score``
  atol 1e-6) and bit-equal to the port's single-process engine; each
  process scores its own half, and one gloo all-gather a step joins them;
- a killed follower: single-host degraded answers, equal, the
  ``multihost`` breaker open; a restarted follower re-handshakes, joins a
  new process group, ``follower_resurrections_total`` counts 1;
- loopback mode over the stub follower, a wedged stub's ACK timeout, the
  handshake's NACK on a follower with other params, the refusal of the
  index path, and the roles' boot errors (the twin of
  ``tests/test_multihost_boot.py``'s contract; the JAX two-process test
  itself is not run from here).

Every test carries its own time limit and kills its children in a
``finally``.
"""

import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
from test_torch_ensemble import jax_tree
from torch_front_common import checked_rows, time_limit  # noqa: F401 — fixture

from igaming_platform_tpu.core.config import BatcherConfig as JBatcherConfig
from igaming_platform_tpu.serve.scorer import TPUScoringEngine
from igaming_platform_tpu.train.data import sample_features
from igaming_platform_tpu_torch.convert import from_jax_params, save_params_tree
from igaming_platform_tpu_torch.core.config import BatcherConfig
from igaming_platform_tpu_torch.obs.metrics import ServiceMetrics
from igaming_platform_tpu_torch.parallel import distributed
from igaming_platform_tpu_torch.parallel.mesh import MeshSpec
from igaming_platform_tpu_torch.serve import multihost
from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine
from igaming_platform_tpu_torch.serve.supervisor import ServingSupervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BCFG = dict(batch_size=32, latency_tiers=(8,), max_wait_ms=1.0)

FOLLOWER = """
import os, sys
sys.path.insert(0, os.environ["REPO_ROOT"])
from igaming_platform_tpu_torch.convert import from_jax_params, load_params_tree
from igaming_platform_tpu_torch.core.config import BatcherConfig, ScoringConfig
from igaming_platform_tpu_torch.parallel import distributed
from igaming_platform_tpu_torch.parallel.mesh import MeshSpec
from igaming_platform_tpu_torch.serve.multihost import follower_serve
distributed.initialize_from_env()
mesh = distributed.global_mesh(MeshSpec(data=-1), local_devices=["cpu"])
params = from_jax_params("mlp+gbdt", load_params_tree(os.environ["PARAMS"]))
follower_serve(int(os.environ["WORK_PORT"]), ScoringConfig(), "mlp+gbdt", params, mesh,
               device="cpu", batcher_config=BatcherConfig(batch_size=32, latency_tiers=(8,)))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Procs:
    """Child processes, each killed at the end whatever happened."""

    def __init__(self, tmp_path):
        self.tmp_path = tmp_path
        self.children = []

    def spawn(self, code_or_args, env=None, name="child"):
        args = ([sys.executable, "-c", textwrap.dedent(code_or_args)]
                if isinstance(code_or_args, str) else [sys.executable, *code_or_args])
        log = open(self.tmp_path / f"{name}-{len(self.children)}.log", "w")
        p = subprocess.Popen(args, env={**os.environ, "REPO_ROOT": REPO, **(env or {})},
                             stdout=log, stderr=subprocess.STDOUT, cwd=REPO)
        self.children.append(p)
        return p

    def kill_all(self):
        for p in self.children:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)


@pytest.fixture
def procs(tmp_path, time_limit):  # noqa: F811
    box = Procs(tmp_path)
    try:
        yield box
    finally:
        box.kill_all()
        distributed.shutdown()


def _dist_env(monkeypatch, coord: int) -> dict:
    env = {"COORDINATOR_ADDRESS": f"127.0.0.1:{coord}", "NUM_PROCESSES": "2"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("PROCESS_ID", "0")
    for knob in ("SLO", "DRIFT", "RUNTIME_TELEMETRY"):
        monkeypatch.setenv(knob, "0")
    return env


def _assert_matches(got, want):
    np.testing.assert_allclose(got["ml_score"], want["ml_score"], rtol=0, atol=1e-6)
    ok = checked_rows(got, want)
    for key in ("score", "action"):
        np.testing.assert_array_equal(got[key][ok], want[key][ok])
    for key in ("rule_score", "reason_mask"):
        np.testing.assert_array_equal(got[key] & ~(1 << 8), want[key] & ~(1 << 8))


def _bits_equal(got, want):
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _step(eng, x, bl):
    return eng._readback(eng._launch(x, bl, eng.get_params()))


def test_two_processes_match_jax_through_death_and_resurrection(procs, monkeypatch, tmp_path):
    tree = jax_tree("mlp+gbdt")
    save_params_tree(str(tmp_path / "params.npz"), tree)
    env = _dist_env(monkeypatch, _free_port())
    work = _free_port()
    fenv = {**env, "PROCESS_ID": "1", "WORK_PORT": str(work),
            "PARAMS": str(tmp_path / "params.npz")}
    procs.spawn(FOLLOWER, fenv, "follower")
    distributed.initialize_from_env()
    mesh = distributed.global_mesh(MeshSpec(data=-1), local_devices=["cpu"])
    assert distributed.global_data_size(mesh) == 2 and distributed.is_primary()
    assert distributed.process_batch_slice(32) == (16, 0)
    port = from_jax_params("mlp+gbdt", tree)
    sup = ServingSupervisor()
    sup.bind(metrics=ServiceMetrics("risk"))
    front = multihost.multihost_engine(
        mesh, [work], ml_backend="mlp+gbdt", params=port, device="cpu", supervisor=sup,
        batcher_config=BatcherConfig(**BCFG),
        channel_kwargs={"io_timeout_s": 10, "reconnect_backoff_s": (0.1, 0.5)})
    single = TorchScoringEngine(ml_backend="mlp+gbdt", params=port, device="cpu",
                                batcher_config=BatcherConfig(**BCFG))
    jeng = TPUScoringEngine(ml_backend="mlp+gbdt", params=tree,
                            batcher_config=JBatcherConfig(**BCFG))
    try:
        assert front.group_epoch == 0 and not front.degraded
        rng = np.random.default_rng(2)
        batches = [(sample_features(rng, n), rng.random(n) < 0.1) for n in (5, 32, 20)]
        wants = [{k: v[:x.shape[0]] for k, v in jeng._run_device(x, bl)[0].items()}
                 for x, bl in batches]
        refs = [_step(single, x, bl) for x, bl in batches]
        steps0 = front.device_steps
        for (x, bl), want, ref in zip(batches, wants, refs):
            got = _step(front, x, bl)
            _assert_matches(got, want)
            _bits_equal(got, ref)
        assert front.device_steps - steps0 == 3 and front.degraded_steps == 0
        procs.children[0].kill()
        procs.children[0].wait(timeout=30)
        for (x, bl), ref in zip(batches, refs):
            _bits_equal(_step(front, x, bl), ref)
        assert front.degraded and front.degraded_steps >= 3
        assert sup.breaker("multihost").state_name == "open"
        procs.spawn(FOLLOWER, fenv, "follower")
        deadline = time.monotonic() + 60
        while front._chan.resurrections == 0 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert front._chan.resurrections == 1
        degraded = front.degraded_steps
        for (x, bl), ref in zip(batches, refs):
            _bits_equal(_step(front, x, bl), ref)
        assert front.group_epoch == 1 and front.degraded_steps == degraded
        assert sup.breaker("multihost").state_name == "closed"
        assert sup.metrics.follower_resurrections_total.value() == 1
        with pytest.raises(RuntimeError, match="multihost front"):
            front.ensure_cache()
    finally:
        front.close()
        single.close()
        jeng.close()


@pytest.mark.parametrize("mode", ["ack", "wedge"])
def test_loopback_over_stub_follower(mode, procs, monkeypatch):
    """Loopback: the channel's discipline over a local-only step. A wedged
    stub stops ACKing: without resurrection the front fails loudly once the
    ACK window is full, never hangs."""
    for knob in ("SLO", "DRIFT", "RUNTIME_TELEMETRY"):
        monkeypatch.setenv(knob, "0")
    work = _free_port()
    procs.spawn(["-m", "igaming_platform_tpu_torch.serve.multihost", "--stub-follower",
                 "--port", str(work), "--mode", mode, "--wedge-after", "2"], name="stub")
    front = multihost.multihost_engine(
        None, [work], ml_backend="mock", device="cpu", reconnect=False, warmup=False,
        batcher_config=BatcherConfig(**BCFG),
        channel_kwargs={"io_timeout_s": 2, "ack_window": 2})
    single = TorchScoringEngine(device="cpu", batcher_config=BatcherConfig(**BCFG))
    try:
        rng = np.random.default_rng(1)
        x, bl = sample_features(rng, 32), np.zeros(32, bool)
        ref = _step(single, x, bl)
        if mode == "ack":
            for _ in range(6):
                _bits_equal(_step(front, x, bl), ref)
            assert front.degraded_steps == 0 and not front.degraded
        else:
            with pytest.raises(multihost.MultihostChannelError, match="no step ACK"):
                for _ in range(8):
                    _step(front, x, bl)
            with pytest.raises(multihost.MultihostChannelError):
                _step(front, x, bl)
    finally:
        front.close()
        single.close()


def test_handshake_nacks_a_follower_with_other_params(procs, monkeypatch, tmp_path):
    env = _dist_env(monkeypatch, _free_port())
    work = _free_port()
    save_params_tree(str(tmp_path / "other.npz"), jax_tree("mlp+gbdt") | {
        "gbdt": {**jax_tree("mlp+gbdt")["gbdt"], "bias": np.float32(0.5)}})
    procs.spawn(FOLLOWER, {**env, "PROCESS_ID": "1", "WORK_PORT": str(work),
                           "PARAMS": str(tmp_path / "other.npz")}, "follower")
    distributed.initialize_from_env()
    mesh = distributed.global_mesh(MeshSpec(data=-1), local_devices=["cpu"])
    params = from_jax_params("mlp+gbdt", jax_tree("mlp+gbdt"))
    with pytest.raises(RuntimeError, match="NACK: multihost model mismatch"):
        multihost.multihost_engine(mesh, [work], ml_backend="mlp+gbdt", params=params,
                                   device="cpu", batcher_config=BatcherConfig(**BCFG))
    assert procs.children[0].wait(timeout=60) != 0


def test_fingerprint_and_param_leaves_round_trip():
    a = from_jax_params("mlp+gbdt", jax_tree("mlp+gbdt"))
    leaves = multihost.param_leaves(a)
    b = multihost.load_param_leaves(a, [leaf * 0 for leaf in leaves])
    assert not np.array_equal(multihost.model_fingerprint("mlp+gbdt", a),
                              multihost.model_fingerprint("mlp+gbdt", b))
    c = multihost.load_param_leaves(b, leaves)
    np.testing.assert_array_equal(multihost.model_fingerprint("mlp+gbdt", a),
                                  multihost.model_fingerprint("mlp+gbdt", c))
    assert not np.array_equal(multihost.model_fingerprint("mlp+gbdt", a),
                              multihost.model_fingerprint("multitask", a))


@pytest.mark.parametrize("env,message", [
    ({"MULTIHOST_ROLE": "front", "SERVE_DEVICE_FALLBACK": "cpu"},
     "SERVE_DEVICE_FALLBACK=cpu is not valid with MULTIHOST_ROLE"),
    ({"MULTIHOST_ROLE": "follower", "SERVE_DEVICE_FALLBACK": "cpu"},
     "SERVE_DEVICE_FALLBACK=cpu is not valid with MULTIHOST_ROLE"),
    ({"MULTIHOST_ROLE": "front"}, "requires MULTIHOST_FOLLOWER_PORTS"),
    ({"MULTIHOST_ROLE": "follower"}, "requires MULTIHOST_WORK_PORT"),
    ({"MULTIHOST_ROLE": "leader"}, "not recognized"),
    ({"MULTIHOST_ROLE": "front", "MULTIHOST_FOLLOWER_PORTS": "1", "DEVICE_PROBE_BUDGET_S": "1"},
     None)])
def test_role_boot_errors(env, message, monkeypatch):
    """The roles fail at boot with the JAX server's messages; with its ports
    set the front goes on to the device gate, which refuses a machine
    without a card (SystemExit)."""
    from igaming_platform_tpu_torch.serve import server

    for key in ("MULTIHOST_FOLLOWER_PORTS", "MULTIHOST_WORK_PORT", "SERVE_DEVICE_FALLBACK",
                "NUM_PROCESSES"):
        monkeypatch.delenv(key, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if message is None:
        monkeypatch.setattr(server, "device_gate", lambda: (_ for _ in ()).throw(SystemExit(1)))
        with pytest.raises(SystemExit):
            server.main()
        return
    with pytest.raises(RuntimeError, match=message):
        server.main()
    jsrc = open(os.path.join(REPO, "igaming_platform_tpu", "serve", "server.py")).read()
    assert message.split(" (")[0] in jsrc.replace("\n", " ").replace('"  "', "").replace(
        '" "', "").replace('"', "") or message == "not recognized"
