"""Port parity: booting a trained checkpoint through ``FRAUD_MODEL_PATH``.

A JAX ``Trainer`` (``TrainConfig(batch_size=256, trunk=(64, 64))``, as
tests/test_train.py) takes 3 steps and ``train/checkpoint.py`` saves it
with Orbax into a temporary directory. The JAX package boots the Orbax
directory with its ``resolve_model_boot`` (what its ``RiskServer`` runs),
and the port's ``assemble_risk_service`` boots the same directory through
its own Orbax reader (``utils/orbax``); each serves on an equal native store
with its clock pinned. The same ScoreTransaction and
ScoreBatch requests go to both: integer fields exact and ``ml_score`` to
atol 1e-6, rows within 1e-4 of a floor boundary whose ``ml_score`` differs
excused and counted (tests/test_torch_ensemble.py::assert_outputs_match),
every other byte equal.

The committed Orbax checkpoint of the released model
(``tests/golden/orbax/trainer/step_00000003``, written by the JAX package)
boots ``multitask`` with no warning, as in JAX, and scores the released
golden exactly; so does the ``.npz`` that ``tools/export_params_npz.py``
converts, which stays optional. A missing path, a checkpoint in zarr3 or
without OCDBT, a corrupt ``.npz`` and a tree that is not multitask each boot
the mock scorer with a warning that says why. The committed
``tests/golden/released_multitask.npz`` is the converter's output for
``released_multitask.msgpack``, leaf for leaf, and scores the released
golden through the port; the converter's writer and the port's write the
same file.
"""

import json
import logging
import os
import shutil

import grpc
import numpy as np
import pytest
from test_torch_server import _assert_same, _via_bytes, _via_grpc
from torch_front_common import T0, event_columns, fill, pin_jax_clock, requests
from torch_front_common import no_jax_hostprof  # noqa: F401 — a fixture

from igaming_platform_tpu.core.config import BatcherConfig as JBatcherConfig
from igaming_platform_tpu.core.config import RiskServiceConfig as JRiskServiceConfig
from igaming_platform_tpu.proto_gen.risk.v1 import risk_pb2
from igaming_platform_tpu.serve import grpc_server as jgrpc
from igaming_platform_tpu.serve import server as jserver_mod
from igaming_platform_tpu.serve.native_store import NativeFeatureStore as JaxNativeStore
from igaming_platform_tpu.serve.scorer import TPUScoringEngine
from igaming_platform_tpu.train.checkpoint import save_checkpoint
from igaming_platform_tpu.train.data import make_stream
from igaming_platform_tpu.train.trainer import TrainConfig, Trainer
from igaming_platform_tpu_torch import convert
from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig, ScoringConfig
from igaming_platform_tpu_torch.models.ensemble import make_score_fn
from igaming_platform_tpu_torch.serve import grpc_server, server
from igaming_platform_tpu_torch.serve.native_store import NativeFeatureStore
from tools import export_params_npz

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
RELEASED_ORBAX = os.path.join(GOLDEN_DIR, "orbax", "trainer", "step_00000003")
N_ACCOUNTS = 50


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """(Orbax checkpoint directory, its .npz) of a 3-step multitask run."""
    root = tmp_path_factory.mktemp("boot")
    trainer = Trainer(TrainConfig(batch_size=256, trunk=(64, 64)))
    trainer.fit(steps=3, data=make_stream(256, seed=11))
    orbax_dir = save_checkpoint(str(root / "ckpt"), trainer.state)
    npz = str(root / "model.npz")
    assert export_params_npz.main([orbax_dir, npz]) == 0
    return orbax_dir, npz


@pytest.mark.usefixtures("no_jax_hostprof")
def test_port_boot_answers_as_the_jax_boot(checkpoint, monkeypatch):
    orbax_dir, npz = checkpoint
    for knob in ("SLO", "DRIFT", "RUNTIME_TELEMETRY"):  # JAX planes, off for its service
        monkeypatch.setenv(knob, "0")
    pin_jax_clock(monkeypatch)
    cols = event_columns(13, N_ACCOUNTS, 1200)
    jstore, tstore = JaxNativeStore(max_accounts=500), NativeFeatureStore(max_accounts=500,
                                                                          clock=lambda: T0)
    fill([jstore, tstore], cols, bonus_accounts=[f"acct{a}" for a in range(0, N_ACCOUNTS, 4)],
         blacklist=[("device", "dev4"), ("ip", "ip9")])
    backend, params = jserver_mod.resolve_model_boot(JRiskServiceConfig(fraud_model_path=orbax_dir))
    assert backend == "multitask"
    jengine = TPUScoringEngine(ml_backend=backend, params=params, feature_store=jstore,
                               batcher_config=JBatcherConfig(batch_size=64, max_wait_ms=1.0))
    jservice = jgrpc.RiskGrpcService(jengine)
    monkeypatch.delenv("DRIFT")
    config = RiskServiceConfig(fraud_model_path=orbax_dir,
                               batcher=BatcherConfig(batch_size=64, max_wait_ms=1.0))
    assembled = server.assemble_risk_service(config, feature_store=tstore, device="cpu")
    jserver, _, jport = jgrpc.serve_risk(jservice, 0)
    channel = grpc.insecure_channel(f"localhost:{jport}")
    try:
        assert assembled.engine.ml_backend == "multitask"
        stub = grpc_server.make_risk_stub(channel)
        txs = [risk_pb2.ScoreTransactionRequest(**r) for r in requests(14, 150, N_ACCOUNTS)]
        exchanges = [("ScoreTransaction", t) for t in txs[:12]]
        exchanges += [("ScoreBatch", risk_pb2.ScoreBatchRequest(transactions=txs)),
                      ("ScoreBatch", risk_pb2.ScoreBatchRequest(transactions=txs[30:101]))]
        for i, (method, msg) in enumerate(exchanges):
            payload = msg.SerializeToString()
            want = _via_grpc(stub, method, payload)
            got = _via_bytes(assembled.service, method, payload)
            assert got[0] == want[0] == "OK", (i, method)
            _assert_same(method, want[1], got[1], f"boot #{i} {method}")
    finally:
        channel.close()
        jserver.stop(0)
        jengine.close()
        assembled.engine.close()
        assembled.service.close()


def _scores_released_golden(params) -> None:
    with open(os.path.join(GOLDEN_DIR, "released_scores.json")) as f:
        golden = json.load(f)
    x = np.load(os.path.join(GOLDEN_DIR, "released_features.npz"))["x"]
    out = make_score_fn(ScoringConfig(), "multitask", device="cpu")(
        params, x, np.zeros((x.shape[0],), dtype=bool))
    np.testing.assert_array_equal(out["score"].numpy(), golden["f32"]["score"])
    np.testing.assert_array_equal(out["action"].numpy(), golden["f32"]["action"])
    np.testing.assert_allclose(out["ml_score"].numpy().astype(float),
                               np.array(golden["f32"]["ml_score"]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["missing", "orbax_dir", "corrupt", "not_multitask", "npz",
                                  "zarr3", "not_ocdbt"])
def test_resolve_model_boot(case, checkpoint, tmp_path, caplog):
    """Each path a deployment may hand FRAUD_MODEL_PATH: an Orbax step
    directory (the committed one of the released model) or an .npz of a
    multitask tree boots multitask, as the JAX server boots the directory;
    everything else boots the mock scorer and says why. ML_BACKEND still
    overrides the backend."""
    orbax_dir, npz = checkpoint
    path = {"missing": str(tmp_path / "nope.npz"), "orbax_dir": RELEASED_ORBAX,
            "corrupt": str(tmp_path / "corrupt.npz"), "not_multitask": str(tmp_path / "mlp.npz"),
            "npz": npz, "zarr3": str(tmp_path / "zarr3"), "not_ocdbt": str(tmp_path / "plain")}[case]
    if case == "corrupt":
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 not a zip archive")
    if case == "not_multitask":
        convert.save_params_tree(path, {"mlp": {"layers": [
            {"w": np.ones((30, 4), np.float32), "b": np.zeros(4, np.float32)}]}})
    if case in ("zarr3", "not_ocdbt"):
        shutil.copytree(orbax_dir, path)
        with open(os.path.join(path, "_METADATA")) as f:
            meta = json.load(f)
        meta["use_zarr3" if case == "zarr3" else "use_ocdbt"] = case == "zarr3"
        with open(os.path.join(path, "_METADATA"), "w") as f:
            json.dump(meta, f)
    with caplog.at_level(logging.WARNING, logger=server.logger.name):
        backend, params = server.resolve_model_boot(RiskServiceConfig(fraud_model_path=path))
    if case in ("npz", "orbax_dir"):
        assert backend == "multitask" and set(params) == {"multitask"} and not caplog.records
        assert server.resolve_model_boot(RiskServiceConfig(
            fraud_model_path=path, ml_backend="mock"))[0] == "mock"
        if case == "orbax_dir":
            assert jserver_mod.resolve_model_boot(JRiskServiceConfig(
                fraud_model_path=path))[0] == "multitask"
            _scores_released_golden(params)
        return
    assert (backend, params) == ("mock", None)
    message = " ".join(r.getMessage() for r in caplog.records)
    assert "using mock scorer" in message, message
    if case in ("zarr3", "not_ocdbt"):
        assert ("zarr3" if case == "zarr3" else "not an OCDBT checkpoint") in message, message


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _leaves(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, list):
        return {k: v for i, node in enumerate(tree)
                for k, v in _leaves(node, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def test_released_golden_npz(tmp_path):
    """The committed .npz is the converter's output for the msgpack, leaf
    for leaf, and scores the released golden exactly; both writers give the
    reader the same tree."""
    want = export_params_npz.load_tree(os.path.join(GOLDEN_DIR, "released_multitask.msgpack"))
    committed = convert.load_params_tree(os.path.join(GOLDEN_DIR, "released_multitask.npz"))
    assert set(committed) == {"multitask"}
    got, ref = _leaves(committed["multitask"]), _leaves(want)
    assert sorted(got) == sorted(ref) and len(got) == 10
    for key in ref:
        assert got[key].dtype == ref[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for i, writer in enumerate((export_params_npz.save_params_tree, convert.save_params_tree)):
        path = str(tmp_path / f"w{i}.npz")
        writer(path, {"multitask": want})
        with np.load(path) as z:
            assert sorted(z.files) == sorted(f"multitask/{k}" for k in ref)
        back = _leaves(convert.load_params_tree(path)["multitask"])
        assert all(np.array_equal(back[k], ref[k]) for k in ref)
    _scores_released_golden(server.load_multitask(
        os.path.join(GOLDEN_DIR, "released_multitask.npz")))
