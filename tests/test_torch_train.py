"""Port parity: the multitask trainer, its data, checkpoints and the loop.

The port's ``train/{fraudgen,data,trainer,checkpoint,loop}.py`` against the
JAX package's on the same numpy inputs, at a small size (trunk (32, 32),
batch 64). The JAX init is carried across with
``convert.trainer_state_from_jax``; the port cannot draw JAX's numbers.

- data: ``generate_labeled``, ``sample_features`` and ``make_aux_targets``
  bit-equal; the fraud teacher bit-equal;
- step 0: loss and metrics at rtol 1e-5; every weight gradient equal to
  JAX's or one bf16 ulp from it, none further (both are rounded to bf16,
  ``ops/dense.py::DenseFn``); bias gradients at rtol/atol 2e-5;
- the optimizer against ``optax.adamw`` on the same gradients: rtol 1e-6;
- three steps: losses rtol 1e-4, params rtol 1e-4 / atol 1e-6;
- ``remat`` bit-equal to plain, ``fit`` bit-equal to stepping one batch at a
  time, the bf16 wire's batch bit-equal to ``ml_dtypes``' cast and its loss
  in ``tests/test_pipeline.py``'s band;
- a checkpoint (an Orbax step directory) round-trips bit for bit and boots
  through ``FRAUD_MODEL_PATH``; ``TrainingLoop`` resumes from it and swaps
  into an engine; the earlier ``step_*.npz`` form still resumes; ``multitask_to_tree`` gives a tree the JAX forward scores.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from igaming_platform_tpu.train import data as jdata
from igaming_platform_tpu.train import fraudgen as jfraudgen
from igaming_platform_tpu.train import trainer as jtrainer
from igaming_platform_tpu_torch import convert
from igaming_platform_tpu_torch.core.config import RiskServiceConfig
from igaming_platform_tpu_torch.serve.scorer import ScoreRequest, TorchScoringEngine
from igaming_platform_tpu_torch.serve.server import resolve_model_boot
from igaming_platform_tpu_torch.train import checkpoint, data, fraudgen, loop, trainer

TRUNK, BATCH = (32, 32), 64


def _cfgs(**kw):
    return (jtrainer.TrainConfig(batch_size=BATCH, trunk=TRUNK, **kw),
            trainer.TrainConfig(batch_size=BATCH, trunk=TRUNK, **kw))


def _pair(**kw):
    """(JAX trainer, port CPU trainer) from the JAX trainer's init."""
    jcfg, pcfg = _cfgs(**kw)
    jt = jtrainer.Trainer(jcfg)
    pt = trainer.Trainer(pcfg, device="cpu")
    pt.state = convert.trainer_state_from_jax(jax.device_get(jt.state.params),
                                              jax.device_get(jt.state.opt_state), 0)
    return jt, pt


def _batches(n, seed=0):
    stream = data.make_stream(BATCH, seed=seed)
    return [next(stream) for _ in range(n)]


def _bf16_bits(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).view(np.int16).astype(np.int32)


def _grad_pairs(jgrads, model):
    for path, layer in convert.multitask_layers(model):
        node = jgrads["trunk"]["layers"][path[2]] if path[0] == "trunk" else jgrads[path[0]]
        yield "/".join(map(str, path)), node, layer


@pytest.mark.parametrize("seed", [0, 11])
def test_data_bit_equal(seed):
    got = fraudgen.generate_labeled(np.random.default_rng(seed), 777, 0.2)
    want = jfraudgen.generate_labeled(np.random.default_rng(seed), 777, 0.2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert fraudgen.KIND_NAMES == jfraudgen.KIND_NAMES
    x = data.sample_features(np.random.default_rng(seed), 500)
    np.testing.assert_array_equal(x, jdata.sample_features(np.random.default_rng(seed), 500))
    for g, w in zip(data.make_aux_targets(x), jdata.make_aux_targets(x)):
        np.testing.assert_array_equal(g, w)
    # The fraud teacher: the port's mock over ref-compat normalization.
    fraud, _, _ = data.make_targets(x)
    want_fraud, _, _ = jdata.make_targets(x)
    assert fraud.dtype == np.float32
    np.testing.assert_array_equal(fraud, want_fraud)


def test_step0_loss_and_gradients_match_jax():
    jt, pt = _pair()
    b = _batches(1)[0]
    loss_fn = jtrainer.make_loss_fn(jt.cfg)
    (_, jm), jg = jax.value_and_grad(loss_fn, has_aux=True)(
        jt.state.params, jnp.asarray(b.x), b.fraud, b.ltv, b.churn)
    model = pt.state.params
    loss, pm = trainer.loss_and_metrics(pt.cfg, model, *(torch.from_numpy(a) for a in
                                                         (b.x, b.fraud, b.ltv, b.churn)))
    loss.backward()
    for k in trainer.METRIC_NAMES:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    jg = jax.tree.map(np.asarray, jg)
    one_ulp = 0
    for name, jnode, layer in _grad_pairs(jg, model):
        # Both sides hold bf16 values: equal, or one bf16 ulp apart.
        d = np.abs(_bf16_bits(layer.w.grad.numpy()) - _bf16_bits(jnode["w"]))
        assert np.array_equal(np.asarray(layer.w.grad.numpy(), np.float32).astype(
            ml_dtypes.bfloat16).astype(np.float32), layer.w.grad.numpy()), name
        assert int((d > 1).sum()) == 0, (name, int((d > 1).sum()))
        one_ulp += int((d == 1).sum())
        np.testing.assert_allclose(layer.b.grad.numpy(), jnode["b"], rtol=2e-5, atol=2e-5,
                                   err_msg=name)
    print(f"weight gradients one bf16 ulp from JAX's: {one_ulp}")


def test_adamw_matches_optax():
    rng = np.random.default_rng(2)
    shapes = [(30, 32), (32,), (32, 1), (1,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    opt = optax.adamw(3e-4, weight_decay=1e-4)
    jp = [jnp.asarray(p) for p in params]
    jstate = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = trainer.AdamState.zeros(tp)
    for _ in range(3):
        grads = [rng.normal(size=s).astype(np.float32) * 1e-2 for s in shapes]
        updates, jstate = jax.jit(opt.update)([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tstate = trainer.adamw_update(tp, [torch.from_numpy(g) for g in grads], tstate,
                                      3e-4, 1e-4)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # XLA contracts a moment's update into one fused multiply-add, torch
    # rounds the product first: moments that cancel to near 0 differ in
    # their last bits, so they are held at 1e-6 of their scale.
    for a, b in zip(tstate.mu + tstate.nu, jstate[0].mu + jstate[0].nu):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6 * np.abs(b).max())
    assert int(tstate.count) == int(jstate[0].count) == 3


def test_three_steps_match_jax():
    jt, pt = _pair()
    for b in _batches(3):
        jl = jt.train_step(jdata.Batch(b.x, b.fraud, b.ltv, b.churn))["loss"]
        pl = pt.train_step(b)["loss"]
        np.testing.assert_allclose(pl, jl, rtol=1e-4)
    jtree = jax.tree.map(np.asarray, jax.device_get(jt.state.params))
    for name, jnode, layer in _grad_pairs(jtree, pt.state.params):
        for k in ("w", "b"):
            np.testing.assert_allclose(getattr(layer, k).detach().numpy(), jnode[k],
                                       rtol=1e-4, atol=1e-6, err_msg=f"{name}/{k}")
    assert pt.state.step == 3 and int(pt.state.opt_state.count) == 3


def _params_of(t):
    return [p.detach().clone() for p in t.state.params.parameters()]


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_remat_and_fit_are_bit_equal_to_stepping():
    batches = _batches(4)
    plain = trainer.Trainer(trainer.TrainConfig(batch_size=BATCH, trunk=TRUNK), device="cpu")
    remat = trainer.Trainer(trainer.TrainConfig(batch_size=BATCH, trunk=TRUNK, remat=True),
                            device="cpu")
    fitted = trainer.Trainer(trainer.TrainConfig(batch_size=BATCH, trunk=TRUNK), device="cpu")
    losses = [plain.train_step(b)["loss"] for b in batches]
    assert [remat.train_step(b)["loss"] for b in batches] == losses
    _assert_same(_params_of(remat), _params_of(plain))
    logged = []
    final = fitted.fit(4, data=iter(batches), log_every=2, log_fn=lambda s, m: logged.append(s))
    assert logged == [2, 4] and final["loss"] == losses[-1]
    _assert_same(_params_of(fitted), _params_of(plain))
    for a, b in zip(fitted.state.opt_state.nu, plain.state.opt_state.nu):
        assert torch.equal(a, b)


def test_bf16_wire(monkeypatch):
    b = _batches(1)[0]
    monkeypatch.setenv("TRAIN_WIRE_DTYPE", "bf16")
    pt = trainer.Trainer(trainer.TrainConfig(batch_size=BATCH, trunk=TRUNK), device="cpu")
    x = pt.put_batch(b).tensors[0]
    assert x.dtype == torch.bfloat16
    np.testing.assert_array_equal(x.view(torch.int16).numpy(),
                                  b.x.astype(ml_dtypes.bfloat16).view(np.int16))

    def run(wire: str) -> float:
        monkeypatch.setenv("TRAIN_WIRE_DTYPE", wire)
        rng = np.random.default_rng(3)
        t = trainer.Trainer(trainer.TrainConfig(batch_size=256, trunk=TRUNK, seed=3),
                            device="cpu")

        def stream():
            while True:
                x = data.sample_features(rng, 256)
                ltv_t, churn_t = data.make_aux_targets(x)
                fraud = (rng.random(256) < 0.1).astype(np.float32)
                yield data.Batch(x=x, fraud=fraud, ltv=ltv_t, churn=churn_t)

        return t.fit(40, data=stream(), log_every=0)["loss"]

    loss_f32, loss_bf16 = run("float32"), run("bf16")
    assert abs(loss_f32 - loss_bf16) < 0.05, (loss_f32, loss_bf16)
    monkeypatch.setenv("TRAIN_WIRE_DTYPE", "bf61")
    with pytest.raises(ValueError, match="TRAIN_WIRE_DTYPE"):
        trainer.Trainer(device="cpu")


def test_mesh_raises_and_step_cost_counts():
    """A mesh trains (its parity with JAX: tests/test_torch_train_mesh.py);
    a data axis that does not divide the batch raises. ``step_cost`` counts
    a step, on one device and on a mesh, and leaves the trainer as it was
    (tests/test_torch_perfmodel.py holds the count to its formulas); a
    data x model mesh counts the unsharded step's products."""
    from igaming_platform_tpu_torch.parallel.mesh import MeshSpec, create_mesh

    cfg = trainer.TrainConfig(batch_size=BATCH, trunk=TRUNK)
    with pytest.raises(ValueError, match="not divisible"):
        trainer.Trainer(trainer.TrainConfig(batch_size=BATCH + 1, trunk=TRUNK),
                        mesh=create_mesh(MeshSpec(data=2), devices=["cpu"] * 2), device="cpu")
    costs = []
    for mesh in (None, create_mesh(MeshSpec(data=2, model=2), devices=["cpu"] * 4)):
        pt = trainer.Trainer(cfg, mesh=mesh, device="cpu")
        before = [p.detach().clone() for p in pt.state.params.parameters()]
        cost = pt.step_cost(_batches(1)[0])
        assert set(cost) == {"flops", "bytes"} and cost["flops"] > 0 and cost["bytes"] > 0
        assert pt.state.step == 0
        assert all(torch.equal(a, b) for a, b in zip(before, pt.state.params.parameters()))
        costs.append(cost)
    assert costs[1]["flops"] == costs[0]["flops"]


def test_checkpoint_roundtrip_boot_and_loop(tmp_path, monkeypatch):
    ckpt = tmp_path / "ckpt"
    t = trainer.Trainer(trainer.TrainConfig(batch_size=BATCH, trunk=TRUNK), device="cpu")
    for b in _batches(2):
        t.train_step(b)
    path = checkpoint.save_checkpoint(str(ckpt), t.state)
    assert path.endswith("step_00000002") and checkpoint.latest_checkpoint(str(ckpt)) == path
    assert [p.name for p in ckpt.iterdir()] == ["step_00000002"]  # no temporary left
    fresh = trainer.Trainer(trainer.TrainConfig(batch_size=BATCH, trunk=TRUNK, seed=1),
                            device="cpu")
    assert checkpoint.restore_trainer(fresh, str(ckpt))
    assert fresh.state.step == 2 and int(fresh.state.opt_state.count) == 2
    _assert_same(_params_of(fresh), _params_of(t))
    for a, b in zip(fresh.state.opt_state.mu + fresh.state.opt_state.nu,
                    t.state.opt_state.mu + t.state.opt_state.nu):
        assert torch.equal(a, b)

    # The file boots through FRAUD_MODEL_PATH and serves the exported params.
    monkeypatch.setenv("FRAUD_MODEL_PATH", path)
    backend, params = resolve_model_boot(RiskServiceConfig.from_env())
    assert backend == "multitask"
    direct = {"multitask": checkpoint.restore_params_for_serving(path)}
    engines = [TorchScoringEngine(ml_backend="multitask", params=p, device="cpu", warmup=False)
               for p in (params, direct, {"multitask": t.export_params()})]
    try:
        reqs = [ScoreRequest(f"ck-{i}", amount=1000 + 77 * i) for i in range(8)]
        answers = [[(r.score, r.ml_score) for r in e.score_batch(reqs)] for e in engines]
        assert answers[0] == answers[1] == answers[2]
        assert len({e.params_fingerprint for e in engines}) == 1

        # The loop resumes from the checkpoint, trains, swaps and saves.
        lp = loop.TrainingLoop(engine=engines[0], config=loop.LoopConfig(
            checkpoint_dir=str(ckpt), checkpoint_every=2, swap_every=1),
            train_config=trainer.TrainConfig(batch_size=BATCH, trunk=TRUNK), device="cpu")
        assert lp.trainer.state.step == 2
        metrics = lp.run_steps(2)
        assert set(metrics) == set(trainer.METRIC_NAMES)
        assert lp.swaps == 2 and lp.checkpoints == 1
        assert checkpoint.latest_checkpoint(str(ckpt)).endswith("step_00000004")
        assert engines[0].params_fingerprint != engines[1].params_fingerprint
    finally:
        for e in engines:
            e.close()


def test_earlier_npz_checkpoint_resumes(tmp_path):
    """The port's earlier ``step_*.npz`` form is still found, resumed and
    booted, beside the Orbax directories."""
    t = trainer.Trainer(trainer.TrainConfig(batch_size=BATCH, trunk=TRUNK), device="cpu")
    for b in _batches(2):
        t.train_step(b)
    model, opt = t.state.params, t.state.opt_state
    path = str(tmp_path / "step_00000002.npz")
    convert.save_params_tree(path, {
        "multitask": convert.multitask_to_tree(model),
        "opt_state": {"count": np.asarray(int(opt.count), np.int32),
                      "mu": convert.multitask_to_tree(model, opt.mu),
                      "nu": convert.multitask_to_tree(model, opt.nu)},
        "step": np.asarray(2, np.int64)})
    assert checkpoint.latest_checkpoint(str(tmp_path)) == path
    fresh = trainer.Trainer(trainer.TrainConfig(batch_size=BATCH, trunk=TRUNK, seed=1),
                            device="cpu")
    assert checkpoint.restore_trainer(fresh, str(tmp_path)) and fresh.state.step == 2
    _assert_same(_params_of(fresh), _params_of(t))
    assert all(torch.equal(a, b) for a, b in zip(fresh.state.opt_state.nu, opt.nu))
    backend, _ = resolve_model_boot(RiskServiceConfig(fraud_model_path=path))
    assert backend == "multitask"


def test_multitask_tree_scores_in_jax():
    from igaming_platform_tpu.core.features import normalize, standardize_for_model
    from igaming_platform_tpu.models.multitask import multitask_forward

    t = trainer.Trainer(trainer.TrainConfig(batch_size=BATCH, trunk=TRUNK), device="cpu")
    for b in _batches(2):
        t.train_step(b)
    tree = convert.multitask_to_tree(t.state.params)
    x = data.sample_features(np.random.default_rng(9), 64)
    want = np.asarray(multitask_forward(tree, standardize_for_model(normalize(x)))["fraud"])
    got = convert.multitask_from_tree(tree)
    from igaming_platform_tpu_torch.models.multitask import fraud_predict
    from igaming_platform_tpu_torch.train.distill import model_inputs

    np.testing.assert_allclose(fraud_predict(got, model_inputs(x, torch.device("cpu"))).numpy(),
                               want, rtol=1e-5, atol=1e-6)
    back = convert.train_multitask_from_tree(tree)
    _assert_same([p.detach() for p in back.parameters()], _params_of(t))
