"""Port parity: the soft forest and distillation (``models/gbdt.py``,
``train/distill.py``) against the JAX package's, on the CPU, at a small size
(8 trees of depth 3, an MLP of (32, 32), batch 64).

One JAX init goes to both (monkeypatched into the port's ``init_gbdt`` and
``init_mlp``; the port cannot draw JAX's numbers). The soft forest's forward
holds at rtol/atol 1e-6 and its gradients in ``thr``, ``leaves`` and ``bias``
at 1e-5; five distillation steps give JAX's losses at rtol 1e-4 (the JAX
recipe's losses are computed here, step by step, with the JAX package's
functions and ``optax.adam``); the distilled ``{"mlp", "gbdt"}`` serve in a
port ``mlp+gbdt`` engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from igaming_platform_tpu.core.features import normalize as jnormalize
from igaming_platform_tpu.core.features import standardize_for_model as jstandardize
from igaming_platform_tpu.models import gbdt as jgbdt
from igaming_platform_tpu.models import mlp as jmlp
from igaming_platform_tpu.train import distill as jdistill
from igaming_platform_tpu_torch import convert
from igaming_platform_tpu_torch.models import gbdt as pgbdt
from igaming_platform_tpu_torch.models import mlp as pmlp
from igaming_platform_tpu_torch.serve.scorer import ScoreRequest, TorchScoringEngine
from igaming_platform_tpu_torch.train import distill

CFG = dict(steps=5, batch_size=64, n_trees=8, depth=3, mlp_hidden=(32, 32), seed=0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _forest(seed=0):
    return jax.tree.map(np.asarray, jgbdt.init_gbdt(jax.random.key(seed), n_trees=8, depth=3))


def _port_forest(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.fixture
def jax_inits(monkeypatch):
    """The port's initialisers return the JAX package's draws."""
    monkeypatch.setattr(pgbdt, "init_gbdt", lambda gen, n_trees, depth: _port_forest(
        jax.tree.map(np.asarray, jgbdt.init_gbdt(jax.random.key(CFG["seed"]), n_trees=n_trees,
                                                 depth=depth))))

    def init_mlp(gen, hidden):
        tree = jmlp.init_mlp(jax.random.key(CFG["seed"] + 7), hidden=hidden)
        return pmlp.TrainMLP([pmlp.TrainDense(torch.from_numpy(np.array(l["w"])),
                                              torch.from_numpy(np.array(l["b"])))
                              for l in tree["layers"]])

    monkeypatch.setattr(pmlp, "init_mlp", init_mlp)


@pytest.mark.parametrize("temperature", [5.0, 50.0, 200.0])
def test_soft_forest_forward_and_gradients(temperature):
    tree = _forest()
    rng = np.random.default_rng(1)
    x = rng.random((64, 30)).astype(np.float32)
    y = (rng.random(64) < 0.3).astype(np.float32)

    def jloss(tr):
        pred = jgbdt.soft_gbdt_predict({"feat": tree["feat"], **tr}, x, temperature=temperature)
        return jnp.mean((pred - y) ** 2)

    jtr = {k: jnp.asarray(tree[k]) for k in ("thr", "leaves", "bias")}
    want_raw = np.asarray(jgbdt.soft_gbdt_raw(tree, x, temperature))
    jl, jg = jax.value_and_grad(jloss)(jtr)

    params = _port_forest(tree)
    for k in ("thr", "leaves", "bias"):
        params[k].requires_grad_(True)
    got_raw = pgbdt.soft_gbdt_raw(params, torch.from_numpy(x), temperature)
    np.testing.assert_allclose(got_raw.detach().numpy(), want_raw, rtol=1e-6, atol=1e-6)
    loss = torch.mean((pgbdt.soft_gbdt_predict(params, torch.from_numpy(x), temperature)
                       - torch.from_numpy(y)) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    for k in ("thr", "leaves", "bias"):
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(jg[k]), err_msg=k, **TOL)


def _jax_gbdt_losses(cfg, data_fn):
    """The JAX ``distill_gbdt`` recipe, step by step, with its losses."""
    params = jgbdt.init_gbdt(jax.random.key(cfg.seed), n_trees=cfg.n_trees, depth=cfg.depth)
    feat = params["feat"]
    tr = {"thr": params["thr"], "leaves": params["leaves"], "bias": params["bias"]}
    opt = optax.adam(cfg.learning_rate)
    state = opt.init(tr)

    def loss_fn(t, xn, y, temp):
        return jnp.mean((jgbdt.soft_gbdt_predict({"feat": feat, **t}, xn, temp) - y) ** 2)

    step = jax.jit(jax.value_and_grad(loss_fn))
    rng = np.random.default_rng(cfg.seed)
    losses = []
    for i in range(cfg.steps):
        x_raw, y = data_fn(rng, cfg.batch_size)
        temp = cfg.temp_start * (cfg.temp_end / cfg.temp_start) ** (i / max(cfg.steps - 1, 1))
        loss, grads = step(tr, jstandardize(jnormalize(x_raw)), jnp.asarray(y), temp)
        updates, state = opt.update(grads, state)
        tr = optax.apply_updates(tr, updates)
        losses.append(float(loss))
    return losses, tr


def test_distill_gbdt_steps_match_jax(jax_inits, monkeypatch):
    cfg = distill.DistillConfig(**CFG)
    losses = []
    real = distill._adam_step

    def recording(params, loss, state, lr):
        losses.append(float(loss.detach()))
        return real(params, loss, state, lr)

    monkeypatch.setattr(distill, "_adam_step", recording)
    params, mae = distill.distill_gbdt(cfg, device="cpu")

    def data_fn(rng, bs):
        x = jdistill.sample_features(rng, bs)
        return x, jdistill.default_teacher(x)

    want, jtr = _jax_gbdt_losses(jdistill.DistillConfig(**CFG), data_fn)
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    for k in ("thr", "leaves", "bias"):
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jtr[k]), rtol=1e-4, atol=1e-6)
    jparams, jmae = jdistill.distill_gbdt(jdistill.DistillConfig(**CFG))
    np.testing.assert_allclose(mae, jmae, rtol=1e-4)


def test_distilled_params_serve(jax_inits):
    cfg = distill.DistillConfig(**CFG)
    params, maes = distill.distill_serving_params(cfg, device="cpu")
    jparams, jmaes = jdistill.distill_serving_params(jdistill.DistillConfig(**CFG))
    for k in ("mlp_mae", "gbdt_mae"):
        np.testing.assert_allclose(maes[k], jmaes[k], rtol=1e-3, err_msg=k)
    # The MLP student's layers against JAX's: bf16 rounding of close weights.
    for layer, jl in zip(params["mlp"].layers, jparams["mlp"]["layers"]):
        np.testing.assert_allclose(layer.b.numpy(), np.asarray(jl["b"]), rtol=1e-4, atol=1e-6)
    engine = TorchScoringEngine(ml_backend="mlp+gbdt", params=params, device="cpu",
                                warmup=False)
    twin = TorchScoringEngine(ml_backend="mlp+gbdt", params=convert.from_jax_params(
        "mlp+gbdt", {"mlp": jax.tree.map(np.asarray, jparams["mlp"]),
                     "gbdt": jax.tree.map(np.asarray, jparams["gbdt"])}), device="cpu",
                              warmup=False)
    try:
        reqs = [ScoreRequest(f"ds-{i}", amount=500 + 991 * i) for i in range(16)]
        got = engine.score_batch(reqs)
        want = twin.score_batch(reqs)
        assert all(0 <= r.score <= 100 and np.isfinite(r.ml_score) for r in got)
        np.testing.assert_allclose([r.ml_score for r in got], [r.ml_score for r in want],
                                   atol=2e-3)
    finally:
        engine.close()
        twin.close()
