"""Port parity: parallel/pipeline.py and train/pp.py, pipeline parallelism.

``pipeline_apply`` on a logical ``cpu`` mesh against the JAX one on the
8-device CPU mesh, from the same stacked stages (model=4 at 1, 2 and 4
microbatches, and 8 stages); its bits against the port's own sequential
stages, since ``dense_f32`` fixes every sum's order whatever the batch.
``PPTrainer`` from a JAX ``init_pp_params`` tree (``convert.pp_params_from_tree``)
against JAX's, with a mesh and without, over 10 steps at
tests/test_pp_training.py's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from igaming_platform_tpu.parallel import pipeline as jpipe
from igaming_platform_tpu.parallel.mesh import MeshSpec as JMeshSpec
from igaming_platform_tpu.parallel.mesh import create_mesh as jcreate_mesh
from igaming_platform_tpu.train import pp as jpp
from igaming_platform_tpu_torch import convert
from igaming_platform_tpu_torch.parallel import pipeline
from igaming_platform_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from igaming_platform_tpu_torch.train import pp


def _meshes(n_stages):
    return (jcreate_mesh(JMeshSpec(data=8 // n_stages, model=n_stages)),
            create_mesh(MeshSpec(data=1, model=n_stages), devices=["cpu"] * n_stages))


def _stages(n, d, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(d, d)) * 0.3).astype(np.float32),
             "b": (rng.normal(size=d) * 0.1).astype(np.float32)} for _ in range(n)]


@pytest.mark.parametrize("n_stages,microbatches", [(4, 1), (4, 2), (4, 4), (8, 4)])
def test_pipeline_apply_matches_jax(n_stages, microbatches):
    jmesh, mesh = _meshes(n_stages)
    d = 16
    stages = _stages(n_stages, d, n_stages + microbatches)
    x = np.random.default_rng(1).normal(size=(32, d)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, xx: jpipe.pipeline_apply(
        jpipe.mlp_stage_fn, p, xx, jmesh, num_microbatches=microbatches))(
            jpipe.stack_stage_params([jax.tree.map(jnp.asarray, s) for s in stages]), x))
    stacked = pipeline.stack_stage_params(stages)
    with torch.no_grad():
        got = pipeline.pipeline_apply(pipeline.mlp_stage_fn, stacked, torch.from_numpy(x), mesh,
                                      num_microbatches=microbatches)
        seq = torch.from_numpy(x)
        for s in stages:
            seq = pipeline.mlp_stage_fn({k: torch.from_numpy(v) for k, v in s.items()}, seq)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got, seq)


def test_pipeline_rejects_bad_microbatch():
    _, mesh = _meshes(4)
    stacked = pipeline.stack_stage_params(_stages(4, 8, 4))
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.pipeline_apply(pipeline.mlp_stage_fn, stacked, torch.zeros(10, 8), mesh,
                                num_microbatches=3)


def _data(n=256, in_dim=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, in_dim)).astype(np.float32)
    w = rng.normal(size=(in_dim,)).astype(np.float32)
    return x, (x @ w + 0.1 * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("with_mesh", [True, False])
def test_pp_trainer_matches_jax(with_mesh):
    n_stages = 4
    jmesh, mesh = _meshes(n_stages)
    cfg = dict(d_model=32, num_microbatches=4, seed=3)
    x, y = _data()
    jt = jpp.PPTrainer(jpp.PPTrainConfig(**cfg), in_dim=12, n_stages=n_stages,
                       mesh=jmesh if with_mesh else None)
    tree = jax.tree.map(np.asarray, jt.params)
    pt = pp.PPTrainer(pp.PPTrainConfig(**cfg), 12, n_stages, mesh if with_mesh else None,
                      device="cpu", params=convert.pp_params_from_tree(tree))
    np.testing.assert_allclose(pt.loss_fn(pt.params, x, y), float(jt.loss_fn(jt.params, x, y)),
                               rtol=1e-5)
    for _ in range(10):
        np.testing.assert_allclose(pt.train_step(x, y), jt.train_step(x, y), rtol=2e-4,
                                   atol=1e-6)
    want = jax.tree.map(np.asarray, jt.params)
    got = convert.pp_params_from_tree(want)  # JAX's stacked stages, one a stage
    for a, b in zip(pp.leaves(pt.params), pp.leaves(got)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=2e-3, atol=2e-5)


def test_pipelined_trainer_equals_sequential_and_stage_count_must_match():
    """The pipelined and sequential trainers from one init: the first loss
    bit-equal, ten steps within the JAX suite's bounds; a stage count unlike
    the ``model`` axis raises JAX's message."""
    _, mesh = _meshes(4)
    cfg = pp.PPTrainConfig(d_model=32, num_microbatches=4, seed=3)
    x, y = _data(seed=1)
    piped = pp.PPTrainer(cfg, 12, 4, mesh, device="cpu")
    seq = pp.PPTrainer(cfg, 12, 4, None, device="cpu")
    assert piped.loss_fn(piped.params, x, y) == seq.loss_fn(seq.params, x, y)
    for _ in range(10):
        np.testing.assert_allclose(piped.train_step(x, y), seq.train_step(x, y), rtol=2e-4,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="n_stages 3 != mesh 'model' axis 4"):
        pp.PPTrainer(cfg, 8, 3, mesh, device="cpu")
