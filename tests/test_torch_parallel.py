"""Port parity: parallel/{mesh,collectives,sharding,ep}.py on 8 CPU shards.

JAX runs on its 8 virtual CPU devices (tests/conftest.py); the port on a
logical mesh of 8 ``cpu`` shards. Held:

- mesh shapes and refusals, equal to JAX's;
- every collective against JAX's ``shard_map`` program on the same numpy
  input, bit for bit (sums of small integers in float32 are exact);
- the sharding specs, tuple for tuple;
- the dispatch masks (with tied gates: the lower index wins, as
  ``jax.lax.top_k`` orders them) bit for bit;
- the routed forward against the port's dense reference (bit for bit when
  nothing drops) and against JAX's routed forward: ``prob`` atol 1e-6 (the
  experts' reductions; ``tests/test_release_golden.py``'s bar), ``load``
  and ``dropped`` exact;
- model-sharded params: the port's sharded mlp+gbdt and multitask against
  the JAX sharded program, ``ml_score`` atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from test_torch_gbdt import _forest
from test_torch_models import mlp_tree, multitask_tree

from igaming_platform_tpu.core.compat import shard_map
from igaming_platform_tpu.parallel import collectives as jcoll
from igaming_platform_tpu.parallel import ep as jep
from igaming_platform_tpu.parallel import mesh as jmesh
from igaming_platform_tpu.parallel import sharding as jsharding
from igaming_platform_tpu.train.data import sample_features
from igaming_platform_tpu_torch.convert import from_jax_params
from igaming_platform_tpu_torch.core.config import ScoringConfig
from igaming_platform_tpu_torch.models import ensemble
from igaming_platform_tpu_torch.models import multitask as mt
from igaming_platform_tpu_torch.parallel import collectives as coll
from igaming_platform_tpu_torch.parallel import ep
from igaming_platform_tpu_torch.parallel import mesh as pmesh
from igaming_platform_tpu_torch.parallel import sharding

CPU8 = ["cpu"] * 8


def jax_mesh(**axes):
    return jmesh.create_mesh(jmesh.MeshSpec(**axes), devices=jax.devices()[:8])


def port_mesh(**axes):
    return pmesh.create_mesh(pmesh.MeshSpec(**axes), devices=CPU8)


@pytest.mark.parametrize("spec,n", [
    (dict(data=-1), 8), (dict(data=-1, model=2), 8), (dict(data=2, model=2, seq=2), 8),
    (dict(data=3), 8), (dict(data=-1, model=3), 8), (dict(data=2, expert=4), 8),
    (dict(model=0), 4)])
def test_mesh_spec_resolution(spec, n):
    """Resolutions and refusals equal to JAX's; a logical mesh's axes."""
    try:
        want = jmesh.MeshSpec(**spec).resolve(n)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)[:20]):
            pmesh.MeshSpec(**spec).resolve(n)
        return
    assert pmesh.MeshSpec(**spec).resolve(n) == want
    if n == 8:
        mesh = port_mesh(**spec)
        assert mesh.shape == dict(jax_mesh(**spec).shape) and mesh.logical
        assert mesh.device == torch.device("cpu")


def test_mesh_helpers():
    mesh = port_mesh(data=-1, model=2)
    pmesh.validate_batch_for_mesh(64, mesh)
    with pytest.raises(ValueError):
        pmesh.validate_batch_for_mesh(63, mesh)
    assert pmesh.mesh_axis_size(pmesh.single_device_mesh("cpu"), "data") == 1
    assert [pmesh.pow2_floor(n) for n in (0, 1, 5, 64, 100)] == [
        jmesh.pow2_floor(n) for n in (0, 1, 5, 64, 100)]
    assert pmesh.auto_spec() == pmesh.MeshSpec(data=-1)
    assert pmesh.best_effort_mesh(model=3, devices=CPU8).shape["data"] == 8
    # The environment's entry point counts CUDA devices and never repeats
    # one: with none visible, any MESH_DEVICES fails with JAX's message.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="MESH_DEVICES=2 but only 0 devices visible"):
            pmesh.devices_from_env(2)


def _jax_collective(name, x):
    mesh = jax_mesh(data=-1)
    d = jmesh.AXIS_DATA
    body, ins, outs = {
        "psum": (lambda v: jcoll.psum(v, d), JP(d), JP()),
        "pmax": (lambda v: jcoll.pmax(v, d), JP(d), JP()),
        "pmean": (lambda v: jcoll.pmean(v, d), JP(d), JP()),
        "all_gather": (lambda v: jcoll.all_gather(v, d), JP(d), JP(None)),
        "ppermute_ring": (lambda v: jcoll.ppermute_ring(v, d, shift=3), JP(d), JP(d)),
        "reduce_scatter": (lambda v: jcoll.reduce_scatter(v, d), JP(), JP(d)),
        "all_to_all": (lambda v: jcoll.all_to_all(v, d, split_axis=1, concat_axis=0),
                       JP(d, None), JP(None, d)),
    }[name]
    return np.asarray(jax.jit(shard_map(body, mesh=mesh, in_specs=ins, out_specs=outs,
                                        check_vma=False))(x))


@pytest.mark.parametrize("name", ["psum", "pmax", "pmean", "all_gather", "ppermute_ring",
                                  "reduce_scatter", "all_to_all"])
def test_collectives_match_jax(name):
    x = np.arange(64, dtype=np.float32).reshape(8, 8) * 0.5 - 7.0
    want = _jax_collective(name, x)
    t = torch.from_numpy(x)
    rows = list(torch.chunk(t, 8))
    if name == "psum":
        got = coll.psum(rows)[0]
    elif name == "pmax":
        got = coll.pmax(rows)[0]
    elif name == "pmean":
        got = coll.pmean(rows)[0]
    elif name == "all_gather":
        got = coll.all_gather(rows)[0]
    elif name == "ppermute_ring":
        got = torch.cat(coll.ppermute_ring(rows, shift=3))
    elif name == "reduce_scatter":
        got = torch.cat(coll.reduce_scatter([t] * 8))
    else:
        got = torch.cat(coll.all_to_all(rows, split_axis=1, concat_axis=0), dim=1)
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)


def test_shard_batch_and_replicate():
    mesh = port_mesh(data=-1)
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    shards = coll.shard_batch(mesh, x)
    assert [tuple(s.shape) for s in shards] == [(2, 2)] * 8
    np.testing.assert_array_equal(coll.unshard_rows(shards).numpy(), x)
    assert all(torch.equal(r, torch.from_numpy(x)) for r in coll.replicate(mesh, x))
    with pytest.raises(ValueError):
        coll.row_bounds(10, 4)


def _specs(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda v: isinstance(v, JP))


@pytest.mark.parametrize("backend", ["mlp", "gbdt", "mlp+gbdt", "multitask", "mock", "routed"])
def test_sharding_specs_match_jax(backend):
    trees = {"mlp": mlp_tree(1), "gbdt": _forest(2), "multitask": multitask_tree(3)}
    params = {k: trees[k] for k in ("mlp", "gbdt", "multitask")
              if k in backend or backend == "routed"}
    want = jsharding.model_param_specs(backend, params)
    got = sharding.model_param_specs(backend, params)
    if want is None:
        assert got is None
        return
    for key, spec in got.items():
        assert spec == _specs(want[key]), key
    assert _specs(jsharding.gbdt_param_specs()) == sharding.gbdt_param_specs()
    assert _specs(jsharding.seq_activation_spec()) == sharding.seq_activation_spec()
    assert _specs(jsharding.batch_spec(3)) == sharding.batch_spec(3)
    if backend == "multitask":
        port_model = from_jax_params("multitask", {"multitask": trees["multitask"]})
        assert mt.param_specs(port_model["multitask"]) == got["multitask"]


TIED = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1], [0.3, 0.3, 0.2, 0.2],
                 [0.0, 0.5, 0.0, 0.5], [0.2, 0.2, 0.3, 0.3]], np.float32)


@pytest.mark.parametrize("gates,capacity", [
    ("tied", 2), ("tied", 16), ("random", 3), ("random", 64)])
def test_dispatch_masks_match_jax(gates, capacity):
    """Dispatch, combine and kept bit for bit, ties broken by index."""
    if gates == "tied":
        g = np.tile(TIED, (4, 1))
    else:
        g = np.random.default_rng(7).dirichlet(np.ones(4), 40).astype(np.float32)
    jd, jc, jk = (np.asarray(a) for a in jep._dispatch_masks(jnp.asarray(g), 2, capacity))
    pd, pc, pk = (a.numpy() for a in ep.dispatch_tensors(torch.from_numpy(g), 2, capacity))
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pc.view(np.int32), jc.view(np.int32))
    jv, ji = jax.lax.top_k(jnp.asarray(g), 2)
    pv, pi = ep.top_k(torch.from_numpy(g), 2)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


def _routed_tree(seed=0, hidden=(32, 32), trunk=(32, 32)):
    rng = np.random.default_rng(seed)
    return {"router": (rng.normal(size=(30, 4)) * 0.01).astype(np.float32),
            "mlp": mlp_tree(seed + 1, hidden), "gbdt": _forest(seed + 2, 8, 3),
            "multitask": multitask_tree(seed + 3, trunk)}


def _jax_experts():
    from igaming_platform_tpu.models.ensemble import routed_experts

    return routed_experts()[0]


@pytest.mark.parametrize("axes,rows,factor", [
    (dict(expert=4), ("expert",), 4.0), (dict(data=2, expert=4), ("data", "expert"), 4.0),
    (dict(data=2, expert=4), ("data", "expert"), 0.5),
    (dict(data=2, expert=4), ("data",), 4.0)])
def test_routed_forward_matches_dense_and_jax(axes, rows, factor):
    tree = _routed_tree()
    x = sample_features(np.random.default_rng(5), 64)
    n = int(np.prod(list(axes.values())))
    jm = jmesh.create_mesh(jmesh.MeshSpec(**axes), devices=jax.devices()[:n])
    pm = pmesh.create_mesh(pmesh.MeshSpec(**axes), devices=["cpu"] * n)
    jparams = (None, tree["mlp"], tree["gbdt"], tree["multitask"])
    want = jep.routed_ensemble_forward(jnp.asarray(tree["router"]), jparams, x, mesh=jm,
                                       expert_fns=_jax_experts(), k=2, capacity_factor=factor,
                                       shard_rows_over=rows)
    port = from_jax_params("routed", tree)
    fns, keys = ensemble.routed_experts()
    eparams = tuple(port.get(k) for k in keys)
    got = ep.routed_ensemble_forward(port["router"], eparams, x, mesh=pm, expert_fns=fns,
                                     k=2, capacity_factor=factor, shard_rows_over=rows)
    np.testing.assert_array_equal(got["load"].numpy(), np.asarray(want["load"]))
    assert int(got["dropped"]) == int(want["dropped"])
    np.testing.assert_allclose(got["prob"].numpy(), np.asarray(want["prob"]), rtol=0, atol=1e-6)
    if factor >= 4.0:
        assert int(got["dropped"]) == 0
        ref = ep.dense_reference(port["router"], eparams, torch.from_numpy(x), expert_fns=fns)
        np.testing.assert_array_equal(got["prob"].numpy().view(np.int32),
                                      ref.numpy().view(np.int32))
    else:
        assert int(got["dropped"]) > 0


def test_routed_score_fn_and_bad_expert_axis():
    """``routed`` through make_score_fn over data x expert equals the
    unsharded mix; an expert axis of another size raises."""
    tree = _routed_tree(1)
    port = from_jax_params("routed", tree)
    x = sample_features(np.random.default_rng(0), 64)
    bl = np.zeros(64, bool)
    dense = ensemble.make_score_fn(ScoringConfig(), "routed", device="cpu")(port, x, bl)
    mesh = port_mesh(data=2, expert=4)
    sharded = ensemble.make_score_fn(ScoringConfig(), "routed", device="cpu",
                                     mesh=mesh)(port, x, bl)
    for key in dense:
        np.testing.assert_array_equal(sharded[key].numpy(), dense[key].numpy(), err_msg=key)
    assert dense["ml_score"].std() > 0
    with pytest.raises(ValueError, match="MESH_EXPERT=4"):
        ensemble.make_score_fn(ScoringConfig(), "routed", device="cpu",
                               mesh=port_mesh(data=4, expert=2))


@pytest.mark.parametrize("backend,axes", [
    ("mlp+gbdt", dict(data=2, model=2, expert=2)), ("multitask", dict(data=4, model=2)),
    ("gbdt", dict(data=1, expert=8))])
def test_model_sharded_params_match_jax(backend, axes):
    """The port's sharded forest and trunks against the JAX SPMD program
    with the same specs, and against the port's unsharded params."""
    trees = {"mlp": mlp_tree(4), "gbdt": _forest(5), "multitask": multitask_tree(6)}
    keys = {"mlp+gbdt": ("mlp", "gbdt"), "multitask": ("multitask",), "gbdt": ("gbdt",)}[backend]
    tree = {k: trees[k] for k in keys}
    from igaming_platform_tpu.core.config import ScoringConfig as JScoringConfig
    from igaming_platform_tpu.models.ensemble import make_score_fn as jmake

    rng = np.random.default_rng(9)
    x = sample_features(rng, 64)
    bl = rng.random(64) < 0.1
    jm = jax_mesh(**axes)
    jparams = jsharding.shard_model_params(jm, backend, jax.tree.map(jnp.asarray, tree))
    want = jax.jit(jmake(JScoringConfig(), backend))(jparams, x, bl)
    port = from_jax_params(backend, tree)
    sharded = sharding.shard_model_params(port_mesh(**axes), backend, port)
    assert sharded is not port and any(type(sharded[k]) is not type(port[k]) for k in keys)
    fn = ensemble.make_score_fn(ScoringConfig(), backend, device="cpu")
    got, plain = fn(sharded, x, bl), fn(port, x, bl)
    np.testing.assert_allclose(got["ml_score"].numpy(), np.asarray(want["ml_score"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["ml_score"].numpy(), plain["ml_score"].numpy(),
                               rtol=0, atol=1e-6)
    for key in ("rule_score", "reason_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
