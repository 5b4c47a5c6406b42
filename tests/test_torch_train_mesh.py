"""Port parity: multi-device training, and serving with a replica per device.

JAX trains on its 8 virtual CPU devices; the port on logical ``cpu`` meshes
of the same shape, from the JAX inits carried across by ``convert.py``:

- ``Trainer(mesh=)`` over data=4 x model=2 against JAX's ``Trainer(mesh=)``,
  6 steps, stepped, through ``fit``'s sharded ``put_batch``, and on a bf16
  wire, at tests/test_train.py's bounds (loss rel 2e-4, ``fraud_mae`` rel
  2e-3);
- a mesh whose data coordinates hold distinct devices (``cpu`` and
  ``cpu:0``, which torch tells apart) keeps one replica each; they stay
  bit-equal and train as the unsharded trainer does;
- ``train_abuse_detector`` in ring and Ulysses mode over data=2 x seq=2
  against the JAX loss differentiated through its ``shard_map``, 3 steps of
  ``optax.adam``, at the ring forward's bound (rtol 2e-4);
- ``train_routed_on_labels``, 5 steps of batch 64, against JAX's loop from
  the same ``init_routed_params`` tree: losses and ``routed_prob``;
- ``gbdt_raw_matmul`` against JAX's, and against ``gbdt_raw`` bit for bit;
- ``serve/scorer.data_sharded``: one params replica per distinct data
  device (none added on a logical mesh), answers equal to the unsharded
  engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from igaming_platform_tpu.models import ensemble as jensemble
from igaming_platform_tpu.models import gbdt as jgbdt
from igaming_platform_tpu.models import sequence as jseq
from igaming_platform_tpu.ops import gbdt_matmul as jgm
from igaming_platform_tpu.parallel import mesh as jmesh
from igaming_platform_tpu.train import routed as jrouted
from igaming_platform_tpu.train import trainer as jtrainer
from igaming_platform_tpu.train.abuse_train import make_abuse_batch
from igaming_platform_tpu.train.data import make_stream as jmake_stream
from igaming_platform_tpu.train.fraudgen import generate_labeled
from igaming_platform_tpu_torch import convert
from igaming_platform_tpu_torch.core.config import BatcherConfig
from igaming_platform_tpu_torch.models import gbdt as pgbdt
from igaming_platform_tpu_torch.models.sequence import SeqConfig
from igaming_platform_tpu_torch.ops import gbdt_matmul
from igaming_platform_tpu_torch.parallel import mesh as pmesh
from igaming_platform_tpu_torch.parallel.sharding import DataReplicas
from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine
from igaming_platform_tpu_torch.train import abuse_train, routed, trainer
from igaming_platform_tpu_torch.train.data import make_stream

CFG = dict(batch_size=64, trunk=(32, 16))


def meshes(devices=None, **axes):
    n = int(np.prod(list(axes.values())))
    return (jmesh.create_mesh(jmesh.MeshSpec(**axes), devices=jax.devices()[:n]),
            pmesh.create_mesh(pmesh.MeshSpec(**axes), devices=devices or ["cpu"] * n))


@pytest.mark.parametrize("how", ["step", "fit", "bf16"])
def test_trainer_over_data_and_model_matches_jax(how, monkeypatch):
    if how == "bf16":
        monkeypatch.setenv("TRAIN_WIRE_DTYPE", "bf16")
    jm, pm = meshes(data=4, model=2)
    jt = jtrainer.Trainer(jtrainer.TrainConfig(**CFG), mesh=jm)
    tree = jax.tree.map(np.asarray, jt.state.params)
    monkeypatch.setattr(trainer, "init_multitask",
                        lambda gen, trunk: convert.train_multitask_from_tree(tree))
    pt = trainer.Trainer(trainer.TrainConfig(**CFG), mesh=pm, device="cpu")
    assert len(pt.replicas) == 1  # a logical mesh: one replica
    if how == "fit":
        pairs = [(pt.fit(6, data=make_stream(64, seed=9)), jt.fit(6, data=jmake_stream(64, seed=9)))]
    else:
        ps, js = make_stream(64, seed=9), jmake_stream(64, seed=9)
        pairs = [(pt.train_step(next(ps)), jt.train_step(next(js))) for _ in range(6)]
    for got, want in pairs:
        assert got["loss"] == pytest.approx(want["loss"], rel=2e-4)
        assert got["fraud_mae"] == pytest.approx(want["fraud_mae"], rel=2e-3)
    served = pt.export_params()
    jtrunk = jax.tree.map(np.asarray, jt.export_params())["trunk"]["layers"]
    for layer, want in zip(served.trunk, jtrunk):
        np.testing.assert_allclose(layer.b.numpy(), want["b"], rtol=1e-3, atol=1e-5)


def test_replicas_on_distinct_devices_stay_equal():
    """``cpu`` and ``cpu:0`` are distinct devices to torch: data=2 x model=2
    over them keeps two replicas, each trunk split over its own pair."""
    mesh = pmesh.create_mesh(pmesh.MeshSpec(data=2, model=2),
                             devices=["cpu", "cpu", "cpu:0", "cpu:0"])
    assert mesh.data_replicas() == [0, 1]
    pt = trainer.Trainer(trainer.TrainConfig(**CFG), mesh=mesh, device="cpu")
    single = trainer.Trainer(trainer.TrainConfig(**CFG), device="cpu")
    assert len(pt.replicas) == 2 and pt.replicas[1].trunk.devices == [torch.device("cpu", 0)] * 2
    got = pt.fit(4, data=make_stream(64, seed=5))
    want = single.fit(4, data=make_stream(64, seed=5))
    assert got["loss"] == pytest.approx(want["loss"], rel=2e-4)
    for a, b in zip(*(list(r.parameters()) for r in pt.replicas)):
        assert torch.equal(a, b)
    assert pt.state.step == 4 and pt.state.opt_state.count.item() == 4


SMALL_SEQ = dict(d_model=32, n_heads=4, n_layers=1, d_ff=64)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sequence_sharded_abuse_training_matches_jax(mode, monkeypatch):
    jm, pm = meshes(data=2, seq=2)
    jcfg = jseq.SeqConfig(**SMALL_SEQ)
    tree = jax.tree.map(np.asarray, jseq.init_sequence_model(jax.random.key(4), jcfg))

    def loss_fn(p, x, y):
        out = jseq.sequence_forward(p, x, jcfg, mesh=jm, seq_mode=mode)
        return jnp.mean(optax.sigmoid_binary_cross_entropy(out["abuse_logit"], y))

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    opt = optax.adam(1e-3)
    params, state, want = tree, opt.init(tree), []
    rng = np.random.default_rng(0)
    for _ in range(3):
        loss, grads = value_and_grad(params, *make_abuse_batch(rng, 8, 16))
        updates, state = opt.update(grads, state)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))
    monkeypatch.setattr(abuse_train, "init_sequence_model",
                        lambda cfg, seed=0: convert.sequence_from_tree(tree, cfg))
    cfg = abuse_train.AbuseTrainConfig(steps=3, batch_size=8, seq_len=16,
                                       model=SeqConfig(**SMALL_SEQ))
    _, metrics = abuse_train.train_abuse_detector(cfg, mesh=pm, seq_mode=mode, device="cpu")
    np.testing.assert_allclose(metrics["losses"], want, rtol=2e-4, atol=0)


def test_routed_training_matches_jax(monkeypatch):
    cfg = jrouted.RoutedTrainConfig(steps=5, batch_size=64, seed=7)
    x, y, _ = generate_labeled(np.random.default_rng(7), 2000)
    init = jensemble.init_routed_params(jax.random.key(7), mlp_hidden=cfg.mlp_hidden,
                                        n_trees=cfg.n_trees, depth=cfg.depth, trunk=cfg.trunk)
    # The JAX trainer's loop, its losses kept.
    feat = init["gbdt"]["feat"]
    tr = {"router": init["router"], "mlp": init["mlp"], "multitask": init["multitask"],
          "gbdt": {k: v for k, v in init["gbdt"].items() if k != "feat"}}

    def loss_fn(tr, xb, yb, temp):
        p = {**tr, "mock": None, "gbdt": {"feat": feat, **tr["gbdt"]}}
        mix, gates, top_idx = jrouted.routed_mixture(p, xb, cfg.k, temp)
        bce = -jnp.mean(yb * jnp.log(mix + 1e-6) + (1.0 - yb) * jnp.log(1.0 - mix + 1e-6))
        return bce + cfg.load_balance_weight * jrouted.load_balance_loss(gates, top_idx)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    opt = optax.adam(cfg.learning_rate)
    state, want, rng = opt.init(tr), [], np.random.default_rng(cfg.seed)
    for i in range(cfg.steps):
        idx = rng.integers(0, x.shape[0], cfg.batch_size)
        temp = np.float32(cfg.temp_start * (cfg.temp_end / cfg.temp_start) ** (i / (cfg.steps - 1)))
        loss, grads = value_and_grad(tr, x[idx], y[idx].astype(np.float32), temp)
        updates, state = opt.update(grads, state)
        tr = optax.apply_updates(tr, updates)
        want.append(float(loss))
    jparams = {**tr, "mock": None, "gbdt": {"feat": feat, **tr["gbdt"]}}

    monkeypatch.setattr(routed, "init_routed_train_params", lambda seed, **kw:
                        convert.routed_train_from_tree(jax.tree.map(np.asarray, init)))
    losses = []
    bundle = routed.train_routed_on_labels(
        x, y, routed.RoutedTrainConfig(steps=5, batch_size=64, seed=7), device="cpu",
        losses=losses)
    np.testing.assert_allclose([float(v) for v in losses], want, rtol=1e-5)
    x_test, _, _ = generate_labeled(np.random.default_rng(8), 500)
    np.testing.assert_allclose(routed.routed_prob(bundle, x_test),
                               jrouted.routed_prob(jparams, x_test), rtol=0, atol=1e-6)
    assert set(bundle) == {"router", "mock", "mlp", "gbdt", "multitask"}


@pytest.mark.parametrize("n_trees,depth", [(32, 4), (64, 6)])
def test_gbdt_raw_matmul_matches_jax_and_the_gather(n_trees, depth):
    params = jgbdt.init_gbdt(jax.random.key(n_trees), n_trees=n_trees, depth=depth)
    x = np.random.default_rng(depth).random((256, 30)).astype(np.float32)
    sel = gbdt_matmul.precompute_selector(np.asarray(params["feat"]), 30)
    np.testing.assert_array_equal(sel, jgm.precompute_selector(np.asarray(params["feat"]), 30))
    port = convert.gbdt_from_tree(jax.tree.map(np.asarray, params))
    got = gbdt_matmul.gbdt_raw_matmul(port, sel, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgm.gbdt_raw_matmul(params, sel, x)),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got, pgbdt.gbdt_raw(port, torch.from_numpy(x)))


def _serving_params(backend):
    from igaming_platform_tpu_torch.models import mlp as pmlp
    from igaming_platform_tpu_torch.models.ensemble import init_routed_params
    from igaming_platform_tpu_torch.models.multitask import init_multitask

    gen = torch.Generator().manual_seed(3)
    if backend == "routed":
        return init_routed_params(3, mlp_hidden=(32, 32), n_trees=16, trunk=(32, 32))
    if backend == "multitask":
        return {"multitask": init_multitask(gen, trunk=(32, 32)).serving()}
    return {"mlp": pmlp.init_mlp(gen, hidden=(32, 32)).serving(),
            "gbdt": pgbdt.init_gbdt(gen, n_trees=16, depth=4)}


@pytest.mark.parametrize("backend,axes", [("mlp+gbdt", dict(data=2)),
                                          ("multitask", dict(data=2, model=2)),
                                          ("routed", dict(data=2, expert=4))])
def test_data_sharded_keeps_a_replica_per_distinct_device(backend, axes):
    """A logical mesh installs one replica; a mesh whose second data
    coordinate holds other devices installs one more, laid there (its trunk
    split over that coordinate's model devices). Both answer as the
    unsharded engine does: bit for bit where nothing is model-sharded."""
    n = int(np.prod(list(axes.values())))
    params = _serving_params(backend)
    bcfg = BatcherConfig(batch_size=64, latency_tiers=(16,), max_wait_ms=1.0)
    plain = TorchScoringEngine(ml_backend=backend, params=params, device="cpu",
                               batcher_config=bcfg)
    engines = [TorchScoringEngine(ml_backend=backend, params=params, device="cpu",
                                  batcher_config=bcfg,
                                  mesh=pmesh.create_mesh(pmesh.MeshSpec(**axes), devices=devs))
               for devs in (["cpu"] * n, ["cpu"] * (n // 2) + ["cpu:0"] * (n // 2))]
    try:
        logical, distinct = (e.get_params() for e in engines)
        assert not isinstance(logical, DataReplicas)
        assert isinstance(distinct, DataReplicas) and list(distinct.replicas) == [1]
        if backend == "multitask":
            assert distinct.at(1)["multitask"].trunk.devices == [torch.device("cpu", 0)] * 2
        rng = np.random.default_rng(1)
        for rows in (16, 64):
            x = rng.random((rows, 30)).astype(np.float32) * 100
            bl = rng.random(rows) < 0.1
            ref = plain._readback(plain._launch(x, bl, plain.get_params()))
            got = [e._readback(e._launch(x, bl, e.get_params())) for e in engines]
            for key in ref:
                np.testing.assert_array_equal(got[1][key], got[0][key], err_msg=key)
                if engines[0]._model_sharded:
                    np.testing.assert_allclose(got[0][key], ref[key], rtol=0, atol=1e-3)
                else:
                    np.testing.assert_array_equal(got[0][key], ref[key], err_msg=key)
    finally:
        for e in (plain, *engines):
            e.close()
