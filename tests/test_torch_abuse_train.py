"""Port parity: train/abuse_train.py, the bonus-abuse detector's trainer.

One JAX params tree (``init_sequence_model`` with biases and norms nudged off
their init values) goes to the JAX loss and, through
``convert.sequence_from_tree``, to the port. At a small config (d_model 32,
4 heads of 8, 1 layer, d_ff 64, batch 8, S 16) the port's step-0 loss and
every parameter's gradient match ``jax.value_and_grad`` of the JAX trainer's
loss at rtol/atol 2e-4 (float32 through a layer and its backward, sums in
another order), and three steps of ``train_abuse_detector`` give the losses
of three ``optax.adam`` steps at rtol 1e-4. The batch generator is a numpy
copy and must be bit-equal. The JAX ``train_abuse_detector`` itself is not
called here: tests/test_abuse_train.py runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from igaming_platform_tpu.models import sequence as jseq
from igaming_platform_tpu.train.abuse_train import make_abuse_batch as jmake_abuse_batch
from igaming_platform_tpu_torch.convert import sequence_from_tree, sequence_to_tree
from igaming_platform_tpu_torch.models.sequence import SeqConfig
from igaming_platform_tpu_torch.serve.abuse import SequenceAbuseDetector
from igaming_platform_tpu_torch.train import abuse_train

SMALL = dict(d_model=32, n_heads=4, n_layers=1, d_ff=64)
BATCH, SEQ, STEPS, LR = 8, 16, 3, 1e-3
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    tree = jseq.init_sequence_model(jax.random.key(seed), jseq.SeqConfig(**SMALL))
    return jax.tree.map(lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.02)
                        .astype(np.float32), tree)


def _jax_loss(p, x, y):
    out = jseq.sequence_forward(p, x, jseq.SeqConfig(**SMALL))
    return jnp.mean(optax.sigmoid_binary_cross_entropy(out["abuse_logit"], y))


_jax_value_and_grad = jax.jit(jax.value_and_grad(_jax_loss))


@pytest.mark.parametrize("seed", [0, 5])
def test_batches_bit_equal(seed):
    for args in ((64, 32), (5, 7)):
        got = abuse_train.make_abuse_batch(np.random.default_rng(seed), *args)
        want = jmake_abuse_batch(np.random.default_rng(seed), *args)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_step0_loss_and_every_gradient_match_jax():
    tree = _tree()
    x, y = jmake_abuse_batch(np.random.default_rng(1), BATCH, SEQ)
    loss, grads = _jax_value_and_grad(tree, x, y)
    model = sequence_from_tree(tree, SeqConfig(**SMALL))
    got = abuse_train.train_step(model, abuse_train.make_optimizer(model, LR), x, y)
    np.testing.assert_allclose(float(got), float(loss), **GRAD_TOL)
    flat, _ = jax.tree_util.tree_flatten_with_path(grads)
    want = {jax.tree_util.keystr(path): np.asarray(g) for path, g in flat}
    paths = _param_paths(len(tree["layers"]))
    named = dict(model.named_parameters())
    assert sorted(paths[name] for name in named) == sorted(want)
    for name, p in named.items():
        assert p.grad is not None and p.grad.abs().max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[paths[name]], err_msg=name, **GRAD_TOL)


def _param_paths(n_layers: int) -> dict:
    """The port's parameter names -> the JAX tree's key paths."""
    out = {}
    for mod, keys in (("embed", ("w", "b")), ("ln_f", ("scale", "bias")), ("head", ("w", "b"))):
        out.update({f"{mod}.{k}": f"['{mod}']['{k}']" for k in keys})
    for i in range(n_layers):
        for mod in ("ln1", "ln2"):
            out.update({f"layers.{i}.{mod}.{k}": f"['layers'][{i}]['{mod}']['{k}']"
                        for k in ("scale", "bias")})
        for mod in ("wqkv", "wo", "w1", "w2"):
            out.update({f"layers.{i}.{mod}.{k}": f"['layers'][{i}]['{mod}']['{k}']"
                        for k in ("w", "b")})
    return out


def test_three_adam_steps_match_optax(monkeypatch):
    tree = _tree(2)
    opt = optax.adam(LR)
    params, state = tree, opt.init(tree)
    rng = np.random.default_rng(0)
    want = []
    for _ in range(STEPS):
        loss, grads = _jax_value_and_grad(params, *jmake_abuse_batch(rng, BATCH, SEQ))
        updates, state = opt.update(grads, state)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))

    monkeypatch.setattr(abuse_train, "init_sequence_model",
                        lambda cfg, seed=0: sequence_from_tree(tree, cfg))
    cfg = abuse_train.AbuseTrainConfig(steps=STEPS, batch_size=BATCH, seq_len=SEQ,
                                       model=SeqConfig(**SMALL))
    model, metrics = abuse_train.train_abuse_detector(cfg, device="cpu")
    np.testing.assert_allclose(metrics["losses"], want, rtol=1e-4, atol=0)
    assert metrics["final_loss"] == metrics["losses"][-1]
    assert 0.0 <= metrics["eval_accuracy"] <= 1.0
    assert all(p.requires_grad and p.grad is not None for p in model.parameters())


def test_optimizer_is_optax_adam():
    """The same gradients, from 1e-9 (below eps) to 1, through three steps
    of each optimizer give the same params: the update, its bias correction
    and its constants are optax's."""
    rng = np.random.default_rng(6)
    w0 = rng.normal(size=(4, 64)).astype(np.float32)
    grads = [(rng.normal(size=w0.shape) * 10.0 ** rng.integers(-9, 1, w0.shape))
             .astype(np.float32) for _ in range(STEPS)]
    opt = optax.adam(LR)
    want, state = jnp.asarray(w0), opt.init(jnp.asarray(w0))
    param = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = abuse_train.make_optimizer(torch.nn.ParameterList([param]), LR)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state)
        want = optax.apply_updates(want, updates)
        param.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)


def test_tree_round_trip_and_serving_copy():
    tree = _tree(3)
    back = sequence_to_tree(sequence_from_tree(tree, SeqConfig(**SMALL)))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)

    # A model fresh from a step hands the detector params that require grad
    # and carry .grad; the detector's copy holds neither, the model keeps both.
    model = sequence_from_tree(tree, SeqConfig(**SMALL))
    abuse_train.train_step(model, abuse_train.make_optimizer(model, LR),
                           *jmake_abuse_batch(np.random.default_rng(4), BATCH, SEQ))
    det = SequenceAbuseDetector(cfg=SeqConfig(**SMALL), device="cpu")
    det.swap_params(model)
    assert all(not p.requires_grad and p.grad is None for p in det.params.parameters())
    assert all(p.requires_grad and p.grad is not None for p in model.parameters())
    det.record_event("a", 100, "bet", timestamp=5.0)
    with torch.inference_mode():
        want = torch.sigmoid(model(torch.from_numpy(det._history_matrix(["a"], 64)))
                             ["abuse_logit"]).numpy()
    np.testing.assert_array_equal(det.check_batch(["a"]), want)


def test_entry_point_needs_a_card_and_dense_mode(monkeypatch):
    cfg = abuse_train.AbuseTrainConfig(steps=1, batch_size=2, seq_len=4,
                                       model=SeqConfig(**SMALL))
    for mode in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError):
            abuse_train.train_abuse_detector(cfg, seq_mode=mode, device="cpu")
    with pytest.raises(ValueError, match="unknown seq_mode"):
        abuse_train.train_abuse_detector(cfg, seq_mode="sparse", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        abuse_train.train_abuse_detector(cfg)
