"""Port parity: models/sequence.py, the bonus-abuse transformer.

Params come from the JAX package's ``init_sequence_model`` and cross over
through ``convert.sequence_from_tree``; histories come from a numpy seed.
On the CPU the port's attention takes the plain dense version, the JAX
model its einsum. Tolerances: ``abuse`` atol 1e-5 and ``hidden`` atol 1e-4,
float32 through two layers with sums in another order. Event encoding and
positions are copies and must be bit-equal.
"""

import jax
import numpy as np
import pytest
import torch

from igaming_platform_tpu.models import sequence as jseq
from igaming_platform_tpu_torch.convert import sequence_from_tree
from igaming_platform_tpu_torch.models import sequence as tseq

# The abuse detector's full serving width.
SERVE_CFG = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128)


def seq_tree(cfg: dict, seed: int = 0) -> dict:
    """JAX params as numpy, and the port's SequenceModel made from them."""
    tree = jax.tree.map(np.asarray, jseq.init_sequence_model(
        jax.random.key(seed), jseq.SeqConfig(**cfg)))
    return tree, sequence_from_tree(tree, tseq.SeqConfig(**cfg))


def test_encoding_and_positions_bit_equal():
    rng = np.random.default_rng(0)
    types = [*jseq.TX_TYPE_INDEX, "unknown"]
    for _ in range(50):
        args = (float(rng.integers(-5, 10**7)), float(rng.random() * 1e5 - 10),
                types[rng.integers(len(types))], float(rng.random()), float(rng.random()))
        np.testing.assert_array_equal(tseq.encode_event(*args), jseq.encode_event(*args))
    for s, d in ((64, 64), (300, 128)):
        np.testing.assert_array_equal(tseq._sinusoidal_positions(s, d),
                                      jseq._sinusoidal_positions(s, d))
    assert tseq.EVENT_DIM == jseq.EVENT_DIM and tseq.TX_TYPE_INDEX == jseq.TX_TYPE_INDEX


@pytest.mark.parametrize("cfg,s,b", [
    (SERVE_CFG, 64, 3),                                   # the detector's serving shape
    (dict(d_model=32, n_heads=4, n_layers=1, d_ff=64), 37, 2),  # ragged S, Dh 8
])
def test_forward_matches_jax(cfg, s, b):
    tree, model = seq_tree(cfg, seed=1)
    x = np.random.default_rng(2).normal(size=(b, s, jseq.EVENT_DIM)).astype(np.float32)
    x[0, : s // 2] = 0.0  # left padding, counted by the mean pool
    want = jseq.sequence_forward(tree, x, jseq.SeqConfig(**cfg))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    for key, atol in (("abuse", 1e-5), ("abuse_logit", 1e-5), ("hidden", 1e-4)):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=atol)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-6, 6, 401)
    want = np.array(jax.nn.gelu(x.numpy()))
    np.testing.assert_allclose(tseq.gelu(x).numpy(), want, rtol=0, atol=1e-6)
    # The exact (erf) GELU is measurably another function.
    assert (torch.nn.functional.gelu(x) - torch.from_numpy(want)).abs().max() > 1e-4


def test_default_init_has_the_jax_layout():
    cfg = tseq.SeqConfig(**SERVE_CFG)
    model = tseq.init_sequence_model(cfg, seed=0)
    tree, converted = seq_tree(SERVE_CFG)
    shapes = {k: tuple(v.shape) for k, v in converted.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes
    again = tseq.init_sequence_model(cfg, seed=0)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    # Every weight trains: 30 parameters at two layers, no buffers.
    assert len(list(model.parameters())) == 30 and not list(model.buffers())
    assert all(p.requires_grad for p in model.parameters())
    # He-normal embed: the spread of the JAX init, not its numbers.
    w = model.embed.w.detach().numpy()
    assert abs(w.std() - np.asarray(tree["embed"]["w"]).std()) < 0.1
    with pytest.raises(ValueError, match="sequence params do not match"):
        sequence_from_tree(tree, tseq.SeqConfig(d_model=64, n_heads=2, n_layers=1, d_ff=128))
