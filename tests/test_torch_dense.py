"""Port check: ops/dense.py, the dense products in a fixed order.

``dense_plain`` is the plain version of ``csrc/dense_fixed.cu``'s bf16 mode;
the CPU path of every ``mlp``, ``mlp+gbdt`` and ``multitask`` engine runs
it. Three properties, each on seeded numpy inputs:

- it computes JAX's ``models/mlp.py::_dense`` (bf16 operands, float32
  sums): both add the same exact products, in other orders, so they agree
  to rtol 1e-6 and atol 1e-6 at unit-scale activations and He-init weights
  (outputs up to about 8: a few float32 ulps), and its error from the
  float64 sum of the same products stays under 1e-6;
- its bits do not depend on the batch: rows 1, 7, 256 and 2048 of a
  4096-row batch, run alone, give the bits of the full run;
- it adds in the kernel's order, bit for bit: a numpy emulation of
  partial p = k = p, p + 8, ... in ascending k from +0.0, then the fixed
  tree fold and the bias.

``dense_f32_plain``, the plain version of the float32 mode, which every
``SequenceModel`` layer runs on the CPU (the session head, the abuse
detector and its training), is held to the same three at the sequence
models' layer shapes: against JAX's float32 ``x @ w + b`` to rtol and atol
2e-6 (sums of up to 128 rounded products in another order, outputs up to
about 5), within 2e-6 of the float64 product; batch-invariant; and in the
kernel's order with each product rounded before it is added, which a fused
multiply-add would not give.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from igaming_platform_tpu.models.mlp import _dense
from igaming_platform_tpu_torch.ops import dense as dense_mod

SHAPES = ((30, 128), (128, 128), (256, 1), (256, 256))


def _case(seed, k, n, rows=4096):
    """Unit-scale activations (standardized features at k = 30, ReLU
    outputs past it), He-init weights, small biases."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, k)).astype(np.float32)
    if k > 30:
        x = np.maximum(x, 0)
    w = (rng.normal(size=(k, n)) * np.sqrt(2.0 / k)).astype(np.float32)
    b = (rng.normal(size=(n,)) * 0.05).astype(np.float32)
    return x, w, b


def _plain(x, w, b):
    wt = dense_mod.round_bf16(torch.from_numpy(w))
    return dense_mod.dense_plain(torch.from_numpy(x), wt, torch.from_numpy(b)).numpy()


def _bf16(a):
    return dense_mod.round_bf16(torch.from_numpy(a)).numpy()


def _emulate(x, w, b):
    """The kernel's order in numpy, one k at a time, float32 throughout."""
    xb, wb = _bf16(x), _bf16(w)
    acc = np.zeros((x.shape[0], dense_mod.PARTIALS, w.shape[1]), np.float32)
    for k in range(x.shape[1]):
        p = k % dense_mod.PARTIALS
        acc[:, p] = acc[:, p] + xb[:, k, None] * wb[None, k]
    while acc.shape[1] > 1:
        acc = acc[:, 0::2] + acc[:, 1::2]
    return acc[:, 0] + b


@pytest.mark.parametrize("k,n", SHAPES[:3])
def test_dense_plain_against_jax(k, n):
    x, w, b = _case(k * 1000 + n, k, n, rows=512)
    want = np.asarray(jax.jit(_dense)(jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)}))
    got = _plain(x, w, b)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = _bf16(x).astype(np.float64) @ _bf16(w).astype(np.float64) + b
    assert np.abs(got - exact).max() < 1e-6


@pytest.mark.parametrize("k,n", SHAPES)
def test_dense_plain_bits_do_not_depend_on_the_batch(k, n):
    x, w, b = _case(k + n, k, n)
    full = _plain(x, w, b).view(np.int32)
    for rows in (1, 7, 256, 2048):
        np.testing.assert_array_equal(_plain(x[:rows], w, b).view(np.int32), full[:rows],
                                      err_msg=f"{rows} rows")


@pytest.mark.parametrize("k,n", [(30, 128), (256, 1), (13, 3), (8, 5)])
def test_dense_plain_adds_in_the_kernel_order(k, n):
    x, w, b = _case(7 * k + n, k, n, rows=64)
    x[0] = 0.0  # an all-zero row: every partial stays +0.0
    got = _plain(x, w, b)
    np.testing.assert_array_equal(got.view(np.int32), _emulate(x, w, b).view(np.int32))


def test_dense_routes_by_device():
    """A CPU tensor takes the plain version and launches nothing; a device
    that is neither CPU nor CUDA raises, as do operands that disagree on the
    card path's checks."""
    x, w, b = _case(3, 30, 16, rows=12)
    wt, bt = dense_mod.round_bf16(torch.from_numpy(w)), torch.from_numpy(b)
    before = dense_mod.dense.launches
    got = dense_mod.dense(torch.from_numpy(x), wt, bt)
    assert got.shape == (12, 16) and dense_mod.dense.launches == before
    np.testing.assert_array_equal(got.numpy(), _plain(x, w, b))
    with pytest.raises(ValueError, match="unsupported device"):
        dense_mod.dense(torch.empty((2, 30), device="meta"), wt, bt)
    with pytest.raises(ValueError, match="disagree"):
        dense_mod._check(torch.from_numpy(x), wt[:29], bt)


# The sequence models' float32 layers (K, N): the session head's embed, qkv,
# wo, w1, w2 and head (d_model 32), the detector's qkv and w2 (d_model 64).
F32_SHAPES = ((12, 32), (32, 96), (32, 32), (32, 64), (64, 32), (32, 1), (64, 192), (128, 64))


def _f32(x, w, b):
    return dense_mod.dense_f32_plain(*(torch.from_numpy(a) for a in (x, w, b))).numpy()


def _emulate_f32(x, w, b, fused: bool):
    """The float32 mode's order in numpy, one k at a time: each product
    rounded to float32 and then added, or (``fused``) added unrounded, as a
    fused multiply-add would, rounded once from float64."""
    acc = np.zeros((x.shape[0], dense_mod.PARTIALS, w.shape[1]), np.float32)
    for k in range(x.shape[1]):
        p = k % dense_mod.PARTIALS
        if fused:
            acc[:, p] = (acc[:, p].astype(np.float64)
                         + x[:, k, None].astype(np.float64) * w[None, k]).astype(np.float32)
        else:
            acc[:, p] = acc[:, p] + x[:, k, None] * w[None, k]
    while acc.shape[1] > 1:
        acc = acc[:, 0::2] + acc[:, 1::2]
    return acc[:, 0] + b


@pytest.mark.parametrize("k,n", F32_SHAPES)
def test_dense_f32_plain_against_jax(k, n):
    x, w, b = _case(k * 1000 + n + 1, k, n, rows=512)
    want = np.asarray(jax.jit(lambda x, w, b: x @ w + b)(x, w, b))
    got = _f32(x, w, b)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    exact = x.astype(np.float64) @ w.astype(np.float64) + b
    assert np.abs(got - exact).max() < 2e-6


@pytest.mark.parametrize("k,n", F32_SHAPES[:5])
def test_dense_f32_plain_bits_do_not_depend_on_the_batch(k, n):
    x, w, b = _case(k + n + 1, k, n)
    full = _f32(x, w, b).view(np.int32)
    for rows in (1, 7, 256, 2048):
        np.testing.assert_array_equal(_f32(x[:rows], w, b).view(np.int32), full[:rows],
                                      err_msg=f"{rows} rows")


@pytest.mark.parametrize("k,n", [(12, 32), (64, 32), (13, 3)])
def test_dense_f32_plain_adds_in_the_kernel_order(k, n):
    """Bit for bit the emulation that rounds each product, and not the one
    that fuses it (they differ on most outputs); a CPU tensor launches
    nothing."""
    x, w, b = _case(11 * k + n, k, n, rows=64)
    x[0] = 0.0
    before = dense_mod.dense_f32.launches
    got = dense_mod.dense_f32(*(torch.from_numpy(a) for a in (x, w, b))).numpy()
    assert dense_mod.dense_f32.launches == before
    np.testing.assert_array_equal(got.view(np.int32),
                                  _emulate_f32(x, w, b, fused=False).view(np.int32))
    fused = _emulate_f32(x, w, b, fused=True)
    assert (fused.view(np.int32) != got.view(np.int32)).mean() > 0.1
