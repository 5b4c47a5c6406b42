"""Port parity: ops/flash_attention.py (the plain version the CPU takes).

q, k, v come from a numpy seed and go through the JAX package's forward
kernels in interpret mode, as tests/test_flash_attention.py runs them:
``_run_resident`` and ``_run_tiled`` give O and the row LSE, and
``models/sequence.py::_dense_attention`` covers an S that no block divides.
O and LSE agree to rtol/atol 2e-5, the JAX tests' bar: both are float32 with
the sums taken in another order. The CUDA kernel itself is held to the plain
version on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from igaming_platform_tpu.models.sequence import _dense_attention
from igaming_platform_tpu.ops.pallas.flash_attention import _run_resident, _run_tiled
from igaming_platform_tpu.ops.pallas.flash_attention import flash_attention as jflash
from igaming_platform_tpu_torch.ops.flash_attention import (
    check_args,
    flash_attention,
    flash_attention_fwd,
)

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, *shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("s,dh,variant", [
    (64, 16, "resident"), (64, 32, "resident"), (128, 16, "tiled"),
    (128, 32, "tiled"), (300, 16, "dense"), (300, 32, "dense"),
])
def test_plain_matches_jax_forward(s, dh, variant):
    q, k, v = _qkv(s + dh, 2 * 2, s, dh)
    o, lse = flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)))
    assert o.shape == (4, s, dh) and lse.shape == (4, s, 1)
    if variant == "dense":
        want_o = _dense_attention(*(jnp.asarray(a).reshape(2, 2, s, dh) for a in (q, k, v)))
        want_o = np.asarray(want_o).reshape(4, s, dh)
        scores = np.einsum("bqd,bkd->bqk", q.astype(np.float64), k) / np.sqrt(dh)
        want_lse = np.log(np.exp(scores - scores.max(-1, keepdims=True)).sum(-1, keepdims=True))
        want_lse += scores.max(-1, keepdims=True)
    else:
        run = _run_resident if variant == "resident" else _run_tiled
        blk = s if variant == "resident" else s // 2
        want_o, want_lse = run(q, k, v, block_q=blk, block_k=blk, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


def test_four_d_wrapper_and_extreme_logits():
    q, k, v = _qkv(7, 2, 2, 64, 32)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jflash(q, k, v, interpret=True)), **TOL)
    # Logits of 3600 overflow a naive exp; the result must stay finite.
    big = torch.full((1, 1, 256, 16), 30.0)
    out = flash_attention(big, big, torch.ones_like(big))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), 1.0, rtol=1e-6)


def test_kernel_argument_check():
    """What a CUDA tensor meets before the launch: any other head size,
    dtype, layout or shape raises instead of taking the plain version."""
    ok = torch.zeros(2, 64, 32)
    check_args(ok, ok, ok)
    bad_dh = torch.zeros(2, 64, 24)
    with pytest.raises(ValueError, match="head size 24"):
        check_args(bad_dh, bad_dh, bad_dh)
    with pytest.raises(TypeError):
        check_args(ok, ok, ok.double())
    with pytest.raises(ValueError, match="contiguous"):
        check_args(ok, ok, torch.zeros(2, 32, 64).transpose(1, 2))
    with pytest.raises(ValueError, match="one \\[BH, S, Dh\\] shape"):
        check_args(ok, ok[:, :32], ok)
    meta = torch.zeros(2, 64, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_fwd(meta, meta, meta)
