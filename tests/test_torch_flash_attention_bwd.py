"""Port parity: the flash-attention backward in ops/flash_attention.py.

q, k, v and dO come from a numpy seed. The port's ``flash_attention_bwd``
(its plain version on the CPU) is held to the JAX package's backward: both
Pallas kernels through ``_run_bwd`` in interpret mode at block-divisible S,
and ``_xla_bwd`` at a ragged S. ``torch.autograd.grad`` through the port's
``FlashAttention`` function is held to ``jax.grad`` through the JAX
``flash_attention`` (its ``custom_vjp``, interpret mode). Tolerance rtol/atol
2e-4, the JAX tests' bar for gradients: float32 sums in another order. The
CUDA kernels themselves are held to the plain version on the card by
chip_smoke.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from igaming_platform_tpu.ops.pallas.flash_attention import _run_bwd, _xla_bwd
from igaming_platform_tpu.ops.pallas.flash_attention import flash_attention as jflash
from igaming_platform_tpu_torch.ops.flash_attention import (
    FlashAttention,
    check_args,
    flash_attention,
    flash_attention_bwd,
    flash_attention_plain,
)

TOL = dict(rtol=2e-4, atol=2e-4)


def _arrays(seed, n, *shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("s,dh,reference", [
    (128, 16, "pallas"), (128, 32, "pallas"), (300, 32, "xla"),
])
def test_bwd_matches_jax(s, dh, reference):
    q, k, v, do = _arrays(s + dh, 4, 4, s, dh)
    o, lse = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    o, lse = o.numpy(), lse.numpy()
    got = flash_attention_bwd(*(torch.from_numpy(a) for a in (q, k, v, o, lse, do)))
    if reference == "pallas":
        want = _run_bwd(q, k, v, o, lse, do, block_q=s // 2, block_k=s // 2, interpret=True)
    else:
        want = _xla_bwd(q, k, v, o, lse, do, 1.0 / math.sqrt(dh))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == (4, s, dh), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("shared", [False, True])
def test_autograd_matches_jax_grad(shared):
    """The same tensor as q, k and v sums three gradients, as in the JAX
    package's test of training through the kernel."""
    q, k, v, w = _arrays(21, 4, 2, 2, 128, 16)
    if shared:
        k = v = q
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ins = (tq,) * 3 if shared else (tq, tk, tv)
    out = flash_attention(*ins)
    assert type(out.grad_fn.next_functions[0][0]).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (tq,) if shared else ins, torch.from_numpy(w))

    def loss(*a):
        return jnp.sum(jflash(*(a * 3 if shared else a), interpret=True) * w)

    want = jax.grad(loss, argnums=(0,) if shared else (0, 1, 2))(*((q,) if shared else (q, k, v)))
    for g, wa in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wa), **TOL)
    with torch.inference_mode():
        assert flash_attention(*ins).grad_fn is None


def test_bwd_argument_check():
    """What a CUDA tensor meets before the backward launches: O and dO must
    match q, the LSE must be [BH, S, 1]; other devices raise."""
    ok = torch.zeros(2, 64, 32)
    check_args(ok, ok, ok, ok, ok, op="flash_attention_bwd")
    with pytest.raises(ValueError, match="flash_attention_bwd: .*do \\(2, 64, 16\\)"):
        check_args(ok, ok, ok, ok, torch.zeros(2, 64, 16), op="flash_attention_bwd")
    with pytest.raises(ValueError, match="do is not contiguous"):
        check_args(ok, ok, ok, ok, torch.zeros(2, 32, 64).transpose(1, 2),
                   op="flash_attention_bwd")
    meta = torch.zeros(2, 64, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_bwd(meta, meta, meta, meta, meta[..., :1], meta)
    assert FlashAttention.apply(ok, ok, ok).shape == ok.shape
