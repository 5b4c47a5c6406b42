"""Port parity: the flash-attention backward in ops/flash_attention.py.

q, k, v and dO come from a numpy seed. The port's ``flash_attention_bwd``
(its plain version on the CPU) is held to the JAX package's backward: both
Pallas kernels through ``_run_bwd`` in interpret mode at block-divisible S,
and ``_xla_bwd`` at a ragged S. ``torch.autograd.grad`` through the port's
``FlashAttention`` function is held to ``jax.grad`` through the JAX
``flash_attention`` (its ``custom_vjp``, interpret mode). Tolerance rtol/atol
2e-4, the JAX tests' bar for gradients: float32 sums in another order. The
CUDA kernels themselves are held to the plain version on the card by
chip_smoke.py; a numpy emulation of their arithmetic (split bf16: three bf16
products per float32 product, chained on the card's tensor-core sum,
``ops/tensor_core_model.py``) pins here that it keeps that bar where one-term
rounding does not.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from igaming_platform_tpu.ops.pallas.flash_attention import _run_bwd, _xla_bwd
from igaming_platform_tpu.ops.pallas.flash_attention import flash_attention as jflash
from igaming_platform_tpu_torch.ops import tensor_core_model as tensor_core
from igaming_platform_tpu_torch.ops.flash_attention import (
    FlashAttention,
    check_args,
    flash_attention,
    flash_attention_bwd,
    flash_attention_plain,
)

TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_BAR = 2e-4


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


def _round_bits(x, keep_mask, half):
    """float32 rounded to fewer mantissa bits: add ``half`` of the dropped
    unit to the bit pattern (plus its round-to-even carry, if given) and cut."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + half(u)) & keep_mask).astype(np.uint32).view(np.float32)


def _bf16(x):
    """Round to nearest even bf16, as cvt.rn.bf16 does."""
    return _round_bits(x, 0xFFFF0000, lambda u: 0x7FFF + ((u >> 16) & 1))


def _tf32(x):
    """Round to nearest TF32, ties away from zero, as cvt.rna.tf32 does."""
    return _round_bits(x, 0xFFFFE000, lambda u: 0x1000)


def _split_mm(a, b):
    """a @ b as the tensor cores take it in split bf16: hi = bf16(x),
    lo = bf16(x - hi), hi.hi + hi.lo + lo.hi, summed in float64."""
    ah, bh = _bf16(a), _bf16(b)
    al, bl = _bf16(a - ah), _bf16(b - bh)
    ah, al, bh, bl = (x.astype(np.float64) for x in (ah, al, bh, bl))
    return (ah @ bh + ah @ bl + al @ bh).astype(np.float32)


def _split_mm_card(a, b):
    """a @ b as the backward kernels take it: split bf16, one accumulator
    chained over k16 steps, each step's three products in the kernels'
    order (lo.hi, hi.lo, hi.hi), each mma.sync as the card sums it."""
    ah, bh = _bf16(a), _bf16(b)
    al, bl = _bf16(a - ah), _bf16(b - bh)
    k = a.shape[1]
    pad = -k % 16
    ah, al = (np.pad(x, ((0, 0), (0, pad))) for x in (ah, al))
    bh, bl = (np.pad(x, ((0, pad), (0, 0))) for x in (bh, bl))
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for c in range(0, k + pad, 16):
        d = slice(c, c + 16)
        acc = tensor_core.mma(acc, al[:, d], bh[d])
        acc = tensor_core.mma(acc, ah[:, d], bl[d])
        acc = tensor_core.mma(acc, ah[:, d], bh[d])
    return acc


def _tf32_mm(a, b):
    return (_tf32(a).astype(np.float64) @ _tf32(b).astype(np.float64)).astype(np.float32)


def _emulated_bwd(mm, q, k, v, do, lse, dmat, scale):
    """The backward kernels' arithmetic with products by ``mm``; P, dS and
    the exponentials in float32, as on the CUDA cores."""
    p = np.exp(mm(q, k.T) * np.float32(scale) - lse)
    ds = p * (mm(do, v.T) - dmat) * np.float32(scale)
    return mm(ds, k), mm(ds.T, q), mm(p.T, do)


@pytest.mark.parametrize("s,dh", [(64, 32), (300, 32), (2048, 64)])
def test_split_bf16_keeps_gradient_bar(s, dh):
    """At the path's (S, Dh), BH 1, split bf16 on the card's tensor-core sum
    keeps dQ, dK and dV within a tenth of the 2e-4 bar against a float64
    backward; one-term TF32 misses it at S = 300."""
    q, k, v, do = _arrays(s * dh, 4, s, dh)
    scale = 1.0 / math.sqrt(dh)
    q64, k64, v64, do64 = (a.astype(np.float64) for a in (q, k, v, do))
    sc = q64 @ k64.T * scale
    lse = sc.max(axis=1, keepdims=True)
    lse += np.log(np.exp(sc - lse).sum(axis=1, keepdims=True))
    p = np.exp(sc - lse)
    dmat = (do64 * (p @ v64)).sum(axis=1, keepdims=True)
    ds = p * (do64 @ v64.T - dmat) * scale
    want = (ds @ k64, ds.T @ q64, p.T @ do64)
    ins = (q, k, v, do, lse.astype(np.float32), dmat.astype(np.float32), scale)

    def share_of_bar(got):
        return max(float(np.max(np.abs(g - w) / (GRAD_BAR + GRAD_BAR * np.abs(w))))
                   for g, w in zip(got, want))

    assert share_of_bar(_emulated_bwd(_split_mm_card, *ins)) <= 0.1
    if (s, dh) == (300, 32):
        assert share_of_bar(_emulated_bwd(_tf32_mm, *ins)) > 1.0
