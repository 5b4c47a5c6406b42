"""Port parity: ops/flash_attention.py (the plain version the CPU takes).

q, k, v come from a numpy seed and go through the JAX package's forward
kernels in interpret mode, as tests/test_flash_attention.py runs them:
``_run_resident`` and ``_run_tiled`` give O and the row LSE, and
``models/sequence.py::_dense_attention`` covers an S that no block divides.
O and LSE agree to rtol/atol 2e-5, the JAX tests' bar: both are float32 with
the sums taken in another order. The CUDA kernel itself is held to the plain
version on the card by chip_smoke.py; a numpy emulation of its arithmetic
(3xTF32 products, the key order of its P.V fragments) pins here that it keeps
that bar where split bf16 does not.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash_attention_bwd import _split_mm, _tf32

from igaming_platform_tpu.models.sequence import _dense_attention
from igaming_platform_tpu.ops.pallas.flash_attention import _run_resident, _run_tiled
from igaming_platform_tpu.ops.pallas.flash_attention import flash_attention as jflash
from igaming_platform_tpu_torch.ops import tensor_core_model as tensor_core
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


BAR = 2e-5


def _pv_key_order():
    """The key order in which the kernel's P.V takes each 8-key chunk, from
    the m16n8k8 fragment layouts: accumulator register i of lane (g, t) holds
    row g + 8 (i // 2), key 2t + i % 2; A register r holds row g + 8 (r % 2),
    k = t + 4 (r // 2) and is filled from accumulator register (0, 2, 1, 3)[r];
    V's B register r holds k = t + 4 r and is loaded from key 2t + r."""
    a_order, b_order = [None] * 8, [None] * 8
    for t in range(4):
        for r, i in enumerate((0, 2, 1, 3)):
            assert r % 2 == i // 2  # the same row
            a_order[t + 4 * (r // 2)] = 2 * t + i % 2
        for r in range(2):
            b_order[t + 4 * r] = 2 * t + r
    assert a_order == b_order and sorted(a_order) == list(range(8))
    return np.array(a_order)


def _tf32_pair(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _mma_nearest(c, a, b):
    """c + a @ b with the k8 sum exact, rounded to nearest float32 once: not
    what the card does (``tensor_core_model.mma``), kept to show what such a
    model lets through."""
    return (np.asarray(c, np.float64) + a.astype(np.float64) @ b.astype(np.float64)).astype(
        np.float32)


def _fma32(a, b, c):
    """a * b + c rounded to float32 once."""
    return (a.astype(np.float64) * np.asarray(b, np.float64) + c.astype(np.float64)).astype(
        np.float32)


def _emulated_fwd_3xtf32(q, k, v, mma=tensor_core.mma, compensated=True):
    """The forward kernel's arithmetic on one head, 64-row blocks, with each
    mma.sync by ``mma``: per key tile, the small terms chained into lo;
    big.big chained over two k8 steps from zero, then added into hi in
    float32 with its rounding error kept (Fast2Sum) and joined to lo
    (``compensated=False``: big.big chained into hi over every k8 step, no
    error kept); exp(fma(lo, scale, fma(hi, scale, -m))); the tile's P.V
    from zero in the kernel's key order, joined by one fma. Each score
    depends on its own key only, so the scores of every tile are taken at
    once."""
    s, dh = q.shape
    tile = 64 if dh <= 32 else 32
    scale = np.float32(1.0 / math.sqrt(dh))
    qb, qs = _tf32_pair(q)
    kp, vp = (np.pad(a, ((0, -s % 8), (0, 0))) for a in (k, v))
    (kb, ks) = _tf32_pair(kp.T)
    hi = np.zeros((s, kp.shape[0]), np.float32)
    lo, err, big = hi, hi, hi
    for c in range(0, dh, 8):
        d = slice(c, c + 8)
        lo = mma(mma(lo, qs[:, d], kb[d]), qb[:, d], ks[d])
        if not compensated:
            hi = mma(hi, qb[:, d], kb[d])
            continue
        big = mma(big, qb[:, d], kb[d])
        if c % 16 == 8 or c == dh - 8:
            err = err + (big - ((hi + big) - hi))
            hi, big = hi + big, 0.0 * big
    lo = lo + err
    m = np.full((s, 1), -np.inf, np.float32)
    l = np.zeros((s, 1), np.float32)
    acc = np.zeros((s, dh), np.float32)
    order = _pv_key_order()
    for t0 in range(0, s, tile):
        n = min(tile, s - t0)
        keys = slice(t0, t0 + n + -n % 8)
        vb, vs = _tf32_pair(vp[keys])
        m_new = np.maximum(m, (hi[:, t0:t0 + n] * scale).max(axis=1, keepdims=True))
        corr = np.exp(m - m_new)
        p = np.exp(_fma32(lo[:, keys], scale, _fma32(hi[:, keys], scale, -m_new)))
        p[:, n:] = 0.0
        l = l * corr + p.sum(axis=1, keepdims=True, dtype=np.float32)
        pb, ps = _tf32_pair(p)
        ta = np.zeros_like(acc)
        for c in range(0, vb.shape[0], 8):
            key = c + order
            ta = mma(ta, ps[:, key], vb[key])
            ta = mma(ta, pb[:, key], vs[key])
            ta = mma(ta, pb[:, key], vb[key])
        acc = _fma32(acc, corr, ta)
        m = m_new
    return acc / l, m + np.log(l)


def _dense_fwd(mm, q, k, v):
    """Dense attention with products by ``mm``, softmax in float32."""
    sc = mm(q, k.T) * np.float32(1.0 / math.sqrt(q.shape[1]))
    mx = sc.max(axis=1, keepdims=True)
    e = np.exp(sc - mx)
    l = e.sum(axis=1, keepdims=True, dtype=np.float32)
    return mm(e / l, v), mx + np.log(l)


def _share_of_bar(q, k, v):
    """A function giving how many 2e-5 bars an (O, LSE) pair lies from the
    float64 forward of (q, k, v) at worst."""
    q64, k64, v64 = (a.astype(np.float64) for a in (q, k, v))
    sc = q64 @ k64.T / math.sqrt(q.shape[1])
    mx = sc.max(axis=1, keepdims=True)
    e = np.exp(sc - mx)
    want = (e @ v64 / e.sum(axis=1, keepdims=True),
            mx + np.log(e.sum(axis=1, keepdims=True)))
    return lambda got: max(float(np.max(np.abs(g - w) / (BAR + BAR * np.abs(w))))
                           for g, w in zip(got, want))


@pytest.mark.parametrize("amp", [1, 3])
@pytest.mark.parametrize("s,dh", [(64, 32), (300, 32), (2048, 64)])
def test_3xtf32_keeps_forward_bar(s, dh, amp):
    """At the path's (S, Dh), one head of q, k, v at amplitude 1 and 3,
    against a float64 forward: the forward kernel's emulated 3xTF32, on the
    card's tensor-core sum, keeps O and LSE within half of the 2e-5 bar
    wherever the float32 dense forward itself stays within the bar, and
    within the bar where it does not (amplitude 3 at S = 2048: float32 sums
    of 64 products of magnitude 80 lie 1.45 bars off); split bf16 (the
    backward's scheme, even with exact sums) misses the bar at amplitude 3."""
    q, k, v = (a * np.float32(amp) for a in _qkv(s * dh + amp, s, dh))
    share_of_bar = _share_of_bar(q, k, v)
    limit = 0.5 if share_of_bar(_dense_fwd(np.matmul, q, k, v)) <= 1.0 else 1.0
    assert share_of_bar(_emulated_fwd_3xtf32(q, k, v)) <= limit
    if amp == 3:
        assert share_of_bar(_dense_fwd(_split_mm, q, k, v)) > 1.0


def test_card_sum_rejects_uncompensated_chain():
    """big.big chained into hi over every k8 step, with no compensation,
    passes an emulation whose tensor core rounds each k-step sum to nearest,
    and misses the bar on the card's sum, which cuts every term toward zero
    (``ops/tensor_core_model.py``, measured with ``csrc/mma_probe.cu``). At
    (300, 64), amplitude 4, the emulation on the card's sum rejects that
    chain and keeps the kernel's compensated one within the bar, where the
    float32 dense forward itself lies past it."""
    q, k, v = (a * np.float32(4) for a in _qkv(300 * 64 + 4, 300, 64))
    share_of_bar = _share_of_bar(q, k, v)
    assert share_of_bar(_dense_fwd(np.matmul, q, k, v)) > 1.0
    assert share_of_bar(_emulated_fwd_3xtf32(q, k, v, _mma_nearest, compensated=False)) <= 1.0
    assert share_of_bar(_emulated_fwd_3xtf32(q, k, v, compensated=False)) > 1.0
    assert share_of_bar(_emulated_fwd_3xtf32(q, k, v)) <= 1.0
