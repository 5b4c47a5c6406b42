"""Bonus-abuse sequence model, in PyTorch (dense attention only).

Counterpart of ``igaming_platform_tpu/models/sequence.py``: a transformer
over a player's [S, EVENT_DIM] event history that returns an abuse score.
Event encoding, config, positions and signals are copies; the model is an
``nn.Module`` with the JAX params' layout (``convert.sequence_from_tree``
carries a JAX tree across, ``convert.sequence_to_tree`` back); its weights
are trainable ``nn.Parameter``s (``train/abuse_train.py``). Its attention
core is ``ops/flash_attention.py``'s ``autograd.Function``: the Hopper
kernels, forward and backward, for CUDA tensors, the plain dense versions
for CPU tensors, as the JAX model takes the Pallas kernels on a TPU and the
einsum elsewhere.

Numerics follow the JAX code: float32 products (no bf16, no TF32), the
population variance in layer norm, ``jax.nn.gelu``'s default tanh
approximation, and a mean pool over S that includes left-padded zero events.
Every ``Affine`` layer adds its float32 products in one order fixed by K
(``ops/dense.py``'s ``dense_f32``, the hand kernel ``csrc/dense_fixed.cu``
on a card), not cuBLAS's, whose order follows M: so a player's score does
not depend on the batch it rides in (one ``check()`` and the same account
inside ``check_batch``, a session-head row in any chunk), on the card as on
the CPU. Its gradient keeps ``torch.matmul``: training needs no fixed order.
The ring and Ulysses attention strategies (sequence sharding over a mesh)
are not ported yet.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from igaming_platform_tpu_torch.core.device import constant
from igaming_platform_tpu_torch.ops.dense import dense_f32
from igaming_platform_tpu_torch.ops.flash_attention import flash_attention

# Per-event feature layout for wagering histories:
# [log-amount, log-dt, 8-way tx-type one-hot, game-weight, balance-ratio]
EVENT_DIM = 12
TX_TYPE_INDEX = {
    "deposit": 0, "withdraw": 1, "bet": 2, "win": 3,
    "refund": 4, "bonus_grant": 5, "bonus_wager": 6, "adjustment": 7,
}


def encode_event(amount: float, dt_seconds: float, tx_type: str,
                 game_weight: float = 1.0, balance_ratio: float = 0.0) -> np.ndarray:
    e = np.zeros(EVENT_DIM, dtype=np.float32)
    e[0] = math.log1p(max(amount, 0.0))
    e[1] = math.log1p(max(dt_seconds, 0.0))
    e[2 + TX_TYPE_INDEX.get(tx_type, 7)] = 1.0
    e[10] = game_weight
    e[11] = balance_ratio
    return e


@dataclass(frozen=True)
class SeqConfig:
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 256
    in_dim: int = EVENT_DIM
    max_len: int = 2048


def _sinusoidal_positions(seq_len: int, d_model: int) -> np.ndarray:
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    angle = pos / np.power(10_000.0, 2 * dim / d_model)
    out = np.zeros((seq_len, d_model), dtype=np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


# The table for each (S, d_model) is built once: at S=8192 building it takes
# the host longer than the card takes for the whole forward.
_positions_table = functools.lru_cache(maxsize=16)(_sinusoidal_positions)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` as the JAX model calls it: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class _FixedOrderAffine(torch.autograd.Function):
    """``dense_f32`` forward on [rows, in]; ``torch.matmul`` backward."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return dense_f32(x, w, b)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        return (grad @ w.t() if need_x else None, x.t() @ grad if need_w else None,
                grad.sum(0) if need_b else None)


class Affine(nn.Module):
    """``x @ w + b`` in float32, its sums in ``dense_f32``'s fixed order;
    ``w`` is [in, out] as in the JAX params."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        if w.dim() != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"dense layer shapes w={tuple(w.shape)} b={tuple(b.shape)}")
        self.w = nn.Parameter(w.to(torch.float32).contiguous())
        self.b = nn.Parameter(b.to(torch.float32).contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = x.reshape(-1, x.shape[-1]).contiguous()
        return _FixedOrderAffine.apply(rows, self.w, self.b).view(*x.shape[:-1], -1)


class LayerNorm(nn.Module):
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` with the population variance."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(scale.to(torch.float32).contiguous())
        self.bias = nn.Parameter(bias.to(torch.float32).contiguous())
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, unbiased=False)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.scale + self.bias


class Block(nn.Module):
    """Pre-norm transformer layer: attention, then a GELU feed-forward."""

    def __init__(self, n_heads: int, ln1: LayerNorm, wqkv: Affine, wo: Affine,
                 ln2: LayerNorm, w1: Affine, w2: Affine):
        super().__init__()
        self.n_heads = n_heads
        self.ln1, self.wqkv, self.wo = ln1, wqkv, wo
        self.ln2, self.w1, self.w2 = ln2, w1, w2

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h = self.n_heads
        # [B, S, 3d] -> q, k, v as [B, H, S, Dh], each contiguous.
        qkv = self.wqkv(x).view(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4).contiguous()
        out = flash_attention(qkv[0], qkv[1], qkv[2])
        return self.wo(out.transpose(1, 2).reshape(b, s, d))

    def forward(self, hid: torch.Tensor) -> torch.Tensor:
        hid = hid + self.attention(self.ln1(hid))
        return hid + self.w2(gelu(self.w1(self.ln2(hid))))


class SequenceModel(nn.Module):
    """[B, S, EVENT_DIM] event histories -> abuse score per player: the JAX
    ``sequence_forward`` in its dense mode, with its params."""

    def __init__(self, cfg: SeqConfig, embed: Affine, layers: list[Block],
                 ln_f: LayerNorm, head: Affine):
        super().__init__()
        if cfg.d_model % cfg.n_heads:
            raise ValueError(f"d_model {cfg.d_model} not divisible by n_heads {cfg.n_heads}")
        self.cfg = cfg
        self.embed, self.ln_f, self.head = embed, ln_f, head
        self.layers = nn.ModuleList(layers)

    @staticmethod
    def pool(h: torch.Tensor) -> torch.Tensor:
        """[B, S, d] -> [B, d]: the mean over S, padded positions included,
        summed in a tree that S alone fixes (position i + S/2 onto i, an odd
        last position carried, until one is left), then times 1/S. Torch's
        mean picks its reduction order by the batch on the card (at S = 64 a
        lone sequence's mean differed from its own inside 4,096); these adds
        are elementwise."""
        s = h.shape[1]
        while h.shape[1] > 1:
            half = h.shape[1] // 2
            folded = h[:, :half] + h[:, half:2 * half]
            h = torch.cat([folded, h[:, 2 * half:]], dim=1) if h.shape[1] % 2 else folded
        return h[:, 0] * (1.0 / s)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """Returns {"abuse": [B] in [0, 1], "abuse_logit": [B], "hidden": [B, d]}."""
        dev = self.head.w.device
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        s, d = x.shape[1], self.cfg.d_model
        hpos = constant(f"seq_positions_{s}_{d}", _positions_table(s, d), dev)
        hid = self.embed(x) + hpos[None]
        for layer in self.layers:
            hid = layer(hid)
        pooled = self.pool(self.ln_f(hid))
        logit = self.head(pooled)[..., 0]
        # The sigmoid in float64, rounded once: torch's float32 one takes
        # another approximation on the CPU for the tail of a vector than for
        # its body, and another on the card, so a row's bits would follow
        # its position in the batch and the device (core/numerics.py; this
        # form keeps the gradient).
        abuse = torch.sigmoid(logit.double()).to(torch.float32)
        return {"abuse": abuse, "abuse_logit": logit, "hidden": pooled}


def init_sequence_model(cfg: SeqConfig = SeqConfig(), seed: int = 0) -> SequenceModel:
    """Random params with the distributions of the JAX ``init_sequence_model``,
    drawn from a ``torch.Generator``: not the numbers of ``jax.random.key(seed)``."""
    gen = torch.Generator().manual_seed(seed)
    d = cfg.d_model

    def dense(d_in, d_out, scale=None):
        scale = scale if scale is not None else math.sqrt(2.0 / d_in)
        w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32) * scale
        return Affine(w, torch.zeros(d_out))

    def norm():
        return LayerNorm(torch.ones(d), torch.zeros(d))

    layers = [Block(cfg.n_heads, norm(), dense(d, 3 * d, math.sqrt(1.0 / d)),
                    dense(d, d, math.sqrt(1.0 / d)), norm(), dense(d, cfg.d_ff),
                    dense(cfg.d_ff, d))
              for _ in range(cfg.n_layers)]
    return SequenceModel(cfg, dense(cfg.in_dim, d), layers, norm(),
                         dense(d, 1, math.sqrt(1.0 / d)))


def abuse_signals(score: float, threshold: float = 0.5) -> list[str]:
    """Decode wire-level abuse signals (risk.proto CheckBonusAbuseResponse)."""
    signals = []
    if score >= threshold:
        signals.append("SEQUENCE_MODEL_HIGH_RISK")
    if score >= 0.8:
        signals.append("WAGERING_PATTERN_ANOMALY")
    return signals
