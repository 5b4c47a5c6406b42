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
the CPU. Its gradient keeps ``torch.matmul`` (``ops/dense.py``'s
``dense_f32_train``): training needs no fixed order.

Over a mesh (``forward(x, mesh=, seq_mode=)``) the attention core shards
the batch over ``data`` and the sequence over ``seq``, as the JAX
``_attention`` does inside ``shard_map``; everything else runs whole:

- ``ring``: each shard keeps its queries while the key/value blocks rotate
  around the ``seq`` ring (``ppermute``), the softmax accumulated online
  (running max, normaliser and output, rescaled per block); plain torch
  ops, as it is plain XLA in JAX, so it is held to dense attention with a
  tolerance (in float64 for large-amplitude inputs, where the float32
  dense reference misses its own bar);
- ``ulysses``: an all-to-all trades the sequence shard for a head shard,
  the dense core (the forward kernel on a card) runs on the full sequence
  for H/n heads, and the exchange reverses; heads are independent, so it
  equals dense attention.
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
from igaming_platform_tpu_torch.parallel import collectives as coll
from igaming_platform_tpu_torch.ops.dense import dense_f32_train
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
        return dense_f32_train(rows, self.w, self.b).view(*x.shape[:-1], -1)


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


def _dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, H, S, Dh] full attention: the forward kernel on a card, the plain
    version on the CPU (``ops/flash_attention.py``)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous())


def _ring_attention_local(qs, ks, vs) -> list[torch.Tensor]:
    """Ring attention over the ``seq`` shards of one data block: ``qs``,
    ``ks``, ``vs`` are lists of [B, H, S_local, Dh]. Key/value blocks
    rotate one step a round; each shard folds the block it holds into its
    running max ``m``, normaliser ``l`` and output ``o``. No [S, S] matrix
    and no full-sequence KV exist on one shard."""
    scale = 1.0 / math.sqrt(qs[0].shape[-1])
    state = []
    for q in qs:
        b, h, s_loc, dh = q.shape
        state.append((torch.full((b, h, s_loc), -math.inf, dtype=q.dtype, device=q.device),
                      torch.zeros((b, h, s_loc), dtype=q.dtype, device=q.device),
                      torch.zeros((b, h, s_loc, dh), dtype=q.dtype, device=q.device)))
    k_cur, v_cur = list(ks), list(vs)
    for _ in range(len(qs)):
        for i, q in enumerate(qs):
            m, l, o = state[i]
            sc = torch.einsum("bhqd,bhkd->bhqk", q, k_cur[i]) * scale
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_cur[i])
            state[i] = (m_new, l, o)
        k_cur = coll.ppermute_ring(k_cur)
        v_cur = coll.ppermute_ring(v_cur)
    return [o / l[..., None] for _, l, o in state]


def _ulysses_attention_local(qs, ks, vs) -> list[torch.Tensor]:
    """Ulysses over the ``seq`` shards of one data block: all-to-all from
    sequence shards to head shards ([B, H/n, S, Dh] each), dense attention,
    and back."""
    def seq_to_heads(xs):
        return coll.all_to_all(xs, split_axis=1, concat_axis=2)

    outs = [_dense_attention(q, k, v)
            for q, k, v in zip(seq_to_heads(qs), seq_to_heads(ks), seq_to_heads(vs))]
    return coll.all_to_all(outs, split_axis=2, concat_axis=1)


def sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                      seq_mode: str) -> torch.Tensor:
    """[B, H, S, Dh] attention with the batch over ``data`` and the
    sequence over ``seq`` (``ring`` or ``ulysses``), each data block's
    shards on the mesh's devices; the result comes back whole on ``q``'s
    device. B must divide by the data axis and S by the seq axis."""
    from igaming_platform_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_SEQ

    n_data, n_seq = int(mesh.shape[AXIS_DATA]), int(mesh.shape[AXIS_SEQ])
    h, s = q.shape[1], q.shape[2]
    if s % n_seq:
        raise ValueError(f"sequence length {s} not divisible by seq axis {n_seq}")
    if seq_mode == "ulysses" and h % n_seq:
        raise ValueError(f"n_heads {h} not divisible by seq axis {n_seq}")
    if seq_mode not in ("ring", "ulysses"):
        raise ValueError(f"unknown seq_mode: {seq_mode}")
    local = _ring_attention_local if seq_mode == "ring" else _ulysses_attention_local
    home = q.device
    rows = coll.row_bounds(q.shape[0], n_data)
    out = []
    for d, (lo, hi) in enumerate(rows):
        devs = [mesh.devices[d, 0, j, 0] for j in range(n_seq)]

        def split(t):
            return [c.to(dv) for c, dv in zip(torch.chunk(t[lo:hi], n_seq, dim=2), devs)]

        parts = local(split(q), split(k), split(v))
        out.append(torch.cat([p.to(home) for p in parts], dim=2))
    return torch.cat(out, dim=0)


class Block(nn.Module):
    """Pre-norm transformer layer: attention, then a GELU feed-forward."""

    def __init__(self, n_heads: int, ln1: LayerNorm, wqkv: Affine, wo: Affine,
                 ln2: LayerNorm, w1: Affine, w2: Affine):
        super().__init__()
        self.n_heads = n_heads
        self.ln1, self.wqkv, self.wo = ln1, wqkv, wo
        self.ln2, self.w1, self.w2 = ln2, w1, w2

    def attention(self, x: torch.Tensor, mesh=None, seq_mode: str = "dense") -> torch.Tensor:
        b, s, d = x.shape
        h = self.n_heads
        # [B, S, 3d] -> q, k, v as [B, H, S, Dh], each contiguous.
        qkv = self.wqkv(x).view(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4).contiguous()
        if mesh is None or seq_mode == "dense":
            out = flash_attention(qkv[0], qkv[1], qkv[2])
        else:
            out = sharded_attention(qkv[0], qkv[1], qkv[2], mesh, seq_mode)
        return self.wo(out.transpose(1, 2).reshape(b, s, d))

    def forward(self, hid: torch.Tensor, mesh=None, seq_mode: str = "dense") -> torch.Tensor:
        hid = hid + self.attention(self.ln1(hid), mesh, seq_mode)
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

    def forward(self, x: torch.Tensor, mesh=None, seq_mode: str = "dense") -> dict[str, torch.Tensor]:
        """Returns {"abuse": [B] in [0, 1], "abuse_logit": [B], "hidden": [B, d]};
        ``mesh``/``seq_mode`` shard the attention (``sharded_attention``)."""
        dev = self.head.w.device
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        s, d = x.shape[1], self.cfg.d_model
        hpos = constant(f"seq_positions_{s}_{d}", _positions_table(s, d), dev)
        hid = self.embed(x) + hpos[None]
        for layer in self.layers:
            hid = layer(hid, mesh, seq_mode)
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
