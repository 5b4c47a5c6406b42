"""Plain reference of the bonus-abuse sequence model's forward.

A pre-norm transformer encoder over [B, S, 12] event histories, written
from its equations in plain PyTorch float32, with no kernel, cache or
batching of the program: an affine embedding plus sinusoidal positions;
per layer ``h + Wo(attn(LN1(h)))`` then ``h + W2(gelu_tanh(W1(LN2(h))))``
with softmax attention over all positions and the population variance in
layer norm (eps 1e-5); a final layer norm, the mean over S, an affine head
to one logit.

Matrix products run with TF32 off unless ``tf32=True``, which is the
control: the same reference one precision step lower. Histories are
scored in row blocks, so that the attention matrices of a long history
fit beside whatever else the device holds.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 for float32 products on, or off, inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def positions(seq_len: int, d_model: int) -> np.ndarray:
    """Sinusoidal positions: sin on even and cos on odd columns of
    pos / 10000^(2i/d)."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    angle = pos / np.power(10_000.0, 2 * dim / d_model)
    out = np.zeros((seq_len, d_model), dtype=np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


def _layer_norm(x, scale, bias):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * scale + bias


def forward(p: dict, cfg: dict, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """[B, S, 12] -> [B] logits."""
    b, s, _ = x.shape
    d, h = cfg["d_model"], cfg["n_heads"]
    hid = x @ p["embed.w"] + p["embed.b"] + pos
    for i in range(cfg["n_layers"]):
        lp = lambda n: p[f"layers.{i}.{n}"]  # noqa: E731
        a = _layer_norm(hid, lp("ln1.scale"), lp("ln1.bias"))
        qkv = (a @ lp("wqkv.w") + lp("wqkv.b")).view(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4)
        scores = qkv[0] @ qkv[1].transpose(-1, -2) / math.sqrt(d // h)
        att = (torch.softmax(scores, dim=-1) @ qkv[2]).transpose(1, 2).reshape(b, s, d)
        hid = hid + att @ lp("wo.w") + lp("wo.b")
        f = _layer_norm(hid, lp("ln2.scale"), lp("ln2.bias"))
        f = F.gelu(f @ lp("w1.w") + lp("w1.b"), approximate="tanh")
        hid = hid + f @ lp("w2.w") + lp("w2.b")
    pooled = _layer_norm(hid, p["ln_f.scale"], p["ln_f.bias"]).mean(dim=1)
    return (pooled @ p["head.w"] + p["head.b"])[:, 0]


def score(p: dict, cfg: dict, xs: torch.Tensor, block: int, tf32: bool = False) -> torch.Tensor:
    """[n, B, S, 12] batches -> [n, B] logits, ``block`` rows at a time."""
    pos = torch.from_numpy(positions(xs.shape[2], cfg["d_model"])).to(xs.device)
    rows = xs.reshape(-1, *xs.shape[2:])
    with torch.no_grad(), matmul_precision(tf32):
        out = [forward(p, cfg, rows[lo:lo + block], pos) for lo in range(0, rows.shape[0], block)]
    return torch.cat(out).view(xs.shape[0], xs.shape[1])
