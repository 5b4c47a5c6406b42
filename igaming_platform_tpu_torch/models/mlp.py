"""Fraud MLP, in PyTorch.

Counterpart of ``igaming_platform_tpu/models/mlp.py``: a [B, 30] -> [B]
fraud-probability net whose matmuls take bf16 operands and accumulate in
float32 (``_dense``, ``mlp.py:64-74`` there).

``torch.matmul`` on bf16 tensors returns bf16, which would round every
output to bf16 and cost about 1e-3. So ``dense`` rounds both operands to
bf16, widens them back to float32 and multiplies in float32. A product of
two bf16 values is exact in float32 (8 + 8 significant bits), so only the
order of the sums differs from XLA's. Even a TF32 product would keep those
operands exact, since TF32 holds 10 significant bits.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

DEFAULT_HIDDEN = (128, 128)


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


class Dense(nn.Module):
    """``h @ w + b`` with bf16-rounded operands and a float32 result.

    ``w`` is [in, out] as in the JAX params. Only its bf16 rounding is used,
    so that is what the layer keeps, made once here and not on every call.
    """

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        w = torch.as_tensor(w, dtype=torch.float32)
        b = torch.as_tensor(b, dtype=torch.float32)
        if w.dim() != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"dense layer shapes w={tuple(w.shape)} b={tuple(b.shape)}")
        self.register_buffer("w_bf16", _round_bf16(w).contiguous())
        self.register_buffer("b", b.contiguous())

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return torch.matmul(_round_bf16(h), self.w_bf16) + self.b


class MLP(nn.Module):
    """in -> hidden... -> 1 fraud logit, ReLU between layers."""

    def __init__(self, layers: Sequence[Dense]):
        super().__init__()
        if not layers:
            raise ValueError("an MLP needs at least one layer")
        self.layers = nn.ModuleList(layers)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Hidden representation after the last ReLU."""
        h = torch.as_tensor(x, dtype=torch.float32)
        for layer in self.layers[:-1]:
            h = torch.relu(layer(h))
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 30] -> [B, 1] logits."""
        return self.layers[-1](self.features(x))


def mlp_predict(model: MLP, x: torch.Tensor) -> torch.Tensor:
    """[B, 30] normalized features -> [B] fraud probability in [0, 1]."""
    return torch.sigmoid(model(x)[..., 0])

