"""Fraud MLP, in PyTorch.

Counterpart of ``igaming_platform_tpu/models/mlp.py``: a [B, 30] -> [B]
fraud-probability net whose matmuls take bf16 operands and accumulate in
float32 (``_dense``, ``mlp.py:64-74`` there).

Every layer is ``ops/dense.py``'s ``dense``: both operands rounded to
bf16 and the exact float32 products added in one order that only k fixes,
so a row's bits do not depend on the batch it rides in. On the card that
is the hand kernel ``csrc/dense_bf16.cu``; on the CPU its plain version.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from igaming_platform_tpu_torch.core import numerics
from igaming_platform_tpu_torch.ops.dense import dense, round_bf16

DEFAULT_HIDDEN = (128, 128)


class Dense(nn.Module):
    """``h @ w + b`` with bf16-rounded operands and a float32 result, in
    ``ops/dense.py``'s fixed order.

    ``w`` is [in, out] as in the JAX params. Only its bf16 rounding is used,
    so that is what the layer keeps, made once here and not on every call.
    """

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        w = torch.as_tensor(w, dtype=torch.float32)
        b = torch.as_tensor(b, dtype=torch.float32)
        if w.dim() != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"dense layer shapes w={tuple(w.shape)} b={tuple(b.shape)}")
        self.register_buffer("w_bf16", round_bf16(w).contiguous())
        self.register_buffer("b", b.contiguous())

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return dense(h, self.w_bf16, self.b)


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
    return numerics.sigmoid(model(x)[..., 0])

