"""Fraud MLP, in PyTorch.

Counterpart of ``igaming_platform_tpu/models/mlp.py``: a [B, 30] -> [B]
fraud-probability net whose matmuls take bf16 operands and accumulate in
float32 (``_dense``, ``mlp.py:64-74`` there).

Every layer is ``ops/dense.py``'s ``dense``: both operands rounded to
bf16 and the exact float32 products added in one order that only k fixes,
so a row's bits do not depend on the batch it rides in. On the card that
is the hand kernel ``csrc/dense_fixed.cu`` (its bf16 mode); on the CPU its
plain version.

``Dense`` and ``MLP`` serve: buffers only, the weight kept as its bf16
rounding. ``TrainDense`` and ``TrainMLP`` train: float32 master weights as
``nn.Parameter``s, every forward through ``ops/dense.py``'s ``dense_train``
(the same kernel on ``round_bf16(w)``, with the JAX gradients), and
``serving()`` builds the serving module from the master weights.
``init_mlp`` draws them as the JAX ``init_mlp`` does (He-normal weights,
zero biases) from an explicit ``torch.Generator``: the same distributions,
not JAX's numbers.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from igaming_platform_tpu_torch.core import numerics
from igaming_platform_tpu_torch.core.features import NUM_FEATURES
from igaming_platform_tpu_torch.ops.dense import dense, dense_train, round_bf16

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


class TrainDense(nn.Module):
    """A trainable dense layer: float32 master ``w`` [in, out] and ``b``
    [out] as parameters; the forward runs on ``round_bf16(w)``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        w = torch.as_tensor(w, dtype=torch.float32)
        b = torch.as_tensor(b, dtype=torch.float32)
        if w.dim() != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"dense layer shapes w={tuple(w.shape)} b={tuple(b.shape)}")
        self.w = nn.Parameter(w.clone().contiguous())
        self.b = nn.Parameter(b.clone().contiguous())

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return dense_train(h, self.w, self.b)

    def serving(self) -> Dense:
        """The serving layer of the current master weights, on their device."""
        return Dense(self.w.detach(), self.b.detach().clone())


def he_normal(gen: torch.Generator, d_in: int, d_out: int, scale: float) -> torch.Tensor:
    """[d_in, d_out] float32 normal draws times ``scale``, on the CPU."""
    return torch.randn((d_in, d_out), generator=gen, dtype=torch.float32) * scale


class TrainMLP(nn.Module):
    """The trainable in -> hidden... -> 1 fraud-logit net."""

    def __init__(self, layers: Sequence[TrainDense]):
        super().__init__()
        if not layers:
            raise ValueError("an MLP needs at least one layer")
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 30] -> [B, 1] logits."""
        h = torch.as_tensor(x, dtype=torch.float32)
        for layer in self.layers[:-1]:
            h = torch.relu(layer(h))
        return self.layers[-1](h)

    def serving(self) -> MLP:
        return MLP([layer.serving() for layer in self.layers])


def init_mlp(gen: torch.Generator, hidden: Sequence[int] = DEFAULT_HIDDEN,
             in_dim: int = NUM_FEATURES, out_dim: int = 1) -> TrainMLP:
    """He-initialised trainable MLP on the CPU: in -> hidden... -> out."""
    dims = (in_dim, *hidden, out_dim)
    return TrainMLP([TrainDense(he_normal(gen, d_in, d_out, math.sqrt(2.0 / d_in)),
                                torch.zeros(d_out))
                     for d_in, d_out in zip(dims[:-1], dims[1:])])
