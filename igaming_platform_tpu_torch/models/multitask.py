"""Joint fraud + LTV multi-task MLP, in PyTorch.

Counterpart of ``igaming_platform_tpu/models/multitask.py``: one shared
trunk over the 30-dim feature schema with three heads (fraud logit, LTV
value, churn logit). Every layer is the bf16-operand, float32-result
``Dense`` of ``models/mlp.py``. ``TrainMultiTask`` is the trainable twin
(``TrainDense`` layers, float32 master weights); ``init_multitask`` draws
it as the JAX ``init_multitask`` does (He-normal trunk, heads of scale
``sqrt(1/d)``, zero biases) from an explicit ``torch.Generator``.
``param_specs`` gives its layout over a mesh (``parallel/sharding.py``):
the trunk alternating over ``model``, the heads replicated.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from igaming_platform_tpu_torch.core import numerics
from igaming_platform_tpu_torch.core.features import NUM_FEATURES
from igaming_platform_tpu_torch.models.mlp import Dense, TrainDense, he_normal


class MultiTask(nn.Module):
    def __init__(self, trunk: Sequence[Dense], fraud_head: Dense, ltv_head: Dense,
                 churn_head: Dense):
        super().__init__()
        self.trunk = nn.ModuleList(trunk)
        self.fraud_head = fraud_head
        self.ltv_head = ltv_head
        self.churn_head = churn_head

    def trunk_features(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.as_tensor(x, dtype=torch.float32)
        for layer in self.trunk:
            h = torch.relu(layer(h))
        return h

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """[B, 30] normalized features -> {"fraud", "ltv", "churn"} ([B] each)."""
        h = self.trunk_features(x)
        fraud_logit = self.fraud_head(h)[..., 0]
        ltv = self.ltv_head(h)[..., 0]
        churn_logit = self.churn_head(h)[..., 0]
        return {
            "fraud": numerics.sigmoid(fraud_logit),
            "fraud_logit": fraud_logit,
            "ltv": ltv,
            "churn": numerics.sigmoid(churn_logit),
            "churn_logit": churn_logit,
        }


def fraud_predict(model: MultiTask, x: torch.Tensor) -> torch.Tensor:
    """[B, 30] -> [B] fraud probability. Runs the trunk and the fraud head
    only: the LTV and churn heads do not feed the fraud score."""
    return numerics.sigmoid(model.fraud_head(model.trunk_features(x))[..., 0])


def param_specs(params) -> dict:
    """Tensor-parallel layout of a multitask net (a JAX-layout tree or a
    ``MultiTask``): trunk layers alternating over ``model``, heads
    replicated; specs as tuples of axis names."""
    from igaming_platform_tpu_torch.parallel.sharding import P, hidden_specs

    trunk = params["trunk"]["layers"] if isinstance(params, dict) else params.trunk
    head_spec = {"w": P(None, None), "b": P(None)}
    return {
        "trunk": {"layers": hidden_specs(len(trunk), head=False)},
        "fraud_head": head_spec,
        "ltv_head": head_spec,
        "churn_head": head_spec,
    }


DEFAULT_TRUNK = (256, 256)


class TrainMultiTask(nn.Module):
    """The trainable multitask net: ``MultiTask``'s forward on ``TrainDense``
    layers. Its sigmoids are torch's (differentiable), not the score step's
    float64-rounded ones: only ``fraud`` feeds a metric, never the loss."""

    def __init__(self, trunk: Sequence[TrainDense], fraud_head: TrainDense,
                 ltv_head: TrainDense, churn_head: TrainDense):
        super().__init__()
        self.trunk = nn.ModuleList(trunk)
        self.fraud_head = fraud_head
        self.ltv_head = ltv_head
        self.churn_head = churn_head

    def trunk_features(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.as_tensor(x, dtype=torch.float32)
        for layer in self.trunk:
            h = torch.relu(layer(h))
        return h

    def fraud_logit(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 30] -> [B]: the trunk and the fraud head only (the routed
        ensemble's expert)."""
        return self.fraud_head(self.trunk_features(x))[..., 0]

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        h = self.trunk_features(x)
        fraud_logit = self.fraud_head(h)[..., 0]
        churn_logit = self.churn_head(h)[..., 0]
        return {
            "fraud": torch.sigmoid(fraud_logit),
            "fraud_logit": fraud_logit,
            "ltv": self.ltv_head(h)[..., 0],
            "churn": torch.sigmoid(churn_logit),
            "churn_logit": churn_logit,
        }

    def serving(self) -> MultiTask:
        """The serving module of the current master weights, on their device."""
        return MultiTask([layer.serving() for layer in self.trunk],
                         self.fraud_head.serving(), self.ltv_head.serving(),
                         self.churn_head.serving())


def init_multitask(gen: torch.Generator, trunk: Sequence[int] = DEFAULT_TRUNK,
                   in_dim: int = NUM_FEATURES) -> TrainMultiTask:
    """A freshly initialised trainable multitask net on the CPU."""
    dims = (in_dim, *trunk)
    layers = [TrainDense(he_normal(gen, d_in, d_out, math.sqrt(2.0 / d_in)), torch.zeros(d_out))
              for d_in, d_out in zip(dims[:-1], dims[1:])]
    d = dims[-1]

    def head() -> TrainDense:
        return TrainDense(he_normal(gen, d, 1, math.sqrt(1.0 / d)), torch.zeros(1))

    return TrainMultiTask(layers, head(), head(), head())
