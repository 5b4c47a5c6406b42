"""Joint fraud + LTV multi-task MLP, in PyTorch.

Counterpart of ``igaming_platform_tpu/models/multitask.py``: one shared
trunk over the 30-dim feature schema with three heads (fraud logit, LTV
value, churn logit). Every layer is the bf16-operand, float32-result
``Dense`` of ``models/mlp.py``. The sharding rules (``param_specs``) wait
for the port's multi-device slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from igaming_platform_tpu_torch.core import numerics
from igaming_platform_tpu_torch.models.mlp import Dense


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
