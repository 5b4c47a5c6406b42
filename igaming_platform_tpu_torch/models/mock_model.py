"""Deterministic fallback fraud scorer, the vectorized reference mock, in PyTorch.

Counterpart of ``igaming_platform_tpu/models/mock_model.py`` (decision
table: onnx_model.go:258-308). The float32 boundary constants are built by
the same two functions, so they carry over bit for bit, and the score adds
its weights in the same order.

Input must be normalized with ``ref_compat=True``.
"""

from __future__ import annotations

import numpy as np
import torch

from igaming_platform_tpu_torch.core.features import F


def _gt_threshold(c: float) -> np.float32:
    """float32 constant t such that (x > t) in float32 == (float64(x) > c).

    Go promotes float32 features to float64 before comparing against float64
    literals; for non-dyadic c the naive float32 constant flips boundary
    cases (3 devices/10 == 0.30000001f IS > 0.3 in Go). t = largest
    float32 <= c.
    """
    t = np.float32(c)
    if float(t) > c:
        t = np.nextafter(t, np.float32(-np.inf))
    return t


def _lt_threshold(c: float) -> np.float32:
    """float32 constant s such that (x < s) in float32 == (float64(x) < c).
    s = smallest float32 >= c."""
    s = np.float32(c)
    if float(s) < c:
        s = np.nextafter(s, np.float32(np.inf))
    return s


# Python floats holding float32 values exactly: compared with a float32
# tensor they stay float32, and nothing is promoted to float64.
_GT_03 = float(_gt_threshold(0.3))
_GT_025 = float(_gt_threshold(0.25))
_GT_05 = float(_gt_threshold(0.5))
_LT_002 = float(_lt_threshold(0.02))
_LT_001 = float(_lt_threshold(0.01))
_GT_08_FACTOR = float(np.float32(0.8))


def mock_predict(xn: torch.Tensor) -> torch.Tensor:
    """Score a normalized [B, 30] batch -> [B] float32 in [0, 1]."""
    xn = torch.as_tensor(xn, dtype=torch.float32)
    s = torch.zeros(xn.shape[:-1], dtype=torch.float32, device=xn.device)

    def add(score, cond, w):
        # w is rounded to float32 first, as jnp.float32(w) does.
        return score + torch.where(cond, float(np.float32(w)), 0.0)

    # Velocity: > 10 tx/min, > 100 tx/hour.
    s = add(s, xn[..., F.TX_COUNT_1M] > _GT_05, 0.2)
    s = add(s, xn[..., F.TX_COUNT_1H] > _GT_05, 0.15)
    # Device churn: > 3 devices, > 5 IPs in 24h.
    s = add(s, xn[..., F.UNIQUE_DEVICES_24H] > _GT_03, 0.15)
    s = add(s, xn[..., F.UNIQUE_IPS_24H] > _GT_025, 0.1)
    # Anonymisation.
    s = add(s, (xn[..., F.IS_VPN] > 0) | (xn[..., F.IS_PROXY] > 0), 0.15)
    s = add(s, xn[..., F.IS_TOR] > 0, 0.25)
    # New account (< ~7 days) + large tx.
    s = add(s, (xn[..., F.ACCOUNT_AGE_DAYS] < _LT_002) & (xn[..., F.TX_AMOUNT] > _GT_05), 0.2)
    # Bonus-only player.
    s = add(s, xn[..., F.BONUS_ONLY_PLAYER] > 0, 0.15)
    # Rapid deposit->withdraw cycle.
    rapid = (
        (xn[..., F.TIME_SINCE_LAST_TX] < _LT_001)
        & (xn[..., F.TX_TYPE_WITHDRAW] > 0)
        & (xn[..., F.TOTAL_WITHDRAWALS] > xn[..., F.TOTAL_DEPOSITS] * _GT_08_FACTOR)
    )
    s = add(s, rapid, 0.2)

    return torch.clamp_max(s, 1.0)
