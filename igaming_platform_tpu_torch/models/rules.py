"""The 8 explainable fraud rules as one batched tensor op, in PyTorch.

Counterpart of ``igaming_platform_tpu/models/rules.py`` (reference:
engine.go:420-483, weights :246-257). All 8 rules evaluate branchlessly
over a [B, 30] raw feature batch and give per-row additive scores plus a
reason bitmask. The arithmetic is float32 as the JAX version writes it,
including Go's truncating ``TotalDeposits*80/100``.
"""

from __future__ import annotations

import numpy as np
import torch

from igaming_platform_tpu_torch.core.config import ScoringConfig
from igaming_platform_tpu_torch.core.device import constant
from igaming_platform_tpu_torch.core.enums import REASON_BIT_ORDER, ReasonCode
from igaming_platform_tpu_torch.core.features import F

# Additive weights, engine.go:246-257.
RULE_WEIGHTS: dict[ReasonCode, int] = {
    ReasonCode.HIGH_VELOCITY: 20,
    ReasonCode.NEW_ACCOUNT_LARGE_TX: 30,
    ReasonCode.IP_COUNTRY_MISMATCH: 25,
    ReasonCode.MULTIPLE_DEVICES: 15,
    ReasonCode.SUSPICIOUS_PATTERN: 20,
    ReasonCode.VPN_DETECTED: 15,
    ReasonCode.KNOWN_FRAUDSTER: 50,
    ReasonCode.RAPID_DEPOSIT_WITHDRAW: 25,
    ReasonCode.BONUS_ABUSE: 20,
    ReasonCode.ML_HIGH_RISK: 30,
}

# Weight vector aligned with the 8 rule bits of REASON_BIT_ORDER (the 9th
# bit, ML_HIGH_RISK, is set by the ensemble, not the rule pass).
_RULE_BIT_WEIGHTS = np.array(
    [RULE_WEIGHTS[code] for code in REASON_BIT_ORDER[:8]], dtype=np.int32
)
_RULE_BITS = (1 << np.arange(8)).astype(np.int32)
_HUNDRED = np.array(100.0, dtype=np.float32)


def apply_rules(
    x: torch.Tensor,
    blacklisted: torch.Tensor,
    cfg: ScoringConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Evaluate all 8 rules over raw (un-normalized) features.

    Args:
      x: [B, 30] float32 raw feature batch (schema order, TX context filled).
      blacklisted: [B] bool, the host-side blacklist membership (rule 8).
      cfg: scoring thresholds.

    Returns:
      (rule_score [B] int32 capped at 100, reason_mask [B] int32) where
      bit i of the mask is REASON_BIT_ORDER[i].
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    amount = x[:, F.TX_AMOUNT]
    is_withdraw = x[:, F.TX_TYPE_WITHDRAW] > 0.0

    # Rule 1: high velocity (engine.go:425-428).
    r1 = x[:, F.TX_COUNT_1M] > cfg.max_tx_per_minute
    # Rule 2: new account + large transaction (:431-434).
    r2 = (x[:, F.ACCOUNT_AGE_DAYS] < cfg.new_account_days) & (amount > cfg.large_deposit_amount)
    # Rule 3: multiple devices (:437-440).
    r3 = x[:, F.UNIQUE_DEVICES_24H] > cfg.max_devices_per_day
    # Rule 4: multiple IPs, weighted as IP_COUNTRY_MISMATCH (:443-446).
    r4 = x[:, F.UNIQUE_IPS_24H] > cfg.max_ips_per_day
    # Rule 5: VPN / proxy / Tor (:449-452).
    r5 = (x[:, F.IS_VPN] > 0) | (x[:, F.IS_PROXY] > 0) | (x[:, F.IS_TOR] > 0)
    # Rule 6: rapid deposit->withdraw laundering signal (:455-460).
    # Go computes TotalDeposits*80/100 in truncating int64 math; the float32
    # multiply, then divide, then floor is the JAX package's order. The
    # divisor is a device tensor: CUDA turns division by a Python scalar
    # into multiplication by its rounded reciprocal, which is not the same
    # float32 quotient.
    hundred = constant("rules.hundred", _HUNDRED, x.device)
    wd_ratio = torch.floor(x[:, F.TOTAL_DEPOSITS] * 80.0 / hundred)
    r6 = (
        (x[:, F.TIME_SINCE_LAST_TX] < 300)
        & is_withdraw
        & (x[:, F.DEPOSIT_COUNT] > 0)
        & (x[:, F.TOTAL_WITHDRAWALS] > wd_ratio)
    )
    # Rule 7: bonus-only player (:463-466).
    r7 = x[:, F.BONUS_ONLY_PLAYER] > 0
    # Rule 8: blacklist hit (:469-475).
    r8 = torch.as_tensor(blacklisted, dtype=torch.bool, device=x.device)

    hits = torch.stack([r1, r2, r3, r4, r5, r6, r7, r8], dim=-1).to(torch.int32)  # [B, 8]
    weights = constant("rules.weights", _RULE_BIT_WEIGHTS, x.device)
    score = torch.sum(hits * weights, dim=-1, dtype=torch.int32)
    score = torch.clamp_max(score, 100)  # cap, engine.go:478-480

    bits = constant("rules.bits", _RULE_BITS, x.device)
    mask = torch.sum(hits * bits, dim=-1, dtype=torch.int32)
    return score, mask
