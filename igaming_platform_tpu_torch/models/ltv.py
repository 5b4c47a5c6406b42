"""Player lifetime value, churn, segment and next-best-action, in PyTorch.

Counterpart of ``igaming_platform_tpu/models/ltv.py`` (the reference's
``prediction/ltv.go``): every formula is branchless elementwise arithmetic
over a [B, 25] float32 feature matrix, so a whole player table scores in one
pass on one device. No kernel: these are torch ops, one op at a time.

Numerics: the arithmetic of the program the JAX service runs. The JAX
server's LTV RPCs and its batch job answer with ``predict_batch_jit``, and
XLA's CPU program for ``base_ltv`` is not the source's association:

- new players' ``net / max(dsr, 1) * 30 * 12`` is one multiply by 360;
- established players' ``net + monthly * months`` is one fused
  multiply-add, rounded once (``core/numerics.py::fma``);
- on a single row (B = 1, as every LTV RPC sends) XLA's simplifier also
  moves both constants together: ``monthly * months`` becomes
  ``(net / max(dsr, 1) * engagement) * 360``, fused with the add.

``predict_batch`` follows the program of its batch's size: its outputs
equal ``predict_batch_jit``'s bit for bit at the sizes tested (B = 1, 2, 3,
4, 8, 17, 4,096 and 100,000: ``tests/test_torch_ltv.py``), on the CPU and on
the card (``chip_smoke.py`` phase 11 holds the card to
``tests/golden/ltv_jit.npz``). Eager JAX, op by op, rounds each step and
differs from both in ``ltv``. The division divides by a tensor, as the JAX
function does: on CUDA a division by a Python scalar is a multiplication by
its rounded reciprocal. Constants enter as Python scalars of elementwise
ops, never as host values written into a device tensor.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from igaming_platform_tpu_torch.core.numerics import fma


class L(enum.IntEnum):
    """LTV feature column indices (PlayerFeatures, ltv.go:38-78)."""

    DAYS_SINCE_REGISTRATION = 0
    DAYS_SINCE_LAST_DEPOSIT = 1
    DAYS_SINCE_LAST_BET = 2
    TOTAL_ACTIVE_DAYS = 3
    SESSIONS_PER_WEEK = 4
    AVG_SESSION_DURATION = 5
    TOTAL_DEPOSITS = 6
    TOTAL_WITHDRAWALS = 7
    NET_REVENUE = 8
    AVG_DEPOSIT_AMOUNT = 9
    DEPOSIT_FREQUENCY = 10
    LARGEST_DEPOSIT = 11
    TOTAL_BETS = 12
    TOTAL_WINS = 13
    BET_COUNT = 14
    WIN_RATE = 15
    AVG_BET_SIZE = 16
    GAMES_PLAYED = 17
    BONUSES_CLAIMED = 18
    BONUS_WAGERING_COMPLETED = 19
    BONUS_CONVERSION_RATE = 20
    PUSH_ENABLED = 21
    EMAIL_OPT_IN = 22
    HAS_VIP_MANAGER = 23
    SUPPORT_TICKETS = 24


NUM_LTV_FEATURES = 25
LTV_FEATURE_NAMES = tuple(f.name.lower() for f in L)

# Segment codes, aligned with risk.v1's Segment enum.
SEG_VIP, SEG_HIGH, SEG_MEDIUM, SEG_LOW, SEG_CHURNING = 1, 2, 3, 4, 5

# Next-best-action codes (the decision tree of ltv.go:300-343).
ACTIONS = (
    "NO_ACTION",
    "SEND_WINBACK_BONUS",
    "SEND_ENGAGEMENT_EMAIL",
    "VIP_MANAGER_CALL",
    "EXCLUSIVE_EVENT_INVITE",
    "ASSIGN_VIP_MANAGER",
    "RETENTION_BONUS",
    "LOYALTY_REWARD",
    "SUGGEST_BONUS",
    "RECOMMEND_NEW_GAMES",
    "STANDARD_PROMOTION",
    "ONBOARDING_GUIDE",
    "SMALL_DEPOSIT_BONUS",
)
ACTION_CODES = {name: i for i, name in enumerate(ACTIONS)}

# Segment thresholds in dollars (ltv.go:105-108).
VIP_THRESHOLD = 10_000.0
HIGH_THRESHOLD = 1_000.0
MEDIUM_THRESHOLD = 100.0


def _tiers(*pairs, default: torch.Tensor) -> torch.Tensor:
    """``where(c0, v0, where(c1, v1, ... default))`` over (condition, value)
    pairs, the first true condition winning."""
    out = default
    for cond, value in reversed(pairs):
        out = torch.where(cond, value, out)
    return out


def engagement_score(f: torch.Tensor) -> torch.Tensor:
    """0-1 engagement (ltv.go:181-225)."""
    dslb = f[:, L.DAYS_SINCE_LAST_BET]
    spw = f[:, L.SESSIONS_PER_WEEK]
    dfreq = f[:, L.DEPOSIT_FREQUENCY]
    zero = torch.zeros_like(dslb)

    s = _tiers((dslb < 3, 0.3), (dslb < 7, 0.2), (dslb < 14, 0.1), default=zero)
    s = s + _tiers((spw >= 5, 0.2), (spw >= 3, 0.15), (spw >= 1, 0.1), default=zero)
    s = s + _tiers((dfreq >= 4, 0.2), (dfreq >= 2, 0.15), (dfreq >= 1, 0.1), default=zero)
    s = s + torch.where(f[:, L.PUSH_ENABLED] > 0, 0.1, zero)
    s = s + torch.where(f[:, L.EMAIL_OPT_IN] > 0, 0.1, zero)
    s = s + torch.where(f[:, L.HAS_VIP_MANAGER] > 0, 0.1, zero)
    return torch.clamp_max(s, 1.0)


def churn_risk(f: torch.Tensor) -> torch.Tensor:
    """0-1 churn probability (ltv.go:228-262)."""
    dslb = f[:, L.DAYS_SINCE_LAST_BET]
    zero = torch.zeros_like(dslb)
    r = _tiers((dslb > 30, 0.5), (dslb > 14, 0.3), (dslb > 7, 0.15), default=zero)
    r = r + torch.where((f[:, L.SESSIONS_PER_WEEK] < 1) & (f[:, L.DAYS_SINCE_REGISTRATION] > 30),
                        0.2, zero)
    r = r + torch.where(f[:, L.DAYS_SINCE_LAST_DEPOSIT] > 30, 0.2, zero)
    r = r + torch.where(f[:, L.SUPPORT_TICKETS] > 3, 0.1, zero)
    r = r + torch.where(f[:, L.TOTAL_WITHDRAWALS] > f[:, L.TOTAL_DEPOSITS], 0.1, zero)
    return torch.clamp_max(r, 1.0)


def base_ltv(f: torch.Tensor) -> torch.Tensor:
    """Projected lifetime value in dollars (ltv.go:155-178), as XLA's program
    for ``f``'s batch size computes it (see the module's docstring)."""
    dsr = f[:, L.DAYS_SINCE_REGISTRATION]
    net = f[:, L.NET_REVENUE]
    daily = net / torch.clamp_min(dsr, 1.0)  # a division by a tensor, as in JAX
    engagement = engagement_score(f)
    # New players (< 30 days): 12 months at the current run-rate.
    new_value = daily * 360.0
    # Established: realized + engagement-scaled remaining months.
    if f.shape[0] == 1:
        est_value = fma(daily * engagement, torch.full_like(net, 360.0), net)
    else:
        est_value = fma(daily * 30.0, engagement * 12.0, net)
    return torch.where(dsr < 30, new_value, est_value)


def determine_segment(ltv: torch.Tensor, churn: torch.Tensor) -> torch.Tensor:
    """Segment codes; churn > 0.7 overrides the value tiers (ltv.go:265-281)."""
    low = torch.full_like(ltv, SEG_LOW, dtype=torch.int32)
    seg = _tiers((ltv >= VIP_THRESHOLD, SEG_VIP), (ltv >= HIGH_THRESHOLD, SEG_HIGH),
                 (ltv >= MEDIUM_THRESHOLD, SEG_MEDIUM), default=low)
    return torch.where(churn > 0.7, SEG_CHURNING, seg).to(torch.int32)


def predict_survival(f: torch.Tensor, churn: torch.Tensor) -> torch.Tensor:
    """Remaining active days (ltv.go:284-297)."""
    days = 90.0 * (1.0 + engagement_score(f)) * (1.0 - churn)
    return torch.clamp_min(days, 0.0).to(torch.int32)


def confidence(f: torch.Tensor) -> torch.Tensor:
    """Data-quality confidence (ltv.go:346-382)."""
    dsr = f[:, L.DAYS_SINCE_REGISTRATION]
    bets = f[:, L.BET_COUNT]
    dfreq = f[:, L.DEPOSIT_FREQUENCY]
    dslb = f[:, L.DAYS_SINCE_LAST_BET]
    zero = torch.zeros_like(dsr)

    c = _tiers((dsr > 90, 0.3), (dsr > 30, 0.2), default=torch.full_like(dsr, 0.1))
    c = c + _tiers((bets > 100, 0.3), (bets > 20, 0.2), default=torch.full_like(dsr, 0.1))
    c = c + _tiers((dfreq > 2, 0.2), (dfreq > 0, 0.1), default=zero)
    c = c + _tiers((dslb < 7, 0.2), (dslb < 30, 0.1), default=zero)
    return torch.clamp_max(c, 1.0)


def next_best_action(seg: torch.Tensor, f: torch.Tensor, churn: torch.Tensor) -> torch.Tensor:
    """Action codes by the segment decision tree (ltv.go:300-343)."""
    a = ACTION_CODES

    def code(name: str) -> torch.Tensor:
        return torch.full_like(seg, a[name], dtype=torch.int32)

    churning = torch.where(f[:, L.NET_REVENUE] > 0, a["SEND_WINBACK_BONUS"],
                           code("SEND_ENGAGEMENT_EMAIL"))
    vip = torch.where(f[:, L.DAYS_SINCE_LAST_DEPOSIT] > 7, a["VIP_MANAGER_CALL"],
                      code("EXCLUSIVE_EVENT_INVITE"))
    high = _tiers((f[:, L.HAS_VIP_MANAGER] <= 0, a["ASSIGN_VIP_MANAGER"]),
                  (churn > 0.3, a["RETENTION_BONUS"]), default=code("LOYALTY_REWARD"))
    medium = _tiers((f[:, L.BONUSES_CLAIMED] < 3, a["SUGGEST_BONUS"]),
                    (f[:, L.GAMES_PLAYED] < 5, a["RECOMMEND_NEW_GAMES"]),
                    default=code("STANDARD_PROMOTION"))
    low = _tiers((f[:, L.DAYS_SINCE_REGISTRATION] < 7, a["ONBOARDING_GUIDE"]),
                 (f[:, L.BONUS_CONVERSION_RATE] > 0.8, a["NO_ACTION"]),
                 default=code("SMALL_DEPOSIT_BONUS"))
    out = _tiers((seg == SEG_CHURNING, churning), (seg == SEG_VIP, vip), (seg == SEG_HIGH, high),
                 (seg == SEG_MEDIUM, medium), default=low)
    return out.to(torch.int32)


def predict_batch(f, device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """The LTV pipeline over [B, 25] features (Predict, ltv.go:113-151), on
    ``device``: a numpy array or a tensor in, [B] tensors on ``device`` out."""
    from igaming_platform_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    if isinstance(f, np.ndarray):
        f = torch.from_numpy(np.ascontiguousarray(f, dtype=np.float32))
    f = f.to(device=dev, dtype=torch.float32)
    if f.dim() != 2 or f.shape[1] != NUM_LTV_FEATURES:
        raise ValueError(f"LTV features must be [B, {NUM_LTV_FEATURES}], got {tuple(f.shape)}")
    ltv = base_ltv(f)
    churn = churn_risk(f)
    adjusted = ltv * (1.0 - churn * 0.5)
    seg = determine_segment(adjusted, churn)
    return {
        "ltv": adjusted,
        "churn_risk": churn,
        "segment": seg,
        "survival_days": predict_survival(f, churn),
        "confidence": confidence(f),
        "action": next_best_action(seg, f, churn),
        "engagement": engagement_score(f),
    }


def to_host(out: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """``predict_batch``'s outputs as numpy arrays in one copy from the
    device: stacked as int32 words, the float32 ones viewed back, bits kept."""
    words = torch.stack([v.view(torch.int32) for v in out.values()]).cpu().numpy()
    return {k: w.view(np.float32) if v.dtype == torch.float32 else w
            for (k, v), w in zip(out.items(), words)}


def segment_players(f, device: str | torch.device = "cuda") -> dict[int, np.ndarray]:
    """Row indices by segment code (SegmentPlayers, ltv.go:401-414)."""
    seg = predict_batch(f, device)["segment"].cpu().numpy()
    return {int(code): np.nonzero(seg == code)[0] for code in np.unique(seg)}
