"""The 30-dim fraud feature schema, the device input contract, in PyTorch.

Counterpart of ``igaming_platform_tpu/core/features.py``. The schema order,
the masks and the arithmetic of ``normalize`` and ``standardize_for_model``
are the same, op for op, so the port sees the same normalized features as
the JAX package. The masks stay numpy float32 constants; each is copied to
a device once and reused.

``normalize(..., ref_compat=True)`` reproduces the reference's stubbed
identity ``log1p`` (onnx_model.go:193-195) for the mock scorer's golden
parity. The default applies the real ``log1p``, rounded from float64
(``core/numerics.py``: the same bits on the CPU and the card). Where that
runs, XLA's CPU ``log1p`` is another float32 approximation (within 2.5 ulp
of the exact value), so the two packages agree there to a few ulp, not bit
for bit. Every other column is bit-exact.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, fields

import numpy as np
import torch

from igaming_platform_tpu_torch.core import numerics
from igaming_platform_tpu_torch.core.device import constant


class F(enum.IntEnum):
    """Feature indices (onnx_model.go:133-166 ordering)."""

    # Velocity (0-4)
    TX_COUNT_1M = 0
    TX_COUNT_5M = 1
    TX_COUNT_1H = 2
    TX_SUM_1H = 3
    TX_AVG_1H = 4
    # Device (5-8)
    UNIQUE_DEVICES_24H = 5
    UNIQUE_IPS_24H = 6
    IP_COUNTRY_CHANGES = 7
    DEVICE_AGE_DAYS = 8
    # Account (9-14)
    ACCOUNT_AGE_DAYS = 9
    TOTAL_DEPOSITS = 10
    TOTAL_WITHDRAWALS = 11
    NET_DEPOSIT = 12
    DEPOSIT_COUNT = 13
    WITHDRAW_COUNT = 14
    # Behavioral (15-18)
    TIME_SINCE_LAST_TX = 15
    SESSION_DURATION = 16
    AVG_BET_SIZE = 17
    WIN_RATE = 18
    # Risk indicators (19-22)
    IS_VPN = 19
    IS_PROXY = 20
    IS_TOR = 21
    DISPOSABLE_EMAIL = 22
    # Bonus (23-25)
    BONUS_CLAIM_COUNT = 23
    BONUS_WAGER_RATE = 24
    BONUS_ONLY_PLAYER = 25
    # Transaction context (26-29)
    TX_AMOUNT = 26
    TX_TYPE_DEPOSIT = 27
    TX_TYPE_WITHDRAW = 28
    TX_TYPE_BET = 29


NUM_FEATURES = 30

FEATURE_NAMES: tuple[str, ...] = tuple(f.name.lower() for f in F)

# Features that get a log1p transform (onnx_model.go:171-174).
LOG_FEATURES = (F.TX_SUM_1H, F.TOTAL_DEPOSITS, F.TOTAL_WITHDRAWALS, F.TX_AMOUNT)

# Min-max scaled count features: index -> (min, max) (onnx_model.go:177-183).
MINMAX_BOUNDS: dict[int, tuple[float, float]] = {
    F.TX_COUNT_1M: (0.0, 20.0),
    F.TX_COUNT_5M: (0.0, 50.0),
    F.TX_COUNT_1H: (0.0, 200.0),
    F.UNIQUE_DEVICES_24H: (0.0, 10.0),
    F.UNIQUE_IPS_24H: (0.0, 20.0),
    F.ACCOUNT_AGE_DAYS: (0.0, 365.0),
    F.TIME_SINCE_LAST_TX: (0.0, 86400.0),
}

_LOG_MASK = np.zeros((NUM_FEATURES,), dtype=np.float32)
for _i in LOG_FEATURES:
    _LOG_MASK[_i] = 1.0

_MM_MASK = np.zeros((NUM_FEATURES,), dtype=np.float32)
_MM_MIN = np.zeros((NUM_FEATURES,), dtype=np.float32)
_MM_SCALE = np.ones((NUM_FEATURES,), dtype=np.float32)
for _i, (_lo, _hi) in MINMAX_BOUNDS.items():
    _MM_MASK[_i] = 1.0
    _MM_MIN[_i] = _lo
    _MM_SCALE[_i] = 1.0 / (_hi - _lo)

# Features still unbounded after `normalize`, squashed by
# `standardize_for_model` before entering trained models.
_UNBOUNDED_FEATURES = (
    F.TX_AVG_1H,
    F.IP_COUNTRY_CHANGES,
    F.DEVICE_AGE_DAYS,
    F.NET_DEPOSIT,
    F.DEPOSIT_COUNT,
    F.WITHDRAW_COUNT,
    F.SESSION_DURATION,
    F.AVG_BET_SIZE,
    F.BONUS_CLAIM_COUNT,
)
_SQUASH_MASK = np.zeros((NUM_FEATURES,), dtype=np.float32)
for _i in _UNBOUNDED_FEATURES:
    _SQUASH_MASK[_i] = 1.0

_CONSTANTS = {
    "log": _LOG_MASK,
    "log_keep": 1.0 - _LOG_MASK,
    "mm": _MM_MASK,
    "mm_keep": 1.0 - _MM_MASK,
    "mm_min": _MM_MIN,
    "mm_scale": _MM_SCALE,
    "squash": _SQUASH_MASK,
    "squash_keep": 1.0 - _SQUASH_MASK,
}


def _const(name: str, device: torch.device) -> torch.Tensor:
    return constant("features." + name, _CONSTANTS[name], device)


def standardize_for_model(xn: torch.Tensor) -> torch.Tensor:
    """Signed-log squash of the features `normalize` leaves unbounded:
    sign(x)*log1p(|x|) on those, the rest passed through untouched."""
    xn = torch.as_tensor(xn, dtype=torch.float32)
    squashed = torch.sign(xn) * numerics.log1p(torch.abs(xn))
    d = xn.device
    return xn * _const("squash_keep", d) + squashed * _const("squash", d)


def normalize(x: torch.Tensor, *, ref_compat: bool = False) -> torch.Tensor:
    """Vectorized feature normalization over a [..., 30] tensor.

    ``ref_compat=True`` reproduces the reference's stubbed log1p (identity
    for positive values); the default applies the real log1p.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    d = x.device
    if ref_compat:
        logged = torch.where(x <= 0.0, 0.0, x)
    else:
        logged = torch.where(x <= 0.0, 0.0, numerics.log1p(torch.clamp_min(x, 0.0)))
    x = x * _const("log_keep", d) + logged * _const("log", d)

    scaled = torch.clamp((x - _const("mm_min", d)) * _const("mm_scale", d), 0.0, 1.0)
    return x * _const("mm_keep", d) + scaled * _const("mm", d)


@dataclass
class FeatureVector:
    """Host-side named view of one feature row, in schema order."""

    tx_count_1m: float = 0.0
    tx_count_5m: float = 0.0
    tx_count_1h: float = 0.0
    tx_sum_1h: float = 0.0
    tx_avg_1h: float = 0.0
    unique_devices_24h: float = 0.0
    unique_ips_24h: float = 0.0
    ip_country_changes: float = 0.0
    device_age_days: float = 0.0
    account_age_days: float = 0.0
    total_deposits: float = 0.0
    total_withdrawals: float = 0.0
    net_deposit: float = 0.0
    deposit_count: float = 0.0
    withdraw_count: float = 0.0
    time_since_last_tx: float = 0.0
    session_duration: float = 0.0
    avg_bet_size: float = 0.0
    win_rate: float = 0.0
    is_vpn: float = 0.0
    is_proxy: float = 0.0
    is_tor: float = 0.0
    disposable_email: float = 0.0
    bonus_claim_count: float = 0.0
    bonus_wager_rate: float = 0.0
    bonus_only_player: float = 0.0
    tx_amount: float = 0.0
    tx_type_deposit: float = 0.0
    tx_type_withdraw: float = 0.0
    tx_type_bet: float = 0.0

    def to_array(self) -> np.ndarray:
        return np.array([getattr(self, f.name) for f in fields(self)], dtype=np.float32)

    @classmethod
    def from_array(cls, arr) -> "FeatureVector":
        arr = np.asarray(arr, dtype=np.float32)
        if arr.shape != (NUM_FEATURES,):
            raise ValueError(f"feature row has shape {arr.shape}, want ({NUM_FEATURES},)")
        return cls(**{f.name: float(arr[i]) for i, f in enumerate(fields(cls))})

    def with_tx_context(self, amount_cents: float, tx_type: str) -> "FeatureVector":
        """Return a copy with the transaction-context tail (26-29) filled."""
        out = FeatureVector(**{f.name: getattr(self, f.name) for f in fields(self)})
        out.tx_amount = float(amount_cents)
        out.tx_type_deposit = 1.0 if tx_type == "deposit" else 0.0
        out.tx_type_withdraw = 1.0 if tx_type == "withdraw" else 0.0
        out.tx_type_bet = 1.0 if tx_type == "bet" else 0.0
        return out


if tuple(f.name for f in fields(FeatureVector)) != FEATURE_NAMES:
    raise ImportError("FeatureVector fields drifted from the feature schema")


def batch_from_vectors(vectors: list[FeatureVector]) -> np.ndarray:
    """Stack host feature vectors into a [B, 30] float32 batch."""
    if not vectors:
        return np.zeros((0, NUM_FEATURES), dtype=np.float32)
    return np.stack([v.to_array() for v in vectors])


def derive_tx_avg(x: np.ndarray) -> np.ndarray:
    """Fill TX_AVG_1H = TX_SUM_1H / TX_COUNT_1H where count > 0
    (engine.go:412-414). Mutates and returns ``x``."""
    count = x[..., F.TX_COUNT_1H]
    with np.errstate(divide="ignore", invalid="ignore"):
        avg = np.where(count > 0, x[..., F.TX_SUM_1H] / np.maximum(count, 1), 0.0)
    x[..., F.TX_AVG_1H] = avg
    return x
