"""Configuration: the scoring and batching knobs, plus env-var getters.

A pure-Python copy of the parts of ``igaming_platform_tpu/core/config.py``
that the port's scoring engine reads. ``ScoringConfig`` is the same frozen
dataclass with the same defaults and env names. ``BatcherConfig`` keeps the
fields the port's one-lane batcher uses; the host-CPU tier
(``host_tier_rows``), the staged wire pipeline (``host_pipeline``) and
device retries (``device_retries``) are not ported yet, so their knobs are
not here either.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace


def getenv_str(key: str, default: str) -> str:
    return os.environ.get(key, default)


def getenv_int(key: str, default: int) -> int:
    raw = os.environ.get(key)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def getenv_float(key: str, default: float) -> float:
    raw = os.environ.get(key)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def getenv_bool(key: str, default: bool) -> bool:
    raw = os.environ.get(key)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


@dataclass(frozen=True)
class ScoringConfig:
    """Fraud scoring knobs (defaults = engine.go:215-228)."""

    block_threshold: int = 80
    review_threshold: int = 50

    max_tx_per_minute: int = 10
    max_tx_per_hour: int = 100
    new_account_days: int = 7
    large_deposit_amount: int = 100_000  # $1000 in cents
    max_devices_per_day: int = 3
    max_ips_per_day: int = 5

    ml_weight: float = 0.6
    rule_weight: float = 0.4

    def with_thresholds(self, block: int, review: int) -> "ScoringConfig":
        return replace(self, block_threshold=block, review_threshold=review)

    @classmethod
    def from_env(cls) -> "ScoringConfig":
        d = cls()
        return cls(
            block_threshold=getenv_int("RISK_BLOCK_THRESHOLD", d.block_threshold),
            review_threshold=getenv_int("RISK_REVIEW_THRESHOLD", d.review_threshold),
            max_tx_per_minute=getenv_int("RISK_MAX_TX_PER_MINUTE", d.max_tx_per_minute),
            max_tx_per_hour=getenv_int("RISK_MAX_TX_PER_HOUR", d.max_tx_per_hour),
            new_account_days=getenv_int("RISK_NEW_ACCOUNT_DAYS", d.new_account_days),
            large_deposit_amount=getenv_int("RISK_LARGE_DEPOSIT_AMOUNT", d.large_deposit_amount),
            max_devices_per_day=getenv_int("RISK_MAX_DEVICES_PER_DAY", d.max_devices_per_day),
            max_ips_per_day=getenv_int("RISK_MAX_IPS_PER_DAY", d.max_ips_per_day),
            ml_weight=getenv_float("RISK_ML_WEIGHT", d.ml_weight),
            rule_weight=getenv_float("RISK_RULE_WEIGHT", d.rule_weight),
        )


@dataclass(frozen=True)
class BatcherConfig:
    """Continuous-batcher knobs: device batch size, shape ladder, flush window."""

    batch_size: int = 256
    # Smaller padded shapes for latency-sensitive traffic: a near-empty
    # flush pads to the smallest tier >= its row count instead of the full
    # throughput shape. Tiers >= batch_size are ignored; () disables.
    latency_tiers: tuple[int, ...] = (256, 2048)
    max_wait_ms: float = 2.0
    max_queue: int = 65536
    # Max device batches with results still in flight (launch/readback
    # overlap); 1 = fully synchronous.
    pipeline_depth: int = 4
