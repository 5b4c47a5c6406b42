"""Synthetic transaction stream and distillation targets for training.

Counterpart of ``igaming_platform_tpu/train/data.py``. Until labelled data
is plugged in, training distils reference-semantics teachers into the
multitask net:

- fraud target: the mock scorer's probability (``models/mock_model.py``);
- churn target: an LTV-heuristic-shaped function of recency and velocity;
- ltv target: net-deposit run-rate scaled by engagement.

``Batch``, ``sample_features`` and ``make_aux_targets`` are numpy copies of
the JAX package's: one ``np.random.Generator`` gives the same arrays bit for
bit. The fraud teacher runs the port's ``mock_predict(normalize(x,
ref_compat=True))`` on the CPU. Batches are plain (x_raw [B, 30], targets)
records: a real event-log reader can take ``make_stream``'s place without
touching the trainer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from igaming_platform_tpu_torch.core.features import F, NUM_FEATURES, derive_tx_avg, normalize
from igaming_platform_tpu_torch.models.mock_model import mock_predict


@dataclass
class Batch:
    x: np.ndarray  # [B, 30] raw features
    fraud: np.ndarray  # [B] soft target in [0, 1]
    ltv: np.ndarray  # [B] dollar value (scaled at loss time)
    churn: np.ndarray  # [B] soft target in [0, 1]


def sample_features(rng: np.random.Generator, n: int) -> np.ndarray:
    """Raw feature batch over serving-realistic ranges (mix of clean and
    fraud-shaped traffic so the distilled net sees both modes)."""
    x = np.zeros((n, NUM_FEATURES), dtype=np.float32)
    fraudish = rng.random(n) < 0.25

    x[:, F.TX_COUNT_1M] = rng.poisson(np.where(fraudish, 12, 1.5))
    x[:, F.TX_COUNT_5M] = x[:, F.TX_COUNT_1M] + rng.poisson(3, n)
    x[:, F.TX_COUNT_1H] = x[:, F.TX_COUNT_5M] + rng.poisson(np.where(fraudish, 120, 10))
    x[:, F.TX_SUM_1H] = rng.gamma(2.0, np.where(fraudish, 60_000, 8_000))
    x[:, F.UNIQUE_DEVICES_24H] = rng.poisson(np.where(fraudish, 4, 1)) + 1
    x[:, F.UNIQUE_IPS_24H] = rng.poisson(np.where(fraudish, 6, 1)) + 1
    x[:, F.IP_COUNTRY_CHANGES] = rng.poisson(np.where(fraudish, 2, 0.1))
    x[:, F.DEVICE_AGE_DAYS] = rng.integers(0, 400, n)
    x[:, F.ACCOUNT_AGE_DAYS] = np.where(fraudish, rng.integers(0, 14, n), rng.integers(0, 700, n))
    x[:, F.TOTAL_DEPOSITS] = rng.gamma(2.0, 50_000, n)
    wd_frac = np.where(fraudish, rng.uniform(0.7, 1.2, n), rng.uniform(0.0, 0.8, n))
    x[:, F.TOTAL_WITHDRAWALS] = x[:, F.TOTAL_DEPOSITS] * wd_frac
    x[:, F.NET_DEPOSIT] = x[:, F.TOTAL_DEPOSITS] - x[:, F.TOTAL_WITHDRAWALS]
    x[:, F.DEPOSIT_COUNT] = rng.poisson(8, n)
    x[:, F.WITHDRAW_COUNT] = rng.poisson(3, n)
    x[:, F.TIME_SINCE_LAST_TX] = np.where(
        fraudish, rng.integers(1, 600, n), rng.integers(60, 86400, n)
    )
    x[:, F.SESSION_DURATION] = rng.integers(0, 14_400, n)
    x[:, F.AVG_BET_SIZE] = rng.gamma(2.0, 1_500, n)
    x[:, F.WIN_RATE] = rng.beta(2, 3, n)
    x[:, F.IS_VPN] = (rng.random(n) < np.where(fraudish, 0.4, 0.05)).astype(np.float32)
    x[:, F.IS_PROXY] = (rng.random(n) < np.where(fraudish, 0.2, 0.02)).astype(np.float32)
    x[:, F.IS_TOR] = (rng.random(n) < np.where(fraudish, 0.15, 0.005)).astype(np.float32)
    x[:, F.DISPOSABLE_EMAIL] = (rng.random(n) < np.where(fraudish, 0.3, 0.03)).astype(np.float32)
    x[:, F.BONUS_CLAIM_COUNT] = rng.poisson(np.where(fraudish, 5, 1))
    x[:, F.BONUS_WAGER_RATE] = rng.beta(2, 2, n)
    x[:, F.BONUS_ONLY_PLAYER] = (
        (x[:, F.BONUS_CLAIM_COUNT] > 3) & (x[:, F.TOTAL_DEPOSITS] < 5000)
    ).astype(np.float32)
    x[:, F.TX_AMOUNT] = rng.gamma(2.0, np.where(fraudish, 40_000, 5_000))
    tx_type = rng.integers(0, 3, n)
    x[:, F.TX_TYPE_DEPOSIT] = tx_type == 0
    x[:, F.TX_TYPE_WITHDRAW] = tx_type == 1
    x[:, F.TX_TYPE_BET] = tx_type == 2
    derive_tx_avg(x)
    return x


def make_aux_targets(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(ltv, churn) teacher targets — pure numpy, no model forward.
    Split out so callers that supply their own fraud labels (train/eval.py)
    don't pay a mock_predict dispatch per batch just to discard it."""
    # Churn-shaped target: stale accounts with withdrawal-dominated flows.
    stale = np.clip(x[:, F.TIME_SINCE_LAST_TX] / 86_400.0, 0, 1)
    wd_dom = (x[:, F.TOTAL_WITHDRAWALS] > x[:, F.TOTAL_DEPOSITS]).astype(np.float32)
    churn = np.clip(0.6 * stale + 0.3 * wd_dom + 0.1 * (x[:, F.SESSION_DURATION] < 60), 0, 1)

    # LTV-shaped target (dollars): net deposit run-rate x engagement proxy.
    net_dollars = x[:, F.NET_DEPOSIT] / 100.0
    engagement = 1.0 - 0.5 * stale
    ltv = np.maximum(net_dollars, 0.0) * (1.0 + engagement)
    return ltv.astype(np.float32), churn.astype(np.float32)


def make_targets(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Teacher targets from reference-semantics functions."""
    fraud = mock_predict(normalize(torch.from_numpy(x), ref_compat=True)).numpy()
    ltv, churn = make_aux_targets(x)
    return fraud.astype(np.float32), ltv, churn


def make_stream(batch_size: int, seed: int = 0) -> Iterator[Batch]:
    rng = np.random.default_rng(seed)
    while True:
        x = sample_features(rng, batch_size)
        fraud, ltv, churn = make_targets(x)
        yield Batch(x=x, fraud=fraud, ltv=ltv, churn=churn)
