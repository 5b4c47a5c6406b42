"""Wagering histories from a seed: a vectorised, frozen copy of the patterns of
the port's ``train/abuse_train.py`` (normal play against three abuse
patterns), as [n, S, 12] float32 event rows and [n] labels.

The event row is ``[log1p(amount), log1p(dt), 8-way type one-hot,
game_weight, balance_ratio]`` with the type order deposit, withdraw, bet,
win, refund, bonus_grant, bonus_wager, adjustment. Each batch holds exactly
half abuse histories, in a shuffled order, so every seed gives the same
work. The draws differ from the program's per-event loop; the
distributions are the same.
"""

from __future__ import annotations

import numpy as np

EVENT_DIM = 12
DEPOSIT, WITHDRAW, BET, WIN, BONUS_GRANT, BONUS_WAGER = 0, 1, 2, 3, 5, 6


def _normal(rng: np.random.Generator, n: int, s: int):
    r = rng.random((n, s))
    kind = np.digitize(r, [0.1, 0.75, 0.95])  # deposit, bet, win, withdraw
    amount_scale = np.array([5000.0, 800.0, 1200.0, 8000.0])[kind]
    dt_scale = np.array([3600.0, 60.0, 30.0, 86400.0])[kind]
    amount = rng.gamma(2.0, 1.0, (n, s)) * amount_scale
    dt = rng.gamma(2.0, 1.0, (n, s)) * dt_scale
    tx = np.array([DEPOSIT, BET, WIN, WITHDRAW])[kind]
    weight = np.where(kind == 1, rng.choice([1.0, 0.5, 0.2], (n, s)), 1.0)
    return amount, dt, tx, weight, np.full((n, s), 0.5)


def _abuse(rng: np.random.Generator, n: int, s: int):
    pattern = rng.integers(0, 3, n)[:, None]
    pos = np.arange(s)[None, :]
    amount, dt = np.empty((n, s)), np.empty((n, s))
    tx, weight, ratio = np.empty((n, s), np.int64), np.ones((n, s)), np.full((n, s), 0.5)
    # 0: bonus grant, six low-weight wagers, withdraw; repeated.
    phase = np.broadcast_to(pos % 8, (n, s))
    p0 = pattern == 0
    grant, wager, out = p0 & (phase == 0), p0 & (phase > 0) & (phase < 7), p0 & (phase == 7)
    amount[grant], dt[grant], tx[grant] = 2000.0, 60.0, BONUS_GRANT
    amount[wager], tx[wager], weight[wager] = 100.0, BONUS_WAGER, 0.1
    dt[wager] = rng.gamma(2.0, 5.0, int(wager.sum()))
    amount[out], dt[out], tx[out], ratio[out] = 2000.0, 30.0, WITHDRAW, 0.95
    # 1: metronomic minimum bets.
    p1 = np.broadcast_to(pattern == 1, (n, s))
    amount[p1], dt[p1], tx[p1], ratio[p1] = 100.0, 2.0, BET, 0.9
    # 2: deposit, then an instant withdrawal; repeated.
    p2 = pattern == 2
    dep, wd = p2 & (pos % 2 == 0), p2 & (pos % 2 == 1)
    amount[dep], tx[dep] = 5000.0, DEPOSIT
    dt[dep] = rng.gamma(2.0, 20.0, int(dep.sum()))
    amount[wd], tx[wd], ratio[wd] = 4900.0, WITHDRAW, 0.98
    dt[wd] = rng.gamma(2.0, 60.0, int(wd.sum()))
    return amount, dt, tx, weight, ratio


def _rows(out: np.ndarray, amount, dt, tx, weight, ratio) -> None:
    out[...] = 0.0
    out[..., 0] = np.log1p(np.maximum(amount, 0.0))
    out[..., 1] = np.log1p(np.maximum(dt, 0.0))
    np.put_along_axis(out, (2 + tx)[..., None], 1.0, axis=-1)
    out[..., 10] = weight
    out[..., 11] = ratio


def fill_batch(rng: np.random.Generator, x: np.ndarray, y: np.ndarray) -> None:
    """Fill one batch in place: ``x`` [B, S, 12] float32, ``y`` [B] float32;
    B/2 abuse histories (label 1) and B - B/2 normal ones, shuffled."""
    b, s = x.shape[0], x.shape[1]
    labels = np.zeros(b, dtype=np.float32)
    labels[: b // 2] = 1.0
    labels = labels[rng.permutation(b)]
    abuse = labels == 1.0
    na = int(abuse.sum())
    xa = np.empty((na, s, EVENT_DIM), np.float32)
    xn = np.empty((b - na, s, EVENT_DIM), np.float32)
    _rows(xa, *_abuse(rng, na, s))
    _rows(xn, *_normal(rng, b - na, s))
    x[abuse] = xa
    x[~abuse] = xn
    y[...] = labels


def fill_pool(seed: int, x: np.ndarray, y: np.ndarray) -> None:
    """Fill ``x`` [n, B, S, 12] and ``y`` [n, B] (float32, e.g. views of
    pinned tensors) with n batches drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    for i in range(x.shape[0]):
        fill_batch(rng, x[i], y[i])
