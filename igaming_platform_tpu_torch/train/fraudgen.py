"""Labeled synthetic fraud generator — planted patterns, honest overlap.

The reference declares a training toolchain but ships no data and no
scripts (the reference's Makefile:215-225; services/risk/training/
absent). Model-quality claims need LABELS, so this generator plants the
three fraud archetypes the risk rules target, each as a noisy latent
process rather than a rule-threshold copy:

- **velocity burst** (engine.go's HIGH_VELOCITY family): minutes-scale
  transaction storms with elevated sums — but with a fraction of bursts
  below the rule thresholds, so learning beats thresholding;
- **multi-accounting** (MULTIPLE_DEVICES / MULTIPLE_IPS): device/IP
  fan-out on young accounts, sometimes paced slowly enough to stay under
  every velocity rule;
- **bonus abuse** (BONUS_ABUSE_PATTERN): high claim counts against thin
  deposits with near-complete wagering and fast withdrawal of winnings.

Clean traffic includes HARD NEGATIVES — legitimate high-rollers (large
amounts, rule false-positives), device-sharing families, and new players
— so rules-only and the hand-tuned mock scorer have a real error floor
and the eval ordering (trained > mock > rules) is earned, not staged.

Returns (x [n,30] raw features, y [n] binary label, kind [n] archetype).

A numpy copy of ``igaming_platform_tpu/train/fraudgen.py`` (the port
imports nothing of the JAX package): one ``np.random.Generator`` gives the
same arrays in both, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from igaming_platform_tpu_torch.core.features import F, NUM_FEATURES, derive_tx_avg

KIND_CLEAN = 0
KIND_VELOCITY = 1
KIND_MULTI_ACCOUNT = 2
KIND_BONUS_ABUSE = 3

KIND_NAMES = {
    KIND_CLEAN: "clean",
    KIND_VELOCITY: "velocity_burst",
    KIND_MULTI_ACCOUNT: "multi_accounting",
    KIND_BONUS_ABUSE: "bonus_abuse",
}


def _base_population(rng: np.random.Generator, n: int) -> np.ndarray:
    """Legitimate-traffic feature process (shared base all kinds mutate)."""
    x = np.zeros((n, NUM_FEATURES), dtype=np.float32)
    x[:, F.TX_COUNT_1M] = rng.poisson(1.2, n)
    x[:, F.TX_COUNT_5M] = x[:, F.TX_COUNT_1M] + rng.poisson(2.0, n)
    x[:, F.TX_COUNT_1H] = x[:, F.TX_COUNT_5M] + rng.poisson(8.0, n)
    x[:, F.TX_SUM_1H] = rng.gamma(2.0, 7_000, n)
    x[:, F.UNIQUE_DEVICES_24H] = 1 + rng.poisson(0.4, n)
    x[:, F.UNIQUE_IPS_24H] = 1 + rng.poisson(0.8, n)
    x[:, F.IP_COUNTRY_CHANGES] = rng.poisson(0.05, n)
    x[:, F.DEVICE_AGE_DAYS] = rng.integers(1, 500, n)
    x[:, F.ACCOUNT_AGE_DAYS] = rng.integers(0, 800, n)
    x[:, F.TOTAL_DEPOSITS] = rng.gamma(1.8, 45_000, n)
    wd = rng.uniform(0.0, 0.85, n)
    x[:, F.TOTAL_WITHDRAWALS] = x[:, F.TOTAL_DEPOSITS] * wd
    x[:, F.DEPOSIT_COUNT] = 1 + rng.poisson(6, n)
    x[:, F.WITHDRAW_COUNT] = rng.poisson(2.5, n)
    x[:, F.TIME_SINCE_LAST_TX] = rng.integers(120, 86_400 * 3, n)
    x[:, F.SESSION_DURATION] = rng.integers(30, 10_800, n)
    x[:, F.AVG_BET_SIZE] = rng.gamma(2.0, 1_200, n)
    x[:, F.WIN_RATE] = rng.beta(2.2, 3.0, n)
    x[:, F.IS_VPN] = (rng.random(n) < 0.06).astype(np.float32)
    x[:, F.IS_PROXY] = (rng.random(n) < 0.02).astype(np.float32)
    x[:, F.IS_TOR] = (rng.random(n) < 0.004).astype(np.float32)
    x[:, F.DISPOSABLE_EMAIL] = (rng.random(n) < 0.04).astype(np.float32)
    x[:, F.BONUS_CLAIM_COUNT] = rng.poisson(0.8, n)
    x[:, F.BONUS_WAGER_RATE] = rng.beta(2.0, 2.5, n)
    x[:, F.TX_AMOUNT] = rng.gamma(2.0, 5_500, n)
    tx_type = rng.integers(0, 3, n)
    x[:, F.TX_TYPE_DEPOSIT] = tx_type == 0
    x[:, F.TX_TYPE_WITHDRAW] = tx_type == 1
    x[:, F.TX_TYPE_BET] = tx_type == 2
    return x


def _harden_negatives(rng: np.random.Generator, x: np.ndarray) -> None:
    """Plant rule false-positives among the clean rows."""
    n = x.shape[0]
    # Legit high-rollers: large single amounts + big hourly sums.
    hr = rng.random(n) < 0.06
    x[hr, F.TX_AMOUNT] = rng.gamma(3.0, 90_000, int(hr.sum()))
    x[hr, F.TX_SUM_1H] = rng.gamma(3.0, 120_000, int(hr.sum()))
    x[hr, F.TOTAL_DEPOSITS] = rng.gamma(3.0, 400_000, int(hr.sum()))
    # Device-sharing households / public wifi: several devices or IPs.
    fam = rng.random(n) < 0.05
    x[fam, F.UNIQUE_DEVICES_24H] = rng.integers(3, 6, int(fam.sum()))
    x[fam, F.UNIQUE_IPS_24H] = rng.integers(4, 9, int(fam.sum()))
    # Brand-new legitimate players.
    new = rng.random(n) < 0.08
    x[new, F.ACCOUNT_AGE_DAYS] = rng.integers(0, 7, int(new.sum()))


def _plant_velocity(rng: np.random.Generator, x: np.ndarray) -> None:
    n = x.shape[0]
    # Burst intensity varies; ~30% stay BELOW the 10-per-minute rule
    # threshold (slow-burn bots) — learnable from the joint shape, not
    # from any single cutoff.
    burst = rng.gamma(2.0, 6.0, n) + 2
    x[:, F.TX_COUNT_1M] = burst
    x[:, F.TX_COUNT_5M] = burst * rng.uniform(2.0, 4.0, n)
    x[:, F.TX_COUNT_1H] = x[:, F.TX_COUNT_5M] * rng.uniform(3.0, 8.0, n)
    x[:, F.TX_SUM_1H] = rng.gamma(2.5, 45_000, n)
    x[:, F.TIME_SINCE_LAST_TX] = rng.integers(1, 240, n)
    x[:, F.SESSION_DURATION] = rng.integers(600, 28_800, n)
    x[:, F.TX_AMOUNT] = rng.gamma(2.0, 18_000, n)
    # Stolen-card cashout shape: deposits recent, withdrawals aggressive.
    x[:, F.TOTAL_WITHDRAWALS] = x[:, F.TOTAL_DEPOSITS] * rng.uniform(0.6, 1.3, n)


def _plant_multi_account(rng: np.random.Generator, x: np.ndarray) -> None:
    n = x.shape[0]
    x[:, F.UNIQUE_DEVICES_24H] = rng.integers(2, 12, n)
    x[:, F.UNIQUE_IPS_24H] = rng.integers(3, 18, n)
    x[:, F.IP_COUNTRY_CHANGES] = rng.poisson(1.5, n)
    x[:, F.ACCOUNT_AGE_DAYS] = rng.integers(0, 30, n)
    x[:, F.DEVICE_AGE_DAYS] = rng.integers(0, 20, n)
    x[:, F.IS_VPN] = (rng.random(n) < 0.45).astype(np.float32)
    x[:, F.IS_PROXY] = (rng.random(n) < 0.25).astype(np.float32)
    x[:, F.DISPOSABLE_EMAIL] = (rng.random(n) < 0.5).astype(np.float32)
    # Paced to dodge velocity rules: NORMAL transaction tempo — resampled
    # consistently across all three windows (1m <= 5m <= 1h must hold, or
    # the impossible combination itself becomes a label leak).
    x[:, F.TX_COUNT_1M] = rng.poisson(1.5, n)
    x[:, F.TX_COUNT_5M] = x[:, F.TX_COUNT_1M] + rng.poisson(2.0, n)
    x[:, F.TX_COUNT_1H] = x[:, F.TX_COUNT_5M] + rng.poisson(8.0, n)
    x[:, F.TOTAL_DEPOSITS] = rng.gamma(1.5, 12_000, n)


def _plant_bonus_abuse(rng: np.random.Generator, x: np.ndarray) -> None:
    n = x.shape[0]
    x[:, F.BONUS_CLAIM_COUNT] = rng.integers(3, 15, n)
    x[:, F.BONUS_WAGER_RATE] = rng.beta(8, 1.5, n)  # grind to completion
    x[:, F.TOTAL_DEPOSITS] = rng.gamma(1.2, 3_000, n)  # thin real money
    x[:, F.TOTAL_WITHDRAWALS] = x[:, F.TOTAL_DEPOSITS] * rng.uniform(0.8, 2.5, n)
    x[:, F.AVG_BET_SIZE] = rng.gamma(1.5, 300, n)  # min-bet grinding
    x[:, F.WIN_RATE] = rng.beta(4, 3, n)
    x[:, F.ACCOUNT_AGE_DAYS] = rng.integers(0, 60, n)
    x[:, F.DISPOSABLE_EMAIL] = (rng.random(n) < 0.4).astype(np.float32)
    x[:, F.UNIQUE_DEVICES_24H] = rng.integers(1, 5, n)


# ---------------------------------------------------------------------------
# Injectable, deterministic drift (the drift observatory's test signal)


@dataclass(frozen=True)
class DriftRamp:
    """A seedable mean/scale shift on a chosen feature subset, ramped
    over a run — the deterministic drift injector the soak harness and
    load generator share (obs/drift.py is the detector under test).

    At run fraction ``frac`` the ramp progress is 0 before
    ``start_frac``, 1 after ``end_frac``, linear between; a drifted
    value is ``v * mult(progress) + shift(progress)`` where ``mult``
    interpolates 1 -> ``scale_mult`` and ``shift`` 0 -> ``mean_shift``.
    Spec strings are colon-separated k=v pairs (the CHAOS_PLAN idiom):
    ``mult=8:start=0.4:end=0.6:features=tx_amount+tx_sum_1h``.
    """

    features: tuple[str, ...] = ("tx_amount",)
    scale_mult: float = 1.0
    mean_shift: float = 0.0
    start_frac: float = 0.0
    end_frac: float = 1.0

    def __post_init__(self):
        names = {f.name.lower() for f in F}
        bad = [f for f in self.features if f not in names]
        if bad:
            raise ValueError(f"unknown drift features {bad} (schema: "
                             "core/features.py F)")
        if not (0.0 <= self.start_frac <= 1.0 and self.end_frac >= self.start_frac):
            raise ValueError("need 0 <= start_frac <= end_frac")

    @classmethod
    def parse(cls, spec: str) -> "DriftRamp":
        kv: dict[str, str] = {}
        for part in spec.split(":"):
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad drift-ramp token {part!r} "
                                 "(want k=v[:k=v...])")
            k, v = part.split("=", 1)
            kv[k.strip()] = v.strip()
        return cls(
            features=tuple(
                f for f in kv.get("features", "tx_amount").split("+") if f),
            scale_mult=float(kv.get("mult", "1.0")),
            mean_shift=float(kv.get("shift", "0.0")),
            start_frac=float(kv.get("start", "0.0")),
            end_frac=float(kv.get("end", "1.0")),
        )

    def spec_string(self) -> str:
        return (f"features={'+'.join(self.features)}:mult={self.scale_mult}"
                f":shift={self.mean_shift}:start={self.start_frac}"
                f":end={self.end_frac}")

    def feature_indices(self) -> list[int]:
        return [int(F[name.upper()]) for name in self.features]

    def progress(self, frac: float) -> float:
        if self.end_frac <= self.start_frac:
            return 1.0 if frac >= self.start_frac else 0.0
        return float(np.clip(
            (frac - self.start_frac) / (self.end_frac - self.start_frac),
            0.0, 1.0))

    def factors(self, frac: float) -> tuple[float, float]:
        """(mult, shift) at run fraction ``frac``."""
        p = self.progress(frac)
        return 1.0 + p * (self.scale_mult - 1.0), p * self.mean_shift

    def schedule_block(self, phases: int = 8) -> list[dict]:
        """The injected schedule, recorded verbatim in artifacts so a
        drift run is reproducible from its JSON alone."""
        out = []
        for ph in range(phases):
            frac = (ph + 0.5) / phases
            mult, shift = self.factors(frac)
            out.append({"phase": ph, "frac": round(frac, 4),
                        "progress": round(self.progress(frac), 4),
                        "mult": round(mult, 4), "shift": round(shift, 4)})
        return out


# ---------------------------------------------------------------------------
# Coordinated fraud rings (the stateful sequence path's test signal)


@dataclass(frozen=True)
class FraudRing:
    """A seedable coordinated multi-account fraud ring: ``ring_size``
    accounts cycling bet -> deposit in lock-step, phase-staggered so the
    ring's aggregate cadence is smooth, each member pacing WELL under
    every velocity rule (default: 2 events per 90 s = 80/h against the
    100/h rule, ~1/min against the 10/min rule) with small, near-uniform
    amounts no aggregate threshold notices. Every individual event —
    and every individual account's windowed aggregates — looks benign;
    the fraud is the *temporal pattern across the session window*, which
    only the stateful sequence path (serve/session_state.py) sees at
    score time.

    Spec strings are colon-separated k=v pairs (the DriftRamp idiom):
    ``size=6:period=90:cycles=12:amount=900:jitter=0.5``.
    """

    ring_size: int = 6
    period_s: float = 90.0     # one bet->deposit cycle per account
    cycles: int = 12
    amount: int = 900          # cents — far below every amount rule
    amount_jitter: float = 0.08  # relative amount wobble inside the ring
    time_jitter_s: float = 0.5   # per-event schedule wobble (seconds)
    start_s: float = 0.0
    account_prefix: str = "ring"

    def __post_init__(self):
        if self.ring_size < 2:
            raise ValueError("ring_size must be >= 2")
        if self.period_s <= 0 or self.cycles < 1:
            raise ValueError("need period_s > 0 and cycles >= 1")

    @classmethod
    def parse(cls, spec: str) -> "FraudRing":
        kv: dict[str, str] = {}
        for part in spec.split(":"):
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad fraud-ring token {part!r} "
                                 "(want k=v[:k=v...])")
            k, v = part.split("=", 1)
            kv[k.strip()] = v.strip()
        return cls(
            ring_size=int(kv.get("size", "6")),
            period_s=float(kv.get("period", "90")),
            cycles=int(kv.get("cycles", "12")),
            amount=int(kv.get("amount", "900")),
            amount_jitter=float(kv.get("amount_jitter", "0.08")),
            time_jitter_s=float(kv.get("jitter", "0.5")),
            start_s=float(kv.get("start", "0")),
            account_prefix=kv.get("prefix", "ring"),
        )

    def spec_string(self) -> str:
        return (f"size={self.ring_size}:period={self.period_s}"
                f":cycles={self.cycles}:amount={self.amount}"
                f":amount_jitter={self.amount_jitter}"
                f":jitter={self.time_jitter_s}:start={self.start_s}"
                f":prefix={self.account_prefix}")

    def accounts(self) -> list[str]:
        return [f"{self.account_prefix}-{i}" for i in range(self.ring_size)]

    def schedule(self, seed: int) -> list[dict]:
        """The deterministic event schedule: time-ordered rows of
        ``{"t_s", "account_id", "amount", "tx_type"}``. Accounts are
        phase-staggered by ``period_s / ring_size`` (the coordination
        signature); each cycle is a bet at the cycle start and a deposit
        half a period later — rapid bet-deposit cycling at machine-regular
        cadence, the thing the session pattern head keys on."""
        rng = np.random.default_rng(seed)
        rows: list[dict] = []
        stagger = self.period_s / self.ring_size
        for i, acct in enumerate(self.accounts()):
            phase = self.start_s + i * stagger
            for c in range(self.cycles):
                base = phase + c * self.period_s
                for off, tx in ((0.0, "bet"), (self.period_s / 2.0, "deposit")):
                    t = base + off + float(
                        rng.uniform(-self.time_jitter_s, self.time_jitter_s))
                    amt = max(1, int(round(self.amount * (
                        1.0 + float(rng.uniform(-self.amount_jitter,
                                                self.amount_jitter))))))
                    rows.append({"t_s": round(t, 4), "account_id": acct,
                                 "amount": amt, "tx_type": tx})
        rows.sort(key=lambda r: r["t_s"])
        return rows

    def schedule_block(self, seed: int) -> dict:
        """The injected schedule summary, recorded verbatim in run
        artifacts (the --drift-ramp pattern) so a fraud-ring run is
        reproducible from its JSON alone."""
        rows = self.schedule(seed)
        return {
            "spec": self.spec_string(),
            "seed": seed,
            "accounts": self.accounts(),
            "events": len(rows),
            "events_per_account_per_hour": round(
                2.0 * 3600.0 / self.period_s, 2),
            "first_events": rows[:8],
            "duration_s": round(rows[-1]["t_s"] - rows[0]["t_s"], 3)
            if rows else 0.0,
        }


def apply_drift_ramp(x: np.ndarray, ramp: DriftRamp, frac: float) -> np.ndarray:
    """Return a drifted COPY of ``x`` ([..., 30] raw features) at run
    fraction ``frac`` — only the ramp's feature subset moves. Derived
    features (TX_AVG_1H) are re-derived when their inputs drifted, so
    the injected rows stay internally consistent."""
    mult, shift = ramp.factors(frac)
    out = np.array(x, dtype=np.float32, copy=True)
    idxs = ramp.feature_indices()
    for i in idxs:
        out[..., i] = out[..., i] * mult + shift
    if int(F.TX_SUM_1H) in idxs or int(F.TX_COUNT_1H) in idxs:
        derive_tx_avg(out)
    return out


def generate_labeled(
    rng: np.random.Generator, n: int, fraud_rate: float = 0.12
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """n rows; fraud split evenly across the three archetypes."""
    x = _base_population(rng, n)
    kind = np.zeros(n, dtype=np.int32)
    u = rng.random(n)
    third = fraud_rate / 3.0
    kind[u < third] = KIND_VELOCITY
    kind[(u >= third) & (u < 2 * third)] = KIND_MULTI_ACCOUNT
    kind[(u >= 2 * third) & (u < fraud_rate)] = KIND_BONUS_ABUSE

    clean = kind == KIND_CLEAN
    # Hard negatives mutate a view of the clean subset in place.
    xc = x[clean]
    _harden_negatives(rng, xc)
    x[clean] = xc
    for k, planter in (
        (KIND_VELOCITY, _plant_velocity),
        (KIND_MULTI_ACCOUNT, _plant_multi_account),
        (KIND_BONUS_ABUSE, _plant_bonus_abuse),
    ):
        m = kind == k
        if m.any():
            xk = x[m]
            planter(rng, xk)
            x[m] = xk

    x[:, F.NET_DEPOSIT] = x[:, F.TOTAL_DEPOSITS] - x[:, F.TOTAL_WITHDRAWALS]
    x[:, F.BONUS_ONLY_PLAYER] = (
        (x[:, F.BONUS_CLAIM_COUNT] > 3) & (x[:, F.TOTAL_DEPOSITS] < 5000)
    ).astype(np.float32)
    derive_tx_avg(x)
    return x, (kind > 0).astype(np.float32), kind
