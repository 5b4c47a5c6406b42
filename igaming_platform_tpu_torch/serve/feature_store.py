"""Host-side feature store: the gather stage feeding device batches.

A copy of ``igaming_platform_tpu/serve/feature_store.py``, with the same
feature semantics (reference: redis_store.go:60-168, engine.go:127-140,
redis_store.go:244-293):

- real-time features: sliding-window velocity counts over a per-account
  transaction history, a 1h rolling sum with TTL, HyperLogLog device/IP
  cardinalities, last-tx timestamp, a session start with 30-min sliding TTL;
- batch features: per-account aggregates, maintained incrementally;
- blacklists: device/ip/fingerprint sets.

``gather_batch`` resolves N requests into one [N, 30] float32 matrix and a
[N] bool blacklist vector. ``fill_row`` writes with Python (float64)
arithmetic into the float32 row, as the JAX package's does, so both stores
gather the same bits. Both take ``now`` so that a caller can pin the clock;
the port's store also takes a ``clock`` for the calls that pass none.
Every write calls ``delta_listener`` (when set) with the account id, after
the write: the device feature cache (``serve/device_cache.py``) marks the
account's resident row stale there. The JAX store's fault-injection seam is
not part of the port.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from igaming_platform_tpu_torch.core.features import F, NUM_FEATURES
from igaming_platform_tpu_torch.serve.hll import HyperLogLog

SECONDS_1M = 60
SECONDS_5M = 300
SECONDS_1H = 3600
SESSION_TTL = 1800  # 30 min sliding session window (redis_store.go:157-160)


@dataclass(slots=True)
class TransactionEvent:
    """Feature-update payload (scoring engine TransactionEvent, engine.go:143-150)."""

    account_id: str
    amount: int
    tx_type: str
    ip: str = ""
    device_id: str = ""
    timestamp: float = 0.0


@dataclass
class _AccountState:
    history: deque = field(default_factory=deque)  # (ts, amount) pairs, 1h window
    sum_1h: int = 0
    sum_expires_at: float = 0.0
    devices: HyperLogLog = field(default_factory=lambda: HyperLogLog(12))
    ips: HyperLogLog = field(default_factory=lambda: HyperLogLog(12))
    hll_expires_at: float = 0.0
    last_tx_ts: float = 0.0
    session_start: float = 0.0
    session_expires_at: float = 0.0

    # Batch aggregates (ClickHouse analog, engine.go:127-140)
    total_deposits: int = 0
    total_withdrawals: int = 0
    deposit_count: int = 0
    withdraw_count: int = 0
    total_bets: int = 0
    total_wins: int = 0
    bet_count: int = 0
    win_count: int = 0
    bonus_claim_count: int = 0
    bonus_wager_complete: float = 0.0
    created_at: float = 0.0


class InMemoryFeatureStore:
    """Thread-safe per-account feature state with Redis-equivalent semantics."""

    def __init__(self, hll_precision: int = 12, clock: Callable[[], float] = time.time):
        # ``clock`` stands in for the wall clock wherever no timestamp or
        # ``now`` is given, so that a caller can pin it for a whole stream.
        self._clock = clock
        self._accounts: dict[str, _AccountState] = {}
        self._lock = threading.RLock()
        self._hll_precision = hll_precision
        self._blacklists: dict[str, set[str]] = {"device": set(), "ip": set(), "fingerprint": set()}
        # Write-back hook of the device feature cache: called with the
        # account id after every write. Must be cheap and must not raise.
        self.delta_listener = None

    @property
    def clock(self) -> Callable[[], float]:
        return self._clock

    def _emit_delta(self, account_id: str) -> None:
        if self.delta_listener is not None:
            self.delta_listener(account_id)

    def _state(self, account_id: str, now: float) -> _AccountState:
        st = self._accounts.get(account_id)
        if st is None:
            st = _AccountState(
                devices=HyperLogLog(self._hll_precision),
                ips=HyperLogLog(self._hll_precision),
            )
            st.created_at = now
            self._accounts[account_id] = st
        return st

    # -- writes -------------------------------------------------------------

    def update(self, event: TransactionEvent) -> None:
        """Post-transaction feature write-back (UpdateRealTimeFeatures,
        redis_store.go:119-168, + incremental batch aggregates)."""
        now = event.timestamp or self._clock()
        with self._lock:
            st = self._state(event.account_id, now)

            # Sliding-window history with 1h pruning (ZADD + ZREMRANGEBYSCORE).
            st.history.append((now, event.amount))
            cutoff = now - SECONDS_1H
            while st.history and st.history[0][0] < cutoff:
                st.history.popleft()

            # 1h sum with TTL semantics (INCRBY + EXPIRE 1h).
            if now > st.sum_expires_at:
                st.sum_1h = 0
            st.sum_1h += event.amount
            st.sum_expires_at = now + SECONDS_1H

            # HLLs with 24h TTL.
            if now > st.hll_expires_at:
                st.devices.reset()
                st.ips.reset()
            st.hll_expires_at = now + 24 * SECONDS_1H
            if event.device_id:
                st.devices.add(event.device_id)
            if event.ip:
                st.ips.add(event.ip)

            st.last_tx_ts = now

            # SETNX session start + sliding 30-min TTL.
            if now > st.session_expires_at:
                st.session_start = now
            st.session_expires_at = now + SESSION_TTL

            # Batch aggregates.
            if event.tx_type == "deposit":
                st.total_deposits += event.amount
                st.deposit_count += 1
            elif event.tx_type == "withdraw":
                st.total_withdrawals += event.amount
                st.withdraw_count += 1
            elif event.tx_type == "bet":
                st.total_bets += event.amount
                st.bet_count += 1
            elif event.tx_type == "win":
                st.total_wins += event.amount
                st.win_count += 1
        self._emit_delta(event.account_id)

    def load_batch_features(
        self, account_id: str, *,
        total_deposits: int = 0, total_withdrawals: int = 0,
        deposit_count: int = 0, withdraw_count: int = 0,
        total_bets: int = 0, total_wins: int = 0,
        bet_count: int = 0, win_count: int = 0,
        bonus_claim_count: int | None = None,
        created_at: float | None = None,
    ) -> None:
        """Bulk-overwrite the batch aggregates from an authoritative scan
        (the hourly ClickHouse refresh of risk/cmd/main.go:226-236, which
        the reference declares but leaves commented out). Realtime windows
        (velocity, HLLs, sessions) are NOT touched — they remain stream-fed."""
        with self._lock:
            st = self._state(account_id, self._clock())
            st.total_deposits = total_deposits
            st.total_withdrawals = total_withdrawals
            st.deposit_count = deposit_count
            st.withdraw_count = withdraw_count
            st.total_bets = total_bets
            st.total_wins = total_wins
            st.bet_count = bet_count
            st.win_count = win_count
            if bonus_claim_count is not None:
                st.bonus_claim_count = bonus_claim_count
            if created_at is not None:
                st.created_at = created_at
        self._emit_delta(account_id)

    def record_bonus_claim(self, account_id: str, wager_complete_rate: float | None = None) -> None:
        with self._lock:
            st = self._state(account_id, self._clock())
            st.bonus_claim_count += 1
            if wager_complete_rate is not None:
                st.bonus_wager_complete = wager_complete_rate
        self._emit_delta(account_id)

    # -- reads --------------------------------------------------------------

    def velocity(self, account_id: str, now: float | None = None) -> tuple[int, int, int]:
        """(count_1m, count_5m, count_1h) — GetVelocity (redis_store.go:171-193)."""
        now = now or self._clock()
        with self._lock:
            st = self._accounts.get(account_id)
            if st is None:
                return 0, 0, 0
            c1 = c5 = ch = 0
            for ts, _ in st.history:
                if ts >= now - SECONDS_1H:
                    ch += 1
                    if ts >= now - SECONDS_5M:
                        c5 += 1
                        if ts >= now - SECONDS_1M:
                            c1 += 1
            return c1, c5, ch

    def check_rate_limit(self, account_id: str, max_per_min: int, max_per_hour: int) -> bool:
        c1, _, ch = self.velocity(account_id)
        return c1 >= max_per_min or ch >= max_per_hour

    # -- blacklist (redis_store.go:244-293) ---------------------------------

    def add_to_blacklist(self, list_type: str, value: str) -> None:
        if list_type not in self._blacklists:
            raise ValueError(f"unknown blacklist type: {list_type}")
        with self._lock:
            self._blacklists[list_type].add(value)

    def check_blacklist(self, device_id: str = "", fingerprint: str = "", ip: str = "") -> bool:
        with self._lock:
            return (
                (bool(device_id) and device_id in self._blacklists["device"])
                or (bool(fingerprint) and fingerprint in self._blacklists["fingerprint"])
                or (bool(ip) and ip in self._blacklists["ip"])
            )

    # -- device batch assembly ---------------------------------------------

    def fill_row(
        self,
        out: np.ndarray,
        account_id: str,
        amount: int,
        tx_type: str,
        now: float | None = None,
    ) -> None:
        """Fill one row of a [*, 30] batch in the schema order, merging
        realtime + batch features exactly like extractFeatures
        (engine.go:326-417)."""
        now = now or self._clock()
        with self._lock:
            st = self._accounts.get(account_id)
            if st is not None:
                c1 = c5 = ch = 0
                for ts, _ in st.history:
                    if ts >= now - SECONDS_1H:
                        ch += 1
                        if ts >= now - SECONDS_5M:
                            c5 += 1
                            if ts >= now - SECONDS_1M:
                                c1 += 1
                out[F.TX_COUNT_1M] = c1
                out[F.TX_COUNT_5M] = c5
                out[F.TX_COUNT_1H] = ch
                sum_1h = st.sum_1h if now <= st.sum_expires_at else 0
                out[F.TX_SUM_1H] = sum_1h
                out[F.TX_AVG_1H] = sum_1h / ch if ch > 0 else 0.0
                if now <= st.hll_expires_at:
                    out[F.UNIQUE_DEVICES_24H] = st.devices.count()
                    out[F.UNIQUE_IPS_24H] = st.ips.count()
                if st.last_tx_ts > 0:
                    out[F.TIME_SINCE_LAST_TX] = now - st.last_tx_ts
                if st.session_start > 0 and now <= st.session_expires_at:
                    out[F.SESSION_DURATION] = now - st.session_start

                out[F.ACCOUNT_AGE_DAYS] = (now - st.created_at) / 86400.0
                out[F.TOTAL_DEPOSITS] = st.total_deposits
                out[F.TOTAL_WITHDRAWALS] = st.total_withdrawals
                out[F.NET_DEPOSIT] = st.total_deposits - st.total_withdrawals
                out[F.DEPOSIT_COUNT] = st.deposit_count
                out[F.WITHDRAW_COUNT] = st.withdraw_count
                out[F.AVG_BET_SIZE] = st.total_bets / st.bet_count if st.bet_count else 0.0
                out[F.WIN_RATE] = st.win_count / st.bet_count if st.bet_count else 0.0
                out[F.BONUS_CLAIM_COUNT] = st.bonus_claim_count
                out[F.BONUS_WAGER_RATE] = st.bonus_wager_complete
                # Bonus-only player heuristic (engine.go:383-386).
                if st.bonus_claim_count > 3 and st.total_deposits < 5000:
                    out[F.BONUS_ONLY_PLAYER] = 1.0

        out[F.TX_AMOUNT] = amount
        out[F.TX_TYPE_DEPOSIT] = 1.0 if tx_type == "deposit" else 0.0
        out[F.TX_TYPE_WITHDRAW] = 1.0 if tx_type == "withdraw" else 0.0
        out[F.TX_TYPE_BET] = 1.0 if tx_type == "bet" else 0.0

    def gather_batch(self, requests, now: float | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Resolve requests -> ([N, 30] float32, [N] bool blacklisted).

        ``requests`` yields objects with account_id, amount, tx_type,
        device_id, fingerprint, ip attributes.
        """
        now = now or self._clock()
        reqs = list(requests)
        x = np.zeros((len(reqs), NUM_FEATURES), dtype=np.float32)
        bl = np.zeros((len(reqs),), dtype=bool)
        for i, r in enumerate(reqs):
            self.fill_row(x[i], r.account_id, r.amount, r.tx_type, now)
            ip_flags = getattr(r, "ip_flags", None)
            if ip_flags is not None:
                x[i, F.IS_VPN] = float(ip_flags[0])
                x[i, F.IS_PROXY] = float(ip_flags[1])
                x[i, F.IS_TOR] = float(ip_flags[2])
            bl[i] = self.check_blacklist(
                getattr(r, "device_id", ""), getattr(r, "fingerprint", ""), getattr(r, "ip", "")
            )
        return x, bl

    # -- maintenance ---------------------------------------------------------

    def delete_account(self, account_id: str) -> None:
        with self._lock:
            self._accounts.pop(account_id, None)

    def num_accounts(self) -> int:
        with self._lock:
            return len(self._accounts)
