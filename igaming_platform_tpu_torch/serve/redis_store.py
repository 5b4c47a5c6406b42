"""Redis-backed feature store adapter (deployment-gated).

Deployments that already run Redis can keep features there — this adapter
speaks the exact key schema of the reference
(services/risk/internal/features/redis_store.go:25-35):
sorted-set tx history with ZCOUNT sliding windows, INCRBY'd 1h sums with
TTL, PFADD/PFCOUNT HyperLogLogs for devices/IPs, last-tx/session keys with
SETNX + sliding TTL, and blacklist sets — so it is interoperable with data
written by the reference's Go service.

The redis client library is an optional dependency; the class raises at
construction when unavailable (`redis_available()` to probe). The default
stores remain serve.feature_store (Python) and serve.native_store (C++).
This is the port's copy of ``igaming_platform_tpu/serve/redis_store.py``;
``serve/server.make_feature_store("redis")`` builds it from ``REDIS_URL``.
"""

from __future__ import annotations

import time

from igaming_platform_tpu_torch.core.features import F, NUM_FEATURES


def redis_available() -> bool:
    try:
        import redis  # noqa: F401

        return True
    except ImportError:
        return False


class RedisFeatureStore:
    """Same interface as InMemoryFeatureStore, state in Redis."""

    def __init__(self, url: str = "redis://localhost:6379", client=None):
        if client is not None:
            self._r = client  # injected (tests use a fake; any redis-like API)
            return
        if not redis_available():
            raise RuntimeError("redis client library not installed")
        import redis

        self._r = redis.Redis.from_url(url, decode_responses=True)

    # Key patterns (redis_store.go:25-35).
    @staticmethod
    def _k(account_id: str, suffix: str) -> str:
        return f"features:{account_id}:{suffix}"

    def update(self, event) -> None:
        now = int(event.timestamp or time.time())
        acct = event.account_id
        pipe = self._r.pipeline()
        hist = self._k(acct, "tx_history")
        pipe.zadd(hist, {f"{now}:{event.amount}": now})
        pipe.zremrangebyscore(hist, "-inf", now - 3600)
        pipe.expire(hist, 7200)
        sum_key = self._k(acct, "tx_sum:1h")
        pipe.incrby(sum_key, event.amount)
        pipe.expire(sum_key, 3600)
        if event.device_id:
            pipe.pfadd(self._k(acct, "devices:24h"), event.device_id)
            pipe.expire(self._k(acct, "devices:24h"), 86400)
        if event.ip:
            pipe.pfadd(self._k(acct, "ips:24h"), event.ip)
            pipe.expire(self._k(acct, "ips:24h"), 86400)
        pipe.set(self._k(acct, "last_tx"), now, ex=7 * 86400)
        pipe.set(self._k(acct, "session_start"), now, nx=True, ex=1800)
        pipe.expire(self._k(acct, "session_start"), 1800)
        pipe.execute()

    def velocity(self, account_id: str, now: float | None = None):
        now = int(now or time.time())
        hist = self._k(account_id, "tx_history")
        pipe = self._r.pipeline()
        pipe.zcount(hist, now - 60, "+inf")
        pipe.zcount(hist, now - 300, "+inf")
        pipe.zcount(hist, now - 3600, "+inf")
        c1, c5, ch = pipe.execute()
        return int(c1), int(c5), int(ch)

    def check_rate_limit(self, account_id: str, max_per_min: int, max_per_hour: int) -> bool:
        c1, _, ch = self.velocity(account_id)
        return c1 >= max_per_min or ch >= max_per_hour

    def add_to_blacklist(self, list_type: str, value: str) -> None:
        keys = {"device": "blacklist:devices", "ip": "blacklist:ips",
                "fingerprint": "blacklist:fingerprints"}
        if list_type not in keys:
            raise ValueError(f"unknown blacklist type: {list_type}")
        self._r.sadd(keys[list_type], value)

    def check_blacklist(self, device_id: str = "", fingerprint: str = "", ip: str = "") -> bool:
        pipe = self._r.pipeline()
        n = 0
        if device_id:
            pipe.sismember("blacklist:devices", device_id)
            n += 1
        if fingerprint:
            pipe.sismember("blacklist:fingerprints", fingerprint)
            n += 1
        if ip:
            pipe.sismember("blacklist:ips", ip)
            n += 1
        return any(pipe.execute()) if n else False

    def load_batch_features(
        self, account_id: str, *,
        total_deposits: int = 0, total_withdrawals: int = 0,
        deposit_count: int = 0, withdraw_count: int = 0,
        total_bets: int = 0, total_wins: int = 0,
        bet_count: int = 0, win_count: int = 0,
        bonus_claim_count: int | None = None,
        created_at: float | None = None,
    ) -> None:
        """Batch aggregates in a hash (the ClickHouse-refresh sink,
        serve/batch_refresh.py), read back by fill_row."""
        mapping = {
            "total_deposits": total_deposits, "total_withdrawals": total_withdrawals,
            "deposit_count": deposit_count, "withdraw_count": withdraw_count,
            "total_bets": total_bets, "total_wins": total_wins,
            "bet_count": bet_count, "win_count": win_count,
        }
        if bonus_claim_count is not None:
            mapping["bonus_claim_count"] = bonus_claim_count
        if created_at is not None:
            mapping["created_at"] = created_at
        self._r.hset(self._k(account_id, "batch"), mapping=mapping)

    def fill_row(self, out, account_id: str, amount: int, tx_type: str, now=None) -> None:
        now = int(now or time.time())
        pipe = self._r.pipeline()
        hist = self._k(account_id, "tx_history")
        pipe.zcount(hist, now - 60, "+inf")
        pipe.zcount(hist, now - 300, "+inf")
        pipe.zcount(hist, now - 3600, "+inf")
        pipe.get(self._k(account_id, "tx_sum:1h"))
        pipe.pfcount(self._k(account_id, "devices:24h"))
        pipe.pfcount(self._k(account_id, "ips:24h"))
        pipe.get(self._k(account_id, "last_tx"))
        pipe.get(self._k(account_id, "session_start"))
        pipe.hgetall(self._k(account_id, "batch"))
        c1, c5, ch, total, dev, ips, last_tx, session, batch = pipe.execute()
        batch = {k: float(v) for k, v in (batch or {}).items()}
        td, tw = batch.get("total_deposits", 0.0), batch.get("total_withdrawals", 0.0)
        out[F.TOTAL_DEPOSITS] = td
        out[F.TOTAL_WITHDRAWALS] = tw
        out[F.NET_DEPOSIT] = td - tw
        out[F.DEPOSIT_COUNT] = batch.get("deposit_count", 0.0)
        out[F.WITHDRAW_COUNT] = batch.get("withdraw_count", 0.0)
        bet_count = batch.get("bet_count", 0.0)
        if bet_count:
            out[F.AVG_BET_SIZE] = batch.get("total_bets", 0.0) / bet_count
            out[F.WIN_RATE] = batch.get("win_count", 0.0) / bet_count
        out[F.BONUS_CLAIM_COUNT] = batch.get("bonus_claim_count", 0.0)
        created = batch.get("created_at", 0.0)
        if created:
            out[F.ACCOUNT_AGE_DAYS] = max(0.0, (now - created) / 86400.0)
        out[F.TX_COUNT_1M] = int(c1)
        out[F.TX_COUNT_5M] = int(c5)
        out[F.TX_COUNT_1H] = int(ch)
        out[F.TX_SUM_1H] = int(total or 0)
        out[F.TX_AVG_1H] = int(total or 0) / int(ch) if int(ch) else 0.0
        out[F.UNIQUE_DEVICES_24H] = int(dev)
        out[F.UNIQUE_IPS_24H] = int(ips)
        if last_tx:
            out[F.TIME_SINCE_LAST_TX] = now - int(last_tx)
        if session:
            out[F.SESSION_DURATION] = now - int(session)
        out[F.TX_AMOUNT] = amount
        out[F.TX_TYPE_DEPOSIT] = 1.0 if tx_type == "deposit" else 0.0
        out[F.TX_TYPE_WITHDRAW] = 1.0 if tx_type == "withdraw" else 0.0
        out[F.TX_TYPE_BET] = 1.0 if tx_type == "bet" else 0.0

    def gather_batch(self, requests, now=None):
        import numpy as np

        reqs = list(requests)
        x = np.zeros((len(reqs), NUM_FEATURES), dtype=np.float32)
        bl = np.zeros((len(reqs),), dtype=bool)
        for i, r in enumerate(reqs):
            self.fill_row(x[i], r.account_id, r.amount, r.tx_type, now)
            bl[i] = self.check_blacklist(
                getattr(r, "device_id", ""), getattr(r, "fingerprint", ""), getattr(r, "ip", "")
            )
        return x, bl
