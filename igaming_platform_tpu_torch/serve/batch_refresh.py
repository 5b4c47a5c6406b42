"""Periodic batch-feature refresh — the hourly analytical-store scan.

The reference's risk entrypoint declares an hourly ticker that refreshes
per-account batch features from ClickHouse (risk/cmd/main.go:226-236) but
its body is commented out; the scorer would serve stale or empty batch
aggregates after any restart. Here the ticker is real:

- the **source** is any callable returning ``{account_id: BatchFeatures}``
  — `wallet_store_source` scans the wallet's transaction table (the
  in-repo analytical system of record; an external ClickHouse scan slots
  in behind the same callable);
- the **sink** is any feature store exposing ``load_batch_features``
  (the in-memory store; the Redis adapter delegates to it).

Realtime windows (velocity, HLL cardinalities, sessions) stay stream-fed
via the event bridge — the refresh only overwrites the slow aggregates,
exactly the realtime/batch split of engine.go:127-140.

This is the port's copy of ``igaming_platform_tpu/serve/batch_refresh.py``;
the port's risk server (``serve/server.py``) runs it under
``BATCH_FEATURE_DB`` or ``CLICKHOUSE_URL=http…``.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class BatchFeatures:
    """Per-account analytical aggregates (the ClickHouse row analog)."""

    total_deposits: int = 0
    total_withdrawals: int = 0
    deposit_count: int = 0
    withdraw_count: int = 0
    total_bets: int = 0
    total_wins: int = 0
    bet_count: int = 0
    win_count: int = 0
    created_at: float = 0.0
    # None = source has no bonus view; the store keeps its stream-fed
    # value (engine.go:137 carries this from ClickHouse when present).
    bonus_claim_count: int | None = None


def wallet_store_source(db_path: str):
    """Source scanning a wallet store's completed transactions — SQLite
    path/URL or ``postgres://`` (platform.repository.open_wallet_reader).

    Opens a fresh read-only connection per scan so the refresh never
    contends with the wallet's write path.
    """

    def scan() -> dict[str, BatchFeatures]:
        from igaming_platform_tpu_torch.platform.repository import open_wallet_reader

        query, close = open_wallet_reader(db_path)
        try:
            created = dict(query("SELECT id, created_at FROM accounts"))
            rows = query(
                "SELECT account_id, type, COALESCE(SUM(amount),0), COUNT(*)"
                " FROM transactions WHERE status='completed' GROUP BY account_id, type"
            )
        finally:
            close()
        agg: dict[str, dict] = {}
        for account_id, tx_type, total, count in rows:
            d = agg.setdefault(account_id, {})
            if tx_type == "deposit":
                d["total_deposits"], d["deposit_count"] = total, count
            elif tx_type == "withdraw":
                d["total_withdrawals"], d["withdraw_count"] = total, count
            elif tx_type == "bet":
                d["total_bets"], d["bet_count"] = total, count
            elif tx_type == "win":
                d["total_wins"], d["win_count"] = total, count
        return {
            account_id: BatchFeatures(created_at=created.get(account_id, 0.0), **d)
            for account_id, d in agg.items()
        }

    return scan


class BatchFeatureRefreshJob:
    """Hourly-by-default ticker: scan the source, bulk-load the store."""

    def __init__(self, feature_store, source, interval_s: float = 3600.0):
        self.feature_store = feature_store
        self.source = source
        self.interval_s = interval_s
        self.last_refresh_count = 0
        self.last_refresh_at = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def refresh_once(self) -> int:
        rows = self.source()
        for account_id, bf in rows.items():
            self.feature_store.load_batch_features(
                account_id,
                total_deposits=bf.total_deposits,
                total_withdrawals=bf.total_withdrawals,
                deposit_count=bf.deposit_count,
                withdraw_count=bf.withdraw_count,
                total_bets=bf.total_bets,
                total_wins=bf.total_wins,
                bet_count=bf.bet_count,
                win_count=bf.win_count,
                bonus_claim_count=bf.bonus_claim_count,
                created_at=bf.created_at or None,
            )
        self.last_refresh_count = len(rows)
        self.last_refresh_at = time.time()
        return len(rows)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, name="batch-feature-refresh", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.refresh_once()
            except Exception:  # noqa: BLE001 — refresh must not die
                logger.warning("batch feature refresh failed", exc_info=True)
            # Until the FIRST successful scan, retry fast: an external
            # source (ClickHouse) that wasn't up when this service booted
            # must not leave the scorer on empty batch aggregates for a
            # whole interval (compose gives no cross-profile ordering).
            wait = (
                self.interval_s
                if self.last_refresh_at > 0
                else min(15.0, self.interval_s)
            )
            self._stop.wait(wait)  # noqa: CC05 — refresh ticker cadence (interval_s), not a retry backoff
