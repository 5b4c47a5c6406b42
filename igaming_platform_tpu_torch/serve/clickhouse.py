"""ClickHouse batch-feature source — the hourly analytical scan.

The reference computes per-account batch features hourly in ClickHouse
(schema: services/risk/internal/scoring/engine.go:127-140;
ticker: services/risk/cmd/main.go:226-236, body commented
out; deployed at deploy/docker-compose.yml:60-74). This
module is the real implementation: a ClickHouse client over the HTTP
interface (port 8123 — the port carries no native-protocol driver, and
HTTP is the interface ClickHouse itself recommends for exactly this kind
of batch pull), plus a source callable for serve/batch_refresh.py's
refresh job. The wallet-store scan stays the default source; ClickHouse
slots in behind the same seam via CLICKHOUSE_URL=http://...

This is the port's copy of ``igaming_platform_tpu/serve/clickhouse.py``;
the decision ledger's ClickHouse sink (``serve/ledger.py``) posts through
the same client. Fake-backed tests (tests/test_torch_stores.py) hold the
request formatting and response parsing to the JAX module's against an
in-process HTTP server.
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.parse
import urllib.request

from igaming_platform_tpu_torch.serve.batch_refresh import BatchFeatures

logger = logging.getLogger(__name__)


class ClickHouseError(RuntimeError):
    pass


class ClickHouseClient:
    """Minimal HTTP-interface client: POST the query, parse JSONEachRow."""

    def __init__(
        self,
        url: str = "http://localhost:8123",
        *,
        database: str = "default",
        user: str = "default",
        password: str = "",
        timeout_s: float = 30.0,
    ):
        self.base_url = url.rstrip("/")
        self.database = database
        self.user = user
        self.password = password
        self.timeout_s = timeout_s

    def query(self, sql: str) -> list[dict]:
        """Run a SELECT; returns one dict per row (JSONEachRow)."""
        params = urllib.parse.urlencode({
            "database": self.database,
            "default_format": "JSONEachRow",
        })
        req = urllib.request.Request(
            f"{self.base_url}/?{params}",
            data=sql.encode(),
            method="POST",
            headers={
                "X-ClickHouse-User": self.user,
                "X-ClickHouse-Key": self.password,
                "Content-Type": "text/plain; charset=utf-8",
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                body = resp.read()
        except urllib.error.HTTPError as exc:
            detail = exc.read().decode(errors="replace")[:500]
            raise ClickHouseError(f"HTTP {exc.code}: {detail}") from exc
        except (urllib.error.URLError, OSError) as exc:
            raise ClickHouseError(f"clickhouse unreachable: {exc}") from exc
        return [json.loads(line) for line in body.splitlines() if line.strip()]

    def ping(self) -> bool:
        try:
            return self.query("SELECT 1 AS ok")[0]["ok"] == 1
        except (ClickHouseError, KeyError, IndexError):
            return False


# The aggregate the reference's hourly job materializes (engine.go:127-140
# field for field), computed from a ClickHouse events table with columns
# (account_id String, type String, amount Int64, ts DateTime/Float64).
BATCH_FEATURES_SQL = """
SELECT
    account_id,
    sumIf(amount, type = 'deposit')   AS total_deposits,
    sumIf(amount, type = 'withdraw')  AS total_withdrawals,
    countIf(type = 'deposit')         AS deposit_count,
    countIf(type = 'withdraw')        AS withdraw_count,
    sumIf(amount, type = 'bet')       AS total_bets,
    sumIf(amount, type = 'win')       AS total_wins,
    countIf(type = 'bet')             AS bet_count,
    countIf(type = 'win')             AS win_count,
    min(ts)                           AS account_created_at,
    countIf(type = 'bonus_grant')     AS bonus_claim_count
FROM {table}
GROUP BY account_id
"""


def clickhouse_source(client: "ClickHouseClient | str", table: str = "events"):
    """Batch-feature source for BatchFeatureRefreshJob backed by ClickHouse.

    ``client`` is a ClickHouseClient or an http:// URL. The returned
    callable yields {account_id: BatchFeatures}; a scan failure raises
    ClickHouseError — the refresh job logs and retries next tick, keeping
    the previous aggregates serving (stale beats absent)."""
    if isinstance(client, str):
        client = ClickHouseClient(client)

    def scan() -> dict[str, BatchFeatures]:
        rows = client.query(BATCH_FEATURES_SQL.format(table=table))
        out: dict[str, BatchFeatures] = {}
        for r in rows:
            out[str(r["account_id"])] = BatchFeatures(
                total_deposits=int(r.get("total_deposits", 0)),
                total_withdrawals=int(r.get("total_withdrawals", 0)),
                deposit_count=int(r.get("deposit_count", 0)),
                withdraw_count=int(r.get("withdraw_count", 0)),
                total_bets=int(r.get("total_bets", 0)),
                total_wins=int(r.get("total_wins", 0)),
                bet_count=int(r.get("bet_count", 0)),
                win_count=int(r.get("win_count", 0)),
                created_at=float(r.get("account_created_at", 0.0) or 0.0),
                bonus_claim_count=int(r["bonus_claim_count"])
                if "bonus_claim_count" in r else None,
            )
        return out

    return scan
