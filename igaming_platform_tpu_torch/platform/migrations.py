"""Versioned schema migrations for the Postgres store of record.

The reference manages its schema with golang-migrate (Makefile targets
`migrate-up` / `migrate-down` / `migrate-create`, Makefile:144-161) over
the baseline DDL of deploy/init-db.sql. This module is the same
capability in-tree: an append-only migration history, a
``schema_migrations`` ledger, and up / down / status commands over
``DATABASE_URL`` — no external tool in the image, and the store's boot
path applies pending migrations itself so a fresh database and a
migrated one are byte-identical.

Each migration runs inside its own transaction together with its ledger
row: a failure mid-DDL rolls back both, so the ledger never lies about
what is applied.

The SQLite development store keeps its own dialect schema
(repository.py); migrations target the production Postgres backend only,
exactly as the reference's golang-migrate setup does. The runner takes
any connection with ``execute``, ``_simple``, ``begin``, ``commit`` and
``rollback``; the command line connects through the port's wire client
(``platform/pgwire.py``).
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Migration:
    version: int
    name: str
    up: str
    down: str
    # plpgsql bodies contain ';' — such statements must go through the
    # simple-query protocol in one batch instead of being split.
    up_simple: str = field(default="")


_V1_CORE = """
CREATE TABLE IF NOT EXISTS accounts (
    id TEXT PRIMARY KEY,
    player_id TEXT UNIQUE NOT NULL,
    currency TEXT NOT NULL DEFAULT 'USD',
    balance BIGINT NOT NULL DEFAULT 0 CHECK (balance >= 0),
    bonus BIGINT NOT NULL DEFAULT 0 CHECK (bonus >= 0),
    status TEXT NOT NULL DEFAULT 'active',
    version BIGINT NOT NULL DEFAULT 1,
    created_at DOUBLE PRECISION NOT NULL,
    updated_at DOUBLE PRECISION NOT NULL
);
CREATE TABLE IF NOT EXISTS transactions (
    id TEXT PRIMARY KEY,
    account_id TEXT NOT NULL REFERENCES accounts(id),
    idempotency_key TEXT,
    type TEXT NOT NULL,
    amount BIGINT NOT NULL CHECK (amount > 0),
    balance_before BIGINT NOT NULL,
    balance_after BIGINT NOT NULL,
    status TEXT NOT NULL DEFAULT 'pending',
    reference TEXT NOT NULL DEFAULT '',
    game_id TEXT,
    round_id TEXT,
    risk_score BIGINT,
    created_at DOUBLE PRECISION NOT NULL,
    completed_at DOUBLE PRECISION,
    seq BIGSERIAL
);
CREATE UNIQUE INDEX IF NOT EXISTS idx_tx_idem
    ON transactions(account_id, idempotency_key)
    WHERE status != 'failed' AND idempotency_key IS NOT NULL;
CREATE INDEX IF NOT EXISTS idx_tx_account ON transactions(account_id, created_at DESC);
CREATE TABLE IF NOT EXISTS ledger_entries (
    id TEXT PRIMARY KEY,
    transaction_id TEXT NOT NULL REFERENCES transactions(id),
    account_id TEXT NOT NULL REFERENCES accounts(id),
    entry_type TEXT NOT NULL CHECK (entry_type IN ('debit','credit')),
    amount BIGINT NOT NULL CHECK (amount > 0),
    balance_after BIGINT NOT NULL,
    description TEXT NOT NULL DEFAULT '',
    created_at DOUBLE PRECISION NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_ledger_account ON ledger_entries(account_id)
"""

_V1_DOWN = """
DROP INDEX IF EXISTS idx_ledger_account;
DROP TABLE IF EXISTS ledger_entries;
DROP INDEX IF EXISTS idx_tx_account;
DROP INDEX IF EXISTS idx_tx_idem;
DROP TABLE IF EXISTS transactions;
DROP TABLE IF EXISTS accounts
"""

_V2_OUTBOX = """
CREATE TABLE IF NOT EXISTS event_outbox (
    id BIGSERIAL PRIMARY KEY,
    exchange TEXT NOT NULL,
    routing_key TEXT NOT NULL,
    payload TEXT NOT NULL,
    published INTEGER NOT NULL DEFAULT 0,
    created_at DOUBLE PRECISION NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_outbox_unpublished ON event_outbox(published) WHERE published = 0
"""

_V3_AUDIT = """
CREATE TABLE IF NOT EXISTS audit_log (
    id BIGSERIAL PRIMARY KEY,
    entity TEXT NOT NULL,
    entity_id TEXT NOT NULL,
    action TEXT NOT NULL,
    old_value TEXT,
    new_value TEXT,
    created_at DOUBLE PRECISION NOT NULL
)
"""

_V4_DEDUPE = """
CREATE TABLE IF NOT EXISTS processed_deliveries (
    event_id TEXT PRIMARY KEY,
    created_at DOUBLE PRECISION NOT NULL
)
"""

# DB-trigger backstop: a concurrent update that slips past the optimistic
# WHERE version=$n (e.g. a buggy write path setting version directly) is
# rejected by the database itself — init-db.sql:224-236.
_V5_TRIGGER = """
CREATE OR REPLACE FUNCTION accounts_version_backstop() RETURNS trigger AS $$
BEGIN
    IF NEW.version IS DISTINCT FROM OLD.version
       AND NEW.version IS DISTINCT FROM OLD.version + 1 THEN
        RAISE EXCEPTION 'version must increment by exactly 1 (got % -> %)',
            OLD.version, NEW.version USING ERRCODE = '40001';
    END IF;
    RETURN NEW;
END $$ LANGUAGE plpgsql;
DROP TRIGGER IF EXISTS trg_accounts_version ON accounts;
CREATE TRIGGER trg_accounts_version BEFORE UPDATE ON accounts
    FOR EACH ROW EXECUTE FUNCTION accounts_version_backstop();
"""

_V5_TRIGGER_DOWN = """
DROP TRIGGER IF EXISTS trg_accounts_version ON accounts;
DROP FUNCTION IF EXISTS accounts_version_backstop
"""

MIGRATIONS: tuple[Migration, ...] = (
    Migration(1, "core_money_tables", _V1_CORE, _V1_DOWN),
    Migration(2, "event_outbox", _V2_OUTBOX,
              "DROP INDEX IF EXISTS idx_outbox_unpublished;"
              "DROP TABLE IF EXISTS event_outbox"),
    Migration(3, "audit_log", _V3_AUDIT, "DROP TABLE IF EXISTS audit_log"),
    Migration(4, "delivery_dedupe", _V4_DEDUPE,
              "DROP TABLE IF EXISTS processed_deliveries"),
    Migration(5, "version_backstop_trigger", "", _V5_TRIGGER_DOWN,
              up_simple=_V5_TRIGGER),
)

_LEDGER_DDL = """
CREATE TABLE IF NOT EXISTS schema_migrations (
    version BIGINT PRIMARY KEY,
    name TEXT NOT NULL,
    applied_at DOUBLE PRECISION NOT NULL
)
"""


def _statements(block: str):
    return [s for s in block.split(";") if s.strip()]


# Session-level advisory lock serializing concurrent migration runs (two
# services booting against the same fresh DATABASE_URL would otherwise
# both apply v1 and collide on the ledger insert) — the same guard
# golang-migrate takes. Arbitrary constant, shared by every runner.
_ADVISORY_LOCK_KEY = 745_001_337


class MigrationRunner:
    """Drives MIGRATIONS against a PgConnection-shaped executor
    (``execute(sql, params)``, ``_simple(sql)``, ``begin/commit/rollback``)."""

    def __init__(self, conn):
        self._conn = conn
        # Ledger DDL under the same advisory lock as the migrations
        # themselves: CREATE TABLE IF NOT EXISTS races on a fresh
        # database (duplicate-key on pg_type/pg_class) when two services
        # boot concurrently — exactly the scenario the lock exists for.
        with self._locked():
            for stmt in _statements(_LEDGER_DDL):
                conn.execute(stmt)

    @contextlib.contextmanager
    def _locked(self):
        self._conn.execute(f"SELECT pg_advisory_lock({_ADVISORY_LOCK_KEY})")
        try:
            yield
        finally:
            self._conn.execute(
                f"SELECT pg_advisory_unlock({_ADVISORY_LOCK_KEY})")

    def applied(self) -> list[int]:
        cur = self._conn.execute(
            "SELECT version FROM schema_migrations ORDER BY version")
        return [int(r[0]) for r in cur.fetchall()]

    def status(self) -> list[tuple[int, str, bool]]:
        done = set(self.applied())
        return [(m.version, m.name, m.version in done) for m in MIGRATIONS]

    def up(self, target: int | None = None) -> list[int]:
        """Apply pending migrations in order, up to and including
        ``target`` (default: all). Returns versions applied."""
        if target is not None and target not in {m.version for m in MIGRATIONS}:
            raise ValueError(f"unknown migration version {target}")
        ran: list[int] = []
        with self._locked():
            # Read the ledger only once the lock is held: a concurrent
            # winner's rows must be visible to the loser.
            done = set(self.applied())
            for m in MIGRATIONS:
                if target is not None and m.version > target:
                    break
                if m.version in done:
                    continue
                self._conn.begin()
                try:
                    for stmt in _statements(m.up):
                        self._conn.execute(stmt)
                    if m.up_simple:
                        self._conn._simple(m.up_simple)
                    self._conn.execute(
                        "INSERT INTO schema_migrations (version, name, applied_at)"
                        " VALUES (?, ?, ?)", (m.version, m.name, time.time()))
                    self._conn.commit()
                except BaseException:
                    self._conn.rollback()
                    raise
                ran.append(m.version)
        return ran

    def down(self, target: int) -> list[int]:
        """Revert applied migrations above ``target`` in reverse order
        (``target=0`` reverts everything). Returns versions reverted."""
        if target != 0 and target not in {m.version for m in MIGRATIONS}:
            raise ValueError(f"unknown migration version {target}")
        ran: list[int] = []
        with self._locked():
            done = set(self.applied())
            for m in reversed(MIGRATIONS):
                if m.version <= target or m.version not in done:
                    continue
                self._conn.begin()
                try:
                    for stmt in _statements(m.down):
                        self._conn.execute(stmt)
                    self._conn.execute(
                        "DELETE FROM schema_migrations WHERE version = ?",
                        (m.version,))
                    self._conn.commit()
                except BaseException:
                    self._conn.rollback()
                    raise
                ran.append(m.version)
        return ran


def migrate_up(conn, target: int | None = None) -> list[int]:
    return MigrationRunner(conn).up(target)


def _connect(url: str):
    """The command line's Postgres connection, not yet connected."""
    from igaming_platform_tpu_torch.platform.pgwire import PgConnection

    return PgConnection(url)


def main(argv: list[str]) -> int:
    if len(argv) < 2 or argv[1] not in {"up", "down", "status"}:
        print("usage: python -m igaming_platform_tpu_torch.platform.migrations "
              "<postgres-url> up [target] | down <target> | status",
              file=sys.stderr)
        return 2
    conn = _connect(argv[0])
    conn.connect()
    try:
        runner = MigrationRunner(conn)
        if argv[1] == "status":
            for version, name, is_applied in runner.status():
                print(f"{version:4d}  {'applied' if is_applied else 'pending':8s}  {name}")
        elif argv[1] == "up":
            ran = runner.up(int(argv[2]) if len(argv) > 2 else None)
            print(f"applied: {ran or 'nothing (up to date)'}")
        else:
            if len(argv) < 3:
                print("down requires a target version (0 = revert all)",
                      file=sys.stderr)
                return 2
            ran = runner.down(int(argv[2]))
            print(f"reverted: {ran or 'nothing'}")
    finally:
        conn.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
