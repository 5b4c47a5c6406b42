"""Repositories: accounts / transactions / ledger, in-memory and SQLite.

Reproduces the data-access semantics of
services/wallet/internal/repository/postgres.go and the
schema constraints of deploy/init-db.sql:

- optimistic locking: UPDATE ... WHERE version = expected, version+1;
  zero rows -> ConcurrentUpdateError (postgres.go:129-148);
- idempotency: UNIQUE(account_id, idempotency_key) (init-db.sql:44),
  lookup by pair (postgres.go:229-240);
- balance CHECK >= 0 (init-db.sql:17-18);
- ledger-derived balance + reconciliation (postgres.go:358-390);
- daily stats aggregation (postgres.go:285-308).

The SQLite backend is the durable single-file deployment; Postgres
(``platform/pg_store.py`` over the wire client ``platform/pgwire.py``) slots
in behind the same interface unchanged. This is the port's copy of
``igaming_platform_tpu/platform/repository.py``; its ``open_wallet_reader``
also gives a SQLite built without the math functions ``floor`` from Python.
"""

from __future__ import annotations

import contextlib
import math
import os
import sqlite3
import threading
import time
from typing import Iterable, Protocol

from igaming_platform_tpu_torch.core.enums import AccountStatus, LedgerEntryType, TxStatus, TxType
from igaming_platform_tpu_torch.platform.domain import (
    Account,
    AccountNotFoundError,
    ConcurrentUpdateError,
    DuplicateTransactionError,
    LedgerEntry,
    Transaction,
)


class AccountRepository(Protocol):
    def create(self, account: Account) -> None: ...
    def get_by_id(self, account_id: str) -> Account: ...
    def get_by_player_id(self, player_id: str) -> Account | None: ...
    def update_balance(self, account_id: str, balance: int, bonus: int, expected_version: int) -> None: ...
    def update_status(self, account_id: str, status: AccountStatus) -> None: ...


class TransactionRepository(Protocol):
    def create(self, tx: Transaction) -> None: ...
    def get_by_id(self, tx_id: str) -> Transaction | None: ...
    def get_by_idempotency_key(self, account_id: str, key: str) -> Transaction | None: ...
    def update(self, tx: Transaction) -> None: ...
    def list_by_account(
        self, account_id: str, limit: int = 50, offset: int = 0,
        *, types: list[str] | None = None, from_ts: float | None = None,
        to_ts: float | None = None, game_id: str | None = None,
    ) -> list[Transaction]: ...
    def count_by_account(
        self, account_id: str,
        *, types: list[str] | None = None, from_ts: float | None = None,
        to_ts: float | None = None, game_id: str | None = None,
    ) -> int: ...


class LedgerRepository(Protocol):
    def create(self, entry: LedgerEntry) -> None: ...
    def get_by_transaction(self, tx_id: str) -> list[LedgerEntry]: ...
    def get_account_balance(self, account_id: str) -> int: ...


# ---------------------------------------------------------------------------
# In-memory implementation
# ---------------------------------------------------------------------------


class InMemoryAccountRepository:
    def __init__(self):
        self._accounts: dict[str, Account] = {}
        self._by_player: dict[str, str] = {}
        self._lock = threading.RLock()

    def create(self, account: Account) -> None:
        with self._lock:
            self._accounts[account.id] = account
            self._by_player[account.player_id] = account.id

    def get_by_id(self, account_id: str) -> Account:
        with self._lock:
            acct = self._accounts.get(account_id)
            if acct is None:
                raise AccountNotFoundError(account_id)
            return Account(**vars(acct))

    def get_by_player_id(self, player_id: str) -> Account | None:
        with self._lock:
            aid = self._by_player.get(player_id)
            return self.get_by_id(aid) if aid else None

    def update_balance(self, account_id: str, balance: int, bonus: int, expected_version: int) -> None:
        if balance < 0 or bonus < 0:
            raise ValueError(f"balance CHECK violated: balance={balance} bonus={bonus}")
        with self._lock:
            acct = self._accounts.get(account_id)
            if acct is None:
                raise AccountNotFoundError(account_id)
            if acct.version != expected_version:
                # Optimistic-lock miss (postgres.go:144-147 + DB trigger).
                raise ConcurrentUpdateError(f"{account_id}: version {acct.version} != {expected_version}")
            acct.balance = balance
            acct.bonus = bonus
            acct.version += 1
            acct.updated_at = time.time()

    def update_status(self, account_id: str, status: AccountStatus) -> None:
        with self._lock:
            acct = self._accounts.get(account_id)
            if acct is None:
                raise AccountNotFoundError(account_id)
            acct.status = status
            acct.updated_at = time.time()

    def list_ids(self) -> list[str]:
        with self._lock:
            return list(self._accounts.keys())


class InMemoryTransactionRepository:
    def __init__(self):
        self._by_id: dict[str, Transaction] = {}
        self._by_idem: dict[tuple[str, str], str] = {}
        self._by_account: dict[str, list[str]] = {}
        self._lock = threading.RLock()

    def create(self, tx: Transaction) -> None:
        with self._lock:
            key = (tx.account_id, tx.idempotency_key)
            if tx.idempotency_key and key in self._by_idem:
                existing = self._by_id[self._by_idem[key]]
                if existing.status != TxStatus.FAILED:
                    raise DuplicateTransactionError(tx.idempotency_key)
                # Failed attempt: the key is re-usable; the failed row stays
                # reachable by id for audit.
            self._by_id[tx.id] = tx
            if tx.idempotency_key:
                self._by_idem[key] = tx.id
            self._by_account.setdefault(tx.account_id, []).append(tx.id)

    def get_by_id(self, tx_id: str) -> Transaction | None:
        with self._lock:
            return self._by_id.get(tx_id)

    def get_by_idempotency_key(self, account_id: str, key: str) -> Transaction | None:
        with self._lock:
            tid = self._by_idem.get((account_id, key))
            return self._by_id.get(tid) if tid else None

    def update(self, tx: Transaction) -> None:
        with self._lock:
            self._by_id[tx.id] = tx

    @staticmethod
    def _matches(tx: Transaction, types, from_ts, to_ts, game_id) -> bool:
        if types and tx.type.value not in types:
            return False
        if from_ts is not None and tx.created_at < from_ts:
            return False
        if to_ts is not None and tx.created_at >= to_ts:
            return False
        if game_id and tx.game_id != game_id:
            return False
        return True

    def list_by_account(
        self, account_id: str, limit: int = 50, offset: int = 0,
        *, types: list[str] | None = None, from_ts: float | None = None,
        to_ts: float | None = None, game_id: str | None = None,
    ) -> list[Transaction]:
        """History page, newest first; filters apply before pagination
        (wallet.proto:172-186: types / from / to / game_id)."""
        with self._lock:
            ids = self._by_account.get(account_id, [])
            newest_first = [
                self._by_id[t] for t in reversed(ids)
                if self._matches(self._by_id[t], types, from_ts, to_ts, game_id)
            ]
            return newest_first[offset : offset + limit]

    def count_by_account(
        self, account_id: str,
        *, types: list[str] | None = None, from_ts: float | None = None,
        to_ts: float | None = None, game_id: str | None = None,
    ) -> int:
        with self._lock:
            ids = self._by_account.get(account_id, [])
            return sum(
                1 for t in ids
                if self._matches(self._by_id[t], types, from_ts, to_ts, game_id)
            )


class InMemoryLedgerRepository:
    def __init__(self):
        self._entries: list[LedgerEntry] = []
        self._lock = threading.RLock()

    def create(self, entry: LedgerEntry) -> None:
        with self._lock:
            self._entries.append(entry)

    def get_by_transaction(self, tx_id: str) -> list[LedgerEntry]:
        with self._lock:
            return [e for e in self._entries if e.transaction_id == tx_id]

    def get_account_balance(self, account_id: str) -> int:
        """Ledger-derived balance: credits - debits (postgres.go:358-369)."""
        with self._lock:
            total = 0
            for e in self._entries:
                if e.account_id != account_id:
                    continue
                total += e.amount if e.entry_type == LedgerEntryType.CREDIT else -e.amount
            return total

    def verify_balance(self, account_id: str, recorded_balance: int) -> bool:
        """Reconciliation check (postgres.go:371-390)."""
        return self.get_account_balance(account_id) == recorded_balance


class DedupeStoreMixin:
    """release/purge halves of the durable-dedupe contract — identical SQL
    on every backend; only the claim INSERT is dialect-specific."""

    def dedupe_release(self, event_id: str) -> None:
        """Undo a claim whose handler failed (the retry must not be
        misread as a duplicate)."""
        with self._lock:
            self._conn.execute(
                "DELETE FROM processed_deliveries WHERE event_id = ?", (event_id,)
            )
            self._commit()

    def dedupe_purge(self, older_than_s: float = 7 * 86400.0) -> int:
        """Drop claims past the redelivery horizon (bounded table)."""
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM processed_deliveries WHERE created_at < ?",
                (time.time() - older_than_s,),
            )
            self._commit()
            return cur.rowcount


def store_of(repo):
    """The transactional store backing a repository view, or None.

    SQLite repository views carry their store as ``_s``; in-memory repos
    have no shared store. Callers use this (and :func:`uow_of`) instead of
    probing private attributes at each site, so the contract lives in one
    place next to the classes that define it.
    """
    return getattr(repo, "_s", None)


def uow_of(repo):
    """The unit-of-work factory of the store backing ``repo``, or None
    when the backend cannot run multi-call transactions."""
    return getattr(store_of(repo), "unit_of_work", None)


def ensure_sqlite_floor(conn: sqlite3.Connection) -> None:
    """SQLite's ``floor`` (NULL stays NULL, an integer itself, a real rounds
    down to a real) from Python, on a library built without its math
    functions: the LTV job's day buckets need it."""
    try:
        conn.execute("SELECT floor(1.5)")
    except sqlite3.OperationalError:
        conn.create_function(
            "floor", 1,
            lambda v: v if v is None or isinstance(v, int) else float(math.floor(v)),
            deterministic=True)


def open_wallet_reader(db: str):
    """(query(sql) -> rows, close) over either wallet backend for
    READ-ONLY scan jobs (LTV batch, batch-feature refresh): a SQLite
    path / ``sqlite://`` URL opens with mode=ro, ``postgres://`` goes
    through the wire client with the session forced read-only — a scan
    job must be incapable of writing to the store of record. Same
    dispatch rule as ``store_from_url``."""
    if db.startswith(("postgres://", "postgresql://")):
        from igaming_platform_tpu_torch.platform.pgwire import PgConnection

        conn = PgConnection(db)
        conn.connect()
        try:
            conn.execute("SET default_transaction_read_only = on")
        except BaseException:
            # A pooler/proxy that rejects session SET must not leak the
            # connection: the caller never gets the close handle.
            conn.close()
            raise
        return (lambda sql: conn.execute(sql).fetchall()), conn.close
    path = db.removeprefix("sqlite://")
    ro = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    ensure_sqlite_floor(ro)
    return (lambda sql: ro.execute(sql).fetchall()), ro.close


def store_from_url(url: str):
    """DATABASE_URL -> store instance, or None for the in-memory repos
    (empty/unknown scheme). The single dispatch shared by the wallet
    server and `make seed`, so the two entry points cannot drift."""
    if url.startswith(("postgres://", "postgresql://")):
        # Production store of record (postgres.go over the pure-Python
        # wire client; schema migrations applied at boot).
        from igaming_platform_tpu_torch.platform.pg_store import PostgresStore

        return PostgresStore(url)
    if url.startswith("sqlite://") and url != "sqlite://:memory:":
        return SQLiteStore(url.removeprefix("sqlite://"))
    if url == "sqlite://:memory:":
        return SQLiteStore()
    return None


# ---------------------------------------------------------------------------
# SQLite implementation (durable single-file deployment)
# ---------------------------------------------------------------------------

_SCHEMA = """
CREATE TABLE IF NOT EXISTS accounts (
    id TEXT PRIMARY KEY,
    player_id TEXT UNIQUE NOT NULL,
    currency TEXT NOT NULL DEFAULT 'USD',
    balance INTEGER NOT NULL DEFAULT 0 CHECK (balance >= 0),
    bonus INTEGER NOT NULL DEFAULT 0 CHECK (bonus >= 0),
    status TEXT NOT NULL DEFAULT 'active',
    version INTEGER NOT NULL DEFAULT 1,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS transactions (
    id TEXT PRIMARY KEY,
    account_id TEXT NOT NULL REFERENCES accounts(id),
    idempotency_key TEXT,
    type TEXT NOT NULL,
    amount INTEGER NOT NULL CHECK (amount > 0),
    balance_before INTEGER NOT NULL,
    balance_after INTEGER NOT NULL,
    status TEXT NOT NULL DEFAULT 'pending',
    reference TEXT NOT NULL DEFAULT '',
    game_id TEXT,
    round_id TEXT,
    risk_score INTEGER,
    created_at REAL NOT NULL,
    completed_at REAL
);
-- Idempotency: unique per (account, key) among non-failed rows only — a
-- failed attempt releases the key for the retry (partial unique index).
CREATE UNIQUE INDEX IF NOT EXISTS idx_tx_idem
    ON transactions(account_id, idempotency_key)
    WHERE status != 'failed' AND idempotency_key IS NOT NULL;
CREATE INDEX IF NOT EXISTS idx_tx_account ON transactions(account_id, created_at DESC);
CREATE TABLE IF NOT EXISTS ledger_entries (
    id TEXT PRIMARY KEY,
    transaction_id TEXT NOT NULL REFERENCES transactions(id),
    account_id TEXT NOT NULL REFERENCES accounts(id),
    entry_type TEXT NOT NULL CHECK (entry_type IN ('debit','credit')),
    amount INTEGER NOT NULL CHECK (amount > 0),
    balance_after INTEGER NOT NULL,
    description TEXT NOT NULL DEFAULT '',
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_ledger_account ON ledger_entries(account_id);
CREATE TABLE IF NOT EXISTS event_outbox (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    exchange TEXT NOT NULL,
    routing_key TEXT NOT NULL,
    payload TEXT NOT NULL,
    published INTEGER NOT NULL DEFAULT 0,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_outbox_unpublished ON event_outbox(published) WHERE published = 0;
CREATE TABLE IF NOT EXISTS audit_log (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    entity TEXT NOT NULL,
    entity_id TEXT NOT NULL,
    action TEXT NOT NULL,
    old_value TEXT,
    new_value TEXT,
    created_at REAL NOT NULL
);
-- Durable at-least-once dedupe: consumer claims on envelope id survive
-- process restart (the in-memory DeliveryDeduper forgets on crash,
-- exactly when the outbox relay redelivers).
CREATE TABLE IF NOT EXISTS processed_deliveries (
    event_id TEXT PRIMARY KEY,
    created_at REAL NOT NULL
);
"""


class SQLiteStore(DedupeStoreMixin):
    """One connection-per-store with the full schema (init-db.sql analog).

    Exposes the three repository views plus the transactional outbox
    (init-db.sql:177-188) and audit log (:191-204).
    """

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        if path != ":memory:":
            self._conn.execute("PRAGMA journal_mode=WAL")
            # Durable by default: FULL syncs per commit, matching the
            # reference's default-durable Postgres — a gRPC-acknowledged
            # wallet commit survives power loss. Benches/soaks opt into
            # SQLITE_SYNCHRONOUS=NORMAL explicitly (batched fsync at WAL
            # checkpoints — the group-commit analog that lifts the hot
            # path off the per-op fsync floor, at the cost of an OS crash
            # losing the WAL tail; the ledger reconciles what persisted).
            sync = os.environ.get("SQLITE_SYNCHRONOUS", "FULL").upper()
            if sync not in ("OFF", "NORMAL", "FULL", "EXTRA"):
                raise ValueError(f"SQLITE_SYNCHRONOUS={sync!r} not a sqlite mode")
            self._conn.execute(f"PRAGMA synchronous={sync}")
        self._conn.executescript(_SCHEMA)
        self._lock = threading.RLock()
        self._tx_depth = 0
        self.accounts = _SQLiteAccounts(self)
        self.transactions = _SQLiteTransactions(self)
        self.ledger = _SQLiteLedger(self)

    def close(self) -> None:
        self._conn.close()

    def _commit(self) -> None:
        """Commit unless inside a unit of work (then the UoW commits).

        A COMMIT that raises must roll its pending writes back — on this
        shared connection they would otherwise ride along with the next
        unrelated commit, materializing a write whose caller was told
        failed.
        """
        if self._tx_depth == 0:
            try:
                self._conn.commit()
            except BaseException:
                self._conn.rollback()
                raise

    @contextlib.contextmanager
    def unit_of_work(self):
        """Run several repository calls as ONE database transaction — the
        UnitOfWork wrapper of postgres.go:393-443. Everything inside
        commits together or rolls back together; per-call commits are
        suppressed while the UoW is open. Reentrant (nesting joins the
        outermost transaction); the store lock is held throughout, so the
        op is also serialized against other threads."""
        with self._lock:
            self._tx_depth += 1
            try:
                yield self
            except BaseException:
                self._tx_depth -= 1
                if self._tx_depth == 0:
                    self._conn.rollback()
                raise
            else:
                self._tx_depth -= 1
                if self._tx_depth == 0:
                    self._commit()

    def audit(self, entity: str, entity_id: str, action: str, old: str = "", new: str = "") -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO audit_log (entity, entity_id, action, old_value, new_value, created_at)"
                " VALUES (?,?,?,?,?,?)",
                (entity, entity_id, action, old, new, time.time()),
            )
            self._commit()

    def outbox_add(self, exchange: str, routing_key: str, payload: str) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO event_outbox (exchange, routing_key, payload, published, created_at)"
                " VALUES (?,?,?,0,?)",
                (exchange, routing_key, payload, time.time()),
            )
            self._commit()

    def outbox_drain(self) -> Iterable[tuple[int, str, str, str]]:
        """Yield unpublished outbox rows; caller marks them published."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, exchange, routing_key, payload FROM event_outbox WHERE published = 0 ORDER BY id"
            ).fetchall()
        return rows

    def outbox_mark_published(self, row_id: int) -> None:
        with self._lock:
            self._conn.execute("UPDATE event_outbox SET published = 1 WHERE id = ?", (row_id,))
            self._commit()

    def outbox_purge_published(self, older_than_s: float = 3600.0) -> int:
        """Delete published rows past the retention window so the table
        doesn't grow one row per money movement forever."""
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM event_outbox WHERE published = 1 AND created_at < ?",
                (time.time() - older_than_s,),
            )
            self._commit()
            return cur.rowcount

    # -- durable delivery dedupe (events.StoreDeliveryDeduper backend) -------

    def dedupe_claim(self, event_id: str) -> bool:
        """Atomically claim an envelope id; False if already claimed —
        including by a previous incarnation of this process. Inside a
        unit_of_work the claim commits WITH the handler's effect."""
        with self._lock:
            cur = self._conn.execute(
                "INSERT OR IGNORE INTO processed_deliveries (event_id, created_at)"
                " VALUES (?, ?)",
                (event_id, time.time()),
            )
            self._commit()
            return cur.rowcount == 1


class _SQLiteAccounts:
    def __init__(self, store: SQLiteStore):
        self._s = store

    def create(self, a: Account) -> None:
        with self._s._lock:
            self._s._conn.execute(
                "INSERT INTO accounts VALUES (?,?,?,?,?,?,?,?,?)",
                (a.id, a.player_id, a.currency, a.balance, a.bonus, a.status.value, a.version,
                 a.created_at, a.updated_at),
            )
            self._s._commit()

    def _row_to_account(self, row) -> Account:
        return Account(
            id=row[0], player_id=row[1], currency=row[2], balance=row[3], bonus=row[4],
            status=AccountStatus(row[5]), version=row[6], created_at=row[7], updated_at=row[8],
        )

    def get_by_id(self, account_id: str) -> Account:
        with self._s._lock:
            row = self._s._conn.execute("SELECT * FROM accounts WHERE id = ?", (account_id,)).fetchone()
        if row is None:
            raise AccountNotFoundError(account_id)
        return self._row_to_account(row)

    def get_by_player_id(self, player_id: str) -> Account | None:
        with self._s._lock:
            row = self._s._conn.execute("SELECT * FROM accounts WHERE player_id = ?", (player_id,)).fetchone()
        return self._row_to_account(row) if row else None

    def update_balance(self, account_id: str, balance: int, bonus: int, expected_version: int) -> None:
        with self._s._lock:
            cur = self._s._conn.execute(
                "UPDATE accounts SET balance=?, bonus=?, version=version+1, updated_at=?"
                " WHERE id=? AND version=?",
                (balance, bonus, time.time(), account_id, expected_version),
            )
            self._s._commit()
            if cur.rowcount == 0:
                # Either missing or a version conflict — same contract as
                # postgres.go:144-147.
                exists = self._s._conn.execute(
                    "SELECT 1 FROM accounts WHERE id=?", (account_id,)
                ).fetchone()
                if exists is None:
                    raise AccountNotFoundError(account_id)
                raise ConcurrentUpdateError(account_id)

    def update_status(self, account_id: str, status: AccountStatus) -> None:
        with self._s._lock:
            cur = self._s._conn.execute(
                "UPDATE accounts SET status=?, updated_at=? WHERE id=?",
                (status.value, time.time(), account_id),
            )
            self._s._commit()
            if cur.rowcount == 0:
                raise AccountNotFoundError(account_id)

    def list_ids(self) -> list[str]:
        with self._s._lock:
            return [r[0] for r in self._s._conn.execute("SELECT id FROM accounts").fetchall()]


class _SQLiteTransactions:
    def __init__(self, store: SQLiteStore):
        self._s = store

    def create(self, t: Transaction) -> None:
        with self._s._lock:
            try:
                self._s._conn.execute(
                    "INSERT INTO transactions VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                    (t.id, t.account_id, t.idempotency_key or None, t.type.value, t.amount,
                     t.balance_before, t.balance_after, t.status.value, t.reference,
                     t.game_id, t.round_id, t.risk_score, t.created_at, t.completed_at),
                )
                self._s._commit()
            except sqlite3.IntegrityError as exc:
                if "UNIQUE" in str(exc):
                    raise DuplicateTransactionError(t.idempotency_key) from exc
                raise

    def _row_to_tx(self, row) -> Transaction:
        return Transaction(
            id=row[0], account_id=row[1], idempotency_key=row[2] or "", type=TxType(row[3]),
            amount=row[4], balance_before=row[5], balance_after=row[6], status=TxStatus(row[7]),
            reference=row[8], game_id=row[9], round_id=row[10], risk_score=row[11],
            created_at=row[12], completed_at=row[13],
        )

    def get_by_id(self, tx_id: str) -> Transaction | None:
        with self._s._lock:
            row = self._s._conn.execute("SELECT * FROM transactions WHERE id=?", (tx_id,)).fetchone()
        return self._row_to_tx(row) if row else None

    def get_by_idempotency_key(self, account_id: str, key: str) -> Transaction | None:
        if not key:
            return None
        with self._s._lock:
            # Prefer the live (non-failed) row for the key.
            row = self._s._conn.execute(
                "SELECT * FROM transactions WHERE account_id=? AND idempotency_key=?"
                " ORDER BY (status = 'failed'), created_at DESC LIMIT 1",
                (account_id, key),
            ).fetchone()
        return self._row_to_tx(row) if row else None

    def update(self, t: Transaction) -> None:
        with self._s._lock:
            self._s._conn.execute(
                "UPDATE transactions SET status=?, completed_at=?, risk_score=? WHERE id=?",
                (t.status.value, t.completed_at, t.risk_score, t.id),
            )
            self._s._commit()

    def update_with_event(self, t: Transaction, exchange: str, routing_key: str, payload: str) -> None:
        """Transaction-row update + outbox stage in ONE commit — the atomic
        pair the transactional-outbox pattern requires (a crash can no
        longer complete the transaction without staging its event)."""
        with self._s._lock:
            self._s._conn.execute(
                "UPDATE transactions SET status=?, completed_at=?, risk_score=? WHERE id=?",
                (t.status.value, t.completed_at, t.risk_score, t.id),
            )
            self._s._conn.execute(
                "INSERT INTO event_outbox (exchange, routing_key, payload, published, created_at)"
                " VALUES (?,?,?,0,?)",
                (exchange, routing_key, payload, time.time()),
            )
            self._s._commit()

    @staticmethod
    def _filter_sql(types, from_ts, to_ts, game_id) -> tuple[str, list]:
        clauses, params = [], []
        if types:
            clauses.append(f"AND type IN ({','.join('?' * len(types))})")
            params.extend(types)
        if from_ts is not None:
            clauses.append("AND created_at >= ?")
            params.append(from_ts)
        if to_ts is not None:
            clauses.append("AND created_at < ?")
            params.append(to_ts)
        if game_id:
            clauses.append("AND game_id = ?")
            params.append(game_id)
        return " ".join(clauses), params

    def list_by_account(
        self, account_id: str, limit: int = 50, offset: int = 0,
        *, types: list[str] | None = None, from_ts: float | None = None,
        to_ts: float | None = None, game_id: str | None = None,
    ) -> list[Transaction]:
        """History page, newest first; filters apply before pagination
        (wallet.proto:172-186: types / from / to / game_id)."""
        where, params = self._filter_sql(types, from_ts, to_ts, game_id)
        with self._s._lock:
            rows = self._s._conn.execute(
                f"SELECT * FROM transactions WHERE account_id=? {where}"
                " ORDER BY created_at DESC, rowid DESC LIMIT ? OFFSET ?",
                (account_id, *params, limit, offset),
            ).fetchall()
        return [self._row_to_tx(r) for r in rows]

    def count_by_account(
        self, account_id: str,
        *, types: list[str] | None = None, from_ts: float | None = None,
        to_ts: float | None = None, game_id: str | None = None,
    ) -> int:
        where, params = self._filter_sql(types, from_ts, to_ts, game_id)
        with self._s._lock:
            (n,) = self._s._conn.execute(
                f"SELECT COUNT(*) FROM transactions WHERE account_id=? {where}",
                (account_id, *params),
            ).fetchone()
        return int(n)

    def daily_stats(self, account_id: str, day_start: float, day_end: float) -> dict:
        """Aggregate per-day totals (postgres.go:285-308)."""
        with self._s._lock:
            rows = self._s._conn.execute(
                "SELECT type, COALESCE(SUM(amount),0), COUNT(*) FROM transactions"
                " WHERE account_id=? AND status='completed' AND created_at >= ? AND created_at < ?"
                " GROUP BY type",
                (account_id, day_start, day_end),
            ).fetchall()
        stats = {"total_deposits": 0, "total_withdrawals": 0, "total_bets": 0, "total_wins": 0,
                 "transaction_count": 0}
        for tx_type, total, count in rows:
            stats["transaction_count"] += count
            if tx_type == "deposit":
                stats["total_deposits"] = total
            elif tx_type == "withdraw":
                stats["total_withdrawals"] = total
            elif tx_type == "bet":
                stats["total_bets"] = total
            elif tx_type == "win":
                stats["total_wins"] = total
        stats["net_position"] = stats["total_deposits"] - stats["total_withdrawals"]
        return stats


class _SQLiteLedger:
    def __init__(self, store: SQLiteStore):
        self._s = store

    def create(self, e: LedgerEntry) -> None:
        with self._s._lock:
            self._s._conn.execute(
                "INSERT INTO ledger_entries VALUES (?,?,?,?,?,?,?,?)",
                (e.id, e.transaction_id, e.account_id, e.entry_type.value, e.amount,
                 e.balance_after, e.description, e.created_at),
            )
            self._s._commit()

    def get_by_transaction(self, tx_id: str) -> list[LedgerEntry]:
        with self._s._lock:
            rows = self._s._conn.execute(
                "SELECT * FROM ledger_entries WHERE transaction_id=?", (tx_id,)
            ).fetchall()
        return [
            LedgerEntry(
                id=r[0], transaction_id=r[1], account_id=r[2], entry_type=LedgerEntryType(r[3]),
                amount=r[4], balance_after=r[5], description=r[6], created_at=r[7],
            )
            for r in rows
        ]

    def get_account_balance(self, account_id: str) -> int:
        with self._s._lock:
            row = self._s._conn.execute(
                "SELECT COALESCE(SUM(CASE WHEN entry_type='credit' THEN amount ELSE -amount END),0)"
                " FROM ledger_entries WHERE account_id=?",
                (account_id,),
            ).fetchone()
        return int(row[0])

    def verify_balance(self, account_id: str, recorded_balance: int) -> bool:
        return self.get_account_balance(account_id) == recorded_balance

    def balance_pairs(self) -> list[tuple[str, int, int, int]]:
        """(account id, balance, bonus, ledger-derived balance) of every
        account in one statement, so one snapshot: the reconcile sweep's
        input in one round trip."""
        with self._s._lock:
            rows = self._s._conn.execute(
                "SELECT a.id, a.balance, a.bonus, COALESCE(l.derived, 0) FROM accounts a"
                " LEFT JOIN (SELECT account_id, SUM(CASE WHEN entry_type='credit' THEN amount"
                " ELSE -amount END) AS derived FROM ledger_entries GROUP BY account_id) l"
                " ON l.account_id = a.id").fetchall()
        return [(r[0], int(r[1]), int(r[2]), int(r[3])) for r in rows]
