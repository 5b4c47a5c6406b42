"""PostgreSQL store of record — the reference's production backend.

Mirrors services/wallet/internal/repository/postgres.go
(optimistic locking :129-148, idempotency lookup :229-240, daily stats
:285-308, ledger verify :358-390, UnitOfWork :393-443) and the schema +
trigger backstops of deploy/init-db.sql (CHECK balance>=0
:17-18, version-increment trigger :224-236, auto updated_at :211-221),
over the pure-Python wire client (platform/pgwire.py: the port needs no
driver). It is the port's copy of ``igaming_platform_tpu/platform/pg_store.py``
over the port's repository views and migrations.

The repository views are the SAME classes as the SQLite backend
(repository.py): PgConnection.execute translates '?' placeholders to $n
and coerces result types by OID, so the SQL and the semantics live in one
place and both backends run the same unit suites. Postgres-specific
overrides are exactly the dialect edges: unique-violation mapping,
BIGSERIAL insertion-order tiebreaks, and the DDL.

Connection discipline is the reference's pool model (postgres.go uses
pgxpool): one connection PER THREAD, created on demand and owned for the
store's lifetime, with per-thread transaction depth — concurrent wallet
ops run truly in parallel on the wire instead of serializing on a single
connection's lock (the cross-op arbiter is the database itself: optimistic
versioning + unique constraints, exactly as with N replicas). The store
"lock" is therefore per-thread (reentrancy only); SQLite keeps its global
lock because one sqlite3 handle is shared.
"""

from __future__ import annotations

import contextlib
import threading
import time

from igaming_platform_tpu_torch.platform.domain import (
    ConcurrentUpdateError,
    DuplicateTransactionError,
    Transaction,
)
from igaming_platform_tpu_torch.platform.pgwire import (
    CHECK_VIOLATION,
    UNIQUE_VIOLATION,
    PgConnection,
    PgError,
)
from igaming_platform_tpu_torch.platform.repository import (
    DedupeStoreMixin,
    _SQLiteAccounts,
    _SQLiteLedger,
    _SQLiteTransactions,
)

# The DDL lives in platform/migrations.py as a versioned history (the
# reference's golang-migrate role, Makefile:144-161); boot applies any
# pending migrations so a fresh database and a migrated one agree.


class _PgConnAdapter:
    """sqlite3-connection-shaped facade over PgConnection, so the SQLite
    repository views run unchanged (they call conn.execute(sql, params)
    and read cursor.rowcount/fetchone/fetchall). A dead connection is
    reconnected and the statement retried ONCE — but only outside a unit
    of work (a mid-transaction retry would silently split the
    transaction; the UoW aborts and the caller retries whole)."""

    def __init__(self, store: "PostgresStore"):
        self._store = store

    def execute(self, sql: str, params: tuple = (), *, error_mapper=None):
        from igaming_platform_tpu_torch.platform.pgwire import PgProtocolError

        try:
            if self._store._tx_depth > 0:
                # Inside a unit of work: PIPELINE — frames buffer on the
                # connection and the whole batch ships with one Sync when
                # a result is inspected or the UoW commits (pgwire._Cursor
                # docstring). Cuts the wallet op to ~3 round trips.
                return self._store._pg.execute_pipelined(
                    sql, tuple(params), error_mapper=error_mapper)
            return self._store._pg.execute(sql, tuple(params), error_mapper=error_mapper)
        except PgProtocolError:
            if self._store._tx_depth > 0:
                raise
            self._store._reconnect()
            return self._store._pg.execute(sql, tuple(params), error_mapper=error_mapper)


class _PgAccounts(_SQLiteAccounts):
    """Dialect override: a SELF-ABORTING optimistic-lock update.

    The base class UPDATEs `WHERE id=? AND version=?` and inspects
    rowcount — which forces a pipeline flush (a full round trip) in the
    middle of every unit of work, with the rig/PG write arbitration held
    across it. Here the version check moves INTO the statement: a CASE
    that, on version mismatch, drives balance to -1 — violating the
    schema's `CHECK (balance >= 0)` (init-db.sql:17-18's backstop) — so
    a conflict becomes a SERVER-side error that aborts the whole
    pipelined batch at COMMIT time. Nothing needs inspecting mid-flight,
    the entire wallet op ships as ONE flush (BEGIN..COMMIT included), and
    the losing replica still observes ConcurrentUpdateError exactly as
    before (postgres.go:144-147 semantics, one round trip).

    Rowcount-0 (account row missing entirely) cannot occur on this path:
    accounts are never deleted, and every caller resolves the account
    immediately before updating (_active_account). The version-conflict
    case — the one that happens under replica contention — is fully
    covered by the CHECK trick.
    """

    def update_balance(self, account_id: str, balance: int, bonus: int, expected_version: int) -> None:
        if balance < 0 or bonus < 0:
            raise ValueError(f"balance CHECK violated: balance={balance} bonus={bonus}")

        def _map(exc: PgError):
            if exc.sqlstate == CHECK_VIOLATION:
                return ConcurrentUpdateError(account_id)
            return exc

        with self._s._lock:
            self._s._conn.execute(
                "UPDATE accounts SET"
                " balance = CASE WHEN version=? THEN ? ELSE -1 END,"
                " bonus = CASE WHEN version=? THEN ? ELSE bonus END,"
                " updated_at = ?,"
                " version = version + 1"
                " WHERE id=?",
                (expected_version, balance, expected_version, bonus,
                 time.time(), account_id),
                error_mapper=_map,
            )
            self._s._commit()


class _PgTransactions(_SQLiteTransactions):
    """Dialect overrides: explicit column list (the PG table has a
    trailing BIGSERIAL seq), seq as the insertion-order tiebreak, and
    SQLSTATE-based duplicate mapping (postgres.go:446-453)."""

    def create(self, t: Transaction) -> None:
        # The duplicate mapping travels WITH the statement (error_mapper):
        # under pipelining the server error surfaces at flush time — which
        # may be a later statement's cursor or the COMMIT — so a local
        # try/except here would never see it.
        def _map(exc: PgError):
            if exc.sqlstate == UNIQUE_VIOLATION:
                return DuplicateTransactionError(t.idempotency_key)
            return exc

        with self._s._lock:
            self._s._conn.execute(
                "INSERT INTO transactions (id, account_id, idempotency_key, type, amount,"
                " balance_before, balance_after, status, reference, game_id, round_id,"
                " risk_score, created_at, completed_at) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (t.id, t.account_id, t.idempotency_key or None, t.type.value, t.amount,
                 t.balance_before, t.balance_after, t.status.value, t.reference,
                 t.game_id, t.round_id, t.risk_score, t.created_at, t.completed_at),
                error_mapper=_map,
            )
            self._s._commit()

    def get_idem_and_account(self, account_id: str, key: str):
        """The wallet op prologue as ONE round trip: idempotency replay
        row + account row, pipelined in a single flush (the eager path
        pays two). WalletService discovers this seam via getattr.

        Heals like the adapter: a dead connection (PG restart, blip) is
        reconnected and the read pair retried once — this is the FIRST
        wire touch of every wallet op, so without the retry a broken
        pooled connection would fail its thread forever."""
        from igaming_platform_tpu_torch.platform.pgwire import PgProtocolError

        try:
            return self._idem_and_account_once(account_id, key)
        except PgProtocolError:
            self._s._reconnect()
            return self._idem_and_account_once(account_id, key)

    def _idem_and_account_once(self, account_id: str, key: str):
        with self._s._lock:
            conn = self._s._pg
            c_tx = None
            if key:
                c_tx = conn.execute_pipelined(
                    "SELECT * FROM transactions WHERE account_id=? AND idempotency_key=?"
                    " ORDER BY (status = 'failed'), created_at DESC LIMIT 1",
                    (account_id, key))
            c_acct = conn.execute_pipelined(
                "SELECT * FROM accounts WHERE id = ?", (account_id,))
            conn.flush()
        tx_row = c_tx.fetchone() if c_tx is not None else None
        acct_row = c_acct.fetchone()
        tx = self._row_to_tx(tx_row) if tx_row else None
        acct = self._s.accounts._row_to_account(acct_row) if acct_row else None
        return tx, acct

    def list_by_account(self, account_id, limit=50, offset=0, *, types=None,
                        from_ts=None, to_ts=None, game_id=None):
        where, params = self._filter_sql(types, from_ts, to_ts, game_id)
        with self._s._lock:
            rows = self._s._conn.execute(
                "SELECT id, account_id, idempotency_key, type, amount, balance_before,"
                " balance_after, status, reference, game_id, round_id, risk_score,"
                f" created_at, completed_at FROM transactions WHERE account_id=? {where}"
                " ORDER BY created_at DESC, seq DESC LIMIT ? OFFSET ?",
                (account_id, *params, limit, offset),
            ).fetchall()
        return [self._row_to_tx(r) for r in rows]


class _ThreadLocalLock:
    """Per-thread reentrant lock: preserves the repository views' nested
    `with store._lock` discipline WITHIN a thread without serializing
    threads against each other — each thread drives its own connection."""

    def __init__(self):
        self._local = threading.local()

    def _get(self) -> threading.RLock:
        lk = getattr(self._local, "lk", None)
        if lk is None:
            lk = self._local.lk = threading.RLock()
        return lk

    def __enter__(self):
        return self._get().__enter__()

    def __exit__(self, *exc):
        return self._get().__exit__(*exc)


class PostgresStore(DedupeStoreMixin):
    """Same surface as SQLiteStore over a real PostgreSQL."""

    def __init__(self, url: str, *, bootstrap: bool = True):
        self._url = url
        self._local = threading.local()
        self._all_conns: list[PgConnection] = []
        self._conn_guard = threading.Lock()
        self._conn = _PgConnAdapter(self)
        self._lock = _ThreadLocalLock()
        self._closing = False
        if bootstrap:
            self._bootstrap()
        self.accounts = _PgAccounts(self)
        self.transactions = _PgTransactions(self)
        self.ledger = _SQLiteLedger(self)

    @property
    def _pg(self) -> PgConnection:
        """This thread's connection, dialed on first use (pool model —
        thread count is bounded by the gRPC server's executor)."""
        conn = getattr(self._local, "conn", None)
        if conn is None:
            if self._closing:
                from igaming_platform_tpu_torch.platform.pgwire import PgProtocolError

                raise PgProtocolError("store is closed")
            conn = PgConnection(self._url)
            conn.connect()
            self._local.conn = conn
            with self._conn_guard:
                self._all_conns.append(conn)
        return conn

    @property
    def _tx_depth(self) -> int:
        return getattr(self._local, "tx_depth", 0)

    @_tx_depth.setter
    def _tx_depth(self, value: int) -> None:
        self._local.tx_depth = value

    def _reconnect(self) -> None:
        """Replace this thread's dead connection (PG restart, network
        blip) — the store of record must heal like the AMQP publisher."""
        old = getattr(self._local, "conn", None)
        if old is not None:
            try:
                old.close()
            except Exception:  # noqa: BLE001 — already dead
                pass
            with self._conn_guard:
                if old in self._all_conns:
                    self._all_conns.remove(old)
        self._local.conn = None
        _ = self._pg  # dial a fresh one eagerly (raises after close())

    def _bootstrap(self) -> None:
        from igaming_platform_tpu_torch.platform.migrations import migrate_up

        migrate_up(self._pg)

    def close(self) -> None:
        self._closing = True
        with self._conn_guard:
            conns, self._all_conns = self._all_conns, []
        for conn in conns:
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — shutdown is best-effort
                pass
        self._local.conn = None

    def _commit(self) -> None:
        # Outside a unit of work each statement autocommits at Sync;
        # inside one, the UoW's COMMIT finishes the explicit transaction.
        pass

    @contextlib.contextmanager
    def unit_of_work(self):
        """BEGIN..COMMIT across several repository calls (the UnitOfWork
        wrapper of postgres.go:393-443); reentrant like the SQLite one."""
        with self._lock:
            if self._tx_depth == 0:
                # Lazy BEGIN: rides the first flush's round trip together
                # with the statements it opens the transaction for.
                self._pg.begin_pipelined()
            self._tx_depth += 1
            try:
                yield self
            except BaseException:
                self._tx_depth -= 1
                if self._tx_depth == 0:
                    try:
                        self._pg.rollback()
                    except Exception:  # noqa: BLE001 — dead socket: the
                        # server aborts the tx anyway; reconnect for the
                        # next operation and surface the ORIGINAL error.
                        try:
                            self._reconnect()
                        except Exception:  # noqa: BLE001
                            pass
                raise
            else:
                self._tx_depth -= 1
                if self._tx_depth == 0:
                    self._pg.commit()

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

    def outbox_drain(self):
        with self._lock:
            return self._conn.execute(
                "SELECT id, exchange, routing_key, payload FROM event_outbox"
                " WHERE published = 0 ORDER BY id"
            ).fetchall()

    def outbox_mark_published(self, row_id: int) -> None:
        with self._lock:
            self._conn.execute("UPDATE event_outbox SET published = 1 WHERE id = ?", (row_id,))
            self._commit()

    def outbox_purge_published(self, older_than_s: float = 3600.0) -> int:
        with self._lock:
            cur = self._conn.execute(
                "DELETE FROM event_outbox WHERE published = 1 AND created_at < ?",
                (time.time() - older_than_s,),
            )
            self._commit()
            return cur.rowcount

    # -- durable delivery dedupe (release/purge from DedupeStoreMixin) -------

    def dedupe_claim(self, event_id: str) -> bool:
        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO processed_deliveries (event_id, created_at)"
                " VALUES (?, ?) ON CONFLICT (event_id) DO NOTHING",
                (event_id, time.time()),
            )
            self._commit()
            return cur.rowcount == 1
