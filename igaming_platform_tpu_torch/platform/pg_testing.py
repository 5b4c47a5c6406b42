"""SQLite-backed PostgreSQL protocol-v3 server — multi-replica test rig.

The port's copy of ``igaming_platform_tpu/platform/pg_testing.py``, so that
the port's Postgres store can be driven where neither a Postgres server nor
the JAX package is installed (``chip_smoke.py`` phase 16 runs it on the
card's machine). One addition: a session's SQLite connection gets
``floor`` from Python when the library was built without its math
functions, so the LTV job's day buckets run through the rig everywhere.
Run it as its own process with
``python -m igaming_platform_tpu_torch.platform.pg_testing <db> [port]``.

The reference's deployment model is horizontal stateless wallet replicas
arbitrated by ONE shared Postgres through optimistic locking
(README.md:157-160, postgres.go:129-148). Proving that
capability needs several `PostgresStore` clients contending over one
real database through the real wire protocol — and a test machine has no
PostgreSQL server. So, in the same from-scratch spirit as the AMQP and
PG *clients* (serve/amqp.py, platform/pgwire.py), this module implements
the *server* side of protocol v3 over a shared SQLite file: real
sockets, real extended-query framing, real cross-connection transaction
arbitration (WAL + BEGIN IMMEDIATE), real UNIQUE/CHECK violation
SQLSTATEs, and real session advisory locks.

It is deliberately NOT a general PG: it supports exactly the dialect the
platform layer speaks —

- startup + trust auth; extended query (Parse/Bind/Describe/Execute/
  Sync); simple query (Q); Terminate;
- explicit transactions with PG's aborted-until-rollback state;
- ``$n`` text-format parameters (the client translates ``?`` to ``$n``);
- SQLSTATE mapping: 23505 unique_violation, 23514 check_violation;
- ``pg_advisory_lock(k)`` / ``pg_advisory_unlock(k)`` as server-side
  session locks (released on disconnect) — what migration boots take;
- dialect translation: BIGSERIAL columns (AUTOINCREMENT / insertion-seq
  trigger), ``FOR UPDATE`` stripped (writers serialize via BEGIN
  IMMEDIATE), plpgsql function/trigger DDL accepted as no-ops (the
  trigger backstop is PG-only; the optimistic lock is the semantics
  under test).

Live-Postgres suites (POSTGRES_URL) remain the deployment truth; this
server makes the cross-replica contention path testable in any CI.
"""

from __future__ import annotations

import os
import re
import socket
import functools
import sqlite3
import struct
import threading
import time

from igaming_platform_tpu_torch.platform.repository import ensure_sqlite_floor

_NULL = b"\x00"


def _cstr(s: str) -> bytes:
    return s.encode() + _NULL


def _msg(mtype: bytes, payload: bytes) -> bytes:
    return mtype + struct.pack(">I", len(payload) + 4) + payload


def _error_msg(sqlstate: str, message: str) -> bytes:
    return _msg(
        b"E",
        b"S" + _cstr("ERROR") + b"C" + _cstr(sqlstate) + b"M" + _cstr(message) + _NULL,
    )


_PLPGSQL_NOOP = re.compile(
    r"^\s*(CREATE\s+(OR\s+REPLACE\s+)?FUNCTION|CREATE\s+TRIGGER|"
    r"DROP\s+TRIGGER|DROP\s+FUNCTION|CREATE\s+EXTENSION|COMMENT\s+ON)",
    re.IGNORECASE,
)
_ADVISORY = re.compile(r"pg_advisory_(unlock|lock)\s*\(\s*(-?\d+)\s*\)", re.IGNORECASE)
_DOLLAR_PARAM = re.compile(r"\$(\d+)")
_BIGSERIAL_PK = re.compile(r"\bBIGSERIAL\s+PRIMARY\s+KEY\b", re.IGNORECASE)
_BIGSERIAL_COL = re.compile(r"\b(\w+)\s+BIGSERIAL\b", re.IGNORECASE)
_CREATE_TABLE = re.compile(r"CREATE\s+TABLE(?:\s+IF\s+NOT\s+EXISTS)?\s+(\w+)", re.IGNORECASE)


def _coerce_param(text: str):
    """Keep parameters as TEXT and let SQLite column affinity coerce —
    exactly what PG's own text-format parameters do. Converting
    numeric-LOOKING strings here would canonicalize real string data
    (player id '007' -> '7'); affinity already handles numeric columns,
    comparisons, arithmetic, and LIMIT/OFFSET for text values. Only the
    wire client's boolean words (it serializes Python bools as
    'true'/'false') map to SQLite's integers."""
    if text == "true":
        return 1
    if text == "false":
        return 0
    return text


def _render(value) -> bytes:
    if isinstance(value, float):
        return repr(value).encode()
    if isinstance(value, bytes):
        return b"\\x" + value.hex().encode()
    return str(value).encode()


def _column_oids(description, rows) -> list[int]:
    """Per-column OID from the first non-NULL value (int8=20, float8=701,
    text=25) so the client's OID coercion reproduces sqlite3's types."""
    ncols = len(description or ())
    oids = [25] * ncols
    for col in range(ncols):
        for row in rows:
            v = row[col]
            if v is None:
                continue
            if isinstance(v, int):
                oids[col] = 20
            elif isinstance(v, float):
                oids[col] = 701
            break
    return oids


class PgSqliteServer:
    """Accepts any number of client connections, each with its own SQLite
    connection onto one shared database file."""

    def __init__(self, db_path: str, port: int = 0):
        if db_path == ":memory:":
            raise ValueError("use a file path — replicas must share the database")
        self.db_path = db_path
        # Bootstrap WAL mode once so every later connection shares it.
        boot = sqlite3.connect(db_path)
        boot.execute("PRAGMA journal_mode=WAL")
        boot.close()
        self._advisory_locks: dict[int, threading.Lock] = {}
        self._advisory_guard = threading.Lock()
        # Fair write gate: explicit write transactions queue here instead
        # of spinning in SQLite's busy-wait (whose progressive sleeps
        # reach ~100 ms — pooled clients would thrash). Real Postgres
        # arbitrates with row locks; a FIFO mutex is the rig's analogue.
        self.write_gate = threading.Lock()
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", port))
        self._listener.listen(16)
        self.port = self._listener.getsockname()[1]
        self.url = f"postgres://tester@127.0.0.1:{self.port}/wallet"
        self._closing = False
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def close(self) -> None:
        self._closing = True
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._listener.close()

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            # Response frames must not sit in Nagle's buffer waiting for a
            # delayed ACK — the client blocks on every reply (~40 ms
            # stalls otherwise, dwarfing statement cost).
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=_Session(self, sock).run, daemon=True
            ).start()

    # -- advisory locks (session level, like PG's) --------------------------

    def advisory_acquire(self, key: int, timeout: float = 30.0) -> bool:
        with self._advisory_guard:
            lock = self._advisory_locks.setdefault(key, threading.Lock())
        return lock.acquire(timeout=timeout)

    def advisory_release(self, key: int) -> None:
        with self._advisory_guard:
            lock = self._advisory_locks.get(key)
        if lock is not None and lock.locked():
            try:
                lock.release()
            except RuntimeError:
                pass


class _Session:
    """One client connection: protocol pump + its own SQLite handle."""

    def __init__(self, server: PgSqliteServer, sock: socket.socket):
        self.server = server
        self.sock = sock
        self.db = sqlite3.connect(server.db_path, check_same_thread=False)
        self.db.isolation_level = None  # explicit transaction control only
        self.db.execute("PRAGMA busy_timeout=15000")
        self.db.execute("PRAGMA synchronous=NORMAL")
        ensure_sqlite_floor(self.db)
        self.in_tx = False
        self.aborted = False
        self.holds_write_gate = False
        self._stmts: dict[bytes, str] = {}  # named prepared statements
        self.held_advisory: set[int] = set()
        self._buf = b""
        self._pending_sql: str | None = None
        self._pending_params: tuple = ()
        self._out = bytearray()
        self._skip_to_sync = False

    # -- socket plumbing ----------------------------------------------------

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _tx_status(self) -> bytes:
        if self.aborted:
            return b"E"
        return b"T" if self.in_tx else b"I"

    def _release_write_gate(self) -> None:
        if self.holds_write_gate:
            self.holds_write_gate = False
            self.server.write_gate.release()

    # -- main loop ----------------------------------------------------------

    def run(self) -> None:
        try:
            (size,) = struct.unpack(">I", self._recv_exact(4))
            startup = self._recv_exact(size - 4)
            (proto,) = struct.unpack(">I", startup[:4])
            if proto == 80877103:  # SSLRequest — refuse, client retries plain
                self.sock.sendall(b"N")
                (size,) = struct.unpack(">I", self._recv_exact(4))
                startup = self._recv_exact(size - 4)
            self.sock.sendall(_msg(b"R", struct.pack(">I", 0)))  # AuthenticationOk
            self.sock.sendall(_msg(b"S", _cstr("server_version") + _cstr("16.0 (sqlite-rig)")))
            self.sock.sendall(_msg(b"K", struct.pack(">II", os.getpid() & 0x7FFFFFFF, 0)))
            self.sock.sendall(_msg(b"Z", b"I"))
            while True:
                mtype = self._recv_exact(1)
                (size,) = struct.unpack(">I", self._recv_exact(4))
                payload = self._recv_exact(size - 4)
                if mtype == b"X":
                    return
                handler = {
                    b"P": self._on_parse, b"B": self._on_bind,
                    b"D": self._on_describe, b"E": self._on_execute,
                    b"S": self._on_sync, b"Q": self._on_query,
                }.get(mtype)
                if handler is None:
                    self._out += _error_msg("0A000", f"unsupported message {mtype!r}")
                    self._skip_to_sync = True
                else:
                    handler(payload)
        except (ConnectionError, OSError):
            pass
        finally:
            if self.in_tx:
                try:
                    self.db.execute("ROLLBACK")
                except sqlite3.Error:
                    pass
            self._release_write_gate()
            for key in list(self.held_advisory):
                self.server.advisory_release(key)
            self.db.close()
            try:
                self.sock.close()
            except OSError:
                pass

    # -- extended protocol --------------------------------------------------

    def _on_parse(self, payload: bytes) -> None:
        if self._skip_to_sync:
            return
        # name \0 sql \0 H n_param_oids ...
        name, rest = payload.split(_NULL, 1)
        sql, _ = rest.split(_NULL, 1)
        if name:
            # Named prepared statement (the client's per-connection
            # statement cache): parsed once, bound many times.
            self._stmts[name] = sql.decode()
        self._pending_sql = sql.decode()
        self._out += _msg(b"1", b"")

    def _on_bind(self, payload: bytes) -> None:
        if self._skip_to_sync:
            return
        end_portal = payload.index(_NULL)
        pos = end_portal + 1                    # portal name
        end_stmt = payload.index(_NULL, pos)
        stmt_name = payload[pos:end_stmt]
        if stmt_name:
            self._pending_sql = self._stmts.get(stmt_name)
            if self._pending_sql is None:
                self._out += _error_msg(
                    "26000", f"prepared statement {stmt_name!r} does not exist")
                if self.in_tx:
                    # Real PG: ANY extended-protocol error inside an
                    # explicit transaction aborts it.
                    self.aborted = True
                self._skip_to_sync = True
                return
        pos = end_stmt + 1                      # statement name
        (nfmt,) = struct.unpack_from(">H", payload, pos)
        pos += 2 + 2 * nfmt
        (nparams,) = struct.unpack_from(">H", payload, pos)
        pos += 2
        params = []
        for _ in range(nparams):
            (plen,) = struct.unpack_from(">i", payload, pos)
            pos += 4
            if plen == -1:
                params.append(None)
            else:
                params.append(_coerce_param(payload[pos : pos + plen].decode()))
                pos += plen
        self._pending_params = tuple(params)
        self._out += _msg(b"2", b"")

    def _on_describe(self, payload: bytes) -> None:
        pass  # RowDescription is emitted with Execute

    def _on_execute(self, payload: bytes) -> None:
        if self._skip_to_sync:
            return
        sql = self._pending_sql or ""
        try:
            out = self._run_statement(sql, self._pending_params)
        except sqlite3.Error as exc:
            self._out += self._sql_error(exc)
            self._skip_to_sync = True
            return
        self._out += out
        if out[:1] == b"E":
            # RETURNED errors (gate/advisory timeouts, 25P02) must skip
            # the rest of the batch exactly like raised ones — PG's
            # extended protocol discards everything until Sync after ANY
            # error, and pipelined clients rely on it (a BEGIN that fails
            # must not let the batch autocommit statement-by-statement).
            self._skip_to_sync = True

    def _on_sync(self, payload: bytes) -> None:
        self._skip_to_sync = False
        self._out += _msg(b"Z", self._tx_status())
        self.sock.sendall(bytes(self._out))
        self._out = bytearray()

    def _on_query(self, payload: bytes) -> None:
        """Simple query: one statement (BEGIN/COMMIT/ROLLBACK or a plpgsql
        blob from MigrationRunner's up_simple)."""
        sql = payload.rstrip(_NULL).decode().strip().rstrip(";")
        try:
            self._out += self._run_statement(sql, ())
        except sqlite3.Error as exc:
            self._out += self._sql_error(exc)
        self._out += _msg(b"Z", self._tx_status())
        self.sock.sendall(bytes(self._out))
        self._out = bytearray()

    # -- statement execution ------------------------------------------------

    def _sql_error(self, exc: sqlite3.Error) -> bytes:
        text = str(exc)
        if "UNIQUE constraint failed" in text:
            state = "23505"
        elif "CHECK constraint failed" in text:
            state = "23514"
        elif "database is locked" in text:
            state = "40001"
        else:
            state = "XX000"
        if self.in_tx:
            self.aborted = True
        return _error_msg(state, text)

    def _run_statement(self, sql: str, params: tuple) -> bytes:
        stripped = sql.strip()
        upper = stripped.upper()

        if self.aborted and upper not in ("ROLLBACK", "COMMIT", "END"):
            if self.in_tx:
                return _error_msg(
                    "25P02",
                    "current transaction is aborted, commands ignored until "
                    "end of transaction block")

        if upper.startswith(("SET ", "RESET ")):
            # Session parameters: read-only mode is ENFORCED (mapped onto
            # SQLite's per-connection query_only pragma) so the scan jobs'
            # "incapable of writing" guarantee is exercised in every rig
            # run, not only against live Postgres; everything else
            # (timezones, …) is accepted and ignored.
            if "DEFAULT_TRANSACTION_READ_ONLY" in upper:
                if upper.startswith("RESET "):
                    ro = False
                else:
                    value = upper.split("=", 1)[-1].split()[-1].strip("'\" ;")
                    ro = value in ("ON", "TRUE", "1", "YES")
                self.db.execute(f"PRAGMA query_only={'ON' if ro else 'OFF'}")
            return _msg(b"C", _cstr(upper.split(None, 1)[0]))

        if upper in ("BEGIN", "START TRANSACTION"):
            # Queue at the server's fair write gate, THEN take SQLite's
            # write lock (IMMEDIATE — up front, so transactions never
            # deadlock on lock upgrades mid-transaction). The gate keeps
            # pooled/replica clients from spinning in SQLite's busy-wait.
            if not self.server.write_gate.acquire(timeout=30.0):
                return _error_msg("40001", "write gate timeout")
            self.holds_write_gate = True
            try:
                self.db.execute("BEGIN IMMEDIATE")
            except sqlite3.Error:
                # An autocommit writer may hold SQLite's lock past the
                # busy timeout; the gate must not stay held by a session
                # with no transaction open.
                self._release_write_gate()
                raise
            self.in_tx, self.aborted = True, False
            return _msg(b"C", _cstr("BEGIN"))
        if upper in ("COMMIT", "END"):
            self.db.execute("ROLLBACK" if self.aborted else "COMMIT")
            was_aborted, self.in_tx, self.aborted = self.aborted, False, False
            self._release_write_gate()
            return _msg(b"C", _cstr("ROLLBACK" if was_aborted else "COMMIT"))
        if upper == "ROLLBACK":
            if self.in_tx:
                self.db.execute("ROLLBACK")
            self.in_tx, self.aborted = False, False
            self._release_write_gate()
            return _msg(b"C", _cstr("ROLLBACK"))

        m = _ADVISORY.search(stripped)
        if m is not None:
            key = int(m.group(2))
            if m.group(1).lower() == "lock":
                if not self.server.advisory_acquire(key):
                    return _error_msg("55P03", f"advisory lock {key} timeout")
                self.held_advisory.add(key)
            else:
                self.server.advisory_release(key)
                self.held_advisory.discard(key)
            return _msg(b"C", _cstr("SELECT 0"))

        if _PLPGSQL_NOOP.match(stripped) or "LANGUAGE PLPGSQL" in upper:
            # The plpgsql trigger backstop is PG-only hardening; the
            # optimistic lock it backs up runs for real here.
            return _msg(b"C", _cstr("CREATE FUNCTION"))

        translated, post_ddl = self._translate(stripped)
        cur = self.db.execute(translated, params)
        for ddl in post_ddl:
            self.db.execute(ddl)
        if not self.in_tx and self.db.in_transaction:
            self.db.execute("COMMIT")

        out = bytearray()
        verb = upper.split(None, 1)[0] if upper else "SELECT"
        if cur.description is not None:
            rows = cur.fetchall()
            oids = _column_oids(cur.description, rows)
            desc = bytearray(struct.pack(">H", len(cur.description)))
            for (name, *_), oid in zip(cur.description, oids):
                desc += _cstr(name) + struct.pack(">IHIhiH", 0, 0, oid, -1, -1, 0)
            out += _msg(b"T", bytes(desc))
            for row in rows:
                data = bytearray(struct.pack(">H", len(row)))
                for v in row:
                    if v is None:
                        data += struct.pack(">i", -1)
                    else:
                        rendered = _render(v)
                        data += struct.pack(">I", len(rendered)) + rendered
                out += _msg(b"D", bytes(data))
            tag = f"SELECT {len(rows)}"
        else:
            out += _msg(b"n", b"")
            n = max(cur.rowcount, 0)
            tag = f"INSERT 0 {n}" if verb == "INSERT" else f"{verb} {n}"
        out += _msg(b"C", _cstr(tag))
        return bytes(out)

    def _translate(self, sql: str) -> tuple[str, list[str]]:
        return _translate_cached(sql)


@functools.lru_cache(maxsize=1024)
def _translate_cached(sql: str) -> tuple[str, list[str]]:
    """PG dialect -> SQLite: $n params, BIGSERIAL, FOR UPDATE. Cached —
    the platform speaks a small fixed statement set, and this regex
    pipeline would otherwise run on EVERY execute."""
    s = _DOLLAR_PARAM.sub("?", sql)
    s = re.sub(r"\s+FOR\s+UPDATE\b", "", s, flags=re.IGNORECASE)
    post_ddl: list[str] = []
    if _BIGSERIAL_PK.search(s):
        s = _BIGSERIAL_PK.sub("INTEGER PRIMARY KEY AUTOINCREMENT", s)
    cols = [m.group(1) for m in _BIGSERIAL_COL.finditer(s)]
    if cols:
        s = _BIGSERIAL_COL.sub(lambda m: f"{m.group(1)} INTEGER", s)
        m_table = _CREATE_TABLE.search(s)
        if m_table is not None:
            table = m_table.group(1)
            # Insertion-order sequence for plain BIGSERIAL columns
            # (the PG transactions.seq tiebreak).
            for col in cols:
                post_ddl.append(
                    f"CREATE TRIGGER IF NOT EXISTS {table}_{col}_fill "
                    f"AFTER INSERT ON {table} WHEN NEW.{col} IS NULL "
                    f"BEGIN UPDATE {table} SET {col} = NEW.rowid "
                    f"WHERE rowid = NEW.rowid; END")
    return s, post_ddl


def _serve_forever(argv: list[str]) -> None:
    """CLI: serve one rig as its OWN OS process — the deployment shape of
    a real database server (benchmarks and multi-process suites point
    replicas at it). Prints `PG_RIG_PORT=<port>` when ready."""
    db_path = argv[1]
    port = int(argv[2]) if len(argv) > 2 else 0
    server = PgSqliteServer(db_path, port=port)
    print(f"PG_RIG_PORT={server.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


if __name__ == "__main__":
    import sys as _sys

    _serve_forever(_sys.argv)
