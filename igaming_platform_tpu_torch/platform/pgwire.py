"""PostgreSQL frontend/backend protocol v3 client — pure Python.

The port's copy of ``igaming_platform_tpu/platform/pgwire.py``. The
reference's production store of record is Postgres
(services/wallet/internal/repository/postgres.go), and the port may need
no Postgres driver, so this module speaks the wire protocol directly over
a socket:

- startup + authentication: trust, cleartext, MD5, and SCRAM-SHA-256
  (RFC 5802/7677; the SCRAM math is pinned against the RFC 7677 test
  vectors in tests/test_torch_pg.py);
- the extended query protocol (Parse/Bind/Describe/Execute/Sync) with
  text-format parameters — no SQL string interpolation anywhere;
- simple query for transaction control (BEGIN/COMMIT/ROLLBACK);
- ErrorResponse field parsing with SQLSTATE codes (the repository maps
  23505 unique_violation to DuplicateTransactionError, etc.).

One connection per store, serialized by the store's lock — the same
discipline as the SQLite backend.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import socket
import struct
import urllib.parse
from dataclasses import dataclass


class PgError(RuntimeError):
    """Server-reported error with SQLSTATE."""

    def __init__(self, fields: dict[str, str]):
        self.fields = fields
        self.sqlstate = fields.get("C", "")
        super().__init__(f"{fields.get('S', 'ERROR')} {self.sqlstate}: {fields.get('M', '')}")


class PgProtocolError(RuntimeError):
    pass


UNIQUE_VIOLATION = "23505"
CHECK_VIOLATION = "23514"
SERIALIZATION_FAILURE = "40001"


@dataclass(frozen=True)
class PgUrl:
    host: str
    port: int
    user: str
    password: str
    database: str

    @classmethod
    def parse(cls, url: str) -> "PgUrl":
        u = urllib.parse.urlparse(url)
        if u.scheme not in ("postgres", "postgresql"):
            raise ValueError(f"not a postgres url: {url}")
        return cls(
            host=u.hostname or "localhost",
            port=u.port or 5432,
            user=urllib.parse.unquote(u.username or "postgres"),
            password=urllib.parse.unquote(u.password or ""),
            database=urllib.parse.unquote(u.path.lstrip("/")) or "postgres",
        )


import functools


@functools.lru_cache(maxsize=512)
def _returns_rows(sql: str) -> bool:
    """Whether a statement can produce a RowDescription (needs Describe)."""
    head = sql.lstrip()[:8].upper()
    if head.startswith(("SELECT", "WITH", "SHOW", "VALUES")):
        return True
    return "RETURNING" in sql.upper()


@functools.lru_cache(maxsize=512)
def qmark_to_dollar(sql: str) -> str:
    """Translate '?' placeholders to $1..$n, skipping string literals.

    Lets the repository layer keep ONE set of SQL statements for both the
    SQLite ('?') and Postgres ('$n') dialects. Cached: the repository's
    statement set is small and fixed, and the per-character scan would
    otherwise run on every single operation.
    """
    out: list[str] = []
    n = 0
    in_str = False
    for ch in sql:
        if ch == "'":
            in_str = not in_str
            out.append(ch)
        elif ch == "?" and not in_str:
            n += 1
            out.append(f"${n}")
        else:
            out.append(ch)
    return "".join(out)


# ---------------------------------------------------------------------------
# SCRAM-SHA-256 (RFC 5802 / 7677)
# ---------------------------------------------------------------------------


class ScramClient:
    """Client side of one SCRAM-SHA-256 exchange."""

    def __init__(self, user: str, password: str, nonce: str | None = None):
        self.user = user
        self.password = password
        self.nonce = nonce or base64.b64encode(os.urandom(18)).decode()
        # PG ignores n= (the startup user wins); send it anyway per RFC.
        self.client_first_bare = f"n={user},r={self.nonce}"
        self.server_first = ""
        self.auth_message = ""
        self._server_signature = b""

    def client_first(self) -> str:
        return "n,," + self.client_first_bare

    def client_final(self, server_first: str) -> str:
        self.server_first = server_first
        attrs = dict(kv.split("=", 1) for kv in server_first.split(","))
        server_nonce = attrs["r"]
        if not server_nonce.startswith(self.nonce):
            raise PgProtocolError("SCRAM server nonce does not extend client nonce")
        salt = base64.b64decode(attrs["s"])
        iterations = int(attrs["i"])

        salted = hashlib.pbkdf2_hmac(
            "sha256", self.password.encode(), salt, iterations
        )
        client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
        stored_key = hashlib.sha256(client_key).digest()
        without_proof = f"c=biws,r={server_nonce}"
        self.auth_message = ",".join(
            (self.client_first_bare, server_first, without_proof)
        )
        client_sig = hmac.new(stored_key, self.auth_message.encode(), hashlib.sha256).digest()
        proof = bytes(a ^ b for a, b in zip(client_key, client_sig))
        server_key = hmac.new(salted, b"Server Key", hashlib.sha256).digest()
        self._server_signature = hmac.new(
            server_key, self.auth_message.encode(), hashlib.sha256
        ).digest()
        return f"{without_proof},p={base64.b64encode(proof).decode()}"

    def verify_server_final(self, server_final: str) -> None:
        attrs = dict(kv.split("=", 1) for kv in server_final.split(","))
        if "e" in attrs:
            raise PgProtocolError(f"SCRAM server error: {attrs['e']}")
        if base64.b64decode(attrs["v"]) != self._server_signature:
            raise PgProtocolError("SCRAM server signature mismatch")


def md5_password(user: str, password: str, salt: bytes) -> str:
    """Postgres MD5 auth response: 'md5' + md5(md5(password+user)+salt)."""
    inner = hashlib.md5((password + user).encode()).hexdigest()
    return "md5" + hashlib.md5(inner.encode() + salt).hexdigest()


# ---------------------------------------------------------------------------
# Connection
# ---------------------------------------------------------------------------


class _Cursor:
    """Mini DB-API cursor over one pipelined statement's results.

    Statements issued inside a unit of work are PIPELINED: their protocol
    frames buffer on the connection and nothing touches the socket until
    either a result is inspected (``rowcount``/``fetch*``) or the
    transaction commits — at which point every buffered statement ships in
    ONE socket write followed by a single Sync, and the whole batch costs
    one round trip instead of one per statement (the wallet's per-op
    store sequence drops from ~7 RTTs to ~3). ``_realize`` triggers that
    flush lazily, so code written against the eager cursor (rowcount
    checks, fetches) is oblivious to the batching.
    """

    __slots__ = ("rows", "_rowcount", "_oids", "_i", "_done", "_conn", "_mapper")

    def __init__(self, conn: "PgConnection | None" = None, mapper=None):
        self.rows: list[tuple] = []
        self._rowcount = 0
        self._oids: list[int] = []
        self._i = 0
        self._done = conn is None
        self._conn = conn
        self._mapper = mapper

    def _realize(self) -> None:
        if not self._done:
            self._conn.flush()

    @property
    def rowcount(self) -> int:
        self._realize()
        return self._rowcount

    def fetchone(self):
        self._realize()
        if self._i >= len(self.rows):
            return None
        row = self.rows[self._i]
        self._i += 1
        return row

    def fetchall(self):
        self._realize()
        out = self.rows[self._i :]
        self._i = len(self.rows)
        return out


class PgConnection:
    def __init__(self, url: str, connect_timeout: float = 5.0):
        self.url = PgUrl.parse(url)
        self.connect_timeout = connect_timeout
        self._sock: socket.socket | None = None
        self._buf = b""
        self.server_params: dict[str, str] = {}
        self.in_transaction = False
        # Pipeline state: frames + cursors buffered since the last flush.
        self._pending: list[_Cursor] = []
        self._pending_frames = bytearray()
        # Named prepared statements (pgx's automatic statement cache):
        # each distinct SQL is Parse'd ONCE per connection under a name;
        # later executions send only Bind/Execute — the server skips
        # re-parsing and the wire skips re-shipping the SQL text. Names
        # are monotonic and never reused. New names COMMIT into the cache
        # only when their batch flushes cleanly: a rollback may drop
        # never-sent Parse frames, and an error makes the server skip
        # later Parses — assuming either exists would bind a statement
        # the server never saw (26000) forever.
        self._stmt_names: dict[str, bytes] = {}
        self._pending_stmt_names: dict[str, bytes] = {}
        self._stmt_counter = 0

    # -- IO -----------------------------------------------------------------

    def _send(self, data: bytes) -> None:
        try:
            self._sock.sendall(data)
        except (OSError, AttributeError) as exc:
            raise PgProtocolError(f"send failed: {exc}") from exc

    def _msg(self, mtype: bytes, payload: bytes) -> bytes:
        return mtype + struct.pack(">I", len(payload) + 4) + payload

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            try:
                chunk = self._sock.recv(65536)
            except (OSError, AttributeError) as exc:
                raise PgProtocolError(f"recv failed: {exc}") from exc
            if not chunk:
                raise PgProtocolError("connection closed by server")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _recv_msg(self) -> tuple[bytes, bytes]:
        head = self._recv_exact(5)
        mtype = head[:1]
        (size,) = struct.unpack(">I", head[1:5])
        return mtype, self._recv_exact(size - 4)

    # -- startup / auth ------------------------------------------------------

    def connect(self) -> None:
        self._sock = socket.create_connection(
            (self.url.host, self.url.port), timeout=self.connect_timeout
        )
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        params = (
            b"user\x00" + self.url.user.encode() + b"\x00"
            b"database\x00" + self.url.database.encode() + b"\x00"
            b"application_name\x00igaming-platform-tpu\x00\x00"
        )
        payload = struct.pack(">I", 196608) + params  # protocol 3.0
        self._send(struct.pack(">I", len(payload) + 4) + payload)
        self._auth_loop()

    def _auth_loop(self) -> None:
        scram: ScramClient | None = None
        while True:
            mtype, payload = self._recv_msg()
            if mtype == b"E":
                raise PgError(_parse_error_fields(payload))
            if mtype == b"R":
                (code,) = struct.unpack(">I", payload[:4])
                if code == 0:  # AuthenticationOk
                    self._wait_ready()
                    return
                if code == 3:  # cleartext
                    self._send(self._msg(b"p", self.url.password.encode() + b"\x00"))
                elif code == 5:  # MD5
                    salt = payload[4:8]
                    resp = md5_password(self.url.user, self.url.password, salt)
                    self._send(self._msg(b"p", resp.encode() + b"\x00"))
                elif code == 10:  # SASL: mechanism list
                    mechs = payload[4:].split(b"\x00")
                    if b"SCRAM-SHA-256" not in mechs:
                        raise PgProtocolError(f"no supported SASL mechanism in {mechs}")
                    scram = ScramClient(self.url.user, self.url.password)
                    first = scram.client_first().encode()
                    body = b"SCRAM-SHA-256\x00" + struct.pack(">I", len(first)) + first
                    self._send(self._msg(b"p", body))
                elif code == 11:  # SASL continue (server-first-message)
                    final = scram.client_final(payload[4:].decode())
                    self._send(self._msg(b"p", final.encode()))
                elif code == 12:  # SASL final
                    scram.verify_server_final(payload[4:].decode())
                else:
                    raise PgProtocolError(f"unsupported auth method {code}")
            # 'v' (NegotiateProtocolVersion) and NoticeResponse tolerated:
            elif mtype in (b"v", b"N"):
                continue
            else:
                raise PgProtocolError(f"unexpected message {mtype!r} during auth")

    def _wait_ready(self) -> None:
        """Consume ParameterStatus/BackendKeyData until ReadyForQuery."""
        while True:
            mtype, payload = self._recv_msg()
            if mtype == b"S":
                key, _, value = payload.rstrip(b"\x00").partition(b"\x00")
                self.server_params[key.decode()] = value.decode()
            elif mtype == b"K":
                pass  # backend key data (cancel protocol unused)
            elif mtype == b"Z":
                self.in_transaction = payload[:1] in (b"T", b"E")
                return
            elif mtype == b"E":
                raise PgError(_parse_error_fields(payload))
            elif mtype == b"N":
                continue
            else:
                raise PgProtocolError(f"unexpected message {mtype!r} before ready")

    # -- extended query ------------------------------------------------------

    def execute_pipelined(self, sql: str, params: tuple = (), *, error_mapper=None) -> _Cursor:
        """Buffer one statement's Parse/Bind/Describe/Execute frames and
        return a lazy cursor; nothing ships until ``flush`` (triggered by
        result inspection, ``commit``, or an eager ``execute``).

        ``error_mapper(PgError) -> Exception`` translates this statement's
        server error into a domain exception at flush time — the pipelined
        analogue of wrapping an eager execute in try/except (the flush may
        be triggered by a LATER statement's cursor, so the mapping must
        travel with the statement it belongs to)."""
        sql = qmark_to_dollar(sql)
        name = self._stmt_names.get(sql) or self._pending_stmt_names.get(sql)
        parse_frame = b""
        if name is None:
            self._stmt_counter += 1
            name = b"s%d" % self._stmt_counter
            self._pending_stmt_names[sql] = name  # committed at clean flush
            parse_frame = self._msg(
                b"P", name + b"\x00" + sql.encode() + b"\x00" + struct.pack(">H", 0))
        bind = bytearray(b"\x00" + name + b"\x00")  # unnamed portal, named stmt
        bind += struct.pack(">H", 0)  # all params text format
        bind += struct.pack(">H", len(params))
        for p in params:
            if p is None:
                bind += struct.pack(">i", -1)
            else:
                if isinstance(p, bool):
                    v = b"true" if p else b"false"
                elif isinstance(p, float):
                    v = repr(p).encode()
                elif isinstance(p, bytes):
                    v = p
                else:
                    v = str(p).encode()
                bind += struct.pack(">I", len(v)) + v
        bind += struct.pack(">H", 0)  # results in text format
        frames = parse_frame + self._msg(b"B", bytes(bind))
        if _returns_rows(sql):
            # Describe is only needed where a RowDescription will follow —
            # writes (INSERT/UPDATE/DELETE without RETURNING) skip the
            # frame and its NoData reply.
            frames += self._msg(b"D", b"P\x00")
        frames += self._msg(b"E", b"\x00" + struct.pack(">I", 0))
        self._pending_frames += frames
        cur = _Cursor(self, error_mapper)
        self._pending.append(cur)
        return cur

    def execute(self, sql: str, params: tuple = (), *, error_mapper=None) -> _Cursor:
        """Parse/Bind/Execute one statement with text-format parameters,
        eagerly (any buffered pipeline flushes first to preserve order).
        '?' placeholders are translated to $n, so repository SQL is shared
        with the SQLite backend verbatim."""
        cur = self.execute_pipelined(sql, params, error_mapper=error_mapper)
        self.flush()
        return cur

    def flush(self, trailing_simple: str | None = None) -> None:
        """Ship every buffered frame (statements + one Sync, then an
        optional trailing simple query such as COMMIT) in ONE socket
        write, and read all results back. Raises the FIRST failed
        statement's (mapped) error after the full response stream is
        consumed — the server skips subsequent statements until Sync, so
        later cursors of a failed batch hold no rows. (That skip is also
        why BEGIN rides the pipeline as a normal extended-protocol
        statement: if opening the transaction fails, none of the
        statements that assumed it execute — no autocommit leak.)"""
        cursors, frames = self._pending, self._pending_frames
        self._pending, self._pending_frames = [], bytearray()
        buf = bytearray(frames)
        if cursors:
            buf += self._msg(b"S", b"")
        if trailing_simple is not None:
            buf += self._msg(b"Q", trailing_simple.encode() + b"\x00")
        if not buf:
            return
        try:
            self._send(bytes(buf))
            stmt_error = self._read_pipeline_block(cursors) if cursors else None
            trailing_error = self._read_simple_block() if trailing_simple is not None else None
        except PgProtocolError:
            for c in cursors:
                c._done = True  # dead socket: never re-flush from a cursor
            raise
        if stmt_error is not None:
            # The server skipped everything after the failed statement —
            # any Parse in THIS batch may not exist server-side, so its
            # names are dropped un-committed (fresh names re-Parse on
            # next use; a Parse that DID run before the error leaves a
            # harmless orphan statement, bounded by error count).
            # Established cache entries stay valid: protocol-level
            # prepared statements survive transaction aborts.
            self._pending_stmt_names.clear()
            idx, err = stmt_error
            mapper = cursors[idx]._mapper
            mapped = mapper(err) if mapper is not None else err
            raise mapped from (err if mapped is not err else None)
        if self._pending_stmt_names:
            self._stmt_names.update(self._pending_stmt_names)
            self._pending_stmt_names.clear()
        if trailing_error is not None:
            raise trailing_error

    def _read_pipeline_block(self, cursors: list[_Cursor]) -> tuple[int, PgError] | None:
        """Distribute one Sync-terminated response stream onto its cursors.
        Returns (statement index, error) for the first failure, if any."""
        i = 0
        first_error: tuple[int, PgError] | None = None
        while True:
            mtype, payload = self._recv_msg()
            if mtype == b"Z":
                self.in_transaction = payload[:1] in (b"T", b"E")
                break
            if mtype == b"E":
                if first_error is None:
                    first_error = (min(i, len(cursors) - 1), PgError(_parse_error_fields(payload)))
                i += 1
            elif mtype == b"T":
                cursors[i]._oids = _parse_row_description(payload)
            elif mtype == b"D":
                cursors[i].rows.append(_parse_data_row(payload, cursors[i]._oids))
            elif mtype == b"C":
                cursors[i]._rowcount = _parse_command_complete(payload)
                i += 1
            elif mtype in (b"1", b"2", b"n", b"s", b"N"):
                continue  # ParseComplete/BindComplete/NoData/suspended/notice
            else:
                raise PgProtocolError(f"unexpected message {mtype!r} in execute")
        for c in cursors:
            c._done = True
        return first_error

    def _read_simple_block(self) -> PgError | None:
        error: PgError | None = None
        while True:
            mtype, payload = self._recv_msg()
            if mtype == b"Z":
                self.in_transaction = payload[:1] in (b"T", b"E")
                break
            if mtype == b"E":
                error = PgError(_parse_error_fields(payload))
        return error

    # -- transaction control -------------------------------------------------

    def _simple(self, sql: str) -> None:
        self.flush()
        self._send(self._msg(b"Q", sql.encode() + b"\x00"))
        error = self._read_simple_block()
        if error is not None:
            raise error

    def begin(self) -> None:
        self._simple("BEGIN")

    def begin_pipelined(self) -> None:
        """Queue BEGIN as an extended-protocol pipeline statement so the
        transaction open rides the first flush's round trip. If BEGIN
        itself fails, the server skips every later statement until Sync —
        nothing can autocommit outside the transaction it assumed."""
        self.flush()  # a stray earlier batch must not land inside this tx
        self.execute_pipelined("BEGIN")

    def commit(self) -> None:
        """COMMIT, carrying any buffered statements in the same round trip.
        If a buffered statement fails, the server's aborted transaction
        turns the trailing COMMIT into ROLLBACK and the statement's error
        is raised — identical outcome to the eager sequence."""
        if self._pending:
            self.flush(trailing_simple="COMMIT")
        else:
            self._simple("COMMIT")

    def _drop_pending(self) -> None:
        for c in self._pending:
            c._done = True  # dropped with the transaction; never re-flush
        self._pending, self._pending_frames = [], bytearray()
        # Parse frames dropped here never reached the server — their
        # names must not enter the cache (26000 forever otherwise).
        self._pending_stmt_names.clear()

    def rollback(self) -> None:
        if self._pending and not self.in_transaction:
            # The whole batch (its BEGIN included) is still buffered —
            # the server never saw the transaction; drop it without
            # touching the socket.
            self._drop_pending()
            return
        # Unsent statements of an aborting transaction are dropped; the
        # server rolls back whatever did ship.
        self._drop_pending()
        self._simple("ROLLBACK")

    def close(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.sendall(self._msg(b"X", b""))  # Terminate
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    @property
    def connected(self) -> bool:
        return self._sock is not None


def _parse_error_fields(payload: bytes) -> dict[str, str]:
    fields: dict[str, str] = {}
    for part in payload.split(b"\x00"):
        if part:
            fields[chr(part[0])] = part[1:].decode(errors="replace")
    return fields


def _parse_row_description(payload: bytes) -> list[int]:
    """Column type OIDs from a RowDescription message."""
    (n,) = struct.unpack_from(">H", payload, 0)
    pos = 2
    oids: list[int] = []
    for _ in range(n):
        end = payload.index(b"\x00", pos)
        pos = end + 1  # skip name
        (_table, _attr, oid, _size, _mod, _fmt) = struct.unpack_from(">IHIhiH", payload, pos)
        pos += 18
        oids.append(oid)
    return oids


# Text-format value coercion by type OID, so the shared repository SQL
# receives the same Python types the sqlite3 driver produces.
_OID_BOOL = 16
_OID_INTS = (20, 21, 23, 26)  # int8, int2, int4, oid
_OID_FLOATS = (700, 701)
_OID_NUMERIC = 1700


def _coerce(text: str, oid: int):
    if oid in _OID_INTS:
        return int(text)
    if oid in _OID_FLOATS:
        return float(text)
    if oid == _OID_BOOL:
        return text == "t"
    if oid == _OID_NUMERIC:
        f = float(text)
        return int(f) if f.is_integer() else f
    return text


def _parse_data_row(payload: bytes, oids: list[int]) -> tuple:
    (n,) = struct.unpack_from(">H", payload, 0)
    pos = 2
    out = []
    for i in range(n):
        (size,) = struct.unpack_from(">i", payload, pos)
        pos += 4
        if size == -1:
            out.append(None)
        else:
            text = payload[pos : pos + size].decode()
            pos += size
            out.append(_coerce(text, oids[i]) if i < len(oids) else text)
    return tuple(out)


def _parse_command_complete(payload: bytes) -> int:
    tag = payload.rstrip(b"\x00").decode()
    parts = tag.split()
    try:
        return int(parts[-1])
    except (ValueError, IndexError):
        return 0
