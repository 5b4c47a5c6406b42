"""Durable decision ledger: every decision written down, replayable bit-exact.

The port's counterpart of ``igaming_platform_tpu/serve/ledger.py``, byte for
byte in its record format: a WAL this module writes is read by the JAX
package's readers and a JAX-written one by this module's. One
:class:`DecisionRecord` type carries what an auditor (and the replay tool,
``igaming_platform_tpu_torch/tools/replay.py``) needs: decision id, account
id, model version and params fingerprint, the feature snapshot and its hash,
wire mode, the serving state and tier at score time, the score, action and
reason outputs, and a trace id.

Durability layers:

- **WAL**: records append to length-prefixed, CRC-framed segments
  (``ledger-<seq>.wal``) with batched fsync off the scoring path: the
  scoring thread only enqueues a columnar batch reference (O(1)); a writer
  thread encodes, writes and fsyncs on a cadence. A SIGKILL mid-write
  leaves at most a torn tail frame, truncated on recovery
  (:func:`recover_segment`). Segments rotate at ``segment_bytes``.
- **Sink drain**: a drainer thread ships records to an analytical sink
  (:class:`ClickHouseDecisionSink`) through a bounded in-memory hand-off
  queue; when the sink is down or slow the queue overflows onto disk (the
  WAL itself is the spill) and the drainer catches up from its persisted
  cursor (``sink.cursor``), so a sink outage never blocks or fails a
  decision and delivery is at-least-once across restarts. Failures feed a
  ``breaker`` when one is given.

The ledger never fails, blocks or changes an answer: a failed append is
counted and dropped. Determinism: ``wall_clock``, ``_fresh_process_token``
and ``_jitter`` are the only sources of nondeterminism in a record, so tests
pin them. The port's engine hands ``note_decisions`` host numpy only, after
each step's readback: nothing on the writer thread reads a device tensor.

A ``metrics=`` registry (``obs/metrics.ServiceMetrics``) gets the
``ledger_*`` families; each record carries the active span's trace id and
the serving state of the supervisor the server binds as the state provider
(``serving_state()`` answers ``"unknown"`` without one). The sinks are
ClickHouse (``serve/clickhouse.py``'s client) and Postgres
(``PgDecisionSink`` over ``platform/pgwire.py``). The params fingerprint
is the engine's own (``serve/scorer.py::params_fingerprint``).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import random
import struct
import threading
import time
import uuid
import zlib
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from igaming_platform_tpu_torch.obs import hostprof
from igaming_platform_tpu_torch.serve import chaos
from igaming_platform_tpu_torch.serve.clickhouse import ClickHouseClient, ClickHouseError  # noqa: F401

logger = logging.getLogger(__name__)

SCHEMA_VERSION = 1
# Side-record schema versions riding the same WAL framing: the version
# byte doubles as the record-kind tag, so v1 DecisionRecords stay
# byte-identical (golden-pinned) while outcome backfill and promotion
# events append without a schema break. A reader rejects a version it does
# not know (LedgerSchemaError), never mis-parses it.
OUTCOME_SCHEMA_VERSION = 2
PROMOTION_SCHEMA_VERSION = 3
_KNOWN_VERSIONS = (SCHEMA_VERSION, OUTCOME_SCHEMA_VERSION,
                   PROMOTION_SCHEMA_VERSION)
SEGMENT_MAGIC = b"DLG1"
_FRAME = struct.Struct("<II")  # payload length, crc32(payload)

# Fixed head of a v1 record (after the version byte): flags, action,
# tx_type code, serving-state code, tier code, thresholds, score,
# rule_score, reason mask, ml-score bits, amount, wall timestamp,
# feature hash (8 raw bytes), params fingerprint (8 raw bytes).
_V1_HEAD = struct.Struct("<BBBBBHHiiIIqd8s8s")

_FLAG_FEATURES = 1
_FLAG_BLACKLISTED = 2
_FLAG_DEGRADED = 4
# Stateful sequence scoring (serve/session_state.py): the record carries
# the account's post-append session-window length, the per-account event
# sequence number and the blake2b-8 session_state_hash. Guarded by a
# flag (not a schema bump) so pre-session v1 records stay byte-identical
# — the golden test pins that.
_FLAG_SESSION = 8
_SESSION_TAIL = struct.Struct("<HI8s")  # window length, event seq, hash

TIER_CODES = {"device": 0, "host": 1, "heuristic": 2}
TIER_NAMES = {v: k for k, v in TIER_CODES.items()}
STATE_CODES = {"serving": 0, "degraded": 1, "brownout": 2, "unknown": 3}
STATE_NAMES = {v: k for k, v in STATE_CODES.items()}

_TX_CODES = {"deposit": 0, "withdraw": 1, "bet": 2, "win": 3}
_TX_NAMES = ("deposit", "withdraw", "bet", "win", "")


class LedgerSchemaError(ValueError):
    """Record bytes carry an unknown schema version or malformed body."""


# ---------------------------------------------------------------------------
# Clock and identity seams: the only nondeterminism sources on the replay
# path. Everything a replay must reproduce is derived from recorded values,
# never from these.


def wall_clock() -> float:  # analysis: clock-seam
    """Record timestamp (unix seconds). Injected seam: replay never calls
    it; audit queries read the recorded value."""
    return time.time()


def _fresh_process_token() -> str:  # analysis: clock-seam
    """Per-process uniqueness for decision ids across restarts."""
    return uuid.uuid4().hex[:10]


def _jitter() -> float:  # analysis: clock-seam
    """0.5x-1.5x backoff jitter factor (writer/sink retry discipline)."""
    return 0.5 + random.random()


_TOKEN = _fresh_process_token()
_SEQ_LOCK = threading.Lock()
_BATCH_SEQ = 0


def next_batch_prefix() -> str:
    """Monotonic per-process decision-batch prefix; row i of the batch is
    decision id ``<prefix>.<i>``."""
    global _BATCH_SEQ
    with _SEQ_LOCK:
        _BATCH_SEQ += 1
        return f"d-{_TOKEN}-{_BATCH_SEQ:07x}"


# ---------------------------------------------------------------------------
# Feature snapshot hash


def feature_hash(features: np.ndarray | None, blacklisted: bool) -> str:
    """16-hex digest of one row's feature snapshot (integrity + compact
    join key for sinks that don't carry the snapshot itself)."""
    h = hashlib.blake2b(digest_size=8)
    if features is not None:
        h.update(np.ascontiguousarray(features, dtype=np.float32).tobytes())
    h.update(b"\x01" if blacklisted else b"\x00")
    return h.hexdigest()


# ---------------------------------------------------------------------------
# DecisionRecord + versioned wire codec


@dataclass(slots=True)
class DecisionRecord:
    """One scoring decision, as the auditor sees it."""

    decision_id: str
    account_id: str
    trace_id: str
    model_version: str
    params_fp: str  # 16 hex chars
    wire_mode: str  # single | batch | wire_row | wire_bytes | index
    serving_state: str  # serving | degraded | brownout | unknown
    tier: str  # device | host | heuristic
    score: int
    action: int
    reason_mask: int
    rule_score: int
    ml_score_bits: int
    amount: int
    tx_type: str
    block_threshold: int
    review_threshold: int
    ts_unix: float
    blacklisted: bool
    features: np.ndarray | None  # [NUM_FEATURES] float32 snapshot, or None
    # Stateful decisions only (index-mode rows scored through the fused
    # session step): post-append window length, per-account monotone
    # event sequence number, and the session_state_hash (blake2b-8 over
    # the post-append window, hex). Empty hash == stateless decision.
    session_len: int = 0
    session_seq: int = 0
    session_hash: str = ""

    @property
    def ml_score(self) -> float:
        return float(np.uint32(self.ml_score_bits).view(np.float32))

    @property
    def feature_hash(self) -> str:
        return feature_hash(self.features, self.blacklisted)

    def sink_row(self) -> dict:
        """The analytical-sink projection (no snapshot — the WAL keeps
        that; the hash joins back to it)."""
        return {
            "decision_id": self.decision_id,
            "account_id": self.account_id,
            "trace_id": self.trace_id,
            "ts": round(self.ts_unix, 6),
            "model_version": self.model_version,
            "params_fp": self.params_fp,
            "wire_mode": self.wire_mode,
            "serving_state": self.serving_state,
            "tier": self.tier,
            "score": self.score,
            "action": self.action,
            "reason_mask": self.reason_mask,
            "rule_score": self.rule_score,
            "ml_score": self.ml_score,
            "amount": self.amount,
            "tx_type": self.tx_type,
            "feature_hash": self.feature_hash,
            "blacklisted": 1 if self.blacklisted else 0,
        }


def _pack_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<H", len(b)) + b


def encode_record(r: DecisionRecord) -> bytes:
    """DecisionRecord -> versioned wire bytes (schema-version byte first;
    the v1 golden is ``tests/golden/decision_record_v1.bin``)."""
    flags = 0
    feats = None
    if r.features is not None:
        flags |= _FLAG_FEATURES
        feats = np.ascontiguousarray(r.features, dtype=np.float32)
    if r.blacklisted:
        flags |= _FLAG_BLACKLISTED
    if r.tier == "heuristic":
        flags |= _FLAG_DEGRADED
    if r.session_hash:
        flags |= _FLAG_SESSION
    head = _V1_HEAD.pack(
        flags,
        r.action & 0xFF,
        _TX_CODES.get(r.tx_type, 4),
        STATE_CODES.get(r.serving_state, STATE_CODES["unknown"]),
        TIER_CODES.get(r.tier, 0),
        r.block_threshold & 0xFFFF,
        r.review_threshold & 0xFFFF,
        int(r.score),
        int(r.rule_score),
        int(r.reason_mask) & 0xFFFFFFFF,
        int(r.ml_score_bits) & 0xFFFFFFFF,
        int(r.amount),
        float(r.ts_unix),
        bytes.fromhex(r.feature_hash),
        bytes.fromhex(r.params_fp),
    )
    parts = [bytes([SCHEMA_VERSION]), head,
             _pack_str(r.decision_id), _pack_str(r.account_id),
             _pack_str(r.trace_id), _pack_str(r.model_version),
             _pack_str(r.wire_mode)]
    if feats is not None:
        parts.append(struct.pack("<H", feats.shape[0]))
        parts.append(feats.tobytes())
    if r.session_hash:
        parts.append(_SESSION_TAIL.pack(
            r.session_len & 0xFFFF, r.session_seq & 0xFFFFFFFF,
            bytes.fromhex(r.session_hash)))
    return b"".join(parts)


def _read_str(buf: memoryview, pos: int) -> tuple[str, int]:
    (ln,) = struct.unpack_from("<H", buf, pos)
    pos += 2
    if pos + ln > len(buf):
        raise LedgerSchemaError("record truncated (string)")
    return bytes(buf[pos:pos + ln]).decode(), pos + ln


def decode_record(payload: bytes) -> DecisionRecord:
    """Wire bytes -> DecisionRecord. A record from a FUTURE schema version
    is rejected loudly (LedgerSchemaError), never mis-parsed."""
    buf = memoryview(payload)
    if len(buf) < 1:
        raise LedgerSchemaError("empty record")
    version = buf[0]
    if version != SCHEMA_VERSION:
        raise LedgerSchemaError(
            f"unknown DecisionRecord schema version {version} "
            f"(this build reads v{SCHEMA_VERSION})")
    if len(buf) < 1 + _V1_HEAD.size:
        raise LedgerSchemaError("record truncated (head)")
    (flags, action, tx_code, state_code, tier_code, block_thr, review_thr,
     score, rule_score, reason_mask, ml_bits, amount, ts,
     fhash, pfp) = _V1_HEAD.unpack_from(buf, 1)
    pos = 1 + _V1_HEAD.size
    decision_id, pos = _read_str(buf, pos)
    account_id, pos = _read_str(buf, pos)
    trace_id, pos = _read_str(buf, pos)
    model_version, pos = _read_str(buf, pos)
    wire_mode, pos = _read_str(buf, pos)
    features = None
    if flags & _FLAG_FEATURES:
        (nf,) = struct.unpack_from("<H", buf, pos)
        pos += 2
        end = pos + 4 * nf
        if end > len(buf):
            raise LedgerSchemaError("record truncated (features)")
        features = np.frombuffer(buf[pos:end], dtype=np.float32).copy()
        pos = end
    session_len = session_seq = 0
    session_hash = ""
    if flags & _FLAG_SESSION:
        if pos + _SESSION_TAIL.size > len(buf):
            raise LedgerSchemaError("record truncated (session tail)")
        session_len, session_seq, shash = _SESSION_TAIL.unpack_from(buf, pos)
        session_hash = shash.hex()
        pos += _SESSION_TAIL.size
    rec = DecisionRecord(
        decision_id=decision_id, account_id=account_id, trace_id=trace_id,
        model_version=model_version, params_fp=pfp.hex(),
        wire_mode=wire_mode,
        serving_state=STATE_NAMES.get(state_code, "unknown"),
        tier=TIER_NAMES.get(tier_code, "device"),
        score=score, action=action, reason_mask=reason_mask,
        rule_score=rule_score, ml_score_bits=ml_bits, amount=amount,
        tx_type=_TX_NAMES[tx_code] if tx_code < len(_TX_NAMES) else "",
        block_threshold=block_thr, review_threshold=review_thr,
        ts_unix=ts, blacklisted=bool(flags & _FLAG_BLACKLISTED),
        features=features,
        session_len=int(session_len), session_seq=int(session_seq),
        session_hash=session_hash,
    )
    if fhash.hex() != rec.feature_hash:
        raise LedgerSchemaError(
            f"feature-snapshot hash mismatch on {decision_id} "
            "(corrupt record body)")
    return rec


# ---------------------------------------------------------------------------
# Side records: outcome backfill + promotion events (v2 / v3 frames)


@dataclass(slots=True)
class OutcomeRecord:
    """The label-backfill seam: a later-arriving ground-truth outcome for
    one decision (chargeback, manual-review verdict, cleared dispute,
    KYC result) joined to its DecisionRecord by ``decision_id``, without
    any change to the golden-pinned v1 decision frames."""

    decision_id: str
    label: int  # 0 = legitimate, 1 = fraud
    source: str  # chargeback | manual_review | dispute_cleared | kyc | ...
    ts_unix: float


_OUTCOME_HEAD = struct.Struct("<Bd")  # label, wall timestamp


def encode_outcome(r: OutcomeRecord) -> bytes:
    return b"".join([
        bytes([OUTCOME_SCHEMA_VERSION]),
        _OUTCOME_HEAD.pack(1 if r.label else 0, float(r.ts_unix)),
        _pack_str(r.decision_id),
        _pack_str(r.source),
    ])


def decode_outcome(payload: bytes) -> OutcomeRecord:
    buf = memoryview(payload)
    if len(buf) < 1 or buf[0] != OUTCOME_SCHEMA_VERSION:
        raise LedgerSchemaError("not an outcome record")
    if len(buf) < 1 + _OUTCOME_HEAD.size:
        raise LedgerSchemaError("outcome record truncated (head)")
    label, ts = _OUTCOME_HEAD.unpack_from(buf, 1)
    pos = 1 + _OUTCOME_HEAD.size
    decision_id, pos = _read_str(buf, pos)
    source, pos = _read_str(buf, pos)
    return OutcomeRecord(decision_id=decision_id, label=int(label),
                         source=source, ts_unix=ts)


@dataclass(slots=True)
class PromotionRecord:
    """One param-set transition on the serving engine, written through the
    same durable WAL as the decisions it explains: replay resolves which
    params scored which decision by joining ``params_fp`` across the
    boundary."""

    event: str  # promote | rollback
    old_fp: str  # 16 hex chars — the params serving BEFORE the swap
    new_fp: str  # 16 hex chars — the params serving AFTER the swap
    model_version: str
    reason: str
    gates_json: str  # compact JSON of the gate table at decision time
    ts_unix: float


_PROMO_EVENTS = {"promote": 0, "rollback": 1}
_PROMO_NAMES = {v: k for k, v in _PROMO_EVENTS.items()}
_PROMOTION_HEAD = struct.Struct("<Bd8s8s")  # event, ts, old fp, new fp


def encode_promotion(r: PromotionRecord) -> bytes:
    return b"".join([
        bytes([PROMOTION_SCHEMA_VERSION]),
        _PROMOTION_HEAD.pack(
            _PROMO_EVENTS.get(r.event, 0), float(r.ts_unix),
            bytes.fromhex(r.old_fp), bytes.fromhex(r.new_fp)),
        _pack_str(r.model_version),
        _pack_str(r.reason),
        _pack_str(r.gates_json),
    ])


def decode_promotion(payload: bytes) -> PromotionRecord:
    buf = memoryview(payload)
    if len(buf) < 1 or buf[0] != PROMOTION_SCHEMA_VERSION:
        raise LedgerSchemaError("not a promotion record")
    if len(buf) < 1 + _PROMOTION_HEAD.size:
        raise LedgerSchemaError("promotion record truncated (head)")
    event, ts, old_fp, new_fp = _PROMOTION_HEAD.unpack_from(buf, 1)
    pos = 1 + _PROMOTION_HEAD.size
    model_version, pos = _read_str(buf, pos)
    reason, pos = _read_str(buf, pos)
    gates_json, pos = _read_str(buf, pos)
    return PromotionRecord(
        event=_PROMO_NAMES.get(event, "promote"), old_fp=old_fp.hex(),
        new_fp=new_fp.hex(), model_version=model_version, reason=reason,
        gates_json=gates_json, ts_unix=ts)


def encode_entry(record) -> bytes:
    """Any ledger entry -> its versioned wire bytes."""
    if isinstance(record, DecisionRecord):
        return encode_record(record)
    if isinstance(record, OutcomeRecord):
        return encode_outcome(record)
    if isinstance(record, PromotionRecord):
        return encode_promotion(record)
    raise TypeError(f"not a ledger entry: {type(record).__name__}")


def decode_entry(payload: bytes):
    """Wire bytes -> ("decision" | "outcome" | "promotion", record).
    A frame from a FUTURE schema version is rejected loudly."""
    if len(payload) < 1:
        raise LedgerSchemaError("empty record")
    version = payload[0]
    if version == SCHEMA_VERSION:
        return "decision", decode_record(payload)
    if version == OUTCOME_SCHEMA_VERSION:
        return "outcome", decode_outcome(payload)
    if version == PROMOTION_SCHEMA_VERSION:
        return "promotion", decode_promotion(payload)
    raise LedgerSchemaError(
        f"unknown ledger entry schema version {version} "
        f"(this build reads {sorted(_KNOWN_VERSIONS)})")


# ---------------------------------------------------------------------------
# WAL segments


def _segment_name(seq: int) -> str:
    return f"ledger-{seq:08d}.wal"


def _segment_seq(name: str) -> int | None:
    if not (name.startswith("ledger-") and name.endswith(".wal")):
        return None
    try:
        return int(name[7:-4])
    except ValueError:
        return None


def recover_segment(path: str) -> tuple[int, int, bool]:
    """Scan one segment; returns (valid_end_offset, frame_count, torn).

    A torn tail — short header, short payload, or CRC mismatch at the end
    (the SIGKILL-mid-write shape) — marks everything from the first bad
    byte as invalid; the caller truncates there before appending."""
    size = os.path.getsize(path)
    if size < len(SEGMENT_MAGIC):
        return 0, 0, size > 0
    with open(path, "rb") as f:
        if f.read(len(SEGMENT_MAGIC)) != SEGMENT_MAGIC:
            return 0, 0, True
        pos = len(SEGMENT_MAGIC)
        count = 0
        while True:
            header = f.read(_FRAME.size)
            if len(header) < _FRAME.size:
                return pos, count, len(header) > 0
            length, crc = _FRAME.unpack(header)
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                return pos, count, True
            pos += _FRAME.size + length
            count += 1


def iter_segment_frames(path: str, start_offset: int = 0):
    """Yield (payload, end_offset) frames from ``start_offset`` (0 means
    just past the magic), stopping cleanly at a torn tail."""
    with open(path, "rb") as f:
        if f.read(len(SEGMENT_MAGIC)) != SEGMENT_MAGIC:
            return
        if start_offset > len(SEGMENT_MAGIC):
            f.seek(start_offset)
        while True:
            header = f.read(_FRAME.size)
            if len(header) < _FRAME.size:
                return
            length, crc = _FRAME.unpack(header)
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                return
            yield payload, f.tell()


def ledger_segments(directory: str) -> list[tuple[int, str]]:
    """Sorted (seq, path) of the directory's WAL segments."""
    out = []
    for name in os.listdir(directory):
        seq = _segment_seq(name)
        if seq is not None:
            out.append((seq, os.path.join(directory, name)))
    return sorted(out)


def iter_entries(directory: str):
    """Yield every decodable ("kind", record) entry across the
    directory's segments, in append order — decisions, outcome
    backfills, and promotion events interleaved as written. Torn tails
    stop a segment's scan cleanly (the recovery contract); frames from a
    future schema version raise LedgerSchemaError — an audit read must
    never silently skip them."""
    for _seq, path in ledger_segments(directory):
        for payload, _end in iter_segment_frames(path):
            yield decode_entry(payload)


def iter_records(directory: str):
    """Yield every decodable DecisionRecord across the directory's
    segments, in append order. Side records (outcomes, promotions) are
    skipped — read them via :func:`iter_entries` — but a frame from an
    UNKNOWN schema version still raises LedgerSchemaError."""
    for kind, record in iter_entries(directory):
        if kind == "decision":
            yield record


def iter_outcomes(directory: str):
    for kind, record in iter_entries(directory):
        if kind == "outcome":
            yield record


def iter_promotions(directory: str):
    for kind, record in iter_entries(directory):
        if kind == "promotion":
            yield record


# ---------------------------------------------------------------------------
# Columnar pending batch (the O(1) hot-path hand-off)


@dataclass(slots=True)
class _PendingBatch:
    """References to one scored batch's result columns; the writer thread
    expands it into records. The scoring paths hand over host arrays made
    for the batch (readback copies, the gathered rows), never a device
    tensor or a buffer they reuse, so holding the references is safe.
    ``ml_score`` is float32 and reaches the record as its IEEE bits
    (``.view``, never a cast)."""

    prefix: str
    ts: float
    n: int
    score: np.ndarray
    action: np.ndarray
    reason_mask: np.ndarray
    rule_score: np.ndarray
    ml_score: np.ndarray
    x: np.ndarray | None
    bl: np.ndarray | None
    account_ids: list | None
    amounts: Any
    tx_codes: Any
    tier_codes: np.ndarray  # [n] uint8
    serving_state: str
    wire_mode: str
    model_version: str
    params_fp: str
    block_threshold: int
    review_threshold: int
    trace_id: str
    # Stateful (session-scored) batches: per-row post-append window
    # lengths, event sequence numbers, raw 8-byte session hashes. None
    # for stateless batches — the records then omit the session tail.
    session_lens: Any = None
    session_seqs: Any = None
    session_hashes: Any = None

    def to_records(self) -> list[DecisionRecord]:
        recs: list[DecisionRecord] = []
        ml_bits = np.ascontiguousarray(
            self.ml_score, dtype=np.float32).view(np.uint32)
        for i in range(self.n):
            feats = None
            bl_i = bool(self.bl[i]) if self.bl is not None else False
            if self.x is not None:
                feats = np.ascontiguousarray(self.x[i], dtype=np.float32)
            acct = ""
            if self.account_ids is not None:
                a = self.account_ids[i]
                acct = a.decode() if isinstance(a, (bytes, memoryview)) else str(a)
            amount = int(self.amounts[i]) if self.amounts is not None else 0
            if self.tx_codes is None:
                tx = ""
            else:
                c = self.tx_codes[i]
                tx = (_TX_NAMES[int(c)] if not isinstance(c, str)
                      else c)
            recs.append(DecisionRecord(
                decision_id=f"{self.prefix}.{i}",
                account_id=acct,
                trace_id=self.trace_id,
                model_version=self.model_version,
                params_fp=self.params_fp,
                wire_mode=self.wire_mode,
                serving_state=self.serving_state,
                tier=TIER_NAMES.get(int(self.tier_codes[i]), "device"),
                score=int(self.score[i]),
                action=int(self.action[i]),
                reason_mask=int(self.reason_mask[i]),
                rule_score=int(self.rule_score[i]),
                ml_score_bits=int(ml_bits[i]),
                amount=amount,
                tx_type=tx,
                block_threshold=self.block_threshold,
                review_threshold=self.review_threshold,
                ts_unix=self.ts,
                blacklisted=bl_i,
                features=feats,
                session_len=(int(self.session_lens[i])
                             if self.session_lens is not None else 0),
                session_seq=(int(self.session_seqs[i])
                             if self.session_seqs is not None else 0),
                session_hash=(self.session_hashes[i].hex()
                              if self.session_hashes is not None else ""),
            ))
        return recs


# ---------------------------------------------------------------------------
# Sinks


class ClickHouseDecisionSink:
    """Decision drain into ClickHouse over the HTTP interface."""

    DDL = (
        "CREATE TABLE IF NOT EXISTS {table} ("
        " decision_id String, account_id String, trace_id String,"
        " ts Float64, model_version String, params_fp String,"
        " wire_mode String, serving_state String, tier String,"
        " score Int32, action UInt8, reason_mask UInt32, rule_score Int32,"
        " ml_score Float32, amount Int64, tx_type String,"
        " feature_hash String, blacklisted UInt8"
        ") ENGINE = MergeTree ORDER BY (account_id, ts)"
    )

    def __init__(self, client, table: str = "risk_decisions",
                 create_table: bool = True):
        self.client = (ClickHouseClient(client) if isinstance(client, str)
                       else client)
        self.table = table
        self._create = create_table
        self._ready = False

    def send(self, records: list[DecisionRecord]) -> None:
        if not self._ready and self._create:
            self.client.query(self.DDL.format(table=self.table))
            self._ready = True
        lines = "\n".join(json.dumps(r.sink_row()) for r in records)
        self.client.query(
            f"INSERT INTO {self.table} FORMAT JSONEachRow\n{lines}")


class PgDecisionSink:
    """Decision drain into Postgres over the port's wire-protocol client
    (``platform/pgwire.py``): one ``INSERT ... ON CONFLICT DO NOTHING`` a
    record, the JAX sink's statement and table. Unlike the JAX sink, which
    sends each INSERT in a round trip of its own, a batch's INSERTs are
    pipelined inside one transaction and ship in one round trip: a batch
    commits whole or not at all, and the drainer's retry of a failed batch
    stays idempotent."""

    DDL = (
        "CREATE TABLE IF NOT EXISTS {table} ("
        " decision_id TEXT PRIMARY KEY, account_id TEXT, trace_id TEXT,"
        " ts DOUBLE PRECISION, model_version TEXT, params_fp TEXT,"
        " wire_mode TEXT, serving_state TEXT, tier TEXT,"
        " score INTEGER, action INTEGER, reason_mask BIGINT,"
        " rule_score INTEGER, ml_score REAL, amount BIGINT, tx_type TEXT,"
        " feature_hash TEXT, blacklisted INTEGER)"
    )

    _COLS = ("decision_id", "account_id", "trace_id", "ts", "model_version",
             "params_fp", "wire_mode", "serving_state", "tier", "score",
             "action", "reason_mask", "rule_score", "ml_score", "amount",
             "tx_type", "feature_hash", "blacklisted")

    def __init__(self, url: str, table: str = "risk_decisions"):
        self.url = url
        self.table = table
        self._conn = None

    def _connection(self):
        if self._conn is None:
            from igaming_platform_tpu_torch.platform.pgwire import PgConnection

            conn = PgConnection(self.url)
            conn.connect()
            conn.execute(self.DDL.format(table=self.table))
            self._conn = conn
        return self._conn

    def send(self, records: list[DecisionRecord]) -> None:
        try:
            conn = self._connection()
            # ON CONFLICT keeps the at-least-once drain idempotent: a
            # cursor replay after SIGKILL re-sends rows, never errors.
            sql = (f"INSERT INTO {self.table} ({', '.join(self._COLS)}) "
                   f"VALUES ({', '.join(f'${i + 1}' for i in range(len(self._COLS)))}) "
                   "ON CONFLICT (decision_id) DO NOTHING")
            conn.begin_pipelined()
            for r in records:
                row = r.sink_row()
                conn.execute_pipelined(sql, tuple(str(row[c]) for c in self._COLS))
            conn.commit()
        except Exception:
            # A poisoned connection must not wedge every later retry.
            self._close_conn()
            raise

    def _close_conn(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.close()
            except Exception:  # noqa: CC04 — best-effort close of a dead conn
                pass


def sink_from_env():
    """LEDGER_SINK=clickhouse|pg|none (+_URL) -> a sink instance or None."""
    kind = os.environ.get("LEDGER_SINK", "").lower()
    if kind in ("", "none", "0"):
        return None
    if kind == "clickhouse":
        url = (os.environ.get("LEDGER_CLICKHOUSE_URL")
               or os.environ.get("CLICKHOUSE_URL", "http://localhost:8123"))
        return ClickHouseDecisionSink(url)
    if kind in ("pg", "postgres"):
        url = (os.environ.get("LEDGER_PG_URL")
               or os.environ.get("DATABASE_URL", ""))
        if not url:
            raise ValueError("LEDGER_SINK=pg requires LEDGER_PG_URL/DATABASE_URL")
        return PgDecisionSink(url)
    raise ValueError(f"LEDGER_SINK={kind!r} not supported (clickhouse|pg|none)")


# ---------------------------------------------------------------------------
# The ledger


class DecisionLedger:
    """Durable WAL + async sink drain for DecisionRecords.

    ``append_columns`` is the only hot-path entry: it stores a columnar
    batch reference under a lock (O(1)) and returns. Everything else
    (record expansion, encode, write, fsync, sink delivery) happens on the
    writer and drainer threads. It never raises and never blocks: when the
    bounded queue is full or the filesystem is failing, batches are dropped
    and counted (``records_dropped``), the ``breaker`` records the failure,
    and scoring proceeds untouched. ``metrics``, a ``ServiceMetrics`` (or
    None), receives the ledger's counters and gauges.
    """

    def __init__(self, directory: str, *,
                 segment_bytes: int | None = None,
                 fsync_interval_ms: float | None = None,
                 queue_max_rows: int | None = None,
                 sink=None, sink_batch: int = 256,
                 sink_queue_max: int = 4096,
                 breaker=None, metrics=None):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.segment_bytes = segment_bytes or int(
            os.environ.get("LEDGER_SEGMENT_BYTES", str(8 << 20)))
        self.fsync_interval_s = (
            fsync_interval_ms if fsync_interval_ms is not None
            else float(os.environ.get("LEDGER_FSYNC_MS", "25"))) / 1000.0
        self.queue_max_rows = queue_max_rows or int(
            os.environ.get("LEDGER_QUEUE_MAX_ROWS", "65536"))
        self.sink = sink
        self.sink_batch = max(1, sink_batch)
        self._breaker = breaker
        self._metrics = metrics

        # One Condition guards ALL queue/segment/stat state; the open
        # file handle itself is owned by the writer thread exclusively
        # (never touched under the lock — file IO must not convoy the
        # O(1) hot-path append).
        self._cv = threading.Condition()
        self._pending: deque[_PendingBatch] = deque()
        self._pending_rows = 0
        self._writing = False  # writer mid-batch (flush must wait it out)
        self._stopping = False

        # Recently issued decision-batch prefixes (guarded by _cv): prefix ->
        # row count, bounded FIFO. This is what lets POST /debug/outcomes
        # answer "is this decision id one this process issued" without
        # scanning the WAL; unknown ids are still appended (the WAL may hold
        # decisions from before a restart) but counted apart.
        self._recent_prefixes: OrderedDict[str, int] = OrderedDict()
        self._recent_prefix_max = int(
            os.environ.get("LEDGER_RECENT_PREFIXES", "65536"))

        # Stats (guarded by _cv).
        self.records_appended = 0
        self.records_dropped = 0
        self.outcome_records = 0
        self.promotion_records = 0
        self.append_errors = 0
        self.fsync_count = 0
        self._fsync_ms: deque[float] = deque(maxlen=2048)
        # The writer's own time: wall seconds in _write_batches, and the
        # thread's CPU seconds there and in the expand-and-encode alone (a
        # thread waiting for the interpreter lock takes no CPU time).
        self.writer_busy_s = 0.0
        self.writer_cpu_s = 0.0
        self.encode_cpu_s = 0.0
        self.encoded_records = 0

        # Segment state (guarded by _cv): [seq, path, end_offset,
        # end_count] per segment; the last entry is the open one.
        self._segments: list[list] = []
        self._durable_count = 0
        self._file = None  # writer-thread-owned (plus init/close)
        self._open_tail_segment()

        # Sink hand-off: bounded deque of (count_index, seq, end_offset,
        # record); overflow (maxlen drop) spills to disk — the drainer
        # detects the gap against its cursor and catches up from the WAL.
        self._sink_q: deque = deque(maxlen=max(1, sink_queue_max))
        self._sink_cv = threading.Condition()
        self.sink_sent = 0
        self.sink_failures = 0
        self.spill_events = 0
        self.sink_queue_high_water = 0
        self._cursor = self._load_cursor()

        self._writer = threading.Thread(
            target=self._writer_loop, name="ledger-writer", daemon=True)
        self._writer.start()
        self._drainer = None
        if sink is not None:
            self._drainer = threading.Thread(
                target=self._drain_loop, name="ledger-sink", daemon=True)
            self._drainer.start()

    # -- segment management (writer thread / init only) ----------------------

    def _open_tail_segment(self) -> None:
        """Recover existing segments (truncating a torn tail on the last
        one) and open the newest for append; start fresh when empty.
        Runs at construction, before any other thread exists."""
        segments: list[list] = []
        count_base = 0
        for seq, path in ledger_segments(self.directory):
            valid_end, frames, torn = recover_segment(path)
            if torn:
                logger.warning(
                    "ledger segment %s torn at offset %d (%d valid frames)"
                    " — truncating", path, valid_end, frames)
                with open(path, "r+b") as f:
                    f.truncate(valid_end)
            segments.append([seq, path, max(valid_end, 0), count_base + frames])
            count_base += frames
        with self._cv:
            self._segments = segments
            self._durable_count = count_base
        if not segments:
            self._start_segment(0)
        else:
            seq, path, end, _cnt = segments[-1]
            if end < len(SEGMENT_MAGIC):
                # Fully-torn tail segment: rewrite it from scratch.
                self._start_segment(seq, path=path)
            else:
                self._file = open(path, "ab")

    def _start_segment(self, seq: int, path: str | None = None) -> None:
        """Open segment ``seq`` for append (file IO outside the lock —
        only the writer thread calls this)."""
        old = self._file
        if old is not None:
            old.close()
        path = path or os.path.join(self.directory, _segment_name(seq))
        f = open(path, "wb")
        f.write(SEGMENT_MAGIC)
        f.flush()
        os.fsync(f.fileno())
        self._file = f
        with self._cv:
            base = self._segments[-1][3] if self._segments else 0
            for s in self._segments:
                if s[0] == seq:
                    s[1], s[2] = path, len(SEGMENT_MAGIC)
                    break
            else:
                self._segments.append([seq, path, len(SEGMENT_MAGIC), base])

    # -- hot-path append ----------------------------------------------------

    def append_columns(self, batch: _PendingBatch) -> bool:
        """Enqueue one scored batch for durable append. O(1); never
        raises; returns False when the batch was dropped (queue full or
        ledger stopping)."""
        with self._cv:
            if self._stopping or self._pending_rows + batch.n > self.queue_max_rows:
                self.records_dropped += batch.n
                dropped = True
            else:
                self._pending.append(batch)
                self._pending_rows += batch.n
                prefix = getattr(batch, "prefix", None)
                if prefix:
                    self._note_prefix(prefix, batch.n)
                dropped = False
            self._cv.notify()
        if dropped and self._metrics is not None:
            self._metrics.ledger_dropped_total.inc(batch.n, reason="queue_full")
        return not dropped

    def _note_prefix(self, prefix: str, n: int) -> None:
        """Caller holds _cv. Bounded FIFO of issued batch prefixes."""
        self._recent_prefixes[prefix] = n
        self._recent_prefixes.move_to_end(prefix)
        while len(self._recent_prefixes) > self._recent_prefix_max:
            self._recent_prefixes.popitem(last=False)

    def knows_decision(self, decision_id: str) -> bool:
        """True when ``decision_id`` belongs to a batch this process
        issued recently (row index inside the batch's row count). False
        for foreign/mistyped ids AND for pre-restart ids — callers treat
        unknown as "join at risk", not "reject"."""
        prefix, _, row = decision_id.rpartition(".")
        with self._cv:
            if decision_id in self._recent_prefixes:
                return True
            n = self._recent_prefixes.get(prefix) if prefix else None
        if n is None:
            return False
        try:
            return 0 <= int(row) < n
        except ValueError:
            return False

    def append_record(self, record: DecisionRecord) -> bool:
        """Single-record convenience (tests / tools); same guarantees."""
        batch = _PendingBatch(
            prefix=record.decision_id, ts=record.ts_unix, n=1,
            score=np.array([record.score], np.int32),
            action=np.array([record.action], np.int32),
            reason_mask=np.array([record.reason_mask], np.int32),
            rule_score=np.array([record.rule_score], np.int32),
            ml_score=np.array([record.ml_score], np.float32),
            x=(record.features[None, :] if record.features is not None else None),
            bl=np.array([record.blacklisted], bool),
            account_ids=[record.account_id],
            amounts=[record.amount],
            tx_codes=[record.tx_type],
            tier_codes=np.array([TIER_CODES.get(record.tier, 0)], np.uint8),
            serving_state=record.serving_state, wire_mode=record.wire_mode,
            model_version=record.model_version, params_fp=record.params_fp,
            block_threshold=record.block_threshold,
            review_threshold=record.review_threshold,
            trace_id=record.trace_id)
        # A single prepacked record keeps its own decision id: mark the
        # prefix so to_records doesn't append a row suffix.
        batch.prefix = record.decision_id
        recs = batch.to_records()
        recs[0].decision_id = record.decision_id
        return self._append_ready(recs)

    def _append_ready(self, records: list[DecisionRecord]) -> bool:
        """Enqueue pre-built records (bypasses columnar expansion)."""
        class _Ready:
            def __init__(self, recs):
                self.n = len(recs)
                self._recs = recs

            def to_records(self):
                return self._recs

        ok = self.append_columns(_Ready(records))  # type: ignore[arg-type]
        if ok:
            # Pre-built DECISION records register their full ids for the
            # knows_decision check (outcome/promotion side-records carry
            # decision_id too but are not decisions — never registered).
            with self._cv:
                for rec in records:
                    if isinstance(rec, DecisionRecord) and rec.decision_id:
                        self._note_prefix(rec.decision_id, 1)
        return ok

    def append_outcome(self, record: OutcomeRecord) -> bool:
        """Label backfill (the v2 side-record): durably append a
        ground-truth outcome for an earlier decision. Same hot-path
        guarantees as decisions — O(1), never raises, drop-counted."""
        return self._append_ready([record])

    def append_promotion(self, record: PromotionRecord) -> bool:
        """Promotion/rollback event (the v3 side-record): the params
        transition the promotion controller just performed, with both
        fingerprints — replay joins decisions to the params that scored
        them across the boundary."""
        return self._append_ready([record])

    # -- writer thread ------------------------------------------------------

    def _writer_loop(self) -> None:
        hostprof.register_scoring_thread("ledger")
        last_fsync = time.monotonic()
        fsync_dirty = False
        while True:
            with self._cv:
                while not self._pending and not self._stopping:
                    # Fsync cadence doubles as the wait bound; waking with
                    # nothing pending just re-checks the dirty flag.
                    self._cv.wait(timeout=max(self.fsync_interval_s, 0.005))
                    if fsync_dirty and not self._pending:
                        break
                batches = list(self._pending)
                self._pending.clear()
                self._pending_rows = 0
                stopping = self._stopping
                self._writing = bool(batches)
            wrote = self._write_batches(batches)
            with self._cv:
                self._writing = False
            fsync_dirty = fsync_dirty or wrote
            now = time.monotonic()
            drained = False
            with self._cv:
                drained = not self._pending
            if fsync_dirty and (
                    now - last_fsync >= self.fsync_interval_s
                    or stopping or drained):
                self._do_fsync()
                last_fsync = time.monotonic()
                fsync_dirty = False
            if stopping:
                with self._cv:
                    if not self._pending:
                        return

    def _write_batches(self, batches: list) -> bool:
        if not batches:
            return False
        wrote_any = False
        wall0, cpu0 = time.perf_counter(), time.thread_time()
        encode_cpu, encoded = 0.0, 0
        for batch in batches:
            try:
                c0 = time.thread_time()
                records = batch.to_records()
                frames = []
                for rec in records:
                    payload = encode_entry(rec)
                    frames.append(_FRAME.pack(len(payload), zlib.crc32(payload))
                                  + payload)
                encode_cpu += time.thread_time() - c0
                encoded += len(records)
                chaos.fire("ledger.append")
                self._write_blob(frames, records)
                wrote_any = True
                if self._breaker is not None:
                    self._breaker.record_success()
                if self._metrics is not None:
                    self._metrics.ledger_records_total.inc(len(records))
            except Exception as exc:  # noqa: BLE001 — counted and fed to the breaker below
                with self._cv:
                    self.records_dropped += batch.n
                    self.append_errors += 1
                if self._breaker is not None:
                    self._breaker.record_failure(exc)
                if self._metrics is not None:
                    self._metrics.ledger_dropped_total.inc(batch.n, reason="write_error")
                logger.warning("ledger append failed (%d records dropped)",
                               batch.n, exc_info=True)
                # Brief jittered pause so an fs outage doesn't spin the
                # writer hot while scoring keeps enqueueing.
                time.sleep(0.02 * _jitter())
        with self._cv:
            self.writer_busy_s += time.perf_counter() - wall0
            self.writer_cpu_s += time.thread_time() - cpu0
            self.encode_cpu_s += encode_cpu
            self.encoded_records += encoded
        return wrote_any

    def _write_blob(self, frames: list[bytes],
                    records: list[DecisionRecord]) -> None:
        """Write one encoded batch (one frame per record); rotate first
        when the open segment would overflow. File IO runs OUTSIDE the
        stats lock."""
        blob_len = sum(len(fr) for fr in frames)
        with self._cv:
            seg = self._segments[-1]
            rotate = (seg[2] + blob_len > self.segment_bytes
                      and seg[2] > len(SEGMENT_MAGIC))
            next_seq = seg[0] + 1
        if rotate:
            self._do_fsync()
            self._start_segment(next_seq)
        f = self._file
        start = f.tell()
        f.write(b"".join(frames))
        f.flush()
        offset = f.tell()
        # Per-frame END offsets: the sink cursor is (seq, offset, count)
        # and a partially-consumed batch must leave the cursor INSIDE the
        # blob — a blob-end offset here once skipped frames when the
        # drainer fell back from memory to disk mid-blob.
        ends = []
        pos = start
        for fr in frames:
            pos += len(fr)
            ends.append(pos)
        with self._cv:
            seg = self._segments[-1]
            seg[2] = offset
            count0 = seg[3]
            seg[3] = count0 + len(records)
            self._durable_count = self._segments[-1][3]
            self.records_appended += len(records)
            for rec in records:
                if isinstance(rec, OutcomeRecord):
                    self.outcome_records += 1
                elif isinstance(rec, PromotionRecord):
                    self.promotion_records += 1
            seq = seg[0]
        if self.sink is not None:
            with self._sink_cv:
                for i, rec in enumerate(records):
                    self._sink_q.append((count0 + i, seq, ends[i], rec))
                lag = self._durable_count - self._cursor["count"]
                self.sink_queue_high_water = max(self.sink_queue_high_water, lag)
                self._sink_cv.notify()
            if self._metrics is not None:
                self._metrics.ledger_sink_queue_depth.set(lag)

    def _do_fsync(self) -> None:
        f = self._file
        if f is None:
            return
        t0 = time.monotonic()
        try:
            os.fsync(f.fileno())
        except OSError as exc:
            if self._breaker is not None:
                self._breaker.record_failure(exc)
            logger.warning("ledger fsync failed", exc_info=True)
            return
        ms = (time.monotonic() - t0) * 1000.0
        with self._cv:
            self.fsync_count += 1
            self._fsync_ms.append(ms)
        if self._metrics is not None:
            self._metrics.ledger_fsync_ms.observe(ms)

    # -- sink drainer -------------------------------------------------------

    def _load_cursor(self) -> dict:
        path = os.path.join(self.directory, "sink.cursor")
        try:
            with open(path) as f:
                cur = json.load(f)
            return {"seq": int(cur["seq"]), "offset": int(cur["offset"]),
                    "count": int(cur["count"])}
        except (OSError, ValueError, KeyError):
            # A missing or corrupt cursor is a cold start: drain from the WAL
            # head. Runs in __init__ only, before the drainer exists.
            return {"seq": self._segments[0][0] if self._segments else 0,
                    "offset": len(SEGMENT_MAGIC), "count": 0}

    def _persist_cursor(self) -> None:
        path = os.path.join(self.directory, "sink.cursor")
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(self._cursor, f)
            os.replace(tmp, path)
        except OSError:
            logger.warning("ledger sink cursor persist failed", exc_info=True)

    def _read_catchup(self, limit: int) -> tuple[list[DecisionRecord], dict]:
        """Read up to ``limit`` frames from the WAL at the cursor (the
        spill path). Returns (decision records, new_cursor) — side
        records (outcomes/promotions) advance the cursor but never ship
        to the decision sink."""
        cur = dict(self._cursor)
        out: list[DecisionRecord] = []
        scanned = 0
        with self._cv:
            segments = [tuple(s) for s in self._segments]
        for seq, path, end_offset, end_count in segments:
            if seq < cur["seq"] or scanned >= limit:
                continue
            start = cur["offset"] if seq == cur["seq"] else 0
            if start >= end_offset:
                continue
            for payload, frame_end in iter_segment_frames(path, start):
                if frame_end > end_offset:
                    break
                kind, rec = decode_entry(payload)
                if kind == "decision":
                    out.append(rec)
                scanned += 1
                cur = {"seq": seq, "offset": frame_end,
                       "count": cur["count"] + 1}
                if scanned >= limit:
                    break
        return out, cur

    def _drain_loop(self) -> None:
        hostprof.register_scoring_thread("ledger_sink")
        while True:
            if not self._drain_once():
                return

    def _drain_once(self) -> bool:
        """One sink-drain step; returns False when stopped AND drained.
        Failures never advance the cursor — the next step catches up from
        the WAL (at-least-once delivery, jittered bounded pauses)."""
        with self._cv:
            durable = self._durable_count
            stopping = self._stopping
        lag = durable - self._cursor["count"]
        if lag <= 0:
            if stopping:
                self._persist_cursor()
                return False
            with self._sink_cv:
                self._sink_cv.wait(timeout=0.05)
            return True
        if self._breaker is not None and not self._breaker.allow():
            time.sleep(0.05 * _jitter())
            return True
        batch, new_cursor, spilled = self._next_sink_batch()
        if not batch:
            if new_cursor["count"] > self._cursor["count"]:
                # A run of side records only: the cursor still advances
                # (nothing for the sink to send) or the drain livelocks
                # on a permanent non-zero lag.
                self._cursor = new_cursor
                self._persist_cursor()
            return True
        try:
            chaos.fire("ledger.sink")
            self.sink.send(batch)
        except Exception as exc:
            with self._sink_cv:
                self.sink_failures += 1
            if self._breaker is not None:
                self._breaker.record_failure(exc)
            logger.warning("ledger sink send failed (%d records, will "
                           "catch up from WAL)", len(batch), exc_info=True)
            time.sleep(0.1 * _jitter())
            return True
        if self._breaker is not None:
            self._breaker.record_success()
        self._cursor = new_cursor
        with self._sink_cv:
            self.sink_sent += len(batch)
            if spilled:
                self.spill_events += 1
        if self._metrics is not None:
            self._metrics.ledger_sink_sent_total.inc(len(batch))
            with self._cv:
                durable = self._durable_count
            self._metrics.ledger_sink_queue_depth.set(durable - self._cursor["count"])
        self._persist_cursor()
        return True

    def _next_sink_batch(self) -> tuple[list[DecisionRecord], dict, bool]:
        """Next contiguous batch for the sink: from the memory hand-off
        when its head matches the cursor, else from the WAL (a spill —
        the queue overflowed or a send failed and dropped entries)."""
        need = self._cursor["count"]
        with self._sink_cv:
            while self._sink_q and self._sink_q[0][0] < need:
                self._sink_q.popleft()  # already delivered (stale)
            head_matches = bool(self._sink_q) and self._sink_q[0][0] == need
            if head_matches:
                batch: list[DecisionRecord] = []
                cur = dict(self._cursor)
                taken = 0
                while (self._sink_q and taken < self.sink_batch
                       and self._sink_q[0][0] == cur["count"]):
                    cnt, seq, end_offset, rec = self._sink_q.popleft()
                    # Side records advance the cursor but never ship to
                    # the decision sink (their table is the WAL itself).
                    if isinstance(rec, DecisionRecord):
                        batch.append(rec)
                    taken += 1
                    cur = {"seq": seq, "offset": end_offset, "count": cnt + 1}
                return batch, cur, False
        records, cur = self._read_catchup(self.sink_batch)
        return records, cur, True

    # -- stats / lifecycle ---------------------------------------------------

    def bind_metrics(self, metrics) -> None:
        self._metrics = metrics

    def _fsync_p99_ms(self) -> float | None:
        with self._cv:
            vals = sorted(self._fsync_ms)
        if not vals:
            return None
        return round(vals[min(len(vals) - 1, int(0.99 * len(vals)))], 3)

    def stats(self) -> dict:
        with self._cv:
            segs = [tuple(s) for s in self._segments]
            stats = {
                "records_appended": self.records_appended,
                "records_dropped": self.records_dropped,
                "outcome_records": self.outcome_records,
                "promotion_records": self.promotion_records,
                "append_errors": self.append_errors,
                "queue_rows": self._pending_rows,
                "fsync_count": self.fsync_count,
                "durable_records": self._durable_count,
                "segments": len(segs),
                "current_segment": segs[-1][1] if segs else None,
                "wal_bytes": sum(s[2] for s in segs),
                "writer_busy_s": self.writer_busy_s,
                "writer_cpu_s": self.writer_cpu_s,
                "encode_cpu_s": self.encode_cpu_s,
                "encoded_records": self.encoded_records,
            }
        stats["fsync_p99_ms"] = self._fsync_p99_ms()
        with self._sink_cv:
            stats["sink"] = {
                "enabled": self.sink is not None,
                "sent": self.sink_sent,
                "failures": self.sink_failures,
                "spill_events": self.spill_events,
                "queue_high_water": self.sink_queue_high_water,
                "lag": stats["durable_records"] - self._cursor["count"],
                "cursor": dict(self._cursor),
            }
        return stats

    def stats_block(self) -> dict:
        """The ``ledger_block`` artifact shape of the JAX package's benches."""
        s = self.stats()
        return {
            "records_appended": s["records_appended"],
            "records_dropped": s["records_dropped"],
            "fsync_p99_ms": s["fsync_p99_ms"],
            "spill_events": s["sink"]["spill_events"],
            "sink_queue_high_water": s["sink"]["queue_high_water"],
            "sink_sent": s["sink"]["sent"],
            "wal_bytes": s["wal_bytes"],
            "segments": s["segments"],
        }

    def flush(self, timeout: float = 10.0) -> bool:
        """Wait until everything enqueued so far is durable (tests /
        shutdown). Returns False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cv:
                drained = (not self._pending and not self._writing
                           and self._durable_count >= self.records_appended)
                self._cv.notify()
            if drained:
                return True
            time.sleep(0.005)
        return False

    def drain_sink(self, timeout: float = 10.0) -> bool:
        """Wait until the sink cursor catches the durable tail."""
        if self.sink is None:
            return True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cv:
                durable = self._durable_count
            if self._cursor["count"] >= durable:
                return True
            time.sleep(0.01)
        return False

    def close(self, drain_timeout: float | None = None) -> None:
        """Flush the WAL, give the sink a bounded window to catch up,
        persist the cursor, stop the threads."""
        if drain_timeout is None:
            drain_timeout = float(os.environ.get("LEDGER_CLOSE_TIMEOUT_S", "5"))
        with self._cv:
            if self._stopping:
                return
            self._stopping = True
            self._cv.notify_all()
        self._writer.join(timeout=max(drain_timeout, 1.0) + 5.0)
        if self._drainer is not None:
            self.drain_sink(timeout=drain_timeout)
            with self._sink_cv:
                self._sink_cv.notify_all()
            self._drainer.join(timeout=5.0)
            self._persist_cursor()
        # The writer thread has exited: the file handle is ours now.
        f, self._file = self._file, None
        if f is not None:
            try:
                f.flush()
                os.fsync(f.fileno())
                f.close()
            except OSError:
                logger.warning("ledger close fsync failed", exc_info=True)


# ---------------------------------------------------------------------------
# Process-global wiring + the single record-construction seam


_STATE_PROVIDER: Callable[[], str] | None = None


def set_state_provider(fn: Callable[[], str] | None) -> None:
    """Serving-state source for records (the supervisor's ``state`` once it
    is ported); records read it at score time so a degraded window is
    visible on every decision it produced. Unset: ``"unknown"``."""
    global _STATE_PROVIDER
    _STATE_PROVIDER = fn


def serving_state() -> str:
    fn = _STATE_PROVIDER
    if fn is None:
        return "unknown"
    try:
        return fn()
    except Exception:  # noqa: BLE001 — state annotation must not fail scoring
        return "unknown"


def note_decisions(
    engine,
    out: dict,
    *,
    n: int,
    wire_mode: str,
    tier: str | None = None,
    x: np.ndarray | None = None,
    bl: np.ndarray | None = None,
    account_ids=None,
    amounts=None,
    tx_codes=None,
    model_version: str | None = None,
    params_fp: str | None = None,
    thresholds: tuple[int, int] | None = None,
    mark_root: bool = True,
    ts: float | None = None,
    session_lens=None,
    session_seqs=None,
    session_hashes=None,
) -> str | None:
    """The DecisionRecord construction seam: every scoring path funnels its
    results through here, as host numpy after the step's readback. O(1) on
    the hot path (columnar references handed to the writer thread). Returns
    the batch decision-id prefix (row i is ``<prefix>.<i>``), or None when no
    ledger is bound. Never raises.

    Callers pass the params fingerprint and the (block, review) thresholds
    captured at dispatch (``engine.params_snapshot``,
    ``engine.thresholds_snapshot``): a hot swap or an ``UpdateThresholds``
    can land between the step and this seam, and the values after it would
    be ones replay catches as unreplayable. Without ``thresholds`` the
    engine's current pair is noted, as the JAX package does. A record
    carries the active span's trace id, and with ``mark_root`` the batch's
    decision-id prefix lands on the trace's root span (the flight entry's
    join key).

    A bound shadow scorer (``engine.shadow``) is handed compiled-tier rows
    at the launch seam; this seam only counts a heuristic tier's rows as
    skipped, since they come from another scorer than the one a candidate
    would replace."""
    shadow = getattr(engine, "shadow", None)
    if shadow is not None and n > 0 and tier == "heuristic":
        shadow.note_skipped(n)
    ledger = getattr(engine, "ledger", None)
    if ledger is None or n <= 0:
        return None
    try:
        from igaming_platform_tpu_torch.obs import tracing

        prefix = next_batch_prefix()
        span = tracing.current_span()
        block_thr, review_thr = (thresholds if thresholds is not None
                                 else engine.get_thresholds())
        # The port has no host-CPU tier: a compiled batch ran on the device.
        tier_codes = np.full((n,), TIER_CODES.get(tier or "device", 0), np.uint8)
        # Session-scored chunks pass the timestamp the session plane used for
        # the inter-event gap, so replay re-derives every gap from recorded
        # values alone; stateless paths stamp the note time.
        batch = _PendingBatch(
            prefix=prefix,
            ts=ts if ts is not None else wall_clock(),
            n=n,
            score=out["score"],
            action=out["action"],
            reason_mask=out["reason_mask"],
            rule_score=out["rule_score"],
            ml_score=out["ml_score"],
            x=x, bl=bl,
            account_ids=list(account_ids) if account_ids is not None else None,
            amounts=amounts, tx_codes=tx_codes,
            tier_codes=tier_codes,
            serving_state=serving_state(),
            wire_mode=wire_mode,
            model_version=model_version or getattr(engine, "ml_backend", "unknown"),
            params_fp=params_fp or getattr(engine, "params_fingerprint", "0" * 16),
            block_threshold=block_thr, review_threshold=review_thr,
            trace_id=span.trace_id if span is not None else "",
            session_lens=session_lens, session_seqs=session_seqs,
            session_hashes=session_hashes,
        )
        ledger.append_columns(batch)
        if mark_root and span is not None:
            # The flight recorder's join key: a trace, a flight entry and a
            # ledger record share one id.
            tracing.set_root_attribute("decision_id", prefix)
        return prefix
    except Exception:  # noqa: BLE001 — the ledger must never fail scoring; drops are counted by the ledger itself
        logger.warning("ledger note_decisions failed", exc_info=True)
        return None
