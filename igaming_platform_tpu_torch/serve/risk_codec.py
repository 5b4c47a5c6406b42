"""A hand proto3 codec for the risk.v1 messages the serving front answers.

The port's counterpart of the generated ``risk_pb2`` module of the JAX
package (``proto/risk/v1/risk.proto``), without protobuf: the card's
machine has none; ``TIMESTAMP`` is ``google.protobuf.Timestamp``. A
message is a dict keyed by field name. ``decode``
fills every field with its proto3 default (``""``, ``0``, ``False``,
``0.0``, ``[]``, or ``None`` for an absent sub-message) and skips unknown
fields and the ``metadata`` map, as the server ignores it. ``encode``
writes fields in number order and skips defaults, as protobuf does: a
float is written when its bits are not zero (so ``-0.0`` is), a
sub-message whenever it is not ``None`` (an empty one as a zero length).
Integers are two's complement varints (no zig-zag), floats fixed32,
strings UTF-8.

``encode_score_response`` writes one ScoreTransactionResponse through the
native batch encoder (``serve/wire.py``), so the single and the batch
answers share one encoder.
"""

from __future__ import annotations

import struct

import numpy as np

STRING, INT32, INT64, BOOL, FLOAT, ENUM, MESSAGE, MAP = range(8)
_WIRE_TYPE = {STRING: 2, INT32: 0, INT64: 0, BOOL: 0, FLOAT: 5, ENUM: 0, MESSAGE: 2, MAP: 2}
_DEFAULTS = {STRING: "", INT32: 0, INT64: 0, BOOL: False, FLOAT: 0.0, ENUM: 0}


def _field(number: int, name: str, kind: int, sub=None, repeated: bool = False) -> tuple:
    return (number, name, kind, sub, repeated)


def _fields(*specs) -> tuple:
    """A message schema: (number, name, kind, sub-schema or None, repeated)
    per field, in number order."""
    return tuple(_field(*s) for s in specs)


TIMESTAMP = _fields((1, "seconds", INT64), (2, "nanos", INT32))
FEATURE_VECTOR = _fields(
    (1, "tx_count_1m", INT32), (2, "tx_count_5m", INT32), (3, "tx_count_1h", INT32),
    (4, "tx_sum_1h", INT64), (5, "tx_avg_1h", FLOAT), (6, "unique_devices_24h", INT32),
    (7, "unique_ips_24h", INT32), (8, "ip_country_changes_7d", INT32),
    (9, "device_age_days", INT32), (10, "account_age_days", INT32),
    (11, "total_deposits", INT64), (12, "total_withdrawals", INT64),
    (13, "net_deposit", INT64), (14, "deposit_count", INT32), (15, "withdraw_count", INT32),
    (16, "time_since_last_tx_sec", INT32), (17, "session_duration_sec", INT32),
    (18, "avg_bet_size", FLOAT), (19, "win_rate", FLOAT), (20, "is_vpn", BOOL),
    (21, "is_proxy", BOOL), (22, "is_tor", BOOL), (23, "disposable_email", BOOL),
    (24, "bonus_claim_count", INT32), (25, "bonus_wager_completion_rate", FLOAT),
    (26, "bonus_only_player", BOOL),
)
_MAP_ENTRY = _fields((1, "key", STRING), (2, "value", STRING))
SCORE_TRANSACTION_REQUEST = _fields(
    (1, "account_id", STRING), (2, "player_id", STRING), (3, "amount", INT64),
    (4, "transaction_type", STRING), (5, "currency", STRING), (6, "game_id", STRING),
    (7, "round_id", STRING), (8, "ip_address", STRING), (9, "device_id", STRING),
    (10, "fingerprint", STRING), (11, "user_agent", STRING), (12, "session_id", STRING),
    (13, "metadata", MAP, _MAP_ENTRY),
)
SCORE_TRANSACTION_RESPONSE = _fields(
    (1, "score", INT32), (2, "action", ENUM), (3, "reason_codes", STRING, None, True),
    (4, "rule_score", INT32), (5, "ml_score", FLOAT), (6, "response_time_ms", INT64),
    (7, "features", MESSAGE, FEATURE_VECTOR),
)
SCORE_BATCH_REQUEST = _fields((1, "transactions", MESSAGE, SCORE_TRANSACTION_REQUEST, True))
SCORE_BATCH_RESPONSE = _fields((1, "results", MESSAGE, SCORE_TRANSACTION_RESPONSE, True))
CHECK_BONUS_ABUSE_REQUEST = _fields((1, "account_id", STRING), (2, "bonus_id", STRING))
CHECK_BONUS_ABUSE_RESPONSE = _fields(
    (1, "is_abuser", BOOL), (2, "abuse_score", FLOAT), (3, "signals", STRING, None, True),
    (4, "linked_accounts", STRING, None, True),
)
ADD_TO_BLACKLIST_REQUEST = _fields(
    (1, "type", STRING), (2, "value", STRING), (3, "reason", STRING), (4, "created_by", STRING),
    (5, "expires_at", MESSAGE, TIMESTAMP),
)
ADD_TO_BLACKLIST_RESPONSE = _fields((1, "success", BOOL), (2, "id", STRING))
CHECK_BLACKLIST_REQUEST = _fields(
    (1, "device_id", STRING), (2, "fingerprint", STRING), (3, "ip_address", STRING),
    (4, "email", STRING),
)
BLACKLIST_MATCH = _fields(
    (1, "type", STRING), (2, "value", STRING), (3, "reason", STRING),
    (4, "created_at", MESSAGE, TIMESTAMP),
)
CHECK_BLACKLIST_RESPONSE = _fields(
    (1, "is_blacklisted", BOOL), (2, "matches", MESSAGE, BLACKLIST_MATCH, True))
GET_FEATURES_REQUEST = _fields((1, "account_id", STRING))
GET_FEATURES_RESPONSE = _fields(
    (1, "account_id", STRING), (2, "features", MESSAGE, FEATURE_VECTOR),
    (3, "computed_at", MESSAGE, TIMESTAMP),
)
UPDATE_THRESHOLDS_REQUEST = _fields((1, "block_threshold", INT32), (2, "review_threshold", INT32))
UPDATE_THRESHOLDS_RESPONSE = _fields(
    (1, "success", BOOL), (2, "block_threshold", INT32), (3, "review_threshold", INT32))
GET_THRESHOLDS_REQUEST = _fields()
GET_THRESHOLDS_RESPONSE = _fields((1, "block_threshold", INT32), (2, "review_threshold", INT32))
# risk.v1 Segment: the codes of models/ltv.py's SEG_* constants.
SEGMENT = {"SEGMENT_UNSPECIFIED": 0, "SEGMENT_VIP": 1, "SEGMENT_HIGH": 2, "SEGMENT_MEDIUM": 3,
           "SEGMENT_LOW": 4, "SEGMENT_CHURNING": 5}
PREDICT_LTV_REQUEST = _fields((1, "account_id", STRING))
PREDICT_LTV_RESPONSE = _fields(
    (1, "account_id", STRING), (2, "predicted_ltv", FLOAT), (3, "segment", ENUM),
    (4, "churn_risk", FLOAT), (5, "predicted_active_days", INT32), (6, "confidence", FLOAT),
    (7, "next_best_action", STRING), (8, "predicted_at", MESSAGE, TIMESTAMP),
)
GET_PLAYER_SEGMENT_REQUEST = _fields((1, "account_id", STRING))
GET_PLAYER_SEGMENT_RESPONSE = _fields(
    (1, "account_id", STRING), (2, "segment", ENUM), (3, "ltv", FLOAT), (4, "churn_risk", FLOAT),
    (5, "recommended_actions", STRING, None, True),
)
# grpc.health.v1: HealthCheckRequest, HealthCheckResponse (status 1 = SERVING,
# 2 = NOT_SERVING).
HEALTH_CHECK_REQUEST = _fields((1, "service", STRING))
HEALTH_CHECK_RESPONSE = _fields((1, "status", ENUM))


# -- encode ------------------------------------------------------------------


def _varint(v: int) -> bytes:
    v &= 0xFFFFFFFFFFFFFFFF  # negative -> 10-byte two's complement
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _delimited(tag: bytes, payload: bytes) -> bytes:
    return tag + _varint(len(payload)) + payload


def encode(schema, msg: dict) -> bytes:
    """Serialize ``msg`` (a dict by field name; missing names are defaults)."""
    out = []
    for number, name, kind, sub, repeated in schema:
        value = msg.get(name)
        if value is None:
            continue
        tag = _varint((number << 3) | _WIRE_TYPE[kind])
        if kind == MAP:
            for k, v in value.items():
                out.append(_delimited(tag, _map_entry(k, v)))
            continue
        for v in (value if repeated else (value,)):
            if kind == MESSAGE:
                out.append(_delimited(tag, encode(sub, v)))
            elif kind == STRING:
                if v or repeated:
                    out.append(_delimited(tag, v.encode()))
            elif kind == FLOAT:
                bits = struct.pack("<f", v)
                if bits != b"\x00\x00\x00\x00" or repeated:
                    out.append(tag + bits)
            elif v or repeated:  # varint kinds
                out.append(tag + _varint(int(v)))
    return b"".join(out)


def _map_entry(key: str, value: str) -> bytes:
    """A map<string, string> entry: key and value are always written."""
    return _delimited(b"\x0a", key.encode()) + _delimited(b"\x12", value.encode())


# -- decode ------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int, end: int) -> tuple[int, int]:
    result = shift = 0
    while pos < end and shift < 64:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
    raise ValueError("truncated or overlong varint")


def _skip(buf: bytes, pos: int, end: int, wire_type: int) -> int:
    if wire_type == 0:
        return _read_varint(buf, pos, end)[1]
    if wire_type == 1:
        pos += 8
    elif wire_type == 2:
        n, pos = _read_varint(buf, pos, end)
        pos += n
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    if pos > end:
        raise ValueError("truncated field")
    return pos


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


_BY_NUMBER: dict[int, dict] = {}


def _index(schema) -> dict:
    idx = _BY_NUMBER.get(id(schema))
    if idx is None:
        idx = _BY_NUMBER[id(schema)] = {f[0]: f for f in schema}
    return idx


def decode(schema, buf: bytes, pos: int = 0, end: int | None = None) -> dict:
    """Parse proto3 bytes into a dict with every field of ``schema``.
    Raises ValueError on malformed input."""
    end = len(buf) if end is None else end
    by_number = _index(schema)
    msg = {name: ([] if rep else None if kind == MESSAGE else _DEFAULTS.get(kind))
           for _, name, kind, _, rep in schema if kind != MAP}
    parts: dict[tuple, list[tuple[int, int]]] = {}  # a repeated singular sub-message merges
    while pos < end:
        tag, pos = _read_varint(buf, pos, end)
        number, wire_type = tag >> 3, tag & 7
        field = by_number.get(number)
        if field is None or field[2] == MAP or _WIRE_TYPE[field[2]] != wire_type:
            pos = _skip(buf, pos, end, wire_type)
            continue
        _, name, kind, sub, repeated = field
        if wire_type == 2:
            n, pos = _read_varint(buf, pos, end)
            if pos + n > end:
                raise ValueError("truncated length-delimited field")
            if kind == STRING:
                try:
                    value = buf[pos:pos + n].decode()
                except UnicodeDecodeError as exc:
                    raise ValueError(f"field {name}: invalid UTF-8") from exc
            elif repeated:
                value = decode(sub, buf, pos, pos + n)
            else:
                parts.setdefault(field, []).append((pos, pos + n))
                pos += n
                continue
            pos += n
        elif wire_type == 5:
            if pos + 4 > end:
                raise ValueError("truncated fixed32 field")
            value = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        else:
            raw, pos = _read_varint(buf, pos, end)
            value = (raw != 0 if kind == BOOL else _signed(raw, 64) if kind == INT64
                     else _signed(raw, 32))
        if repeated:
            msg[name].append(value)
        else:
            msg[name] = value
    for (_, name, _, sub, _), spans in parts.items():
        msg[name] = decode(sub, b"".join(buf[a:b] for a, b in spans))
    return msg


# -- the single score response through the native batch encoder ----------------


def encode_score_response(score: int, action: int, reason_mask: int, rule_score: int,
                          ml_score: float, response_time_ms: int, features: np.ndarray) -> bytes:
    """One ScoreTransactionResponse from one row of results and its [30]
    feature row: the native ScoreBatchResponse encoder at n = 1, less the
    outer ``results`` tag and length. A ``-0.0`` ml_score, which the batch
    encoder skips as a default and protobuf writes, is written in place of
    a stand-in of the same width."""
    from igaming_platform_tpu_torch.serve.wire import encode_score_batch

    ml = np.float32(ml_score)
    negative_zero = ml == 0 and np.signbit(ml)
    stand_in = np.array([0x80000001], np.uint32).view(np.float32)  # nonzero, 4 bytes wide

    def one(ml_value, rtms, feats):
        batch = encode_score_batch(
            np.array([score]), np.array([action]), np.array([reason_mask]),
            np.array([rule_score]), np.array([ml_value], np.float32),
            np.array([rtms], np.int64), feats)
        _, pos = _read_varint(batch, 1, len(batch))  # the results tag is one byte
        return batch[pos:]

    row = np.asarray(features, np.float32).reshape(1, -1)
    if not negative_zero:
        return one(ml, response_time_ms, row)
    body = bytearray(one(stand_in[0], response_time_ms, row))
    at = len(one(0.0, 0, None)) + 1  # fields 1-4, then field 5's tag
    body[at:at + 4] = struct.pack("<f", -0.0)
    return bytes(body)
