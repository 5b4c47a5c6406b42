"""Native wire encoding for the serving front.

The port's counterpart of ``igaming_platform_tpu/serve/wire.py`` in row
mode. ``encode_score_batch`` serializes a whole risk.v1 ScoreBatchResponse
from the result arrays in one C++ call (``native/wire_codec.cpp``, built by
``serve/_native_build.py``), with no per-row Python object. Its bytes equal
the Python protobuf serializer's for the same rows.

``RawProtoMessage`` lets a handler return pre-serialized bytes through the
``SerializeToString`` seam. A codec that does not build raises: the port
has no per-row protobuf encoder to fall back to.

The index frames (``IDX1``) of the cached path are here too:
``encode_index_batch`` and ``decode_index_batch``, byte for byte the JAX
package's format, and ``TX_TYPE_CODES``, the wire's transaction-type codes,
which the native store reads as well.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from igaming_platform_tpu_torch.core.enums import REASON_BIT_ORDER
from igaming_platform_tpu_torch.serve import _native_build

# Reason-code string table in bit order, concatenated + offsets: the C
# encoder expands the in-graph bitmask to repeated string fields directly.
_REASONS_BUF = b"".join(code.value.encode() for code in REASON_BIT_ORDER)
_REASONS_OFF = np.zeros((len(REASON_BIT_ORDER) + 1,), dtype=np.int32)
np.cumsum([len(code.value.encode()) for code in REASON_BIT_ORDER], out=_REASONS_OFF[1:])

_lib = None

# Wire transaction-type codes: deposit=0 withdraw=1 bet=2 win=3, anything
# else 4 ("other"). The index frames, the native store's C calls and the
# session event codec all use these.
TX_TYPE_CODES = {"deposit": 0, "withdraw": 1, "bet": 2, "win": 3}
TX_TYPE_NAMES = ("deposit", "withdraw", "bet", "win", "")


def _library():
    """The bound codec, built on first use; raises if it does not build."""
    global _lib
    if _lib is None:
        lib = _native_build.load("wire_codec")
        lib.encode_score_batch.restype = ctypes.c_int64
        lib.encode_score_batch.argtypes = [
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),  # score
            ctypes.POINTER(ctypes.c_int32),  # action
            ctypes.POINTER(ctypes.c_int32),  # reason_mask
            ctypes.POINTER(ctypes.c_int32),  # rule_score
            ctypes.POINTER(ctypes.c_float),  # ml_score
            ctypes.POINTER(ctypes.c_int64),  # rtms
            ctypes.c_void_p,                 # features (nullable)
            ctypes.c_char_p,                 # reasons_buf
            ctypes.POINTER(ctypes.c_int32),  # reasons_off
            ctypes.c_int32,                  # n_reasons
            ctypes.POINTER(ctypes.c_uint8),  # out
            ctypes.c_int64,                  # out_cap
        ]
        _lib = lib
    return _lib


class RawProtoMessage:
    """Pre-serialized proto bytes behind the SerializeToString seam."""

    __slots__ = ("_payload",)

    def __init__(self, payload: bytes):
        self._payload = payload

    def SerializeToString(self, deterministic: bool = False) -> bytes:  # noqa: N802
        return self._payload


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def encode_score_batch(
    score: np.ndarray,
    action: np.ndarray,
    reason_mask: np.ndarray,
    rule_score: np.ndarray,
    ml_score: np.ndarray,
    response_time_ms: np.ndarray,
    features: np.ndarray | None,
) -> bytes:
    """Serialize a ScoreBatchResponse from result arrays (one C call).

    ``features`` is the raw [N, 30] gather matrix (its first 26 columns are
    the wire FeatureVector) or None to omit the echo.
    """
    lib = _library()
    n = int(score.shape[0])
    score, action, reason_mask, rule_score = (
        np.ascontiguousarray(a, dtype=np.int32) for a in (score, action, reason_mask, rule_score))
    ml_score = np.ascontiguousarray(ml_score, dtype=np.float32)
    rtms = np.ascontiguousarray(response_time_ms, dtype=np.int64)
    if features is not None:
        features = np.ascontiguousarray(features, dtype=np.float32)
        feat_ptr = features.ctypes.data_as(ctypes.c_void_p)
    else:
        feat_ptr = ctypes.c_void_p(0)

    def encode(cap: int) -> tuple[int, ctypes.Array]:
        buf = ctypes.create_string_buffer(cap)
        written = lib.encode_score_batch(
            n, _i32(score), _i32(action), _i32(reason_mask), _i32(rule_score),
            ml_score.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            rtms.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            feat_ptr, _REASONS_BUF, _i32(_REASONS_OFF), len(REASON_BIT_ORDER),
            ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), cap,
        )
        return written, buf

    # A generous first estimate; the codec returns -(bytes needed) when it
    # is short, and the second call gets exactly that.
    written, buf = encode(64 * n + 256 * (features is not None) * n + 1024)
    if written < 0:
        written, buf = encode(-written)
    if written < 0:
        raise RuntimeError("wire codec sizing failed")
    return buf.raw[:written]


# ---------------------------------------------------------------------------
# Index-mode ScoreBatch frames (the device-resident feature cache)
# ---------------------------------------------------------------------------
#
# A compact columnar alternative to the risk.v1 ScoreBatchRequest proto,
# carried through the same raw-bytes ScoreBatch seam: a 4-byte magic tells
# the frame from a proto, whose first byte is always the field-1 tag 0x0A.
# The server resolves account ids against the device-resident feature
# table and ships only int32 slot indices and the per-transaction context
# to the device. The response stays a risk.v1 ScoreBatchResponse, without
# the feature echo (the rows never exist on the host).
#
# Layout (little-endian):
#   b"IDX1" | u32 n
#   i64 amounts[n]
#   u8  tx_type_codes[n]       (deposit=0 withdraw=1 bet=2 win=3 other=4)
#   4 string columns - account_id, ip, device_id, fingerprint - each:
#     u8 present; if present: u32 offs[n+1] (cumulative) | blob bytes

INDEX_WIRE_MAGIC = b"IDX1"


def _encode_str_column(values, n: int) -> bytes:
    if values is None:
        return b"\x00"
    if len(values) != n:
        raise ValueError(f"column length {len(values)} != {n} rows")
    encoded = [v.encode() if isinstance(v, str) else bytes(v) for v in values]
    offs = np.zeros((n + 1,), dtype=np.uint32)
    np.cumsum([len(e) for e in encoded], out=offs[1:])
    return b"\x01" + offs.tobytes() + b"".join(encoded)


def encode_index_batch(account_ids, amounts, tx_types, ips=None, devices=None,
                       fingerprints=None) -> bytes:
    """Serialize an index-mode ScoreBatch frame (the client side)."""
    n = len(account_ids)
    amounts_arr = np.ascontiguousarray(amounts, dtype=np.int64)
    if amounts_arr.shape != (n,):
        raise ValueError(f"amounts shape {amounts_arr.shape} != ({n},)")
    codes = np.fromiter((TX_TYPE_CODES.get(t, 4) for t in tx_types), np.uint8, n)
    return b"".join([
        INDEX_WIRE_MAGIC, struct.pack("<I", n), amounts_arr.tobytes(), codes.tobytes(),
        _encode_str_column(account_ids, n), _encode_str_column(ips, n),
        _encode_str_column(devices, n), _encode_str_column(fingerprints, n),
    ])


def _decode_str_column(payload: memoryview, pos: int, n: int):
    if pos + 1 > len(payload):
        raise ValueError("index frame truncated (column flag)")
    present = payload[pos]
    pos += 1
    if present == 0:
        return None, pos
    if present != 1:
        raise ValueError(f"bad column flag {present}")
    end_offs = pos + 4 * (n + 1)
    if end_offs > len(payload):
        raise ValueError("index frame truncated (offsets)")
    offs = np.frombuffer(payload[pos:end_offs], dtype=np.uint32)
    if n and (np.diff(offs.astype(np.int64)) < 0).any():
        raise ValueError("index frame offsets not monotonic")
    blob_len = int(offs[-1])
    pos = end_offs
    if pos + blob_len > len(payload):
        raise ValueError("index frame truncated (blob)")
    blob = payload[pos:pos + blob_len]
    return [bytes(blob[offs[i]:offs[i + 1]]) for i in range(n)], pos + blob_len


def decode_index_batch(payload: bytes):
    """Parse an index-mode frame -> (account_ids: list[bytes], amounts
    i64[n], tx_type_codes u8[n], ips, devices, fingerprints), the last three
    list[bytes] or None. Raises ValueError on a malformed frame."""
    mv = memoryview(payload)
    if len(mv) < 8 or bytes(mv[:4]) != INDEX_WIRE_MAGIC:
        raise ValueError("not an index-mode frame")
    (n,) = struct.unpack_from("<I", payload, 4)
    pos = 8
    end = pos + 8 * n
    if end + n > len(mv):
        raise ValueError("index frame truncated (numeric columns)")
    amounts = np.frombuffer(mv[pos:end], dtype=np.int64)
    codes = np.frombuffer(mv[end:end + n], dtype=np.uint8)
    pos = end + n
    ids, pos = _decode_str_column(mv, pos, n)
    if ids is None:
        raise ValueError("index frame missing account_id column")
    ips, pos = _decode_str_column(mv, pos, n)
    devices, pos = _decode_str_column(mv, pos, n)
    fingerprints, pos = _decode_str_column(mv, pos, n)
    return ids, amounts, codes, ips, devices, fingerprints
