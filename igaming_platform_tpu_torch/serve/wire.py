"""Native wire encoding for the serving front.

The port's counterpart of ``igaming_platform_tpu/serve/wire.py`` in row
mode. ``encode_score_batch`` serializes a whole risk.v1 ScoreBatchResponse
from the result arrays in one C++ call (``native/wire_codec.cpp``, built by
``serve/_native_build.py``), with no per-row Python object. Its bytes equal
the Python protobuf serializer's for the same rows.

``RawProtoMessage`` lets a handler return pre-serialized bytes through the
``SerializeToString`` seam. A codec that does not build raises: the port
has no per-row protobuf encoder to fall back to. The index frames of the
cached path are not ported yet.
"""

from __future__ import annotations

import ctypes

import numpy as np

from igaming_platform_tpu_torch.core.enums import REASON_BIT_ORDER
from igaming_platform_tpu_torch.serve import _native_build

# Reason-code string table in bit order, concatenated + offsets: the C
# encoder expands the in-graph bitmask to repeated string fields directly.
_REASONS_BUF = b"".join(code.value.encode() for code in REASON_BIT_ORDER)
_REASONS_OFF = np.zeros((len(REASON_BIT_ORDER) + 1,), dtype=np.int32)
np.cumsum([len(code.value.encode()) for code in REASON_BIT_ORDER], out=_REASONS_OFF[1:])

_lib = None


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
