"""Port parity: serve/wire.py (the native response encoder and the
index-mode frames) and serve/risk_codec.py (the port's hand risk.v1 codec).

``encode_score_batch`` must give the JAX package's bytes on the same seeded
arrays, with and without the feature echo, at 0, 1 and 4097 rows. Every
message of the slice, built from a seed with numpy plus edge cases (empty
strings, negative int64 amounts, ml_score 0.0 and -0.0, non-ASCII ids),
must encode to the bytes of the JAX package's generated ``risk_pb2``, and
decode from them (unknown fields appended) to the same fields. Index-mode
frames (``IDX1``) encode to the JAX codec's bytes and decode to what it
decodes; malformed ones raise in both.
"""

import struct

import numpy as np
import pytest

from igaming_platform_tpu.proto_gen.risk.v1 import risk_pb2
from igaming_platform_tpu.serve import wire as jax_wire
from igaming_platform_tpu_torch.serve import risk_codec as codec
from igaming_platform_tpu_torch.serve import wire

# Unknown fields a newer client may send: varint 100, bytes 101, fixed64 102, fixed32 103.
UNKNOWN = b"\xa0\x06\x07" + b"\xaa\x06\x02hi" + b"\xb1\x06" + bytes(8) + b"\xbd\x06" + bytes(4)
STRINGS = ("", "acct-42", "ünïcødé-账户", "x" * 300)


def _result_arrays(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 30)).astype(np.float32) * 1000
    x[:, [19, 20, 21, 22, 25]] = rng.random((n, 5)) < 0.3  # the bool features: 0 or 1
    x[rng.random((n, 30)) < 0.3] = 0.0
    ml = rng.random(n).astype(np.float32)
    ml[:: 7] = 0.0
    return (rng.integers(0, 101, n), rng.integers(1, 4, n), rng.integers(0, 1 << 12, n),
            rng.integers(0, 101, n), ml, rng.integers(0, 5000, n), x)


@pytest.mark.parametrize("with_features", [True, False])
@pytest.mark.parametrize("n", [0, 1, 4097])
def test_encode_score_batch_matches_jax(n, with_features):
    *cols, x = _result_arrays(n, n + with_features)
    feats = x if with_features else None
    got = wire.encode_score_batch(*cols, feats)
    assert got == jax_wire.encode_score_batch(*cols, feats)
    assert len(risk_pb2.ScoreBatchResponse.FromString(got).results) == n


def _value(kind, rng):
    if kind == codec.STRING:
        return STRINGS[rng.integers(len(STRINGS))]
    if kind == codec.BOOL:
        return bool(rng.integers(2))
    if kind == codec.FLOAT:
        return [0.0, -0.0, float(np.float32(rng.normal() * 100))][rng.integers(3)]
    if kind == codec.ENUM:
        return int(rng.integers(0, 4))
    if kind == codec.INT32:
        return int(rng.choice([0, -1, rng.integers(-2**31, 2**31)]))
    return int(rng.choice([0, -5, rng.integers(-2**62, 2**62)]))  # INT64


def _message(schema, rng, depth=0) -> dict:
    """A random message of ``schema``: each field set or left out."""
    msg = {}
    for _, name, kind, sub, repeated in schema:
        if rng.random() < 0.2 or kind == codec.MAP:
            continue
        if kind == codec.MESSAGE:
            make = lambda: _message(sub, rng, depth + 1)  # noqa: E731
        else:
            make = lambda: _value(kind, rng)  # noqa: E731
        msg[name] = [make() for _ in range(rng.integers(0, 4))] if repeated else make()
    return msg


_PB2 = {
    codec.SCORE_TRANSACTION_REQUEST: risk_pb2.ScoreTransactionRequest,
    codec.SCORE_TRANSACTION_RESPONSE: risk_pb2.ScoreTransactionResponse,
    codec.SCORE_BATCH_REQUEST: risk_pb2.ScoreBatchRequest,
    codec.SCORE_BATCH_RESPONSE: risk_pb2.ScoreBatchResponse,
    codec.CHECK_BONUS_ABUSE_REQUEST: risk_pb2.CheckBonusAbuseRequest,
    codec.CHECK_BONUS_ABUSE_RESPONSE: risk_pb2.CheckBonusAbuseResponse,
    codec.ADD_TO_BLACKLIST_REQUEST: risk_pb2.AddToBlacklistRequest,
    codec.ADD_TO_BLACKLIST_RESPONSE: risk_pb2.AddToBlacklistResponse,
    codec.CHECK_BLACKLIST_REQUEST: risk_pb2.CheckBlacklistRequest,
    codec.CHECK_BLACKLIST_RESPONSE: risk_pb2.CheckBlacklistResponse,
    codec.GET_FEATURES_REQUEST: risk_pb2.GetFeaturesRequest,
    codec.GET_FEATURES_RESPONSE: risk_pb2.GetFeaturesResponse,
    codec.UPDATE_THRESHOLDS_REQUEST: risk_pb2.UpdateThresholdsRequest,
    codec.UPDATE_THRESHOLDS_RESPONSE: risk_pb2.UpdateThresholdsResponse,
    codec.GET_THRESHOLDS_REQUEST: risk_pb2.GetThresholdsRequest,
    codec.GET_THRESHOLDS_RESPONSE: risk_pb2.GetThresholdsResponse,
}
_NAMES = {id(schema): cls.__name__ for schema, cls in _PB2.items()}


def _bits(msg):
    """Compare floats by their bits, so -0.0 and 0.0 differ."""
    if isinstance(msg, dict):
        return {k: _bits(v) for k, v in msg.items()}
    if isinstance(msg, list):
        return [_bits(v) for v in msg]
    return struct.pack("<f", msg) if isinstance(msg, float) else msg


@pytest.mark.parametrize("schema", list(_PB2), ids=lambda s: _NAMES[id(s)])
def test_risk_codec_matches_pb2(schema):
    cls = _PB2[schema]
    rng = np.random.default_rng(len(_NAMES[id(schema)]))
    for _ in range(40):
        msg = _message(schema, rng)
        pb = cls(**msg)
        assert codec.encode(schema, msg) == pb.SerializeToString()
        decoded = codec.decode(schema, pb.SerializeToString() + UNKNOWN)
        pb.DiscardUnknownFields()
        assert codec.encode(schema, decoded) == pb.SerializeToString()
        again = codec.decode(schema, codec.encode(schema, decoded))
        assert _bits(again) == _bits(decoded)
    if schema is codec.SCORE_TRANSACTION_REQUEST:  # the metadata map is read past
        pb = cls(account_id="a", amount=-7, metadata={"k": "v"})
        assert codec.decode(schema, pb.SerializeToString())["amount"] == -7
        assert codec.encode(schema, {"account_id": "a", "amount": -7, "metadata": {"k": "v"}}) \
            == pb.SerializeToString()


@pytest.mark.parametrize("ml_score", [0.0, -0.0, 0.4375, 1.0])
def test_single_score_response_matches_pb2(ml_score):
    """One ScoreTransactionResponse through the native batch encoder equals
    the JAX server's protobuf answer (``_score_to_proto``), including
    protobuf's -0.0."""
    from igaming_platform_tpu.core.enums import action_from_code, decode_reason_mask
    from igaming_platform_tpu.core.features import FeatureVector
    from igaming_platform_tpu.serve.grpc_server import RiskGrpcService
    from igaming_platform_tpu.serve.scorer import ScoreResponse

    score, action, mask, rule, _, rtms, x = (c[1] for c in _result_arrays(3, 5))
    resp = ScoreResponse(score=int(score), action=action_from_code(int(action)).value,
                         reason_codes=decode_reason_mask(int(mask)), rule_score=int(rule),
                         ml_score=ml_score, response_time_ms=float(rtms) + 0.7,
                         features=FeatureVector.from_array(x))
    want = RiskGrpcService._score_to_proto(None, resp).SerializeToString()
    got = codec.encode_score_response(int(score), int(action), int(mask), int(rule), ml_score,
                                      int(rtms), x)
    assert got == want


@pytest.mark.parametrize("n", [0, 1, 300])
def test_index_frames_match_jax(n):
    """``encode_index_batch`` gives the JAX codec's bytes, with every string
    column and without the optional ones, and ``decode_index_batch`` reads
    back what the JAX decoder reads."""
    rng = np.random.default_rng(n)
    ids = [STRINGS[i] + str(i) for i in rng.integers(0, len(STRINGS), n)]
    amounts = rng.integers(-2**40, 2**40, n)
    kinds = [("deposit", "withdraw", "bet", "win", "refund", "")[k] for k in rng.integers(0, 6, n)]
    cols = [[STRINGS[i] for i in rng.integers(0, len(STRINGS), n)] for _ in range(3)]
    for optional in (cols, [None, cols[1], None]):
        frame = wire.encode_index_batch(ids, amounts, kinds, *optional)
        assert frame == jax_wire.encode_index_batch(ids, amounts, kinds, *optional)
        got, want = wire.decode_index_batch(frame), jax_wire.decode_index_batch(frame)
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w
    assert wire.TX_TYPE_CODES == jax_wire.TX_TYPE_CODES
    assert wire.INDEX_WIRE_MAGIC == jax_wire.INDEX_WIRE_MAGIC


def _frame_cases():
    good = jax_wire.encode_index_batch(["a", "bb"], [5, 6], ["bet", "win"], ips=["1", "2"])
    return [b"IDX1", b"XXXX" + good[4:], good[:9], good[:-1], good[:26] + b"\x02" + good[27:],
            jax_wire.encode_index_batch(["a"], [1], ["bet"])[:17] + b"\x00",
            good[:30] + (7).to_bytes(4, "little") + good[34:]]


@pytest.mark.parametrize("frame", _frame_cases())
def test_index_frames_refuse_malformed_bytes(frame):
    """Truncated frames, a wrong magic, a bad column flag, a missing account
    column and offsets that go backwards raise ValueError in both codecs."""
    with pytest.raises(ValueError):
        jax_wire.decode_index_batch(frame)
    with pytest.raises(ValueError):
        wire.decode_index_batch(frame)


@pytest.mark.parametrize("payload", [b"\x0a\x05ab", b"\x08\x80\x80", b"\x0a\x02\xff\xfe",
                                     b"\x0b"])
def test_risk_codec_refuses_malformed_bytes(payload):
    """Truncated fields, an overlong length, invalid UTF-8 and a group wire
    type raise ValueError, as protobuf refuses them."""
    with pytest.raises(ValueError):
        codec.decode(codec.SCORE_TRANSACTION_REQUEST, payload)
