"""Port parity: models/ltv.py, the two LTV RPCs and serve/ltv_job.py.

Inputs come from a numpy seed and go through the JAX function and the port
on the CPU. The JAX service and job answer with ``predict_batch_jit``, whose
XLA program folds ``x * 30 * 12`` into ``x * 360`` and fuses
``net + monthly * months`` into one FMA (and, on a single row, moves both
constants onto ``net / days * engagement``); the port follows that program,
so every output is held bit for bit:

- ``predict_batch`` against ``predict_batch_jit`` over 100,000 rows, many of
  them on a threshold of every formula (days 3, 7, 14 and 30, sessions 1, 3
  and 5, deposit frequency 1, 2 and 4, bets 20 and 100, churn landing on 0.3
  and 0.7, LTV an ulp from 100, 1,000 and 10,000 dollars, for established and
  for new players), at one call, and at 17, 8, 4, 3, 2 and 1 rows a call;
  against eager JAX, op by op, every output but ``ltv``;
- ``fma`` against the exact value, on a double-rounding case;
- the committed golden of ``predict_batch_jit``'s outputs
  (``tests/golden/ltv_jit.npz``, which ``chip_smoke.py`` holds the card to):
  the jit still writes it and the port reproduces it; regenerate it with
  ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_ltv.py``;
- ``PredictLTV`` and ``GetPlayerSegment`` through the port's bytes service
  against the JAX service's handlers for the same ``ltv_source``, decoded by
  protobuf, ``predicted_at`` excluded;
- ``run_batch_job`` against the JAX job on a wallet written by the JAX
  ``SQLiteStore`` and ``WalletService``, at 400 values of ``now``: the same
  records and segments.
"""

import json
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from igaming_platform_tpu.models import ltv as jltv
from igaming_platform_tpu.proto_gen.risk.v1 import risk_pb2
from igaming_platform_tpu.serve import ltv_job as jjob
from igaming_platform_tpu.serve.grpc_server import RiskGrpcService as JaxService
from igaming_platform_tpu_torch.core.numerics import fma
from igaming_platform_tpu_torch.models import ltv as tltv
from igaming_platform_tpu_torch.serve import grpc_server
from igaming_platform_tpu_torch.serve import ltv_job as tjob
from test_ltv_job import seeded_db
from torch_front_common import no_jax_hostprof  # noqa: F401 — a fixture

L = jltv.L
GOLDEN = Path(__file__).parent / "golden" / "ltv_jit.npz"
GOLDEN_ROWS, GOLDEN_SINGLES = 4096, 256  # the golden's batch; its leading rows scored one a call


def ltv_rows(seed: int, n: int = 4096) -> np.ndarray:
    """Seeded rows whose columns take each formula's thresholds and the
    values on either side of them."""
    rng = np.random.default_rng(seed)
    f = np.zeros((n, 25), np.float32)

    def pick(*values):
        return rng.choice(np.array(values, np.float32), n)

    f[:, L.DAYS_SINCE_REGISTRATION] = pick(0, 1, 6, 7, 8, 29, 30, 31, 60, 90, 91, 400, 29.5)
    f[:, L.DAYS_SINCE_LAST_DEPOSIT] = pick(0, 7, 8, 30, 31, 100)
    f[:, L.DAYS_SINCE_LAST_BET] = pick(0, 2, 3, 6, 7, 8, 13, 14, 15, 29, 30, 31, 100)
    f[:, L.SESSIONS_PER_WEEK] = pick(0, 0.5, 1, 2, 3, 4, 5, 6)
    f[:, L.TOTAL_DEPOSITS] = rng.exponential(500, n)
    f[:, L.TOTAL_WITHDRAWALS] = np.where(rng.random(n) < 0.1, f[:, L.TOTAL_DEPOSITS],
                                         rng.exponential(300, n))
    f[:, L.NET_REVENUE] = rng.normal(0, 3000, n) * pick(1, 10, 0.01)
    f[:, L.DEPOSIT_FREQUENCY] = pick(0, 0.5, 1, 2, 3, 4, 5)
    f[:, L.BET_COUNT] = pick(0, 20, 21, 100, 101, 500)
    f[:, L.GAMES_PLAYED] = pick(0, 4, 5, 6)
    f[:, L.BONUSES_CLAIMED] = pick(0, 2, 3, 4)
    f[:, L.BONUS_CONVERSION_RATE] = pick(0, 0.8, 0.81, 1)
    f[:, L.PUSH_ENABLED:L.HAS_VIP_MANAGER + 1] = rng.integers(0, 2, (n, 3))
    f[:, L.SUPPORT_TICKETS] = pick(0, 3, 4)
    # Rows whose adjusted LTV lands on a segment threshold or an ulp either
    # side: established (30 days), no engagement, churn 0.15 (last bet 14
    # days ago), so the LTV is net revenue times (1 - 0.15 * 0.5).
    on = np.arange(0, n, 17)
    f[on] = 0
    f[on, L.DAYS_SINCE_REGISTRATION] = 30
    f[on, L.DAYS_SINCE_LAST_BET] = 14
    keep = np.float32(1) - np.float32(0.15) * np.float32(0.5)
    nets = []
    for thr in (jltv.MEDIUM_THRESHOLD, jltv.HIGH_THRESHOLD, jltv.VIP_THRESHOLD):
        net = np.float32(thr / keep)
        nets += [np.nextafter(net, np.float32(0)), net, np.nextafter(net, np.float32(1e9))]
    f[on, L.NET_REVENUE] = rng.choice(np.array(nets, np.float32), on.size)
    # New players (under 30 days), the same churn, their LTV 360 times the
    # daily run rate, landing within 3 ulps of a segment threshold: the
    # branch whose constants XLA folds.
    new = np.arange(8, n, 17)
    f[new] = 0
    dsr = rng.choice(np.array([1, 3, 10, 29, 29.5], np.float32), new.size)
    f[new, L.DAYS_SINCE_REGISTRATION] = dsr
    f[new, L.DAYS_SINCE_LAST_BET] = 14
    thr = rng.choice(np.array([jltv.MEDIUM_THRESHOLD, jltv.HIGH_THRESHOLD,
                               jltv.VIP_THRESHOLD], np.float32), new.size)
    net = (thr / keep * dsr / np.float32(360)).astype(np.float32)
    f[new, L.NET_REVENUE] = (net.view(np.int32) + rng.integers(-3, 4, new.size,
                                                                dtype=np.int32)).view(np.float32)
    return f


def _bits(out: dict) -> dict:
    return {k: np.asarray(v).view(np.int32) for k, v in out.items()}


def _assert_outputs(got: dict, want: dict, what: str, skip=()) -> None:
    assert set(got) == set(want), what
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, key)
        if key not in skip:
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                          err_msg=f"{what} {key}")


def _port(f: np.ndarray) -> dict:
    return {k: v.numpy() for k, v in tltv.predict_batch(f, "cpu").items()}


def _jit(f: np.ndarray) -> dict:
    return {k: np.asarray(v) for k, v in jltv.predict_batch_jit(f).items()}


def _in_calls(fn, f: np.ndarray, rows: int) -> dict:
    """``fn`` over ``f`` in calls of ``rows`` rows, the outputs joined."""
    parts = [fn(f[i:i + rows]) for i in range(0, f.shape[0], rows)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


@pytest.mark.parametrize("rows_a_call,n", [(100_000, 100_000), (17, 3_400), (8, 2_000),
                                           (4, 2_000), (3, 3_000), (2, 2_000), (1, 2_000)])
def test_predict_batch_against_jax(rows_a_call, n):
    """Bit-equal to the jit on all seven outputs at 100,000 rows a call and
    at 17, 8, 4, 3, 2 and 1 (the single-row program differs from the batch
    one; the small batches take the vector loop's tail); against eager JAX,
    every output but ``ltv``, which eager JAX rounds step by step."""
    f = ltv_rows(0, 100_000)[:n]
    got = _in_calls(_port, f, rows_a_call)
    _assert_outputs(got, _in_calls(_jit, f, rows_a_call), what=f"jit, {rows_a_call} rows a call")
    if rows_a_call != f.shape[0]:
        return
    _assert_outputs(got, {k: np.asarray(v) for k, v in jltv.predict_batch(f).items()},
                    what="eager", skip=("ltv",))
    # Every segment, every action and both sides of the churn override occur.
    assert set(np.unique(got["segment"])) == {1, 2, 3, 4, 5}
    assert set(np.unique(got["action"])) == set(range(len(jltv.ACTIONS)))
    assert (got["churn_risk"] == np.float32(0.7)).any()
    want = jltv.segment_players(f)
    seg = tltv.segment_players(f, "cpu")
    assert sorted(seg) == sorted(want)
    for code in want:
        np.testing.assert_array_equal(seg[code], want[code])
    assert tltv.ACTIONS == jltv.ACTIONS and tltv.LTV_FEATURE_NAMES == jltv.LTV_FEATURE_NAMES


def test_fma_rounds_once():
    """``fma`` against the exact value, rounded to nearest float32: seeded
    operands, and a case where the float64 sum lands on a float32 midpoint
    the exact value lies beyond (1 + 2^-24 + 2^-60: rounding twice gives
    1.0, once 1 + 2^-23), either sign."""
    rng = np.random.default_rng(4)
    a = (rng.normal(size=2000) * 10.0 ** rng.integers(-3, 4, 2000)).astype(np.float32)
    b = (rng.normal(size=2000) * 10.0 ** rng.integers(-3, 4, 2000)).astype(np.float32)
    c = (rng.normal(size=2000) * 10.0 ** rng.integers(-3, 4, 2000)).astype(np.float32)
    tie = np.float32(2.0 ** -24 * (1 + 2.0 ** -12)), np.float32(1 - 2.0 ** -12 + 2.0 ** -24)
    a = np.concatenate([a, [tie[0], -tie[0]]]).astype(np.float32)
    b = np.concatenate([b, [tie[1], tie[1]]]).astype(np.float32)
    c = np.concatenate([c, [1.0, -1.0]]).astype(np.float32)
    got = fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for i in range(a.size):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))  # a neighbour of the exact value; the nearer of its two wins
        hi = np.nextafter(lo, np.float32(np.inf) if Fraction(float(lo)) < exact else np.float32(-np.inf))
        d_lo, d_hi = abs(Fraction(float(lo)) - exact), abs(Fraction(float(hi)) - exact)
        want = lo if d_lo < d_hi or (d_lo == d_hi and lo.view(np.int32) % 2 == 0) else hi
        assert got[i].view(np.int32) == want.view(np.int32), (i, a[i], b[i], c[i])
    assert got[-2] == np.float32(1 + 2.0 ** -23) and got[-1] == -got[-2]


def ltv_golden() -> dict:
    """``predict_batch_jit``'s outputs over GOLDEN_ROWS seeded rows in one
    call, and over their leading GOLDEN_SINGLES rows one a call, with the
    rows."""
    f = ltv_rows(7, GOLDEN_ROWS)
    out = {"features": f}
    out.update({f"batch_{k}": v for k, v in _jit(f).items()})
    out.update({f"single_{k}": v for k, v in _in_calls(_jit, f[:GOLDEN_SINGLES], 1).items()})
    return out


def test_ltv_golden_reproduced():
    """The jit still writes the committed golden, and the port reproduces
    it bit for bit in both of its programs."""
    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    fresh = ltv_golden()
    assert sorted(golden) == sorted(fresh)
    for k, v in fresh.items():
        np.testing.assert_array_equal(golden[k].view(np.int32), v.view(np.int32), err_msg=k)
    f = golden["features"]
    for kind, got in (("batch", _port(f)), ("single", _in_calls(_port, f[:GOLDEN_SINGLES], 1))):
        _assert_outputs(got, {k: golden[f"{kind}_{k}"] for k in got}, what=kind)


@pytest.mark.usefixtures("no_jax_hostprof")
def test_ltv_rpcs_answer_as_the_jax_service():
    f = ltv_rows(1, n=64)
    rows = {f"acct{i}": f[i] for i in range(f.shape[0] - 1)}  # the last account has none

    def source(account_id):
        return rows.get(account_id)

    class Engine:  # the LTV RPCs use no scoring engine, only its device
        device = "cpu"

        def score(self, request):
            raise AssertionError("an LTV RPC scored a transaction")

    jsvc = JaxService(Engine(), ltv_source=source)
    tsvc = grpc_server.RiskGrpcService(Engine(), ltv_source=source)
    for i in range(f.shape[0]):
        account = f"acct{i}"
        req = risk_pb2.PredictLTVRequest(account_id=account)
        want = jsvc.PredictLTV(req, None)
        got = risk_pb2.PredictLTVResponse.FromString(
            tsvc.call("PredictLTV", req.SerializeToString()))
        assert got.predicted_at.seconds > 0
        for msg in (want, got):
            msg.ClearField("predicted_at")
        assert got == want, account
        req = risk_pb2.GetPlayerSegmentRequest(account_id=account)
        want = jsvc.GetPlayerSegment(req, None)
        got = risk_pb2.GetPlayerSegmentResponse.FromString(
            tsvc.call("GetPlayerSegment", req.SerializeToString()))
        assert got == want, account
    # No features: the zeros row, as in the JAX service.
    assert risk_pb2.GetPlayerSegmentResponse.FromString(tsvc.call(
        "GetPlayerSegment", risk_pb2.GetPlayerSegmentRequest(
            account_id="nobody").SerializeToString())).segment == jltv.SEG_LOW


def test_batch_job_against_jax(tmp_path):
    """The same records as the JAX job at 400 values of ``now``: the
    accounts' ages, and with them the branch and rounding of each LTV,
    change with it (the wallet is stamped from the wall clock)."""
    path = seeded_db(tmp_path)
    for i in range(400):
        now = 1_800_000_000 + i * 3607.3
        want = jjob.run_batch_job(path, now=now)
        timings = {}
        got = tjob.run_batch_job(path, now=now, device="cpu", timings=timings)
        assert got == want and got["count"] == 3, now
    assert set(timings) == {"scan_s", "device_s", "records_s"}
    ids, x = tjob.ltv_features_from_wallet(path, now=now)
    jids, jx = jjob.ltv_features_from_wallet(path, now=now)
    assert ids == jids
    np.testing.assert_array_equal(x, jx)
    empty = str(tmp_path / "empty.db")
    from igaming_platform_tpu.platform.repository import SQLiteStore

    SQLiteStore(empty).close()
    assert tjob.run_batch_job(f"sqlite://{empty}", device="cpu") == {
        "players": [], "segments": {}, "count": 0}
    from igaming_platform_tpu_torch.platform.pg_testing import PgSqliteServer

    rig = PgSqliteServer(path)
    try:
        assert tjob.run_batch_job(rig.url, now=now, device="cpu") == want
    finally:
        rig.close()
    out = tmp_path / "out.json"
    assert tjob.main([path, str(out), "--device", "cpu"]) == 0
    written = json.loads(out.read_text())
    assert written["device"] == "cpu" and written["count"] == 3


if __name__ == "__main__":
    np.savez_compressed(GOLDEN, **ltv_golden())
    print(f"wrote {GOLDEN}")
