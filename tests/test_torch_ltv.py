"""Port parity: models/ltv.py, the two LTV RPCs and serve/ltv_job.py.

Inputs come from a numpy seed and go through the JAX function and the port
on the CPU:

- ``predict_batch`` on [4096, 25] rows, many of them on a threshold of
  every formula (days 3, 7, 14 and 30, sessions 1, 3 and 5, deposit
  frequency 1, 2 and 4, bets 20 and 100, churn landing on 0.3 and 0.7,
  LTV an ulp from 100, 1,000 and 10,000 dollars, for established and for
  new players): integer outputs exact
  against ``predict_batch_jit``, the JAX server's function, and every float
  bit for bit against ``predict_batch`` run op by op. The port keeps the
  source's association; XLA's compiled program folds ``x * 30 * 12`` into
  ``x * 360`` and contracts ``net + monthly * months`` into an FMA, so the
  jitted ``ltv`` lies within 2 float32 ulps (rtol 3e-7) and its other
  floats are bit-equal;
- ``PredictLTV`` and ``GetPlayerSegment`` through the port's bytes service
  against the JAX service's handlers for the same ``ltv_source``, decoded by
  protobuf, ``predicted_at`` excluded, floats as above;
- ``run_batch_job`` against the JAX job on a wallet written by the JAX
  ``SQLiteStore`` and ``WalletService``: the same records and segments.
"""

import json

import numpy as np
import pytest

from igaming_platform_tpu.models import ltv as jltv
from igaming_platform_tpu.proto_gen.risk.v1 import risk_pb2
from igaming_platform_tpu.serve import ltv_job as jjob
from igaming_platform_tpu.serve.grpc_server import RiskGrpcService as JaxService
from igaming_platform_tpu_torch.models import ltv as tltv
from igaming_platform_tpu_torch.serve import grpc_server
from igaming_platform_tpu_torch.serve import ltv_job as tjob
from test_ltv_job import seeded_db
from torch_front_common import no_jax_hostprof  # noqa: F401 — a fixture

L = jltv.L
LTV_RTOL = 3e-7  # XLA's folded constants and FMA: 2 float32 ulps


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


def _assert_outputs(got: dict, want: dict, jit: bool, what: str) -> None:
    assert set(got) == set(want), what
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, key)
        if key == "ltv" and jit:
            np.testing.assert_allclose(g, w, rtol=LTV_RTOL, atol=0, err_msg=f"{what} {key}")
        else:
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                          err_msg=f"{what} {key}")


def test_predict_batch_against_jax():
    f = ltv_rows(0)
    got = {k: v.numpy() for k, v in tltv.predict_batch(f, "cpu").items()}
    _assert_outputs(got, {k: np.asarray(v) for k, v in jltv.predict_batch(f).items()},
                    jit=False, what="eager")
    _assert_outputs(got, {k: np.asarray(v) for k, v in jltv.predict_batch_jit(f).items()},
                    jit=True, what="jit")
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
        assert got.predicted_ltv == pytest.approx(want.predicted_ltv, rel=LTV_RTOL, abs=0)
        got.predicted_ltv = want.predicted_ltv
        assert got == want, account
        req = risk_pb2.GetPlayerSegmentRequest(account_id=account)
        want = jsvc.GetPlayerSegment(req, None)
        got = risk_pb2.GetPlayerSegmentResponse.FromString(
            tsvc.call("GetPlayerSegment", req.SerializeToString()))
        assert got.ltv == pytest.approx(want.ltv, rel=LTV_RTOL, abs=0)
        got.ltv = want.ltv
        assert got == want, account
    # No features: the zeros row, as in the JAX service.
    assert risk_pb2.GetPlayerSegmentResponse.FromString(tsvc.call(
        "GetPlayerSegment", risk_pb2.GetPlayerSegmentRequest(
            account_id="nobody").SerializeToString())).segment == jltv.SEG_LOW


def test_batch_job_against_jax(tmp_path):
    path = seeded_db(tmp_path)
    now = 1_800_000_000.0
    want = jjob.run_batch_job(path, now=now)
    timings = {}
    got = tjob.run_batch_job(path, now=now, device="cpu", timings=timings)
    assert got == want and got["count"] == 3
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
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        tjob.run_batch_job("postgres://localhost/wallet", device="cpu")
    out = tmp_path / "out.json"
    assert tjob.main([path, str(out), "--device", "cpu"]) == 0
    written = json.loads(out.read_text())
    assert written["device"] == "cpu" and written["count"] == 3
