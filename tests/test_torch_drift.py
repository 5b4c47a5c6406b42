"""Port parity: obs/drift.py, the drift observatory, and the engine's drift seam.

The same seeded numpy inputs go through the JAX package and the port on the
CPU:

- ``sketch_kernel`` and ``cached_sketch_kernel`` against the JAX kernels
  (jitted, as the JAX engine runs them) and ``np_sketch``, with the pad rows
  holding large garbage: histograms equal, moments within rtol 1e-4 (float32
  sums in another order);
- ``DriftEngine`` of each package under one fake clock, fed the same
  sketches, outcomes and shadow results, a reference pinned midway, then
  drifted traffic and back: windows, PSI/KS, the alert events and the
  whole ``snapshot()`` equal;
- a reference minted by either package loads in the other, with the same
  fingerprint;
- the engine's row, cached and session steps sketch every scored row, fused
  (in the step's enqueue) and split (``FUSED=0``), on the float32, bf16 and
  int8 row wires: the window equals ``np_sketch`` of the rows the step
  scored (the int8 wire's dequantized rows; on the split layout its rows
  are counted as skipped);
- ``RiskGrpcService`` installs and binds a drift engine by default, none
  with ``DRIFT=0``, and ``close()`` leaves no drift thread behind.
"""

import json
import threading

import jax
import numpy as np
import pytest
import torch
from test_torch_rules_mock import _raw_batch

from igaming_platform_tpu.obs import drift as jdrift
from igaming_platform_tpu_torch.core.config import BatcherConfig
from igaming_platform_tpu_torch.core.features import F
from igaming_platform_tpu_torch.obs import drift as tdrift
from igaming_platform_tpu_torch.ops.quantize import wire_dequantize_int8, wire_quantize_int8
from igaming_platform_tpu_torch.serve import grpc_server
from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore, TransactionEvent
from igaming_platform_tpu_torch.serve.scorer import ScoreRequest, TorchScoringEngine, encode_bf16

T0 = 1_700_000_000.0
MOMENT_RTOL = 1e-4
ACTION_CODES = {"approve": 1, "review": 2, "block": 3}
HIST = slice(tdrift.OFF_FHIST, tdrift.SKETCH_LEN)
MOMENTS = slice(0, tdrift.OFF_FHIST)


def _packed(rng, b):
    packed = np.zeros((5, b), np.int32)
    packed[0] = rng.integers(-3, 110, b)  # scores, a few off the 0-100 scale
    packed[1] = rng.integers(0, 5, b)  # actions, one past the last
    return packed


def assert_sketch_equal(got, want, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(got[HIST], want[HIST], err_msg=f"{label} histograms")
    np.testing.assert_allclose(got[MOMENTS], want[MOMENTS], rtol=MOMENT_RTOL,
                               err_msg=f"{label} moments")


@pytest.mark.parametrize("kind", ["row", "cached"])
def test_sketch_kernels_match_jax_and_numpy(kind):
    rng = np.random.default_rng(40 if kind == "row" else 41)
    b, n = 300, 257
    packed = _packed(rng, b)
    if kind == "row":
        x = _raw_batch(42, b)
        x[n:] = rng.normal(size=(b - n, x.shape[1])).astype(np.float32) * 1e6  # garbage pads
        rows = x[:n]
        want = np.asarray(jax.jit(jdrift.sketch_kernel)(x, packed, np.int32(n)))
        got = tdrift.sketch_kernel(torch.from_numpy(x), torch.from_numpy(packed), n)
    else:
        table = _raw_batch(43, 64)
        idxs = rng.integers(0, 64, b).astype(np.int32)
        amounts = rng.integers(0, 10**6, b).astype(np.float32)
        types = rng.integers(0, 5, b).astype(np.int32)
        rows = table[idxs[:n]].copy()
        rows[:, F.TX_AMOUNT] = amounts[:n]
        for col, code in ((F.TX_TYPE_DEPOSIT, 0), (F.TX_TYPE_WITHDRAW, 1), (F.TX_TYPE_BET, 2)):
            rows[:, col] = types[:n] == code
        want = np.asarray(jax.jit(jdrift.cached_sketch_kernel)(
            table, idxs, amounts, types, packed, np.int32(n)))
        got = tdrift.cached_sketch_kernel(
            torch.from_numpy(table), torch.from_numpy(idxs.astype(np.int64)),
            torch.from_numpy(amounts), torch.from_numpy(types), torch.from_numpy(packed), n)
    assert got.dtype == torch.float32 and got.shape == (tdrift.SKETCH_LEN,)
    ref = jdrift.np_sketch(rows, packed[0, :n], packed[1, :n])
    assert_sketch_equal(got.numpy(), ref, f"{kind} vs np_sketch")
    assert_sketch_equal(got.numpy(), want, f"{kind} vs JAX")
    np.testing.assert_array_equal(tdrift.np_sketch(rows, packed[0, :n], packed[1, :n]), ref)
    assert got[tdrift.OFF_ROWS] == n and ref[tdrift.OFF_FHIST:tdrift.OFF_SHIST].sum() == 30 * n


def test_layout_and_fingerprint_equal():
    for name in ("SKETCH_LEN", "OFF_SUM", "OFF_SUMSQ", "OFF_FHIST", "OFF_SHIST", "OFF_AHIST"):
        assert getattr(tdrift, name) == getattr(jdrift, name), name
    assert tdrift.EDGES_SPEC == jdrift.EDGES_SPEC
    assert tdrift.edges_fingerprint() == jdrift.edges_fingerprint()


class _Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def _traffic(rng, shift: float, n: int = 400):
    x = _raw_batch(int(rng.integers(1 << 30)), n)
    x[:, F.TX_AMOUNT] *= shift
    packed = _packed(rng, n)
    return jdrift.np_sketch(x, packed[0], packed[1])


def test_drift_engine_matches_jax():
    """Both engines under one fake clock, fed the same feeds step by step."""
    cfg = dict(window_s=30.0, bucket_s=5.0, min_rows=200, queue_max=64)
    clock = _Clock(T0)
    engines = (jdrift.DriftEngine(jdrift.DriftConfig(**cfg), clock=clock),
               tdrift.DriftEngine(tdrift.DriftConfig(**cfg), clock=clock))
    rng = np.random.default_rng(44)
    events = []
    try:
        for step in range(40):
            clock.t = T0 + 2.5 * step
            shift = 1.0 if step < 12 or step >= 24 else 1e4
            vec = _traffic(rng, shift)
            scores = rng.integers(0, 100, 50)
            labels = (rng.random(50) < scores / 150).astype(np.float64)
            prod = {"action": rng.integers(1, 4, 30), "score": rng.integers(0, 100, 30)}
            cand = {"action": prod["action"].copy(), "score": prod["score"] + 1}
            cand["action"][:3] = 3
            for eng in engines:
                assert eng.submit(vec.copy(), int(vec[0]))
                eng.note_outcomes(scores, labels)
                eng.note_shadow_result(cand, prod, 30)
                assert eng.drain(10.0)
            if step == 10:
                ref_vec = engines[0].window_vec()
                np.testing.assert_array_equal(engines[1].window_vec(), ref_vec)
                for eng, mod in zip(engines, (jdrift, tdrift)):
                    cal = eng._cal_total.copy()
                    eng.set_reference(mod.DriftReference.from_sketch(
                        ref_vec, source="clean", calibration=cal, created_unix=T0))
            snaps = [json.loads(json.dumps(eng.snapshot())) for eng in engines]
            assert snaps[1] == snaps[0], f"step {step}"
            events = snaps[1]["alert_events"]
        kinds = {(e["kind"], e["event"]) for e in events}
        assert ("input", "raised") in kinds and ("input", "cleared") in kinds
        assert snaps[1]["shadow"]["window_rows"] > 0 and snaps[1]["calibration"]["error"] is not None
        # A full queue drops and counts in both.
        for eng in engines:
            eng._stopping = True
            assert not eng.submit(np.zeros(tdrift.SKETCH_LEN), 5)
            eng._stopping = False
        assert engines[0].rows_dropped == engines[1].rows_dropped == 5
    finally:
        for eng in engines:
            eng.close()


def test_reference_files_load_in_both_packages(tmp_path):
    rng = np.random.default_rng(45)
    vec = _traffic(rng, 1.0)
    cal = np.stack([rng.integers(0, 50, 20), rng.integers(0, 5, 20)], axis=1).astype(np.float64)
    for make, load in ((tdrift, jdrift), (jdrift, tdrift)):
        ref = make.DriftReference.from_sketch(vec, source="minted", calibration=cal,
                                              created_unix=T0)
        path = ref.save(str(tmp_path / f"{make.__name__}.json"))
        back = load.DriftReference.load(path)
        assert back.fingerprint() == ref.fingerprint() and back.meta() == ref.meta()
        np.testing.assert_array_equal(back.calibration, cal)
    bad = json.loads(open(path).read())
    bad["edges_fp"] = "0" * 16
    with pytest.raises(ValueError, match="fingerprint"):
        tdrift.DriftReference.from_json(bad)


def _store(n_accounts=40):
    store = InMemoryFeatureStore(clock=lambda: T0)
    rng = np.random.default_rng(46)
    for i in range(400):
        store.update(TransactionEvent(
            f"acct{rng.integers(n_accounts)}", int(rng.integers(100, 900_000)),
            ("deposit", "bet", "withdraw", "win")[i % 4], device_id=f"dev{i % 9}",
            timestamp=T0 - float(rng.random() * 80_000)))
    return store


def _wire_rows(x: np.ndarray, wire: str) -> np.ndarray:
    """The float32 rows a step scores after the wire: decoded as the step does."""
    if wire == "bf16":
        return torch.from_numpy(encode_bf16(x)).view(torch.bfloat16).float().numpy()
    if wire == "int8":
        return wire_dequantize_int8(torch.from_numpy(wire_quantize_int8(x))).numpy()
    return x


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("path", ["row-f32", "row-bf16", "row-int8", "cached", "session"])
def test_engine_sketches_every_scored_row(path, fused, monkeypatch):
    monkeypatch.setenv("FUSED", "1" if fused else "0")
    wire = path.split("-")[1] if path.startswith("row") else "f32"
    monkeypatch.setenv("WIRE_DTYPE", wire)
    store = _store()
    eng = TorchScoringEngine(ml_backend="mock", feature_store=store, device="cpu",
                             batcher_config=BatcherConfig(batch_size=32, latency_tiers=(8,),
                                                          max_wait_ms=1.0),
                             feature_cache=64 if path in ("cached", "session") else False,
                             session_state=path == "session")
    de = tdrift.DriftEngine(tdrift.DriftConfig(min_rows=1, window_s=600.0))
    eng.bind_drift(de)
    rng = np.random.default_rng(47)
    ids = [f"acct{a}" for a in rng.integers(0, 45, 75)]
    amounts = rng.integers(100, 2_000_000, 75).tolist()
    types = [("deposit", "bet", "withdraw", "win")[t] for t in rng.integers(0, 4, 75)]
    try:
        reqs = [ScoreRequest(a, amount=m, tx_type=t) for a, m, t in zip(ids, amounts, types)]
        x, _ = store.gather_batch(reqs)
        if path.startswith("row"):
            out = eng.score_batch(reqs)
            scores = np.array([r.score for r in out])
            actions = np.array([ACTION_CODES[r.action] for r in out])
        else:
            got = eng.score_columns_cached(ids, amounts, types, now=T0)
            scores, actions = got["score"], got["action"]
        rows = _wire_rows(x, wire)
        assert de.drain(10.0)
        if wire == "int8" and not fused:
            assert de.rows_skipped == 75 and de.rows_sketched == 0
            return
        assert de.rows_sketched == 75 and de.rows_skipped == 0 and de.errors == 0
        assert_sketch_equal(de.window_vec(), tdrift.np_sketch(rows, scores, actions), path)
    finally:
        eng.close()
        de.close()


def _drift_threads() -> int:
    return sum(t.name == "drift-observatory" and t.is_alive() for t in threading.enumerate())


def test_grpc_service_binds_drift_by_default(monkeypatch):
    monkeypatch.delenv("DRIFT", raising=False)
    before = _drift_threads()
    eng = TorchScoringEngine(ml_backend="mock", device="cpu", warmup=False,
                             batcher_config=BatcherConfig(batch_size=16, max_wait_ms=1.0))
    try:
        svc = grpc_server.RiskGrpcService(eng)
        assert svc.drift is not None and eng.drift is svc.drift
        assert tdrift.get_default() is svc.drift and _drift_threads() == before + 1
        svc.close()
        svc.close()
        assert eng.drift is None and tdrift.get_default() is None
        assert _drift_threads() == before
        monkeypatch.setenv("DRIFT", "0")
        svc = grpc_server.RiskGrpcService(eng)
        assert svc.drift is None and eng.drift is None and tdrift.get_default() is None
        svc.close()
    finally:
        eng.close()
