"""Port parity: obs/metrics.py and the ``metrics=`` seams that feed it.

- The registries: every family of the JAX package's ``ServiceMetrics`` is
  the port's, with the same name, type, help string and bucket bounds.
- One scripted RPC sequence (ScoreTransaction, ScoreBatch, PredictLTV,
  GetPlayerSegment, CheckBonusAbuse, a deadline shed and a malformed
  ScoreBatch) through the JAX package's ``RiskGrpcService`` RPC wrapper and
  the port's ``call``, each over a supervised CPU engine with the same
  store, params and a decision ledger (``tests/torch_front_common.py::
  PlanePair``). In the two expositions the families, types and label keys
  are equal; these series are equal in every sample: requests and errors by
  method and code, ``risk_score`` buckets, ``txns_scored_total``,
  ``batch_occupancy``, ``ltv_segment_total``, ``bulk_gate_limit``,
  ``deadline_expired_total``, the supervisor's serving and breaker states,
  ``slo_requests_total``, ``drift_rows_total`` and the ledger's records and
  drops. Latency values are excluded, and named here: the histograms of
  request, stage, queue, deadline-remaining and batch-size-chosen times are
  held to equal sample counts (and, for the stage histogram, the same stage
  names); the ledger's fsync times (how many fsyncs run depends on timing),
  the SLO burn, attainment and alert gauges, the drift window gauges and the
  lane depth gauge are held to their label keys; the SLO violation, budget
  and alert-count series, which have samples only when an RPC ran over the
  objective, are not compared.
- Each of the nine ``metrics=`` seams of the port against its JAX twin, fed
  the same operations: the feature cache (constructed bound, and bound
  later), the session plane, the shadow scorer, the drift engine, the
  ledger, the online miner and learner, and the promotion controller; and
  the LTV batch job's segment counter.
"""

import re

import numpy as np
import pytest
from test_torch_drift import _Clock, _traffic
from test_torch_ensemble import jax_tree, mlp_tree
from torch_front_common import PlanePair, T0, requests
from torch_front_common import no_jax_hostprof  # noqa: F401 — a fixture

from igaming_platform_tpu.obs import metrics as jmetrics
from igaming_platform_tpu.proto_gen.risk.v1 import risk_pb2
from igaming_platform_tpu_torch.obs import metrics as pmetrics

EXACT = ("grpc_requests_total", "grpc_errors_total", "risk_score", "txns_scored_total",
         "batch_occupancy",
         "ltv_segment_total", "bulk_gate_limit", "deadline_expired_total", "serving_state",
         "breaker_state", "slo_requests_total", "drift_rows_total", "ledger_records_total",
         "ledger_dropped_total", "abuse_shed_total", "bulk_shed_total")
COUNTS_ONLY = ("grpc_request_duration_ms", "stage_latency_ms", "batcher_time_in_queue_ms",
               "deadline_remaining_ms", "batch_size_chosen")
# Whether these have samples at all depends on latency (a violation is an RPC
# over the objective): not compared.
LATENCY_ONLY = ("slo_violations_total", "slo_budget_stage_ms_total", "slo_alerts_total")
_SAMPLE = re.compile(r"^(?P<name>[a-z_]+)(?P<labels>\{[^}]*\})? (?P<value>\S+)")


def _families(registry) -> dict:
    return {m.name: (type(m).__name__, m.help, getattr(m, "buckets", None))
            for m in registry._metrics}


def test_registries_match_jax():
    got = _families(pmetrics.ServiceMetrics("risk").registry)
    want = _families(jmetrics.ServiceMetrics("risk").registry)
    assert got == want
    assert len(got) == 86


def _samples(text: str) -> dict:
    """family -> sorted [(sample name, labels, value)], exemplars dropped."""
    out: dict = {}
    family = None
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            family = line.split()[2]
            out[family] = []
            continue
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line.split(" # ")[0])
        out[family].append((m["name"], m["labels"] or "", m["value"]))
    return {k: sorted(v) for k, v in out.items()}


def _label_keys(samples) -> set:
    return {tuple(sorted(re.findall(r'(\w+)="', labels))) for _, labels, _ in samples}


def _rpc_script():
    """(method, request bytes, metadata) in order."""
    reqs = requests(9, 12, 40)
    tx = [risk_pb2.ScoreTransactionRequest(**r).SerializeToString() for r in reqs]
    batch = risk_pb2.ScoreBatchRequest(transactions=[
        risk_pb2.ScoreTransactionRequest(**r) for r in requests(13, 150, 40)]).SerializeToString()
    script = [("ScoreTransaction", t, ()) for t in tx[:6]]
    script += [("ScoreBatch", batch, ()), ("ScoreBatch", batch, ())]
    for acct in ("acct3", "acct8"):
        script.append(("PredictLTV", risk_pb2.PredictLTVRequest(
            account_id=acct).SerializeToString(), ()))
    script.append(("GetPlayerSegment", risk_pb2.GetPlayerSegmentRequest(
        account_id="acct3").SerializeToString(), ()))
    for acct in ("acct0", "acct5"):
        script.append(("CheckBonusAbuse", risk_pb2.CheckBonusAbuseRequest(
            account_id=acct, bonus_id="b1").SerializeToString(), ()))
    script.append(("ScoreTransaction", tx[6], (("risk-deadline-ms", "0"),)))
    script.append(("ScoreBatch", b"\xff\xff\xff", ()))
    script.append(("ScoreTransaction", tx[7], (("risk-deadline-ms", "5000"),)))
    return script


def test_rpc_sequence_exposition_matches_jax(tmp_path, monkeypatch, no_jax_hostprof):
    pair = PlanePair(monkeypatch, tmp_path)
    try:
        codes = [[pair.call(side, m, p, md) for m, p, md in _rpc_script()] for side in (0, 1)]
        assert codes[1] == codes[0]
        assert codes[1].count("OK") == len(codes[1]) - 2
        assert {"DEADLINE_EXCEEDED", "INVALID_ARGUMENT"} <= set(codes[1])
        pair.settle()
        texts = [svc.metrics.registry.render_text() for svc in pair.services]
    finally:
        pair.close()
    want, got = _samples(texts[0]), _samples(texts[1])
    assert sorted(got) == sorted(want)
    for family in want:
        short = family[len("risk_"):]
        if short in EXACT:
            assert got[family] == want[family], family
        elif short in COUNTS_ONLY:
            counts = [[s for s in fam if s[0].endswith("_count")] for fam in (got[family],
                                                                           want[family])]
            assert counts[0] == counts[1], family
        if short not in LATENCY_ONLY:
            assert _label_keys(got[family]) == _label_keys(want[family]), family
    # The scripted traffic reached the deterministic series it should.
    assert ("risk_grpc_requests_total", '{code="OK",method="ScoreBatch"}', "2.0") in got[
        "risk_grpc_requests_total"]
    compared = [f for f in want if f[len("risk_"):] in EXACT + COUNTS_ONLY]
    assert len(compared) == len(EXACT + COUNTS_ONLY)
    assert ("risk_txns_scored_total", "", "307.0") in got["risk_txns_scored_total"]
    stages = {re.search(r'stage="([^"]+)"', s[1])[1] for s in got["risk_stage_latency_ms"]
              if s[0].endswith("_count")}
    assert {"score.decode", "score.dispatch", "score.readback", "score.encode", "score.queue",
            "score.gather", "score.admission"} <= stages


# ---------------------------------------------------------------------------
# The nine metrics= seams, each against its JAX twin


def _family_lines(metrics, prefixes) -> list[str]:
    return sorted(ln.split(" # ")[0] for ln in metrics.registry.render_text().splitlines()
                  if not ln.startswith("#") and ln.startswith(tuple(f"risk_{p}" for p in prefixes)))


def _cache(metrics, mod_side):
    from torch_ledger_common import seed_stores

    from igaming_platform_tpu.serve import device_cache as jdc
    from igaming_platform_tpu_torch.serve import device_cache as pdc

    stores = seed_stores()
    side = mod_side
    ids = [f"lg-{i % 15}" for i in range(40)]
    make = ((lambda **kw: jdc.DeviceFeatureCache(stores[0], capacity=8, **kw)) if side == 0
            else (lambda **kw: pdc.DeviceFeatureCache(stores[1], capacity=8, device="cpu", **kw)))
    bound, later = make(metrics=metrics), make()
    for cache in (bound, later):
        for lo in range(0, 40, 8):
            cache.lookup(ids[lo:lo + 8], now=T0)
        cache.note_update("lg-3")
        cache.lookup(["lg-3", "lg-4"], now=T0)
    later.bind_metrics(metrics)


def _session(metrics, side):
    if side == 0:
        from igaming_platform_tpu.serve.session_state import SessionStateManager as M

        mgr = M(8, metrics=metrics)
    else:
        from igaming_platform_tpu_torch.serve.session_state import SessionStateManager as M

        mgr = M(8, device="cpu", metrics=metrics)
    mgr.note_bypass(5)
    with mgr.lock:
        mgr.on_admit(["s1", "s2"], [0, 1])
        for k in range(4):
            mgr.prepare_chunk(["s1", "s2", "s1"], np.array([100.0, 5.0, 7.0], np.float32),
                              np.array([0, 2, 1], np.int32), T0 + k)
        mgr.on_admit(["s1"], [3])


def _shadow(metrics, side):
    from igaming_platform_tpu_torch.convert import from_jax_params

    tree, cand = jax_tree("mlp"), {"mlp": mlp_tree(9)}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(48, 30)).astype(np.float32) * 3
    bl = np.zeros((48,), bool)
    if side == 0:
        from igaming_platform_tpu.core.config import BatcherConfig as JB
        from igaming_platform_tpu.serve.scorer import TPUScoringEngine
        from igaming_platform_tpu.serve.shadow import ShadowScorer

        eng = TPUScoringEngine(ml_backend="mlp", params=tree, batcher_config=JB(batch_size=64))
        shadow = ShadowScorer(eng, cand, metrics=metrics)
        out = {k: np.asarray(v) for k, v in eng.score_arrays(np.pad(x, ((0, 16), (0, 0))),
                                                             np.pad(bl, (0, 16))).items()}
    else:
        from igaming_platform_tpu_torch.core.config import BatcherConfig
        from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine
        from igaming_platform_tpu_torch.serve.shadow import ShadowScorer

        eng = TorchScoringEngine(ml_backend="mlp", params=from_jax_params("mlp", tree),
                                 device="cpu", batcher_config=BatcherConfig(batch_size=64))
        shadow = ShadowScorer(eng, from_jax_params("mlp", cand), metrics=metrics)
        out = {k: v.numpy() for k, v in eng.score_arrays(x, bl).items()}
    try:
        out = {k: v[:48] for k, v in out.items()}
        for _ in range(3):
            assert shadow.submit(out, x=x, bl=bl, n=48)
        assert shadow.drain(20.0)
        shadow._stopping = True
        assert not shadow.submit(out, x=x, bl=bl, n=48)  # dropped, counted
    finally:
        shadow._stopping = False
        shadow.close()
        eng.close()


def _drift(metrics, side):
    from igaming_platform_tpu.obs import drift as jdrift
    from igaming_platform_tpu_torch.obs import drift as pdrift

    mod = (jdrift, pdrift)[side]
    clock = _Clock(T0)
    eng = mod.DriftEngine(mod.DriftConfig(window_s=30.0, bucket_s=5.0, min_rows=200,
                                          queue_max=64), metrics=metrics, clock=clock)
    rng = np.random.default_rng(44)
    try:
        for step in range(20):
            clock.t = T0 + 2.5 * step
            vec = _traffic(rng, 1.0 if step < 8 else 1e4)
            assert eng.submit(vec.copy(), int(vec[0]))
            eng.note_skipped(7)
            assert eng.drain(10.0)
            if step == 6:
                eng.set_reference(mod.DriftReference.from_sketch(
                    eng.window_vec(), source="clean", created_unix=T0))
            eng.evaluate()
    finally:
        eng.close()


def _ledger(metrics, side):
    import tempfile

    from torch_ledger_common import record

    from igaming_platform_tpu.serve import ledger as jl
    from igaming_platform_tpu_torch.serve import ledger as pl

    mod = (jl, pl)[side]
    with tempfile.TemporaryDirectory() as d:
        bound = mod.DecisionLedger(d + "/a", metrics=metrics)
        later = mod.DecisionLedger(d + "/b")
        later.bind_metrics(metrics)
        try:
            for ledger in (bound, later):
                for i in range(5):
                    ledger.append_record(record(mod, i))
                assert ledger.flush(10.0)
        finally:
            bound.close()
            later.close()
        assert not bound.append_record(record(mod, 9))  # a stopped ledger drops, counted


def _miner(metrics, side, tmp_path):
    from test_torch_online import _write_wal

    from igaming_platform_tpu.train import online as jonline
    from igaming_platform_tpu_torch.serve import ledger as pl
    from igaming_platform_tpu_torch.train import online as ponline

    _write_wal(pl, str(tmp_path / "wal"))
    assert (jonline, ponline)[side].LedgerMiner(str(tmp_path / "wal"), metrics=metrics).poll().n


def _ltv_job(metrics, side, tmp_path):
    from test_ltv_job import seeded_db

    from igaming_platform_tpu.serve import ltv_job as jjob
    from igaming_platform_tpu_torch.serve import ltv_job as pjob

    tmp_path.mkdir(parents=True, exist_ok=True)
    path = seeded_db(tmp_path)
    for now in (1_800_000_000, 1_800_090_000):
        if side == 0:
            jjob.run_batch_job(path, now=now, metrics=metrics)
        else:
            pjob.run_batch_job(path, now=now, device="cpu", metrics=metrics)


def _learner(metrics, side):
    from igaming_platform_tpu.train import online as jonline
    from igaming_platform_tpu_torch.train import online as ponline

    if side == 0:
        learner = jonline.OnlineLearner(trunk=(8,), batch_size=32, seed=0, metrics=metrics)
    else:
        learner = ponline.OnlineLearner(trunk=(8,), batch_size=32, seed=0, metrics=metrics,
                                        device="cpu")
    learner.train_steps(2)
    learner.train_steps(0)


class _Engine:
    ml_backend = "multitask"
    params_fingerprint = "00aa11bb22cc33dd"

    def get_params(self):
        return {"multitask": "served"}


class _Shadow:
    def window_rows(self):
        return 3

    def flip_rate(self):
        return 0.4


class _Probe:
    def auc(self, params):
        return 0.2


def _controller(metrics, side):
    from igaming_platform_tpu.train import promote as jpromote
    from igaming_platform_tpu_torch.train import promote as ppromote

    mod = (jpromote, ppromote)[side]
    ctl = mod.PromotionController(_Engine(), _Shadow(), probe=_Probe(), metrics=metrics)
    ok, table = ctl.gate_check({"multitask": "candidate"})
    assert not ok and sum(not row["ok"] for row in table.values()) >= 2
    ctl._record("forced_promote", "a" * 16, "b" * 16, "drill", None)
    ctl._record("auto_rollback", "b" * 16, "a" * 16, "drill", table)


SEAMS = {"cache": (_cache, ("feature_cache_", "cache_shard_", "hbm_bytes")),
         "session": (_session, ("session_", "hbm_bytes")),
         "shadow": (_shadow, ("shadow_",)),
         "drift": (_drift, ("drift_",)),
         "ledger": (_ledger, ("ledger_records", "ledger_dropped", "ledger_sink")),
         "miner": (_miner, ("online_mined",)),
         "ltv_job": (_ltv_job, ("ltv_segment",)),
         "learner": (_learner, ("online_train",)),
         "controller": (_controller, ("promotion",))}


@pytest.mark.parametrize("seam", sorted(SEAMS))
def test_metrics_seam_matches_jax(seam, tmp_path, no_jax_hostprof):
    drive, prefixes = SEAMS[seam]
    lines = []
    for side, mod in enumerate((jmetrics, pmetrics)):
        metrics = mod.ServiceMetrics("risk")
        if seam in ("miner", "ltv_job"):
            drive(metrics, side, tmp_path / str(side))
        else:
            drive(metrics, side)
        lines.append(_family_lines(metrics, prefixes))
    assert lines[1] == lines[0]
    assert lines[1], f"{seam}: nothing exported"
