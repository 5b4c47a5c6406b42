"""Port parity: the online loop (``train/{online,promote}.py``), the
server's ``ONLINE_LOOP=1`` and ``driftref --synthetic``, on the CPU.

- the miner: one WAL mined by both packages gives equal ``MinedExamples``
  (rows, labels, hard flags, ids, counts, scores) and counters, for a WAL
  written by the JAX ledger and for one written by the port's;
- the learner: the same seed and reservoir give bit-equal batches, and from
  one JAX init the same losses (rtol 1e-4);
- the controller: the real probe's AUC within 1e-6 of JAX's on one tree; a
  scripted idle -> promote -> re-anchor -> injected regression -> rollback
  run takes the same transitions in both packages under the JAX tests'
  gates, and each package decodes the other's promotion records;
- the loop: a tick mines 24, trains and seats a candidate in the shadow;
  the next tick promotes it under the JAX tests' gates; a replay across the
  boundary finds no mismatch;
- the server: ``ONLINE_LOOP=1`` without a ledger, or with another backend
  than multitask, fails the boot as the JAX server's does; with both it
  answers ``/debug/promotion`` and ``/debug/shadowz``;
- ``driftref --synthetic`` writes the JAX tool's reference.
"""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from igaming_platform_tpu.core.config import BatcherConfig as JBatcherConfig
from igaming_platform_tpu.models.multitask import init_multitask as jinit_multitask
from igaming_platform_tpu.serve import ledger as jl
from igaming_platform_tpu.serve.scorer import ScoreRequest as JRequest
from igaming_platform_tpu.serve.scorer import TPUScoringEngine
from igaming_platform_tpu.serve.shadow import ShadowScorer as JShadow
from igaming_platform_tpu.train import gates as jgates
from igaming_platform_tpu.train import online as jonline
from igaming_platform_tpu.train import promote as jpromote
from igaming_platform_tpu_torch import convert
from igaming_platform_tpu_torch.core.config import BatcherConfig
from igaming_platform_tpu_torch.serve import ledger as pl
from igaming_platform_tpu_torch.serve.scorer import ScoreRequest, TorchScoringEngine
from igaming_platform_tpu_torch.serve.shadow import ShadowScorer
from igaming_platform_tpu_torch.train import gates, online, promote
from torch_front_common import no_jax_hostprof  # noqa: F401 — a fixture

LEDGERS = {"jax": jl, "port": pl}
# The JAX tests' controller gates (tests/test_online_promotion.py).
GATES = dict(min_candidate_auc=0.55, max_auc_drop=0.5, min_shadow_rows=8, max_flip_rate=1.0,
             require_slo_quiet=True, min_post_auc=0.55)


def _tree(seed: int, trunk=(32, 32)) -> dict:
    return jax.tree.map(np.asarray, jinit_multitask(jax.random.key(seed), trunk=trunk))


def _write_wal(mod, directory: str) -> None:
    """40 decisions with snapshots (hard negatives, hard positives, plain
    labels, unlabelled), an unmatched outcome and a promotion record."""
    ledger = mod.DecisionLedger(directory)
    rng = np.random.default_rng(3)
    try:
        for i in range(40):
            score = (85, 12, 20, 70)[i % 4]
            did = f"d-mine-{i:07x}.0"
            ledger.append_record(mod.DecisionRecord(
                decision_id=did, account_id=f"acct-{i}", trace_id="", model_version="multitask",
                params_fp="00aa11bb22cc33dd", wire_mode="batch", serving_state="serving",
                tier="device", score=score, action=2 if score >= 80 else int(score >= 50),
                reason_mask=0, rule_score=score,
                ml_score_bits=int(np.float32(score / 100.0).view(np.uint32)),
                amount=1000 + i, tx_type="deposit", block_threshold=80, review_threshold=50,
                ts_unix=1754300000.0 + i, blacklisted=False,
                features=rng.normal(size=30).astype(np.float32)))
            if i % 4 != 3:
                ledger.append_outcome(mod.OutcomeRecord(
                    decision_id=did, label=int(i % 4 == 1 or i % 8 == 2), source="review",
                    ts_unix=float(i)))
        ledger.append_outcome(mod.OutcomeRecord(decision_id="d-elsewhere.0", label=1,
                                                source="chargeback", ts_unix=99.0))
        ledger.append_promotion(mod.PromotionRecord(
            event="promote", old_fp="a" * 16, new_fp="b" * 16, model_version="multitask",
            reason="test", gates_json="{}", ts_unix=100.0))
        assert ledger.flush(10.0)
    finally:
        ledger.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_miner_equal_both_ways(tmp_path, writer):
    _write_wal(LEDGERS[writer], str(tmp_path))
    jm, pm = jonline.LedgerMiner(str(tmp_path)), online.LedgerMiner(str(tmp_path))
    want, got = jm.poll(), pm.poll()
    assert got.n == want.n == 30
    for k in ("x", "y", "hard", "scores"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.decision_ids == want.decision_ids and got.counts == want.counts
    assert pm.stats == jm.stats
    assert pm.stats["hard_negatives"] > 0 and pm.stats["hard_positives"] > 0
    assert pm.poll().n == 0 == jm.poll().n


def test_learner_batches_and_losses(tmp_path):
    _write_wal(pl, str(tmp_path))
    mined = online.LedgerMiner(str(tmp_path)).poll()
    jlearn = jonline.OnlineLearner(trunk=(16,), batch_size=64, seed=0)
    plearn = online.OnlineLearner(trunk=(16,), batch_size=64, seed=0, device="cpu")
    for learner in (jlearn, plearn):
        learner.ingest(mined)
    assert plearn.reservoir_size == jlearn.reservoir_size == 30
    for _ in range(3):
        got, want = plearn._batch(), jlearn._batch()
        for k in ("x", "fraud", "ltv", "churn"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    plearn.trainer.state = convert.trainer_state_from_jax(
        jax.device_get(jlearn.trainer.state.params), jax.device_get(jlearn.trainer.state.opt_state),
        0)
    np.testing.assert_allclose(plearn.train_steps(3)["loss"], jlearn.train_steps(3)["loss"],
                               rtol=1e-4)
    cand = plearn.candidate()["multitask"]
    assert next(cand.buffers()).device.type == "cpu"
    # A copy: the next step leaves it as it was.
    before = cand.fraud_head.b.clone()
    plearn.train_steps(1)
    assert (cand.fraud_head.b == before).all()


class _StubProbe:
    """Fingerprints marked good score 0.95, the rest 0.2: the gate logic
    without training time (the JAX tests' probe)."""

    def __init__(self, fingerprint):
        self.fingerprint = fingerprint
        self.good: set[str] = set()

    def mark_good(self, params) -> None:
        self.good.add(self.fingerprint(params))

    def auc(self, params) -> float:
        return 0.95 if self.fingerprint(params) in self.good else 0.2


class _FakeSLO:
    def alerts_active(self):
        return {"fast": False, "slow": False}


def test_quality_probe_matches_jax():
    tree = _tree(0)
    want = jpromote.QualityProbe(rows=512, seed=11).auc({"multitask": tree})
    probe = promote.QualityProbe(rows=512, seed=11)
    params = convert.from_jax_params("multitask", {"multitask": tree})
    got = probe.auc(params)
    assert abs(got - want) <= 1e-6, (got, want)
    neg = dict(tree, fraud_head={k: -v for k, v in tree["fraud_head"].items()})
    flipped = probe.auc(convert.from_jax_params("multitask", {"multitask": neg}))
    assert abs(flipped + got - 1.0) < 1e-9


def _script(side, engine, shadow, ledger, vault, candidate, reqs, fingerprint):
    probe = _StubProbe(fingerprint)
    probe.mark_good(engine.get_params())
    probe.mark_good(candidate)
    mod, gmod = (jpromote, jgates) if side == "jax" else (promote, gates)
    ctl = mod.PromotionController(engine, shadow, ledger=ledger,
                                  gates=gmod.PromotionGates(**GATES), probe=probe,
                                  slo_engine=_FakeSLO(), vault_dir=vault)
    actions = [ctl.tick()["action"]]
    shadow.set_candidate(candidate)
    engine.score_batch(reqs)
    assert shadow.drain(20.0)
    verdict = ctl.tick()
    actions.append(verdict["action"])
    actions.append(ctl.tick()["action"])
    ctl.inject_regression()
    actions.append(ctl.tick()["action"])
    return actions, verdict["gates"], [h["event"] for h in ctl.history], ctl


def test_controller_script_matches_jax(tmp_path, monkeypatch, no_jax_hostprof):
    for knob in ("SLO", "DRIFT", "RUNTIME_TELEMETRY"):
        monkeypatch.setenv(knob, "0")
    p0, p1 = _tree(0), _tree(2)
    runs = {}
    for side in ("jax", "port"):
        wal = str(tmp_path / side)
        if side == "jax":
            engine = TPUScoringEngine(ml_backend="multitask", params={"multitask": p0},
                                      batcher_config=JBatcherConfig(batch_size=32,
                                                                    max_wait_ms=1.0))
            shadow, cand = JShadow(engine), {"multitask": p1}
            reqs = [JRequest(f"pr-{i}", amount=500 + i) for i in range(16)]
            fingerprint = jl.params_fingerprint
        else:
            engine = TorchScoringEngine(
                ml_backend="multitask", params=convert.from_jax_params("multitask",
                                                                       {"multitask": p0}),
                batcher_config=BatcherConfig(batch_size=32, max_wait_ms=1.0), device="cpu")
            shadow = ShadowScorer(engine)
            cand = convert.from_jax_params("multitask", {"multitask": p1})
            reqs = [ScoreRequest(f"pr-{i}", amount=500 + i) for i in range(16)]
            fingerprint = promote.params_fingerprint
        ledger = LEDGERS[side].DecisionLedger(wal)
        engine.ledger = ledger
        engine.shadow = shadow
        try:
            runs[side] = _script(side, engine, shadow, ledger, str(tmp_path / f"{side}-vault"),
                                 cand, reqs, fingerprint)
            assert ledger.flush(10.0)
        finally:
            ledger.close()
            shadow.close()
            engine.close()
    (ja, jg, jh, _), (pa, pg, ph, pctl) = runs["jax"], runs["port"]
    assert pa == ja == ["idle", "promote", "idle", "rollback"]
    assert pg == jg and ph == jh
    assert pctl.promotions == 2 and pctl.rollbacks == 1
    # Each package decodes the other's promotion records alike.
    for side in ("jax", "port"):
        wal = str(tmp_path / side)
        got = [(r.event, r.old_fp, r.new_fp, r.gates_json) for r in pl.iter_promotions(wal)]
        want = [(r.event, r.old_fp, r.new_fp, r.gates_json) for r in jl.iter_promotions(wal)]
        assert got == want and [e for e, *_ in got] == ["promote", "promote", "rollback"]
    # The vault holds the boot tree, the candidate and the regression.
    assert len(list((tmp_path / "port-vault").iterdir())) == 3


def test_loop_tick_promotes_and_replays(tmp_path, monkeypatch):
    from igaming_platform_tpu_torch.tools.replay import replay_directory

    for knob in ("SLO", "DRIFT"):
        monkeypatch.setenv(knob, "0")
    wal = str(tmp_path / "wal")
    ledger = pl.DecisionLedger(wal)
    engine = TorchScoringEngine(
        ml_backend="multitask", params=convert.from_jax_params("multitask",
                                                               {"multitask": _tree(0)}),
        batcher_config=BatcherConfig(batch_size=32, max_wait_ms=1.0), device="cpu")
    engine.ledger = ledger
    shadow = ShadowScorer(engine)
    engine.shadow = shadow
    try:
        ctl = promote.PromotionController(
            engine, shadow, ledger=ledger, gates=gates.PromotionGates(**GATES),
            probe=promote.QualityProbe(rows=512, seed=11), vault_dir=f"{wal}/params-vault")
        loop = online.OnlineLoop(
            miner=online.LedgerMiner(wal),
            learner=online.OnlineLearner(trunk=(16,), batch_size=64, seed=0, device="cpu"),
            shadow=shadow, controller=ctl, tick_s=60.0, steps_per_tick=2,
            min_examples_to_train=8)
        reqs = [ScoreRequest(f"lp-{i}", amount=400 + 37 * i) for i in range(24)]
        responses = engine.score_batch(reqs)
        for i, r in enumerate(responses):
            ledger.append_outcome(pl.OutcomeRecord(decision_id=r.decision_id, label=i % 2,
                                                   source="manual_review", ts_unix=float(i)))
        assert ledger.flush(10.0)
        out = loop.tick()
        assert out["mined"] == 24 and out["trained"] is True
        assert loop.learner.steps_total == 2
        assert shadow.candidate_fp != engine.params_fingerprint
        report = loop.report()
        assert report["miner"]["mined_total"] == 24
        assert report["shadow"]["candidate_fp"] == shadow.candidate_fp
        assert report["promotion"]["serving_fp"] == engine.params_fingerprint
        candidate_fp = shadow.candidate_fp
        engine.score_batch(reqs[:16])
        assert shadow.drain(20.0)
        out = loop.tick()
        assert out["controller"]["action"] == "promote", out
        assert engine.params_fingerprint == candidate_fp
        engine.score_batch(reqs)
        assert ledger.flush(10.0)
    finally:
        ledger.close()
        shadow.close()
        engine.close()
    verdict = replay_directory(wal, batch=32, tiers=BatcherConfig().latency_tiers, device="cpu")
    assert verdict["ok"], verdict
    assert verdict["params_fingerprint_mismatch"] == 0
    assert len(verdict["replayed_by_params_fp"]) == 2
    assert verdict["promotions"][0]["event"] == "promote"


def _call(port, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=None if body is None else json.dumps(body).encode(),
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


@pytest.mark.parametrize("case", ["no_ledger", "mock_backend", "boots"])
def test_server_online_loop(tmp_path, monkeypatch, case):
    from igaming_platform_tpu_torch.core.config import RiskServiceConfig
    from igaming_platform_tpu_torch.serve import server
    from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore

    model = tmp_path / "model.npz"
    convert.save_params_tree(str(model), {"multitask": _tree(0)})
    monkeypatch.setenv("ONLINE_LOOP", "1")
    monkeypatch.setenv("DRIFT", "0")
    monkeypatch.setenv("ONLINE_TICK_S", "600")
    monkeypatch.setenv("ONLINE_TRUNK", "16")
    monkeypatch.setenv("PROMOTE_PROBE_ROWS", "256")
    if case != "no_ledger":
        monkeypatch.setenv("LEDGER_DIR", str(tmp_path / "wal"))
    if case != "mock_backend":
        monkeypatch.setenv("FRAUD_MODEL_PATH", str(model))
    config = RiskServiceConfig.from_env()
    if case != "boots":
        with pytest.raises(RuntimeError, match="LEDGER_DIR" if case == "no_ledger"
                           else "multitask"):
            server.assemble_risk_service(config, feature_store=InMemoryFeatureStore(),
                                         device="cpu")
        return
    srv = server.RiskServer(server.assemble_risk_service(
        config, feature_store=InMemoryFeatureStore(), device="cpu"), grpc_port=-1, http_port=0)
    try:
        assert srv.engine.shadow is srv.online.shadow
        status, rep = _call(srv.http_port, "/debug/promotion", {"action": "tick"})
        assert status == 200 and rep["serving_fp"] == srv.engine.params_fingerprint
        assert _call(srv.http_port, "/debug/promotion", {"action": "nope"})[0] == 400
        assert _call(srv.http_port, "/debug/promotion", {"action": "pause"})[1]["paused"]
        status, shadowz = _call(srv.http_port, "/debug/shadowz")
        assert status == 200 and {"loop", "miner", "learner", "shadow", "promotion"} <= set(
            shadowz)
        assert (tmp_path / "wal" / "params-vault").is_dir()
    finally:
        srv.shutdown(grace=1.0)
    assert srv.online._thread is None


def test_driftref_synthetic_matches_jax(tmp_path):
    from igaming_platform_tpu_torch.tools import driftref
    from tools import driftref as jdriftref

    a, b = tmp_path / "jax.json", tmp_path / "port.json"
    assert jdriftref.main(["--synthetic", "--rows", "3000", "--seed", "5", "--out", str(a)]) == 0
    assert driftref.main(["--synthetic", "--rows", "3000", "--seed", "5", "--out", str(b),
                          "--device", "cpu"]) == 0
    want, got = json.loads(a.read_text()), json.loads(b.read_text())
    want.pop("created_unix"), got.pop("created_unix")
    assert got == want
