"""Port parity: igaming_platform_tpu_torch/tools/replay.py, the params vault and
tools/driftref.py, on the CPU.

- ``run_verify`` (the mock engine's batch, batcher and wire paths under a
  ledger-append chaos plan) replays with ``ok``;
- a fingerprint no params source resolves is flagged, a tampered score is
  caught, a tampered vault entry raises;
- an ``mlp+gbdt`` WAL written across a ``swap_params``, by the batch, batcher
  and both wire paths, replays bit-exact through the vault (and the first
  tree through ``--params``); each note batch replays in the chunks and
  ladder shapes the engine used;
- ``heuristic_scores`` equals JAX's; a port-written session WAL passes the
  port's ``verify_session_chain`` and JAX's ``tools/replay.py`` one with
  equal counts, and a tampered session hash is caught;
- a drift reference minted from a port-written WAL loads in both packages,
  from the same sketch as JAX's ``tools/driftref.py`` gives.
"""

import numpy as np
import pytest
from test_torch_ensemble import jax_tree
from test_torch_gbdt import _forest
from torch_ledger_common import T0, engines, pin_ledgers, record, requests, seed_stores

from igaming_platform_tpu.obs import drift as jdrift
from igaming_platform_tpu.serve import ledger as jl
from igaming_platform_tpu.serve.supervisor import heuristic_scores as jheuristic
from igaming_platform_tpu_torch.convert import from_jax_params, load_params_tree, save_params_tree
from igaming_platform_tpu_torch.obs import drift as pdrift
from igaming_platform_tpu_torch.serve import ledger as pl
from igaming_platform_tpu_torch.serve.supervisor import heuristic_scores
from igaming_platform_tpu_torch.tools import driftref, replay
from igaming_platform_tpu_torch.train.promote import vault_load, vault_save
from tools import driftref as jdriftref
from tools import replay as jreplay

TREE = jax_tree("mlp+gbdt")
OTHER = {**TREE, "gbdt": _forest(12)}


def _rewrite(src: str, dst: str, edit) -> None:
    """Copy the decisions of one WAL into another, ``edit`` applied to the
    list, records as they are (``append_record`` would drop a session tail)."""
    records = list(pl.iter_records(src))
    edit(records)
    led = pl.DecisionLedger(dst)
    try:
        assert led._append_ready(records)
        assert led.flush(5.0)
    finally:
        led.close()


def test_run_verify_replays_ok(tmp_path):
    verdict = replay.run_verify(str(tmp_path / "rv"), rows=48, batch=32, device="cpu")
    assert verdict["ok"], verdict
    assert verdict["mismatches"] == verdict["params_fingerprint_mismatch"] == 0
    assert verdict["replayed"] == verdict["records_total"] == 48 + 8 + 48
    assert verdict["device"] == "cpu" and verdict["replayed_by_tier"] == {"device": 104}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replay.main(["--verify"])


def test_fingerprint_mismatch_and_tampering_caught(tmp_path, monkeypatch):
    pin_ledgers(monkeypatch)
    d = str(tmp_path / "fp")
    led = pl.DecisionLedger(d)
    try:
        rec = record(pl, 0)
        rec.model_version = "mock"
        led.append_record(rec)  # no engine has this fingerprint
        assert led.flush(5.0)
    finally:
        led.close()
    verdict = replay.replay_directory(d, batch=32, device="cpu")
    assert verdict["params_fingerprint_mismatch"] == 1 and not verdict["ok"]

    _, teng = engines({}, "mock", seed_stores())
    d = str(tmp_path / "scored")
    teng.ledger = led = pl.DecisionLedger(d)
    try:
        teng.score_batch(requests(8)[1])
        assert led.flush(5.0)
    finally:
        led.close()
        teng.close()

    def lie(records):
        records[3].score += 7  # the outputs no longer match the snapshot

    _rewrite(d, str(tmp_path / "tampered"), lie)
    verdict = replay.replay_directory(str(tmp_path / "tampered"), batch=32, device="cpu")
    assert verdict["mismatches"] == 1 and not verdict["ok"]
    sample = verdict["mismatch_samples"][0]
    assert sample["recorded"]["score"] == sample["recomputed"]["score"] + 7


def test_replay_across_swap_through_vault(tmp_path, monkeypatch):
    pin_ledgers(monkeypatch)
    _, teng = engines(TREE, "mlp+gbdt", seed_stores())
    d = str(tmp_path / "swap")
    vault = str(tmp_path / "swap" / "params-vault")
    teng.ledger = led = pl.DecisionLedger(d)
    shapes = []
    try:
        first = vault_save(vault, teng.get_params(), "mlp+gbdt")
        second = vault_save(vault, from_jax_params("mlp+gbdt", OTHER), "mlp+gbdt")
        assert first == teng.params_fingerprint and second != first
        treqs = requests(40)[1]
        for swap in (False, True):
            if swap:
                teng.swap_params(from_jax_params("mlp+gbdt", OTHER))
            teng.score_batch(treqs)
            for r in treqs[:3]:
                teng.score(r)
            for pipelined in (False, True):
                teng._pipeline_enabled = pipelined
                teng.score_batch_wire([r.account_id for r in treqs], [r.amount for r in treqs],
                                      [r.tx_type for r in treqs])
        assert led.flush(5.0)
    finally:
        led.close()
        teng.close()
    launch = replay._replay_compiled

    def spy(engine, records):
        out = launch(engine, records)
        shapes.append([engine._pick_shape(min(engine.batch_size, len(records) - lo))
                       for lo in range(0, len(records), engine.batch_size)])
        return out

    monkeypatch.setattr(replay, "_replay_compiled", spy)
    verdict = replay.replay_directory(d, batch=32, tiers=(8,), device="cpu")
    assert verdict["ok"], verdict["mismatch_samples"]
    assert verdict["replayed"] == verdict["records_total"] == 2 * (40 + 3 + 80)
    assert verdict["replayed_by_params_fp"] == {first: 123, second: 123}
    # score_batch notes each chunk, the batcher each flush, a wire RPC the
    # whole RPC: replayed as 32 + 8 rows (shapes 32, 8) and single rows.
    assert sorted(map(tuple, shapes)) == sorted(
        2 * ([(32,), (8,)] + [(8,)] * 3 + [(32, 8)] * 2))

    params = str(tmp_path / "tree.npz")
    save_params_tree(params, TREE)
    got = load_params_tree(params)
    np.testing.assert_array_equal(got["mlp"]["layers"][1]["w"], TREE["mlp"]["layers"][1]["w"])
    args = ["--dir", d, "--device", "cpu", "--batch", "32", "--params", params,
            "--params-vault", str(tmp_path / "empty"), "--out", str(tmp_path / "v.json")]
    assert replay.main(args) == 1  # the swapped tree is in no source
    verdict = replay.replay_directory(d, batch=32, tiers=(8,), device="cpu", params=params,
                                      vault_dir=str(tmp_path / "empty"))
    assert verdict["replayed_by_params_fp"] == {first: 123}
    assert verdict["params_fingerprint_mismatch"] == 123 and verdict["mismatches"] == 0

    entry = f"{vault}/{second}.npz"
    with np.load(entry) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["gbdt.bias"] = arrays["gbdt.bias"] + np.float32(1.0)
    with open(entry, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(ValueError, match="vault corrupt"):
        vault_load(vault, second)
    with pytest.raises(RuntimeError, match="vault corrupt"):
        replay.replay_directory(d, batch=32, tiers=(8,), device="cpu")


@pytest.mark.parametrize("backend", ["mlp", "gbdt", "multitask", "mlp+gbdt_int8",
                                     "multitask_int8"])
def test_vault_round_trip(tmp_path, backend):
    """Every backend's installed tree comes back from the vault as the same
    modules, under the same fingerprint; another backend's name is refused."""
    from igaming_platform_tpu_torch.ops.quantize import quantize_checkpoint
    from igaming_platform_tpu_torch.serve.scorer import params_fingerprint

    tree = {**TREE, "multitask": jax_tree("multitask")["multitask"]}
    name = backend
    if backend.endswith("_int8"):
        tree, name = quantize_checkpoint(tree, backend[:-len("_int8")])
    params = from_jax_params(name, tree)
    fp = vault_save(str(tmp_path), params, name)
    assert vault_save(str(tmp_path), params, name) == fp == params_fingerprint(params)
    back = vault_load(str(tmp_path), fp, name)
    assert params_fingerprint(back) == fp
    assert {k: type(v) for k, v in back.items()} == {k: type(v) for k, v in params.items()}
    assert vault_load(str(tmp_path), "0" * 16) is None
    with pytest.raises(ValueError, match="holds"):
        vault_load(str(tmp_path), fp, "mock")


def test_heuristic_scores_equal_jax():
    rng = np.random.default_rng(3)
    x = rng.random((400, 30)).astype(np.float32) * rng.choice([1.0, 20.0, 90_000.0], (400, 30))
    bl = rng.random(400) < 0.1
    for thr in ((80, 50), (30, 10)):
        got, want = heuristic_scores(x, bl, thr), jheuristic(x, bl, thr)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype
        assert len(np.unique(got["score"])) > 3


def test_session_chain_passes_both_packages(tmp_path, monkeypatch):
    pin_ledgers(monkeypatch)
    monkeypatch.setenv("SESSION_EVENTS", "6")
    _, teng = engines(TREE, "mlp+gbdt", seed_stores(), batch=8, tiers=(4,), feature_cache=16,
                      session_state=True)
    d = str(tmp_path / "sess")
    teng.ledger = led = pl.DecisionLedger(d)
    rng = np.random.default_rng(2)
    try:
        teng.ensure_cache()
        for k in range(12):
            ids = [f"lg-{a}" for a in rng.integers(0, 10, (1, 5, 11)[k % 3])]
            teng.score_columns_cached(ids, [int(a) for a in rng.integers(100, 9000, len(ids))],
                                      ["bet"] * len(ids), now=T0 + 45.0 * k)
        assert led.flush(5.0)
    finally:
        led.close()
        teng.close()
    got = replay.verify_session_chain(list(pl.iter_records(d)))
    want = jreplay.verify_session_chain(list(jl.iter_records(d)))
    assert got == want
    assert got["session_ok"] and got["session_verified"] == got["session_records"] == 12 * 17 // 3
    verdict = replay.replay_directory(d, batch=8, tiers=(4,), device="cpu")
    assert verdict["ok"] and verdict["replayed"] == 0
    assert verdict["session_verified"] == verdict["skipped_no_snapshot"] == 68

    def flip(records):
        records[20].session_hash = "f" * 16

    _rewrite(d, str(tmp_path / "flipped"), flip)
    verdict = replay.replay_directory(str(tmp_path / "flipped"), batch=8, device="cpu")
    assert verdict["session_hash_mismatch"] == 1 and not verdict["ok"]


def test_driftref_from_port_wal_loads_in_both(tmp_path):
    d = str(tmp_path / "rv")
    assert replay.run_verify(d, rows=40, batch=16, device="cpu")["ok"]
    led = pl.DecisionLedger(d)
    try:
        for i, rec in enumerate(pl.iter_records(d)):
            if i % 4 == 0:
                led.append_outcome(pl.OutcomeRecord(rec.decision_id, i % 8 == 0, "chargeback", T0))
        assert led.flush(5.0)
    finally:
        led.close()
    vec, cal, stats = driftref.sketch_from_ledger(d)
    jvec, jcal, jstats = jdriftref.sketch_from_ledger(d)
    np.testing.assert_array_equal(vec, jvec)
    np.testing.assert_array_equal(cal, jcal)
    assert stats == jstats and stats["outcomes_joined"] > 0
    out = str(tmp_path / "ref.json")
    assert driftref.main(["--ledger", d, "--out", out]) == 0
    assert driftref.main(["--ledger", d, "--verify"]) == 0
    fp = pdrift.DriftReference.load(out).fingerprint()
    assert jdrift.DriftReference.load(out).fingerprint() == fp
    with pytest.raises(NotImplementedError):
        driftref.main(["--synthetic"])
