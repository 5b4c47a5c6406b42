"""Port parity: model-quality evaluation and device parity
(``train/{eval,gates,device_parity}.py``) against the JAX package's.

The metric functions and the gate tables are exact on the same inputs. A
small ``run_eval`` (4,000 / 2,000 rows, 40 steps), with the JAX package's
inits carried into the port's initialisers, keeps the JAX package's
ordering gates and its AUCs, the ``routed_trained`` row's among them (its
bundle from the JAX ``init_routed_params`` tree). ``device_parity.run`` on
the CPU reports both sides equal and ``ok``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from igaming_platform_tpu.models import ensemble as jensemble
from igaming_platform_tpu.models import gbdt as jgbdt
from igaming_platform_tpu.models import multitask as jmultitask
from igaming_platform_tpu.train import eval as jeval
from igaming_platform_tpu.train import gates as jgates
from igaming_platform_tpu.train import routed as jrouted
from igaming_platform_tpu_torch import convert
from igaming_platform_tpu_torch.models import gbdt as pgbdt
from igaming_platform_tpu_torch.train import device_parity, gates
from igaming_platform_tpu_torch.train import eval as peval
from igaming_platform_tpu_torch.train import routed as prouted
from igaming_platform_tpu_torch.train import trainer as ptrainer


def _scores(case: int):
    rng = np.random.default_rng(case)
    y = (rng.random(700) < 0.2).astype(np.float32)
    if case == 0:
        p = rng.random(700)
    elif case == 1:  # heavy ties, as integer scores give
        p = np.floor(rng.random(700) * 20) / 20
    else:  # informative, with a calibration offset
        p = np.clip(0.6 * y + 0.5 * rng.random(700) - 0.1, 0, 1)
    return y, p


@pytest.mark.parametrize("case", [0, 1, 2])
def test_metrics_and_gate_tables_exact(case):
    y, p = _scores(case)
    for name in ("roc_auc", "average_precision", "expected_calibration_error", "metrics"):
        assert getattr(peval, name)(y, p) == getattr(jeval, name)(y, p), name
    models = {k: peval.metrics(*_scores(case + i)) for i, k in enumerate(
        ("rules_only", "mock", "gbdt_trained", "multitask_trained"))}
    assert gates.ordering_gates(models) == jgates.ordering_gates(models)
    assert gates.eval_gates(models) == jgates.eval_gates(models)
    table = dict(candidate_auc=0.91 + 0.01 * case, baseline_auc=0.93, shadow_rows=100 * case,
                 flip_rate=0.05 * case, slo_alerting=case == 1, drift_alerting=case == 2)
    assert gates.promotion_gate_table(gates=gates.PromotionGates(), **table) == \
        jgates.promotion_gate_table(gates=jgates.PromotionGates(), **table)


@pytest.fixture
def jax_inits(monkeypatch):
    def init_multitask(gen, trunk):
        return convert.train_multitask_from_tree(jax.tree.map(
            np.asarray, jmultitask.init_multitask(jax.random.key(0), trunk=trunk)))

    monkeypatch.setattr(ptrainer, "init_multitask", init_multitask)
    monkeypatch.setattr(pgbdt, "init_gbdt", lambda gen, n_trees, depth: {
        k: torch.from_numpy(np.array(v)) for k, v in jax.tree.map(
            np.asarray, jgbdt.init_gbdt(jax.random.key(0), n_trees=n_trees, depth=depth)).items()})

    def init_routed(seed, **kw):
        return convert.routed_train_from_tree(jax.tree.map(
            np.asarray, jensemble.init_routed_params(jax.random.key(seed), **kw)))

    monkeypatch.setattr(prouted, "init_routed_train_params", init_routed)


def test_small_run_eval_matches_jax(jax_inits, tmp_path, monkeypatch):
    got = peval.run_eval(n_train=4000, n_test=2000, steps=40, device="cpu")
    assert "not_ported" not in got and got["train"]["routed_steps"] == 40
    # The JAX side of the same table.
    x_tr, y_tr, _ = jeval.generate_labeled(np.random.default_rng(0), 4000, 0.12)
    x_te, y_te, _ = jeval.generate_labeled(np.random.default_rng(1), 2000, 0.12)
    jmt = jeval.train_multitask_on_labels(x_tr, y_tr, steps=40)
    jgb = jeval.train_gbdt_on_labels(x_tr, y_tr, steps=150)
    jrt = jrouted.train_routed_on_labels(x_tr, y_tr, jrouted.RoutedTrainConfig(steps=40))
    want = {"rules_only": jeval.metrics(y_te, jeval._rules_prob(x_te, jeval.ScoringConfig())),
            "mock": jeval.metrics(y_te, jeval._mock_prob(x_te)),
            "multitask_trained": jeval.metrics(y_te, jeval.multitask_prob(jmt, x_te)),
            "gbdt_trained": jeval.metrics(y_te, jeval.gbdt_prob(jgb, x_te)),
            "routed_trained": jeval.metrics(y_te, jrouted.routed_prob(jrt, x_te))}
    for name, row in want.items():
        # The routed bundle's router sees raw features: its logits run to
        # thousands, so its gates differ from XLA's in the fifth digit, and
        # Adam's first steps (about lr * sign(g)) turn gradients of 1e-10
        # that differ in their first digit into steps of lr. Its row is held
        # to a wider bound; tests/test_torch_train_mesh.py holds the trainer
        # itself to JAX's at 1e-6.
        tol = 1e-2 if name == "routed_trained" else 2e-3
        for k in ("auc", "average_precision"):
            assert abs(got["models"][name][k] - row[k]) <= tol, (name, k, got["models"][name])
    assert got["ordering"] == jgates.ordering_gates(want)
    assert got["ordering"]["mock_beats_rules"] and got["ordering"]["gbdt_beats_mock"]

    out = tmp_path / "eval.json"
    monkeypatch.setattr(peval, "run_eval", lambda **kw: got)
    peval.main(["--out", str(out), "--device", "cpu"])
    assert json.loads(out.read_text())["models"] == got["models"]
    with pytest.raises(SystemExit):
        peval.main([])  # no --out: never a default file


def test_device_parity_on_cpu():
    out = device_parity.run(n_rows=2000, steps=20, device="cpu")
    assert out["ok"] and out["same_backend"]
    for name in ("multitask", "gbdt"):
        assert out[name]["max_prob_delta"] == 0.0
        assert out[name]["rows_bit_equal"] == out["rows"] == 400
