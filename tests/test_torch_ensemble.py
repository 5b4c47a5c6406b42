"""Port parity: models/ensemble.py (make_score_fn) for each of the five backends.

One raw batch, one blacklist and one pair of thresholds go through the JAX
package's ``make_score_fn`` and the port's on the CPU. Params come from a
numpy seed through ``convert.from_jax_params``.

Tolerances:
- ``rule_score`` and ``reason_mask`` exact (float32 compares, integer sums);
- ``ml_score`` atol 1e-6 (see tests/test_torch_models.py and test_torch_gbdt.py);
- ``score`` and ``action`` exact on every row whose pre-floor value
  ``0.4*rule + 60*ml + 1e-4`` lies more than 1e-4 from an integer, where
  a 1e-6 change in ``ml_score`` cannot move the floor, and on every row
  whose ``ml_score`` agrees to the bit. The rest are counted and printed.
"""

import numpy as np
import pytest
import torch
from test_torch_gbdt import _forest
from test_torch_models import mlp_tree, multitask_tree
from test_torch_rules_mock import _boundary_batch, _raw_batch

from igaming_platform_tpu.core.config import ScoringConfig as JScoringConfig
from igaming_platform_tpu.models.ensemble import make_score_fn as jmake_score_fn
from igaming_platform_tpu_torch.convert import from_jax_params
from igaming_platform_tpu_torch.core.config import ScoringConfig
from igaming_platform_tpu_torch.models.ensemble import combine, make_score_fn

BACKENDS = ("mock", "mlp", "gbdt", "mlp+gbdt", "multitask")


def jax_tree(backend):
    trees = {"mlp": mlp_tree(10), "gbdt": _forest(11), "multitask": multitask_tree(12)}
    if backend == "mock":
        return {}
    if backend == "mlp+gbdt":
        return {"mlp": trees["mlp"], "gbdt": trees["gbdt"]}
    return {backend: trees[backend]}


def assert_outputs_match(got, want, label):
    """The module's tolerances; returns the number of floor-boundary rows."""
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.cpu().numpy() for k, v in got.items()}
    for key in ("rule_score", "reason_mask"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"{label} {key}")
    np.testing.assert_allclose(got["ml_score"], want["ml_score"], rtol=0, atol=1e-6,
                               err_msg=f"{label} ml_score")
    pre = 0.4 * want["rule_score"] + 60.0 * want["ml_score"].astype(np.float64) + 1e-4
    # A row whose ml_score agrees to the bit goes through the same float32
    # ops in both packages, so it is held exactly wherever it lies.
    same_ml = got["ml_score"].view(np.int32) == want["ml_score"].view(np.int32)
    checked = (np.abs(pre - np.round(pre)) > 1e-4) | same_ml
    for key in ("score", "action"):
        np.testing.assert_array_equal(got[key][checked], want[key][checked],
                                      err_msg=f"{label} {key}")
    n_boundary = int((~checked).sum())
    print(f"{label}: {n_boundary} of {checked.size} rows within 1e-4 of a floor boundary")
    return n_boundary


@pytest.mark.parametrize("backend", BACKENDS)
def test_make_score_fn_matches_jax(backend):
    x = np.concatenate([_raw_batch(20, 384), _boundary_batch()])
    bl = np.random.default_rng(21).random(x.shape[0]) < 0.05
    thresholds = np.array([70, 40], dtype=np.int32)
    tree = jax_tree(backend)
    want = jmake_score_fn(JScoringConfig(), backend)(tree, x, bl, thresholds)
    fn = make_score_fn(ScoringConfig(), backend, device="cpu")
    got = fn(from_jax_params(backend, tree), x, bl, torch.from_numpy(thresholds))
    assert {k: v.dtype for k, v in got.items()} == {
        "score": torch.int32, "action": torch.int32, "rule_score": torch.int32,
        "ml_score": torch.float32, "reason_mask": torch.int32}
    assert_outputs_match(got, want, backend)
    # Without a thresholds input the config's thresholds apply.
    want_cfg = jmake_score_fn(JScoringConfig(), backend)(tree, x, bl)
    assert_outputs_match(fn(from_jax_params(backend, tree), x, bl), want_cfg, backend + "/cfg")


def test_unknown_backend_raises():
    for name in ("routed", "mlp_int4", "gbdt_fp8", "nope"):
        with pytest.raises(ValueError, match="unknown ml backend"):
            make_score_fn(ScoringConfig(), name, device="cpu")


def test_combine_float32_association():
    """(0.4*rule + (0.6*ml)*100) + 1e-4 in float32, then floor and cap."""
    rule = torch.tensor([0, 50, 100, 20, 0], dtype=torch.int32)
    ml = torch.tensor([0.5, 0.999999, 1.0, 0.71, np.float32(1) / 3], dtype=torch.float32)
    final, action, mask = combine(rule, ml, torch.zeros(5, dtype=torch.int32), ScoringConfig())
    r32, m32 = rule.numpy().astype(np.float32), ml.numpy()
    pre = (np.float32(0.4) * r32 + np.float32(0.6) * m32 * np.float32(100.0)) + np.float32(1e-4)
    np.testing.assert_array_equal(final.numpy(), np.minimum(np.floor(pre), 100).astype(np.int32))
    np.testing.assert_array_equal(mask.numpy() >> 8, m32 > np.float32(0.7))
    assert action.tolist() == [1, 3, 3, 2, 1]
