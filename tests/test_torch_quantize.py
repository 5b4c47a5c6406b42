"""Port parity: ops/quantize.py and the four int8 backends of models/ensemble.py.

The same seeded numpy trees and rows go through the JAX package's
quantizers and int8 functions and the port's, on the CPU:

- the load-time quantizers (``quantize_checkpoint`` for each recipe, with
  and without a calibration batch): every int8 code and float32 scale
  bit-equal;
- ``wire_quantize_int8``: codes equal, non-finite inputs included;
- ``wire_dequantize_int8`` over every code of every feature: the linear
  features bit-equal; the signed-log ones go through ``expm1``, which the
  two packages compute differently: the elements that differ are counted,
  printed and held within 3 ulp (log1p's distance in
  tests/test_torch_features.py);
- ``mlp_predict_int8`` and ``gbdt_predict_int8`` (the forest on its plain
  version here) against the JAX functions, eager and jitted: atol 1e-6, the
  ``ml_score`` bar of tests/test_torch_ensemble.py;
- the four int8 engines (``make_score_fn``) against JAX's, with that test's
  ``assert_outputs_match`` (integer columns exact except the counted
  floor-boundary rows);
- the released checkpoint's committed ``int8`` scores exact through the
  port's ``multitask_int8``, calibrated with the port's own normalize.
"""

import jax
import numpy as np
import pytest
import torch
from test_release_golden import _load as load_released
from test_torch_ensemble import assert_outputs_match
from test_torch_gbdt import _forest
from test_torch_models import _model_inputs, mlp_tree, multitask_tree
from test_torch_rules_mock import _boundary_batch, _raw_batch

from igaming_platform_tpu.core.config import ScoringConfig as JScoringConfig
from igaming_platform_tpu.core.features import normalize as jnormalize
from igaming_platform_tpu.core.features import standardize_for_model as jstandardize
from igaming_platform_tpu.models.ensemble import make_score_fn as jmake_score_fn
from igaming_platform_tpu.ops import quantize as jq
from igaming_platform_tpu_torch.convert import from_jax_params
from igaming_platform_tpu_torch.core.config import ScoringConfig
from igaming_platform_tpu_torch.core.features import normalize, standardize_for_model
from igaming_platform_tpu_torch.models.ensemble import make_score_fn
from igaming_platform_tpu_torch.ops import quantize as tq

ML_ATOL = 1e-6
EXPM1_ULP = 3


def _trees():
    return {"mlp": mlp_tree(30), "gbdt": _forest(31), "multitask": multitask_tree(32)}


def _calibration(seed=33, n=512):
    return np.asarray(jstandardize(jnormalize(_raw_batch(seed, n))), np.float32)


def _flat(tree, prefix=""):
    """(path, leaf) pairs of a params tree of arrays, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("backend", ["mlp", "gbdt", "mlp+gbdt", "multitask"])
def test_quantizers_bit_equal_to_jax(backend, calibrated):
    trees = _trees()
    tree = {k: trees[k] for k in backend.split("+")}
    cal = _calibration() if calibrated else None
    want, wname = jq.quantize_checkpoint(tree, backend, cal)
    got, gname = tq.quantize_checkpoint(tree, backend, cal)
    assert gname == wname
    w = dict(_flat(want))
    g = dict(_flat(got))
    assert g.keys() == w.keys()
    for path, wv in w.items():
        gv = g[path]
        if wv is None or isinstance(wv, bool):
            assert gv is wv or gv == wv, path
            continue
        wv = np.asarray(wv)
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, path
        np.testing.assert_array_equal(np.atleast_1d(gv).view(np.uint8),
                                      np.atleast_1d(wv).view(np.uint8), err_msg=path)
    assert any(v.dtype == np.int8 for v in g.values() if isinstance(v, np.ndarray))
    # The port carries the tree across with int8 codes and float32 scales.
    params = from_jax_params(gname, got)
    for key in params:
        state = params[key].state_dict() if hasattr(params[key], "state_dict") else params[key]
        codes = {k: v.dtype for k, v in state.items() if k.endswith("_q") or k.endswith("wq")}
        assert codes and set(codes.values()) == {torch.int8}, key


def test_fan_in_past_the_exact_bound_raises():
    wide = {"layers": [{"w": np.ones((tq.MAX_EXACT_FAN_IN + 1, 4), np.float32),
                        "b": np.zeros(4, np.float32)}]}
    with pytest.raises(ValueError, match="fan-in"):
        tq.quantize_mlp(wide)


def test_wire_quantize_int8_equal():
    x = _raw_batch(34, 2048)
    x[:5, 3] = [np.nan, np.inf, -np.inf, 1e30, -0.0]
    got, want = tq.wire_quantize_int8(x), np.asarray(jq.wire_quantize_int8(x))
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tq.W8_CEIL, jq.W8_CEIL)
    np.testing.assert_array_equal(tq.W8_LINEAR, jq.W8_LINEAR)


def _ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units in the last place of float32 (same-sign values)."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def test_wire_dequantize_int8_every_code():
    q = np.tile(np.arange(-127, 128, dtype=np.int8)[:, None], (1, tq.W8_CEIL.size))
    got = tq.wire_dequantize_int8(torch.from_numpy(q)).numpy()
    for want in (np.asarray(jq.wire_dequantize_int8(q)),
                 np.asarray(jax.jit(jq.wire_dequantize_int8)(q))):
        linear = tq.W8_LINEAR > 0
        np.testing.assert_array_equal(got[:, linear], want[:, linear])
        dist = _ulp_distance(got, want)
        differ = int((dist > 0).sum())
        print(f"wire_dequantize_int8: {differ} of {dist.size} elements differ, "
              f"at most {int(dist.max())} ulp")
        assert dist.max() <= EXPM1_ULP
        np.testing.assert_array_equal(np.sign(got), np.sign(want))


@pytest.mark.parametrize("model", ["mlp", "gbdt", "multitask"])
def test_int8_models_match_jax(model):
    trees = _trees()
    x = _model_inputs(35, 512)
    if model == "gbdt":
        qtree = tq.quantize_gbdt(trees["gbdt"])
        jfn, tfn = jq.gbdt_predict_int8, tq.gbdt_predict_int8
        params = from_jax_params("gbdt_int8", {"gbdt_int8": qtree})["gbdt_int8"]
    else:
        qtree = (tq.quantize_mlp(trees["mlp"], _calibration()) if model == "mlp"
                 else tq.quantize_multitask_fraud(trees["multitask"], _calibration()))
        jfn, tfn = jq.mlp_predict_int8, tq.mlp_predict_int8
        params = from_jax_params("mlp_int8", {"mlp_int8": qtree})["mlp_int8"]
    got = tfn(params, torch.from_numpy(x)).numpy()
    for want in (np.asarray(jfn(qtree, x)), np.asarray(jax.jit(jfn)(qtree, x))):
        np.testing.assert_allclose(got, want, rtol=0, atol=ML_ATOL, err_msg=model)
    assert got.std() > 0.01  # the probabilities spread: the check is not vacuous


@pytest.mark.parametrize("backend", ["mlp_int8", "gbdt_int8", "mlp+gbdt_int8", "multitask_int8"])
def test_int8_engines_match_jax(backend):
    base = backend.removesuffix("_int8")
    trees = _trees()
    tree, _ = tq.quantize_checkpoint({k: trees[k] for k in base.split("+")}, base, _calibration())
    x = np.concatenate([_raw_batch(36, 384), _boundary_batch()])
    bl = np.random.default_rng(37).random(x.shape[0]) < 0.05
    thresholds = np.array([70, 40], dtype=np.int32)
    want = jmake_score_fn(JScoringConfig(), backend)(tree, x, bl, thresholds)
    fn = make_score_fn(ScoringConfig(), backend, device="cpu")
    got = fn(from_jax_params(backend, tree), x, bl, torch.from_numpy(thresholds))
    assert_outputs_match(got, want, backend)


def test_released_checkpoint_int8_scores_exact():
    golden, params, x, _y = load_released()
    tree = jax.tree.map(np.asarray, params)
    cal = standardize_for_model(normalize(torch.from_numpy(x))).numpy()
    qtree, backend = tq.quantize_checkpoint({"multitask": tree}, "multitask", cal)
    out = make_score_fn(ScoringConfig(), backend, device="cpu")(
        from_jax_params(backend, qtree), x, np.zeros((x.shape[0],), dtype=bool))
    np.testing.assert_array_equal(out["score"].numpy().astype(int), golden["int8"]["score"])
