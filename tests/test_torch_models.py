"""Port parity: models/mlp.py, models/multitask.py and the released checkpoint.

Params come from a numpy seed (or from the released checkpoint, loaded with
flax) and go through ``convert.from_jax_params``. Tolerance for the
probabilities: atol 1e-6. Both packages multiply bf16-rounded operands,
whose products are exact in float32, and accumulate in float32; only the
order of the sums differs. The released checkpoint must reproduce its
committed ``score`` and ``action`` exactly through the port's ``multitask``
backend, and ``ml_score`` to the committed 1e-6.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from igaming_platform_tpu.core.features import normalize as jnormalize
from igaming_platform_tpu.core.features import standardize_for_model as jstandardize
from igaming_platform_tpu.models.mlp import mlp_predict as jmlp_predict
from igaming_platform_tpu.models.multitask import init_multitask
from igaming_platform_tpu.models.multitask import multitask_forward as jmultitask_forward
from igaming_platform_tpu_torch.convert import from_jax_params
from igaming_platform_tpu_torch.core.config import ScoringConfig
from igaming_platform_tpu_torch.models.ensemble import make_score_fn
from igaming_platform_tpu_torch.models.mlp import mlp_predict
from igaming_platform_tpu_torch.models.multitask import fraud_predict

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _layer(rng, d_in, d_out, scale=None):
    scale = np.sqrt(2.0 / d_in) if scale is None else scale
    return {"w": (rng.normal(size=(d_in, d_out)) * scale).astype(np.float32),
            "b": (rng.normal(size=(d_out,)) * 0.05).astype(np.float32)}


def mlp_tree(seed, hidden=(128, 128)):
    rng = np.random.default_rng(seed)
    dims = (30, *hidden, 1)
    return {"layers": [_layer(rng, a, b) for a, b in zip(dims[:-1], dims[1:])]}


def multitask_tree(seed, trunk=(64, 64)):
    rng = np.random.default_rng(seed)
    dims = (30, *trunk)
    return {
        "trunk": {"layers": [_layer(rng, a, b) for a, b in zip(dims[:-1], dims[1:])]},
        "fraud_head": _layer(rng, trunk[-1], 1, np.sqrt(1.0 / trunk[-1])),
        "ltv_head": _layer(rng, trunk[-1], 1, np.sqrt(1.0 / trunk[-1])),
        "churn_head": _layer(rng, trunk[-1], 1, np.sqrt(1.0 / trunk[-1])),
    }


def _model_inputs(seed, n=256):
    """Standardized features of raw rows spanning counts, cents and flags."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 30)).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(0, 7, size=x.shape).astype(np.float32)
    return np.array(jstandardize(jnormalize(x)))


@pytest.mark.parametrize("hidden", [(128, 128), (16,)])
def test_mlp_predict(hidden):
    tree = mlp_tree(0, hidden)
    xn = _model_inputs(1)
    want = np.asarray(jmlp_predict(tree, xn))
    model = from_jax_params("mlp", {"mlp": tree})["mlp"]
    got = mlp_predict(model, torch.from_numpy(xn))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_mlp_bf16_operands_f32_result():
    """The product is of bf16-rounded operands, and the result keeps
    float32 precision (a bf16 matmul output would round to ~3 digits)."""
    tree = mlp_tree(2, (8,))
    model = from_jax_params("mlp", {"mlp": tree})["mlp"]
    dense = model.layers[0]
    h = torch.from_numpy(np.random.default_rng(3).random((16, 30)).astype(np.float32))
    w = torch.from_numpy(tree["layers"][0]["w"])
    exact = (h.to(torch.bfloat16).double() @ w.to(torch.bfloat16).double()
             + torch.from_numpy(tree["layers"][0]["b"]).double()).numpy()
    got = dense(h).double().numpy()
    # float32 accumulation of 30 exact products of magnitude < 1.
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5)
    bf16_out = torch.from_numpy(exact).to(torch.bfloat16).double().numpy()
    assert np.abs(bf16_out - exact).max() > 1e-3 > np.abs(got - exact).max() * 100


def test_multitask_heads():
    tree = multitask_tree(4)
    xn = _model_inputs(5)
    want = jmultitask_forward(tree, xn)
    model = from_jax_params("multitask", {"multitask": tree})["multitask"]
    got = model(torch.from_numpy(xn))
    for key in ("fraud", "churn"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-6)
    for key in ("fraud_logit", "ltv", "churn_logit"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fraud_predict(model, torch.from_numpy(xn)).numpy(),
                               np.asarray(want["fraud"]), rtol=0, atol=1e-6)


def _released():
    with open(os.path.join(GOLDEN_DIR, "released_scores.json")) as f:
        golden = json.load(f)
    template = init_multitask(jax.random.key(0), trunk=tuple(golden["trunk"]))
    with open(os.path.join(GOLDEN_DIR, "released_multitask.msgpack"), "rb") as f:
        params = serialization.from_bytes(template, f.read())
    data = np.load(os.path.join(GOLDEN_DIR, "released_features.npz"))
    return golden, jax.tree.map(np.asarray, params), data["x"]


def test_released_checkpoint_through_port():
    golden, tree, x = _released()
    params = from_jax_params("multitask", {"multitask": tree})
    fn = make_score_fn(ScoringConfig(), "multitask", device="cpu")
    out = fn(params, x, np.zeros((x.shape[0],), dtype=bool))
    assert x.shape[0] == 64
    np.testing.assert_array_equal(out["score"].numpy(), golden["f32"]["score"])
    np.testing.assert_array_equal(out["action"].numpy(), golden["f32"]["action"])
    np.testing.assert_allclose(out["ml_score"].numpy().astype(float),
                               np.array(golden["f32"]["ml_score"]), rtol=0, atol=1e-6)
