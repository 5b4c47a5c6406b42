"""Port parity: obs/perfmodel.py's cost counts and utilization.

XLA's cost analysis sees no hand kernel, so the port counts each kernel's
work from its shapes, with the formulas behind PERF.md's bounds. The counts
of the serving step (``TorchScoringEngine.step_cost``: forest, dense layers
and the step's elementwise bytes), of the attention model and of a training
step (``Trainer.step_cost``: forward, the gradient products, adamw's bytes)
equal those formulas over the layers of the JAX trees they were converted
from; ``utilization`` equals the JAX arithmetic on the same inputs with the
card's peaks.
"""

import math

import numpy as np
import pytest
import torch
from test_torch_ensemble import jax_tree

from igaming_platform_tpu.obs import perfmodel as jperf
from igaming_platform_tpu_torch.convert import from_jax_params
from igaming_platform_tpu_torch.core.config import BatcherConfig
from igaming_platform_tpu_torch.obs import perfmodel
from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine
from igaming_platform_tpu_torch.train import trainer

F = 30


def _dense(b, k, n):
    return 2.0 * b * k * n, 4.0 * (b * k + k * n + n + b * n)


def _step_formula(tree, b: int) -> dict:
    flops = nbytes = 0.0
    for layer in tree.get("mlp", {}).get("layers", []):
        f, nb = _dense(b, *np.shape(layer["w"]))
        flops, nbytes = flops + f, nbytes + nb
    if "gbdt" in tree:
        t, d = np.shape(tree["gbdt"]["feat"])
        flops += b * t * (d + 1)
        nbytes += b * F * 4 + b * 4 + t * d * 8 + t * (1 << d) * 4 + 4
    passes = b * (F * 4 + 1) + 5 * b * 4
    return {"flops": flops, "bytes": nbytes + passes}


@pytest.mark.parametrize("backend,n_rows", [("mlp+gbdt", 100), ("mlp+gbdt", 64), ("mlp", 7),
                                            ("gbdt", 20), ("mock", 33)])
def test_step_cost_equals_formulas(backend, n_rows):
    tree = jax_tree(backend)
    eng = TorchScoringEngine(ml_backend=backend, params=from_jax_params(backend, tree) or None,
                             batcher_config=BatcherConfig(batch_size=64, latency_tiers=(8, 32),
                                                          max_wait_ms=1.0), device="cpu")
    try:
        shape = eng._pick_shape(n_rows)
        assert eng.step_cost(n_rows) == _step_formula(tree, shape)
    finally:
        eng.close()


@pytest.mark.parametrize("bh,s,dh", [(4, 16, 8), (2, 64, 32)])
def test_attention_and_dense_counts(bh, s, dh):
    """The attention forward and backward and both dense modes count their
    formulas, on the CPU's plain versions as the card's kernels would."""
    from igaming_platform_tpu_torch.ops import dense, flash_attention

    q, k, v = (torch.randn(bh, s, dh) for _ in range(3))
    with perfmodel.counting() as rec:
        o, lse = flash_attention.flash_attention_fwd(q, k, v)
        flash_attention.flash_attention_bwd(q, k, v, o, lse, torch.randn(bh, s, dh))
        x = torch.randn(s, dh)
        dense.dense(x, dense.round_bf16(torch.randn(dh, 3)), torch.zeros(3))
        dense.dense_f32(x, torch.randn(dh, 5), torch.zeros(5))
    want_flops = 4 * bh * s * s * dh + 10 * bh * s * s * dh + 2 * s * dh * 3 + 2 * s * dh * 5
    want_bytes = ((4 * bh * s * dh * 4 + bh * s * 4) + (8 * bh * s * dh * 4 + bh * s * 4)
                  + _dense(s, dh, 3)[1] + _dense(s, dh, 5)[1])
    assert perfmodel.compiled_cost(rec) == {"flops": want_flops, "bytes": want_bytes}
    assert rec["calls"] == {"flash_attention_fwd": 1, "flash_attention_bwd": 1, "dense": 1,
                            "dense_f32": 1}
    assert perfmodel.cost_of(lambda: None) == {"flops": 0.0, "bytes": 0.0}


def test_trainer_step_cost_equals_formulas():
    """Forward products, the gradient products (dw of every layer, dx of
    every layer but the first, whose input needs no gradient) and adamw's
    7 float32s a weight."""
    cfg = trainer.TrainConfig(batch_size=32, trunk=(16, 8))
    t = trainer.Trainer(cfg, device="cpu")
    from igaming_platform_tpu_torch.train.data import make_stream

    batch = next(make_stream(cfg.batch_size, seed=3))
    cost = t.step_cost(batch)
    weights = [tuple(p.shape) for p in t.state.params.parameters() if p.ndim == 2]
    first = (F, cfg.trunk[0])
    flops = nbytes = 0.0
    for shape in weights:
        f, nb = _dense(cfg.batch_size, *shape)
        products = 2 if shape == first else 3
        flops, nbytes = flops + products * f, nbytes + products * nb
    n_weights = sum(p.numel() for p in t.state.params.parameters())
    assert weights.count(first) == 1
    assert cost == {"flops": flops, "bytes": nbytes + 7 * 4 * n_weights}


@pytest.mark.parametrize("cost,seconds", [({"flops": 3.2e9, "bytes": 8.0e6}, 1.3e-4),
                                          ({"flops": 0.0, "bytes": 5.0e5}, 2.0e-6),
                                          ({"flops": 1e12, "bytes": 0.0}, 0.5),
                                          ({"flops": 1.0, "bytes": 1.0}, 0.0),
                                          ({"flops": 1.0, "bytes": 1.0}, math.nan)])
def test_utilization_matches_jax_arithmetic(cost, seconds, monkeypatch):
    """The same cost and seconds: the JAX function with the card's peaks
    put in its table, and the port's on the card's name, agree; an unknown
    device reports rates with null shares in both."""
    name = "NVIDIA H100 80GB HBM3"
    peaks = perfmodel.peak_for(name)
    assert peaks == (989e12, 3.35e12)
    monkeypatch.setattr(jperf, "peak_for", lambda device: peaks)
    assert perfmodel.utilization(cost, seconds, name) == jperf.utilization(cost, seconds, None)
    monkeypatch.setattr(jperf, "peak_for", lambda device: None)
    assert perfmodel.utilization(cost, seconds, "cpu") == jperf.utilization(cost, seconds, None)
