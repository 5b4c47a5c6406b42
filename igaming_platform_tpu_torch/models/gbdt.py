"""GBDT as tensors: oblivious decision trees, in PyTorch.

Counterpart of ``igaming_platform_tpu/models/gbdt.py``. Every node at depth
d of a tree tests the same (feature, threshold) pair, so a tree of depth D
is a gather, a compare and a leaf lookup:

    bits[b, t, d] = x[b, feat[t, d]] > thr[t, d]
    leaf[b, t]    = sum_d bits[b, t, d] << d
    out[b]        = sum_t leaves[t, leaf[b, t]] + bias

Params are a dict of tensors on one device: ``feat`` [T, D] int32, ``thr``
[T, D] float32, ``leaves`` [T, 2^D] float32, ``bias`` float32 (one value).
On a CUDA device ``gbdt_raw`` launches the hand-written forest kernel
(``ops/gbdt_kernel.py``); on the CPU it runs the kernel's plain gather form.
``init_gbdt`` draws a random forest as the JAX ``init_gbdt`` does (from
an explicit ``torch.Generator``: the same distributions, not JAX's
numbers), and ``soft_gbdt_raw`` is its differentiable relaxation for
distillation: sigmoid splits, each leaf weighted by the product of its
branch probabilities, a [B, T, 2^D, D] product in plain torch ops (16 MB at
1024 rows, 64 trees of depth 4), as XLA compiles it in the JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from igaming_platform_tpu_torch.core import numerics
from igaming_platform_tpu_torch.core.features import NUM_FEATURES
from igaming_platform_tpu_torch.ops.gbdt_kernel import gbdt_forest

Params = dict[str, Any]


def gbdt_raw(params: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, F] -> [B] raw margin (sum of leaf values + bias). A forest sharded
    over the mesh's ``expert`` axis (``parallel/sharding.ShardedForest``)
    sums its shards' margins."""
    x = torch.as_tensor(x, dtype=torch.float32).contiguous()
    if "shards" in params:
        return params.raw(x)
    return gbdt_forest(x, params["feat"], params["thr"], params["leaves"], params["bias"])


def gbdt_predict(params: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, F] normalized features -> [B] probability in [0, 1]."""
    return numerics.sigmoid(gbdt_raw(params, x))


def init_gbdt(gen: torch.Generator, n_trees: int = 64, depth: int = 4,
              in_dim: int = NUM_FEATURES, leaf_scale: float = 0.1) -> Params:
    """A random oblivious forest on the CPU: feature ids uniform in
    [0, in_dim), thresholds uniform in [0, 1), leaves normal times
    ``leaf_scale``, bias 0."""
    return {
        "feat": torch.randint(0, in_dim, (n_trees, depth), generator=gen, dtype=torch.int32),
        "thr": torch.rand((n_trees, depth), generator=gen, dtype=torch.float32),
        "leaves": torch.randn((n_trees, 2 ** depth), generator=gen,
                              dtype=torch.float32) * leaf_scale,
        "bias": torch.zeros((), dtype=torch.float32),
    }


def soft_gbdt_raw(params: Params, x: torch.Tensor, temperature: float = 50.0) -> torch.Tensor:
    """[B, F] -> [B]: the forest with sigmoid splits, differentiable in
    ``thr``, ``leaves`` and ``bias``; at temperature -> inf it converges to
    ``gbdt_raw``."""
    x = torch.as_tensor(x, dtype=torch.float32)
    feat, thr, leaves = params["feat"], params["thr"], params["leaves"]
    n_trees, depth = feat.shape
    gathered = x[:, feat.reshape(-1).long()].reshape(x.shape[0], n_trees, depth)
    p_right = torch.sigmoid((gathered - thr[None]) * temperature)  # [B, T, D]
    # P(leaf) = prod_d (bit_d ? p_right : 1 - p_right) for each leaf's bits.
    bits = ((np.arange(2 ** depth)[:, None] >> np.arange(depth)[None]) & 1).astype(np.float32)
    leaf_bits = torch.from_numpy(bits).to(x.device)  # [2^D, D]
    p = p_right[:, :, None, :]
    probs = p * leaf_bits[None, None] + (1.0 - p) * (1.0 - leaf_bits[None, None])
    leaf_prob = torch.prod(probs, dim=-1)  # [B, T, 2^D]
    return torch.sum(leaf_prob * leaves[None], dim=(1, 2)) + params["bias"]


def soft_gbdt_predict(params: Params, x: torch.Tensor, temperature: float = 50.0) -> torch.Tensor:
    return torch.sigmoid(soft_gbdt_raw(params, x, temperature))
