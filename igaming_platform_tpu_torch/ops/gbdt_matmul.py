"""Oblivious-forest inference as a matmul: the gather as a one-hot product.

Counterpart of ``igaming_platform_tpu/ops/gbdt_matmul.py`` (the Hummingbird
GEMM strategy, PAPERS.md): the feature gather of ``models/gbdt.gbdt_raw``
becomes one dense product with a one-hot selector,

    gathered[b, t*D+d] = x[b, :] @ onehot(feat[t, d])
    bits   = gathered > thresholds
    leaf   = bits . powers-of-2 per tree
    out[b] = sum_t leaves[t, leaf[b, t]]

The selector product is a plain float32 ``torch.matmul`` with TF32 off (a
TF32 product would round the features and flip comparisons at the
boundary), as the JAX package computes it in XLA outside any Pallas kernel.
Each gathered value is one ``x * 1`` plus zeros, so it equals the gather's
value bit for bit; the trees' leaves are then added in ``gbdt_raw``'s order
on that device (the forest kernel's ``sum_order`` on a card, the plain
version's ``torch.sum`` on the CPU), so the margin equals ``gbdt_raw``'s bit
for bit too. Serving does not call it (the forest kernel,
``ops/gbdt_kernel.py``, is the serving path), as in the JAX package.
``precompute_selector`` runs once per model swap.
"""

from __future__ import annotations

import numpy as np
import torch


def precompute_selector(feat, in_dim: int) -> np.ndarray:
    """[T, D] int feature ids -> [F, T*D] float32 one-hot selector."""
    feat = np.asarray(feat)
    n_trees, depth = feat.shape
    sel = np.zeros((in_dim, n_trees * depth), dtype=np.float32)
    flat = feat.reshape(-1)
    sel[flat, np.arange(flat.size)] = 1.0
    return sel


def gbdt_raw_matmul(params: dict, sel, x) -> torch.Tensor:
    """[B, F] -> [B] raw margin via the matmul formulation. ``sel`` is
    ``precompute_selector(params["feat"], F)``; thresholds and leaves come
    from the same params as the gather form. Runs on ``x``'s device."""
    x = torch.as_tensor(x, dtype=torch.float32)
    dev = x.device
    sel = torch.as_tensor(sel, dtype=torch.float32, device=dev)
    thr = torch.as_tensor(params["thr"], dtype=torch.float32, device=dev)  # [T, D]
    leaves = torch.as_tensor(params["leaves"], dtype=torch.float32, device=dev)  # [T, 2^D]
    n_trees, depth = thr.shape
    gathered = torch.matmul(x, sel).reshape(x.shape[0], n_trees, depth)
    bits = (gathered > thr[None]).to(torch.int32)
    pows = torch.as_tensor(1 << np.arange(depth), dtype=torch.int32, device=dev)
    leaf_idx = torch.sum(bits * pows, dim=-1)  # [B, T]
    # One-hot leaf select: one leaf plus zeros a tree, exact.
    onehot = (leaf_idx[:, :, None] == torch.arange(leaves.shape[1], device=dev)[None, None])
    picked = torch.sum(onehot.to(torch.float32) * leaves[None], dim=-1)  # [B, T]
    bias = torch.as_tensor(params["bias"], dtype=torch.float32, device=dev).reshape(())
    return _tree_sum(picked) + bias


def _tree_sum(picked: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B]: the trees added in ``gbdt_raw``'s order on this device."""
    if picked.device.type == "cpu":
        return torch.sum(picked, dim=-1)
    from igaming_platform_tpu_torch.ops.gbdt_kernel import sum_order

    n_trees = picked.shape[1]
    order = sum_order(n_trees)
    total = None
    for k0 in range(0, n_trees, order.tree_block):
        k1 = min(n_trees, k0 + order.tree_block)
        block = None
        for p in range(order.partials):
            acc = torch.zeros(picked.shape[0], dtype=torch.float32, device=picked.device)
            for t in range(k0 + p, k1, order.partials):
                acc = acc + picked[:, t]
            block = acc if block is None else block + acc
        total = block if total is None else total + block
    return total
