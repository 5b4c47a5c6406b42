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
The soft (differentiable) forest used for training waits for the port's
training slice.
"""

from __future__ import annotations

from typing import Any

import torch

from igaming_platform_tpu_torch.core import numerics
from igaming_platform_tpu_torch.ops.gbdt_kernel import gbdt_forest

Params = dict[str, Any]


def gbdt_raw(params: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, F] -> [B] raw margin (sum of leaf values + bias)."""
    x = torch.as_tensor(x, dtype=torch.float32).contiguous()
    return gbdt_forest(x, params["feat"], params["thr"], params["leaves"], params["bias"])


def gbdt_predict(params: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, F] normalized features -> [B] probability in [0, 1]."""
    return numerics.sigmoid(gbdt_raw(params, x))
