"""Fused oblivious-forest inference: the Hopper kernel, its wrapper and its plain version.

Replaces the TPU kernel ``igaming_platform_tpu/ops/pallas/gbdt_kernel.py::_kernel``
(launched by ``_run``, wrapped by ``gbdt_raw_pallas``). The function is the
one the JAX ensemble serves, ``models/gbdt.py::gbdt_raw``: [B, F] features
-> [B] raw margins ``sum_t leaves[t, leaf(b, t)] + bias``. The sigmoid and
the ensemble mean stay in torch, as they sit outside the kernel in JAX.

The kernel is ``csrc/gbdt_forest.cu``, CUDA C++ for ``sm_90a``, built by
``ops/_build.py`` at first use and called through ctypes. It gathers
``x[b, feat[t, d]]`` directly instead of the TPU's one-hot selector
product, so every split compares the exact float32 feature.

What bounds it on an H100: bytes, B*30*4 read plus B*4 written plus the
~6 KB forest. At B=4096 that is about 0.51 MB, about 0.15 us at 3.35 TB/s,
so the launch latency dominates. The design answers with one launch per
call that allocates nothing and never synchronises, with the forest staged
once per block in shared memory (see the source's header).

``gbdt_forest`` takes the plain PyTorch version for CPU tensors only; for
CUDA tensors it launches the kernel or raises. ``gbdt_forest.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

MAX_DEPTH = 8
ROWS_PER_BLOCK = 32  # csrc/gbdt_forest.cu kRowsPerBlock
MAX_SHARED_BYTES = 48 * 1024  # csrc/gbdt_forest.cu kMaxSharedBytes

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
# Launches come from the batcher's thread and from direct batch calls.
_count_lock = threading.Lock()


def _lib() -> ctypes.CDLL:
    from igaming_platform_tpu_torch.ops import _build

    lib = _build.load("gbdt_forest")
    fn = lib.gbdt_forest_launch
    if fn.argtypes is None:
        fn.argtypes = [_VOIDP] * 6 + [_INT] * 4 + [_VOIDP]
        fn.restype = _INT
    return lib


def shared_bytes(n_features: int, n_trees: int, depth: int) -> int:
    """Shared memory one block of the kernel uses."""
    return n_trees * depth * 8 + n_trees * (1 << depth) * 4 + ROWS_PER_BLOCK * n_features * 4


def forest_leaf_index(x: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """[B, F] x [T, D] -> [B, T] int32 leaf index ``sum_d (x[b, feat] > thr) << d``."""
    b = x.shape[0]
    n_trees, depth = feat.shape
    gathered = x[:, feat.reshape(-1).long()].reshape(b, n_trees, depth)
    bits = (gathered > thr[None]).to(torch.int32)
    pows = torch.tensor([1 << d for d in range(depth)], dtype=torch.int32, device=x.device)
    return torch.sum(bits * pows, dim=-1, dtype=torch.int32)


def gbdt_forest_plain(x: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                      leaves: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the gather form of ``models/gbdt.py:51-65``."""
    leaf_idx = forest_leaf_index(x, feat, thr).long()  # [B, T]
    trees = torch.arange(feat.shape[0], device=x.device)
    vals = leaves[trees[None, :], leaf_idx]  # [B, T]
    return torch.sum(vals, dim=-1) + bias.reshape(())


def _check(x, feat, thr, leaves, bias) -> None:
    dev = x.device
    for name, t, dtype in (("x", x, torch.float32), ("feat", feat, torch.int32),
                           ("thr", thr, torch.float32), ("leaves", leaves, torch.float32),
                           ("bias", bias, torch.float32)):
        if t.device != dev:
            raise ValueError(f"gbdt_forest: {name} is on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"gbdt_forest: {name} is {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gbdt_forest: {name} is not contiguous")
    if x.dim() != 2 or feat.dim() != 2:
        raise ValueError(f"gbdt_forest: x {tuple(x.shape)} and feat {tuple(feat.shape)} must be 2-D")
    n_trees, depth = feat.shape
    if not 1 <= depth <= MAX_DEPTH or n_trees < 1:
        raise ValueError(f"gbdt_forest: depth {depth} outside 1..{MAX_DEPTH} or no trees")
    if thr.shape != feat.shape or leaves.shape != (n_trees, 1 << depth) or bias.numel() != 1:
        raise ValueError(
            f"gbdt_forest: feat {tuple(feat.shape)} thr {tuple(thr.shape)} "
            f"leaves {tuple(leaves.shape)} bias {tuple(bias.shape)} disagree")
    smem = shared_bytes(x.shape[1], n_trees, depth)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"gbdt_forest: forest needs {smem} B of shared memory, "
                         f"the kernel takes {MAX_SHARED_BYTES}")


def gbdt_forest(x: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                leaves: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """[B, F] float32 -> [B] float32 raw margins of the oblivious forest."""
    if x.device.type == "cpu":
        return gbdt_forest_plain(x, feat, thr, leaves, bias)
    if x.device.type != "cuda":
        raise ValueError(f"gbdt_forest: unsupported device {x.device}")
    _check(x, feat, thr, leaves, bias)
    b, n_features = x.shape
    n_trees, depth = feat.shape
    out = torch.empty((b,), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().gbdt_forest_launch(
        x.data_ptr(), feat.data_ptr(), thr.data_ptr(), leaves.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, n_features, n_trees, depth, stream)
    if rc != 0:
        raise RuntimeError(f"gbdt_forest: kernel launch failed with CUDA error {rc}")
    with _count_lock:
        gbdt_forest.launches += 1
    return out


gbdt_forest.launches = 0
