"""Fused oblivious-forest inference: the Hopper kernel, its wrapper and its plain version.

Replaces the TPU kernel ``igaming_platform_tpu/ops/pallas/gbdt_kernel.py::_kernel``
(launched by ``_run``, wrapped by ``gbdt_raw_pallas``). The function is the
one the JAX ensemble serves, ``models/gbdt.py::gbdt_raw``: [B, F] features
-> [B] raw margins ``sum_t leaves[t, leaf(b, t)] + bias``, for any forest
the JAX function takes (any T, depth 1..30). The sigmoid and the ensemble
mean stay in torch, as they sit outside the kernel in JAX.

The kernel is ``csrc/gbdt_forest.cu``, CUDA C++ for ``sm_90a``, built by
``ops/_build.py`` at first use and called through ctypes. It gathers
``x[b, feat[t, d]]`` directly instead of the TPU's one-hot selector
product, so every split compares the exact float32 feature. A lane is a
row (two at large batches); the forest streams through shared memory in
chunks of trees, so its size is not bounded by shared memory; at small
batches a thread-block cluster splits the trees (see the source's header).
``launch_plan`` picks rows a block, the cluster and trees a chunk. A row's
margin adds its trees in one order, ``sum_order``, which the forest's size
fixes and every plan keeps: so a row gives the same bits whatever batch it
rides in.

What bounds it on an H100: at the serving forest (T=64, D=4) bytes, about
0.15 us at B=4096, under the launch itself; at production forests (T=1000,
D=6) the B*T*D compares. One launch per call, no allocation, no sync.

``gbdt_forest`` takes the plain PyTorch version for CPU tensors only; for
CUDA tensors it launches the kernel or raises. ``gbdt_forest.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from igaming_platform_tpu_torch.core.device import constant

# Mirrors of csrc/gbdt_forest.cu's constants.
MAX_THREADS = 1024  # kMaxThreads
MAX_DEPTH = 30  # kMaxDepth: at 31 the JAX function's int32 1 << d overflows
MAX_SHARED_LEAF_DEPTH = 8  # kMaxSharedLeafDepth
MAX_SHARED_BYTES = 232448  # kMaxSharedBytes, 227 KB
CHUNK_MULTIPLE = 4  # kChunkMultiple
MAX_CLUSTER = 8  # kMaxCluster
# The plan's choices, from a sweep on an H100 (chip_smoke.forest_plan_sweep):
# rows a lane (one, or two at a batch whose 32-row blocks fill the card);
# splits (trees x depth) a block of a cluster takes at least; and the bytes
# of one stage of the ring (two stages stay under 100 KB, so two blocks fit
# an SM).
LANES = 32
SPLITS_PER_BLOCK = 256
STAGE_BYTES = 48 * 1024
# The sum order (``sum_order``): a partial sum, and so a warp, for every
# TREES_PER_PARTIAL trees up to MAX_PARTIALS; tree blocks of TREE_BLOCK
# trees, doubled until a forest has at most MAX_TREE_BLOCKS of them.
TREES_PER_PARTIAL = 8
MAX_PARTIALS = 16
TREE_BLOCK = 64
MAX_TREE_BLOCKS = 32
# Tree blocks a chunk holds at most: each takes a [partials, rows] slab of
# partial sums in shared memory.
MAX_CHUNK_TREE_BLOCKS = 8

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
# Launches come from the batcher's thread and from direct batch calls.
_count_lock = threading.Lock()


def _lib() -> ctypes.CDLL:
    from igaming_platform_tpu_torch.ops import _build

    lib = _build.load("gbdt_forest")
    fn = lib.gbdt_forest_launch
    if fn.argtypes is None:
        fn.argtypes = [_VOIDP] * 6 + [_INT] * 10 + [_VOIDP]
        fn.restype = _INT
    return lib


def _align16(n: int) -> int:
    return (n + 15) & ~15


def stage_bytes(chunk: int, depth: int) -> int:
    """One stage of the ring: feat and thr of ``chunk`` trees, and their
    leaves up to depth MAX_SHARED_LEAF_DEPTH (deeper ones are read in place)."""
    leaves = _align16(chunk * (4 << depth)) if depth <= MAX_SHARED_LEAF_DEPTH else 0
    return 2 * _align16(chunk * depth * 4) + leaves


class SumOrder(NamedTuple):
    """The order in which the kernel adds a row's trees: the trees fall in
    tree blocks of ``tree_block`` consecutive trees; inside a tree block,
    ``partials`` partial sums interleave (partial p adds the block's trees p,
    p + partials, ... in order, from 0.0); a tree block's sum adds its
    partials in order, the row's sum adds the tree blocks' sums in order,
    then the bias."""

    partials: int
    tree_block: int


@functools.lru_cache(maxsize=256)
def sum_order(n_trees: int) -> SumOrder:
    """The sum order of a forest of ``n_trees`` trees: it depends on nothing
    else, so every launch plan of the forest, at any batch size, adds a row's
    trees the same way."""
    partials = 1
    while partials < MAX_PARTIALS and partials * TREES_PER_PARTIAL < n_trees:
        partials *= 2
    tree_block = TREE_BLOCK
    while -(-n_trees // tree_block) > MAX_TREE_BLOCKS:
        tree_block *= 2
    return SumOrder(partials, tree_block)


class LaunchPlan(NamedTuple):
    rows: int  # rows a block: 32, one a lane, or 64, two a lane
    groups: int  # warps a block, warp g keeping partial g of each tree block
    cluster: int  # blocks of a cluster sharing the same rows
    span: int  # trees each block of a cluster takes: whole tree blocks
    chunk: int  # trees a stage: whole tree blocks, or a share of one
    stages: int  # 1 when one chunk holds a block's trees, else a ring of 2
    grid: int  # blocks
    shared_bytes: int  # dynamic shared memory a block
    tree_block: int  # trees a tree block (sum_order)


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, n_features: int, n_trees: int, depth: int, n_sms: int) -> LaunchPlan:
    """The kernel's launch for a [b, n_features] batch and a [T, D] forest on
    a card of ``n_sms`` SMs: 32 rows a block, or 64 (two a lane) when 32-row
    blocks would fill the card and the forest can be split in two; while the
    row blocks leave SMs idle, clusters of up to 8 blocks that split the
    trees, each keeping at least SPLITS_PER_BLOCK splits and a tree block;
    a warp for each partial sum of ``sum_order``; as many trees a chunk as
    STAGE_BYTES holds, in whole tree blocks or a share of one."""
    splits = n_trees * depth
    n_tree_blocks = -(-n_trees // sum_order(n_trees).tree_block)
    rows = LANES
    if -(-b // LANES) * 2 > n_sms and splits >= 2 * SPLITS_PER_BLOCK:
        rows = 2 * LANES
    row_blocks = -(-b // rows)
    cluster = 1
    while (cluster < MAX_CLUSTER and row_blocks * cluster * 2 <= n_sms
           and splits >= cluster * 2 * SPLITS_PER_BLOCK and n_tree_blocks >= cluster * 2):
        cluster *= 2
    return plan_for(b, n_features, n_trees, depth, rows, cluster)


def _tree_blocks(n_trees: int, tree_block: int) -> int:
    return -(-n_trees // tree_block)


def plan_for(b: int, n_features: int, n_trees: int, depth: int, rows: int,
             cluster: int) -> LaunchPlan:
    """The rest of a plan given its rows and cluster: a warp for each
    partial sum, the span in whole tree blocks, as many trees a chunk as
    STAGE_BYTES holds (up to MAX_CHUNK_TREE_BLOCKS whole tree blocks, or a
    power of two dividing one), the stages, grid and bytes."""
    order = sum_order(n_trees)
    tb = order.tree_block
    span = n_trees if cluster == 1 else -(-_tree_blocks(n_trees, tb) // cluster) * tb
    per_tree = 8 * depth + (4 << depth if depth <= MAX_SHARED_LEAF_DEPTH else 0)
    fit = (STAGE_BYTES - 48) // per_tree
    chunk = (min(fit // tb, MAX_CHUNK_TREE_BLOCKS) * tb if fit >= tb
             else 1 << (fit.bit_length() - 1))
    chunk = min(span, max(chunk, order.partials, CHUNK_MULTIPLE))
    stages = 1 if chunk == span else 2
    shared = (_align16(rows * (n_features | 1) * 4)
              + _align16(rows * order.partials * _tree_blocks(chunk, tb) * 4)
              + _align16(rows * _tree_blocks(n_trees, tb) * 4) + stages * stage_bytes(chunk, depth))
    return LaunchPlan(rows, order.partials, cluster, span, chunk, stages,
                      -(-b // rows) * cluster, shared, tb)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def forest_leaf_index(x: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """[B, F] x [T, D] -> [B, T] int32 leaf index ``sum_d (x[b, feat] > thr) << d``."""
    b = x.shape[0]
    n_trees, depth = feat.shape
    gathered = x[:, feat.reshape(-1).long()].reshape(b, n_trees, depth)
    bits = (gathered > thr[None]).to(torch.int32)
    # Cached on the device: a fresh torch.tensor here would be a blocking
    # host-to-device copy on every call.
    pows = constant(f"gbdt_pows_{depth}", np.left_shift(1, np.arange(depth, dtype=np.int32)),
                    x.device)
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
    plan = launch_plan(b, n_features, n_trees, depth, _sm_count(x.device.index))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().gbdt_forest_launch(
        x.data_ptr(), feat.data_ptr(), thr.data_ptr(), leaves.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, n_features, n_trees, depth, plan.rows, plan.groups, plan.chunk,
        plan.cluster, plan.span, plan.tree_block, stream)
    if rc != 0:
        raise RuntimeError(f"gbdt_forest: kernel launch failed with CUDA error {rc}")
    with _count_lock:
        gbdt_forest.launches += 1
    return out


gbdt_forest.launches = 0
