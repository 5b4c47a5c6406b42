"""Port parity: models/gbdt.py and the forest kernel's plain version (ops/gbdt_kernel.py).

The forest and the features come from a numpy seed and go through the JAX
package's ``gbdt_raw`` (the function the ensemble serves) and its Pallas
kernel in interpret mode, as tests/test_ops.py runs it, and through the
port on the CPU, where ``gbdt_forest`` takes its plain gather form.

Tolerances: leaf indices are exact, since each split is one float32 ``>``
on the same feature value. Margins agree to atol 1e-6: each sums 64 leaves
of scale 0.1, and the two packages add them in different orders. Forests of
hundreds of trees agree to atol 1e-5, the bar chip_smoke.py holds the kernel
to against the sum in float64: at 1,000 trees of depth 6 both float32 sums
lie within 2.6e-6 of it (4096 rows). The CUDA kernel itself is held to its
plain version on the card by chip_smoke.py; its launch plan is checked here.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from igaming_platform_tpu.models.gbdt import gbdt_predict as jgbdt_predict
from igaming_platform_tpu.models.gbdt import gbdt_raw as jgbdt_raw
from igaming_platform_tpu.ops.pallas.gbdt_kernel import gbdt_raw_pallas
from igaming_platform_tpu_torch.convert import from_jax_params, gbdt_from_tree
from igaming_platform_tpu_torch.models.gbdt import gbdt_predict, gbdt_raw
from igaming_platform_tpu_torch.ops import gbdt_kernel
from igaming_platform_tpu_torch.ops.gbdt_kernel import forest_leaf_index, gbdt_forest

N_FEATURES = 30


def _forest(seed, n_trees=64, depth=4):
    rng = np.random.default_rng(seed)
    return {
        "feat": rng.integers(0, N_FEATURES, (n_trees, depth)).astype(np.int32),
        "thr": rng.random((n_trees, depth)).astype(np.float32),
        "leaves": (rng.normal(size=(n_trees, 2**depth)) * 0.1).astype(np.float32),
        "bias": np.float32(rng.normal() * 0.1),
    }


def _features(seed, b, tree):
    """Standardized-scale features, with some entries set exactly to a
    split threshold (a tie must go left: ``>`` is false)."""
    rng = np.random.default_rng(seed)
    x = rng.random((b, N_FEATURES)).astype(np.float32)
    feat, thr = tree["feat"].reshape(-1), tree["thr"].reshape(-1)
    for row in range(0, b, 3):
        k = rng.integers(0, feat.size)
        x[row, feat[k]] = thr[k]
    return x


def _leaf_index_numpy(x, tree):
    feat, thr = tree["feat"], tree["thr"]
    bits = (x[:, feat.reshape(-1)].reshape(x.shape[0], *feat.shape) > thr[None]).astype(np.int64)
    return np.sum(bits << np.arange(feat.shape[1]), axis=-1)


@pytest.mark.parametrize("b", [256, 7])
def test_plain_matches_gbdt_raw(b):
    tree = _forest(0)
    x = _features(1, b, tree)
    p = gbdt_from_tree(tree)
    idx = forest_leaf_index(torch.from_numpy(x), p["feat"], p["thr"])
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), _leaf_index_numpy(x, tree))
    got = gbdt_raw(p, torch.from_numpy(x))
    want = np.asarray(jgbdt_raw(tree, x))
    assert got.shape == (b,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("b", [256, 512])
def test_plain_matches_pallas_interpret(b):
    tree = _forest(2)
    x = _features(3, b, tree)
    want = np.asarray(gbdt_raw_pallas(tree, x, interpret=True))
    p = gbdt_from_tree(tree)
    got = gbdt_forest(torch.from_numpy(x), p["feat"], p["thr"], p["leaves"], p["bias"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_trees,depth,atol", [(16, 3, 1e-6), (5, 8, 1e-6), (64, 1, 1e-6),
                                                 (600, 4, 1e-5), (1000, 6, 1e-5),
                                                 (64, 12, 1e-6)])
def test_plain_other_shapes(n_trees, depth, atol):
    tree = _forest(4, n_trees, depth)
    x = _features(5, 33, tree)
    got = gbdt_raw(gbdt_from_tree(tree), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgbdt_raw(tree, x)), rtol=0, atol=atol)


def test_gbdt_predict_and_from_jax_params():
    tree = _forest(6)
    x = _features(7, 64, tree)
    p = from_jax_params("gbdt", {"gbdt": tree})["gbdt"]
    got = gbdt_predict(p, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jgbdt_predict(tree, x)), rtol=0, atol=1e-6)


def test_cpu_path_never_launches():
    tree = gbdt_from_tree(_forest(8))
    before = gbdt_forest.launches
    gbdt_raw(tree, torch.zeros((4, N_FEATURES)))
    assert gbdt_forest.launches == before


def test_bad_feature_ids_rejected():
    tree = _forest(9)
    tree["feat"][3, 1] = N_FEATURES
    with pytest.raises(ValueError, match="feature ids"):
        gbdt_from_tree(tree)


def test_kernel_contract_checks():
    """What the CUDA launcher refuses, the wrapper refuses first: dtype,
    device, shape, contiguity, and depth past 30. Any forest the JAX
    function scores passes, wide or deep."""
    p = gbdt_from_tree(_forest(10))
    x = torch.zeros((8, N_FEATURES))
    args = [x, p["feat"], p["thr"], p["leaves"], p["bias"]]
    gbdt_kernel._check(*args)
    bad = [
        (0, x.double(), TypeError),
        (0, torch.zeros((8, 2 * N_FEATURES))[:, ::2], ValueError),
        (1, p["feat"].long(), TypeError),
        (3, p["leaves"][:, :8].contiguous(), ValueError),
    ]
    for i, value, exc in bad:
        with pytest.raises(exc):
            gbdt_kernel._check(*[value if j == i else a for j, a in enumerate(args)])
    for n_trees, depth in [(600, 4), (2, 9), (2, 10), (2, 11), (2, 12)]:
        ok = gbdt_from_tree(_forest(11, n_trees=n_trees, depth=depth))
        gbdt_kernel._check(x, ok["feat"], ok["thr"], ok["leaves"], ok["bias"])
    # Depth 31: the JAX function's int32 leaf index 1 << d overflows. On the
    # meta device, which holds shapes only: a [1, 2^31] leaf table takes 8 GB.
    meta = [torch.empty(shape, dtype=dtype, device="meta") for shape, dtype in (
        ((8, N_FEATURES), torch.float32), ((1, 31), torch.int32), ((1, 31), torch.float32),
        ((1, 1 << 31), torch.float32), ((), torch.float32))]
    with pytest.raises(ValueError, match="depth"):
        gbdt_kernel._check(*meta)


def _cu_constants():
    src = (Path(gbdt_kernel.__file__).parents[1] / "csrc" / "gbdt_forest.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


@pytest.mark.parametrize("b,n_features,n_trees,depth", [
    (1, 30, 64, 4), (255, 30, 64, 4), (4096, 30, 64, 4), (4096, 30, 16, 3),
    (256, 30, 600, 4), (4096, 30, 1000, 6), (2048, 30, 1000, 6), (256, 30, 256, 10),
    (4097, 31, 301, 5), (40, 1, 64, 3), (33, 30, 3, 16), (1, 30, 100_000, 8),
    (7, 30, 5, 30)])
def test_launch_plan_invariants(b, n_features, n_trees, depth):
    """The plan the wrapper hands the launcher keeps the launcher's rules
    (csrc/gbdt_forest.cu's constants): shared memory within 227 KB, whole
    warps of rows, at most 1024 threads and 8 blocks a cluster, rows
    covering B, and every tree walked by exactly one group of one block."""
    k = _cu_constants()
    assert (k["kMaxThreads"], k["kMaxDepth"], k["kMaxSharedLeafDepth"], k["kMaxSharedBytes"],
            k["kChunkMultiple"], k["kMaxCluster"]) == (
        gbdt_kernel.MAX_THREADS, gbdt_kernel.MAX_DEPTH, gbdt_kernel.MAX_SHARED_LEAF_DEPTH,
        gbdt_kernel.MAX_SHARED_BYTES, gbdt_kernel.CHUNK_MULTIPLE, gbdt_kernel.MAX_CLUSTER)
    plan = gbdt_kernel.launch_plan(b, n_features, n_trees, depth, 132)
    assert plan.shared_bytes <= k["kMaxSharedBytes"]
    assert plan.rows in (32, 64) and 32 * plan.groups <= k["kMaxThreads"]
    assert plan.cluster in (1, 2, 4, 8) and plan.grid % plan.cluster == 0
    row_blocks = plan.grid // plan.cluster
    assert row_blocks * plan.rows >= b > (row_blocks - 1) * plan.rows
    if plan.cluster == 1:
        assert plan.span == n_trees
    else:
        assert plan.span % k["kChunkMultiple"] == 0 and plan.span * plan.cluster >= n_trees
    assert 0 < plan.chunk <= plan.span
    assert plan.chunk == plan.span or plan.chunk % k["kChunkMultiple"] == 0
    assert plan.stages == (1 if plan.chunk == plan.span else 2)
    walked = np.zeros(n_trees, dtype=np.int64)
    for rank in range(plan.cluster):  # as the kernel walks: rank, chunk, group
        t_begin = min(n_trees, rank * plan.span)
        t_end = min(n_trees, t_begin + plan.span)
        for t0 in range(t_begin, t_end, plan.chunk):
            n = min(plan.chunk, t_end - t0)
            for g in range(plan.groups):
                walked[t0 + np.arange(g, n, plan.groups)] += 1
    assert (walked == 1).all()


def _emulate_kernel_sums(v: np.ndarray, plan, n_trees: int) -> np.ndarray:
    """A row's margin less its bias as csrc/gbdt_forest.cu adds it under
    ``plan``, in float32 from the [R, T] leaf values ``v``: rank, chunk,
    segment, warp; each warp's partial handed over where a tree block ends;
    a tree block's partials added in warp order; rank 0 adds every rank's
    tree block sums in rank order."""
    f32 = np.float32
    ranks = []
    for rank in range(plan.cluster):
        t_begin = min(n_trees, rank * plan.span)
        t_end = min(n_trees, t_begin + plan.span)
        acc = np.zeros((plan.groups, v.shape[0]), f32)
        sums = []
        for t0 in range(t_begin, t_end, plan.chunk):
            n = min(plan.chunk, t_end - t0)
            seg = min(plan.tree_block, plan.chunk)
            for s0 in range(0, n, seg):
                s1 = min(n, s0 + seg)
                for g in range(plan.groups):
                    for j in range(s0 + g, s1, plan.groups):
                        acc[g] = acc[g] + v[:, t0 + j]
                if (t0 + s1 - t_begin) % plan.tree_block == 0 or t0 + s1 == t_end:
                    s = acc[0].copy()
                    for g in range(1, plan.groups):
                        s = s + acc[g]
                    sums.append(s)
                    acc[:] = f32(0)
        ranks.append(sums)
    blocks = [s for sums in ranks for s in sums]
    total = blocks[0]
    for s in blocks[1:]:
        total = total + s
    return total


def _canonical_sums(v: np.ndarray, n_trees: int) -> np.ndarray:
    """The same sum straight from ``sum_order``'s description."""
    order = gbdt_kernel.sum_order(n_trees)
    blocks = []
    for k0 in range(0, n_trees, order.tree_block):
        k1 = min(n_trees, k0 + order.tree_block)
        parts = []
        for p in range(order.partials):
            acc = np.zeros(v.shape[0], np.float32)
            for t in range(k0 + p, k1, order.partials):
                acc = acc + v[:, t]
            parts.append(acc)
        s = parts[0]
        for q in parts[1:]:
            s = s + q
        blocks.append(s)
    total = blocks[0]
    for s in blocks[1:]:
        total = total + s
    return total


@pytest.mark.parametrize("n_trees,depth", [(64, 4), (16, 3), (600, 4), (1000, 6), (256, 10),
                                           (301, 5), (2000, 2), (33, 8), (5, 1), (3000, 3)])
def test_launch_plan_sum_order(n_trees, depth):
    """Every plan ``launch_plan`` gives a forest, at B = 1, 256, 2048 and
    4096 (the ladder's shapes and a single row) on a 132-SM card, adds a
    row's trees in ``sum_order``'s one order: the kernel's additions,
    emulated in float32 on leaf values of scales 1e-3 to 1e3, give the same
    bits under every plan and equal the order's own sum, which a plain
    ``np.sum`` misses. So a row's margin does not depend on its batch."""
    rng = np.random.default_rng(n_trees)
    v = (rng.normal(size=(16, n_trees)) * 10.0 ** rng.uniform(-3, 3, (16, n_trees))).astype(
        np.float32)
    want = _canonical_sums(v, n_trees)
    plans = {gbdt_kernel.launch_plan(b, N_FEATURES, n_trees, depth, 132)
             for b in (1, 256, 2048, 4096)}
    for plan in plans:
        assert plan.groups == gbdt_kernel.sum_order(n_trees).partials
        assert plan.tree_block == gbdt_kernel.sum_order(n_trees).tree_block
        assert plan.cluster == 1 or plan.span % plan.tree_block == 0
        assert plan.chunk == plan.span or (plan.chunk % plan.groups == 0 and (
            plan.chunk % plan.tree_block == 0 or plan.tree_block % plan.chunk == 0))
        np.testing.assert_array_equal(_emulate_kernel_sums(v, plan, n_trees), want)
    if n_trees >= 600:
        assert len(plans) > 1  # the plans differ by B; the order does not
        assert not np.array_equal(np.sum(v, axis=1, dtype=np.float32), want)
