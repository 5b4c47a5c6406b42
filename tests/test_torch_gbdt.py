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
