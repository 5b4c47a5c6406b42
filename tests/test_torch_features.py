"""Port parity: core/features.py (normalize, standardize_for_model, host helpers).

The same numpy inputs go through the JAX functions and the port's on the
CPU. Tolerance: every column is bit-exact except where the real log1p runs
(the 4 log features in normalize, the 9 squashed features in
standardize_for_model). There the two packages use different float32
log1p approximations: over 2.5M inputs XLA's CPU log1p lay up to 2.5 ulp
from the exact value and PyTorch's within 0.6 ulp, so those columns are
held to 3 ulp.

Inputs are never subnormal: XLA's CPU backend flushes subnormals to zero
and PyTorch does not, and no count or amount in cents is subnormal.
"""

import numpy as np
import pytest
import torch

from igaming_platform_tpu.core import features as jf
from igaming_platform_tpu_torch.core import features as tf


def _random_batch(seed, n=256):
    rng = np.random.default_rng(seed)
    x = rng.random((n, jf.NUM_FEATURES)).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(-2, 9, size=x.shape).astype(np.float32)
    x[rng.random(x.shape) < 0.2] *= -1
    return x


def _edge_batch():
    rows = [np.zeros(jf.NUM_FEATURES, np.float32),
            np.full(jf.NUM_FEATURES, -1.0, np.float32),
            np.full(jf.NUM_FEATURES, -1e9, np.float32),
            np.full(jf.NUM_FEATURES, 1e9, np.float32),
            np.full(jf.NUM_FEATURES, -0.0, np.float32)]
    # Counts sitting exactly on the min-max bounds, one ulp either side of
    # the upper bound, and one count above the lower.
    for shift in ("lo", "lo+1", "hi", "hi-ulp", "hi+ulp"):
        r = np.full(jf.NUM_FEATURES, 3.0, np.float32)
        for i, (lo, hi) in jf.MINMAX_BOUNDS.items():
            hi32 = np.float32(hi)
            r[i] = {"lo": lo, "lo+1": lo + 1.0, "hi": hi32,
                    "hi-ulp": np.nextafter(hi32, np.float32(0)),
                    "hi+ulp": np.nextafter(hi32, np.float32(np.inf))}[shift]
        rows.append(r)
    return np.stack(rows)


BATCHES = {"random0": lambda: _random_batch(0), "random1": lambda: _random_batch(1),
           "edge": _edge_batch}


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_normalize_ref_compat_bit_exact(batch):
    x = BATCHES[batch]()
    want = np.asarray(jf.normalize(x, ref_compat=True))
    got = tf.normalize(torch.from_numpy(x), ref_compat=True).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_normalize_real_log1p(batch):
    x = BATCHES[batch]()
    want = np.asarray(jf.normalize(x))
    got = tf.normalize(torch.from_numpy(x)).numpy()
    log_cols = [int(i) for i in jf.LOG_FEATURES]
    other = [i for i in range(jf.NUM_FEATURES) if i not in log_cols]
    np.testing.assert_array_equal(got[:, other].view(np.int32), want[:, other].view(np.int32))
    assert _ulps(got[:, log_cols], want[:, log_cols]).max() <= 3


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_standardize_for_model(batch):
    xn = np.array(jf.normalize(BATCHES[batch]()))
    want = np.asarray(jf.standardize_for_model(xn))
    got = tf.standardize_for_model(torch.from_numpy(xn)).numpy()
    sq = [int(i) for i in jf._UNBOUNDED_FEATURES]
    other = [i for i in range(jf.NUM_FEATURES) if i not in sq]
    np.testing.assert_array_equal(got[:, other].view(np.int32), want[:, other].view(np.int32))
    assert _ulps(got[:, sq], want[:, sq]).max() <= 3


def test_schema_and_masks_match():
    assert tf.FEATURE_NAMES == jf.FEATURE_NAMES
    assert [int(f) for f in tf.LOG_FEATURES] == [int(f) for f in jf.LOG_FEATURES]
    assert tf.MINMAX_BOUNDS == jf.MINMAX_BOUNDS
    for name in ("_LOG_MASK", "_MM_MASK", "_MM_MIN", "_MM_SCALE", "_SQUASH_MASK"):
        np.testing.assert_array_equal(getattr(tf, name), getattr(jf, name))


def test_host_helpers_match():
    x = np.abs(_random_batch(2, n=8))
    x[:3, jf.F.TX_COUNT_1H] = 0.0
    np.testing.assert_array_equal(tf.derive_tx_avg(x.copy()), jf.derive_tx_avg(x.copy()))
    vecs_t = [tf.FeatureVector.from_array(r).with_tx_context(500, "withdraw") for r in x]
    vecs_j = [jf.FeatureVector.from_array(r).with_tx_context(500, "withdraw") for r in x]
    np.testing.assert_array_equal(tf.batch_from_vectors(vecs_t), jf.batch_from_vectors(vecs_j))
