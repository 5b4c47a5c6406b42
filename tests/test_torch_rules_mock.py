"""Port parity: models/rules.py (apply_rules) and models/mock_model.py (mock_predict).

The same numpy batches go through the JAX functions and the port's on the
CPU. Tolerance: none. The rules are float32 compares and integer sums, and
the mock scorer adds float32 constants in a fixed order, so both packages
must give the same bits. The batches carry the Go-boundary rows: 3 devices
(normalized to 0.3f, which Go counts as > 0.3), withdrawals at exactly 80%
of deposits, and counts sitting exactly on each rule's threshold.
"""

import numpy as np
import pytest
import torch

from igaming_platform_tpu.core.config import ScoringConfig as JScoringConfig
from igaming_platform_tpu.core.features import F, NUM_FEATURES
from igaming_platform_tpu.core.features import normalize as jnormalize
from igaming_platform_tpu.models.mock_model import mock_predict as jmock_predict
from igaming_platform_tpu.models.rules import apply_rules as japply_rules
from igaming_platform_tpu_torch.core.config import ScoringConfig
from igaming_platform_tpu_torch.models.mock_model import mock_predict
from igaming_platform_tpu_torch.models.rules import apply_rules


def _raw_batch(seed, n=512):
    """Raw feature rows at the scales the feature store writes them."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, NUM_FEATURES), np.float32)
    x[:, F.TX_COUNT_1M] = rng.integers(0, 25, n)
    x[:, F.TX_COUNT_5M] = x[:, F.TX_COUNT_1M] + rng.integers(0, 30, n)
    x[:, F.TX_COUNT_1H] = x[:, F.TX_COUNT_5M] + rng.integers(0, 200, n)
    x[:, F.TX_SUM_1H] = rng.integers(0, 10**7, n)
    x[:, F.TX_AVG_1H] = x[:, F.TX_SUM_1H] / np.maximum(x[:, F.TX_COUNT_1H], 1)
    x[:, F.UNIQUE_DEVICES_24H] = rng.integers(0, 12, n)
    x[:, F.UNIQUE_IPS_24H] = rng.integers(0, 25, n)
    x[:, F.IP_COUNTRY_CHANGES] = rng.integers(0, 5, n)
    x[:, F.DEVICE_AGE_DAYS] = rng.random(n) * 400
    x[:, F.ACCOUNT_AGE_DAYS] = rng.random(n) * rng.choice([10.0, 400.0], n)
    x[:, F.TOTAL_DEPOSITS] = rng.integers(0, 10**8, n)
    x[:, F.TOTAL_WITHDRAWALS] = rng.integers(0, 10**8, n)
    x[:, F.NET_DEPOSIT] = x[:, F.TOTAL_DEPOSITS] - x[:, F.TOTAL_WITHDRAWALS]
    x[:, F.DEPOSIT_COUNT] = rng.integers(0, 50, n)
    x[:, F.WITHDRAW_COUNT] = rng.integers(0, 50, n)
    x[:, F.TIME_SINCE_LAST_TX] = rng.random(n) * rng.choice([600.0, 86400.0 * 2], n)
    x[:, F.SESSION_DURATION] = rng.random(n) * 7200
    x[:, F.AVG_BET_SIZE] = rng.integers(0, 10**5, n)
    x[:, F.WIN_RATE] = rng.random(n)
    for col in (F.IS_VPN, F.IS_PROXY, F.IS_TOR, F.DISPOSABLE_EMAIL, F.BONUS_ONLY_PLAYER):
        x[:, col] = rng.random(n) < 0.1
    x[:, F.BONUS_CLAIM_COUNT] = rng.integers(0, 6, n)
    x[:, F.BONUS_WAGER_RATE] = rng.random(n)
    x[:, F.TX_AMOUNT] = rng.integers(100, 10**7, n)
    tx = rng.integers(0, 3, n)
    x[np.arange(n), F.TX_TYPE_DEPOSIT + tx] = 1.0
    return x


def _boundary_batch():
    """Rows that sit exactly on a rule's or the mock's decision boundary."""
    base = np.zeros(NUM_FEATURES, np.float32)
    base[F.ACCOUNT_AGE_DAYS] = 100.0
    base[F.TIME_SINCE_LAST_TX] = 1000.0
    rows = []

    def row(**kw):
        r = base.copy()
        for name, value in kw.items():
            r[F[name]] = value
        rows.append(r)

    for dev in (2, 3, 4):  # 3 devices -> 0.3f, which Go counts as > 0.3
        row(UNIQUE_DEVICES_24H=dev)
    for ips in (5, 6):  # 5 IPs -> 0.25 exactly; > 5 is the rule
        row(UNIQUE_IPS_24H=ips)
    for c in (10, 11):  # 10/min -> 0.5 exactly; > 10 is the rule
        row(TX_COUNT_1M=c, TX_COUNT_1H=100 + c - 10)
    # New account + large tx: age 7 vs < 7, amount 100000 vs > 100000.
    for age, amt in ((7.0, 100_001), (6.99, 100_000), (6.99, 100_001), (2.555, 600_000)):
        row(ACCOUNT_AGE_DAYS=age, TX_AMOUNT=amt)
    # Rapid deposit -> withdraw: withdrawals at exactly 80% of deposits, one
    # cent above, and deposits whose 80% is not a whole number of cents.
    for dep, wd in ((10_000, 8_000), (10_000, 8_001), (12_345, 9_876), (12_345, 9_877),
                    (999_999, 799_999), (999_999, 800_000)):
        for since in (299.0, 300.0, 3.6):
            row(TOTAL_DEPOSITS=dep, TOTAL_WITHDRAWALS=wd, DEPOSIT_COUNT=2,
                TIME_SINCE_LAST_TX=since, TX_TYPE_WITHDRAW=1.0)
    row(BONUS_ONLY_PLAYER=1.0, IS_TOR=1.0, IS_VPN=1.0)
    return np.stack(rows)


BATCHES = {"random0": lambda: _raw_batch(0), "random1": lambda: _raw_batch(1),
           "boundary": _boundary_batch}


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_apply_rules_exact(batch):
    x = BATCHES[batch]()
    bl = np.random.default_rng(5).random(x.shape[0]) < 0.1
    want_score, want_mask = japply_rules(x, bl, JScoringConfig())
    score, mask = apply_rules(torch.from_numpy(x), torch.from_numpy(bl), ScoringConfig())
    assert score.dtype == torch.int32 and mask.dtype == torch.int32
    np.testing.assert_array_equal(score.numpy(), np.asarray(want_score))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


def test_apply_rules_go_boundaries():
    """The rows of the boundary batch decide as the Go engine does."""
    x = _boundary_batch()
    _, mask = apply_rules(torch.from_numpy(x), torch.zeros(x.shape[0], dtype=torch.bool),
                          ScoringConfig())
    mask = mask.numpy()
    rapid = (mask >> 5) & 1
    dep, wd, since = (x[:, F.TOTAL_DEPOSITS], x[:, F.TOTAL_WITHDRAWALS],
                      x[:, F.TIME_SINCE_LAST_TX])
    is_wd = x[:, F.TX_TYPE_WITHDRAW] > 0
    # Go: TotalWithdrawals > TotalDeposits*80/100 in int64 arithmetic.
    go = is_wd & (since < 300) & (wd > (dep.astype(np.int64) * 80) // 100)
    np.testing.assert_array_equal(rapid.astype(bool), go)
    assert go.any() and (is_wd & ~go).any()


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_mock_predict_bit_exact(batch):
    xn = np.array(jnormalize(BATCHES[batch](), ref_compat=True))
    want = np.asarray(jmock_predict(xn))
    got = mock_predict(torch.from_numpy(xn))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_mock_predict_three_devices_counts():
    """3 devices normalize to 0.3f = 0.30000001..., which Go's float64
    compare counts as > 0.3: the device weight 0.15 is added."""
    x = np.zeros((2, NUM_FEATURES), np.float32)
    x[0, F.UNIQUE_DEVICES_24H] = 3.0
    x[1, F.UNIQUE_DEVICES_24H] = 2.0
    xn = np.array(jnormalize(x, ref_compat=True))
    got = mock_predict(torch.from_numpy(xn)).numpy()
    assert got[0] == np.float32(0.15) and got[1] == 0.0
