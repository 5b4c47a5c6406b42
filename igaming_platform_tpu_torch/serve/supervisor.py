"""The degraded scoring tier's scorer, for replay.

The port's counterpart of ``heuristic_scores`` in
``igaming_platform_tpu/serve/supervisor.py``. The replay tool re-scores the
decisions a JAX server took in its ``DEGRADED_CPU_HEURISTIC`` tier with it.
The rest of the supervisor (circuit breakers, serving states, the wrapped
engine and its heuristic fallback) comes with Queue 1 item 4
(``ROADMAP.md``); until then the port's engine has no degraded tier.
"""

from __future__ import annotations

import numpy as np

from igaming_platform_tpu_torch.core.enums import (
    ACTION_APPROVE,
    ACTION_BLOCK,
    ACTION_REVIEW,
    REASON_BIT_ORDER,
    ReasonCode,
)
from igaming_platform_tpu_torch.core.features import F


def heuristic_scores(x: np.ndarray, bl: np.ndarray, thresholds) -> dict[str, np.ndarray]:
    """Vectorized conservative scoring over a [N, 30] feature matrix, with
    the compiled step's result-dict contract: a blatant-pattern rule set
    that blocks the obvious fraud and approves the rest."""
    x = np.asarray(x, dtype=np.float32)
    bl = np.asarray(bl, dtype=bool)
    n = x.shape[0]
    score = np.zeros((n,), dtype=np.float32)
    mask = np.zeros((n,), dtype=np.int32)

    def rule(cond: np.ndarray, points: float, code: ReasonCode) -> None:
        cond = np.asarray(cond, dtype=bool)
        score[cond] += points
        mask[cond] |= 1 << REASON_BIT_ORDER.index(code)

    rule(x[:, F.TX_COUNT_1M] > 10, 30.0, ReasonCode.HIGH_VELOCITY)
    rule((x[:, F.ACCOUNT_AGE_DAYS] < 1.0) & (x[:, F.TX_AMOUNT] > 50_000),
         25.0, ReasonCode.NEW_ACCOUNT_LARGE_TX)
    rule((x[:, F.TIME_SINCE_LAST_TX] < 30.0) & (x[:, F.TX_TYPE_WITHDRAW] > 0)
         & (x[:, F.DEPOSIT_COUNT] > 0),
         20.0, ReasonCode.RAPID_DEPOSIT_WITHDRAW)
    rule(x[:, F.BONUS_ONLY_PLAYER] > 0, 20.0, ReasonCode.BONUS_ABUSE)
    rule((x[:, F.IS_VPN] > 0) | (x[:, F.IS_TOR] > 0), 10.0, ReasonCode.VPN_DETECTED)
    rule(bl, 80.0, ReasonCode.KNOWN_FRAUDSTER)

    score_i = np.clip(score, 0.0, 100.0).astype(np.int32)
    thr = np.asarray(thresholds, dtype=np.int32)
    action = np.where(score_i >= thr[0], ACTION_BLOCK,
                      np.where(score_i >= thr[1], ACTION_REVIEW, ACTION_APPROVE)).astype(np.int32)
    return {
        "score": score_i,
        "action": action,
        "reason_mask": mask,
        "rule_score": score_i.copy(),
        "ml_score": (score_i / 100.0).astype(np.float32),
    }
