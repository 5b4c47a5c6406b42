"""The fraud-scoring step: normalize -> ML -> rules -> ensemble -> action, in PyTorch.

Counterpart of ``igaming_platform_tpu/models/ensemble.py`` (reference
pipeline: engine.go:262-323). One function over a [B, 30] batch on one
device; PyTorch runs it eagerly, op by op, where the JAX package compiles
it into one XLA program.

Backends: ``mock``, ``mlp``, ``gbdt``, ``mlp+gbdt``, ``multitask`` and their
int8 variants ``mlp_int8``, ``gbdt_int8``, ``mlp+gbdt_int8`` and
``multitask_int8`` (``ops/quantize.py``). The routed mixture waits for the
multi-device slice; its name, like any other unknown one, raises.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from igaming_platform_tpu_torch.core.config import ScoringConfig
from igaming_platform_tpu_torch.core.device import resolve_device
from igaming_platform_tpu_torch.core.enums import ACTION_APPROVE, ACTION_BLOCK, ACTION_REVIEW
from igaming_platform_tpu_torch.core.features import normalize, standardize_for_model
from igaming_platform_tpu_torch.models import gbdt as gbdt_mod
from igaming_platform_tpu_torch.models import mlp as mlp_mod
from igaming_platform_tpu_torch.models.mock_model import mock_predict
from igaming_platform_tpu_torch.models.multitask import fraud_predict
from igaming_platform_tpu_torch.models.rules import apply_rules
from igaming_platform_tpu_torch.ops.quantize import gbdt_predict_int8, mlp_predict_int8

BACKENDS = ("mock", "mlp", "gbdt", "mlp+gbdt", "multitask",
            "mlp_int8", "gbdt_int8", "mlp+gbdt_int8", "multitask_int8")

# Bit index of ML_HIGH_RISK in the reason mask (REASON_BIT_ORDER[8]).
ML_HIGH_RISK_BIT = 8

# Guards against float32 sitting an ulp below the float64 value Go computes
# before its int() truncation.
_TRUNC_EPS = 1e-4


def combine(
    rule_score: torch.Tensor,
    ml_score: torch.Tensor,
    reason_mask: torch.Tensor,
    cfg: ScoringConfig,
    thresholds: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ensemble + action decision (engine.go:285-310).

    ``thresholds`` is an optional [2] int32 tensor (block, review): the
    runtime-tunable thresholds enter as data, so changing them rebuilds
    nothing. Without it the config's values apply.

    The float32 association is the JAX package's:
    ``((rule_weight*rule) + ((ml_weight*ml)*100)) + _TRUNC_EPS``, then floor.

    Returns (final_score [B] i32, action [B] i32, reason_mask [B] i32).
    """
    final = torch.floor(
        cfg.rule_weight * rule_score.to(torch.float32)
        + cfg.ml_weight * ml_score * 100.0
        + _TRUNC_EPS
    ).to(torch.int32)
    final = torch.clamp_max(final, 100)

    # ML_HIGH_RISK appended when ml > 0.7 (engine.go:285-287).
    reason_mask = reason_mask | torch.where(ml_score > 0.7, 1 << ML_HIGH_RISK_BIT, 0).to(torch.int32)

    if thresholds is None:
        block, review = cfg.block_threshold, cfg.review_threshold
    else:
        block, review = thresholds[0], thresholds[1]

    action = torch.where(
        final >= block,
        ACTION_BLOCK,
        torch.where(final >= review, ACTION_REVIEW, ACTION_APPROVE),
    ).to(torch.int32)
    return final, action, reason_mask


def make_score_fn(
    cfg: ScoringConfig,
    ml_backend: str = "mock",
    device: str | torch.device = "cuda",
) -> Callable[..., dict[str, torch.Tensor]]:
    """Build the scoring step for an ML backend, on ``device``.

    Backends:
      - "mock": reference-parity deterministic scorer (no params)
      - "mlp": fraud MLP (``params["mlp"]``, an ``MLP``)
      - "gbdt": oblivious forest (``params["gbdt"]``, a dict of tensors)
      - "mlp+gbdt": mean of the MLP and GBDT probabilities
      - "multitask": fraud head of the multi-task net (``params["multitask"]``)
      - "mlp_int8", "gbdt_int8", "mlp+gbdt_int8", "multitask_int8": the same
        with int8 params (``ops/quantize.py``; the multitask variant is its
        fraud path as an int8 MLP)

    The returned fn has signature ``f(params, x_raw, blacklisted,
    thresholds=None)``: ``x_raw`` a [B, 30] float32 raw batch, ``blacklisted``
    [B] bool, both numpy arrays or tensors; params must already sit on
    ``device`` (``convert.params_to``). It returns a dict of [B] tensors on
    ``device``: score, action, rule_score, ml_score, reason_mask.

    The mock backend normalizes in ref-compat mode (identity log1p), the
    data its thresholds were written against; the trained backends use the
    real log1p plus the model-side squash.
    """
    if ml_backend not in BACKENDS:
        raise ValueError(f"unknown ml backend: {ml_backend}")
    dev = resolve_device(device)
    ref_compat = ml_backend == "mock"

    def score_fn(
        params: Any,
        x_raw,
        blacklisted,
        thresholds: torch.Tensor | None = None,
    ) -> dict[str, torch.Tensor]:
        x_raw = torch.as_tensor(x_raw, dtype=torch.float32, device=dev)
        blacklisted = torch.as_tensor(blacklisted, dtype=torch.bool, device=dev)
        if thresholds is not None:
            thresholds = torch.as_tensor(thresholds, dtype=torch.int32, device=dev)
        xn = normalize(x_raw, ref_compat=ref_compat)
        if not ref_compat:
            xn = standardize_for_model(xn)

        if ml_backend == "mock":
            ml = mock_predict(xn)
        elif ml_backend == "mlp":
            ml = mlp_mod.mlp_predict(params["mlp"], xn)
        elif ml_backend == "gbdt":
            ml = gbdt_mod.gbdt_predict(params["gbdt"], xn)
        elif ml_backend == "mlp_int8":
            ml = mlp_predict_int8(params["mlp_int8"], xn)
        elif ml_backend == "gbdt_int8":
            ml = gbdt_predict_int8(params["gbdt_int8"], xn)
        elif ml_backend == "mlp+gbdt":
            ml = 0.5 * (mlp_mod.mlp_predict(params["mlp"], xn)
                        + gbdt_mod.gbdt_predict(params["gbdt"], xn))
        elif ml_backend == "mlp+gbdt_int8":
            ml = 0.5 * (mlp_predict_int8(params["mlp_int8"], xn)
                        + gbdt_predict_int8(params["gbdt_int8"], xn))
        elif ml_backend == "multitask":
            ml = fraud_predict(params["multitask"], xn)
        else:
            ml = mlp_predict_int8(params["multitask_int8"], xn)

        rule_score, mask = apply_rules(x_raw, blacklisted, cfg)
        final, action, mask = combine(rule_score, ml, mask, cfg, thresholds)
        return {
            "score": final,
            "action": action,
            "rule_score": rule_score,
            "ml_score": ml,
            "reason_mask": mask,
        }

    return score_fn
