"""Quality and promotion gates: one source of truth for every floor.

A copy of ``igaming_platform_tpu/train/gates.py`` (the port imports nothing
of the JAX package): the same bounds, the same ``PROMOTE_*`` environment
overrides and the same tables, so a gate table the port writes into a
``PromotionRecord`` reads as the JAX controller's would. A model-change gate
must be attributable: the number that blocked or admitted a candidate has
exactly one definition, and the record says which gate said what.
Consumers in the port:

- ``train/eval.py``: the ``ordering`` and ``gates`` blocks of its result;
- ``train/promote.py``: the online promotion controller's admit and
  rollback decisions.
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class EvalGates:
    """Offline model-quality floors (the EVAL.json contract)."""

    # Trained candidates must beat the hand-tuned mock by a real margin
    # (the committed EVAL.json shows ~0.10 headroom; the floor asserts
    # the ordering is earned, not a tie broken by noise).
    min_margin_over_mock: float = 0.015
    # Absolute floor for a trained fraud head on the labeled holdout.
    min_trained_auc: float = 0.95
    # Calibration ceiling — a model can rank well and still be unusable
    # for threshold-based actions if its probabilities drift.
    max_trained_ece: float = 0.10


EVAL_GATES = EvalGates()


def ordering_gates(models: dict) -> dict:
    """The EVAL.json ``ordering`` block: pairwise quality ordering the
    repo's quality story rests on (trained > mock > rules)."""
    return {
        "trained_beats_mock": (
            models["multitask_trained"]["auc"] > models["mock"]["auc"]),
        "mock_beats_rules": (
            models["mock"]["auc"] > models["rules_only"]["auc"]),
        "gbdt_beats_mock": (
            models["gbdt_trained"]["auc"] > models["mock"]["auc"]),
    }


def eval_gates(models: dict, gates: EvalGates = EVAL_GATES) -> dict:
    """Threshold gates over an EVAL.json ``models`` block: gate name ->
    {ok, value, bound}. ``all(ok)`` is the admit verdict."""
    trained = models["multitask_trained"]
    mock = models["mock"]
    table = {
        "trained_auc_floor": {
            "value": trained["auc"], "bound": gates.min_trained_auc,
            "ok": trained["auc"] >= gates.min_trained_auc},
        "margin_over_mock": {
            "value": round(trained["auc"] - mock["auc"], 4),
            "bound": gates.min_margin_over_mock,
            "ok": trained["auc"] - mock["auc"] >= gates.min_margin_over_mock},
        "trained_ece_ceiling": {
            "value": trained["ece"], "bound": gates.max_trained_ece,
            "ok": trained["ece"] <= gates.max_trained_ece},
    }
    return table


@dataclass(frozen=True)
class PromotionGates:
    """Online promotion floors (train/promote.py). Every bound has a
    ``PROMOTE_*`` env override so a deployment can tighten or loosen a
    gate without a code change — and the gate table recorded on each
    promotion carries the values actually used."""

    # Candidate quality on the labeled probe set (fraud-head ROC-AUC).
    min_candidate_auc: float = 0.90
    # The candidate may not regress the last-known-good params' probe
    # AUC by more than this (absolute).
    max_auc_drop: float = 0.02
    # Shadow evidence: at least this many live rows scored by the
    # candidate since it became the shadow, and no more than this
    # fraction of them flipping the production action.
    min_shadow_rows: int = 256
    max_flip_rate: float = 0.15
    # SLO plane: no promotion while a burn-rate alert is active (the
    # serving path is already in trouble; a param swap mid-incident
    # destroys attribution).
    require_slo_quiet: bool = True
    # Drift plane (obs/drift.py): no promotion while input, score or
    # calibration drift is alerting — a candidate trained on drifted
    # data can pass every latency and probe gate and still be the wrong
    # model to promote; drift evidence must settle first.
    require_drift_quiet: bool = True
    # Post-promotion watch: the live probe AUC floor below which the
    # controller rolls back to last-known-good within one tick.
    min_post_auc: float = 0.85
    # Rollback also fires if the SLO fast window starts burning hard
    # right after a promotion (quality regressions that manifest as
    # latency/errors rather than AUC).
    rollback_on_slo_page: bool = True
    # Minimum seconds between promotions: the learner emits a fresh
    # candidate every tick, and promoting each one would churn the
    # served fingerprint faster than anyone can attribute an incident
    # to a model change.
    cooldown_s: float = 0.0

    @classmethod
    def from_env(cls) -> "PromotionGates":
        def _f(name: str, default: float) -> float:
            return float(os.environ.get(name, str(default)))

        return cls(
            min_candidate_auc=_f("PROMOTE_MIN_AUC", cls.min_candidate_auc),
            max_auc_drop=_f("PROMOTE_MAX_AUC_DROP", cls.max_auc_drop),
            min_shadow_rows=int(_f("PROMOTE_MIN_SHADOW_ROWS",
                                   cls.min_shadow_rows)),
            max_flip_rate=_f("PROMOTE_MAX_FLIP_RATE", cls.max_flip_rate),
            require_slo_quiet=os.environ.get(
                "PROMOTE_REQUIRE_SLO_QUIET", "1") != "0",
            require_drift_quiet=os.environ.get(
                "PROMOTE_REQUIRE_DRIFT_QUIET", "1") != "0",
            min_post_auc=_f("PROMOTE_MIN_POST_AUC", cls.min_post_auc),
            rollback_on_slo_page=os.environ.get(
                "PROMOTE_ROLLBACK_ON_SLO_PAGE", "1") != "0",
            cooldown_s=_f("PROMOTE_COOLDOWN_S", cls.cooldown_s),
        )

    def as_dict(self) -> dict:
        return asdict(self)


def promotion_gate_table(
    *,
    candidate_auc: float,
    baseline_auc: float,
    shadow_rows: int,
    flip_rate: float,
    slo_alerting: bool,
    gates: PromotionGates,
    drift_alerting: bool = False,
) -> dict:
    """The admit gate table: gate name -> {ok, value, bound}. Promotion
    fires only when every row's ``ok`` is True; the table itself is what
    lands in the ledger's PromotionRecord (attributable gating)."""
    table = {
        "candidate_auc_floor": {
            "value": round(candidate_auc, 4),
            "bound": gates.min_candidate_auc,
            "ok": candidate_auc >= gates.min_candidate_auc},
        "no_regression_vs_baseline": {
            "value": round(candidate_auc - baseline_auc, 4),
            "bound": -gates.max_auc_drop,
            "ok": candidate_auc >= baseline_auc - gates.max_auc_drop},
        "shadow_rows_floor": {
            "value": shadow_rows, "bound": gates.min_shadow_rows,
            "ok": shadow_rows >= gates.min_shadow_rows},
        "shadow_flip_rate_ceiling": {
            "value": round(flip_rate, 4), "bound": gates.max_flip_rate,
            "ok": flip_rate <= gates.max_flip_rate},
        "slo_quiet": {
            "value": bool(slo_alerting), "bound": False,
            "ok": (not slo_alerting) or not gates.require_slo_quiet},
        "drift_quiet": {
            "value": bool(drift_alerting), "bound": False,
            "ok": (not drift_alerting) or not gates.require_drift_quiet},
    }
    return table


def gates_pass(table: dict) -> bool:
    return all(row["ok"] for row in table.values())
