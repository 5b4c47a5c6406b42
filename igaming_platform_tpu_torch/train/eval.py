"""Model-quality evaluation: AUC, average precision and calibration on
labelled fraud.

Counterpart of ``igaming_platform_tpu/train/eval.py``: train the multitask
net and the forest on labelled synthetic fraud (``train/fraudgen.py``:
planted velocity, multi-accounting and bonus-abuse patterns with hard
negatives), then score a held-out set with every candidate the serving
stack can run and report ROC-AUC, average precision and expected
calibration error:

- ``rules_only``: the 8 explainable rules' score / 100;
- ``mock``: the deterministic hand-tuned scorer;
- ``ensemble_mock``: rules and mock at serving's ensemble weights;
- ``gbdt_trained``: the forest fit on labels (soft-split annealing);
- ``multitask_trained``: the fraud head of the multitask net;
- ``ensemble_trained``: rules and the multitask net at serving's weights.

The trained models are the port's serving modules (the fixed-order dense
kernel and the forest kernel on a card). ``routed_trained`` (the JAX
package's mixture-of-experts bundle, ``train/routed.py``) waits for
``ROADMAP.md`` Queue 1 item 6; the result says so under ``not_ported``.

    python -m igaming_platform_tpu_torch.train.eval --out eval.json [--device cpu]

runs on the card unless ``--device cpu``; with no card it raises. It writes
only the ``--out`` it is given. The quality bar: trained models beat the
mock, which beats rules-only, on held-out AUC (``train/gates.py``).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from igaming_platform_tpu_torch.core.config import ScoringConfig
from igaming_platform_tpu_torch.core.device import resolve_device
from igaming_platform_tpu_torch.core.features import normalize
from igaming_platform_tpu_torch.train import gates as gates_mod
from igaming_platform_tpu_torch.train.fraudgen import KIND_NAMES, generate_labeled

NOT_PORTED = {"routed_trained": "train/routed.py waits for ROADMAP.md Queue 1 item 6"}

# ---------------------------------------------------------------------------
# Metrics (pure numpy)
# ---------------------------------------------------------------------------


def roc_auc(y: np.ndarray, p: np.ndarray) -> float:
    """Rank-based AUC (equivalent to the Mann-Whitney U statistic)."""
    order = np.argsort(p, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(p) + 1)
    # Average ranks over ties so AUC is exact for discrete scores.
    sorted_p = p[order]
    i = 0
    while i < len(sorted_p):
        j = i
        while j + 1 < len(sorted_p) and sorted_p[j + 1] == sorted_p[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    pos = y > 0.5
    n_pos = int(pos.sum())
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def average_precision(y: np.ndarray, p: np.ndarray) -> float:
    """Area under the precision-recall curve (step interpolation)."""
    order = np.argsort(-p, kind="mergesort")
    y_sorted = y[order] > 0.5
    tp = np.cumsum(y_sorted)
    precision = tp / np.arange(1, len(y_sorted) + 1)
    n_pos = int(y_sorted.sum())
    if n_pos == 0:
        return 0.0
    return float((precision * y_sorted).sum() / n_pos)


def expected_calibration_error(y: np.ndarray, p: np.ndarray, bins: int = 10) -> float:
    """ECE: |mean predicted - observed rate| weighted by bin mass."""
    edges = np.linspace(0.0, 1.0, bins + 1)
    idx = np.clip(np.digitize(p, edges) - 1, 0, bins - 1)
    ece = 0.0
    for b in range(bins):
        m = idx == b
        if m.any():
            ece += (m.mean()) * abs(float(p[m].mean()) - float(y[m].mean()))
    return float(ece)


def metrics(y: np.ndarray, p: np.ndarray) -> dict:
    return {
        "auc": round(roc_auc(y, p), 4),
        "average_precision": round(average_precision(y, p), 4),
        "ece": round(expected_calibration_error(y, p), 4),
    }


# ---------------------------------------------------------------------------
# Candidates
# ---------------------------------------------------------------------------


def _rules_prob(x: np.ndarray, cfg: ScoringConfig) -> np.ndarray:
    from igaming_platform_tpu_torch.models.rules import apply_rules

    score, _ = apply_rules(torch.from_numpy(x), torch.zeros(x.shape[0], dtype=torch.bool), cfg)
    return score.numpy().astype(np.float64) / 100.0


def _mock_prob(x: np.ndarray) -> np.ndarray:
    from igaming_platform_tpu_torch.models.mock_model import mock_predict

    return mock_predict(normalize(torch.from_numpy(x), ref_compat=True)).numpy().astype(np.float64)


def train_multitask_on_labels(
    x: np.ndarray, y: np.ndarray, *, steps: int = 400, batch_size: int = 1024,
    trunk: tuple[int, ...] = (128, 128), seed: int = 0, device: str | torch.device = "cuda",
):
    """Fit the multitask net's fraud head on hard labels; the LTV and churn
    heads keep their teacher targets (``train/data.py``) so the shared trunk
    stays multi-task. Returns the serving ``MultiTask`` on ``device``."""
    from igaming_platform_tpu_torch.train.data import Batch, make_aux_targets
    from igaming_platform_tpu_torch.train.trainer import TrainConfig, Trainer

    rng = np.random.default_rng(seed)
    trainer = Trainer(TrainConfig(batch_size=batch_size, trunk=trunk, seed=seed), device=device)

    def stream():
        n = x.shape[0]
        while True:
            idx = rng.integers(0, n, batch_size)
            xb = x[idx]
            ltv_t, churn_t = make_aux_targets(xb)
            yield Batch(x=xb, fraud=y[idx], ltv=ltv_t, churn=churn_t)

    trainer.fit(steps, data=stream(), log_every=0)
    return trainer.export_params()


def _model_device(model) -> torch.device:
    return next(model.buffers()).device


def multitask_prob(model, x: np.ndarray) -> np.ndarray:
    """The serving module's fraud probability of raw rows, on its device."""
    from igaming_platform_tpu_torch.models.multitask import fraud_predict
    from igaming_platform_tpu_torch.train.distill import model_inputs

    with torch.no_grad():
        prob = fraud_predict(model, model_inputs(x, _model_device(model)))
    return prob.cpu().numpy().astype(np.float64)


def train_gbdt_on_labels(
    x: np.ndarray, y: np.ndarray, *, steps: int = 300, batch_size: int = 1024,
    n_trees: int = 64, depth: int = 4, seed: int = 0, device: str | torch.device = "cuda",
):
    """Fit the forest on hard labels with the soft-split annealing loop of
    ``train/distill.py``, fed labelled batches."""
    from igaming_platform_tpu_torch.train.distill import DistillConfig, distill_gbdt

    def labeled_batches(rng, bs):
        idx = rng.integers(0, x.shape[0], bs)
        return x[idx], y[idx]

    params, _mae = distill_gbdt(
        DistillConfig(steps=steps, batch_size=batch_size, n_trees=n_trees, depth=depth,
                      seed=seed),
        data_fn=labeled_batches, device=device)
    return params


def gbdt_prob(params, x: np.ndarray) -> np.ndarray:
    from igaming_platform_tpu_torch.models.gbdt import gbdt_predict
    from igaming_platform_tpu_torch.train.distill import model_inputs

    prob = gbdt_predict(params, model_inputs(x, params["thr"].device))
    return prob.cpu().numpy().astype(np.float64)


# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------


def run_eval(
    *, n_train: int = 60_000, n_test: int = 20_000, fraud_rate: float = 0.12,
    steps: int = 400, seed: int = 0, device: str | torch.device = "cuda",
) -> dict:
    dev = resolve_device(device)
    cfg = ScoringConfig()
    rng = np.random.default_rng(seed)
    x_train, y_train, _ = generate_labeled(rng, n_train, fraud_rate)
    x_test, y_test, kind_test = generate_labeled(
        np.random.default_rng(seed + 1), n_test, fraud_rate
    )

    t0 = time.time()
    mt_params = train_multitask_on_labels(x_train, y_train, steps=steps, seed=seed, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    mt_s = time.time() - t0
    t0 = time.time()
    gbdt_params = train_gbdt_on_labels(x_train, y_train, steps=max(150, steps // 2), seed=seed,
                                       device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gbdt_s = time.time() - t0

    rules_p = _rules_prob(x_test, cfg)
    mock_p = _mock_prob(x_test)
    mt_p = multitask_prob(mt_params, x_test)
    gb_p = gbdt_prob(gbdt_params, x_test)

    # Serving's ensemble weights (RISK_RULE_WEIGHT / RISK_ML_WEIGHT).
    rw, mw = cfg.rule_weight, cfg.ml_weight
    models = {
        "rules_only": metrics(y_test, rules_p),
        "mock": metrics(y_test, mock_p),
        "ensemble_mock": metrics(y_test, rw * rules_p + mw * mock_p),
        "gbdt_trained": metrics(y_test, gb_p),
        "multitask_trained": metrics(y_test, mt_p),
        "ensemble_trained": metrics(y_test, rw * rules_p + mw * mt_p),
    }

    # Per-archetype recall at the serving review threshold for the trained
    # ensemble: which planted pattern each model catches.
    review = (rw * rules_p + mw * mt_p) >= cfg.review_threshold / 100.0
    per_kind = {}
    for k, name in KIND_NAMES.items():
        if k == 0:
            continue
        m = kind_test == k
        per_kind[name] = round(float(review[m].mean()), 4) if m.any() else None

    return {
        "dataset": {
            "n_train": n_train, "n_test": n_test, "fraud_rate": fraud_rate,
            "patterns": [v for k, v in KIND_NAMES.items() if k > 0],
            "seed": seed,
        },
        "train": {
            "multitask_steps": steps, "multitask_seconds": round(mt_s, 1),
            "gbdt_steps": max(150, steps // 2), "gbdt_seconds": round(gbdt_s, 1),
        },
        "models": models,
        "not_ported": dict(NOT_PORTED),
        "trained_ensemble_recall_at_review": per_kind,
        "ordering": gates_mod.ordering_gates(models),
        "gates": gates_mod.eval_gates(models),
    }


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="where to write the result JSON")
    ap.add_argument("--n-train", type=int, default=60_000)
    ap.add_argument("--n-test", type=int, default=20_000)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = run_eval(n_train=args.n_train, n_test=args.n_test, steps=args.steps,
                      device=args.device)
    dev = resolve_device(args.device)
    result["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({"models": result["models"], "ordering": result["ordering"]}, indent=2))


if __name__ == "__main__":
    main()
