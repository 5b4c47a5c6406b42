"""Card-against-CPU numerics parity for trained models.

Counterpart of ``igaming_platform_tpu/train/device_parity.py``, with the
same contract as its ``run()``: train the serving multitask net and the
forest once, on the card, on labelled synthetic fraud
(``train/fraudgen.py``), score one held-out batch with the trained params
on the card and on the CPU, and report the deltas:

    python -m igaming_platform_tpu_torch.train.device_parity [--out FILE] [--device cpu]

Bounds (the JAX package's): max |fraud-probability delta| <= 1e-2, AUC
delta <= 1e-3, and >= 99% of the derived integer scores within +-1. The
multitask net's layers run the fixed-order dense kernel and its sigmoid
rounds from float64 (``core/numerics.py``), so its delta is expected to be
0; the forest's is measured. As in the JAX harness, the forest scores the
raw ``x_test`` rows, not the normalized ones it was trained on: the harness
checks that the devices agree, and that is what it compares. With
``--device cpu`` both sides are the CPU (labelled ``same_backend``).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from igaming_platform_tpu_torch.convert import params_to
from igaming_platform_tpu_torch.core.device import resolve_device


def _auc(y: np.ndarray, p: np.ndarray) -> float:
    order = np.argsort(p)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(p) + 1)
    pos = y > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if not n_pos or not n_neg:
        return float("nan")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def run(n_rows: int = 40_000, steps: int = 300, seed: int = 0,
        device: str | torch.device = "cuda") -> dict:
    from igaming_platform_tpu_torch.models.gbdt import gbdt_predict
    from igaming_platform_tpu_torch.models.multitask import fraud_predict
    from igaming_platform_tpu_torch.train.distill import model_inputs
    from igaming_platform_tpu_torch.train.eval import (
        train_gbdt_on_labels,
        train_multitask_on_labels,
    )
    from igaming_platform_tpu_torch.train.fraudgen import generate_labeled

    dev = resolve_device(device)
    cpu = torch.device("cpu")
    x, y, _arche = generate_labeled(np.random.default_rng(seed), n_rows)
    split = int(0.8 * n_rows)
    x_train, y_train = x[:split], y[:split]
    x_test, y_test = x[split:], y[split:]

    mt_params = train_multitask_on_labels(x_train, y_train, steps=steps, seed=seed, device=dev)
    gbdt_params = train_gbdt_on_labels(x_train, y_train, steps=steps, seed=seed, device=dev)
    xn = model_inputs(x_test, cpu)

    def mt_prob(target):
        model = params_to({"multitask": mt_params}, target)["multitask"]
        with torch.no_grad():
            return fraud_predict(model, xn.to(target)).cpu().numpy().astype(np.float64)

    def gb_prob(target):
        params = params_to({"gbdt": gbdt_params}, target)["gbdt"]
        xb = torch.from_numpy(np.ascontiguousarray(x_test, dtype=np.float32)).to(target)
        return gbdt_predict(params, xb).cpu().numpy().astype(np.float64)

    out: dict = {
        "metric": "trained_model_device_parity",
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "cpu_control": "cpu",
        "rows": int(x_test.shape[0]),
        "same_backend": dev.type == "cpu",
    }
    worst_prob, worst_auc, worst_score_agree = 0.0, 0.0, 1.0
    for name, fn in (("multitask", mt_prob), ("gbdt", gb_prob)):
        p_dev = fn(dev)
        p_cpu = fn(cpu)
        delta = float(np.max(np.abs(p_dev - p_cpu)))
        auc_dev, auc_cpu = _auc(y_test, p_dev), _auc(y_test, p_cpu)
        # The ensemble's ML contribution is int(p * 100 * 0.6): the integer
        # score the wire carries.
        s_dev = np.floor(p_dev * 100.0 * 0.6)
        s_cpu = np.floor(p_cpu * 100.0 * 0.6)
        agree1 = float(np.mean(np.abs(s_dev - s_cpu) <= 1.0))
        out[name] = {
            "max_prob_delta": round(delta, 6),
            "max_prob_delta_unrounded": delta,
            "auc_device": round(auc_dev, 6),
            "auc_cpu": round(auc_cpu, 6),
            "auc_delta": round(abs(auc_dev - auc_cpu), 6),
            "score_within_1": round(agree1, 5),
            "rows_bit_equal": int(np.sum(p_dev == p_cpu)),
        }
        worst_prob = max(worst_prob, delta)
        worst_auc = max(worst_auc, abs(auc_dev - auc_cpu))
        worst_score_agree = min(worst_score_agree, agree1)
    out.update({
        "max_prob_delta": round(worst_prob, 6),
        "max_auc_delta": round(worst_auc, 6),
        "min_score_within_1": round(worst_score_agree, 5),
        "ok": bool(worst_prob <= 1e-2 and worst_auc <= 1e-3 and worst_score_agree >= 0.99),
    })
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="")
    parser.add_argument("--rows", type=int, default=40_000)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    result = run(n_rows=args.rows, steps=args.steps, device=args.device)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
