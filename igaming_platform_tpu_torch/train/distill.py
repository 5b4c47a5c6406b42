"""Distillation: fit the oblivious forest and the fraud MLP to a teacher.

Counterpart of ``igaming_platform_tpu/train/distill.py``. Any teacher (the
reference-parity mock scorer by default, or a label source) is distilled
into the servable students:

- the forest trains through its soft relaxation (``models/gbdt.py``'s
  ``soft_gbdt_predict``: sigmoid splits) under a temperature ramp, its
  feature ids fixed, its thresholds, leaves and bias trained, then serves
  with hard splits (the forest kernel on a card);
- the fraud MLP trains directly (``models/mlp.py``'s ``TrainMLP``, every
  layer the fixed-order dense kernel on a card);
- ``distill_serving_params`` returns ``{"mlp", "gbdt"}``: the port's
  serving params of the ``mlp+gbdt`` backend, ready for ``swap_params``.

Both take ``optax.adam``'s step (``train/trainer.py``'s ``adamw_update``
with no decay) on a mean squared error. Entry points run on ``"cuda"``
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from igaming_platform_tpu_torch.core.device import resolve_device
from igaming_platform_tpu_torch.core.features import normalize, standardize_for_model
from igaming_platform_tpu_torch.models import gbdt as gbdt_mod
from igaming_platform_tpu_torch.models import mlp as mlp_mod
from igaming_platform_tpu_torch.models.mock_model import mock_predict
from igaming_platform_tpu_torch.train.data import sample_features
from igaming_platform_tpu_torch.train.trainer import AdamState, adamw_update


@dataclass(frozen=True)
class DistillConfig:
    steps: int = 300
    batch_size: int = 1024
    learning_rate: float = 3e-3
    n_trees: int = 64
    depth: int = 4
    mlp_hidden: tuple[int, ...] = (128, 128)
    temp_start: float = 5.0
    temp_end: float = 200.0
    seed: int = 0


def default_teacher(x_raw: np.ndarray) -> np.ndarray:
    """Reference-parity teacher: the mock scorer over ref-compat
    normalization, on the CPU."""
    return mock_predict(normalize(torch.from_numpy(x_raw), ref_compat=True)).numpy()


def model_inputs(x_raw: np.ndarray, device: torch.device) -> torch.Tensor:
    """Production normalization and the model-side squash, on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(x_raw, dtype=np.float32)).to(device)
    return standardize_for_model(normalize(x))


def _adam_step(params: list[torch.Tensor], loss: torch.Tensor, state: AdamState,
               lr: float) -> AdamState:
    for p in params:
        p.grad = None
    loss.backward()
    return adamw_update(params, [p.grad for p in params], state, lr)


def distill_gbdt(cfg: DistillConfig = DistillConfig(), teacher: Callable | None = None,
                 data_fn: Callable | None = None, device: str | torch.device = "cuda"):
    """Fit the forest by soft-split annealing; returns (params on
    ``device``, the hard forest's MAE on 4,096 held-out rows).

    ``teacher`` maps raw features to targets (default: the mock scorer).
    ``data_fn(rng, batch_size) -> (x_raw, y)`` replaces the whole batch
    source (``train/eval.py`` fits labelled data with the same recipe)."""
    dev = resolve_device(device)
    teacher = teacher or default_teacher
    if data_fn is None:
        def data_fn(rng, batch_size):  # noqa: ANN001
            x_raw = sample_features(rng, batch_size)
            return x_raw, np.asarray(teacher(x_raw))
    init = gbdt_mod.init_gbdt(torch.Generator().manual_seed(cfg.seed), n_trees=cfg.n_trees,
                              depth=cfg.depth)
    feat = init["feat"].to(dev)
    trainable = [init[k].to(dev).requires_grad_(True) for k in ("thr", "leaves", "bias")]
    state = AdamState.zeros(trainable)

    rng = np.random.default_rng(cfg.seed)
    for i in range(cfg.steps):
        x_raw, y = data_fn(rng, cfg.batch_size)
        y = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
        frac = i / max(cfg.steps - 1, 1)
        temp = cfg.temp_start * (cfg.temp_end / cfg.temp_start) ** frac
        thr, leaves, bias = trainable
        pred = gbdt_mod.soft_gbdt_predict({"feat": feat, "thr": thr, "leaves": leaves,
                                           "bias": bias}, model_inputs(x_raw, dev), temp)
        state = _adam_step(trainable, torch.mean((pred - y) ** 2), state, cfg.learning_rate)

    final = {"feat": feat.contiguous(),
             **{k: t.detach().contiguous() for k, t in zip(("thr", "leaves", "bias"), trainable)}}
    x_eval, y_eval = data_fn(np.random.default_rng(cfg.seed + 1), 4096)
    pred = gbdt_mod.gbdt_predict(final, model_inputs(x_eval, dev)).cpu().numpy()
    return final, float(np.mean(np.abs(pred - np.asarray(y_eval, np.float32))))


def distill_mlp(cfg: DistillConfig = DistillConfig(), teacher: Callable | None = None,
                device: str | torch.device = "cuda"):
    """Fit the fraud MLP; returns (the serving ``MLP`` on ``device``, its MAE
    against the teacher on 4,096 held-out rows)."""
    dev = resolve_device(device)
    teacher = teacher or default_teacher
    model = mlp_mod.init_mlp(torch.Generator().manual_seed(cfg.seed + 7),
                             hidden=cfg.mlp_hidden).to(dev)
    params = list(model.parameters())
    state = AdamState.zeros(params)

    rng = np.random.default_rng(cfg.seed + 7)
    for _ in range(cfg.steps):
        x_raw = sample_features(rng, cfg.batch_size)
        y = torch.from_numpy(np.asarray(teacher(x_raw), np.float32)).to(dev)
        pred = torch.sigmoid(model(model_inputs(x_raw, dev))[..., 0])
        state = _adam_step(params, torch.mean((pred - y) ** 2), state, cfg.learning_rate)

    served = model.serving()
    x_eval = sample_features(np.random.default_rng(cfg.seed + 8), 4096)
    with torch.no_grad():
        pred = mlp_mod.mlp_predict(served, model_inputs(x_eval, dev)).cpu().numpy()
    return served, float(np.mean(np.abs(pred - np.asarray(teacher(x_eval), np.float32))))


def distill_serving_params(cfg: DistillConfig = DistillConfig(), teacher: Callable | None = None,
                           device: str | torch.device = "cuda"):
    """Train both students; returns ({"mlp", "gbdt"}, {"mlp_mae", "gbdt_mae"})."""
    gbdt_params, gbdt_mae = distill_gbdt(cfg, teacher, device=device)
    mlp_params, mlp_mae = distill_mlp(cfg, teacher, device=device)
    return {"mlp": mlp_params, "gbdt": gbdt_params}, {"mlp_mae": mlp_mae, "gbdt_mae": gbdt_mae}
