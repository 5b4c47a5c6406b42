"""Train the routed ensemble: router and experts jointly, on labels.

Counterpart of ``igaming_platform_tpu/train/routed.py``. ``ml_backend=
"routed"`` (``models/ensemble.py``) serves a top-k mixture of the
ensemble's experts; this fits the whole bundle on labelled fraud:

- the router learns which expert to trust per row (gradients flow through
  the top-k gate values: the renormalised weights are differentiable in the
  winning logits; ``parallel/ep.gate_probs`` through the fixed-order float32
  kernel, ``dense_f32_train``);
- the trainable experts (the MLP, the forest through its soft-split
  relaxation under the temperature ramp of ``train/distill.py``, the
  multitask net's fraud head; every bf16 layer the fixed-order dense kernel
  on a card) learn with it; the mock expert is a frozen heuristic the router
  can still pick;
- a Switch-style load-balance term (fraction of rows times mean gate per
  expert, the fraction without gradient) keeps the router from collapsing
  onto one expert.

``optax.adam``'s step (``train/trainer.adamw_update`` with no decay), the
batches of ``np.random.default_rng(cfg.seed)``. The result is the serving
bundle ``{router, mock, mlp, gbdt, multitask}`` that
``TorchScoringEngine(ml_backend="routed")`` takes, and ``routed_prob``
scores as that backend does (the hard forest). Entry points run on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from igaming_platform_tpu_torch.core.device import resolve_device
from igaming_platform_tpu_torch.core.features import normalize, standardize_for_model
from igaming_platform_tpu_torch.models.ensemble import TrainRouted, init_routed_train_params
from igaming_platform_tpu_torch.models.gbdt import soft_gbdt_predict
from igaming_platform_tpu_torch.models.mock_model import mock_predict
from igaming_platform_tpu_torch.parallel.ep import gate_probs, topk_mix
from igaming_platform_tpu_torch.train.trainer import AdamState, adamw_update


@dataclass(frozen=True)
class RoutedTrainConfig:
    steps: int = 400
    batch_size: int = 1024
    learning_rate: float = 3e-3
    k: int = 2
    load_balance_weight: float = 0.5
    # The forest's soft-split temperature ramp (train/distill.py's recipe).
    temp_start: float = 5.0
    temp_end: float = 200.0
    mlp_hidden: tuple[int, ...] = (64, 64)
    n_trees: int = 32
    depth: int = 4
    trunk: tuple[int, ...] = (64, 64)
    seed: int = 0


def _expert_outputs(bundle: TrainRouted, x_raw: torch.Tensor, temp: float) -> torch.Tensor:
    """[B, 4] expert probabilities (the soft forest, so gradients flow)."""
    prep = standardize_for_model(normalize(x_raw))
    return torch.stack([
        mock_predict(normalize(x_raw, ref_compat=True)),
        torch.sigmoid(bundle.mlp(prep)[..., 0]),
        soft_gbdt_predict(bundle.forest.params(), prep, temperature=temp),
        torch.sigmoid(bundle.multitask.fraud_logit(prep)),
    ], dim=-1)


def routed_mixture(bundle: TrainRouted, x_raw: torch.Tensor, k: int, temp: float) -> tuple:
    """The differentiable top-k mixture and what the balance term needs:
    (mix [B], gates [B, E], top_idx [B, k]). The mix is ``ep.topk_mix``,
    the function serving uses."""
    gates = gate_probs(bundle.router, x_raw)
    mix, top_idx = topk_mix(gates, _expert_outputs(bundle, x_raw, temp), k)
    return mix, gates, top_idx


def load_balance_loss(gates: torch.Tensor, top_idx: torch.Tensor) -> torch.Tensor:
    """Switch-transformer aux: ``E * sum_e f_e * P_e``, smallest when the
    routed fractions and the gate mass are uniform. ``f_e`` is a count (no
    gradient); the router's gradient comes through ``P_e``."""
    e = gates.shape[-1]
    top1 = torch.nn.functional.one_hot(top_idx[:, 0], e).to(gates.dtype)
    f = torch.mean(top1, dim=0).detach()
    p = torch.mean(gates, dim=0)
    return e * torch.sum(f * p)


def train_routed_on_labels(x: np.ndarray, y: np.ndarray,
                           cfg: RoutedTrainConfig = RoutedTrainConfig(), *,
                           device: str | torch.device = "cuda",
                           losses: list | None = None) -> dict:
    """Fit the router and experts on labelled raw rows; returns the serving
    bundle on ``device``. ``losses``, when given, gets each step's loss (a
    tensor on the device, unread)."""
    dev = resolve_device(device)
    bundle = init_routed_train_params(cfg.seed, mlp_hidden=cfg.mlp_hidden,
                                      n_trees=cfg.n_trees, depth=cfg.depth,
                                      trunk=cfg.trunk).to(dev)
    params = list(bundle.parameters())
    state = AdamState.zeros(params)
    rng = np.random.default_rng(cfg.seed)
    eps = 1e-6
    for i in range(cfg.steps):
        idx = rng.integers(0, x.shape[0], cfg.batch_size)
        frac = i / max(cfg.steps - 1, 1)
        temp = float(np.float32(cfg.temp_start * (cfg.temp_end / cfg.temp_start) ** frac))
        xb = torch.from_numpy(np.ascontiguousarray(x[idx], dtype=np.float32)).to(dev)
        yb = torch.from_numpy(y[idx].astype(np.float32)).to(dev)
        mix, gates, top_idx = routed_mixture(bundle, xb, cfg.k, temp)
        bce = -torch.mean(yb * torch.log(mix + eps) + (1.0 - yb) * torch.log(1.0 - mix + eps))
        loss = bce + cfg.load_balance_weight * load_balance_loss(gates, top_idx)
        # The multitask net's LTV and churn heads feed nothing: zero
        # gradients, as jax.grad gives them.
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True))]
        state = adamw_update(params, grads, state, cfg.learning_rate)
        if losses is not None:
            losses.append(loss.detach())
    return bundle.serving()


def routed_prob(params: dict, x_raw: np.ndarray, k: int = 2) -> np.ndarray:
    """The serving bundle's probability of raw rows, as ``ml_backend=
    "routed"`` serves it (``parallel/ep.dense_reference`` over the same
    expert stack, the hard forest), on the bundle's device; float64."""
    from igaming_platform_tpu_torch.models.ensemble import routed_experts
    from igaming_platform_tpu_torch.parallel.ep import dense_reference

    fns, keys = routed_experts()
    dev = params["router"].device
    x = torch.from_numpy(np.ascontiguousarray(x_raw, dtype=np.float32)).to(dev)
    with torch.no_grad():
        prob = dense_reference(params["router"], tuple(params.get(key) for key in keys), x,
                               expert_fns=fns, k=k)
    return prob.cpu().numpy().astype(np.float64)
