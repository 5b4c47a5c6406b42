"""Pipeline-parallel training: gradients through the GPipe schedule.

Counterpart of ``igaming_platform_tpu/train/pp.py``. ``parallel/pipeline.py``
gives the forward microbatch schedule; this closes the loop for training:
loss, gradients and ``optax.sgd``'s update, differentiated through the
pipeline, so each stage's gradient is computed on its own device
(activations flow forward stage to stage, their gradients flow back the
reverse way: autograd through the copies between devices).

A regression trunk of d -> d dense stages (classic GPipe): an input
projection and a scalar head stay on the mesh's first device, outside the
pipeline. Every layer is ``ops/dense.py``'s ``dense_f32_train`` (the
fixed-order float32 kernel on a card, ``torch.matmul`` gradients).
``mesh=None`` runs the same stages in a loop on one device: the sequential
reference the pipelined trainer is held to. Entry points run on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from igaming_platform_tpu_torch.core.device import resolve_device
from igaming_platform_tpu_torch.ops.dense import dense_f32_train
from igaming_platform_tpu_torch.parallel.mesh import AXIS_MODEL, Mesh
from igaming_platform_tpu_torch.parallel.pipeline import (
    mlp_stage_fn,
    pipeline_apply,
    stack_stage_params,
)


@dataclass(frozen=True)
class PPTrainConfig:
    d_model: int = 64
    learning_rate: float = 1e-2
    num_microbatches: int = 4
    seed: int = 0


def init_pp_params(gen: torch.Generator, n_stages: int, d_model: int, in_dim: int,
                   stacked: bool = True) -> dict:
    """Input projection + ``n_stages`` d -> d stages + a scalar head, on the
    CPU, with the JAX ``init_pp_params`` distributions (weights normal over
    sqrt(fan-in), zero biases) drawn from ``gen``: not a JAX key's numbers."""
    def layer(d_in: int, d_out: int) -> dict:
        w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32) / math.sqrt(d_in)
        return {"w": w, "b": torch.zeros(d_out, dtype=torch.float32)}

    proj = layer(in_dim, d_model)
    stages = [layer(d_model, d_model) for _ in range(n_stages)]
    head = layer(d_model, 1)
    return {"proj": proj, "stages": stack_stage_params(stages) if stacked else stages,
            "head": head}


def _affine(p: dict, x: torch.Tensor) -> torch.Tensor:
    return dense_f32_train(x.contiguous(), p["w"], p["b"])


def _forward(params: dict, x: torch.Tensor, mesh: Mesh | None,
             num_microbatches: int) -> torch.Tensor:
    h = torch.relu(_affine(params["proj"], x))
    if mesh is not None:
        h = pipeline_apply(mlp_stage_fn, params["stages"], h, mesh,
                           num_microbatches=num_microbatches, axis=AXIS_MODEL)
    else:  # the sequential reference: the same stages in a loop on one device
        for stage in params["stages"]:
            h = mlp_stage_fn(stage, h)
    return _affine(params["head"], h)[..., 0]


def leaves(params: dict) -> list[torch.Tensor]:
    """Every tensor of a trainer's params: proj, the stages in order, head."""
    out = [params["proj"]["w"], params["proj"]["b"]]
    for stage in params["stages"]:
        out += [stage["w"], stage["b"]]
    return out + [params["head"]["w"], params["head"]["b"]]


class PPTrainer:
    """A regression trainer whose trunk runs pipeline-parallel over
    ``model``. ``params`` (a tree as ``init_pp_params`` gives it, stacked or
    per stage; ``convert.pp_params_from_tree`` carries a JAX one) replaces
    the seeded init."""

    def __init__(self, cfg: PPTrainConfig, in_dim: int, n_stages: int, mesh: Mesh | None = None,
                 *, device: str | torch.device = "cuda", params: dict | None = None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None and int(mesh.shape[AXIS_MODEL]) != n_stages:
            raise ValueError(
                f"n_stages {n_stages} != mesh '{AXIS_MODEL}' axis {int(mesh.shape[AXIS_MODEL])}")
        self.device = resolve_device(mesh.device if mesh is not None else device)
        if params is None:
            params = init_pp_params(torch.Generator().manual_seed(cfg.seed), n_stages,
                                    cfg.d_model, in_dim)
        stages = params["stages"]
        if isinstance(stages, dict):
            stages = [{k: v[s] for k, v in stages.items()} for s in range(n_stages)]
        if len(stages) != n_stages:
            raise ValueError(f"params hold {len(stages)} stages, want {n_stages}")

        def own(p: dict, dev) -> dict:
            return {k: (v.detach().clone() if isinstance(v, torch.Tensor)
                        else torch.from_numpy(np.array(v, dtype=np.float32)))
                    .to(dtype=torch.float32, device=dev).requires_grad_(True)
                    for k, v in p.items()}

        # Each stage's leaves on its own device (all on one without a mesh).
        stages = [own(p, mesh.axis_device(AXIS_MODEL, s) if mesh is not None else self.device)
                  for s, p in enumerate(stages)]
        self.params = {"proj": own(params["proj"], self.device), "stages": stages,
                       "head": own(params["head"], self.device)}

    def _xy(self, x, y) -> tuple[torch.Tensor, torch.Tensor]:
        return (torch.as_tensor(x, dtype=torch.float32).to(self.device),
                torch.as_tensor(y, dtype=torch.float32).to(self.device))

    def _loss(self, params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        pred = _forward(params, x, self.mesh, self.cfg.num_microbatches)
        return torch.mean((pred - y) ** 2)

    def loss_fn(self, params: dict, x, y) -> float:
        with torch.no_grad():
            return float(self._loss(params, *self._xy(x, y)))

    def train_step(self, x, y) -> float:
        """One ``optax.sgd`` step (``p + (-lr * g)``); returns the loss
        before it."""
        loss = self._loss(self.params, *self._xy(x, y))
        params = leaves(self.params)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.add_((-self.cfg.learning_rate) * g)
        return float(loss.detach())
