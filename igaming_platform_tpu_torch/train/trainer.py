"""Training for the multitask fraud/LTV/churn net, on one card.

Counterpart of ``igaming_platform_tpu/train/trainer.py``. The net keeps
float32 master weights (``models/multitask.py``'s ``TrainMultiTask``);
every forward layer is ``ops/dense.py``'s ``dense_train``: the fixed-order
kernel ``csrc/dense_fixed.cu`` (bf16 mode) on a card, its plain version on
the CPU, five launches a forward (two trunk layers and three heads), and
the gradients JAX takes through ``_dense``, each weight and input gradient
rounded to bf16. The loss and the optimizer are written out as optax 0.2.6
computes them, not taken from torch's functional losses or
``torch.optim.AdamW``, which round differently:

- binary cross-entropy ``-z * log_sigmoid(x) - (1 - z) * log_sigmoid(-x)``
  for fraud and churn; Huber with delta 10 on ``ltv / ltv_scale``;
- ``optax.adamw(lr, weight_decay)``: Adam's ``m_hat / (sqrt(v_hat) + eps)``,
  then ``+ wd * p`` on every leaf (biases too: optax has no mask here), then
  ``* -lr``; every division is by a tensor, as optax divides.

``TRAIN_WIRE_DTYPE=bf16`` ships the feature batch host-to-device as
bfloat16 (round to nearest even, as ``ml_dtypes`` casts) and restores
float32 at the head of the step; a value other than bf16/float32 raises.
``remat=True`` recomputes the forward in the backward
(``torch.utils.checkpoint``, non-reentrant): the same fixed-order kernel, so
the same bits, at twice the forward launches. ``fit`` double-buffers: batch
k+1's copy, from pinned memory on a side stream, overlaps step k, and
metrics are read back once per log point.

A ``Trainer`` may run on a stream of its own (``stream=``, the online
learner's, beside the serving engine's); every step, read-back and export
is enqueued there.

``step_cost`` counts one step's floating-point operations and bytes for
``obs/perfmodel.py`` and leaves the trainer as it was.

Over a mesh (``mesh=``, ``parallel/mesh.py``) the trainer is data and tensor
parallel, as the JAX trainer's ``jit`` over its shardings is:

- the batch's rows split over ``data``; ``put_batch`` copies each shard's
  rows to that shard's device (from pinned memory on that device's copy
  stream when ``side=True``);
- one params replica per distinct set of devices a ``data`` coordinate
  holds (``Mesh.data_replicas``): a logical mesh that repeats one card keeps
  one replica, never one a shard. With ``model`` > 1 a replica's trunk is
  split over its ``model`` devices in the alternating column/row layout of
  ``models/multitask.param_specs`` (``parallel/sharding.py``'s
  ``TrainShardedMultiTask``), the heads replicated;
- a shard's loss is its mean weighted by its rows over the global batch;
  each replica differentiates its shards' sum, the gradients are psummed
  over the replicas in coordinate order (``parallel/collectives.py``), and
  every replica takes the same AdamW update, so the replicas stay equal
  bit for bit;
- ``export_params`` hands serving one unsharded ``MultiTask``.

A split sum adds in another order than one device's, so a mesh step is held
to the unsharded step (and to the JAX trainer's mesh step) with a tolerance.
"""

from __future__ import annotations

import contextlib
import copy
import os
from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from igaming_platform_tpu_torch.core.device import resolve_device
from igaming_platform_tpu_torch.core.features import normalize, standardize_for_model
from igaming_platform_tpu_torch.obs import perfmodel
from igaming_platform_tpu_torch.parallel import collectives as coll
from igaming_platform_tpu_torch.parallel.mesh import validate_batch_for_mesh
from igaming_platform_tpu_torch.parallel.sharding import shard_train_model
from igaming_platform_tpu_torch.models.multitask import (
    MultiTask,
    TrainMultiTask,
    init_multitask,
)
from igaming_platform_tpu_torch.train.data import Batch, make_stream

METRIC_NAMES = ("loss", "fraud_loss", "ltv_loss", "churn_loss", "fraud_mae")
HUBER_DELTA = 10.0


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 1024
    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    ltv_scale: float = 1_000.0  # dollars -> unit scale for the Huber head
    fraud_loss_weight: float = 1.0
    ltv_loss_weight: float = 0.5
    churn_loss_weight: float = 0.5
    trunk: tuple[int, ...] = (256, 256)
    # Recompute the forward in the backward: activation memory for FLOPs.
    remat: bool = False
    seed: int = 0


@dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the step count (int32, on the device)
    and the first and second moments, one per parameter in
    ``parameters()`` order."""

    count: torch.Tensor
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]

    @classmethod
    def zeros(cls, params: list[torch.Tensor]) -> "AdamState":
        device = params[0].device
        return cls(torch.zeros((), dtype=torch.int32, device=device),
                   [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])


@dataclass
class TrainState:
    params: TrainMultiTask
    opt_state: AdamState
    step: int


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -F.softplus(-x)


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy``, elementwise."""
    return -labels * log_sigmoid(logits) - (1.0 - labels) * log_sigmoid(-logits)


def huber_loss(predictions: torch.Tensor, targets: torch.Tensor,
               delta: float = HUBER_DELTA) -> torch.Tensor:
    """optax's ``huber_loss``, elementwise."""
    abs_errors = torch.abs(predictions - targets)
    quadratic = torch.clamp_max(abs_errors, delta)
    linear = abs_errors - quadratic
    return 0.5 * (quadratic * quadratic) + delta * linear


def loss_and_metrics(cfg: TrainConfig, model: TrainMultiTask, x_raw: torch.Tensor,
                     fraud_t: torch.Tensor, ltv_t: torch.Tensor,
                     churn_t: torch.Tensor) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The JAX ``make_loss_fn``'s loss (differentiable) and its metrics
    (detached), on the model's device."""
    xn = standardize_for_model(normalize(x_raw))
    out = checkpoint(model, xn, use_reentrant=False) if cfg.remat else model(xn)
    fraud_loss = torch.mean(sigmoid_binary_cross_entropy(out["fraud_logit"], fraud_t))
    churn_loss = torch.mean(sigmoid_binary_cross_entropy(out["churn_logit"], churn_t))
    scale = torch.tensor(cfg.ltv_scale, dtype=torch.float32, device=ltv_t.device)
    ltv_loss = torch.mean(huber_loss(out["ltv"], ltv_t / scale))
    total = (cfg.fraud_loss_weight * fraud_loss + cfg.ltv_loss_weight * ltv_loss
             + cfg.churn_loss_weight * churn_loss)
    metrics = {
        "loss": total, "fraud_loss": fraud_loss, "ltv_loss": ltv_loss,
        "churn_loss": churn_loss,
        "fraud_mae": torch.mean(torch.abs(out["fraud"] - fraud_t)),
    }
    return total, {k: v.detach() for k, v in metrics.items()}


def adam_direction(grads: list[torch.Tensor], state: AdamState, b1: float, b2: float,
                   eps: float) -> tuple[list[torch.Tensor], AdamState]:
    """optax's ``scale_by_adam``: the moments, then ``m_hat / (sqrt(v_hat) +
    eps)`` with the bias corrections ``1 - b**count`` in float32 on the
    device. Returns (directions, the new state); ``state`` is left as it
    was."""
    count = state.count + 1
    count_f = count.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=count.device)
    bc1 = one - torch.pow(torch.full_like(one, b1), count_f)
    bc2 = one - torch.pow(torch.full_like(one, b2), count_f)
    mu = [(1.0 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
    nu = [(1.0 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
    # A replica split over ``model`` holds parameters on several devices;
    # the bias corrections live on the first one's.
    corrections = {count.device: (bc1, bc2)}
    out = []
    for m, v in zip(mu, nu):
        if m.device not in corrections:
            corrections[m.device] = (bc1.to(m.device), bc2.to(m.device))
        c1, c2 = corrections[m.device]
        out.append((m / c1) / (torch.sqrt(v / c2) + eps))
    return out, AdamState(count, mu, nu)


def adamw_update(params: list[torch.Tensor], grads: list[torch.Tensor], state: AdamState,
                 lr: float, weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> AdamState:
    """One ``optax.adamw`` step, in place on ``params``; returns the new
    state. Adam's direction, ``+ wd * p``, ``* -lr``, then ``p + u``. With
    ``weight_decay`` 0 it is ``optax.adam``'s step (no decay term)."""
    directions, new_state = adam_direction(grads, state, b1, b2, eps)
    with torch.no_grad():
        for p, u in zip(params, directions):
            if weight_decay:
                u = u + weight_decay * p
            p.add_((-lr) * u)
    return new_state


def wire_dtype_from_env() -> torch.dtype | None:
    """``TRAIN_WIRE_DTYPE``: bfloat16 for ``bf16``, None for float32."""
    wire = os.environ.get("TRAIN_WIRE_DTYPE", "").lower()
    if wire in ("bf16", "bfloat16"):
        return torch.bfloat16
    if wire not in ("", "f32", "fp32", "float32"):
        # A typo would train at the float32 wire rate while the operator
        # believes compression is on.
        raise ValueError(f"TRAIN_WIRE_DTYPE={wire!r} not supported (use 'bf16' or 'float32')")
    return None


@dataclass
class DeviceBatch:
    """A batch on the trainer's device: (x, fraud, ltv, churn), and the
    event after its copy when it was made on the side stream. Over a mesh,
    ``shards`` holds one such batch per ``data`` coordinate, on its device."""

    tensors: tuple[torch.Tensor, ...]
    ready: Any = None
    shards: list | None = None


class Trainer:
    """The multitask trainer on one device (``"cuda"`` unless the caller
    passes ``device="cpu"``)."""

    def __init__(self, cfg: TrainConfig | None = None, mesh=None, *,
                 device: str | torch.device = "cuda", stream=None):
        self.cfg = cfg or TrainConfig()
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self.stream = stream
        self._wire = wire_dtype_from_env()
        if mesh is not None:
            from igaming_platform_tpu_torch.parallel.mesh import AXIS_DATA

            validate_batch_for_mesh(self.cfg.batch_size, mesh)
            n_data = int(mesh.shape[AXIS_DATA])
            # The device of each data shard's rows, and the replica it uses.
            self._shard_devices = [mesh.axis_device(AXIS_DATA, d) for d in range(n_data)]
            coords = mesh.data_replicas()
        else:
            self._shard_devices = [self.device]
            coords = [0]
        # The data coordinate each replica is laid at, and each shard's replica.
        replica_coords = sorted(set(coords))
        self._shard_replica = [replica_coords.index(c) for c in coords]
        self._copy_streams = {d: torch.cuda.Stream(d) for d in set(self._shard_devices)
                              if d.type == "cuda"}
        with self._on_stream():
            params = init_multitask(torch.Generator().manual_seed(self.cfg.seed),
                                    trunk=self.cfg.trunk).to(self.device)
            # Replica 0 is the state's; the others, with their optimizer
            # states, live beside it.
            replicas = [params if mesh is None else shard_train_model(mesh, params, c)
                        for c in replica_coords]
            self._others = replicas[1:]
            self._opt = [AdamState.zeros(list(m.parameters())) for m in self._others]
            self.state = TrainState(replicas[0],
                                    AdamState.zeros(list(replicas[0].parameters())), 0)

    @property
    def replicas(self) -> list:
        """Every params replica, the state's first (one without a mesh)."""
        return [self.state.params, *self._others]

    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.stream is not None \
            else contextlib.nullcontext()

    def put_batch(self, batch: Batch, side: bool = False) -> DeviceBatch:
        """Start a batch's host-to-device copy. ``side=True`` copies from
        pinned memory on the trainer's copy stream and records an event the
        step waits for (``fit``'s double buffering); otherwise the copy is
        enqueued on the trainer's stream. Over a mesh each ``data`` shard's
        rows go to its own device, on that device's copy stream."""
        x = torch.from_numpy(np.ascontiguousarray(batch.x, dtype=np.float32))
        if self._wire is not None:
            x = x.to(self._wire)
        host = (x, *(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
                     for a in (batch.fraud, batch.ltv, batch.churn)))
        if self.mesh is None:
            return self._put(host, self.device, side)
        if self.device.type == "cuda":
            host = tuple(t.pin_memory() for t in host)
        bounds = coll.row_bounds(host[0].shape[0], len(self._shard_devices))
        return DeviceBatch((), None, [self._put(tuple(t[lo:hi] for t in host), dev, side)
                                      for (lo, hi), dev in zip(bounds, self._shard_devices)])

    def _put(self, host: tuple, dev: torch.device, side: bool) -> DeviceBatch:
        if dev.type != "cuda":
            return DeviceBatch(host)
        stream = self._copy_streams[dev] if side else (
            self.stream if dev == self.device else None)
        with torch.cuda.device(dev):
            ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
            with ctx:
                tensors = tuple(t.pin_memory().to(dev, non_blocking=True) for t in host)
                ready = torch.cuda.current_stream(dev).record_event() if side else None
        return DeviceBatch(tensors, ready)

    @staticmethod
    def _arrived(part: DeviceBatch) -> tuple[torch.Tensor, ...]:
        """A batch's tensors, once the stream that reads them has waited for
        their copy."""
        if part.ready is not None:
            dev = part.tensors[0].device
            current = torch.cuda.current_stream(dev)
            current.wait_event(part.ready)
            for t in part.tensors:
                t.record_stream(current)
        x, fraud_t, ltv_t, churn_t = part.tensors
        return x.to(torch.float32), fraud_t, ltv_t, churn_t

    def train_step_device(self, dev_batch: DeviceBatch) -> dict[str, torch.Tensor]:
        """One step with no host synchronisation; the metrics stay on the
        device."""
        with self._on_stream():
            losses, metrics = self._losses(self.replicas, dev_batch)
            params = [list(m.parameters()) for m in self.replicas]
            for p in (p for ps in params for p in ps):
                p.grad = None
            for loss in losses:
                loss.backward()
            grads = [[p.grad for p in ps] for ps in params]
            if len(grads) > 1:  # the data-parallel psum, in coordinate order
                grads = [list(g) for g in zip(*(coll.psum(list(gs)) for gs in zip(*grads)))]
            states = [adamw_update(ps, gs, st, self.cfg.learning_rate, self.cfg.weight_decay)
                      for ps, gs, st in zip(params, grads, [self.state.opt_state, *self._opt])]
            self._opt = states[1:]
        self.state = TrainState(self.state.params, states[0], self.state.step + 1)
        return metrics

    def _losses(self, replicas, dev_batch: DeviceBatch) -> tuple[list, dict[str, torch.Tensor]]:
        """Each replica's loss (its shards' means, each weighted by its rows
        over the global batch, added in coordinate order; one shard of
        weight 1 without a mesh) and the step's metrics, weighted alike, on
        the trainer's device."""
        parts = [self._arrived(part) for part in dev_batch.shards or [dev_batch]]
        total_rows = sum(int(p[0].shape[0]) for p in parts)
        losses: list = [None] * len(replicas)
        metrics: dict[str, torch.Tensor] = {}
        for r, p in zip(self._shard_replica, parts):
            with torch.cuda.device(p[0].device) if p[0].device.type == "cuda" \
                    else contextlib.nullcontext():
                loss, m = loss_and_metrics(self.cfg, replicas[r], *p)
            weight = p[0].shape[0] / total_rows
            losses[r] = loss * weight if losses[r] is None else losses[r] + loss * weight
            for k, v in m.items():
                v = (v * weight).to(self.device)
                metrics[k] = v if k not in metrics else metrics[k] + v
        return losses, metrics

    def materialize_metrics(self, metrics: dict[str, torch.Tensor]) -> dict[str, float]:
        """Device metrics -> host floats in one copy."""
        with self._on_stream():
            values = torch.stack([metrics[k] for k in METRIC_NAMES]).cpu().tolist()
        return dict(zip(METRIC_NAMES, values))

    def train_step(self, batch: Batch) -> dict[str, float]:
        return self.materialize_metrics(self.train_step_device(self.put_batch(batch)))

    def fit(self, steps: int, data: Iterator[Batch] | None = None, log_every: int = 50,
            log_fn=None) -> dict[str, float]:
        """Double-buffered loop: batch k+1's copy overlaps step k; metrics are
        read back only at log points and at the end."""
        if steps <= 0:
            return {}
        data = data or make_stream(self.cfg.batch_size, seed=self.cfg.seed)
        metrics = None
        pending = self.put_batch(next(data), side=True)
        for i in range(steps):
            current = pending
            if i + 1 < steps:
                pending = self.put_batch(next(data), side=True)
            metrics = self.train_step_device(current)
            if log_fn is not None and (i + 1) % log_every == 0:
                log_fn(self.state.step, self.materialize_metrics(metrics))
        return self.materialize_metrics(metrics)

    def step_cost(self, batch: Batch) -> dict[str, float]:
        """{"flops", "bytes"} of one training step on ``batch``, counted from
        its kernels (``obs/perfmodel.py``): the forward and backward of a
        copy of the model (of every replica over a mesh; the trainer's state
        is untouched), plus the adamw pass's bytes (each parameter, its
        gradient and both moments read, the parameter and the moments
        written: 7 float32s a weight)."""
        replicas = [copy.deepcopy(m) for m in self.replicas]
        with self._on_stream():
            dev_batch = self.put_batch(batch)
            with perfmodel.counting() as record:
                for loss in self._losses(replicas, dev_batch)[0]:
                    loss.backward()
        n_weights = sum(p.numel() for m in replicas for p in m.parameters())
        return perfmodel.add_bytes(perfmodel.compiled_cost(record), 7 * 4 * n_weights)

    def export_params(self) -> MultiTask:
        """The serving module of the current master weights, on the
        trainer's device; the trainer's stream has finished it."""
        with self._on_stream():
            served = self.state.params.serving()
        if self.stream is not None:
            self.stream.synchronize()
        return served
