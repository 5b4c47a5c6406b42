"""Pipeline parallelism: GPipe microbatching over a mesh axis.

Counterpart of ``igaming_platform_tpu/parallel/pipeline.py``. Stages are
the leading dim of a stacked params tree (``stack_stage_params``), and stage
``s`` lives on ``mesh.axis_device(axis, s)``: ``pipeline_apply`` places each
stage's slice there (or takes per-stage params already placed, as the
trainer keeps them, ``train/pp.py``). The schedule is the JAX one's
(M + S - 1) ticks: at tick t stage s runs microbatch t - s, and its output
is copied to stage s + 1's device (the ``ppermute``) for the next tick. A
stage whose slot holds no microbatch (the bubble) computes nothing here,
where the JAX program computes a value it then discards: the outputs are
the same. The last stage's outputs are the result, on ``x``'s device (the
JAX ``psum`` of them over the axis).

Plain torch ops and copies between devices, so autograd runs the backward
through the same ring in reverse. ``mlp_stage_fn`` is a dense + ReLU stage
on ``ops/dense.py``'s ``dense_f32_train``, whose sum order no batch size
changes: a pipelined forward gives the sequential forward's bits.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from igaming_platform_tpu_torch.parallel.mesh import AXIS_MODEL, Mesh


def stack_stage_params(stage_params: Sequence[dict]) -> dict:
    """[per-stage {name: tensor}] -> {name: tensor with a leading stage dim}."""
    return {k: torch.stack([torch.as_tensor(p[k]) for p in stage_params])
            for k in stage_params[0]}


def place_stages(stacked: dict | Sequence[dict], mesh: Mesh,
                 axis: str = AXIS_MODEL) -> list[dict]:
    """Stage ``s``'s params on ``mesh.axis_device(axis, s)``: a stacked tree
    is sliced, a per-stage list is moved (a tensor already there is kept,
    so autograd reaches it)."""
    n_stages = int(mesh.shape[axis])
    if isinstance(stacked, dict):
        stages = [{k: torch.as_tensor(v)[s] for k, v in stacked.items()}
                  for s in range(n_stages)]
    else:
        stages = list(stacked)
    if len(stages) != n_stages:
        raise ValueError(f"{len(stages)} stages for mesh '{axis}' axis {n_stages}")
    out = []
    for s, p in enumerate(stages):
        dev = mesh.axis_device(axis, s)
        out.append({k: v if v.device == dev else v.to(dev) for k, v in p.items()})
    return out


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: dict | Sequence[dict],
    x: torch.Tensor,
    mesh: Mesh,
    *,
    num_microbatches: int,
    axis: str = AXIS_MODEL,
) -> torch.Tensor:
    """Run x [B, d] through the S stages of ``mesh``'s ``axis`` with M
    microbatches; returns [B, d'] on ``x``'s device. ``stage_fn(params,
    activation [mb, d]) -> [mb, d']`` keeps one shape across stages (GPipe).
    B must divide by M."""
    x = torch.as_tensor(x, dtype=torch.float32)
    b = x.shape[0]
    if b % num_microbatches != 0:
        raise ValueError(f"batch {b} not divisible by microbatches {num_microbatches}")
    stages = place_stages(stacked_params, mesh, axis)
    n_stages = len(stages)
    devs = [mesh.axis_device(axis, s) for s in range(n_stages)]
    x_mb = torch.chunk(x, num_microbatches, dim=0)
    outputs: list = [None] * num_microbatches
    recv: list = [None] * n_stages  # what each stage holds for this tick
    for t in range(num_microbatches + n_stages - 1):
        sent: list = [None] * n_stages
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < num_microbatches:
                continue  # the bubble
            inp = x_mb[m].to(devs[0]) if s == 0 else recv[s]
            out = stage_fn(stages[s], inp)
            if s == n_stages - 1:
                outputs[m] = out
            else:
                sent[s + 1] = out.to(devs[s + 1])  # the ppermute to the next stage
        recv = sent
    return torch.cat([o.to(x.device) for o in outputs], dim=0)


def mlp_stage_fn(params: dict, x: torch.Tensor) -> torch.Tensor:
    """A dense + ReLU pipeline stage (d -> d), for stage-parallel trunks."""
    from igaming_platform_tpu_torch.ops.dense import dense_f32_train

    return torch.relu(dense_f32_train(x.contiguous(), params["w"], params["b"]))
