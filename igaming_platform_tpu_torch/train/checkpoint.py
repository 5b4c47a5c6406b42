"""Checkpoint and resume for the multitask trainer, and serving restore.

Counterpart of ``igaming_platform_tpu/train/checkpoint.py``, in the port's
own format (Orbax is on neither machine the port runs on): one
``step_XXXXXXXX.npz`` per checkpoint, in ``convert.save_params_tree``'s
layout, holding

- ``multitask/...``: the float32 master weights as the JAX multitask tree;
- ``opt_state/count``, ``opt_state/mu/...`` and ``opt_state/nu/...``:
  ``optax.adamw``'s Adam state, the moments in the params' layout;
- ``step``: the trainer's step (its data cursor).

A checkpoint is written to a temporary file and renamed into place, so a
reader sees a whole file or none. Its params part is what
``FRAUD_MODEL_PATH`` boots (``serve/server.py::resolve_model_boot`` reads
``multitask/`` and ignores the rest).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from igaming_platform_tpu_torch import convert
from igaming_platform_tpu_torch.models.multitask import MultiTask
from igaming_platform_tpu_torch.train.trainer import AdamState, Trainer, TrainState


def _state_tree(state: TrainState) -> dict:
    model, opt = state.params, state.opt_state
    return {
        "multitask": convert.multitask_to_tree(model),
        "opt_state": {"count": np.asarray(int(opt.count), np.int32),
                      "mu": convert.multitask_to_tree(model, opt.mu),
                      "nu": convert.multitask_to_tree(model, opt.nu)},
        "step": np.asarray(state.step, np.int64),
    }


def save_checkpoint(directory: str, state: TrainState) -> str:
    """Write a step-versioned checkpoint; returns its path."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{state.step:08d}.npz")
    tmp = f"{path}.{os.getpid()}.tmp"
    convert.save_params_tree(tmp, _state_tree(state))
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory: str) -> str | None:
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and d.endswith(".npz"))
    return os.path.join(directory, steps[-1]) if steps else None


def restore_checkpoint(path: str) -> dict:
    """The checkpoint's tree: ``multitask``, ``opt_state`` and ``step``."""
    return convert.load_params_tree(path)


def restore_trainer(trainer: Trainer, directory: str) -> bool:
    """Resume a trainer from the newest checkpoint, on its device; True on
    restore. A checkpoint of another trunk raises."""
    path = latest_checkpoint(directory)
    if path is None:
        return False
    tree = restore_checkpoint(path)
    model = convert.train_multitask_from_tree(tree["multitask"])
    if [tuple(p.shape) for p in model.parameters()] != [
            tuple(p.shape) for p in trainer.state.params.parameters()]:
        raise ValueError(f"{path}: its params do not match the trainer's trunk "
                         f"{trainer.cfg.trunk}")
    dev = trainer.device
    opt = tree["opt_state"]
    state = AdamState(torch.tensor(int(opt["count"]), dtype=torch.int32, device=dev),
                      [t.to(dev) for t in convert.tree_leaves(model, opt["mu"])],
                      [t.to(dev) for t in convert.tree_leaves(model, opt["nu"])])
    trainer.state = TrainState(model.to(dev), state, int(tree["step"]))
    return True


def restore_params_for_serving(path: str) -> MultiTask:
    """Only the params, as the serving module on the CPU (the hot-swap
    input's ``multitask``)."""
    return convert.multitask_from_tree(restore_checkpoint(path)["multitask"])
