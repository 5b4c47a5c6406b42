"""Checkpoint and resume for the multitask trainer, and serving restore.

Counterpart of ``igaming_platform_tpu/train/checkpoint.py``, in the same
on-disk layout: one Orbax ``StandardCheckpointer`` directory
``step_XXXXXXXX/`` per checkpoint (``utils/orbax``, the port's own reader and
writer of that layout), holding

- ``params``: the float32 master weights as the JAX multitask tree;
- ``opt_state``: ``optax.adamw``'s chain state, ``[{"count", "mu", "nu"},
  None, None]``, the moments in the params' layout;
- ``step``: the trainer's step (its data cursor), int64.

So the JAX ``restore_trainer`` resumes what the port writes, the port resumes
what the JAX trainer writes, and ``FRAUD_MODEL_PATH`` boots either
(``serve/server.py::resolve_model_boot`` reads ``params``). A checkpoint is
written into a temporary directory and renamed into place, so a reader sees
a whole checkpoint or none.

The port's earlier format, ``step_XXXXXXXX.npz`` (``convert.save_params_tree``
of ``{"multitask", "opt_state": {"count", "mu", "nu"}, "step"}``), is still
found and read.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from igaming_platform_tpu_torch import convert
from igaming_platform_tpu_torch.models.multitask import MultiTask
from igaming_platform_tpu_torch.train.trainer import Trainer, TrainState
from igaming_platform_tpu_torch.utils.orbax import restore_tree, save_tree


def _state_tree(state: TrainState) -> dict:
    return {"params": convert.multitask_to_tree(state.params),
            "opt_state": convert.adamw_state_tree(state.params, state.opt_state),
            "step": np.asarray(state.step, np.int64)}


def save_checkpoint(directory: str, state: TrainState) -> str:
    """Write a step-versioned checkpoint; returns its path. A checkpoint of
    the same step is replaced."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"step_{state.step:08d}")
    if os.path.exists(path):
        stale = os.path.join(directory, f".step_{state.step:08d}.replaced-{os.getpid()}")
        os.rename(path, stale)
        shutil.rmtree(stale)
    return save_tree(path, _state_tree(state))


def latest_checkpoint(directory: str) -> str | None:
    """The newest ``step_*`` checkpoint in ``directory``: an Orbax
    directory, or the port's earlier ``.npz``."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_")
                   and (d.endswith(".npz") or os.path.isdir(os.path.join(directory, d))))
    return os.path.join(directory, steps[-1]) if steps else None


def restore_checkpoint(path: str) -> dict:
    """The checkpoint's tree, ``{"params", "opt_state", "step"}``, whichever
    form it is in."""
    if os.path.isdir(path):
        return restore_tree(path)
    tree = convert.load_params_tree(path)
    return {"params": tree["multitask"], "opt_state": tree["opt_state"], "step": tree["step"]}


def restore_trainer(trainer: Trainer, directory: str) -> bool:
    """Resume a trainer from the newest checkpoint, on its device; True on
    restore. A checkpoint of another trunk raises."""
    path = latest_checkpoint(directory)
    if path is None:
        return False
    tree = restore_checkpoint(path)
    state = convert.trainer_state_from_jax(tree["params"], tree["opt_state"],
                                           int(np.asarray(tree["step"])), trainer.device)
    if [tuple(p.shape) for p in state.params.parameters()] != [
            tuple(p.shape) for p in trainer.state.params.parameters()]:
        raise ValueError(f"{path}: its params do not match the trainer's trunk "
                         f"{trainer.cfg.trunk}")
    trainer.state = state
    return True


def restore_params_for_serving(path: str) -> MultiTask:
    """Only the params, as the serving module on the CPU (the hot-swap
    input's ``multitask``)."""
    return convert.multitask_from_tree(restore_checkpoint(path)["params"])
