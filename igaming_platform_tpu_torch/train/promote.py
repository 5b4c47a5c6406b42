"""The params vault: fingerprint-keyed param trees, for replay across swaps.

The port's counterpart of ``vault_save``/``vault_load`` in
``igaming_platform_tpu/train/promote.py``. The JAX vault keeps an Orbax
checkpoint per fingerprint; Orbax is on neither machine the port runs on,
so the port's vault has its own format: ``<vault>/<fp>.npz`` holds the
engine's installed tree, one array per ``key.name`` in the order
``serve/scorer.py::params_fingerprint`` walks it, and the backend's name
(``__backend__``). Loading rebuilds the same modules on the CPU, and an
entry whose rebuilt tree does not hash to its name raises. The promotion
controller, which writes the vault when it promotes, waits for Queue 1 item
9 (``ROADMAP.md``); until then the vault's writer is whoever swaps params.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from igaming_platform_tpu_torch.models.mlp import MLP, Dense
from igaming_platform_tpu_torch.models.multitask import MultiTask
from igaming_platform_tpu_torch.ops.quantize import QuantizedDense, QuantizedMLP
from igaming_platform_tpu_torch.serve.scorer import params_fingerprint

_BACKEND = "__backend__"


def _entry(vault_dir: str, fp: str) -> str:
    return os.path.join(os.path.abspath(vault_dir), f"{fp}.npz")


def vault_save(vault_dir: str, params: Any, ml_backend: str) -> str:
    """Store a serving param tree under its fingerprint; returns the
    fingerprint. Idempotent: an existing entry is left in place."""
    fp = params_fingerprint(params)
    path = _entry(vault_dir, fp)
    if os.path.exists(path):
        return fp
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrays = {_BACKEND: np.array(ml_backend)}
    for key in sorted(params or {}):
        value = params[key]
        tensors = value.state_dict() if hasattr(value, "state_dict") else value
        for name, t in tensors.items():
            arrays[f"{key}.{name}"] = t.detach().cpu().numpy()
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # a reader sees the whole entry or none
    return fp


def _layers(t: dict, prefix: str) -> list[int]:
    return sorted({int(k[len(prefix):].split(".")[0]) for k in t if k.startswith(prefix)})


def _dense(t: dict, p: str) -> Dense:
    return Dense(t[f"{p}w_bf16"], t[f"{p}b"])


def _quantized(t: dict) -> QuantizedMLP:
    return QuantizedMLP(
        [QuantizedDense(t[f"layers.{i}.wq"].numpy(), t[f"layers.{i}.scale"].numpy(),
                        t[f"layers.{i}.b"].numpy()) for i in _layers(t, "layers.")],
        t["input_scale"].numpy() if "input_scale" in t else None)


# How each params key's tree is rebuilt from its tensors (a forest stays a
# dict of tensors). Dense keeps the bf16 rounding of its weight, and
# rounding it again changes nothing.
_REBUILD = {
    "mlp": lambda t: MLP([_dense(t, f"layers.{i}.") for i in _layers(t, "layers.")]),
    "multitask": lambda t: MultiTask([_dense(t, f"trunk.{i}.") for i in _layers(t, "trunk.")],
                                     _dense(t, "fraud_head."), _dense(t, "ltv_head."),
                                     _dense(t, "churn_head.")),
    "mlp_int8": _quantized,
    "multitask_int8": _quantized,
}


def vault_load(vault_dir: str, fp: str, ml_backend: str | None = None) -> Any | None:
    """The param tree stored under ``fp``, on the CPU, or None when the
    vault has no such entry. Raises ValueError when the entry is another
    backend's than ``ml_backend`` or its rebuilt tree's fingerprint is not
    ``fp`` (a corrupt or tampered entry)."""
    path = _entry(vault_dir, fp)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        backend = str(z[_BACKEND])
        grouped: dict[str, dict[str, torch.Tensor]] = {}
        for name in z.files:
            if name != _BACKEND:
                key, _, rest = name.partition(".")
                grouped.setdefault(key, {})[rest] = torch.from_numpy(z[name].copy())
    if ml_backend is not None and backend != ml_backend:
        raise ValueError(f"params vault entry {fp} holds {backend!r} params, not {ml_backend!r}")
    params = {key: _REBUILD[key](t) if key in _REBUILD else t for key, t in grouped.items()}
    got = params_fingerprint(params or None)
    if got != fp:
        raise ValueError(f"params vault entry {fp} rebuilt to fingerprint {got}: vault corrupt")
    return params or None
