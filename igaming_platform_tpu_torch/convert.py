"""Carry the JAX package's params across to the port.

``from_jax_params(ml_backend, tree)`` takes a params pytree of the JAX
package as nested dicts and lists of numpy arrays (what
``jax.tree.map(np.asarray, params)`` gives) and returns the port's params
for that backend, on the CPU:

- ``mlp``: ``{"layers": [{"w", "b"}, ...]}`` -> ``models.mlp.MLP``
- ``gbdt``: ``{"feat", "thr", "leaves", "bias"}`` -> a dict of tensors
- ``multitask``: ``{"trunk": {"layers"}, "fraud_head", "ltv_head",
  "churn_head"}`` -> ``models.multitask.MultiTask``
- ``mlp_int8`` and ``multitask_int8``: an int8 MLP tree (``ops/quantize.py``
  ``quantize_mlp``: ``{"layers": [{"wq", "scale", "b"}, ...],
  "input_scale"}``) -> ``ops.quantize.QuantizedMLP``, int8 codes kept int8
- ``gbdt_int8``: ``quantize_gbdt``'s tree (``{"feat", "thr_q", "thr_scale",
  "leaves_q", "leaf_scale", "bias"}``) -> a dict of tensors, the codes int8
  and the scales float32, plus the float32 thresholds and leaves the forest
  kernel reads (``ops.quantize.forest_images``)

``sequence_from_tree(tree, cfg)`` does the same for the abuse detector's
sequence model (``init_sequence_model``'s tree) -> ``models.sequence.SequenceModel``,
and ``sequence_to_tree(model)`` is its inverse: a trained model's params as
the JAX package's tree of numpy arrays.

``params_to(params, device)`` copies them to a device. Neither needs JAX:
the tree is plain numpy.

``save_params_tree`` and ``load_params_tree`` keep such a tree in an
``.npz``, one array per leaf, its path joined by ``/``: the form in which a
JAX checkpoint reaches the card (``tools/export_params_npz.py`` writes it
from an Orbax checkpoint or a flax ``.msgpack``), and the form
``FRAUD_MODEL_PATH`` and replay's ``--params`` read.
"""

from __future__ import annotations

import copy
from typing import Any

import numpy as np
import torch
from torch import nn

from igaming_platform_tpu_torch.core.features import NUM_FEATURES
from igaming_platform_tpu_torch.models.mlp import MLP, Dense
from igaming_platform_tpu_torch.models.multitask import MultiTask
from igaming_platform_tpu_torch.models.sequence import (
    Affine,
    Block,
    LayerNorm,
    SeqConfig,
    SequenceModel,
)
from igaming_platform_tpu_torch.ops.quantize import QuantizedDense, QuantizedMLP, forest_images

# Which params each backend reads.
BACKEND_KEYS = {
    "mock": (),
    "mlp": ("mlp",),
    "gbdt": ("gbdt",),
    "mlp+gbdt": ("mlp", "gbdt"),
    "multitask": ("multitask",),
    "mlp_int8": ("mlp_int8",),
    "gbdt_int8": ("gbdt_int8",),
    "mlp+gbdt_int8": ("mlp_int8", "gbdt_int8"),
    "multitask_int8": ("multitask_int8",),
}


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(layer: dict) -> Dense:
    return Dense(_f32(layer["w"]), _f32(layer["b"]))


def mlp_from_tree(tree: dict) -> MLP:
    return MLP([_dense(layer) for layer in tree["layers"]])


def multitask_from_tree(tree: dict) -> MultiTask:
    return MultiTask(
        [_dense(layer) for layer in tree["trunk"]["layers"]],
        _dense(tree["fraud_head"]), _dense(tree["ltv_head"]), _dense(tree["churn_head"]),
    )


def gbdt_from_tree(tree: dict, n_features: int = NUM_FEATURES) -> dict[str, torch.Tensor]:
    feat = np.array(tree["feat"], dtype=np.int32)
    if feat.size and (feat.min() < 0 or feat.max() >= n_features):
        raise ValueError(f"gbdt feature ids must lie in [0, {n_features})")
    return {
        "feat": torch.from_numpy(feat),
        "thr": _f32(tree["thr"]),
        "leaves": _f32(tree["leaves"]),
        "bias": _f32(tree["bias"]).reshape(()),
    }


def quantized_mlp_from_tree(tree: dict) -> QuantizedMLP:
    return QuantizedMLP([QuantizedDense(layer["wq"], layer["scale"], layer["b"])
                         for layer in tree["layers"]], tree.get("input_scale"))


def quantized_gbdt_from_tree(tree: dict) -> dict[str, torch.Tensor]:
    thr, leaves = forest_images(tree)
    out = gbdt_from_tree({"feat": tree["feat"], "thr": thr, "leaves": leaves,
                          "bias": tree["bias"]})
    out.update({"thr_q": torch.from_numpy(np.array(tree["thr_q"], dtype=np.int8)),
                "thr_scale": _f32(tree["thr_scale"]),
                "leaves_q": torch.from_numpy(np.array(tree["leaves_q"], dtype=np.int8)),
                "leaf_scale": _f32(tree["leaf_scale"])})
    return out


def sequence_from_tree(tree: dict, cfg: SeqConfig) -> SequenceModel:
    """The abuse detector's sequence model from the JAX params of
    ``init_sequence_model``: {"embed", "layers": [{"ln1", "wqkv", "wo",
    "ln2", "w1", "w2"}, ...], "ln_f", "head"}."""
    def affine(p):
        return Affine(_f32(p["w"]), _f32(p["b"]))

    def norm(p):
        return LayerNorm(_f32(p["scale"]), _f32(p["bias"]))

    if len(tree["layers"]) != cfg.n_layers or np.shape(tree["embed"]["w"]) != (
            cfg.in_dim, cfg.d_model):
        raise ValueError(f"sequence params do not match {cfg}")
    layers = [Block(cfg.n_heads, norm(p["ln1"]), affine(p["wqkv"]), affine(p["wo"]),
                    norm(p["ln2"]), affine(p["w1"]), affine(p["w2"]))
              for p in tree["layers"]]
    return SequenceModel(cfg, affine(tree["embed"]), layers, norm(tree["ln_f"]),
                         affine(tree["head"]))


def sequence_to_tree(model: SequenceModel) -> dict:
    """The JAX params tree of numpy arrays for ``model``: the inverse of
    ``sequence_from_tree``."""
    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy().copy()

    def affine(m: Affine) -> dict:
        return {"w": arr(m.w), "b": arr(m.b)}

    def norm(m: LayerNorm) -> dict:
        return {"scale": arr(m.scale), "bias": arr(m.bias)}

    return {
        "embed": affine(model.embed),
        "layers": [{"ln1": norm(b.ln1), "wqkv": affine(b.wqkv), "wo": affine(b.wo),
                    "ln2": norm(b.ln2), "w1": affine(b.w1), "w2": affine(b.w2)}
                   for b in model.layers],
        "ln_f": norm(model.ln_f),
        "head": affine(model.head),
    }


_CONVERTERS = {"mlp": mlp_from_tree, "gbdt": gbdt_from_tree, "multitask": multitask_from_tree,
               "mlp_int8": quantized_mlp_from_tree, "gbdt_int8": quantized_gbdt_from_tree,
               "multitask_int8": quantized_mlp_from_tree}


def from_jax_params(ml_backend: str, tree: dict) -> dict[str, Any]:
    """The port's params for ``ml_backend`` from a JAX params tree of numpy arrays."""
    if ml_backend not in BACKEND_KEYS:
        raise ValueError(f"unknown ml backend: {ml_backend}")
    return {key: _CONVERTERS[key](tree[key]) for key in BACKEND_KEYS[ml_backend]}


def params_to(params: dict[str, Any] | None, device: torch.device | str) -> dict[str, Any] | None:
    """A copy of the port's params on ``device``; the input is left as it was."""
    if params is None:
        return None
    out = {}
    for key, value in params.items():
        if isinstance(value, nn.Module):
            out[key] = copy.deepcopy(value).to(device)
        else:
            out[key] = {k: v.to(device) for k, v in value.items()}
    return out


def save_params_tree(path: str, tree: dict) -> None:
    """A JAX-layout params tree (nested dicts and lists of numpy arrays) to
    an ``.npz``, one array per leaf, its path joined by ``/``."""
    flat: dict[str, np.ndarray] = {}

    def walk(node, prefix: str) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")
        else:
            flat[prefix[:-1]] = np.asarray(node)

    walk(tree, "")
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_params_tree(path: str) -> dict:
    """The tree :func:`save_params_tree` wrote: numeric path parts become
    list positions."""
    root: dict = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            node = root
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = z[key]

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)
