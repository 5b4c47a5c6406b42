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
- ``routed``: ``router`` [30, 4] -> a float32 tensor, with ``mlp``,
  ``gbdt`` and ``multitask`` as above
- ``gbdt_int8``: ``quantize_gbdt``'s tree (``{"feat", "thr_q", "thr_scale",
  "leaves_q", "leaf_scale", "bias"}``) -> a dict of tensors, the codes int8
  and the scales float32, plus the float32 thresholds and leaves the forest
  kernel reads (``ops.quantize.forest_images``)

``sequence_from_tree(tree, cfg)`` does the same for the abuse detector's
sequence model (``init_sequence_model``'s tree) -> ``models.sequence.SequenceModel``,
and ``sequence_to_tree(model)`` is its inverse: a trained model's params as
the JAX package's tree of numpy arrays.

``train_multitask_from_tree(tree)`` gives the trainable net
(``models.multitask.TrainMultiTask``, float32 master weights) of a JAX
multitask tree, and ``multitask_to_tree(model)`` is its inverse: the trained
master weights as the JAX tree of numpy arrays, which the JAX engine scores.
``trainer_state_from_jax(params, opt_state, step)`` carries a JAX trainer's
state (its params, ``optax.adamw``'s ``mu``/``nu`` and count, as numpy) into
the port's ``train.trainer.TrainState``.

``adamw_state_tree(model, opt)`` is the inverse: an ``AdamState`` as
``optax.adamw``'s chain state is checkpointed by the JAX package,
``[{"count", "mu", "nu"}, None, None]`` (``ScaleByAdamState``, then the
``EmptyState`` of ``add_decayed_weights`` and of the learning-rate scale).

``to_jax_params(params)`` is the inverse of ``from_jax_params``: the port's
installed params as the JAX serving tree of numpy arrays, the form the
params vault keeps (``train/promote.py``). A dense layer gives its weights
as the layer keeps them, rounded to bfloat16 (which the JAX forward rounds
to again); an int8 tree gives ``quantize_mlp``'s and ``quantize_gbdt``'s
keys. ``jax_fingerprint(tree)`` is the JAX package's
``serve/ledger.py::params_fingerprint`` of such a tree, the name the JAX
service gives a vault entry.

``routed_train_from_tree(tree)`` gives the trainable routed bundle
(``models.ensemble.TrainRouted``) of a JAX ``init_routed_params`` tree, and
``pp_params_from_tree(tree)`` a pipeline trainer's params
(``train.pp.PPTrainer(params=)``) of a JAX ``init_pp_params`` tree, so a test
starts both packages' trainers from the same numbers.

``params_to(params, device)`` copies them to a device. Neither needs JAX:
the tree is plain numpy.

``save_params_tree`` and ``load_params_tree`` keep such a tree in an
``.npz``, one array per leaf, its path joined by ``/``: the form
``tools/export_params_npz.py`` writes on the JAX side, which
``FRAUD_MODEL_PATH`` and replay's ``--params`` still read. The JAX
service's own Orbax checkpoints need no conversion: ``utils/orbax`` reads
and writes them.
"""

from __future__ import annotations

import copy
import hashlib
from typing import Any

import numpy as np
import torch
from torch import nn

from igaming_platform_tpu_torch.core.features import NUM_FEATURES
from igaming_platform_tpu_torch.models.mlp import MLP, Dense, TrainDense
from igaming_platform_tpu_torch.models.multitask import MultiTask, TrainMultiTask
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
    "routed": ("router", "mlp", "gbdt", "multitask"),
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


MULTITASK_LAYERS = ("fraud_head", "ltv_head", "churn_head")


def train_multitask_from_tree(tree: dict) -> TrainMultiTask:
    """The trainable multitask net, on the CPU, of a JAX multitask tree."""
    def layer(p):
        return TrainDense(_f32(p["w"]), _f32(p["b"]))

    return TrainMultiTask([layer(p) for p in tree["trunk"]["layers"]],
                          *(layer(tree[h]) for h in MULTITASK_LAYERS))


def multitask_layers(model: TrainMultiTask) -> list[tuple[tuple, TrainDense]]:
    """(path in the JAX tree, layer) for every layer, trunk first then the
    heads: the order of ``model.parameters()``."""
    return ([(("trunk", "layers", i), layer) for i, layer in enumerate(model.trunk)]
            + [((h,), getattr(model, h)) for h in MULTITASK_LAYERS])


def multitask_to_tree(model: TrainMultiTask, tensors: list[torch.Tensor] | None = None) -> dict:
    """The JAX multitask tree of numpy arrays for ``model``'s master weights,
    or for ``tensors`` laid out as ``model.parameters()`` (an Adam moment)."""
    flat = iter(tensors if tensors is not None else list(model.parameters()))
    tree: dict = {"trunk": {"layers": []}}
    for path, _layer in multitask_layers(model):
        leaf = {"w": next(flat).detach().cpu().numpy().copy(),
                "b": next(flat).detach().cpu().numpy().copy()}
        if path[0] == "trunk":
            tree["trunk"]["layers"].append(leaf)
        else:
            tree[path[0]] = leaf
    return tree


def tree_leaves(model: TrainMultiTask, tree: dict) -> list[torch.Tensor]:
    """A JAX-layout multitask tree's arrays as float32 tensors in
    ``model.parameters()`` order."""
    out = []
    for path, _layer in multitask_layers(model):
        node = tree["trunk"]["layers"][path[2]] if path[0] == "trunk" else tree[path[0]]
        out += [_f32(node["w"]), _f32(node["b"])]
    return out


def trainer_state_from_jax(params: dict, opt_state: Any, step: int,
                           device: torch.device | str = "cpu"):
    """The port's ``TrainState`` on ``device`` from a JAX trainer's params,
    its ``optax.adamw`` state (the ``ScaleByAdamState`` first in the chain,
    or that state itself, or a dict with ``count``, ``mu`` and ``nu``) and
    step, all as numpy."""
    from igaming_platform_tpu_torch.train.trainer import AdamState, TrainState

    adam = opt_state
    if isinstance(adam, (tuple, list)) and not hasattr(adam, "mu"):
        adam = adam[0]
    get = adam.get if isinstance(adam, dict) else (lambda k: getattr(adam, k))
    model = train_multitask_from_tree(params).to(device)
    count = torch.tensor(int(np.asarray(get("count"))), dtype=torch.int32, device=device)
    state = AdamState(count, [t.to(device) for t in tree_leaves(model, get("mu"))],
                      [t.to(device) for t in tree_leaves(model, get("nu"))])
    return TrainState(model, state, int(step))


def adamw_state_tree(model: TrainMultiTask, opt) -> list:
    """``optax.adamw``'s chain state for ``opt`` (an ``AdamState`` laid out
    as ``model.parameters()``), as numpy in the JAX checkpoint's nesting."""
    return [{"count": np.asarray(int(opt.count), np.int32),
             "mu": multitask_to_tree(model, opt.mu),
             "nu": multitask_to_tree(model, opt.nu)}, None, None]


def routed_train_from_tree(tree: dict):
    """The trainable routed bundle (``models.ensemble.TrainRouted``), on the
    CPU, of the JAX ``init_routed_params`` tree ({"router", "mlp", "gbdt",
    "multitask"}; "mock" is None)."""
    from igaming_platform_tpu_torch.models.ensemble import SoftForest, TrainRouted
    from igaming_platform_tpu_torch.models.mlp import TrainMLP

    mlp = TrainMLP([TrainDense(_f32(p["w"]), _f32(p["b"])) for p in tree["mlp"]["layers"]])
    return TrainRouted(_f32(tree["router"]), mlp, SoftForest(gbdt_from_tree(tree["gbdt"])),
                       train_multitask_from_tree(tree["multitask"]))


def pp_params_from_tree(tree: dict) -> dict:
    """A pipeline trainer's params (``train.pp.PPTrainer(params=)``), on the
    CPU, from the JAX ``init_pp_params`` tree: "proj" and "head" as {"w",
    "b"}, "stages" stacked ([S, d, d], [S, d]) or per stage; the port's keeps
    one {"w", "b"} a stage."""
    def layer(p):
        return {"w": _f32(p["w"]), "b": _f32(p["b"])}

    stages = tree["stages"]
    if isinstance(stages, dict):
        stages = [{"w": stages["w"][s], "b": stages["b"][s]}
                  for s in range(np.shape(stages["w"])[0])]
    return {"proj": layer(tree["proj"]), "stages": [layer(p) for p in stages],
            "head": layer(tree["head"])}


_CONVERTERS = {"router": _f32, "mlp": mlp_from_tree, "gbdt": gbdt_from_tree, "multitask": multitask_from_tree,
               "mlp_int8": quantized_mlp_from_tree, "gbdt_int8": quantized_gbdt_from_tree,
               "multitask_int8": quantized_mlp_from_tree}


def params_from_tree(tree: dict) -> dict[str, Any]:
    """The port's params for every key of a JAX serving tree (a vault
    entry's), whatever the backend; a None entry (the routed bundle's
    ``mock``) has none, and an unknown key raises."""
    tree = {key: value for key, value in tree.items() if value is not None}
    unknown = sorted(set(tree) - set(_CONVERTERS))
    if unknown:
        raise ValueError(f"no port params for keys {unknown}")
    return {key: _CONVERTERS[key](value) for key, value in tree.items()}


def from_jax_params(ml_backend: str, tree: dict) -> dict[str, Any]:
    """The port's params for ``ml_backend`` from a JAX params tree of numpy arrays."""
    if ml_backend not in BACKEND_KEYS:
        raise ValueError(f"unknown ml backend: {ml_backend}")
    return {key: _CONVERTERS[key](tree[key]) for key in BACKEND_KEYS[ml_backend]}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _dense_tree(layer: Dense) -> dict:
    return {"w": _np(layer.w_bf16), "b": _np(layer.b)}


def _quantized_tree(m: QuantizedMLP) -> dict:
    return {"layers": [{"wq": _np(q.wq), "scale": _np(q.scale), "b": _np(q.b)} for q in m.layers],
            "input_scale": None if m.input_scale is None else _np(m.input_scale),
            "quantized": True}


_GBDT_INT8_KEYS = ("feat", "thr_q", "thr_scale", "leaves_q", "leaf_scale", "bias")
_TO_TREE = {
    "router": _np,
    "mlp": lambda m: {"layers": [_dense_tree(layer) for layer in m.layers]},
    "gbdt": lambda g: {k: _np(g[k]) for k in ("feat", "thr", "leaves", "bias")},
    "multitask": lambda m: {"trunk": {"layers": [_dense_tree(layer) for layer in m.trunk]},
                            **{h: _dense_tree(getattr(m, h)) for h in MULTITASK_LAYERS}},
    "mlp_int8": _quantized_tree,
    "gbdt_int8": lambda g: {**{k: _np(g[k]) for k in _GBDT_INT8_KEYS}, "quantized": True},
    "multitask_int8": _quantized_tree,
}


def to_jax_params(params: dict[str, Any] | None) -> dict:
    """The JAX serving tree, numpy on the host, of the port's params (the
    inverse of :func:`from_jax_params`); None entries are left out."""
    out = {}
    for key, value in (params or {}).items():
        if value is None:
            continue
        if key not in _TO_TREE:
            raise ValueError(f"no JAX layout for params key {key!r}")
        out[key] = _TO_TREE[key](value)
    return out


def _treedef(node) -> str:
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(node[k])}" for k in sorted(node)) + "}"
    if isinstance(node, list):
        return "[" + ", ".join(_treedef(v) for v in node) + "]"
    if isinstance(node, tuple):
        return "(" + ", ".join(_treedef(v) for v in node) + ("," if len(node) == 1 else "") + ")"
    return "None" if node is None else "*"


def _tree_leaves(node, out: list) -> list:
    if isinstance(node, dict):
        for k in sorted(node):
            _tree_leaves(node[k], out)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _tree_leaves(v, out)
    elif node is not None:
        out.append(node)
    return out


def jax_fingerprint(tree: Any) -> str:
    """The JAX package's ``params_fingerprint`` of a tree of dicts, lists,
    tuples and numpy leaves: blake2b-64 over the treedef's repr, then each
    leaf's dtype, shape and bytes in flattening order."""
    h = hashlib.blake2b(digest_size=8)
    if tree is None:
        h.update(b"none")
        return h.hexdigest()
    h.update(f"PyTreeDef({_treedef(tree)})".encode())
    for leaf in _tree_leaves(tree, []):
        arr = np.asarray(leaf)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def params_to(params: dict[str, Any] | None, device: torch.device | str) -> dict[str, Any] | None:
    """A copy of the port's params on ``device``; the input is left as it was.
    On a card the caller's stream has finished the copy when this returns,
    so another stream (an engine's) may read it at once."""
    if params is None:
        return None
    out = {}
    for key, value in params.items():
        if value is None:
            out[key] = None
        elif isinstance(value, nn.Module):
            out[key] = copy.deepcopy(value).to(device)
        elif isinstance(value, torch.Tensor):
            out[key] = value.to(device)
        else:
            out[key] = {k: v.to(device) for k, v in value.items()}
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
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
