"""Sharding rules: how a serving checkpoint lays out over the mesh.

Counterpart of ``igaming_platform_tpu/parallel/sharding.py``. The spec
functions return the JAX package's layouts as tuples of axis names (a
``PartitionSpec`` read as a tuple): one entry per array dim, ``None`` for a
replicated dim.

- MLP params: alternating hidden-dim sharding over ``model``: layer i splits
  its output features, layer i+1 its input features, so each pair ends in
  one all-reduce; the output head stays replicated;
- GBDT forests: the tree dim over ``expert``: each shard owns a block of
  the trees, margins summed over the shards;
- the multitask trunk as the MLP's hidden layers, heads replicated
  (``models/multitask.param_specs``).

``shard_model_params`` builds the sharded modules that compute with those
layouts shard by shard: ``ShardedForest`` (each expert shard runs the forest
kernel over its trees; the margins psum in shard order, then the bias),
``ShardedMLP`` and ``ShardedMultiTask`` (each model shard runs the dense
kernel over its columns or its rows; a row split's partial products psum in
shard order, then the bias). Values never change, only layout: the engine
keeps the fingerprint of the unsharded params. A split sum adds in another
order than the unsharded kernel's, so sharded models are held to the JAX
sharded program with a tolerance, never bit for bit.
"""

from __future__ import annotations

import copy
from typing import Any

import torch
from torch import nn

from igaming_platform_tpu_torch.models.mlp import Dense, TrainDense
from igaming_platform_tpu_torch.models.multitask import MultiTask, TrainMultiTask
from igaming_platform_tpu_torch.parallel import collectives as coll
from igaming_platform_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_MODEL,
    AXIS_SEQ,
    Mesh,
    mesh_axis_size,
)


def P(*axes) -> tuple:
    """A partition spec: one axis name (or None) per array dim."""
    return tuple(axes)


def batch_spec(ndim: int) -> tuple:
    return P(AXIS_DATA, *([None] * (ndim - 1)))


def hidden_specs(n_layers: int, *, head: bool) -> list[dict]:
    """The alternating layout of ``n_layers`` dense layers; with ``head``
    the last one is a replicated output head."""
    specs = []
    for i in range(n_layers):
        if head and i == n_layers - 1:
            specs.append({"w": P(None, None), "b": P(None)})
        elif i % 2 == 0:
            specs.append({"w": P(None, AXIS_MODEL), "b": P(AXIS_MODEL)})
        else:
            specs.append({"w": P(AXIS_MODEL, None), "b": P(None)})
    return specs


def mlp_param_specs(params) -> dict:
    """Alternating TP layout for an MLP (a ``{"layers": [...]}`` tree or an
    ``MLP`` module)."""
    layers = params["layers"] if isinstance(params, dict) else params.layers
    return {"layers": hidden_specs(len(layers), head=True)}


def gbdt_param_specs() -> dict:
    """EP layout: the forest's tree dimension sharded over ``expert``."""
    return {
        "feat": P(AXIS_EXPERT, None),
        "thr": P(AXIS_EXPERT, None),
        "leaves": P(AXIS_EXPERT, None),
        "bias": P(),
    }


def seq_activation_spec(ndim: int = 3) -> tuple:
    """[B, S, ...] with batch on data and sequence on seq."""
    return P(AXIS_DATA, AXIS_SEQ, *([None] * (ndim - 2)))


def model_param_specs(ml_backend: str, params: Any) -> dict | None:
    """The spec of each sharded piece of a serving checkpoint of
    ``ml_backend``, or None when nothing shards (mock has no params; the
    int8 trees are too small to split; routed params keep the experts'
    own layout, ``parallel/ep.py``). Pieces not named stay replicated."""
    if params is None:
        return None
    specs: dict[str, Any] = {}
    if ml_backend in ("mlp", "mlp+gbdt") and "mlp" in params:
        specs["mlp"] = mlp_param_specs(params["mlp"])
    if ml_backend in ("gbdt", "mlp+gbdt") and "gbdt" in params:
        specs["gbdt"] = gbdt_param_specs()
    if ml_backend == "multitask" and "multitask" in params:
        from igaming_platform_tpu_torch.models import multitask as mt

        specs["multitask"] = mt.param_specs(params["multitask"])
    return specs or None


# -- the sharded modules -----------------------------------------------------


def _blocks(n: int, k: int, what: str) -> list[tuple[int, int]]:
    if n % k:
        raise ValueError(f"{what} of {n} does not split over {k} shards")
    return coll.row_bounds(n, k)


class ShardedForest(dict):
    """A forest with its trees split over ``expert``: ``shards`` holds one
    ``{"feat", "thr", "leaves"}`` block per shard (on that shard's device, at
    data coordinate ``data``), ``bias`` the replicated bias.
    ``models/gbdt.gbdt_raw`` sums the shards' margins in shard order, then
    adds the bias."""

    def __init__(self, mesh: Mesh, params: dict, data: int = 0):
        n = mesh_axis_size(mesh, AXIS_EXPERT)
        shards = []
        for i, (lo, hi) in enumerate(_blocks(int(params["feat"].shape[0]), n, "a forest")):
            dev = mesh.axis_device(AXIS_EXPERT, i, data)
            shards.append({k: params[k][lo:hi].contiguous().to(dev)
                           for k in ("feat", "thr", "leaves")})
        super().__init__(shards=shards, bias=params["bias"].to(mesh.axis_device(AXIS_DATA, data)))

    def raw(self, x: torch.Tensor) -> torch.Tensor:
        from igaming_platform_tpu_torch.ops.gbdt_kernel import gbdt_forest

        parts = []
        for s in self["shards"]:
            xs = x if x.device == s["feat"].device else x.to(s["feat"].device)
            zero = torch.zeros((), dtype=torch.float32, device=xs.device)
            parts.append(gbdt_forest(xs, s["feat"], s["thr"], s["leaves"], zero))
        margin = coll.psum(parts, devices=[x.device] * len(parts))[0]
        return margin + self["bias"].to(x.device)


def _column_shard(layer, lo: int, hi: int, dev) -> nn.Module:
    return Dense(layer.w_bf16[:, lo:hi], layer.b[lo:hi]).to(dev)


class _RowShard(nn.Module):
    """Rows ``lo:hi`` of a layer's weight, no bias: one shard's partial
    product of a row-split layer."""

    def __init__(self, layer, lo: int, hi: int, dev):
        super().__init__()
        self.register_buffer("w_bf16", layer.w_bf16[lo:hi].contiguous().to(dev))
        self.register_buffer("zero", torch.zeros(layer.w_bf16.shape[1], device=dev))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        from igaming_platform_tpu_torch.ops.dense import dense

        return dense(h, self.w_bf16, self.zero)


class ShardedHidden(nn.Module):
    """Dense hidden layers (ReLU after each) in the alternating layout over
    ``model``: an even layer's output features split (each shard its
    columns, the activation left sharded), an odd layer's input features
    split (each shard its rows' partial product, psummed in shard order,
    then the bias). A sharded activation left at the end is all-gathered.
    The shards are the ``model`` devices at data coordinate ``data``."""

    def __init__(self, mesh: Mesh, layers, data: int = 0):
        super().__init__()
        n = mesh_axis_size(mesh, AXIS_MODEL)
        self.n = n
        self.devices = [mesh.axis_device(AXIS_MODEL, i, data) for i in range(n)]
        self.kinds: list[str] = []
        self.parts = nn.ModuleList()
        self.biases = []
        for i, layer in enumerate(layers):
            width = int(layer.w_bf16.shape[1] if i % 2 == 0 else layer.w_bf16.shape[0])
            bounds = _blocks(width, n, f"layer {i}'s hidden width")
            if i % 2 == 0:
                self.kinds.append("col")
                self.parts.append(nn.ModuleList(
                    [_column_shard(layer, lo, hi, d) for (lo, hi), d in zip(bounds, self.devices)]))
                self.biases.append(None)
            else:
                self.kinds.append("row")
                self.parts.append(nn.ModuleList(
                    [_RowShard(layer, lo, hi, d) for (lo, hi), d in zip(bounds, self.devices)]))
                self.biases.append(layer.b.to(self.devices[0]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        home = x.device
        h: Any = torch.as_tensor(x, dtype=torch.float32)  # a tensor, or a list of column shards
        for kind, parts, b in zip(self.kinds, self.parts, self.biases):
            if kind == "col":
                h = [torch.relu(p(h.to(d))) for p, d in zip(parts, self.devices)]
            else:
                partial = [p(hs) for p, hs in zip(parts, h)]
                h = torch.relu(coll.psum(partial, devices=[home] * self.n)[0] + b.to(home))
        if isinstance(h, list):
            h = coll.all_gather(h, gather_axis=1, devices=[home] * self.n)[0]
        return h


class ShardedMLP(nn.Module):
    """An ``MLP`` whose hidden layers run ``ShardedHidden``; the output head
    is replicated. ``models/mlp.mlp_predict`` takes it as it takes an MLP."""

    def __init__(self, mesh: Mesh, mlp, data: int = 0):
        super().__init__()
        self.hidden = ShardedHidden(mesh, list(mlp.layers[:-1]), data)
        self.head = coll.on_device(mlp.layers[-1], mesh.axis_device(AXIS_DATA, data))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return self.hidden(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))


class ShardedMultiTask(nn.Module):
    """A ``MultiTask`` whose trunk runs ``ShardedHidden``; the heads are
    replicated. ``models/multitask.fraud_predict`` takes it as it takes a
    MultiTask."""

    def __init__(self, mesh: Mesh, model, data: int = 0):
        super().__init__()
        dev = mesh.axis_device(AXIS_DATA, data)
        self.trunk = ShardedHidden(mesh, list(model.trunk), data)
        self.fraud_head = coll.on_device(model.fraud_head, dev)
        self.ltv_head = coll.on_device(model.ltv_head, dev)
        self.churn_head = coll.on_device(model.churn_head, dev)

    def trunk_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.trunk(x)


def shard_model_params(mesh: Mesh, ml_backend: str, params: Any, data: int = 0) -> Any:
    """The serving checkpoint with each piece ``model_param_specs`` names
    replaced by its sharded module: the forest's trees over ``expert`` (when
    that axis is > 1), the MLP and multitask trunks over ``model`` (when
    that axis is > 1), on the devices at data coordinate ``data``. Identity
    when nothing shards."""
    specs = model_param_specs(ml_backend, params)
    if specs is None:
        return params
    out = dict(params)
    if "gbdt" in specs and mesh_axis_size(mesh, AXIS_EXPERT) > 1:
        out["gbdt"] = ShardedForest(mesh, params["gbdt"], data)
    if mesh_axis_size(mesh, AXIS_MODEL) > 1:
        if "mlp" in specs:
            out["mlp"] = ShardedMLP(mesh, params["mlp"], data)
        if "multitask" in specs:
            out["multitask"] = ShardedMultiTask(mesh, params["multitask"], data)
    return out


# -- training over ``model`` ---------------------------------------------------


class _TrainRowShard(nn.Module):
    """Rows ``lo:hi`` of a trainable layer's float32 master weight, no bias:
    one shard's partial product of a row-split layer."""

    def __init__(self, w: torch.Tensor, dev):
        super().__init__()
        self.w = nn.Parameter(w.detach().clone().contiguous().to(dev))
        self.register_buffer("zero", torch.zeros(w.shape[1], device=dev))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        from igaming_platform_tpu_torch.ops.dense import dense_train

        return dense_train(h, self.w, self.zero)


class TrainShardedHidden(nn.Module):
    """The training twin of ``ShardedHidden``: ``TrainDense`` layers (float32
    master weights, ``DenseFn``'s gradients) in the alternating layout over
    ``model`` at data coordinate ``data``. An even layer keeps its columns
    and their bias on each shard; an odd layer its rows on each shard and
    its bias on the first. Autograd runs through the psum and the gather."""

    def __init__(self, mesh: Mesh, layers, data: int = 0):
        super().__init__()
        n = mesh_axis_size(mesh, AXIS_MODEL)
        self.n = n
        self.devices = [mesh.axis_device(AXIS_MODEL, i, data) for i in range(n)]
        self.kinds: list[str] = []
        self.parts = nn.ModuleList()
        self.biases = nn.ParameterList()
        for i, layer in enumerate(layers):
            w, b = layer.w.detach(), layer.b.detach()
            width = int(w.shape[1] if i % 2 == 0 else w.shape[0])
            bounds = _blocks(width, n, f"layer {i}'s hidden width")
            if i % 2 == 0:
                self.kinds.append("col")
                self.parts.append(nn.ModuleList(
                    [TrainDense(w[:, lo:hi].to(d), b[lo:hi].to(d))
                     for (lo, hi), d in zip(bounds, self.devices)]))
            else:
                self.kinds.append("row")
                self.parts.append(nn.ModuleList(
                    [_TrainRowShard(w[lo:hi], d) for (lo, hi), d in zip(bounds, self.devices)]))
                self.biases.append(nn.Parameter(b.clone().to(self.devices[0])))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        home = x.device
        h: Any = torch.as_tensor(x, dtype=torch.float32)
        row = 0
        for kind, parts in zip(self.kinds, self.parts):
            if kind == "col":
                h = [torch.relu(p(h.to(d))) for p, d in zip(parts, self.devices)]
            else:
                partial = [p(hs) for p, hs in zip(parts, h)]
                h = torch.relu(coll.psum(partial, devices=[home] * self.n)[0]
                               + self.biases[row].to(home))
                row += 1
        if isinstance(h, list):
            h = coll.all_gather(h, gather_axis=1, devices=[home] * self.n)[0]
        return h

    def full_layers(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Every layer's whole (w, b), detached, on the first shard's device."""
        home = self.devices[0]
        out, row = [], 0
        for kind, parts in zip(self.kinds, self.parts):
            if kind == "col":
                out.append((torch.cat([p.w.detach().to(home) for p in parts], dim=1),
                            torch.cat([p.b.detach().to(home) for p in parts])))
            else:
                out.append((torch.cat([p.w.detach().to(home) for p in parts], dim=0),
                            self.biases[row].detach().clone()))
                row += 1
        return out


class TrainShardedMultiTask(TrainMultiTask):
    """A ``TrainMultiTask`` whose trunk runs ``TrainShardedHidden`` over
    ``model`` at data coordinate ``data``; the heads are replicated there.
    ``serving()`` assembles the whole net: one unsharded ``MultiTask``."""

    def __init__(self, mesh: Mesh, model, data: int = 0):
        dev = mesh.axis_device(AXIS_DATA, data)
        super().__init__([], *(copy.deepcopy(h).to(dev) for h in (
            model.fraud_head, model.ltv_head, model.churn_head)))
        self.trunk = TrainShardedHidden(mesh, list(model.trunk), data)

    def trunk_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.trunk(x)

    def serving(self) -> MultiTask:
        return MultiTask([Dense(w, b) for w, b in self.trunk.full_layers()],
                         self.fraud_head.serving(), self.ltv_head.serving(),
                         self.churn_head.serving())


def shard_train_model(mesh: Mesh, model, data: int = 0) -> nn.Module:
    """A trainable multitask net laid over ``mesh`` at data coordinate
    ``data``: its trunk over ``model`` when that axis is > 1
    (``TrainShardedMultiTask``), else a copy on that coordinate's device."""
    if mesh_axis_size(mesh, AXIS_MODEL) > 1:
        return TrainShardedMultiTask(mesh, model, data)
    return copy.deepcopy(model).to(mesh.axis_device(AXIS_DATA, data))


# -- one serving replica per data device ---------------------------------------


class DataReplicas(dict):
    """Serving params laid at data coordinate 0 (the dict itself), carrying
    the replica of every other data coordinate whose devices are its own
    (``Mesh.data_replicas``): ``at(c)`` is the replica data coordinate ``c``
    scores with."""

    def __init__(self, params: dict, replicas: dict[int, Any], coords: list[int]):
        super().__init__(params)
        self.replicas = replicas
        self.coords = coords

    def at(self, c: int) -> Any:
        r = self.coords[c]
        return self if r == 0 else self.replicas[r]


def replicate_over_data(mesh: Mesh, params: dict, lay=lambda p, c: p) -> dict:
    """``params`` (on the mesh's first device) with one replica for each data
    coordinate whose devices are distinct from every earlier one's, each
    laid by ``lay(params_on_its_device, c)`` (``shard_model_params`` for a
    model-sharded engine). A logical mesh gives ``lay(params, 0)`` alone:
    one replica, never one a shard."""
    from igaming_platform_tpu_torch.convert import params_to

    coords = mesh.data_replicas()
    home = lay(params, 0)
    distinct = sorted(set(coords) - {0})
    if not distinct:
        return home
    replicas = {c: lay(params_to(params, mesh.axis_device(AXIS_DATA, c)), c) for c in distinct}
    return DataReplicas(home, replicas, coords)
