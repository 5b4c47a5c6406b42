"""The collective vocabulary over per-shard tensor lists.

Counterpart of ``igaming_platform_tpu/parallel/collectives.py``. There the
functions lower to XLA collectives inside ``shard_map``; here a value
sharded over a mesh axis of size n is a list of n tensors, coordinate i's
shard at index i, and every collective is a function from such a list to
such a list. Each result lands on the device of the shard that receives it
(``devices``, default: where each input shard lies), so the same code runs
on a logical mesh that repeats one device and on distinct devices.

Sums add the shards in coordinate order, left to right: a fixed order, but
not the single-device program's, so a split reduction is held to its JAX
twin with a tolerance, never bit for bit.
"""

from __future__ import annotations

import collections
import itertools
import threading
from typing import Any, Sequence

import numpy as np
import torch

from igaming_platform_tpu_torch.parallel.mesh import AXIS_DATA, Mesh

Shards = list[torch.Tensor]


def _place(t: torch.Tensor, shards: Sequence[torch.Tensor], devices) -> Shards:
    devs = devices if devices is not None else [s.device for s in shards]
    return [t if t.device == d else t.to(d) for d in devs]


def _sum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    dev = xs[0].device
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x.to(dev)
    return acc


def psum(xs: Sequence[torch.Tensor], devices=None) -> Shards:
    """All-reduce sum over the axis: every shard gets the sum, added in
    coordinate order."""
    return _place(_sum(xs), xs, devices)


def pmean(xs: Sequence[torch.Tensor], devices=None) -> Shards:
    return _place(_sum(xs) / len(xs), xs, devices)


def pmax(xs: Sequence[torch.Tensor], devices=None) -> Shards:
    dev = xs[0].device
    acc = xs[0]
    for x in xs[1:]:
        acc = torch.maximum(acc, x.to(dev))
    return _place(acc, xs, devices)


def all_gather(xs: Sequence[torch.Tensor], *, tiled: bool = True, gather_axis: int = 0,
               devices=None) -> Shards:
    """Every shard gets all shards, concatenated on ``gather_axis``
    (``tiled``) or stacked on a new leading axis."""
    dev = xs[0].device
    parts = [x.to(dev) for x in xs]
    full = torch.cat(parts, dim=gather_axis) if tiled else torch.stack(parts, dim=gather_axis)
    return _place(full, xs, devices)


def reduce_scatter(xs: Sequence[torch.Tensor], *, scatter_axis: int = 0, devices=None) -> Shards:
    """Sum, then shard i keeps the i-th block of ``scatter_axis``."""
    total = _sum(xs)
    n = len(xs)
    blocks = torch.chunk(total, n, dim=scatter_axis)
    devs = devices if devices is not None else [x.device for x in xs]
    return [b.to(d) for b, d in zip(blocks, devs)]


def all_to_all(xs: Sequence[torch.Tensor], *, split_axis: int, concat_axis: int,
               devices=None) -> Shards:
    """Shard j gets block j of every shard's ``split_axis``, concatenated on
    ``concat_axis`` in source order: the exchange of Ulysses and of the
    routed experts' dispatch."""
    n = len(xs)
    for x in xs:
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} does not split "
                             f"{n} ways")
    devs = devices if devices is not None else [x.device for x in xs]
    split = [torch.chunk(x, n, dim=split_axis) for x in xs]
    return [torch.cat([split[i][j].to(devs[j]) for i in range(n)], dim=concat_axis)
            for j in range(n)]


def ppermute_ring(xs: Sequence[torch.Tensor], *, shift: int = 1, devices=None) -> Shards:
    """Rotate the shards around the ring: shard (i + shift) mod n gets
    shard i's value."""
    n = len(xs)
    devs = devices if devices is not None else [x.device for x in xs]
    out: list = [None] * n
    for i, x in enumerate(xs):
        j = (i + shift) % n
        out[j] = x.to(devs[j])
    return out


# -- host-facing sharding helpers -------------------------------------------


def row_bounds(n_rows: int, n_shards: int) -> list[tuple[int, int]]:
    """The contiguous row blocks of an even split: [(lo, hi)] per shard."""
    if n_rows % n_shards:
        raise ValueError(f"{n_rows} rows do not split evenly over {n_shards} shards")
    per = n_rows // n_shards
    return [(i * per, (i + 1) * per) for i in range(n_shards)]


def axis_devices(mesh: Mesh, axis: str = AXIS_DATA) -> list[torch.device]:
    return [mesh.axis_device(axis, i) for i in range(mesh.shape[axis])]


def shard_batch(mesh: Mesh, x, *, axis: str = AXIS_DATA) -> Shards:
    """A host array or tensor with its leading dim split over ``axis``: one
    contiguous block per coordinate, on that coordinate's device."""
    t = torch.as_tensor(np.asarray(x)) if isinstance(x, np.ndarray) else x
    devs = axis_devices(mesh, axis)
    return [t[lo:hi].to(d) for (lo, hi), d in zip(row_bounds(t.shape[0], len(devs)), devs)]


def replicate(mesh: Mesh, x, *, axis: str = AXIS_DATA) -> Shards:
    """The same value on every coordinate of ``axis``."""
    t = torch.as_tensor(np.asarray(x)) if isinstance(x, np.ndarray) else x
    return [t.to(d) for d in axis_devices(mesh, axis)]


def unshard_rows(xs: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The row layout's inverse: the blocks concatenated on the first
    shard's device."""
    return all_gather(xs, gather_axis=dim)[0]


# -- params on a shard's device ---------------------------------------------

_PLACED_MAX = 16
_placed: "collections.OrderedDict[tuple[int, torch.device], tuple[Any, Any]]" = (
    collections.OrderedDict())
_placed_lock = threading.Lock()


def _first_tensor(obj) -> torch.Tensor | None:
    if isinstance(obj, torch.Tensor):
        return obj
    if isinstance(obj, torch.nn.Module):
        return next(itertools.chain(obj.parameters(), obj.buffers()), None)
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        for v in obj:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def on_device(params: Any, device: torch.device) -> Any:
    """``params`` (a tensor, a module, or a dict or tuple of them) with its
    tensors on ``device``: ``params`` itself when they lie there already (a
    logical mesh), else a copy made at the first call and kept for the
    next ones (the 16 most recent; the copy keeps ``params`` alive, so its
    ``id`` is not reused while it is kept)."""
    first = _first_tensor(params)
    device = torch.device(device)
    if first is None or first.device == device:
        return params
    key = (id(params), device)
    with _placed_lock:
        hit = _placed.get(key)
        if hit is not None and hit[0] is params:
            _placed.move_to_end(key)
            return hit[1]
    copy = _copy_to(params, device)
    with _placed_lock:
        _placed[key] = (params, copy)
        while len(_placed) > _PLACED_MAX:
            _placed.popitem(last=False)
    return copy


def _copy_to(obj, device):
    import copy

    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, torch.nn.Module):
        return copy.deepcopy(obj).to(device)
    if isinstance(obj, dict):
        return {k: _copy_to(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_copy_to(v, device) for v in obj)
    return obj
