"""Slot-sharded device state: the feature table and the session ring over a mesh.

Counterpart of ``igaming_platform_tpu/parallel/state_sharding.py``. The
big per-slot arrays (the feature cache's table and flags, the session
ring, cursor and length) split by slot over the mesh ``data`` axis, so a
K-shard mesh holds one table split K ways. Shards are contiguous row
blocks, so

    owner(slot) = slot // (capacity // K)

and the host side (CLOCK admission, per-shard occupancy, the debug pages)
attributes every slot without asking the device.

A slot-sharded array is a ``SlotShardedArray``: one tensor per shard, on
that shard's device, holding the shard's rows plus one scratch row past
the end. Two access patterns, both exact by construction:

- ``gather_slots``: each shard reads its owned rows (a non-owned or
  out-of-range slot reads the scratch row, then zero in its place: JAX's
  ``mode='fill'``), the contributions all-gather over ``data`` and the
  owner's copy is selected, never summed;
- ``scatter_slots`` (and ``index_add_``/``put_``): global slots map to
  local rows; every slot a shard does not own maps to the scratch row
  (JAX's ``mode='drop'``), so torch's indexing never meets an out-of-range
  index and never writes a row another shard owns. A slot past the
  capacity (the session step's pad rows) is owned by nobody and vanishes.

Every access is masked by index arithmetic on the device, never by a
boolean selection, which would wait for the stream to learn its size.

A ``SlotShardedArray`` answers ``index_select``, ``index_copy_`` and
``index_add_`` as a tensor does, so the cache and the session step run one
code path over either layout (the JAX package's ``make_sharded_scatter``
and ``make_sharded_ring_sync`` are those calls on a sharded array).
``plan_for`` returns a ``SlotShardingPlan`` when the mesh's ``data`` axis
is > 1 and ``STATE_SHARDING`` is not ``0`` (default on); otherwise None
and the caller keeps the unsharded layout.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from igaming_platform_tpu_torch.parallel import collectives as coll
from igaming_platform_tpu_torch.parallel.mesh import AXIS_DATA


def sharding_enabled_env() -> bool:
    return os.environ.get("STATE_SHARDING", "1") not in ("0", "false")


@dataclass(frozen=True)
class SlotShardingPlan:
    """How per-slot device state splits over the mesh ``data`` axis."""

    mesh: object
    n_shards: int

    def round_capacity(self, capacity: int) -> int:
        """Smallest multiple of ``n_shards`` >= capacity: equal row blocks,
        and rounding up never shrinks what the operator asked for."""
        k = self.n_shards
        return ((int(capacity) + k - 1) // k) * k

    def rows_per_shard(self, capacity: int) -> int:
        if capacity % self.n_shards != 0:
            raise ValueError(f"capacity {capacity} not divisible by {self.n_shards} shards "
                             "(round_capacity first)")
        return capacity // self.n_shards

    def owner_of(self, slots, capacity: int) -> np.ndarray:
        """Vectorized slot -> shard index (host-side attribution)."""
        return (np.asarray(slots, np.int64) // self.rows_per_shard(capacity)).astype(np.int32)

    def devices(self) -> list[torch.device]:
        return coll.axis_devices(self.mesh, AXIS_DATA)

    def zeros(self, capacity: int, row_shape: tuple = (), dtype=torch.float32
              ) -> "SlotShardedArray":
        """A zero slot-sharded array of ``capacity`` rows of ``row_shape``."""
        rows = self.rows_per_shard(capacity)
        return SlotShardedArray([torch.zeros((rows + 1, *row_shape), dtype=dtype, device=d)
                                 for d in self.devices()], rows)


def plan_for(mesh, enabled: bool | None = None) -> SlotShardingPlan | None:
    """The plan for this mesh, or None when slot sharding doesn't apply (no
    mesh, a 1-wide data axis, STATE_SHARDING=0)."""
    if mesh is None:
        return None
    k = int(mesh.shape.get(AXIS_DATA, 1))
    if k <= 1:
        return None
    if enabled is None:
        enabled = sharding_enabled_env()
    if not enabled:
        return None
    return SlotShardingPlan(mesh, k)


# -- the per-shard building blocks -------------------------------------------


def local_slot_index(local_rows: int, shard: int, slots: torch.Tensor):
    """Global slot ids -> (local row index, owned mask) for shard ``shard``.
    Non-owned (and out-of-range) slots map to ``local_rows``: the scratch
    row one past the shard's last."""
    li = slots - shard * local_rows
    owned = (li >= 0) & (li < local_rows)
    return torch.where(owned, li, torch.full_like(li, local_rows)), owned


def gather_slots(shards: Sequence[torch.Tensor], local_rows: int,
                 slots: torch.Tensor) -> torch.Tensor:
    """Exact sharded gather of global ``slots``: each shard's owned rows
    (zero elsewhere) all-gather over ``data`` and the owner's row is
    selected. A slot past the capacity reads zero. The result lies on the
    device of ``slots``."""
    contribs = []
    for i, local in enumerate(shards):
        s = slots.to(local.device)
        li, owned = local_slot_index(local_rows, i, s)
        rows = local.index_select(0, li)
        mask = owned.reshape(-1, *([1] * (rows.dim() - 1)))
        contribs.append(torch.where(mask, rows, torch.zeros_like(rows)))
    allc = coll.all_gather(contribs, tiled=False, devices=[slots.device] * len(shards))[0]
    owner = torch.clamp(torch.div(slots, local_rows, rounding_mode="floor"), 0,
                        len(shards) - 1)
    return allc[owner, torch.arange(slots.shape[0], device=slots.device)]


def scatter_slots(shards: Sequence[torch.Tensor], local_rows: int, slots: torch.Tensor,
                  rows: torch.Tensor) -> None:
    """Write ``rows`` at global ``slots``, in place: each shard lands only
    its owned rows; the rest go to its scratch row. Slots must be distinct
    (a duplicate's winner is unspecified, as in the unsharded copy)."""
    for i, local in enumerate(shards):
        li, _ = local_slot_index(local_rows, i, slots.to(local.device))
        local.index_copy_(0, li, rows.to(local.device))


class SlotShardedArray:
    """A per-slot array split by slot over ``data``: ``shards[i]`` holds
    slots ``[i * rows, (i + 1) * rows)`` and a scratch row at index
    ``rows``. Reads and writes take global slot ids."""

    def __init__(self, shards: list[torch.Tensor], rows_per_shard: int):
        self.shards = shards
        self.rows = int(rows_per_shard)

    @property
    def capacity(self) -> int:
        return self.rows * len(self.shards)

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def gather(self, slots: torch.Tensor) -> torch.Tensor:
        return gather_slots(self.shards, self.rows, slots)

    def index_select(self, dim: int, slots: torch.Tensor) -> torch.Tensor:
        """``tensor.index_select(0, slots)``'s sharded twin (zero past the
        capacity)."""
        if dim != 0:
            raise ValueError("a slot-sharded array is indexed on dim 0 only")
        return self.gather(slots)

    def index_copy_(self, dim: int, slots: torch.Tensor, rows: torch.Tensor):
        if dim != 0:
            raise ValueError("a slot-sharded array is indexed on dim 0 only")
        scatter_slots(self.shards, self.rows, slots, rows)
        return self

    def index_add_(self, dim: int, slots: torch.Tensor, values: torch.Tensor):
        """Add ``values`` at global ``slots`` (duplicates add up)."""
        if dim != 0:
            raise ValueError("a slot-sharded array is indexed on dim 0 only")
        for i, local in enumerate(self.shards):
            li, _ = local_slot_index(self.rows, i, slots.to(local.device))
            local.index_add_(0, li, values.to(local.device))
        return self

    def put_rows_at(self, slots: torch.Tensor, cols: torch.Tensor, values: torch.Tensor) -> None:
        """``array[slots, cols] = values`` with global ``slots``: the ring
        append. (slot, col) pairs must be distinct."""
        for i, local in enumerate(self.shards):
            li, _ = local_slot_index(self.rows, i, slots.to(local.device))
            local[li, cols.to(local.device)] = values.to(local.device)

    def apply_(self, fn) -> None:
        """``fn(shard)`` in place on every shard's owned rows."""
        for local in self.shards:
            fn(local[:self.rows])

    def full(self) -> torch.Tensor:
        """Every owned row, in slot order (a gather of the whole array)."""
        return coll.all_gather([s[:self.rows] for s in self.shards],
                               devices=[self.device] * len(self.shards))[0]

    def per_shard_nbytes(self) -> list[int]:
        return [s.numel() * s.element_size() for s in self.shards]


def per_shard_nbytes(arr) -> list[int]:
    """Device bytes of ``arr`` per shard: a ``SlotShardedArray``'s shards
    (each with its scratch row), or one entry for a plain tensor or numpy
    array: a replicated array reports its full size, the asymmetry the
    measurement records."""
    if isinstance(arr, SlotShardedArray):
        return arr.per_shard_nbytes()
    if isinstance(arr, torch.Tensor):
        return [arr.numel() * arr.element_size()]
    return [int(np.prod(arr.shape)) * arr.dtype.itemsize]
