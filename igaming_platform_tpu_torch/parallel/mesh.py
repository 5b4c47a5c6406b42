"""The device mesh: a named-axis grid of ``torch.device`` handles.

Counterpart of ``igaming_platform_tpu/parallel/mesh.py``. JAX runs one SPMD
program over a ``jax.sharding.Mesh``; PyTorch has no such program, so the
port's mesh is a grid of devices with the JAX axes:

- ``data``   batch sharding for serving batches (rows split, DP);
- ``model``  tensor parallelism for the MLP and multitask trunks;
- ``seq``    sequence sharding for the abuse detector (ring, Ulysses);
- ``expert`` the routed ensemble's experts, and the forest's tree bank.

A sharded step runs its body shard by shard over per-shard tensors, and the
collectives (``parallel/collectives.py``) are functions over those lists.
The grid may repeat one device (``create_mesh(spec, devices=[cpu] * 8)``):
such a LOGICAL mesh runs every shard on that device, which checks the
layouts and the arithmetic of a sharded program but measures no
interconnect. ``devices_from_env`` is the environment's entry point: it
counts the visible CUDA devices and never repeats one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"

MESH_AXES = (AXIS_DATA, AXIS_MODEL, AXIS_SEQ, AXIS_EXPERT)


@dataclass(frozen=True)
class MeshSpec:
    """Requested axis sizes; ``data=-1`` absorbs all remaining devices."""

    data: int = -1
    model: int = 1
    seq: int = 1
    expert: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int, int]:
        fixed = self.model * self.seq * self.expert
        if fixed <= 0:
            raise ValueError(f"axis sizes must be positive: {self}")
        data = self.data
        if data == -1:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by model*seq*expert={fixed}")
            data = n_devices // fixed
        total = data * fixed
        if total != n_devices:
            raise ValueError(f"mesh {data}x{self.model}x{self.seq}x{self.expert}={total} != "
                             f"{n_devices} devices")
        return (data, self.model, self.seq, self.expert)


class Mesh:
    """A [data, model, seq, expert] grid of devices, laid out row-major.

    ``shape`` maps each axis name to its size, as a JAX mesh's does.
    ``process_index``/``process_count`` place a global mesh's ``data`` axis
    over processes (``parallel/distributed.global_mesh``): this process owns
    the data coordinates ``[process_index * local_data, ...)``; a local mesh
    has one process."""

    def __init__(self, devices: np.ndarray, process_index: int = 0, process_count: int = 1):
        if devices.ndim != len(MESH_AXES):
            raise ValueError(f"a mesh grid has {len(MESH_AXES)} axes, got {devices.ndim}")
        self.devices = devices
        self.axis_names = MESH_AXES
        self.shape = {a: int(s) for a, s in zip(MESH_AXES, devices.shape)}
        self.process_index = int(process_index)
        self.process_count = int(process_count)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """The device of the first shard: where a sharded step's inputs
        arrive and its gathered result is left."""
        return self.devices.flat[0]

    def distinct_devices(self) -> list[torch.device]:
        out: list[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    @property
    def logical(self) -> bool:
        """True when the grid repeats a device: its shards share hardware."""
        return len(self.distinct_devices()) < self.size

    def axis_device(self, axis: str, i: int, data: int = 0) -> torch.device:
        """The device of coordinate ``i`` on ``axis``, at ``data`` on the data
        axis (when ``axis`` is another) and 0 on every other."""
        idx = [0] * len(MESH_AXES)
        idx[0] = data
        idx[MESH_AXES.index(axis)] = i
        return self.devices[tuple(idx)]

    def data_replicas(self) -> list[int]:
        """For each ``data`` coordinate, the coordinate whose params replica it
        uses: the first one whose devices (on the other axes) are its own. A
        logical mesh that repeats one device gives all 0: one replica."""
        keys = [tuple(self.devices[d].flat) for d in range(self.shape[AXIS_DATA])]
        return [keys.index(k) for k in keys]

    def __repr__(self) -> str:
        dims = "x".join(f"{a}={s}" for a, s in self.shape.items())
        kind = " logical" if self.logical else ""
        return f"Mesh({dims}{kind} over {[str(d) for d in self.distinct_devices()]})"


def create_mesh(spec: MeshSpec = MeshSpec(), devices: Sequence | None = None) -> Mesh:
    """Build the 4-axis mesh over ``devices`` (default: every visible CUDA
    device), row-major so neighbouring ``data`` coordinates are adjacent in
    the list. ``devices`` may repeat a device: a logical mesh."""
    if devices is None:
        devices = visible_cuda_devices()
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    shape = spec.resolve(len(devs))
    grid = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        grid[i] = d
    return Mesh(grid.reshape(shape))


def visible_cuda_devices() -> list[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def single_device_mesh(device=None) -> Mesh:
    """A 1x1x1x1 mesh: the same sharded code paths on one device."""
    if device is None:
        devs = visible_cuda_devices()
        if not devs:
            raise RuntimeError("no CUDA device is available; pass device='cpu'")
        device = devs[0]
    return create_mesh(MeshSpec(data=1), devices=[device])


def best_effort_mesh(model: int = 1, seq: int = 1, expert: int = 1,
                     devices: Sequence | None = None) -> Mesh:
    """Mesh over ``devices`` (every visible CUDA device by default) with the
    given non-data axis sizes, falling back to pure DP if the device count
    doesn't divide."""
    devs = list(devices) if devices is not None else visible_cuda_devices()
    fixed = model * seq * expert
    if len(devs) % fixed != 0:
        return create_mesh(MeshSpec(data=-1), devices=devs)
    return create_mesh(MeshSpec(data=-1, model=model, seq=seq, expert=expert), devices=devs)


def devices_from_env(n: int) -> list[torch.device]:
    """The first ``n`` visible CUDA devices for ``MESH_DEVICES=n`` (-1: all
    of them). Refuses an ``n`` beyond the visible count, with the JAX
    server's message; never repeats a device."""
    devs = visible_cuda_devices()
    n = len(devs) if n == -1 else n
    if n > len(devs):
        raise RuntimeError(f"MESH_DEVICES={n} but only {len(devs)} devices visible")
    return devs[:n]


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return int(mesh.shape[axis])


def validate_batch_for_mesh(batch_size: int, mesh: Mesh) -> None:
    """Fixed-shape discipline: device batches must divide evenly over DP."""
    dp = mesh_axis_size(mesh, AXIS_DATA)
    if batch_size % dp != 0:
        raise ValueError(f"batch {batch_size} not divisible by data axis {dp}")


def pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n > 0 else 1


def auto_spec(n_devices: int | None = None) -> MeshSpec:
    """Heuristic default: all devices on ``data`` (serving + DP training)."""
    return MeshSpec(data=-1)
