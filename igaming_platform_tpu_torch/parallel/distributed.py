"""Multi-process bootstrap over ``torch.distributed`` with the gloo backend.

Counterpart of ``igaming_platform_tpu/parallel/distributed.py``. There
``jax.distributed`` stitches every host's devices into one global mesh;
here ``initialize_from_env`` reads the same variables and joins this
process to a gloo rendezvous:

    COORDINATOR_ADDRESS  host:port of process 0 (it hosts the store)
    NUM_PROCESSES        total process count
    PROCESS_ID           this process's index

Gloo, not NCCL: NCCL refuses two ranks on one GPU, and its collectives
would need the tensors on the card; gloo moves host copies. ``new_group``
makes a further gloo group over the same store under its own tag: the
multi-host front makes one per follower incarnation, since a group whose
member died cannot be used again. Every rendezvous and collective carries
``DIST_TIMEOUT`` (60 s).

Only this module and ``serve/multihost.py`` use ``torch.distributed``.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Sequence

import torch

from igaming_platform_tpu_torch.parallel.mesh import Mesh, MeshSpec

logger = logging.getLogger(__name__)

_state: dict = {}

DIST_TIMEOUT = datetime.timedelta(seconds=60)


def initialize_from_env() -> bool:
    """Join the gloo rendezvous the environment describes; True when the
    run has more than one process. A single-process run (NUM_PROCESSES
    unset or 1) does nothing and returns False."""
    num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return False
    if _state:
        return True
    import torch.distributed as dist

    host, port = os.environ["COORDINATOR_ADDRESS"].rsplit(":", 1)
    rank = int(os.environ["PROCESS_ID"])
    store = dist.TCPStore(host, int(port), num_processes, rank == 0, timeout=DIST_TIMEOUT,
                          wait_for_workers=False)
    _state.update(store=store, rank=rank, size=num_processes)
    logger.info("distributed initialized: process %d/%d over gloo at %s:%s",
                rank, num_processes, host, port)
    return True


def new_group(tag: str):
    """A gloo process group of every process, rendezvoused under ``tag``
    on the coordinator's store (every process must call it with the same
    tag). Its collectives take CPU tensors."""
    import torch.distributed as dist

    if not _state:
        raise RuntimeError("initialize_from_env() first (NUM_PROCESSES > 1)")
    return dist.ProcessGroupGloo(dist.PrefixStore(tag, _state["store"]), _state["rank"],
                                 _state["size"], DIST_TIMEOUT)


def all_gather(group, t: torch.Tensor) -> list[torch.Tensor]:
    """One gloo all-gather of a CPU tensor: every process's copy, in rank
    order."""
    outs = [torch.empty_like(t) for _ in range(group.size())]
    group.allgather([outs], [t.contiguous()]).wait()
    return outs


def process_index() -> int:
    return int(_state.get("rank", 0))


def process_count() -> int:
    return int(_state.get("size", 1))


def is_primary() -> bool:
    """True on the process that owns logging and checkpoint writes."""
    return process_index() == 0


def shutdown() -> None:
    """Forget the rendezvous (the store closes with its last reference)."""
    _state.clear()


def global_mesh(spec: MeshSpec = MeshSpec(), local_devices: Sequence | None = None) -> Mesh:
    """A mesh whose ``data`` axis spans every process: this process's
    ``local_devices`` (default: its visible CUDA devices) hold its block of
    the data coordinates, and the grid lists only them; ``process_index``
    and ``process_count`` say where the block sits. ``spec``'s non-data
    axes stay within a process."""
    from igaming_platform_tpu_torch.parallel.mesh import create_mesh, visible_cuda_devices

    devs = list(local_devices) if local_devices is not None else visible_cuda_devices()
    local = create_mesh(MeshSpec(data=-1, model=spec.model, seq=spec.seq, expert=spec.expert),
                        devices=devs)
    return Mesh(local.devices, process_index=process_index(), process_count=process_count())


def global_data_size(mesh: Mesh) -> int:
    """The ``data`` axis across every process of a global mesh."""
    return int(mesh.shape["data"]) * mesh.process_count


def process_batch_slice(global_batch: int) -> tuple[int, int]:
    """(per-process batch, offset) for host-local data loading."""
    n = process_count()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    per = global_batch // n
    return per, per * process_index()
