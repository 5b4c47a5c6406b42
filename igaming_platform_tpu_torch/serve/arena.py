"""Per-shape staging arenas: reusable host buffers for the serving loop.

The port's counterpart of ``igaming_platform_tpu/serve/arena.py``. The
host pipeline (``serve/pipeline_engine.py``) pads every chunk into a
staging buffer of its padded shape. An :class:`ArenaPool` keeps a bounded
free list of buffers per (shape, dtype) and hands them back out, so the
steady state cycles the same few buffers instead of allocating per batch.

On the card the pool hands out page-locked (pinned) host memory, as numpy
views of ``torch.empty(..., pin_memory=True)``: only from pinned memory is
a ``non_blocking`` host-to-device copy asynchronous. That is also what
makes reuse dangerous. The copy engine reads the buffer after the launch
returns, so a buffer rewritten before its copy has finished sends the
next batch's rows into this batch's step. :class:`StagingHold` keeps the
invariant: its buffers go back to the pool only after every party has
released them AND the CUDA event recorded after their copies has
completed.
"""

from __future__ import annotations

import threading

import numpy as np
import torch


class ArenaPool:
    """Thread-safe free lists of numpy buffers keyed by (shape, dtype).

    ``max_per_key`` bounds how many idle buffers a key keeps; beyond that,
    released buffers are dropped (a burst must not pin its high-water mark
    forever). ``pin_memory`` allocates page-locked buffers (needs a card).
    """

    def __init__(self, max_per_key: int = 8, pin_memory: bool = False):
        self.max_per_key = max(1, max_per_key)
        self.pin_memory = pin_memory
        self._free: dict[tuple, list[np.ndarray]] = {}
        self._lock = threading.Lock()
        # Reuses against fresh allocations: a healthy steady state is
        # nearly all reuse after the first few batches.
        self.reused = 0
        self.allocated = 0

    @staticmethod
    def _key(shape: tuple, dtype) -> tuple:
        return (tuple(shape), np.dtype(dtype).str)

    def _allocate(self, shape: tuple, dtype) -> np.ndarray:
        if not self.pin_memory:
            return np.zeros(shape, dtype=dtype)
        # The numpy view keeps its pinned tensor alive.
        t = torch.from_numpy(np.empty(0, dtype=dtype))  # the torch dtype of ``dtype``
        return torch.zeros(shape, dtype=t.dtype, pin_memory=True).numpy()

    def acquire(self, shape: tuple, dtype, zero: bool = False) -> np.ndarray:
        """A buffer of exactly (shape, dtype): a free one when there is one,
        else a new one. ``zero=True`` clears a reused buffer."""
        key = self._key(shape, dtype)
        with self._lock:
            stack = self._free.get(key)
            buf = stack.pop() if stack else None
            if buf is None:
                self.allocated += 1
            else:
                self.reused += 1
        if buf is None:
            return self._allocate(shape, dtype)
        if zero:
            buf.fill(0)
        return buf

    def release(self, buf: np.ndarray | None) -> None:
        """Return a buffer to its free list. None is ignored, and
        non-contiguous or read-only arrays are dropped, not pooled."""
        if buf is None or not buf.flags.c_contiguous or not buf.flags.writeable:
            return
        key = self._key(buf.shape, buf.dtype)
        with self._lock:
            stack = self._free.setdefault(key, [])
            if len(stack) < self.max_per_key:
                stack.append(buf)

    def stats(self) -> dict:
        with self._lock:
            idle = sum(len(v) for v in self._free.values())
        return {"allocated": self.allocated, "reused": self.reused, "idle": idle}


class StagingHold:
    """Deferred release of one dispatch's staging buffers.

    Each of ``parties`` consumers calls :meth:`release` once; on the last
    call the buffers return to the pool, after waiting for ``copied``, the
    CUDA event recorded on the engine's stream after the buffers'
    host-to-device copies (``None`` on the CPU, where the copy is done when
    the launch returns). Set ``copied`` once the copies are enqueued.
    Thread-safe; release may come from any thread."""

    __slots__ = ("_pool", "_bufs", "_parties", "_lock", "copied")

    def __init__(self, pool: ArenaPool, bufs, parties: int = 1):
        self._pool = pool
        self._bufs = [b for b in bufs if b is not None]
        self._parties = int(parties)
        self._lock = threading.Lock()
        self.copied = None

    def release(self) -> None:
        with self._lock:
            self._parties -= 1
            if self._parties != 0:
                return
            bufs, self._bufs = self._bufs, []
        if self.copied is not None:
            self.copied.synchronize()
        for b in bufs:
            self._pool.release(b)
