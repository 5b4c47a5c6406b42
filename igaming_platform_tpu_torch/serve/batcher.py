"""Continuous batcher: concurrent Score requests coalesce into one device batch.

The port's counterpart of ``igaming_platform_tpu/serve/batcher.py``,
reduced to one FIFO lane:

- requests enqueue with a Future;
- the launcher thread flushes a batch when ``batch_size`` requests have
  arrived or ``max_wait_ms`` has passed since the first one;
- dispatch and collect are two phases: ``dispatch(payloads)`` launches the
  device step and starts its device-to-host copy without waiting, and
  ``collect(handle)`` waits for it and builds the results. Collect runs on
  a collector thread with at most ``pipeline_depth`` batches in flight, so
  batch k+1 launches while batch k's results are still coming back.

Deadline lanes, earliest-deadline-first order, hedged re-dispatch and
device retries are not ported yet.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Sequence

import numpy as np

from igaming_platform_tpu_torch.core.config import BatcherConfig

_SENTINEL = object()


class CollectorPipeline:
    """Bounded in-flight window drained by a collector thread.

    The producer ``put()``s dispatched work; the collector thread runs
    ``process(item)``. If ``process`` raises, the error is recorded and the
    collector keeps draining (passing items to ``on_discard``), so a
    producer blocked in ``put()`` never deadlocks on a dead collector, and
    ``put()`` re-raises that error. ``close()`` delivers the shutdown
    sentinel and joins the thread.
    """

    def __init__(
        self,
        process: Callable[[Any], None],
        depth: int,
        name: str = "collector",
        on_discard: Callable[[Any], None] | None = None,
    ):
        self._process = process
        self._on_discard = on_discard
        self._queue: queue.Queue = queue.Queue(max(1, depth))
        self._errors: list[BaseException] = []
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._closed = False
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is _SENTINEL:
                return
            if self._errors:
                if self._on_discard is not None:
                    self._on_discard(item)
                continue
            try:
                self._process(item)
            except BaseException as exc:  # noqa: BLE001 — re-raised in put/close
                self._errors.append(exc)

    def put(self, item: Any) -> None:
        """Enqueue; blocks at depth (backpressure). Raises the collector's
        pending error rather than feeding a failed pipeline."""
        while True:
            if self._errors:
                raise self._errors[0]
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def close(self, raise_errors: bool = True) -> None:
        if not self._closed:
            self._closed = True
            while True:
                try:
                    self._queue.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    if not self._thread.is_alive():
                        break
            self._thread.join(timeout=30)
        if raise_errors and self._errors:
            raise self._errors[0]


class _Item:
    __slots__ = ("payload", "future")

    def __init__(self, payload: Any):
        self.payload = payload
        self.future: Future = Future()


class ContinuousBatcher:
    """One-lane request coalescer over a two-phase (dispatch/collect) runner."""

    def __init__(
        self,
        cfg: BatcherConfig | None = None,
        *,
        dispatch: Callable[[list], Any],
        collect: Callable[[Any], Sequence],
    ):
        self.cfg = cfg or BatcherConfig()
        self._dispatch = dispatch
        self._collect = collect
        self._queue: queue.Queue = queue.Queue(self.cfg.max_queue)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="continuous-batcher", daemon=True)
        self._pipeline = CollectorPipeline(
            self._finalize_batch, self.cfg.pipeline_depth,
            name="batcher-collector", on_discard=self._discard_batch)
        self._started = False
        self.batches_run = 0
        self.rows_scored = 0

    def start(self) -> "ContinuousBatcher":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._started:
            self._thread.join(timeout=5)
        self._pipeline.close(raise_errors=False)
        # Requests still queued when the launcher stopped get an answer too.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            item.future.set_exception(RuntimeError("batcher stopped"))

    def submit(self, payload: Any) -> Future:
        if self._stop.is_set():
            raise RuntimeError("batcher stopped")
        item = _Item(payload)
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            raise RuntimeError(f"batcher queue full ({self.cfg.max_queue} requests)") from None
        return item.future

    def score_sync(self, payload: Any, timeout: float = 30.0):
        return self.submit(payload).result(timeout=timeout)

    # -- internals -----------------------------------------------------------

    def _loop(self) -> None:
        max_rows = self.cfg.batch_size
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            items = [first]
            flush_at = time.monotonic() + self.cfg.max_wait_ms / 1000.0
            while len(items) < max_rows:
                remaining = flush_at - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    items.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            # Take whatever already arrived, up to the batch size.
            while len(items) < max_rows:
                try:
                    items.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            try:
                handle = self._dispatch([it.payload for it in items])
                # Blocks while pipeline_depth batches are in flight.
                self._pipeline.put((items, handle))
            except Exception as exc:  # noqa: BLE001 — the request futures carry it
                for it in items:
                    if not it.future.done():
                        it.future.set_exception(exc)
            self.batches_run += 1
            self.rows_scored += len(items)

    def _discard_batch(self, item) -> None:
        items, _handle = item
        exc = RuntimeError("batcher pipeline failed")
        for it in items:
            if not it.future.done():
                it.future.set_exception(exc)

    def _finalize_batch(self, item) -> None:
        """Collector side: wait for the batch, then resolve its futures.
        A collect error belongs to the batch's requests, not the pipeline."""
        items, handle = item
        try:
            results = self._collect(handle)
        except Exception as exc:  # noqa: BLE001 — the request futures carry it
            for it in items:
                if not it.future.done():
                    it.future.set_exception(exc)
            return
        for it, res in zip(items, results):
            it.future.set_result(res)


def pad_batch(x: np.ndarray, batch_size: int,
              out: np.ndarray | None = None) -> tuple[np.ndarray, int]:
    """Pad rows with zeros up to the batch shape; returns (padded, n_valid).

    Without ``out`` a full batch is returned as-is. ``out`` is a staging
    buffer of the padded shape (``serve/arena.py``): the rows are written
    into it, the tail zeroed, even when the batch is full, since a pinned
    staging buffer is what lets the copy to the card run asynchronously."""
    n = x.shape[0]
    if n > batch_size:
        raise ValueError(f"batch {n} exceeds batch shape {batch_size}")
    if out is not None:
        if out.shape != (batch_size, *x.shape[1:]) or out.dtype != x.dtype:
            raise ValueError(f"pad buffer {out.shape}/{out.dtype} does not match "
                             f"({batch_size}, *{x.shape[1:]})/{x.dtype}")
        out[:n] = x
        out[n:] = 0
        return out, n
    if n == batch_size:
        return x, n
    padded = np.zeros((batch_size, *x.shape[1:]), dtype=x.dtype)
    padded[:n] = x
    return padded, n
