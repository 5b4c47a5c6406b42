"""Continuous batcher: concurrent Score requests coalesce into one device
batch, in an order the deadline scheduler picks.

The port's counterpart of ``igaming_platform_tpu/serve/batcher.py``:

- requests enqueue with a Future, a priority *lane* and an optional
  per-request :class:`~igaming_platform_tpu_torch.serve.deadline.Deadline`
  into a :class:`~igaming_platform_tpu_torch.serve.deadline.DeadlineScheduler`:
  earliest deadline first within a lane, strict cross-lane aging
  (interactive > bulk > background);
- each tick plans its batch shape and flush window against the tightest
  admitted deadline with the online step-time model
  (``obs/perfmodel.OnlineStepModel``, seeded from the engine's warm-up):
  a near-due queue flushes a small ladder shape now instead of waiting out
  ``max_wait_ms``;
- requests whose deadline expires while queued are shed with
  ``DeadlineExpired`` at assembly, never scored dead;
- dispatch and collect are two phases: ``dispatch(payloads)`` launches the
  device step and starts its device-to-host copy without waiting, and
  ``collect(handle)`` waits for it and builds the results. Collect runs on
  a collector thread with at most ``pipeline_depth`` batches in flight, so
  batch k+1 launches while batch k's results are still coming back;
- a batch whose collect stalls past ``BATCH_HEDGE_MULT`` times the model's
  step time is dispatched again and the two raced, first result wins
  (scoring is pure on the gathered features, so either is bit-exact;
  ``BATCH_HEDGE=0`` opts out); a collect that fails is dispatched again
  synchronously up to ``cfg.device_retries`` times.

Lanes reorder when rows dispatch, never what they score: a row's bits do not
depend on the batch it rides in. Every deadline and timeout here is
``time.monotonic()``.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Callable, Sequence

import numpy as np

from igaming_platform_tpu_torch.core.config import BatcherConfig
from igaming_platform_tpu_torch.serve.deadline import (
    LANE_INTERACTIVE,
    Deadline,
    DeadlineExpired,
    DeadlineScheduler,
    plan_tick,
)

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

    def fail(self, exc: BaseException) -> None:
        """Poison the pipeline: a producer blocked in ``put()`` raises
        ``exc`` instead of waiting forever, and the collector drains
        remaining items through ``on_discard`` without processing them."""
        self._errors.append(exc)

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


class ContinuousBatcher:
    """Request coalescer over the deadline scheduler and a two-phase
    (dispatch/collect) runner.

    ``shapes``/``step_model``/``lane_gate`` opt the batcher into deadline
    planning: the shape ladder the tick planner may choose from, the online
    step-time model it predicts with, and the dispatch gate an interactive
    batch holds while it launches (all three wired by the engine). Without
    them every tick takes the full shape and the full window.
    """

    def __init__(
        self,
        cfg: BatcherConfig | None = None,
        *,
        dispatch: Callable[[list], Any],
        collect: Callable[[Any], Sequence],
        shapes: Sequence[int] | None = None,
        step_model=None,
        lane_gate=None,
    ):
        self.cfg = cfg or BatcherConfig()
        self._dispatch = dispatch
        self._collect = collect
        self.scheduler = DeadlineScheduler(max_queue=self.cfg.max_queue)
        self.step_model = step_model
        self.lane_gate = lane_gate
        self._shapes = tuple(sorted(set(
            int(s) for s in (shapes or ()) if 0 < int(s) <= self.cfg.batch_size
        ))) or (self.cfg.batch_size,)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="continuous-batcher", daemon=True)
        self._pipeline = CollectorPipeline(
            self._finalize_batch, self.cfg.pipeline_depth,
            name="batcher-collector", on_discard=self._discard_batch)
        # Hedged re-dispatch of a stalled window: collect runs on a small
        # pool so a stall past the model's threshold can launch a second
        # dispatch and race it. Inert until the model has evidence.
        self._hedge_enabled = os.environ.get("BATCH_HEDGE", "1") != "0"
        self._hedge_mult = float(os.environ.get("BATCH_HEDGE_MULT", "4"))
        self._hedge_pool: ThreadPoolExecutor | None = None
        self._started = False
        self.batches_run = 0
        self.rows_scored = 0
        self.batches_replayed = 0
        self.batches_hedged = 0
        self.expired_shed = 0
        # Rows that entered a dispatch with their deadline already spent:
        # zero by construction (the assembly shed runs right before
        # dispatch), counted as evidence rather than assumed.
        self.dead_dispatched = 0
        # Observability hooks, set by the serving layer; a failing hook
        # never fails a batch. on_batch(per-request queue waits ms, depth
        # left behind); on_plan(chosen padded shape);
        # on_dispatch_deadlines(remaining_ms list).
        self.on_batch = None
        self.on_plan = None
        self.on_dispatch_deadlines = None

    def start(self) -> "ContinuousBatcher":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.scheduler.close()
        if self._started:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                # The launcher is blocked in pipeline.put() behind a stalled
                # collect: poison the pipeline so put() raises and the
                # launcher fails its in-flight futures.
                self._pipeline.fail(RuntimeError("batcher stopped while collector stalled"))
                self._thread.join(timeout=5)
        # Closed after the launcher has joined: no put can race the
        # sentinel, and every dispatched batch still resolves its futures.
        self._pipeline.close(raise_errors=False)
        if self._hedge_pool is not None:
            self._hedge_pool.shutdown(wait=False)
        # Requests still queued when the launcher stopped get an answer too.
        for it in self.scheduler.drain(self.scheduler.qsize()):
            if not it.future.done():
                it.future.set_exception(RuntimeError("batcher stopped"))

    def submit(self, payload: Any, deadline: Deadline | None = None,
               lane: str = LANE_INTERACTIVE):
        """Enqueue one request. ``deadline=None`` means no deadline: the
        item orders FIFO-like behind its lane's EDF traffic and is never
        shed. Raises RuntimeError once stopped, ``QueueFullError`` at
        capacity and ``DeadlineExpired`` for a spent deadline."""
        if self._stop.is_set():
            raise RuntimeError("batcher stopped")
        return self.scheduler.submit(payload, deadline=deadline, lane=lane)

    def score_sync(self, payload: Any, timeout: float = 30.0,
                   deadline: Deadline | None = None, lane: str = LANE_INTERACTIVE):
        return self.submit(payload, deadline=deadline, lane=lane).result(timeout=timeout)

    # -- internals -----------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            first = self.scheduler.poll(timeout=0.05)
            if first is None:
                continue
            now = time.monotonic()
            plan = plan_tick(shapes=self._shapes, tightest_ms=self._tightest_ms(first, now),
                             max_wait_ms=self.cfg.max_wait_ms, step_model=self.step_model)
            items = [first]
            flush_at = now + plan.window_s
            while len(items) < plan.max_rows:
                remaining = flush_at - time.monotonic()
                if remaining <= 0:
                    break
                nxt = self.scheduler.poll(timeout=remaining)
                if nxt is None:
                    break
                items.append(nxt)
            # Take whatever already arrived, up to the planned rows.
            if len(items) < plan.max_rows:
                items.extend(self.scheduler.drain(plan.max_rows - len(items)))
            # A request whose budget ran out while the window was open is
            # shed, never scored dead.
            items = self._shed_expired(items)
            if not items:
                continue
            self._note_assembly(items, plan)
            try:
                t_dispatch = time.monotonic()
                if self.lane_gate is not None:
                    with self.lane_gate.interactive():
                        handle = self._dispatch([it.payload for it in items])
                else:
                    handle = self._dispatch([it.payload for it in items])
                # Blocks while pipeline_depth batches are in flight.
                self._pipeline.put((items, handle, t_dispatch))
            except Exception as exc:  # noqa: BLE001 — the request futures carry it
                for it in items:
                    if not it.future.done():
                        it.future.set_exception(exc)
            self.batches_run += 1
            self.rows_scored += len(items)

    def _tightest_ms(self, first, now: float) -> float | None:
        """Tightest remaining budget across the popped head and the queue."""
        tightest = self.scheduler.tightest_remaining_ms(now)
        if first.deadline is not None:
            rem = first.deadline.remaining_ms(now)
            tightest = rem if tightest is None else min(tightest, rem)
        return tightest

    def _shed_expired(self, items: list) -> list:
        now = time.monotonic()
        live = [it for it in items if it.deadline is None or not it.deadline.expired(now)]
        if len(live) == len(items):
            return items
        for it in items:
            if it.deadline is not None and it.deadline.expired(now):
                self.expired_shed += 1
                if not it.future.done():
                    it.future.set_exception(DeadlineExpired(
                        f"deadline expired during batch assembly (lane={it.lane})",
                        stage="dispatch"))
                self.scheduler._note_expired(1, "dispatch", it.lane)
        return live

    def _note_assembly(self, items: list, plan) -> None:
        assembled = time.monotonic()
        # Refresh the per-lane depth gauge at assembly too: submits alone
        # would leave it at the last enqueue's depth after a drain.
        if self.scheduler.on_depth is not None:
            for lane, depth in self.scheduler.depths().items():
                self.scheduler._note_depth(lane, depth)
        self.dead_dispatched += sum(
            1 for it in items
            if it.deadline is not None and it.deadline.remaining_ms(assembled) <= 0.0)
        hooks = (
            (self.on_batch, lambda fn: fn([(assembled - it.enqueued_at) * 1000.0 for it in items],
                                          self.scheduler.qsize())),
            (self.on_plan, lambda fn: fn(plan.shape)),
            (self.on_dispatch_deadlines, lambda fn: fn([
                it.deadline.remaining_ms(assembled) for it in items if it.deadline is not None])),
        )
        for fn, call in hooks:
            if fn is not None:
                try:
                    call(fn)
                except Exception:  # noqa: BLE001 — metrics must not fail batches
                    pass

    def _observe_step(self, n_rows: int, ms: float) -> None:
        if self.step_model is not None:
            self.step_model.observe(self._padded_shape(n_rows), ms)

    def _padded_shape(self, n_rows: int) -> int:
        for s in self._shapes:
            if n_rows <= s:
                return s
        return self._shapes[-1]

    def _discard_batch(self, item) -> None:
        """Poisoned-pipeline drain: fail the batch's futures."""
        items, _handle, _t = item
        errors = self._pipeline._errors
        exc = errors[0] if errors else RuntimeError("batcher pipeline failed")
        for it in items:
            if not it.future.done():
                it.future.set_exception(exc)

    # -- collect side ----------------------------------------------------------

    def _collect_hedged(self, items: list, handle):
        """Blocking collect with a stall hedge: once the step model has
        evidence and the collect overruns its stall threshold, the batch is
        dispatched again and the two handles race; the loser is discarded.
        One hedge a batch; without evidence (or ``BATCH_HEDGE=0``) a plain
        blocking collect."""
        threshold_ms = None
        if self._hedge_enabled and self.step_model is not None:
            threshold_ms = self.step_model.stall_threshold_ms(
                self._padded_shape(len(items)), mult=self._hedge_mult)
        if threshold_ms is None:
            return self._collect(handle)
        if self._hedge_pool is None:
            self._hedge_pool = ThreadPoolExecutor(max_workers=2,
                                                  thread_name_prefix="batcher-hedge")
        primary = self._hedge_pool.submit(self._collect, handle)
        try:
            return primary.result(timeout=threshold_ms / 1000.0)
        except (FutureTimeout, TimeoutError):
            pass  # a stalled window: hedge below
        self.batches_hedged += 1
        secondary = self._hedge_pool.submit(
            lambda: self._collect(self._dispatch([it.payload for it in items])))
        pending = {primary, secondary}
        last_exc: BaseException | None = None
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                exc = fut.exception()
                if exc is None:
                    return fut.result()
                last_exc = exc
        raise last_exc  # both the stalled window and the hedge failed

    def _finalize_batch(self, item) -> None:
        """Collector side: wait for the batch (hedged), then resolve its
        futures. A failed collect dispatches the batch again synchronously
        up to ``cfg.device_retries`` times (scoring is pure on the gathered
        features, so a replay is safe); a collect error that remains
        belongs to the batch's requests, not the pipeline."""
        items, handle, t_dispatch = item
        exc: BaseException | None = None
        results = None
        try:
            results = self._collect_hedged(items, handle)
        except Exception as first:  # noqa: BLE001 — retried, then the futures carry it
            exc = first
            for _ in range(max(0, self.cfg.device_retries)):
                try:
                    results = self._collect(self._dispatch([it.payload for it in items]))
                    self.batches_replayed += 1
                    exc = None
                    break
                except Exception as nxt:  # noqa: BLE001
                    exc = nxt
        self._observe_step(len(items), (time.monotonic() - t_dispatch) * 1000.0)
        if exc is not None:
            for it in items:
                if not it.future.done():
                    it.future.set_exception(exc)
            return
        for it, res in zip(items, results):
            if not it.future.done():
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
