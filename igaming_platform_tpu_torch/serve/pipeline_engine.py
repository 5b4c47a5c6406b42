"""Pipelined host engine: stage workers overlap host work with device steps.

The port's counterpart of ``igaming_platform_tpu/serve/pipeline_engine.py``.
It runs the wire ScoreBatch path as a staged pipeline, so the host work of
chunk k+1 overlaps the device step of chunk k and the readback of chunk
k-1:

- **decode/gather** stays on the calling RPC thread (the native one-call
  decode and gather); with several RPCs in flight those calls already run
  beside everything below;
- **stage workers** encode each chunk for the row wire (``WIRE_DTYPE``)
  and pad it into a staging buffer of the wire's dtype from an
  :class:`~igaming_platform_tpu_torch.serve.arena.ArenaPool` (pinned host
  memory on a card) and launch the step without waiting. The launch takes
  the engine's CUDA stream itself: the current stream is per thread, and a
  worker left on its default stream would race the other threads' copies;
- a bounded in-flight window (``depth`` device batches, at least 2) sits
  between dispatch and readback;
- a **readback worker** waits for each chunk's one packed copy back and
  only then releases its staging buffers, through a
  :class:`~igaming_platform_tpu_torch.serve.arena.StagingHold` that also
  waits for the event recorded after the buffers' own copies;
- the native response encode runs back on the submitting thread, so the
  encodes of concurrent RPCs run side by side; the decision ledger's note
  of the RPC (``serve/ledger.py``) runs there too, just before it, with the
  params fingerprint captured with the params at submit.

Results are bit-exact with the lockstep path (``TorchScoringEngine.
_score_rows_encode``): the same chunk boundaries, the same padded shapes,
the same step. ``stats()`` keeps each stage's busy time. The host profiler
hooks and the in-flight gauges of the JAX module are not ported.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any

import numpy as np

from igaming_platform_tpu_torch.serve import ledger as ledger_mod
from igaming_platform_tpu_torch.serve.arena import ArenaPool, StagingHold
from igaming_platform_tpu_torch.serve.batcher import pad_batch
from igaming_platform_tpu_torch.serve.scorer import RESULT_KEYS, _device_readback

_SENTINEL = object()


class _Job:
    """One wire batch moving through the pipeline (one RPC's rows)."""

    __slots__ = ("x", "bl", "include_features", "start", "total", "n_chunks", "parts",
                 "rtms", "future", "done_chunks", "params", "params_fp", "thr", "thr_host",
                 "account_ids")

    def __init__(self, x: np.ndarray, bl: np.ndarray, include_features: bool, start: float,
                 n_chunks: int, snapshot: tuple[Any, str], thresholds: tuple[Any, tuple],
                 account_ids=None):
        self.x = x
        self.bl = bl
        # Captured together at submit: every chunk of the job scores with one
        # tree and one pair of thresholds, and the ledger notes that tree's
        # fingerprint and those thresholds even if a swap or an
        # UpdateThresholds lands before the encode.
        self.params, self.params_fp = snapshot
        self.thr, self.thr_host = thresholds
        self.account_ids = account_ids
        self.include_features = include_features
        self.start = start
        self.total = x.shape[0]
        self.n_chunks = n_chunks
        self.parts: list[dict | None] = [None] * n_chunks
        self.rtms = np.empty((self.total,), dtype=np.int64)
        self.future: Future = Future()
        self.done_chunks = 0

    @property
    def failed(self) -> bool:
        return self.future.done()

    def fail(self, exc: BaseException) -> None:
        if not self.future.done():
            self.future.set_exception(exc)


class HostPipeline:
    """Staged wire-batch scorer over a TorchScoringEngine.

    ``score_rows_to_wire`` is a drop-in for the engine's lockstep
    ``_score_rows_encode``; callers submit concurrently and their chunks
    interleave through the shared workers. A worker never dies on a request
    error: the error lands on that request's future.
    """

    def __init__(self, engine: Any, depth: int = 2, stage_workers: int | None = None,
                 name: str = "host-pipeline"):
        # At least 2 device batches in flight: with one, the readback of
        # batch N gates the dispatch of N+1 and this is the lockstep path.
        self.depth = max(2, int(depth))
        if stage_workers is None:
            stage_workers = int(os.environ.get("PIPELINE_STAGE_WORKERS", "2"))
        self.stage_workers = max(1, stage_workers)
        self._engine = engine
        self._pinned = engine.device.type == "cuda"
        self._arena = ArenaPool(max_per_key=self.depth + self.stage_workers + 1,
                                pin_memory=self._pinned)
        self._stage_q: queue.Queue = queue.Queue(max(8, 4 * self.depth))
        self._inflight_q: queue.Queue = queue.Queue(self.depth)
        self._stage_alive = self.stage_workers  # guarded by _stats_lock
        self._closed = False
        self._close_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._busy_s = {"dispatch": 0.0, "readback": 0.0, "encode": 0.0}
        self._stage_threads = [
            threading.Thread(target=self._stage_loop, name=f"{name}-stage-{i}", daemon=True)
            for i in range(self.stage_workers)
        ]
        self._readback_worker = threading.Thread(
            target=self._readback_loop, name=f"{name}-readback", daemon=True)
        for t in self._stage_threads:
            t.start()
        self._readback_worker.start()

    # -- stats ---------------------------------------------------------------

    def _note_busy(self, stage: str, seconds: float) -> None:
        with self._stats_lock:
            self._busy_s[stage] += seconds

    def stats(self) -> dict:
        """Busy milliseconds per stage (the stages overlap, so they may sum
        past the wall time) and the arena's reuse."""
        with self._stats_lock:
            busy = {k: v * 1000.0 for k, v in self._busy_s.items()}
        return {"stage_busy_ms": busy, "arena": self._arena.stats()}

    # -- submission ----------------------------------------------------------

    def score_rows_to_wire(self, x: np.ndarray, bl: np.ndarray, include_features: bool,
                           start: float, account_ids=None) -> bytes:
        """Gathered [N, 30] rows -> ScoreBatchResponse wire bytes through the
        workers. Blocks the caller until its batch is back, then notes it to
        the engine's ledger and encodes on this thread."""
        if self._closed:
            raise RuntimeError("host pipeline is closed")
        total = x.shape[0]
        if total == 0:
            return b""
        batch = self._engine.batch_size
        n_chunks = (total + batch - 1) // batch
        job = _Job(x, bl, include_features, start, n_chunks, self._engine.params_snapshot(),
                   self._engine.thresholds_snapshot(), account_ids)
        for idx, lo in enumerate(range(0, total, batch)):
            # Blocks when the stage queue is full: backpressure on the caller.
            self._stage_q.put((job, idx, lo, min(lo + batch, total)))
        job.future.result()  # every chunk read back, or the job failed
        return self._encode_job(job)

    def _encode_job(self, job: _Job) -> bytes:
        from igaming_platform_tpu_torch.serve.wire import encode_score_batch

        t0 = time.monotonic()
        try:
            cat = {k: np.concatenate([p[k] for p in job.parts]) for k in RESULT_KEYS}
            ledger_mod.note_decisions(self._engine, cat, n=job.total, wire_mode="wire_row",
                                      x=job.x, bl=job.bl, account_ids=job.account_ids,
                                      params_fp=job.params_fp, thresholds=job.thr_host)
            return encode_score_batch(
                cat["score"], cat["action"], cat["reason_mask"], cat["rule_score"],
                cat["ml_score"], job.rtms, job.x if job.include_features else None)
        finally:
            self._note_busy("encode", time.monotonic() - t0)

    # -- stage workers: pad into arenas + launch -------------------------------

    def _dispatch_chunk(self, job: _Job, lo: int, hi: int):
        """Pad one chunk into staging buffers and launch it; returns the
        launch handle and the hold on the buffers (None when the chunk went
        as it was). On a card every chunk is staged, since only a pinned
        buffer copies asynchronously."""
        n = hi - lo
        chunk, blc = job.x[lo:hi], job.bl[lo:hi]
        if self._engine._wire_encode is not None:
            # The row wire's encode (WIRE_DTYPE), before padding: the staging
            # buffers take the wire's dtype.
            chunk = self._engine._wire_encode(chunk)
        shape = self._engine._pick_shape(n)
        if n == shape and not self._pinned:
            return self._engine._launch_padded(chunk, blc, n, job.params, thr=job.thr), None
        xp = self._arena.acquire((shape, chunk.shape[1]), chunk.dtype)
        blp = self._arena.acquire((shape,), np.bool_)
        pad_batch(chunk, shape, out=xp)
        pad_batch(blc, shape, out=blp)
        hold = StagingHold(self._arena, (xp, blp))
        try:
            return self._engine._launch_padded(xp, blp, n, job.params, hold=hold,
                                               thr=job.thr), hold
        except BaseException:
            hold.release()
            raise

    def _stage_loop(self) -> None:
        while True:
            item = self._stage_q.get()
            if item is _SENTINEL:
                # The last stage worker to exit forwards the sentinel, so the
                # readback worker outlives every producer.
                with self._stats_lock:
                    self._stage_alive -= 1
                    last = self._stage_alive == 0
                if last:
                    self._inflight_q.put(_SENTINEL)
                return
            job, idx, lo, hi = item
            if job.failed:
                continue
            t0 = time.monotonic()
            try:
                handle, hold = self._dispatch_chunk(job, lo, hi)
            except BaseException as exc:  # noqa: BLE001 — belongs to the job
                job.fail(exc)
                continue
            finally:
                self._note_busy("dispatch", time.monotonic() - t0)
            # Blocks at `depth` batches in flight: the device stays at most
            # depth steps ahead of readback.
            self._inflight_q.put((job, idx, lo, handle, hold))

    # -- readback worker -----------------------------------------------------

    def _readback_loop(self) -> None:
        while True:
            item = self._inflight_q.get()
            if item is _SENTINEL:
                return
            job, idx, lo, handle, hold = item
            t0 = time.monotonic()
            try:
                host = _device_readback(handle)
            except BaseException as exc:  # noqa: BLE001 — belongs to the job
                job.fail(exc)
                host = None
            finally:
                self._note_busy("readback", time.monotonic() - t0)
                # The step has consumed its inputs: only now may the staging
                # buffers be rewritten.
                if hold is not None:
                    hold.release()
            if host is None or job.failed:
                continue
            n = handle[2]
            job.parts[idx] = host
            job.rtms[lo:lo + n] = int((time.monotonic() - job.start) * 1000.0)
            job.done_chunks += 1
            if job.done_chunks == job.n_chunks:
                job.future.set_result(None)  # the caller's thread encodes

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Drain both workers and join them. Idempotent; queued jobs finish
        first (their chunks are ahead of the sentinel)."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        for _ in self._stage_threads:
            self._stage_q.put(_SENTINEL)
        for t in self._stage_threads:
            t.join(timeout=30)
        self._readback_worker.join(timeout=30)
