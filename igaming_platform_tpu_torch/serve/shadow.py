"""Shadow scoring: candidate params score the live stream beside production.

Counterpart of ``igaming_platform_tpu/serve/shadow.py``. A candidate param
set (same backend and layout as production) scores every batch production
scores, and the shadow keeps the evidence a promotion needs: how often the
candidate would have changed the action, and by how much its scores
differ. The shadow can never change, delay or fail a production answer:

- **fused** (the default): the engine scores the candidate in the step's
  own enqueue on its stream, on the same rows (``TorchScoringEngine.
  _step_variants``, and the session step's shadow variant, which folds the
  candidate with the same head result), and hands both packed results
  here (:meth:`submit_scored`); the worker copies them back after the CUDA
  event recorded after the step and diffs them;
- **split** (``FUSED=0`` or ``SHADOW_FUSED=0``): the engine hands the
  device copy of the batch as it crossed the wire (:meth:`submit_echo`)
  and the worker runs the candidate's step on it, on the engine's stream,
  dequantizing int8 wire codes as production did; index-path rows have no
  such copy and are counted as skipped;
- every ``submit_*`` is an O(1) bounded enqueue: past ``queue_max_rows``
  the batch is dropped and counted, never waited for;
- a candidate change (``set_candidate``) bumps a generation: batches of an
  earlier candidate still queued are dropped as stale, and the evidence
  window restarts.

The candidate's outputs for a batch equal offline scoring of the rows
production scored with the candidate params (same function, same rows,
int8 wire included). ``report()`` is the ``/debug/shadowz`` payload; a
``metrics=`` registry gets the ``shadow_*`` families. The supervisor points
the scorer at a rebuilt engine with ``rebind_engine``. Not ported yet: the
host profiler's thread registration.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from igaming_platform_tpu_torch.convert import params_to
from igaming_platform_tpu_torch.models.ensemble import make_score_fn
from igaming_platform_tpu_torch.serve.batcher import pad_batch
from igaming_platform_tpu_torch.serve.scorer import (
    _stack_packed,
    _unpack_host,
    decode_wire,
    params_fingerprint,
)

logger = logging.getLogger(__name__)

_ACTION_NAMES = {1: "approve", 2: "review", 3: "block"}


def _new_stats() -> dict:
    return {
        "batches": 0,
        "rows": 0,
        "flips": 0,
        "flips_by_direction": {},
        "score_delta_sum": 0.0,
        "score_delta_max": 0,
        "ml_delta_sum": 0.0,
        "ml_delta_max": 0.0,
    }


class ShadowScorer:
    """Score the live stream with candidate params next to production.

    The ``submit_*`` entries append references to a bounded deque under a
    short lock and return; they never raise and never block. The copies
    back to the host, the split layout's step and the diff run on the
    worker thread.
    """

    def __init__(self, engine, candidate_params: Any = None, *, backend: str | None = None,
                 queue_max_rows: int | None = None, metrics=None,
                 on_result: Callable[[dict, dict, int], None] | None = None):
        self._engine = engine
        self._metrics = metrics
        self.backend = backend or getattr(engine, "ml_backend", "mock")
        # The split layout's step: the serving function of the backend, on
        # the engine's device.
        self._fn = make_score_fn(engine.config, self.backend, device=engine.device)
        self._candidate = params_to(candidate_params, engine.device)
        self.candidate_fp = params_fingerprint(self._candidate)
        self.queue_max_rows = queue_max_rows or int(
            os.environ.get("SHADOW_QUEUE_MAX_ROWS", "16384"))
        # Called as (candidate_out, production_out, n) after each shadow
        # batch, on the worker thread.
        self.on_result = on_result

        self._cv = threading.Condition()
        self._pending: deque = deque()
        self._pending_rows = 0
        self._working = False  # the worker holds a popped batch
        self._stopping = False
        self._generation = 0  # bumped on set_candidate: stale batches drop

        # Stats (guarded by _cv): lifetime, and a window reset on every
        # candidate change.
        self.total = _new_stats()
        self.window = _new_stats()
        self.rows_dropped = 0
        self.rows_skipped_no_snapshot = 0
        self.errors = 0
        self._started_at = time.monotonic()
        self._last_scored_at: float | None = None
        self.fused_batches = 0
        # Steps the worker ran itself on the split layout (each launches the
        # backend's kernels once).
        self.split_steps = 0

        self._thread = threading.Thread(target=self._worker, name="shadow-scorer", daemon=True)
        self._thread.start()
        if self._candidate is not None:
            self._notify_engine()

    # -- hot-path entries ----------------------------------------------------

    def _try_enqueue(self, item: tuple, n: int) -> bool:
        """Bounded O(1) enqueue shared by every submit: a full queue, a
        stopped scorer or no candidate drops (counted). The generation tag
        (item[1]) is stamped under the lock that checks the candidate, when
        the caller passes None."""
        with self._cv:
            if (self._stopping or self._candidate is None
                    or self._pending_rows + n > self.queue_max_rows):
                self.rows_dropped += n
                dropped = True
            else:
                if item[1] is None:
                    item = (item[0], self._generation) + item[2:]
                self._pending.append(item)
                self._pending_rows += n
                dropped = False
                self._cv.notify()
        if dropped and self._metrics is not None:
            self._metrics.shadow_rows_total.inc(n, outcome="dropped")
        return not dropped

    def submit(self, out: dict, *, x: np.ndarray | None, bl: np.ndarray | None, n: int) -> bool:
        """Host-rows entry (for harnesses): one production-scored batch
        (``out``, a dict of host arrays) with its float32 feature rows; the
        worker pads, copies and scores them. Returns False when dropped."""
        try:
            if x is None:
                with self._cv:
                    self.rows_skipped_no_snapshot += n
                return False
            return self._try_enqueue(("xhost", None, out, x, bl, n, self._engine._thresholds), n)
        except Exception:  # noqa: BLE001 — the shadow must never fail scoring; counted
            self.note_error()
            return False

    def submit_scored(self, prod_out: torch.Tensor, cand_out: torch.Tensor, n: int,
                      gen: int | None, ready=None) -> bool:
        """Fused entry: both packed [5, B] results come from one step;
        ``ready`` is the CUDA event recorded after it (None on the CPU)."""
        try:
            return self._try_enqueue(("scored", gen, prod_out, cand_out, n, ready), n)
        except Exception:  # noqa: BLE001 — the shadow must never fail scoring; counted
            self.note_error()
            return False

    def submit_echo(self, prod_out: torch.Tensor, echo: torch.Tensor, blp: torch.Tensor, n: int,
                    thresholds: torch.Tensor, ready=None) -> bool:
        """Split entry: the device copy of the padded batch as it crossed the
        wire, its blacklist and thresholds; the worker scores the candidate
        on it. The tensors stay referenced by the queue until then."""
        try:
            return self._try_enqueue(("echo", None, prod_out, echo, blp, n, thresholds, ready), n)
        except Exception:  # noqa: BLE001 — the shadow must never fail scoring; counted
            self.note_error()
            return False

    def note_skipped(self, n: int) -> None:
        """Rows a scoring path could not shadow-score (index-path rows on the
        split layout): counted, never silent."""
        with self._cv:
            self.rows_skipped_no_snapshot += n

    def note_error(self) -> None:
        with self._cv:
            self.errors += 1

    # -- candidate management ------------------------------------------------

    def active_state(self) -> tuple[int, Any] | None:
        """(generation, candidate params on the engine's device) while a
        candidate is installed and the scorer is live; the engine's step
        reads it to score the candidate in its own enqueue."""
        with self._cv:
            if self._stopping or self._candidate is None:
                return None
            return self._generation, self._candidate

    def set_candidate(self, params: Any) -> str:
        """Install a new candidate (copied to the engine's device first);
        resets the evidence window, drops queued batches of the old one as
        stale, and tells the engine. Returns the candidate's fingerprint."""
        installed = params_to(params, self._engine.device)
        fp = params_fingerprint(installed)
        with self._cv:
            self._candidate = installed
            self.candidate_fp = fp
            self._generation += 1
            self.window = _new_stats()
        if installed is not None:
            self._notify_engine()
        return fp

    def rebind_engine(self, engine) -> None:
        """Point the shadow at a rebuilt engine and tell it of the sitting
        candidate."""
        self._engine = engine
        if self.candidate_params is not None:
            self._notify_engine()

    def _notify_engine(self) -> None:
        hook = getattr(self._engine, "_on_shadow_candidate", None)
        if hook is not None:
            hook(self)

    @property
    def candidate_params(self) -> Any:
        with self._cv:
            return self._candidate

    def window_rows(self) -> int:
        with self._cv:
            return self.window["rows"]

    def flip_rate(self) -> float:
        """Action-flip fraction over the current candidate's window."""
        with self._cv:
            rows = self.window["rows"]
            return self.window["flips"] / rows if rows else 0.0

    # -- worker --------------------------------------------------------------

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stopping:
                    self._cv.wait(timeout=0.1)
                if self._stopping and not self._pending:
                    return
                item = self._pending.popleft()
                n = item[4] if item[0] == "scored" else item[5]
                self._pending_rows -= n
                params = self._candidate
                current_gen = self._generation
                self._working = True
            try:
                kind, gen = item[0], item[1]
                if gen == current_gen and params is not None:
                    if kind == "scored":
                        _k, _g, prod_out, cand_out, _n, ready = item
                        cand = self._readback(cand_out, n, ready)
                        prod = self._readback(prod_out, n, ready)
                        with self._cv:
                            self.fused_batches += 1
                    elif kind == "echo":
                        _k, _g, prod_out, echo, blp, _n, thresholds, ready = item
                        cand = self._score_device(params, echo, blp, n, thresholds)
                        prod = self._readback(prod_out, n, ready)
                    else:
                        _k, _g, prod, x, bl, _n, thresholds = item
                        cand = self._score_host(params, x, bl, n, thresholds)
                    self._diff(prod, cand, n)
                    hook = self.on_result
                    if hook is not None:
                        hook(cand, prod, n)
            except Exception:  # noqa: BLE001 — counted; never reaches serving
                with self._cv:
                    self.errors += 1
                logger.warning("shadow scoring failed (batch of %d rows skipped)", n,
                               exc_info=True)
            finally:
                del item
                with self._cv:
                    self._working = False

    @staticmethod
    def _readback(packed: torch.Tensor, n: int, ready) -> dict:
        """A packed [5, B] result's first ``n`` columns on the host, copied
        after ``ready`` (the CUDA event recorded after the step wrote it)."""
        if ready is not None:
            ready.synchronize()
        host = _unpack_host(packed.cpu().numpy())
        return {k: v[:n] for k, v in host.items()}

    def _score_device(self, params, x: torch.Tensor, blp: torch.Tensor, n: int,
                      thresholds: torch.Tensor) -> dict:
        """One candidate step over a device batch in the wire's dtype, on the
        engine's stream (after the production step that copied it there)."""
        engine = self._engine
        with engine._on_stream(), torch.inference_mode():
            packed = _stack_packed(self._fn(params, decode_wire(x), blp, thresholds))
            done = engine._record_event()
        with self._cv:
            self.split_steps += 1
        return self._readback(packed, n, done)

    def _score_host(self, params, x: np.ndarray, bl: np.ndarray | None, n: int,
                    thresholds: torch.Tensor) -> dict:
        """Host rows padded to the engine's shape ladder, copied and scored."""
        x32 = np.ascontiguousarray(x[:n], dtype=np.float32)
        blv = (np.ascontiguousarray(bl[:n], dtype=bool) if bl is not None
               else np.zeros((n,), dtype=bool))
        shape = self._engine._pick_shape(n)
        xp, _ = pad_batch(x32, shape)
        blp, _ = pad_batch(blv, shape)
        device = self._engine.device
        return self._score_device(params, torch.from_numpy(xp).to(device),
                                  torch.from_numpy(blp).to(device), n, thresholds)

    def _diff(self, prod: dict, cand: dict, n: int) -> None:
        prod_action = np.asarray(prod["action"][:n], dtype=np.int64)
        cand_action = np.asarray(cand["action"], dtype=np.int64)
        flips = prod_action != cand_action
        flip_count = int(flips.sum())
        d_score = np.abs(np.asarray(prod["score"][:n], np.int64)
                         - np.asarray(cand["score"], np.int64))
        d_ml = np.abs(np.asarray(prod["ml_score"][:n], np.float64)
                      - np.asarray(cand["ml_score"], np.float64))
        directions: dict[str, int] = {}
        if flip_count:
            for p, c in zip(prod_action[flips], cand_action[flips]):
                key = (f"{_ACTION_NAMES.get(int(p), int(p))}->"
                       f"{_ACTION_NAMES.get(int(c), int(c))}")
                directions[key] = directions.get(key, 0) + 1
        with self._cv:
            for stats in (self.total, self.window):
                stats["batches"] += 1
                stats["rows"] += n
                stats["flips"] += flip_count
                stats["score_delta_sum"] += float(d_score.sum())
                stats["score_delta_max"] = max(stats["score_delta_max"],
                                               int(d_score.max(initial=0)))
                stats["ml_delta_sum"] += float(d_ml.sum())
                stats["ml_delta_max"] = max(stats["ml_delta_max"], float(d_ml.max(initial=0.0)))
                for key, c in directions.items():
                    by_dir = stats["flips_by_direction"]
                    by_dir[key] = by_dir.get(key, 0) + c
            self._last_scored_at = time.monotonic()
        if self._metrics is not None:
            self._metrics.shadow_rows_total.inc(n, outcome="scored")
            if flip_count:
                self._metrics.shadow_action_flips_total.inc(flip_count)
            self._metrics.shadow_score_divergence.observe_many(d_score)

    # -- reporting / lifecycle -----------------------------------------------

    @staticmethod
    def _stats_view(stats: dict) -> dict:
        rows = stats["rows"]
        return {
            "batches": stats["batches"],
            "rows": rows,
            "action_flips": stats["flips"],
            "flip_rate": round(stats["flips"] / rows, 6) if rows else 0.0,
            "flips_by_direction": dict(stats["flips_by_direction"]),
            "score_delta_mean": (round(stats["score_delta_sum"] / rows, 4) if rows else 0.0),
            "score_delta_max": stats["score_delta_max"],
            "ml_delta_mean": (round(stats["ml_delta_sum"] / rows, 6) if rows else 0.0),
            "ml_delta_max": round(stats["ml_delta_max"], 6),
        }

    def report(self) -> dict:
        """The shadow half of the ``/debug/shadowz`` payload."""
        with self._cv:
            total = self._stats_view(self.total)
            window = self._stats_view(self.window)
            snap = {
                "backend": self.backend,
                "candidate_fp": self.candidate_fp,
                "production_fp": getattr(self._engine, "params_fingerprint", None),
                "queue_rows": self._pending_rows,
                "queue_max_rows": self.queue_max_rows,
                "rows_dropped": self.rows_dropped,
                "rows_skipped_no_snapshot": self.rows_skipped_no_snapshot,
                # Batches whose candidate result came from the production
                # step itself, against the split layout's.
                "fused_batches": self.fused_batches,
                "errors": self.errors,
                "uptime_s": round(time.monotonic() - self._started_at, 3),
                "last_scored_age_s": (round(time.monotonic() - self._last_scored_at, 3)
                                      if self._last_scored_at is not None else None),
            }
        snap["total"] = total
        snap["window"] = window
        return snap

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until every queued batch has been scored. False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cv:
                if not self._pending and not self._working:
                    return True
            time.sleep(0.005)
        return False

    def close(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._thread.join(timeout=10.0)
