"""Online learning: mine the decision WAL, train incrementally, in place.

Counterpart of ``igaming_platform_tpu/train/online.py``. The scoring stream
feeds a learner on the same card as serving instead of an offline train,
export and redeploy cycle:

- ``LedgerMiner`` tails the decision WAL (``serve/ledger.py`` segments)
  with an incremental cursor, joining outcome side-records (``decision_id
  -> label``) to the decisions' feature snapshots. It yields labelled
  examples with the ones that matter flagged: hard negatives (scored risky,
  legitimate in truth) and hard positives (missed fraud).
- ``OnlineLearner`` feeds them to the multitask trainer
  (``train/trainer.py``): each step's batch mixes mined rows (hard ones
  oversampled) with fresh labelled synthetic rows (``train/fraudgen.py``),
  so a thin mined stream cannot collapse the model onto a few disputed
  rows. On a card its steps run on a stream of its own, beside the
  engine's. Its ``candidate()`` is a host copy taken after the step that
  made it has finished: the optimizer updates the weights in place, so a
  live reference would change under the shadow.
- ``OnlineLoop`` is the ticker: mine, train, hand the candidate to the
  shadow scorer (``serve/shadow.py``), run the promotion controller's tick
  (``train/promote.py``). One thread, bounded work a tick; ``report()``
  feeds ``/debug/shadowz``.

Environment knobs: ``MINER_PENDING_MAX``; ``ONLINE_TRUNK``,
``ONLINE_BATCH``, ``ONLINE_MINED_FRAC`` and ``ONLINE_RESERVOIR_MAX`` (the
learner); ``ONLINE_TICK_S``, ``ONLINE_STEPS_PER_TICK`` and
``ONLINE_MIN_EXAMPLES`` (the loop). ``metrics=`` (an ``obs/metrics.py``
``ServiceMetrics``) feeds the ``online_*`` counters.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from igaming_platform_tpu_torch.core.features import NUM_FEATURES
from igaming_platform_tpu_torch.obs import drift as drift_mod
from igaming_platform_tpu_torch.serve import ledger as ledger_mod
from igaming_platform_tpu_torch.train.data import Batch, make_aux_targets
from igaming_platform_tpu_torch.train.fraudgen import generate_labeled
from igaming_platform_tpu_torch.train.trainer import TrainConfig, Trainer

logger = logging.getLogger(__name__)


@dataclass
class MinedExamples:
    """One miner pass's yield: labelled rows and provenance counters."""

    x: np.ndarray  # [n, NUM_FEATURES] float32 snapshots
    y: np.ndarray  # [n] float32 labels (0 legit / 1 fraud)
    hard: np.ndarray  # [n] bool: hard negative or hard positive
    decision_ids: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)
    # The decision's served score per example: drift's calibration feed.
    scores: np.ndarray = field(default_factory=lambda: np.empty((0,), np.float32))

    @property
    def n(self) -> int:
        return int(self.x.shape[0])


class LedgerMiner:
    """Incremental hard-example miner over a decision-ledger directory.

    ``poll()`` scans only frames appended since the last call (cursor:
    segment seq and byte offset). Decisions with a feature snapshot wait in
    a bounded pending window for their outcome; outcomes join by decision id
    and emit labelled examples.
    """

    def __init__(self, directory: str, *, pending_max: int | None = None, metrics=None):
        self.directory = directory
        self._metrics = metrics
        self.pending_max = pending_max or int(os.environ.get("MINER_PENDING_MAX", "65536"))
        self._cursor = {"seq": -1, "offset": 0}
        # decision_id -> (features, score, review_threshold), oldest first.
        self._pending: OrderedDict[str, tuple] = OrderedDict()
        self.stats = {
            "frames_scanned": 0,
            "decisions_seen": 0,
            "decisions_snapshotless": 0,
            "outcomes_seen": 0,
            "outcomes_unmatched": 0,
            "mined_total": 0,
            "hard_negatives": 0,
            "hard_positives": 0,
            "pending_evicted": 0,
            "promotions_seen": 0,
        }

    def _new_frames(self):
        """Frames appended since the cursor, advancing it."""
        cur = self._cursor
        for seq, path in ledger_mod.ledger_segments(self.directory):
            if seq < cur["seq"]:
                continue
            start = cur["offset"] if seq == cur["seq"] else 0
            for payload, end in ledger_mod.iter_segment_frames(path, start):
                yield payload
                cur["seq"], cur["offset"] = seq, end

    def poll(self) -> MinedExamples:
        """Mine every frame appended since the last poll."""
        xs: list[np.ndarray] = []
        ys: list[float] = []
        hard: list[bool] = []
        ids: list[str] = []
        scs: list[float] = []
        s = self.stats
        for payload in self._new_frames():
            s["frames_scanned"] += 1
            try:
                kind, rec = ledger_mod.decode_entry(payload)
            except ledger_mod.LedgerSchemaError:
                logger.warning("miner: undecodable ledger frame skipped", exc_info=True)
                continue
            if kind == "decision":
                s["decisions_seen"] += 1
                if rec.features is None:
                    s["decisions_snapshotless"] += 1
                    continue
                self._pending[rec.decision_id] = (rec.features, rec.score, rec.review_threshold)
                while len(self._pending) > self.pending_max:
                    self._pending.popitem(last=False)
                    s["pending_evicted"] += 1
            elif kind == "promotion":
                s["promotions_seen"] += 1
            elif kind == "outcome":
                s["outcomes_seen"] += 1
                pend = self._pending.pop(rec.decision_id, None)
                if pend is None:
                    s["outcomes_unmatched"] += 1
                    continue
                features, score, review_thr = pend
                # The examples worth their bytes: confident and wrong.
                is_hard_neg = rec.label == 0 and score >= review_thr
                is_hard_pos = rec.label == 1 and score < review_thr
                xs.append(np.asarray(features, np.float32))
                ys.append(float(rec.label))
                hard.append(is_hard_neg or is_hard_pos)
                ids.append(rec.decision_id)
                scs.append(float(score))
                s["mined_total"] += 1
                if is_hard_neg:
                    s["hard_negatives"] += 1
                if is_hard_pos:
                    s["hard_positives"] += 1
        x = np.stack(xs) if xs else np.empty((0, NUM_FEATURES), np.float32)
        mined = MinedExamples(
            x=x, y=np.asarray(ys, np.float32), hard=np.asarray(hard, bool), decision_ids=ids,
            counts={"hard_negatives": s["hard_negatives"], "hard_positives": s["hard_positives"]},
            scores=np.asarray(scs, np.float32))
        if self._metrics is not None and mined.n:
            n_hard = int(mined.hard.sum())
            self._metrics.online_mined_total.inc(mined.n - n_hard, kind="labeled")
            self._metrics.online_mined_total.inc(n_hard, kind="hard")
        return mined


class OnlineLearner:
    """Incremental trainer over mined examples and synthetic base replay.

    A bounded reservoir holds mined rows (hard examples carry a sampling
    weight); each step draws ``mined_frac`` of its batch from the reservoir
    and the rest from the labelled generator. It runs the stock ``Trainer``,
    so a candidate is a real serving tree.
    """

    def __init__(self, *, trunk: tuple[int, ...] | None = None, batch_size: int | None = None,
                 seed: int = 0, mined_frac: float | None = None, hard_weight: float = 4.0,
                 reservoir_max: int | None = None, metrics=None,
                 device: str | torch.device = "cuda"):
        self._metrics = metrics
        if trunk is None:
            trunk = tuple(int(t) for t in os.environ.get("ONLINE_TRUNK", "64,64").split(",") if t)
        if batch_size is None:
            batch_size = int(os.environ.get("ONLINE_BATCH", "256"))
        if mined_frac is None:
            mined_frac = float(os.environ.get("ONLINE_MINED_FRAC", "0.5"))
        dev = torch.device(device)
        # On a card the learner's steps take a stream of their own.
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.trainer = Trainer(TrainConfig(batch_size=batch_size, trunk=trunk, seed=seed),
                               device=dev, stream=stream)
        self.mined_frac = float(mined_frac)
        self.hard_weight = float(hard_weight)
        self.reservoir_max = reservoir_max or int(os.environ.get("ONLINE_RESERVOIR_MAX", "16384"))
        self._rng = np.random.default_rng(seed + 1)
        self._res_x = np.empty((0, NUM_FEATURES), np.float32)
        self._res_y = np.empty((0,), np.float32)
        self._res_w = np.empty((0,), np.float64)
        self.examples_ingested = 0
        self.steps_total = 0
        self.last_metrics: dict[str, float] = {}

    def ingest(self, mined: MinedExamples) -> None:
        if mined.n == 0:
            return
        w = np.where(mined.hard, self.hard_weight, 1.0)
        self._res_x = np.concatenate([self._res_x, mined.x])[-self.reservoir_max:]
        self._res_y = np.concatenate([self._res_y, mined.y])[-self.reservoir_max:]
        self._res_w = np.concatenate([self._res_w, w])[-self.reservoir_max:]
        self.examples_ingested += mined.n

    @property
    def reservoir_size(self) -> int:
        return int(self._res_x.shape[0])

    def _batch(self) -> Batch:
        bs = self.trainer.cfg.batch_size
        n_mined = min(int(bs * self.mined_frac), self.reservoir_size)
        xb, yb, _ = generate_labeled(self._rng, bs - n_mined)
        parts_x, parts_y = [xb], [yb.astype(np.float32)]
        if n_mined:
            p = self._res_w / self._res_w.sum()
            idx = self._rng.choice(self.reservoir_size, n_mined, p=p)
            parts_x.append(self._res_x[idx])
            parts_y.append(self._res_y[idx])
        x = np.concatenate(parts_x)
        y = np.concatenate(parts_y)
        ltv_t, churn_t = make_aux_targets(x)
        return Batch(x=x, fraud=y, ltv=ltv_t, churn=churn_t)

    def train_steps(self, steps: int) -> dict[str, float]:
        """``steps`` incremental steps, double-buffered as ``fit`` is; the
        metrics are read back once, at the end."""
        if steps <= 0:
            return self.last_metrics
        pending = self.trainer.put_batch(self._batch(), side=True)
        metrics_dev = None
        for i in range(steps):
            current = pending
            if i + 1 < steps:
                pending = self.trainer.put_batch(self._batch(), side=True)
            metrics_dev = self.trainer.train_step_device(current)
        self.steps_total += steps
        if self._metrics is not None:
            self._metrics.online_train_steps_total.inc(steps)
        self.last_metrics = self.trainer.materialize_metrics(metrics_dev)
        return self.last_metrics

    def candidate(self) -> dict:
        """The serving-shaped candidate (``{"multitask": MultiTask}``), a host
        copy made after the learner's stream has finished its last step."""
        return {"multitask": self.trainer.export_params().to("cpu")}


class OnlineLoop:
    """The closed loop: mine, train, shadow, gate, and maybe promote.

    One background ticker thread; each tick does a bounded amount of work.
    ``report()`` is the ``/debug/shadowz`` payload across the miner, the
    learner, the shadow and the promotion controller.
    """

    def __init__(self, *, miner: LedgerMiner, learner: OnlineLearner, shadow, controller,
                 tick_s: float | None = None, steps_per_tick: int | None = None,
                 min_examples_to_train: int | None = None):
        self.miner = miner
        self.learner = learner
        self.shadow = shadow
        self.controller = controller
        self.tick_s = tick_s if tick_s is not None else float(
            os.environ.get("ONLINE_TICK_S", "2.0"))
        self.steps_per_tick = steps_per_tick or int(os.environ.get("ONLINE_STEPS_PER_TICK", "20"))
        self.min_examples_to_train = (
            min_examples_to_train if min_examples_to_train is not None
            else int(os.environ.get("ONLINE_MIN_EXAMPLES", "64")))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.ticks = 0
        self.last_tick_ms: float | None = None
        self.last_tick_split_ms: dict[str, float] = {}
        self._lock = threading.Lock()
        # One tick at a time: the ticker thread and POST /debug/promotion.
        self._tick_lock = threading.Lock()

    def tick(self) -> dict:
        """One loop iteration (also the test and operator entry).

        The controller judges the sitting candidate, with the evidence
        window it gathered, before the candidate is refreshed; the refresh
        happens only when the sitting candidate is absent, already serving,
        or has a full evidence window. Refreshing every tick would restart
        the window each time and the rows-floor gate could never pass."""
        with self._tick_lock:
            marks = [time.monotonic()]
            mined = self.miner.poll()
            if mined.n:
                # Calibration feed: every (served score, outcome) pair joined.
                drift = drift_mod.get_default()
                if drift is not None:
                    drift.note_outcomes(mined.scores, mined.y)
            self.learner.ingest(mined)
            marks.append(time.monotonic())
            trained = False
            if self.learner.examples_ingested >= self.min_examples_to_train:
                self.learner.train_steps(self.steps_per_tick)
                trained = True
            marks.append(time.monotonic())
            verdict = self.controller.tick()
            marks.append(time.monotonic())
            if trained:
                min_rows = getattr(getattr(self.controller, "gates", None), "min_shadow_rows", 0)
                serving_fp = getattr(self.controller.engine, "params_fingerprint", None)
                if (self.shadow.candidate_params is None
                        or self.shadow.candidate_fp == serving_fp
                        or self.shadow.window_rows() >= min_rows):
                    self.shadow.set_candidate(self.learner.candidate())
            marks.append(time.monotonic())
            with self._lock:
                self.ticks += 1
                self.last_tick_ms = round((marks[-1] - marks[0]) * 1000.0, 3)
                # Where the tick went: mine, train, the controller, the refresh.
                self.last_tick_split_ms = {
                    stage: round((b - a) * 1000.0, 3) for stage, a, b in zip(
                        ("mine", "train", "controller", "refresh"), marks, marks[1:])}
            return {"mined": mined.n, "trained": trained, "controller": verdict,
                    "tick_ms": self.last_tick_ms}

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop outlives a bad tick; logged
                logger.warning("online-loop tick failed", exc_info=True)
            self._stop.wait(self.tick_s)

    def start(self) -> "OnlineLoop":
        if self._thread is not None:
            raise RuntimeError("the online loop is already running")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="online-loop", daemon=True)
        self._thread.start()
        return self

    def stop(self, close_shadow: bool = True) -> None:
        """Stop the ticker; ``close_shadow=False`` keeps the shadow scoring,
        so the loop can start again."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if close_shadow:
            self.shadow.close()

    def report(self) -> dict:
        """The full ``/debug/shadowz`` payload."""
        with self._lock:
            loop = {"ticks": self.ticks, "tick_s": self.tick_s,
                    "steps_per_tick": self.steps_per_tick, "last_tick_ms": self.last_tick_ms,
                    "last_tick_split_ms": dict(self.last_tick_split_ms)}
        return {
            "loop": loop,
            "miner": dict(self.miner.stats),
            "learner": {
                "examples_ingested": self.learner.examples_ingested,
                "reservoir_size": self.learner.reservoir_size,
                "steps_total": self.learner.steps_total,
                "last_metrics": self.learner.last_metrics,
            },
            "shadow": self.shadow.report(),
            "promotion": self.controller.report(),
        }
