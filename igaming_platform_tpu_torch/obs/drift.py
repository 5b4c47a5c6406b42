"""Streaming drift observatory: sketches of every scored batch, off the request path.

Counterpart of ``igaming_platform_tpu/obs/drift.py``:

- the scoring engine computes ONE extra reduction over the batch it has
  just scored, on the card and in the same enqueue as the step
  (:func:`sketch_kernel`; :func:`cached_sketch_kernel` re-composes the
  index path's rows from the device feature table): per-feature count,
  sum and sum of squares, fixed-edge histograms over the [N, 30] block, a
  score histogram and action counts, one float32 vector of
  ``SKETCH_LEN``;
- :class:`DriftEngine` takes those vectors through a bounded queue (a full
  queue drops and counts, never blocks) and its worker thread folds them
  into time buckets forming a rolling window, compares the window with a
  pinned reference (PSI and KS per feature, PSI of the score and action
  distributions), tracks calibration against outcomes
  (``note_outcomes``) and shadow-versus-production divergence
  (``note_shadow_result``), and raises and clears alerts;
- references persist as JSON keyed by the histogram-edge fingerprint, the
  same file in both packages (``DriftReference``); ``POST /debug/driftz``
  pins or loads one, ``DRIFT_REF`` loads one at boot.

The worker reads a device vector only after the CUDA event the engine
recorded on its stream after the step (``submit``'s ``ready``): a copy on
the worker's own stream could otherwise run before the step has written
it. The vector stays referenced by the queue until then.

Histogram edges are fixed and scale-free: features bin by
``sign(v) * log1p(|v|)`` over [-2, 18] in 16 bins, scores in 20 bins of
five points. The layout and ``EDGES_SPEC`` are the JAX package's, so
``edges_fingerprint()`` is equal in both. A ``metrics=`` registry gets the
``risk_drift_*`` families. Not ported yet: the host profiler's thread
registration, ``fleet_drift_block`` and ``summary_block``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from igaming_platform_tpu_torch.core.device import constant
from igaming_platform_tpu_torch.core.features import FEATURE_NAMES, NUM_FEATURES

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Sketch layout + fixed edges (the fleet merge contract)

N_FEATURE_BINS = 16
FEATURE_EDGE_LO = -2.0
FEATURE_EDGE_HI = 18.0
N_SCORE_BINS = 20  # five-point bins over the 0-100 score scale
SCORE_BIN_WIDTH = 5
N_ACTIONS = 4  # 0=unknown, 1=approve, 2=review, 3=block

OFF_ROWS = 0
OFF_SUM = 1
OFF_SUMSQ = OFF_SUM + NUM_FEATURES
OFF_FHIST = OFF_SUMSQ + NUM_FEATURES
OFF_SHIST = OFF_FHIST + NUM_FEATURES * N_FEATURE_BINS
OFF_AHIST = OFF_SHIST + N_SCORE_BINS
SKETCH_LEN = OFF_AHIST + N_ACTIONS

EDGES_SPEC = {
    "version": 1,
    "transform": "signed_log1p",
    "num_features": NUM_FEATURES,
    "feature_bins": N_FEATURE_BINS,
    "lo": FEATURE_EDGE_LO,
    "hi": FEATURE_EDGE_HI,
    "score_bins": N_SCORE_BINS,
    "score_bin_width": SCORE_BIN_WIDTH,
    "actions": N_ACTIONS,
}

_ALERT_KINDS = ("input", "score", "calibration")
_BIN_WIDTH = (FEATURE_EDGE_HI - FEATURE_EDGE_LO) / N_FEATURE_BINS


def edges_fingerprint() -> str:
    """16-hex digest of the histogram edge spec: two sketch states merge
    only when their fingerprints match."""
    blob = json.dumps(EDGES_SPEC, sort_keys=True, separators=(",", ":"))
    return hashlib.blake2b(blob.encode(), digest_size=8).hexdigest()


# ---------------------------------------------------------------------------
# The device reductions


def sketch_kernel(x: torch.Tensor, packed: torch.Tensor, n: int) -> torch.Tensor:
    """One reduction over a device-resident [B, 30] batch and its packed
    [5, B] score output -> the flat [SKETCH_LEN] float32 sketch of its first
    ``n`` rows (the rest are padding, whatever they hold).

    Histogram counts are exact (integer float32 sums from ``index_add_``);
    the moments are float32 sums in the device's order. The bin is
    ``floor((t - lo) / width)`` with ``width`` divided as a device tensor,
    as ``np_sketch`` divides: on CUDA a division by a Python scalar would
    multiply by its rounded reciprocal."""
    dev = x.device
    xv = x[:n].to(torch.float32)
    s_sum = xv.sum(dim=0)
    s_sumsq = (xv * xv).sum(dim=0)

    t = torch.sign(xv) * torch.log1p(torch.abs(xv))
    width = constant("drift.bin_width", np.array(_BIN_WIDTH, np.float32), dev)
    bins = torch.clamp(torch.floor((t - FEATURE_EDGE_LO) / width).to(torch.int64),
                       0, N_FEATURE_BINS - 1)
    offsets = constant("drift.feature_offsets",
                       np.arange(NUM_FEATURES, dtype=np.int64) * N_FEATURE_BINS, dev)
    ones = torch.ones((n * NUM_FEATURES,), dtype=torch.float32, device=dev)
    fhist = torch.zeros((NUM_FEATURES * N_FEATURE_BINS,), dtype=torch.float32, device=dev)
    fhist.index_add_(0, (bins + offsets).reshape(-1), ones)

    score = packed[0, :n].to(torch.int64)
    sbin = torch.clamp(torch.div(score, SCORE_BIN_WIDTH, rounding_mode="floor"),
                       0, N_SCORE_BINS - 1)
    action = torch.clamp(packed[1, :n].to(torch.int64), 0, N_ACTIONS - 1)
    tail = torch.zeros((1 + N_SCORE_BINS + N_ACTIONS,), dtype=torch.float32, device=dev)
    tail.index_add_(0, torch.cat([sbin + 1, action + 1 + N_SCORE_BINS]), ones[:2 * n])
    # A fill kernel: ``tail[0] = n`` would copy a host scalar with a blocking
    # copy, which waits for the stream.
    tail[:1].fill_(float(n))
    return torch.cat([tail[:1], s_sum, s_sumsq, fhist, tail[1:]])


def cached_sketch_kernel(table: torch.Tensor, idxs: torch.Tensor, amounts: torch.Tensor,
                         types: torch.Tensor, packed: torch.Tensor, n: int) -> torch.Tensor:
    """Index-mode sketch: the scored rows re-composed from the device
    feature table (the cached step's gather and context columns), then
    :func:`sketch_kernel`. The rows never exist on the host."""
    from igaming_platform_tpu_torch.serve.device_cache import compose_features

    return sketch_kernel(compose_features(table, idxs, amounts, types), packed, n)


def np_sketch(x: np.ndarray, scores: np.ndarray, actions: np.ndarray) -> np.ndarray:
    """Host (numpy) reference of :func:`sketch_kernel` over unpadded rows."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    vec = np.zeros((SKETCH_LEN,), np.float64)
    vec[OFF_ROWS] = n
    if n == 0:
        return vec
    vec[OFF_SUM:OFF_SUM + NUM_FEATURES] = x.sum(axis=0, dtype=np.float64)
    vec[OFF_SUMSQ:OFF_SUMSQ + NUM_FEATURES] = (x.astype(np.float64) ** 2).sum(axis=0)
    t = np.sign(x) * np.log1p(np.abs(x))
    width = (FEATURE_EDGE_HI - FEATURE_EDGE_LO) / N_FEATURE_BINS
    bins = np.clip(np.floor((t - FEATURE_EDGE_LO) / width).astype(np.int64),
                   0, N_FEATURE_BINS - 1)
    fhist = np.zeros((NUM_FEATURES, N_FEATURE_BINS), np.float64)
    for f in range(NUM_FEATURES):
        fhist[f] = np.bincount(bins[:, f], minlength=N_FEATURE_BINS)
    vec[OFF_FHIST:OFF_SHIST] = fhist.reshape(-1)
    sbin = np.clip(np.asarray(scores, np.int64) // SCORE_BIN_WIDTH, 0, N_SCORE_BINS - 1)
    vec[OFF_SHIST:OFF_AHIST] = np.bincount(sbin, minlength=N_SCORE_BINS)
    abin = np.clip(np.asarray(actions, np.int64), 0, N_ACTIONS - 1)
    vec[OFF_AHIST:] = np.bincount(abin, minlength=N_ACTIONS)
    return vec


# ---------------------------------------------------------------------------
# Sketch-vector views + divergence math


def sketch_views(vec: np.ndarray) -> dict:
    """Named views into a flat sketch vector (no copies)."""
    v = np.asarray(vec, np.float64)
    return {
        "rows": float(v[OFF_ROWS]),
        "feat_sum": v[OFF_SUM:OFF_SUM + NUM_FEATURES],
        "feat_sumsq": v[OFF_SUMSQ:OFF_SUMSQ + NUM_FEATURES],
        "feat_hist": v[OFF_FHIST:OFF_SHIST].reshape(NUM_FEATURES, N_FEATURE_BINS),
        "score_hist": v[OFF_SHIST:OFF_AHIST],
        "action_hist": v[OFF_AHIST:],
    }


def _smoothed_probs(counts: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    c = np.asarray(counts, np.float64)
    total = c.sum()
    k = c.shape[-1]
    if total <= 0:
        return np.full(c.shape, 1.0 / k)
    return (c / total + eps) / (1.0 + eps * k)


def psi(counts_p, counts_q) -> float:
    """Population Stability Index between two binned distributions
    (epsilon-smoothed). Rule of thumb: < 0.1 stable, 0.1-0.25 shifting,
    > 0.25 drifted."""
    p = _smoothed_probs(counts_p)
    q = _smoothed_probs(counts_q)
    return float(np.sum((p - q) * np.log(p / q)))


def ks_stat(counts_p, counts_q) -> float:
    """Two-sample Kolmogorov-Smirnov statistic from the shared fixed-edge
    binning (exact to bin resolution)."""
    p = np.asarray(counts_p, np.float64)
    q = np.asarray(counts_q, np.float64)
    if p.sum() <= 0 or q.sum() <= 0:
        return 0.0
    return float(np.max(np.abs(np.cumsum(p / p.sum()) - np.cumsum(q / q.sum()))))


# ---------------------------------------------------------------------------
# Reference snapshot (persisted/reloadable like a checkpoint)


@dataclass
class DriftReference:
    """A pinned traffic snapshot: the distributions "normal" looked like.

    ``calibration`` is the per-score-bin ``[count, positives]`` table of
    outcomes at pin time (None when none had been observed)."""

    edges_fp: str
    source: str
    created_unix: float
    rows: int
    feat_hist: np.ndarray  # [NUM_FEATURES, N_FEATURE_BINS] counts
    score_hist: np.ndarray  # [N_SCORE_BINS] counts
    action_hist: np.ndarray  # [N_ACTIONS] counts
    feat_mean: np.ndarray  # [NUM_FEATURES]
    feat_std: np.ndarray  # [NUM_FEATURES]
    calibration: np.ndarray | None  # [N_SCORE_BINS, 2] (count, positives)

    def fingerprint(self) -> str:
        h = hashlib.blake2b(digest_size=8)
        h.update(self.edges_fp.encode())
        for arr in (self.feat_hist, self.score_hist, self.action_hist):
            h.update(np.ascontiguousarray(arr, np.float64).tobytes())
        return h.hexdigest()

    def meta(self) -> dict:
        return {
            "fingerprint": self.fingerprint(),
            "edges_fp": self.edges_fp,
            "source": self.source,
            "created_unix": round(self.created_unix, 3),
            "rows": self.rows,
        }

    def to_json(self) -> dict:
        return {
            "kind": "drift_reference",
            "edges_fp": self.edges_fp,
            "edges_spec": EDGES_SPEC,
            "source": self.source,
            "created_unix": self.created_unix,
            "rows": self.rows,
            "feat_hist": self.feat_hist.tolist(),
            "score_hist": self.score_hist.tolist(),
            "action_hist": self.action_hist.tolist(),
            "feat_mean": self.feat_mean.tolist(),
            "feat_std": self.feat_std.tolist(),
            "calibration": (self.calibration.tolist() if self.calibration is not None else None),
        }

    def save(self, path: str) -> str:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as fh:
            json.dump(self.to_json(), fh)
        os.replace(tmp, path)
        return path

    @classmethod
    def from_json(cls, payload: dict) -> "DriftReference":
        if payload.get("kind") != "drift_reference":
            raise ValueError("not a drift reference file")
        edges_fp = str(payload["edges_fp"])
        if edges_fp != edges_fingerprint():
            raise ValueError(
                f"reference edge fingerprint {edges_fp} does not match this build's "
                f"{edges_fingerprint()}: re-mint the reference; comparing across edge "
                "layouts would fabricate PSI")
        cal = payload.get("calibration")
        return cls(
            edges_fp=edges_fp,
            source=str(payload.get("source", "unknown")),
            created_unix=float(payload.get("created_unix", 0.0)),
            rows=int(payload["rows"]),
            feat_hist=np.asarray(payload["feat_hist"], np.float64),
            score_hist=np.asarray(payload["score_hist"], np.float64),
            action_hist=np.asarray(payload["action_hist"], np.float64),
            feat_mean=np.asarray(payload["feat_mean"], np.float64),
            feat_std=np.asarray(payload["feat_std"], np.float64),
            calibration=(np.asarray(cal, np.float64) if cal is not None else None),
        )

    @classmethod
    def load(cls, path: str) -> "DriftReference":
        with open(path) as fh:
            return cls.from_json(json.load(fh))

    @classmethod
    def from_sketch(cls, vec: np.ndarray, *, source: str,
                    calibration: np.ndarray | None = None,
                    created_unix: float | None = None) -> "DriftReference":
        views = sketch_views(vec)
        rows = max(1.0, views["rows"])
        mean = views["feat_sum"] / rows
        var = np.maximum(views["feat_sumsq"] / rows - mean * mean, 0.0)
        return cls(
            edges_fp=edges_fingerprint(), source=source,
            created_unix=(time.time() if created_unix is None else created_unix),
            rows=int(views["rows"]),
            feat_hist=views["feat_hist"].copy(),
            score_hist=views["score_hist"].copy(),
            action_hist=views["action_hist"].copy(),
            feat_mean=mean, feat_std=np.sqrt(var),
            calibration=(np.asarray(calibration, np.float64).copy()
                         if calibration is not None else None),
        )


def calibration_error(window_cal: np.ndarray, ref_cal: np.ndarray | None,
                      min_ref_bin: int = 5) -> tuple[float | None, list]:
    """Divergence between the live fraud rate per score bin and the
    reference curve, weighted by the live bin mass; bins the reference has
    fewer than ``min_ref_bin`` outcomes for are skipped. Returns (error, or
    None when incomparable; the curve)."""
    w = np.asarray(window_cal, np.float64)
    curve = []
    total = w[:, 0].sum()
    for k in range(w.shape[0]):
        cnt, pos = w[k, 0], w[k, 1]
        curve.append({"bin": k, "lo": k * SCORE_BIN_WIDTH, "count": int(cnt),
                      "rate": round(pos / cnt, 4) if cnt else None})
    if ref_cal is None or total <= 0:
        return None, curve
    r = np.asarray(ref_cal, np.float64)
    err = 0.0
    weight = 0.0
    for k in range(min(w.shape[0], r.shape[0])):
        if w[k, 0] <= 0 or r[k, 0] < min_ref_bin:
            continue
        obs = w[k, 1] / w[k, 0]
        ref = r[k, 1] / r[k, 0]
        curve[k]["ref_rate"] = round(ref, 4)
        err += (w[k, 0] / total) * abs(obs - ref)
        weight += w[k, 0] / total
    if weight <= 0:
        return None, curve
    return float(err / weight), curve


def merge_drift_windows(payloads: list[dict]) -> dict:
    """Bucket-wise merge of window sketches (``{"edges_fp", "vec"}`` each).
    The sketch is a pure sum, so the merge is exact, but only across one
    edge layout: mixed fingerprints raise ValueError. Returns {"edges_fp",
    "rows", "vec"}."""
    merged: np.ndarray | None = None
    edges_fp: str | None = None
    for payload in payloads:
        fp = str(payload.get("edges_fp", ""))
        vec = np.asarray(payload.get("vec", ()), np.float64)
        if vec.shape != (SKETCH_LEN,):
            raise ValueError(f"drift sketch length {vec.shape} != {SKETCH_LEN}: refusing to "
                             "merge across incompatible sketch layouts")
        if edges_fp is None:
            edges_fp = fp
            merged = vec.copy()
        elif fp != edges_fp:
            raise ValueError(f"drift edge fingerprint mismatch ({fp} vs {edges_fp}): refusing "
                             "a bucket-wise merge across incompatible histogram edges")
        else:
            merged += vec
    if merged is None:
        return {"edges_fp": edges_fingerprint(), "rows": 0,
                "vec": np.zeros((SKETCH_LEN,), np.float64)}
    return {"edges_fp": edges_fp, "rows": int(merged[OFF_ROWS]), "vec": merged}


def psi_table(vec: np.ndarray, ref: DriftReference, top: int = 8) -> dict:
    """Per-feature PSI/KS of a window sketch against a reference, plus the
    score and action PSI."""
    views = sketch_views(vec)
    feats = {}
    for i, name in enumerate(FEATURE_NAMES):
        feats[name] = {
            "psi": round(psi(views["feat_hist"][i], ref.feat_hist[i]), 4),
            "ks": round(ks_stat(views["feat_hist"][i], ref.feat_hist[i]), 4),
        }
    ranked = sorted(feats.items(), key=lambda kv: kv[1]["psi"], reverse=True)
    return {
        "features": feats,
        "top_features": [{"feature": k, **v} for k, v in ranked[:top]],
        "max_feature_psi": ranked[0][1]["psi"] if ranked else 0.0,
        "max_feature_ks": (max(v["ks"] for v in feats.values()) if feats else 0.0),
        "score_psi": round(psi(views["score_hist"], ref.score_hist), 4),
        "action_psi": round(psi(views["action_hist"], ref.action_hist), 4),
    }


# ---------------------------------------------------------------------------
# Engine config


@dataclass(frozen=True)
class DriftConfig:
    window_s: float = 30.0
    bucket_s: float = 5.0
    min_rows: int = 512
    psi_alert: float = 0.25
    psi_clear: float = 0.125
    ks_alert: float = 0.30
    score_psi_alert: float = 0.25
    cal_window_s: float = 300.0
    cal_min_outcomes: int = 200
    cal_alert: float = 0.15
    queue_max: int = 256

    @classmethod
    def from_env(cls) -> "DriftConfig":
        def _f(name: str, default: float) -> float:
            return float(os.environ.get(name, str(default)))

        psi_alert = _f("DRIFT_PSI_ALERT", cls.psi_alert)
        return cls(
            window_s=_f("DRIFT_WINDOW_S", cls.window_s),
            bucket_s=_f("DRIFT_BUCKET_S", cls.bucket_s),
            min_rows=int(_f("DRIFT_MIN_ROWS", cls.min_rows)),
            psi_alert=psi_alert,
            psi_clear=_f("DRIFT_PSI_CLEAR", 0.5 * psi_alert),
            ks_alert=_f("DRIFT_KS_ALERT", cls.ks_alert),
            score_psi_alert=_f("DRIFT_SCORE_PSI_ALERT", cls.score_psi_alert),
            cal_window_s=_f("DRIFT_CAL_WINDOW_S", cls.cal_window_s),
            cal_min_outcomes=int(_f("DRIFT_CAL_MIN_OUTCOMES", cls.cal_min_outcomes)),
            cal_alert=_f("DRIFT_CAL_ALERT", cls.cal_alert),
            queue_max=int(_f("DRIFT_QUEUE_MAX", cls.queue_max)),
        )


# ---------------------------------------------------------------------------
# The engine


class DriftEngine:
    """Rolling-window drift accounting over device-computed sketches.

    ``submit`` is the only hot-path entry: an O(1) bounded enqueue of the
    sketch tensor under a short lock; it never raises and never blocks.
    The copy of the vector to the host, the window folds, the PSI/KS
    evaluation and the alert transitions run on the worker thread, the
    evaluation at most once a second.
    """

    def __init__(self, config: DriftConfig | None = None, *, metrics=None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or DriftConfig.from_env()
        self._metrics = metrics
        self._clock = clock
        self.edges_fp = edges_fingerprint()

        self._cv = threading.Condition()
        self._pending: deque = deque()
        self._stopping = False
        self._working = False

        # bucket index -> accumulated sketch vector (float64 host sums).
        self._buckets: dict[int, np.ndarray] = {}
        # bucket index -> [N_SCORE_BINS, 2] (outcome count, positives).
        self._cal_buckets: dict[int, np.ndarray] = {}
        # Lifetime calibration (what pin_reference snapshots as the curve).
        self._cal_total = np.zeros((N_SCORE_BINS, 2), np.float64)
        # bucket index -> [rows, flips, score_delta_sum] shadow divergence.
        self._shadow_buckets: dict[int, np.ndarray] = {}

        self.reference: DriftReference | None = None
        ref_path = os.environ.get("DRIFT_REF", "")
        if ref_path:
            # A broken reference file fails the boot: a reference-less
            # observatory never alerts.
            self.reference = DriftReference.load(ref_path)
            logger.info("drift reference loaded from %s (%s)", ref_path, self.reference.meta())

        self._alerts = {k: False for k in _ALERT_KINDS}
        self._events: deque = deque(maxlen=256)
        self._last_eval: dict = {}
        self._last_eval_sec = -1
        self._started_at = clock()

        # Stats (guarded by _cv).
        self.sketches_total = 0
        self.rows_sketched = 0
        self.rows_dropped = 0
        self.rows_skipped = 0
        self.outcomes_total = 0
        self.shadow_rows_total = 0
        self.errors = 0

        self._thread = threading.Thread(target=self._worker, name="drift-observatory",
                                        daemon=True)
        self._thread.start()

    # -- hot-path entries ----------------------------------------------------

    def submit(self, sketch, n: int, ready=None) -> bool:
        """Enqueue one sketch vector (a device tensor, or a host array).
        ``ready`` is the CUDA event recorded on the engine's stream after
        the step that wrote it (None on the CPU). O(1); never raises;
        returns False when dropped (queue full or stopping)."""
        try:
            with self._cv:
                if self._stopping or len(self._pending) >= self.config.queue_max:
                    self.rows_dropped += n
                    dropped = True
                else:
                    self._pending.append((sketch, int(n), self._clock(), ready))
                    dropped = False
                    self._cv.notify()
            if self._metrics is not None and dropped:
                self._metrics.drift_rows_total.inc(n, outcome="dropped")
            return not dropped
        except Exception:  # noqa: BLE001 — drift accounting must never fail scoring
            return False

    def note_skipped(self, n: int, reason: str = "unsketchable") -> None:
        """Rows a scoring path could not sketch (the int8 wire's codes on the
        split path): counted, so coverage gaps are visible."""
        with self._cv:
            self.rows_skipped += n
        if self._metrics is not None:
            self._metrics.drift_rows_total.inc(n, outcome="skipped")

    def note_error(self) -> None:
        with self._cv:
            self.errors += 1

    # -- off-path feeds ------------------------------------------------------

    def note_outcomes(self, scores, labels) -> None:
        """Outcomes joined to decision scores: folds (score bin, label)
        counts into the calibration window. Never raises."""
        try:
            s = np.asarray(scores, np.float64).ravel()
            y = np.asarray(labels, np.float64).ravel()
            if s.size == 0 or s.size != y.size:
                return
            sbin = np.clip(s.astype(np.int64) // SCORE_BIN_WIDTH, 0, N_SCORE_BINS - 1)
            counts = np.bincount(sbin, minlength=N_SCORE_BINS).astype(np.float64)
            pos = np.bincount(sbin, weights=y, minlength=N_SCORE_BINS).astype(np.float64)
            bucket = self._bucket_index(self._clock())
            with self._cv:
                cal = self._cal_buckets.get(bucket)
                if cal is None:
                    cal = self._cal_buckets.setdefault(
                        bucket, np.zeros((N_SCORE_BINS, 2), np.float64))
                cal[:, 0] += counts
                cal[:, 1] += pos
                self._cal_total[:, 0] += counts
                self._cal_total[:, 1] += pos
                self.outcomes_total += int(s.size)
        except Exception:  # noqa: BLE001 — a malformed outcome feed is counted, never raised
            self.note_error()

    def note_shadow_result(self, cand: dict, prod: dict, n: int) -> None:
        """Shadow-scorer hook (``serve/shadow.ShadowScorer.on_result``):
        candidate-versus-production divergence through the same rolling
        windows. Never raises."""
        try:
            ca = np.asarray(cand["action"][:n], np.int64)
            pa = np.asarray(prod["action"][:n], np.int64)
            flips = float(np.sum(ca != pa))
            delta = float(np.abs(np.asarray(cand["score"][:n], np.int64)
                                 - np.asarray(prod["score"][:n], np.int64)).sum())
            bucket = self._bucket_index(self._clock())
            with self._cv:
                row = self._shadow_buckets.get(bucket)
                if row is None:
                    row = self._shadow_buckets.setdefault(bucket, np.zeros((3,), np.float64))
                row += (n, flips, delta)
                self.shadow_rows_total += n
        except Exception:  # noqa: BLE001 — divergence trending is advisory; counted
            self.note_error()

    # -- worker --------------------------------------------------------------

    def _bucket_index(self, now: float) -> int:
        return int(now / self.config.bucket_s)

    @staticmethod
    def _host_vector(sketch, ready) -> np.ndarray:
        """The sketch on the host: after ``ready`` (the step's event on the
        engine's stream) when it is a device tensor."""
        if isinstance(sketch, torch.Tensor):
            if ready is not None:
                ready.synchronize()
            sketch = sketch.cpu().numpy()
        return np.asarray(sketch, np.float64)

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stopping:
                    self._cv.wait(timeout=0.25)
                if self._stopping and not self._pending:
                    return
                sketch, n, ts, ready = self._pending.popleft()
                self._working = True
            try:
                vec = self._host_vector(sketch, ready)
                del sketch
                bucket = self._bucket_index(ts)
                with self._cv:
                    acc = self._buckets.get(bucket)
                    if acc is None:
                        acc = self._buckets.setdefault(bucket, np.zeros((SKETCH_LEN,), np.float64))
                    acc += vec
                    self.sketches_total += 1
                    self.rows_sketched += n
                    self._prune(bucket)
                if self._metrics is not None:
                    self._metrics.drift_rows_total.inc(n, outcome="sketched")
                now = self._clock()
                if int(now) != self._last_eval_sec:
                    self._last_eval_sec = int(now)
                    self.evaluate(now)
            except Exception:  # noqa: BLE001 — one bad sketch must not kill the observatory
                with self._cv:
                    self.errors += 1
                logger.warning("drift sketch fold failed", exc_info=True)
            finally:
                with self._cv:
                    self._working = False

    def _prune(self, now_bucket: int) -> None:
        """Caller holds the lock."""
        horizon_s = 2 * max(self.config.window_s, self.config.cal_window_s)
        horizon = now_bucket - int(horizon_s / self.config.bucket_s) - 1
        for store in (self._buckets, self._cal_buckets, self._shadow_buckets):
            if len(store) > horizon_s / self.config.bucket_s + 4:
                for b in [b for b in store if b < horizon]:
                    del store[b]

    # -- windows -------------------------------------------------------------

    def window_vec(self, now: float | None = None, window_s: float | None = None) -> np.ndarray:
        now = self._clock() if now is None else now
        window_s = self.config.window_s if window_s is None else window_s
        lo = self._bucket_index(now - window_s)
        out = np.zeros((SKETCH_LEN,), np.float64)
        with self._cv:
            for b, vec in self._buckets.items():
                if b > lo:
                    out += vec
        return out

    def _cal_window(self, now: float) -> np.ndarray:
        lo = self._bucket_index(now - self.config.cal_window_s)
        out = np.zeros((N_SCORE_BINS, 2), np.float64)
        with self._cv:
            for b, cal in self._cal_buckets.items():
                if b > lo:
                    out += cal
        return out

    def _shadow_window(self, now: float) -> np.ndarray:
        lo = self._bucket_index(now - self.config.window_s)
        out = np.zeros((3,), np.float64)
        with self._cv:
            for b, row in self._shadow_buckets.items():
                if b > lo:
                    out += row
        return out

    # -- reference management ------------------------------------------------

    def pin_reference(self, *, source: str = "pinned-from-window",
                      min_rows: int | None = None) -> DriftReference:
        """Pin the current rolling window as the reference. Raises
        ValueError when the window is too thin to pin."""
        min_rows = self.config.min_rows if min_rows is None else min_rows
        vec = self.window_vec()
        if vec[OFF_ROWS] < max(1, min_rows):
            raise ValueError(
                f"window holds {int(vec[OFF_ROWS])} rows, need >= {min_rows} to pin a "
                "reference (warm it with clean traffic first)")
        with self._cv:
            cal = self._cal_total.copy() if self._cal_total[:, 0].sum() > 0 else None
        ref = DriftReference.from_sketch(vec, source=source, calibration=cal)
        self.set_reference(ref)
        return ref

    def set_reference(self, ref: DriftReference) -> None:
        if ref.edges_fp != self.edges_fp:
            raise ValueError(f"reference edges {ref.edges_fp} != engine edges {self.edges_fp}")
        with self._cv:
            self.reference = ref
            # A new normal invalidates standing alerts.
            for kind in self._alerts:
                self._alerts[kind] = False
        logger.info("drift reference set: %s", ref.meta())

    def load_reference(self, path: str) -> DriftReference:
        ref = DriftReference.load(path)
        self.set_reference(ref)
        return ref

    # -- evaluation + alerts -------------------------------------------------

    def _update_alert(self, kind: str, value: float | None, raise_thr: float,
                      clear_thr: float, now: float) -> None:
        if value is None:
            return
        with self._cv:
            active = self._alerts[kind]
            fire = False
            if not active and value >= raise_thr:
                self._alerts[kind] = True
                fire = True
                self._events.append({"t": round(now - self._started_at, 3), "kind": kind,
                                     "event": "raised", "value": round(value, 4),
                                     "threshold": raise_thr})
            elif active and value < clear_thr:
                self._alerts[kind] = False
                self._events.append({"t": round(now - self._started_at, 3), "kind": kind,
                                     "event": "cleared", "value": round(value, 4),
                                     "threshold": clear_thr})
            state = self._alerts[kind]
        if self._metrics is not None:
            self._metrics.drift_alert.set(1.0 if state else 0.0, kind=kind)
            if fire:
                self._metrics.drift_alerts_total.inc(kind=kind)

    def evaluate(self, now: float | None = None) -> dict:
        """Recompute window-versus-reference divergences and flip alert
        state; called at most once a second by the worker and on every
        snapshot."""
        now = self._clock() if now is None else now
        cfg = self.config
        vec = self.window_vec(now)
        rows = int(vec[OFF_ROWS])
        result: dict = {"window_rows": rows}
        ref = self.reference
        if ref is not None and rows >= cfg.min_rows:
            table = psi_table(vec, ref)
            result["input"] = table
            # KS folds in scaled to the PSI threshold, so psi_alert stays the
            # one sensitivity knob.
            input_metric = max(table["max_feature_psi"],
                               table["max_feature_ks"] * (cfg.psi_alert / cfg.ks_alert))
            self._update_alert("input", input_metric, cfg.psi_alert, cfg.psi_clear, now)
            out_metric = max(table["score_psi"], table["action_psi"])
            self._update_alert("score", out_metric, cfg.score_psi_alert,
                               0.5 * cfg.score_psi_alert, now)
            if self._metrics is not None:
                for name, row in table["features"].items():
                    self._metrics.drift_psi.set(row["psi"], feature=name)
                    self._metrics.drift_ks.set(row["ks"], feature=name)
                self._metrics.drift_output_psi.set(table["score_psi"], dist="score")
                self._metrics.drift_output_psi.set(table["action_psi"], dist="action")
        cal = self._cal_window(now)
        cal_outcomes = int(cal[:, 0].sum())
        err, curve = calibration_error(cal, ref.calibration if ref is not None else None)
        result["calibration"] = {
            "window_outcomes": cal_outcomes,
            "error": round(err, 4) if err is not None else None,
            "curve": curve,
        }
        if err is not None and cal_outcomes >= cfg.cal_min_outcomes:
            self._update_alert("calibration", err, cfg.cal_alert, 0.5 * cfg.cal_alert, now)
            if self._metrics is not None:
                self._metrics.drift_calibration_error.set(err)
        sh = self._shadow_window(now)
        result["shadow"] = {
            "window_rows": int(sh[0]),
            "flip_rate": round(sh[1] / sh[0], 4) if sh[0] else 0.0,
            "score_delta_mean": round(sh[2] / sh[0], 4) if sh[0] else 0.0,
        }
        if self._metrics is not None:
            self._metrics.drift_window_rows.set(rows)
            if sh[0]:
                self._metrics.drift_shadow_divergence.set(sh[2] / sh[0])
        self._last_eval = result
        return result

    def alerts_active(self) -> dict:
        with self._cv:
            return dict(self._alerts)

    # -- reporting / lifecycle -----------------------------------------------

    def snapshot(self) -> dict:
        """The ``/debug/driftz`` payload, with the raw window vector and the
        reference state."""
        now = self._clock()
        result = self.evaluate(now)
        vec = self.window_vec(now)
        views = sketch_views(vec)
        rows = max(1.0, views["rows"])
        mean = views["feat_sum"] / rows
        ref = self.reference
        with self._cv:
            alerts = dict(self._alerts)
            events = list(self._events)
            stats = {
                "sketches_total": self.sketches_total,
                "rows_sketched": self.rows_sketched,
                "rows_dropped": self.rows_dropped,
                "rows_skipped": self.rows_skipped,
                "outcomes_total": self.outcomes_total,
                "shadow_rows_total": self.shadow_rows_total,
                "errors": self.errors,
                "queue_depth": len(self._pending),
            }
        return {
            "edges": {"fingerprint": self.edges_fp, "spec": EDGES_SPEC},
            "config": {
                "window_s": self.config.window_s,
                "bucket_s": self.config.bucket_s,
                "min_rows": self.config.min_rows,
                "psi_alert": self.config.psi_alert,
                "psi_clear": self.config.psi_clear,
                "ks_alert": self.config.ks_alert,
                "score_psi_alert": self.config.score_psi_alert,
                "cal_window_s": self.config.cal_window_s,
                "cal_min_outcomes": self.config.cal_min_outcomes,
                "cal_alert": self.config.cal_alert,
            },
            "uptime_s": round(now - self._started_at, 3),
            "reference": ref.meta() if ref is not None else None,
            "reference_state": ref.to_json() if ref is not None else None,
            "window": {
                "window_s": self.config.window_s,
                "rows": int(views["rows"]),
                "feat_mean": [round(float(v), 4) for v in mean],
                "score_hist": [int(v) for v in views["score_hist"]],
                "action_hist": [int(v) for v in views["action_hist"]],
                "vec": vec.tolist(),
            },
            "alerts": alerts,
            "alert_events": events,
            "stats": stats,
            **result,
        }

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until every queued sketch has been folded."""
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


# ---------------------------------------------------------------------------
# Process-default engine (the one /debug/driftz reads)

DEFAULT: DriftEngine | None = None


def install(engine: DriftEngine) -> DriftEngine:
    """Make ``engine`` the process default; a previously installed engine is
    closed, so its worker thread does not linger."""
    global DEFAULT
    if DEFAULT is not None and DEFAULT is not engine:
        DEFAULT.close()
    DEFAULT = engine
    return engine


def uninstall() -> None:
    global DEFAULT
    if DEFAULT is not None:
        DEFAULT.close()
        DEFAULT = None


def get_default() -> DriftEngine | None:
    return DEFAULT
