"""TorchScoringEngine: the risk service's scoring engine, hot path on the card.

The port's counterpart of ``igaming_platform_tpu/serve/scorer.py``
``TPUScoringEngine``, with the same public surface for the fraud-scoring
path (risk.v1 ScoreTransaction / ScoreBatch):

- the host feature store (``serve/feature_store.py``) gathers each batch
  into a [B, 30] float32 matrix and a blacklist vector;
- the batch is padded to the smallest shape of the ladder
  (``latency_tiers`` + ``batch_size``) that holds it and copied to the
  device, where ``models/ensemble.py`` runs normalize, the ML backend, the
  8 rules, the ensemble and the action decision;
- the step returns ONE packed [5, B] int32 tensor (score, action,
  reason_mask, rule_score, ml_score as IEEE-754 bits) and ONE
  device-to-host copy brings it back;
- ``score()`` rides the continuous batcher; ``score_batch`` runs chunks of
  ``batch_size`` directly;
- thresholds are a device tensor input: ``set_thresholds`` rebuilds
  nothing; ``swap_params`` installs new params atomically.

Every batch runs on the engine's device. There is no host-CPU tier: on a
CUDA engine a small batch goes to the card like a large one, and the CPU
runs a batch only when the caller built the engine with ``device="cpu"``.
Not ported yet: the host tier, the wire modes, the native store, the
cached/index path, session state, drift, shadow and the decision ledger.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from igaming_platform_tpu_torch.convert import BACKEND_KEYS, params_to
from igaming_platform_tpu_torch.core.config import BatcherConfig, ScoringConfig
from igaming_platform_tpu_torch.core.device import resolve_device
from igaming_platform_tpu_torch.core.enums import ReasonCode, action_from_code, decode_reason_mask
from igaming_platform_tpu_torch.core.features import NUM_FEATURES, FeatureVector
from igaming_platform_tpu_torch.models.ensemble import make_score_fn
from igaming_platform_tpu_torch.serve.batcher import ContinuousBatcher, pad_batch
from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore, TransactionEvent


@dataclass(slots=True)
class ScoreRequest:
    """Mirror of scoring.ScoreRequest (engine.go:40-53)."""

    account_id: str
    amount: int = 0
    tx_type: str = "deposit"
    player_id: str = ""
    currency: str = "USD"
    game_id: str = ""
    ip: str = ""
    device_id: str = ""
    fingerprint: str = ""
    user_agent: str = ""
    session_id: str = ""
    ip_flags: tuple[int, int, int] | None = None  # (vpn, proxy, tor) when known


@dataclass(slots=True)
class ScoreResponse:
    """Mirror of scoring.ScoreResponse (engine.go:56-64)."""

    score: int
    action: str
    reason_codes: list[ReasonCode]
    rule_score: int
    ml_score: float
    response_time_ms: float
    features: FeatureVector


def _stack_packed(out: dict) -> torch.Tensor:
    """Dict output -> packed int32 [5, B]: score, action, reason_mask,
    rule_score, and ml_score as its IEEE-754 bits. One copy to the host
    instead of five."""
    return torch.stack([
        out["score"].to(torch.int32),
        out["action"].to(torch.int32),
        out["reason_mask"].to(torch.int32),
        out["rule_score"].to(torch.int32),
        out["ml_score"].to(torch.float32).view(torch.int32),
    ])


def _unpack_host(packed) -> dict:
    """Host-side view of the packed [5, B] result as the canonical dict."""
    a = np.asarray(packed)
    return {
        "score": a[0],
        "action": a[1],
        "reason_mask": a[2],
        "rule_score": a[3],
        "ml_score": a[4].view(np.float32),
    }


class TorchScoringEngine:
    def __init__(
        self,
        config: ScoringConfig | None = None,
        *,
        ml_backend: str = "mock",
        params: Any = None,
        batcher_config: BatcherConfig | None = None,
        feature_store: InMemoryFeatureStore | None = None,
        device: str | torch.device = "cuda",
        warmup: bool = True,
    ):
        self.device = resolve_device(device)
        self.config = config or ScoringConfig()
        self.ml_backend = ml_backend
        self._score_fn = make_score_fn(self.config, ml_backend, device=self.device)
        self._params = self._install(params)
        self._params_lock = threading.Lock()
        self.features = feature_store or InMemoryFeatureStore()
        bcfg = batcher_config or BatcherConfig()
        self.batch_size = bcfg.batch_size
        # Shape ladder: the throughput shape plus the smaller latency tiers.
        # A flush pads to the smallest shape that holds it.
        self._shapes = sorted(
            {t for t in bcfg.latency_tiers if 0 < t < self.batch_size} | {self.batch_size}
        )
        self._thresholds_host = (self.config.block_threshold, self.config.review_threshold)
        self._thresholds = self._thresholds_tensor(*self._thresholds_host)
        # Device steps launched (every step of a gbdt backend launches the
        # forest kernel once); read by tests and the chip smoke.
        self.device_steps = 0
        self._steps_lock = threading.Lock()
        self._batcher = ContinuousBatcher(
            bcfg, dispatch=self._dispatch_requests, collect=self._collect_requests)
        if warmup:
            self.warmup()
        self._batcher.start()

    # -- lifecycle -----------------------------------------------------------

    def warmup(self) -> None:
        """Run every shape of the ladder once before taking traffic, so the
        first request pays neither the kernel build nor a first launch."""
        for shape in self._shapes:
            x = np.zeros((shape, NUM_FEATURES), dtype=np.float32)
            bl = np.zeros((shape,), dtype=bool)
            self._readback(self._launch(x, bl, self.get_params()))

    def close(self) -> None:
        self._batcher.stop()

    # -- params / thresholds -------------------------------------------------

    def _install(self, params: Any) -> Any:
        missing = [k for k in BACKEND_KEYS[self.ml_backend] if not params or k not in params]
        if missing:
            raise ValueError(f"ml_backend={self.ml_backend!r} needs params {missing}")
        return params_to(params, self.device)

    def swap_params(self, params: Any) -> None:
        """Atomically install new model parameters (copied to the device
        before the swap, so scoring never waits on the copy)."""
        installed = self._install(params)
        with self._params_lock:
            self._params = installed

    def get_params(self) -> Any:
        with self._params_lock:
            return self._params

    def _thresholds_tensor(self, block: int, review: int) -> torch.Tensor:
        return torch.tensor([block, review], dtype=torch.int32, device=self.device)

    def get_thresholds(self) -> tuple[int, int]:
        return self._thresholds_host

    def set_thresholds(self, block: int, review: int) -> None:
        """Runtime threshold tuning (engine.go:498-504): a new [2] input
        tensor, nothing rebuilt."""
        t = self._thresholds_tensor(block, review)
        self._thresholds, self._thresholds_host = t, (int(block), int(review))

    # -- scoring -------------------------------------------------------------

    def score(self, req: ScoreRequest, timeout: float = 30.0) -> ScoreResponse:
        """Single-transaction scoring through the continuous batcher."""
        start = time.monotonic()
        resp: ScoreResponse = self._batcher.score_sync(req, timeout=timeout)
        resp.response_time_ms = (time.monotonic() - start) * 1000.0
        return resp

    def score_batch(self, reqs: list[ScoreRequest]) -> list[ScoreResponse]:
        """Direct batch path (ScoreBatch RPC), chunked to ``batch_size``:
        an oversized batch runs as several device steps."""
        start = time.monotonic()
        responses: list[ScoreResponse] = []
        for i in range(0, len(reqs), self.batch_size):
            chunk = reqs[i : i + self.batch_size]
            x, bl = self.features.gather_batch(chunk)
            host = self._readback(self._launch(x, bl, self.get_params()))
            responses.extend(self._row_response(host, x, j) for j in range(len(chunk)))
        elapsed_ms = (time.monotonic() - start) * 1000.0
        for r in responses:
            r.response_time_ms = elapsed_ms
        return responses

    def score_arrays(self, x: np.ndarray, blacklisted: np.ndarray | None = None) -> dict:
        """Score a pre-gathered [N, 30] batch as it is (no padding); returns
        the dict of [N] tensors on the engine's device."""
        if blacklisted is None:
            blacklisted = np.zeros((x.shape[0],), dtype=bool)
        with torch.inference_mode():
            out = self._score_fn(self.get_params(), x, blacklisted, self._thresholds)
        self._count_step()
        return out

    def update_features(self, event: TransactionEvent) -> None:
        """Post-transaction write-back (engine.go:486-488)."""
        self.features.update(event)

    # -- internals -----------------------------------------------------------

    def _pick_shape(self, n: int) -> int:
        """Smallest ladder shape that holds n rows."""
        for shape in self._shapes:
            if n <= shape:
                return shape
        return self.batch_size

    def _count_step(self) -> None:
        with self._steps_lock:
            self.device_steps += 1

    def _launch(self, x: np.ndarray, bl: np.ndarray, params: Any):
        """Pad, copy to the device, run the step and start the copy of the
        packed [5, B] result back to pinned host memory, without waiting.
        Returns a handle for ``_readback``."""
        n = x.shape[0]
        shape = self._pick_shape(n)
        xp, _ = pad_batch(x, shape)
        blp, _ = pad_batch(bl, shape)
        xd = torch.from_numpy(xp).to(self.device)
        bld = torch.from_numpy(blp).to(self.device)
        with torch.inference_mode():
            packed = _stack_packed(self._score_fn(params, xd, bld, self._thresholds))
            if self.device.type == "cuda":
                host = torch.empty(packed.shape, dtype=torch.int32, pin_memory=True)
                host.copy_(packed, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host, done = packed, None
        self._count_step()
        return host, done, n

    @staticmethod
    def _readback(handle) -> dict:
        host, done, n = handle
        if done is not None:
            done.synchronize()
        return _unpack_host(host.numpy()[:, :n])

    # Two-phase batcher hooks: dispatch on the launcher thread, collect on
    # the collector thread, so batch k+1 launches while batch k's results
    # are still on their way back.

    def _dispatch_requests(self, reqs: list[ScoreRequest]):
        x, bl = self.features.gather_batch(reqs)
        return self._launch(x, bl, self.get_params()), x

    def _collect_requests(self, handle) -> list[ScoreResponse]:
        launched, x = handle
        host = self._readback(launched)
        return [self._row_response(host, x, i) for i in range(x.shape[0])]

    @staticmethod
    def _row_response(out: dict, x: np.ndarray, i: int) -> ScoreResponse:
        return ScoreResponse(
            score=int(out["score"][i]),
            action=action_from_code(int(out["action"][i])).value,
            reason_codes=decode_reason_mask(int(out["reason_mask"][i])),
            rule_score=int(out["rule_score"][i]),
            ml_score=float(out["ml_score"][i]),
            response_time_ms=0.0,
            features=FeatureVector.from_array(x[i]),
        )
