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
- the wire paths of ScoreBatch (``score_batch_wire_bytes``,
  ``score_batch_wire``) gather through the native store, score in chunks
  through the staged host pipeline (``serve/pipeline_engine.py``, or the
  lockstep flow with ``HOST_PIPELINE=0``) and encode the whole response in
  one native call, each chunk's rows reporting the time that chunk came
  back;
- thresholds are a device tensor input: ``set_thresholds`` rebuilds
  nothing; ``swap_params`` installs new params atomically, with their
  fingerprint.

Every batch runs on the engine's device. On a card, every copy and step
goes on one CUDA stream the engine owns, whichever thread launches it, and
launches are enqueued one at a time. There is no host-CPU tier: on a CUDA
engine a small batch goes to the card like a large one, and the CPU runs a
batch only when the caller built the engine with ``device="cpu"``. Not
ported yet: the host tier, the index wire mode (``WIRE_MODE=index``
raises), the cached path, session state, drift, shadow and the decision
ledger.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import time
from collections import deque
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


RESULT_KEYS = ("score", "action", "reason_mask", "rule_score", "ml_score")


def _device_readback(handle) -> dict:
    """The device-to-host drain of one launch (``_launch_padded``'s handle):
    wait for the packed [5, B] copy, then view its first n columns."""
    host, done, n = handle
    if done is not None:
        done.synchronize()
    return _unpack_host(host.numpy()[:, :n])


def params_fingerprint(params: Any) -> str:
    """Stable 16-hex digest over a params tree (name, dtype, shape and
    bytes of every tensor, in tree order). Computed once per install,
    never on the scoring path."""
    h = hashlib.blake2b(digest_size=8)
    if params is None:
        h.update(b"none")
        return h.hexdigest()
    for key in sorted(params):
        value = params[key]
        tensors = value.state_dict() if hasattr(value, "state_dict") else value
        for name, t in tensors.items():
            arr = t.detach().cpu().numpy()
            h.update(f"{key}.{name}:{arr.dtype}:{arr.shape}".encode())
            h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


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
        self.params_fingerprint = params_fingerprint(self._params)
        self._params_lock = threading.Lock()
        self.features = feature_store or InMemoryFeatureStore()
        # The one stream of every copy and step on a card; launches are
        # enqueued under a lock, one at a time.
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._dispatch_lock = threading.Lock()
        bcfg = batcher_config or BatcherConfig()
        self.batch_size = bcfg.batch_size
        self._pipeline_depth = bcfg.pipeline_depth
        self.wire_mode = os.environ.get("WIRE_MODE", "row").lower()
        if self.wire_mode not in ("row", "index"):
            raise ValueError(f"WIRE_MODE={self.wire_mode!r} not supported (use 'row' or 'index')")
        # Staged host pipeline for the wire paths: on by default;
        # HOST_PIPELINE=0 (or host_pipeline=False) keeps the lockstep flow,
        # which is also the parity reference of the pipeline.
        env_pipe = os.environ.get("HOST_PIPELINE", "")
        self._pipeline_enabled = (
            bcfg.host_pipeline if env_pipe == "" else env_pipe not in ("0", "false"))
        self._host_pipeline = None
        self._host_pipeline_lock = threading.Lock()
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
        if self._host_pipeline is not None:
            self._host_pipeline.close()

    def _ensure_pipeline(self):
        """Build (once) the staged host pipeline; None when disabled."""
        if not self._pipeline_enabled:
            return None
        if self._host_pipeline is None:
            with self._host_pipeline_lock:
                if self._host_pipeline is None:
                    from igaming_platform_tpu_torch.serve.pipeline_engine import HostPipeline

                    self._host_pipeline = HostPipeline(self, depth=self._pipeline_depth)
        return self._host_pipeline

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
        fingerprint = params_fingerprint(installed)
        with self._params_lock:
            self._params = installed
            self.params_fingerprint = fingerprint

    def get_params(self) -> Any:
        with self._params_lock:
            return self._params

    def params_snapshot(self) -> tuple[Any, str]:
        """(params, fingerprint) captured together: every chunk of a
        multi-chunk job scores with one tree, even across a hot swap."""
        with self._params_lock:
            return self._params, self.params_fingerprint

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

    # -- wire fast path (ScoreBatch RPC) -------------------------------------

    def score_batch_wire(
        self,
        account_ids: list[str],
        amounts: list[int],
        tx_types: list[str],
        ips: list[str] | None = None,
        devices: list[str] | None = None,
        fingerprints: list[str] | None = None,
        *,
        include_features: bool = True,
    ) -> bytes:
        """Columnar batch scoring straight to ScoreBatchResponse wire bytes:
        no per-row request or response object. Row mode only: the index
        mode's cached path is not ported yet."""
        start = time.monotonic()
        if self.wire_mode == "index":
            raise NotImplementedError("WIRE_MODE=index needs the cached path, not ported yet")
        if hasattr(self.features, "gather_columns"):
            x, bl = self.features.gather_columns(
                account_ids, amounts, tx_types, ips=ips, devices=devices,
                fingerprints=fingerprints)
        else:
            x, bl = self.features.gather_batch([
                ScoreRequest(account_id=account_ids[i], amount=amounts[i], tx_type=tx_types[i],
                             ip=ips[i] if ips else "", device_id=devices[i] if devices else "",
                             fingerprint=fingerprints[i] if fingerprints else "")
                for i in range(len(account_ids))])
        return self._score_rows_to_wire(x, bl, include_features, start)

    def score_batch_wire_bytes(
        self, payload: bytes, *, include_features: bool = True
    ) -> tuple[bytes, int]:
        """ScoreBatchRequest wire bytes -> (ScoreBatchResponse wire bytes,
        rows): one native call decodes and gathers, the device scores in
        chunks, one native call encodes. Raises ValueError on a malformed
        request, RuntimeError when the store has no native decoder."""
        start = time.monotonic()
        if not hasattr(self.features, "decode_gather"):
            raise RuntimeError("feature store has no native wire decoder")
        x, bl = self.features.decode_gather(payload)
        return self._score_rows_to_wire(x, bl, include_features, start), x.shape[0]

    def _score_rows_to_wire(self, x: np.ndarray, bl: np.ndarray, include_features: bool,
                            start: float) -> bytes:
        """A gathered [N, 30] batch to response bytes: through the host
        pipeline when enabled, else the lockstep flow. Bit-exact either way."""
        pipe = self._ensure_pipeline()
        if pipe is not None:
            return pipe.score_rows_to_wire(x, bl, include_features, start)
        return self._score_rows_encode(x, bl, include_features, start)

    def _score_rows_encode(self, x: np.ndarray, bl: np.ndarray, include_features: bool,
                           start: float) -> bytes:
        """Lockstep chunked scoring to response bytes: chunk k's readback
        overlaps chunk k+1's step, at most ``pipeline_depth`` chunks in
        flight, and each row's response_time_ms is the time its chunk came
        back (the per-call semantics of engine.go:263,312)."""
        from igaming_platform_tpu_torch.serve.wire import encode_score_batch

        total = x.shape[0]
        if total == 0:
            return b""
        parts: dict[str, list[np.ndarray]] = {k: [] for k in RESULT_KEYS}
        rtms = np.empty((total,), dtype=np.int64)
        inflight: deque = deque()

        def read_one() -> None:
            handle, lo = inflight.popleft()
            host = _device_readback(handle)
            for k in RESULT_KEYS:
                parts[k].append(host[k])
            rtms[lo:lo + handle[2]] = int((time.monotonic() - start) * 1000.0)

        params, _ = self.params_snapshot()
        for lo in range(0, total, self.batch_size):
            hi = min(lo + self.batch_size, total)
            inflight.append((self._launch(x[lo:hi], bl[lo:hi], params), lo))
            if len(inflight) > self._pipeline_depth:
                read_one()
        while inflight:
            read_one()
        cat = {k: np.concatenate(v) for k, v in parts.items()}
        return encode_score_batch(cat["score"], cat["action"], cat["reason_mask"],
                                  cat["rule_score"], cat["ml_score"], rtms,
                                  x if include_features else None)

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
        """Pad into fresh arrays and launch (``_launch_padded``)."""
        n = x.shape[0]
        shape = self._pick_shape(n)
        xp, _ = pad_batch(x, shape)
        blp, _ = pad_batch(bl, shape)
        return self._launch_padded(xp, blp, n, params)

    def _launch_padded(self, xp: np.ndarray, blp: np.ndarray, n: int, params: Any,
                       hold=None):
        """Copy one padded batch to the device, run the step and start the
        copy of the packed [5, B] result back to pinned host memory, all on
        the engine's stream, without waiting. From pinned staging buffers
        the input copies are asynchronous too: ``hold``
        (``serve/arena.StagingHold``) then gets the event recorded after
        them, and keeps the buffers from the pool until it has passed.
        Returns a handle for ``_readback``."""
        cuda = self.device.type == "cuda"
        with self._dispatch_lock, (torch.cuda.stream(self.stream) if cuda
                                   else contextlib.nullcontext()):
            xd = torch.from_numpy(xp).to(self.device, non_blocking=True)
            bld = torch.from_numpy(blp).to(self.device, non_blocking=True)
            if hold is not None and cuda:
                hold.copied = torch.cuda.Event()
                hold.copied.record(self.stream)
            with torch.inference_mode():
                packed = _stack_packed(self._score_fn(params, xd, bld, self._thresholds))
                if cuda:
                    host = torch.empty(packed.shape, dtype=torch.int32, pin_memory=True)
                    host.copy_(packed, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(self.stream)
                else:
                    host, done = packed, None
            self._count_step()
        return host, done, n

    _readback = staticmethod(_device_readback)

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
