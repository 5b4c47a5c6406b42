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
- the index wire mode (``IDX1`` frames through ``score_batch_wire_index``,
  or ``WIRE_MODE=index`` for the columnar ``score_batch_wire``) scores
  through the device feature cache (``serve/device_cache.py``, built by
  ``ensure_cache``: eagerly with ``feature_cache``/``FEATURE_CACHE``, else
  on the first index request): each chunk's ``lookup`` copies pending
  deltas into the table, then the cached step gathers the rows on the
  device; only slots and the per-transaction context cross to the card;
- with ``session_state``/``SESSION_STATE=1`` the cached step is the fused
  session step (``serve/session_state.py``): the session head over each
  account's event ring (``SESSION_HEAD=pattern|transformer``) folds into the
  ensemble and the event is appended to the ring, in the same step; rows
  scored on the row paths meanwhile are counted as bypass;
- thresholds are a device tensor input: ``set_thresholds`` rebuilds
  nothing; ``swap_params`` installs new params atomically, with their
  fingerprint;
- ``WIRE_DTYPE=bf16|int8`` ships the row paths' batches to the card as
  bfloat16 bits (rounded to nearest even on the host) or as the int8 wire
  codes of ``ops/quantize.py``, and the step decodes them at its head; the
  index path keeps its float32 table;
- with a drift engine bound (``bind_drift``; ``RiskGrpcService`` binds one
  unless ``DRIFT=0``) every step also reduces a sketch of the rows it
  scored (``obs/drift.py``), and with a shadow scorer attached
  (``engine.shadow``, ``serve/shadow.py``) every step also scores the
  candidate params on the same rows, both in the step's own enqueue on the
  engine's stream. ``FUSED=0`` gives the split layout: the sketch is its
  own enqueue after the step, over the device copy of the batch (the int8
  wire's codes are counted as skipped, not sketched), and the shadow's
  worker scores the candidate from that device copy (``SHADOW_FUSED=0``
  alone does the latter). The drift and shadow workers read the step's
  tensors only after the CUDA event recorded after it; neither can fail,
  delay or change an answer;
- with a decision ledger bound (``engine.ledger``, ``serve/ledger.py``;
  ``LEDGER_DIR`` on the server) every path notes each batch it answered,
  after the readback, as host numpy, with the params fingerprint and the
  thresholds captured at dispatch: the batcher's flushes (``"single"``),
  each ``score_batch`` chunk (``"batch"``, which stamps ``decision_id`` on
  its responses), each wire RPC (``"wire_row"``, on the lockstep path and
  in the host pipeline's encode) and the index path (``"index"``: with session state one note per
  chunk with its session fields, else one per call without a feature
  snapshot). The ledger never fails or changes an answer, and a row it
  cannot keep (a full queue, a failed append) is counted as dropped. It
  does slow answers: with it bound, bulk ScoreBatch callers got about a
  quarter of the rows/s, its writer thread sharing the interpreter with
  them (``PERF.md`` §5, ``ROADMAP.md`` Queue 1, the benchmark's first target).

The operations plane's seams, as in the JAX engine: each path opens stage
spans with the JAX names (``score.pad``, ``score.session``,
``score.gather``, ``score.cache_lookup``, ``score.dispatch`` the enqueue,
``score.readback`` the wait on the step's CUDA event and the copy,
``score.ledger_note``, ``score.decode``, ``score.blacklist``,
``score.encode``; ``obs/tracing.py``), and the step's enqueue sits in
``annotate("score_step")``; closing a span never synchronizes the card.
``score_observer`` gets each wire batch's host scores; ``bind_cache_metrics``,
``bind_session_metrics`` and ``bind_pipeline_metrics`` route those planes'
families into a ``ServiceMetrics``. ``device.dispatch`` and
``device.readback`` (``serve/chaos.py``) fire at ``_device_dispatch``, the
one launch chokepoint every step of every path goes through (it also counts
the dispatch and notes its shape signature, ``obs/runtime_telemetry.py``),
and at ``_device_readback``. ``step_cost(n)`` counts a step's operations
and bytes from its shapes (``obs/perfmodel.py``). ``score(req, timeout,
deadline=, lane=)`` rides the deadline scheduler (``serve/deadline.py``, ``serve/batcher.py``), which plans
against ``step_model`` (seeded by the warm-up's timed steps, then fed by every
collect and pipeline readback); bulk chunk dispatches yield to a launching
interactive batch through ``lane_gate``; ``deadline_snapshot()`` is
``/debug/deadlinez``'s payload.

Every batch runs on the engine's device. On a card, every copy and step
goes on one CUDA stream the engine owns, whichever thread launches it, and
launches are enqueued one at a time (``_on_stream``); the cache's delta
copies and the ring's admission copies go on that stream too, so a write
never overtakes a step enqueued before it. There is no host-CPU tier: on a
CUDA engine a small batch goes to the card like a large one, and the CPU
runs a batch only when the caller built the engine with ``device="cpu"``.
Not ported: the host tier.

Over a mesh (``mesh=``, ``parallel/mesh.py``) the engine serves as the JAX
engine does over its serving mesh: every launched batch splits its rows
over ``data`` (the ``routed`` backend over a full expert axis over ``data x
expert``, inside ``parallel/ep.py``), shard by shard, and the packed [5, B] result is the
unsharded engine's, bit for bit, since a row's bits do not depend on its
batch; ``batch_size`` must divide by that split (``_row_divisor``) and
ladder shapes that do not are dropped. With ``MODEL_SHARDING`` (on unless
``0``) and a ``model`` or ``expert`` axis > 1 the params shard too
(``parallel/sharding.py``: the tree bank over ``expert``, the MLP and
multitask trunks over ``model``; never ``routed``), which changes the order
of their sums, not their values or fingerprint. The feature cache and the
session ring split by slot over ``data`` (``parallel/state_sharding.py``,
``STATE_SHARDING``). The mesh's first device is the engine's device: the
batch arrives there and the packed result leaves from there.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from igaming_platform_tpu_torch.convert import BACKEND_KEYS, params_to
from igaming_platform_tpu_torch.core.config import BatcherConfig, ScoringConfig
from igaming_platform_tpu_torch.core.device import host_to_device, resolve_device
from igaming_platform_tpu_torch.core.enums import ReasonCode, action_from_code, decode_reason_mask
from igaming_platform_tpu_torch.core.features import NUM_FEATURES, FeatureVector
from igaming_platform_tpu_torch.models.ensemble import make_score_fn, routed_splits_rows
from igaming_platform_tpu_torch.obs import perfmodel, runtime_telemetry
from igaming_platform_tpu_torch.obs.drift import cached_sketch_kernel, sketch_kernel
from igaming_platform_tpu_torch.obs.perfmodel import OnlineStepModel
from igaming_platform_tpu_torch.obs.tracing import annotate, span
from igaming_platform_tpu_torch.ops.quantize import wire_dequantize_int8, wire_quantize_int8
from igaming_platform_tpu_torch.serve.batcher import ContinuousBatcher, pad_batch
from igaming_platform_tpu_torch.serve import chaos
from igaming_platform_tpu_torch.serve import ledger as ledger_mod
from igaming_platform_tpu_torch.serve.deadline import (
    LANE_BULK,
    LANE_INTERACTIVE,
    Deadline,
    LaneGate,
)
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
    # The ledger's join key (serve/ledger.py): set when a decision ledger is
    # bound, "" otherwise.
    decision_id: str = ""


def _row_divisor(mesh, ml_backend: str) -> int:
    """How many ways the mesh splits a batch's rows: the data axis, times
    the expert axis for the routed backend (GShard row layout)."""
    from igaming_platform_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_EXPERT, mesh_axis_size

    d = mesh_axis_size(mesh, AXIS_DATA)
    if ml_backend == "routed":
        d *= mesh_axis_size(mesh, AXIS_EXPERT)
    return max(1, d)


def data_sharded(make_fn: Callable, mesh) -> Callable:
    """A score step run shard by shard over the mesh's ``data`` axis: each
    shard's contiguous block of rows is scored on its own shard's device,
    with that device's params replica, by ``make_fn(device)``'s step, and
    the outputs are gathered to the mesh's first device. Row-wise, so the
    outputs equal the unsharded ones bit for bit. Params installed by the
    engine carry their replicas (``parallel/sharding.DataReplicas``); other
    params (a shadow candidate's) are copied to a shard's device at first
    use (``collectives.on_device``). On a logical mesh every shard is the
    first device's, and so are its params: no copy."""
    from igaming_platform_tpu_torch.parallel import collectives as coll
    from igaming_platform_tpu_torch.parallel.sharding import DataReplicas

    devs = coll.axis_devices(mesh)
    home = mesh.device
    fns = {d: make_fn(d) for d in set(devs)}

    def sharded(params, x_raw, blacklisted, thresholds=None):
        x_raw = torch.as_tensor(x_raw, dtype=torch.float32, device=home)
        blacklisted = torch.as_tensor(blacklisted, dtype=torch.bool, device=home)
        outs = []
        for c, (dev, xs, bs) in enumerate(zip(devs, torch.tensor_split(x_raw, len(devs)),
                                              torch.tensor_split(blacklisted, len(devs)))):
            if dev == home:
                p = params
            elif isinstance(params, DataReplicas):
                p = params.at(c)
            else:
                p = coll.on_device(params, dev)
            thr = thresholds if thresholds is None else thresholds.to(dev)
            guard = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
            with guard:
                outs.append(fns[dev](p, xs.to(dev), bs.to(dev), thr))
        return {k: coll.unshard_rows([o[k] for o in outs]) for k in outs[0]}

    return sharded


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


def _device_dispatch(fn_name: str, shape, dtype, device=None):
    """The launch chokepoint, as ``serve/scorer.py::_device_dispatch`` of the
    JAX package: the ``device.dispatch`` chaos seam fires, the padded shape
    signature is noted with the compile watcher (``obs/runtime_telemetry``)
    and the dispatch counter counts one (``risk_device_dispatches_total`` and
    the RPC root's ``dispatches``). One dispatch is one launched step, not
    each CUDA kernel inside it. Every step a scoring path launches comes
    through here: the score steps (``_enqueue``), the split drift sketch,
    the shadow scorer's own step, the session admission sync, the cache's
    delta copy and flag write, the abuse model and ``score_arrays``.
    Returns the step's mark on ``device`` (``obs/devtrace.py``): the caller
    enters it around the step's enqueue, on the step's stream; while no
    device timeline is armed it does nothing."""
    chaos.fire("device.dispatch")
    runtime_telemetry.note_compile_signature(fn_name, shape, dtype)
    return runtime_telemetry.note_dispatch(step=(fn_name, shape, device))


def _device_readback(handle) -> dict:
    """The device-to-host drain of one launch (``_launch_padded``'s handle):
    wait for the packed [5, B] copy, then view its first n columns. The
    ``device.readback`` chaos seam fires here, where a stalled or failing
    readback would show."""
    chaos.fire("device.readback")
    host, done, n = handle
    if done is not None:
        done.synchronize()
    return _unpack_host(host.numpy()[:, :n])


def encode_bf16(x: np.ndarray) -> np.ndarray:
    """Host side of ``WIRE_DTYPE=bf16``: float32 rows -> their bfloat16
    bits (torch's round to nearest even), as int16, the dtype numpy can
    hold and pin."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy()


def wire_codec(name: str) -> tuple[np.dtype, Callable[[np.ndarray], np.ndarray] | None]:
    """``WIRE_DTYPE`` -> (the numpy dtype of the row wire, its host encoder,
    None for float32). An unknown value raises: a typo would otherwise
    ship float32 while the operator believes the wire is compressed."""
    name = name.lower()
    if name in ("", "f32", "fp32", "float32"):
        return np.dtype(np.float32), None
    if name in ("bf16", "bfloat16"):
        return np.dtype(np.int16), encode_bf16
    if name == "int8":
        return np.dtype(np.int8), wire_quantize_int8
    raise ValueError(f"WIRE_DTYPE={name!r} not supported (use 'bf16', 'int8' or 'float32')")


def decode_wire(xd: torch.Tensor) -> torch.Tensor:
    """Device side of the row wire: the step's float32 [B, 30] rows from
    the batch as it crossed (float32, bfloat16 bits as int16, or int8
    codes)."""
    if xd.dtype == torch.int16:
        return xd.view(torch.bfloat16).to(torch.float32)
    if xd.dtype == torch.int8:
        return wire_dequantize_int8(xd)
    return xd


@dataclass
class _Variants:
    """What one step hands the drift and shadow seams: the sketch and the
    candidate's packed result computed in the step's own enqueue (None when
    not fused), or what the split layout needs instead: a thunk computing
    the sketch in a later enqueue (``compressed`` when the batch is int8
    wire codes, which are not sketched) and the device copy of the batch
    (``echo``, None on the index paths) with its blacklist and thresholds
    for the shadow's own step."""

    sketch: torch.Tensor | None = None
    shadow_out: torch.Tensor | None = None
    gen: int | None = None
    # The fused sketch or candidate raised: counted, nothing handed on.
    sketch_failed: bool = False
    shadow_failed: bool = False
    split_sketch: Callable[[], torch.Tensor] | None = field(default=None, repr=False)
    # The split sketch's dispatch signature: (name, shape, dtype).
    sketch_sig: tuple = ("sketch_kernel", (), None)
    compressed: bool = False
    echo: torch.Tensor | None = None
    bl: torch.Tensor | None = None
    thresholds: torch.Tensor | None = None


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
        if value is None:
            continue
        if isinstance(value, torch.Tensor):
            value = {"": value}
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
        feature_cache: bool | int | None = None,
        session_state: bool | None = None,
        mesh=None,
    ):
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self.config = config or ScoringConfig()
        self.ml_backend = ml_backend
        score_fn = make_score_fn(self.config, ml_backend, device=self.device, mesh=mesh)
        # The routed mixture over a full expert axis splits its own rows
        # (over data x expert, parallel/ep.py); every other step splits here.
        if (mesh is not None and mesh.shape["data"] > 1
                and not (ml_backend == "routed" and routed_splits_rows(mesh))):
            score_fn = data_sharded(
                lambda dev: make_score_fn(self.config, ml_backend, device=dev, mesh=mesh), mesh)
        self._score_fn = score_fn
        # Model parallelism over the same mesh (MODEL_SHARDING, on unless 0):
        # the forest's trees over ``expert``, the MLP and multitask trunks
        # over ``model``; routed params keep parallel/ep.py's layout.
        self._model_sharded = bool(
            mesh is not None and ml_backend != "routed"
            and os.environ.get("MODEL_SHARDING", "1") not in ("0", "false")
            and (mesh.shape["model"] > 1 or mesh.shape["expert"] > 1))
        self._params, self.params_fingerprint = self._install_fingerprinted(params)
        self._params_lock = threading.Lock()
        # The multihost front refuses the index path (its table cannot ride
        # the work channel).
        self._cache_supported = True
        self.features = feature_store or InMemoryFeatureStore()
        self._wire_dtype, self._wire_encode = wire_codec(os.environ.get("WIRE_DTYPE", ""))
        # The drift engine (bind_drift) and the shadow scorer (set by its
        # owner); None keeps each seam one attribute check. FUSED=0 keeps
        # both on the split layout, SHADOW_FUSED=0 the shadow alone.
        self.drift = None
        self.shadow = None
        # The decision ledger (serve/ledger.py), bound by the serving layer;
        # None keeps every note one attribute check.
        self.ledger = None
        # The serving layer's hooks: the score histogram's feed (host numpy
        # scores of each wire batch) and the ServiceMetrics registries the
        # cache, session plane and host pipeline export to, applied when
        # each is built.
        self.score_observer: Callable[[np.ndarray], None] | None = None
        self._cache_metrics_sink = None
        self._session_metrics_sink = None
        self._pipeline_metrics_sink = None
        self._fused_enabled = os.environ.get("FUSED", "1") not in ("0", "false")
        self._shadow_fused_enabled = os.environ.get("SHADOW_FUSED", "1") not in ("0", "false")
        self._shadow_fused_ready = False
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
        if mesh is not None:
            from igaming_platform_tpu_torch.parallel.mesh import validate_batch_for_mesh

            validate_batch_for_mesh(self.batch_size, mesh)
            # The routed backend splits rows over data x expert: the
            # throughput shape must divide (a boot error, not a failed step);
            # latency tiers that do not are dropped, as in the JAX engine.
            divisor = _row_divisor(mesh, ml_backend)
            if self.batch_size % divisor != 0:
                raise ValueError(
                    f"batch {self.batch_size} not divisible by the mesh row split ({divisor}: "
                    f"data x expert for ml_backend={ml_backend})")
            self._shapes = [s for s in self._shapes if s == self.batch_size or s % divisor == 0]
        # (device tensor, host pair), replaced as one: a dispatch reads both
        # at once (``thresholds_snapshot``).
        host_thr = (self.config.block_threshold, self.config.review_threshold)
        self._thr_state = (self._thresholds_tensor(*host_thr), host_thr)
        # Device steps launched (every step of a gbdt backend launches the
        # forest kernel once); read by tests and the chip smoke.
        self.device_steps = 0
        self._steps_lock = threading.Lock()
        # The device feature cache: built by ensure_cache(), eagerly at
        # warmup when ``feature_cache``/FEATURE_CACHE asks (an int is the
        # capacity) or WIRE_MODE=index, else on the first index request.
        self.cache = None
        self._cache_lock = threading.Lock()
        if feature_cache is None:
            feature_cache = os.environ.get("FEATURE_CACHE", "") not in ("", "0")
        self._cache_capacity = (
            feature_cache if isinstance(feature_cache, int) and not isinstance(feature_cache, bool)
            else int(os.environ.get("FEATURE_CACHE_CAPACITY", "65536")))
        self._cache_eager = bool(feature_cache)
        # Session state (SESSION_STATE=1 or session_state=True): built with
        # the cache, sharing its slot index and CLOCK.
        from igaming_platform_tpu_torch.serve import session_state as session_mod

        self.session = None
        # The fused session step per (sketch, shadow) variant.
        self._session_fns: dict[tuple[bool, bool], Callable] = {}
        self._session_enabled = (session_mod.session_enabled_env() if session_state is None
                                 else bool(session_state))
        # The deadline plane (serve/deadline.py): the online step-time model
        # the scheduler plans batch shapes against (seeded by the warm-up's
        # timed steps) and the gate that lets an interactive batch launch
        # before a bulk chunk waiting on the same stream.
        self.step_model = OnlineStepModel()
        self.lane_gate = LaneGate()
        self._batcher = ContinuousBatcher(
            bcfg, dispatch=self._dispatch_requests, collect=self._collect_requests,
            shapes=self._shapes, step_model=self.step_model, lane_gate=self.lane_gate)
        if warmup:
            self.warmup()
        self._batcher.start()

    # -- lifecycle -----------------------------------------------------------

    def warmup(self) -> None:
        """Run every shape of the ladder twice before taking traffic, so the
        first request pays neither the kernel build nor a first launch, and
        seed the step-time model with each shape's second step (its device
        time between CUDA events on a card, its wall time on the CPU); then
        build the feature cache when it is asked for eagerly or the wire
        mode is index."""
        for shape in self._shapes:
            x = np.zeros((shape, NUM_FEATURES), dtype=np.float32)
            bl = np.zeros((shape,), dtype=bool)
            self._readback(self._launch(x, bl, self.get_params()))
            self.step_model.observe(shape, self._timed_step(x, bl))
        if self._cache_eager or self.wire_mode == "index":
            self.ensure_cache()

    def _timed_step(self, x: np.ndarray, bl: np.ndarray) -> float:
        """Milliseconds of one step of the padded batch ``x``: the device
        time between two CUDA events on the engine's stream on a card, the
        wall time of launch and readback on the CPU."""
        if self.stream is None:
            t0 = time.monotonic()
            self._readback(self._launch(x, bl, self.get_params()))
            return (time.monotonic() - t0) * 1000.0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with self._on_stream():
            start.record(self.stream)
        handle = self._launch(x, bl, self.get_params())
        with self._on_stream():
            end.record(self.stream)
        self._readback(handle)
        end.synchronize()
        return start.elapsed_time(end)

    def close(self) -> None:
        self._batcher.stop()
        if self._host_pipeline is not None:
            self._host_pipeline.close()

    @property
    def pipeline(self):
        """The host pipeline, once built (None before the first pipelined
        wire batch, or when disabled)."""
        return self._host_pipeline

    def _ensure_pipeline(self):
        """Build (once) the staged host pipeline; None when disabled."""
        if not self._pipeline_enabled:
            return None
        if self._host_pipeline is None:
            with self._host_pipeline_lock:
                if self._host_pipeline is None:
                    from igaming_platform_tpu_torch.serve.pipeline_engine import HostPipeline

                    pipe = HostPipeline(self, depth=self._pipeline_depth)
                    if self._pipeline_metrics_sink is not None:
                        pipe.bind_metrics(self._pipeline_metrics_sink)
                    self._host_pipeline = pipe
        return self._host_pipeline

    # -- the serving layer's metrics sinks ------------------------------------

    def bind_pipeline_metrics(self, metrics) -> None:
        """Route the host pipeline's gauges (in-flight depth, overlap ratio)
        into a ServiceMetrics registry, now or when it is built."""
        self._pipeline_metrics_sink = metrics
        if self._host_pipeline is not None:
            self._host_pipeline.bind_metrics(metrics)

    def bind_cache_metrics(self, metrics) -> None:
        """Route the feature cache's counters into a ServiceMetrics
        registry, now or when ``ensure_cache`` builds it."""
        self._cache_metrics_sink = metrics
        if self.cache is not None:
            self.cache.bind_metrics(metrics)

    def bind_session_metrics(self, metrics) -> None:
        """Route the session plane's counters into a ServiceMetrics
        registry, now or when ``ensure_cache`` builds it."""
        self._session_metrics_sink = metrics
        if self.session is not None:
            self.session.bind_metrics(metrics)

    def _observe_scores(self, scores: np.ndarray) -> None:
        """Feed one wire batch's host scores to ``score_observer``; a
        failing observer never fails scoring."""
        if self.score_observer is not None:
            try:
                self.score_observer(scores)
            except Exception:  # noqa: BLE001 — metrics must not fail scoring
                pass

    def deadline_snapshot(self) -> dict:
        """The deadline plane's debug surface (``/debug/deadlinez``): lane
        depths, the expiry-shed, hedge and replay counters, the per-shape
        step-time model and the lane gate's yields."""
        b = self._batcher
        return {
            "lanes": b.scheduler.depths(),
            "queued": b.scheduler.qsize(),
            "batches_run": b.batches_run,
            "rows_scored": b.rows_scored,
            "batches_replayed": b.batches_replayed,
            "batches_hedged": b.batches_hedged,
            "expired_shed": b.expired_shed,
            "dead_dispatched": b.dead_dispatched,
            "lane_gate_yields": self.lane_gate.yields,
            "step_model": self.step_model.snapshot(),
        }

    # -- the drift and shadow seams -------------------------------------------

    def bind_drift(self, drift_engine) -> None:
        """Attach a DriftEngine (``obs/drift.py``; None detaches): from the
        next step on, every step also reduces a sketch of the rows it
        scored, and the drift worker folds it. Eager torch compiles nothing,
        so binding only runs the sketch once at every ladder shape, off the
        request path, so that no request pays its first launches."""
        if drift_engine is not None:
            with self._on_stream(), torch.inference_mode():
                for shape in self._shapes:
                    sketch_kernel(torch.zeros((shape, NUM_FEATURES), device=self.device),
                                  torch.zeros((5, shape), dtype=torch.int32, device=self.device),
                                  shape)
        self.drift = drift_engine

    def _on_shadow_candidate(self, shadow) -> None:
        """The shadow scorer's hook (its constructor, ``set_candidate``,
        ``rebind_engine``). The JAX engine compiles the shadow variants of
        its fused programs here, on a background thread; eager torch
        compiles nothing, so this only marks the variant ready: from the
        next step on a live candidate is scored in the step's own enqueue."""
        self._shadow_fused_ready = True

    def _fused_shadow_state(self):
        """(generation, candidate params) when the next step scores a live
        candidate in its own enqueue; else None."""
        shadow = self.shadow
        if (shadow is None or not self._fused_enabled or not self._shadow_fused_enabled
                or not self._shadow_fused_ready):
            return None
        return shadow.active_state()

    def _step_variants(self, packed: torch.Tensor, x: torch.Tensor, bl: torch.Tensor,
                       thr: torch.Tensor, n: int, *, split_sketch: Callable[[], torch.Tensor],
                       sketch_sig: tuple, echo: torch.Tensor | None = None,
                       compressed: bool = False) -> _Variants | None:
        """Inside a step's enqueue, after its score: the fused sketch of the
        scored rows ``x`` and the candidate's score of them, or what the
        split layout needs; None when neither drift nor a shadow is bound."""
        if self.drift is None and self.shadow is None:
            return None
        v = _Variants(split_sketch=split_sketch, sketch_sig=sketch_sig, compressed=compressed,
                      echo=echo, bl=bl, thresholds=thr)
        if self._fused_enabled and self.drift is not None:
            try:
                v.sketch = sketch_kernel(x, packed, n)
            except Exception:  # noqa: BLE001 — never fails the step; counted by _note_drift
                v.sketch_failed = True
        sstate = self._fused_shadow_state()
        if sstate is not None:
            try:
                v.gen = sstate[0]
                v.shadow_out = _stack_packed(self._score_fn(sstate[1], x, bl, thr))
            except Exception:  # noqa: BLE001 — never fails the step; counted by _note_shadow
                v.shadow_failed = True
        return v

    def _record_event(self):
        """A CUDA event recorded now on the engine's stream; None on the CPU."""
        if self.stream is None:
            return None
        event = torch.cuda.Event()
        event.record(self.stream)
        return event

    def _note_drift(self, v: _Variants, n: int, ready) -> None:
        """Hand one step's sketch to the drift engine: the fused one, or the
        split layout's own enqueue after the step; int8 wire codes on the
        split layout are counted as skipped. Never raises: a failure is
        counted by the drift engine."""
        drift = self.drift
        if drift is None:
            return
        try:
            if v.sketch_failed:
                drift.note_error()
            elif v.sketch is not None:
                drift.submit(v.sketch, n, ready)
            elif v.compressed:
                drift.note_skipped(n, "compressed")
            else:
                mark = _device_dispatch(*v.sketch_sig, self.device)
                with self._on_stream(), torch.inference_mode(), mark:
                    sketch = v.split_sketch()
                    ready = self._record_event()
                drift.submit(sketch, n, ready)
        except Exception:  # noqa: BLE001 — drift must never fail scoring; counted
            drift.note_error()

    def _note_shadow(self, packed: torch.Tensor, v: _Variants, n: int, ready) -> None:
        """Hand one step to the shadow scorer: the candidate's packed result
        from the step's enqueue, or the device copy of the batch for the
        shadow's own step; index-path rows on the split layout are counted
        as skipped. Never raises: a failure is counted by the shadow."""
        shadow = self.shadow
        if shadow is None:
            return
        try:
            if v.shadow_failed:
                shadow.note_error()
            elif v.shadow_out is not None:
                shadow.submit_scored(packed, v.shadow_out, n, v.gen, ready)
            elif v.echo is None:
                shadow.note_skipped(n)
            else:
                # On the CPU the batch's tensor shares the staging buffer,
                # which the pipeline reuses after the readback: copy it.
                echo = v.echo if self.stream is not None else v.echo.clone()
                shadow.submit_echo(packed, echo, v.bl, n, v.thresholds, ready)
        except Exception:  # noqa: BLE001 — the shadow must never fail scoring; counted
            shadow.note_error()

    # -- params / thresholds -------------------------------------------------

    def _install(self, params: Any) -> Any:
        missing = [k for k in BACKEND_KEYS[self.ml_backend]
                   if not params or k not in params or params[k] is None]
        if missing:
            raise ValueError(f"ml_backend={self.ml_backend!r} needs params {missing}")
        return params_to(params, self.device)

    def _install_fingerprinted(self, params: Any) -> tuple[Any, str]:
        """(installed params, their fingerprint): the fingerprint of the
        values, taken before a model-sharded engine lays them over its mesh
        (layout only, so sharding never changes it)."""
        installed = self._install(params)
        fingerprint = params_fingerprint(installed)
        if self.mesh is not None and installed is not None:
            from igaming_platform_tpu_torch.parallel import sharding

            def lay(p, c):
                if not self._model_sharded:
                    return p
                return sharding.shard_model_params(self.mesh, self.ml_backend, p, c)

            # One replica per distinct data device (each data shard scores
            # on its own card); a logical mesh keeps one.
            installed = sharding.replicate_over_data(self.mesh, installed, lay)
        return installed, fingerprint

    def swap_params(self, params: Any) -> None:
        """Atomically install new model parameters (copied to the device
        before the swap, so scoring never waits on the copy; laid over the
        mesh as the boot params were)."""
        installed, fingerprint = self._install_fingerprinted(params)
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

    @property
    def _thresholds(self) -> torch.Tensor:
        return self._thr_state[0]

    def get_thresholds(self) -> tuple[int, int]:
        return self._thr_state[1]

    def thresholds_snapshot(self) -> tuple[torch.Tensor, tuple[int, int]]:
        """(device tensor, (block, review)) of one ``set_thresholds``: a
        dispatch launches with the tensor and notes the pair, so a record
        carries the thresholds that scored it even if they change before
        the readback."""
        return self._thr_state

    def set_thresholds(self, block: int, review: int) -> None:
        """Runtime threshold tuning (engine.go:498-504): a new [2] input
        tensor, nothing rebuilt."""
        self._thr_state = (self._thresholds_tensor(block, review), (int(block), int(review)))

    # -- scoring -------------------------------------------------------------

    def score(self, req: ScoreRequest, timeout: float = 30.0, deadline: Deadline | None = None,
              lane: str = LANE_INTERACTIVE) -> ScoreResponse:
        """Single-transaction scoring through the continuous batcher.
        ``deadline`` rides into the scheduler: EDF order within ``lane``,
        shed (``DeadlineExpired``) instead of scored if it runs out while
        queued."""
        start = time.monotonic()
        resp: ScoreResponse = self._batcher.score_sync(req, timeout=timeout, deadline=deadline,
                                                       lane=lane)
        resp.response_time_ms = (time.monotonic() - start) * 1000.0
        return resp

    def score_batch(self, reqs: list[ScoreRequest]) -> list[ScoreResponse]:
        """Direct batch path (ScoreBatch RPC), chunked to ``batch_size``:
        an oversized batch runs as several device steps."""
        start = time.monotonic()
        responses: list[ScoreResponse] = []
        for i in range(0, len(reqs), self.batch_size):
            chunk = reqs[i : i + self.batch_size]
            with span("score.gather", batch=len(chunk)):
                x, bl = self.features.gather_batch(chunk)
            params, fp = self.params_snapshot()
            thr, thr_host = self.thresholds_snapshot()
            with span("score.device", batch=len(chunk)), annotate("score_step"):
                host = self._readback(self._launch(x, bl, params, thr))
            rows = [self._row_response(host, x, j) for j in range(len(chunk))]
            self._note_decisions_requests(host, x, bl, chunk, rows, "batch", fp, thr_host)
            responses.extend(rows)
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
        no per-row request or response object. With ``WIRE_MODE=index`` the
        rows score through the device feature cache, and the response has no
        feature echo (the rows never exist on the host)."""
        start = time.monotonic()
        if self.wire_mode == "index":
            from igaming_platform_tpu_torch.serve.wire import TX_TYPE_CODES, encode_score_batch

            self.ensure_cache()
            total = len(account_ids)
            types = [TX_TYPE_CODES.get(t, 4) for t in tx_types]
            bl = self._blacklist_flags(total, ips, devices, fingerprints)
            cat, rtms = self._indexed_outputs(list(account_ids), amounts, types, bl, start)
            with span("score.encode", batch=total):
                return encode_score_batch(cat["score"], cat["action"], cat["reason_mask"],
                                          cat["rule_score"], cat["ml_score"], rtms, None)
        with span("score.gather", batch=len(account_ids)):
            if hasattr(self.features, "gather_columns"):
                x, bl = self.features.gather_columns(
                    account_ids, amounts, tx_types, ips=ips, devices=devices,
                    fingerprints=fingerprints)
            else:
                x, bl = self.features.gather_batch([
                    ScoreRequest(account_id=account_ids[i], amount=amounts[i],
                                 tx_type=tx_types[i], ip=ips[i] if ips else "",
                                 device_id=devices[i] if devices else "",
                                 fingerprint=fingerprints[i] if fingerprints else "")
                    for i in range(len(account_ids))])
        return self._score_rows_to_wire(x, bl, include_features, start, account_ids)

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
        with span("score.decode") as dsp:
            x, bl = self.features.decode_gather(payload)
            dsp.attributes["batch"] = int(x.shape[0])
        return self._score_rows_to_wire(x, bl, include_features, start), x.shape[0]

    def _score_rows_to_wire(self, x: np.ndarray, bl: np.ndarray, include_features: bool,
                            start: float, account_ids=None) -> bytes:
        """A gathered [N, 30] batch to response bytes: through the host
        pipeline when enabled, else the lockstep flow. Bit-exact either way.
        ``account_ids``, where the caller still has them (the columnar path),
        ride to the decision ledger; the bytes path notes rows without them."""
        pipe = self._ensure_pipeline()
        if pipe is not None:
            return pipe.score_rows_to_wire(x, bl, include_features, start, account_ids)
        return self._score_rows_encode(x, bl, include_features, start, account_ids)

    def _score_rows_encode(self, x: np.ndarray, bl: np.ndarray, include_features: bool,
                           start: float, account_ids=None) -> bytes:
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
            with span("score.readback", batch=handle[2]):
                host = _device_readback(handle)
            for k in RESULT_KEYS:
                parts[k].append(host[k])
            rtms[lo:lo + handle[2]] = int((time.monotonic() - start) * 1000.0)

        params, fp = self.params_snapshot()
        thr, thr_host = self.thresholds_snapshot()
        for lo in range(0, total, self.batch_size):
            hi = min(lo + self.batch_size, total)
            self.lane_gate.acquire(LANE_BULK)
            with span("score.dispatch", batch=hi - lo), annotate("score_step"):
                inflight.append((self._launch(x[lo:hi], bl[lo:hi], params, thr), lo))
            if len(inflight) > self._pipeline_depth:
                read_one()
        while inflight:
            read_one()
        cat = {k: np.concatenate(v) for k, v in parts.items()}
        self._observe_scores(cat["score"])
        with span("score.ledger_note", batch=total):
            ledger_mod.note_decisions(self, cat, n=total, wire_mode="wire_row", x=x, bl=bl,
                                      account_ids=account_ids, params_fp=fp,
                                      thresholds=thr_host)
        with span("score.encode", batch=total):
            return encode_score_batch(cat["score"], cat["action"], cat["reason_mask"],
                                      cat["rule_score"], cat["ml_score"], rtms,
                                      x if include_features else None)

    def step_cost(self, n_rows: int | None = None) -> dict[str, float]:
        """{"flops", "bytes"} of one packed score step at the ladder shape
        that holds ``n_rows`` (the batch size by default), counted from its
        kernels (``obs/perfmodel.py``) on zero rows, plus the step's
        elementwise passes as bytes: the batch read in the wire's dtype with
        its blacklist, the packed [5, B] int32 result written. The numerator
        of ``perfmodel.utilization``; the count launches one step."""
        shape = self._pick_shape(n_rows or self.batch_size)
        x = torch.zeros((shape, NUM_FEATURES), dtype=torch.float32, device=self.device)
        bl = torch.zeros((shape,), dtype=torch.bool, device=self.device)
        with self._on_stream(), torch.inference_mode():
            cost = perfmodel.cost_of(self._score_fn, self.get_params(), x, bl, self._thresholds)
        if self.stream is not None:
            self.stream.synchronize()
        passes = shape * (NUM_FEATURES * self._wire_dtype.itemsize + 1) + 5 * shape * 4
        return perfmodel.add_bytes(cost, passes)

    def score_arrays(self, x: np.ndarray, blacklisted: np.ndarray | None = None) -> dict:
        """Score a pre-gathered [N, 30] float32 batch as it is (no padding),
        through the row wire (``WIRE_DTYPE``) as a launched batch would go;
        returns the dict of [N] tensors on the engine's device. No drift or
        shadow note."""
        if blacklisted is None:
            blacklisted = np.zeros((x.shape[0],), dtype=bool)
        if self._wire_encode is not None and x.dtype != self._wire_dtype:
            x = self._wire_encode(np.asarray(x, np.float32))
        mark = _device_dispatch("score_arrays", x.shape, x.dtype, self.device)
        with torch.inference_mode(), mark:
            xd = decode_wire(torch.from_numpy(np.ascontiguousarray(x)).to(self.device))
            out = self._score_fn(self.get_params(), xd, blacklisted, self._thresholds)
        self._count_step()
        return out

    def update_features(self, event: TransactionEvent) -> None:
        """Post-transaction write-back (engine.go:486-488)."""
        self.features.update(event)

    # -- the device feature cache and the session plane -----------------------

    def _note_session_bypass(self, n: int) -> None:
        """Rows scored on a row path while session state is on: counted as
        bypass (the account's window does not advance), never silent."""
        if self.session is not None and n > 0:
            self.session.note_bypass(n)

    def ensure_cache(self):
        """Build (once) the device feature table and the cached step, run the
        step at every ladder shape, and build the session plane when it is
        on. Called at warmup or by the first index-mode request."""
        if self.cache is not None:
            return self.cache
        if not self._cache_supported:
            raise RuntimeError("device feature cache unsupported on this engine "
                               "(multihost front: the table cannot ride the work channel)")
        with self._cache_lock:
            if self.cache is not None:
                return self.cache
            from igaming_platform_tpu_torch.serve.device_cache import DeviceFeatureCache

            if self._cache_capacity < self.batch_size:
                # A chunk may hold batch_size distinct accounts, and a lookup
                # never reclaims a slot its own rows read.
                raise ValueError(f"feature cache capacity {self._cache_capacity} is smaller "
                                 f"than the batch size {self.batch_size}")

            max_age = os.environ.get("FEATURE_CACHE_MAX_AGE_S")
            cache = DeviceFeatureCache(self.features, capacity=self._cache_capacity,
                                       device=self.device, on_stream=self._on_stream,
                                       mesh=self.mesh,
                                       max_age_s=float(max_age) if max_age else None,
                                       metrics=self._cache_metrics_sink)
            # The store's write-back hook: every update marks the account's
            # row for the next lookup's delta copy.
            if hasattr(self.features, "delta_listener"):
                self.features.delta_listener = cache.note_update
            params = self.get_params()
            for shape in self._shapes:
                args = self._device_args(np.zeros((shape,), np.int64),
                                         np.zeros((shape,), np.float32),
                                         np.full((shape,), 4, np.int32), np.zeros((shape,), bool))
                self._readback(self._enqueue(
                    lambda: self._cached_step(params, cache, *args())[0], shape,
                    ("cached_step", (shape,), np.dtype(np.int64))))
            self._ensure_session(cache)
            self.cache = cache
        return cache

    def _cached_step(self, params, cache, idxs, amounts, types, bl, thr=None):
        """The cached step: (packed [5, B], the composed rows, their
        blacklist, the thresholds it used: ``thr``, else the engine's)."""
        from igaming_platform_tpu_torch.serve.device_cache import compose_rows

        x, blv = compose_rows(cache.table, cache.flags, idxs, amounts, types, bl)
        thr = self._thresholds if thr is None else thr
        return _stack_packed(self._score_fn(params, x, blv, thr)), x, blv, thr

    def _session_step_for(self, mgr, sketch: bool, shadow: bool):
        """The fused session step of one (sketch, shadow) variant over the
        session plane ``mgr``, built on first use."""
        step = self._session_fns.get((sketch, shadow))
        if step is None:
            from igaming_platform_tpu_torch.serve import session_state as session_mod

            step = session_mod.make_session_step(
                self._score_fn, self.config, mgr.head_fn, capacity=mgr.capacity,
                n_events=mgr.n_events, min_events=mgr.min_events,
                flag_threshold=mgr.flag_threshold, sketch=sketch, shadow=shadow,
                plan=mgr.plan)
            self._session_fns[(sketch, shadow)] = step
        return step

    def _session_variant_step(self, mgr, sketch: bool, sstate, n: int, *args):
        """Run the session step variant that carries the sketch and the live
        candidate (``sstate``) and return (its outputs, ``_Variants``). The
        step writes the ring only after both, so a variant that raises has
        changed nothing: its error is counted by the shadow (or the drift
        engine) and the next simpler variant runs, down to the plain step."""
        shadow = sstate is not None
        v = _Variants()
        while True:
            extra = (sstate[1] if shadow else None, n) if sketch or shadow else ()
            try:
                res = self._session_step_for(mgr, sketch, shadow)(*args, *extra)
                break
            except Exception:  # noqa: BLE001 — the observers never fail the step
                if shadow:
                    shadow, v.shadow_failed = False, True
                elif sketch:
                    sketch, v.sketch_failed = False, True
                else:
                    raise
        if sketch:
            v.sketch = res[4]
        if shadow:
            v.gen, v.shadow_out = sstate[0], res[-1]
        return res, v

    def _ensure_session(self, cache) -> None:
        """Build (once) the session plane beside a new cache: the device ring
        and host index, the fused step, run at every ladder shape against
        the scratch slot (no real window moves), and the cache's admission
        hook, so one CLOCK decision governs both tables. The caller holds
        ``_cache_lock``."""
        if not self._session_enabled or self.session is not None:
            return
        from igaming_platform_tpu_torch.serve import session_state as session_mod

        mgr = session_mod.SessionStateManager(cache.capacity, device=self.device,
                                              on_stream=self._on_stream, mesh=self.mesh,
                                              metrics=self._session_metrics_sink)
        step = self._session_step_for(mgr, False, False)
        params = self.get_params()
        with mgr.lock:
            for shape in self._shapes:
                args = self._device_args(
                    np.zeros((shape,), np.int64), np.full((shape,), cache.capacity, np.int64),
                    np.arange(shape, dtype=np.int32), np.zeros((shape,), np.float32),
                    np.full((shape,), 4, np.int32),
                    np.zeros((shape, session_mod.EVENT_WIDTH), np.float32),
                    np.zeros((shape,), bool), np.zeros((0,), np.int64))

                def warm():
                    idxs, sidx, occ, amounts, types, events, bl, app = args()
                    packed, ring, cur, ln = step(
                        params, mgr.head_params, cache.table, cache.flags, mgr.session_ring,
                        mgr.session_cursor, mgr.session_length, idxs, sidx, occ, amounts,
                        types, events, bl, self._thresholds, app)
                    mgr.adopt(ring, cur, ln)
                    return packed

                self._readback(self._enqueue(warm, shape,
                                             ("session_step", (shape,), np.dtype(np.int64))))
        cache.session_hook = mgr.on_admit
        self.session = mgr

    def _device_args(self, *arrays: np.ndarray):
        """A thunk that copies ``arrays`` to the engine's device; called
        inside ``_enqueue``, so the copies go on the engine's stream."""
        return lambda: [host_to_device(a, self.device) for a in arrays]

    def _launch_cached(self, idxs: np.ndarray, amounts: np.ndarray, types: np.ndarray,
                       bl: np.ndarray, params: Any, account_ids=None, now: float | None = None,
                       thr=None):
        """Launch the cached step with the thresholds tensor ``thr`` (else
        the engine's): the device gathers the rows from the table; only
        int32 slots and the per-transaction context cross to the card. Pad
        rows read slot 0, scored and discarded.

        With session state on (and ``account_ids`` given) the fused session
        step runs instead: the host index commit and the device append under
        the manager's lock, so the ring advances in the host index's order.
        Returns (handle, n, session_meta); ``session_meta`` holds each row's
        post-append length, event sequence number and lazy session hash
        (``SessionChunkAudit``) and the chunk's time, the fields a decision
        ledger records; None on the plain path."""
        n = idxs.shape[0]
        shape = self._pick_shape(n)
        thr = self._thresholds if thr is None else thr
        with span("score.pad", batch=n):
            idxsp, _ = pad_batch(idxs.astype(np.int64), shape)
            amtp, _ = pad_batch(amounts, shape)
            typp, _ = pad_batch(types, shape)
            blp, _ = pad_batch(bl, shape)
        cache, mgr = self.cache, self.session
        if mgr is not None and account_ids is not None:
            from igaming_platform_tpu_torch.serve.session_state import surviving_appends

            with mgr.lock:
                ts = now if now is not None else cache.clock()
                with span("score.session", batch=n):
                    events, occ, post_len, seqs, audit = mgr.prepare_chunk(
                        account_ids, amounts, types, ts)
                with span("score.pad", batch=n):
                    evp, _ = pad_batch(events, shape)
                    occp, _ = pad_batch(occ, shape)
                # Pad rows all target the scratch slot, at distinct ranks.
                sidxp = np.full((shape,), mgr.capacity, dtype=np.int64)
                sidxp[:n] = idxs
                occp[n:] = np.arange(shape - n, dtype=np.int32)
                args = self._device_args(idxsp, sidxp, occp, amtp, typp, evp, blp,
                                         surviving_appends(idxs, occ, mgr.n_events))

                def step():
                    *inputs, app = args()
                    sketch = self._fused_enabled and self.drift is not None
                    sstate = self._fused_shadow_state()
                    res, v = self._session_variant_step(
                        mgr, sketch, sstate, n, params, mgr.head_params, cache.table, cache.flags,
                        mgr.session_ring, mgr.session_cursor, mgr.session_length, *inputs,
                        thr, app)
                    packed = res[0]
                    mgr.adopt(*res[1:4])
                    if self.drift is None and self.shadow is None:
                        return packed
                    idx_d, amt_d, typ_d = inputs[0], inputs[3], inputs[4]
                    v.split_sketch = lambda: cached_sketch_kernel(
                        cache.table, idx_d, amt_d, typ_d, packed, n)
                    v.sketch_sig = ("cached_sketch_kernel", idxsp.shape, idxsp.dtype)
                    return packed, v

                handle = self._enqueue(step, n, ("session_step", idxsp.shape, idxsp.dtype))
            return handle, n, {"ts": ts, "lens": post_len, "seqs": seqs, "hashes": audit}
        args = self._device_args(idxsp, amtp, typp, blp)

        def cached():
            idx_d, amt_d, typ_d, bl_d = args()
            packed, x, blv, _ = self._cached_step(params, cache, idx_d, amt_d, typ_d, bl_d, thr)
            return packed, self._step_variants(
                packed, x, blv, thr, n, split_sketch=lambda: cached_sketch_kernel(
                    cache.table, idx_d, amt_d, typ_d, packed, n),
                sketch_sig=("cached_sketch_kernel", idxsp.shape, idxsp.dtype))

        return self._enqueue(cached, n, ("cached_step", idxsp.shape, idxsp.dtype)), n, None

    def _blacklist_flags(self, n: int, ips, devices, fingerprints) -> np.ndarray:
        """The per-request blacklist vector from the store's host sets: the
        part of the gather the cached path keeps on the host."""
        bl = np.zeros((n,), dtype=bool)
        if not any(getattr(self.features, "_blacklists", {}).values()):
            return bl

        def col(values, i) -> str:
            if values is None:
                return ""
            v = values[i]
            return v.decode() if isinstance(v, (bytes, memoryview)) else v

        for i in range(n):
            bl[i] = self.features.check_blacklist(col(devices, i), col(fingerprints, i),
                                                  col(ips, i))
        return bl

    def _indexed_outputs(self, account_ids, amounts, types, bl, start: float,
                         now: float | None = None):
        """Chunked scoring through the cached step -> (result dict, per-row
        response times). Chunks go lookup, then launch, in order (each
        lookup copies pending deltas into the table before its step); at
        most ``pipeline_depth`` chunks are in flight."""
        total = len(account_ids)
        amounts32 = np.ascontiguousarray(amounts, dtype=np.float32)
        types32 = np.ascontiguousarray(types, dtype=np.int32)
        parts: dict[str, list[np.ndarray]] = {k: [] for k in RESULT_KEYS}
        rtms = np.empty((total,), dtype=np.int64)
        inflight: deque = deque()
        params, fp = self.params_snapshot()
        thr, thr_host = self.thresholds_snapshot()
        session_on = self.session is not None

        def read_one() -> None:
            handle, lo, n, smeta = inflight.popleft()
            with span("score.readback", batch=n):
                host = _device_readback(handle)
            for k in RESULT_KEYS:
                parts[k].append(host[k])
            rtms[lo:lo + n] = int((time.monotonic() - start) * 1000.0)
            if smeta is not None:
                # Session-scored chunks are noted one by one: one note, one
                # step, one batch-start snapshot of the windows, so replay
                # rebuilds every row's window (duplicate accounts included)
                # from the ledger's order and the recorded session fields.
                with span("score.ledger_note", batch=n):
                    ledger_mod.note_decisions(
                        self, host, n=n, wire_mode="index", tier="device", bl=bl[lo:lo + n],
                        account_ids=account_ids[lo:lo + n], amounts=amounts32[lo:lo + n],
                        tx_codes=types32[lo:lo + n], params_fp=fp, thresholds=thr_host,
                        ts=smeta["ts"], session_lens=smeta["lens"],
                        session_seqs=smeta["seqs"], session_hashes=smeta["hashes"],
                        mark_root=(lo == 0))

        for lo in range(0, total, self.batch_size):
            hi = min(lo + self.batch_size, total)
            with self.cache.step_lock:
                with span("score.cache_lookup", batch=hi - lo):
                    idxs = self.cache.lookup(account_ids[lo:hi], now=now)
                self.lane_gate.acquire(LANE_BULK)
                with span("score.dispatch", batch=hi - lo), annotate("score_step"):
                    handle, n, smeta = self._launch_cached(
                        idxs, amounts32[lo:hi], types32[lo:hi], bl[lo:hi], params,
                        account_ids=account_ids[lo:hi] if session_on else None, now=now,
                        thr=thr)
            inflight.append((handle, lo, n, smeta))
            if len(inflight) > self._pipeline_depth:
                read_one()
        while inflight:
            read_one()
        cat = {k: np.concatenate(v) if len(v) > 1 else v[0] for k, v in parts.items()}
        self._observe_scores(cat["score"])
        if not session_on:
            # The rows live in the device table and never reach the host, so
            # the records carry the per-transaction context and the outputs
            # without a feature snapshot (replay counts them as skipped).
            with span("score.ledger_note", batch=total):
                ledger_mod.note_decisions(self, cat, n=total, wire_mode="index", tier="device",
                                          bl=bl, account_ids=account_ids, amounts=amounts32,
                                          tx_codes=types32, params_fp=fp, thresholds=thr_host)
        return cat, rtms

    def score_columns_cached(self, account_ids, amounts, tx_types, ips=None, devices=None,
                             fingerprints=None, now: float | None = None) -> dict:
        """Columnar scoring through the device feature table -> the result
        dict (score, action, reason_mask, rule_score, ml_score as host
        arrays). Bit-identical to the host-gather path for the same ``now``."""
        self.ensure_cache()
        from igaming_platform_tpu_torch.serve.wire import TX_TYPE_CODES

        n = len(account_ids)
        types = [TX_TYPE_CODES.get(t, 4) for t in tx_types]
        bl = self._blacklist_flags(n, ips, devices, fingerprints)
        cat, _ = self._indexed_outputs(list(account_ids), amounts, types, bl,
                                       time.monotonic(), now=now)
        return cat

    def score_batch_wire_index(self, payload: bytes) -> tuple[bytes, int]:
        """An index-mode ScoreBatch frame (``IDX1``) -> (risk.v1
        ScoreBatchResponse bytes without the feature echo, rows). Raises
        ValueError on a malformed frame."""
        from igaming_platform_tpu_torch.serve.wire import decode_index_batch, encode_score_batch

        start = time.monotonic()
        with span("score.decode") as dsp:
            ids, amounts, codes, ips, devices, fingerprints = decode_index_batch(payload)
            dsp.attributes["batch"] = len(ids)
        if len(ids) == 0:
            return b"", 0
        self.ensure_cache()
        with span("score.blacklist", batch=len(ids)):
            bl = self._blacklist_flags(len(ids), ips, devices, fingerprints)
        cat, rtms = self._indexed_outputs(ids, amounts, codes, bl, start)
        with span("score.encode", batch=len(ids)):
            return encode_score_batch(cat["score"], cat["action"], cat["reason_mask"],
                                      cat["rule_score"], cat["ml_score"], rtms,
                                      None), len(ids)

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

    def _launch(self, x: np.ndarray, bl: np.ndarray, params: Any, thr=None):
        """Pad into fresh arrays and launch (``_launch_padded``)."""
        n = x.shape[0]
        shape = self._pick_shape(n)
        if self._wire_encode is not None:
            # Encode before padding: zero pads stay zero in either wire.
            x = self._wire_encode(x)
        with span("score.pad", batch=n):
            xp, _ = pad_batch(x, shape)
            blp, _ = pad_batch(bl, shape)
        return self._launch_padded(xp, blp, n, params, thr=thr)

    @contextlib.contextmanager
    def _on_stream(self):
        """The engine's dispatch lock and, on a card, its stream: every copy,
        step and state write of the engine is enqueued inside this."""
        with self._dispatch_lock, (torch.cuda.stream(self.stream) if self.stream is not None
                                   else contextlib.nullcontext()):
            yield

    def _enqueue(self, step, n: int, sig: tuple):
        """Run ``step`` (its input copies and its launches; it returns the
        packed [5, B] result, or that and the step's ``_Variants``) on the
        engine's stream, then start the copy of the result back to pinned
        host memory, without waiting, and hand the variants to the drift and
        shadow seams with the event recorded after the copy. Returns a
        handle for ``_readback``. The step is one dispatch, signature
        ``sig`` = (name, padded shape, dtype), noted first, outside the
        dispatch lock (``_device_dispatch``)."""
        mark = _device_dispatch(*sig, self.device)
        with self._on_stream(), torch.inference_mode(), mark:
            res = step()
            packed, variants = res if isinstance(res, tuple) else (res, None)
            if self.stream is not None:
                host = torch.empty(packed.shape, dtype=torch.int32, pin_memory=True)
                host.copy_(packed, non_blocking=True)
            else:
                host = packed
            done = self._record_event()
            self._count_step()
        if variants is not None and n > 0:
            self._note_drift(variants, n, done)
            self._note_shadow(packed, variants, n, done)
        return host, done, n

    def _launch_padded(self, xp: np.ndarray, blp: np.ndarray, n: int, params: Any,
                       hold=None, thr=None):
        """Copy one padded batch to the device, run the step and start the
        copy of the packed [5, B] result back (``_enqueue``). From pinned
        staging buffers the input copies are asynchronous too: ``hold``
        (``serve/arena.StagingHold``) then gets the event recorded after
        them, and keeps the buffers from the pool until it has passed. The
        batch crosses in the wire's dtype and is decoded at the step's head.
        ``thr`` is the thresholds tensor the step uses, else the engine's."""
        self._note_session_bypass(n)
        thr = self._thresholds if thr is None else thr

        def step():
            xd = torch.from_numpy(xp).to(self.device, non_blocking=True)
            bld = torch.from_numpy(blp).to(self.device, non_blocking=True)
            if hold is not None:
                hold.copied = self._record_event()
            x = decode_wire(xd)
            packed = _stack_packed(self._score_fn(params, x, bld, thr))
            return packed, self._step_variants(
                packed, x, bld, thr, n, split_sketch=lambda: sketch_kernel(x, packed, n),
                sketch_sig=("sketch_kernel", xp.shape, xp.dtype), echo=xd,
                compressed=xd.dtype == torch.int8)

        return self._enqueue(step, n, ("packed_step", xp.shape, xp.dtype))

    _readback = staticmethod(_device_readback)

    # Two-phase batcher hooks: dispatch on the launcher thread, collect on
    # the collector thread, so batch k+1 launches while batch k's results
    # are still on their way back.

    def _dispatch_requests(self, reqs: list[ScoreRequest]):
        # Spans per batch, not per request: the batcher's thread serves the
        # requests of many RPCs at once, so these are batch-level roots.
        with span("score.gather", batch=len(reqs)):
            x, bl = self.features.gather_batch(reqs)
        params, fp = self.params_snapshot()
        thr, thr_host = self.thresholds_snapshot()
        with span("score.dispatch", batch=len(reqs)), annotate("score_step"):
            launched = self._launch(x, bl, params, thr)
        return launched, x, bl, reqs, fp, thr_host

    def _collect_requests(self, handle) -> list[ScoreResponse]:
        launched, x, bl, reqs, fp, thr_host = handle
        with span("score.readback", batch=launched[2]):
            host = self._readback(launched)
        rows = [self._row_response(host, x, i) for i in range(x.shape[0])]
        self._note_decisions_requests(host, x, bl, reqs, rows, "single", fp, thr_host)
        return rows

    def _note_decisions_requests(self, out: dict, x: np.ndarray, bl: np.ndarray, reqs,
                                 responses: list[ScoreResponse], wire_mode: str,
                                 params_fp: str, thresholds: tuple[int, int]) -> None:
        """The ledger note of the request-object paths (batcher, direct
        batch): one note for the launched batch, with the fingerprint and
        thresholds it was dispatched with, and its decision ids stamped on
        the responses."""
        if self.ledger is None and self.shadow is None:
            return
        with span("score.ledger_note", batch=len(responses)):
            prefix = ledger_mod.note_decisions(
                self, out, n=len(responses), wire_mode=wire_mode, x=x, bl=bl,
                params_fp=params_fp, thresholds=thresholds,
                account_ids=[r.account_id for r in reqs], amounts=[r.amount for r in reqs],
                tx_codes=[r.tx_type for r in reqs])
        if prefix is not None:
            for i, resp in enumerate(responses):
                resp.decision_id = f"{prefix}.{i}"

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
