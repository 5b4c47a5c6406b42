"""Port parity: serve/pipeline_engine.py (the staged host pipeline) and
serve/arena.py (staging buffers and their holds).

The pipeline changes when host work happens, never what comes out: on an
engine chunked at 64 rows, its ScoreBatchResponse bytes equal the lockstep
path's bit for bit (response_time_ms masked, as it is a clock reading), as
tests/test_host_pipeline.py pins for the JAX package. A staging buffer does
not go back to the pool before its hold is released and its copy event has
passed.
"""

import time

import numpy as np
import pytest
from test_torch_ensemble import jax_tree
from torch_front_common import T0, event_columns, fill, requests

from igaming_platform_tpu_torch.convert import from_jax_params
from igaming_platform_tpu_torch.core.config import BatcherConfig
from igaming_platform_tpu_torch.serve import risk_codec as codec
from igaming_platform_tpu_torch.serve.arena import ArenaPool, StagingHold
from igaming_platform_tpu_torch.serve.native_store import NativeFeatureStore
from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine


def masked(payload: bytes) -> bytes:
    """A ScoreBatchResponse with every response_time_ms zeroed."""
    msg = codec.decode(codec.SCORE_BATCH_RESPONSE, payload)
    for row in msg["results"]:
        row["response_time_ms"] = 0
    return codec.encode(codec.SCORE_BATCH_RESPONSE, msg)


@pytest.fixture(scope="module", params=["mock", "mlp+gbdt"])
def engine(request):
    store = NativeFeatureStore(max_accounts=500, clock=lambda: T0)
    fill([store], event_columns(3, 80, 2000), blacklist=[("device", "dev4")])
    eng = TorchScoringEngine(ml_backend=request.param,
                             params=from_jax_params(request.param, jax_tree(request.param)),
                             batcher_config=BatcherConfig(batch_size=64, latency_tiers=(16,),
                                                          max_wait_ms=1.0),
                             feature_store=store, device="cpu")
    yield eng
    eng.close()


@pytest.mark.parametrize("n", [1, 64, 150, 300])
def test_pipeline_bit_exact_vs_lockstep(engine, n):
    """Same chunks, same padded shapes, same step: the same bytes, feature
    echo included, at sizes with partial last chunks (padded to 16 or 64)."""
    payload = codec.encode(codec.SCORE_BATCH_REQUEST, {"transactions": requests(4, n, 80)})
    x, bl = engine.features.decode_gather(payload)
    assert bl.any() or n < 64
    lockstep = engine._score_rows_encode(x, bl, True, time.monotonic())
    pipe = engine._ensure_pipeline()
    steps = engine.device_steps
    pipelined = pipe.score_rows_to_wire(x, bl, True, time.monotonic())
    assert engine.device_steps - steps == -(-n // 64)
    assert len(codec.decode(codec.SCORE_BATCH_RESPONSE, pipelined)["results"]) == n
    assert masked(pipelined) == masked(lockstep)
    assert masked(engine.score_batch_wire_bytes(payload)[0]) == masked(lockstep)
    stats = pipe.stats()["arena"]
    assert stats["idle"] == stats["allocated"]  # every hold released after readback


class _Event:
    """A CUDA event stand-in that records being waited on."""

    def __init__(self):
        self.waited = False

    def synchronize(self):
        self.waited = True


def test_staging_buffer_not_reused_before_its_hold_is_released():
    pool = ArenaPool()
    xp, blp = pool.acquire((16, 30), np.float32), pool.acquire((16,), np.bool_)
    hold = StagingHold(pool, (xp, blp), parties=2)
    hold.copied = _Event()
    assert pool.acquire((16, 30), np.float32) is not xp  # still held: a fresh buffer
    hold.release()
    assert not hold.copied.waited and pool.acquire((16,), np.bool_) is not blp
    hold.release()  # the last party: waits for the copy event, then returns both
    assert hold.copied.waited
    assert pool.acquire((16, 30), np.float32) is xp and pool.acquire((16,), np.bool_) is blp
    assert pool.stats() == {"allocated": 4, "reused": 2, "idle": 0}


def test_pipeline_off_closed_and_empty(engine, monkeypatch):
    """HOST_PIPELINE=0 keeps the lockstep flow; an empty batch is empty
    bytes; a closed pipeline refuses work."""
    monkeypatch.setenv("HOST_PIPELINE", "0")
    eng = TorchScoringEngine(batcher_config=BatcherConfig(batch_size=64), device="cpu",
                             warmup=False)
    try:
        assert eng._ensure_pipeline() is None
    finally:
        eng.close()
    pipe = engine._ensure_pipeline()
    assert pipe.score_rows_to_wire(np.zeros((0, 30), np.float32), np.zeros(0, bool), True,
                                   time.monotonic()) == b""
    other = type(pipe)(engine, depth=2, stage_workers=1)
    other.close()
    other.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        other.score_rows_to_wire(np.zeros((1, 30), np.float32), np.zeros(1, bool), True, 0.0)
