#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (igaming_platform_tpu_torch).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each one against its plain PyTorch version on the card, then drives the
port's paths through their entry points and holds their answers against the
same objects on the CPU: the fraud-scoring engine (``mlp+gbdt`` at full
serving width: 64 trees of depth 4 and an MLP of 128x128) through
``score()`` and ``score_batch``, and the bonus-abuse path (wallet event
stream -> ``ScoringBridge`` -> histories -> the sequence detector at its
serving width, d_model 64, 2 heads of 32, 2 layers) through ``drain``,
``check_batch`` and ``check``, and the detector's trainer
(``train_abuse_detector`` at its full width, 200 Adam steps of 64
sequences of 64 events). Phases:

1. environment: a card must be present; prints its name and power limit
   (``nvidia-smi``) and turns TF32 off for matmuls and convolutions;
2. build: compiles every kernel with ``nvcc``, all at once, and reports the
   time;
3. kernels: an empty kernel's time, the floor of any launch; each kernel
   against its plain version at the shapes its paths give it, with CUDA-event
   timings (median of 50 launches) and, for the forest, also back to back
   (50 launches between one event pair) and by ``torch.profiler``; the
   forest at the serving sizes and at production sizes (up to 1,000 trees,
   depth 10), two launches bit-identical; and, for the
   attention kernels, ``scaled_dot_product_attention`` (its forward, and
   its backward through ``torch.autograd.grad``) on the same inputs as a
   yardstick; two launches of each attention kernel must be bit-identical;
   the forward is also held on amplitude-3 inputs to the plain version in
   float64; both are checked at the head sizes, block widths and edges the
   timed shapes do not reach; and the card's ``mma.sync`` rate, the
   attention kernels' practical ceiling; the dense kernel's two modes (the
   MLP layers' bf16 product, the sequence models' float32 one) at the main
   path's layer shapes, bit-equal to their plain versions on the card,
   timed beside ``torch.matmul`` / ``torch.addmm`` of the same operands,
   with a timing split over K; the score step's transcendentals on the card
   against the CPU; and batch invariance (a row's bits alone and inside a
   4096-row batch) of the forest and dense kernels, of the mlp, mlp+gbdt
   and multitask steps, of the transformer session head and of the abuse
   detector, asserted, the sequence models logged stage by stage;
4. engine: a feature store of 10,000 accounts, 20 single requests and one
   batch of 4096, the launch counts of that run, and the CPU comparison;
   then the device time of one step and its kernels by name, where a
   batch's host time goes, and the latency of 1000 sequential ``score()``
   calls; then a ``gbdt`` engine with a forest of 1,000 trees of depth 6
   through the same singles and batch, against the CPU engine;
5. abuse: a seeded wallet event stream of 2,000 accounts drained through
   the bridge into the card's detector, ``check_batch`` over every account
   and ``check`` on a sample (bit-equal to ``check_batch``, asserted), the
   attention and dense_f32 kernels' launch counts of that run, and the same
   stream through a CPU bridge and detector; then ``check()`` latency,
   ``check_batch(256)`` throughput and the device time of one forward at
   BASELINE config 3's width (d_model 128, 2 heads of 64) at S = 256, 2048
   and 8192;
6. training: one seeded model trained 5 steps on the card and on the CPU
   from the same batches (per-step losses and every step-1 gradient
   compared, every gradient on the card nonzero); then the full 200-step
   ``train_abuse_detector`` on the card, the launch counts of that run
   (dQ and dK/dV kernels = layers x steps, forward kernel = layers x
   (steps + 1 eval forward)), its held-out accuracy, the trained model
   served by a card ``SequenceAbuseDetector``, where a step's time goes
   (host batch synthesis, device step, kernels by name), and one training
   step at config-3 width at S=2048;
7. serving front: a native store of 100,000 accounts, the risk.v1 RPC mix
   through ``RiskGrpcService.call`` (its drift engine bound, as by default)
   and the HTTP sidecar, every ScoreBatch held to a CPU engine on the same
   rows;
8. index path and session state, on phase 7's store: IDX1 frames through
   ``RiskGrpcService.call`` into engine A (every account resident, the
   transformer session head) and engine B (the default capacity, the
   pattern head, CLOCK evicting), each held frame by frame to a CPU twin and
   then bit for bit in its table and ring; rows/s, one RPC's split, the
   cache and session counts, the launches per device step and the device
   bytes of the table and ring;
9. the score step's variants, on phase 7's store: engine C, ``mlp+gbdt_int8``
   quantized by the port from phase 7's params, on the int8 wire, with its
   service's drift engine and a second tree in shadow, through ScoreBatch and
   ScoreTransaction RPCs, each held to a CPU twin (answers, every RPC's
   sketch, the shadow's window), forest launches two a step; engine A of
   phase 8 with drift and a shadow for two frames, held to its twin the same
   way and bit for bit in its table and ring; then, in turns on phase 7's
   engine, ScoreBatch rows/s with the drift engine unbound and bound and on
   the float32, bf16 and int8 wires, each wire's host encode per row, and one
   step's kernels by name without and with the sketch;
10. the decision ledger and replay, on phase 7's store (``phase_ledger``);
11. the trained model, on phase 7's store: the assembly booted from
    ``FRAUD_MODEL_PATH`` with the released golden ``.npz`` (its scores
    reproduced) and with a multitask tree of 256x256, whose ScoreBatch and
    ScoreTransaction answers are held bit for bit to a CPU twin booted from
    the same file; PredictLTV and GetPlayerSegment for 1,000 accounts and
    the LTV batch job over a wallet of 100,000 accounts, each equal to the
    CPU; ``predict_batch`` bit-equal to the JAX service's jit outputs
    committed in ``tests/golden/ltv_jit.npz``;
12. training and the online loop, on phase 7's store: the multitask trainer
    at ``TrainConfig``'s defaults (batch 1024, trunk 256x256) 5 steps on the
    card and on the CPU from one tree and the same batches (losses, step-1
    weight gradients within one bf16 ulp, 5 dense launches a step), ``fit``
    for 400 steps (the loss falls; wall and device ms a step, kernels by
    name), ``run_eval`` at the JAX defaults (every gate ok),
    ``distill_serving_params`` at its defaults (MAEs beside a CPU twin's; the
    students served by a card ``mlp+gbdt`` engine held to a CPU twin, forest
    launches counted), ``device_parity.run`` (``ok``), a checkpoint resumed by
    a ``TrainingLoop`` and booted through ``FRAUD_MODEL_PATH`` with
    ``ONLINE_LOOP=1`` (answers bit-equal to a CPU twin), outcomes posted, ticks
    until a promotion that is ledgered, vaulted and replayed with 0
    mismatches, a rollback replayed again, and ScoreBatch rows/s with the
    loop idle and ticking.

Any failure exits non-zero. The second-to-last lines are the ``kernels``
JSON object and the card's name and power limit; the last line is the
result object. With no card, or outside the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# rate outside the tensor cores. Used for the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Float32-accurate attention arithmetic on the tensor cores: the bf16 dense
# rate (989 TFLOP/s) over three, since split bf16 takes three bf16 products
# (hi.hi + hi.lo + lo.hi) per float32 product. The bound of every attention
# kernel, whichever implementation runs.
ATTN_OPS_PER_S = 989e12 / 3

KERNEL_SHAPES_B = (1, 255, 256, 2048, 4096)
KERNEL_FORESTS = ((64, 4), (16, 3))
# Forests of production size (fraud models hold hundreds to a thousand trees;
# CatBoost's default is 1,000 of depth 6) and a deep one, whose leaves the
# kernel reads in place: timed at a latency tier and at a full batch, and held
# to the plain sum in float64 (the float32 JAX sum lies 2.2e-06 from it at
# (1000, 6)).
LARGE_FORESTS, LARGE_SHAPES_B, LARGE_ATOL = ((600, 4), (1000, 6), (256, 10)), (256, 4096), 1e-5
# Checked against the float64 plain sum, not timed, (T, D, B, F): depth 1,
# the deepest leaves kept in shared memory and the shallowest read in place,
# deep trees, odd and tiny feature counts, a ragged B over many chunks.
FOREST_CHECK_SHAPES = ((5, 1, 3, 30), (33, 8, 100, 30), (7, 9, 70, 30), (40, 12, 129, 30),
                       (3, 16, 33, 30), (2, 20, 5, 30), (301, 5, 4097, 31), (64, 3, 40, 1),
                       (2000, 2, 1000, 30))
# Forests whose kernel time torch.profiler also reads, at these B.
PROFILE_B = (256, 4096)
# Batch invariance (phase 3): the leading B rows of a full batch, launched
# alone, must give the bits of the same rows inside the full batch's launch:
# asserted for the forest kernel at these forests (whose launch plans differ
# by B), the dense kernel, the packed step of the mlp, mlp+gbdt and
# multitask engines at the ladder's shapes, the transformer session head and
# the abuse detector; counted for torch.matmul (cuBLAS picks its sgemm by M).
INVARIANCE_FORESTS, INVARIANCE_B = ((64, 4), (600, 4), (1000, 6)), (1, 256, 2048)
N_FEATURES = 30
SERVE_TREES, SERVE_DEPTH, SERVE_HIDDEN = 64, 4, (128, 128)
# The multitask backend at its default width (models/multitask.py
# DEFAULT_TRUNK): phase 3's batch invariance and phase 11's full-width boot.
MULTITASK_TRUNK = (256, 256)
# The dense kernel (csrc/dense_fixed.cu) at the main path's layers (B, K, N):
# the mlp engines' 30->128 and 128->128 and the multitask trunk's 30->256 and
# 256->256 at a 4096-row step, and 256->256 at the ScoreTransaction tier;
# checked only: the heads (N = 1), odd K and N, ragged B. Against the
# product in float64 of the same bf16 operands: at most DENSE_F64_ATOL
# (float32 sums of up to 257 products, outputs up to about 10).
DENSE_SHAPES = ((4096, 30, 128), (4096, 128, 128), (4096, 30, 256), (4096, 256, 256),
                (256, 256, 256))
DENSE_MAIN_SHAPE = (4096, 256, 256)
DENSE_CHECK_SHAPES = ((1, 30, 1), (4096, 256, 1), (4097, 128, 1), (33, 13, 3), (70, 257, 65),
                      (5, 8, 200))
DENSE_F64_ATOL = 1e-5
# Its float32 mode (models/sequence.py's Affine), at the sequence models'
# layers: the transformer session head (d_model 32) over a 4096-row chunk of
# 16-event windows, B*S = 65,536 rows: embed 12->32, qkv 32->96, wo 32->32,
# w1 32->64, w2 64->32, and its head 32->1 at 4096 rows; the abuse detector
# (d_model 64) in one check_batch(256) at S = 64, 16,384 rows: 12->64,
# 64->192, 64->64, 64->128, 128->64; and one check(), 64 rows of 64->192.
DENSE_F32_SHAPES = ((65536, 12, 32), (65536, 32, 96), (65536, 32, 32), (65536, 32, 64),
                    (65536, 64, 32), (4096, 32, 1), (16384, 12, 64), (16384, 64, 192),
                    (16384, 64, 64), (16384, 64, 128), (16384, 128, 64), (64, 64, 192))
DENSE_F32_MAIN_SHAPE = (16384, 64, 192)  # the detector's qkv in one check_batch(256)
DENSE_F32_CHECK_SHAPES = ((1, 12, 1), (33, 13, 3), (70, 257, 65), (5, 8, 200), (16, 32, 96))
# The timing split: the bf16 mode at B = 4096, N = 256 over these K.
DENSE_K_SWEEP = (32, 64, 128, 256, 512)
# The builds of csrc/dense_fixed.cu ``dense_variants`` times beside the
# default, each a set of its build-time knobs: the timing probes
# (DENSE_PROBE 1: every cycle reads a stage's first k, so the operand loads
# leave the loop; 2: nothing staged past the first stage; wrong answers,
# timed in the split only).
DENSE_VARIANTS = ({"DENSE_PROBE": 1}, {"DENSE_PROBE": 2})
# Phase 4's second engine: the gbdt backend with a production-sized forest.
LARGE_ENGINE_FOREST = (1000, 6)
BATCH_SIZE, LATENCY_TIERS = 4096, (256, 2048)
N_ACCOUNTS, EVENTS_PER_ACCOUNT = 10_000, 20
N_SINGLE = 20
# score() latency sample: 1000 sequential requests, so that p99 has ten
# samples beyond it.
N_LATENCY = 1000
KERNEL_ATOL = 1e-6  # 64 float32 leaves of scale 0.1 summed in another order
ML_ATOL = 1e-5  # cuBLAS float32 sums the MLP's products in another order
REPS = 50
# Attention shapes (B*H, S, Dh): the abuse detector (one check, 256
# accounts), BASELINE config 3 (benchmarks/configs.py: 64 x 2 heads at
# S=256, 8 x 2 at 2048, 2 x 2 at 8192, the TPU's tiled range), a ragged S,
# and the transformer session head (4 heads x a 4096-row or 256-row chunk).
FLASH_SHAPES = ((2, 64, 32), (512, 64, 32), (128, 256, 64), (16, 2048, 64),
                (4, 8192, 64), (4, 300, 32), (16384, 16, 8), (1024, 16, 8))
FLASH_MAIN_SHAPE = (512, 64, 32)  # check_batch of 256 accounts
FLASH_TOL = 2e-5  # rtol and atol of O and LSE: the JAX tests' bar, float32 sums reordered
# Checked, not timed: the head sizes, block widths (128-row blocks at long S,
# 64-row blocks, or 16-row blocks when 64-row ones leave SMs idle) and edges
# the timed shapes miss: S = 1, S past a 128-key tile's end, and (8, 16, 8),
# whose 16-row blocks have warps that see no key.
FLASH_CHECK_SHAPES = ((8, 16, 8), (1, 200, 8), (70, 130, 8), (140, 256, 8), (5, 1, 16),
                      (2, 150, 16), (33, 257, 16), (70, 257, 16), (3, 1, 32), (160, 100, 32),
                      (60, 300, 32), (3, 100, 64), (200, 1, 64), (50, 1000, 64), (3, 200, 128),
                      (40, 300, 128))
# Inputs of amplitude 3 (randn x 3) at these shapes: split bf16 would pass
# unit-amplitude inputs and miss the bar here. At this amplitude the float32
# plain version is itself about a bar from float64 (float32 sums of products
# of magnitude 80), so the kernel is held to the plain version in float64.
FLASH_AMP, FLASH_AMP_SHAPES = 3.0, ((4, 300, 32), (16, 2048, 64))
# Backward shapes (B*H, S, Dh): a training step (batch 64 x 2 heads), one
# check's width, config-3 width at S=2048 and at 8192 (past the TPU kernels'
# range), a ragged S, and the session head's Dh 8.
FLASH_BWD_SHAPES = ((128, 64, 32), (2, 64, 32), (16, 2048, 64), (4, 8192, 64),
                    (4, 300, 32), (8, 16, 8))
FLASH_BWD_MAIN_SHAPE = (128, 64, 32)
# Checked, not timed: the head sizes and block widths (64-row blocks, or
# 16-row blocks when 64-row ones leave SMs idle) the shapes above miss.
FLASH_BWD_CHECK_SHAPES = ((33, 257, 16), (70, 130, 8), (3, 200, 128), (40, 300, 128),
                          (160, 100, 32), (3, 100, 64))
GRAD_TOL = 2e-4  # rtol and atol of gradients: the JAX tests' bar, float32 sums reordered
# The abuse path: the detector's serving width and BASELINE config 3's.
ABUSE_CFG = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128)
CONFIG3_CFG = dict(d_model=128, n_heads=2, n_layers=2, d_ff=256)
CONFIG3_POINTS = ((64, 256), (8, 2048), (2, 8192))  # (batch, S)
ABUSE_ACCOUNTS, ABUSE_MAX_EVENTS = 1_600, 64  # the drain sets most of the script's time
ABUSE_BATCH, ABUSE_CHECKS, ABUSE_LATENCY = 256, 200, 1000
ABUSE_ATOL = 1e-4  # card against CPU detector: float32 through two layers, sums reordered
STREAM_T0 = 1_700_000_000.0
# Training: steps compared between the card and the CPU, their loss bar
# (float32 through two layers and Adam, sums reordered), the least held-out
# accuracy of the full run, and config-3 width's training point.
PARITY_STEPS, LOSS_RTOL, MIN_ACCURACY = 5, 1e-4, 0.95
CONFIG3_TRAIN_POINT = (8, 2048)  # (batch, S)
# The mma.sync rate: iterations of 8 chains a warp, 8 warps an SM.
MMA_ITERS = 2048
# The tensor-core probe: seeded operand tiles per family and instruction, each
# run once through csrc/mma_probe.cu and held bit for bit to
# ops/tensor_core_model.py's mma.
PROBE_TILES = 2000
# The serving front (phase 7): a native store at its default capacity filled
# with 100,000 accounts of about 20 events each, ScoreBatch RPCs of 16,384
# rows (4 chunks of 4096 through the host pipeline), and the RPC mix.
SERVER_ACCOUNTS, SERVER_EVENTS_PER_ACCOUNT = 100_000, 20
SERVER_BATCH_ROWS, SERVER_BATCHES = 16_384, 5
SERVER_SINGLES, SERVER_ABUSE_CHECKS = 500, 50
SERVER_NOW = 1_700_000_000.0  # the store's clock: pinned in phase 7, stepped in phase 8
STORE_CLOCK = [SERVER_NOW]
# The index path and session state (phase 8), on phase 7's store. Engine A:
# WIRE_MODE=index, every account resident after first touch, the transformer
# session head; rounds of one 16,384-row IDX1 frame and then 100 one-row
# frames, the clock stepping INDEX_STEP_S between them. Random rows come from
# a hot set of 20,000 accounts (so accounts repeat inside a 4,096-row chunk
# and windows warm across frames); INDEX_CYCLERS accounts outside it get a
# machine-paced cycle, a bet in each large frame and a deposit in one small
# frame, the same amount every time. Engine B: the default capacity, the
# pattern head, 7 frames over every account, so CLOCK evicts and the ring
# rehydrates.
INDEX_ROUNDS, INDEX_CYCLERS, INDEX_HOT, INDEX_STEP_S = 5, 100, 20_000, 30.0
INDEX_A_CAPACITY, INDEX_B_CAPACITY, INDEX_B_FRAMES = 131_072, 65_536, 7
# The pinned transformer head scores the warm windows of this traffic
# between about 0.20 and 0.25 (a CPU rehearsal at 3,000 accounts), never near
# the default 0.7: engine A folds at about their median instead.
INDEX_A_THRESHOLD = 0.23
INDEX_SAMPLED_WINDOWS = 100
# The score step's variants (phase 9), on phase 7's store. Engine C: the
# int8 backends on the int8 wire with drift and a shadow, VARIANT_RPCS
# ScoreBatch RPCs of SERVER_BATCH_ROWS and VARIANT_SINGLES ScoreTransaction
# RPCs; engine A of phase 8 with drift and a shadow for VARIANT_FRAMES
# frames; then VARIANT_TURN_RPCS RPCs a turn on phase 7's engine. A sketch's
# moments are float32 sums in another order on the card: rtol 1e-4.
VARIANT_RPCS, VARIANT_SINGLES, VARIANT_FRAMES, VARIANT_TURN_RPCS = 5, 200, 2, 5
CALIBRATION_ROWS, MAX_VARIANT_BOUNDARY, MOMENT_RTOL = 4096, 10, 1e-4
# The decision ledger and replay (phase 10), on phase 7's store. Engine L:
# mlp+gbdt with an MLP of SERVE_HIDDEN and a LARGE_ENGINE_FOREST forest,
# LEDGER_DIR set, takes LEDGER_SINGLES ScoreTransaction RPCs, SERVER_BATCHES
# ScoreBatch RPCs of SERVER_BATCH_ROWS rows, one score_batch of
# LEDGER_DIRECT requests, then a swap to a second tree and
# LEDGER_AFTER_SWAP more ScoreBatch RPCs, the ledger flushed after each.
# Engine A of phase 8, with a ledger of its own, takes LEDGER_INDEX_ROUNDS
# large IDX1 frames and the first round's INDEX_CYCLERS one-row frames.
# Then phase 7's engine in turns, its ledger unbound and bound,
# VARIANT_TURN_RPCS RPCs a turn.
LEDGER_SINGLES, LEDGER_DIRECT, LEDGER_AFTER_SWAP, LEDGER_INDEX_ROUNDS = 500, 1000, 2, 3
# The trained model and LTV (phase 11), on phase 7's store: the released
# golden checkpoint (GOLDEN_DIR), a MULTITASK_TRUNK tree through the same RPC
# mix as phase 7, LTV_ACCOUNTS accounts through the two LTV RPCs, and the LTV
# batch job over a wallet of WALLET_ACCOUNTS accounts and WALLET_TXS
# transactions.
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden")
LTV_ACCOUNTS, WALLET_ACCOUNTS, WALLET_TXS = 1_000, 100_000, 2_000_000
# Spin cycles queued before each timed call, so the card is still busy
# while the host enqueues the call: the events then bracket device work only.
SLEEP_CYCLES = 4_000_000
# The same, before a run of REPS back-to-back calls: long enough for the host
# to enqueue all of them (checked on every run).
B2B_SLEEP_CYCLES = 40_000_000

def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, reps: int = REPS, warmup: int = 5, sleep: int = SLEEP_CYCLES) -> float:
    """Median device time of one call of ``fn``, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(sleep)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_ms_b2b(torch, fn, n: int = REPS, reps: int = 5, warmup: int = 5) -> float:
    """Device time of one call of ``fn``, as the median over ``reps`` of
    ``n`` back-to-back calls between one pair of CUDA events, over ``n``.
    A spin queued first keeps the card busy while the host enqueues the
    calls; the run fails if the host took longer than the spin, since the
    card would then have waited on it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spin.record()
        torch.cuda._sleep(B2B_SLEEP_CYCLES)
        start.record()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms >= spin.elapsed_time(start):
            raise AssertionError(f"back-to-back timing: the host took {host_ms:.3f} ms to "
                                 f"enqueue, longer than the {spin.elapsed_time(start):.3f} ms spin")
        out.append(start.elapsed_time(end) / n)
    return statistics.median(out)


def profiled_kernel_ms(torch, fn, name: str, n: int = 20) -> float | None:
    """Mean device duration of the kernels whose name holds ``name`` over
    ``n`` calls of ``fn``, from ``torch.profiler``; None if it saw none."""
    prof = profile_window(torch, lambda: [fn() for _ in range(n)], top=50)
    hits = [k for k in prof["top"] if name in k["kernel"]]
    if not hits:
        return None
    return sum(k["device_ms"] for k in hits) / sum(k["count"] for k in hits)


def profile_window(torch, fn, top: int = 6) -> dict:
    """Device time by kernel over one run of ``fn`` (``torch.profiler``,
    CUDA activity), against the run's host wall time: the card's busy
    share. A profiler that records no device time gives None, "not
    measured", rather than a number."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages() if e.self_device_time_total > 0),
                     key=lambda k: -k[1])
    device = sum(k[1] for k in kernels)
    if device == 0:
        return {"wall_ms": wall_ms, "device_ms": None, "busy_share": None, "top": []}
    return {"wall_ms": wall_ms, "device_ms": device, "busy_share": device / wall_ms,
            "top": [{"kernel": k[:80], "device_ms": ms, "count": n} for k, ms, n in kernels[:top]]}


def forest_tree(rng, n_trees: int, depth: int, n_features: int = N_FEATURES) -> dict:
    """A random oblivious forest in the JAX package's params layout."""
    return {
        "feat": rng.integers(0, n_features, (n_trees, depth)).astype(np.int32),
        "thr": rng.random((n_trees, depth)).astype(np.float32),
        "leaves": (rng.normal(size=(n_trees, 2**depth)) * 0.1).astype(np.float32),
        "bias": np.float32(rng.normal() * 0.1),
    }


def mlp_tree(rng, hidden) -> dict:
    dims = (N_FEATURES, *hidden, 1)
    return {"layers": [
        {"w": (rng.normal(size=(a, b)) * np.sqrt(2.0 / a)).astype(np.float32),
         "b": (rng.normal(size=(b,)) * 0.05).astype(np.float32)}
        for a, b in zip(dims[:-1], dims[1:])]}


def forest_bound(b: int, n_trees: int, depth: int) -> tuple[float, str]:
    """Least time for the forest on this card: each input read once, the
    output written once; operations are B*T*D compares plus B*T adds."""
    forest_bytes = n_trees * depth * 8 + n_trees * (1 << depth) * 4 + 4
    bytes_ms = (b * N_FEATURES * 4 + b * 4 + forest_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = (b * n_trees * (depth + 1)) / FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def forest_case(torch, rng, n_trees: int, depth: int, b: int, n_features: int = N_FEATURES):
    """A seeded forest on the card and [B, F] features on it, one in three
    rows with a feature equal to a split threshold (a tie must go left)."""
    from igaming_platform_tpu_torch.convert import gbdt_from_tree

    tree = forest_tree(rng, n_trees, depth, n_features)
    f = {k: v.cuda() for k, v in gbdt_from_tree(tree, n_features).items()}
    x_np = rng.random((b, n_features)).astype(np.float32)
    rows = np.arange(0, b, 3)
    k = rng.integers(0, n_trees * depth, rows.size)
    x_np[rows, tree["feat"].reshape(-1)[k]] = tree["thr"].reshape(-1)[k]
    return (torch.from_numpy(x_np).cuda(), f["feat"], f["thr"], f["leaves"], f["bias"])


def check_forest(torch, gbdt_kernel, args, f64: bool, name: str) -> float:
    """The kernel against the plain version: in float32 at KERNEL_ATOL, or
    (``f64``) in float64 at LARGE_ATOL; a second launch must give the same
    bits. Returns the max error."""
    got, again = (gbdt_kernel.gbdt_forest(*args) for _ in range(2))
    x, feat, thr, leaves, bias = args
    if f64:
        x, thr, leaves, bias = x.double(), thr.double(), leaves.double(), bias.double()
    want = gbdt_kernel.gbdt_forest_plain(x, feat, thr, leaves, bias)
    atol = LARGE_ATOL if f64 else KERNEL_ATOL
    torch.cuda.synchronize()
    if got.shape != (args[0].shape[0],) or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: bad output")
    err = float((got.double() - want.double()).abs().max())
    if err > atol:
        raise AssertionError(f"{name}: max error {err} > {atol}")
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches gave different bits")
    return err


def phase_kernels(torch, gbdt_kernel, forests=KERNEL_FORESTS, large=LARGE_FORESTS,
                  checks=FOREST_CHECK_SHAPES) -> list[dict]:
    """The forest kernel against its plain version: ``forests`` at every
    KERNEL_SHAPES_B against the float32 plain version, ``large`` at
    LARGE_SHAPES_B and ``checks`` against it in float64; two launches
    bit-identical everywhere. Each timed shape by one event pair a call
    (``device_ms``), back to back, and at PROFILE_B by ``torch.profiler``."""
    rng = np.random.default_rng(0)
    cases = [(t, d, b, False) for t, d in forests for b in KERNEL_SHAPES_B]
    cases += [(t, d, b, True) for t, d in large for b in LARGE_SHAPES_B]
    rows = []
    for n_trees, depth, b, f64 in cases:
        args = forest_case(torch, rng, n_trees, depth, b)
        name = f"gbdt_forest T={n_trees} D={depth} B={b}"
        err = check_forest(torch, gbdt_kernel, args, f64, name)
        bound, bound_by = forest_bound(b, n_trees, depth)
        row = {"T": n_trees, "D": depth, "B": b, "max_abs_err": err,
               "against": "float64 plain" if f64 else "float32 plain",
               "repeatable": True,
               "kernel_ms": device_ms(torch, lambda: gbdt_kernel.gbdt_forest(*args)),
               "kernel_b2b_ms": device_ms_b2b(torch, lambda: gbdt_kernel.gbdt_forest(*args)),
               "kernel_profiler_ms": (profiled_kernel_ms(
                   torch, lambda: gbdt_kernel.gbdt_forest(*args), "gbdt_forest_kernel")
                   if b in PROFILE_B else None),
               "plain_ms": device_ms(torch, lambda: gbdt_kernel.gbdt_forest_plain(*args)),
               "bound_ms": bound, "bound_by": bound_by}
        row["bound_share"] = bound / row["kernel_b2b_ms"]
        rows.append(row)
        prof = row["kernel_profiler_ms"]
        log(f"phase 3: {name}: max_abs_err={err:.3g} against the {row['against']}, two "
            f"launches bit-identical; kernel_ms={row['kernel_ms']:.6f} "
            f"back_to_back_ms={row['kernel_b2b_ms']:.6f} profiler_ms="
            f"{'not measured' if prof is None else f'{prof:.6f}'} "
            f"plain_ms={row['plain_ms']:.6f} bound_ms={bound:.6f} ({bound_by}, "
            f"{100 * row['bound_share']:.1f}% of it back to back)")
    for n_trees, depth, b, n_features in checks:
        args = forest_case(torch, rng, n_trees, depth, b, n_features)
        name = f"gbdt_forest T={n_trees} D={depth} B={b} F={n_features}"
        err = check_forest(torch, gbdt_kernel, args, True, name)
        log(f"phase 3: {name} (check only): max_abs_err={err:.3g} against the float64 plain "
            f"version, two launches bit-identical")
    return rows


def differing_rows(bits, x: np.ndarray, sizes=INVARIANCE_B) -> dict[int, int]:
    """Per B of ``sizes``: how many rows of ``bits(x[:B])`` differ in any bit
    from the same rows of ``bits(x)``; ``bits`` gives an int32 [rows, k]."""
    full = bits(x)
    return {b: int((bits(x[:b]) != full[:b]).any(axis=1).sum()) for b in sizes}


def multitask_tree(rng, trunk) -> dict:
    """A multitask params tree in the JAX layout: He-init trunk, three heads."""
    dims = (N_FEATURES, *trunk)

    def layer(a, b, scale):
        return {"w": (rng.normal(size=(a, b)) * scale).astype(np.float32),
                "b": (rng.normal(size=(b,)) * 0.05).astype(np.float32)}

    head = np.sqrt(1.0 / trunk[-1])
    trunk_layers = [layer(a, b, np.sqrt(2.0 / a)) for a, b in zip(dims[:-1], dims[1:])]
    return {"trunk": {"layers": trunk_layers},
            "fraud_head": layer(trunk[-1], 1, head), "ltv_head": layer(trunk[-1], 1, head),
            "churn_head": layer(trunk[-1], 1, head)}


def session_windows(rng, n: int):
    """[n, SESSION_EVENTS, EVENT_WIDTH] windows of seeded events, as the
    session ring holds them (``encode_events_host``), each with a seeded
    length and zeros past it."""
    from igaming_platform_tpu_torch.serve import session_state as ss

    n_events = ss.default_events()
    ev = ss.encode_events_host(rng.integers(100, 500_000, n * n_events),
                               rng.integers(0, 5, n * n_events),
                               rng.exponential(600.0, n * n_events))
    win = ev.reshape(n, n_events, -1)
    lengths = rng.integers(1, n_events + 1, n)
    win[np.arange(n_events)[None, :] >= lengths[:, None]] = 0.0
    return win, lengths


def sequence_stages(torch, model, x) -> list:
    """``SequenceModel.forward`` of ``model`` on ``x`` stage by stage: a list
    of (name, fn, input, output), each input and output with the batch first,
    so that ``fn(input[:n])`` is the stage run on the leading n rows alone.
    Its logit must equal the model's own, bit for bit (asserted)."""
    from igaming_platform_tpu_torch.models.sequence import _positions_table, gelu
    from igaming_platform_tpu_torch.ops.flash_attention import flash_attention

    stages = []

    def run(name, fn, inp):
        out = fn(inp)
        stages.append((name, fn, inp, out))
        return out

    def attend(t):  # [B, 3, H, S, Dh] -> [B, H, S, Dh]
        return flash_attention(*(t[:, i].contiguous() for i in range(3)))

    b, s, d = x.shape[0], x.shape[1], model.cfg.d_model
    h = model.cfg.n_heads
    hid = run("embed", model.embed, x) + torch.from_numpy(_positions_table(s, d)).to(x.device)[None]
    for i, layer in enumerate(model.layers):
        qkv = run(f"layer{i}.qkv", layer.wqkv, run(f"layer{i}.ln1", layer.ln1, hid))
        att = run(f"layer{i}.attention", attend,
                  qkv.view(b, s, 3, h, d // h).permute(0, 2, 3, 1, 4).contiguous())
        hid = hid + run(f"layer{i}.wo", layer.wo, att.transpose(1, 2).reshape(b, s, d))
        up = run(f"layer{i}.w1", layer.w1, run(f"layer{i}.ln2", layer.ln2, hid))
        hid = hid + run(f"layer{i}.w2", layer.w2, gelu(up))
    pooled = run("pool", model.pool, run("ln_f", model.ln_f, hid))
    logit = run("head", model.head, pooled)[..., 0]
    want = model(x)["abuse_logit"]
    if not torch.equal(logit.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("sequence_stages: the stage-by-stage forward left the model's")
    return stages


def stage_log(torch, model, x, sizes=INVARIANCE_B) -> dict:
    """Per stage of ``sequence_stages`` and per n of ``sizes``: rows of an
    n-row forward differing from the leading n rows of the full forward
    (``forward``, each stage fed by the n-row forward's previous one), and
    rows of the stage run alone on the full forward's own leading n inputs
    (``alone``: a nonzero count is the stage's own doing)."""

    def differ(a, b):
        return int((a.reshape(a.shape[0], -1).view(torch.int32)
                    != b.reshape(b.shape[0], -1).view(torch.int32)).any(dim=1).sum())

    with torch.inference_mode():
        full = sequence_stages(torch, model, x)
        out = {name: {"forward": {}, "alone": {}} for name, *_ in full}
        for n in sizes:
            part = sequence_stages(torch, model, x[:n])
            for (name, fn, inp, want), (_, _, _, got) in zip(full, part):
                out[name]["forward"][n] = differ(got, want[:n])
                out[name]["alone"][n] = differ(fn(inp[:n]), want[:n])
    return out


def phase_batch_invariance(torch, gbdt_kernel, dense_mod) -> dict:
    """A row's answer must not depend on the batch it rides in. Over seeded
    4096-row batches, the leading 1, 256 and 2048 rows launched alone
    against the same rows of the full launch, 0 differing rows asserted:
    the forest kernel at INVARIANCE_FORESTS; the dense kernel at 30->128 and
    256->256 (``torch.matmul`` of the same operands counted beside it, the
    cuBLAS sgemm it replaces); the packed step (``_launch``, the engine's
    own padding to a ladder shape) of an mlp and an mlp+gbdt engine (MLP
    128x128, forest 1,000 x 6) and of a multitask engine (trunk 256x256);
    the transformer session head (``SESSION_HEAD=transformer``, engine A's)
    over seeded windows and the abuse detector over seeded histories, each
    also logged stage by stage (``stage_log``)."""
    from igaming_platform_tpu_torch.convert import from_jax_params
    from igaming_platform_tpu_torch.core.config import BatcherConfig
    from igaming_platform_tpu_torch.serve import session_state as ss
    from igaming_platform_tpu_torch.serve.scorer import RESULT_KEYS, TorchScoringEngine

    rng = np.random.default_rng(9)
    out = {"forest": {}, "dense": {}, "cublas_sgemm": {}, "engine": {}}
    for n_trees, depth in INVARIANCE_FORESTS:
        x, *forest = forest_case(torch, rng, n_trees, depth, BATCH_SIZE)
        diffs = differing_rows(lambda xb: gbdt_kernel.gbdt_forest(xb, *forest).view(
            torch.int32).cpu().numpy()[:, None], x)
        out["forest"][f"{n_trees}x{depth}"] = diffs
        log(f"phase 3: batch invariance, gbdt_forest T={n_trees} D={depth}: rows differing "
            f"from the B={BATCH_SIZE} launch {json.dumps(diffs)}")
        if any(diffs.values()):
            raise AssertionError(f"gbdt_forest T={n_trees} D={depth}: a row's margin depends "
                                 f"on its batch: {diffs}")
    for _, k, n in ((BATCH_SIZE, 30, 128), (BATCH_SIZE, 256, 256)):
        x, w, b = dense_case(torch, rng, BATCH_SIZE, k, n)
        xb = dense_mod.round_bf16(x)
        name = f"{k}->{n}"
        out["dense"][name] = diffs = differing_rows(
            lambda xs: dense_mod.dense(xs, w, b).view(torch.int32).cpu().numpy(), x)
        out["cublas_sgemm"][name] = lib = differing_rows(
            lambda xs: torch.matmul(xs, w).view(torch.int32).cpu().numpy(), xb)
        log(f"phase 3: batch invariance, dense_bf16 {name}: rows differing from the "
            f"B={BATCH_SIZE} launch {json.dumps(diffs)} (torch.matmul of the same operands: "
            f"{json.dumps(lib)})")
        if any(diffs.values()):
            raise AssertionError(f"dense_bf16 {name}: a row's bits depend on its batch: {diffs}")
    tree = {"mlp": mlp_tree(rng, SERVE_HIDDEN), "gbdt": forest_tree(rng, *LARGE_ENGINE_FOREST),
            "multitask": multitask_tree(rng, MULTITASK_TRUNK)}
    x = (rng.random((BATCH_SIZE, N_FEATURES)) * 100.0).astype(np.float32)
    bl = np.zeros((BATCH_SIZE,), dtype=bool)
    for backend in ("mlp", "mlp+gbdt", "multitask"):
        engine = TorchScoringEngine(
            ml_backend=backend, device="cuda", params=from_jax_params(backend, tree),
            batcher_config=BatcherConfig(batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS))
        try:
            params = engine.get_params()

            def bits(xb):
                h = engine._readback(engine._launch(xb, bl[:xb.shape[0]], params))
                return np.stack([h[k].view(np.int32) for k in RESULT_KEYS], axis=1)

            out["engine"][backend] = diffs = differing_rows(bits, x)
        finally:
            engine.close()
        log(f"phase 3: batch invariance, {backend} packed step at shapes "
            f"{[engine._pick_shape(b) for b in INVARIANCE_B]}: rows differing from the "
            f"B={BATCH_SIZE} step {json.dumps(diffs)}")
        if any(diffs.values()):
            raise AssertionError(f"{backend} packed step: a row's answer depends on its batch: "
                                 f"{diffs}")
    # The sequence models: the session head over engine A's seeded windows
    # (attention at BH = 4 B, S = 16, Dh = 8) and the abuse detector at its
    # serving width over seeded histories (BH = 2 B, S = 64, Dh = 32), each
    # logged stage by stage, the output asserted.
    from igaming_platform_tpu_torch.convert import sequence_from_tree
    from igaming_platform_tpu_torch.models.sequence import SeqConfig

    head = ss.session_head_params(torch.device("cuda"))
    win, lengths = session_windows(rng, BATCH_SIZE)
    win_d, len_d = torch.from_numpy(win).cuda(), torch.from_numpy(lengths).cuda()
    with torch.inference_mode():
        out["session_head_transformer"] = diffs = differing_rows(
            lambda w: ss.transformer_scores(head, win_d[:w.shape[0]], len_d[:w.shape[0]]).view(
                torch.int32).cpu().numpy()[:, None], win)
    detector = sequence_from_tree(seq_tree(rng, ABUSE_CFG), SeqConfig(**ABUSE_CFG)).cuda()
    hist = torch.from_numpy(rng.normal(size=(BATCH_SIZE, ABUSE_MAX_EVENTS, 12)).astype(
        np.float32)).cuda()
    hist[::3, :ABUSE_MAX_EVENTS // 2] = 0.0  # left-padded histories, as check_batch builds them
    out["stages"] = {"session_head": stage_log(torch, head, win_d),
                     "abuse_detector": stage_log(torch, detector, hist)}
    for model_name, stages in out["stages"].items():
        for stage, counts in stages.items():
            log(f"phase 3: batch invariance, {model_name} stage {stage}: rows differing from the "
                f"B={BATCH_SIZE} forward {json.dumps(counts['forward'])}, run alone on its "
                f"inputs {json.dumps(counts['alone'])}")
    detector_diffs = out["stages"]["abuse_detector"]["head"]["forward"]
    log(f"phase 3: batch invariance, the transformer session head over {BATCH_SIZE} seeded "
        f"windows: rows differing from the B={BATCH_SIZE} forward {json.dumps(diffs)}; the abuse "
        f"detector's logit over {BATCH_SIZE} histories {json.dumps(detector_diffs)}")
    if any(diffs.values()) or any(detector_diffs.values()):
        raise AssertionError(f"sequence models: a row's score depends on its batch: session "
                             f"head {diffs}, abuse detector {detector_diffs}")
    return out


def dense_case(torch, rng, b: int, k: int, n: int, f32: bool = False):
    """Seeded operands of one layer on the card: unit-scale activations
    (ReLU outputs past the 30 features), He-init weights rounded to bf16 as
    ``Dense`` keeps them (left in float32 for the float32 mode), small
    biases."""
    from igaming_platform_tpu_torch.ops.dense import round_bf16

    x = rng.normal(size=(b, k)).astype(np.float32)
    if k > N_FEATURES:
        x = np.maximum(x, 0.0)
    w = torch.from_numpy((rng.normal(size=(k, n)) * np.sqrt(2.0 / k)).astype(np.float32))
    bias = (rng.normal(size=(n,)) * 0.05).astype(np.float32)
    return (torch.from_numpy(x).cuda(), (w if f32 else round_bf16(w)).cuda(),
            torch.from_numpy(bias).cuda())


def dense_bound(b: int, k: int, n: int) -> tuple[float, str]:
    """Least time for one layer on this card: 2*B*K*N float32 operations
    at the CUDA cores' rate, or the bytes of x, w, the bias and the output
    once each."""
    ops_ms = 2.0 * b * k * n / FP32_OPS_PER_S * 1e3
    bytes_ms = 4.0 * (b * k + k * n + n + b * n) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def dense_mode(dense_mod, f32: bool):
    """(name, kernel wrapper, plain version, the same operands as the kernel
    multiplies them) of one mode of csrc/dense_fixed.cu."""
    if f32:
        return "dense_f32", dense_mod.dense_f32, dense_mod.dense_f32_plain, lambda x: x
    return "dense_bf16", dense_mod.dense, dense_mod.dense_plain, dense_mod.round_bf16


def check_dense(torch, dense_mod, x, w, b, name: str, f32: bool = False) -> float:
    """The kernel bit-equal to its plain version on the card and to a second
    launch, finite, of the right shape, within DENSE_F64_ATOL of the float64
    product of the same operands. Returns that error."""
    _, kernel, plain_fn, operand = dense_mode(dense_mod, f32)
    got, again = (kernel(x, w, b) for _ in range(2))
    plain = plain_fn(x, w, b)
    exact = operand(x).double() @ w.double() + b.double()
    torch.cuda.synchronize()
    if got.shape != (x.shape[0], w.shape[1]) or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: bad output")
    if not torch.equal(got.view(torch.int32), plain.view(torch.int32)):
        bad = int((got.view(torch.int32) != plain.view(torch.int32)).sum())
        raise AssertionError(f"{name}: {bad} outputs differ in bits from the plain version "
                             "on the card")
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"{name}: two launches gave different bits")
    err = float((got.double() - exact).abs().max())
    if err > DENSE_F64_ATOL:
        raise AssertionError(f"{name}: max error {err} from float64 > {DENSE_F64_ATOL}")
    return err


def phase_dense(torch, dense_mod, floor: dict, f32: bool = False) -> list[dict]:
    """One mode of the dense kernel at its timed shapes (DENSE_SHAPES, or
    DENSE_F32_SHAPES for the float32 mode), checked (``check_dense``) and
    timed by one event pair a call and back to back, beside the empty
    kernel's ``floor``, the plain version on the card and the PyTorch call
    of the same operands (the bf16 mode: ``torch.matmul`` of the bf16-rounded
    float32 operands, as in earlier runs; the float32 mode: ``torch.addmm``
    with the bias; cuBLAS sgemm, TF32 off: the library time); the check-only
    shapes checked; then, for the bf16 mode, the timing split: back-to-back
    times at B=4096, N=256 over DENSE_K_SWEEP, whose slope is the kernel's
    time a k and whose intercept its fixed cost (launch, fold, stores)."""
    mode, kernel, plain_fn, operand = dense_mode(dense_mod, f32)
    rng = np.random.default_rng(11 if f32 else 10)
    rows = []
    for b, k, n in DENSE_F32_SHAPES if f32 else DENSE_SHAPES:
        x, w, bias = dense_case(torch, rng, b, k, n, f32)
        name = f"{mode} B={b} K={k} N={n}"
        err = check_dense(torch, dense_mod, x, w, bias, name, f32)
        xo = operand(x)
        bound, bound_by = dense_bound(b, k, n)
        run = lambda: kernel(x, w, bias)  # noqa: E731
        library = ((lambda: torch.addmm(bias, xo, w)) if f32  # noqa: E731
                   else (lambda: torch.matmul(xo, w)))
        row = {"mode": mode, "B": b, "K": k, "N": n, "max_abs_err": err,
               "against": "float64 product", "bit_equal_plain": True, "repeatable": True,
               "kernel_ms": device_ms(torch, run), "kernel_b2b_ms": device_ms_b2b(torch, run),
               "plain_ms": device_ms(torch, lambda: plain_fn(x, w, bias)),
               "library_ms": device_ms(torch, library),
               "library_b2b_ms": device_ms_b2b(torch, library),
               "bound_ms": bound, "bound_by": bound_by,
               "launch_floor_ms": floor["back_to_back_ms"]}
        row["bound_share"] = bound / row["kernel_b2b_ms"]
        row["over_library"] = row["kernel_b2b_ms"] / row["library_b2b_ms"]
        rows.append(row)
        log(f"phase 3: {name}: max_abs_err={err:.3g} against the float64 product, bit-equal to "
            f"the plain version on the card, two launches bit-identical; kernel_ms="
            f"{row['kernel_ms']:.6f} back_to_back_ms={row['kernel_b2b_ms']:.6f} (empty kernel "
            f"{floor['back_to_back_ms']:.6f}) plain_ms={row['plain_ms']:.6f} library_ms="
            f"{row['library_ms']:.6f} (back to back {row['library_b2b_ms']:.6f}, the kernel "
            f"{row['over_library']:.3f}x) bound_ms={bound:.6f} ({bound_by}, "
            f"{100 * row['bound_share']:.1f}% of it back to back)")
    for b, k, n in DENSE_F32_CHECK_SHAPES if f32 else DENSE_CHECK_SHAPES:
        x, w, bias = dense_case(torch, rng, b, k, n, f32)
        name = f"{mode} B={b} K={k} N={n}"
        err = check_dense(torch, dense_mod, x, w, bias, name, f32)
        log(f"phase 3: {name} (check only): max_abs_err={err:.3g} against the float64 product, "
            "bit-equal to the plain version on the card")
    if not f32:
        sweep = {}
        for k in DENSE_K_SWEEP:
            x, w, bias = dense_case(torch, rng, BATCH_SIZE, k, 256)
            sweep[k] = device_ms_b2b(torch, lambda: kernel(x, w, bias))
        ks = np.array(DENSE_K_SWEEP, dtype=np.float64)
        slope, intercept = np.polyfit(ks, [sweep[k] for k in DENSE_K_SWEEP], 1)
        rate = 2.0 * BATCH_SIZE * 256 / (slope * 1e-3)
        rows.append({"mode": mode, "k_sweep_b2b_ms": sweep, "ms_per_k": slope,
                     "fixed_ms": intercept, "flops_per_s_in_the_k_loop": rate})
        log(f"phase 3: {mode} timing split at B={BATCH_SIZE}, N=256, back to back: "
            f"{json.dumps(sweep)} ms by K; {slope * 1e3:.4f} us a k ({rate / 1e12:.1f} TFLOP/s "
            f"in the k loop, {100 * rate / FP32_OPS_PER_S:.1f}% of {FP32_OPS_PER_S / 1e12:.0f}), "
            f"{intercept * 1e3:.3f} us fixed")
    return rows


def phase_device_numerics(torch, n: int = 1 << 20) -> dict:
    """The score step's transcendentals on the card against the CPU, over
    ``n`` seeded float32 values (features spanning 10^-3 to 10^8, logits of
    scale 6): how many give other bits with torch's float32 ``log1p`` and
    ``sigmoid`` (counted), and with ``core/numerics.py``'s, rounded from
    float64 (0 asserted: the CPU twins and replay depend on it)."""
    from igaming_platform_tpu_torch.core import numerics

    rng = np.random.default_rng(12)
    vals = torch.from_numpy((rng.random(n) * 10.0 ** rng.integers(-3, 9, n)).astype(np.float32))
    logits = torch.from_numpy((rng.normal(size=n) * 6.0).astype(np.float32))

    def differ(fn, v):
        return int((fn(v).view(torch.int32) != fn(v.cuda()).view(torch.int32).cpu()).sum())

    out = {"values": n,
           "torch_log1p_float32": differ(torch.log1p, vals),
           "torch_sigmoid_float32": differ(torch.sigmoid, logits),
           "numerics_log1p": differ(numerics.log1p, vals),
           "numerics_sigmoid": differ(numerics.sigmoid, logits)}
    log(f"phase 3: the card against the CPU over {n} values, outputs with other bits: "
        f"float32 log1p {out['torch_log1p_float32']}, sigmoid {out['torch_sigmoid_float32']}; "
        f"rounded from float64 (core/numerics.py) log1p {out['numerics_log1p']}, sigmoid "
        f"{out['numerics_sigmoid']}")
    if out["numerics_log1p"] or out["numerics_sigmoid"]:
        raise AssertionError(f"core/numerics.py gives other bits on the card: {out}")
    return out


def forest_plan_sweep(torch, gbdt_kernel, shapes=((64, 4, 256), (64, 4, 4096), (600, 4, 256),
                                                  (600, 4, 4096), (1000, 6, 256),
                                                  (1000, 6, 4096), (256, 10, 256),
                                                  (256, 10, 4096)),
                      rows=(32, 64), clusters=(1, 2, 4, 8)) -> list[dict]:
    """Back-to-back time of the forest kernel under launch plans other than
    ``launch_plan``'s (``plan_for``), through its C entry point, each held
    to the plain version in float64: for tuning the plan, not part of
    ``main``."""
    rng = np.random.default_rng(3)
    lib = gbdt_kernel._lib()
    out = []
    for n_trees, depth, b in shapes:
        args = forest_case(torch, rng, n_trees, depth, b)
        x, feat, thr, leaves, bias = args
        want = gbdt_kernel.gbdt_forest_plain(x.double(), feat, thr.double(), leaves.double(),
                                             bias.double())
        y = torch.empty(b, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for r, cl in itertools.product(rows, clusters):
            plan = gbdt_kernel.plan_for(b, N_FEATURES, n_trees, depth, r, cl)
            if plan.shared_bytes > gbdt_kernel.MAX_SHARED_BYTES:
                continue

            def run():
                if lib.gbdt_forest_launch(x.data_ptr(), feat.data_ptr(), thr.data_ptr(),
                                          leaves.data_ptr(), bias.data_ptr(), y.data_ptr(), b,
                                          N_FEATURES, n_trees, depth, plan.rows, plan.groups,
                                          plan.chunk, plan.cluster, plan.span,
                                          plan.tree_block, stream):
                    raise RuntimeError(f"gbdt_forest: launch refused: {plan}")

            run()
            torch.cuda.synchronize()
            err = float((y.double() - want).abs().max())
            if err > LARGE_ATOL:
                raise AssertionError(f"plan sweep T={n_trees} D={depth} B={b} {plan}: "
                                     f"max error {err}")
            row = {"T": n_trees, "D": depth, "B": b, **plan._asdict(),
                   "b2b_ms": device_ms_b2b(torch, run)}
            out.append(row)
            log(f"plan sweep: {json.dumps(row)}")
    return out


def load_parent_module(parent: str, source: str, module: str):
    """A kernel of another checkout at ``parent``: its ``csrc/<source>.cu``
    built with this tree's flags into ``build/parent_kernels/``, and its
    ``ops/<module>.py`` loaded under another name, launching that build."""
    import ctypes
    import importlib.util
    from pathlib import Path

    from igaming_platform_tpu_torch.ops import _build

    root = Path(parent) / "igaming_platform_tpu_torch"
    out = Path("build/parent_kernels")
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"lib{source}_{Path(parent).resolve().name}.so"
    built = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                            str(root / "csrc" / f"{source}.cu")], capture_output=True, text=True)
    if built.returncode:
        raise RuntimeError(f"parent {source} build failed:\n{built.stdout}{built.stderr}")
    spec = importlib.util.spec_from_file_location(f"parent_{module}", root / "ops" / f"{module}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib, own_lib = ctypes.CDLL(str(so)), mod._lib

    def parent_lib(*args):  # the parent's own loader, handed the parent's build
        load, _build.load = _build.load, (lambda name: lib)
        try:
            return own_lib(*args)
        finally:
            _build.load = load

    mod._lib = parent_lib
    return mod


def attention_invariance(torch, fwd, sizes=(1, 2, 16, 256, 2048)) -> dict:
    """Rows (of O and LSE) of the attention forward ``fwd`` launched on the
    heads of the leading B sequences that differ from the same rows of one
    launch over BATCH_SIZE sequences, per B of ``sizes``: at the session
    head's (4 B, 16, 8) and the abuse detector's (2 B, 64, 32)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for heads, s, dh in ((4, 16, 8), (2, 64, 32)):
        q, k, v = (torch.randn((heads * BATCH_SIZE, s, dh), device="cuda", generator=gen)
                   for _ in range(3))
        o, lse = fwd(q, k, v)
        full = torch.cat([o, lse], dim=2).view(torch.int32)
        diffs = {}
        for b in sizes:
            n = heads * b
            po, plse = fwd(q[:n], k[:n], v[:n])
            diffs[b] = int((torch.cat([po, plse], dim=2).view(torch.int32)
                            != full[:n]).any(dim=2).sum())
        out[f"({heads}B, {s}, {dh})"] = diffs
    return out


def kernel_turns(parent: str) -> dict:
    """This tree's dense kernel (bf16 mode) and attention forward against the
    checkout's at ``parent`` (a ``git archive`` unpack), in one process:
    each attention forward's ``attention_invariance``; then both dense
    kernels at DENSE_SHAPES and both forwards at FLASH_SHAPES, timed in
    turns (parent, change, change, parent) by one event pair a call and back
    to back, each checked bit-equal to the other's output (the dense kernel,
    whose bits must not change) or within FLASH_TOL of the plain version.
    Run it as ``python3 -c "import chip_smoke as c; c.kernel_turns('dir')"``."""
    import torch

    from igaming_platform_tpu_torch.ops import dense as dense_mod
    from igaming_platform_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    log(nvidia_smi_line())
    dense = (("parent", load_parent_module(parent, dense_source(parent), "dense").dense),
             ("change", dense_mod.dense))
    flash = (("parent", load_parent_module(parent, "flash_attention_fwd",
                                           "flash_attention").flash_attention_fwd),
             ("change", fa.flash_attention_fwd))
    out = {"attention_invariance": {}, "dense": [], "flash": []}
    for name, fwd in flash:
        out["attention_invariance"][name] = inv = attention_invariance(torch, fwd)
        log(f"kernel turns: {name} attention forward, rows differing from the "
            f"B={BATCH_SIZE} launch: {json.dumps(inv)}")

    def turns(pair, run_of):
        times = {"parent": [], "change": []}
        for name, fn in (pair[0], pair[1], pair[1], pair[0]):
            run = run_of(fn)
            times[name].append({"per_pair_ms": device_ms(torch, run),
                                "back_to_back_ms": device_ms_b2b(torch, run)})
        return times

    rng = np.random.default_rng(10)
    for b, k, n in DENSE_SHAPES:
        x, w, bias = dense_case(torch, rng, b, k, n)
        if not torch.equal(dense[0][1](x, w, bias).view(torch.int32),
                           dense[1][1](x, w, bias).view(torch.int32)):
            raise AssertionError(f"kernel turns: dense B={b} K={k} N={n}: the bits changed")
        row = {"B": b, "K": k, "N": n, **turns(dense, lambda fn: lambda: fn(x, w, bias))}
        out["dense"].append(row)
        log(f"kernel turns: dense {json.dumps(row)}")
    gen = torch.Generator(device="cuda").manual_seed(6)
    for bh, s, dh in FLASH_SHAPES:
        q, k, v = (torch.randn((bh, s, dh), device="cuda", generator=gen) for _ in range(3))
        want = fa.flash_attention_plain(q, k, v)
        for name, fwd in flash:
            for got, ref in zip(fwd(q, k, v), want):
                if not torch.allclose(got, ref, rtol=FLASH_TOL, atol=FLASH_TOL):
                    raise AssertionError(f"kernel turns: {name} forward at ({bh}, {s}, {dh}) "
                                         "misses the plain version")
        row = {"BH": bh, "S": s, "Dh": dh, **turns(flash, lambda fn: lambda: fn(q, k, v))}
        out["flash"].append(row)
        log(f"kernel turns: flash {json.dumps(row)}")
    return out


def dense_source(root: str) -> str:
    """The dense kernel's source in the checkout at ``root``: ``dense_fixed``,
    or ``dense_bf16`` before the float32 mode."""
    from pathlib import Path

    csrc = Path(root) / "igaming_platform_tpu_torch" / "csrc"
    return next(name for name in ("dense_fixed", "dense_bf16") if (csrc / f"{name}.cu").exists())


def dense_variants(*parents: str, variants=DENSE_VARIANTS) -> dict:
    """The dense kernel against its parents and its own builds, in one
    process: this tree's ``csrc/dense_fixed.cu`` also built with each set of
    knobs of ``variants`` (a ``-D`` each; the timing probes), all ``nvcc``
    at once, register use logged, beside the dense kernels of the checkouts
    at ``parents`` (``git archive`` unpacks). Each kernel that is not a
    probe is held bit-equal to ``dense_plain`` (bf16 mode) at DENSE_SHAPES,
    DENSE_CHECK_SHAPES and DENSE_K_SWEEP, and to ``dense_f32_plain``
    (float32 mode) at DENSE_F32_SHAPES and DENSE_F32_CHECK_SHAPES. Then,
    back to back, every kernel in turns (the list, then the list reversed)
    at DENSE_SHAPES beside ``torch.matmul``, a float32 to bf16 copy of x
    (what a bf16 copy of x made before the kernel would cost at least) and
    the bound; the timing split over DENSE_K_SWEEP at B=4096, N=256, probes
    included (the k loop's share of the card's float32 rate with and without
    the operand loads and the staging); and the float32 mode at
    DENSE_F32_SHAPES beside ``torch.addmm``.
    Run it as ``python3 -c "import chip_smoke as c; c.dense_variants('dir', ...)"``."""
    import ctypes
    from pathlib import Path

    import torch

    from igaming_platform_tpu_torch.ops import _build
    from igaming_platform_tpu_torch.ops import dense as dense_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    log(nvidia_smi_line())
    out_dir = Path("build/dense_variants")
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "dense_fixed.cu"
    procs = {}
    for i, knobs in enumerate(variants):
        name = " ".join(f"{k}={v}" for k, v in knobs.items())
        so = out_dir / f"libdense_fixed_variant{i}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *(f"-D{k}={v}" for k, v in knobs.items()),
             "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"dense variant {name}: build failed:\n{text}")
        for line in text.splitlines():  # per kernel: <mode, lanes' rows, rows a lane>
            if "Function properties for" in line or "registers" in line or "spill" in line:
                log(f"dense variants: {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(so))

    def wrapper(lib, entry):
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run(x, w, b):
            y = torch.empty((x.shape[0], w.shape[1]), device="cuda")
            if fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), x.shape[0],
                  x.shape[1], w.shape[1], torch.cuda.current_stream().cuda_stream):
                raise RuntimeError(f"{entry}: launch failed")
            return y
        return run

    probes = {name: wrapper(lib, "dense_bf16_launch") for name, lib in libs.items()
              if "DENSE_PROBE" in name}  # timed in the split only: wrong answers
    bf16 = {name: wrapper(lib, "dense_bf16_launch") for name, lib in libs.items()
            if name not in probes}
    f32 = {name: wrapper(lib, "dense_f32_launch") for name, lib in libs.items()
           if name not in probes}
    for parent in parents:
        mod = load_parent_module(parent, dense_source(parent), "dense")
        bf16[f"parent {Path(parent).name}"] = mod.dense
        if hasattr(mod, "dense_f32"):
            f32[f"parent {Path(parent).name}"] = mod.dense_f32
    bf16["this tree"] = dense_mod.dense
    f32["this tree"] = dense_mod.dense_f32

    def equal(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    def in_turns(kernels, args):
        times = {name: [] for name in kernels}
        order = list(kernels)
        for name in order + order[::-1]:
            times[name].append(device_ms_b2b(torch, lambda: kernels[name](*args)))
        return times

    rng = np.random.default_rng(10)
    out = {"bf16": [], "f32": [], "k_sweep": {}}
    checked = [(b, k, n, False) for b, k, n in (*DENSE_SHAPES, *DENSE_CHECK_SHAPES)]
    checked += [(BATCH_SIZE, k, 256, False) for k in DENSE_K_SWEEP]
    checked += [(b, k, n, True) for b, k, n in (*DENSE_F32_SHAPES, *DENSE_F32_CHECK_SHAPES)]
    for b, k, n, is_f32 in checked:
        x, w, bias = dense_case(torch, rng, b, k, n, is_f32)
        want = (dense_mod.dense_f32_plain if is_f32 else dense_mod.dense_plain)(x, w, bias)
        for name, fn in (f32 if is_f32 else bf16).items():
            if not equal(fn(x, w, bias), want):
                raise AssertionError(f"dense variants: {name} {'f32' if is_f32 else 'bf16'} "
                                     f"B={b} K={k} N={n}: other bits than the plain version")
    log(f"dense variants: {len(checked)} shapes, every kernel bit-equal to its plain version")
    for b, k, n in DENSE_SHAPES:
        x, w, bias = dense_case(torch, rng, b, k, n)
        xo, xh = dense_mod.round_bf16(x), torch.empty((b, k), dtype=torch.bfloat16, device="cuda")
        row = {"B": b, "K": k, "N": n, "bound_ms": dense_bound(b, k, n)[0],
               "bound_by": dense_bound(b, k, n)[1],
               **in_turns({**bf16, "torch.matmul": lambda x, w, b: torch.matmul(xo, w),
                           "x to bf16": lambda x, w, b: xh.copy_(x)}, (x, w, bias))}
        out["bf16"].append(row)
        log(f"dense variants: bf16 {json.dumps(row)}")
    for name, fn in {**bf16, **probes}.items():
        sweep = {}
        for k in DENSE_K_SWEEP:
            x, w, bias = dense_case(torch, rng, BATCH_SIZE, k, 256)
            sweep[k] = device_ms_b2b(torch, lambda: fn(x, w, bias))
        slope, intercept = np.polyfit(np.array(DENSE_K_SWEEP, dtype=np.float64),
                                      [sweep[k] for k in DENSE_K_SWEEP], 1)
        out["k_sweep"][name] = {"b2b_ms": sweep, "ms_per_k": slope, "fixed_ms": intercept,
                                "share_of_peak_in_the_k_loop":
                                    2.0 * BATCH_SIZE * 256 / (slope * 1e-3) / FP32_OPS_PER_S}
        log(f"dense variants: timing split {name} {json.dumps(out['k_sweep'][name])}")
    for b, k, n in DENSE_F32_SHAPES:
        x, w, bias = dense_case(torch, rng, b, k, n, True)
        row = {"B": b, "K": k, "N": n, "bound_ms": dense_bound(b, k, n)[0],
               **in_turns({**f32, "torch.addmm": lambda x, w, b: torch.addmm(b, x, w)},
                          (x, w, bias))}
        out["f32"].append(row)
        log(f"dense variants: f32 {json.dumps(row)}")
    return out


def forest_turns(parent: str, shapes=((64, 4, 1), (64, 4, 256), (64, 4, 2048), (64, 4, 4096),
                                      (16, 3, 256), (16, 3, 4096), (600, 4, 1), (600, 4, 256),
                                      (600, 4, 2048), (600, 4, 4096), (1000, 6, 1),
                                      (1000, 6, 256), (1000, 6, 2048), (1000, 6, 4096),
                                      (256, 10, 256), (256, 10, 4096))) -> dict:
    """This tree's forest kernel against the one of the checkout at
    ``parent`` (a ``git archive`` unpack), in one process: each kernel's
    rows differing from its own full launch (``differing_rows``) at the
    INVARIANCE_FORESTS and (256, 10), (16, 3); then at each (T, D, B) of
    ``shapes`` both timed in turns (parent, change, change, parent) by one
    event pair a call and back to back, and by the profiler at PROFILE_B.
    Run it as ``python3 -c "import chip_smoke as c; c.forest_turns('dir')"``."""
    import torch

    from igaming_platform_tpu_torch.ops import gbdt_kernel

    log(nvidia_smi_line())
    kernels = (("parent", load_parent_module(parent, "gbdt_forest", "gbdt_kernel")),
               ("change", gbdt_kernel))
    rng = np.random.default_rng(9)
    out = {"invariance": {}, "times": []}
    for n_trees, depth in (*INVARIANCE_FORESTS, (256, 10), (16, 3)):
        x, *forest = forest_case(torch, rng, n_trees, depth, BATCH_SIZE)
        for name, mod in kernels:
            diffs = differing_rows(lambda xb: mod.gbdt_forest(xb, *forest).view(
                torch.int32).cpu().numpy()[:, None], x)
            out["invariance"][f"{name} {n_trees}x{depth}"] = diffs
            log(f"forest turns: {name} T={n_trees} D={depth}: rows differing from the "
                f"B={BATCH_SIZE} launch {json.dumps(diffs)}")
    for n_trees, depth, b in shapes:
        args = forest_case(torch, rng, n_trees, depth, b)
        row = {"T": n_trees, "D": depth, "B": b, "parent": [], "change": [],
               "plan": gbdt_kernel.launch_plan(b, N_FEATURES, n_trees, depth,
                                               gbdt_kernel._sm_count(0))._asdict()}
        for name, mod in (kernels[0], kernels[1], kernels[1], kernels[0]):
            run = lambda: mod.gbdt_forest(*args)  # noqa: E731
            row[name].append({"per_pair_ms": device_ms(torch, run),
                              "back_to_back_ms": device_ms_b2b(torch, run)})
        for name, mod in kernels:
            row[f"{name}_profiler_ms"] = (profiled_kernel_ms(
                torch, lambda: mod.gbdt_forest(*args), "gbdt_forest_kernel")
                if b in PROFILE_B else None)
        out["times"].append(row)
        log(f"forest turns: {json.dumps(row)}")
    return out


def phase_launch_floor(torch) -> dict:
    """The time of an empty kernel (``csrc/mma_rate.cu`` ``empty_launch``)
    through the same ctypes path as the forest's: the floor of any launch,
    by one event pair a launch and back to back."""
    import ctypes

    from igaming_platform_tpu_torch.ops import _build

    fn = _build.load("mma_rate").empty_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        if fn(stream):
            raise RuntimeError("empty_launch: kernel launch failed")

    floor = {"per_pair_ms": device_ms(torch, run), "back_to_back_ms": device_ms_b2b(torch, run)}
    log(f"phase 3: empty kernel (the launch floor): per_pair_ms={floor['per_pair_ms']:.6f} "
        f"back_to_back_ms={floor['back_to_back_ms']:.6f}")
    return floor


def phase_mma_rate(torch) -> dict:
    """The card's ``mma.sync`` rate in TFLOP/s (``csrc/mma_rate.cu``): 8 warps
    an SM, as the attention kernels run, each with 8 independent chains of
    TF32 m16n8k8 (the forward's product) or bf16 m16n8k16 (the backward's)."""
    import ctypes

    from igaming_platform_tpu_torch.ops import _build

    fn = _build.load("mma_rate").mma_rate_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    blocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 128, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for name, tf32, flop in (("tf32_m16n8k8", 1, 2048), ("bf16_m16n8k16", 0, 4096)):
        def run():
            if fn(tf32, blocks, MMA_ITERS, out.data_ptr(), stream):
                raise RuntimeError("mma_rate: kernel launch failed")

        ms = device_ms(torch, run, reps=10)
        rates[name] = blocks * 4 * MMA_ITERS * 8 * flop / ms / 1e9
    log(f"phase 3: mma.sync rate, 8 warps an SM: TF32 m16n8k8 {rates['tf32_m16n8k8']:.1f} "
        f"TFLOP/s, bf16 m16n8k16 {rates['bf16_m16n8k16']:.1f} TFLOP/s")
    return rates


def flash_bound(bh: int, s: int, dh: int) -> tuple[float, str]:
    """Least time for one forward on this card: 4*BH*S^2*Dh float32-accurate
    flops at ``ATTN_OPS_PER_S``, or q, k, v read and o, lse written once."""
    ops_ms = 4.0 * bh * s * s * dh / ATTN_OPS_PER_S * 1e3
    bytes_ms = (4 * bh * s * dh * 4 + bh * s * 4) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def share_of_bar(got, want) -> float:
    """The largest |got - want| / (atol + rtol |want|) at FLASH_TOL, in float64."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (FLASH_TOL + FLASH_TOL * want.abs())).max())


def check_flash(torch, fa, q, k, v, want, name: str) -> dict:
    """The wrapper's O and LSE against ``want`` at rtol/atol FLASH_TOL, and a
    second launch, which must give the same bits; returns the max errors and
    the share of the bar they use."""
    bh, s, dh = q.shape
    (o, lse), (o2, lse2) = (fa.flash_attention_fwd(q, k, v) for _ in range(2))
    torch.cuda.synchronize()
    if o.shape != (bh, s, dh) or lse.shape != (bh, s, 1):
        raise AssertionError(f"{name}: shapes {tuple(o.shape)}, {tuple(lse.shape)}")
    if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
        raise AssertionError(f"{name}: non-finite output")
    for what, got, w in (("O", o, want[0]), ("LSE", lse, want[1])):
        if not torch.allclose(got.double(), w.double(), rtol=FLASH_TOL, atol=FLASH_TOL):
            raise AssertionError(f"{name}: {what} max error "
                                 f"{float((got.double() - w.double()).abs().max())} beyond "
                                 f"{FLASH_TOL}")
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"{name}: two launches gave different bits")
    return {"max_abs_err_o": float((o.double() - want[0].double()).abs().max()),
            "max_abs_err_lse": float((lse.double() - want[1].double()).abs().max()),
            "share_of_bar": max(share_of_bar(o, want[0]), share_of_bar(lse, want[1])),
            "out": (o, lse)}


def phase_flash(torch, fa) -> list[dict]:
    """The forward against the plain version at every timed shape (two
    launches bit-identical), timed beside the plain version and
    ``scaled_dot_product_attention``; then amplitude-3 inputs against the
    plain version in float64, and the check-only shapes."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for bh, s, dh in FLASH_SHAPES:
        q, k, v = (torch.randn((bh, s, dh), generator=gen, device="cuda") for _ in range(3))
        name = f"flash_attention_fwd BH={bh} S={s} Dh={dh}"
        got = check_flash(torch, fa, q, k, v, fa.flash_attention_plain(q, k, v), name)
        del got["out"]
        bound, bound_by = flash_bound(bh, s, dh)
        reps = REPS if s <= 2048 else 10
        row = {"BH": bh, "S": s, "Dh": dh,
               "max_abs_err": max(got["max_abs_err_o"], got["max_abs_err_lse"]), **got,
               "repeatable": True,
               "kernel_ms": device_ms(torch, lambda: fa.flash_attention_fwd(q, k, v), reps),
               "plain_ms": device_ms(torch, lambda: fa.flash_attention_plain(q, k, v), reps),
               "library_ms": device_ms(torch, lambda: sdpa(q, k, v), reps),
               "bound_ms": bound, "bound_by": bound_by}
        row["bound_share"] = bound / row["kernel_ms"]
        row["over_sdpa"] = row["kernel_ms"] / row["library_ms"]
        rows.append(row)
        log(f"phase 3: {name}: max_abs_err O={row['max_abs_err_o']:.3g} "
            f"LSE={row['max_abs_err_lse']:.3g} ({got['share_of_bar']:.3f} of the bar), two "
            f"launches bit-identical; kernel_ms={row['kernel_ms']:.6f} "
            f"plain_ms={row['plain_ms']:.6f} sdpa_ms={row['library_ms']:.6f} "
            f"(kernel/sdpa {row['over_sdpa']:.3f}) bound_ms={bound:.6f} ({bound_by}, "
            f"{100 * row['bound_share']:.1f}% of it)")
    for bh, s, dh in FLASH_AMP_SHAPES:
        q, k, v = (FLASH_AMP * torch.randn((bh, s, dh), generator=gen, device="cuda")
                   for _ in range(3))
        name = f"flash_attention_fwd BH={bh} S={s} Dh={dh} amplitude {FLASH_AMP:g}"
        want = fa.flash_attention_plain(q.double(), k.double(), v.double())
        got = check_flash(torch, fa, q, k, v, want, name)
        plain = fa.flash_attention_plain(q, k, v)
        amp = {"share_of_bar_vs_f64": got["share_of_bar"],
               "max_abs_err_o_vs_f64": got["max_abs_err_o"],
               "max_abs_err_lse_vs_f64": got["max_abs_err_lse"],
               "plain_f32_share_of_bar_vs_f64": max(share_of_bar(p, w)
                                                    for p, w in zip(plain, want)),
               "share_of_bar_vs_plain_f32": max(share_of_bar(g, p)
                                                for g, p in zip(got["out"], plain))}
        next(r for r in rows if (r["BH"], r["S"], r["Dh"]) == (bh, s, dh))["amplitude_3"] = amp
        del want, plain, got
        log(f"phase 3: {name}: against the plain version in float64 "
            f"{amp['share_of_bar_vs_f64']:.3f} of the bar (max_abs_err "
            f"O={amp['max_abs_err_o_vs_f64']:.3g} LSE={amp['max_abs_err_lse_vs_f64']:.3g}), two "
            f"launches bit-identical; the float32 "
            f"plain version is {amp['plain_f32_share_of_bar_vs_f64']:.3f} of the bar from float64 "
            f"and the kernel {amp['share_of_bar_vs_plain_f32']:.3f} of it from the float32 plain")
    for bh, s, dh in FLASH_CHECK_SHAPES:
        q, k, v = (torch.randn((bh, s, dh), generator=gen, device="cuda") for _ in range(3))
        name = f"flash_attention_fwd BH={bh} S={s} Dh={dh}"
        got = check_flash(torch, fa, q, k, v, fa.flash_attention_plain(q, k, v), name)
        log(f"phase 3: {name} (check only): max_abs_err O={got['max_abs_err_o']:.3g} "
            f"LSE={got['max_abs_err_lse']:.3g} ({got['share_of_bar']:.3f} of the bar), two "
            f"launches bit-identical")
    return rows


def flash_bwd_bounds(bh: int, s: int, dh: int) -> dict:
    """Least time on this card, at ``ATTN_OPS_PER_S`` or the bytes each input
    read and each output written once, for each backward kernel: 6 (dQ) and 8
    (dK/dV) x BH*S^2*Dh flops, each with its recompute (q, k, v, dO, LSE and D
    in; dQ, or dK and dV, out); and for the pair (``flash_attention_bwd``):
    10 x BH*S^2*Dh, the five products the gradient needs (q, k, v, O, dO and
    LSE in; dQ, dK, dV out)."""
    row, vec = bh * s * dh * 4, bh * s * 4
    out = {}
    for part, flops, n_bytes in (("dq", 6, 5 * row + 2 * vec), ("dkv", 8, 6 * row + 2 * vec),
                                 ("pair", 10, 8 * row + vec)):
        ops_ms = flops * bh * s * s * dh / ATTN_OPS_PER_S * 1e3
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        out[part] = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    return out


def check_flash_bwd(torch, fa, bh: int, s: int, dh: int, gen) -> tuple:
    """The wrapper's dQ, dK and dV against the plain backward at rtol/atol
    GRAD_TOL on seeded inputs; returns the inputs and the max errors."""
    q, k, v, do = (torch.randn((bh, s, dh), generator=gen, device="cuda") for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    name = f"flash_attention_bwd BH={bh} S={s} Dh={dh}"
    errs = {}
    for what, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.shape != (bh, s, dh) or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: {what} has shape {tuple(g.shape)} or non-finite values")
        if not torch.allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL):
            raise AssertionError(f"{name}: {what} max error "
                                 f"{float((g - w).abs().max())} beyond {GRAD_TOL}")
        errs[what] = float((g - w).abs().max())
    return (q, k, v, o, lse, do), errs


def phase_flash_bwd(torch, fa) -> list[dict]:
    """Both backward kernels against the plain backward, each timed alone
    through its C entry point on the wrapper's inputs, and launched twice
    more there, into fresh outputs, which must be bit-identical; the pair
    through ``flash_attention_bwd`` (D included); the plain backward; and the
    backward of ``scaled_dot_product_attention`` (``torch.autograd.grad``
    with dO) as the library's yardstick for the pair. Then the check-only
    shapes."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = fa._lib("flash_attention_bwd")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for bh, s, dh in FLASH_BWD_SHAPES:
        (q, k, v, o, lse, do), errs = check_flash_bwd(torch, fa, bh, s, dh, gen)
        name = f"flash_attention_bwd BH={bh} S={s} Dh={dh}"
        dmat = (do * o).sum(dim=-1)
        stream = torch.cuda.current_stream().cuda_stream
        scale = 1.0 / math.sqrt(dh)
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
               dmat.data_ptr())

        def dq_only(dq):
            if lib.flash_attention_bwd_dq_launch(*ins, dq.data_ptr(), bh, s, dh, scale, stream):
                raise RuntimeError(f"{name}: dQ launch failed")

        def dkv_only(dk, dv):
            if lib.flash_attention_bwd_dkv_launch(*ins, dk.data_ptr(), dv.data_ptr(), bh, s, dh,
                                                  scale, stream):
                raise RuntimeError(f"{name}: dK/dV launch failed")

        runs = [[torch.empty_like(q) for _ in range(3)] for _ in range(2)]
        for dq, dk, dv in runs:
            dq_only(dq)
            dkv_only(dk, dv)
        torch.cuda.synchronize()
        for what, a, b in zip(("dQ", "dK", "dV"), *runs):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: two launches gave different {what}")
        dq, dk, dv = runs[0]
        del runs[1]

        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = sdpa(*leaves)
        reps = REPS if s <= 2048 else 10
        bounds = flash_bwd_bounds(bh, s, dh)
        row = {"BH": bh, "S": s, "Dh": dh,
               "max_abs_err_dq": errs["dq"], "max_abs_err_dk": errs["dk"],
               "max_abs_err_dv": errs["dv"], "max_abs_err_dkv": max(errs["dk"], errs["dv"]),
               "repeatable": True,
               "dq_ms": device_ms(torch, lambda: dq_only(dq), reps),
               "dkv_ms": device_ms(torch, lambda: dkv_only(dk, dv), reps),
               "pair_ms": device_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
                                    reps),
               "plain_ms": device_ms(
                   torch, lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do), reps),
               "library_ms": device_ms(
                   torch, lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), reps),
               "dq_bound_ms": bounds["dq"][0], "dq_bound_by": bounds["dq"][1],
               "dkv_bound_ms": bounds["dkv"][0], "dkv_bound_by": bounds["dkv"][1],
               "pair_bound_ms": bounds["pair"][0], "pair_bound_by": bounds["pair"][1]}
        row["pair_over_sdpa"] = row["pair_ms"] / row["library_ms"]
        del out, leaves
        rows.append(row)
        log(f"phase 3: {name}: max_abs_err dQ={errs['dq']:.3g} dK={errs['dk']:.3g} "
            f"dV={errs['dv']:.3g}, two launches bit-identical; dq_ms={row['dq_ms']:.6f} "
            f"(bound {bounds['dq'][0]:.6f}, {bounds['dq'][1]}) dkv_ms={row['dkv_ms']:.6f} "
            f"(bound {bounds['dkv'][0]:.6f}, {bounds['dkv'][1]}) pair_ms={row['pair_ms']:.6f} "
            f"(bound {bounds['pair'][0]:.6f}, {bounds['pair'][1]}) plain_ms={row['plain_ms']:.6f} "
            f"sdpa_bwd_ms={row['library_ms']:.6f} pair/sdpa={row['pair_over_sdpa']:.3f}")
    for bh, s, dh in FLASH_BWD_CHECK_SHAPES:
        _, errs = check_flash_bwd(torch, fa, bh, s, dh, gen)
        log(f"phase 3: flash_attention_bwd BH={bh} S={s} Dh={dh} (check only): max_abs_err "
            f"dQ={errs['dq']:.3g} dK={errs['dk']:.3g} dV={errs['dv']:.3g}")
    return rows


def fill_store(store_mod, now: float):
    """10,000 accounts with about 20 events each over the last two days,
    some bonus claims, and blacklisted devices and IPs."""
    rng = np.random.default_rng(1)
    store = store_mod.InMemoryFeatureStore()
    n = N_ACCOUNTS * EVENTS_PER_ACCOUNT
    accounts = rng.integers(0, N_ACCOUNTS, n)
    ts = np.sort(now - rng.random(n) * rng.choice([300.0, 3600.0, 172800.0], n))
    amounts = rng.integers(100, 500_000, n)
    types = rng.choice(["deposit", "withdraw", "bet", "win"], n, p=[0.3, 0.1, 0.5, 0.1])
    devices, ips = rng.integers(0, 50_000, n), rng.integers(0, 80_000, n)
    for i in range(n):
        store.update(store_mod.TransactionEvent(
            account_id=f"acct{accounts[i]}", amount=int(amounts[i]), tx_type=str(types[i]),
            ip=f"ip{ips[i]}", device_id=f"dev{devices[i]}", timestamp=float(ts[i])))
    for a in rng.integers(0, N_ACCOUNTS, 2_000):
        store.record_bonus_claim(f"acct{a}", wager_complete_rate=float(rng.random()))
    for d in rng.integers(0, 50_000, 500):
        store.add_to_blacklist("device", f"dev{d}")
    for a in rng.integers(0, 80_000, 500):
        store.add_to_blacklist("ip", f"ip{a}")
    return store


def requests(scorer, n: int, seed: int):
    rng = np.random.default_rng(seed)
    types = ("deposit", "withdraw", "bet")
    return [scorer.ScoreRequest(
        account_id=f"acct{rng.integers(0, N_ACCOUNTS + 500)}",
        amount=int(rng.integers(100, 2_000_000)), tx_type=types[rng.integers(3)],
        ip=f"ip{rng.integers(0, 80_000)}", device_id=f"dev{rng.integers(0, 50_000)}",
        ip_flags=tuple(int(v) for v in rng.random(3) < 0.05)) for _ in range(n)]


def compare_with_cpu(responses, reqs, store, cpu_engine) -> int:
    """Responses of the card against the CPU engine on the same rows.
    Returns the number of floor-boundary rows left unchecked."""
    return compare_columns(*engine_columns(responses, reqs, store, cpu_engine))


def engine_columns(responses, reqs, store, cpu_engine) -> tuple[dict, dict]:
    """(the responses' result columns, the CPU engine's on the same rows)."""
    x = np.stack([r.features.to_array() for r in responses])
    bl = np.array([store.check_blacklist(r.device_id, r.fingerprint, r.ip) for r in reqs])
    want = {k: v.numpy() for k, v in cpu_engine.score_arrays(x, bl).items()}
    codes = {"approve": 1, "review": 2, "block": 3}
    from igaming_platform_tpu_torch.core.enums import REASON_BIT_ORDER

    got = {
        "score": np.array([r.score for r in responses]),
        "action": np.array([codes[r.action] for r in responses]),
        "rule_score": np.array([r.rule_score for r in responses]),
        "ml_score": np.array([r.ml_score for r in responses], dtype=np.float32),
        "reason_mask": np.array([sum(1 << REASON_BIT_ORDER.index(c) for c in r.reason_codes)
                                 for r in responses]),
    }
    return got, want


def compare_columns(got: dict, want: dict, what: str = "engine") -> int:
    """Result columns of the card against the CPU engine's on the same rows:
    rule_score and reason_mask exact, ml_score within ML_ATOL, score and
    action exact except on rows within 1e-4 of a floor boundary whose
    ml_score differs. Returns the number of such rows."""
    if not (np.isfinite(got["ml_score"]).all() and (got["ml_score"] >= 0).all()
            and (got["ml_score"] <= 1).all() and (got["score"] >= 0).all()
            and (got["score"] <= 100).all()):
        raise AssertionError(f"{what}: scores out of range")
    for key in ("rule_score", "reason_mask"):
        if not np.array_equal(got[key], want[key]):
            raise AssertionError(f"{what}: {key} differs from the CPU engine")
    ml_err = float(np.abs(got["ml_score"] - want["ml_score"]).max())
    if ml_err > ML_ATOL:
        raise AssertionError(f"{what}: ml_score differs from the CPU engine by {ml_err}")
    pre = 0.4 * want["rule_score"] + 60.0 * want["ml_score"].astype(np.float64) + 1e-4
    same_ml = got["ml_score"].view(np.int32) == want["ml_score"].view(np.int32)
    checked = (np.abs(pre - np.round(pre)) > 1e-4) | same_ml
    for key in ("score", "action"):
        if not np.array_equal(got[key][checked], want[key][checked]):
            raise AssertionError(f"{what}: {key} differs from the CPU engine")
    return int((~checked).sum())


def phase_engine(torch, card: str, gbdt_kernel) -> dict:
    from igaming_platform_tpu_torch.convert import from_jax_params
    from igaming_platform_tpu_torch.ops import dense as dense_mod
    from igaming_platform_tpu_torch.core.config import BatcherConfig
    from igaming_platform_tpu_torch.serve import feature_store as store_mod
    from igaming_platform_tpu_torch.serve import scorer

    rng = np.random.default_rng(2)
    tree = {"mlp": mlp_tree(rng, SERVE_HIDDEN),
            "gbdt": forest_tree(rng, SERVE_TREES, SERVE_DEPTH)}
    t0 = time.perf_counter()
    store = fill_store(store_mod, time.time())
    log(f"phase 4: feature store of {store.num_accounts()} accounts, "
        f"{N_ACCOUNTS * EVENTS_PER_ACCOUNT} events, in {time.perf_counter() - t0:.1f} s")
    bcfg = BatcherConfig(batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0)
    engines = []
    try:
        gpu = scorer.TorchScoringEngine(ml_backend="mlp+gbdt", device="cuda",
                                        params=from_jax_params("mlp+gbdt", tree),
                                        batcher_config=bcfg, feature_store=store)
        engines.append(gpu)
        cpu = scorer.TorchScoringEngine(ml_backend="mlp+gbdt", device="cpu",
                                        params=from_jax_params("mlp+gbdt", tree),
                                        batcher_config=bcfg, feature_store=store, warmup=False)
        engines.append(cpu)
        singles = requests(scorer, N_SINGLE, 3)
        batch = requests(scorer, BATCH_SIZE, 4)
        torch.cuda.synchronize()

        # The main path's run: counts set to 0 just before, read just after.
        gbdt_kernel.gbdt_forest.launches = 0
        dense_mod.dense.launches = 0
        steps0 = gpu.device_steps
        single_out = [gpu.score(req) for req in singles]
        t = time.perf_counter()
        batch_out = gpu.score_batch(batch)
        batch_s = [time.perf_counter() - t]
        launches = gbdt_kernel.gbdt_forest.launches
        dense_launches = dense_mod.dense.launches
        steps = gpu.device_steps - steps0

        if launches == 0 or launches != steps:
            raise AssertionError(
                f"engine: {steps} device steps but {launches} forest kernel launches")
        layers = len(tree["mlp"]["layers"])
        if dense_launches != layers * steps:
            raise AssertionError(f"engine: {steps} device steps of {layers} MLP layers but "
                                 f"{dense_launches} dense kernel launches")
        boundary = (compare_with_cpu(single_out, singles, store, cpu)
                    + compare_with_cpu(batch_out, batch, store, cpu))
        step = score_step(torch, gpu, store, batch)
        step_ms = step_device_ms(torch, step)
        # The step's kernels by name, from the profiler: what its device time is.
        step_profile = profile_window(torch, step, top=50)

        for _ in range(4):
            t = time.perf_counter()
            gpu.score_batch(batch)
            batch_s.append(time.perf_counter() - t)
        single_ms = []
        for req in requests(scorer, N_LATENCY, 5):
            t = time.perf_counter()
            gpu.score(req)
            single_ms.append((time.perf_counter() - t) * 1e3)

        # Where one batch's host time goes: the gather, the device step with
        # its copies both ways, and building the row responses.
        t = time.perf_counter()
        x_b, bl_b = store.gather_batch(batch)
        t_gather = time.perf_counter() - t
        host = gpu._readback(gpu._launch(x_b, bl_b, gpu.get_params()))
        t_step = time.perf_counter() - t - t_gather
        [gpu._row_response(host, x_b, i) for i in range(BATCH_SIZE)]
        t_rows = time.perf_counter() - t - t_gather - t_step
    finally:
        for eng in engines:
            eng.close()
    large = large_forest_engine(torch, gbdt_kernel, rng, store, bcfg, singles, batch)
    result = {
        "launches": launches, "dense_launches": dense_launches, "device_steps": steps,
        "floor_boundary_rows": boundary,
        "batch_rows_per_s": [BATCH_SIZE / s for s in batch_s],
        "single_n": N_LATENCY,
        "single_p50_ms": float(np.percentile(single_ms, 50)),
        "single_p99_ms": float(np.percentile(single_ms, 99)),
        "step_4096_device_ms": step_ms,
        "batch_4096_host_ms": {"gather": t_gather * 1e3, "step_and_copies": t_step * 1e3,
                               "responses": t_rows * 1e3},
        "step_4096_kernels": step_profile,
        "gbdt_engine_1000x6": large,
    }
    log(f"phase 4: [{card}] score_batch({BATCH_SIZE}) x5: median "
        f"{statistics.median(result['batch_rows_per_s']):.0f} rows/s; "
        f"score() x{N_LATENCY} sequential: p50 {result['single_p50_ms']:.3f} ms, "
        f"p99 {result['single_p99_ms']:.3f} ms; device time of one {BATCH_SIZE}-row step "
        f"{step_ms:.6f} ms")
    log(f"phase 4: {steps} device steps, {launches} forest kernel launches, {dense_launches} "
        f"dense kernel launches; agrees with the "
        f"CPU engine ({boundary} floor-boundary rows not compared)")
    if step_profile["device_ms"] is not None:
        log(f"phase 4: one {BATCH_SIZE}-row step's kernels (torch.profiler): "
            f"{step_profile['device_ms']:.6f} ms of device time in "
            f"{step_profile['wall_ms']:.3f} ms of wall; by name: "
            + "; ".join(f"{k['kernel']} {k['device_ms']:.6f} ms x{k['count']}"
                        for k in step_profile["top"]))
    log(f"phase 4: gbdt engine with a {LARGE_ENGINE_FOREST[0]} x {LARGE_ENGINE_FOREST[1]} forest: "
        f"{large['device_steps']} device steps, {large['launches']} forest kernel launches; "
        f"agrees with the CPU engine ({large['floor_boundary_rows']} floor-boundary rows not "
        f"compared); device time of one {BATCH_SIZE}-row step {large['step_4096_device_ms']:.6f} ms")
    log("phase 4: " + json.dumps(result))
    return result


def score_step(torch, engine, store, batch):
    """One full-batch score step of ``engine``, inputs already on the card."""
    x_step, bl_step = (torch.from_numpy(a).cuda() for a in store.gather_batch(batch))

    def step():
        with torch.inference_mode():
            engine._score_fn(engine.get_params(), x_step, bl_step, engine._thresholds)

    return step


def step_device_ms(torch, step) -> float:
    """Device time of a score step, by CUDA events behind a long spin: an
    eager step's enqueue outlasts the default spin on a slow host, and the
    events would then count host time."""
    return device_ms(torch, step, reps=20, sleep=B2B_SLEEP_CYCLES)


def large_forest_engine(torch, gbdt_kernel, rng, store, bcfg, singles, batch) -> dict:
    """A ``gbdt`` engine on the card with a production-sized forest
    (LARGE_ENGINE_FOREST): the singles and the batch, its forest launches
    equal to its device steps, its answers against the CPU engine's."""
    from igaming_platform_tpu_torch.convert import from_jax_params
    from igaming_platform_tpu_torch.serve import scorer

    tree = {"gbdt": forest_tree(rng, *LARGE_ENGINE_FOREST)}
    engines = []
    try:
        for device in ("cuda", "cpu"):
            engines.append(scorer.TorchScoringEngine(
                ml_backend="gbdt", device=device, params=from_jax_params("gbdt", tree),
                batcher_config=bcfg, feature_store=store, warmup=device == "cuda"))
        gpu, cpu = engines
        torch.cuda.synchronize()
        # This path's run: counts set to 0 just before, read just after.
        gbdt_kernel.gbdt_forest.launches = 0
        steps0 = gpu.device_steps
        single_out = [gpu.score(req) for req in singles]
        batch_out = gpu.score_batch(batch)
        launches = gbdt_kernel.gbdt_forest.launches
        steps = gpu.device_steps - steps0
        if launches == 0 or launches != steps:
            raise AssertionError(f"gbdt engine {LARGE_ENGINE_FOREST}: {steps} device steps but "
                                 f"{launches} forest kernel launches")
        boundary = (compare_with_cpu(single_out, singles, store, cpu)
                    + compare_with_cpu(batch_out, batch, store, cpu))
        step_ms = step_device_ms(torch, score_step(torch, gpu, store, batch))
    finally:
        for eng in engines:
            eng.close()
    return {"forest": list(LARGE_ENGINE_FOREST), "launches": launches, "device_steps": steps,
            "floor_boundary_rows": boundary, "step_4096_device_ms": step_ms}


def seq_tree(rng, cfg: dict) -> dict:
    """A random sequence model in the JAX package's params layout
    (``init_sequence_model``), with random biases and norm scales too."""
    d, d_ff = cfg["d_model"], cfg["d_ff"]

    def dense(a, b, scale):
        return {"w": (rng.normal(size=(a, b)) * scale).astype(np.float32),
                "b": (rng.normal(size=(b,)) * 0.02).astype(np.float32)}

    def norm():
        return {"scale": (1.0 + rng.normal(size=(d,)) * 0.1).astype(np.float32),
                "bias": (rng.normal(size=(d,)) * 0.02).astype(np.float32)}

    return {
        "embed": dense(12, d, np.sqrt(2.0 / 12)),
        "layers": [{"ln1": norm(), "wqkv": dense(d, 3 * d, np.sqrt(1.0 / d)),
                    "wo": dense(d, d, np.sqrt(1.0 / d)), "ln2": norm(),
                    "w1": dense(d, d_ff, np.sqrt(2.0 / d)), "w2": dense(d_ff, d, np.sqrt(2.0 / d_ff))}
                   for _ in range(cfg["n_layers"])],
        "ln_f": norm(),
        "head": dense(d, 1, np.sqrt(1.0 / d)),
    }


def wallet_stream(events_mod, seed: int = 6):
    """Wallet events of ABUSE_ACCOUNTS accounts, oldest first: about one in
    six runs the abuse shape (deposit, bonus grant, rapid wagers, quick
    withdrawal) on a few shared devices, some of them blacklisted; the
    others deposit, bet and win at a human pace on their own devices. Some
    non-money events and ten redelivered duplicates. Ends just before
    STREAM_T0."""
    rng = np.random.default_rng(seed)
    stream = []
    for a in range(ABUSE_ACCOUNTS):
        acct = f"acct{a}"
        abuser = rng.random() < 0.16
        n = int(rng.integers(4 if abuser else 1, ABUSE_MAX_EVENTS + 1))
        t = STREAM_T0 - 86_400.0 * rng.random()
        for i in range(n):
            if abuser:
                kind = ("deposit" if i == 0 else "bonus_grant" if i == 1 else
                        "withdraw" if i == n - 1 else "bonus_wager")
                t += float(rng.exponential(12.0))
                device = f"shared{rng.integers(60)}"
            else:
                kind = str(rng.choice(["deposit", "bet", "win", "withdraw"],
                                      p=[0.2, 0.55, 0.2, 0.05]))
                t += float(rng.exponential(600.0))
                device = f"dev{a}" if rng.random() < 0.9 else f"dev{rng.integers(ABUSE_ACCOUNTS)}"
            ev = events_mod.new_transaction_event("transaction.completed", {
                "id": f"{acct}-{i}", "account_id": acct, "type": kind,
                "amount": int(rng.integers(500, 200_000)), "status": "completed"})
            ev.data["device_id"] = device
            ev.timestamp = min(t, STREAM_T0 - 1.0)
            stream.append(ev)
        if a % 50 == 0:  # not a money event: skipped
            stream.append(events_mod.Event(type="account.created", aggregate_id=acct,
                                           timestamp=stream[-1].timestamp - 1.0))
    stream.sort(key=lambda ev: ev.timestamp)
    # Redeliveries of the same envelopes, deduped by id.
    return stream + stream[:: len(stream) // 10][:10]


def abuse_bridge(device: str, model, stream):
    """A bridge over a mock-backend engine (the serving default) and a
    detector with ``model``, on ``device``, with the stream published."""
    from igaming_platform_tpu_torch.core.config import BatcherConfig
    from igaming_platform_tpu_torch.serve import abuse, bridge, events, feature_store, scorer

    # One event at a time through score(): no flush window to wait out.
    eng = scorer.TorchScoringEngine(
        device=device, batcher_config=BatcherConfig(batch_size=256, latency_tiers=(8,),
                                                    max_wait_ms=0.0),
        feature_store=feature_store.InMemoryFeatureStore(clock=lambda: STREAM_T0))
    for d in range(5):
        eng.features.add_to_blacklist("device", f"shared{d}")
    # Thresholds low enough that a few percent of events publish risk events.
    eng.set_thresholds(60, 40)
    det = abuse.SequenceAbuseDetector(params=model, device=device)
    b = bridge.ScoringBridge(eng, events.default_broker(), abuse_detector=det,
                             high_score_threshold=45)
    for ev in stream:
        b.broker.publish_raw("wallet.events", ev.type, ev.to_json())
    return b


def published(events_mod, broker) -> list:
    out = []
    while (raw := broker.get("notifications.events", timeout=0)) is not None:
        ev = events_mod.Event.from_json(raw)
        out.append((ev.type, ev.data))
    return out


def affine_layers(cfg) -> int:
    """``Affine`` layers a ``SequenceModel`` forward runs: the embedding,
    four a layer (qkv, wo, w1, w2), the head; one dense_f32 launch each."""
    return 2 + 4 * cfg.n_layers


def phase_abuse(torch, card: str, fa) -> dict:
    from igaming_platform_tpu_torch.convert import sequence_from_tree
    from igaming_platform_tpu_torch.models.sequence import SeqConfig
    from igaming_platform_tpu_torch.ops import dense as dense_mod
    from igaming_platform_tpu_torch.serve import events as events_mod

    rng = np.random.default_rng(7)
    cfg = SeqConfig(**ABUSE_CFG)
    model = sequence_from_tree(seq_tree(rng, ABUSE_CFG), cfg)
    stream = wallet_stream(events_mod)
    accounts = [f"acct{a}" for a in range(ABUSE_ACCOUNTS)]
    sample = accounts[:: ABUSE_ACCOUNTS // ABUSE_CHECKS]
    gpu = abuse_bridge("cuda", model, stream)
    cpu = abuse_bridge("cpu", model, stream)
    bridges = (gpu, cpu)
    det = gpu.abuse_detector
    try:
        det.check_batch(accounts[:ABUSE_BATCH])  # first forward off the count
        torch.cuda.synchronize()

        # The path's run: counts set to 0 just before, read just after.
        fa.flash_attention_fwd.launches = 0
        dense_mod.dense_f32.launches = 0
        steps0 = det.device_steps
        t = time.perf_counter()
        drained = gpu.drain()
        drain_s = time.perf_counter() - t
        scores = np.concatenate([det.check_batch(accounts[i:i + ABUSE_BATCH])
                                 for i in range(0, ABUSE_ACCOUNTS, ABUSE_BATCH)])
        checks = [det.check(a) for a in sample]
        launches = fa.flash_attention_fwd.launches
        dense_launches = dense_mod.dense_f32.launches
        steps = det.device_steps - steps0
        if launches == 0 or launches != cfg.n_layers * steps:
            raise AssertionError(f"abuse: {steps} forward passes of {cfg.n_layers} layers "
                                 f"but {launches} attention kernel launches")
        if dense_launches != affine_layers(cfg) * steps:
            raise AssertionError(f"abuse: {steps} forward passes of {affine_layers(cfg)} affine "
                                 f"layers but {dense_launches} dense_f32 launches")
        # One check() scores an account as check_batch(256) did, bit for bit.
        alone = np.array([c[0] for c in checks], dtype=np.float32)
        in_batch = scores[::ABUSE_ACCOUNTS // ABUSE_CHECKS]
        check_vs_batch = int((alone.view(np.int32) != in_batch.view(np.int32)).sum())
        if check_vs_batch:
            raise AssertionError(f"abuse: {check_vs_batch} of {len(sample)} accounts score "
                                 "other bits in check() than inside check_batch(256)")

        # The same stream through the CPU bridge and detector.
        t = time.perf_counter()
        cpu.drain()
        cpu_drain_s = time.perf_counter() - t
        counts = [(b.events_processed, b.events_skipped, b.events_deduped) for b in bridges]
        risk_events = [published(events_mod, b.broker) for b in bridges]
        if drained != len(stream) or counts[0] != counts[1] or risk_events[0] != risk_events[1]:
            raise AssertionError(f"abuse: bridge counts {counts} or risk events "
                                 f"({len(risk_events[0])} vs {len(risk_events[1])}) differ")
        cdet = cpu.abuse_detector
        if not np.array_equal(det._history_matrix(accounts, 64),
                              cdet._history_matrix(accounts, 64)):
            raise AssertionError("abuse: histories differ between the card and the CPU")
        want = np.concatenate([cdet.check_batch(accounts[i:i + ABUSE_BATCH])
                               for i in range(0, ABUSE_ACCOUNTS, ABUSE_BATCH)])
        if scores.shape != (ABUSE_ACCOUNTS,) or not np.isfinite(scores).all() \
                or scores.min() < 0 or scores.max() > 1:
            raise AssertionError("abuse: scores out of range")
        score_err = float(np.abs(scores - want).max())
        if score_err > ABUSE_ATOL:
            raise AssertionError(f"abuse: scores differ from the CPU by {score_err}")
        near = 0
        for acct, (score, signals, linked) in zip(sample, checks):
            cscore, csignals, clinked = cdet.check(acct)
            if abs(score - cscore) > ABUSE_ATOL or linked != clinked:
                raise AssertionError(f"abuse: check({acct}) differs from the CPU")
            if min(abs(cscore - 0.5), abs(cscore - 0.8)) <= ABUSE_ATOL:
                near += 1
            elif signals != csignals:
                raise AssertionError(f"abuse: check({acct}) signals differ from the CPU")
        if not any(linked for _, _, linked in checks):
            raise AssertionError("abuse: no linked accounts in the sample")
        log(f"phase 5: {len(stream)} events drained in {drain_s:.1f} s on the card, "
            f"{cpu_drain_s:.1f} s on the CPU; counts {counts[0]}, {len(risk_events[0])} risk "
            f"events; {steps} forward passes, {launches} attention kernel launches, "
            f"{dense_launches} dense_f32 launches; scores agree with the CPU to {score_err:.3g} "
            f"({near} near-threshold checks); check() equals check_batch({ABUSE_BATCH}) bit for "
            f"bit on all {len(sample)} sampled accounts")

        # Latency of one check() and throughput of check_batch(256).
        check_ms = []
        for i in range(ABUSE_LATENCY):
            t = time.perf_counter()
            det.check(accounts[(i * 7) % ABUSE_ACCOUNTS])
            check_ms.append((time.perf_counter() - t) * 1e3)
        batch_s = []
        for i in range(5):
            chunk = accounts[i * ABUSE_BATCH:(i + 1) * ABUSE_BATCH]
            t = time.perf_counter()
            det.check_batch(chunk)
            batch_s.append(time.perf_counter() - t)
        # Where a check_batch(256) goes: the host's history matrix, then the
        # forward on the card; and the forward of a single check().
        t = time.perf_counter()
        hist_256 = det._history_matrix(accounts[:ABUSE_BATCH], 64)
        history_ms = (time.perf_counter() - t) * 1e3
        x_step, x_one = torch.from_numpy(hist_256).cuda(), torch.from_numpy(hist_256[:1]).cuda()
        with torch.inference_mode():
            step_ms = device_ms(torch, lambda: det.params(x_step), reps=20)
            one_ms = device_ms(torch, lambda: det.params(x_one), reps=20)
        profiles = {
            "check_x50": profile_window(
                torch, lambda: [det.check(a) for a in accounts[:50]]),
            "check_batch_256_x5": profile_window(
                torch, lambda: [det.check_batch(accounts[i * ABUSE_BATCH:(i + 1) * ABUSE_BATCH])
                                for i in range(5)]),
        }
    finally:
        for b in bridges:
            b.engine.close()

    # BASELINE config 3's width: the device time of one forward per S, the
    # S=256 point held against the same model on the CPU.
    cfg3 = SeqConfig(**CONFIG3_CFG)
    tree3 = seq_tree(rng, CONFIG3_CFG)
    model3 = sequence_from_tree(tree3, cfg3).to("cuda")
    config3 = {}
    with torch.inference_mode():
        for batch, s in CONFIG3_POINTS:
            x = torch.from_numpy(rng.normal(size=(batch, s, 12)).astype(np.float32)).cuda()
            out = model3(x)["abuse"]
            if out.shape != (batch,) or not torch.isfinite(out).all():
                raise AssertionError(f"config 3 forward at S={s}: bad output")
            config3[s] = {"batch": batch,
                          "device_ms": device_ms(torch, lambda: model3(x), 10 if s > 2048 else 20),
                          "profile": profile_window(torch, lambda: model3(x))}
            if s == CONFIG3_POINTS[0][1]:
                want3 = sequence_from_tree(tree3, cfg3)(x.cpu())["abuse"]
                config3[s]["max_abs_err_vs_cpu"] = float((out.cpu() - want3).abs().max())
                if config3[s]["max_abs_err_vs_cpu"] > ABUSE_ATOL:
                    raise AssertionError(f"config 3 forward at S={s} differs from the CPU by "
                                         f"{config3[s]['max_abs_err_vs_cpu']}")
    result = {
        "events": len(stream), "launches": launches, "forward_passes": steps,
        "dense_f32_launches": dense_launches, "check_vs_check_batch_differing": check_vs_batch,
        "bridge_counts": counts[0], "risk_events": len(risk_events[0]),
        "score_max_abs_err": score_err, "near_threshold_checks": near,
        "drain_s": drain_s, "cpu_drain_s": cpu_drain_s,
        "check_n": ABUSE_LATENCY,
        "check_p50_ms": float(np.percentile(check_ms, 50)),
        "check_p99_ms": float(np.percentile(check_ms, 99)),
        "check_batch_256_seq_per_s": [ABUSE_BATCH / t for t in batch_s],
        "history_256_host_ms": history_ms,
        "forward_256_device_ms": step_ms,
        "forward_1_device_ms": one_ms,
        "config3_forward_device_ms": config3,
        "profiles": profiles,
    }
    log(f"phase 5: [{card}] check() x{ABUSE_LATENCY}: p50 {result['check_p50_ms']:.3f} ms, "
        f"p99 {result['check_p99_ms']:.3f} ms; check_batch({ABUSE_BATCH}) x5 median "
        f"{statistics.median(result['check_batch_256_seq_per_s']):.0f} seq/s (history matrix "
        f"{history_ms:.3f} ms on the host); device time of one forward: {step_ms:.6f} ms at "
        f"{ABUSE_BATCH} accounts, {one_ms:.6f} ms at 1")
    log("phase 5: " + json.dumps(result))
    return result


def record_two_accounts(det) -> None:
    """An abusive account (bonus -> grind -> withdraw cycles) and a normal
    one (deposits and varied bets at human cadence), as the JAX package's
    test of a trained detector records them."""
    for cycle in range(4):
        t = 1000.0 + cycle * 100
        det.record_event("abuser", 2000, "bonus_grant", timestamp=t)
        for i in range(6):
            det.record_event("abuser", 100, "bonus_wager", game_weight=0.1, timestamp=t + 1 + i)
        det.record_event("abuser", 2000, "withdraw", balance_ratio=0.95, timestamp=t + 10)
    rng = np.random.default_rng(3)
    t = 1000.0
    for i in range(30):
        t += float(rng.gamma(2, 600))
        if i % 10 == 0:
            det.record_event("player", 5000, "deposit", timestamp=t)
        else:
            det.record_event("player", float(rng.gamma(2, 800)), "bet",
                             game_weight=float(rng.choice([1.0, 0.5])), timestamp=t)


def kernel_split(prof: dict) -> dict | None:
    """Device ms of the three attention kernels and of everything else in a
    profiler window; None when the profiler recorded no device time."""
    if prof["device_ms"] is None:
        return None
    split = {part: sum(k["device_ms"] for k in prof["top"] if f"flash_attention_{part}_kernel"
                       in k["kernel"])
             for part in ("fwd", "bwd_dq", "bwd_dkv")}
    split["rest"] = prof["device_ms"] - sum(split.values())
    return split


def phase_train(torch, card: str, fa) -> dict:
    from igaming_platform_tpu_torch.convert import sequence_from_tree
    from igaming_platform_tpu_torch.models.sequence import SeqConfig
    from igaming_platform_tpu_torch.ops import dense as dense_mod
    from igaming_platform_tpu_torch.serve.abuse import SequenceAbuseDetector
    from igaming_platform_tpu_torch.train import abuse_train as at

    tcfg = at.AbuseTrainConfig()
    cfg = SeqConfig(**ABUSE_CFG)
    if tcfg.model != cfg:
        raise AssertionError(f"train: the trainer's width {tcfg.model} is not the detector's")
    batch, seq_len = tcfg.batch_size, tcfg.seq_len

    # The card against the CPU: one seeded tree, the same batches.
    tree = seq_tree(np.random.default_rng(8), ABUSE_CFG)
    models = {dev: sequence_from_tree(tree, cfg).to(dev) for dev in ("cuda", "cpu")}
    opts = {dev: at.make_optimizer(m, tcfg.learning_rate) for dev, m in models.items()}
    rng = np.random.default_rng(9)
    losses = {dev: [] for dev in models}
    for step in range(PARITY_STEPS):
        x, y = at.make_abuse_batch(rng, batch, seq_len)
        for dev, model in models.items():
            losses[dev].append(float(at.train_step(model, opts[dev], x, y)))
        if step == 0:
            grads = {dev: {n: p.grad.detach().cpu().clone() for n, p in m.named_parameters()}
                     for dev, m in models.items()}
    zero = [n for n, g in grads["cuda"].items() if not g.abs().max() > 0]
    if zero:
        raise AssertionError(f"train: no gradient on the card for {zero}")
    grad_err = 0.0
    for n, g in grads["cuda"].items():
        if not torch.allclose(g, grads["cpu"][n], rtol=GRAD_TOL, atol=GRAD_TOL):
            raise AssertionError(f"train: step-1 gradient of {n} differs from the CPU's by "
                                 f"{float((g - grads['cpu'][n]).abs().max())}")
        grad_err = max(grad_err, float((g - grads["cpu"][n]).abs().max()))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    if not np.isfinite(losses["cuda"]).all() or loss_rel > LOSS_RTOL:
        raise AssertionError(f"train: card losses {losses['cuda']} against the CPU's "
                             f"{losses['cpu']}")
    log(f"phase 6: {PARITY_STEPS} steps on the card and the CPU: losses agree to {loss_rel:.3g} "
        f"(relative), {len(grads['cuda'])} step-1 gradients all nonzero on the card and "
        f"within {grad_err:.3g} of the CPU's")
    del models, opts

    # The path's run: counts set to 0 just before, read just after.
    torch.cuda.synchronize()
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches_dq = fa.flash_attention_bwd.launches_dkv = 0
    dense_mod.dense_f32.launches = 0
    t = time.perf_counter()
    model, metrics = at.train_abuse_detector(tcfg, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    launches = {"fwd": fa.flash_attention_fwd.launches, "dq": fa.flash_attention_bwd.launches_dq,
                "dkv": fa.flash_attention_bwd.launches_dkv,
                "dense_f32": dense_mod.dense_f32.launches}
    per_step = cfg.n_layers * tcfg.steps
    if (launches["dq"], launches["dkv"], launches["fwd"], launches["dense_f32"]) != (
            per_step, per_step, per_step + cfg.n_layers,
            affine_layers(cfg) * (tcfg.steps + 1)):
        raise AssertionError(f"train: {tcfg.steps} steps of {cfg.n_layers} layers and one eval "
                             f"forward but kernel launches {launches}")
    if len(metrics["losses"]) != tcfg.steps or not np.isfinite(metrics["losses"]).all():
        raise AssertionError("train: bad losses")
    if metrics["eval_accuracy"] < MIN_ACCURACY:
        raise AssertionError(f"train: eval accuracy {metrics['eval_accuracy']} < {MIN_ACCURACY}")

    # The trained model serves on the card.
    det = SequenceAbuseDetector(device="cuda")
    det.swap_params(model)
    if any(p.requires_grad or p.grad is not None for p in det.params.parameters()):
        raise AssertionError("train: the detector's copy holds autograd state")
    record_two_accounts(det)
    abuser, player = det.check("abuser")[0], det.check("player")[0]
    if not abuser > player:
        raise AssertionError(f"train: abuser scored {abuser}, normal player {player}")
    log(f"phase 6: [{card}] train_abuse_detector, {tcfg.steps} steps of {batch} x {seq_len} "
        f"in {train_s:.2f} s: final loss {metrics['final_loss']:.4g}, eval accuracy "
        f"{metrics['eval_accuracy']}; launches fwd {launches['fwd']}, dQ {launches['dq']}, "
        f"dK/dV {launches['dkv']}; served: abuser {abuser:.4f} > player {player:.4f}")

    # Where a step's time goes: host batch synthesis, the step itself from
    # numpy batches to the end of its work (host wall), the device step
    # (CUDA events, batch already on the card), and kernels over five steps.
    rng = np.random.default_rng(10)
    t = time.perf_counter()
    batches = [at.make_abuse_batch(rng, batch, seq_len) for _ in range(20)]
    synth_ms = (time.perf_counter() - t) * 1e3 / len(batches)
    opt = at.make_optimizer(model, tcfg.learning_rate)
    at.train_step(model, opt, *batches[0])
    torch.cuda.synchronize()
    t = time.perf_counter()
    for b in batches:
        at.train_step(model, opt, *b)
    torch.cuda.synchronize()
    step_wall_ms = (time.perf_counter() - t) * 1e3 / len(batches)
    xd, yd = (torch.from_numpy(a).cuda() for a in batches[0])
    step_ms = device_ms(torch, lambda: at.train_step(model, opt, xd, yd), reps=20,
                        sleep=4 * SLEEP_CYCLES)
    loop = profile_window(torch, lambda: [at.train_step(model, opt, *b) for b in batches[:5]],
                          top=100)

    # One training step at BASELINE config 3's width.
    cfg3 = SeqConfig(**CONFIG3_CFG)
    model3 = sequence_from_tree(seq_tree(np.random.default_rng(11), CONFIG3_CFG), cfg3).to("cuda")
    opt3 = at.make_optimizer(model3, tcfg.learning_rate)
    b3, s3 = CONFIG3_TRAIN_POINT
    rng3 = np.random.default_rng(12)
    x3 = torch.from_numpy(rng3.normal(size=(b3, s3, 12)).astype(np.float32)).cuda()
    y3 = torch.from_numpy((rng3.random(b3) < 0.5).astype(np.float32)).cuda()
    if not math.isfinite(float(at.train_step(model3, opt3, x3, y3))):
        raise AssertionError(f"train: config-3 step at S={s3} gave a non-finite loss")
    step3_ms = device_ms(torch, lambda: at.train_step(model3, opt3, x3, y3), reps=10, warmup=2)
    prof3 = profile_window(torch, lambda: at.train_step(model3, opt3, x3, y3), top=100)

    result = {
        "launches_fwd": launches["fwd"], "launches_dq": launches["dq"],
        "launches_dkv": launches["dkv"], "launches_dense_f32": launches["dense_f32"],
        "steps": tcfg.steps,
        "final_loss": metrics["final_loss"], "eval_accuracy": metrics["eval_accuracy"],
        "losses_every_20": metrics["losses"][::20],
        "parity_losses": losses, "parity_loss_max_rel": loss_rel,
        "parity_grad_max_abs_err": grad_err,
        "served_scores": {"abuser": abuser, "player": player},
        "train_s": train_s, "wall_ms_per_step": train_s * 1e3 / tcfg.steps,
        "batch_synthesis_host_ms": synth_ms, "step_wall_ms": step_wall_ms,
        "step_device_ms": step_ms,
        "loop_5_steps": {**loop, "top": loop["top"][:8], "split": kernel_split(loop)},
        "config3_step": {"batch": b3, "S": s3, "device_ms": step3_ms,
                         "wall_ms": prof3["wall_ms"], "kernel_ms": prof3["device_ms"],
                         "split": kernel_split(prof3), "top": prof3["top"][:8]},
    }
    log(f"phase 6: per step: {result['wall_ms_per_step']:.3f} ms of wall in the 200-step run, "
        f"{synth_ms:.3f} ms of host batch synthesis, {step_wall_ms:.3f} ms of wall for the step "
        f"itself, {step_ms:.6f} ms device step (events); "
        f"config-3 step at B={b3} S={s3}: {step3_ms:.6f} ms, split {result['config3_step']['split']}")
    log("phase 6: " + json.dumps(result))
    return result


def probe_tiles(rng, k: int, n: int):
    """Operand tiles for the tensor-core probe, n of each of four families:
    normal values over wide exponents; unit values with C zero or not; one
    dominant product and tiny ones (the cut's bits); a large C and small
    products. A and B are rounded to the instruction's operand type."""
    from igaming_platform_tpu_torch.ops.tensor_core_model import round_operand

    fams = [
        (rng.normal(size=(n, 16, k)) * 2.0 ** rng.integers(-10, 10, (n, 16, k)),
         rng.normal(size=(n, k, 8)) * 2.0 ** rng.integers(-10, 10, (n, k, 8)),
         rng.normal(size=(n, 16, 8)) * 2.0 ** rng.integers(-20, 20, (n, 16, 8))),
        (rng.normal(size=(n, 16, k)), rng.normal(size=(n, k, 8)),
         rng.normal(size=(n, 16, 8)) * (rng.random((n, 1, 1)) < 0.5)),
    ]
    a = 2.0 ** -rng.integers(20, 34, (n, 16, k)) * rng.choice([-1, 1], (n, 16, k))
    a[:, :, 0] = 1.0
    fams.append((a, (1 + rng.integers(0, 8, (n, k, 8)) / 8.0) * rng.choice([-1, 1], (n, k, 8)),
                 rng.choice([0.0, 1.0, -1.0, 3.0, 2.0 ** -10], (n, 16, 8))
                 * (1 + rng.integers(0, 16, (n, 16, 8)) / 16.0)))
    fams.append((rng.normal(size=(n, 16, k)),
                 rng.normal(size=(n, k, 8)) * 2.0 ** -rng.integers(10, 30, (n, 1, 1)),
                 rng.normal(size=(n, 16, 8)) * 4))
    kind = "tf32" if k == 8 else "bf16"
    a, b, c = (np.concatenate([f[i] for f in fams]).astype(np.float32) for i in range(3))
    return round_operand(a, kind), round_operand(b, kind), c


def phase_mma_probe(torch) -> dict:
    """The CPU emulations' tensor core against the card's: PROBE_TILES tiles
    of each family through ``csrc/mma_probe.cu``, TF32 m16n8k8 and bf16
    m16n8k16, and every output held bit for bit to
    ``ops/tensor_core_model.mma``."""
    import ctypes

    from igaming_platform_tpu_torch.ops import _build
    from igaming_platform_tpu_torch.ops.tensor_core_model import mma

    lib = _build.load("mma_probe")
    lib.mma_probe_launch.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
    rng = np.random.default_rng(11)
    out = {}
    for name, k in (("tf32_m16n8k8", 8), ("bf16_m16n8k16", 16)):
        a, b, c = probe_tiles(rng, k, PROBE_TILES)
        ad, bd, cd = (torch.from_numpy(x).cuda() for x in (a, b, c))
        dd = torch.empty_like(cd)
        rc = lib.mma_probe_launch(int(k == 8), a.shape[0], ad.data_ptr(), bd.data_ptr(),
                                  cd.data_ptr(), dd.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"mma_probe {name}: kernel launch failed ({rc})")
        d = dd.cpu().numpy()
        bad = sum(not np.array_equal(mma(c[i], a[i], b[i]).view(np.uint32), d[i].view(np.uint32))
                  for i in range(a.shape[0]))
        if bad:
            raise AssertionError(f"mma_probe {name}: {bad} of {a.shape[0]} tiles differ from "
                                 "ops/tensor_core_model.mma")
        nearest = np.mean(d == (np.einsum("nik,nkj->nij", a.astype(np.float64),
                                          b.astype(np.float64)) + c).astype(np.float32))
        out[name] = {"tiles": int(a.shape[0]), "model_bit_equal": True,
                     "share_equal_to_round_to_nearest": float(nearest)}
        log(f"phase 3: mma_probe {name}: {a.shape[0]} tiles, every output bit-equal to "
            f"ops/tensor_core_model.mma; {nearest:.4f} of outputs equal the exact sum rounded "
            "to nearest")
    return out


def fill_native_store(native_store, now: float):
    """The native store at its default capacity (1,000,000 accounts) filled
    with SERVER_ACCOUNTS accounts of about SERVER_EVENTS_PER_ACCOUNT events
    each over the last two days, through ``update_columns`` in chunks, some
    bonus claims and blacklisted devices and IPs; the clock pinned at
    ``now``."""
    rng = np.random.default_rng(21)
    STORE_CLOCK[0] = now
    store = native_store.NativeFeatureStore(clock=lambda: STORE_CLOCK[0])
    n = SERVER_ACCOUNTS * SERVER_EVENTS_PER_ACCOUNT
    accounts = rng.integers(0, SERVER_ACCOUNTS, n)
    ts = np.sort(now - rng.random(n) * rng.choice([300.0, 3600.0, 172800.0], n))
    amounts = rng.integers(100, 500_000, n)
    types = np.array(["deposit", "withdraw", "bet", "win"])[
        rng.choice(4, n, p=[0.3, 0.1, 0.5, 0.1])]
    devices, ips = rng.integers(0, 300_000, n), rng.integers(0, 500_000, n)
    chunk = 200_000
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        store.update_columns([f"acct{a}" for a in accounts[lo:hi]], amounts[lo:hi].tolist(),
                             types[lo:hi].tolist(), [f"ip{i}" for i in ips[lo:hi]],
                             [f"dev{d}" for d in devices[lo:hi]], ts[lo:hi])
    for a in rng.integers(0, SERVER_ACCOUNTS, 20_000):
        store.record_bonus_claim(f"acct{a}", wager_complete_rate=float(rng.random()))
    for d in rng.integers(0, 300_000, 2_000):
        store.add_to_blacklist("device", f"dev{d}")
    for i in rng.integers(0, 500_000, 2_000):
        store.add_to_blacklist("ip", f"ip{i}")
    return store, n


def server_requests(codec, rng, n: int) -> list[dict]:
    types = ("deposit", "withdraw", "bet")
    return [{"account_id": f"acct{rng.integers(0, SERVER_ACCOUNTS + 5_000)}",
             "amount": int(rng.integers(100, 2_000_000)), "transaction_type": types[rng.integers(3)],
             "ip_address": f"ip{rng.integers(0, 500_000)}",
             "device_id": f"dev{rng.integers(0, 300_000)}", "currency": "EUR"}
            for _ in range(n)]


def response_columns(codec, payload: bytes) -> tuple[list, dict]:
    """A ScoreBatchResponse's rows, and its result columns as arrays."""
    from igaming_platform_tpu_torch.core.enums import REASON_BIT_ORDER

    bit = {code.value: b for b, code in enumerate(REASON_BIT_ORDER)}
    rows = codec.decode(codec.SCORE_BATCH_RESPONSE, payload)["results"]
    return rows, {"score": np.array([r["score"] for r in rows]),
                  "action": np.array([r["action"] for r in rows]),
                  "rule_score": np.array([r["rule_score"] for r in rows]),
                  "ml_score": np.array([r["ml_score"] for r in rows], dtype=np.float32),
                  "reason_mask": np.array([sum(1 << bit[c] for c in r["reason_codes"])
                                           for r in rows])}


def http_call(port: int, path: str, body: dict | None = None) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def phase_server(torch, card: str, gbdt_kernel, fa, filled: tuple) -> dict:
    """The risk.v1 serving front on the card: the native store at deployment
    size, ``assemble_risk_service`` with the ``mlp+gbdt`` backend and the
    abuse detector at serving width, the HTTP sidecar bound (no gRPC: the
    card's machine has no grpcio), and the RPC mix through the service's
    byte handlers, requests built and responses read by the port's own
    codec. Every ScoreBatch answer is held to a CPU engine on the same
    gathered rows; the forest's launches must equal the device steps and the
    forward's layers x forwards."""
    from igaming_platform_tpu_torch.convert import from_jax_params, sequence_from_tree
    from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
    from igaming_platform_tpu_torch.models.sequence import SeqConfig
    from igaming_platform_tpu_torch.ops import dense as dense_mod
    from igaming_platform_tpu_torch.serve import scorer, server, wire
    from igaming_platform_tpu_torch.serve import risk_codec as codec

    store, n_events, fill_s = filled
    log(f"phase 7: native store of {store.num_accounts()} accounts, {n_events} events, "
        f"filled in {fill_s:.1f} s")
    rng = np.random.default_rng(22)
    tree = {"mlp": mlp_tree(rng, SERVE_HIDDEN), "gbdt": forest_tree(rng, SERVE_TREES, SERVE_DEPTH)}
    seq_cfg = SeqConfig(**ABUSE_CFG)
    config = RiskServiceConfig(batcher=BatcherConfig(
        batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0))
    assembled = server.assemble_risk_service(
        config, ml_backend="mlp+gbdt", params=from_jax_params("mlp+gbdt", tree),
        feature_store=store, abuse_params=sequence_from_tree(seq_tree(rng, ABUSE_CFG), seq_cfg),
        device="cuda")
    srv = server.RiskServer(assembled, grpc_port=-1, http_port=0)
    svc, engine, det = assembled.service, assembled.engine, assembled.abuse
    cpu = scorer.TorchScoringEngine(ml_backend="mlp+gbdt", params=from_jax_params("mlp+gbdt", tree),
                                    batcher_config=config.batcher, feature_store=store,
                                    device="cpu", warmup=False)
    try:
        # Requests, built before the clock starts.
        batches = [codec.encode(codec.SCORE_BATCH_REQUEST,
                                {"transactions": server_requests(codec, rng, SERVER_BATCH_ROWS)})
                   for _ in range(SERVER_BATCHES)]
        singles = [codec.encode(codec.SCORE_TRANSACTION_REQUEST, r)
                   for r in server_requests(codec, rng, SERVER_SINGLES)]
        checked = [f"acct{a}" for a in rng.integers(0, SERVER_ACCOUNTS, SERVER_ABUSE_CHECKS)]
        for acct in checked:  # the detector's histories, as the bridge would feed them
            for i in range(int(rng.integers(5, 64))):
                det.record_event(acct, int(rng.integers(500, 200_000)),
                                 str(rng.choice(["deposit", "bet", "win", "withdraw"])),
                                 device_id=f"dev{rng.integers(0, 300_000)}",
                                 timestamp=SERVER_NOW - 3600.0 + 30.0 * i)
        abuse_reqs = [codec.encode(codec.CHECK_BONUS_ABUSE_REQUEST, {"account_id": a})
                      for a in checked]
        svc.call("ScoreBatch", batches[0])  # the pipeline's first build off the count
        torch.cuda.synchronize()

        # The path's run: counts set to 0 just before, read just after.
        gbdt_kernel.gbdt_forest.launches = 0
        fa.flash_attention_fwd.launches = 0
        dense_mod.dense_f32.launches = 0
        steps0, fwd0 = engine.device_steps, det.device_steps
        single_ms, batch_s, split, abuse_ms, batch_out = [], [], None, [], []
        for payload in singles:
            t = time.perf_counter()
            svc.call("ScoreTransaction", payload)
            single_ms.append((time.perf_counter() - t) * 1e3)
        pipe = engine._host_pipeline
        for payload in batches:
            busy0 = dict(pipe.stats()["stage_busy_ms"])
            t = time.perf_counter()
            batch_out.append(svc.call("ScoreBatch", payload))
            batch_s.append(time.perf_counter() - t)
            if split is None:
                busy = pipe.stats()["stage_busy_ms"]
                split = {k: busy[k] - busy0[k] for k in busy}
        for payload in abuse_reqs:
            t = time.perf_counter()
            svc.call("CheckBonusAbuse", payload)
            abuse_ms.append((time.perf_counter() - t) * 1e3)
        bl_resp = codec.decode(codec.ADD_TO_BLACKLIST_RESPONSE, svc.call(
            "AddToBlacklist", codec.encode(codec.ADD_TO_BLACKLIST_REQUEST,
                                           {"type": "device", "value": "dev-smoke"})))
        hit = codec.decode(codec.CHECK_BLACKLIST_RESPONSE, svc.call(
            "CheckBlacklist", codec.encode(codec.CHECK_BLACKLIST_REQUEST,
                                           {"device_id": "dev-smoke"})))
        svc.call("UpdateThresholds", codec.encode(codec.UPDATE_THRESHOLDS_REQUEST,
                                                  {"block_threshold": 1, "review_threshold": 0}))
        thresholds = codec.decode(codec.GET_THRESHOLDS_RESPONSE, svc.call("GetThresholds", b""))
        blocked = codec.decode(codec.SCORE_TRANSACTION_RESPONSE,
                               svc.call("ScoreTransaction", singles[0]))
        svc.call("UpdateThresholds", codec.encode(codec.UPDATE_THRESHOLDS_REQUEST,
                                                  {"block_threshold": 80, "review_threshold": 50}))
        features = codec.decode(codec.GET_FEATURES_RESPONSE, svc.call(
            "GetFeatures", codec.encode(codec.GET_FEATURES_REQUEST, {"account_id": "acct1"})))
        health = http_call(srv.http_port, "/health")
        ready = http_call(srv.http_port, "/ready")
        debug = http_call(srv.http_port, "/debug/score",
                          {"account_id": "acct2", "amount": 5000, "transaction_type": "deposit"})
        torch.cuda.synchronize()
        launches = gbdt_kernel.gbdt_forest.launches
        fwd_launches = fa.flash_attention_fwd.launches
        f32_launches = dense_mod.dense_f32.launches
        steps, forwards = engine.device_steps - steps0, det.device_steps - fwd0
        if f32_launches != affine_layers(seq_cfg) * forwards:
            raise AssertionError(f"server: {forwards} forwards but {f32_launches} dense_f32 "
                                 "launches")

        if launches == 0 or launches != steps:
            raise AssertionError(f"server: {steps} device steps but {launches} forest launches")
        if fwd_launches == 0 or fwd_launches != seq_cfg.n_layers * forwards:
            raise AssertionError(f"server: {forwards} forwards of {seq_cfg.n_layers} layers but "
                                 f"{fwd_launches} attention kernel launches")
        if not (bl_resp["success"] and hit["is_blacklisted"]):
            raise AssertionError("server: AddToBlacklist/CheckBlacklist")
        if (thresholds["block_threshold"], thresholds["review_threshold"]) != (1, 0) \
                or blocked["action"] != 3 or engine.get_thresholds() != (80, 50):
            raise AssertionError(f"server: thresholds {thresholds}, action {blocked['action']}")
        if features["account_id"] != "acct1" or features["features"] is None:
            raise AssertionError("server: GetFeatures")
        if health != (200, {"status": "healthy"}) or ready[0] != 200 or not ready[1]["device"] \
                or debug[0] != 200 or not 0 <= debug[1]["score"] <= 100:
            raise AssertionError(f"server: sidecar {health} {ready} {debug}")

        # Every ScoreBatch answer against the CPU engine on the same rows.
        boundary = 0
        for payload, out in zip(batches, batch_out):
            x, bl = store.decode_gather(payload)
            want = {k: v.numpy() for k, v in cpu.score_arrays(x, bl).items()}
            rows, got = response_columns(codec, out)
            if len(rows) != SERVER_BATCH_ROWS:
                raise AssertionError(f"server: {len(rows)} rows answered")
            boundary += compare_columns(got, want, "server")
            n = x.shape[0]
            echo = codec.decode(codec.SCORE_BATCH_RESPONSE, wire.encode_score_batch(
                *(np.zeros(n, np.int32) for _ in range(4)), np.zeros(n, np.float32),
                np.zeros(n, np.int64), x))["results"]
            if any(r["features"] != e["features"] for r, e in zip(rows, echo)):
                raise AssertionError("server: the feature echo differs from the gathered rows")
        # The host split of one RPC: the decode and gather, timed alone on
        # the same payload, and the pipeline's busy time per stage.
        t = time.perf_counter()
        store.decode_gather(batches[0])
        split["decode_gather"] = (time.perf_counter() - t) * 1e3
    finally:
        cpu.close()
        srv.shutdown(grace=5.0)
    result = {
        "accounts": store.num_accounts(), "events": n_events, "fill_s": fill_s,
        "launches": launches, "device_steps": steps,
        "forward_launches": fwd_launches, "forwards": forwards,
        "dense_f32_launches": f32_launches,
        "floor_boundary_rows": boundary,
        "score_batch_rows": SERVER_BATCH_ROWS,
        "score_batch_rows_per_s": [SERVER_BATCH_ROWS / t for t in batch_s],
        "score_batch_ms": [t * 1e3 for t in batch_s],
        "score_batch_host_split_ms": split,
        "score_transaction_p50_ms": float(np.percentile(single_ms, 50)),
        "score_transaction_p99_ms": float(np.percentile(single_ms, 99)),
        "check_bonus_abuse_p50_ms": float(np.percentile(abuse_ms, 50)),
        "check_bonus_abuse_p99_ms": float(np.percentile(abuse_ms, 99)),
        "ready": ready[1],
    }
    log(f"phase 7: [{card}] ScoreBatch of {SERVER_BATCH_ROWS} rows bytes to bytes x"
        f"{SERVER_BATCHES}: median {statistics.median(result['score_batch_rows_per_s']):.0f} "
        "rows/s")
    log(f"phase 7: [{card}] one ScoreBatch RPC's host split (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + f"; the RPC's wall {batch_s[0] * 1e3:.3f}")
    log(f"phase 7: [{card}] ScoreTransaction x{SERVER_SINGLES}: p50 "
        f"{result['score_transaction_p50_ms']:.3f} ms, p99 {result['score_transaction_p99_ms']:.3f}"
        f" ms; CheckBonusAbuse x{SERVER_ABUSE_CHECKS}: p50 "
        f"{result['check_bonus_abuse_p50_ms']:.3f} ms, p99 {result['check_bonus_abuse_p99_ms']:.3f} ms")
    log(f"phase 7: {steps} device steps, {launches} forest launches; {forwards} forwards, "
        f"{fwd_launches} attention launches; every ScoreBatch answer agrees with the CPU engine "
        f"({boundary} floor-boundary rows not compared), feature echo bit-equal; /ready {ready[1]}")
    log("phase 7: " + json.dumps(result))
    return result


def index_traffic_a(wire, rng, rounds: int = INDEX_ROUNDS) -> list[tuple[float, bytes, bool]]:
    """Engine A's frames in order, each with the store clock it is sent at
    and whether it is a large frame: per round (``rounds``), one frame of
    SERVER_BATCH_ROWS rows (hot-set rows, and each cycler's bet), then one
    one-row frame per cycler (its deposit) INDEX_STEP_S later."""
    accounts = rng.permutation(SERVER_ACCOUNTS)
    cyclers, hot = accounts[:INDEX_CYCLERS], accounts[INDEX_CYCLERS:INDEX_CYCLERS + INDEX_HOT]
    cycler_amount = rng.integers(1_000, 200_000, INDEX_CYCLERS)
    frames = []
    for r in range(rounds):
        t = SERVER_NOW + 2 * INDEX_STEP_S * (r + 1)
        n = SERVER_BATCH_ROWS
        ids = hot[rng.integers(0, INDEX_HOT, n)]
        amounts = rng.integers(100, 2_000_000, n)
        kinds = np.array(["deposit", "withdraw", "bet"])[rng.integers(0, 3, n)]
        pos = rng.choice(n, INDEX_CYCLERS, replace=False)
        ids[pos], amounts[pos], kinds[pos] = cyclers, cycler_amount, "bet"
        frames.append((t, wire.encode_index_batch(
            [f"acct{a}" for a in ids], amounts, kinds.tolist(),
            ips=[f"ip{i}" for i in rng.integers(0, 500_000, n)],
            devices=[f"dev{d}" for d in rng.integers(0, 300_000, n)]), True))
        frames += [(t + INDEX_STEP_S, wire.encode_index_batch(
            [f"acct{cyclers[j]}"], [int(cycler_amount[j])], ["deposit"]), False)
            for j in range(INDEX_CYCLERS)]
    return frames


def index_traffic_b(wire, rng) -> list[tuple[float, bytes, bool]]:
    """Engine B's frames: every account once (more accounts than slots),
    then the rest of the rows from the first two fifths of them, long
    evicted by then; INDEX_CYCLERS accounts in every frame, bet and deposit
    in turn."""
    accounts = rng.permutation(SERVER_ACCOUNTS)
    cyclers, rest = accounts[:INDEX_CYCLERS], accounts[INDEX_CYCLERS:]
    per = SERVER_BATCH_ROWS - INDEX_CYCLERS
    extra = INDEX_B_FRAMES * per - rest.size
    ids_all = np.concatenate([rest, rest[rng.integers(0, rest.size * 2 // 5, extra)]])
    frames = []
    for f in range(INDEX_B_FRAMES):
        ids = np.insert(ids_all[f * per:(f + 1) * per],
                        np.sort(rng.integers(0, per, INDEX_CYCLERS)), cyclers)
        n = ids.size
        kinds = np.array(["deposit", "withdraw", "bet"])[rng.integers(0, 3, n)]
        amounts = rng.integers(100, 2_000_000, n)
        cyc = np.isin(ids, cyclers)
        kinds[cyc], amounts[cyc] = ("bet", "deposit")[f % 2], 5_000
        frames.append((SERVER_NOW + 1_000.0 + 2 * INDEX_STEP_S * f, wire.encode_index_batch(
            [f"acct{a}" for a in ids], amounts, kinds.tolist(),
            devices=[f"dev{d}" for d in rng.integers(0, 300_000, n)]), True))
    return frames


def compare_session_columns(got: dict, want: dict, threshold: float, what: str) -> tuple:
    """``compare_columns`` for session rows, after excusing the rows one
    side folded and the other did not where the folded side's ML score (the
    head's probability) lies within 1e-4 of the threshold. Returns
    (floor-boundary rows, threshold rows, folded rows)."""
    from igaming_platform_tpu_torch.core.enums import SESSION_PATTERN_BIT

    fold_g = (got["reason_mask"] >> SESSION_PATTERN_BIT) & 1
    fold_w = (want["reason_mask"] >> SESSION_PATTERN_BIT) & 1
    folded_ml = np.where(fold_g == 1, got["ml_score"], want["ml_score"])
    near = (fold_g != fold_w) & (np.abs(folded_ml.astype(np.float64) - threshold) < 1e-4)
    keep = ~near
    boundary = compare_columns({k: v[keep] for k, v in got.items()},
                               {k: v[keep] for k, v in want.items()}, what)
    return boundary, int(near.sum()), int(fold_g.sum())


class RpcSplit:
    """Host time of one index-mode RPC by stage, from timing shims around the
    functions each stage calls: decode, lookup, dispatch (the launch of a
    chunk, with its session bookkeeping and copies), readback, encode."""

    def __init__(self, engine, scorer, wire):
        self.ms = dict.fromkeys(("decode", "lookup", "dispatch", "readback", "encode"), 0.0)
        self._patches = [(wire, "decode_index_batch", "decode"), (engine.cache, "lookup", "lookup"),
                         (engine, "_launch_cached", "dispatch"),
                         (scorer, "_device_readback", "readback"),
                         (wire, "encode_score_batch", "encode")]

    def _timed(self, fn, stage):
        def shim(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.ms[stage] += (time.perf_counter() - t) * 1e3
        return shim

    def __enter__(self):
        self._saved = [(obj, name, obj.__dict__.get(name)) for obj, name, _ in self._patches]
        for obj, name, stage in self._patches:
            setattr(obj, name, self._timed(getattr(obj, name), stage))
        return self

    def __exit__(self, *exc):
        for obj, name, old in self._saved:
            if old is None:
                delattr(obj, name)
            else:
                setattr(obj, name, old)


def drive_index(svc, cpu_svc, engine, frames, threshold, what, scorer, wire, codec) -> dict:
    """Every frame through the card's service and then the CPU twin's, the
    store clock set to the frame's time; each card answer held to the twin's
    (``compare_session_columns``). The large frames are timed bytes to bytes,
    the last one also split by stage."""
    large_s, single_s, split = [], [], None
    boundary = near = folds = 0
    n_large = sum(large for _, _, large in frames)
    for t, frame, large in frames:
        STORE_CLOCK[0] = t
        timer = (RpcSplit(getattr(engine, "inner", engine), scorer, wire)
                 if large and len(large_s) == n_large - 1 else None)
        start = time.perf_counter()
        if timer is None:
            out = svc.call("ScoreBatch", frame)
        else:
            with timer:
                out = svc.call("ScoreBatch", frame)
            split = timer.ms
        (large_s if large else single_s).append(time.perf_counter() - start)
        want = cpu_svc.call("ScoreBatch", frame)
        rows, got = response_columns(codec, out)
        if len(rows) != wire.decode_index_batch(frame)[1].size or any(r["features"] for r in rows):
            raise AssertionError(f"{what}: {len(rows)} rows, or a feature echo")
        b, n, f = compare_session_columns(got, response_columns(codec, want)[1], threshold, what)
        boundary, near, folds = boundary + b, near + n, folds + f
    split["wall"] = large_s[-1] * 1e3
    return {"large_s": large_s, "single_s": single_s, "split_ms": split,
            "floor_boundary_rows": boundary, "threshold_rows": near, "folded_rows": folds}


def check_twin_state(torch, engine, cpu, rng, what: str) -> int:
    """The card's table and session ring, cursor and length bit-equal to the
    CPU twin's, and INDEX_SAMPLED_WINDOWS resident accounts' device windows
    equal to the host index. Returns the number of windows compared."""
    pairs = [(engine.cache.table, cpu.cache.table),
             (engine.session.session_ring, cpu.session.session_ring),
             (engine.session.session_cursor, cpu.session.session_cursor),
             (engine.session.session_length, cpu.session.session_length)]
    for name, (dev, host) in zip(("table", "ring", "cursor", "length"), pairs):
        if not torch.equal(dev.cpu(), host):
            raise AssertionError(f"{what}: the card's {name} differs from the CPU twin's")
    resident = sorted(engine.cache._slots.items())
    picks = rng.choice(len(resident), min(INDEX_SAMPLED_WINDOWS, len(resident)), replace=False)
    for i in picks:
        account, slot = resident[i]
        if not np.array_equal(engine.session.device_window(slot),
                              engine.session.twin_window(account)):
            raise AssertionError(f"{what}: {account}'s device window differs from its host index")
    return len(picks)


def phase_index(torch, card: str, gbdt_kernel, fa, store, row_rows_per_s: float,
                device: str = "cuda") -> dict:
    """The index wire mode and session state on the card, on phase 7's store:
    engine A (``assemble_risk_service``, WIRE_MODE=index, capacity
    INDEX_A_CAPACITY, the transformer head) takes ``index_traffic_a``
    through ``RiskGrpcService.call`` with the sidecar bound; engine B (the
    default capacity, the pattern head) takes ``index_traffic_b``. Each is
    held frame by frame to a CPU twin fed the same frames, and after its run
    its table and ring bit for bit. The forest's launches must equal each
    engine's device steps, and the forward's engine A's (one layer).
    ``device="cpu"`` runs the same path with the plain versions, to
    rehearse it without a card (the launch checks are then skipped)."""
    import os

    from igaming_platform_tpu_torch.convert import from_jax_params
    from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
    from igaming_platform_tpu_torch.ops import dense as dense_mod
    from igaming_platform_tpu_torch.serve import grpc_server, scorer, server, wire
    from igaming_platform_tpu_torch.serve import risk_codec as codec
    from igaming_platform_tpu_torch.serve import session_state as ss

    rng = np.random.default_rng(23)
    params = from_jax_params("mlp+gbdt", {"mlp": mlp_tree(rng, SERVE_HIDDEN),
                                          "gbdt": forest_tree(rng, SERVE_TREES, SERVE_DEPTH)})
    bcfg = BatcherConfig(batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0)
    on_card = device == "cuda"
    knobs = ("WIRE_MODE", "SESSION_STATE", "SESSION_HEAD", "SESSION_FLAG_THRESHOLD")
    saved = {k: os.environ.get(k) for k in knobs}
    result = {}
    try:
        for name, capacity, head, threshold, traffic in (
                ("a", INDEX_A_CAPACITY, "transformer", INDEX_A_THRESHOLD, index_traffic_a),
                ("b", INDEX_B_CAPACITY, "pattern", 0.7, index_traffic_b)):
            os.environ.update({"WIRE_MODE": "index", "SESSION_STATE": "1", "SESSION_HEAD": head,
                               "SESSION_FLAG_THRESHOLD": str(threshold)})
            frames = traffic(wire, rng)
            # The CPU twin and its service first: a service installs the
            # process's drift engine and closes the one installed before it,
            # so the card's service, built next, keeps its own.
            cpu = scorer.TorchScoringEngine(ml_backend="mlp+gbdt", params=params,
                                            batcher_config=bcfg, feature_store=store,
                                            device="cpu", feature_cache=capacity, warmup=False)
            cpu_svc = grpc_server.RiskGrpcService(cpu)
            if on_card:
                torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated() if on_card else 0
            if name == "a":
                assembled = server.assemble_risk_service(
                    RiskServiceConfig(batcher=bcfg), ml_backend="mlp+gbdt", params=params,
                    feature_store=store, device=device, feature_cache=capacity, warmup=False)
                engine, svc = assembled.engine, assembled.service
            else:
                engine = scorer.TorchScoringEngine(ml_backend="mlp+gbdt", params=params,
                                                   batcher_config=bcfg, feature_store=store,
                                                   device=device, feature_cache=capacity,
                                                   warmup=False)
                svc = grpc_server.RiskGrpcService(engine)
            # One row-path step first: the engine's stream gets its cuBLAS
            # workspace (32 MiB) before the cache's bytes are counted.
            engine._readback(engine._launch(np.zeros((1, N_FEATURES), np.float32),
                                            np.zeros((1,), bool), engine.get_params()))
            if on_card:
                torch.cuda.synchronize()
            mem1 = torch.cuda.memory_allocated() if on_card else 0
            t0 = time.perf_counter()
            engine.ensure_cache()
            build_s = time.perf_counter() - t0
            if on_card:
                torch.cuda.synchronize()
            state_bytes = (torch.cuda.memory_allocated() if on_card else 0) - mem1
            srv = server.RiskServer(assembled, grpc_port=-1, http_port=0) if name == "a" else None
            cpu.bind_drift(None)  # its drift engine was closed by the card's service
            try:
                cpu.ensure_cache()
                # Store writes reach both caches' dirty sets.
                store.delta_listener = lambda a, caches=(engine.cache, cpu.cache): [
                    c.note_update(a) for c in caches]
                if on_card:
                    torch.cuda.synchronize()
                # The path's run: counts set to 0 just before, read just after.
                gbdt_kernel.gbdt_forest.launches = 0
                fa.flash_attention_fwd.launches = 0
                dense_mod.dense_f32.launches = 0
                steps0 = engine.device_steps
                half = len(frames) // 2
                run = drive_index(svc, cpu_svc, engine, frames[:half], threshold,
                                  f"index {name}", scorer, wire, codec)
                # A write-back of 500 accounts between frames: the next
                # lookups fold the dirty rows.
                touched = [f"acct{a}" for a in rng.integers(0, SERVER_ACCOUNTS, 500)]
                store.update_columns(touched, [777] * 500, ["bet"] * 500, [""] * 500,
                                     ["dev-index"] * 500, [STORE_CLOCK[0]] * 500)
                deltas0 = engine.cache.stats()["deltas_applied"]
                rest = drive_index(svc, cpu_svc, engine, frames[half:], threshold,
                                   f"index {name}", scorer, wire, codec)
                steps = engine.device_steps - steps0
                forest, forwards = gbdt_kernel.gbdt_forest.launches, fa.flash_attention_fwd.launches
                f32_launches = dense_mod.dense_f32.launches
                head_layers = affine_layers(ss.SESSION_SEQ_CONFIG) if head == "transformer" else 0
                if on_card and (steps == 0 or forest != steps
                                or forwards != (steps if head == "transformer" else 0)
                                or f32_launches != head_layers * steps):
                    raise AssertionError(f"index {name}: {steps} device steps, {forest} forest "
                                         f"launches, {forwards} forward launches, {f32_launches} "
                                         "dense_f32 launches")
                windows = check_twin_state(torch, engine, cpu, rng, f"index {name}")
                stats, snap = engine.cache.stats(), engine.session.snapshot()
                if stats != cpu.cache.stats() or snap != cpu.session.snapshot():
                    raise AssertionError(f"index {name}: counts differ from the CPU twin's")
                if stats["deltas_applied"] - deltas0 < 1:
                    raise AssertionError(f"index {name}: the write-back folded no row")
                pages = {}
                if srv is not None:
                    pages = {p: http_call(srv.http_port, f"/debug/{p}")
                             for p in ("cachez", "sessionz")}
                    if pages["cachez"] != (200, {**stats, "shards": engine.cache.shard_stats(),
                                                 "session_shards":
                                                     engine.session.shard_stats()}) \
                            or pages["sessionz"] != (200, snap):
                        raise AssertionError(f"index {name}: sidecar pages {pages}")
            finally:
                store.delta_listener = None
                cpu.close()
                cpu_svc.close()
                if srv is not None:
                    srv.shutdown(grace=5.0)
                else:
                    engine.close()
                    svc.close()
            large, singles = run["large_s"] + rest["large_s"], run["single_s"] + rest["single_s"]
            result[name] = {
                "capacity": capacity, "head": head, "flag_threshold": threshold,
                "large_frames": len(large), "small_frames": len(singles),
                "rows": sum(wire.decode_index_batch(f)[1].size for _, f, _ in frames),
                "score_batch_rows_per_s": [SERVER_BATCH_ROWS / t for t in large],
                "one_row_frame_p50_ms": (float(np.percentile(singles, 50)) * 1e3
                                         if singles else None),
                "split_ms": rest["split_ms"], "cache": stats,
                "session": {k: snap[k] for k in ("appends", "rehydrations", "admissions", "rows",
                                                 "accounts_tracked")},
                "device_steps": steps, "forest_launches": forest, "forward_launches": forwards,
                "dense_f32_launches": f32_launches,
                "folded_rows": run["folded_rows"] + rest["folded_rows"],
                "threshold_rows": run["threshold_rows"] + rest["threshold_rows"],
                "floor_boundary_rows": run["floor_boundary_rows"] + rest["floor_boundary_rows"],
                "windows_compared": windows, "state_bytes": state_bytes,
                "state_bytes_expected": engine.cache.hbm_bytes() + engine.session.hbm_bytes(),
                "engine_bytes": mem1 - mem0, "ensure_cache_s": build_s,
            }
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        STORE_CLOCK[0] = SERVER_NOW
    a, b = result["a"], result["b"]
    if a["folded_rows"] == 0 or b["folded_rows"] == 0:
        raise AssertionError(f"index: folded rows A {a['folded_rows']}, B {b['folded_rows']}")
    if b["cache"]["evictions"] == 0 or b["session"]["rehydrations"] == 0:
        raise AssertionError(f"index b: evictions {b['cache']['evictions']}, rehydrations "
                             f"{b['session']['rehydrations']}")
    if a["cache"]["evictions"] != 0:
        raise AssertionError("index a: an eviction with every account fitting")
    for name, r in result.items():
        log(f"phase 8: [{card}] engine {name.upper()} ({r['head']} head, capacity "
            f"{r['capacity']}): IDX1 ScoreBatch of {SERVER_BATCH_ROWS} rows bytes to bytes x"
            f"{r['large_frames']}: median {statistics.median(r['score_batch_rows_per_s']):.0f} "
            f"rows/s (row mode, phase 7: {row_rows_per_s:.0f} rows/s)"
            + (f"; {r['small_frames']} one-row frames, p50 {r['one_row_frame_p50_ms']:.3f} ms"
               if r["small_frames"] else ""))
        log(f"phase 8: [{card}] engine {name.upper()}: one RPC's host split (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in r["split_ms"].items()))
        c, sess = r["cache"], r["session"]
        log(f"phase 8: engine {name.upper()}: hits {c['hits']}, misses {c['misses']}, deltas "
            f"{c['deltas_applied']}, evictions {c['evictions']}; session appends "
            f"{sess['appends']}, admissions {sess['admissions']}, rehydrations "
            f"{sess['rehydrations']}, rows {sess['rows']}; {r['folded_rows']} rows folded")
        log(f"phase 8: engine {name.upper()}: {r['device_steps']} device steps, "
            f"{r['forest_launches']} forest launches, {r['forward_launches']} forward launches; "
            f"table and ring {r['state_bytes']} bytes on the device (expected "
            f"{r['state_bytes_expected']}), built in {r['ensure_cache_s']:.1f} s; every answer "
            f"agrees with the CPU twin ({r['floor_boundary_rows']} floor-boundary and "
            f"{r['threshold_rows']} threshold rows excused), table, ring, cursor and length "
            f"bit-equal, {r['windows_compared']} windows equal to the host index")
    log("phase 8: " + json.dumps(result))
    return result


def server_tree(seed: int) -> dict:
    """An ``mlp+gbdt`` params tree at serving width, drawn as phase 7 draws its
    own (seed 22)."""
    rng = np.random.default_rng(seed)
    return {"mlp": mlp_tree(rng, SERVE_HIDDEN), "gbdt": forest_tree(rng, SERVE_TREES, SERVE_DEPTH)}


def sketch_diff(got, want) -> dict:
    """Two sketch vectors: histogram bins that differ (must be 0) and the
    largest relative error of the moments (must be under MOMENT_RTOL)."""
    from igaming_platform_tpu_torch.obs import drift as drift_mod

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    hist = slice(drift_mod.OFF_FHIST, drift_mod.SKETCH_LEN)
    mom = slice(0, drift_mod.OFF_FHIST)
    rel = np.abs(got[mom] - want[mom]) / np.maximum(np.abs(want[mom]), 1e-30)
    return {"bins_differing": int((got[hist] != want[hist]).sum()),
            "moment_rel_err": float(rel.max())}


def check_sketches(pairs, what: str) -> dict:
    """Every (card, twin) sketch pair: histograms equal, moments within
    MOMENT_RTOL. Returns the totals."""
    diffs = [sketch_diff(g, w) for g, w in pairs]
    out = {"sketches": len(diffs), "bins_differing": sum(d["bins_differing"] for d in diffs),
           "moment_rel_err": max(d["moment_rel_err"] for d in diffs)}
    if out["bins_differing"] or out["moment_rel_err"] > MOMENT_RTOL:
        raise AssertionError(f"{what}: sketches differ from the CPU twin's: {out}")
    return out


def window_delta(drift, before: np.ndarray) -> np.ndarray:
    """The drift engine's window after its queue drains, less ``before``."""
    if not drift.drain(30.0):
        raise AssertionError("drift: the queue did not drain")
    return drift.window_vec() - before


def single_columns(codec, payloads: list[bytes]) -> dict:
    """ScoreTransactionResponse bytes as result columns."""
    from igaming_platform_tpu_torch.core.enums import REASON_BIT_ORDER

    bit = {code.value: b for b, code in enumerate(REASON_BIT_ORDER)}
    rows = [codec.decode(codec.SCORE_TRANSACTION_RESPONSE, p) for p in payloads]
    return {"score": np.array([r["score"] for r in rows]),
            "action": np.array([r["action"] for r in rows]),
            "rule_score": np.array([r["rule_score"] for r in rows]),
            "ml_score": np.array([r["ml_score"] for r in rows], dtype=np.float32),
            "reason_mask": np.array([sum(1 << bit[c] for c in r["reason_codes"])
                                     for r in rows])}


def response_from_score(resp) -> dict:
    """One engine ScoreResponse as a row of result columns."""
    from igaming_platform_tpu_torch.core.enums import REASON_BIT_ORDER

    return {"score": resp.score, "action": {"approve": 1, "review": 2, "block": 3}[resp.action],
            "rule_score": resp.rule_score, "ml_score": np.float32(resp.ml_score),
            "reason_mask": sum(1 << REASON_BIT_ORDER.index(c) for c in resp.reason_codes)}


def shadow_pair(engine, cpu, cand, capture: bool):
    """A ShadowScorer of ``cand`` on the card's engine and on its CPU twin,
    each feeding its engine's drift engine; with ``capture`` each also keeps
    the candidate results in order."""
    from igaming_platform_tpu_torch.serve.shadow import ShadowScorer

    out = []
    for eng in (engine, cpu):
        got = []
        drift = eng.drift

        def hook(c, p, n, got=got, drift=drift):
            drift.note_shadow_result(c, p, n)
            if capture:
                got.append(c)

        sh = ShadowScorer(eng, cand, queue_max_rows=1 << 22, on_result=hook)
        eng.shadow = sh
        out.append((sh, got))
    return out


def compare_shadow_reports(card: dict, twin: dict, boundary: int, what: str) -> None:
    """The card's shadow window against the twin's: the same rows, and the
    same flips and score deltas but for at most ``boundary`` rows."""
    w, t = card["window"], twin["window"]
    if (w["rows"] != t["rows"] or card["errors"] or twin["errors"] or card["rows_dropped"]
            or twin["rows_dropped"] or abs(w["action_flips"] - t["action_flips"]) > boundary
            or abs(w["score_delta_mean"] - t["score_delta_mean"]) * w["rows"] > 2 * boundary + 1
            or abs(w["ml_delta_max"] - t["ml_delta_max"]) > 2 * ML_ATOL):
        raise AssertionError(f"{what}: shadow report {w} differs from the CPU twin's {t}")


def variants_int8(torch, gbdt_kernel, store, device: str) -> dict:
    """Engine C: ``mlp+gbdt_int8`` quantized by the port from phase 7's
    params (the store's first CALIBRATION_ROWS accounts as calibration),
    WIRE_DTYPE=int8, its service's drift engine, and a candidate in shadow;
    VARIANT_RPCS ScoreBatch and VARIANT_SINGLES ScoreTransaction RPCs
    through ``RiskGrpcService.call``, each held to a CPU twin (answers, each
    RPC's sketch, the shadow's window); forest launches = 2 x device steps;
    /debug/driftz after the drain."""
    import os

    from igaming_platform_tpu_torch.convert import from_jax_params
    from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
    from igaming_platform_tpu_torch.core.features import normalize, standardize_for_model
    from igaming_platform_tpu_torch.obs import drift as drift_mod
    from igaming_platform_tpu_torch.ops import quantize
    from igaming_platform_tpu_torch.serve import grpc_server, scorer, server
    from igaming_platform_tpu_torch.serve import risk_codec as codec

    n_cal = min(CALIBRATION_ROWS, store.num_accounts())
    x_cal, _ = store.gather_columns([f"acct{i}" for i in range(n_cal)], [0] * n_cal,
                                    ["deposit"] * n_cal)
    cal = standardize_for_model(normalize(torch.from_numpy(x_cal))).numpy()
    t = time.perf_counter()
    qtree, backend = quantize.quantize_checkpoint(server_tree(22), "mlp+gbdt", cal)
    qcand, _ = quantize.quantize_checkpoint(server_tree(29), "mlp+gbdt", cal)
    quantize_s = time.perf_counter() - t
    params, cand = from_jax_params(backend, qtree), from_jax_params(backend, qcand)
    bcfg = BatcherConfig(batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0)
    os.environ["WIRE_DTYPE"] = "int8"
    os.environ.pop("DRIFT", None)
    assembled = server.assemble_risk_service(RiskServiceConfig(batcher=bcfg), ml_backend=backend,
                                             params=params, feature_store=store, device=device)
    srv = server.RiskServer(assembled, grpc_port=-1, http_port=0)
    svc, engine = assembled.service, assembled.engine
    cpu = scorer.TorchScoringEngine(ml_backend=backend, params=params, batcher_config=bcfg,
                                    feature_store=store, device="cpu", warmup=False)
    cpu_drift = drift_mod.DriftEngine()
    cpu.bind_drift(cpu_drift)
    (sh, _), (cpu_sh, _) = shadow_pair(engine, cpu, cand, capture=False)
    rng = np.random.default_rng(24)
    batches = [codec.encode(codec.SCORE_BATCH_REQUEST,
                            {"transactions": server_requests(codec, rng, SERVER_BATCH_ROWS)})
               for _ in range(VARIANT_RPCS)]
    singles = [codec.encode(codec.SCORE_TRANSACTION_REQUEST, r)
               for r in server_requests(codec, rng, VARIANT_SINGLES)]
    drift = svc.drift
    try:
        if device == "cuda":
            torch.cuda.synchronize()
        # The path's run: counts set to 0 just before, read just after.
        gbdt_kernel.gbdt_forest.launches = 0
        steps0 = engine.device_steps
        batch_s, outs, card_sketches = [], [], []
        for payload in batches:
            before = drift.window_vec()
            t = time.perf_counter()
            outs.append(svc.call("ScoreBatch", payload))
            batch_s.append(time.perf_counter() - t)
            card_sketches.append(window_delta(drift, before))
        before = drift.window_vec()
        single_out = [svc.call("ScoreTransaction", p) for p in singles]
        card_sketches.append(window_delta(drift, before))
        if device == "cuda":
            torch.cuda.synchronize()
        launches = gbdt_kernel.gbdt_forest.launches
        steps = engine.device_steps - steps0
        if device == "cuda" and (steps == 0 or launches != 2 * steps):
            raise AssertionError(f"int8 engine: {steps} device steps, {launches} forest launches "
                                 "(a live candidate: two a step)")
        if not sh.drain(60.0):
            raise AssertionError("int8 engine: the shadow did not drain")
        status, driftz = http_call(srv.http_port, "/debug/driftz")
        rows = VARIANT_RPCS * SERVER_BATCH_ROWS + VARIANT_SINGLES
        if status != 200 or driftz["window"]["rows"] != rows \
                or driftz["stats"]["rows_sketched"] != rows or driftz["stats"]["errors"]:
            raise AssertionError(f"int8 engine: /debug/driftz {status} {driftz.get('window')} "
                                 f"{driftz.get('stats')} for {rows} rows scored")
        status, shadowz = http_call(srv.http_port, "/debug/shadowz")
        if status != 200 or shadowz["shadow"]["fused_batches"] != steps:
            raise AssertionError(f"int8 engine: /debug/shadowz {status} {shadowz}")

        # The CPU twin: the same RPCs through the same engine paths.
        boundary, twin_sketches = 0, []
        for payload, out in zip(batches, outs):
            before = cpu_drift.window_vec()
            want = cpu.score_batch_wire_bytes(payload)[0]
            twin_sketches.append(window_delta(cpu_drift, before))
            boundary += compare_columns(response_columns(codec, out)[1],
                                        response_columns(codec, want)[1], "int8 engine")
        before = cpu_drift.window_vec()
        want_single = [response_from_score(cpu.score(grpc_server.RiskGrpcService._request_from_proto(
            codec.decode(codec.SCORE_TRANSACTION_REQUEST, p)))) for p in singles]
        twin_sketches.append(window_delta(cpu_drift, before))
        boundary += compare_columns(single_columns(codec, single_out),
                                    {k: np.array([r[k] for r in want_single])
                                     for k in want_single[0]}, "int8 engine singles")
        if boundary > MAX_VARIANT_BOUNDARY:
            raise AssertionError(f"int8 engine: {boundary} floor-boundary rows")
        sketches = check_sketches(zip(card_sketches, twin_sketches), "int8 engine")
        if not cpu_sh.drain(120.0):
            raise AssertionError("int8 engine: the twin's shadow did not drain")
        report, twin_report = sh.report(), cpu_sh.report()
        compare_shadow_reports(report, twin_report, boundary, "int8 engine")
    finally:
        sh.close()
        cpu_sh.close()
        cpu.close()
        cpu_drift.close()
        srv.shutdown(grace=5.0)
    return {"backend": backend, "wire": "int8", "quantize_s": quantize_s,
            "calibration_rows": n_cal, "device_steps": steps, "forest_launches": launches,
            "score_batch_rows_per_s": [SERVER_BATCH_ROWS / t for t in batch_s],
            "floor_boundary_rows": boundary, "sketch_check": sketches,
            "driftz_window_rows": driftz["window"]["rows"], "shadow_window": report["window"],
            "shadow_fused_batches": report["fused_batches"]}


def variants_session(torch, gbdt_kernel, fa, store, device: str) -> dict:
    """Engine A of phase 8 (index path, the transformer session head) with
    its service's drift engine and a candidate in shadow, for VARIANT_FRAMES
    frames of phase 8's traffic, each held to a CPU twin: answers, each
    frame's sketch, every chunk's candidate result; then the table and ring
    bit-equal. Forest launches = 2 x device steps, forward launches = device
    steps (the head runs once a step for both)."""
    import os

    from igaming_platform_tpu_torch.convert import from_jax_params
    from igaming_platform_tpu_torch.core.config import BatcherConfig
    from igaming_platform_tpu_torch.obs import drift as drift_mod
    from igaming_platform_tpu_torch.serve import grpc_server, scorer, wire
    from igaming_platform_tpu_torch.serve import risk_codec as codec

    # Phase 8's params and the first frames of its engine A, drawn as it draws them.
    rng = np.random.default_rng(23)
    params = from_jax_params("mlp+gbdt", {"mlp": mlp_tree(rng, SERVE_HIDDEN),
                                          "gbdt": forest_tree(rng, SERVE_TREES, SERVE_DEPTH)})
    frames = index_traffic_a(wire, rng)[:VARIANT_FRAMES]
    cand = from_jax_params("mlp+gbdt", server_tree(30))
    os.environ.update({"WIRE_DTYPE": "float32", "WIRE_MODE": "index", "SESSION_STATE": "1",
                       "SESSION_HEAD": "transformer",
                       "SESSION_FLAG_THRESHOLD": str(INDEX_A_THRESHOLD)})
    bcfg = BatcherConfig(batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0)
    engines = [scorer.TorchScoringEngine(ml_backend="mlp+gbdt", params=params,
                                         batcher_config=bcfg, feature_store=store, device=d,
                                         feature_cache=INDEX_A_CAPACITY, warmup=False)
               for d in (device, "cpu")]
    engine, cpu = engines
    svc = grpc_server.RiskGrpcService(engine)
    cpu_drift = drift_mod.DriftEngine()
    cpu.bind_drift(cpu_drift)
    pairs = []
    try:
        for eng in engines:
            eng.ensure_cache()
        store.delta_listener = lambda a: [e.cache.note_update(a) for e in engines]
        pairs = shadow_pair(engine, cpu, cand, capture=True)
        drift = svc.drift
        if device == "cuda":
            torch.cuda.synchronize()
        # The path's run: counts set to 0 just before, read just after.
        gbdt_kernel.gbdt_forest.launches = 0
        fa.flash_attention_fwd.launches = 0
        steps0 = engine.device_steps
        outs, card_sketches = [], []
        for t, frame, _ in frames:
            STORE_CLOCK[0] = t
            before = drift.window_vec()
            outs.append(svc.call("ScoreBatch", frame))
            card_sketches.append(window_delta(drift, before))
        if device == "cuda":
            torch.cuda.synchronize()
        steps = engine.device_steps - steps0
        forest, forwards = gbdt_kernel.gbdt_forest.launches, fa.flash_attention_fwd.launches
        if device == "cuda" and (steps == 0 or forest != 2 * steps or forwards != steps):
            raise AssertionError(f"session variants: {steps} device steps, {forest} forest and "
                                 f"{forwards} forward launches")
        boundary = near = 0
        twin_sketches = []
        for (t, frame, _), out in zip(frames, outs):
            STORE_CLOCK[0] = t
            before = cpu_drift.window_vec()
            want = cpu.score_batch_wire_index(frame)[0]
            twin_sketches.append(window_delta(cpu_drift, before))
            b, n, _ = compare_session_columns(response_columns(codec, out)[1],
                                              response_columns(codec, want)[1],
                                              INDEX_A_THRESHOLD, "session variants")
            boundary, near = boundary + b, near + n
        sketches = check_sketches(zip(card_sketches, twin_sketches), "session variants")
        (sh, got), (cpu_sh, want_c) = pairs
        if not (sh.drain(60.0) and cpu_sh.drain(120.0)) or len(got) != len(want_c) or not got:
            raise AssertionError(f"session variants: {len(got)} and {len(want_c)} shadow batches")
        for g, w in zip(got, want_c):
            b, n, _ = compare_session_columns(g, w, INDEX_A_THRESHOLD, "session shadow")
            boundary, near = boundary + b, near + n
        if boundary > MAX_VARIANT_BOUNDARY:
            raise AssertionError(f"session variants: {boundary} floor-boundary rows")
        report = sh.report()
        compare_shadow_reports(report, cpu_sh.report(), boundary + near, "session variants")
        windows = check_twin_state(torch, engine, cpu, rng, "session variants")
    finally:
        store.delta_listener = None
        for sh, _ in pairs:
            sh.close()
        for eng in engines:
            eng.close()
        svc.close()
        cpu_drift.close()
        STORE_CLOCK[0] = SERVER_NOW
    return {"frames": len(frames), "rows": sum(wire.decode_index_batch(f)[1].size
                                               for _, f, _ in frames),
            "device_steps": steps, "forest_launches": forest, "forward_launches": forwards,
            "floor_boundary_rows": boundary, "threshold_rows": near, "sketch_check": sketches,
            "shadow_window": report["window"], "windows_compared": windows}


def variants_turns(torch, store, device: str) -> dict:
    """Phase 7's engine (``mlp+gbdt``) in turns on one card, VARIANT_TURN_RPCS
    ScoreBatch RPCs of SERVER_BATCH_ROWS rows each turn (rows/s, median):
    the drift engine unbound (as with DRIFT=0) and bound, order off, on, on,
    off; then the float32, bf16 and int8 row wires with drift on, order f32,
    bf16, int8, int8, bf16, f32. Also the host cost of each wire's encode
    and one BATCH_SIZE-row step's kernels by name without and with the
    sketch."""
    import os

    from igaming_platform_tpu_torch.convert import from_jax_params
    from igaming_platform_tpu_torch.core.config import BatcherConfig
    from igaming_platform_tpu_torch.obs import drift as drift_mod
    from igaming_platform_tpu_torch.obs.drift import sketch_kernel
    from igaming_platform_tpu_torch.ops.quantize import wire_quantize_int8
    from igaming_platform_tpu_torch.serve import grpc_server, scorer
    from igaming_platform_tpu_torch.serve import risk_codec as codec

    params = from_jax_params("mlp+gbdt", server_tree(22))
    rng = np.random.default_rng(25)
    payloads = [codec.encode(codec.SCORE_BATCH_REQUEST,
                             {"transactions": server_requests(codec, rng, SERVER_BATCH_ROWS)})
                for _ in range(VARIANT_TURN_RPCS)]
    bcfg = BatcherConfig(batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0)
    os.environ["DRIFT"] = "0"  # each engine gets a drift engine of its own below
    built = {}
    try:
        for wire_name in ("float32", "bf16", "int8"):
            os.environ["WIRE_DTYPE"] = wire_name
            eng = scorer.TorchScoringEngine(ml_backend="mlp+gbdt", params=params,
                                            batcher_config=bcfg, feature_store=store,
                                            device=device)
            drift = drift_mod.DriftEngine()
            eng.bind_drift(drift)
            svc = grpc_server.RiskGrpcService(eng)
            svc.call("ScoreBatch", payloads[0])  # the pipeline's build, off the clock
            built[wire_name] = (eng, svc, drift)

        def turn(svc) -> dict:
            """One turn: rows/s of each RPC, and the pipeline's busy ms per
            stage (dispatch holds the wire's encode) per RPC."""
            pipe = svc.engine._host_pipeline
            busy0 = pipe.stats()["stage_busy_ms"]
            rates = []
            for payload in payloads:
                t = time.perf_counter()
                svc.call("ScoreBatch", payload)
                rates.append(SERVER_BATCH_ROWS / (time.perf_counter() - t))
            busy = pipe.stats()["stage_busy_ms"]
            return {"rows_per_s": rates, "stage_busy_ms_per_rpc": {
                k: (busy[k] - busy0[k]) / len(payloads) for k in busy}}

        eng, svc, drift = built["float32"]
        drift_turns = []
        for on in (False, True, True, False):
            eng.bind_drift(drift if on else None)
            drift_turns.append({"drift": on, **turn(svc)})
        wire_turns = [{"wire": w, **turn(built[w][1])}
                      for w in ("float32", "bf16", "int8", "int8", "bf16", "float32")]
        for _, _, d in built.values():
            d.drain(30.0)

        x, bl = store.decode_gather(payloads[0])
        chunk = x[:BATCH_SIZE]
        encode_us = {}
        for name, fn in (("bf16", scorer.encode_bf16), ("int8", wire_quantize_int8)):
            times = []
            for _ in range(20):
                t = time.perf_counter()
                fn(chunk)
                times.append(time.perf_counter() - t)
            encode_us[name] = statistics.median(times) * 1e6 / BATCH_SIZE
        kernels = None
        if device == "cuda":
            xd, bld = (torch.from_numpy(a[:BATCH_SIZE]).cuda() for a in (x, bl))

            def step(sketch: bool):
                def run():
                    with torch.inference_mode():
                        out = eng._score_fn(eng.get_params(), xd, bld, eng._thresholds)
                        if sketch:
                            sketch_kernel(xd, scorer._stack_packed(out), BATCH_SIZE)
                return run

            kernels = {}
            for name, fn in (("step", step(False)), ("step_and_sketch", step(True)),
                             ("step", step(False))):
                kernels.setdefault(name, {"device_ms": [], "profile": None})
                kernels[name]["device_ms"].append(step_device_ms(torch, fn))
                kernels[name]["profile"] = profile_window(torch, fn, top=60)
    finally:
        for eng, svc, drift in built.values():
            eng.close()
            svc.close()
            drift.close()
        os.environ.pop("DRIFT", None)
    return {"drift_turns": drift_turns, "wire_turns": wire_turns,
            "encode_us_per_row": encode_us, "step_kernels": kernels}


def phase_variants(torch, card: str, gbdt_kernel, fa, store, device: str = "cuda") -> dict:
    """Phase 9, on phase 7's store: the score step's variants. Engine C
    (``variants_int8``), engine A with drift and a shadow
    (``variants_session``), and the turns on phase 7's engine
    (``variants_turns``). ``device="cpu"`` rehearses it without a card (the
    launch checks and the kernel profile are then skipped)."""
    import os

    knobs = ("WIRE_DTYPE", "DRIFT", "DRIFT_WINDOW_S", "WIRE_MODE", "SESSION_STATE",
             "SESSION_HEAD", "SESSION_FLAG_THRESHOLD")
    saved = {k: os.environ.get(k) for k in knobs}
    t0 = time.perf_counter()
    try:
        # A window longer than the phase, so /debug/driftz counts every row.
        os.environ["DRIFT_WINDOW_S"] = "3600"
        c = variants_int8(torch, gbdt_kernel, store, device)
        a = variants_session(torch, gbdt_kernel, fa, store, device)
        turns = variants_turns(torch, store, device)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    result = {"int8_engine": c, "session_engine": a, "turns": turns,
              "seconds": time.perf_counter() - t0}
    log(f"phase 9: [{card}] engine C ({c['backend']}, int8 wire, drift, a candidate in shadow): "
        f"ScoreBatch of {SERVER_BATCH_ROWS} rows x{VARIANT_RPCS}: median "
        f"{statistics.median(c['score_batch_rows_per_s']):.0f} rows/s; {c['device_steps']} "
        f"device steps, {c['forest_launches']} forest launches; answers, every RPC's sketch "
        f"({c['sketch_check']}) and the shadow window agree with the CPU twin "
        f"({c['floor_boundary_rows']} floor-boundary rows excused); /debug/driftz window "
        f"{c['driftz_window_rows']} rows; quantized in {c['quantize_s']:.3f} s")
    log(f"phase 9: engine A with drift and a shadow, {a['frames']} frames of {a['rows']} rows: "
        f"{a['device_steps']} device steps, {a['forest_launches']} forest and "
        f"{a['forward_launches']} forward launches; answers, sketches ({a['sketch_check']}) and "
        f"every candidate result agree with the CPU twin ({a['floor_boundary_rows']} "
        f"floor-boundary and {a['threshold_rows']} threshold rows excused); table, ring, cursor "
        f"and length bit-equal")
    for tr in turns["drift_turns"] + turns["wire_turns"]:
        what = (f"drift {'on ' if tr['drift'] else 'off'}" if "drift" in tr
                else f"wire {tr['wire']}")
        log(f"phase 9: [{card}] {what}: median {statistics.median(tr['rows_per_s']):.0f} rows/s; "
            "busy ms per RPC: " + ", ".join(
                f"{k} {v:.3f}" for k, v in tr["stage_busy_ms_per_rpc"].items()))
    log(f"phase 9: host encode per row: " + ", ".join(
        f"{k} {v:.4f} us" for k, v in turns["encode_us_per_row"].items()))
    for name, k in (turns["step_kernels"] or {}).items():
        prof = k["profile"]
        if prof["device_ms"] is not None:
            log(f"phase 9: [{card}] one {BATCH_SIZE}-row {name}: {k['device_ms']} ms by events; "
                f"{prof['device_ms']:.6f} ms of kernels in {sum(r['count'] for r in prof['top'])} "
                "launches; by name: " + "; ".join(
                    f"{r['kernel']} {r['device_ms']:.6f} ms x{r['count']}" for r in prof["top"]))
    log(f"phase 9: {result['seconds']:.1f} s")
    log("phase 9: " + json.dumps(result))
    return result


def snapshot_rows(ledger_mod, directory: str) -> dict[str, int]:
    """Rows of a WAL that carry a feature snapshot, by wire mode (path)."""
    out: dict[str, int] = {}
    for rec in ledger_mod.iter_records(directory):
        if rec.features is not None:
            out[rec.wire_mode] = out.get(rec.wire_mode, 0) + 1
    return out


def timed_replay(replay, directory: str, device: str) -> tuple[dict, float]:
    t = time.perf_counter()
    verdict = replay.replay_directory(directory, batch=BATCH_SIZE, tiers=LATENCY_TIERS,
                                      device=device)
    return verdict, time.perf_counter() - t


def ledger_engine_l(torch, gbdt_kernel, store, directory: str, device: str) -> dict:
    """Engine L through ``assemble_risk_service`` with ``LEDGER_DIR`` set and
    its sidecar bound: ScoreTransaction RPCs (the batcher at small shapes,
    each answer's ``risk-decision-id`` checked), ScoreBatch RPCs (the host
    pipeline), one ``score_batch``, a swap with both trees in the params
    vault, more ScoreBatch RPCs; the ledger flushed after each, no row
    dropped. Then the WAL replayed on ``device`` and, on a card, on the CPU
    (its mismatches counted, not asserted)."""
    import os

    from igaming_platform_tpu_torch.convert import from_jax_params
    from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
    from igaming_platform_tpu_torch.serve import ledger as ledger_mod
    from igaming_platform_tpu_torch.serve import risk_codec as codec
    from igaming_platform_tpu_torch.serve import server
    from igaming_platform_tpu_torch.serve.scorer import ScoreRequest
    from igaming_platform_tpu_torch.tools import replay
    from igaming_platform_tpu_torch.train.promote import vault_save

    rng = np.random.default_rng(26)
    params = [from_jax_params("mlp+gbdt", {"mlp": mlp_tree(rng, SERVE_HIDDEN),
                                           "gbdt": forest_tree(rng, *LARGE_ENGINE_FOREST)})
              for _ in range(2)]
    fps = [vault_save(os.path.join(directory, "params-vault"), p, "mlp+gbdt") for p in params]
    singles = [codec.encode(codec.SCORE_TRANSACTION_REQUEST, r)
               for r in server_requests(codec, rng, LEDGER_SINGLES)]
    batches = [codec.encode(codec.SCORE_BATCH_REQUEST,
                            {"transactions": server_requests(codec, rng, SERVER_BATCH_ROWS)})
               for _ in range(SERVER_BATCHES + LEDGER_AFTER_SWAP)]
    direct = [ScoreRequest(account_id=r["account_id"], amount=r["amount"],
                           tx_type=r["transaction_type"], ip=r["ip_address"],
                           device_id=r["device_id"])
              for r in server_requests(codec, rng, LEDGER_DIRECT)]
    os.environ["LEDGER_DIR"] = directory
    try:
        assembled = server.assemble_risk_service(
            RiskServiceConfig(batcher=BatcherConfig(batch_size=BATCH_SIZE,
                                                    latency_tiers=LATENCY_TIERS, max_wait_ms=2.0)),
            ml_backend="mlp+gbdt", params=params[0], feature_store=store, device=device)
    finally:
        os.environ.pop("LEDGER_DIR")
    srv = server.RiskServer(assembled, grpc_port=-1, http_port=0)
    engine, svc, led = assembled.engine, assembled.service, assembled.ledger
    try:
        if engine.params_fingerprint != fps[0] or engine.ledger is not led:
            raise AssertionError("ledger L: the vault's fingerprint or the ledger's binding")
        engine._ensure_pipeline()
        if device == "cuda":
            torch.cuda.synchronize()
        # The path's run: counts set to 0 just before, read just after.
        gbdt_kernel.gbdt_forest.launches = 0
        steps0 = engine.device_steps
        t0 = time.perf_counter()
        ids = []
        for payload in singles:
            ids.append(dict(svc.call_with_trailing("ScoreTransaction", payload)[1]).get(
                "risk-decision-id", ""))
            led.flush(30.0)
        for payload in batches[:SERVER_BATCHES]:
            svc.call("ScoreBatch", payload)
            led.flush(30.0)
        responses = engine.score_batch(direct)
        led.flush(30.0)
        engine.swap_params(params[1])
        for payload in batches[SERVER_BATCHES:]:
            svc.call("ScoreBatch", payload)
            led.flush(30.0)
        run_s = time.perf_counter() - t0
        if device == "cuda":
            torch.cuda.synchronize()
        launches, steps = gbdt_kernel.gbdt_forest.launches, engine.device_steps - steps0
        stats = led.stats()
        ledgerz = http_call(srv.http_port, "/debug/ledgerz")
    finally:
        srv.shutdown(grace=5.0)
    rows = (LEDGER_SINGLES + LEDGER_DIRECT
            + SERVER_BATCH_ROWS * (SERVER_BATCHES + LEDGER_AFTER_SWAP))
    if device == "cuda" and (steps == 0 or launches != steps):
        raise AssertionError(f"ledger L: {steps} device steps but {launches} forest launches")
    if (stats["records_dropped"] or stats["records_appended"] != rows
            or ledgerz[0] != 200 or ledgerz[1]["records_appended"] != rows):
        raise AssertionError(f"ledger L: {rows} rows answered, ledger {stats}")
    if not all(ids) or len(set(ids)) != LEDGER_SINGLES or not all(r.decision_id for r in responses):
        raise AssertionError("ledger L: an answer without its decision id")
    by_path = snapshot_rows(ledger_mod, directory)
    verdict, replay_s = timed_replay(replay, directory, device)
    if not (verdict["ok"] and verdict["mismatches"] == 0
            and verdict["params_fingerprint_mismatch"] == 0
            and verdict["replayed"] == sum(by_path.values()) == rows
            and set(verdict["replayed_by_params_fp"]) == set(fps)):
        raise AssertionError(f"ledger L: replay {json.dumps(verdict)[:2000]}")
    cpu = None
    if device == "cuda":
        cpu, _ = timed_replay(replay, directory, "cpu")
    return {"rows": rows, "snapshot_rows_by_path": by_path, "run_s": run_s,
            "device_steps": steps, "forest_launches": launches, "ledger": stats,
            "fingerprints": fps, "replay": {k: verdict[k] for k in (
                "ok", "records_total", "replayed", "replayed_by_params_fp", "mismatches",
                "params_fingerprint_mismatch", "device")},
            "replay_s": replay_s, "replay_records_per_s": verdict["records_total"] / replay_s,
            "cpu_replay_mismatches": None if cpu is None else cpu["mismatches"],
            "cpu_replay_ok": None if cpu is None else cpu["ok"]}


def ledger_engine_a(torch, gbdt_kernel, fa, store, directory: str, device: str) -> dict:
    """Engine A of phase 8 (index mode, the transformer session head) with
    ``LEDGER_DIR`` set: LEDGER_INDEX_ROUNDS large IDX1 frames and the first
    round's one-row frames, the ledger flushed after each; then its WAL
    replayed on ``device``: every session row's window rebuilt from the
    ledger's order and its hash verified."""
    import os

    from igaming_platform_tpu_torch.convert import from_jax_params
    from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
    from igaming_platform_tpu_torch.serve import server, wire
    from igaming_platform_tpu_torch.tools import replay

    rng = np.random.default_rng(27)
    frames = index_traffic_a(wire, rng, LEDGER_INDEX_ROUNDS)
    frames = [f for i, f in enumerate(frames) if f[2] or i <= INDEX_CYCLERS]
    knobs = {"WIRE_MODE": "index", "SESSION_STATE": "1", "SESSION_HEAD": "transformer",
             "SESSION_FLAG_THRESHOLD": str(INDEX_A_THRESHOLD), "LEDGER_DIR": directory}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:  # the session plane reads its knobs when ensure_cache builds it
        assembled = server.assemble_risk_service(
            RiskServiceConfig(batcher=BatcherConfig(batch_size=BATCH_SIZE,
                                                    latency_tiers=LATENCY_TIERS, max_wait_ms=2.0)),
            ml_backend="mlp+gbdt", params=from_jax_params("mlp+gbdt", server_tree(27)),
            feature_store=store, device=device, feature_cache=INDEX_A_CAPACITY, warmup=False)
        assembled.engine.ensure_cache()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    srv = server.RiskServer(assembled, grpc_port=-1, http_port=0)
    engine, svc, led = assembled.engine, assembled.service, assembled.ledger
    try:
        if engine.session.head != "transformer":
            raise AssertionError(f"ledger A: session head {engine.session.head}")
        if device == "cuda":
            torch.cuda.synchronize()
        # The path's run: counts set to 0 just before, read just after.
        gbdt_kernel.gbdt_forest.launches = 0
        fa.flash_attention_fwd.launches = 0
        steps0 = engine.device_steps
        for t, frame, _large in frames:
            STORE_CLOCK[0] = t
            svc.call("ScoreBatch", frame)
            led.flush(30.0)
        if device == "cuda":
            torch.cuda.synchronize()
        steps = engine.device_steps - steps0
        forest, forwards = gbdt_kernel.gbdt_forest.launches, fa.flash_attention_fwd.launches
        stats = led.stats()
    finally:
        STORE_CLOCK[0] = SERVER_NOW
        srv.shutdown(grace=5.0)
    rows = sum(wire.decode_index_batch(f)[1].size for _, f, _ in frames)
    if device == "cuda" and (steps == 0 or forest != steps or forwards != steps):
        raise AssertionError(f"ledger A: {steps} device steps, {forest} forest launches, "
                             f"{forwards} forward launches")
    if stats["records_dropped"] or stats["records_appended"] != rows:
        raise AssertionError(f"ledger A: {rows} rows answered, ledger {stats}")
    verdict, replay_s = timed_replay(replay, directory, device)
    if not (verdict["ok"] and verdict["session_ok"]
            and verdict["session_verified"] == verdict["session_records"] == rows
            and verdict["skipped_no_snapshot"] == rows):
        raise AssertionError(f"ledger A: replay {json.dumps(verdict)[:2000]}")
    return {"rows": rows, "frames": len(frames), "device_steps": steps,
            "forest_launches": forest, "forward_launches": forwards, "ledger": stats,
            "replay": {k: verdict[k] for k in ("ok", "records_total", "session_records",
                                                "session_verified", "session_chain_gaps",
                                                "session_resets", "session_ok", "device")},
            "replay_s": replay_s, "replay_records_per_s": verdict["records_total"] / replay_s}


def ledger_turns(torch, store, directory: str, device: str) -> dict:
    """Phase 7's engine (drift bound, as by default) in turns, its ledger
    unbound and bound, order off, on, on, off, VARIANT_TURN_RPCS ScoreBatch
    RPCs of SERVER_BATCH_ROWS rows a turn (rows/s, and the process's CPU
    seconds over the RPCs), the ledger left to catch up between turns, off
    the clock; for each on-turn the writer's wall and CPU seconds and its
    expand-and-encode CPU µs a record (``DecisionLedger.stats``); then the
    writer's counts, which must add up to the rows noted, its fsync p99 and
    the WAL's bytes a record."""
    from igaming_platform_tpu_torch.convert import from_jax_params
    from igaming_platform_tpu_torch.core.config import BatcherConfig
    from igaming_platform_tpu_torch.serve import grpc_server, scorer
    from igaming_platform_tpu_torch.serve import ledger as ledger_mod
    from igaming_platform_tpu_torch.serve import risk_codec as codec

    rng = np.random.default_rng(28)
    payloads = [codec.encode(codec.SCORE_BATCH_REQUEST,
                             {"transactions": server_requests(codec, rng, SERVER_BATCH_ROWS)})
                for _ in range(VARIANT_TURN_RPCS)]
    engine = scorer.TorchScoringEngine(
        ml_backend="mlp+gbdt", params=from_jax_params("mlp+gbdt", server_tree(22)),
        batcher_config=BatcherConfig(batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS,
                                     max_wait_ms=2.0), feature_store=store, device=device)
    svc = grpc_server.RiskGrpcService(engine)
    led = ledger_mod.DecisionLedger(directory)
    turns = []
    try:
        svc.call("ScoreBatch", payloads[0])  # the pipeline's build, off the clock
        writer_keys = ("writer_busy_s", "writer_cpu_s", "encode_cpu_s", "encoded_records")
        for on in (False, True, True, False):
            before = led.stats()
            engine.ledger = led if on else None
            rates = []
            cpu0 = time.process_time()
            for payload in payloads:
                t = time.perf_counter()
                svc.call("ScoreBatch", payload)
                rates.append(SERVER_BATCH_ROWS / (time.perf_counter() - t))
            engine.ledger = None
            turns.append({"ledger": on, "rows_per_s": rates,
                          "rpc_s": sum(SERVER_BATCH_ROWS / r for r in rates),
                          "process_cpu_s": time.process_time() - cpu0, "catch_up_s": None})
            if on:
                t = time.perf_counter()
                led.flush(120.0)
                turns[-1]["catch_up_s"] = time.perf_counter() - t
                after = led.stats()
                writer = {k: after[k] - before[k] for k in writer_keys}
                n = writer["encoded_records"]
                writer["encode_us_per_record"] = writer["encode_cpu_s"] / n * 1e6 if n else None
                writer["writer_cpu_us_per_record"] = (writer["writer_cpu_s"] / n * 1e6
                                                      if n else None)
                turns[-1]["writer"] = writer
        stats = led.stats()
    finally:
        engine.close()
        svc.close()
        led.close()
    noted = 2 * VARIANT_TURN_RPCS * SERVER_BATCH_ROWS
    if stats["records_appended"] + stats["records_dropped"] != noted:
        raise AssertionError(f"ledger turns: {noted} rows noted, ledger {stats}")
    return {"turns": turns, "rows_noted": noted, "records_appended": stats["records_appended"],
            "records_dropped": stats["records_dropped"], "fsync_p99_ms": stats["fsync_p99_ms"],
            "fsync_count": stats["fsync_count"],
            "wal_bytes_per_record": (stats["wal_bytes"] / stats["durable_records"]
                                     if stats["durable_records"] else None)}


def phase_ledger(torch, card: str, gbdt_kernel, fa, store, device: str = "cuda") -> dict:
    """Phase 10, on phase 7's store: the decision ledger and replay. Engine L
    (``ledger_engine_l``), engine A with a ledger (``ledger_engine_a``),
    each WAL replayed bit-exact on the card, and the ledger's cost on phase
    7's engine (``ledger_turns``). ``device="cpu"`` rehearses it without a
    card (the launch checks and the CPU replay are then skipped)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip-smoke-ledger-")
    try:
        lrun = ledger_engine_l(torch, gbdt_kernel, store, f"{root}/l", device)
        arun = ledger_engine_a(torch, gbdt_kernel, fa, store, f"{root}/a", device)
        turns = ledger_turns(torch, store, f"{root}/turns", device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    result = {"engine_l": lrun, "engine_a": arun, "turns": turns,
              "seconds": time.perf_counter() - t0}
    rp = lrun["replay"]
    log(f"phase 10: [{card}] engine L ({LARGE_ENGINE_FOREST[0]} x {LARGE_ENGINE_FOREST[1]} "
        f"forest): {lrun['rows']} rows noted in {lrun['run_s']:.1f} s, none dropped; "
        f"{lrun['device_steps']} device steps, {lrun['forest_launches']} forest launches; "
        f"replay on {rp['device']}: ok={rp['ok']}, {rp['replayed']} of "
        f"{rp['records_total']} records replayed ({json.dumps(lrun['snapshot_rows_by_path'])} "
        f"with a snapshot), {rp['mismatches']} mismatches, "
        f"{rp['params_fingerprint_mismatch']} fingerprint mismatches, by fingerprint "
        f"{json.dumps(rp['replayed_by_params_fp'])}; {lrun['replay_records_per_s']:.0f} "
        f"records/s; the same WAL replayed on the CPU: {lrun['cpu_replay_mismatches']} "
        "mismatches (not asserted)")
    ra = arun["replay"]
    log(f"phase 10: [{card}] engine A ({arun['frames']} IDX1 frames): {arun['rows']} rows noted, "
        f"none dropped; {arun['device_steps']} device steps, {arun['forest_launches']} forest and "
        f"{arun['forward_launches']} forward launches; replay: session_ok={ra['session_ok']}, "
        f"{ra['session_verified']} of {ra['session_records']} session hashes verified, "
        f"{arun['replay_records_per_s']:.0f} records/s")
    for tr in turns["turns"]:
        w = tr.get("writer")
        log(f"phase 10: [{card}] ledger {'on ' if tr['ledger'] else 'off'}: median "
            f"{statistics.median(tr['rows_per_s']):.0f} rows/s; the RPCs {tr['rpc_s']:.3f} s "
            f"of wall, the process {tr['process_cpu_s']:.3f} s of CPU"
            + (f"; the writer caught up {tr['catch_up_s']:.3f} s after the turn, busy "
               f"{w['writer_busy_s']:.3f} s of wall and {w['writer_cpu_s']:.3f} s of CPU, "
               f"encode {w['encode_us_per_record']:.2f} µs of CPU a record"
               if w else ""))
    log(f"phase 10: the writer: {turns['records_appended']} appended, "
        f"{turns['records_dropped']} dropped of {turns['rows_noted']} noted; fsync p99 "
        f"{turns['fsync_p99_ms']} ms; {turns['wal_bytes_per_record']:.1f} WAL bytes a record")
    log(f"phase 10: {result['seconds']:.1f} s")
    log("phase 10: " + json.dumps(result))
    return result


def ltv_feature_rows(rng, n: int) -> np.ndarray:
    """[n, 25] seeded LTV features of players: tenure, recency, sessions,
    money columns in dollars, counts and flags, each column spread over the
    formulas' thresholds."""
    from igaming_platform_tpu_torch.models.ltv import L, NUM_LTV_FEATURES

    f = np.zeros((n, NUM_LTV_FEATURES), np.float32)
    f[:, L.DAYS_SINCE_REGISTRATION] = rng.exponential(200.0, n)
    f[:, L.DAYS_SINCE_LAST_DEPOSIT] = rng.exponential(20.0, n)
    f[:, L.DAYS_SINCE_LAST_BET] = rng.exponential(12.0, n)
    f[:, L.TOTAL_ACTIVE_DAYS] = rng.integers(0, 300, n)
    f[:, L.SESSIONS_PER_WEEK] = rng.exponential(2.5, n)
    f[:, L.TOTAL_DEPOSITS] = rng.lognormal(6.0, 1.8, n)
    f[:, L.TOTAL_WITHDRAWALS] = f[:, L.TOTAL_DEPOSITS] * rng.random(n) * 1.2
    f[:, L.NET_REVENUE] = f[:, L.TOTAL_DEPOSITS] - f[:, L.TOTAL_WITHDRAWALS]
    f[:, L.DEPOSIT_FREQUENCY] = rng.exponential(2.0, n)
    f[:, L.BET_COUNT] = rng.integers(0, 1000, n)
    f[:, L.GAMES_PLAYED] = rng.integers(0, 12, n)
    f[:, L.BONUSES_CLAIMED] = rng.integers(0, 6, n)
    f[:, L.BONUS_CONVERSION_RATE] = rng.random(n)
    f[:, L.PUSH_ENABLED:L.HAS_VIP_MANAGER + 1] = rng.random((n, 3)) < 0.3
    f[:, L.SUPPORT_TICKETS] = rng.integers(0, 6, n)
    return f


def write_wallet(path: str, rng, n_accounts: int, n_txs: int, now: float) -> None:
    """A SQLite wallet store in the schema the LTV scan reads (accounts
    ``id``, ``created_at``; transactions ``account_id``, ``type``,
    ``amount`` in cents, ``status``, ``created_at``, ``completed_at``),
    written with raw SQL: ``n_accounts`` accounts opened over the last 400
    days, ``n_txs`` transactions over deposit, bet, win, withdraw and
    bonus_grant after each account's opening, 1 in 50 still pending."""
    import sqlite3

    created = now - rng.random(n_accounts) * 400 * 86_400.0
    acct = rng.integers(0, n_accounts, n_txs)
    kinds = np.array(["deposit", "bet", "win", "withdraw", "bonus_grant"])[
        rng.choice(5, n_txs, p=[0.2, 0.5, 0.2, 0.07, 0.03])]
    amounts = rng.lognormal(7.5, 1.5, n_txs).astype(np.int64) + 100
    ts = created[acct] + rng.random(n_txs) * (now - created[acct])
    done = np.where(rng.random(n_txs) < 0.02, "pending", "completed")
    con = sqlite3.connect(path)
    try:
        con.executescript(
            "PRAGMA journal_mode=OFF; PRAGMA synchronous=OFF;"
            "CREATE TABLE accounts (id TEXT PRIMARY KEY, created_at REAL NOT NULL);"
            "CREATE TABLE transactions (id INTEGER PRIMARY KEY, account_id TEXT NOT NULL,"
            " type TEXT NOT NULL, amount INTEGER NOT NULL, status TEXT NOT NULL,"
            " created_at REAL NOT NULL, completed_at REAL);")
        con.executemany("INSERT INTO accounts VALUES (?, ?)",
                        zip((f"acct{i}" for i in range(n_accounts)), created.tolist()))
        con.executemany(
            "INSERT INTO transactions (account_id, type, amount, status, created_at,"
            " completed_at) VALUES (?, ?, ?, ?, ?, ?)",
            zip((f"acct{a}" for a in acct.tolist()), kinds.tolist(), amounts.tolist(),
                done.tolist(), ts.tolist(), (ts + 2.0).tolist()))
        con.commit()
    finally:
        con.close()


def f32_bits(values) -> np.ndarray:
    return np.asarray(values, np.float32).view(np.int32)


def trained_golden(torch, server, config, store, device: str) -> dict:
    """The port's assembly booted from FRAUD_MODEL_PATH=the released golden
    ``.npz``, the golden features scored through its engine: ``score`` and
    ``action`` equal to the committed float32 ones, ``ml_score`` within
    1e-6."""
    with open(f"{GOLDEN_DIR}/released_scores.json") as f:
        golden = json.load(f)
    x = np.load(f"{GOLDEN_DIR}/released_features.npz")["x"]
    assembled = server.assemble_risk_service(config, feature_store=store, device=device)
    try:
        engine = assembled.engine
        if engine.ml_backend != "multitask":
            raise AssertionError(f"golden boot: backend {engine.ml_backend}")
        out = {k: v.cpu().numpy() for k, v in engine.score_arrays(x).items()}
    finally:
        assembled.engine.close()
        assembled.service.close()
    err = float(np.abs(out["ml_score"].astype(np.float64)
                       - np.array(golden["f32"]["ml_score"])).max())
    if not (np.array_equal(out["score"], golden["f32"]["score"])
            and np.array_equal(out["action"], golden["f32"]["action"]) and err <= 1e-6):
        raise AssertionError(f"golden boot: score/action differ or ml_score off by {err}")
    return {"rows": int(x.shape[0]), "ml_score_max_abs_err": err, "trunk": golden["trunk"]}


def trained_ltv(server_svc, codec, ltv_mod, rng, device: str) -> dict:
    """PredictLTV and GetPlayerSegment for LTV_ACCOUNTS accounts through the
    service, its ``ltv_source`` seeded, each answer held to the CPU's
    ``predict_batch`` of the same row alone, as the RPC scores it: integer
    fields exact, floats bit for bit."""
    rows = ltv_feature_rows(rng, LTV_ACCOUNTS)
    server_svc.ltv_source = lambda a: rows[int(a[4:])] if a.startswith("acct") else None
    singles = [ltv_mod.predict_batch(rows[i:i + 1], "cpu") for i in range(LTV_ACCOUNTS)]
    want = {k: np.concatenate([o[k].numpy() for o in singles]) for k in singles[0]}
    ms = {"PredictLTV": [], "GetPlayerSegment": []}
    bad = 0
    for i in range(LTV_ACCOUNTS):
        req = codec.encode(codec.PREDICT_LTV_REQUEST, {"account_id": f"acct{i}"})
        t = time.perf_counter()
        p = codec.decode(codec.PREDICT_LTV_RESPONSE, server_svc.call("PredictLTV", req))
        ms["PredictLTV"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        g = codec.decode(codec.GET_PLAYER_SEGMENT_RESPONSE,
                         server_svc.call("GetPlayerSegment", req))
        ms["GetPlayerSegment"].append((time.perf_counter() - t) * 1e3)
        action = ltv_mod.ACTIONS[int(want["action"][i])]
        ok = (p["account_id"] == g["account_id"] == f"acct{i}"
              and p["segment"] == g["segment"] == int(want["segment"][i])
              and p["predicted_active_days"] == int(want["survival_days"][i])
              and p["next_best_action"] == action and g["recommended_actions"] == [action]
              and p["predicted_at"] is not None
              and f32_bits(p["predicted_ltv"]) == f32_bits(want["ltv"][i])
              and f32_bits(g["ltv"]) == f32_bits(want["ltv"][i])
              and f32_bits(p["churn_risk"]) == f32_bits(g["churn_risk"])
              == f32_bits(want["churn_risk"][i])
              and f32_bits(p["confidence"]) == f32_bits(want["confidence"][i]))
        bad += not ok
    if bad:
        raise AssertionError(f"LTV RPCs: {bad} of {LTV_ACCOUNTS} accounts differ from the CPU")
    server_svc.ltv_source = None
    return {"accounts": LTV_ACCOUNTS, "segments": {int(k): int(v) for k, v in zip(
                *np.unique(want["segment"], return_counts=True))},
            **{f"{m}_p50_ms": float(np.percentile(v, 50)) for m, v in ms.items()},
            **{f"{m}_p99_ms": float(np.percentile(v, 99)) for m, v in ms.items()}}


def ltv_golden(ltv_mod, device: str) -> dict:
    """``predict_batch`` on ``device`` against the committed outputs of the
    JAX service's ``predict_batch_jit`` (``tests/golden/ltv_jit.npz``,
    written on the JAX side by ``tests/test_torch_ltv.py``): every output
    bit for bit, over its rows in one call and over its leading rows one a
    call (XLA's single-row program)."""
    with np.load(os.path.join(GOLDEN_DIR, "ltv_jit.npz")) as z:
        golden = {k: z[k] for k in z.files}
    f = golden["features"]
    singles = golden["single_ltv"].shape[0]
    got = {"batch": ltv_mod.to_host(ltv_mod.predict_batch(f, device))}
    parts = [ltv_mod.to_host(ltv_mod.predict_batch(f[i:i + 1], device)) for i in range(singles)]
    got["single"] = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    differing = {f"{kind}_{k}": int((v.view(np.int32) != golden[f"{kind}_{k}"].view(
        np.int32)).sum()) for kind, out in got.items() for k, v in out.items()}
    if any(differing.values()) or len(differing) != len(golden) - 1:
        raise AssertionError(f"LTV golden: outputs differ from the jit's: {differing}")
    return {"rows": int(f.shape[0]), "single_rows": int(singles), "outputs": len(differing)}


def trained_ltv_job(ltv_job, root: str, rng, device: str) -> dict:
    """The LTV batch job over a written wallet of WALLET_ACCOUNTS accounts
    and WALLET_TXS transactions: one scan (``ltv_features_from_wallet``),
    then the job's device pass and records (``batch_result``, what
    ``run_batch_job`` runs after its scan) on ``device`` and on the CPU over
    that one matrix, records and segments equal; seconds split into scan,
    device pass and records."""
    path = f"{root}/wallet.db"
    t = time.perf_counter()
    write_wallet(path, rng, WALLET_ACCOUNTS, WALLET_TXS, SERVER_NOW)
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    ids, x = ltv_job.ltv_features_from_wallet(path, now=SERVER_NOW)
    timings = {"scan_s": time.perf_counter() - t}
    got = ltv_job.batch_result(ids, x, device, timings)
    cpu_timings = {}
    want = ltv_job.batch_result(ids, x, "cpu", cpu_timings)
    if got["count"] != WALLET_ACCOUNTS or got != want:
        raise AssertionError(f"LTV job: {got['count']} players; differs from the CPU job: "
                             f"{got != want}")
    return {"accounts": WALLET_ACCOUNTS, "transactions": WALLET_TXS, "write_s": write_s,
            "seconds": timings, "cpu_seconds": cpu_timings,
            "segments": {k: len(v) for k, v in sorted(got["segments"].items())}}


def phase_trained(torch, card: str, dense_mod, store, phase7: dict, device: str = "cuda",
                  singles: int = SERVER_SINGLES, batch_rows: int = SERVER_BATCH_ROWS) -> dict:
    """Phase 11, on phase 7's store: the trained multitask backend booted
    from FRAUD_MODEL_PATH and the LTV model. (a) The released golden
    (``trained_golden``). (b) A multitask tree of MULTITASK_TRUNK drawn from
    a seed, saved as an ``.npz`` and booted through the assembly, against a
    CPU twin booted from the same file: SERVER_BATCHES ScoreBatch RPCs of
    ``batch_rows`` rows and ``singles`` ScoreTransaction RPCs, every answer
    bit-equal to the twin's (the dense kernel adds as ``dense_plain``, the
    transcendentals round from float64); the dense kernel's launches equal
    3 a device step (two trunk layers and the fraud head). (c) The LTV RPCs
    (``trained_ltv``), ``predict_batch`` against the jit's golden
    (``ltv_golden``), and (d) the batch job (``trained_ltv_job``).
    ``device="cpu"`` rehearses it without a card (the launch check then
    skipped)."""
    import shutil
    import tempfile

    from igaming_platform_tpu_torch.convert import save_params_tree
    from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
    from igaming_platform_tpu_torch.models import ltv as ltv_mod
    from igaming_platform_tpu_torch.serve import grpc_server, ltv_job, scorer, server
    from igaming_platform_tpu_torch.serve import risk_codec as codec

    t0 = time.perf_counter()
    rng = np.random.default_rng(111)
    bcfg = BatcherConfig(batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0)
    root = tempfile.mkdtemp(prefix="chip-smoke-trained-")
    try:
        golden = trained_golden(torch, server, RiskServiceConfig(
            fraud_model_path=f"{GOLDEN_DIR}/released_multitask.npz", batcher=bcfg), store, device)
        npz = f"{root}/multitask.npz"
        save_params_tree(npz, {"multitask": multitask_tree(rng, MULTITASK_TRUNK)})
        config = RiskServiceConfig(fraud_model_path=npz, batcher=bcfg)
        assembled = server.assemble_risk_service(config, feature_store=store, device=device)
        svc, engine = assembled.service, assembled.engine
        cpu_backend, cpu_params = server.resolve_model_boot(config)
        cpu = scorer.TorchScoringEngine(ml_backend=cpu_backend, params=cpu_params,
                                        batcher_config=bcfg, feature_store=store, device="cpu",
                                        warmup=False)
        cpu_svc = grpc_server.RiskGrpcService(cpu)
        try:
            if engine.ml_backend != "multitask" or cpu.ml_backend != "multitask":
                raise AssertionError(f"boot: {engine.ml_backend}, twin {cpu.ml_backend}")
            batches = [codec.encode(codec.SCORE_BATCH_REQUEST,
                                    {"transactions": server_requests(codec, rng, batch_rows)})
                       for _ in range(SERVER_BATCHES)]
            single_reqs = [codec.encode(codec.SCORE_TRANSACTION_REQUEST, r)
                           for r in server_requests(codec, rng, singles)]
            svc.call("ScoreBatch", batches[0])  # the pipeline's first build off the count
            if device == "cuda":
                torch.cuda.synchronize()

            # The path's run: counts set to 0 just before, read just after.
            dense_mod.dense.launches = 0
            steps0 = engine.device_steps
            single_ms, single_out, batch_s, batch_out = [], [], [], []
            for payload in single_reqs:
                t = time.perf_counter()
                single_out.append(svc.call("ScoreTransaction", payload))
                single_ms.append((time.perf_counter() - t) * 1e3)
            for payload in batches:
                t = time.perf_counter()
                batch_out.append(svc.call("ScoreBatch", payload))
                batch_s.append(time.perf_counter() - t)
            if device == "cuda":
                torch.cuda.synchronize()
            launches = dense_mod.dense.launches
            steps = engine.device_steps - steps0
            if device == "cuda" and (steps == 0 or launches != 3 * steps):
                raise AssertionError(f"trained: {steps} device steps but {launches} dense "
                                     "launches (3 a step)")

            # Every answer against the CPU twin's, bit for bit.
            for payload, out in zip(single_reqs, single_out):
                got, want = (codec.decode(codec.SCORE_TRANSACTION_RESPONSE, b)
                             for b in (out, cpu_svc.call("ScoreTransaction", payload)))
                got["response_time_ms"] = want["response_time_ms"] = 0
                if codec.encode(codec.SCORE_TRANSACTION_RESPONSE, got) != codec.encode(
                        codec.SCORE_TRANSACTION_RESPONSE, want):
                    raise AssertionError(f"trained: a ScoreTransaction differs from the twin: "
                                         f"{got} {want}")
            for payload, out in zip(batches, batch_out):
                rows, got = response_columns(codec, out)
                twin_rows, want = response_columns(codec, cpu_svc.call("ScoreBatch", payload))
                if len(rows) != batch_rows or any(
                        not np.array_equal(f32_bits(got[k]) if k == "ml_score" else got[k],
                                           f32_bits(want[k]) if k == "ml_score" else want[k])
                        for k in want):
                    raise AssertionError("trained: a ScoreBatch answer differs from the twin")
                if any(r["features"] != w["features"] for r, w in zip(rows, twin_rows)):
                    raise AssertionError("trained: the feature echo differs from the twin")
            ltv = trained_ltv(svc, codec, ltv_mod, rng, device)
            ltv["golden"] = ltv_golden(ltv_mod, device)
        finally:
            cpu_svc.close()
            cpu.close()
            assembled.engine.close()
            assembled.service.close()
        job = trained_ltv_job(ltv_job, root, rng, device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    result = {
        "golden": golden, "trunk": list(MULTITASK_TRUNK), "dense_launches": launches,
        "device_steps": steps, "score_batch_rows": batch_rows,
        "score_batch_rows_per_s": [batch_rows / t for t in batch_s],
        "score_transaction_p50_ms": float(np.percentile(single_ms, 50)),
        "score_transaction_p99_ms": float(np.percentile(single_ms, 99)),
        "phase7_mlp_gbdt": {k: phase7.get(k) for k in (
            "score_batch_rows_per_s", "score_transaction_p50_ms", "score_transaction_p99_ms")},
        "ltv_rpcs": ltv, "ltv_job": job, "seconds": time.perf_counter() - t0,
    }
    p7 = result["phase7_mlp_gbdt"]
    log(f"phase 11: [{card}] golden booted from released_multitask.npz: {golden['rows']} rows, "
        f"score and action exact, ml_score within {golden['ml_score_max_abs_err']:.3g}")
    log(f"phase 11: [{card}] multitask {MULTITASK_TRUNK} booted from FRAUD_MODEL_PATH: "
        f"ScoreBatch of {batch_rows} rows x{SERVER_BATCHES}: median "
        f"{statistics.median(result['score_batch_rows_per_s']):.0f} rows/s (phase 7's mlp+gbdt: "
        f"{statistics.median(p7['score_batch_rows_per_s'] or [0]):.0f}); ScoreTransaction "
        f"x{singles}: p50 {result['score_transaction_p50_ms']:.3f} ms, p99 "
        f"{result['score_transaction_p99_ms']:.3f} ms (phase 7: "
        f"{p7['score_transaction_p50_ms'] or 0:.3f}, {p7['score_transaction_p99_ms'] or 0:.3f}); "
        f"{steps} device steps, {launches} dense launches; every answer bit-equal to the CPU "
        "twin booted from the same file")
    log(f"phase 11: [{card}] predict_batch bit-equal to the JAX service's jit on all "
        f"{ltv['golden']['outputs']} outputs of tests/golden/ltv_jit.npz ({ltv['golden']['rows']} "
        f"rows in one call, {ltv['golden']['single_rows']} one a call)")
    log(f"phase 11: [{card}] PredictLTV and GetPlayerSegment x{ltv['accounts']}: bit-equal to "
        f"the CPU's predict_batch of each row; p50 {ltv['PredictLTV_p50_ms']:.3f} and "
        f"{ltv['GetPlayerSegment_p50_ms']:.3f} ms, p99 {ltv['PredictLTV_p99_ms']:.3f} and "
        f"{ltv['GetPlayerSegment_p99_ms']:.3f} ms; segments {json.dumps(ltv['segments'])}")
    js, jc = job["seconds"], job["cpu_seconds"]
    log(f"phase 11: [{card}] LTV job over {job['accounts']} accounts and {job['transactions']} "
        f"transactions (written in {job['write_s']:.1f} s): scan {js['scan_s']:.3f} s, device "
        f"pass {js['device_s']:.3f} s, records {js['records_s']:.3f} s (on the CPU, the same "
        f"scan's matrix: {jc['device_s']:.3f}, {jc['records_s']:.3f}); records and "
        f"segments equal to the CPU job's; segments {json.dumps(job['segments'])}")
    log(f"phase 11: {result['seconds']:.1f} s")
    log("phase 11: " + json.dumps(result))
    return result


# Training and the online loop (phase 12), on phase 7's store. (a) One
# seeded MULTITASK_TRUNK tree trained TRAIN_PARITY_STEPS steps of
# TrainConfig's batch on the card and on the CPU from the same batches;
# (b) fit for FIT_STEPS; (c) run_eval at EVAL_ROWS / EVAL_STEPS (the JAX
# defaults); (d) distillation at DistillConfig's defaults and
# device_parity.run at its defaults; (e) a checkpoint resumed by a
# TrainingLoop for RESUME_STEPS and booted through FRAUD_MODEL_PATH; (f) the
# assembly with ONLINE_LOOP=1 on that model: ONLINE_OUTCOMES outcomes
# posted (ONLINE_HARD_NEGATIVES of them hard negatives), up to ONLINE_TICKS
# ticks, then ScoreBatch rows/s with the loop idle and ticking on its
# thread, ONLINE_TURN_RPCS RPCs a turn. The promotion gates are the JAX
# tests' (tests/test_online_promotion.py), set through PROMOTE_*.
TRAIN_BATCH, TRAIN_PARITY_STEPS, FIT_STEPS, FIT_PROFILE_STEPS = 1024, 5, 400, 20
EVAL_ROWS, EVAL_STEPS = (60_000, 20_000), 400
DISTILL_CFG, PARITY_ROWS, PARITY_STEPS_MT = {}, 40_000, 300  # DistillConfig(**DISTILL_CFG)
RESUME_STEPS = 10
ONLINE_OUTCOMES, ONLINE_HARD_NEGATIVES, ONLINE_TICKS, ONLINE_TURN_RPCS = 512, 128, 8, 5
ONLINE_BATCH_ROWS = SERVER_BATCH_ROWS
PROMOTE_ENV = {"PROMOTE_MIN_AUC": "0.55", "PROMOTE_MAX_AUC_DROP": "0.5",
               "PROMOTE_MIN_SHADOW_ROWS": "8", "PROMOTE_MAX_FLIP_RATE": "1.0",
               "PROMOTE_MIN_POST_AUC": "0.55"}
DENSE_PER_FORWARD = 5  # two trunk layers and three heads


def bf16_bits(t) -> np.ndarray:
    """float32 values that hold bf16 numbers, as their bf16 bit patterns."""
    return (np.asarray(t, np.float32).view(np.int32) >> 16).astype(np.int32)


def seeded_trainer(tree, device: str):
    """A ``Trainer`` at TrainConfig's defaults but TRAIN_BATCH and
    MULTITASK_TRUNK, on ``device``, holding the JAX-layout ``tree`` and a
    fresh Adam state."""
    from igaming_platform_tpu_torch import convert
    from igaming_platform_tpu_torch.train import trainer

    t = trainer.Trainer(trainer.TrainConfig(batch_size=TRAIN_BATCH, trunk=MULTITASK_TRUNK),
                        device=device)
    model = convert.train_multitask_from_tree(tree).to(device)
    t.state = trainer.TrainState(model, trainer.AdamState.zeros(list(model.parameters())), 0)
    return t


def train_parity(torch, dense_mod, tree, device: str) -> dict:
    """(a) The card against the CPU: one tree, the same batches, losses at
    LOSS_RTOL, step-1 weight gradients equal or one bf16 ulp apart, every
    gradient on the card nonzero, 5 dense launches a step."""
    from igaming_platform_tpu_torch.train import data

    runs = {}
    stream = data.make_stream(TRAIN_BATCH, seed=21)
    batches = [next(stream) for _ in range(TRAIN_PARITY_STEPS)]
    for side, dev in (("card", device), ("cpu", "cpu")):
        t = seeded_trainer(tree, dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        dense_mod.dense.launches = 0
        losses, grads = [], None
        for b in batches:
            losses.append(t.train_step(b)["loss"])
            if grads is None:
                grads = [p.grad.detach().cpu().clone() for p in t.state.params.parameters()]
        runs[side] = {"losses": losses, "grads": grads, "launches": dense_mod.dense.launches}
    card, cpu = runs["card"], runs["cpu"]
    if device == "cuda" and card["launches"] != DENSE_PER_FORWARD * TRAIN_PARITY_STEPS:
        raise AssertionError(f"train: {card['launches']} dense launches in "
                             f"{TRAIN_PARITY_STEPS} steps")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    if not np.isfinite(card["losses"]).all() or rel > LOSS_RTOL:
        raise AssertionError(f"train: card losses {card['losses']} against {cpu['losses']}")
    names = [n for n, _ in t.state.params.named_parameters()]
    zero = [n for n, g in zip(names, card["grads"]) if not g.abs().max() > 0]
    if zero:
        raise AssertionError(f"train: no gradient on the card for {zero}")
    one_ulp, bias_err = 0, 0.0
    for n, g, w in zip(names, card["grads"], cpu["grads"]):
        if n.endswith(".w"):
            d = np.abs(bf16_bits(g.numpy()) - bf16_bits(w.numpy()))
            if (d > 1).any():
                raise AssertionError(f"train: {int((d > 1).sum())} step-1 gradients of {n} "
                                     "more than one bf16 ulp from the CPU's")
            one_ulp += int((d == 1).sum())
        else:
            bias_err = max(bias_err, float((g - w).abs().max()))
    return {"losses": card["losses"], "cpu_losses": cpu["losses"], "loss_max_rel": rel,
            "weight_grads_one_ulp": one_ulp,
            "weight_grads": sum(g.numel() for n, g in zip(names, card["grads"])
                                if n.endswith(".w")),
            "bias_grad_max_abs_err": bias_err, "dense_launches": card["launches"]}


def train_fit(torch, dense_mod, tree, device: str):
    """(b) fit for FIT_STEPS on the card: the loss falls, the launches are
    5 a step; wall ms a step, and a FIT_PROFILE_STEPS window's device time
    by kernel. Returns (the trainer, the result)."""
    from igaming_platform_tpu_torch.train import data, trainer

    t = seeded_trainer(tree, device)
    first = next(data.make_stream(TRAIN_BATCH, seed=22))
    with torch.no_grad():
        _, m0 = trainer.loss_and_metrics(t.cfg, t.state.params, *(
            torch.from_numpy(a).to(device) for a in (first.x, first.fraud, first.ltv,
                                                     first.churn)))
    loss0 = float(m0["loss"])
    logged = []
    if device == "cuda":
        torch.cuda.synchronize()
    dense_mod.dense.launches = 0
    t0 = time.perf_counter()
    final = t.fit(FIT_STEPS, data=data.make_stream(TRAIN_BATCH, seed=22), log_every=50,
                  log_fn=lambda step, m: logged.append((step, m["loss"])))
    if device == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dense_mod.dense.launches
    if device == "cuda" and launches != DENSE_PER_FORWARD * FIT_STEPS:
        raise AssertionError(f"fit: {launches} dense launches in {FIT_STEPS} steps")
    if not (np.isfinite(final["loss"]) and final["loss"] < loss0):
        raise AssertionError(f"fit: the loss went from {loss0} to {final['loss']}")
    result = {"steps": FIT_STEPS, "loss_before": loss0, "final": final, "logged": logged,
              "wall_s": wall_s, "wall_ms_per_step": wall_s * 1e3 / FIT_STEPS,
              "dense_launches": launches}
    if device == "cuda":
        stream = data.make_stream(TRAIN_BATCH, seed=23)
        prof = profile_window(torch, lambda: t.fit(FIT_PROFILE_STEPS, data=stream, log_every=0),
                              top=12)
        n = FIT_PROFILE_STEPS
        result["profile"] = {
            "steps": n, "wall_ms_per_step": prof["wall_ms"] / n,
            "device_ms_per_step": None if prof["device_ms"] is None else prof["device_ms"] / n,
            "host_share": None if prof["busy_share"] is None else 1.0 - prof["busy_share"],
            "kernels": [{**k, "device_ms": k["device_ms"] / n, "count": k["count"] / n}
                        for k in prof["top"]]}
    return t, result


def train_eval(torch, device: str) -> dict:
    """(c) run_eval at the JAX defaults, written through the CLI's writer:
    every ordering and eval gate ok."""
    import tempfile

    from igaming_platform_tpu_torch.train import eval as eval_mod

    t0 = time.perf_counter()
    result = eval_mod.run_eval(n_train=EVAL_ROWS[0], n_test=EVAL_ROWS[1], steps=EVAL_STEPS,
                               device=device)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-eval-") as root:
        with open(f"{root}/eval.json", "w") as f:
            json.dump(result, f)
    bad = [k for k, ok in result["ordering"].items() if not ok]
    bad += [k for k, row in result["gates"].items() if not row["ok"]]
    if bad:
        raise AssertionError(f"eval: gates failed {bad}: {json.dumps(result['models'])}")
    return {"models": result["models"], "train": result["train"],
            "ordering": result["ordering"], "gates": result["gates"],
            "seconds": time.perf_counter() - t0}


def train_distill(torch, gbdt_kernel, store, device: str) -> dict:
    """(d) distill_serving_params at its defaults on the card and on the
    CPU (both MAEs); its students serve in a card mlp+gbdt engine held to a
    CPU twin as phase 4 holds its engine; then device_parity.run."""
    from igaming_platform_tpu_torch.convert import params_to
    from igaming_platform_tpu_torch.core.config import BatcherConfig
    from igaming_platform_tpu_torch.serve import scorer
    from igaming_platform_tpu_torch.train import device_parity, distill

    cfg = distill.DistillConfig(**DISTILL_CFG)
    t0 = time.perf_counter()
    params, maes = distill.distill_serving_params(cfg, device=device)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, twin_maes = distill.distill_serving_params(cfg, device="cpu")
    twin_s = time.perf_counter() - t0
    bcfg = BatcherConfig(batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0)
    engine = scorer.TorchScoringEngine(ml_backend="mlp+gbdt", params=params, batcher_config=bcfg,
                                       feature_store=store, device=device)
    cpu = scorer.TorchScoringEngine(ml_backend="mlp+gbdt", params=params_to(params, "cpu"),
                                    batcher_config=bcfg, feature_store=store, device="cpu",
                                    warmup=False)
    try:
        rng = np.random.default_rng(31)
        reqs = [scorer.ScoreRequest(account_id=r["account_id"], amount=r["amount"],
                                    tx_type=r["transaction_type"], ip=r["ip_address"],
                                    device_id=r["device_id"])
                for r in server_requests(None, rng, BATCH_SIZE)]
        if device == "cuda":
            torch.cuda.synchronize()
        gbdt_kernel.gbdt_forest.launches = 0
        responses = engine.score_batch(reqs)
        if device == "cuda":
            torch.cuda.synchronize()
        launches = gbdt_kernel.gbdt_forest.launches
        if device == "cuda" and launches == 0:
            raise AssertionError("distill: the distilled engine launched no forest kernel")
        got, want = engine_columns(responses, reqs, store, cpu)
        unchecked = compare_columns(got, want, "distilled engine")
        bit_equal = int((got["ml_score"].view(np.int32) == want["ml_score"].view(np.int32)).sum())
    finally:
        engine.close()
        cpu.close()
    t0 = time.perf_counter()
    parity = device_parity.run(n_rows=PARITY_ROWS, steps=PARITY_STEPS_MT, device=device)
    parity_s = time.perf_counter() - t0
    if not parity["ok"]:
        raise AssertionError(f"device parity: {json.dumps(parity)}")
    return {"maes": maes, "twin_maes": twin_maes, "card_s": card_s, "twin_s": twin_s,
            "engine_rows": len(reqs), "engine_bit_equal_rows": bit_equal,
            "engine_unchecked_rows": unchecked, "forest_launches": launches,
            "device_parity": parity, "device_parity_s": parity_s}


def twin_rpcs_equal(codec, svc, cpu_svc, rng, n_batches: int, batch_rows: int,
                    singles: int) -> None:
    """ScoreBatch and ScoreTransaction RPCs through a service and its CPU
    twin: every answer bit-equal (response times aside)."""
    for _ in range(n_batches):
        payload = codec.encode(codec.SCORE_BATCH_REQUEST,
                               {"transactions": server_requests(codec, rng, batch_rows)})
        rows, got = response_columns(codec, svc.call("ScoreBatch", payload))
        twin_rows, want = response_columns(codec, cpu_svc.call("ScoreBatch", payload))
        if len(rows) != batch_rows or any(
                not np.array_equal(f32_bits(got[k]) if k == "ml_score" else got[k],
                                   f32_bits(want[k]) if k == "ml_score" else want[k])
                for k in want):
            raise AssertionError("a ScoreBatch answer differs from the CPU twin")
    for r in server_requests(codec, rng, singles):
        payload = codec.encode(codec.SCORE_TRANSACTION_REQUEST, r)
        got, want = (codec.decode(codec.SCORE_TRANSACTION_RESPONSE, b)
                     for b in (svc.call("ScoreTransaction", payload),
                               cpu_svc.call("ScoreTransaction", payload)))
        got["response_time_ms"] = want["response_time_ms"] = 0
        if got != want:
            raise AssertionError(f"a ScoreTransaction differs from the CPU twin: {got} {want}")


def score_batch_rpc(codec, svc, rng, rows: int) -> float:
    """One ScoreBatch RPC of ``rows`` rows; returns its rows/s."""
    payload = codec.encode(codec.SCORE_BATCH_REQUEST,
                           {"transactions": server_requests(codec, rng, rows)})
    t = time.perf_counter()
    svc.call("ScoreBatch", payload)
    return rows / (time.perf_counter() - t)


def plant_outcomes(ledger_mod, directory: str, rng) -> list[dict]:
    """Outcomes for decisions of a WAL: ONLINE_HARD_NEGATIVES of those
    scored at or over review cleared (label 0: hard negatives), a quarter of
    the rest marked fraud, the others cleared."""
    recs = [r for r in ledger_mod.iter_records(directory) if r.features is not None]
    high = [r for r in recs if r.score >= r.review_threshold][:ONLINE_HARD_NEGATIVES]
    low = [r for r in recs if r.score < r.review_threshold][:ONLINE_OUTCOMES - len(high)]
    rows = [{"decision_id": r.decision_id, "label": 0, "source": "dispute_cleared"}
            for r in high]
    rows += [{"decision_id": r.decision_id, "label": int(rng.random() < 0.25),
              "source": "review"} for r in low]
    return rows


def online_assembly(torch, card: str, store, ckpt: str, device: str) -> dict:
    """(e) and (f): the assembly with ONLINE_LOOP=1, LEDGER_DIR and
    FRAUD_MODEL_PATH=the checkpoint, held to a CPU twin booted from the same
    file; outcomes posted; ticks through POST /debug/promotion until a
    promotion, which is ledgered, vaulted and replayed; a rollback, replayed;
    then ScoreBatch rows/s with the loop idle and ticking in turns."""
    import shutil
    import tempfile

    from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
    from igaming_platform_tpu_torch.serve import grpc_server, scorer, server
    from igaming_platform_tpu_torch.serve import ledger as ledger_mod
    from igaming_platform_tpu_torch.serve import risk_codec as codec
    from igaming_platform_tpu_torch.tools import replay

    root = tempfile.mkdtemp(prefix="chip-smoke-online-")
    wal = f"{root}/wal"
    env = {"ONLINE_LOOP": "1", "LEDGER_DIR": wal, "ONLINE_TICK_S": "3600", **PROMOTE_ENV}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    rng = np.random.default_rng(41)
    bcfg = BatcherConfig(batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0)
    config = RiskServiceConfig(fraud_model_path=ckpt, batcher=bcfg)
    # The twin's service first: a service installs the process's drift engine.
    cpu_backend, cpu_params = server.resolve_model_boot(config)
    cpu = scorer.TorchScoringEngine(ml_backend=cpu_backend, params=cpu_params,
                                    batcher_config=bcfg, feature_store=store, device="cpu",
                                    warmup=False)
    cpu_svc = grpc_server.RiskGrpcService(cpu)
    srv = None
    try:
        srv = server.RiskServer(server.assemble_risk_service(config, feature_store=store,
                                                             device=device),
                                grpc_port=-1, http_port=0)
        svc, engine, online, port = srv.service, srv.engine, srv.online, srv.http_port
        if engine.ml_backend != "multitask" or online is None:
            raise AssertionError(f"online: booted {engine.ml_backend}, loop {online}")
        boot_fp = engine.params_fingerprint
        # (e) The checkpoint's answers against the CPU twin, bit for bit.
        twin_rpcs_equal(codec, svc, cpu_svc, rng, 2, ONLINE_BATCH_ROWS, 50)
        if engine.params_fingerprint != boot_fp:
            raise AssertionError("online: the served params changed before any tick")
        # (f) Outcomes, hard negatives planted, through the sidecar: one RPC
        # under a review threshold at the 90th percentile of the scores so
        # far, so that a tenth of its rows are flagged for review, then the
        # thresholds restored.
        if not srv.ledger.flush(30.0):
            raise AssertionError("online: the ledger did not flush")
        p90 = int(np.percentile([r.score for r in ledger_mod.iter_records(wal)], 90))
        block, review = engine.get_thresholds()
        http_call(port, "/debug/thresholds", {"block": max(block, p90 + 1), "review": max(p90, 1)})
        score_batch_rpc(codec, svc, rng, ONLINE_BATCH_ROWS)
        http_call(port, "/debug/thresholds", {"block": block, "review": review})
        if not srv.ledger.flush(30.0):
            raise AssertionError("online: the ledger did not flush")
        outcomes = plant_outcomes(ledger_mod, wal, rng)
        planted = sum(1 for o in outcomes if o["source"] == "dispute_cleared")
        if not planted:
            raise AssertionError("online: no decision flagged for review to clear")
        status, out = http_call(port, "/debug/outcomes", {"outcomes": outcomes})
        if status != 200 or out["accepted"] != len(outcomes) or out["unknown"]:
            raise AssertionError(f"online: outcomes {status} {out}")
        if not srv.ledger.flush(30.0):
            raise AssertionError("online: the ledger did not flush")
        ticks, pinned = [], False
        for _ in range(ONLINE_TICKS):
            status, rep = http_call(port, "/debug/promotion", {"action": "tick"})
            if status != 200:
                raise AssertionError(f"online: tick {status} {rep}")
            ticks.append({"tick_ms": online.last_tick_ms,
                          "split_ms": dict(online.last_tick_split_ms), "history": [
                h["event"] for h in rep["history"]], "gates": rep["last_gate_table"],
                "post_check": rep["last_post_check"]})
            log(f"phase 12: tick {len(ticks)}: {online.last_tick_ms} ms "
                f"{json.dumps(online.last_tick_split_ms)}, gates "
                f"{json.dumps(rep['last_gate_table'])}, post {json.dumps(rep['last_post_check'])}")
            if rep["promotions"]:
                break
            gates = rep["last_gate_table"] or {}
            if not gates.get("drift_quiet", {}).get("ok", True) and not pinned:
                # The drift gate blocks: pin this traffic as the reference.
                status, out = http_call(port, "/debug/driftz", {"action": "pin_reference"})
                if status != 200:
                    raise AssertionError(f"online: pin_reference {status} {out}")
                pinned = True
            score_batch_rpc(codec, svc, rng, ONLINE_BATCH_ROWS)
            if not engine.shadow.drain(30.0):
                raise AssertionError("online: the shadow did not drain")
        report = online.report()
        if not report["miner"]["hard_negatives"]:
            raise AssertionError(f"online: the miner found no hard negative: {report['miner']}")
        promo = report["promotion"]
        if promo["promotions"] != 1 or promo["history"][-1]["event"] != "promote":
            raise AssertionError(f"online: no promotion in {len(ticks)} ticks: "
                                 f"{json.dumps(ticks)}")
        new_fp = promo["history"][-1]["new_fp"]
        if engine.params_fingerprint != new_fp or new_fp == boot_fp:
            raise AssertionError("online: the promoted params do not serve")
        score_batch_rpc(codec, svc, rng, ONLINE_BATCH_ROWS)  # decisions after the boundary
        if not srv.ledger.flush(30.0):
            raise AssertionError("online: the ledger did not flush")
        records = [(r.event, r.old_fp, r.new_fp) for r in ledger_mod.iter_promotions(wal)]
        vault = sorted(os.listdir(f"{wal}/params-vault"))
        if records != [("promote", boot_fp, new_fp)] or not {
                f"{boot_fp}.npz", f"{new_fp}.npz"} <= set(vault):
            raise AssertionError(f"online: ledger {records}, vault {vault}")
        verdict, replay_s = timed_replay(replay, wal, device)
        if not verdict["ok"] or verdict["params_fingerprint_mismatch"] or len(
                verdict["replayed_by_params_fp"]) != 2:
            raise AssertionError(f"online: replay across the promotion: {json.dumps(verdict)}")
        status, rep = http_call(port, "/debug/promotion", {"action": "rollback"})
        if status != 200 or rep["rollbacks"] != 1 or engine.params_fingerprint != boot_fp:
            raise AssertionError(f"online: rollback {status} {rep.get('history')}")
        score_batch_rpc(codec, svc, rng, ONLINE_BATCH_ROWS)
        if not srv.ledger.flush(30.0):
            raise AssertionError("online: the ledger did not flush")
        verdict2, replay2_s = timed_replay(replay, wal, device)
        if not verdict2["ok"] or verdict2["params_fingerprint_mismatch"] or [
                p["event"] for p in verdict2["promotions"]] != ["promote", "rollback"]:
            raise AssertionError(f"online: replay after the rollback: {json.dumps(verdict2)}")

        # ScoreBatch rows/s with the loop idle and ticking on its thread, in
        # turns; the controller paused so that no swap lands in a turn.
        http_call(port, "/debug/promotion", {"action": "pause"})
        online.stop(close_shadow=False)  # the boot's ticker, waiting out ONLINE_TICK_S
        online.tick_s = 0.0
        turns = []
        for on in (False, True, True, False):
            ticks0 = online.ticks
            if on:
                online.start()
            rates = [score_batch_rpc(codec, svc, rng, ONLINE_BATCH_ROWS)
                     for _ in range(ONLINE_TURN_RPCS)]
            if on:
                online.stop(close_shadow=False)
            turns.append({"loop": "ticking" if on else "idle", "rows_per_s": rates,
                          "median": statistics.median(rates), "ticks": online.ticks - ticks0,
                          "last_tick_ms": online.last_tick_ms,
                          "last_tick_split_ms": dict(online.last_tick_split_ms)})
        report = online.report()
    finally:
        if srv is not None:
            srv.shutdown(grace=5.0)
        cpu_svc.close()
        cpu.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    if srv.online._thread is not None:
        raise AssertionError("online: the loop's thread outlived the shutdown")
    return {"ticks": ticks, "drift_pinned": pinned, "outcomes": len(outcomes),
            "hard_negatives_planted": planted, "review_threshold_p90": p90,
            "miner": report["miner"], "learner": report["learner"],
            "promotion": {k: report["promotion"][k] for k in ("promotions", "rollbacks",
                                                               "last_good_probe_auc")},
            "promoted_fp": new_fp, "boot_fp": boot_fp, "vault": vault,
            "replay": {k: verdict[k] for k in ("replayed", "mismatches",
                                               "replayed_by_params_fp")},
            "replay_s": replay_s, "replay_after_rollback_s": replay2_s,
            "turns": turns, "promote_env": PROMOTE_ENV}


def phase_online(torch, card: str, dense_mod, gbdt_kernel, store, device: str = "cuda") -> dict:
    """Phase 12, on phase 7's store: the multitask trainer, evaluation,
    distillation, device parity, checkpoints and the online loop
    (``train_parity``, ``train_fit``, ``train_eval``, ``train_distill``,
    ``online_assembly``). ``device="cpu"`` rehearses it without a card (the
    launch checks then skipped)."""
    import shutil
    import tempfile

    from igaming_platform_tpu_torch.train import checkpoint, loop, trainer

    t0 = time.perf_counter()
    tree = multitask_tree(np.random.default_rng(121), MULTITASK_TRUNK)
    parity = train_parity(torch, dense_mod, tree, device)
    log(f"phase 12: [{card}] {TRAIN_PARITY_STEPS} steps of {TRAIN_BATCH} x {MULTITASK_TRUNK} on "
        f"the card and the CPU: losses agree to {parity['loss_max_rel']:.3g} (relative); "
        f"{parity['weight_grads_one_ulp']} of {parity['weight_grads']} step-1 weight gradients "
        f"one bf16 ulp from the CPU's, none further; bias gradients within "
        f"{parity['bias_grad_max_abs_err']:.3g}; {parity['dense_launches']} dense launches")
    fitted, fit = train_fit(torch, dense_mod, tree, device)
    prof = fit.get("profile", {})
    log(f"phase 12: [{card}] fit {FIT_STEPS} steps: loss {fit['loss_before']:.4f} -> "
        f"{fit['final']['loss']:.4f}, {fit['wall_ms_per_step']:.3f} ms of wall a step; "
        f"profiled {FIT_PROFILE_STEPS} steps: {prof.get('wall_ms_per_step')} ms wall, "
        f"{prof.get('device_ms_per_step')} ms device a step, host share "
        f"{prof.get('host_share')}")
    ev = train_eval(torch, device)
    log(f"phase 12: [{card}] run_eval {EVAL_ROWS} rows, {EVAL_STEPS} steps: every gate ok; "
        f"AUC multitask {ev['models']['multitask_trained']['auc']}, gbdt "
        f"{ev['models']['gbdt_trained']['auc']}, mock {ev['models']['mock']['auc']}, rules "
        f"{ev['models']['rules_only']['auc']}; training s {json.dumps(ev['train'])}")
    dist = train_distill(torch, gbdt_kernel, store, device)
    log(f"phase 12: [{card}] distill_serving_params: MAEs {json.dumps(dist['maes'])} (CPU twin "
        f"{json.dumps(dist['twin_maes'])}), {dist['card_s']:.1f} s (CPU {dist['twin_s']:.1f}); "
        f"served {dist['engine_rows']} rows, {dist['engine_bit_equal_rows']} ml_score bit-equal "
        f"to the CPU twin, {dist['forest_launches']} forest launches; device_parity "
        f"{json.dumps({k: dist['device_parity'][k] for k in ('multitask', 'gbdt', 'ok')})}")

    root = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        checkpoint.save_checkpoint(root, fitted.state)
        resumed = loop.TrainingLoop(config=loop.LoopConfig(
            checkpoint_dir=root, checkpoint_every=RESUME_STEPS, swap_every=0),
            train_config=trainer.TrainConfig(batch_size=TRAIN_BATCH, trunk=MULTITASK_TRUNK),
            device=device)
        if resumed.trainer.state.step != fitted.state.step or not all(
                torch.equal(a, b) for a, b in zip(resumed.trainer.state.params.parameters(),
                                                  fitted.state.params.parameters())):
            raise AssertionError("checkpoint: the resumed trainer is not the saved one")
        resumed.run_steps(RESUME_STEPS)
        ckpt = checkpoint.latest_checkpoint(root)
        if resumed.checkpoints != 1 or not ckpt.endswith(
                f"step_{fitted.state.step + RESUME_STEPS:08d}.npz"):
            raise AssertionError(f"checkpoint: resumed loop wrote {ckpt}")
        online_run = online_assembly(torch, card, store, ckpt, device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    turns = online_run["turns"]
    log(f"phase 12: [{card}] ONLINE_LOOP=1 on the resumed checkpoint: answers bit-equal to the "
        f"CPU twin; {online_run['outcomes']} outcomes ({online_run['hard_negatives_planted']} "
        f"hard negatives) -> promotion in {len(online_run['ticks'])} ticks "
        f"({[t['tick_ms'] for t in online_run['ticks']]} ms), ledgered, vaulted, replayed with "
        f"0 mismatches ({online_run['replay']['replayed']} records), rolled back and replayed; "
        f"ScoreBatch rows/s " + ", ".join(f"{t['loop']} {t['median']:.0f} ({t['ticks']} ticks)"
                                         for t in turns))
    result = {"parity": parity, "fit": fit, "eval": ev, "distill": dist, "online": online_run,
              "dense_launches": parity["dense_launches"] + fit["dense_launches"],
              "forest_launches": dist["forest_launches"], "seconds": time.perf_counter() - t0}
    log(f"phase 12: {result['seconds']:.1f} s")
    log("phase 12: " + json.dumps(result, default=str))
    return result


# Phase 13: the operations plane on phase 7's store.
PLANE_MIX_SINGLES, PLANE_MIX_BATCHES, PLANE_MIX_LTV, PLANE_MIX_ABUSE = 40, 3, 3, 10
PLANE_SINGLES = 500  # ScoreTransaction latency under bulk load
PLANE_TURN_BATCHES, PLANE_TURN_SINGLES = 5, 100  # a turn of the plane's cost
PLANE_WATCHDOG_S = 2.0  # the drill's watchdog (the default, DEVICE_STEP_DEADLINE_S, is 30 s)
PLANE_WEDGE_MS = 3000  # the drill's stalled readbacks: the collect, its hedge, the rebuild's first
PLANE_DEGRADED = 8  # ScoreTransactions answered while the engine rebuilds
PLANE_PROFILE_S = 1.0
PLANE_ANNOTATE_ROWS = 4096


def http_text(port: int, path: str) -> tuple[int, str]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def exposition(text: str) -> dict[str, float]:
    """Prometheus text -> {sample with its labels: value}, exemplars dropped."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.split(" # ")[0].rsplit(" ", 1)
            out[key] = float(value)
    return out


def plane_assembly(server, config, tree, store, abuse_params, device: str, env: dict):
    """``assemble_risk_service`` as a user boots it, under ``env`` (the
    process's environment restored after)."""
    from igaming_platform_tpu_torch.convert import from_jax_params

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return server.assemble_risk_service(
            config, ml_backend="mlp+gbdt", params=from_jax_params("mlp+gbdt", tree),
            feature_store=store, abuse_params=abuse_params, device=device)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bulk_traffic(svc, rpc_error, batches: list, stop) -> dict:
    """ScoreBatch RPCs back to back until ``stop`` is set, a shed honouring
    its ``grpc-retry-pushback-ms`` as a client would: RPCs answered and
    shed."""
    out = {"rpcs": 0, "sheds": 0}
    i = 0
    while not stop.is_set():
        try:
            svc.call("ScoreBatch", batches[i % len(batches)])
            out["rpcs"] += 1
        except rpc_error as exc:
            out["sheds"] += 1
            stop.wait(float(dict(exc.trailing).get("grpc-retry-pushback-ms", 250)) / 1e3)
        i += 1
    return out


def timed_calls(svc, method: str, payloads: list, codes: dict | None = None) -> list[float]:
    """Milliseconds of each answered call; every call's status code counted
    in ``codes`` by (method, code), sheds included."""
    from igaming_platform_tpu_torch.serve.grpc_server import RpcAbort

    ms = []
    for payload in payloads:
        t = time.perf_counter()
        try:
            svc.call(method, payload)
            code = "OK"
            ms.append((time.perf_counter() - t) * 1e3)
        except RpcAbort as exc:
            code = exc.code.name
        if codes is not None:
            codes[(method, code)] = codes.get((method, code), 0) + 1
    return ms


def plane_drill(torch, svc, engine, store, codec, singles, batch, gbdt_kernel, dense_mod,
                device: str) -> dict:
    """The supervisor drill on the default assembly: stalled readbacks
    (``device.readback`` wedges, a host-side stall: the card stays healthy)
    trip the watchdog; the answers while the engine rebuilds (its first
    warm-up readback stalled too) are the heuristic tier's on the same rows;
    the rebuild's warm-up launches the forest and dense kernels; the breaker
    closes."""
    from igaming_platform_tpu_torch.serve import chaos, grpc_server, supervisor
    from igaming_platform_tpu_torch.serve.scorer import ScoreRequest

    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated() if cuda else 0
    gbdt_kernel.gbdt_forest.launches = 0
    dense_mod.dense.launches = 0
    sup = engine.supervisor
    # A short watchdog for the drill alone: under full load a host stall (a
    # profiler's trace export) can hold a step past 2 s without a fault.
    watchdog, engine._watchdog_s = engine._watchdog_s, PLANE_WATCHDOG_S
    if sup.state != supervisor.SERVING:
        raise AssertionError(f"drill: the supervisor is {sup.snapshot()} before the fault")
    # Three stalled readbacks: the batch's collect and its hedge, then the
    # rebuild's first warm-up step, so the degraded tier answers while the
    # device is still stalled (a rebuild on a healthy card takes a fraction
    # of a second).
    chaos.install(f"seed=13;device.readback=wedge:p=1.0:ms={PLANE_WEDGE_MS}:count=3")
    t_trip = time.perf_counter()
    try:
        svc.call("ScoreTransaction", singles[0][1])
        raise AssertionError("drill: a wedged readback answered")
    except grpc_server.RpcAbort as exc:
        if exc.code.name != "UNAVAILABLE" or dict(exc.trailing).get(
                "grpc-retry-pushback-ms") is None:
            raise AssertionError(f"drill: {exc.code.name} {exc.trailing}") from exc
    tripped_s = time.perf_counter() - t_trip
    if sup.breaker("device").state == supervisor.CLOSED:
        raise AssertionError("drill: the device breaker did not open")
    # A ScoreBatch while the circuit is open: the heuristic tier on the
    # rows the store decodes and gathers.
    x, bl = store.decode_gather(batch)
    want = supervisor.heuristic_scores(x, bl, engine.get_thresholds())
    _, got = response_columns(codec, engine.score_batch_wire_bytes(batch)[0])
    if engine.rebuilds == 0 and not all(np.array_equal(got[k], want[k]) for k in (
            "score", "action", "rule_score", "reason_mask", "ml_score")):
        raise AssertionError("drill: the degraded ScoreBatch is not the heuristic tier's")
    # Degraded answers, each against the heuristic tier on the same rows.
    thresholds = engine.get_thresholds()
    degraded = int(engine.rebuilds == 0)
    for fields, payload in singles[1:1 + PLANE_DEGRADED]:
        got = codec.decode(codec.SCORE_TRANSACTION_RESPONSE, svc.call("ScoreTransaction",
                                                                       payload))
        if "DEGRADED_CPU_HEURISTIC" not in got["reason_codes"]:
            continue  # the rebuild finished first
        x, bl = store.gather_batch([ScoreRequest(
            account_id=fields["account_id"], amount=fields["amount"],
            tx_type=fields["transaction_type"], ip=fields["ip_address"],
            device_id=fields["device_id"])])
        want = supervisor.heuristic_scores(x, bl, thresholds)
        if (got["score"], got["action"], got["rule_score"]) != (
                int(want["score"][0]), int(want["action"][0]), int(want["rule_score"][0])) \
                or np.float32(got["ml_score"]) != want["ml_score"][0]:
            raise AssertionError(f"drill: degraded answer {got} is not the heuristic's {want}")
        degraded += 1
    if degraded == 0:
        raise AssertionError("drill: no degraded answer while the engine rebuilt")
    deadline = time.monotonic() + 60
    while engine.rebuilds < 1 and time.monotonic() < deadline:
        time.sleep(0.02)
    if engine.rebuilds != 1:
        raise AssertionError(f"drill: {engine.rebuilds} rebuilds")
    rebuilt_s = time.perf_counter() - t_trip
    chaos.clear()
    probes, close_by = 0, time.monotonic() + 20
    while sup.breaker("device").state != supervisor.CLOSED and time.monotonic() < close_by:
        # Each probe on another account: one account's calls meet its rate limit.
        svc.call("ScoreTransaction", singles[1 + PLANE_DEGRADED + probes % (
            len(singles) - 1 - PLANE_DEGRADED)][1])
        probes += 1
        time.sleep(0.01)
    closed_s = time.perf_counter() - t_trip
    engine._watchdog_s = watchdog
    if sup.breaker("device").state != supervisor.CLOSED or sup.state != supervisor.SERVING:
        raise AssertionError(f"drill: after {probes} probes {sup.snapshot()}, probes out "
                             f"{sup.breaker('device')._probes_out}")
    if cuda:
        torch.cuda.synchronize()
    forest, dense = gbdt_kernel.gbdt_forest.launches, dense_mod.dense.launches
    return {"tripped_s": tripped_s, "rebuilt_s": rebuilt_s, "trip_to_closed_s": closed_s,
            "degraded_answers": degraded, "probes": probes, "forest_launches": forest,
            "dense_launches": dense, "rebuilds": engine.rebuilds,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20 if cuda else None,
            "before_mib": mem0 / 2**20, "supervisor": sup.snapshot()["state"]}


def phase_plane(torch, card: str, gbdt_kernel, fa, dense_mod, store, device: str = "cuda") -> dict:
    """Phase 13, on phase 7's store: the risk server assembled as a user boots
    it (supervisor, SLO engine, deadline plane, drift; ``mlp+gbdt`` and the
    detector; ``DEVICE_STEP_DEADLINE_S`` short for the drill) behind the HTTP
    sidecar. The RPC mix, then ``/metrics``: the request counters by method
    and code equal the RPCs sent, the ``risk_score`` count the rows scored,
    one flight entry a root. A ``risk-deadline-ms: 0`` call sheds, counted;
    ScoreTransaction latency under 16,384-row ScoreBatch load; the
    supervisor drill; ``/debug/profilez`` under traffic; the plane's cost,
    the default assembly against ``SUPERVISOR=0 SLO=0`` in turns, and a
    4096-row step's device time with and without ``annotate``. Every part
    logs its line as it ends.
    ``device="cpu"`` rehearses it without a card (the launch and profiler
    checks then skipped)."""
    import threading

    from igaming_platform_tpu_torch.convert import from_jax_params, sequence_from_tree
    from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
    from igaming_platform_tpu_torch.models.sequence import SeqConfig
    from igaming_platform_tpu_torch.obs import flight, tracing
    from igaming_platform_tpu_torch.obs.perfmodel import device_step_time
    from igaming_platform_tpu_torch.serve import grpc_server, scorer, server
    from igaming_platform_tpu_torch.serve import risk_codec as codec

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    rng = np.random.default_rng(130)
    tree = server_tree(22)
    seq_cfg = SeqConfig(**ABUSE_CFG)
    abuse_tree = seq_tree(rng, ABUSE_CFG)
    config = RiskServiceConfig(batcher=BatcherConfig(
        batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0))
    # The plane off first: its SLO=0 uninstalls the process's SLO engine,
    # which the default assembly then installs.
    off = plane_assembly(server, config, tree, store, sequence_from_tree(abuse_tree, seq_cfg),
                         device, {"SUPERVISOR": "0", "SLO": "0"})
    on = plane_assembly(server, config, tree, store, sequence_from_tree(abuse_tree, seq_cfg),
                        device, {})
    srv = server.RiskServer(on, grpc_port=-1, http_port=0)
    svc, engine, det = on.service, on.engine, on.abuse
    cpu = scorer.TorchScoringEngine(ml_backend="mlp+gbdt", params=from_jax_params("mlp+gbdt", tree),
                                    batcher_config=config.batcher, feature_store=store,
                                    device="cpu", warmup=False)
    stop = threading.Event()
    try:
        fields = server_requests(codec, rng, PLANE_SINGLES + PLANE_MIX_SINGLES + 64)
        singles = [(f, codec.encode(codec.SCORE_TRANSACTION_REQUEST, f)) for f in fields]
        batches = [codec.encode(codec.SCORE_BATCH_REQUEST, {
            "transactions": server_requests(codec, rng, SERVER_BATCH_ROWS)}) for _ in range(4)]
        ltv = [codec.encode(codec.PREDICT_LTV_REQUEST, {"account_id": f"acct{a}"})
               for a in rng.integers(0, SERVER_ACCOUNTS, PLANE_MIX_LTV)]
        segment = [codec.encode(codec.GET_PLAYER_SEGMENT_REQUEST, {"account_id": f"acct{a}"})
                   for a in rng.integers(0, SERVER_ACCOUNTS, PLANE_MIX_LTV)]
        checked = [f"acct{a}" for a in rng.integers(0, SERVER_ACCOUNTS, PLANE_MIX_ABUSE)]
        for acct in checked:
            for i in range(int(rng.integers(5, 64))):
                det.record_event(acct, int(rng.integers(500, 200_000)), "bet",
                                 device_id=f"dev{rng.integers(0, 300_000)}",
                                 timestamp=SERVER_NOW - 3600.0 + 30.0 * i)
        abuse = [codec.encode(codec.CHECK_BONUS_ABUSE_REQUEST, {"account_id": a}) for a in checked]
        inner = engine.inner
        for e in (engine, off.engine):  # the pipelines' first build, off the counts and SLO
            e.score_batch_wire_bytes(batches[0])
        if cuda:
            torch.cuda.synchronize()

        # The plane's cost, off, on, on, off: ScoreBatch turns first, before
        # any interactive call arms the burn-shed gate, then ScoreTransaction
        # turns.
        turns = []
        for name in ("off", "on", "on", "off"):
            tsvc = off.service if name == "off" else svc
            codes: dict = {}
            bs = [SERVER_BATCH_ROWS / ms * 1e3 for ms in timed_calls(
                tsvc, "ScoreBatch", batches[:1] * PLANE_TURN_BATCHES, codes)]
            turns.append({"plane": name, "rows_per_s": bs,
                          "median_rows_per_s": statistics.median(bs) if bs else None,
                          "sheds": sum(n for (_, c), n in codes.items() if c != "OK")})
        for turn in turns:
            tsvc = off.service if turn["plane"] == "off" else svc
            st = timed_calls(tsvc, "ScoreTransaction",
                             [p for _, p in singles[1:1 + PLANE_TURN_SINGLES]])
            turn["st_p99_ms"] = float(np.percentile(st, 99))

        annotate = {}
        if cuda:
            # The step alone on device inputs: the score function and the
            # packed result, as ``_enqueue`` runs it.
            xs, bls = store.decode_gather(batches[3])
            params, thr = inner.get_params(), inner.thresholds_snapshot()[0]
            xd = torch.from_numpy(xs[:PLANE_ANNOTATE_ROWS]).to(device)
            bld = torch.from_numpy(bls[:PLANE_ANNOTATE_ROWS]).to(device)

            def plain():
                with torch.inference_mode():
                    scorer._stack_packed(inner._score_fn(params, xd, bld, thr))

            def annotated():
                with tracing.annotate("score_step"), torch.inference_mode():
                    scorer._stack_packed(inner._score_fn(params, xd, bld, thr))

            # Events around launches queued behind a sleep kernel: the device
            # time, not the host's enqueue of about 90 launches.
            with torch.cuda.stream(inner.stream):
                for name, fn in (("plain", plain), ("annotate", annotated),
                                 ("annotate", annotated), ("plain", plain)):
                    annotate.setdefault(name, []).append(device_ms(torch, fn))
            annotate["host_enqueue_bound"] = device_step_time(plain, stream=inner.stream) * 1e3

        log(f"phase 13: [{card}] the plane's cost in turns: " + "; ".join(
            f"{t['plane']} {t['median_rows_per_s']} rows/s ({t['sheds']} shed), ST p99 "
            f"{t['st_p99_ms']:.3f} ms" for t in turns)
            + f"; 4096-row step device ms {json.dumps(annotate)}")

        # The RPC mix, its counts set to 0 just before and read just after.
        mix_singles = singles[-PLANE_MIX_SINGLES:]
        gbdt_kernel.gbdt_forest.launches = 0
        dense_mod.dense.launches = 0
        fa.flash_attention_fwd.launches = 0
        before = exposition(http_text(srv.http_port, "/metrics")[1])
        flight.DEFAULT_RECORDER.clear()
        steps0, fwd0 = engine.device_steps, det.device_steps
        sent: dict = {}
        timed_calls(svc, "ScoreTransaction", [p for _, p in mix_singles], sent)
        timed_calls(svc, "ScoreBatch", batches[:PLANE_MIX_BATCHES], sent)
        timed_calls(svc, "PredictLTV", ltv, sent)
        timed_calls(svc, "GetPlayerSegment", segment, sent)
        timed_calls(svc, "CheckBonusAbuse", abuse, sent)
        if cuda:
            torch.cuda.synchronize()
        mix_launches = {"forest": gbdt_kernel.gbdt_forest.launches,
                        "dense": dense_mod.dense.launches,
                        "attention": fa.flash_attention_fwd.launches,
                        "device_steps": engine.device_steps - steps0,
                        "forwards": det.device_steps - fwd0}
        status, text = http_text(srv.http_port, "/metrics")
        after = exposition(text)

        def delta(key: str) -> float:
            return after.get(key, 0.0) - before.get(key, 0.0)

        rows = (sent.get(("ScoreTransaction", "OK"), 0)
                + sent.get(("ScoreBatch", "OK"), 0) * SERVER_BATCH_ROWS)
        for (method, code), n in sent.items():
            got = delta(f'risk_grpc_requests_total{{code="{code}",method="{method}"}}')
            if got != n:
                raise AssertionError(f"plane: {method} {code} counted {got}, sent {n}")
        if delta("risk_risk_score_count") != rows or delta("risk_txns_scored_total") != rows:
            raise AssertionError(f"plane: risk_score counted {delta('risk_risk_score_count')}, "
                                 f"{rows} rows scored")
        entries = flight.DEFAULT_RECORDER.snapshot()
        if len(entries) != sum(sent.values()) or {e["method"] for e in entries} != {
                m for m, _ in sent}:
            raise AssertionError(f"plane: {len(entries)} flight entries for "
                                 f"{sum(sent.values())} roots")
        breakdown = flight.stage_breakdown(entries, "ScoreBatch")
        if cuda and (mix_launches["forest"] != mix_launches["device_steps"]
                     or mix_launches["forest"] == 0
                     or mix_launches["dense"] != len(tree["mlp"]["layers"]) * mix_launches[
                         "device_steps"]
                     or mix_launches["attention"] != seq_cfg.n_layers * mix_launches["forwards"]
                     or mix_launches["attention"] == 0):
            raise AssertionError(f"plane: launches {mix_launches}")

        stages = breakdown.get("stages", {})
        mix_sent = {f"{m} {c}": n for (m, c), n in sent.items()}
        log(f"phase 13: [{card}] RPC mix {json.dumps(mix_sent)}: /metrics counters "
            "equal the RPCs sent by method and code, "
            f"risk_score counted {rows} rows, {len(entries)} flight entries; ScoreBatch stage p50 "
            "(ms): " + ", ".join(f"{k} {v.get('p50_ms')}" for k, v in sorted(stages.items())))

        # Deadlines: a spent budget sheds at admission, counted.
        expired0 = exposition(http_text(srv.http_port, "/metrics")[1]).get(
            'risk_deadline_expired_total{stage="admission"}', 0.0)
        try:
            svc.call("ScoreTransaction", singles[0][1], (("risk-deadline-ms", "0"),))
            raise AssertionError("plane: a spent deadline was scored")
        except grpc_server.RpcAbort as exc:
            if exc.code.name != "DEADLINE_EXCEEDED" or not exc.shed:
                raise AssertionError(f"plane: a spent deadline answered {exc.code.name}") from exc
        expired = exposition(http_text(srv.http_port, "/metrics")[1]).get(
            'risk_deadline_expired_total{stage="admission"}', 0.0) - expired0
        if expired != 1:
            raise AssertionError(f"plane: {expired} admission sheds counted")

        # ScoreTransaction under bulk load, and /debug/profilez under traffic.
        hedged0, yields0 = inner._batcher.batches_hedged, inner.lane_gate.yields
        bulk: dict = {}
        bulk_thread = threading.Thread(target=lambda: bulk.update(bulk_traffic(
            svc, grpc_server.RpcAbort, batches, stop)), daemon=True)
        bulk_thread.start()
        status, prof = http_call(srv.http_port, f"/debug/profilez?seconds={PLANE_PROFILE_S}")
        if status != 200:
            raise AssertionError(f"plane: profilez {status} {prof}")
        kernels = prof["kernels"]
        forest_events = sum(n for k, n in kernels.items() if "gbdt_forest_kernel" in k)
        dense_events = sum(n for k, n in kernels.items() if "dense_fixed_kernel" in k)
        if cuda and (forest_events == 0 or dense_events == 0):
            raise AssertionError(f"plane: the profile caught {prof['kernel_events']} kernel "
                                 f"events, forest {forest_events}, dense {dense_events}")
        depths, st_ms = [], []
        for i, (_, payload) in enumerate(singles[1:1 + PLANE_SINGLES]):
            t = time.perf_counter()
            svc.call("ScoreTransaction", payload)
            st_ms.append((time.perf_counter() - t) * 1e3)
            if i % 25 == 0:
                depths.append(inner.deadline_snapshot()["lanes"])
        stop.set()
        bulk_thread.join(60)
        stop.clear()
        deadline_snap = inner.deadline_snapshot()
        loaded = {"p50_ms": float(np.percentile(st_ms, 50)),
                  "p99_ms": float(np.percentile(st_ms, 99)), "bulk": bulk,
                  "max_lane_depth": {lane: max(d[lane] for d in depths) for lane in depths[0]},
                  "batches_hedged": deadline_snap["batches_hedged"] - hedged0,
                  "lane_gate_yields": deadline_snap["lane_gate_yields"] - yields0,
                  "expired_shed": deadline_snap["expired_shed"],
                  "dead_dispatched": deadline_snap["dead_dispatched"]}

        log(f"phase 13: [{card}] risk-deadline-ms 0 shed as DEADLINE_EXCEEDED, counted; "
            f"ScoreTransaction x{PLANE_SINGLES} under {SERVER_BATCH_ROWS}-row ScoreBatch load: p50 "
            f"{loaded['p50_ms']:.3f} ms, p99 {loaded['p99_ms']:.3f} ms; bulk {json.dumps(bulk)}; "
            f"max lane depths {json.dumps(loaded['max_lane_depth'])}; bulk dispatches that yielded "
            f"to an interactive batch {loaded['lane_gate_yields']}; batches_hedged "
            f"{loaded['batches_hedged']}")
        log(f"phase 13: [{card}] /debug/profilez?seconds={PLANE_PROFILE_S} under traffic: "
            f"{prof['kernel_events']} kernel events, gbdt_forest_kernel {forest_events}, "
            f"dense_fixed_kernel {dense_events}")

        # The supervisor drill; the first engine's answers kept to hold the
        # rebuilt one's to.
        _, first = response_columns(codec, engine.score_batch_wire_bytes(batches[2])[0])
        drill = plane_drill(torch, svc, engine, store, codec, singles[-40:], batches[1],
                            gbdt_kernel, dense_mod, device)
        shapes = len(engine.inner._shapes)
        if cuda and (drill["forest_launches"] < 2 * shapes
                     or drill["dense_launches"] < 2 * shapes * len(tree["mlp"]["layers"])):
            raise AssertionError(f"drill: the rebuild's warm-up launched {drill}")
        # The rebuilt engine: bit-equal to the first engine on the card, and
        # to the CPU twin as phase 7 holds the card to it (the forest's card
        # sum is not bit-equal to the CPU's, PERF.md §6).
        x, bl = store.decode_gather(batches[2])
        want = {k: v.numpy() for k, v in cpu.score_arrays(x, bl).items()}
        _, got = response_columns(codec, engine.score_batch_wire_bytes(batches[2])[0])
        differing = sum(int((got[k] != first[k]).sum()) for k in ("score", "action", "rule_score",
                                                                   "reason_mask"))
        differing += int((got["ml_score"].view(np.int32) != first["ml_score"].view(np.int32)).sum())
        if differing:
            raise AssertionError(f"drill: {differing} values of the rebuilt engine's answers "
                                 "differ from the first engine's")
        drill["cpu_twin_boundary_rows"] = compare_columns(got, want, "drill")
        log(f"phase 13: [{card}] drill: UNAVAILABLE with pushback after {drill['tripped_s']:.3f} s, "
            f"{drill['degraded_answers']} degraded answers equal to heuristic_scores, rebuilt at "
            f"{drill['rebuilt_s']:.3f} s (warm-up: {drill['forest_launches']} forest, "
            f"{drill['dense_launches']} dense launches), breaker closed at "
            f"{drill['trip_to_closed_s']:.3f} s; answers then bit-equal to the first engine's "
            f"and within phase 7's tolerance of the CPU twin ({drill['cpu_twin_boundary_rows']} "
            "floor-boundary rows not compared); peak "
            f"device memory {drill['peak_mib']} MiB (before {drill['before_mib']:.1f})")

    finally:
        stop.set()
        cpu.close()
        srv.shutdown(grace=5.0)
        off.engine.close()
        off.service.close()
    result = {"mix": {"sent": mix_sent,
                      "launches": mix_launches, "rows": rows,
                      "scoreBatch_stage_breakdown": breakdown},
              "deadline": {"admission_sheds": expired, **loaded}, "drill": drill,
              "profilez": {"kernel_events": prof["kernel_events"], "forest": forest_events,
                           "dense": dense_events, "seconds": prof["seconds"]},
              "turns": turns, "annotate_step_ms": annotate,
              "forest_launches": mix_launches["forest"] + drill["forest_launches"],
              "dense_launches": mix_launches["dense"] + drill["dense_launches"],
              "attention_launches": mix_launches["attention"],
              "seconds": time.perf_counter() - t_phase}
    log(f"phase 13: {result['seconds']:.1f} s")
    log("phase 13: " + json.dumps(result, default=str))
    return result


# Phase 7 alone in a fresh process of the checkout it runs in, printing one
# "TURN " JSON line: for ``phase7_turns``.
_PHASE7_TURN = r"""
import inspect, json, statistics, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as c
from igaming_platform_tpu_torch.ops import _build, gbdt_kernel
from igaming_platform_tpu_torch.ops import flash_attention as fa
from igaming_platform_tpu_torch.serve import native_store
torch.backends.cuda.matmul.allow_tf32 = False
_build.build(["gbdt_forest", "flash_attention_fwd"])
card = c.nvidia_smi_line()
if "filled" in inspect.signature(c.phase_server).parameters:
    t = time.perf_counter()
    filled = (*c.fill_native_store(native_store, c.SERVER_NOW), time.perf_counter() - t)
    r = c.phase_server(torch, card, gbdt_kernel, fa, filled)
else:
    r = c.phase_server(torch, card, gbdt_kernel, fa)
print("TURN " + json.dumps({"median": statistics.median(r["score_batch_rows_per_s"]),
    "rows_per_s": r["score_batch_rows_per_s"], "st_p50": r["score_transaction_p50_ms"],
    "st_p99": r["score_transaction_p99_ms"], "card": card}))
"""


def phase7_turns(parent: str, turns: str = "pccppc") -> list[dict]:
    """Phase 7 of two checkouts in turns on one card, each run in its own
    process: ``p`` runs the checkout at ``parent`` (a ``git archive`` unpack
    of the parent commit, whose ``phase_server`` may fill its own store),
    ``c`` this one. Returns the runs' medians and latencies in turn order.
    Run it as ``python3 -c "import chip_smoke as c; c.phase7_turns('dir')"``."""
    runs = []
    for turn in turns:
        where = parent if turn == "p" else "."
        out = subprocess.run([sys.executable, "-c", _PHASE7_TURN], cwd=where,
                             capture_output=True, text=True, check=False)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("TURN ")]
        if out.returncode or not lines:
            raise AssertionError(f"phase 7 in {where}: exit {out.returncode}\n"
                                 + out.stderr[-3000:])
        runs.append({"checkout": "parent" if turn == "p" else "change",
                     **json.loads(lines[0][5:])})
        log(f"phase 7 turn {len(runs)}: " + json.dumps(runs[-1]))
    return runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from igaming_platform_tpu_torch.ops import _build, gbdt_kernel
    from igaming_platform_tpu_torch.ops import dense as dense_mod
    from igaming_platform_tpu_torch.ops import flash_attention as fa

    # Phase 1: environment.
    card = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase 1: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # Phase 2: build every kernel, one nvcc each, started together.
    t0 = time.perf_counter()
    report = _build.build(["gbdt_forest", "flash_attention_fwd", "flash_attention_bwd",
                           "dense_fixed", "mma_rate", "mma_probe"])
    log(f"phase 2: built in {time.perf_counter() - t0:.1f} s")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"phase 2: {name}: {line.strip()}")

    # Phase 3: each kernel against its plain version.
    floor = phase_launch_floor(torch)
    rows = phase_kernels(torch, gbdt_kernel)
    dense_rows = phase_dense(torch, dense_mod, floor)
    dense_f32_rows = phase_dense(torch, dense_mod, floor, f32=True)
    numerics_run = phase_device_numerics(torch)
    invariance = phase_batch_invariance(torch, gbdt_kernel, dense_mod)
    mma_rates = phase_mma_rate(torch)
    probe = phase_mma_probe(torch)
    flash_rows = phase_flash(torch, fa)
    bwd_rows = phase_flash_bwd(torch, fa)

    # Phase 4: the scoring engine's path; phase 5: the bonus-abuse path.
    engine = phase_engine(torch, card, gbdt_kernel)
    abuse_run = phase_abuse(torch, card, fa)
    # Phase 6: the abuse detector's training path.
    train_run = phase_train(torch, card, fa)
    # Phase 7: the risk.v1 serving front; phase 8: its index path and
    # session state, on the same store.
    from igaming_platform_tpu_torch.serve import native_store

    t0 = time.perf_counter()
    filled = (*fill_native_store(native_store, SERVER_NOW), time.perf_counter() - t0)
    server_run = phase_server(torch, card, gbdt_kernel, fa, filled)
    # Phase 13: the operations plane, on the same store while the process is
    # young (the profiler's capture is part of it).
    plane_run = phase_plane(torch, card, gbdt_kernel, fa, dense_mod, filled[0])
    index_run = phase_index(torch, card, gbdt_kernel, fa, filled[0],
                            statistics.median(server_run["score_batch_rows_per_s"]))
    # Phase 9: the score step's variants (int8, drift, shadow), same store.
    variants_run = phase_variants(torch, card, gbdt_kernel, fa, filled[0])
    # Phase 10: the decision ledger and replay, same store.
    ledger_run = phase_ledger(torch, card, gbdt_kernel, fa, filled[0])
    # Phase 11: the trained multitask model booted from FRAUD_MODEL_PATH,
    # the LTV RPCs and the LTV batch job, same store.
    trained_run = phase_trained(torch, card, dense_mod, filled[0], server_run)
    # Phase 12: the multitask trainer, distillation, evaluation, device
    # parity, checkpoints and ONLINE_LOOP=1, same store.
    online_run = phase_online(torch, card, dense_mod, gbdt_kernel, filled[0])

    main_row = next(r for r in rows if (r["T"], r["D"], r["B"]) == (64, 4, BATCH_SIZE))
    flash_main = next(r for r in flash_rows if (r["BH"], r["S"], r["Dh"]) == FLASH_MAIN_SHAPE)
    bwd_main = next(r for r in bwd_rows if (r["BH"], r["S"], r["Dh"]) == FLASH_BWD_MAIN_SHAPE)
    dense_main = next(r for r in dense_rows if (r.get("B"), r.get("K"), r.get("N"))
                      == DENSE_MAIN_SHAPE)
    f32_main = next(r for r in dense_f32_rows if (r["B"], r["K"], r["N"]) == DENSE_F32_MAIN_SHAPE)
    kernels = {"kernels": [{
        "name": "gbdt_forest", "route": "cuda",
        "source": "igaming_platform_tpu_torch/csrc/gbdt_forest.cu",
        "replaces": "igaming_platform_tpu/ops/pallas/gbdt_kernel.py:52",
        "launches": engine["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None,
        "back_to_back_ms": main_row["kernel_b2b_ms"], "launch_floor_ms": floor,
        "batch_invariance": invariance,
        "launches_gbdt_engine_1000x6": engine["gbdt_engine_1000x6"]["launches"],
        "launches_server": server_run["launches"],
        "launches_index": index_run["a"]["forest_launches"] + index_run["b"]["forest_launches"],
        "launches_variants": (variants_run["int8_engine"]["forest_launches"]
                              + variants_run["session_engine"]["forest_launches"]),
        "launches_ledger": (ledger_run["engine_l"]["forest_launches"]
                            + ledger_run["engine_a"]["forest_launches"]),
        "launches_distilled": online_run["forest_launches"],
        "launches_plane": plane_run["forest_launches"],
        "shapes": rows,
    }, {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "igaming_platform_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "igaming_platform_tpu/ops/pallas/flash_attention.py:85",
        "also_replaces": "igaming_platform_tpu/ops/pallas/flash_attention.py:142",
        "launches": abuse_run["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        "ms": flash_main["kernel_ms"], "plain_ms": flash_main["plain_ms"],
        "bound_ms": flash_main["bound_ms"], "bound_by": flash_main["bound_by"],
        "library_ms": flash_main["library_ms"],
        "mma_sync_tflops": mma_rates,
        "mma_probe": probe,
        "launches_server": server_run["forward_launches"],
        "launches_index": index_run["a"]["forward_launches"],
        "launches_variants": variants_run["session_engine"]["forward_launches"],
        "launches_ledger": ledger_run["engine_a"]["forward_launches"],
        "launches_plane": plane_run["attention_launches"],
        "shapes": flash_rows,
    }, *({
        "name": f"flash_attention_bwd_{part}", "route": "cuda",
        "source": "igaming_platform_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": f"igaming_platform_tpu/ops/pallas/flash_attention.py:{line}",
        "launches": train_run[f"launches_{part}"],
        "max_abs_err": max(r[f"max_abs_err_{part}"] for r in bwd_rows),
        "ms": bwd_main[f"{part}_ms"], "plain_ms": bwd_main["plain_ms"],
        "bound_ms": bwd_main[f"{part}_bound_ms"], "bound_by": bwd_main[f"{part}_bound_by"],
        "library_ms": bwd_main["library_ms"],
        "plain_and_library_compute": "dQ, dK and dV together",
        "shapes": bwd_rows,
    } for part, line in (("dq", 251), ("dkv", 261))), {
        "name": "dense_bf16", "route": "cuda",
        "source": "igaming_platform_tpu_torch/csrc/dense_fixed.cu",
        "replaces": None,
        "repair": ("not a TPU kernel: the bf16 dense of igaming_platform_tpu/models/mlp.py:64-74 "
                   "(_dense, compiled by XLA), in a sum order that no batch size changes, in "
                   "place of cuBLAS's float32 sgemm, whose order follows M"),
        "launches": (engine["dense_launches"] + trained_run["dense_launches"]
                     + online_run["dense_launches"]),
        "launches_engine": engine["dense_launches"],
        "launches_trained": trained_run["dense_launches"],
        "launches_train": online_run["dense_launches"],
        "launches_plane": plane_run["dense_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in dense_rows if "max_abs_err" in r),
        "ms": dense_main["kernel_ms"], "plain_ms": dense_main["plain_ms"],
        "bound_ms": dense_main["bound_ms"], "bound_by": dense_main["bound_by"],
        "library_ms": dense_main["library_ms"],
        "library": "torch.matmul of the same bf16-rounded float32 operands (TF32 off)",
        "back_to_back_ms": dense_main["kernel_b2b_ms"], "launch_floor_ms": floor,
        "batch_invariance": {k: invariance[k] for k in ("dense", "cublas_sgemm", "engine",
                                                         "session_head_transformer")},
        "device_numerics": numerics_run,
        "shapes": dense_rows,
    }, {
        "name": "dense_f32", "route": "cuda",
        "source": "igaming_platform_tpu_torch/csrc/dense_fixed.cu",
        "replaces": None,
        "repair": ("not a TPU kernel: the float32 x @ w + b of the sequence model's layers "
                   "(igaming_platform_tpu/models/sequence.py, compiled by XLA), in a sum order "
                   "that no batch size changes, each product rounded before it is added, in "
                   "place of cuBLAS's float32 sgemm, whose order follows M"),
        "launches": abuse_run["dense_f32_launches"],
        "launches_server": server_run["dense_f32_launches"],
        "launches_index": index_run["a"]["dense_f32_launches"],
        "launches_train": train_run["launches_dense_f32"],
        "max_abs_err": max(r["max_abs_err"] for r in dense_f32_rows),
        "ms": f32_main["kernel_ms"], "plain_ms": f32_main["plain_ms"],
        "bound_ms": f32_main["bound_ms"], "bound_by": f32_main["bound_by"],
        "library_ms": f32_main["library_ms"],
        "library": "torch.addmm of the same float32 operands (TF32 off)",
        "back_to_back_ms": f32_main["kernel_b2b_ms"],
        "batch_invariance": invariance["stages"],
        "shapes": dense_f32_rows,
    }]}
    log(json.dumps(kernels))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
