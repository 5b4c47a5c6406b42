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
   stream through a CPU bridge and detector (in a child process that drains
   beside the card's bridge); then ``check()`` latency,
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
    loop idle and ticking;
13. and 14. the operations plane, on phase 7's store (``phase_plane``,
    ``phase_plane2``);
15. the wallet side (``phase_platform``): the single-binary ``PlatformApp``
    (``mlp+gbdt`` at phase 4's widths, the detector at serving width) against
    its CPU twin on 1,000 operations (outcomes, gate scores, abuse scores);
    a SQLite store of 100,000 accounts and 3,000 operations over 600 of
    them (operations/s, latency by kind, a deposit's split, reconcile with 0
    mismatches, every outbox row relayed); and 2,500 operations whose events
    reach the risk service's bridge over AMQP through a broker outage (every
    event consumed once, the ``amqp`` breaker sees it, feature rows equal to
    an in-process twin); every gate swallowed nothing and every launch is
    counted against the steps and checks;
16. the stores of record and the wallet's own front (``phase_stores``): the
    port's Postgres rig (``platform/pg_testing.py``) over a file of 100,000
    accounts; ``WalletServer`` over it with its gate on the card, 2,000
    wallet.v1 operations through ``WalletGrpcService.call`` against the same
    operations over SQLite on the card and over SQLite on the CPU (answers,
    gate scores, ops/s and latency by kind), reconciled over the wire and
    counted on ``/metrics``; ``LEDGER_SINK=pg`` on the same rig (every noted
    row in ``risk_decisions`` or dropped, equal to the WAL); the LTV job over
    ``postgres://`` and ``sqlite://`` (bit-equal); the batch refresh of phase
    7's store from the rig and from a ClickHouse stand-in behind a row-mode
    and an IDX1 engine, held to CPU twins; ``FEATURE_STORE=redis`` refused
    and the Redis store over a dict-backed client against a CPU twin; forest
    and dense launches against the steps;
17. multi-device serving and the fleet (``phase_multi_device``), on phase
    7's store, over LOGICAL meshes whose shards all run on the one card (the
    sharded layouts and arithmetic, no interconnect, no multi-GPU speed):
    the routed backend over data=2 x expert=4 against its unsharded engine,
    a CPU twin and single RPCs; phase 7's engine data- and model-sharded;
    slot-sharded IDX1 with session state over data=4 against the unsharded
    engine, every shard live and CLOCK evicting, state gathered bit-equal; ring and Ulysses abuse scoring over
    seq=4 against the dense detector; the multi-host front over gloo with a
    follower process (killed, degraded, resurrected); three replicas behind
    the affinity picker with the fleet view;
18. multi-device training (``phase_train_mesh``) over logical meshes of the
    one card: ``train_abuse_detector`` over data=2 x seq=2 in Ulysses mode at
    its defaults (the attention kernels, forward and backward, on every head
    shard; losses against phase 6's dense run, launches counted) and in ring
    mode for 20 steps (no attention kernel); the multitask ``Trainer`` at its
    defaults over data=2 and data=2 x model=2 against an unsharded card
    trainer (tests/test_train.py's bounds, replicas equal, dense launches
    counted); ``PPTrainer`` over model=4 against its sequential path; the
    routed ensemble trained at its defaults (a CPU twin, held-out AUC above
    the untrained bundle's), served by a card routed engine bit-equal to
    ``routed_prob``, and ``gbdt_raw_matmul`` bit-equal to the forest kernel.

Any failure exits non-zero. Before the ``kernels`` JSON object a
``phase_times`` line gives every phase's wall seconds. The second-to-last
lines are the ``kernels`` JSON object and the card's name and power limit;
the last line is the result object. With no card, or outside the repository, it exits non-zero
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

T_START = time.perf_counter()  # the script's start, for the phase_times line's total

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
ML_HIGH_RISK_BIT = 8  # the reason mask's ML_HIGH_RISK bit (set where ml_score > 0.7)
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
ABUSE_ACCOUNTS, ABUSE_MAX_EVENTS = 1_200, 64  # the drain sets most of the script's time
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


def compare_columns(got: dict, want: dict, what: str = "engine", atol: float = ML_ATOL,
                    split_sum: bool = False) -> int:
    """Result columns of the card against the CPU engine's on the same rows:
    rule_score and reason_mask exact, ml_score within ``atol``, score and
    action exact except on rows within 1e-4 of a floor boundary whose
    ml_score differs. Returns the number of such rows.

    ``split_sum`` (a model sharded over the mesh, whose float sums run in
    another order) widens a differing row's floor window by 60 times its
    ml_score difference, the most that difference moves its score, and
    excuses the ML_HIGH_RISK bit of a row whose two ml_scores lie on the
    two sides of 0.7; such rows count among the returned ones."""
    if not (np.isfinite(got["ml_score"]).all() and (got["ml_score"] >= 0).all()
            and (got["ml_score"] <= 1).all() and (got["score"] >= 0).all()
            and (got["score"] <= 100).all()):
        raise AssertionError(f"{what}: scores out of range")
    straddle = split_sum & (np.minimum(got["ml_score"], want["ml_score"]) <= 0.7) & (
        np.maximum(got["ml_score"], want["ml_score"]) > 0.7)
    excused_bit = np.where(straddle, 1 << ML_HIGH_RISK_BIT, 0)
    if not np.array_equal(got["rule_score"], want["rule_score"]):
        raise AssertionError(f"{what}: rule_score differs from the CPU engine")
    if not np.array_equal(got["reason_mask"] | excused_bit, want["reason_mask"] | excused_bit):
        raise AssertionError(f"{what}: reason_mask differs from the CPU engine")
    ml_err = float(np.abs(got["ml_score"] - want["ml_score"]).max())
    if ml_err > atol:
        raise AssertionError(f"{what}: ml_score differs from the CPU engine by {ml_err}")
    pre = 0.4 * want["rule_score"] + 60.0 * want["ml_score"].astype(np.float64) + 1e-4
    same_ml = got["ml_score"].view(np.int32) == want["ml_score"].view(np.int32)
    window = 1e-4
    if split_sum:
        window = window + 60.0 * np.abs(got["ml_score"].astype(np.float64) - want["ml_score"])
    checked = (np.abs(pre - np.round(pre)) > window) | same_ml
    for key in ("score", "action"):
        if not np.array_equal(got[key][checked], want[key][checked]):
            raise AssertionError(f"{what}: {key} differs from the CPU engine")
    return int(((~checked) | straddle).sum())


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
    detector with ``model``, on ``device``, with the stream, (type, JSON)
    pairs, published."""
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
    for kind, raw in stream:
        b.broker.publish_raw("wallet.events", kind, raw)
    return b


def abuse_model(rng):
    """Phase 5's detector model, drawn first from ``rng`` (seeded 7)."""
    from igaming_platform_tpu_torch.convert import sequence_from_tree
    from igaming_platform_tpu_torch.models.sequence import SeqConfig

    cfg = SeqConfig(**ABUSE_CFG)
    return sequence_from_tree(seq_tree(rng, ABUSE_CFG), cfg), cfg


def abuse_cpu_twin(path: str) -> None:
    """Phase 5's CPU twin, in a process of its own so that it drains beside
    the card's bridge: reads (stream, accounts, sample) from ``path + ".in"``,
    drains the stream through a CPU bridge and detector, and writes what
    phase 5 holds the card to into ``path + ".out"``."""
    import pickle

    from igaming_platform_tpu_torch.serve import events as events_mod

    with open(path + ".in", "rb") as f:
        stream, accounts, sample = pickle.load(f)
    cpu = abuse_bridge("cpu", abuse_model(np.random.default_rng(7))[0], stream)
    t = time.perf_counter()
    cpu.drain()
    drain_s = time.perf_counter() - t
    cdet = cpu.abuse_detector
    out = {"drain_s": drain_s,
           "counts": (cpu.events_processed, cpu.events_skipped, cpu.events_deduped),
           "risk_events": published(events_mod, cpu.broker),
           "history": cdet._history_matrix(accounts, 64),
           "scores": np.concatenate([cdet.check_batch(accounts[i:i + ABUSE_BATCH])
                                     for i in range(0, len(accounts), ABUSE_BATCH)]),
           "checks": [cdet.check(a) for a in sample]}
    cpu.engine.close()
    with open(path + ".out", "wb") as f:
        pickle.dump(out, f)


class ChildTwin:
    """A CPU twin in a child process, beside the card's work: ``fn`` (a
    function of this script taking a path) reads its input, pickled at
    ``path + ".in"``, and writes its answers to ``path + ".out"``. ``start``
    starts it, ``result`` waits for it (killing it on a timeout) and reads
    its answers, ``close`` kills it if it still runs."""

    def __init__(self, fn: str, payload, what: str, threads: int | None = None):
        import pickle
        import tempfile

        self.fn, self.what, self.threads = fn, what, threads
        self.dir = tempfile.mkdtemp(prefix=f"chip-smoke-{what}-")
        self.path = os.path.join(self.dir, "twin")
        with open(self.path + ".in", "wb") as f:
            pickle.dump(payload, f)
        self.proc = None

    def start(self) -> None:
        self.log = open(self.path + ".log", "wb")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); import chip_smoke as c; "
             + (f"import torch; torch.set_num_threads({self.threads}); " if self.threads else "")
             + f"c.{self.fn}(sys.argv[1])", self.path],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=self.log,
            stderr=subprocess.STDOUT)

    def result(self, timeout: float = 600.0) -> dict:
        import pickle

        rc = self.proc.wait(timeout=timeout)
        if rc != 0:
            with open(self.path + ".log", "rb") as f:
                tail = f.read()[-3000:].decode(errors="replace")
            raise AssertionError(f"{self.what}: the CPU twin exited {rc}: {tail}")
        return self.result_file()

    def result_file(self) -> dict:
        import pickle

        with open(self.path + ".out", "rb") as f:
            return pickle.load(f)

    def close(self) -> None:
        import shutil

        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if self.proc is not None:
            self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


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
    model, cfg = abuse_model(rng)
    stream = [(ev.type, ev.to_json()) for ev in wallet_stream(events_mod)]
    accounts = [f"acct{a}" for a in range(ABUSE_ACCOUNTS)]
    sample = accounts[:: ABUSE_ACCOUNTS // ABUSE_CHECKS]
    gpu = abuse_bridge("cuda", model, stream)
    # The same stream through the CPU bridge and detector, in a process of
    # its own that drains beside the card's bridge.
    twin = ChildTwin("abuse_cpu_twin", (stream, accounts, sample), "abuse")
    det = gpu.abuse_detector
    try:
        det.check_batch(accounts[:ABUSE_BATCH])  # first forward off the count
        torch.cuda.synchronize()
        twin.start()

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

        cpu = twin.result()
        cpu_drain_s = cpu["drain_s"]
        counts = [(gpu.events_processed, gpu.events_skipped, gpu.events_deduped),
                  tuple(cpu["counts"])]
        risk_events = [published(events_mod, gpu.broker), cpu["risk_events"]]
        if drained != len(stream) or counts[0] != counts[1] or risk_events[0] != risk_events[1]:
            raise AssertionError(f"abuse: bridge counts {counts} or risk events "
                                 f"({len(risk_events[0])} vs {len(risk_events[1])}) differ")
        if not np.array_equal(det._history_matrix(accounts, 64), cpu["history"]):
            raise AssertionError("abuse: histories differ between the card and the CPU")
        want = cpu["scores"]
        if scores.shape != (ABUSE_ACCOUNTS,) or not np.isfinite(scores).all() \
                or scores.min() < 0 or scores.max() > 1:
            raise AssertionError("abuse: scores out of range")
        score_err = float(np.abs(scores - want).max())
        if score_err > ABUSE_ATOL:
            raise AssertionError(f"abuse: scores differ from the CPU by {score_err}")
        near = 0
        for acct, (score, signals, linked), (cscore, csignals, clinked) in zip(
                sample, checks, cpu["checks"]):
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
        gpu.engine.close()
        twin.close()

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
    result["losses"] = metrics["losses"]  # phase 18 holds its sharded runs to them
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


def message_without(payload: bytes, field: int) -> bytes:
    """A message's bytes without ``field`` (every occurrence)."""
    from igaming_platform_tpu_torch.serve import risk_codec as codec

    n, pos, out = len(payload), 0, []
    while pos < n:
        start = pos
        key, pos = codec._read_varint(payload, pos, n)
        pos = codec._skip(payload, pos, n, key & 7)
        if key >> 3 != field:
            out.append(payload[start:pos])
    return b"".join(out)


SERVER_BURST = 32  # concurrent ScoreTransaction callers on one channel (phase 7)
SERVER_IN_PROCESS_SINGLES = 100  # phase 7's in-process floor on the same server


def phase_server(torch, card: str, gbdt_kernel, fa, filled: tuple) -> dict:
    """The risk.v1 serving front on the card, over the wire: the native store
    at deployment size, ``assemble_risk_service`` with the ``mlp+gbdt``
    backend and the abuse detector at serving width, ``RiskServer`` with its
    gRPC port (the port's own transport, ``serve/grpc_wire.py``) and HTTP
    sidecar bound, and the RPC mix sent through the port's client over
    loopback, requests built and responses read by the port's own codec.
    Every ScoreBatch answer is held to a CPU engine on the same gathered
    rows; the forest's launches must equal the device steps and the
    forward's layers x forwards. Then health and reflection over gRPC, an
    RPC whose deadline has passed (DEADLINE_EXCEEDED), SERVER_BURST
    concurrent ScoreTransaction callers on one channel (each answer
    byte-equal to the in-process answer, response_time_ms aside), and the
    in-process floor on the same server: SERVER_IN_PROCESS_SINGLES singles
    and one ScoreBatch through ``RiskGrpcService.call``."""
    from concurrent.futures import ThreadPoolExecutor

    from igaming_platform_tpu_torch.convert import from_jax_params, sequence_from_tree
    from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
    from igaming_platform_tpu_torch.models.sequence import SeqConfig
    from igaming_platform_tpu_torch.ops import dense as dense_mod
    from igaming_platform_tpu_torch.serve import grpc_server, grpc_wire, scorer, server, wire
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
    srv = server.RiskServer(assembled, grpc_port=0, http_port=0)
    svc, engine, det = assembled.service, assembled.engine, assembled.abuse
    channel = grpc_wire.insecure_channel(f"localhost:{srv.grpc_port}")
    stub = grpc_server.make_risk_stub(channel)
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
        # The pipeline's first build and the channel's dial, off the count.
        stub.ScoreBatch(batches[0], timeout=120)
        torch.cuda.synchronize()

        # The path's run, over the wire: counts set to 0 just before, read
        # just after.
        gbdt_kernel.gbdt_forest.launches = 0
        fa.flash_attention_fwd.launches = 0
        dense_mod.dense_f32.launches = 0
        steps0, fwd0 = engine.device_steps, det.device_steps
        single_ms, batch_s, split, abuse_ms, batch_out = [], [], None, [], []
        single_out = []
        for payload in singles:
            t = time.perf_counter()
            single_out.append(stub.ScoreTransaction(payload, timeout=30))
            single_ms.append((time.perf_counter() - t) * 1e3)
        pipe = engine._host_pipeline
        for payload in batches:
            busy0 = dict(pipe.stats()["stage_busy_ms"])
            t = time.perf_counter()
            batch_out.append(stub.ScoreBatch(payload, timeout=120))
            batch_s.append(time.perf_counter() - t)
            if split is None:
                busy = pipe.stats()["stage_busy_ms"]
                split = {k: busy[k] - busy0[k] for k in busy}
        for payload in abuse_reqs:
            t = time.perf_counter()
            stub.CheckBonusAbuse(payload, timeout=30)
            abuse_ms.append((time.perf_counter() - t) * 1e3)
        bl_resp = codec.decode(codec.ADD_TO_BLACKLIST_RESPONSE, stub.AddToBlacklist(
            codec.encode(codec.ADD_TO_BLACKLIST_REQUEST, {"type": "device", "value": "dev-smoke"}),
            timeout=30))
        hit = codec.decode(codec.CHECK_BLACKLIST_RESPONSE, stub.CheckBlacklist(
            codec.encode(codec.CHECK_BLACKLIST_REQUEST, {"device_id": "dev-smoke"}), timeout=30))
        stub.UpdateThresholds(codec.encode(codec.UPDATE_THRESHOLDS_REQUEST,
                                           {"block_threshold": 1, "review_threshold": 0}),
                              timeout=30)
        thresholds = codec.decode(codec.GET_THRESHOLDS_RESPONSE,
                                  stub.GetThresholds(b"", timeout=30))
        blocked = codec.decode(codec.SCORE_TRANSACTION_RESPONSE,
                               stub.ScoreTransaction(singles[0], timeout=30))
        stub.UpdateThresholds(codec.encode(codec.UPDATE_THRESHOLDS_REQUEST,
                                           {"block_threshold": 80, "review_threshold": 50}),
                              timeout=30)
        features = codec.decode(codec.GET_FEATURES_RESPONSE, stub.GetFeatures(
            codec.encode(codec.GET_FEATURES_REQUEST, {"account_id": "acct1"}), timeout=30))
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

        # Health and reflection over gRPC; a deadline already spent.
        served = codec.decode(codec.HEALTH_CHECK_RESPONSE, grpc_server.make_health_stub(
            channel).Check(codec.encode(codec.HEALTH_CHECK_REQUEST, {"service": ""}), timeout=30))
        listed = list(channel.stream_stream(
            "/grpc.reflection.v1alpha.ServerReflection/ServerReflectionInfo")(
                iter([b"\x3a\x00", b"\x3a\x00"]), timeout=30))
        if served["status"] != grpc_server.SERVING or len(listed) != 2 or not all(
                b"risk.v1.RiskService" in m and b"grpc.health.v1.Health" in m for m in listed):
            raise AssertionError(f"server: health {served} or reflection {listed}")
        try:
            stub.ScoreTransaction(singles[1], timeout=0.0)
            expired = "OK"
        except grpc_wire.RpcError as exc:
            expired = exc.code().name
        if expired != "DEADLINE_EXCEEDED":
            raise AssertionError(f"server: a spent grpc-timeout answered {expired}")
        # SERVER_BURST callers at once on the one channel, each answer
        # byte-equal to the in-process answer to the same request.
        burst = singles[:SERVER_BURST]
        t = time.perf_counter()
        with ThreadPoolExecutor(SERVER_BURST) as pool:
            burst_out = list(pool.map(lambda p: stub.ScoreTransaction(p, timeout=60), burst))
        burst_s = time.perf_counter() - t
        differ = sum(message_without(w, 6) != message_without(g, 6) for w, g in zip(
            (svc.call("ScoreTransaction", p) for p in burst), burst_out))
        if differ:
            raise AssertionError(f"server: {differ} of {len(burst)} burst answers differ from "
                                 "the in-process answers")
        # The floor, in-process on the same server: singles and one batch.
        local_ms = []
        for payload in singles[:SERVER_IN_PROCESS_SINGLES]:
            t = time.perf_counter()
            svc.call("ScoreTransaction", payload)
            local_ms.append((time.perf_counter() - t) * 1e3)
        # The wire's batches and singles burn the SLO's fast window (it counts
        # ScoreBatch against 50 ms): the floor's batch is a measurement, held
        # clear of the burn gate.
        svc.burn_gate.enabled = False
        t = time.perf_counter()
        local_batch = svc.call("ScoreBatch", batches[1])
        local_batch_s = time.perf_counter() - t
        svc.burn_gate.enabled = True
        if ([without_time(e) for e in router_entries(local_batch)]
                != [without_time(e) for e in router_entries(batch_out[1])]):
            raise AssertionError("server: the in-process ScoreBatch answer differs from the wire's")
        wire_stats = {
            "single_request_bytes": int(np.mean([len(p) for p in singles])),
            "single_response_bytes": int(np.mean([len(p) for p in single_out])),
            "batch_request_bytes": len(batches[1]), "batch_response_bytes": len(batch_out[1]),
            "wire_single_p50_ms": float(np.percentile(single_ms, 50)),
            "wire_single_p99_ms": float(np.percentile(single_ms, 99)),
            "wire_batch_rows_per_s": [SERVER_BATCH_ROWS / t for t in batch_s],
            "in_process_single_p50_ms": float(np.percentile(local_ms, 50)),
            "in_process_single_p99_ms": float(np.percentile(local_ms, 99)),
            "in_process_batch_rows_per_s": SERVER_BATCH_ROWS / local_batch_s,
            "burst_callers": SERVER_BURST, "burst_calls": len(burst),
            "burst_calls_per_s": len(burst) / burst_s,
        }
    finally:
        channel.close()
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
        "ready": ready[1], "wire": wire_stats,
    }
    log(f"phase 7: [{card}] over the wire (the port's gRPC transport, loopback): ScoreTransaction "
        f"x{SERVER_SINGLES} p50 {wire_stats['wire_single_p50_ms']:.3f} ms, p99 "
        f"{wire_stats['wire_single_p99_ms']:.3f} ms ({wire_stats['single_request_bytes']} B in, "
        f"{wire_stats['single_response_bytes']} B out); ScoreBatch of {SERVER_BATCH_ROWS} rows "
        f"x{SERVER_BATCHES}: median {statistics.median(wire_stats['wire_batch_rows_per_s']):.0f} "
        f"rows/s ({wire_stats['batch_request_bytes']} B in, {wire_stats['batch_response_bytes']} "
        f"B out); in-process on the same server: ScoreTransaction x{SERVER_IN_PROCESS_SINGLES} "
        f"p50 {wire_stats['in_process_single_p50_ms']:.3f} ms, p99 "
        f"{wire_stats['in_process_single_p99_ms']:.3f} ms; one ScoreBatch "
        f"{wire_stats['in_process_batch_rows_per_s']:.0f} rows/s; {SERVER_BURST} callers on one "
        f"channel: {wire_stats['burst_calls']} calls at {wire_stats['burst_calls_per_s']:.0f}/s, "
        "answers byte-equal to in-process (response_time_ms aside); health SERVING, reflection "
        "list_services x2 on one stream, a spent grpc-timeout DEADLINE_EXCEEDED")
    log(f"phase 7: [{card}] one ScoreBatch RPC's host split (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + f"; the RPC's wall {batch_s[0] * 1e3:.3f}")
    log(f"phase 7: [{card}] CheckBonusAbuse x{SERVER_ABUSE_CHECKS}: p50 "
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
    # The same WAL replayed on the CPU (not asserted: a card's WAL differs
    # there in ml_score bits) runs in a child process beside engine A and the
    # ledger turns; phase_ledger collects it.
    cpu_twin = None
    if device == "cuda":
        cpu_twin = ChildTwin("ledger_cpu_replay", directory, "ledger", threads=2)
        cpu_twin.start()
    return {"rows": rows, "snapshot_rows_by_path": by_path, "run_s": run_s,
            "device_steps": steps, "forest_launches": launches, "ledger": stats,
            "fingerprints": fps, "replay": {k: verdict[k] for k in (
                "ok", "records_total", "replayed", "replayed_by_params_fp", "mismatches",
                "params_fingerprint_mismatch", "device")},
            "replay_s": replay_s, "replay_records_per_s": verdict["records_total"] / replay_s,
            "cpu_replay_twin": cpu_twin}


def ledger_cpu_replay(path: str) -> None:
    """Phase 10's WAL (the directory pickled at ``path + ".in"``) replayed on
    the CPU, in a child process (``ChildTwin``): its mismatches and seconds."""
    import pickle

    from igaming_platform_tpu_torch.tools import replay

    with open(path + ".in", "rb") as f:
        directory = pickle.load(f)
    verdict, secs = timed_replay(replay, directory, "cpu")
    with open(path + ".out", "wb") as f:
        pickle.dump({"mismatches": verdict["mismatches"], "ok": verdict["ok"], "seconds": secs}, f)


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
    twin = None
    try:
        lrun = ledger_engine_l(torch, gbdt_kernel, store, f"{root}/l", device)
        twin = lrun.pop("cpu_replay_twin")
        arun = ledger_engine_a(torch, gbdt_kernel, fa, store, f"{root}/a", device)
        turns = ledger_turns(torch, store, f"{root}/turns", device)
        cpu = twin.result() if twin is not None else {}
        lrun.update({"cpu_replay_mismatches": cpu.get("mismatches"),
                     "cpu_replay_ok": cpu.get("ok"), "cpu_replay_s": cpu.get("seconds")})
    finally:
        if twin is not None:
            twin.close()
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
        f"mismatches (not asserted), {lrun['cpu_replay_s']} s in a child process")
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


def distill_cpu_twin(path: str) -> None:
    """Phase 12's distillation on the CPU (``DistillConfig(**cfg)``, the
    pickled input), for its MAEs: in a child process beside the card's
    phase 12 (``ChildTwin``)."""
    import pickle

    from igaming_platform_tpu_torch.train import distill

    with open(path + ".in", "rb") as f:
        cfg = pickle.load(f)
    t0 = time.perf_counter()
    _, maes = distill.distill_serving_params(distill.DistillConfig(**cfg), device="cpu")
    with open(path + ".out", "wb") as f:
        pickle.dump({"maes": maes, "seconds": time.perf_counter() - t0}, f)


def train_distill(torch, gbdt_kernel, store, device: str, twin=None) -> dict:
    """(d) distill_serving_params at its defaults on the card and on the
    CPU (both MAEs; the CPU's in ``twin``, a ``ChildTwin`` of
    ``distill_cpu_twin`` started at the head of phase 12, or here after the
    card's when none is given); its students serve in a card mlp+gbdt engine
    held to a CPU twin as phase 4 holds its engine; then device_parity.run."""
    from igaming_platform_tpu_torch.convert import params_to
    from igaming_platform_tpu_torch.core.config import BatcherConfig
    from igaming_platform_tpu_torch.serve import scorer
    from igaming_platform_tpu_torch.train import device_parity, distill

    cfg = distill.DistillConfig(**DISTILL_CFG)
    if twin is None:  # no child: the twin runs here, after the card
        twin = ChildTwin("distill_cpu_twin", DISTILL_CFG, "distill")
    t0 = time.perf_counter()
    params, maes = distill.distill_serving_params(cfg, device=device)
    card_s = time.perf_counter() - t0
    if twin.proc is None:
        distill_cpu_twin(twin.path)
        twin_out = twin.result_file()
    else:
        twin_out = twin.result()
    twin.close()
    twin_maes, twin_s = twin_out["maes"], twin_out["seconds"]
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
    # The promotion gates read the service's SLO engine, as the JAX
    # controller reads the process's: under its default 50 ms objective the
    # phase's 16,384-row ScoreBatch RPCs (60 ms and more) burn the budget and
    # hold every promotion; a bulk-sized objective lets the gates judge the
    # candidate.
    env = {"ONLINE_LOOP": "1", "LEDGER_DIR": wal, "ONLINE_TICK_S": "3600",
           "SLO_OBJECTIVE_MS": "1000", **PROMOTE_ENV}
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
    t0 = time.perf_counter()
    # The distillation's CPU twin drains beside this phase's card work.
    # Half the host's cores: the card's phase 12 runs beside it.
    twin = ChildTwin("distill_cpu_twin", DISTILL_CFG, "distill",
                     threads=max(1, (os.cpu_count() or 2) // 2))
    twin.start()
    try:
        result = online_parts(torch, card, dense_mod, gbdt_kernel, store, device, twin)
    finally:
        twin.close()
    result["seconds"] = time.perf_counter() - t0
    log(f"phase 12: {result['seconds']:.1f} s")
    log("phase 12: " + json.dumps(result, default=str))
    return result


def online_parts(torch, card, dense_mod, gbdt_kernel, store, device, twin) -> dict:
    import shutil
    import tempfile

    from igaming_platform_tpu_torch.train import checkpoint, loop, trainer

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
    dist = train_distill(torch, gbdt_kernel, store, device, twin)
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
    return {"parity": parity, "fit": fit, "eval": ev, "distill": dist, "online": online_run,
            "dense_launches": parity["dense_launches"] + fit["dense_launches"],
            "forest_launches": dist["forest_launches"]}


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


def timed_calls(svc, method: str, payloads: list, codes: dict | None = None,
                metadata=()) -> list[float]:
    """Milliseconds of each answered call (sent with ``metadata``); every
    call's status code counted in ``codes`` by (method, code), sheds
    included."""
    from igaming_platform_tpu_torch.serve.grpc_server import RpcAbort

    ms = []
    for payload in payloads:
        t = time.perf_counter()
        try:
            svc.call(method, payload, metadata)
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
        for _ in range(3):
            status, prof = http_call(srv.http_port, f"/debug/profilez?seconds={PLANE_PROFILE_S}")
            if status != 409:
                break
            # An automatic anomaly capture holds the one-capture lock: wait.
            if srv._profile_lock.acquire(timeout=60):
                srv._profile_lock.release()
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


# Phase 14: the rest of the operations plane on phase 7's store.
PLANE2_HZ = 97  # the boot's stack sampler (HOSTPROF_HZ)
PLANE2_GC_S = 5.0  # the GC-pressure drill's length
PLANE2_GC_THRESHOLD = 1  # gc.set_threshold during the drill: a collection per allocation
PLANE2_GC_EVERY_S = 0.25  # the drill's collector: a full gc.collect() this often
PLANE2_DEADLINE_MS = {"ScoreBatch": 10_000, "ScoreTransaction": 2_000}
PLANE2_MIX = (40, 3, 10)  # ScoreTransaction, 16,384-row ScoreBatch, CheckBonusAbuse
PLANE2_DELAY_MS = 250  # the injected device.dispatch delay
PLANE2_CAPTURE_S = 1.5  # ANOMALY_PROFILE_SECONDS
PLANE2_TURN_BATCHES, PLANE2_TURN_SINGLES = 5, 100
# The capture turns: captures forced back to back (cooldown 0), each this long.
PLANE2_FORCED_CAPTURE_S = 0.2
PLANE2_HOLD_MS = 20.0  # the longest tick gap a capture may add (the probe's 1 ms ticker)
PLANE2_SLOWEST_MS = 50.0  # BASELINE.json's p99 target: the slowest ScoreTransaction in a capture
PLANE2_P99_SLACK_MS = 5.0  # captures forced may add this to the off turns' ScoreTransaction p99
# The capture turns, in order: "off" (ANOMALY_PROFILE=0), "on" (captures
# forced), PLANE2_TURN_SINGLES ScoreTransaction calls each, after
# PLANE2_TURN_SINGLES calls not counted. The host's speed drifts over a
# phase (on an NVIDIA H100 80GB HBM3 host, ScoreTransaction p99 fell 4-8 ms
# from the first to the last of four 400-call turns): the order cancels a
# linear and a quadratic drift, twice over, and each kind's pooled p99 is
# the 8th slowest of its 800 calls.
PLANE2_CAPTURE_TURNS = ("off", "on", "on", "off", "on", "off", "off", "on") * 2
# A server boot in a fresh process, as ``python -m ...serve.server`` does.
_BOOT = ("import sys; sys.path.insert(0, '.'); "
         "from igaming_platform_tpu_torch.serve.server import main; main()")


class Ticker:
    """A thread that sleeps 1 ms at a time and keeps each tick's end and the
    gap since the one before: the longest gap over a stretch of time is the
    longest that the interpreter was kept from it."""

    def __init__(self):
        import threading

        self.ticks: list[tuple[float, float]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="ticker", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        last = time.perf_counter()
        while not self._stop.is_set():
            time.sleep(0.001)
            now = time.perf_counter()
            self.ticks.append((now, now - last))
            last = now

    def max_gap_ms(self, t0: float, t1: float) -> float:
        """The longest gap among the ticks that end in [t0, t1] or end the
        gap that spans t1."""
        later = [g for t, g in self.ticks if t > t1]
        gaps = [g for t, g in self.ticks if t0 <= t <= t1] + later[:1]
        return max(gaps, default=0.0) * 1e3

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(10)


def mix_traffic(svc, calls: list, codes: dict, lat: dict, until, timeout_s: float = 120.0) -> None:
    """The RPC mix ``calls`` ((method, payload, metadata), in order) sent in
    a loop until ``until()`` is true, at most ``timeout_s``: each call's code
    counted in ``codes``, each answered call's ms kept by method in ``lat``."""
    end = time.monotonic() + timeout_s
    while not until() and time.monotonic() < end:
        for method, payload, md in calls:
            lat.setdefault(method, []).extend(timed_calls(svc, method, [payload], codes, md))
            if until():
                return


def trace_marks(path: str) -> dict:
    """A device timeline's trace (``obs/devtrace.py``): its kernel and step
    events by name, its window object, its span events, the marks written
    without a duration and the shortest kernel duration (µs)."""
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    out = {"kernels": {}, "steps": {}, "spans": 0, "incomplete": 0, "min_kernel_us": None,
           "window": trace.get("window", {})}
    for ev in trace.get("traceEvents", []):
        cat = ev.get("cat")
        if cat == "span":
            out["spans"] += 1
        if cat not in ("kernel", "step"):
            continue
        into = out["kernels" if cat == "kernel" else "steps"]
        into[ev["name"]] = into.get(ev["name"], 0) + 1
        if "dur" not in ev:
            out["incomplete"] += 1
        elif cat == "kernel":
            out["min_kernel_us"] = min(ev["dur"], out["min_kernel_us"] or ev["dur"])
    return out


def plane2_state(on: bool, svc, engine, telemetry) -> None:
    """The plane of this process on (the default: host profiler, its
    sampler at HOSTPROF_HZ, the runtime telemetry ``telemetry``) or off
    (``HOSTPROF=0 RUNTIME_TELEMETRY=0``), as a boot with those knobs would
    have it; the host profiler is rebuilt from the environment."""
    from igaming_platform_tpu_torch.obs import hostprof, runtime_telemetry, tracing

    os.environ["HOSTPROF"] = "1" if on else "0"
    hostprof.reinstall_from_env().install(svc.metrics)
    runtime_telemetry.uninstall()
    if on:
        runtime_telemetry.DEFAULT = telemetry
        tracing.add_span_sink(telemetry.observe_span)


def boot_subprocess(env: dict, until: str | None, timeout_s: float = 300.0) -> dict:
    """``python -m ...serve.server`` in a fresh process under ``env``: run to
    its exit (``until`` None), or until a log line holds ``until``, then
    SIGTERM and wait. Returns its exit code, seconds and log."""
    import signal
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", _BOOT], env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    lines: list[str] = []
    seen = threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line.rstrip())
            if until is not None and until in line:
                seen.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        if until is not None:
            if not seen.wait(timeout_s):
                raise AssertionError(f"boot: no {until!r} in {timeout_s} s:\n" + "\n".join(lines))
            up_s = time.perf_counter() - t0
            proc.send_signal(signal.SIGTERM)
        else:
            up_s = None
        rc = proc.wait(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(10)
    return {"rc": rc, "up_s": up_s, "seconds": time.perf_counter() - t0, "log": lines}


def phase_plane2(torch, card: str, gbdt_kernel, fa, dense_mod, store,
                 device: str = "cuda") -> dict:
    """Phase 14, on phase 7's store: the default risk service with the whole
    plane on (host profiler with its sampler at ``HOSTPROF_HZ=97``, runtime
    telemetry, deadline lanes, SLO, supervisor, drift) behind the sidecar.
    In order: the plane's cost on ScoreBatch, off (``HOSTPROF=0
    RUNTIME_TELEMETRY=0``) and on in turns; the GC-pressure drill
    (``gc.set_threshold(1)`` and a thread collecting for 5 s under ScoreBatch
    traffic: every RPC answers within its deadline, collections counted,
    pauses attributed to RPCs in flight); the RPC mix (ScoreBatch, then
    CheckBonusAbuse, then ScoreTransaction: bulk first, so the burn-shed gate
    has no interactive traffic to protect), after which the dispatch counter
    equals the steps launched and the RPC roots' ``dispatches`` add up to
    it, the forest, dense and attention launch counters grew by the steps
    times their launches a step, each signature counted once, the compile
    events equal the process's builds and loads, and the µs-per-row table
    has its stages; the plane's cost on ScoreTransaction in turns; the
    anomaly drill (a ``device.dispatch`` delay: one anomaly, one trace-keyed
    capture of the port's device timeline under the RPC mix, whose kernel
    events equal the launch counters' deltas and whose step events the
    dispatches, a 1 ms ticker's longest gap from the delayed call to the
    trace on disk at most ``PLANE2_HOLD_MS`` and the slowest
    ScoreTransaction in it at most ``PLANE2_SLOWEST_MS``, beside the same
    mix with no capture; a second anomaly inside the cooldown only counts);
    ScoreTransaction p99 with captures forced back to back against
    ``ANOMALY_PROFILE=0`` in turns (``PLANE2_CAPTURE_TURNS``), at most
    ``PLANE2_P99_SLACK_MS`` over the off turns'; reflection through the
    byte handler; the card probe and two boots with no visible card; and
    ``step_cost`` of a 4096-row step against its device time.
    ``device="cpu"`` rehearses it without a card (launch, timing bound and
    probe checks then skipped)."""
    import gc
    import threading

    from igaming_platform_tpu_torch.convert import sequence_from_tree
    from igaming_platform_tpu_torch.core import devices
    from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
    from igaming_platform_tpu_torch.models.sequence import SeqConfig
    from igaming_platform_tpu_torch.obs import flight, hostprof, perfmodel
    from igaming_platform_tpu_torch.obs import runtime_telemetry
    from igaming_platform_tpu_torch.serve import chaos, grpc_server, reflection, scorer, server
    from igaming_platform_tpu_torch.serve import risk_codec as codec

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    rng = np.random.default_rng(140)
    tree = server_tree(22)
    seq_cfg = SeqConfig(**ABUSE_CFG)
    abuse_tree = seq_tree(rng, ABUSE_CFG)
    config = RiskServiceConfig(batcher=BatcherConfig(
        batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0))
    import shutil
    import tempfile

    saved = {k: os.environ.get(k) for k in ("HOSTPROF", "HOSTPROF_HZ", "ANOMALY_PROFILE",
                                            "ANOMALY_PROFILE_SECONDS", "ANOMALY_PROFILE_DIR")}
    # The default plane: the anomaly profile on; its traces in a directory
    # removed at the end.
    capture_dir = tempfile.mkdtemp(prefix="plane2-captures-")
    os.environ.update({"HOSTPROF": "1", "HOSTPROF_HZ": str(PLANE2_HZ), "ANOMALY_PROFILE": "1",
                       "ANOMALY_PROFILE_SECONDS": str(PLANE2_CAPTURE_S),
                       "ANOMALY_PROFILE_DIR": capture_dir})
    hostprof.reinstall_from_env()  # a boot's profiler: the sampler runs from the start
    on = plane_assembly(server, config, tree, store, sequence_from_tree(abuse_tree, seq_cfg),
                        device, {})
    srv = server.RiskServer(on, grpc_port=-1, http_port=0)
    svc, engine, det, inner = on.service, on.engine, on.abuse, on.engine.inner
    tel = svc.telemetry
    stop = threading.Event()
    sb_md = (("risk-deadline-ms", str(PLANE2_DEADLINE_MS["ScoreBatch"])),)
    st_md = (("risk-deadline-ms", str(PLANE2_DEADLINE_MS["ScoreTransaction"])),)
    try:
        fields = server_requests(codec, rng, PLANE2_MIX[0] + PLANE2_TURN_SINGLES + 400)
        singles = [codec.encode(codec.SCORE_TRANSACTION_REQUEST, f) for f in fields]
        batches = [codec.encode(codec.SCORE_BATCH_REQUEST, {
            "transactions": server_requests(codec, rng, SERVER_BATCH_ROWS)}) for _ in range(2)]
        checked = [f"acct{a}" for a in rng.integers(0, SERVER_ACCOUNTS, PLANE2_MIX[2])]
        for acct in checked:
            for i in range(int(rng.integers(5, 64))):
                det.record_event(acct, int(rng.integers(500, 200_000)), "bet",
                                 device_id=f"dev{rng.integers(0, 300_000)}",
                                 timestamp=SERVER_NOW - 3600.0 + 30.0 * i)
        abuse = [codec.encode(codec.CHECK_BONUS_ABUSE_REQUEST, {"account_id": a}) for a in checked]
        engine.score_batch_wire_bytes(batches[0])  # the pipeline's first build
        if cuda:
            torch.cuda.synchronize()

        # The plane's cost on ScoreBatch, off, on, on, off.
        turns = []
        for name in ("off", "on", "on", "off"):
            plane2_state(name == "on", svc, engine, tel)
            codes: dict = {}
            bs = [SERVER_BATCH_ROWS / ms * 1e3 for ms in timed_calls(
                svc, "ScoreBatch", batches[:1] * PLANE2_TURN_BATCHES, codes, sb_md)]
            turns.append({"plane": name, "rows_per_s": bs,
                          "median_rows_per_s": statistics.median(bs) if bs else None,
                          "sheds": sum(n for (_, c), n in codes.items() if c != "OK")})
        plane2_state(True, svc, engine, tel)
        hp = hostprof.get_default()

        # The GC-pressure drill: ScoreBatch only, each with its deadline.
        m0 = exposition(http_text(srv.http_port, "/metrics")[1])
        gc0 = hp.gc_snapshot()
        collector = {"collects": 0}

        def collect():
            while not stop.wait(PLANE2_GC_EVERY_S):
                gc.collect()
                collector["collects"] += 1

        thresholds = gc.get_threshold()
        lat, codes = [], {}
        gc.set_threshold(PLANE2_GC_THRESHOLD)
        thread = threading.Thread(target=collect, daemon=True)
        thread.start()
        try:
            end = time.monotonic() + PLANE2_GC_S
            while time.monotonic() < end:
                lat += timed_calls(svc, "ScoreBatch", batches[1:], codes, sb_md)
        finally:
            stop.set()
            thread.join(60)
            stop.clear()
            gc.set_threshold(*thresholds)
        gc1 = hp.gc_snapshot()
        m1 = exposition(http_text(srv.http_port, "/metrics")[1])

        def family_sum(m: dict, family: str) -> float:
            return sum(v for k, v in m.items() if k.split("{")[0] == family)

        gc_drill = {"rpcs": len(lat), "codes": {f"{m} {c}": n for (m, c), n in codes.items()},
                    "max_ms": max(lat) if lat else None,
                    "p50_ms": float(np.percentile(lat, 50)) if lat else None,
                    "collects": collector["collects"],
                    "collections": family_sum(m1, "risk_gc_collections_total")
                    - family_sum(m0, "risk_gc_collections_total"),
                    "pauses_in_rpc": gc1["pauses_in_rpc"] - gc0["pauses_in_rpc"],
                    "pause_in_rpc_ms": gc1["pause_in_rpc_ms"] - gc0["pause_in_rpc_ms"],
                    "pause_ms_p99": None}
        pauses = [p["pause_ms"] for p in gc1["recent_pauses"]]
        gc_drill["pause_ms_p99"] = float(np.percentile(pauses, 99)) if pauses else None
        if (not lat or codes != {("ScoreBatch", "OK"): len(lat)}
                or gc_drill["max_ms"] >= PLANE2_DEADLINE_MS["ScoreBatch"]
                or gc_drill["collections"] <= 0 or gc_drill["pauses_in_rpc"] <= 0):
            raise AssertionError(f"plane2: GC drill {gc_drill}")
        log(f"phase 14: [{card}] GC drill: {len(lat)} ScoreBatch RPCs under "
            f"gc.set_threshold({PLANE2_GC_THRESHOLD}) "
            f"and {collector['collects']} gc.collect() calls (one each {PLANE2_GC_EVERY_S} s) in "
            f"{PLANE2_GC_S} s, all OK, p50 {gc_drill['p50_ms']:.1f} ms, slowest "
            f"{gc_drill['max_ms']:.1f} ms (deadline {PLANE2_DEADLINE_MS['ScoreBatch']} ms); "
            f"{gc_drill['collections']:.0f} collections counted on /metrics, "
            f"{gc_drill['pauses_in_rpc']} pauses ({gc_drill['pause_in_rpc_ms']:.1f} ms) "
            "attributed to RPCs in flight")

        # The RPC mix, its counts set to 0 just before and read just after.
        hp.reset()
        gbdt_kernel.gbdt_forest.launches = 0
        dense_mod.dense.launches = 0
        fa.flash_attention_fwd.launches = 0
        flight.DEFAULT_RECORDER.clear()
        m_before = exposition(http_text(srv.http_port, "/metrics")[1])
        d0, steps0, fwd0 = tel.dispatches_total, engine.device_steps, det.device_steps
        sent: dict = {}
        watcher = tel.compile_watcher
        timed_calls(svc, "ScoreBatch", batches[:1], sent, sb_md)
        sigs_once = len(watcher._signatures)  # the same batch again adds none
        timed_calls(svc, "ScoreBatch", batches[:1] * (PLANE2_MIX[1] - 1), sent, sb_md)
        sigs_again = len(watcher._signatures)
        timed_calls(svc, "CheckBonusAbuse", abuse, sent)
        st_d0, st_steps0 = tel.dispatches_total, engine.device_steps
        timed_calls(svc, "ScoreTransaction", singles[:PLANE2_MIX[0]], sent, st_md)
        if cuda:
            torch.cuda.synchronize()
        st_dispatches = tel.dispatches_total - st_d0
        st_steps = engine.device_steps - st_steps0
        mix = {"dispatches": tel.dispatches_total - d0,
               "device_steps": engine.device_steps - steps0,
               "abuse_steps": det.device_steps - fwd0,
               "forest": gbdt_kernel.gbdt_forest.launches, "dense": dense_mod.dense.launches,
               "attention": fa.flash_attention_fwd.launches}
        m_after = exposition(http_text(srv.http_port, "/metrics")[1])
        entries = flight.DEFAULT_RECORDER.snapshot()
        roots = sum(e.get("dispatches", 0) for e in entries)
        mix["metric_dispatches"] = (m_after.get("risk_device_dispatches_total", 0.0)
                                    - m_before.get("risk_device_dispatches_total", 0.0))
        mix["root_dispatches"] = roots
        mix["st_batcher_dispatches"] = st_dispatches
        bad = []
        if sent != {("ScoreBatch", "OK"): PLANE2_MIX[1], ("CheckBonusAbuse", "OK"): PLANE2_MIX[2],
                    ("ScoreTransaction", "OK"): PLANE2_MIX[0]}:
            bad.append(f"answers {sent}")
        if not (mix["dispatches"] == mix["metric_dispatches"]
                == mix["device_steps"] + mix["abuse_steps"]):
            bad.append("the dispatch counter is not the steps launched")
        # Batcher steps serve many RPCs: their dispatches land on batch roots.
        if st_dispatches != st_steps or roots != mix["dispatches"] - st_dispatches:
            bad.append("the RPC roots' dispatches do not add up")
        if cuda and (mix["forest"] != mix["device_steps"] or mix["forest"] == 0
                     or mix["dense"] != len(tree["mlp"]["layers"]) * mix["device_steps"]
                     or mix["attention"] != seq_cfg.n_layers * mix["abuse_steps"]
                     or mix["attention"] == 0):
            bad.append("launch counters")
        signatures = sorted(watcher._signatures)
        ladder = set(inner._shapes)
        packed_shapes = {s.split(":")[1] for s in signatures if s.startswith("packed_step:")}
        if (m_after.get("risk_compile_signatures_total", 0.0) != len(signatures)
                or not all(int(sh.strip("()").split(",")[0]) in ladder for sh in packed_shapes)):
            bad.append(f"signatures {signatures}")
        events = runtime_telemetry.compile_log()
        compile_metric = family_sum(m_after, "risk_compile_events_total")
        if compile_metric != len(events) or watcher.compiles_total != len(events):
            bad.append(f"compile events {compile_metric} against {len(events)} builds and loads")
        if sigs_again != sigs_once:
            bad.append("a signature seen before was counted again")
        stages = hp.snapshot()["stages"]
        table = {k: v["us_per_row"] for k, v in stages.items() if v["us_per_row"] is not None}
        if not {"decode", "dispatch", "readback", "encode"} <= set(table):
            bad.append(f"µs-per-row stages {sorted(table)}")
        sampler = hp.sampler.snapshot()
        if sampler["samples_total"] == 0 or not sampler["running"]:
            bad.append(f"sampler {sampler}")
        if bad:
            raise AssertionError(f"plane2: mix {mix}: " + "; ".join(bad))
        kinds: dict = {}
        for e in events:
            kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
        log(f"phase 14: [{card}] RPC mix {PLANE2_MIX[1]} ScoreBatch, {PLANE2_MIX[2]} "
            f"CheckBonusAbuse, {PLANE2_MIX[0]} ScoreTransaction: risk_device_dispatches_total "
            f"+{mix['dispatches']} = {mix['device_steps']} engine steps + {mix['abuse_steps']} "
            f"abuse steps; RPC roots carry {roots}, the batcher's batch roots "
            f"{st_dispatches}; forest {mix['forest']}, dense {mix['dense']}, attention "
            f"{mix['attention']} launches; {len(signatures)} signatures "
            f"({sorted(packed_shapes)} packed), none counted twice; "
            f"{len(events)} compile events {json.dumps(kinds)}; sampler "
            f"{sampler['samples_total']} samples of {sampler['roles_seen']}")
        log(f"phase 14: [{card}] host µs/row (mean, p50, p99): " + "; ".join(
            f"{k} {v['mean']}/{v['p50']}/{v['p99']}" for k, v in sorted(table.items())))

        # The plane's cost on ScoreTransaction, off, on, on, off.
        for turn in turns:
            plane2_state(turn["plane"] == "on", svc, engine, tel)
            st = timed_calls(svc, "ScoreTransaction",
                             singles[PLANE2_MIX[0]:PLANE2_MIX[0] + PLANE2_TURN_SINGLES])
            turn["st_p99_ms"] = float(np.percentile(st, 99))
        plane2_state(True, svc, engine, tel)
        off = [t for t in turns if t["plane"] == "off"]
        ons = [t for t in turns if t["plane"] == "on"]
        cost = {"rows_per_s_off_spread": abs(off[0]["median_rows_per_s"]
                                             - off[1]["median_rows_per_s"]),
                "rows_per_s_on_minus_off": statistics.mean(t["median_rows_per_s"] for t in ons)
                - statistics.mean(t["median_rows_per_s"] for t in off),
                "st_p99_off_spread_ms": abs(off[0]["st_p99_ms"] - off[1]["st_p99_ms"]),
                "st_p99_on_minus_off_ms": statistics.mean(t["st_p99_ms"] for t in ons)
                - statistics.mean(t["st_p99_ms"] for t in off)}
        log(f"phase 14: [{card}] the plane's cost in turns: " + "; ".join(
            f"{t['plane']} {t['median_rows_per_s']} rows/s ({t['sheds']} shed), ST p99 "
            f"{t['st_p99_ms']:.3f} ms" for t in turns) + f"; {json.dumps(cost)}")

        # The anomaly drill on ScoreTransaction traffic: the detectors and the
        # cooldown start afresh once no capture runs (the GC drill's pauses
        # are anomalies too), warm up on ANOMALY_WARMUP_STEPS steps, then a
        # delayed dispatch.
        rest = itertools.cycle(singles[PLANE2_MIX[0] + PLANE2_TURN_SINGLES:])
        if not srv._profile_lock.acquire(timeout=60):
            raise AssertionError("plane2: a profile capture did not end")
        srv._profile_lock.release()
        warmup = int(os.environ.get("ANOMALY_WARMUP_STEPS", "30"))
        with tel._lock:
            tel._last_profile_at = float("-inf")
        anomalies0 = tel.anomalies_total
        profiles0 = len(tel.profile_captures)

        delayed_at: list[float] = []

        def one_delayed() -> int:
            # A fresh baseline first: the capture's own stalls are anomalies
            # too, and the damped baseline keeps their spread. The cooldown
            # is not reset.
            with tel._lock:
                tel._detectors.clear()
            for _ in range(warmup + 10):
                svc.call("ScoreTransaction", next(rest), st_md)
            before = tel.anomalies_total
            chaos.install(f"seed=14;device.dispatch=delay:p=1.0:ms={PLANE2_DELAY_MS}:count=1")
            delayed_at.append(time.perf_counter())
            try:
                svc.call("ScoreTransaction", next(rest), st_md)
            finally:
                chaos.clear()
            return tel.anomalies_total - before

        # The capture under the RPC mix (seeded order): from the delayed call
        # that arms it until its trace is on disk, a 1 ms ticker's longest
        # gap; then the same mix as long again with no capture, the ticker's
        # floor under this traffic.
        mix_calls = ([("ScoreBatch", batches[0], sb_md)] * PLANE2_MIX[1]
                     + [("CheckBonusAbuse", a, ()) for a in abuse]
                     + [("ScoreTransaction", p, st_md) for p in singles[:PLANE2_MIX[0]]])
        mix_calls = [mix_calls[i] for i in rng.permutation(len(mix_calls))]
        # The burn-shed gate held open for the drill: the GC drill's slow
        # ScoreBatch RPCs and the delayed call burn the SLO's fast window
        # (the JAX SLO counts ScoreBatch against 50 ms), and a shed bulk lane
        # would leave the capture without the mix's ScoreBatch load.
        svc.burn_gate.enabled = False
        ticker = Ticker()
        try:
            first = one_delayed()
            during, during_ms = {}, {}
            mix_traffic(svc, mix_calls, during, during_ms, lambda: any(
                "trace" in c or "error" in c for c in tel.profile_captures[profiles0:]))
            t_done = time.perf_counter()
            hold_ms = ticker.max_gap_ms(delayed_at[-1], t_done)
            t_floor = time.perf_counter()
            floor_end = t_floor + (t_done - delayed_at[-1])
            floor_codes, floor_ms = {}, {}
            mix_traffic(svc, mix_calls, floor_codes, floor_ms,
                        lambda: time.perf_counter() > floor_end)
            floor_hold_ms = ticker.max_gap_ms(t_floor, time.perf_counter())
        finally:
            ticker.stop()
            svc.burn_gate.enabled = True
        second = one_delayed()
        captures = tel.profile_captures[profiles0:]
        capture = captures[0] if captures else {}
        marks = trace_marks(capture["trace"]) if "trace" in capture else {}
        window = marks.get("window", {})
        anomaly = {"first": first, "second": second,
                   "anomalies_in_drill": tel.anomalies_total - anomalies0,
                   "profiles": len(captures), "trace_id": capture.get("trace_id"),
                   "log_dir": capture.get("log_dir"), "kernel_events": marks.get("kernels"),
                   "step_events": marks.get("steps"), "window": window,
                   "spans": marks.get("spans"), "incomplete": marks.get("incomplete"),
                   "min_kernel_us": marks.get("min_kernel_us"),
                   "metric_profiles": exposition(http_text(srv.http_port, "/metrics")[1]).get(
                       "risk_anomaly_profiles_total"),
                   "hold_ms": hold_ms, "capture_s": t_done - delayed_at[0],
                   "floor_hold_ms": floor_hold_ms,
                   "during_capture": {f"{m} {c}": n for (m, c), n in during.items()},
                   "during_capture_max_ms": {m: max(v) for m, v in during_ms.items() if v},
                   "during_capture_p99_ms": {m: float(np.percentile(v, 99))
                                             for m, v in during_ms.items() if v},
                   "floor_max_ms": {m: max(v) for m, v in floor_ms.items() if v},
                   "floor_codes": {f"{m} {c}": n for (m, c), n in floor_codes.items()}}
        bad = []
        if (first != 1 or second != 1 or len(captures) != 1 or "error" in capture
                or (capture.get("trace_id") or "x")[:8] not in (capture.get("log_dir") or "")):
            bad.append("one anomaly, one capture keyed by its trace id")
        if (not marks or sum(marks["steps"].values()) != window.get("dispatches")
                or window.get("unresolved") or marks["incomplete"] or not marks["spans"]):
            bad.append("step events against the dispatch counter")
        if cuda and (marks.get("kernels") != window.get("launches") or not {
                "gbdt_forest", "dense", "dense_f32", "flash_attention_fwd"} <= set(window.get(
                    "launches", {})) or not marks["min_kernel_us"] or marks["min_kernel_us"] <= 0):
            bad.append("kernel events against the launch counters")
        if {k for k in anomaly["during_capture"] if not k.endswith(" OK")}:
            bad.append("an RPC of the mix failed during the capture")
        if cuda and (hold_ms > PLANE2_HOLD_MS or anomaly["during_capture_max_ms"].get(
                "ScoreTransaction", 0.0) > PLANE2_SLOWEST_MS):
            bad.append(f"the capture held serving ({hold_ms:.1f} ms, bound {PLANE2_HOLD_MS}) or "
                       f"a ScoreTransaction took over {PLANE2_SLOWEST_MS} ms")
        if bad:
            raise AssertionError(f"plane2: anomaly drill {anomaly} {capture}: " + "; ".join(bad))
        log(f"phase 14: [{card}] anomaly drill: a {PLANE2_DELAY_MS} ms device.dispatch delay "
            f"raised {first} step anomaly and {len(captures)} capture keyed by trace "
            f"{anomaly['trace_id']}, {anomaly['capture_s']:.3f} s from the delayed call to the "
            f"trace on disk under the RPC mix; the device timeline's kernel events "
            f"{json.dumps(marks['kernels'])} = the launch counters' deltas "
            f"{json.dumps(window.get('launches'))}, step events {json.dumps(marks['steps'])} "
            f"= {window.get('dispatches')} dispatches, {marks['spans']} spans, shortest kernel "
            f"{marks['min_kernel_us']} µs, {window.get('slices')} slices; a second anomaly inside "
            f"the {tel.cooldown_s:.0f} s cooldown raised {second} anomaly and no capture")
        log(f"phase 14: [{card}] capture under the RPC mix: longest 1 ms-ticker gap {hold_ms:.3f} "
            f"ms (the mix alone: {floor_hold_ms:.3f} ms); during the capture "
            f"{json.dumps(anomaly['during_capture'])}, slowest "
            f"{json.dumps(anomaly['during_capture_max_ms'])} ms, p99 "
            f"{json.dumps(anomaly['during_capture_p99_ms'])} ms; the mix alone slowest "
            f"{json.dumps(anomaly['floor_max_ms'])} ms")

        # ScoreTransaction p99 with captures forced back to back (cooldown 0,
        # PLANE2_FORCED_CAPTURE_S each) against ANOMALY_PROFILE=0, in turns.
        saved_cooldown, saved_enabled = tel.cooldown_s, tel.profile_enabled
        turn_singles = singles[PLANE2_MIX[0]:PLANE2_MIX[0] + PLANE2_TURN_SINGLES]
        timed_calls(svc, "ScoreTransaction", turn_singles, {}, st_md)
        capture_turns = []
        try:
            for name in PLANE2_CAPTURE_TURNS:
                if not srv._profile_lock.acquire(timeout=60):
                    raise AssertionError("plane2: a profile capture did not end")
                srv._profile_lock.release()
                tel.cooldown_s, tel.profile_enabled = 0.0, name == "on"
                os.environ["ANOMALY_PROFILE_SECONDS"] = str(PLANE2_FORCED_CAPTURE_S)
                n0 = len(tel.profile_captures)
                stop_forcing = threading.Event()

                def force() -> None:
                    # One capture at a time: the next once the last is written.
                    k = 0
                    while not stop_forcing.wait(0.02):
                        if srv._profile_lock.locked():
                            continue
                        k += 1
                        trace_id = f"forced{len(capture_turns)}-{k}"
                        tel._maybe_profile(trace_id, "score.dispatch", 0.0)
                        rec = next((c for c in reversed(tel.profile_captures)
                                    if c["trace_id"] == trace_id), {})
                        while not ("trace" in rec or "error" in rec or stop_forcing.wait(0.02)):
                            pass

                forcer = threading.Thread(target=force, daemon=True)
                if name == "on":
                    forcer.start()
                codes = {}
                st = timed_calls(svc, "ScoreTransaction", turn_singles, codes, st_md)
                stop_forcing.set()
                if forcer.is_alive():
                    forcer.join(10)
                capture_turns.append({
                    "captures": name, "st_ms": st, "st_p99_ms": float(np.percentile(st, 99)),
                    "st_max_ms": max(st), "codes": {f"{m} {c}": n for (m, c), n in codes.items()},
                    "captures_started": len(tel.profile_captures) - n0})
        finally:
            tel.cooldown_s, tel.profile_enabled = saved_cooldown, saved_enabled
            os.environ["ANOMALY_PROFILE_SECONDS"] = str(PLANE2_CAPTURE_S)
        if not srv._profile_lock.acquire(timeout=60):
            raise AssertionError("plane2: a profile capture did not end")
        srv._profile_lock.release()
        forced = [c for c in tel.profile_captures[profiles0 + len(captures):]
                  if c["trace_id"].startswith("forced")]
        offs = [t for t in capture_turns if t["captures"] == "off"]
        ons = [t for t in capture_turns if t["captures"] == "on"]

        def pooled_p99(turns) -> float:
            return float(np.percentile([v for t in turns for v in t["st_ms"]], 99))

        # The bound's statistic: the p99 of every call of the on turns
        # against the p99 of every call of the off turns; the off turns'
        # spread, the first half's pooled p99 against the second half's.
        pooled = {"off": pooled_p99(offs), "on": pooled_p99(ons)}
        half = len(offs) // 2
        off_spread = abs(pooled_p99(offs[:half]) - pooled_p99(offs[half:]))
        for t in capture_turns:
            del t["st_ms"]
        capture_cost = {
            "st_p99_off_spread_ms": off_spread,
            "st_p99_off_ms": pooled["off"], "st_p99_on_ms": pooled["on"],
            "st_p99_on_minus_off_ms": pooled["on"] - pooled["off"],
            "forced_captures": len(forced),
            "forced_written": sum("trace" in c for c in forced),
            # A natural anomaly's capture may hold the lock when one is forced.
            "forced_errors": [c["error"] for c in forced if "error" in c
                              and "already in progress" not in c["error"]]}
        log(f"phase 14: [{card}] ScoreTransaction with captures forced ({PLANE2_FORCED_CAPTURE_S} s "
            "each, back to back) against ANOMALY_PROFILE=0, in turns: " + "; ".join(
                f"{t['captures']} p99 {t['st_p99_ms']:.3f} ms, slowest {t['st_max_ms']:.3f} ms "
                f"({t['captures_started']} captures)"
                for t in capture_turns)
            + f"; {json.dumps(capture_cost)}")
        if (any(t["codes"] != {"ScoreTransaction OK": PLANE2_TURN_SINGLES} for t in capture_turns)
                or not all(t["captures_started"] for t in ons) or capture_cost["forced_errors"]
                or capture_cost["forced_written"] < len(ons)
                or (cuda and capture_cost["st_p99_on_minus_off_ms"] > PLANE2_P99_SLACK_MS)):
            raise AssertionError(f"plane2: capture turns {capture_turns} {capture_cost}")

        # Reflection through the byte handler.
        refl = reflection.ReflectionService(("risk.v1.RiskService", "grpc.health.v1.Health"))
        listed = refl.respond(b"\x3a\x00")
        symbol = b"risk.v1.RiskService"
        found = refl.respond(b"\x22" + bytes([len(symbol)]) + symbol)
        if not (symbol in listed and b"grpc.reflection.v1alpha.ServerReflection" in listed
                and b"risk/v1/risk.proto" in found and b"google/protobuf/timestamp.proto" in found):
            raise AssertionError("plane2: reflection")
        log(f"phase 14: reflection: list_services {len(listed)} bytes, "
            f"file_containing_symbol risk.v1.RiskService {len(found)} bytes (risk.proto and "
            "timestamp.proto)")

        # The card probe, and boots with no visible card.
        for k in ("BENCH_DEVICE_PROBED", "BENCH_DEVICE_FALLBACK"):
            os.environ.pop(k, None)
        t0 = time.perf_counter()
        label = devices.ensure_responsive_device()
        probe = {"label": label, "seconds": time.perf_counter() - t0}
        os.environ.pop("BENCH_DEVICE_PROBED", None)
        if cuda and label is not None:
            raise AssertionError(f"plane2: the card's probe failed: {label}")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("BENCH_DEVICE") and k not in ("HOSTPROF_HZ", "CHAOS_PLAN")}
        env.update({"CUDA_VISIBLE_DEVICES": "", "GRPC_PORT": "-1", "HTTP_PORT": "0",
                    "FEATURE_STORE": "python", "DEVICE_PROBE_BUDGET_S": "60"})
        # The two boots run at once (each beside the other's load).
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(2) as pool:
            refused_f = pool.submit(boot_subprocess, env, None)
            served_f = pool.submit(boot_subprocess, {**env, "SERVE_DEVICE_FALLBACK": "cpu"},
                                   "risk server up")
            refused, served = refused_f.result(), served_f.result()
        refused_line = next((ln for ln in refused["log"] if "device unavailable" in ln), "")
        probe.update({"refused_rc": refused["rc"], "refused_s": refused["seconds"],
                      "refused_line": refused_line[-200:], "fallback_rc": served["rc"],
                      "fallback_up_s": served["up_s"]})
        if (refused["rc"] != 1 or "device init failed" not in refused_line
                or served["rc"] != 0
                or not any("signal 15" in ln for ln in served["log"])
                or not any("serving on the host CPU" in ln for ln in served["log"])):
            raise AssertionError(f"plane2: boots {probe}\n" + "\n".join(
                refused["log"][-20:] + served["log"][-20:]))
        log(f"phase 14: [{card}] probe: healthy in {probe['seconds']:.2f} s; with no visible "
            f"card the boot exits {refused['rc']} in {refused['seconds']:.1f} s "
            f"({refused_line.split('ERROR')[-1].strip()[:160]}), and with "
            f"SERVE_DEVICE_FALLBACK=cpu serves on the CPU (up in {served['up_s']:.1f} s, "
            f"exit {served['rc']} on SIGTERM)")

        # Cost counts: a 4096-row step's count against its device time.
        step_cost = inner.step_cost(BATCH_SIZE)
        xs, bls = store.decode_gather(batches[0])
        params, thr = inner.get_params(), inner.thresholds_snapshot()[0]
        xd = torch.from_numpy(np.ascontiguousarray(xs[:BATCH_SIZE])).to(device)
        bld = torch.from_numpy(np.ascontiguousarray(bls[:BATCH_SIZE])).to(device)

        def step():
            with torch.inference_mode():
                scorer._stack_packed(inner._score_fn(params, xd, bld, thr))

        if cuda:
            with torch.cuda.stream(inner.stream):
                step_ms = device_ms(torch, step)
        else:
            t0 = time.perf_counter()
            step()
            step_ms = (time.perf_counter() - t0) * 1e3
        util = perfmodel.utilization(step_cost, step_ms / 1e3, device)
        log(f"phase 14: [{card}] step_cost of the {BATCH_SIZE}-row mlp+gbdt step: "
            f"{step_cost['flops']:.0f} operations, {step_cost['bytes']:.0f} bytes; device "
            f"{step_ms:.6f} ms -> {json.dumps(util)}")

        # /metrics after all of it: the families the plane feeds.
        final = exposition(http_text(srv.http_port, "/metrics")[1])
        fed = {f: family_sum(final, f) for f in (
            "risk_device_dispatches_total", "risk_compile_signatures_total",
            "risk_compile_events_total", "risk_host_stage_us_per_row_count",
            "risk_gc_collections_total", "risk_step_anomalies_total",
            "risk_anomaly_profiles_total", "risk_arena_buffers", "risk_hbm_bytes")}
        if not all(fed[f] > 0 for f in list(fed)[:5]):
            raise AssertionError(f"plane2: /metrics {fed}")
        log(f"phase 14: [{card}] /metrics: " + json.dumps(fed))
    finally:
        stop.set()
        chaos.clear()
        srv.shutdown(grace=5.0)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        hostprof.reinstall_from_env()
        shutil.rmtree(capture_dir, ignore_errors=True)
    result = {"gc_drill": gc_drill, "mix": mix, "signatures": len(signatures),
              "compile_events": len(events), "compile_kinds": kinds, "stage_us_per_row": table,
              "sampler": {k: sampler[k] for k in ("samples_total", "roles_seen", "hz")},
              "turns": turns, "cost": cost, "anomaly": anomaly, "capture_turns": capture_turns,
              "capture_cost": capture_cost, "probe": probe,
              "step_cost": step_cost, "step_ms": step_ms, "utilization": util, "metrics": fed,
              "forest_launches": mix["forest"], "dense_launches": mix["dense"],
              "attention_launches": mix["attention"],
              "seconds": time.perf_counter() - t_phase}
    log(f"phase 14: {result['seconds']:.1f} s")
    log("phase 14: " + json.dumps(result, default=str))
    return result


def capture_stall_probe(torch, seconds: float = 1.5) -> list[dict]:
    """How long a ``torch.profiler`` capture holds the interpreter: a thread
    ticking every 1 ms and a thread launching elementwise steps run while a
    capture of ``seconds`` starts, stops, exports its Chrome trace, has a
    child process count its device events (``tracing.count_trace_events``,
    as ``/debug/profilez`` does) and parses its events in this process (as
    ``/debug/profilez`` did); per part, its wall ms and the longest gap
    between ticks. Rows: host CPU and CUDA activity, then CUDA alone, then
    both again, then CUDA alone with ``record_shapes=False`` and
    ``with_stack=False`` stated. Each row also holds the child's counts to
    the in-process ones, by name. Not run by ``main``: ``python3 -c "import
    torch, chip_smoke as c; c.capture_stall_probe(torch)"``."""
    import tempfile
    import threading

    from igaming_platform_tpu_torch.obs import tracing

    tracing.prepare_device_trace()
    stop = threading.Event()
    gaps: list[float] = []

    def ticker():
        last = time.perf_counter()
        while not stop.is_set():
            time.sleep(0.001)
            now = time.perf_counter()
            gaps.append(now - last)
            last = now

    def work():
        x = torch.randn(4096, 30, device="cuda")
        while not stop.is_set():
            for _ in range(90):
                x = x * 1.0001 + 0.0
            torch.cuda.synchronize()

    def in_process(prof) -> dict:
        out: dict = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                out[ev.name] = out.get(ev.name, 0) + 1
        return out

    threads = [threading.Thread(target=ticker), threading.Thread(target=work)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    rows = []
    trace = os.path.join(tempfile.mkdtemp(prefix="capture-stall-"), "trace.json")
    try:
        for acts, kw in ((("CPU", "CUDA"), {}), (("CUDA",), {}), (("CPU", "CUDA"), {}),
                         (("CUDA",), {"record_shapes": False, "with_stack": False})):
            prof = torch.profiler.profile(
                activities=[getattr(torch.profiler.ProfilerActivity, a) for a in acts], **kw)
            row = {"activities": list(acts), **kw}
            got: dict = {}
            for part, fn in (("enter", prof.__enter__),
                             ("window", lambda: time.sleep(seconds)),
                             ("exit", lambda: prof.__exit__(None, None, None)),
                             ("export", lambda: prof.export_chrome_trace(trace)),
                             ("child_count", lambda: got.update(
                                 child=tracing.count_trace_events(trace))),
                             ("events", lambda: got.update(
                                 events=in_process(prof), n=len(prof.events())))):
                g0, t = len(gaps), time.perf_counter()
                fn()
                row[f"{part}_ms"] = (time.perf_counter() - t) * 1e3
                time.sleep(0.05)
                row[f"{part}_max_gap_ms"] = max(gaps[g0:] or [0.0]) * 1e3
            row["events"] = got["n"]
            row["device_events"] = sum(got["events"].values())
            row["child_device_events"] = sum(got["child"].values())
            row["child_counts_equal"] = got["child"] == got["events"]
            row["trace_bytes"] = os.path.getsize(trace)
            rows.append(row)
            log("capture stall: " + json.dumps(row))
    finally:
        stop.set()
        for t in threads:
            t.join()
    return rows


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


# One turn of ``wire_turns``: the phases that go over the port's gRPC
# transport (7, 15, 16, 17) in a fresh process of one checkout, after its
# kernels are built and phase 7's store filled; a "TURN " JSON line with each
# phase's seconds and phase 7's and 16's latencies and rates (in-process in a
# checkout from before the transport, over the wire since).
_WIRE_TURN = """
import json, statistics, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as c
from igaming_platform_tpu_torch.ops import _build, gbdt_kernel
from igaming_platform_tpu_torch.ops import dense as dense_mod
from igaming_platform_tpu_torch.ops import flash_attention as fa
from igaming_platform_tpu_torch.serve import native_store
card = c.nvidia_smi_line()
torch.backends.cuda.matmul.allow_tf32 = False
_build.build(["gbdt_forest", "flash_attention_fwd", "dense_fixed"])
t = time.perf_counter()
filled = (*c.fill_native_store(native_store, c.SERVER_NOW), time.perf_counter() - t)
seconds, out = {"fill": round(filled[2], 1)}, {}
for name, run in (
        ("7", lambda: c.phase_server(torch, card, gbdt_kernel, fa, filled)),
        ("15", lambda: c.phase_platform(torch, card, gbdt_kernel, fa, dense_mod)),
        ("16", lambda: c.phase_stores(torch, card, gbdt_kernel, dense_mod, filled[0])),
        ("17", lambda: c.phase_multi_device(torch, card, gbdt_kernel, fa, dense_mod,
                                            filled[0]))):
    t = time.perf_counter()
    out[name] = run()
    seconds[name] = round(time.perf_counter() - t, 1)
p7 = out["7"]
print("TURN " + json.dumps({
    "seconds": seconds, "st_p50_ms": p7["score_transaction_p50_ms"],
    "st_p99_ms": p7["score_transaction_p99_ms"],
    "cba_p99_ms": p7["check_bonus_abuse_p99_ms"],
    "sb_rows_per_s": statistics.median(p7["score_batch_rows_per_s"]),
    "wallet_ops_per_s": out["16"]["wallet"]["ops_per_s"], "card": card}))
"""


def wire_turns(parent: str, turns: str = "pccp") -> list[dict]:
    """Phases 7, 15, 16 and 17 of two checkouts in turns on one card, each
    turn in its own process (``_WIRE_TURN``): ``p`` runs the checkout at
    ``parent`` (a ``git archive`` unpack of a commit from before the wire),
    ``c`` this one. Returns each turn's phase seconds and phase 7's and 16's
    numbers in turn order. Run it as ``python3 -c "import chip_smoke as c;
    c.wire_turns('dir')"``."""
    runs = []
    for turn in turns:
        where = parent if turn == "p" else "."
        out = subprocess.run([sys.executable, "-c", _WIRE_TURN], cwd=where,
                             capture_output=True, text=True, check=False)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("TURN ")]
        if out.returncode or not lines:
            raise AssertionError(f"wire turn in {where}: exit {out.returncode}\n"
                                 + out.stderr[-3000:])
        runs.append({"checkout": "parent" if turn == "p" else "change",
                     **json.loads(lines[0][5:])})
        log(f"wire turn {len(runs)}: " + json.dumps(runs[-1]))
    return runs


# Phase 15: the platform on the card. The single binary (platform/app.py)
# with the mlp+gbdt engine at phase 4's widths and the detector at serving
# width: (a) PLATFORM_PARITY_OPS operations over PLATFORM_PARITY_ACCOUNTS
# accounts, PLATFORM_PARITY_CLAIMS of them bonus claims, through the card app
# and its CPU twin; (b) a SQLite store of PLATFORM_ACCOUNTS accounts and
# PLATFORM_OPS operations over PLATFORM_ACTIVE of them, PLATFORM_CLAIMS bonus
# claims among them; (c) PLATFORM_AMQP_OPS operations whose events then reach
# the risk service's bridge over AMQP, through one broker outage of
# PLATFORM_OUTAGE_S. Thresholds low enough for random weights to review and
# block a few percent of operations (phase 5 lowers them too). Cut for the
# phase's 120 s: PLATFORM_OPS from 10,000 and PLATFORM_ACTIVE from 2,000
# (the same operations an account), PLATFORM_AMQP_OPS from 5,000; at those
# counts the phase took 220.3 s on an H100 (PERF.md §6).
PLATFORM_PARITY_OPS, PLATFORM_PARITY_ACCOUNTS, PLATFORM_PARITY_CLAIMS = 1_000, 200, 50
PLATFORM_ACCOUNTS, PLATFORM_OPS, PLATFORM_ACTIVE, PLATFORM_CLAIMS = 100_000, 3_000, 600, 200
PLATFORM_AMQP_OPS, PLATFORM_OUTAGE_S = 2_500, 1.0
PLATFORM_THRESHOLDS = (45, 30)  # (block, review)
# The detector's head bias, shifted so that its random weights score the
# stream's claims on both sides of the 0.5 threshold (unshifted, every
# claim of a CPU rehearsal scored 0.63-0.79 and was refused as abuse).
PLATFORM_ABUSE_BIAS_SHIFT = -0.9
PLATFORM_T0 = 1_772_668_800.0  # 2026-03-05 00:00 UTC: inside the rules' date windows
PLATFORM_CREATE_BATCH = 10_000  # accounts a unit of work while the store is filled
PLATFORM_RULES = ("welcome_bonus_100", "second_deposit_boost", "verified_account_credit",
                  "boost_code_reload", "friday_reload")
PLATFORM_BLACKLISTED = "bad-dev"


def platform_ops(seed: int, n_ops: int, n_accounts: int, n_claims: int) -> list[tuple]:
    """A seeded wallet stream: (kind, account index, amount, key, device,
    game category, rule, seconds to the next operation). Deposits, bets,
    wins and withdrawals at a human pace, ``n_claims`` bonus claims, velocity
    bursts (eight deposits half a second apart) and a blacklisted device on
    one operation in 25."""
    rng = np.random.default_rng(seed)
    ops, i = [], 0
    while len(ops) < n_ops - n_claims:
        acct = int(rng.integers(n_accounts))
        amount = int(rng.integers(500, 150_000))
        device = PLATFORM_BLACKLISTED if rng.random() < 0.04 else f"dev{acct % 997}"
        if rng.random() < 0.02:
            for j in range(min(8, n_ops - n_claims - len(ops))):
                ops.append(("deposit", acct, amount, f"v{i}-{j}", device, "", "", 0.5))
        else:
            kind = str(rng.choice(["deposit", "bet", "win", "withdraw"], p=[0.3, 0.4, 0.15, 0.15]))
            cat = str(rng.choice(["slots", "video_poker", "table_games", ""]))
            ops.append((kind, acct, amount // (10 if kind == "bet" else 1), f"k{i}", device,
                        cat, "", float(rng.choice([1.0, 30.0, 600.0]))))
        i += 1
    for k, at in enumerate(sorted(rng.choice(n_ops, n_claims, replace=False).tolist())):
        ops.insert(at, ("claim", int(rng.integers(n_accounts)), int(rng.integers(500, 150_000)),
                        f"c{k}", "", "", PLATFORM_RULES[rng.integers(len(PLATFORM_RULES))], 5.0))
    return ops


def apply_platform_op(app, account_id: str, op: tuple):
    """One operation through the app's public flows; the outcome as plain
    data (an exception by its class name)."""
    kind, _, amount, key, device, cat, rule, _ = op
    try:
        if kind == "claim":
            b = app.claim_bonus(account_id, rule, deposit_amount=amount)
            return ("bonus", b.rule_id, b.bonus_amount, b.wagering_required)
        if kind == "bet":
            res = app.bet(account_id, amount, key, game_category=cat, device_id=device)
        elif kind == "win":
            res = app.win(account_id, amount, key)
        else:
            res = getattr(app, kind)(account_id, amount, key, device_id=device)
    except Exception as exc:  # noqa: BLE001 - the exception is the outcome
        return type(exc).__name__
    tx = res.transaction
    return ("ok", res.new_balance, res.risk_score, res.real_deducted, res.bonus_deducted,
            tx.type.value, tx.amount, tx.status.value)


class GateRecorder:
    """In front of an app's engine (its risk gate's) and its abuse gate: the
    response columns of every gate score, every abuse check's score, and the
    time each took."""

    def __init__(self, app):
        self.engine = app.engine
        self.abuse = app.abuse
        self.rows: list[tuple] = []
        self.features: list[np.ndarray] = []
        self.abuse_scores: list[float] = []
        self.gate_s = 0.0
        app.risk_gate.engine = self
        app.bonus.risk_checker = self.is_abuser

    def score(self, req, *args, **kwargs):
        from igaming_platform_tpu_torch.core.enums import REASON_BIT_ORDER

        t = time.perf_counter()
        resp = self.engine.score(req, *args, **kwargs)
        self.gate_s += time.perf_counter() - t
        self.rows.append((resp.score, {"approve": 1, "review": 2, "block": 3}[resp.action],
                          resp.rule_score, resp.ml_score,
                          sum(1 << REASON_BIT_ORDER.index(c) for c in resp.reason_codes)))
        self.features.append(resp.features.to_array())
        return resp

    def is_abuser(self, account_id: str) -> bool:
        score, _, _ = self.abuse.check(account_id)
        self.abuse_scores.append(score)
        return score >= self.abuse.threshold

    def columns(self) -> dict:
        cols = np.array([r[:3] + (r[4],) for r in self.rows], dtype=np.int64).reshape(-1, 4)
        return {"score": cols[:, 0], "action": cols[:, 1], "rule_score": cols[:, 2],
                "reason_mask": cols[:, 3],
                "ml_score": np.array([r[3] for r in self.rows], dtype=np.float32)}

    def __getattr__(self, name):
        return getattr(self.engine, name)


def platform_app(tree, model, device: str, clock, sqlite_path: str = ""):
    from igaming_platform_tpu_torch.core.config import ScoringConfig
    from igaming_platform_tpu_torch.platform.app import AppConfig, PlatformApp

    block, review = PLATFORM_THRESHOLDS
    app = PlatformApp(AppConfig(sqlite_path=sqlite_path, scoring=ScoringConfig(
        block_threshold=block, review_threshold=review)), ml_backend="mlp+gbdt", params=tree,
        abuse_params=model, device=device, clock=clock)
    app.engine.features.add_to_blacklist("device", PLATFORM_BLACKLISTED)
    return app


class PlatformCounts:
    """The kernel launch counters and the engine's and detector's step
    counts, zeroed together and read together."""

    def __init__(self, gbdt_kernel, fa, dense_mod, apps):
        self.mods, self.apps = (gbdt_kernel, fa, dense_mod), apps

    def zero(self) -> None:
        gbdt_kernel, fa, dense_mod = self.mods
        gbdt_kernel.gbdt_forest.launches = 0
        fa.flash_attention_fwd.launches = 0
        dense_mod.dense.launches = dense_mod.dense_f32.launches = 0
        self.steps0 = [(a.engine.device_steps, a.abuse.device_steps) for a in self.apps]

    def read(self, layers: int, cfg, checks: int, device: str, what: str) -> dict:
        """The launches since ``zero``, held to the steps and checks counted:
        forest one a step, dense ``layers`` a step, the forward n_layers a
        detector step and dense_f32 ``affine_layers`` a detector step, and one
        detector step a check."""
        gbdt_kernel, fa, dense_mod = self.mods
        steps = sum(a.engine.device_steps - s for a, (s, _) in zip(self.apps, self.steps0))
        abuse_steps = sum(a.abuse.device_steps - s for a, (_, s) in zip(self.apps, self.steps0))
        out = {"device_steps": steps, "abuse_steps": abuse_steps, "checks": checks,
               "forest": gbdt_kernel.gbdt_forest.launches, "dense": dense_mod.dense.launches,
               "forward": fa.flash_attention_fwd.launches,
               "dense_f32": dense_mod.dense_f32.launches}
        if device == "cuda":
            want = {"forest": steps, "dense": layers * steps, "forward": cfg.n_layers * checks,
                    "dense_f32": affine_layers(cfg) * checks}
            if steps == 0 or abuse_steps != checks or any(
                    out[k] != v for k, v in want.items()):
                raise AssertionError(f"{what}: launches {out} do not match {want}")
        return out


def hold_gate_errors(errors: dict, last_error, what: str) -> None:
    """Every gate that fails open (or closed) swallowed nothing: a kernel
    that failed would otherwise pass each operation unscored."""
    if any(errors.values()):
        raise AssertionError(f"{what}: the gates swallowed {errors}: {last_error!r}")


def platform_run(app, ops, clock, accounts: int) -> dict:
    """``ops`` over ``accounts`` new accounts through ``app`` under the
    pinned ``clock``: the outcome of each, and what its gates recorded."""
    rec = GateRecorder(app)
    ids = [app.wallet.create_account(f"player{i}").id for i in range(accounts)]
    t0 = time.perf_counter()
    outcomes = []
    for op in ops:
        outcomes.append(apply_platform_op(app, ids[op[1]], op))
        clock[0] += op[-1]
    return {"outcomes": outcomes, "rec": rec, "ids": ids, "seconds": time.perf_counter() - t0}


def platform_cpu_twin(path: str) -> None:
    """Phase 15's CPU twin app (its tree, the detector's tree and config
    pickled at ``path + ".in"``) through the parity operations, in a child
    process beside the card's app (``ChildTwin``): what ``platform_parity``
    holds the card app to."""
    import pickle

    from igaming_platform_tpu_torch.convert import sequence_from_tree
    from igaming_platform_tpu_torch.models.sequence import SeqConfig

    with open(path + ".in", "rb") as f:
        tree, seq, cfg, counts = pickle.load(f)
    clock = [PLATFORM_T0]
    app = platform_app(tree, sequence_from_tree(seq, SeqConfig(**cfg)), "cpu", lambda: clock[0])
    try:
        run = platform_run(app, platform_ops(15, *counts), clock, counts[1])
        hold_gate_errors(app.gate_errors(), app.wallet.last_gate_error, "platform parity twin")
        rec = run["rec"]
        out = {"outcomes": run["outcomes"], "columns": rec.columns(), "rows": len(rec.rows),
               "features": np.stack(rec.features) if rec.features else None,
               "abuse_scores": rec.abuse_scores, "seconds": run["seconds"],
               "history": [app.abuse.history_length(run["ids"][i])
                           for i in range(0, counts[1], 10)]}
    finally:
        app.close()
    with open(path + ".out", "wb") as f:
        pickle.dump(out, f)


def platform_parity(torch, tree, model, cfg, counts_cls, device: str, card: str) -> dict:
    """(a) The card app against its CPU twin, operation by operation; the
    twin runs the same operations under its own pinned clock in a child
    process (``platform_cpu_twin``) beside the card's app."""
    from dataclasses import asdict

    from igaming_platform_tpu_torch.convert import sequence_to_tree

    sizes = (PLATFORM_PARITY_OPS, PLATFORM_PARITY_ACCOUNTS, PLATFORM_PARITY_CLAIMS)
    twin = ChildTwin("platform_cpu_twin", (tree, sequence_to_tree(model), asdict(cfg), sizes),
                     "platform", threads=2)
    twin.start()
    clock = [PLATFORM_T0]
    card_app = platform_app(tree, model, device, lambda: clock[0])
    ops = platform_ops(15, *sizes)
    try:
        counts = counts_cls([card_app])
        counts.zero()
        run = platform_run(card_app, ops, clock, PLATFORM_PARITY_ACCOUNTS)
        rec = run["rec"]
        launches = counts.read(len(tree["mlp"]["layers"]), cfg, len(rec.abuse_scores),
                               device, "platform parity")
        hold_gate_errors(card_app.gate_errors(), card_app.wallet.last_gate_error,
                         "platform parity")
        cpu = twin.result()
        differ = [k for k, (c, p) in enumerate(zip(run["outcomes"], cpu["outcomes"])) if c != p]
        if differ or len(run["outcomes"]) != len(cpu["outcomes"]):
            k = differ[0] if differ else len(cpu["outcomes"])
            raise AssertionError(f"platform parity: {len(differ)} operations differ, first "
                                 f"{ops[k]}: {run['outcomes'][k:k + 1]} against "
                                 f"{cpu['outcomes'][k:k + 1]}")
        if len(rec.rows) != cpu["rows"] or not rec.rows:
            raise AssertionError("platform parity: the gates scored different operations")
        boundary = compare_columns(rec.columns(), cpu["columns"], "platform gate")
        if not np.array_equal(np.stack(rec.features).view(np.int32),
                              cpu["features"].view(np.int32)):
            raise AssertionError("platform parity: the gates' feature rows differ")
        abuse_err = float(np.abs(np.subtract(rec.abuse_scores, cpu["abuse_scores"])).max())
        if abuse_err > ABUSE_ATOL:
            raise AssertionError(f"platform parity: abuse scores differ by {abuse_err}")
        names = [c if isinstance(c, str) else c[0] for c in run["outcomes"]]
        kinds = {n: names.count(n) for n in sorted(set(names))}
        history = [card_app.abuse.history_length(run["ids"][i])
                   for i in range(0, PLATFORM_PARITY_ACCOUNTS, 10)]
        if history != cpu["history"]:
            raise AssertionError("platform parity: abuse histories differ")
        return {"ops": len(ops), "outcomes": kinds, "gate_scores": len(rec.rows),
                "abuse_checks": len(rec.abuse_scores), "floor_boundary_rows": boundary,
                "abuse_max_abs_err": abuse_err, "seconds_card_app": run["seconds"],
                "seconds_cpu_twin": cpu["seconds"], "launches": launches}
    finally:
        twin.close()
        card_app.close()


def percentiles_ms(samples: list[float]) -> dict:
    return {"n": len(samples), "p50": float(np.percentile(samples, 50)) * 1e3,
            "p99": float(np.percentile(samples, 99)) * 1e3}


def platform_scale(torch, tree, model, cfg, counts_cls, device: str, card: str) -> dict:
    """(b) A SQLite store of PLATFORM_ACCOUNTS accounts, then PLATFORM_OPS
    operations over PLATFORM_ACTIVE of them, timed; reconcile over all."""
    import shutil
    import tempfile

    from igaming_platform_tpu_torch.platform.reconcile import Reconciler
    from igaming_platform_tpu_torch.serve.scorer import ScoreRequest

    root = tempfile.mkdtemp(prefix="chip-smoke-wallet-")
    clock = [PLATFORM_T0]
    app = platform_app(tree, model, device, lambda: clock[0], os.path.join(root, "wallet.db"))
    rec = GateRecorder(app)
    pumped = [0.0]
    pump = app.pump

    def timed_pump():
        t = time.perf_counter()
        pump()
        pumped[0] += time.perf_counter() - t

    try:
        # The store, filled through create_account in units of work of
        # PLATFORM_CREATE_BATCH accounts, their events relayed in each.
        t0 = time.perf_counter()
        ids = []
        for start in range(0, PLATFORM_ACCOUNTS, PLATFORM_CREATE_BATCH):
            with app.store.unit_of_work():
                ids += [app.wallet.create_account(f"player{i}").id
                        for i in range(start, min(start + PLATFORM_CREATE_BATCH,
                                                  PLATFORM_ACCOUNTS))]
                app.outbox_relay.flush()
            app.pump()
        fill_s = time.perf_counter() - t0
        # The floors under every operation, measured here: one audit row's
        # commit, and one score() of the engine alone.
        t = time.perf_counter()
        for _ in range(200):
            app.store.audit("probe", "commit", "floor")
        commit_floor_ms = (time.perf_counter() - t) / 200 * 1e3
        score_ms = []
        for i in range(200):
            req = ScoreRequest(account_id=ids[i], amount=5_000, tx_type="deposit")
            t = time.perf_counter()
            app.engine.score(req)
            score_ms.append((time.perf_counter() - t) * 1e3)
        score_floor_ms = float(np.median(score_ms))

        ops = platform_ops(16, PLATFORM_OPS, PLATFORM_ACTIVE, PLATFORM_CLAIMS)
        app.pump = timed_pump
        counts = counts_cls([app])
        counts.zero()
        by_kind: dict[str, list[float]] = {}
        split: dict[str, list[float]] = {"gate": [], "wallet": [], "pump": []}
        outcomes: dict[str, int] = {}
        t0 = time.perf_counter()
        for op in ops:
            gate0, pump0 = rec.gate_s, pumped[0]
            t = time.perf_counter()
            out = apply_platform_op(app, ids[op[1]], op)
            dt = time.perf_counter() - t
            clock[0] += op[-1]
            name = out if isinstance(out, str) else out[0]
            outcomes[name] = outcomes.get(name, 0) + 1
            by_kind.setdefault(op[0], []).append(dt)
            if op[0] == "deposit" and name == "ok":
                gate, pumped_s = rec.gate_s - gate0, pumped[0] - pump0
                split["gate"].append(gate)
                split["pump"].append(pumped_s)
                split["wallet"].append(dt - gate - pumped_s)
        ops_s = time.perf_counter() - t0
        launches = counts.read(len(tree["mlp"]["layers"]), cfg, len(rec.abuse_scores), device,
                               "platform scale")
        app.pump = pump
        hold_gate_errors(app.gate_errors(), app.wallet.last_gate_error, "platform scale")
        if not rec.abuse_scores:
            raise AssertionError("platform scale: no abuse check ran")
        for need in ("RiskReviewError", "RiskBlockedError", "bonus", "ok"):
            if not outcomes.get(need):
                raise AssertionError(f"platform scale: no {need} outcome in {outcomes}")

        t = time.perf_counter()
        report = Reconciler(app.wallet.accounts, app.wallet.ledger).run_once()
        reconcile_s = time.perf_counter() - t
        if report.checked != PLATFORM_ACCOUNTS or report.mismatched != 0:
            raise AssertionError(f"platform scale: reconcile checked {report.checked}, "
                                 f"{report.mismatched} mismatched")
        unrelayed = len(list(app.store.outbox_drain()))
        seen = (app.bridge.events_processed + app.bridge.events_skipped)
        if unrelayed or seen != app.outbox_relay.published_total:
            raise AssertionError(f"platform scale: {unrelayed} outbox rows unrelayed; the bridge "
                                 f"saw {seen} of {app.outbox_relay.published_total}")
        return {"accounts": PLATFORM_ACCOUNTS, "fill_s": fill_s, "ops": len(ops),
                "active_accounts": PLATFORM_ACTIVE, "ops_s": ops_s, "ops_per_s": len(ops) / ops_s,
                "outcomes": outcomes,
                "latency_ms": {k: percentiles_ms(v) for k, v in sorted(by_kind.items())},
                "deposit_split_ms": {k: float(np.median(v)) * 1e3 for k, v in split.items()},
                "commit_floor_ms": commit_floor_ms, "score_floor_ms": score_floor_ms,
                "reconcile_s": reconcile_s,
                "relayed": app.outbox_relay.published_total, "abuse_checks": len(rec.abuse_scores),
                "launches": launches}
    finally:
        app.pump = pump
        app.close()
        shutil.rmtree(root, ignore_errors=True)


def outage_broker_cls():
    """The port's fake broker with an outage: every connection dropped,
    and new ones refused for a while, its queues kept."""
    from igaming_platform_tpu_torch.serve import amqp_testing

    class OutageBroker(amqp_testing.FakeAmqpServer):
        refuse_until = 0.0

        def outage(self, seconds: float) -> None:
            self.refuse_until = time.monotonic() + seconds
            self.drop_connections()

        def _accept_loop(self) -> None:
            while not self._stop.is_set():
                try:
                    sock, _ = self._listener.accept()
                except OSError:
                    return
                if self._stop.is_set() or time.monotonic() < self.refuse_until:
                    sock.close()
                    if self._stop.is_set():
                        return
                    continue
                conn = amqp_testing._ClientConn(self, sock)
                with self._lock:
                    self._conns.append(conn)
                conn.start()

    return OutageBroker


def platform_amqp(torch, tree, model, cfg, gbdt_kernel, fa, dense_mod, device: str,
                  card: str) -> dict:
    """(c) The risk service on the card behind the port's AMQP broker: a
    wallet gated by its engine stages PLATFORM_AMQP_OPS operations' events
    in its outbox; then the relay publishes them over AMQP to the service's
    bridge, timed from the relay's start to the last event consumed, with
    one outage once half are published; then the bridge against an
    in-process twin fed the events it processed, in its order."""
    import types

    from igaming_platform_tpu_torch.convert import from_jax_params
    from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
    from igaming_platform_tpu_torch.core.enums import EXCHANGE_WALLET
    from igaming_platform_tpu_torch.platform.outbox import (
        InMemoryOutbox,
        OutboxPublisher,
        OutboxRelay,
    )
    from igaming_platform_tpu_torch.platform.repository import (
        InMemoryAccountRepository,
        InMemoryLedgerRepository,
        InMemoryTransactionRepository,
    )
    from igaming_platform_tpu_torch.platform.risk_adapter import InProcessRiskGate
    from igaming_platform_tpu_torch.platform.wallet import WalletConfig, WalletService
    from igaming_platform_tpu_torch.serve import bridge as bridge_mod
    from igaming_platform_tpu_torch.serve import events, feature_store, scorer
    from igaming_platform_tpu_torch.serve import server as server_mod

    clock = [PLATFORM_T0]
    now = lambda: clock[0]  # noqa: E731
    broker = outage_broker_cls()()
    config = RiskServiceConfig(batcher=BatcherConfig(batch_size=256, latency_tiers=(8,),
                                                     max_wait_ms=1.0), rabbitmq_url=broker.url)
    assembled = server_mod.assemble_risk_service(
        config, ml_backend="mlp+gbdt", params=from_jax_params("mlp+gbdt", tree),
        abuse_params=model, broker=broker.url, device=device,
        feature_store=feature_store.InMemoryFeatureStore(clock=now))
    server = server_mod.RiskServer(assembled, grpc_port=0, http_port=0)
    wire = assembled.bridge
    order: list[str] = []
    process = wire._process_event

    def recorded(event):
        process(event)  # recorded once processed: a retried event counts once
        order.append(event.to_json())

    wire._process_event = recorded
    outbox = InMemoryOutbox()
    relay_target = events.make_relay_target(broker.url)
    relay_target.max_retries, relay_target.retry_delay = 2, 0.05
    breaker = server.supervisor.breaker("amqp")
    relay_target.on_publish_result = server_mod.amqp_breaker_feed(breaker)
    relay = OutboxRelay(outbox, relay_target, poll_interval_s=0.005, max_backoff_s=0.25)
    block, review = PLATFORM_THRESHOLDS
    wallet = WalletService(InMemoryAccountRepository(), InMemoryTransactionRepository(),
                           InMemoryLedgerRepository(), events=OutboxPublisher(outbox),
                           risk=InProcessRiskGate(assembled.engine), clock=now,
                           config=WalletConfig(risk_threshold_block=block,
                                               risk_threshold_review=review))
    counts = PlatformCounts(gbdt_kernel, fa, dense_mod, [
        types.SimpleNamespace(engine=assembled.inner, abuse=assembled.abuse)])
    twin = None
    try:
        ids = [wallet.create_account(f"player{i}").id for i in range(PLATFORM_ACTIVE)]
        ops = platform_ops(17, PLATFORM_AMQP_OPS, PLATFORM_ACTIVE, 0)
        counts.zero()
        for op in ops:
            kind, acct, amount, key, device_id, cat, _, step = op
            try:
                if kind == "win":
                    wallet.win(ids[acct], amount, key)
                elif kind == "bet":
                    wallet.bet(ids[acct], amount, key, game_category=cat, device_id=device_id)
                else:
                    getattr(wallet, kind)(ids[acct], amount, key, device_id=device_id)
            except Exception:  # noqa: BLE001 - refusals are outcomes; the gate counts its own
                pass
            clock[0] += step
        staged = len(list(outbox.outbox_drain()))
        t0 = time.perf_counter()
        relay.start()
        deadline = time.monotonic() + 90.0
        outage_at = None
        while (wire.events_processed + wire.events_skipped < staged
               and time.monotonic() < deadline):
            if outage_at is None and relay_target.published >= staged // 2:
                outage_at = time.perf_counter() - t0
                broker.outage(PLATFORM_OUTAGE_S)
            time.sleep(0.002)
        seconds = time.perf_counter() - t0
        relay.stop(drain=True)
        if list(outbox.outbox_drain()) or relay.published_total != staged:
            raise AssertionError(f"platform amqp: {relay.published_total} of {staged} outbox "
                                 "rows relayed")
        consumed = wire.events_processed + wire.events_skipped
        if consumed != staged:
            raise AssertionError(f"platform amqp: the bridge consumed {consumed} of {staged} "
                                 "events once")
        launches = counts.read(len(tree["mlp"]["layers"]), cfg, 0, device, "platform amqp")
        if relay_target.reconnects < 1 or breaker.snapshot()["failures_total"] < 1:
            raise AssertionError(f"platform amqp: the outage went unseen (reconnects "
                                 f"{relay_target.reconnects}, breaker {breaker.snapshot()})")
        hold_gate_errors(wallet.gate_errors, wallet.last_gate_error, "platform amqp")

        # The twin: the same events, in the bridge's order, in process (the
        # mock backend on the CPU: feature rows do not depend on the model).
        twin_engine = scorer.TorchScoringEngine(
            device="cpu", batcher_config=BatcherConfig(batch_size=256, latency_tiers=(8,),
                                                       max_wait_ms=1.0),
            feature_store=feature_store.InMemoryFeatureStore(clock=now), warmup=False)
        twin = bridge_mod.ScoringBridge(twin_engine, events.default_broker())
        for raw in order:
            twin.broker.publish_raw(EXCHANGE_WALLET, json.loads(raw)["type"], raw)
        twin.drain()
        rows = np.zeros((2, len(ids), N_FEATURES), np.float32)
        for i, a in enumerate(ids):
            assembled.inner.features.fill_row(rows[0, i], a, 5000, "bet", now=clock[0])
            twin_engine.features.fill_row(rows[1, i], a, 5000, "bet", now=clock[0])
        if not np.array_equal(rows[0].view(np.int32), rows[1].view(np.int32)):
            raise AssertionError("platform amqp: feature rows differ from the in-process twin")
        gate = platform_grpc_gate(server, assembled, wallet, ids, clock, counts, tree, cfg,
                                  device)
        launches = {k: launches[k] + gate["launches"][k] for k in launches}
        return {"ops": len(ops), "events": staged, "events_per_s": staged / seconds,
                "grpc_gate": gate,
                "seconds": seconds, "outage_at_s": outage_at, "duplicates": wire.events_deduped,
                "relay_reconnects": relay_target.reconnects,
                "bridge_publisher_reconnects": wire.publisher.reconnects,
                "relay_failed_drains": relay.failed_total, "breaker": breaker.snapshot(),
                "processed": wire.events_processed, "skipped": wire.events_skipped,
                "launches": launches}
    finally:
        relay.stop(drain=False)
        relay_target.close()
        server.shutdown(grace=1.0)
        if twin is not None:
            twin.engine.close()
        broker.close()


PLATFORM_GATE_OPS = 300  # wallet operations gated over gRPC (phase 15, amqp part)


class PairedGate:
    """The wallet's risk gate: ``remote`` decides; ``local`` scores the same
    call, and both decisions are kept."""

    def __init__(self, remote, local):
        self.remote, self.local = remote, local
        self.pairs: list[tuple] = []

    def score_transaction(self, *args, **kwargs):
        got = self.remote.score_transaction(*args, **kwargs)
        self.pairs.append((got, self.local.score_transaction(*args, **kwargs)))
        return got


def platform_grpc_gate(server, assembled, wallet, ids, clock, counts, tree, cfg,
                       device: str) -> dict:
    """The amqp part's wallet gated by a ``GrpcRiskGate`` dialing its
    ``RiskServer`` over the port's gRPC transport, PLATFORM_GATE_OPS more
    operations: each decision (score, action, reasons) equal to the
    in-process gate's on the same call, the store unchanged between the two
    (the outbox is no longer relayed)."""
    from igaming_platform_tpu_torch.platform.risk_adapter import GrpcRiskGate, InProcessRiskGate

    remote = GrpcRiskGate(f"localhost:{server.grpc_port}", timeout=30.0)
    gate, saved = PairedGate(remote, InProcessRiskGate(assembled.engine)), wallet.risk
    wallet.risk = gate
    errors0 = dict(wallet.gate_errors)
    try:
        ops = platform_ops(18, PLATFORM_GATE_OPS, len(ids), 0)
        counts.zero()
        t0 = time.perf_counter()
        for kind, acct, amount, key, device_id, cat, _, step in ops:
            try:
                if kind == "win":
                    wallet.win(ids[acct], amount, f"g{key}")
                elif kind == "bet":
                    wallet.bet(ids[acct], amount, f"g{key}", game_category=cat,
                               device_id=device_id)
                else:
                    getattr(wallet, kind)(ids[acct], amount, f"g{key}", device_id=device_id)
            except Exception:  # noqa: BLE001 - refusals are outcomes; the gate errors are held
                pass
            clock[0] += step
        seconds = time.perf_counter() - t0
        launches = counts.read(len(tree["mlp"]["layers"]), cfg, 0, device, "platform grpc gate")
    finally:
        wallet.risk = saved
        remote.close()
    if wallet.gate_errors != errors0:
        raise AssertionError(f"platform grpc gate: gate errors {wallet.gate_errors} "
                             f"({wallet.last_gate_error!r})")
    differ = [i for i, (got, want) in enumerate(gate.pairs) if got != want]
    if len(gate.pairs) < 200 or differ:
        i = differ[0] if differ else 0
        raise AssertionError(f"platform grpc gate: {len(differ)} of {len(gate.pairs)} decisions "
                             f"differ, first {gate.pairs[i:i + 1]}")
    actions = [got[1] for got, _ in gate.pairs]
    return {"ops": len(ops), "decisions": len(gate.pairs), "seconds": seconds,
            "actions": {a: actions.count(a) for a in sorted(set(actions))},
            "launches": launches}


def phase_platform(torch, card: str, gbdt_kernel, fa, dense_mod, device: str = "cuda") -> dict:
    """Phase 15: the wallet side on the card (``platform_parity``,
    ``platform_scale``, ``platform_amqp``). ``device="cpu"`` rehearses it
    without a card (the launch checks then skipped)."""
    from igaming_platform_tpu_torch.convert import sequence_from_tree
    from igaming_platform_tpu_torch.models.sequence import SeqConfig

    t0 = time.perf_counter()
    rng = np.random.default_rng(150)
    tree = {"mlp": mlp_tree(rng, SERVE_HIDDEN), "gbdt": forest_tree(rng, SERVE_TREES, SERVE_DEPTH)}
    cfg = SeqConfig(**ABUSE_CFG)
    seq = seq_tree(rng, ABUSE_CFG)
    seq["head"]["b"] = seq["head"]["b"] + np.float32(PLATFORM_ABUSE_BIAS_SHIFT)
    model = sequence_from_tree(seq, cfg)

    def counts_cls(apps):
        return PlatformCounts(gbdt_kernel, fa, dense_mod, apps)

    parity = platform_parity(torch, tree, model, cfg, counts_cls, device, card)
    log(f"phase 15: [{card}] parity: {parity['ops']} operations through the card app and its "
        f"CPU twin, outcomes equal ({json.dumps(parity['outcomes'])}); {parity['gate_scores']} "
        f"gate scores ({parity['floor_boundary_rows']} floor-boundary rows not compared), "
        f"{parity['abuse_checks']} abuse checks within {parity['abuse_max_abs_err']:.3g}; "
        f"launches {json.dumps(parity['launches'])}")
    scale = platform_scale(torch, tree, model, cfg, counts_cls, device, card)
    log(f"phase 15: [{card}] scale: {scale['accounts']} accounts filled in {scale['fill_s']:.1f} s; "
        f"{scale['ops']} operations over {scale['active_accounts']} accounts at "
        f"{scale['ops_per_s']:.1f} ops/s ({json.dumps(scale['outcomes'])}); latency ms "
        f"{json.dumps(scale['latency_ms'])}; a deposit's split ms "
        f"{json.dumps(scale['deposit_split_ms'])} (floors: a commit "
        f"{scale['commit_floor_ms']:.3f} ms, a score() {scale['score_floor_ms']:.3f} ms)"
        f"; reconcile of {scale['accounts']} accounts in {scale['reconcile_s']:.1f} s, 0 "
        f"mismatches; {scale['relayed']} outbox rows relayed; launches "
        f"{json.dumps(scale['launches'])}")
    wire = platform_amqp(torch, tree, model, cfg, gbdt_kernel, fa, dense_mod, device, card)
    log(f"phase 15: [{card}] amqp: {wire['ops']} operations, {wire['events']} events outbox -> "
        f"bridge in {wire['seconds']:.2f} s, {wire['events_per_s']:.1f} events/s, through a "
        f"{PLATFORM_OUTAGE_S} s outage at {wire['outage_at_s']:.2f} s "
        f"(relay reconnects {wire['relay_reconnects']}, {wire['duplicates']} duplicates "
        f"deduped, amqp breaker {json.dumps(wire['breaker'])}); feature rows equal to the "
        f"in-process twin")
    g = wire["grpc_gate"]
    log(f"phase 15: [{card}] grpc gate: {g['ops']} operations gated by a GrpcRiskGate over the "
        f"port's gRPC transport, {g['decisions']} decisions ({json.dumps(g['actions'])}) equal to "
        f"the in-process gate's, in {g['seconds']:.2f} s; launches {json.dumps(g['launches'])}")
    result = {"parity": parity, "scale": scale, "amqp": wire,
              "launches": {k: parity["launches"][k] + scale["launches"][k]
                           + wire["launches"][k] for k in ("forest", "dense", "forward",
                                                           "dense_f32")},
              "seconds": time.perf_counter() - t0}
    log(f"phase 15: {result['seconds']:.1f} s")
    log("phase 15: " + json.dumps(result, default=str))
    return result


# Phase 16: the stores of record and the wallet's own front. A Postgres
# protocol-v3 rig (the port's platform/pg_testing.py over one SQLite file)
# holding STORES_ACCOUNTS accounts (ids of phase 7's native store) and a
# history of STORES_HISTORY completed transactions among them, written into
# the file directly after the store's bootstrap over the wire (the SQLite
# store on the card gets the same accounts, without the history); STORES_OPS
# wallet.v1 operations over STORES_ACTIVE accounts through each server's
# serve_wallet and the port's gRPC client over loopback (Postgres on the
# card, SQLite on the card, SQLite on the CPU); the LTV job
# over postgres:// and sqlite://; the batch refresh of phase 7's store from
# the rig and from a ClickHouse stand-in, then STORES_REFRESH_RPCS ScoreBatch
# RPCs to a row-mode and an IDX1 engine; the Redis store over a dict-backed
# client; last, the decision ledger's Postgres sink on the same rig under
# STORES_LEDGER_RPCS ScoreBatch RPCs (its drain takes the interpreter's lock
# often enough to slow whatever runs beside it, so it runs alone).
STORES_ACCOUNTS, STORES_HISTORY = SERVER_ACCOUNTS, 50_000
STORES_OPS, STORES_ACTIVE = 2_000, 400
STORES_LEDGER_RPCS, STORES_REFRESH_RPCS, STORES_REDIS_ROWS = 2, 4, 4096
# The wallet's risk thresholds (block, review): the gate's random weights
# score an operation 9-21 alone and 29-41 from a blacklisted device, so a few
# percent are refused for review and a few blocked.
STORES_THRESHOLDS = (40, 25)
STORES_DRAIN_S = 120.0  # the ledger sink's drain: a time limit, not an expectation
STORES_INDEX_CAPACITY = 131_072
STORES_OP_MIX = (("Deposit", 0.27), ("Bet", 0.33), ("Win", 0.12), ("Withdraw", 0.1),
                 ("Refund", 0.03), ("GetBalance", 0.08), ("GetTransactionHistory", 0.07))


def stores_fill(path: str, n_accounts: int, n_history: int, rng) -> dict:
    """``n_accounts`` accounts (``acct{i}``, phase 7's ids; balance 0, created
    up to two years before SERVER_NOW) and ``n_history`` completed
    transactions among them, written straight into a wallet file whose
    schema the store's bootstrap made; no ledger entries, so the books
    reconcile. Returns the rows written and the seconds."""
    import sqlite3

    t = time.perf_counter()
    created = SERVER_NOW - rng.random(n_accounts) * 730 * 86400.0
    db = sqlite3.connect(path)
    try:
        db.executemany(
            "INSERT INTO accounts (id, player_id, currency, balance, bonus, status, version,"
            " created_at, updated_at) VALUES (?,?,'USD',0,0,'active',1,?,?)",
            [(f"acct{i}", f"player{i}", float(c), float(c)) for i, c in enumerate(created)])
        accts = rng.integers(0, n_accounts, n_history)
        kinds = np.array(["deposit", "bet", "win", "withdraw"])[
            rng.choice(4, n_history, p=[0.35, 0.4, 0.15, 0.1])]
        amounts = rng.integers(100, 500_000, n_history)
        ts = created[accts] + rng.random(n_history) * (SERVER_NOW - created[accts])
        db.executemany(
            "INSERT INTO transactions (id, account_id, idempotency_key, type, amount,"
            " balance_before, balance_after, status, reference, game_id, round_id, risk_score,"
            " created_at, completed_at) VALUES (?,?,?,?,?,0,0,'completed','history',NULL,NULL,"
            "NULL,?,?)",
            [(f"h{j}", f"acct{a}", f"h{j}", str(k), int(m), float(s), float(s))
             for j, (a, k, m, s) in enumerate(zip(accts, kinds, amounts, ts))])
        db.commit()
    finally:
        db.close()
    return {"accounts": n_accounts, "history": n_history, "seconds": time.perf_counter() - t}


class StepCounts:
    """The forest and dense launch counters against card engines' device
    steps: ``begin(engines)`` sets the counts to 0 just before a path's run,
    ``end`` reads them just after and holds them to one forest and ``layers``
    dense launches a step; the totals accumulate over the phase."""

    def __init__(self, gbdt_kernel, dense_mod, layers: int, device: str):
        self.mods, self.layers, self.device = (gbdt_kernel, dense_mod), layers, device
        self.total = {"forest": 0, "dense": 0, "device_steps": 0}

    def begin(self, engines) -> None:
        gbdt_kernel, dense_mod = self.mods
        self.engines = [getattr(e, "inner", e) for e in engines]
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()
        gbdt_kernel.gbdt_forest.launches = 0
        dense_mod.dense.launches = 0
        self.steps0 = [e.device_steps for e in self.engines]

    def end(self, what: str) -> dict:
        gbdt_kernel, dense_mod = self.mods
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()
        steps = sum(e.device_steps - s for e, s in zip(self.engines, self.steps0))
        out = {"forest": gbdt_kernel.gbdt_forest.launches, "dense": dense_mod.dense.launches,
               "device_steps": steps}
        if self.device == "cuda" and (steps == 0 or out["forest"] != steps
                                      or out["dense"] != self.layers * steps):
            raise AssertionError(f"{what}: launches {out} against {steps} device steps")
        for k in self.total:
            self.total[k] += out[k]
        return out


class EngineRecorder:
    """In front of a risk gate's engine: the result columns of every score."""

    def __init__(self, engine):
        self.engine, self.rows = engine, []

    def score(self, req, *args, **kwargs):
        resp = self.engine.score(req, *args, **kwargs)
        self.rows.append(response_from_score(resp))
        return resp

    def columns(self) -> dict:
        return {k: np.array([r[k] for r in self.rows]) for k in self.rows[0]}

    def __getattr__(self, name):
        return getattr(self.engine, name)


def stores_ops(seed: int) -> list[tuple]:
    """The logical wallet.v1 stream: a CreateAccount for each of STORES_ACTIVE
    accounts, then (method, account index, amount, key, device) drawn from
    STORES_OP_MIX; a blacklisted device on one operation in 25."""
    rng = np.random.default_rng(seed)
    ops = [("CreateAccount", i, 0, "", "") for i in range(STORES_ACTIVE)]
    kinds, p = zip(*STORES_OP_MIX)
    for i in range(STORES_OPS - STORES_ACTIVE):
        kind = str(rng.choice(kinds, p=np.array(p) / sum(p)))
        acct = int(rng.integers(STORES_ACTIVE))
        amount = int(rng.integers(500, 150_000)) // (10 if kind == "Bet" else 1)
        device = PLATFORM_BLACKLISTED if rng.random() < 0.04 else f"dev{acct % 97}"
        ops.append((kind, acct, amount, f"op{i}", device))
    return ops


def stores_request(wc, op: tuple, ids: list, deposits: dict) -> bytes:
    """One logical operation as wallet.v1 request bytes for one server: its
    own account ids, and for a refund its own last deposit's id."""
    kind, acct, amount, key, device = op
    if kind == "CreateAccount":
        return wc.encode(wc.CREATE_ACCOUNT_REQUEST, {"player_id": f"active{acct}"})
    aid = ids[acct]
    if kind in ("GetBalance", "GetTransactionHistory"):
        return wc.encode(wc.METHODS[kind][0], {"account_id": aid, "limit": 20})
    if kind == "Refund":
        return wc.encode(wc.REFUND_REQUEST, {"account_id": aid, "idempotency_key": key,
                                             "original_transaction_id": deposits.get(
                                                 acct, "missing")})
    return wc.encode(wc.METHODS[kind][0], {"account_id": aid, "amount": amount,
                                           "idempotency_key": key, "device_id": device})


def stores_outcome(wc, kind: str, out) -> tuple:
    """An answer as comparable data: the status, or the decoded fields with
    identifiers (also inside a refund's reference) and timestamps left out."""
    import re

    if isinstance(out, str):
        return (out,)
    msg = wc.decode(wc.METHODS[kind][1], out)
    drop = ("id", "account_id", "created_at", "completed_at", "updated_at")
    uuid = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")

    def strip(m):
        if isinstance(m, dict):
            return {k: strip(v) for k, v in m.items() if k not in drop}
        if isinstance(m, list):
            return [strip(v) for v in m]
        return uuid.sub("<id>", m) if isinstance(m, str) else m

    return ("OK", json.dumps(strip(msg), sort_keys=True))


def stores_wallet_server(cfg_url: str, engine, broker):
    from igaming_platform_tpu_torch.core.config import WalletServiceConfig
    from igaming_platform_tpu_torch.platform.risk_adapter import InProcessRiskGate
    from igaming_platform_tpu_torch.platform.server import WalletServer

    block, review = STORES_THRESHOLDS
    rec = EngineRecorder(engine)
    srv = WalletServer(WalletServiceConfig(database_url=cfg_url, risk_service_addr="",
                                           risk_threshold_block=block,
                                           risk_threshold_review=review),
                       risk_gate=InProcessRiskGate(rec), broker=broker, grpc_port=0,
                       http_port=0)
    return srv, rec


def stores_pg(params, root: str, counts, device: str) -> dict:
    """(1) The wallet over Postgres on the card against SQLite on the card and
    a CPU twin over SQLite, each behind its wallet.v1 gRPC server and called
    through the port's client: the same logical operations, answers equal
    (ids and timestamps left out), gate scores to the engine's tolerance;
    ops/s and latency by kind, the wire's included; the books reconciled
    over the wire; /metrics."""
    from igaming_platform_tpu_torch.core.config import BatcherConfig
    from igaming_platform_tpu_torch.platform.pg_testing import PgSqliteServer
    from igaming_platform_tpu_torch.serve import scorer
    from igaming_platform_tpu_torch.serve import wallet_codec as wc
    from igaming_platform_tpu_torch.serve.events import InMemoryBroker
    from igaming_platform_tpu_torch.serve.feature_store import InMemoryFeatureStore
    from igaming_platform_tpu_torch.serve import grpc_wire
    from igaming_platform_tpu_torch.serve.grpc_server import make_wallet_stub

    rng = np.random.default_rng(160)

    def gate_engine(dev, bcfg):
        store = InMemoryFeatureStore(clock=lambda: PLATFORM_T0)
        store.add_to_blacklist("device", PLATFORM_BLACKLISTED)
        return scorer.TorchScoringEngine(ml_backend="mlp+gbdt", params=params,
                                         batcher_config=bcfg, feature_store=store, device=dev)

    # The CPU twin pads a single score to 8 rows, not 256: a row's bits do
    # not depend on its batch (phase 3's batch invariance), and the twin's
    # 256-row CPU steps were a sixth of the phase's time.
    engine = gate_engine(device, BatcherConfig(batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS,
                                               max_wait_ms=0.0))
    cpu_engine = gate_engine("cpu", BatcherConfig(batch_size=256, latency_tiers=(8,),
                                                  max_wait_ms=0.0))
    rig = PgSqliteServer(os.path.join(root, "wallet-pg.db"))
    servers, channels, result = [], [], {}
    try:
        t = time.perf_counter()
        pg, pg_rec = stores_wallet_server(rig.url, engine, InMemoryBroker())
        servers.append(pg)
        boot_s = time.perf_counter() - t
        sq, sq_rec = stores_wallet_server(f"sqlite://{root}/wallet-sqlite.db", engine,
                                          InMemoryBroker())
        servers.append(sq)
        twin, twin_rec = stores_wallet_server(f"sqlite://{root}/wallet-twin.db",
                                              cpu_engine, InMemoryBroker())
        servers.append(twin)
        # Each store's first reconcile sweep ran at boot over an empty book;
        # the accounts and the history go in after it.
        for srv in servers[:2]:
            deadline = time.monotonic() + 30
            while srv.reconciler.last_report is None and time.monotonic() < deadline:
                time.sleep(0.01)
        fills = [stores_fill(rig.db_path, STORES_ACCOUNTS, STORES_HISTORY,
                             np.random.default_rng(161)),
                 stores_fill(f"{root}/wallet-sqlite.db", STORES_ACCOUNTS, 0,
                             np.random.default_rng(161))]
        # The floors: one score() alone, one commit over the wire and one on
        # SQLite (an audit row each).
        score_ms = []
        for i in range(200):
            t = time.perf_counter()
            engine.score(scorer.ScoreRequest(account_id=f"acct{i}", amount=5_000,
                                             tx_type="deposit"))
            score_ms.append((time.perf_counter() - t) * 1e3)
        commit_ms = {}
        for name, srv in (("postgres", pg), ("sqlite", sq)):
            t = time.perf_counter()
            for _ in range(200):
                srv.store.audit("probe", "commit", "floor")
            commit_ms[name] = (time.perf_counter() - t) / 200 * 1e3

        ops = stores_ops(162)
        # Each server's wallet.v1 over the port's gRPC transport (serve_wallet),
        # through the port's client.
        sides = [{"srv": s, "ids": [], "deposits": {}, "out": [], "ms": {},
                  "channel": grpc_wire.insecure_channel(f"localhost:{s.grpc_port}")}
                 for s in (pg, sq, twin)]
        for side in sides:
            side["stub"] = make_wallet_stub(side["channel"])
            channels.append(side["channel"])
        counts.begin([engine])
        for op in ops:
            kind = op[0]
            for side in sides:
                payload = stores_request(wc, op, side["ids"], side["deposits"])
                t = time.perf_counter()
                try:
                    out = getattr(side["stub"], kind)(payload, timeout=60)
                except grpc_wire.RpcError as exc:
                    out = exc.code().name
                side["ms"].setdefault(kind, []).append(time.perf_counter() - t)
                side["out"].append(stores_outcome(wc, kind, out))
                if kind == "CreateAccount":
                    side["ids"].append(wc.decode(wc.CREATE_ACCOUNT_RESPONSE,
                                                 out)["account"]["id"])
                elif kind == "Deposit" and not isinstance(out, str):
                    side["deposits"][op[1]] = wc.decode(wc.DEPOSIT_RESPONSE,
                                                        out)["transaction"]["id"]
        launches = counts.end("stores: wallet")
        for side, name in zip(sides[1:], ("sqlite on the card", "the CPU twin")):
            differ = [i for i, (a, b) in enumerate(zip(sides[0]["out"], side["out"])) if a != b]
            if differ:
                i = differ[0]
                raise AssertionError(f"stores: {len(differ)} answers over Postgres differ from "
                                     f"{name}'s, first {ops[i]}: {sides[0]['out'][i]} against "
                                     f"{side['out'][i]}")
        if len(pg_rec.rows) != len(twin_rec.rows) or not pg_rec.rows:
            raise AssertionError("stores: the gates scored different operations")
        boundary = compare_columns(pg_rec.columns(), twin_rec.columns(), "stores gate")
        statuses: dict[str, int] = {}
        for op, o in zip(ops, sides[0]["out"]):
            statuses[f"{op[0]} {o[0]}"] = statuses.get(f"{op[0]} {o[0]}", 0) + 1
        for need in ("Deposit OK", "Bet OK", "Win OK", "Withdraw OK", "Refund OK",
                     "GetTransactionHistory OK", "Deposit PERMISSION_DENIED"):
            if not statuses.get(need):
                raise AssertionError(f"stores: no {need} in {statuses}")
        completed: dict[str, int] = {}
        for op, o in zip(ops, sides[0]["out"]):
            if o[0] == "OK" and op[0] in ("Deposit", "Bet", "Win", "Withdraw", "Refund"):
                t_type = json.loads(o[1])["transaction"]["type"]
                completed[t_type] = completed.get(t_type, 0) + 1

        t = time.perf_counter()
        status, report = http_call(pg.http_port, "/debug/reconciliation")
        reconcile_s = time.perf_counter() - t
        n_accounts = STORES_ACCOUNTS + STORES_ACTIVE
        if status != 200 or report["checked"] != n_accounts or report["mismatched"] != 0:
            raise AssertionError(f"stores: reconcile {status} {report['checked']} checked, "
                                 f"{report['mismatched']} mismatched")
        text = http_text(pg.http_port, "/metrics")[1]
        metrics = exposition(text)
        got = {k.split('"')[1]: int(v) for k, v in metrics.items()
               if k.startswith("wallet_transactions_total{")}
        if got != completed or int(metrics.get("wallet_reconciliation_checked", -1)) != n_accounts:
            raise AssertionError(f"stores: /metrics {got} against {completed}, reconciliation "
                                 f"{metrics.get('wallet_reconciliation_checked')}")
        walls = {name: sum(sum(v) for v in s["ms"].values())
                 for name, s in zip(("postgres", "sqlite", "cpu_twin"), sides)}
        result = {
            "boot_s": boot_s, "fill": fills[0], "fill_sqlite": fills[1], "ops": len(ops), "active_accounts": STORES_ACTIVE,
            "statuses": statuses, "completed_by_type": completed,
            "gate_scores": len(pg_rec.rows), "floor_boundary_rows": boundary,
            "ops_per_s": {k: len(ops) / v for k, v in walls.items()},
            "latency_ms": {name: {k: percentiles_ms(v) for k, v in sorted(s["ms"].items())}
                           for name, s in zip(("postgres", "sqlite"), sides)},
            "score_floor_ms": float(np.median(score_ms)), "commit_floor_ms": commit_ms,
            "reconcile_s": reconcile_s, "reconciled_accounts": report["checked"],
            "launches": launches, "rig_url": rig.url,
        }
    finally:
        for channel in channels:
            channel.close()
        for srv in servers:
            srv.shutdown(grace=1.0)
        engine.close()
        cpu_engine.close()
    result["rig"] = rig
    return result


def stores_ledger(params, store, rig_url: str, root: str, counts, device: str) -> dict:
    """(2) LEDGER_SINK=pg: a risk service over phase 7's store with its ledger
    bound and its sink on the phase's rig, STORES_LEDGER_RPCS ScoreBatch RPCs;
    returns the ledger, still draining, and what ``stores_ledger_check``
    needs."""
    from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
    from igaming_platform_tpu_torch.serve import risk_codec as codec
    from igaming_platform_tpu_torch.serve import server

    rng = np.random.default_rng(163)
    directory = os.path.join(root, "ledger")
    env = {"LEDGER_DIR": directory, "LEDGER_SINK": "pg", "LEDGER_PG_URL": rig_url,
           "DRIFT": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        assembled = server.assemble_risk_service(
            RiskServiceConfig(batcher=BatcherConfig(batch_size=BATCH_SIZE,
                                                    latency_tiers=LATENCY_TIERS,
                                                    max_wait_ms=2.0)),
            ml_backend="mlp+gbdt", params=params, feature_store=store, device=device)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    payloads = [codec.encode(codec.SCORE_BATCH_REQUEST,
                             {"transactions": server_requests(codec, rng, SERVER_BATCH_ROWS)})
                for _ in range(STORES_LEDGER_RPCS)]
    STORE_CLOCK[0] = SERVER_NOW
    counts.begin([assembled.engine])
    t = time.perf_counter()
    for p in payloads:
        assembled.service.call("ScoreBatch", p)
    rpc_s = time.perf_counter() - t
    launches = counts.end("stores: ledger")
    return {"assembled": assembled, "directory": directory, "started": time.perf_counter(),
            "noted": STORES_LEDGER_RPCS * SERVER_BATCH_ROWS, "rpc_s": rpc_s,
            "launches": launches}


def stores_ledger_check(ledger_mod, run: dict, rig_path: str) -> dict:
    """Wait for the sink (at most STORES_DRAIN_S), then hold it: every noted
    row appended or dropped, the table's rows equal to the WAL's records
    field for field, every appended row in the table."""
    import sqlite3

    assembled = run["assembled"]
    ledger = assembled.ledger
    try:
        ledger.flush(30.0)
        drained = ledger.drain_sink(timeout=STORES_DRAIN_S)
        drain_s = time.perf_counter() - run["started"]
        stats = ledger.stats()
    finally:
        assembled.engine.close()
        ledger.close()
        assembled.service.close()
    appended, dropped = stats["records_appended"], stats["records_dropped"]
    if appended + dropped != run["noted"]:
        raise AssertionError(f"stores ledger: {appended} appended + {dropped} dropped of "
                             f"{run['noted']} noted")
    cols = ledger_mod.PgDecisionSink._COLS
    db = sqlite3.connect(rig_path)
    try:
        table = {r[0]: tuple(str(v) for v in r) for r in db.execute(
            f"SELECT {', '.join(cols)} FROM risk_decisions")}
    finally:
        db.close()
    wal = {}
    for rec in ledger_mod.iter_records(run["directory"]):
        row = rec.sink_row()
        wal[rec.decision_id] = tuple(str(row[c]) for c in cols)
    if not drained or len(wal) != appended or table != wal:
        raise AssertionError(f"stores ledger: drained {drained}; {len(table)} table rows, "
                             f"{len(wal)} WAL records, {appended} appended; equal "
                             f"{table == wal}")
    return {"noted": run["noted"], "appended": appended, "dropped": dropped,
            "sunk": stats["sink"]["sent"], "sink_failures": stats["sink"]["failures"],
            "table_rows": len(table), "drain_s": drain_s,
            "sink_rows_per_s": len(table) / drain_s, "rpc_s": run["rpc_s"],
            "launches": run["launches"]}


def stores_ltv(ltv_job, rig_url: str, rig_path: str, device: str) -> dict:
    """(3) The LTV job over postgres:// and over sqlite:// on the same file:
    the records bit-equal."""
    got, timings = [], []
    for db in (rig_url, f"sqlite://{rig_path}"):
        t = {}
        got.append(ltv_job.run_batch_job(db, now=SERVER_NOW + 86400.0, device=device,
                                         timings=t))
        timings.append(t)
    if got[0] != got[1] or got[0]["count"] != STORES_ACCOUNTS + STORES_ACTIVE:
        raise AssertionError(f"stores ltv: postgres:// and sqlite:// differ "
                             f"({got[0]['count']} and {got[1]['count']} records)")
    return {"records": got[0]["count"], "postgres": timings[0], "sqlite": timings[1]}


class ClickHouseStandIn:
    """A ClickHouse HTTP interface that answers every query with ``rows`` as
    JSONEachRow, as tests/test_clickhouse.py's fake does."""

    def __init__(self, rows: list[dict]):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        body = "\n".join(json.dumps(r) for r in rows).encode()
        self.queries: list[str] = []
        stand_in = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):  # noqa: N802
                stand_in.queries.append(self.rfile.read(
                    int(self.headers.get("Content-Length", 0))).decode())
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def stores_refresh(torch, params, store, rig_url: str, counts, device: str) -> dict:
    """(4) The batch refresh of phase 7's store from the rig behind a row-mode
    and an IDX1 engine (caches warm), each held to a CPU twin after it; the
    share of rows whose score moved; the same features from a ClickHouse
    stand-in."""
    from igaming_platform_tpu_torch.core.config import BatcherConfig
    from igaming_platform_tpu_torch.serve import batch_refresh, clickhouse, grpc_server, scorer
    from igaming_platform_tpu_torch.serve import risk_codec as codec
    from igaming_platform_tpu_torch.serve import wire

    rng = np.random.default_rng(164)
    bcfg = BatcherConfig(batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0)
    saved = {k: os.environ.get(k) for k in ("DRIFT", "WIRE_MODE", "SESSION_STATE")}
    os.environ.update({"DRIFT": "0", "SESSION_STATE": "0"})
    STORE_CLOCK[0] = SERVER_NOW
    engines = []

    def make(dev, capacity):
        e = scorer.TorchScoringEngine(ml_backend="mlp+gbdt", params=params, batcher_config=bcfg,
                                      feature_store=store, device=dev, feature_cache=capacity,
                                      warmup=False)
        engines.append(e)
        return e

    try:
        row, row_cpu = make(device, None), make("cpu", None)
        os.environ["WIRE_MODE"] = "index"
        idx_cpu, idx = make("cpu", STORES_INDEX_CAPACITY), make(device, STORES_INDEX_CAPACITY)
        services = [grpc_server.RiskGrpcService(e) for e in (row, idx_cpu, idx)]
        for e in (idx_cpu, idx):
            e.ensure_cache()
        store.delta_listener = lambda a, caches=(idx.cache, idx_cpu.cache): [
            c.note_update(a) for c in caches]
        reqs = [server_requests(codec, rng, SERVER_BATCH_ROWS) for _ in range(STORES_REFRESH_RPCS)]
        batches = [codec.encode(codec.SCORE_BATCH_REQUEST, {"transactions": r}) for r in reqs]
        frames = [wire.encode_index_batch([r["account_id"] for r in rs],
                                          [r["amount"] for r in rs],
                                          [r["transaction_type"] for r in rs],
                                          devices=[r["device_id"] for r in rs]) for rs in reqs]

        def drive():
            rows_out = [services[0].call("ScoreBatch", b) for b in batches]
            idx_out = [services[2].call("ScoreBatch", f) for f in frames]
            return rows_out, idx_out

        counts.begin([row, idx])
        before = drive()  # the caches warm here, before the refresh
        for f in frames:
            services[1].call("ScoreBatch", f)
        resident = len(idx.cache._slots)
        scans = []
        source = batch_refresh.wallet_store_source(rig_url)
        job = batch_refresh.BatchFeatureRefreshJob(store, lambda: scans.append(source()) or scans[0])
        t = time.perf_counter()
        refreshed = job.refresh_once()
        refresh_s = time.perf_counter() - t
        dirty = (len(idx.cache._dirty), len(idx_cpu.cache._dirty))
        t = time.perf_counter()
        after = drive()
        after_s = time.perf_counter() - t
        launches = counts.end("stores: refresh")
        boundary = changed = rows = 0
        for payload, b_out, a_out in zip(batches, before[0], after[0]):
            x, bl = store.decode_gather(payload)
            want = {k: v.numpy() for k, v in row_cpu.score_arrays(x, bl).items()}
            got = response_columns(codec, a_out)[1]
            boundary += compare_columns(got, want, "stores refresh row mode")
            changed += int((got["score"] != response_columns(codec, b_out)[1]["score"]).sum())
            rows += len(got["score"])
        for frame, b_out, a_out in zip(frames, before[1], after[1]):
            got = response_columns(codec, a_out)[1]
            want = response_columns(codec, services[1].call("ScoreBatch", frame))[1]
            boundary += compare_columns(got, want, "stores refresh index")
            changed += int((got["score"] != response_columns(codec, b_out)[1]["score"]).sum())
            rows += len(got["score"])
        if not torch.equal(idx.cache.table.cpu(), idx_cpu.cache.table):
            raise AssertionError("stores refresh: the card's cache table differs from the twin's")
        if changed == 0 or dirty[0] == 0 or dirty[0] != dirty[1]:
            raise AssertionError(f"stores refresh: {changed} rows changed score; dirty {dirty}")

        # The same features from ClickHouse's interface.
        scan = scans[0]
        sample = sorted(scan)[:2000]
        x0 = np.zeros((len(sample), N_FEATURES), np.float32)
        for i, a in enumerate(sample):
            store.fill_row(x0[i], a, 1000, "deposit")
        stand_in = ClickHouseStandIn([
            {"account_id": a, "total_deposits": bf.total_deposits,
             "total_withdrawals": bf.total_withdrawals, "deposit_count": bf.deposit_count,
             "withdraw_count": bf.withdraw_count, "total_bets": bf.total_bets,
             "total_wins": bf.total_wins, "bet_count": bf.bet_count, "win_count": bf.win_count,
             "account_created_at": bf.created_at} for a, bf in scan.items()])
        try:
            ch_job = batch_refresh.BatchFeatureRefreshJob(
                store, clickhouse.clickhouse_source(stand_in.url))
            t = time.perf_counter()
            ch_count = ch_job.refresh_once()
            ch_s = time.perf_counter() - t
            ch_scan = clickhouse.clickhouse_source(stand_in.url)()
        finally:
            stand_in.close()
        x1 = np.zeros_like(x0)
        for i, a in enumerate(sample):
            store.fill_row(x1[i], a, 1000, "deposit")
        if ch_scan != scan or ch_count != refreshed or not np.array_equal(x0.view(np.int32),
                                                                         x1.view(np.int32)):
            raise AssertionError("stores refresh: ClickHouse's features differ from the rig's")
    finally:
        store.delta_listener = None
        for e in engines:
            e.close()
        for s in services:
            s.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"refreshed_accounts": refreshed, "refresh_s": refresh_s, "resident": resident,
            "dirty_after_refresh": dirty[0], "rows": rows, "rows_changed": changed,
            "changed_share": changed / rows, "floor_boundary_rows": boundary,
            "after_rpcs_s": after_s, "clickhouse_refresh_s": ch_s,
            "clickhouse_queries": len(stand_in.queries), "launches": launches}


class DictRedis:
    """The Redis commands ``serve/redis_store.py`` sends, over dicts: sorted
    sets with score ranges, INCRBY, SET NX, hashes, sets; PFCOUNT exact."""

    def __init__(self):
        self.zsets, self.strings, self.sets, self.hashes = {}, {}, {}, {}

    def pipeline(self):
        redis, ops = self, []

        class Pipeline:
            def __getattr__(self, name):
                def queue(*args, **kwargs):
                    ops.append((name, args, kwargs))
                    return self
                return queue

            def execute(self):
                out = [getattr(redis, f"_{n}")(*a, **k) for n, a, k in ops]
                ops.clear()
                return out

        return Pipeline()

    @staticmethod
    def _bound(v, inf):
        return inf if v in ("-inf", "+inf") else float(v)

    def sadd(self, key, value):
        self.sets.setdefault(key, set()).add(value)

    def hset(self, key, mapping):
        self.hashes.setdefault(key, {}).update({k: str(v) for k, v in mapping.items()})

    def _zadd(self, key, mapping):
        self.zsets.setdefault(key, {}).update(mapping)

    def _zremrangebyscore(self, key, lo, hi):
        lo, hi, zs = self._bound(lo, -math.inf), self._bound(hi, math.inf), self.zsets.get(key, {})
        for m in [m for m, s in zs.items() if lo <= s <= hi]:
            del zs[m]

    def _zcount(self, key, lo, hi):
        lo, hi = self._bound(lo, -math.inf), self._bound(hi, math.inf)
        return sum(1 for s in self.zsets.get(key, {}).values() if lo <= s <= hi)

    def _incrby(self, key, amount):
        self.strings[key] = str(int(self.strings.get(key, "0")) + amount)

    def _expire(self, key, ttl):
        return True

    def _set(self, key, value, nx=False, ex=None):
        if nx and key in self.strings:
            return None
        self.strings[key] = str(value)
        return True

    def _get(self, key):
        return self.strings.get(key)

    def _pfadd(self, key, value):
        self.sets.setdefault(key, set()).add(value)

    def _pfcount(self, key):
        return len(self.sets.get(key, ()))

    def _sismember(self, key, value):
        return value in self.sets.get(key, ())

    def _hgetall(self, key):
        return dict(self.hashes.get(key, {}))


def stores_redis(params, counts, device: str) -> dict:
    """(5) FEATURE_STORE=redis raises without the library; the Redis store
    over a dict-backed client fed phase 15's stream, a STORES_REDIS_ROWS-row
    score_batch on the card against a CPU twin over the same client."""
    from igaming_platform_tpu_torch.core.config import BatcherConfig
    from igaming_platform_tpu_torch.core.enums import ReasonCode
    from igaming_platform_tpu_torch.core.features import F
    from igaming_platform_tpu_torch.serve import scorer, server
    from igaming_platform_tpu_torch.serve.feature_store import TransactionEvent
    from igaming_platform_tpu_torch.serve.redis_store import RedisFeatureStore

    try:
        server.make_feature_store("redis")
    except RuntimeError as exc:
        refused = str(exc)
    else:
        raise AssertionError("stores redis: FEATURE_STORE=redis built without the library")
    pinned = [PLATFORM_T0]

    class PinnedRedisStore(RedisFeatureStore):
        """The twin's clock: every gather at the stream's last event."""

        def gather_batch(self, requests, now=None):
            return super().gather_batch(requests, now or pinned[0])

    client = DictRedis()
    stores = [PinnedRedisStore(client=client), PinnedRedisStore(client=client)]
    clock = PLATFORM_T0
    ops = platform_ops(15, PLATFORM_PARITY_OPS * 3, PLATFORM_PARITY_ACCOUNTS,
                       PLATFORM_PARITY_CLAIMS)
    t = time.perf_counter()
    for kind, acct, amount, _, device_id, _, _, step in ops:
        if kind != "claim":
            stores[0].update(TransactionEvent(f"player{acct}", amount, kind,
                                              device_id=device_id, ip=f"ip{acct % 31}",
                                              timestamp=clock))
        pinned[0] = clock
        clock += step
    feed_s = time.perf_counter() - t
    stores[0].add_to_blacklist("device", PLATFORM_BLACKLISTED)
    rng = np.random.default_rng(165)
    reqs = [scorer.ScoreRequest(account_id=f"player{rng.integers(PLATFORM_PARITY_ACCOUNTS)}",
                                amount=int(rng.integers(100, 500_000)),
                                tx_type=("deposit", "bet", "withdraw")[i % 3],
                                device_id=(PLATFORM_BLACKLISTED if i % 50 == 0
                                           else f"dev{rng.integers(997)}"))
            for i in range(STORES_REDIS_ROWS)]
    bcfg = BatcherConfig(batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=0.0)
    engines = [scorer.TorchScoringEngine(ml_backend="mlp+gbdt", params=params,
                                         batcher_config=bcfg, feature_store=s, device=d,
                                         warmup=False)
               for s, d in zip(stores, (device, "cpu"))]
    try:
        counts.begin(engines[:1])
        t = time.perf_counter()
        got = engines[0].score_batch(reqs)
        card_s = time.perf_counter() - t
        launches = counts.end("stores: redis")
        want = engines[1].score_batch(reqs)
        x_got = np.stack([r.features.to_array() for r in got])
        x_want = np.stack([r.features.to_array() for r in want])
        if not np.array_equal(x_got.view(np.int32), x_want.view(np.int32)):
            raise AssertionError("stores redis: the gathered rows differ from the CPU twin's")
        boundary = compare_columns({k: np.array([response_from_score(r)[k] for r in got])
                                    for k in ("score", "action", "rule_score", "ml_score",
                                              "reason_mask")},
                                   {k: np.array([response_from_score(r)[k] for r in want])
                                    for k in ("score", "action", "rule_score", "ml_score",
                                              "reason_mask")}, "stores redis")
    finally:
        for e in engines:
            e.close()
    if not x_got[:, F.TX_COUNT_1H].any() or not any(
            ReasonCode.KNOWN_FRAUDSTER in r.reason_codes for r in got):
        raise AssertionError("stores redis: the stream's windows or the blacklist never showed")
    return {"refused": refused, "events": sum(1 for o in ops if o[0] != "claim"),
            "feed_s": feed_s, "rows": len(reqs), "score_batch_s": card_s,
            "keys": len(client.zsets) + len(client.strings) + len(client.sets),
            "floor_boundary_rows": boundary, "launches": launches}


def phase_stores(torch, card: str, gbdt_kernel, dense_mod, store, device: str = "cuda") -> dict:
    """Phase 16: the stores of record and the wallet's own front, on phase
    15's tree (``stores_pg``, ``stores_ledger``, ``stores_ltv``,
    ``stores_refresh``, ``stores_redis``). ``device="cpu"`` rehearses it
    without a card (the launch checks then skipped)."""
    import shutil
    import tempfile

    from igaming_platform_tpu_torch.convert import from_jax_params
    from igaming_platform_tpu_torch.serve import ledger as ledger_mod
    from igaming_platform_tpu_torch.serve import ltv_job

    t0 = time.perf_counter()
    rng = np.random.default_rng(150)
    tree = {"mlp": mlp_tree(rng, SERVE_HIDDEN), "gbdt": forest_tree(rng, SERVE_TREES, SERVE_DEPTH)}
    params = from_jax_params("mlp+gbdt", tree)
    counts = StepCounts(gbdt_kernel, dense_mod, len(tree["mlp"]["layers"]), device)
    root = tempfile.mkdtemp(prefix="chip-smoke-stores-")
    rig = None
    try:
        wallet = stores_pg(params, root, counts, device)
        rig = wallet.pop("rig")
        log(f"phase 16: [{card}] wallet.v1: {wallet['fill']['accounts']} accounts and "
            f"{wallet['fill']['history']} historical transactions written into the rig's SQLite "
            f"file directly after the store's bootstrap over the wire ({wallet['fill']['seconds']:.1f}"
            f" s; the SQLite store's {wallet['fill_sqlite']['accounts']} accounts in "
            f"{wallet['fill_sqlite']['seconds']:.1f} s); {wallet['ops']} operations over {wallet['active_accounts']} accounts through "
            f"serve_wallet and the port's gRPC client, answers over Postgres equal to SQLite's "
            f"on the card and "
            f"the CPU twin's ({json.dumps(wallet['statuses'])}), {wallet['gate_scores']} gate "
            f"scores ({wallet['floor_boundary_rows']} floor-boundary rows not compared); ops/s "
            f"{json.dumps(wallet['ops_per_s'])}; latency ms {json.dumps(wallet['latency_ms'])}; "
            f"floors: a score() {wallet['score_floor_ms']:.3f} ms, a commit "
            f"{json.dumps(wallet['commit_floor_ms'])} ms; reconcile of "
            f"{wallet['reconciled_accounts']} accounts over the wire in "
            f"{wallet['reconcile_s']:.1f} s, 0 mismatches; /metrics equal to the completed "
            f"operations {json.dumps(wallet['completed_by_type'])}; launches "
            f"{json.dumps(wallet['launches'])}")
        ltv = stores_ltv(ltv_job, rig.url, rig.db_path, device)
        log(f"phase 16: [{card}] LTV job over {ltv['records']} accounts: postgres:// "
            f"{json.dumps(ltv['postgres'])}, sqlite:// {json.dumps(ltv['sqlite'])} (s), "
            f"records bit-equal")
        refresh = stores_refresh(torch, params, store, rig.url, counts, device)
        log(f"phase 16: [{card}] refresh: {refresh['refreshed_accounts']} accounts from "
            f"postgres:// in {refresh['refresh_s']:.2f} s ({refresh['dirty_after_refresh']} "
            f"resident cache rows dirty), {refresh['rows']} rows after it equal to the CPU "
            f"twins ({refresh['floor_boundary_rows']} floor-boundary rows not compared), "
            f"{refresh['rows_changed']} rows ({refresh['changed_share']:.4f}) changed score; "
            f"ClickHouse stand-in refresh in {refresh['clickhouse_refresh_s']:.2f} s, the same "
            f"features; launches {json.dumps(refresh['launches'])}")
        redis = stores_redis(params, counts, device)
        log(f"phase 16: [{card}] redis: FEATURE_STORE=redis refused ({redis['refused']}); "
            f"{redis['events']} events into the dict-backed client in {redis['feed_s']:.2f} s; "
            f"a {redis['rows']}-row score_batch in {redis['score_batch_s']:.3f} s equal to the "
            f"CPU twin ({redis['floor_boundary_rows']} floor-boundary rows); launches "
            f"{json.dumps(redis['launches'])}")
        ledger_run = stores_ledger(params, store, rig.url, root, counts, device)
        ledger = stores_ledger_check(ledger_mod, ledger_run, rig.db_path)
        log(f"phase 16: [{card}] LEDGER_SINK=pg: {ledger['noted']} rows noted, "
            f"{ledger['appended']} appended, {ledger['dropped']} dropped, {ledger['table_rows']} "
            f"in risk_decisions equal to the WAL field for field, drained in "
            f"{ledger['drain_s']:.1f} s ({ledger['sink_rows_per_s']:.0f} rows/s); launches "
            f"{json.dumps(ledger['launches'])}")
    finally:
        if rig is not None:
            rig.close()
        STORE_CLOCK[0] = SERVER_NOW
        shutil.rmtree(root, ignore_errors=True)
    result = {"wallet": wallet, "ledger": ledger, "ltv": ltv, "refresh": refresh,
              "redis": redis, "launches": counts.total, "seconds": time.perf_counter() - t0}
    log(f"phase 16: launches {json.dumps(counts.total)}; {result['seconds']:.1f} s")
    log("phase 16: " + json.dumps(result, default=str))
    return result


# Multi-device serving and the fleet (phase 17). Every mesh here is a
# LOGICAL mesh: its shards repeat one device (cuda:0 on the card), so it
# checks the sharded layouts and arithmetic and measures no interconnect;
# none of its times is a multi-GPU speed. MD_* sizes: the routed engine
# takes MD_RPCS ScoreBatch RPCs of SERVER_BATCH_ROWS rows and MD_SINGLES
# ScoreTransaction RPCs, its CPU twin the first MD_CPU_ROWS rows; the data-
# and model-sharded engines MD_SHARD_RPCS RPCs each; the slot-sharded index
# engines MD_STATE_FRAMES IDX1 frames of SERVER_BATCH_ROWS rows over a cache
# of MD_STATE_CAPACITY slots (fewer than the frames' accounts, so every shard
# owns live slots and CLOCK evicts); the detectors MD_ABUSE_ACCOUNTS accounts of
# MD_ABUSE_HISTORY events; the multi-host front MD_RPCS RPCs and MD_SINGLES
# singles; the fleet MD_FLEET_RPCS RPCs over three replicas.
# MD_SINGLES is 100, not 200: the script's time budget (PERF.md section 7).
MD_RPCS, MD_SINGLES, MD_CPU_ROWS, MD_SHARD_RPCS = 5, 100, 2048, 2
MD_STATE_FRAMES, MD_STATE_CAPACITY = 2, 16_384
MD_ABUSE_ACCOUNTS, MD_ABUSE_HISTORY = 256, 256
MD_FLEET_RPCS, MD_FLEET_STALE_S = 4, 2.0
MD_ROUTED_MESH = dict(data=2, expert=4)
MD_MODEL_MESH = dict(data=2, model=2, expert=2)
MD_SEQ_MESH = dict(data=2, seq=4)
MD_ULYSSES_CFG = dict(d_model=64, n_heads=4, n_layers=2, d_ff=128)  # 4 heads: seq=4 splits them
MD_SEQ_TOL = 2e-4  # rtol of ring and Ulysses against dense attention (tests/test_sequence.py)
# ml_score of the model-sharded engine against the unsharded one: a trunk
# split reorders the float32 partial sums ahead of the next layer's bf16
# rounding, so an activation within an ulp of a bf16 boundary can round the
# other way (2^-8 of its value); seen up to 1.8e-4 in a CPU rehearsal.
MD_MODEL_ATOL = 1e-3


def md_mesh(device: str, **axes):
    """A mesh of ``axes`` whose shards repeat the one card (``cuda:0``) or
    the CPU; with SMOKE_DISTINCT_CARDS=1 the shards spread over the visible
    cards in contiguous blocks, so that data coordinates hold distinct cards
    when there are enough of them."""
    from igaming_platform_tpu_torch.parallel.mesh import MeshSpec, create_mesh

    n = int(np.prod(list(axes.values())))
    spread = os.environ.get("SMOKE_DISTINCT_CARDS") == "1"
    if device != "cuda":
        # A rehearsal: torch tells "cpu:0" to "cpu:3" apart, so the spread
        # mesh's paths run on the CPU too.
        return create_mesh(MeshSpec(**axes), devices=[f"cpu:{i * 4 // n}" if spread else "cpu"
                                                      for i in range(n)])
    import torch

    cards = torch.cuda.device_count() if spread else 1
    return create_mesh(MeshSpec(**axes), devices=[f"cuda:{i * cards // n}" for i in range(n)])


class Launches:
    """The kernels' counters: ``begin`` sets them to 0 just before a run,
    ``end`` reads them just after; on the card each count is held to its
    expectation."""

    NAMES = ("forest", "dense", "dense_f32", "forward")

    def __init__(self, gbdt_kernel, dense_mod, fa, device: str):
        self.counters = {"forest": gbdt_kernel.gbdt_forest, "dense": dense_mod.dense,
                         "dense_f32": dense_mod.dense_f32, "forward": fa.flash_attention_fwd}
        self.device = device
        self.total = dict.fromkeys(self.NAMES, 0)

    def sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def begin(self) -> None:
        self.sync()
        for c in self.counters.values():
            c.launches = 0

    def end(self, what: str, want: dict) -> dict:
        self.sync()
        got = {k: c.launches for k, c in self.counters.items()}
        if self.device == "cuda" and any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"{what}: launches {got}, expected {want}")
        for k in self.total:
            self.total[k] += got[k]
        return got


def md_batches(codec, rng, n_rpcs: int, rows: int) -> list[bytes]:
    return [codec.encode(codec.SCORE_BATCH_REQUEST,
                         {"transactions": server_requests(codec, rng, rows)})
            for _ in range(n_rpcs)]


def md_rpcs(codec, svc, batches) -> tuple[list[dict], list[float]]:
    """Each ScoreBatch through ``svc``: (result columns, seconds)."""
    cols, secs = [], []
    for payload in batches:
        t = time.perf_counter()
        out = svc.call("ScoreBatch", payload)
        secs.append(time.perf_counter() - t)
        cols.append(response_columns(codec, out)[1])
    return cols, secs


def md_equal(got: dict, want: dict, what: str) -> None:
    """Every result column equal, ``ml_score`` bit for bit."""
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        if key == "ml_score":
            a, b = a.view(np.int32), b.view(np.int32)
        if not np.array_equal(a, b):
            raise AssertionError(f"{what}: {key} differs")


def md_rate(secs: list[float], rows: int) -> float:
    return rows / statistics.median(secs)


def md_singles(codec, svc, rng, batch_payload: bytes, n: int) -> tuple[dict, list[int], float]:
    """``n`` rows of a ScoreBatch request as ScoreTransaction RPCs, one row
    each: (their result columns, the rows' indices, ms each, median)."""
    txs = codec.decode(codec.SCORE_BATCH_REQUEST, batch_payload)["transactions"]
    idx = sorted(rng.choice(len(txs), n, replace=False).tolist())
    rows, ms = [], []
    for i in idx:
        t = time.perf_counter()
        rows.append(codec.decode(codec.SCORE_TRANSACTION_RESPONSE, svc.call(
            "ScoreTransaction", codec.encode(codec.SCORE_TRANSACTION_REQUEST, txs[i]))))
        ms.append((time.perf_counter() - t) * 1e3)
    payload = codec.encode(codec.SCORE_BATCH_RESPONSE, {"results": rows})
    return response_columns(codec, payload)[1], idx, statistics.median(ms)


def md_take(cols: dict, idx: list[int]) -> dict:
    return {k: np.asarray(v)[idx] for k, v in cols.items()}


def fleet_routed(torch, codec, store, counts, rng, batches, device: str) -> dict:
    """Part 1: ``ml_backend="routed"`` at ``init_routed_params``' defaults over
    data=2 x expert=4 through ``RiskGrpcService.call``, against the same
    bundle without a mesh (``dense_reference``) on the same device, a CPU
    twin on the first MD_CPU_ROWS rows, and MD_SINGLES ScoreTransaction RPCs
    of the same rows."""
    from igaming_platform_tpu_torch.core.config import BatcherConfig
    from igaming_platform_tpu_torch.models.ensemble import init_routed_params, routed_experts
    from igaming_platform_tpu_torch.parallel import ep
    from igaming_platform_tpu_torch.serve import grpc_server, scorer

    t_start = time.perf_counter()
    params = init_routed_params(170)
    bcfg = BatcherConfig(batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0)
    mesh = md_mesh(device, **MD_ROUTED_MESH)
    twin = scorer.TorchScoringEngine(ml_backend="routed", params=params, batcher_config=bcfg,
                                     feature_store=store, device="cpu", warmup=False)
    twin_svc = grpc_server.RiskGrpcService(twin)
    engines = {name: scorer.TorchScoringEngine(ml_backend="routed", params=params,
                                               batcher_config=bcfg, feature_store=store,
                                               device=device, mesh=m)
               for name, m in (("dense", None), ("mesh", mesh))}
    svcs = {name: grpc_server.RiskGrpcService(e) for name, e in engines.items()}
    out, secs_by = {}, {"engines": time.perf_counter() - t_start}
    try:
        for name in ("dense", "mesh"):
            t0 = time.perf_counter()
            svcs[name].call("ScoreBatch", batches[0])  # the pipeline's build off the count
            n_data = mesh.shape["data"] if name == "mesh" else 1
            sources = mesh.size if name == "mesh" else 1
            counts.begin()
            steps0 = engines[name].device_steps
            cols, secs = md_rpcs(codec, svcs[name], batches)
            single_ms = None
            if name == "mesh":
                singles, idx, single_ms = md_singles(codec, svcs[name], np.random.default_rng(171),
                                                     batches[0], MD_SINGLES)
                md_equal(singles, md_take(cols[0], idx), "routed singles")
            steps = engines[name].device_steps - steps0
            launches = counts.end(f"routed {name}", {
                "forest": n_data * steps, "dense": 6 * n_data * steps,
                "dense_f32": sources * steps, "forward": 0})
            out[name] = {"cols": cols, "rows_per_s": md_rate(secs, SERVER_BATCH_ROWS),
                         "single_ms": single_ms, "steps": steps, "launches": launches}
            secs_by[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for a, b in zip(out["mesh"]["cols"], out["dense"]["cols"]):
            md_equal(a, b, "routed mesh against dense")
        sub = codec.decode(codec.SCORE_BATCH_REQUEST, batches[0])["transactions"][:MD_CPU_ROWS]
        want = response_columns(codec, twin_svc.call(
            "ScoreBatch", codec.encode(codec.SCORE_BATCH_REQUEST, {"transactions": sub})))[1]
        boundary = compare_columns({k: np.asarray(v)[:MD_CPU_ROWS]
                                    for k, v in out["mesh"]["cols"][0].items()}, want,
                                   "routed mesh against the CPU twin")
        # Expert load and dropped picks of one throughput step's rows, off
        # the count (the engine's step does not return them).
        x = np.ascontiguousarray(store.gather_columns(
            [t["account_id"] for t in sub[:BATCH_SIZE // 2]] * 2,
            [t["amount"] for t in sub[:BATCH_SIZE // 2]] * 2,
            [t["transaction_type"] for t in sub[:BATCH_SIZE // 2]] * 2)[0])
        fns, keys = routed_experts()
        p = engines["mesh"].get_params()
        stats = ep.routed_ensemble_forward(
            p["router"], tuple(p.get(k) for k in keys),
            torch.from_numpy(x).to(engines["mesh"].device), mesh=mesh, expert_fns=fns, k=2,
            capacity_factor=float(len(fns)), shard_rows_over=("data", "expert"))
        load = stats["load"].cpu().numpy().tolist()
        dropped = int(stats["dropped"])
        if dropped != 0 or sum(load) != 2 * x.shape[0]:
            raise AssertionError(f"routed: {dropped} picks dropped at capacity factor 4, "
                                 f"load {load}")
        secs_by["twin_and_load"] = time.perf_counter() - t0
    finally:
        for s in (*svcs.values(), twin_svc):
            s.close()
        for e in (*engines.values(), twin):
            e.close()
    return {"rows_per_s": {k: v["rows_per_s"] for k, v in out.items()},
            "single_ms": out["mesh"]["single_ms"],
            "steps": {k: v["steps"] for k, v in out.items()},
            "launches": {k: v["launches"] for k, v in out.items()},
            "expert_load": load, "dropped": dropped, "cpu_rows": MD_CPU_ROWS,
            "floor_boundary_rows": boundary, "singles": MD_SINGLES,
            "seconds": {k: round(v, 2) for k, v in secs_by.items()}}


def fleet_sharded(torch, codec, store, counts, params, batches, device: str) -> dict:
    """Part 2: phase 7's ``mlp+gbdt`` engine over data=2 (rows only: bit-equal
    to the unsharded engine) and over data=2 x model=2 x expert=2 (the tree
    bank over expert, the MLP over model: within ML_ATOL)."""
    from igaming_platform_tpu_torch.core.config import BatcherConfig
    from igaming_platform_tpu_torch.serve import grpc_server, scorer

    bcfg = BatcherConfig(batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0)
    cases = (("plain", None, (1, 3)), ("data", md_mesh(device, data=2), (2, 6)),
             ("model", md_mesh(device, **MD_MODEL_MESH), (4, 10)))
    out = {}
    for name, mesh, (forest, dense) in cases:
        engine = scorer.TorchScoringEngine(ml_backend="mlp+gbdt", params=params,
                                           batcher_config=bcfg, feature_store=store,
                                           device=device, mesh=mesh)
        svc = grpc_server.RiskGrpcService(engine)
        try:
            svc.call("ScoreBatch", batches[0])
            counts.begin()
            steps0 = engine.device_steps
            cols, secs = md_rpcs(codec, svc, batches[:MD_SHARD_RPCS])
            steps = engine.device_steps - steps0
            launches = counts.end(f"sharded {name}", {"forest": forest * steps,
                                                      "dense": dense * steps, "forward": 0})
            out[name] = {"cols": cols, "rows_per_s": md_rate(secs, SERVER_BATCH_ROWS),
                         "rpc_ms": statistics.median(secs) * 1e3,
                         "launches": launches, "steps": steps,
                         "model_sharded": engine._model_sharded,
                         "fingerprint": engine.params_fingerprint}
        finally:
            svc.close()
            engine.close()
    boundary, ml_err, differing = 0, 0.0, 0
    for d, m, p in zip(out["data"]["cols"], out["model"]["cols"], out["plain"]["cols"]):
        md_equal(d, p, "data-sharded against unsharded")
        boundary += compare_columns(m, p, "model-sharded against unsharded",
                                    atol=MD_MODEL_ATOL, split_sum=True)
        ml_err = max(ml_err, float(np.abs(m["ml_score"] - p["ml_score"]).max()))
        differing += int((m["ml_score"].view(np.int32) != p["ml_score"].view(np.int32)).sum())
    if not out["model"]["model_sharded"] or len({v["fingerprint"] for v in out.values()}) != 1:
        raise AssertionError("sharded: the params did not shard, or their fingerprint changed")
    return {"rows_per_s": {k: v["rows_per_s"] for k, v in out.items()},
            "rpc_ms": {k: v["rpc_ms"] for k, v in out.items()},
            "launches": {k: v["launches"] for k, v in out.items()},
            "ml_max_abs_err_model_sharded": ml_err, "ml_rows_differing": differing,
            "rows_excused": boundary}


def fleet_state(torch, codec, store, counts, params, rng, device: str) -> dict:
    """Part 3: slot-sharded IDX1 with session state over data=4 on phase 7's
    store, against the same engine unsharded: every answer equal, the
    table, ring, cursor and length gathered bit-equal, each shard's bytes."""
    import os

    from igaming_platform_tpu_torch.core.config import BatcherConfig
    from igaming_platform_tpu_torch.serve import grpc_server, scorer, wire

    bcfg = BatcherConfig(batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0)
    frames = []
    for f in range(MD_STATE_FRAMES):
        n = SERVER_BATCH_ROWS
        ids = rng.integers(0, SERVER_ACCOUNTS, n)
        frames.append(wire.encode_index_batch(
            [f"acct{a}" for a in ids], rng.integers(100, 2_000_000, n),
            np.array(["deposit", "withdraw", "bet"])[rng.integers(0, 3, n)].tolist()))
    saved = os.environ.get("SESSION_STATE")
    os.environ["SESSION_STATE"] = "1"
    out = {}
    try:
        for name, mesh, per_step in (("plain", None, (1, 3)),
                                     ("sharded", md_mesh(device, data=4), (4, 12))):
            engine = scorer.TorchScoringEngine(ml_backend="mlp+gbdt", params=params,
                                               batcher_config=bcfg, feature_store=store,
                                               device=device, feature_cache=MD_STATE_CAPACITY,
                                               mesh=mesh)
            svc = grpc_server.RiskGrpcService(engine)
            try:
                engine.ensure_cache()
                counts.begin()
                steps0 = engine.device_steps
                cols, secs = [], []
                for frame in frames:
                    t = time.perf_counter()
                    cols.append(response_columns(codec, svc.call("ScoreBatch", frame))[1])
                    secs.append(time.perf_counter() - t)
                steps = engine.device_steps - steps0
                launches = counts.end(f"state {name}", {"forest": per_step[0] * steps,
                                                        "dense": per_step[1] * steps})
                ring, cur, ln = engine.session.ring_state()
                table = engine.cache.table
                table = table.full() if hasattr(table, "full") else table[:engine.cache.capacity]
                out[name] = {"cols": cols, "state": [t.cpu() for t in (table, ring, cur, ln)],
                             "rows_per_s": md_rate(secs, SERVER_BATCH_ROWS),
                             "launches": launches, "cache": engine.cache.shard_stats(),
                             "session": engine.session.shard_stats(),
                             "stats": engine.cache.stats()}
            finally:
                svc.close()
                engine.close()
    finally:
        if saved is None:
            os.environ.pop("SESSION_STATE", None)
        else:
            os.environ["SESSION_STATE"] = saved
    occupancy = out["sharded"]["cache"]["occupancy"]
    if min(occupancy) == 0 or out["sharded"]["stats"]["evictions"] == 0:
        raise AssertionError(f"state: occupancy {occupancy} and "
                             f"{out['sharded']['stats']['evictions']} evictions: a shard held "
                             "no live slot or CLOCK never evicted")
    for a, b in zip(out["sharded"]["cols"], out["plain"]["cols"]):
        md_equal(a, b, "slot-sharded IDX1 against unsharded")
    for what, a, b in zip(("table", "ring", "cursor", "length"), out["sharded"]["state"],
                          out["plain"]["state"]):
        if not torch.equal(a, b):
            raise AssertionError(f"state: the gathered {what} differs from the unsharded one")
    if out["sharded"]["stats"] != {**out["plain"]["stats"], "shards": 4}:
        raise AssertionError("state: cache counts differ")
    table_bytes = out["plain"]["cache"]["hbm_bytes"][0]
    per_shard = out["sharded"]["cache"]["hbm_bytes"]
    return {"rows_per_s": {k: v["rows_per_s"] for k, v in out.items()},
            "launches": {k: v["launches"] for k, v in out.items()},
            "cache_bytes_per_shard": per_shard, "cache_bytes_unsharded": table_bytes,
            "ring_bytes_per_shard": out["sharded"]["session"]["hbm_bytes"],
            "ring_bytes_unsharded": out["plain"]["session"]["hbm_bytes"][0],
            "shard_share": per_shard[0] / table_bytes,
            "occupancy": occupancy, "evictions": out["sharded"]["stats"]["evictions"]}


def fleet_sequence(torch, counts, device: str) -> dict:
    """Part 4: ``check_batch`` of MD_ABUSE_ACCOUNTS accounts with
    MD_ABUSE_HISTORY events over data=2 x seq=4: ring attention with the
    serving detector (2 heads), Ulysses with a 4-head detector (seq=4 must
    split the heads), each against the dense detector of the same params;
    the forward kernel's launches in the Ulysses run counted."""
    from igaming_platform_tpu_torch.convert import sequence_from_tree
    from igaming_platform_tpu_torch.models.sequence import SeqConfig
    from igaming_platform_tpu_torch.serve.abuse import SequenceAbuseDetector

    mesh = md_mesh(device, **MD_SEQ_MESH)
    accounts = [f"seq-{i}" for i in range(MD_ABUSE_ACCOUNTS)]
    out = {}
    for mode, cfg in (("ring", ABUSE_CFG), ("ulysses", MD_ULYSSES_CFG)):
        model = sequence_from_tree(seq_tree(np.random.default_rng(172), cfg), SeqConfig(**cfg))
        dets = {"dense": SequenceAbuseDetector(model, SeqConfig(**cfg),
                                               max_history=MD_ABUSE_HISTORY, device=device),
                mode: SequenceAbuseDetector(model, SeqConfig(**cfg), max_history=MD_ABUSE_HISTORY,
                                            device=device, mesh=mesh, seq_mode=mode)}
        for det in dets.values():
            r = np.random.default_rng(173)
            for i in range(MD_ABUSE_ACCOUNTS * MD_ABUSE_HISTORY):
                det.record_event(accounts[i % MD_ABUSE_ACCOUNTS], int(r.integers(100, 50_000)),
                                 ("deposit", "bet", "win", "bonus_grant")[int(r.integers(0, 4))],
                                 timestamp=1_000_000.0 + i * 0.5)
        res = {}
        for name, det in dets.items():
            det.check_batch(accounts[:2], seq_len=MD_ABUSE_HISTORY)
            counts.begin()
            t = time.perf_counter()
            scores = det.check_batch(accounts, seq_len=MD_ABUSE_HISTORY)
            sec = time.perf_counter() - t
            layers = SeqConfig(**cfg).n_layers
            want_fwd = {"dense": layers, "ring": 0,
                        "ulysses": layers * MD_SEQ_MESH["data"] * MD_SEQ_MESH["seq"]}[name]
            launches = counts.end(f"sequence {mode} {name}", {
                "forward": want_fwd, "dense_f32": affine_layers(SeqConfig(**cfg))})
            res[name] = (scores, sec, launches)
        err = float(np.abs(res[mode][0] - res["dense"][0]).max())
        if not np.allclose(res[mode][0], res["dense"][0], rtol=MD_SEQ_TOL, atol=MD_SEQ_TOL / 10):
            raise AssertionError(f"sequence {mode}: {err} from the dense detector")
        out[mode] = {"max_abs_err": err, "ms": res[mode][1] * 1e3,
                     "dense_ms": res["dense"][1] * 1e3, "launches": res[mode][2],
                     "dense_launches": res["dense"][2], "heads": cfg["n_heads"]}
    return out


class FleetMultihost:
    """Part 5: the multi-host front (``multihost_engine``, the engine
    MULTIHOST_ROLE=front builds) over a global data=2 mesh on gloo, its
    follower a process of its own (``Follower``: on the card the
    MULTIHOST_ROLE=follower entry point), a RiskGrpcService over it.
    ``start``: MD_RPCS ScoreBatch and MD_SINGLES ScoreTransaction RPCs equal
    to a single-process engine's answers; the follower killed: degraded
    single-host answers, equal, the multihost breaker open; the follower
    restarted. ``finish`` (after other work, while it boots): the
    re-handshake, a new process group, follower_resurrections_total 1, the
    answers after it equal. ``close`` in every case."""

    def __init__(self, torch, codec, store, counts, batches, follower, root: str, device: str):
        from igaming_platform_tpu_torch.core.config import BatcherConfig
        from igaming_platform_tpu_torch.obs.metrics import ServiceMetrics
        from igaming_platform_tpu_torch.parallel import distributed
        from igaming_platform_tpu_torch.parallel.mesh import MeshSpec
        from igaming_platform_tpu_torch.serve import grpc_server, multihost, scorer
        from igaming_platform_tpu_torch.serve.server import load_multitask
        from igaming_platform_tpu_torch.serve.supervisor import ServingSupervisor

        self.t0 = time.perf_counter()
        self.codec, self.counts, self.batches, self.follower = codec, counts, batches, follower
        self.multihost = multihost
        bcfg = BatcherConfig(batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0)
        params = load_multitask(os.path.join(root, "multitask.npz"))
        dev = "cuda:0" if device == "cuda" else "cpu"
        mesh = distributed.global_mesh(MeshSpec(data=-1), local_devices=[dev])
        self.sup = ServingSupervisor()
        self.sup.bind(metrics=ServiceMetrics("risk"))
        self.gathers = []
        self.real_gather = multihost.gather_step

        def timed_gather(group, block):
            t = time.perf_counter()
            try:
                return self.real_gather(group, block)
            finally:
                self.gathers.append((block.shape[1], (time.perf_counter() - t) * 1e3))

        multihost.gather_step = timed_gather
        self.single = scorer.TorchScoringEngine(ml_backend="multitask", params=params,
                                                batcher_config=bcfg, feature_store=store,
                                                device=device)
        # The reference's service first: a service installs the process's
        # drift engine and closes the one installed before it.
        self.ref_svc = grpc_server.RiskGrpcService(self.single)
        t0 = time.perf_counter()
        self.front = multihost.multihost_engine(
            mesh, [follower.port], ml_backend="multitask", params=params, feature_store=store,
            batcher_config=bcfg, supervisor=self.sup, device=device,
            channel_kwargs={"reconnect_backoff_s": (0.2, 1.0)})
        self.boot_s = time.perf_counter() - t0
        self.svc = grpc_server.RiskGrpcService(self.front)

    def start(self) -> None:
        codec, front, svc = self.codec, self.front, self.svc
        tm = self.t = {"init": time.perf_counter() - self.t0}
        t0 = time.perf_counter()
        self.ref = [md_rpcs(codec, self.ref_svc, [b])[0][0] for b in self.batches]
        tm["reference_rpcs"] = time.perf_counter() - t0
        svc.call("ScoreBatch", self.batches[0])
        self.counts.begin()
        steps0 = front.device_steps
        self.gathers.clear()
        cols, secs = md_rpcs(codec, svc, self.batches)
        singles, idx, self.single_ms = md_singles(codec, svc, np.random.default_rng(174),
                                                  self.batches[0], MD_SINGLES)
        self.steps = front.device_steps - steps0
        self.launches = self.counts.end("multihost front", {"dense": 3 * self.steps,
                                                            "forest": 0})
        for a, b in zip(cols, self.ref):
            md_equal(a, b, "multihost front against one process")
        md_equal(singles, md_take(self.ref[0], idx), "multihost singles against one process")
        if front.degraded_steps or front.group_epoch != 0 or len(self.gathers) != self.steps:
            raise AssertionError(f"multihost: {front.degraded_steps} degraded steps, epoch "
                                 f"{front.group_epoch}, {len(self.gathers)} gathers for "
                                 f"{self.steps} steps")
        self.rows_per_s = md_rate(secs, SERVER_BATCH_ROWS)
        tm["front_rpcs_and_singles"] = time.perf_counter() - t0 - tm["reference_rpcs"]
        self.gather_ms = statistics.median(ms for _, ms in self.gathers)
        self.gather_rows = self.gathers[-1][0]
        # One gather of a whole SERVER_BATCH_ROWS result: a global step of
        # that many rows, off the path's count.
        x = np.zeros((SERVER_BATCH_ROWS, N_FEATURES), np.float32)
        t = time.perf_counter()
        front._readback(front._launch_padded(x, np.zeros(SERVER_BATCH_ROWS, bool),
                                             SERVER_BATCH_ROWS, front.get_params()))
        self.step_whole_ms = (time.perf_counter() - t) * 1e3
        self.gather_whole_ms = self.gathers[-1][1]
        # The follower dies: single-host degraded, equal answers.
        self.follower.kill()
        degraded, dsecs = md_rpcs(codec, svc, self.batches[:2])
        for a, b in zip(degraded, self.ref[:2]):
            md_equal(a, b, "multihost degraded against one process")
        breaker = self.sup.breaker("multihost").state_name
        if not front.degraded or breaker != "open" or front.degraded_steps == 0:
            raise AssertionError(f"multihost: degraded={front.degraded}, breaker {breaker}")
        self.degraded_rows_per_s = md_rate(dsecs, SERVER_BATCH_ROWS)
        self.degraded_steps = front.degraded_steps
        tm["whole_step_kill_degraded"] = (time.perf_counter() - t0 - tm["reference_rpcs"]
                                          - tm["front_rpcs_and_singles"])
        self.restarted = time.perf_counter()
        self.follower.start()

    def finish(self) -> dict:
        front = self.front
        while front._chan.resurrections == 0 and time.perf_counter() - self.restarted < 120:
            time.sleep(0.1)
        rejoin_s = time.perf_counter() - self.restarted
        after, _ = md_rpcs(self.codec, self.svc, self.batches[:1])
        md_equal(after[0], self.ref[0], "multihost after the rejoin")
        resurrections = self.sup.metrics.follower_resurrections_total.value()
        if (front._chan.resurrections != 1 or resurrections != 1 or front.group_epoch != 1
                or self.sup.breaker("multihost").state_name != "closed"):
            raise AssertionError(f"multihost: {front._chan.resurrections} resurrections "
                                 f"({resurrections} counted), epoch {front.group_epoch}")
        return {"boot_s": self.boot_s, "rows_per_s": self.rows_per_s,
                "single_ms": self.single_ms, "steps": self.steps, "launches": self.launches,
                "gather_ms_per_step": self.gather_ms, "gather_rows_per_process": self.gather_rows,
                "step_whole_ms": self.step_whole_ms, "gather_whole_ms": self.gather_whole_ms,
                "degraded_rows_per_s": self.degraded_rows_per_s,
                "degraded_steps": self.degraded_steps, "rejoin_s": rejoin_s,
                "follower_resurrections_total": resurrections,
                "seconds": {k: round(v, 2) for k, v in self.t.items()}}

    def close(self) -> None:
        self.multihost.gather_step = self.real_gather
        self.svc.close()
        self.ref_svc.close()
        self.front.close()
        self.single.close()


class Follower:
    """The follower process of part 5: on the card the MULTIHOST_ROLE=
    follower entry point of the risk server; ``device="cpu"`` a process
    running ``follower_serve`` on the CPU (the role refuses the CPU)."""

    def __init__(self, root: str, device: str):
        import socket

        def free() -> int:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                return s.getsockname()[1]

        self.root, self.device, self.port, self.coord = root, device, free(), free()
        self.proc = None
        self.starts = 0

    def env(self) -> dict:
        return {"COORDINATOR_ADDRESS": f"127.0.0.1:{self.coord}", "NUM_PROCESSES": "2"}

    def start(self) -> None:
        env = {**os.environ, **self.env(), "PROCESS_ID": "1", "MULTIHOST_ROLE": "follower",
               "MULTIHOST_WORK_PORT": str(self.port),
               "FRAUD_MODEL_PATH": os.path.join(self.root, "multitask.npz")}
        env.pop("SERVE_DEVICE_FALLBACK", None)
        if self.device == "cuda":
            args = [sys.executable, "-m", "igaming_platform_tpu_torch.serve.server"]
        else:
            args = [sys.executable, "-c", (
                "import os, sys; sys.path.insert(0, '.');"
                "from igaming_platform_tpu_torch.parallel import distributed as d;"
                "from igaming_platform_tpu_torch.parallel.mesh import MeshSpec;"
                "from igaming_platform_tpu_torch.serve.server import load_multitask;"
                "from igaming_platform_tpu_torch.core.config import ScoringConfig;"
                "from igaming_platform_tpu_torch.serve.multihost import follower_serve;"
                "d.initialize_from_env();"
                "follower_serve(int(os.environ['MULTIHOST_WORK_PORT']), ScoringConfig(), "
                "'multitask', load_multitask(os.environ['FRAUD_MODEL_PATH']), "
                "d.global_mesh(MeshSpec(data=-1), local_devices=['cpu']), device='cpu')")]
        self.starts += 1
        log_file = open(os.path.join(self.root, f"follower-{self.starts}.log"), "w")
        self.proc = subprocess.Popen(args, env=env, stdout=log_file, stderr=subprocess.STDOUT,
                                     cwd=os.path.dirname(os.path.abspath(__file__)))

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
        if self.proc is not None:
            self.proc.wait(timeout=30)

    def stop(self) -> None:
        if self.proc is not None:
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        self.kill()

    def tail(self) -> str:
        try:
            with open(os.path.join(self.root, f"follower-{self.starts}.log")) as f:
                return f.read()[-3000:]
        except OSError:
            return ""


def fleet_replicas(torch, codec, store, counts, params, rng, device: str) -> dict:
    """Part 6: three risk servers (``assemble_risk_service``, each with its
    gRPC port and HTTP sidecar) on the device, an ``AccountAffinityPicker``
    splitting MD_FLEET_RPCS ScoreBatch RPCs by owner, each replica answering
    its rows through ``RiskGrpcService.call``, the merged answers equal to
    one replica's whole answer byte for byte but for ``response_time_ms``;
    then ``serve_router`` in front of two of them over the port's gRPC
    transport: the same RPCs, split and merged by the router over the wire,
    and a ScoreTransaction through it, equal to the in-process merge and
    answer; a ``FleetView`` over the sidecars (merged histogram counts equal
    to the sum of the replicas'); one replica stopped goes stale within
    MD_FLEET_STALE_S and the view never blocks."""
    from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
    from igaming_platform_tpu_torch.obs.fleetview import FleetView, parse_histograms
    from igaming_platform_tpu_torch.obs.metrics import ServiceMetrics
    from igaming_platform_tpu_torch.serve import grpc_server, grpc_wire, server
    from igaming_platform_tpu_torch.serve.router import (
        AccountAffinityPicker,
        ScoringRouter,
        serve_router,
    )

    config = RiskServiceConfig(batcher=BatcherConfig(
        batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0))
    servers = []
    view = None
    try:
        for _ in range(3):
            assembled = server.assemble_risk_service(config, ml_backend="mlp+gbdt", params=params,
                                                     feature_store=store, device=device)
            servers.append(server.RiskServer(assembled, grpc_port=0, http_port=0))
        names = [f"replica{i}" for i in range(3)]
        picker = AccountAffinityPicker(names)
        # Requests as the client holds them, and their encoded entries: a
        # replica's share is its owned entries as they stand (what the
        # router forwards), its answer's entries merge back in order.
        reqs = [server_requests(codec, rng, SERVER_BATCH_ROWS) for _ in range(MD_FLEET_RPCS)]
        payloads = [codec.encode(codec.SCORE_BATCH_REQUEST, {"transactions": r}) for r in reqs]
        counts.begin()
        steps0 = sum(getattr(s.engine, "inner", s.engine).device_steps for s in servers)
        split_s, shares, merged_all = [], [0, 0, 0], []
        for rows, payload in zip(reqs, payloads):
            entries = router_entries(payload)
            owner = [picker.owner_addr(r["account_id"]) for r in rows]
            t = time.perf_counter()
            merged = [None] * len(rows)
            for i, name in enumerate(names):
                idx = [j for j, o in enumerate(owner) if o == name]
                shares[i] += len(idx)
                got = router_entries(servers[i].service.call(
                    "ScoreBatch", b"".join(entries[j] for j in idx)))
                for j, entry in zip(idx, got):
                    merged[j] = entry
            split_s.append(time.perf_counter() - t)
            merged_all.append(merged)
        for merged, payload in zip(merged_all, payloads):
            whole = router_entries(servers[0].service.call("ScoreBatch", payload))
            if [without_time(e) for e in merged] != [without_time(e) for e in whole]:
                raise AssertionError("fleet: merged owner shares differ from one replica's answer")
        # The router over the wire, in front of replicas 0 and 1.
        router = ScoringRouter({f"r{i}": (f"localhost:{servers[i].grpc_port}", None)
                                for i in range(2)}, hedge=False)
        front, _, front_port = serve_router(router, 0)
        channel = grpc_wire.insecure_channel(f"localhost:{front_port}")
        try:
            stub = grpc_server.make_risk_stub(channel)
            forwards0 = router.stats["forwards"]
            routed_s = []
            for merged, payload in zip(merged_all, payloads):
                t = time.perf_counter()
                routed = router_entries(stub.ScoreBatch(payload, timeout=120))
                routed_s.append(time.perf_counter() - t)
                if [without_time(e) for e in routed] != [without_time(e) for e in merged]:
                    raise AssertionError("fleet: the router's merge over the wire differs from "
                                         "the in-process merge")
            single = codec.encode(codec.SCORE_TRANSACTION_REQUEST, reqs[0][0])
            routed_single = stub.ScoreTransaction(single, timeout=60)
            if message_without(routed_single, 6) != message_without(
                    servers[0].service.call("ScoreTransaction", single), 6):
                raise AssertionError("fleet: a ScoreTransaction through the router differs")
            router_forwards = router.stats["forwards"] - forwards0
            if router_forwards < 2 * len(payloads):
                raise AssertionError(f"fleet: the router split {len(payloads)} RPCs into "
                                     f"{router_forwards} forwards")
        finally:
            channel.close()
            front.stop(0).wait()
            router.close()
        steps = sum(getattr(s.engine, "inner", s.engine).device_steps for s in servers) - steps0
        if steps == 0:
            raise AssertionError("fleet: no device step")
        launches = counts.end("fleet", {"forest": steps, "dense": 3 * steps, "forward": 0})
        t = time.perf_counter()
        http_text(servers[0].http_port, "/metrics")
        get_ms = (time.perf_counter() - t) * 1e3
        targets = {name: f"127.0.0.1:{s.http_port}" for name, s in zip(names, servers)}
        metrics = ServiceMetrics("risk")
        view = FleetView(targets, interval_s=0.25, timeout_s=1.0, stale_after_s=MD_FLEET_STALE_S,
                         metrics=metrics)
        t = time.perf_counter()
        view.scrape_once()
        scrape_ms = (time.perf_counter() - t) * 1e3
        snap = view.snapshot()
        per = [parse_histograms(http_text(s.http_port, "/metrics")[1]).get(
            "risk_stage_latency_ms", {}) for s in servers]
        stages = {}
        for fam in per:
            for key, h in fam.items():
                stage = dict(key).get("stage")
                stages[stage] = stages.get(stage, 0) + h.count
        merged_counts = {k: v["count"] for k, v in snap["fleet_stage_latency_ms"].items()}
        if not merged_counts or merged_counts != stages:
            raise AssertionError(f"fleet view: merged counts {merged_counts} != the replicas' "
                                 f"sum {stages}")
        drift_block = snap.get("fleet_drift")
        view.start()
        servers[2].shutdown(grace=0.2)
        stopped = time.perf_counter()
        stale_s, worst_ms = None, 0.0
        while time.perf_counter() - stopped < 3 * MD_FLEET_STALE_S + 2:
            t = time.perf_counter()
            s = view.snapshot()
            worst_ms = max(worst_ms, (time.perf_counter() - t) * 1e3)
            if {r["replica"]: r for r in s["replicas"]}["replica2"]["stale"]:
                stale_s = time.perf_counter() - stopped
                break
            time.sleep(0.05)
        if stale_s is None or stale_s > MD_FLEET_STALE_S + 1.0 or worst_ms > 50.0:
            raise AssertionError(f"fleet view: stale after {stale_s} s, a snapshot took "
                                 f"{worst_ms:.1f} ms")
    finally:
        if view is not None:
            view.stop()
        for s in servers[:2]:
            s.shutdown(grace=0.2)
    return {"owner_rows": shares, "split_rpc_ms": statistics.median(split_s) * 1e3,
            "router_rpc_ms": statistics.median(routed_s) * 1e3,
            "router_forwards": router_forwards,
            "launches": launches, "steps": steps, "scrape_ms": scrape_ms,
            "sidecar_get_ms": get_ms,
            "stage_counts": stages, "stale_after_s": stale_s,
            "snapshot_worst_ms": worst_ms, "fleet_drift": drift_block}


def fleet_capture_cards(torch, store, params, batches, device: str) -> dict | None:
    """Part 7, under SMOKE_DISTINCT_CARDS=1 with two cards or more (else
    None): a ``RiskServer`` over a data mesh of every visible card, as
    ``MESH_DEVICES`` lays it out, readies each card for captures at boot;
    one capture forced under ScoreBatch RPCs. Held: every kernel and step
    mark has its ``ts`` and ``dur``; the kernel events equal the launch
    deltas, each card's share equal (a data shard launches every kernel
    once a step); no mark made a CUDA event (an empty pool) on a serving
    thread."""
    import threading

    from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig
    from igaming_platform_tpu_torch.obs import devtrace
    from igaming_platform_tpu_torch.serve import server

    n = torch.cuda.device_count() if device == "cuda" else 0
    if os.environ.get("SMOKE_DISTINCT_CARDS") != "1" or n < 2:
        return None
    config = RiskServiceConfig(batcher=BatcherConfig(
        batch_size=BATCH_SIZE, latency_tiers=LATENCY_TIERS, max_wait_ms=2.0))
    assembled = server.assemble_risk_service(config, ml_backend="mlp+gbdt", params=params,
                                             feature_store=store, device=device,
                                             mesh=md_mesh(device, data=n))
    srv = server.RiskServer(assembled, grpc_port=-1, http_port=0)
    tel, made, orig = srv.telemetry, [], devtrace._event

    def counting(card):
        if not devtrace._POOL.get(card):
            made.append((card, threading.current_thread().name))
        return orig(card)

    saved = (tel.cooldown_s, tel.profile_enabled, os.environ.get("ANOMALY_PROFILE_SECONDS"))
    try:
        readied = sorted(devtrace._POOL)
        if readied != list(range(n)):
            raise AssertionError(f"cards: {readied} readied at boot of {n}")
        srv.service.call("ScoreBatch", batches[0])
        devtrace._event = counting
        tel.cooldown_s, tel.profile_enabled = 0.0, True
        os.environ["ANOMALY_PROFILE_SECONDS"] = "1.0"
        rec, k = {}, 0
        for attempt in range(3):  # a natural anomaly's capture may hold the lock
            if not srv._profile_lock.acquire(timeout=60):
                raise AssertionError("cards: a capture did not end")
            srv._profile_lock.release()
            trace_id = f"cards-{attempt}"
            tel._maybe_profile(trace_id, "score.dispatch", 0.0)
            rec, end = {}, time.monotonic() + 120
            while not ("trace" in rec or "error" in rec) and time.monotonic() < end:
                srv.service.call("ScoreBatch", batches[k % len(batches)])
                k += 1
                rec = next((c for c in reversed(tel.profile_captures)
                            if c["trace_id"] == trace_id), {})
            if "trace" in rec:
                break
        if "trace" not in rec:
            raise AssertionError(f"cards: the capture wrote no trace: {rec}")
        with open(rec["trace"], encoding="utf-8") as f:
            trace = json.load(f)
    finally:
        devtrace._event = orig
        tel.cooldown_s, tel.profile_enabled = saved[:2]
        if saved[2] is None:
            os.environ.pop("ANOMALY_PROFILE_SECONDS", None)
        else:
            os.environ["ANOMALY_PROFILE_SECONDS"] = saved[2]
        srv.shutdown(grace=1.0)
    marks = [ev for ev in trace["traceEvents"] if ev.get("cat") in ("kernel", "step")]
    incomplete = [ev["name"] for ev in marks if "dur" not in ev or ev["args"].get("incomplete")]
    per_card: dict[int, dict] = {}
    for ev in marks:
        if ev["cat"] == "kernel":
            card = per_card.setdefault(ev["pid"] - 2, {})
            card[ev["name"]] = card.get(ev["name"], 0) + 1
    window = trace["window"]
    shares = {name: [per_card.get(i, {}).get(name, 0) for i in range(n)]
              for name in window["launches"]}
    bad = []
    if incomplete:
        bad.append(f"{len(incomplete)} marks without ts and dur: {sorted(set(incomplete))}")
    if window["kernel_events"] != window["launches"] or not window["launches"]:
        bad.append(f"kernel events {window['kernel_events']} against launches "
                   f"{window['launches']}")
    if any(len(set(v)) != 1 or sum(v) != window["launches"][k] for k, v in shares.items()):
        bad.append(f"per-card kernel events {shares}")
    if made:
        bad.append(f"{len(made)} CUDA events made on serving threads: {made[:5]}")
    if bad:
        raise AssertionError("cards: " + "; ".join(bad))
    return {"cards": n, "readied": readied, "rpcs": k, "marks": len(marks),
            "per_card_kernel_events": shares, "window_launches": window["launches"],
            "anchor_uncertainty_us": window.get("anchor_uncertainty_us")}


def router_entries(payload: bytes) -> list[bytes]:
    """The raw result (or transaction) entries of a ScoreBatch message, as
    the router splits and merges them."""
    from igaming_platform_tpu_torch.serve.router import _entries

    return _entries(payload)


def without_time(entry: bytes) -> bytes:
    """A ScoreBatch result entry without its ``response_time_ms`` (field 6),
    the one field two replicas' answers of one row may differ in."""
    from igaming_platform_tpu_torch.serve import risk_codec as codec

    n = len(entry)
    _, pos = codec._read_varint(entry, 0, n)
    _, pos = codec._read_varint(entry, pos, n)
    out = []
    while pos < n:
        start = pos
        key, pos = codec._read_varint(entry, pos, n)
        pos = codec._skip(entry, pos, n, key & 7)
        if key >> 3 != 6:
            out.append(entry[start:pos])
    return b"".join(out)


def phase_multi_device(torch, card: str, gbdt_kernel, fa, dense_mod, store,
                       device: str = "cuda") -> dict:
    """Phase 17: multi-device serving and the fleet, on phase 7's store, over
    LOGICAL meshes whose shards repeat the one card (the layouts and the
    arithmetic of a sharded program, no interconnect): the routed backend,
    data and model sharding, slot-sharded state, sequence-sharded abuse
    scoring, the multi-host front with a follower process, and a fleet of
    three replicas behind the affinity ring with the fleet view.
    ``device="cpu"`` rehearses it without a card (the launch checks then
    skipped)."""
    import shutil
    import tempfile

    from igaming_platform_tpu_torch.convert import from_jax_params, save_params_tree
    from igaming_platform_tpu_torch.parallel import distributed
    from igaming_platform_tpu_torch.serve import risk_codec as codec

    t0 = time.perf_counter()
    STORE_CLOCK[0] = SERVER_NOW
    counts = Launches(gbdt_kernel, dense_mod, fa, device)
    root = tempfile.mkdtemp(prefix="chip-smoke-md-")
    rng = np.random.default_rng(22)  # phase 7's tree
    params = from_jax_params("mlp+gbdt", {"mlp": mlp_tree(rng, SERVE_HIDDEN),
                                          "gbdt": forest_tree(rng, SERVE_TREES, SERVE_DEPTH)})
    save_params_tree(os.path.join(root, "multitask.npz"),
                     {"multitask": multitask_tree(np.random.default_rng(175), MULTITASK_TRUNK)})
    rng = np.random.default_rng(176)
    batches = md_batches(codec, rng, MD_RPCS, SERVER_BATCH_ROWS)
    # The follower boots while parts 1-4 run; the front hosts the store.
    follower = Follower(root, device)
    saved_env = {k: os.environ.get(k) for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES",
                                                 "PROCESS_ID", "BURN_SHED",
                                                 "BULK_P99_SLO_MS")}
    # The process's SLO engine has seen every earlier phase's latencies: its
    # burn gate and the bulk p99 gate would shed this phase's ScoreBatch
    # RPCs, which are held for their answers, not their latency.
    os.environ.update(follower.env(), PROCESS_ID="0", BURN_SHED="0", BULK_P99_SLO_MS="0")
    distributed.initialize_from_env()
    follower.start()
    parts, mark = {}, [time.perf_counter()]

    def part(name: str) -> None:
        now = time.perf_counter()
        parts[name] = round(now - mark[0], 2)
        mark[0] = now

    if os.environ.get("SMOKE_DISTINCT_CARDS") == "1":
        log(f"phase 17: [{card}] meshes over the visible cards")
    else:
        shard_dev = "cuda:0" if device == "cuda" else "cpu"
        log(f"phase 17: [{card}] logical meshes: every shard on {shard_dev}; no number here is "
            "a multi-GPU speed")
    try:
        routed = fleet_routed(torch, codec, store, counts, rng, batches, device)
        part("routed")
        log(f"phase 17: routed over data=2 x expert=4: {MD_RPCS} ScoreBatch RPCs of "
            f"{SERVER_BATCH_ROWS} rows equal to the unsharded dense_reference engine bit for bit, "
            f"{routed['singles']} ScoreTransaction RPCs equal to their batch rows, the first "
            f"{routed['cpu_rows']} rows against the CPU twin ({routed['floor_boundary_rows']} "
            f"floor-boundary rows); expert load {routed['expert_load']}, {routed['dropped']} "
            f"picks dropped at capacity factor 4; rows/s {json.dumps(routed['rows_per_s'])}; "
            f"a single {routed['single_ms']:.2f} ms on the mesh; launches "
            f"{json.dumps(routed['launches'])} for steps {json.dumps(routed['steps'])}; seconds "
            f"{json.dumps(routed['seconds'])}")
        sharded = fleet_sharded(torch, codec, store, counts, params, batches, device)
        part("sharded")
        log(f"phase 17: mlp+gbdt over data=2 bit-equal to unsharded; over data=2 x model=2 x "
            f"expert=2 ml_score within {MD_MODEL_ATOL} (max "
            f"{sharded['ml_max_abs_err_model_sharded']:.3g}, {sharded['ml_rows_differing']} rows "
            f"not bit-equal, {sharded['rows_excused']} rows near a floor or 0.7 excused); rows/s "
            f"{json.dumps(sharded['rows_per_s'])}; launches {json.dumps(sharded['launches'])}")
        log(f"phase 17: floors: F, a {SERVER_BATCH_ROWS}-row ScoreBatch on the unsharded engine, "
            f"{sharded['rpc_ms']['plain']:.2f} ms (median of {MD_SHARD_RPCS})")
        # The multi-host part kills its follower and restarts it; the restart
        # boots while parts 3, 4 and 6 run.
        mh_run = FleetMultihost(torch, codec, store, counts, batches, follower, root, device)
        try:
            mh_run.start()
            part("multihost")
            state = fleet_state(torch, codec, store, counts, params, rng, device)
            part("state")
            log(f"phase 17: slot-sharded IDX1 + session over data=4, {MD_STATE_CAPACITY} slots: "
                f"{MD_STATE_FRAMES} frames equal to unsharded, every shard live, "
                f"table/ring/cursor/length gathered bit-equal; cache bytes "
                f"per shard {state['cache_bytes_per_shard']} of {state['cache_bytes_unsharded']} "
                f"({state['shard_share']:.4f}), ring bytes per shard "
                f"{state['ring_bytes_per_shard']} of {state['ring_bytes_unsharded']}; occupancy "
                f"{state['occupancy']}, {state['evictions']} evictions; rows/s {json.dumps(state['rows_per_s'])}; launches "
                f"{json.dumps(state['launches'])}")
            seq = fleet_sequence(torch, counts, device)
            part("sequence")
            log(f"phase 17: sequence-sharded abuse over data=2 x seq=4, {MD_ABUSE_ACCOUNTS} "
                f"accounts of {MD_ABUSE_HISTORY} events: " + json.dumps(seq))
            fleet = fleet_replicas(torch, codec, store, counts, params, rng, device)
            part("fleet")
            cards = fleet_capture_cards(torch, store, params, batches, device)
            if cards is not None:
                part("cards")
                log(f"phase 17: a capture over {cards['cards']} cards (every card readied at "
                    f"boot): {cards['marks']} marks, every one with ts and dur; kernel events "
                    f"per card {json.dumps(cards['per_card_kernel_events'])} sum to the launch "
                    f"deltas {json.dumps(cards['window_launches'])}; no CUDA event made on a "
                    "serving thread")
            mh = mh_run.finish()
            part("multihost rejoin (the rest of the follower's restart)")
        finally:
            mh_run.close()
        log(f"phase 17: multi-host front over gloo, follower process: {MD_RPCS} RPCs and "
            f"{MD_SINGLES} singles equal to one process; {mh['rows_per_s']:.0f} rows/s, a single "
            f"{mh['single_ms']:.2f} ms; gather {mh['gather_ms_per_step']:.3f} ms a step "
            f"({mh['gather_rows_per_process']} rows each), a {SERVER_BATCH_ROWS}-row step "
            f"{mh['step_whole_ms']:.2f} ms of which the gather {mh['gather_whole_ms']:.3f} ms; "
            f"follower killed: {mh['degraded_steps']} degraded steps, "
            f"{mh['degraded_rows_per_s']:.0f} rows/s, equal, breaker open; rejoined in "
            f"{mh['rejoin_s']:.1f} s, follower_resurrections_total "
            f"{mh['follower_resurrections_total']:.0f}; launches {json.dumps(mh['launches'])}; "
            f"seconds {json.dumps(mh['seconds'])}")
        log(f"phase 17: fleet of 3 replicas: owner rows {fleet['owner_rows']}, merged answers "
            f"equal to one replica's; a split RPC {fleet['split_rpc_ms']:.1f} ms; serve_router in "
            f"front of two over the port's gRPC transport: merges and a ScoreTransaction equal "
            f"to in-process, a routed RPC {fleet['router_rpc_ms']:.1f} ms "
            f"({fleet['router_forwards']} forwards); fleet view "
            f"scrape {fleet['scrape_ms']:.1f} ms, merged stage counts equal to the replicas' sum "
            f"{json.dumps(fleet['stage_counts'])}; a stopped replica stale after "
            f"{fleet['stale_after_s']:.2f} s (limit {MD_FLEET_STALE_S}), worst snapshot "
            f"{fleet['snapshot_worst_ms']:.2f} ms; S, one sidecar GET /metrics, "
            f"{fleet['sidecar_get_ms']:.2f} ms; fleet_drift "
            f"{json.dumps(fleet['fleet_drift'], default=str)[:600]}; launches "
            f"{json.dumps(fleet['launches'])}")
        follower.stop()
        log(f"phase 17: seconds by part {json.dumps(parts)}")
    except BaseException:
        log("phase 17: follower log: " + follower.tail())
        raise
    finally:
        follower.kill()
        distributed.shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    result = {"routed": routed, "sharded": sharded, "state": state,
              "sequence": seq, "multihost": mh, "part_seconds": parts, "cards": cards,
              "fleet": {k: v for k, v in fleet.items() if k != "fleet_drift"},
              "launches": counts.total, "seconds": time.perf_counter() - t0}
    log(f"phase 17: launches {json.dumps(counts.total)}; {result['seconds']:.1f} s")
    log("phase 17: " + json.dumps(result, default=str))
    return result


# Phase 18: multi-device training over LOGICAL meshes of the one card (every
# shard on cuda:0; with SMOKE_DISTINCT_CARDS=1, md_mesh spreads a mesh's
# shards over the visible cards): Ulysses and ring abuse training over data x
# seq, the multitask Trainer over data and data x model, the pipeline trainer
# over model, and the routed ensemble trained and served. A logical mesh
# measures layouts, arithmetic and launches, never an interconnect. TM_*
# sizes: the ring run's steps (the dense run's first TM_RING_STEPS batches);
# the Trainer's steps at TrainConfig's defaults, the first TM_TRAIN_HELD held
# to the unsharded trainer at tests/test_train.py's bounds; the pipeline's
# stages, steps and rows (tests/test_pp_training.py's data); the routed
# trainer's fraudgen rows (train, held out) and its CPU twin's steps.
TM_SEQ_MESH = dict(data=2, seq=2)
TM_RING_STEPS, TM_TRAIN_STEPS, TM_TRAIN_HELD = 20, 20, 6
TM_TRAIN_MESHES = (dict(data=2), dict(data=2, model=2))
TM_LOSS_RTOL, TM_MAE_RTOL = 2e-4, 2e-3  # tests/test_train.py:144-145
TM_SEQ_RTOL = 2e-4  # the ring forward's bound, tests/test_sequence.py:46
TM_PP_STAGES, TM_PP_STEPS, TM_PP_ROWS, TM_PP_IN = 4, 10, 256, 12
TM_ROUTED_ROWS, TM_ROUTED_TWIN_STEPS, TM_ROUTED_RTOL = (20_000, 8_000), 20, 1e-4
# The routed twin's steps held at TM_ROUTED_RTOL. The router sees raw
# features (logits in the thousands), so its gates differ between the card
# and the CPU in the fifth digit, and Adam's early steps (about lr * sign(g))
# turn router gradients of 1e-10, whose relative error between two devices is
# of order 1, into steps of lr: the runs part after a few steps (both within
# 1e-4 for 5, 1.4e-3 apart at the 8th on an H100). Every step is reported;
# two card runs are held bit-equal to each other.
TM_ROUTED_HELD = 5


class _Count:
    """An attribute counter of a kernel wrapper, seen as ``.launches``."""

    def __init__(self, obj, attr: str):
        self.obj, self.attr = obj, attr

    @property
    def launches(self) -> int:
        return getattr(self.obj, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.obj, self.attr, value)


class TrainLaunches(Launches):
    """``Launches`` with the backward kernels' two counters."""

    NAMES = ("forest", "dense", "dense_f32", "forward", "dq", "dkv")

    def __init__(self, gbdt_kernel, dense_mod, fa, device: str):
        super().__init__(gbdt_kernel, dense_mod, fa, device)
        self.counters.update(dq=_Count(fa.flash_attention_bwd, "launches_dq"),
                             dkv=_Count(fa.flash_attention_bwd, "launches_dkv"))
        self.total = dict.fromkeys(self.NAMES, 0)


def _max_rel(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def mesh_train_abuse(torch, counts, dense_losses, mode: str, steps: int, device: str) -> dict:
    """(1, 2) ``train_abuse_detector`` over data x seq in ``mode``, at
    AbuseTrainConfig's defaults but ``steps``, against the dense run's
    losses of the same batches (phase 6's)."""
    from igaming_platform_tpu_torch.train import abuse_train as at

    tcfg = at.AbuseTrainConfig(steps=steps)
    cfg = tcfg.model
    shards = int(np.prod(list(TM_SEQ_MESH.values())))
    per = cfg.n_layers * shards if mode == "ulysses" else 0
    counts.begin()
    t = time.perf_counter()
    _, metrics = at.train_abuse_detector(tcfg, mesh=md_mesh(device, **TM_SEQ_MESH),
                                         seq_mode=mode, device=device)
    counts.sync()
    secs = time.perf_counter() - t
    launches = counts.end(f"{mode} training", {
        "forward": per * (steps + 1), "dq": per * steps, "dkv": per * steps,
        "dense_f32": affine_layers(cfg) * (steps + 1)})
    losses = metrics["losses"]
    want = dense_losses[:steps]
    rel = _max_rel(losses, want)
    if not np.isfinite(losses).all() or rel > TM_SEQ_RTOL:
        raise AssertionError(f"{mode} training: losses {losses[:5]}... against the dense run's "
                             f"{want[:5]}...: {rel:.3g} relative")
    if mode == "ulysses" and metrics["eval_accuracy"] < MIN_ACCURACY:
        raise AssertionError(f"ulysses training: eval accuracy {metrics['eval_accuracy']}")
    return {"steps": steps, "bit_equal_steps": int(sum(a == b for a, b in zip(losses, want))),
            "loss_max_rel": rel, "final_loss": losses[-1],
            "eval_accuracy": metrics["eval_accuracy"], "seconds": secs,
            "launches": launches}


def mesh_train_trainer(torch, counts, device: str) -> dict:
    """(3) the multitask Trainer at TrainConfig's defaults over each of
    TM_TRAIN_MESHES, against an unsharded card Trainer fed the same batches
    through ``fit`` (double-buffered ``put_batch``)."""
    from igaming_platform_tpu_torch.train import trainer as tr
    from igaming_platform_tpu_torch.train.data import make_stream

    cfg = tr.TrainConfig()
    stream = make_stream(cfg.batch_size, seed=181)
    batches = [next(stream) for _ in range(TM_TRAIN_STEPS)]
    layers = len(cfg.trunk)

    def run(axes):
        mesh = None if axes is None else md_mesh(device, **axes)
        t = tr.Trainer(cfg, mesh=mesh, device=device)
        hist = []
        n_data = 1 if axes is None else axes.get("data", 1)
        n_model = 1 if axes is None else axes.get("model", 1)
        per_shard = layers * n_model + 3  # the trunk's layers on each model shard, 3 heads
        counts.begin()
        t0 = time.perf_counter()
        t.fit(TM_TRAIN_STEPS, data=iter(batches), log_every=1,
              log_fn=lambda step, m: hist.append(m))
        counts.sync()
        secs = time.perf_counter() - t0
        what = f"Trainer over {axes}"
        launches = counts.end(what, {"dense": n_data * per_shard * TM_TRAIN_STEPS})
        first = [list(r.parameters()) for r in t.replicas]
        if not all(torch.equal(a, b.to(a.device)) for r in first[1:] for a, b in zip(first[0], r)):
            raise AssertionError(f"{what}: the replicas differ")
        return t, hist, {"replicas": len(t.replicas), "seconds": secs,
                         "ms_per_step": secs * 1e3 / TM_TRAIN_STEPS, "launches": launches,
                         "dense_per_step": launches["dense"] / TM_TRAIN_STEPS}

    plain, want, out = run(None)
    served = plain.export_params()
    runs = {"unsharded": out}
    for axes in TM_TRAIN_MESHES:
        t, hist, info = run(axes)
        name = "x".join(f"{k}={v}" for k, v in axes.items())
        loss_rel = [abs(g["loss"] - w["loss"]) / abs(w["loss"]) for g, w in zip(hist, want)]
        mae_rel = [abs(g["fraud_mae"] - w["fraud_mae"]) / abs(w["fraud_mae"])
                   for g, w in zip(hist, want)]
        if max(loss_rel[:TM_TRAIN_HELD]) > TM_LOSS_RTOL or \
                max(mae_rel[:TM_TRAIN_HELD]) > TM_MAE_RTOL:
            raise AssertionError(f"Trainer over {name}: first {TM_TRAIN_HELD} steps' loss "
                                 f"{loss_rel[:TM_TRAIN_HELD]} / fraud_mae "
                                 f"{mae_rel[:TM_TRAIN_HELD]} relative to the unsharded run")
        mine = t.export_params()
        w_err = max(float((a.w_bf16 - b.w_bf16).abs().max())
                    for a, b in zip(mine.trunk, served.trunk))
        runs[name] = {**info, "loss_max_rel_held": max(loss_rel[:TM_TRAIN_HELD]),
                      "fraud_mae_max_rel_held": max(mae_rel[:TM_TRAIN_HELD]),
                      "loss_rel_last": loss_rel[-1], "fraud_mae_rel_last": mae_rel[-1],
                      "bit_equal_steps": int(sum(g["loss"] == w["loss"]
                                                 for g, w in zip(hist, want))),
                      "export_trunk_w_bf16_max_abs_diff": w_err}
    return {"steps": TM_TRAIN_STEPS, "batch": cfg.batch_size, "trunk": list(cfg.trunk),
            "last_loss": want[-1]["loss"], "runs": runs}


def mesh_train_pp(torch, counts, device: str) -> dict:
    """(4) PPTrainer over model=TM_PP_STAGES against its sequential path, at
    PPTrainConfig's defaults, from one seed."""
    from igaming_platform_tpu_torch.train import pp

    rng = np.random.default_rng(0)
    x = rng.normal(size=(TM_PP_ROWS, TM_PP_IN)).astype(np.float32)
    w = rng.normal(size=(TM_PP_IN,)).astype(np.float32)
    y = (x @ w + 0.1 * rng.normal(size=TM_PP_ROWS)).astype(np.float32)
    cfg = pp.PPTrainConfig()
    mesh = md_mesh(device, data=1, model=TM_PP_STAGES)
    piped = pp.PPTrainer(cfg, TM_PP_IN, TM_PP_STAGES, mesh, device=device)
    seq = pp.PPTrainer(cfg, TM_PP_IN, TM_PP_STAGES, None, device=device)
    first = (piped.loss_fn(piped.params, x, y), seq.loss_fn(seq.params, x, y))
    if first[0] != first[1]:
        raise AssertionError(f"pipeline trainer: first loss {first[0]} against {first[1]}")
    out = {}
    for name, t, per in (("pipelined", piped, 2 + TM_PP_STAGES * cfg.num_microbatches),
                         ("sequential", seq, 2 + TM_PP_STAGES)):
        counts.begin()
        t0 = time.perf_counter()
        losses = [t.train_step(x, y) for _ in range(TM_PP_STEPS)]
        secs = time.perf_counter() - t0
        out[name] = {"losses": losses, "seconds": secs,
                     "launches": counts.end(f"{name} trainer",
                                            {"dense_f32": per * TM_PP_STEPS})}
    lp, ls = out["pipelined"]["losses"], out["sequential"]["losses"]
    if not np.allclose(lp, ls, rtol=2e-4, atol=1e-6):
        raise AssertionError(f"pipeline trainer: losses {lp} against {ls}")
    err = 0.0
    for a, b in zip(pp.leaves(piped.params), pp.leaves(seq.params)):
        a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
        if not np.allclose(a, b, rtol=2e-3, atol=2e-5):
            raise AssertionError("pipeline trainer: params part from the sequential path's")
        err = max(err, float(np.abs(a - b).max()))
    return {"stages": TM_PP_STAGES, "microbatches": cfg.num_microbatches,
            "first_loss_bit_equal": True, "bit_equal_steps": int(sum(a == b for a, b in zip(lp, ls))),
            "loss_max_rel": _max_rel(lp, ls), "param_max_abs_diff": err, **out}


def mesh_train_routed(torch, counts, device: str) -> dict:
    """(5) ``train_routed_on_labels`` at RoutedTrainConfig's defaults on
    fraudgen rows: a card/CPU twin of TM_ROUTED_TWIN_STEPS steps on the same
    batches; held-out AUC against the untrained bundle's; the bundle served
    by a card engine (``ml_backend="routed"``), bit-equal to ``routed_prob``;
    the matmul forest bit-equal to the forest kernel on its trees."""
    from igaming_platform_tpu_torch.convert import params_to
    from igaming_platform_tpu_torch.core.config import BatcherConfig
    from igaming_platform_tpu_torch.core.features import normalize, standardize_for_model
    from igaming_platform_tpu_torch.models.ensemble import init_routed_params
    from igaming_platform_tpu_torch.models.gbdt import gbdt_raw
    from igaming_platform_tpu_torch.ops import gbdt_matmul
    from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine
    from igaming_platform_tpu_torch.train import routed as rt
    from igaming_platform_tpu_torch.train.eval import roc_auc
    from igaming_platform_tpu_torch.train.fraudgen import generate_labeled

    x, y, _ = generate_labeled(np.random.default_rng(183), TM_ROUTED_ROWS[0])
    xt, yt, _ = generate_labeled(np.random.default_rng(184), TM_ROUTED_ROWS[1])
    twin_cfg = rt.RoutedTrainConfig(steps=TM_ROUTED_TWIN_STEPS)
    twin = {}
    for run, dev in (("card", device), ("card again", device), ("cpu", "cpu")):
        twin[run] = []
        rt.train_routed_on_labels(x, y, twin_cfg, device=dev, losses=twin[run])
        twin[run] = [float(v) for v in twin[run]]
    if twin["card"] != twin["card again"]:
        raise AssertionError(f"routed training: two card runs differ: {twin['card']} against "
                             f"{twin['card again']}")
    rel = [abs(a - b) / abs(b) for a, b in zip(twin["card"], twin["cpu"])]
    if max(rel[:TM_ROUTED_HELD]) > TM_ROUTED_RTOL:
        raise AssertionError(f"routed training: card losses {twin['card']} against the CPU's "
                             f"{twin['cpu']}")
    twin_rel = max(rel[:TM_ROUTED_HELD])
    cfg = rt.RoutedTrainConfig()
    losses = []
    counts.begin()
    t0 = time.perf_counter()
    bundle = rt.train_routed_on_labels(x, y, cfg, device=device, losses=losses)
    counts.sync()
    secs = time.perf_counter() - t0
    # A step: the router (dense_f32), the MLP's 3 layers and the multitask
    # trunk and fraud head (3 layers) through the dense kernel; the soft
    # forest is torch ops.
    launches = counts.end("routed training", {"forest": 0, "forward": 0,
                                              "dense": 6 * cfg.steps, "dense_f32": cfg.steps})
    fresh = params_to(init_routed_params(cfg.seed, mlp_hidden=cfg.mlp_hidden,
                                         n_trees=cfg.n_trees, depth=cfg.depth,
                                         trunk=cfg.trunk), device)
    auc = {"trained": roc_auc(yt, rt.routed_prob(bundle, xt)),
           "untrained": roc_auc(yt, rt.routed_prob(fresh, xt))}
    if not auc["trained"] > auc["untrained"]:
        raise AssertionError(f"routed training: held-out AUC {auc}")
    rows = np.ascontiguousarray(xt[:BATCH_SIZE])
    engine = TorchScoringEngine(ml_backend="routed", params=bundle, device=device,
                                batcher_config=BatcherConfig(batch_size=BATCH_SIZE,
                                                             latency_tiers=LATENCY_TIERS,
                                                             max_wait_ms=2.0))
    try:
        counts.begin()
        served = engine.score_arrays(rows)["ml_score"].cpu().numpy()
        serve_launches = counts.end("routed serving", {"forest": 1, "dense": 6,
                                                       "dense_f32": 1})
    finally:
        engine.close()
    want = rt.routed_prob(bundle, rows).astype(np.float32)
    differ = int((served.view(np.int32) != want.view(np.int32)).sum())
    if differ:
        raise AssertionError(f"routed serving: {differ} of {len(rows)} ml_scores differ from "
                             f"routed_prob")
    prep = standardize_for_model(normalize(torch.from_numpy(rows).to(device)))
    sel = gbdt_matmul.precompute_selector(bundle["gbdt"]["feat"].cpu().numpy(), prep.shape[1])
    with torch.no_grad():
        matmul = gbdt_matmul.gbdt_raw_matmul(bundle["gbdt"], sel, prep)
        gather = gbdt_raw(bundle["gbdt"], prep)
    matmul_differ = int((matmul != gather).sum())
    if matmul_differ:
        raise AssertionError(f"gbdt_raw_matmul: {matmul_differ} rows differ from gbdt_raw")
    return {"steps": cfg.steps, "batch": cfg.batch_size, "rows": list(TM_ROUTED_ROWS),
            "twin_steps": TM_ROUTED_TWIN_STEPS, "twin_held_steps": TM_ROUTED_HELD,
            "twin_loss_max_rel": twin_rel, "twin_loss_rel_by_step": rel,
            "twin_first_step_apart": next((i for i, r in enumerate(rel) if r > 0), None),
            "loss_first_last": [float(losses[0]), float(losses[-1])], "seconds": secs,
            "ms_per_step": secs * 1e3 / cfg.steps, "auc": auc, "launches": launches,
            "served_rows": len(rows), "served_bit_equal": True,
            "serve_launches": serve_launches, "matmul_rows_bit_equal": len(rows)}


def phase_train_mesh(torch, card: str, gbdt_kernel, fa, dense_mod, dense_losses,
                     device: str = "cuda") -> dict:
    """Phase 18: multi-device training over LOGICAL meshes of the one card
    (the layouts and the arithmetic of a sharded program, no interconnect):
    Ulysses and ring abuse training, the multitask Trainer over data and
    data x model, the pipeline trainer and the routed ensemble.
    ``dense_losses`` are phase 6's 200 dense losses (None: trained here).
    ``device="cpu"`` rehearses it without a card (the launch checks then
    skipped)."""
    from igaming_platform_tpu_torch.train import abuse_train as at

    t0 = time.perf_counter()
    counts = TrainLaunches(gbdt_kernel, dense_mod, fa, device)
    if dense_losses is None:
        dense_losses = at.train_abuse_detector(at.AbuseTrainConfig(), device=device)[1]["losses"]
    parts, mark = {}, [time.perf_counter()]

    def part(name: str) -> None:
        now = time.perf_counter()
        parts[name] = round(now - mark[0], 2)
        mark[0] = now

    spread = os.environ.get("SMOKE_DISTINCT_CARDS") == "1"
    log(f"phase 18: [{card}] " + ("meshes over the visible cards" if spread else
                                  f"logical meshes: every shard on "
                                  f"{md_mesh(device, data=1).device}; no number here is a "
                                  f"multi-GPU speed"))
    ulysses = mesh_train_abuse(torch, counts, dense_losses, "ulysses", at.AbuseTrainConfig().steps,
                               device)
    part("ulysses")
    log(f"phase 18: [{card}] Ulysses abuse training over data=2 x seq=2, "
        f"{ulysses['steps']} steps in {ulysses['seconds']:.2f} s: {ulysses['bit_equal_steps']} "
        f"losses bit-equal to phase 6's dense run, the rest within "
        f"{ulysses['loss_max_rel']:.3g} (relative); eval accuracy {ulysses['eval_accuracy']}; "
        f"launches {json.dumps(ulysses['launches'])}")
    ring = mesh_train_abuse(torch, counts, dense_losses, "ring", TM_RING_STEPS, device)
    part("ring")
    log(f"phase 18: [{card}] ring abuse training over data=2 x seq=2, {ring['steps']} steps in "
        f"{ring['seconds']:.2f} s: losses within {ring['loss_max_rel']:.3g} of the dense run's "
        f"({ring['bit_equal_steps']} bit-equal); launches {json.dumps(ring['launches'])}")
    trainer_run = mesh_train_trainer(torch, counts, device)
    part("trainer")
    log(f"phase 18: [{card}] Trainer, {trainer_run['steps']} steps of {trainer_run['batch']} x "
        f"{trainer_run['trunk']} through fit: " + json.dumps(trainer_run["runs"]))
    pp_run = mesh_train_pp(torch, counts, device)
    part("pipeline")
    log(f"phase 18: [{card}] PPTrainer, {TM_PP_STAGES} stages on model, "
        f"{pp_run['microbatches']} microbatches, {TM_PP_STEPS} steps: first loss bit-equal to "
        f"the sequential path, losses within {pp_run['loss_max_rel']:.3g} "
        f"({pp_run['bit_equal_steps']} bit-equal), params within "
        f"{pp_run['param_max_abs_diff']:.3g}; seconds "
        f"{pp_run['pipelined']['seconds']:.3f} / {pp_run['sequential']['seconds']:.3f}; "
        f"launches {json.dumps(pp_run['pipelined']['launches'])} / "
        f"{json.dumps(pp_run['sequential']['launches'])}")
    routed_run = mesh_train_routed(torch, counts, device)
    part("routed")
    log(f"phase 18: [{card}] train_routed_on_labels, {routed_run['steps']} steps of "
        f"{routed_run['batch']} in {routed_run['seconds']:.2f} s "
        f"({routed_run['ms_per_step']:.3f} ms a step): two card runs of "
        f"{TM_ROUTED_TWIN_STEPS} steps bit-equal; the first {TM_ROUTED_HELD} losses within "
        f"{routed_run['twin_loss_max_rel']:.3g} of the CPU twin's (first apart at step "
        f"{routed_run['twin_first_step_apart']}; relative by step "
        f"{json.dumps([float(f'{r:.3g}') for r in routed_run['twin_loss_rel_by_step']])}); "
        f"held-out AUC "
        f"{json.dumps(routed_run['auc'])}; a card routed engine's {routed_run['served_rows']} "
        f"ml_scores bit-equal to routed_prob (launches "
        f"{json.dumps(routed_run['serve_launches'])}); gbdt_raw_matmul bit-equal to the forest "
        f"kernel on {routed_run['matmul_rows_bit_equal']} rows; launches "
        f"{json.dumps(routed_run['launches'])}")
    result = {"ulysses": ulysses, "ring": ring, "trainer": trainer_run,
              "pipeline": pp_run, "routed": routed_run,
              "part_seconds": parts, "launches": counts.total,
              "seconds": time.perf_counter() - t0}
    log(f"phase 18: seconds by part {json.dumps(parts)}")
    log(f"phase 18: launches {json.dumps(counts.total)}; {result['seconds']:.1f} s")
    log("phase 18: " + json.dumps(result, default=str))
    return result


def wire_phases(capture_only: bool = False) -> dict:
    """The phases that go over the port's gRPC transport, alone: the kernels
    they launch built, phase 7's store filled, then phases 7, 15, 16 and 17
    (``capture_only``: phase 17's capture over every card alone, for a call
    with several cards and ``SMOKE_DISTINCT_CARDS=1``). Run it as
    ``python3 -c "import chip_smoke as c; c.wire_phases()"``."""
    import torch

    from igaming_platform_tpu_torch.convert import from_jax_params
    from igaming_platform_tpu_torch.ops import _build, gbdt_kernel
    from igaming_platform_tpu_torch.ops import dense as dense_mod
    from igaming_platform_tpu_torch.ops import flash_attention as fa
    from igaming_platform_tpu_torch.serve import native_store
    from igaming_platform_tpu_torch.serve import risk_codec as codec

    card = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["gbdt_forest", "flash_attention_fwd", "dense_fixed"])
    t0 = time.perf_counter()
    filled = (*fill_native_store(native_store, SERVER_NOW), time.perf_counter() - t0)
    times: dict[str, float] = {"fill": round(time.perf_counter() - t0, 1)}
    out = {}
    if capture_only:
        rng = np.random.default_rng(22)
        params = from_jax_params("mlp+gbdt", {"mlp": mlp_tree(rng, SERVE_HIDDEN),
                                              "gbdt": forest_tree(rng, SERVE_TREES, SERVE_DEPTH)})
        batches = md_batches(codec, np.random.default_rng(176), 2, SERVER_BATCH_ROWS)
        out["cards"] = fleet_capture_cards(torch, filled[0], params, batches, "cuda")
        if out["cards"] is None:
            raise AssertionError("capture_only needs SMOKE_DISTINCT_CARDS=1 and two cards")
        log("cards " + json.dumps(out["cards"]))
    else:
        for name, run in (
                ("7", lambda: phase_server(torch, card, gbdt_kernel, fa, filled)),
                ("15", lambda: phase_platform(torch, card, gbdt_kernel, fa, dense_mod)),
                ("16", lambda: phase_stores(torch, card, gbdt_kernel, dense_mod, filled[0])),
                ("17", lambda: phase_multi_device(torch, card, gbdt_kernel, fa, dense_mod,
                                                  filled[0]))):
            t = time.perf_counter()
            out[name] = run()
            times[name] = round(time.perf_counter() - t, 1)
    log("wire_phases times " + json.dumps(times))
    log(card)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from igaming_platform_tpu_torch.ops import _build, gbdt_kernel
    from igaming_platform_tpu_torch.ops import dense as dense_mod
    from igaming_platform_tpu_torch.ops import flash_attention as fa

    # Every phase's wall seconds, in order (the phase_times line).
    times: dict[str, float] = {}
    mark = [time.perf_counter()]

    def done(name: str) -> None:
        now = time.perf_counter()
        times[name] = round(now - mark[0], 1)
        mark[0] = now

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
    done("1-2 environment and build")

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
    done("3 kernels")

    # Phase 4: the scoring engine's path; phase 5: the bonus-abuse path.
    engine = phase_engine(torch, card, gbdt_kernel)
    done("4 engine")
    abuse_run = phase_abuse(torch, card, fa)
    done("5 abuse")
    # Phase 6: the abuse detector's training path.
    train_run = phase_train(torch, card, fa)
    done("6 abuse training")
    # Phase 7: the risk.v1 serving front; phase 8: its index path and
    # session state, on the same store.
    from igaming_platform_tpu_torch.serve import native_store

    t0 = time.perf_counter()
    filled = (*fill_native_store(native_store, SERVER_NOW), time.perf_counter() - t0)
    server_run = phase_server(torch, card, gbdt_kernel, fa, filled)
    done("7 server (with the store's fill)")
    # Phase 13: the operations plane, on the same store while the process is
    # young (the profiler's capture is part of it).
    plane_run = phase_plane(torch, card, gbdt_kernel, fa, dense_mod, filled[0])
    done("13 plane")
    # Phase 14: the rest of the plane (host profiler, runtime telemetry, the
    # card probe, reflection, cost counts), same store.
    plane2_run = phase_plane2(torch, card, gbdt_kernel, fa, dense_mod, filled[0])
    done("14 plane2")
    index_run = phase_index(torch, card, gbdt_kernel, fa, filled[0],
                            statistics.median(server_run["score_batch_rows_per_s"]))
    done("8 index")
    # Phase 9: the score step's variants (int8, drift, shadow), same store.
    variants_run = phase_variants(torch, card, gbdt_kernel, fa, filled[0])
    done("9 variants")
    # Phase 10: the decision ledger and replay, same store.
    ledger_run = phase_ledger(torch, card, gbdt_kernel, fa, filled[0])
    done("10 ledger")
    # Phase 11: the trained multitask model booted from FRAUD_MODEL_PATH,
    # the LTV RPCs and the LTV batch job, same store.
    trained_run = phase_trained(torch, card, dense_mod, filled[0], server_run)
    done("11 trained")
    # Phase 12: the multitask trainer, distillation, evaluation, device
    # parity, checkpoints and ONLINE_LOOP=1, same store.
    online_run = phase_online(torch, card, dense_mod, gbdt_kernel, filled[0])
    done("12 online")
    # Phase 15: the wallet side: the single-binary platform against its CPU
    # twin, a SQLite store of 100,000 accounts, and the AMQP transport.
    platform_run = phase_platform(torch, card, gbdt_kernel, fa, dense_mod)
    done("15 platform")
    # Phase 16: the stores of record and the wallet's own front: Postgres over
    # the wire, wallet.v1, the ledger's Postgres sink, LTV over postgres://,
    # the batch refresh of phase 7's store, the Redis store.
    stores_run = phase_stores(torch, card, gbdt_kernel, dense_mod, filled[0])
    done("16 stores")
    # Phase 17: multi-device serving and the fleet over logical meshes of the
    # one card, on phase 7's store.
    md_run = phase_multi_device(torch, card, gbdt_kernel, fa, dense_mod, filled[0])
    done("17 multi-device")
    # Phase 18: multi-device training over logical meshes of the one card,
    # held to phase 6's dense losses.
    tm_run = phase_train_mesh(torch, card, gbdt_kernel, fa, dense_mod, train_run["losses"])
    done("18 multi-device training")

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
        "launches_plane2": plane2_run["forest_launches"],
        "launches_platform": platform_run["launches"]["forest"],
        "launches_stores": stores_run["launches"]["forest"],
        "launches_multi_device": md_run["launches"]["forest"],
        "launches_multi_device_train": tm_run["launches"]["forest"],
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
        "launches_plane2": plane2_run["attention_launches"],
        "launches_platform": platform_run["launches"]["forward"],
        "launches_multi_device": md_run["launches"]["forward"],
        "launches_multi_device_train": tm_run["launches"]["forward"],
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
        "launches_multi_device_train": tm_run["launches"][part],
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
        "launches_plane2": plane2_run["dense_launches"],
        "launches_platform": platform_run["launches"]["dense"],
        "launches_stores": stores_run["launches"]["dense"],
        "launches_multi_device": md_run["launches"]["dense"],
        "launches_multi_device_train": tm_run["launches"]["dense"],
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
        "launches_platform": platform_run["launches"]["dense_f32"],
        "launches_multi_device": md_run["launches"]["dense_f32"],
        "launches_multi_device_train": tm_run["launches"]["dense_f32"],
        "max_abs_err": max(r["max_abs_err"] for r in dense_f32_rows),
        "ms": f32_main["kernel_ms"], "plain_ms": f32_main["plain_ms"],
        "bound_ms": f32_main["bound_ms"], "bound_by": f32_main["bound_by"],
        "library_ms": f32_main["library_ms"],
        "library": "torch.addmm of the same float32 operands (TF32 off)",
        "back_to_back_ms": f32_main["kernel_b2b_ms"],
        "batch_invariance": invariance["stages"],
        "shapes": dense_f32_rows,
    }]}
    done("kernels line")
    times["total"] = round(time.perf_counter() - T_START, 1)
    log("phase_times " + json.dumps(times))
    log(json.dumps(kernels))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
