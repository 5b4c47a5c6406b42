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
3. kernels: each kernel against its plain version at the shapes its paths
   give it, with CUDA-event timings (median of 50 launches) and, for the
   attention kernels, ``scaled_dot_product_attention`` (its forward, and
   its backward through ``torch.autograd.grad``) on the same inputs as a
   yardstick;
4. engine: a feature store of 10,000 accounts, 20 single requests and one
   batch of 4096, the launch counts of that run, and the CPU comparison;
   then the device time of one step, where a batch's host time goes, and
   the latency of 1000 sequential ``score()`` calls;
5. abuse: a seeded wallet event stream of 2,000 accounts drained through
   the bridge into the card's detector, ``check_batch`` over every account
   and ``check`` on a sample, the attention kernel's launch count of that
   run, and the same stream through a CPU bridge and detector; then
   ``check()`` latency, ``check_batch(256)`` throughput and the device time
   of one forward at BASELINE config 3's width (d_model 128, 2 heads of 64)
   at S = 256, 2048 and 8192;
6. training: one seeded model trained 5 steps on the card and on the CPU
   from the same batches (per-step losses and every step-1 gradient
   compared, every gradient on the card nonzero); then the full 200-step
   ``train_abuse_detector`` on the card, the launch counts of that run
   (dQ and dK/dV kernels = layers x steps, forward kernel = layers x
   (steps + 1 eval forward)), its held-out accuracy, the trained model
   served by a card ``SequenceAbuseDetector``, where a step's time goes
   (host batch synthesis, device step, kernels by name), and one training
   step at config-3 width at S=2048.

Any failure exits non-zero. The second-to-last lines are the ``kernels``
JSON object and the card's name and power limit; the last line is the
result object. With no card, or outside the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# rate outside the tensor cores. Used for the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

KERNEL_SHAPES_B = (1, 255, 256, 2048, 4096)
KERNEL_FORESTS = ((64, 4), (16, 3))
N_FEATURES = 30
SERVE_TREES, SERVE_DEPTH, SERVE_HIDDEN = 64, 4, (128, 128)
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
# S=256, 8 x 2 at 2048, 2 x 2 at 8192, the TPU's tiled range) and a ragged S.
FLASH_SHAPES = ((2, 64, 32), (512, 64, 32), (128, 256, 64), (16, 2048, 64),
                (4, 8192, 64), (4, 300, 32))
FLASH_MAIN_SHAPE = (512, 64, 32)  # check_batch of 256 accounts
FLASH_TOL = 2e-5  # rtol and atol of O and LSE: the JAX tests' bar, float32 sums reordered
# Backward shapes (B*H, S, Dh): a training step (batch 64 x 2 heads), one
# check's width, config-3 width at S=2048 and at 8192 (past the TPU kernels'
# range), a ragged S, and the session head's Dh 8.
FLASH_BWD_SHAPES = ((128, 64, 32), (2, 64, 32), (16, 2048, 64), (4, 8192, 64),
                    (4, 300, 32), (8, 16, 8))
FLASH_BWD_MAIN_SHAPE = (128, 64, 32)
GRAD_TOL = 2e-4  # rtol and atol of gradients: the JAX tests' bar, float32 sums reordered
# The abuse path: the detector's serving width and BASELINE config 3's.
ABUSE_CFG = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128)
CONFIG3_CFG = dict(d_model=128, n_heads=2, n_layers=2, d_ff=256)
CONFIG3_POINTS = ((64, 256), (8, 2048), (2, 8192))  # (batch, S)
ABUSE_ACCOUNTS, ABUSE_MAX_EVENTS = 2_000, 64
ABUSE_BATCH, ABUSE_CHECKS, ABUSE_LATENCY = 256, 200, 1000
ABUSE_ATOL = 1e-4  # card against CPU detector: float32 through two layers, sums reordered
STREAM_T0 = 1_700_000_000.0
# Training: steps compared between the card and the CPU, their loss bar
# (float32 through two layers and Adam, sums reordered), the least held-out
# accuracy of the full run, and config-3 width's training point.
PARITY_STEPS, LOSS_RTOL, MIN_ACCURACY = 5, 1e-4, 0.95
CONFIG3_TRAIN_POINT = (8, 2048)  # (batch, S)
# Spin cycles queued before each timed call, so the card is still busy
# while the host enqueues the call: the events then bracket device work only.
SLEEP_CYCLES = 4_000_000


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


def forest_tree(rng, n_trees: int, depth: int) -> dict:
    """A random oblivious forest in the JAX package's params layout."""
    return {
        "feat": rng.integers(0, N_FEATURES, (n_trees, depth)).astype(np.int32),
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


def phase_kernels(torch, gbdt_kernel) -> list[dict]:
    from igaming_platform_tpu_torch.convert import gbdt_from_tree

    rng = np.random.default_rng(0)
    rows = []
    for n_trees, depth in KERNEL_FORESTS:
        tree = forest_tree(rng, n_trees, depth)
        f = {k: v.cuda() for k, v in gbdt_from_tree(tree).items()}
        for b in KERNEL_SHAPES_B:
            x_np = rng.random((b, N_FEATURES)).astype(np.float32)
            # Ties: a feature equal to its split threshold must go left.
            k = rng.integers(0, n_trees * depth, b)
            x_np[np.arange(b), tree["feat"].reshape(-1)[k]] = tree["thr"].reshape(-1)[k]
            x = torch.from_numpy(x_np).cuda()
            args = (x, f["feat"], f["thr"], f["leaves"], f["bias"])
            got = gbdt_kernel.gbdt_forest(*args)
            want = gbdt_kernel.gbdt_forest_plain(*args)
            torch.cuda.synchronize()
            if got.shape != (b,) or not torch.isfinite(got).all():
                raise AssertionError(f"gbdt_forest T={n_trees} D={depth} B={b}: bad output")
            err = float((got - want).abs().max())
            if err > KERNEL_ATOL:
                raise AssertionError(
                    f"gbdt_forest T={n_trees} D={depth} B={b}: max error {err} > {KERNEL_ATOL}")
            bound, bound_by = forest_bound(b, n_trees, depth)
            row = {"T": n_trees, "D": depth, "B": b, "max_abs_err": err,
                   "kernel_ms": device_ms(torch, lambda: gbdt_kernel.gbdt_forest(*args)),
                   "plain_ms": device_ms(torch, lambda: gbdt_kernel.gbdt_forest_plain(*args)),
                   "bound_ms": bound, "bound_by": bound_by}
            rows.append(row)
            log(f"phase 3: gbdt_forest T={n_trees} D={depth} B={b}: max_abs_err={err:.3g} "
                f"kernel_ms={row['kernel_ms']:.6f} plain_ms={row['plain_ms']:.6f} "
                f"bound_ms={bound:.6f} ({bound_by})")
    return rows


def flash_bound(bh: int, s: int, dh: int) -> tuple[float, str]:
    """Least time for one forward on this card: 4*BH*S^2*Dh float32 flops on
    the CUDA cores, or q, k, v read and o, lse written once."""
    ops_ms = 4.0 * bh * s * s * dh / FP32_OPS_PER_S * 1e3
    bytes_ms = (4 * bh * s * dh * 4 + bh * s * 4) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_flash(torch, fa) -> list[dict]:
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for bh, s, dh in FLASH_SHAPES:
        q, k, v = (torch.randn((bh, s, dh), generator=gen, device="cuda") for _ in range(3))
        o, lse = fa.flash_attention_fwd(q, k, v)
        want_o, want_lse = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        name = f"flash_attention_fwd BH={bh} S={s} Dh={dh}"
        if o.shape != (bh, s, dh) or lse.shape != (bh, s, 1):
            raise AssertionError(f"{name}: shapes {tuple(o.shape)}, {tuple(lse.shape)}")
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"{name}: non-finite output")
        for what, got, want in (("O", o, want_o), ("LSE", lse, want_lse)):
            if not torch.allclose(got, want, rtol=FLASH_TOL, atol=FLASH_TOL):
                raise AssertionError(f"{name}: {what} max error "
                                     f"{float((got - want).abs().max())} beyond {FLASH_TOL}")
        err_o = float((o - want_o).abs().max())
        err_lse = float((lse - want_lse).abs().max())
        err = max(err_o, err_lse)
        del want_o, want_lse
        bound, bound_by = flash_bound(bh, s, dh)
        reps = REPS if s <= 2048 else 10
        row = {"BH": bh, "S": s, "Dh": dh, "max_abs_err": err,
               "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
               "kernel_ms": device_ms(torch, lambda: fa.flash_attention_fwd(q, k, v), reps),
               "plain_ms": device_ms(torch, lambda: fa.flash_attention_plain(q, k, v), reps),
               "library_ms": device_ms(torch, lambda: sdpa(q, k, v), reps),
               "bound_ms": bound, "bound_by": bound_by}
        rows.append(row)
        log(f"phase 3: {name}: max_abs_err O={err_o:.3g} LSE={err_lse:.3g} kernel_ms={row['kernel_ms']:.6f} "
            f"plain_ms={row['plain_ms']:.6f} sdpa_ms={row['library_ms']:.6f} "
            f"bound_ms={bound:.6f} ({bound_by})")
    return rows


def flash_bwd_bounds(bh: int, s: int, dh: int) -> dict:
    """Least time for each backward kernel on this card: 6 (dQ) and 8 (dK/dV)
    x BH*S^2*Dh float32 flops on the CUDA cores, or each input read and each
    output written once (q, k, v, dO, LSE and D in; dQ, or dK and dV, out)."""
    row, vec = bh * s * dh * 4, bh * s * 4
    out = {}
    for part, flops, n_out in (("dq", 6, 1), ("dkv", 8, 2)):
        ops_ms = flops * bh * s * s * dh / FP32_OPS_PER_S * 1e3
        bytes_ms = ((4 + n_out) * row + 2 * vec) / HBM_BYTES_PER_S * 1e3
        out[part] = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    return out


def phase_flash_bwd(torch, fa) -> list[dict]:
    """Both backward kernels against the plain backward, each timed alone
    through its C entry point on the wrapper's inputs; the pair through
    ``flash_attention_bwd`` (D included); the plain backward; and the
    backward of ``scaled_dot_product_attention`` (``torch.autograd.grad``
    with dO) as the library's yardstick for the pair."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = fa._lib("flash_attention_bwd")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for bh, s, dh in FLASH_BWD_SHAPES:
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
        del got, want

        dmat = (do * o).sum(dim=-1)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        stream = torch.cuda.current_stream().cuda_stream
        scale = 1.0 / math.sqrt(dh)
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
               dmat.data_ptr())

        def dq_only():
            if lib.flash_attention_bwd_dq_launch(*ins, dq.data_ptr(), bh, s, dh, scale, stream):
                raise RuntimeError(f"{name}: dQ launch failed")

        def dkv_only():
            if lib.flash_attention_bwd_dkv_launch(*ins, dk.data_ptr(), dv.data_ptr(), bh, s, dh,
                                                  scale, stream):
                raise RuntimeError(f"{name}: dK/dV launch failed")

        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = sdpa(*leaves)
        reps = REPS if s <= 2048 else 10
        bounds = flash_bwd_bounds(bh, s, dh)
        row = {"BH": bh, "S": s, "Dh": dh,
               "max_abs_err_dq": errs["dq"], "max_abs_err_dk": errs["dk"],
               "max_abs_err_dv": errs["dv"], "max_abs_err_dkv": max(errs["dk"], errs["dv"]),
               "dq_ms": device_ms(torch, dq_only, reps),
               "dkv_ms": device_ms(torch, dkv_only, reps),
               "pair_ms": device_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
                                    reps),
               "plain_ms": device_ms(
                   torch, lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do), reps),
               "library_ms": device_ms(
                   torch, lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), reps),
               "dq_bound_ms": bounds["dq"][0], "dq_bound_by": bounds["dq"][1],
               "dkv_bound_ms": bounds["dkv"][0], "dkv_bound_by": bounds["dkv"][1]}
        del out, leaves
        rows.append(row)
        log(f"phase 3: {name}: max_abs_err dQ={errs['dq']:.3g} dK={errs['dk']:.3g} "
            f"dV={errs['dv']:.3g} dq_ms={row['dq_ms']:.6f} (bound {bounds['dq'][0]:.6f}, "
            f"{bounds['dq'][1]}) dkv_ms={row['dkv_ms']:.6f} (bound {bounds['dkv'][0]:.6f}, "
            f"{bounds['dkv'][1]}) pair_ms={row['pair_ms']:.6f} plain_ms={row['plain_ms']:.6f} "
            f"sdpa_bwd_ms={row['library_ms']:.6f}")
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
    if not (np.isfinite(got["ml_score"]).all() and (got["ml_score"] >= 0).all()
            and (got["ml_score"] <= 1).all() and (got["score"] >= 0).all()
            and (got["score"] <= 100).all()):
        raise AssertionError("engine: scores out of range")
    for key in ("rule_score", "reason_mask"):
        if not np.array_equal(got[key], want[key]):
            raise AssertionError(f"engine: {key} differs from the CPU engine")
    ml_err = float(np.abs(got["ml_score"] - want["ml_score"]).max())
    if ml_err > ML_ATOL:
        raise AssertionError(f"engine: ml_score differs from the CPU engine by {ml_err}")
    pre = 0.4 * want["rule_score"] + 60.0 * want["ml_score"].astype(np.float64) + 1e-4
    same_ml = got["ml_score"].view(np.int32) == want["ml_score"].view(np.int32)
    checked = (np.abs(pre - np.round(pre)) > 1e-4) | same_ml
    for key in ("score", "action"):
        if not np.array_equal(got[key][checked], want[key][checked]):
            raise AssertionError(f"engine: {key} differs from the CPU engine")
    return int((~checked).sum())


def phase_engine(torch, card: str, gbdt_kernel) -> dict:
    from igaming_platform_tpu_torch.convert import from_jax_params
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
        steps0 = gpu.device_steps
        single_out = [gpu.score(req) for req in singles]
        t = time.perf_counter()
        batch_out = gpu.score_batch(batch)
        batch_s = [time.perf_counter() - t]
        launches = gbdt_kernel.gbdt_forest.launches
        steps = gpu.device_steps - steps0

        if launches == 0 or launches != steps:
            raise AssertionError(
                f"engine: {steps} device steps but {launches} forest kernel launches")
        boundary = (compare_with_cpu(single_out, singles, store, cpu)
                    + compare_with_cpu(batch_out, batch, store, cpu))
        # Device time of one full-batch score step, inputs already on the card.
        x_step, bl_step = (torch.from_numpy(a).cuda() for a in store.gather_batch(batch))

        def step():
            with torch.inference_mode():
                gpu._score_fn(gpu.get_params(), x_step, bl_step, gpu._thresholds)

        step_ms = device_ms(torch, step, reps=20)

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
    result = {
        "launches": launches, "device_steps": steps, "floor_boundary_rows": boundary,
        "batch_rows_per_s": [BATCH_SIZE / s for s in batch_s],
        "single_n": N_LATENCY,
        "single_p50_ms": float(np.percentile(single_ms, 50)),
        "single_p99_ms": float(np.percentile(single_ms, 99)),
        "step_4096_device_ms": step_ms,
        "batch_4096_host_ms": {"gather": t_gather * 1e3, "step_and_copies": t_step * 1e3,
                               "responses": t_rows * 1e3},
    }
    log(f"phase 4: [{card}] score_batch({BATCH_SIZE}) x5: median "
        f"{statistics.median(result['batch_rows_per_s']):.0f} rows/s; "
        f"score() x{N_LATENCY} sequential: p50 {result['single_p50_ms']:.3f} ms, "
        f"p99 {result['single_p99_ms']:.3f} ms; device time of one {BATCH_SIZE}-row step "
        f"{step_ms:.6f} ms")
    log(f"phase 4: {steps} device steps, {launches} forest kernel launches; agrees with the "
        f"CPU engine ({boundary} floor-boundary rows not compared)")
    log("phase 4: " + json.dumps(result))
    return result


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
    """Wallet events of 2,000 accounts, oldest first: about one in six runs
    the abuse shape (deposit, bonus grant, rapid wagers, quick withdrawal)
    on a few shared devices, some of them blacklisted; the others deposit,
    bet and win at a human pace on their own devices. Some non-money events
    and ten redelivered duplicates. Ends just before STREAM_T0."""
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


def phase_abuse(torch, card: str, fa) -> dict:
    from igaming_platform_tpu_torch.convert import sequence_from_tree
    from igaming_platform_tpu_torch.models.sequence import SeqConfig
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
        steps0 = det.device_steps
        t = time.perf_counter()
        drained = gpu.drain()
        drain_s = time.perf_counter() - t
        scores = np.concatenate([det.check_batch(accounts[i:i + ABUSE_BATCH])
                                 for i in range(0, ABUSE_ACCOUNTS, ABUSE_BATCH)])
        checks = [det.check(a) for a in sample]
        launches = fa.flash_attention_fwd.launches
        steps = det.device_steps - steps0
        if launches == 0 or launches != cfg.n_layers * steps:
            raise AssertionError(f"abuse: {steps} forward passes of {cfg.n_layers} layers "
                                 f"but {launches} attention kernel launches")

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
            f"events; {steps} forward passes, {launches} attention kernel launches; scores "
            f"agree with the CPU to {score_err:.3g} ({near} near-threshold checks)")

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
    t = time.perf_counter()
    model, metrics = at.train_abuse_detector(tcfg, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    launches = {"fwd": fa.flash_attention_fwd.launches, "dq": fa.flash_attention_bwd.launches_dq,
                "dkv": fa.flash_attention_bwd.launches_dkv}
    per_step = cfg.n_layers * tcfg.steps
    if (launches["dq"], launches["dkv"], launches["fwd"]) != (
            per_step, per_step, per_step + cfg.n_layers):
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
        "launches_dkv": launches["dkv"], "steps": tcfg.steps,
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from igaming_platform_tpu_torch.ops import _build, gbdt_kernel
    from igaming_platform_tpu_torch.ops import flash_attention as fa

    # Phase 1: environment.
    card = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase 1: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # Phase 2: build every kernel, one nvcc each, started together.
    t0 = time.perf_counter()
    report = _build.build(["gbdt_forest", "flash_attention_fwd", "flash_attention_bwd"])
    log(f"phase 2: built in {time.perf_counter() - t0:.1f} s")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"phase 2: {name}: {line.strip()}")

    # Phase 3: each kernel against its plain version.
    rows = phase_kernels(torch, gbdt_kernel)
    flash_rows = phase_flash(torch, fa)
    bwd_rows = phase_flash_bwd(torch, fa)

    # Phase 4: the scoring engine's path; phase 5: the bonus-abuse path.
    engine = phase_engine(torch, card, gbdt_kernel)
    abuse_run = phase_abuse(torch, card, fa)
    # Phase 6: the abuse detector's training path.
    train_run = phase_train(torch, card, fa)

    main_row = next(r for r in rows if (r["T"], r["D"], r["B"]) == (64, 4, BATCH_SIZE))
    flash_main = next(r for r in flash_rows if (r["BH"], r["S"], r["Dh"]) == FLASH_MAIN_SHAPE)
    bwd_main = next(r for r in bwd_rows if (r["BH"], r["S"], r["Dh"]) == FLASH_BWD_MAIN_SHAPE)
    kernels = {"kernels": [{
        "name": "gbdt_forest", "route": "cuda",
        "source": "igaming_platform_tpu_torch/csrc/gbdt_forest.cu",
        "replaces": "igaming_platform_tpu/ops/pallas/gbdt_kernel.py:52",
        "launches": engine["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None,
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
    } for part, line in (("dq", 251), ("dkv", 261)))]}
    log(json.dumps(kernels))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
