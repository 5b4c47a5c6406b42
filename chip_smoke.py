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
``check_batch`` and ``check``. Phases:

1. environment: a card must be present; prints its name and power limit
   (``nvidia-smi``) and turns TF32 off for matmuls and convolutions;
2. build: compiles every kernel with ``nvcc``, all at once, and reports the
   time;
3. kernels: each kernel against its plain version at the shapes its paths
   give it, with CUDA-event timings (median of 50 launches) and, for the
   attention kernel, ``scaled_dot_product_attention`` on the same inputs
   as a yardstick;
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
   at S = 256, 2048 and 8192.

Any failure exits non-zero. The second-to-last lines are the ``kernels``
JSON object and the card's name and power limit; the last line is the
result object. With no card, or outside the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
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
# The abuse path: the detector's serving width and BASELINE config 3's.
ABUSE_CFG = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128)
CONFIG3_CFG = dict(d_model=128, n_heads=2, n_layers=2, d_ff=256)
CONFIG3_POINTS = ((64, 256), (8, 2048), (2, 8192))  # (batch, S)
ABUSE_ACCOUNTS, ABUSE_MAX_EVENTS = 2_000, 64
ABUSE_BATCH, ABUSE_CHECKS, ABUSE_LATENCY = 256, 200, 1000
ABUSE_ATOL = 1e-4  # card against CPU detector: float32 through two layers, sums reordered
STREAM_T0 = 1_700_000_000.0
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


def device_ms(torch, fn, reps: int = REPS, warmup: int = 5) -> float:
    """Median device time of one call of ``fn``, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
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
    report = _build.build(["gbdt_forest", "flash_attention_fwd"])
    log(f"phase 2: built in {time.perf_counter() - t0:.1f} s")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"phase 2: {name}: {line.strip()}")

    # Phase 3: each kernel against its plain version.
    rows = phase_kernels(torch, gbdt_kernel)
    flash_rows = phase_flash(torch, fa)

    # Phase 4: the scoring engine's path; phase 5: the bonus-abuse path.
    engine = phase_engine(torch, card, gbdt_kernel)
    abuse_run = phase_abuse(torch, card, fa)

    main_row = next(r for r in rows if (r["T"], r["D"], r["B"]) == (64, 4, BATCH_SIZE))
    flash_main = next(r for r in flash_rows if (r["BH"], r["S"], r["Dh"]) == FLASH_MAIN_SHAPE)
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
    }]}
    log(json.dumps(kernels))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
