"""The card's liveness probe, shared by the server boot and any long CLI.

The port's counterpart of ``igaming_platform_tpu/core/devices.py``. A card
whose driver hangs makes the first CUDA call of a process block for good,
so the probe runs in a killable subprocess first: CUDA init, one tiny
launch, a synchronize. It retries with backoff while a hang lasts, inside
``DEVICE_PROBE_BUDGET_S`` (default 360 s), and gives up at once on a
failure that is not a hang (no driver, no visible card, a broken install):
retrying those would only stall the boot.

What differs from the JAX module: the probe never pins this process to the
CPU. It returns the failure's label and records it for child processes
(``BENCH_DEVICE_FALLBACK=<label>``, or ``BENCH_DEVICE_PROBED=1`` when the
card answered), and the caller decides: the server fails its boot with the
label, or serves on the CPU only when ``SERVE_DEVICE_FALLBACK=cpu`` asks for
it (``serve/server.device_gate``). ``reprobe_recovered`` clears a recorded
failure once a throttled quick probe passes.

The persistent compile cache is ``ops/_build.py``'s ``build/torch_kernels/``:
its key already holds the sources, the flags, the ``nvcc`` version and the
card's compute capability, so ``enable_persistent_compile_cache`` only
names it; ``cache_dir_for`` and ``host_fingerprint`` are kept for callers
that key a directory by backend and host.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import time

_PROBE_SNIPPET = (
    "import torch; torch.cuda.init(); x = torch.ones(1, device='cuda') + 1; "
    "torch.cuda.synchronize(); assert int(x.item()) == 2"
)


def _probe_once(timeout_s: float) -> str | None:
    """One subprocess probe: None when the card answered, else a label of
    the failure."""
    try:
        probe = subprocess.run([sys.executable, "-c", _PROBE_SNIPPET], timeout=timeout_s,
                               capture_output=True)
    except subprocess.TimeoutExpired:
        return "cpu (device unresponsive)"
    if probe.returncode == 0:
        return None
    # A fast failure is not a hang: name its cause.
    tail = probe.stderr.decode("utf-8", "replace").strip().splitlines()
    detail = tail[-1][:120] if tail else f"rc={probe.returncode}"
    return f"cpu (device init failed: {detail})"


def ensure_responsive_device(probe_timeout_s: float = 75.0) -> str | None:
    """Probe the card from a killable subprocess, retrying with backoff
    while the budget lasts. Returns None when it answered, else the label
    of the failure (also left in ``BENCH_DEVICE_FALLBACK`` for child
    processes). Never pins this process anywhere."""
    if os.environ.get("BENCH_DEVICE_FALLBACK"):
        # A parent already found the card gone: its label, no new probe.
        return os.environ["BENCH_DEVICE_FALLBACK"]
    if os.environ.get("BENCH_DEVICE_PROBED") == "1":
        return None  # a parent already probed successfully
    budget_s = float(os.environ.get("DEVICE_PROBE_BUDGET_S", 360.0))
    deadline = time.monotonic() + budget_s
    delay_s, attempts = 10.0, 0
    while True:
        attempts += 1
        remaining = deadline - time.monotonic()
        label = _probe_once(min(probe_timeout_s, max(15.0, remaining)))
        if label is None:
            os.environ["BENCH_DEVICE_PROBED"] = "1"
            return None
        if "unresponsive" not in label:
            break  # a deterministic failure: retrying cannot help
        if time.monotonic() + delay_s >= deadline:
            break
        time.sleep(delay_s)
        delay_s = min(delay_s * 2.0, 60.0)
    if attempts > 1:
        label = f"{label[:-1]}; {attempts} probes over {int(budget_s)}s)"
    os.environ["BENCH_DEVICE_FALLBACK"] = label
    return label


_last_reprobe_at: float = 0.0


def reprobe_recovered(probe_timeout_s: float = 20.0, min_interval_s: float = 90.0) -> bool:
    """For a caller that recorded a failure: one quick probe, at most one
    per ``min_interval_s``. When it passes, the recorded failure is cleared
    so later child processes use the card again. True when the card
    answers (or no failure was recorded)."""
    global _last_reprobe_at
    if not os.environ.get("BENCH_DEVICE_FALLBACK"):
        return True
    now = time.monotonic()
    if now - _last_reprobe_at < min_interval_s:
        return False
    _last_reprobe_at = now
    env = dict(os.environ)
    env.pop("BENCH_DEVICE_FALLBACK", None)
    try:
        probe = subprocess.run([sys.executable, "-c", _PROBE_SNIPPET], timeout=probe_timeout_s,
                               capture_output=True, env=env)
    except subprocess.TimeoutExpired:
        return False
    if probe.returncode != 0:
        return False
    del os.environ["BENCH_DEVICE_FALLBACK"]
    os.environ["BENCH_DEVICE_PROBED"] = "1"
    return True


def host_fingerprint(cpuinfo_path: str = "/proc/cpuinfo") -> str:
    """Short digest of the host ISA and CPU feature flags."""
    import platform as _platform

    bits = [_platform.machine()]
    try:
        with open(cpuinfo_path, encoding="utf-8", errors="replace") as f:
            for line in f:
                if line.lower().startswith(("flags", "features")):
                    bits.append(" ".join(sorted(line.split(":", 1)[1].split())))
                    break
    except OSError:
        bits.append(_platform.processor() or "unknown-cpu")
    return hashlib.sha256("|".join(bits).encode()).hexdigest()[:12]


def cache_dir_for(backend: str, base_dir: str) -> str:
    """A directory keyed by ``<backend>-<host fingerprint>``."""
    return os.path.join(base_dir, f"{backend}-{host_fingerprint()}")


def enable_persistent_compile_cache() -> str | None:
    """The port's one compile cache, ``ops/_build.BUILD_DIR``, where every
    kernel library is kept across restarts under a key of its sources,
    flags, ``nvcc`` version and compute capability; None without a card
    (nothing is compiled for the CPU)."""
    import torch

    if not torch.cuda.is_available():
        return None
    from igaming_platform_tpu_torch.ops import _build

    return str(_build.BUILD_DIR)
