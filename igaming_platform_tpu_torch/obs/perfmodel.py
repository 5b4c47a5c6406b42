"""Device peaks, utilization and the online step-time model.

The port's counterpart of ``igaming_platform_tpu/obs/perfmodel.py``, the
part that needs no XLA:

- ``peak_for`` matches ``torch.cuda.get_device_name()`` (or any device name)
  against a small table of published peaks; an unknown name (the CPU)
  reports achieved rates with null utilization instead of inventing a
  denominator;
- ``utilization`` turns a per-call cost ({"flops", "bytes"}) and a time
  into achieved rates and their share of the peaks;
- ``OnlineStepModel`` is the deadline scheduler's per-shape step-time model
  (serve/deadline.py, serve/batcher.py), a copy of the JAX one;
- ``device_step_time`` times one call's device work with CUDA events.

The JAX module's ``compiled_cost``/``cost_of`` read XLA's cost analysis of a
compiled program; nothing like it sees a hand kernel launched through
ctypes, so they have no counterpart here (``ROADMAP.md``).
"""

from __future__ import annotations

import threading
from typing import Any

# Published per-card peaks: (dense bf16 tensor-core FLOP/s, memory bytes/s),
# from NVIDIA's data sheets, dense rates without sparsity, at the full power
# limit. Matched by substring of the lowercased device name, first match
# wins, so the more specific names come first.
_PEAKS: dict[str, tuple[float, float]] = {
    # H100 data sheet: SXM 989 TFLOP/s bf16, 3.35 TB/s HBM3 (80 GB).
    "h100 80gb hbm3": (989e12, 3.35e12),
    "h100 sxm": (989e12, 3.35e12),
    # H100 data sheet: NVL 835 TFLOP/s bf16, 3.9 TB/s HBM3 (94 GB).
    "h100 nvl": (835e12, 3.9e12),
    # H100 data sheet: PCIe 756 TFLOP/s bf16, 2.0 TB/s HBM2e (80 GB).
    "h100 pcie": (756e12, 2.0e12),
    # A100 data sheet: 312 TFLOP/s bf16; 80 GB SXM 2.039 TB/s.
    "a100-sxm4-80gb": (312e12, 2.039e12),
    "a100": (312e12, 1.555e12),
}


def _device_name(device: Any) -> str:
    if isinstance(device, str) and device not in ("cuda", "cpu") and ":" not in device:
        return device
    import torch

    dev = torch.device(device) if not isinstance(device, torch.device) else device
    if dev.type != "cuda" or not torch.cuda.is_available():
        return dev.type
    return torch.cuda.get_device_name(dev)


def peak_for(device: Any) -> tuple[float, float] | None:
    """(peak bf16 FLOP/s, peak memory B/s) for a device name, a
    ``torch.device`` or ``"cuda"``/``"cuda:N"``; None for an unknown one."""
    name = _device_name(device).lower()
    for key, peaks in _PEAKS.items():
        if key in name:
            return peaks
    return None


def utilization(
    cost: dict[str, float], seconds_per_call: float, device: Any
) -> dict[str, float | None]:
    """Achieved rates + utilization vs the device's published peaks.

    Returns achieved_tflops / achieved_hbm_gbps always (when the cost has
    the numerator), and mfu / hbm_util only when the device has a known
    peak: a CPU line carries nulls rather than a made-up denominator.
    """
    out: dict[str, float | None] = {
        "achieved_tflops": None, "achieved_hbm_gbps": None,
        "mfu": None, "hbm_util": None,
    }
    if not seconds_per_call > 0.0:  # also catches NaN (below-resolution)
        return out
    flops_s = cost.get("flops", 0.0) / seconds_per_call
    bytes_s = cost.get("bytes", 0.0) / seconds_per_call
    if flops_s > 0:
        out["achieved_tflops"] = round(flops_s / 1e12, 4)
    if bytes_s > 0:
        out["achieved_hbm_gbps"] = round(bytes_s / 1e9, 2)
    peaks = peak_for(device)
    if peaks is not None:
        peak_flops, peak_hbm = peaks
        if flops_s > 0:
            out["mfu"] = round(flops_s / peak_flops, 4)
        if bytes_s > 0:
            out["hbm_util"] = round(bytes_s / peak_hbm, 4)
    return out


class OnlineStepModel:
    """Online per-shape step-time model for the deadline scheduler.

    An EWMA of *observed* dispatch→collect wall times keyed by padded
    batch shape (rows). The deadline scheduler plans each tick against
    it: "can a 4096-row step still land inside the tightest admitted
    deadline, or should this tick flush a 256 tier now?" — and the
    batcher's hedged re-dispatch uses the same prediction as its stall
    threshold. The engine seeds it from its warm-up's timed steps; live
    observations then take over.

    Predictions for never-observed shapes extrapolate from the nearest
    observed shape by row ratio (step cost here is dominated by
    per-row work + a constant launch overhead; linear-in-rows is the
    conservative upper bound for smaller shapes). Thread-safe; O(1)
    per observation.
    """

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self._lock = threading.Lock()
        self._ewma_ms: dict[int, float] = {}
        self._ewvar_ms: dict[int, float] = {}
        self.observations = 0

    def observe(self, shape_rows: int, ms: float) -> None:
        if not (ms >= 0.0):  # rejects NaN and negatives
            return
        shape = int(shape_rows)
        with self._lock:
            self.observations += 1
            prev = self._ewma_ms.get(shape)
            if prev is None:
                self._ewma_ms[shape] = float(ms)
                self._ewvar_ms[shape] = 0.0
            else:
                delta = float(ms) - prev
                self._ewma_ms[shape] = prev + self.alpha * delta
                self._ewvar_ms[shape] = (
                    (1 - self.alpha) * (self._ewvar_ms[shape]
                                        + self.alpha * delta * delta))

    def predict_ms(self, shape_rows: int) -> float | None:
        """Expected step wall (ms) at ``shape_rows``, or None before
        any evidence exists (callers fall back to fixed-knob policy)."""
        shape = int(shape_rows)
        with self._lock:
            if not self._ewma_ms:
                return None
            hit = self._ewma_ms.get(shape)
            if hit is not None:
                return hit
            # Nearest observed shape, scaled by row ratio only when
            # extrapolating UP (more rows can't be faster); a smaller
            # shape is bounded above by the nearest larger observation.
            known = sorted(self._ewma_ms)
            larger = [s for s in known if s >= shape]
            if larger:
                return self._ewma_ms[larger[0]]
            nearest = known[-1]
            return self._ewma_ms[nearest] * (shape / nearest)

    def stall_threshold_ms(self, shape_rows: int, mult: float = 4.0,
                           min_slack_ms: float = 5.0) -> float | None:
        """The hedge trip-wire: a batch still uncollected past this is
        a stalled pipeline window. Predicted step time times ``mult``,
        never tighter than predicted + ``min_slack_ms`` + 3 sigma —
        noise must not hedge the median batch."""
        with self._lock:
            mean = self._ewma_ms.get(int(shape_rows))
            var = self._ewvar_ms.get(int(shape_rows), 0.0)
        if mean is None:
            mean = self.predict_ms(shape_rows)
            if mean is None:
                return None
        sigma = var ** 0.5
        return max(mean * mult, mean + min_slack_ms + 3.0 * sigma)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "observations": self.observations,
                "ewma_ms": {str(k): round(v, 4)
                            for k, v in sorted(self._ewma_ms.items())},
            }


def device_step_time(fn, *args, n: int = 17, reps: int = 3, stream=None) -> float:
    """Per-call device time (seconds) of ``fn(*args)`` on a card.

    One call warms up; then ``n`` calls are enqueued back to back between
    two CUDA events on ``stream`` (the current stream by default), ``reps``
    times, and the least elapsed time over ``n`` is returned. The events
    bracket the device work alone: host enqueue time counts only where it
    leaves the device idle (a slow host shows as a longer step, as it
    would in serving)."""
    import torch

    stream = stream or torch.cuda.current_stream()
    with torch.cuda.stream(stream):
        fn(*args)
        best = float("inf")
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(n):
                fn(*args)
            end.record(stream)
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1000.0 / n)
    return best
