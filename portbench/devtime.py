"""The device trace of a measured window: ``torch.profiler`` reduced to numbers.

``Window`` wraps the measured window in a profiler (host and CUDA activity)
and a marker span. ``summary()`` then gives, from the profiler's own events:

- ``window_s``: the marker's length, the traced window;
- ``busy_s``: the union of the device's operations (kernels, copies, sets)
  inside it;
- ``kernels``: device seconds and counts by operation name;
- ``breakdown``: the ten operations that took most device time, and the ten
  largest sums of idle gaps, each gap named by the innermost host event in
  flight at its middle ("thread_<tid>: <name>"), or "unattributed".

Nothing here reads the program; a window that caught no device operation
raises, since every cell drives the card.
"""

from __future__ import annotations

import bisect
import heapq
from collections import defaultdict

MARKER = "portbench.window"
_TOP = 10


class Window:
    """``with Window(enabled) as w: ...``; then ``w.summary()``. Disabled, it
    records nothing and ``summary()`` returns None."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self._mark = None

    def __enter__(self):
        if self.enabled:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts, record_shapes=False,
                                                with_stack=False, profile_memory=False)
            self._prof.__enter__()
            self._mark = torch.profiler.record_function(MARKER)
            self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            import torch

            torch.cuda.synchronize()
            self._mark.__exit__(*exc)
            self._prof.__exit__(*exc)
        return False

    def summary(self) -> dict | None:
        if not self.enabled:
            return None
        return reduce_events(_events(self._prof))


def _events(prof) -> list[tuple[str, bool, int, int, int]]:
    """(name, on_device, start_ns, end_ns, thread) of every profiler event.
    A span's annotation on the device track (the marker's, the program's
    ``record_function`` names) is no device operation and is left out."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        if dev and (e.name() == MARKER or e.is_user_annotation()):
            continue
        start = int(e.start_ns())
        out.append((e.name(), dev, start, start + int(e.duration_ns()),
                    int(e.start_thread_id()) if not dev else 0))
    return out


def reduce_events(events) -> dict:
    """The window's numbers from (name, on_device, start_ns, end_ns, thread)
    events; see the module docstring."""
    marks = [(s, e) for name, dev, s, e, _ in events if not dev and name == MARKER]
    if not marks:
        raise RuntimeError("the trace holds no window marker")
    w0, w1 = marks[0]
    dev = sorted((s, e, name) for name, on_dev, s, e, _ in events
                 if on_dev and e > w0 and s < w1)
    if not dev:
        raise RuntimeError("the trace holds no device operation inside the window: "
                           "CUPTI recorded nothing")
    kernels: dict[str, list] = defaultdict(lambda: [0.0, 0])
    busy_ns, gaps = 0, []
    cur_s, cur_e = None, None
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        kernels[name][0] += (e - s) / 1e9
        kernels[name][1] += 1
        if cur_e is None:
            gaps.append((w0, s))
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy_ns += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_ns += cur_e - cur_s
    gaps.append((cur_e, w1))
    host = sorted((s, e, f"thread_{t}: {name}") for name, on_dev, s, e, t in events
                  if not on_dev and name != MARKER and e > w0 and s < w1)
    idle = _name_gaps([g for g in gaps if g[1] > g[0]], host)
    ops = sorted(((n, v[0]) for n, v in kernels.items()), key=lambda kv: -kv[1])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "kernels": {n: {"seconds": v[0], "count": v[1]} for n, v in kernels.items()},
        "breakdown": {"device_ops": [[n, s] for n, s in ops[:_TOP]],
                      "idle_gaps": [[n, s] for n, s in idle[:_TOP]]},
    }


def _name_gaps(gaps, host) -> list[tuple[str, float]]:
    """Sum idle seconds by the innermost host event in flight at each gap's
    middle; largest first."""
    starts = [h[0] for h in host]
    sums: dict[str, float] = defaultdict(float)
    active: list = []  # heap of (end, -start, name)
    i = 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) // 2
        j = bisect.bisect_right(starts, mid)
        while i < j:
            s, e, name = host[i]
            heapq.heappush(active, (e, -s, name))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        label = max(active, key=lambda a: -a[1])[2] if active else "unattributed"
        sums[label] += (g1 - g0) / 1e9
    return sorted(sums.items(), key=lambda kv: -kv[1])


def kernel_seconds(summary: dict, *fragments: str) -> tuple[float, int]:
    """Device seconds and launches of every operation whose name holds one
    of ``fragments``."""
    secs, count = 0.0, 0
    for name, v in summary["kernels"].items():
        if any(f in name for f in fragments):
            secs += v["seconds"]
            count += v["count"]
    return secs, count
