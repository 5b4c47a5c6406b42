"""Deadline-aware admission & scheduling — the batching policy layer.

The port's copy of ``igaming_platform_tpu/serve/deadline.py`` (pure Python, kept apart so
the port imports nothing of the JAX package).

Queue wait, not device compute, is the whole gap to the 50 ms p99 north
star in the JAX service's stage attribution (`score.queue` dominates
violating requests). Following "Scaling TensorFlow to 300 million predictions per
second" — batching *policy* buys tail latency at scale — this module
turns the fixed-knob continuous batcher into a deadline scheduler:

- **Per-request deadlines**: parsed from the ``risk-deadline-ms`` gRPC
  metadata, falling back to the gRPC context deadline, falling back to
  ``DEADLINE_DEFAULT_MS`` (itself defaulting to ``SLO_OBJECTIVE_MS``).
  A request whose budget is already spent is rejected at admission with
  ``DEADLINE_EXCEEDED`` + the standard retry-pushback hint — scoring a
  row its caller will never receive only steals capacity. Sheds, not
  errors: they do not burn SLO budget (obs/slo.py).
- **Priority lanes** with earliest-deadline-first order inside each
  lane: interactive ``ScoreTransaction`` > bulk ``ScoreBatch`` >
  LTV/background jobs. Strict no-starvation aging: a lower lane whose
  head has waited past its aging budget outranks higher lanes for one
  pop, so bulk progresses even under a sustained interactive flood.
- **Dynamic batch shape + flush window** per tick: the scheduler plans
  each batch against the tightest admitted deadline using the online
  step-time model (obs/perfmodel.OnlineStepModel) — a near-due queue
  flushes a small tier now instead of waiting out a fixed window to
  fill the throughput shape.
- **Closed loop on the SLO plane**: :class:`BurnShedGate` subscribes to
  the SLOEngine's (obs/slo.py) fast-window burn alert; while the fast window is
  burning, bulk lanes shed with ``BULK_SHED`` + pushback (the
  ``_AdaptiveBulkGate`` discipline) so the interactive lane's p99
  recovers, and bulk resumes the moment the alert clears.

Scheduling is score-inert by construction: lanes and EDF reorder *when*
rows dispatch, never what they score — scoring is pure per row, pinned
by tests/test_deadline_scheduler.py against the lockstep path.

Every timestamp in this module is ``time.monotonic()`` — wall clock
steps backwards under NTP and would revive expired requests or expire
live ones (analyzer rule MX06 pins the discipline repo-wide).
"""

from __future__ import annotations

import heapq
import os
import threading
import time
from concurrent.futures import Future
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

# -- lanes -------------------------------------------------------------------

LANE_INTERACTIVE = "interactive"
LANE_BULK = "bulk"
LANE_BACKGROUND = "background"
# Priority order, highest first. Bounded enumeration — these three are
# also the only legal `lane` metric label values (MX05).
LANES: tuple[str, ...] = (LANE_INTERACTIVE, LANE_BULK, LANE_BACKGROUND)

# How long a lower lane's HEAD may wait before it outranks higher lanes
# for one pop (strict no-starvation aging across lanes).
_DEFAULT_AGING_MS = {LANE_INTERACTIVE: 0.0, LANE_BULK: 25.0,
                     LANE_BACKGROUND: 100.0}

DEADLINE_METADATA_KEY = "risk-deadline-ms"
# Clamp for nonsense-huge metadata (a caller sending 10^12 ms must not
# produce an effectively-unexpirable request that also skews EDF order).
DEADLINE_MAX_MS = 600_000.0


def default_deadline_ms() -> float:
    """The deadline assigned to requests that carry none:
    ``DEADLINE_DEFAULT_MS`` when set, else the SLO objective — the bound
    the caller implicitly expects by calling a 50 ms-p99 service."""
    raw = os.environ.get("DEADLINE_DEFAULT_MS")
    if raw:
        try:
            return min(DEADLINE_MAX_MS, max(1.0, float(raw)))
        except ValueError:
            pass
    try:
        return float(os.environ.get("SLO_OBJECTIVE_MS", "50"))
    except ValueError:
        return 50.0


class DeadlineExpired(Exception):
    """A request's budget ran out before it could be (or while it was)
    scheduled. Mapped by the gRPC layer to ``DEADLINE_EXCEEDED`` with
    the retry-pushback hint; counted as a shed, never an error."""

    def __init__(self, msg: str, stage: str = "admission"):
        super().__init__(msg)
        self.stage = stage


@dataclass(slots=True)
class Deadline:
    """A monotonic-anchored latency budget. ``born_at`` is
    ``time.monotonic()`` at admission; everything downstream is
    arithmetic on that anchor — never wall clock."""

    budget_ms: float
    born_at: float = field(default_factory=time.monotonic)
    source: str = "default"  # metadata | context | default

    @classmethod
    def after_ms(cls, ms: float, source: str = "default") -> "Deadline":
        return cls(budget_ms=float(ms), source=source)

    def remaining_ms(self, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        return self.budget_ms - (now - self.born_at) * 1000.0

    def expired(self, now: float | None = None) -> bool:
        return self.remaining_ms(now) <= 0.0

    def abs_ms(self) -> float:
        """Absolute monotonic expiry in ms — the EDF heap key."""
        return self.born_at * 1000.0 + self.budget_ms


def parse_deadline_ms(value: Any) -> float | None:
    """Robust ``risk-deadline-ms`` parse: numeric strings clamp to
    [0, DEADLINE_MAX_MS]; zero/negative mean "already expired" (0.0);
    garbage returns None so the caller falls through to the next
    deadline source."""
    if value is None:
        return None
    try:
        ms = float(value)
    except (TypeError, ValueError):
        return None
    if ms != ms or ms in (float("inf"), float("-inf")):  # NaN / inf
        return None
    if ms <= 0.0:
        return 0.0
    return min(ms, DEADLINE_MAX_MS)


def from_grpc(context, default_ms: float | None = None) -> Deadline:
    """The admission-time deadline for an RPC, by precedence:
    ``risk-deadline-ms`` metadata > the gRPC context deadline >
    ``default_ms`` (None = :func:`default_deadline_ms`)."""
    if context is not None:
        try:
            for key, value in context.invocation_metadata() or ():
                if key == DEADLINE_METADATA_KEY:
                    ms = parse_deadline_ms(value)
                    if ms is not None:
                        return Deadline.after_ms(ms, source="metadata")
        except Exception:  # noqa: CC04 — metadata parse must not fail admission; the default deadline applies
            pass
        try:
            remaining = context.time_remaining()
        except Exception:  # noqa: CC04 — a torn context has no deadline; the default applies
            remaining = None
        # grpc returns a very large value for "no deadline" on some
        # versions; treat anything past the clamp as absent.
        if remaining is not None and 0 <= remaining * 1000.0 <= DEADLINE_MAX_MS:
            return Deadline.after_ms(remaining * 1000.0, source="context")
    return Deadline.after_ms(
        default_deadline_ms() if default_ms is None else default_ms,
        source="default")


def outbound_deadline_ms(deadline: Deadline | None,
                         now: float | None = None) -> int | None:
    """The ``risk-deadline-ms`` value for the NEXT hop: the remaining
    budget at send time, i.e. the admitted budget decremented by the
    elapsed time at this hop. Floor 0 — the receiver sheds it."""
    if deadline is None:
        return None
    return max(0, int(deadline.remaining_ms(now)))


# -- scheduler ---------------------------------------------------------------


@dataclass(slots=True)
class _Item:
    payload: Any
    future: Future
    deadline: Deadline | None
    lane: str
    enqueued_at: float
    seq: int

    def edf_key(self) -> tuple[float, int]:
        # Items without a deadline order by their enqueue time plus the
        # default budget — FIFO-ish among themselves, never shed.
        if self.deadline is not None:
            return (self.deadline.abs_ms(), self.seq)
        return (self.enqueued_at * 1000.0 + default_deadline_ms(), self.seq)


class DeadlineScheduler:
    """Multi-lane EDF queue with cross-lane aging and expiry shedding.

    ``submit`` is O(log n); ``poll`` pops the next item to dispatch:
    the highest-priority non-empty lane, unless a lower lane's head has
    aged past its budget (then the most-overdue aged lane wins one pop).
    Expired items are shed at pop time — their futures fail with
    :class:`DeadlineExpired` and ``on_expired`` counts them — so a dead
    request never reaches the device.
    """

    def __init__(self, max_queue: int = 65536,
                 aging_ms: dict[str, float] | None = None):
        self.max_queue = max(1, max_queue)
        self.aging_ms = dict(_DEFAULT_AGING_MS)
        if aging_ms:
            self.aging_ms.update(aging_ms)
        self._cv = threading.Condition()
        self._heaps: dict[str, list[tuple[tuple[float, int], _Item]]] = {
            lane: [] for lane in LANES}
        self._size = 0
        self._seq = 0
        self._closed = False
        # Hooks (called OUTSIDE the scheduler lock — metric registries
        # have their own locks and must not nest under this one):
        self.on_expired: Callable[[int, str, str], None] | None = None
        self.on_depth: Callable[[str, int], None] | None = None

    # -- submission ----------------------------------------------------------

    def submit(self, payload: Any, deadline: Deadline | None = None,
               lane: str = LANE_INTERACTIVE) -> Future:
        if lane not in self._heaps:
            raise ValueError(f"unknown lane {lane!r} (use one of {LANES})")
        fut: Future = Future()
        now = time.monotonic()
        if deadline is not None and deadline.expired(now):
            # Double-guard: the gRPC layer sheds expired requests before
            # submit, but a deadline can expire in between.
            self._note_expired(1, "admission", lane)
            raise DeadlineExpired(
                f"deadline expired {-deadline.remaining_ms(now):.1f} ms "
                "before admission", stage="admission")
        with self._cv:
            if self._size >= self.max_queue:
                raise QueueFullError(
                    f"scheduler queue full ({self.max_queue} items)")
            self._seq += 1
            item = _Item(payload, fut, deadline, lane, now, self._seq)
            heapq.heappush(self._heaps[lane], (item.edf_key(), item))
            self._size += 1
            self._cv.notify()
            depth = len(self._heaps[lane])
        self._note_depth(lane, depth)
        return fut

    # -- dispatch side -------------------------------------------------------

    def poll(self, timeout: float | None = None) -> _Item | None:
        """Pop the next dispatchable item (lane priority + aging + EDF),
        shedding expired items along the way. Blocks up to ``timeout``;
        None on timeout or close."""
        deadline_t = None if timeout is None else time.monotonic() + timeout
        expired: list[tuple[_Item, str]] = []
        try:
            with self._cv:
                while True:
                    item = self._pop_locked(expired)
                    if item is not None:
                        return item
                    if self._closed:
                        return None
                    remaining = (None if deadline_t is None
                                 else deadline_t - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        return None
                    self._cv.wait(remaining)
        finally:
            self._shed(expired)

    def drain(self, max_items: int) -> list[_Item]:
        """Non-blocking pop of up to ``max_items`` already-queued items
        (the opportunistic tail of a batch assembly)."""
        out: list[_Item] = []
        expired: list[tuple[_Item, str]] = []
        with self._cv:
            while len(out) < max_items:
                item = self._pop_locked(expired)
                if item is None:
                    break
                out.append(item)
        self._shed(expired)
        return out

    def _pop_locked(self, expired: list) -> _Item | None:
        """Caller holds the lock. Lane choice: highest-priority
        non-empty lane, unless an aged lower lane overrides; expired
        heads are collected for shedding, not returned."""
        now = time.monotonic()
        while True:
            lane = self._choose_lane(now)
            if lane is None:
                return None
            _key, item = heapq.heappop(self._heaps[lane])
            self._size -= 1
            if (item.deadline is not None and item.deadline.expired(now)):
                expired.append((item, lane))
                continue
            return item

    def _choose_lane(self, now: float) -> str | None:
        aged_lane, aged_overdue = None, 0.0
        first_nonempty = None
        for lane in LANES:
            heap = self._heaps[lane]
            if not heap:
                continue
            if first_nonempty is None:
                first_nonempty = lane
            waited_ms = (now - heap[0][1].enqueued_at) * 1000.0
            overdue = waited_ms - self.aging_ms.get(lane, 0.0)
            if lane != first_nonempty and overdue > 0 and overdue > aged_overdue:
                aged_lane, aged_overdue = lane, overdue
        return aged_lane or first_nonempty

    def _shed(self, expired: list) -> None:
        """Fail expired items' futures (outside the lock) and count."""
        by_lane: dict[str, int] = {}
        for item, lane in expired:
            by_lane[lane] = by_lane.get(lane, 0) + 1
            if not item.future.done():
                item.future.set_exception(DeadlineExpired(
                    "deadline expired while queued "
                    f"(lane={lane}, waited "
                    f"{(time.monotonic() - item.enqueued_at) * 1000.0:.1f} ms)",
                    stage="dispatch"))
        for lane, n in by_lane.items():
            self._note_expired(n, "dispatch", lane)

    # -- introspection -------------------------------------------------------

    def qsize(self) -> int:
        with self._cv:
            return self._size

    def depths(self) -> dict[str, int]:
        with self._cv:
            return {lane: len(h) for lane, h in self._heaps.items()}

    def tightest_remaining_ms(self, now: float | None = None) -> float | None:
        """Remaining budget of the most urgent queued item (lane heads
        are EDF minima, so scanning heads is exact), or None when no
        queued item carries a real deadline."""
        now = time.monotonic() if now is None else now
        tightest: float | None = None
        with self._cv:
            for heap in self._heaps.values():
                for _key, item in heap[:1]:
                    if item.deadline is None:
                        continue
                    rem = item.deadline.remaining_ms(now)
                    if tightest is None or rem < tightest:
                        tightest = rem
        return tightest

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def _note_expired(self, n: int, stage: str, lane: str) -> None:
        if self.on_expired is not None:
            try:
                self.on_expired(n, stage, lane)
            except Exception:  # noqa: CC04 — metrics must not fail scheduling; sheds are already counted by the caller's future
                pass

    def _note_depth(self, lane: str, depth: int) -> None:
        if self.on_depth is not None:
            try:
                self.on_depth(lane, depth)
            except Exception:  # noqa: CC04 — metrics must not fail scheduling; depth is a gauge refreshed on the next submit
                pass


class QueueFullError(Exception):
    """Admission queue at capacity — the caller sheds RESOURCE_EXHAUSTED."""


# -- per-tick batch planning -------------------------------------------------


@dataclass(slots=True)
class TickPlan:
    """One dispatch tick's policy: how many rows to assemble at most
    (the ladder shape the step model says fits the tightest deadline)
    and how long to hold the flush window open waiting for them."""

    max_rows: int
    window_s: float
    shape: int


def plan_tick(*, shapes: Iterable[int], tightest_ms: float | None,
              max_wait_ms: float, step_model=None,
              margin_ms: float = 2.0) -> TickPlan:
    """Choose batch shape + flush window against the tightest admitted
    deadline. With no real deadline (or no model evidence yet) this
    degrades to the fixed-knob behavior: full shape, full window.

    The shape chosen is the largest compiled ladder shape whose
    predicted step time fits inside half the tightest remaining budget
    (the other half covers queue wait already spent plus readback +
    encode); the flush window is whatever budget remains after the
    predicted step and a safety margin, capped at the configured
    ``max_wait_ms`` — a near-due queue flushes now, an all-slack queue
    waits the full window for a fuller batch."""
    ladder = sorted(set(int(s) for s in shapes)) or [1]
    full = ladder[-1]
    if tightest_ms is None or tightest_ms <= 0:
        return TickPlan(full, max_wait_ms / 1000.0, full)
    chosen = ladder[0]
    predicted = None
    if step_model is not None:
        for s in ladder:
            p = step_model.predict_ms(s)
            if p is None or p <= 0.5 * tightest_ms:
                chosen = s
                predicted = p
            else:
                break
    else:
        chosen = full
    step_ms = predicted if predicted is not None else 0.0
    window_ms = min(max_wait_ms, max(0.0, tightest_ms - step_ms - margin_ms))
    return TickPlan(chosen, window_ms / 1000.0, chosen)


# -- cross-lane dispatch gate ------------------------------------------------


class LaneGate:
    """Priority gate at the device-dispatch seam. The continuous
    batcher marks an interactive batch *pending* while it launches;
    bulk/background chunk dispatches briefly yield (bounded by their
    lane's aging budget, so they can never starve) so the interactive
    step enqueues on the device first. Free when uncontended: one lock
    check per bulk dispatch."""

    def __init__(self, aging_ms: dict[str, float] | None = None):
        self.aging_ms = dict(_DEFAULT_AGING_MS)
        if aging_ms:
            self.aging_ms.update(aging_ms)
        self._cv = threading.Condition()
        self._interactive_pending = 0
        self.yields = 0  # bulk dispatches that waited at least once

    @contextmanager
    def interactive(self):
        with self._cv:
            self._interactive_pending += 1
        try:
            yield
        finally:
            with self._cv:
                self._interactive_pending -= 1
                if self._interactive_pending == 0:
                    self._cv.notify_all()

    def acquire(self, lane: str) -> None:
        """Block a bulk/background dispatch while an interactive batch
        is launching, up to the lane's aging budget."""
        if lane == LANE_INTERACTIVE:
            return
        limit_s = self.aging_ms.get(lane, 25.0) / 1000.0
        deadline_t = None
        with self._cv:
            waited = False
            while self._interactive_pending > 0:
                now = time.monotonic()
                if deadline_t is None:
                    deadline_t = now + limit_s
                remaining = deadline_t - now
                if remaining <= 0:
                    break  # aged out: no starvation, dispatch anyway
                waited = True
                self._cv.wait(remaining)
            if waited:
                self.yields += 1


# -- closed loop on the SLO plane --------------------------------------------


class BurnShedGate:
    """Bulk-lane shedding driven by the live SLO burn signal.

    While the SLOEngine's FAST window burn alert is active (the error
    budget is burning ≥ SLO_FAST_BURN_ALERT times too fast), bulk and
    background admissions shed with ``BULK_SHED`` + the standard
    ``grpc-retry-pushback-ms`` hint — the `_AdaptiveBulkGate` pushback
    discipline, now closed-loop on the measured SLO instead of a local
    latency window. Interactive traffic is never shed here: it is the
    lane the loop exists to protect — and for the same reason the shed
    only arms while interactive traffic actually EXISTS (an admission
    within ``BURN_SHED_IDLE_S``): a pure-bulk workload burning its own
    latency budget flat-out has nothing to yield to, and shedding it
    would just cut throughput (the flat-out bench arm pinned exactly
    this failure). ``BURN_SHED=0`` opts out."""

    def __init__(self, alerts_provider: Callable[[], dict] | None = None,
                 enabled: bool | None = None,
                 interactive_idle_s: float | None = None):
        if enabled is None:
            enabled = os.environ.get("BURN_SHED", "1") != "0"
        if interactive_idle_s is None:
            interactive_idle_s = float(
                os.environ.get("BURN_SHED_IDLE_S", "10"))
        self.enabled = enabled
        self.interactive_idle_s = interactive_idle_s
        self._provider = alerts_provider
        self._last_interactive: float | None = None
        self.sheds = 0
        self._lock = threading.Lock()

    def _alerts(self) -> dict:
        if self._provider is not None:
            try:
                return self._provider() or {}
            except Exception:  # noqa: CC04 — a failing alert provider must fail OPEN (no shed), not break admission
                return {}
        from igaming_platform_tpu_torch.obs import slo as _slo

        engine = _slo.get_default()
        if engine is None:
            return {}
        try:
            return engine.alerts_active()
        except Exception:  # noqa: CC04 — same fail-open contract as the injected provider
            return {}

    def note_interactive(self) -> None:
        """An interactive admission just happened — arms the shed."""
        self._last_interactive = time.monotonic()

    def _interactive_present(self) -> bool:
        last = self._last_interactive
        return (last is not None
                and time.monotonic() - last <= self.interactive_idle_s)

    def shedding(self) -> bool:
        """True while bulk admissions should shed: the fast window is
        burning AND there is interactive traffic to protect."""
        return (self.enabled and self._interactive_present()
                and bool(self._alerts().get("fast")))

    def note_shed(self) -> None:
        with self._lock:
            self.sheds += 1

    def stats(self) -> dict:
        shedding = self.shedding() if self.enabled else False
        with self._lock:
            return {"enabled": self.enabled, "sheds": self.sheds,
                    "interactive_present": self._interactive_present(),
                    "shedding": shedding}
