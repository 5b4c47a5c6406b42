"""Deterministic chaos layer: seedable fault plans at the serving path's seams.

The port's copy of ``igaming_platform_tpu/serve/chaos.py`` (pure Python,
kept apart so the port imports nothing of the JAX package). A fault plan is
a seed plus a list of (seam, fault) specs, injected at well-known choke
points, so recovery behaviour becomes something tests assert. In the port
the engine fires ``device.dispatch`` and ``device.readback``
(``serve/scorer.py``; the host pipeline's readback worker reads back through
it), both feature stores fire ``feature_store.gather``, and the decision
ledger fires ``ledger.append`` and ``ledger.sink`` (``serve/ledger.py``);
the supervisor (``serve/supervisor.py``) classifies what they raise.
``CHAOS_PLAN`` is installed at the server's boot and parsed for the replay
tool's ``--verify``; the fleet, AMQP and work-channel seams wait for their
modules (``ROADMAP.md``).

Seams (each a single ``chaos.fire(seam)`` call at the choke point):

- ``device.dispatch``   — scorer launch of the compiled step
- ``device.readback``   — the D2H drain (scorer + pipeline readback worker)
- ``feature_store.gather`` — host feature gather / native decode+gather
- ``workchannel.send``  — the front -> follower work-frame socket write
- ``amqp.publish``      — the event-backbone publish attempt
- ``router.forward``    — a fleet router's forward of a scoring RPC to a
  replica (serve/router.py); ``drop`` severs the router↔replica link for
  that forward, which must retry onto the next ring owner
- ``router.health``     — the fleet health watcher's probe of a replica;
  ``drop``/``error`` make the replica look dead to the watcher
- ``ledger.append``     — the decision ledger's WAL write (serve/ledger.py);
  ``error`` is the fs-outage shape — scoring must proceed untouched while
  drops are counted and the ``ledger`` breaker opens
- ``ledger.sink``       — the ledger's sink drain push; ``error`` is the
  sink-outage shape — the drainer falls behind and later catches up from
  the WAL at its persisted cursor

Fleet-level *process* faults — replica SIGKILL (pod death) and replica
wedge (SIGSTOP, the process stops answering but the sockets stay open) —
cannot be fired from inside the victim: they are scheduled by the fleet
harness (``benchmarks/fleet.py`` ``FleetFaultSchedule``, driven by
``benchmarks/soak.py --fleet-chaos``) and recorded in the FLEET_CHAOS
artifact next to the seam injections above.

Fault kinds: ``delay`` (sleep ``ms``), ``wedge`` (a LONG sleep — the
tunnel-wedge shape; bounded by ``ms`` so tests terminate), ``error``
(raise :class:`ChaosError`), ``drop`` (``fire`` returns ``"drop"`` and the
seam skips the operation — only meaningful on send-like seams).

Plans are DETERMINISTIC: each seam draws from its own ``random.Random``
derived from (plan seed, seam name), and specs can be windowed by the
seam's operation count (``after``/``count``), so the same plan string
produces the same fault sequence on every run — a failing chaos test
replays exactly.

Plan grammar (``CHAOS_PLAN`` env var, ``;``-separated)::

    seed=42;device.readback=wedge:p=1.0:ms=3000:after=5:count=1;
    feature_store.gather=error:p=1.0

``fire()`` is free when no plan is installed (one module-global ``is
None`` check), so the seams cost nothing in production.
"""

from __future__ import annotations

import random
import threading
import time as _time

__all__ = [
    "ChaosError",
    "ChaosPlan",
    "FaultSpec",
    "active",
    "clear",
    "fire",
    "install",
    "install_from_env",
]

SEAMS = (
    "device.dispatch",
    "device.readback",
    "feature_store.gather",
    "workchannel.send",
    "amqp.publish",
    "router.forward",
    "router.health",
    "ledger.append",
    "ledger.sink",
)

_KINDS = ("delay", "wedge", "error", "drop")


class ChaosError(RuntimeError):
    """The injected failure: raised by ``fire`` for ``error`` faults.

    Deliberately a RuntimeError (not an OSError): it must flow through the
    same generic-failure handling real dependency errors take, so a chaos
    run proves the recovery path, not a chaos-only special case."""

    def __init__(self, seam: str, detail: str = ""):
        super().__init__(f"chaos: injected failure at {seam}" +
                         (f" ({detail})" if detail else ""))
        self.seam = seam


class FaultSpec:
    """One seam's fault: kind, probability, window over the op counter."""

    __slots__ = ("seam", "kind", "prob", "ms", "after", "count")

    def __init__(self, seam: str, kind: str, prob: float = 1.0,
                 ms: float = 0.0, after: int = 0, count: int | None = None):
        if kind not in _KINDS:
            raise ValueError(f"unknown chaos fault kind {kind!r} (use {_KINDS})")
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"chaos fault probability {prob} outside [0, 1]")
        self.seam = seam
        self.kind = kind
        self.prob = prob
        self.ms = ms
        self.after = max(0, int(after))
        self.count = None if count is None else max(1, int(count))

    def in_window(self, op_index: int) -> bool:
        if op_index < self.after:
            return False
        return self.count is None or op_index < self.after + self.count

    def __repr__(self) -> str:  # artifact-friendly
        win = f"after={self.after}" + (
            f",count={self.count}" if self.count is not None else "")
        return (f"FaultSpec({self.seam}: {self.kind} p={self.prob}"
                f" ms={self.ms} {win})")


def _parse_entry(entry: str) -> FaultSpec:
    seam, _, rhs = entry.partition("=")
    seam = seam.strip()
    if not rhs:
        raise ValueError(f"bad CHAOS_PLAN entry {entry!r} (want seam=kind:...)")
    parts = [p.strip() for p in rhs.split(":") if p.strip()]
    kind, kv = parts[0], parts[1:]
    fields: dict[str, float] = {}
    for item in kv:
        key, _, val = item.partition("=")
        if key not in ("p", "ms", "after", "count"):
            raise ValueError(f"bad CHAOS_PLAN field {item!r} in {entry!r}")
        fields[key] = float(val)
    return FaultSpec(
        seam, kind,
        prob=fields.get("p", 1.0),
        ms=fields.get("ms", 0.0),
        after=int(fields.get("after", 0)),
        count=int(fields["count"]) if "count" in fields else None,
    )


class ChaosPlan:
    """A seed plus fault specs; thread-safe, deterministic per seam."""

    def __init__(self, specs: list[FaultSpec], seed: int = 0):
        self.seed = int(seed)
        self.specs: dict[str, list[FaultSpec]] = {}
        for spec in specs:
            self.specs.setdefault(spec.seam, []).append(spec)
        self._lock = threading.Lock()
        self._ops: dict[str, int] = {}
        self._rng: dict[str, random.Random] = {
            seam: random.Random(f"{self.seed}:{seam}") for seam in self.specs
        }
        # Injection log for artifacts: (seam, kind, op_index, monotonic t).
        self.events: list[tuple[str, str, int, float]] = []

    @classmethod
    def from_string(cls, plan: str) -> "ChaosPlan":
        seed = 0
        specs: list[FaultSpec] = []
        for raw in plan.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            if raw.startswith("seed="):
                seed = int(raw[5:])
                continue
            specs.append(_parse_entry(raw))
        return cls(specs, seed=seed)

    def _pick(self, seam: str) -> FaultSpec | None:
        """Decide (under the lock) whether this op draws a fault."""
        specs = self.specs.get(seam)
        if not specs:
            return None
        idx = self._ops.get(seam, 0)
        self._ops[seam] = idx + 1
        rng = self._rng[seam]
        for spec in specs:
            # The draw happens for EVERY in-window op, hit or miss, so the
            # fault sequence depends only on (seed, seam, op index) — not
            # on which other specs matched first.
            if spec.in_window(idx) and rng.random() < spec.prob:
                self.events.append((seam, spec.kind, idx, _time.monotonic()))
                return spec
        return None

    def fire(self, seam: str) -> str | None:
        """Apply the plan at a seam. Returns the fault kind applied (the
        send seams honor ``"drop"`` by skipping the op), None when clean.
        ``error`` faults raise :class:`ChaosError` instead of returning."""
        with self._lock:
            spec = self._pick(seam)
        if spec is None:
            return None
        if spec.kind in ("delay", "wedge"):
            # A wedge is just a delay long enough to blow every deadline
            # on the path — bounded by ms so harnesses always terminate.
            _time.sleep(spec.ms / 1000.0)  # noqa: CC02 — deliberate fault injection
            return spec.kind
        if spec.kind == "error":
            raise ChaosError(seam)
        return spec.kind  # "drop": the seam skips the operation

    def op_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._ops)

    def snapshot(self) -> dict:
        """Plan + injection log for soak artifacts."""
        with self._lock:
            return {
                "seed": self.seed,
                "specs": {s: [repr(f) for f in fs] for s, fs in self.specs.items()},
                "ops": dict(self._ops),
                "injected": [
                    {"seam": s, "kind": k, "op": i, "t": round(t, 4)}
                    for s, k, i, t in self.events
                ],
            }


_ACTIVE: ChaosPlan | None = None


def install(plan: "ChaosPlan | str") -> ChaosPlan:
    """Install a plan process-wide (tests, soak --chaos, CHAOS_PLAN boot)."""
    global _ACTIVE
    if isinstance(plan, str):
        plan = ChaosPlan.from_string(plan)
    _ACTIVE = plan
    return plan


def install_from_env() -> ChaosPlan | None:
    """Install the CHAOS_PLAN env plan, if set. Parse errors are LOUD —
    a typo'd plan silently not injecting would fake a green chaos run."""
    import os

    plan = os.environ.get("CHAOS_PLAN", "")
    if not plan:
        return None
    return install(plan)


def clear() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> ChaosPlan | None:
    return _ACTIVE


def fire(seam: str) -> str | None:
    """The seam hook. Free when no plan is installed."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.fire(seam)
