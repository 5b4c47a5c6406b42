"""Device-resident feature cache: ship slot indices and deltas, not rows.

The port's counterpart of ``igaming_platform_tpu/serve/device_cache.py``.
The per-account feature row lives in a ``[capacity, 30]`` float32 table on
the engine's device, and an index-mode request carries only

- an ``int32`` slot per row for the accounts already resident (4 bytes a
  row instead of 120),
- the per-transaction context as compact columns (amount, tx-type code),
  which the step writes into the gathered rows on the device, and
- full rows only for misses and refreshes, copied into the table by one
  ``index_copy_`` per lookup, between scoring steps.

Semantics, as in the JAX package:

- the table holds each account's base row as the host store computed it
  at the last delta (``fill_row(acct, 0, "")``), so a cached step is
  bit-identical to a host gather made with the same ``now``;
- ``note_update`` (the store's ``delta_listener``) marks an account dirty;
  the next ``lookup`` re-gathers every dirty row, so scoring never reads a
  row older than the account's last event;
- ``max_age_s`` treats rows older than that as stale (time-derived
  features drift with wall time between events);
- slot reclamation is CLOCK (second chance): one reference bit a slot and
  a rotating hand. A slot that an earlier row of the same lookup resolved
  to is never reclaimed by that lookup: its step reads that row. (The JAX
  package's loop can reclaim it once its sweep has cleared every bit; that
  row then scores with the new account's features, and with session state
  appends its event to the new account's ring.) A lookup with more
  distinct accounts than slots raises;
- ``flags`` is a per-slot sticky bool column (an account-level block) that
  the step ORs into the request's blacklist vector.

The port writes the table in place where the JAX package rebinds a new
array. Every device write goes on the engine's one CUDA stream, under its
dispatch lock (``on_stream``), so a delta copy enqueued after a step runs
after that step has read the old rows. The slot-sharded layout over a mesh
(``parallel/state_sharding.py``) and the metrics sink are not ported yet:
``mesh`` and ``metrics`` raise, ``shard_stats`` gives the unsharded answer.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from igaming_platform_tpu_torch.core.device import host_to_device, resolve_device
from igaming_platform_tpu_torch.core.features import NUM_FEATURES, F

_TXA, _TD, _TW, _TB = (int(F.TX_AMOUNT), int(F.TX_TYPE_DEPOSIT), int(F.TX_TYPE_WITHDRAW),
                       int(F.TX_TYPE_BET))


def compose_features(table: torch.Tensor, idxs: torch.Tensor, amounts: torch.Tensor,
                     types: torch.Tensor) -> torch.Tensor:
    """The table's rows at ``idxs`` with the four context columns
    overwritten (amount and the deposit/withdraw/bet one-hots of the wire
    code): [B, 30] float32."""
    x = table.index_select(0, idxs)
    x[:, _TXA] = amounts
    x[:, _TD] = (types == 0).to(x.dtype)
    x[:, _TW] = (types == 1).to(x.dtype)
    x[:, _TB] = (types == 2).to(x.dtype)
    return x


def compose_rows(table: torch.Tensor, flags: torch.Tensor, idxs: torch.Tensor,
                 amounts: torch.Tensor, types: torch.Tensor,
                 bl: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The cached step's input: ``compose_features`` and the blacklist ORed
    with the slots' flags. Returns ([B, 30] float32, [B] bool)."""
    x = compose_features(table, idxs, amounts, types)
    return x, torch.logical_or(bl, flags.index_select(0, idxs))


class DeviceFeatureCache:
    """Device-resident ``[capacity, 30]`` account-feature table with a host
    ``account_id -> slot`` index and an in-place delta copy."""

    def __init__(self, feature_store: Any, capacity: int = 65536, *,
                 device: str | torch.device = "cuda",
                 on_stream: Callable[[], Any] | None = None, mesh=None,
                 max_age_s: float | None = None, metrics: Any = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if mesh is not None:
            raise NotImplementedError(
                "a slot-sharded feature cache over a mesh is not ported yet (ROADMAP.md)")
        if metrics is not None:
            raise NotImplementedError("cache metrics need obs/, not ported yet (ROADMAP.md)")
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.features = feature_store
        self.clock: Callable[[], float] = getattr(feature_store, "clock", time.time)
        self.max_age_s = max_age_s
        self.plan = None  # the unsharded layout
        self._lock = threading.Lock()
        # Held from a lookup to the launch of the step that reads its slots,
        # so no other lookup reclaims them in between.
        self.step_lock = threading.RLock()
        self._on_stream = on_stream or contextlib.nullcontext

        # Host slot index and CLOCK state.
        self._slots: dict[str, int] = {}
        self._slot_keys: list[str | None] = [None] * self.capacity
        self._ref = np.zeros(self.capacity, dtype=bool)
        self._row_ts = np.zeros(self.capacity, dtype=np.float64)
        self._hand = 0
        self._free = self.capacity  # slots never yet assigned
        self._dirty: set[str] = set()
        # Session admission hook (serve/session_state.py): called under the
        # lock with (account_ids, slots) of every slot this lookup admitted,
        # so the session ring shares this cache's CLOCK decision.
        self.session_hook = None

        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.deltas_applied = 0

        with self._on_stream():
            self.table = torch.zeros((self.capacity, NUM_FEATURES), dtype=torch.float32,
                                     device=self.device)
            self.flags = torch.zeros((self.capacity,), dtype=torch.bool, device=self.device)

    # -- metrics and surfaces -------------------------------------------------

    def bind_metrics(self, metrics: Any) -> None:
        raise NotImplementedError("cache metrics need obs/, not ported yet (ROADMAP.md)")

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "deltas_applied": self.deltas_applied,
                "occupancy": self.capacity - self._free,
                "capacity": self.capacity,
                "shards": 1,
            }

    def hbm_bytes(self) -> int:
        """Device bytes of the table and the flags column."""
        return self.capacity * (NUM_FEATURES * 4 + 1)

    def shard_stats(self) -> dict:
        """The unsharded layout's answer: one shard holds every slot."""
        with self._lock:
            return {
                "sharded": False,
                "shards": 1,
                "rows_per_shard": self.capacity,
                "occupancy": [self.capacity - self._free],
                "hbm_bytes": [self.hbm_bytes()],
            }

    # -- write-back hook ------------------------------------------------------

    def note_update(self, account_id: str) -> None:
        """Mark a resident account's row stale; the next lookup re-gathers
        it. O(1)."""
        with self._lock:
            if account_id in self._slots:
                self._dirty.add(account_id)

    def set_account_flag(self, account_id: str, value: bool = True) -> None:
        """Sticky per-account device flag, ORed into the blacklist vector by
        the cached step. Admits the account if it is not resident."""
        with self.step_lock:
            idxs = self.lookup([account_id])
            with self._lock, self._on_stream():
                self.flags[host_to_device(idxs.astype(np.int64), self.device)] = bool(value)

    # -- slot management ------------------------------------------------------

    def _assign_slot(self, pinned: set[int]) -> int:
        """CLOCK second-chance reclamation, never of a ``pinned`` slot (one
        an earlier row of this lookup resolved to); the caller holds the
        lock."""
        if self._free > 0:
            # Cold start: hand over never-used slots in order.
            for _ in range(self.capacity):
                slot = self._hand
                self._hand = (self._hand + 1) % self.capacity
                if self._slot_keys[slot] is None:
                    self._free -= 1
                    return slot
        if len(pinned) >= self.capacity:
            raise ValueError(f"a lookup of more distinct accounts than the cache's "
                             f"{self.capacity} slots")
        while True:
            slot = self._hand
            self._hand = (self._hand + 1) % self.capacity
            if self._ref[slot]:
                self._ref[slot] = False
                continue
            if slot in pinned:
                continue
            old = self._slot_keys[slot]
            if old is not None:
                del self._slots[old]
                self._dirty.discard(old)
                self.evictions += 1
            return slot

    def _gather_base_rows(self, ids: list[str], now: float) -> np.ndarray:
        """Host-gather the account-level base rows (amount 0, no tx type:
        the step overwrites the four context columns on the device)."""
        k = len(ids)
        if hasattr(self.features, "gather_columns"):
            x, _ = self.features.gather_columns(ids, [0] * k, [""] * k, now=now)
            return np.ascontiguousarray(x, dtype=np.float32)
        x = np.zeros((k, NUM_FEATURES), dtype=np.float32)
        for i, a in enumerate(ids):
            self.features.fill_row(x[i], a, 0, "", now=now)
        return x

    # -- the hot path ---------------------------------------------------------

    def lookup(self, account_ids, now: float | None = None) -> np.ndarray:
        """Account ids -> ``int32`` slots, admitting misses and copying every
        pending delta (dirty rows, admissions, stale rows) into the table
        with one ``index_copy_`` on the engine's stream before returning."""
        now = now or self.clock()
        n = len(account_ids)
        idxs = np.empty((n,), dtype=np.int32)
        with self._lock:
            hits = misses = 0
            refresh: dict[str, int] = {}
            admitted: dict[str, int] = {}
            pinned: set[int] = set()
            stale_cut = None if self.max_age_s is None else now - self.max_age_s
            for i, raw in enumerate(account_ids):
                a = raw if isinstance(raw, str) else bytes(raw).decode()
                slot = self._slots.get(a)
                if slot is None:
                    slot = self._assign_slot(pinned)
                    self._slots[a] = slot
                    self._slot_keys[slot] = a
                    refresh[a] = slot
                    admitted[a] = slot
                    misses += 1
                elif a in self._dirty or (stale_cut is not None
                                          and self._row_ts[slot] < stale_cut):
                    # A resident slot with a stale row: a hit plus a delta.
                    refresh[a] = slot
                    hits += 1
                else:
                    hits += 1
                self._ref[slot] = True
                pinned.add(slot)
                idxs[i] = slot
            # Fold the whole dirty set, not only this batch's rows: one copy
            # either way, and every resident row stays <= one event stale.
            for a in self._dirty:
                slot = self._slots.get(a)
                if slot is not None:
                    refresh[a] = slot
            self._dirty.clear()
            deltas = len(refresh)
            if deltas:
                slots = np.fromiter(refresh.values(), np.int64, deltas)
                rows = self._gather_base_rows(list(refresh), now)
                with self._on_stream():
                    self.table.index_copy_(0, host_to_device(slots, self.device),
                                           host_to_device(rows, self.device))
                self._row_ts[slots] = now
                self.deltas_applied += deltas
            if admitted and self.session_hook is not None:
                # Same admission, second table: the session ring rehydrates
                # the admitted slots before the next step reads them.
                self.session_hook(list(admitted), list(admitted.values()))
            self.hits += hits
            self.misses += misses
        return idxs

    def contains(self, account_id: str) -> bool:
        with self._lock:
            return account_id in self._slots
