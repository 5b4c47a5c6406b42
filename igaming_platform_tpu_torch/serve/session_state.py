"""Device-resident per-account session state: the stateful sequence head.

The port's counterpart of ``igaming_platform_tpu/serve/session_state.py``.
Beside the device feature cache (``serve/device_cache.py``) it keeps, on
the engine's device:

- ``session_ring`` [capacity+1, N_EVENTS, EVENT_WIDTH] float32: each slot's
  last events, slot-aligned with the feature table; row ``capacity`` is the
  scratch slot that batch padding reads, never a real account's;
- ``session_cursor`` / ``session_length`` [capacity+1] int32: each slot's
  write cursor and saturating event count.

Both tables share the cache's host ``account_id -> slot`` index and its
CLOCK: on admission the cache calls :meth:`SessionStateManager.on_admit`,
which rehydrates the slot from the host index, so an evicted account gets
its window back.

The scoring step is fused (:func:`make_session_step`): the step that
gathers the feature rows gathers each row's ring window, runs the session
head over the post-append window (history and the event being scored),
folds the result into the ensemble and appends the event to the ring.
Where the JAX package donates the ring to a jitted step and rebinds what it
returns, the port writes the ring, cursor and length in place, on the
engine's stream, under the manager's lock:

- duplicate accounts in one chunk append at ``cursor + occ``, distinct
  positions; when more than ``N_EVENTS`` rows of one account would wrap
  onto each other, only the last write to each position is made, which is
  the state the JAX package's in-order scatter leaves, without two writes
  to one address (their order on a card is undefined);
- the cursor and length advance by an integer ``index_add_``, whose
  result does not depend on the order of the adds.

The host index (``_twin``) is authoritative: every decision's window can
be rebuilt from it (``SessionChunkAudit`` hashes it lazily). The step's
drift sketch and shadow variants (``make_session_step(sketch=, shadow=)``)
reduce and re-score the same composed rows in the same step. A
``metrics=`` registry (``bind_metrics``) gets the ``session_*`` families.

On a mesh with a ``data`` axis > 1 (``STATE_SHARDING`` not ``0``) the ring,
cursor and length split by slot over ``data`` with the feature cache's
plan, so one slot id lives on the same shard in both tables
(``parallel/state_sharding.py``). The sharded layout has no scratch slot:
pad rows target ``sidx == capacity``, which no shard owns, so they read an
empty window and their appends and counts vanish. Gathered, the sharded
ring, cursor and length equal the unsharded ones bit for bit.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from igaming_platform_tpu_torch.core.device import host_to_device, resolve_device
from igaming_platform_tpu_torch.core.enums import SESSION_COLD_BIT, SESSION_PATTERN_BIT
from igaming_platform_tpu_torch.models.sequence import EVENT_DIM, SeqConfig, SequenceModel
from igaming_platform_tpu_torch.parallel.state_sharding import per_shard_nbytes, plan_for

# Per-event layout: models/sequence.encode_event - [log-amount, log-dt,
# 8-way tx-type one-hot, game-weight, balance-ratio].
EVENT_WIDTH = EVENT_DIM

# Wire tx-type codes (serve/wire.TX_TYPE_CODES: deposit=0 withdraw=1 bet=2
# win=3 other=4) -> the one-hot column inside the event vector; "other"
# lands on the adjustment column (7), as encode_event's fallback.
_TX_EVENT_COL = np.array([0, 1, 2, 3, 7], dtype=np.int64)

# One-hot sub-columns of the event vector the pattern head reads.
_COL_DEPOSIT = 2 + 0
_COL_BET = 2 + 2

# The transformer head: the stock sequence model at d_model 32, 4 heads of
# 8, one layer, over the N-event window. Its params are the JAX package's
# pinned draw (jax.random.key(11)), committed beside this module.
SESSION_SEQ_CONFIG = SeqConfig(d_model=32, n_heads=4, n_layers=1, d_ff=64, in_dim=EVENT_DIM,
                               max_len=256)
HEAD_PARAMS_PATH = Path(__file__).with_name("session_head_params.npz")


def default_events() -> int:
    return int(os.environ.get("SESSION_EVENTS", "16"))


def default_min_events() -> int:
    return int(os.environ.get("SESSION_MIN_EVENTS", "4"))


def default_flag_threshold() -> float:
    return float(os.environ.get("SESSION_FLAG_THRESHOLD", "0.7"))


def session_enabled_env() -> bool:
    return os.environ.get("SESSION_STATE", "") not in ("", "0")


# ---------------------------------------------------------------------------
# Event encoding and window hash (host side)


def encode_events_host(amounts, tx_codes, dts) -> np.ndarray:
    """[B] amounts, wire tx codes and inter-event gaps -> [B, EVENT_WIDTH]
    float32 event rows: float64 arithmetic up to the final float32 cast, as
    the JAX package's codec, so both give the same bytes."""
    b = len(amounts)
    ev = np.zeros((b, EVENT_WIDTH), dtype=np.float32)
    ev[:, 0] = np.log1p(np.maximum(np.asarray(amounts, np.float64), 0.0))
    ev[:, 1] = np.log1p(np.maximum(np.asarray(dts, np.float64), 0.0))
    codes = np.clip(np.asarray(tx_codes, np.int64), 0, len(_TX_EVENT_COL) - 1)
    ev[np.arange(b), 2 + _TX_EVENT_COL[codes]] = 1.0
    ev[:, 10] = 1.0  # game weight (unknown at the wire: neutral)
    return ev


def window_hash(window: np.ndarray) -> bytes:
    """blake2b-8 over a post-append window ([L, EVENT_WIDTH] float32,
    chronological): a decision's ``session_state_hash``."""
    h = hashlib.blake2b(digest_size=8)
    h.update(np.ascontiguousarray(window, dtype=np.float32).tobytes())
    return h.digest()


# ---------------------------------------------------------------------------
# Session heads ([B, N, D] window + [B] lengths -> [B] probability)


def pattern_scores(window: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The ``pattern`` head: a paramless detector of bet/deposit cycling at
    a regular cadence with consistent amounts, the product of four factors
    in [0, 1] (bet-or-deposit share, alternation share, exp(-4 var log-dt)
    over events 1.., exp(-2 var log-amount)). Every division is by a device
    tensor, as in the JAX package."""
    n = window.shape[1]
    k = torch.arange(n, device=window.device)[None, :]
    m = (k < lengths[:, None]).to(torch.float32)  # [B, N] valid-event mask
    cnt = torch.clamp_min(m.sum(dim=1), 1.0)

    log_amt, log_dt = window[..., 0], window[..., 1]
    is_dep, is_bet = window[..., _COL_DEPOSIT], window[..., _COL_BET]

    bd_frac = ((is_bet + is_dep) * m).sum(dim=1) / cnt

    pair_m = m[:, 1:] * m[:, :-1]
    pairs = torch.clamp_min(pair_m.sum(dim=1), 1.0)
    alt = is_bet[:, 1:] * is_dep[:, :-1] + is_dep[:, 1:] * is_bet[:, :-1]
    alt_frac = (alt * pair_m).sum(dim=1) / pairs

    # dt regularity: event 0's gap points outside the window.
    dt_m = m[:, 1:]
    dt_cnt = torch.clamp_min(dt_m.sum(dim=1), 1.0)
    dt_mu = (log_dt[:, 1:] * dt_m).sum(dim=1) / dt_cnt
    dt_var = (((log_dt[:, 1:] - dt_mu[:, None]) ** 2) * dt_m).sum(dim=1) / dt_cnt
    reg = torch.exp(-4.0 * dt_var)

    a_mu = (log_amt * m).sum(dim=1) / cnt
    a_var = (((log_amt - a_mu[:, None]) ** 2) * m).sum(dim=1) / cnt
    acons = torch.exp(-2.0 * a_var)

    return torch.clamp(bd_frac * alt_frac * reg * acons, 0.0, 1.0)


def session_head_tree() -> dict:
    """The committed transformer-head params as the JAX package's tree of
    numpy arrays (``init_session_head_params()``'s, bit for bit)."""
    with np.load(HEAD_PARAMS_PATH) as z:
        flat = {k: z[k] for k in z.files}
    tree: dict = {"layers": [{} for _ in range(SESSION_SEQ_CONFIG.n_layers)]}
    for key, arr in flat.items():
        parts = key.split(".")
        node = tree["layers"][int(parts[1])] if parts[0] == "layers" else tree
        for p in parts[2:-1] if parts[0] == "layers" else parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def session_head_params(device: torch.device) -> SequenceModel:
    """The transformer head on ``device``, from the committed params."""
    from igaming_platform_tpu_torch.convert import sequence_from_tree

    return sequence_from_tree(session_head_tree(), SESSION_SEQ_CONFIG).to(device)


def transformer_scores(sparams: SequenceModel, window: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """The ``transformer`` head: the sequence model over the zero-padded
    window (positions past ``lengths`` still add their bias and position
    terms: deterministic, as in the JAX package). Its attention is the
    flash-attention forward kernel on a card."""
    del lengths
    return sparams(window)["abuse"]


# ---------------------------------------------------------------------------
# The fused step: feature gather + score + session head + in-place append


def windows_from_state(ring_rows: torch.Tensor, cur: torch.Tensor, ln: torch.Tensor,
                       events: torch.Tensor, n_events: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Post-append windows from gathered ring state (``ring_rows`` [B, N, D],
    ``cur``/``ln`` [B]): the last ``min(length, N-1)`` stored events in
    order, then the new event, zero-padded to [B, N, D]. Returns (windows,
    post-append lengths)."""
    lp = torch.clamp_max(ln + 1, n_events)
    hist = lp - 1
    k = torch.arange(n_events, device=ring_rows.device)[None, :]
    pos = torch.remainder(cur[:, None] - hist[:, None] + k, n_events)
    win = torch.gather(ring_rows, 1, pos[..., None].expand(-1, -1, ring_rows.shape[2]))
    win = torch.where((k < hist[:, None])[..., None], win, 0.0)
    win = torch.where((k == hist[:, None])[..., None], events[:, None, :], win)
    return win, lp


def build_windows(ring, cursor, length, sidx, events, n_events: int):
    """Each row's post-append window from the ring. Duplicate accounts in one
    batch all see the batch-start state; their appends land at distinct
    offsets."""
    return windows_from_state(ring.index_select(0, sidx), cursor.index_select(0, sidx),
                              length.index_select(0, sidx), events, n_events)


def occurrence_rank_host(uidx: np.ndarray) -> np.ndarray:
    """occ[i] = how many earlier rows of the batch target the same account:
    duplicate appends land at cursor+occ. Vectorized over stable-sorted
    runs."""
    b = uidx.shape[0]
    if b == 0:
        return np.zeros((0,), np.int32)
    order = np.argsort(uidx, kind="stable")
    sorted_u = uidx[order]
    starts = np.empty((b,), dtype=bool)
    starts[0] = True
    np.not_equal(sorted_u[1:], sorted_u[:-1], out=starts[1:])
    run_id = np.cumsum(starts) - 1
    run_start = np.flatnonzero(starts)
    occ = np.empty((b,), np.int32)
    occ[order] = (np.arange(b) - run_start[run_id]).astype(np.int32)
    return occ


def surviving_appends(sidx: np.ndarray, occ: np.ndarray, n_events: int) -> np.ndarray:
    """The rows (of ``sidx``/``occ``, the real rows of a chunk) whose ring
    write survives: the last row to each (slot, position), where rows of one
    slot share a position when their ``occ`` agree modulo ``n_events``
    (the position is ``(cursor + occ) % n_events``). Sorted int64 row
    indices; every row but in a chunk with a wrap."""
    key = sidx.astype(np.int64) * n_events + np.remainder(occ, n_events)
    b = key.shape[0]
    _, first_rev = np.unique(key[::-1], return_index=True)
    if first_rev.shape[0] == b:
        return np.arange(b, dtype=np.int64)
    return np.sort(b - 1 - first_rev).astype(np.int64)


class SessionChunkAudit:
    """Lazy per-row ``session_state_hash`` provider: the chunk's batch-start
    snapshots, ``(buffer, row_count)`` per unique account into the
    append-only twin buffers, hashed only when a row is read. Indexes like a
    ``list[bytes]``."""

    __slots__ = ("events", "post_len", "uidx", "snaps")

    def __init__(self, events: np.ndarray, post_len: np.ndarray,
                 uidx: np.ndarray, snaps: list[tuple[np.ndarray, int]]):
        self.events = events
        self.post_len = post_len
        self.uidx = uidx
        self.snaps = snaps

    def __len__(self) -> int:
        return int(self.post_len.shape[0])

    def __getitem__(self, i: int) -> bytes:
        hist = int(self.post_len[i]) - 1
        h = hashlib.blake2b(digest_size=8)
        if hist > 0:
            buf, count = self.snaps[int(self.uidx[i])]
            h.update(np.ascontiguousarray(buf[count - hist:count], dtype=np.float32).tobytes())
        h.update(self.events[i].tobytes())
        return h.digest()


def _stack(final, action, mask, rule, ml) -> torch.Tensor:
    return torch.stack([final.to(torch.int32), action.to(torch.int32), mask.to(torch.int32),
                        rule.to(torch.int32), ml.to(torch.float32).view(torch.int32)])


def make_session_step(score_fn, cfg, head_fn, *, capacity: int, n_events: int,
                      min_events: int, flag_threshold: float, sketch: bool = False,
                      shadow: bool = False, plan=None):
    """The fused session step::

        step(params, sparams, table, flags, ring, cursor, length, idxs, sidx,
             occ, amounts, types, events, bl, thr, app)
          -> (packed [5, B] int32, ring, cursor, length)

    ``ring``, ``cursor`` and ``length`` are written in place and returned.
    ``idxs`` indexes the feature table (pad rows -> slot 0, scored and
    discarded); ``sidx`` the ring (pad rows -> the scratch slot
    ``capacity``); ``occ`` is the host's occurrence rank
    (:func:`occurrence_rank_host`); ``app`` the rows whose append is made
    (:func:`surviving_appends` of the real rows). Scoring: the
    ensemble runs unchanged; a row whose post-append window is warm (>=
    ``min_events``) and whose head probability reaches ``flag_threshold``
    has its ML score raised to that probability, the ``SESSION_PATTERN``
    bit set and score and action recombined; below the threshold a warm
    row's outputs equal the session-off step's. Cold rows never fold and
    carry ``SESSION_COLD``.

    ``sketch``/``shadow`` select a variant whose signature gains trailing
    ``(..., cand, n)`` and whose outputs extend to ``(packed, ring, cursor,
    length[, sketch][, shadow_packed])``: the drift sketch of the composed
    rows (``obs/drift.sketch_kernel`` over the first ``n``), and the
    candidate params ``cand`` scored on the same rows and folded with the
    same head probability, warm and cold rows as production, computed
    before the append; the head runs once and the ring is appended once.
    With a slot-sharding ``plan`` the ring, cursor and length are
    ``SlotShardedArray``s: the reads gather from the owners and the append
    and counts land on the owning shard only (a pad row's nowhere)."""
    from igaming_platform_tpu_torch.models.ensemble import ML_HIGH_RISK_BIT, combine
    from igaming_platform_tpu_torch.obs.drift import sketch_kernel
    from igaming_platform_tpu_torch.serve.device_cache import compose_rows

    def session_fold(out, sprob, fold, cold, thr):
        """One params' base outputs folded with the head's result; shared by
        production and the shadow (``sprob``, ``fold``, ``cold`` do not
        depend on the params)."""
        ml = out["ml_score"].to(torch.float32)
        ml2 = torch.where(fold, torch.maximum(ml, sprob), ml)
        # combine() is pure in (rule, ml, mask): strip the ML bit the base
        # pass derived from the unfolded ml and let combine re-derive it, so
        # an unfolded row reproduces the base outputs bit for bit.
        mask_base = out["reason_mask"] & ~(1 << ML_HIGH_RISK_BIT)
        final, action, mask = combine(out["rule_score"], ml2, mask_base, cfg, thr)
        mask = mask | torch.where(fold, 1 << SESSION_PATTERN_BIT, 0).to(mask.dtype)
        mask = mask | torch.where(cold, 1 << SESSION_COLD_BIT, 0).to(mask.dtype)
        return _stack(final, action, mask, out["rule_score"], ml2)

    def step(params, sparams, table, flags, ring, cursor, length, idxs, sidx, occ,
             amounts, types, events, bl, thr, app, cand=None, n=None):
        x, blv = compose_rows(table, flags, idxs, amounts, types, bl)
        out = score_fn(params, x, blv, thr)

        win, lp = build_windows(ring, cursor, length, sidx, events, n_events)
        sprob = head_fn(sparams, win, lp).to(torch.float32)
        real = sidx < capacity
        warm = torch.logical_and(lp >= min_events, real)
        fold = torch.logical_and(warm, sprob >= flag_threshold)
        cold = torch.logical_and(torch.logical_not(warm), real)
        packed = session_fold(out, sprob, fold, cold, thr)
        extra = []
        if sketch:
            extra.append(sketch_kernel(x, packed, n))
        if shadow:
            extra.append(session_fold(score_fn(cand, x, blv, thr), sprob, fold, cold, thr))

        # The append, after every read of the batch-start state above.
        wpos = torch.remainder(cursor.index_select(0, sidx) + occ, n_events)
        ones = torch.ones_like(sidx, dtype=cursor.dtype)
        if plan is not None:
            ring.put_rows_at(sidx.index_select(0, app), wpos.index_select(0, app),
                             events.index_select(0, app))
            cursor.index_add_(0, sidx, ones).apply_(lambda t: t.remainder_(n_events))
            length.index_add_(0, sidx, ones).apply_(lambda t: t.clamp_(max=n_events))
            return (packed, ring, cursor, length, *extra)
        ring[sidx.index_select(0, app), wpos.index_select(0, app)] = events.index_select(0, app)
        cursor.index_add_(0, sidx, ones).remainder_(n_events)
        length.index_add_(0, sidx, ones).clamp_(max=n_events)
        # The scratch slot stays empty, so a pad row never looks warm. Fill
        # kernels: ``cursor[capacity] = 0`` would copy a host scalar with a
        # blocking copy, which waits for the stream.
        cursor[capacity:].fill_(0)
        length[capacity:].fill_(0)
        return (packed, ring, cursor, length, *extra)

    return step


# ---------------------------------------------------------------------------
# Host session index + device ring manager


class _AcctSession:
    """Host-authoritative window of one account, in an append-only buffer
    (reallocated when full, never shifted in place), so snapshots can be
    handed out as stable numpy views. ``seq`` counts every event ever
    appended; the live window is the last ``min(seq, N)`` rows."""

    __slots__ = ("buf", "count", "seq", "last_ts")

    def __init__(self, n_events: int):
        self.buf = np.zeros((4 * n_events, EVENT_WIDTH), dtype=np.float32)
        self.count = 0
        self.seq = 0
        self.last_ts = 0.0

    def window_view(self, n_events: int) -> np.ndarray:
        k = min(self.seq, n_events)
        return self.buf[self.count - k:self.count]

    def append_rows(self, rows: np.ndarray, n_events: int, now: float) -> None:
        k = rows.shape[0]
        if self.count + k > self.buf.shape[0]:
            keep = min(self.count, n_events)
            nb = np.empty((max(4 * n_events, k + n_events), EVENT_WIDTH), dtype=np.float32)
            nb[:keep] = self.buf[self.count - keep:self.count]
            self.buf = nb  # old views (audit snapshots) keep the old buffer
            self.count = keep
        self.buf[self.count:self.count + k] = rows
        self.count += k
        self.seq += k
        self.last_ts = now


class SessionStateManager:
    """The engine's session plane: the device ring, the host index and the
    counts. Everything that writes either runs under ``lock``."""

    def __init__(self, capacity: int, *, device: str | torch.device = "cuda",
                 on_stream: Callable[[], Any] | None = None, mesh=None,
                 n_events: int | None = None, min_events: int | None = None,
                 flag_threshold: float | None = None, head: str | None = None,
                 metrics: Any = None):
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.n_events = int(n_events if n_events is not None else default_events())
        if self.n_events < 2:
            raise ValueError(f"SESSION_EVENTS must be >= 2, got {self.n_events}")
        self.min_events = int(min_events if min_events is not None else default_min_events())
        self.flag_threshold = float(
            flag_threshold if flag_threshold is not None else default_flag_threshold())
        self.head = (head or os.environ.get("SESSION_HEAD", "pattern")).lower()
        if self.head not in ("pattern", "transformer"):
            raise ValueError(f"SESSION_HEAD={self.head!r} not supported "
                             "(use 'pattern' or 'transformer')")
        self.head_params = (session_head_params(self.device) if self.head == "transformer"
                            else None)
        self.head_fn = (transformer_scores if self.head == "transformer"
                        else (lambda sparams, win, lp: pattern_scores(win, lp)))
        # The feature cache's plan (its capacity arrives rounded already).
        self.plan = plan_for(mesh)
        self.n_shards = 1 if self.plan is None else self.plan.n_shards
        self._on_stream = on_stream or contextlib.nullcontext

        self.lock = threading.RLock()
        self._twin: dict[str, _AcctSession] = {}

        self.appends = 0
        self.rehydrations = 0
        self.admissions = 0
        self.warm_rows = 0
        self.cold_rows = 0
        self.bypass_rows = 0
        self._metrics = metrics

        with self._on_stream():
            if self.plan is not None:
                self._ring_rows = self.capacity  # no scratch slot: pad rows vanish
                self.session_ring = self.plan.zeros(self.capacity, (self.n_events, EVENT_WIDTH))
                self.session_cursor = self.plan.zeros(self.capacity, (), torch.int32)
                self.session_length = self.plan.zeros(self.capacity, (), torch.int32)
            else:
                self._ring_rows = self.capacity + 1  # + the scratch slot
                self.session_ring = torch.zeros((self._ring_rows, self.n_events, EVENT_WIDTH),
                                                dtype=torch.float32, device=self.device)
                self.session_cursor = torch.zeros((self._ring_rows,), dtype=torch.int32,
                                                  device=self.device)
                self.session_length = torch.zeros((self._ring_rows,), dtype=torch.int32,
                                                  device=self.device)

    # -- surfaces -------------------------------------------------------------

    def bind_metrics(self, metrics: Any) -> None:
        """Attach a ServiceMetrics (``obs/metrics.py``); the counts so far
        are flushed into it at once."""
        if metrics is self._metrics:
            return
        self._metrics = metrics
        with self.lock:
            self._export(self.warm_rows, self.cold_rows, self.bypass_rows, self.appends,
                         self.rehydrations)

    def _export(self, warm: int, cold: int, bypass: int, appends: int,
                rehydrations: int) -> None:
        """The ``session_*`` counters' deltas and the ring's device bytes."""
        m = self._metrics
        if m is None:
            return
        for outcome, n in (("warm", warm), ("cold", cold), ("bypass", bypass)):
            if n:
                m.session_rows_total.inc(n, outcome=outcome)
        if appends:
            m.session_appends_total.inc(appends)
        if rehydrations:
            m.session_rehydrations_total.inc(rehydrations)
        m.session_hbm_bytes.set(self.hbm_bytes())
        for shard, b in enumerate(self.hbm_bytes_per_shard()):
            m.hbm_bytes.set(b, shard=str(shard), table="session_ring")

    def hbm_bytes(self) -> int:
        return sum(self.hbm_bytes_per_shard())

    def hbm_bytes_per_shard(self) -> list[int]:
        """Each shard's device bytes of ring, cursor and length (a sharded
        layout's shards each hold one scratch row past their slots)."""
        return [r + c + n for r, c, n in zip(per_shard_nbytes(self.session_ring),
                                             per_shard_nbytes(self.session_cursor),
                                             per_shard_nbytes(self.session_length))]

    def shard_stats(self) -> dict:
        rows = self._ring_rows // self.n_shards if self.plan is not None else self._ring_rows
        return {"sharded": self.plan is not None, "shards": self.n_shards,
                "rows_per_shard": rows, "hbm_bytes": self.hbm_bytes_per_shard()}

    def ring_state(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(ring, cursor, length) of every slot, gathered in slot order (the
        unsharded layout's scratch slot left out)."""
        with self.lock, self._on_stream():
            if self.plan is not None:
                return (self.session_ring.full(), self.session_cursor.full(),
                        self.session_length.full())
            c = self.capacity
            return self.session_ring[:c], self.session_cursor[:c], self.session_length[:c]

    def snapshot(self) -> dict:
        """The /debug/sessionz payload."""
        with self.lock:
            return {
                "enabled": True,
                "head": self.head,
                "capacity": self.capacity,
                "n_events": self.n_events,
                "min_events": self.min_events,
                "flag_threshold": self.flag_threshold,
                "accounts_tracked": len(self._twin),
                "hbm_bytes": self.hbm_bytes(),
                "appends": self.appends,
                "rehydrations": self.rehydrations,
                "admissions": self.admissions,
                "rows": {"warm": self.warm_rows, "cold": self.cold_rows,
                         "bypass": self.bypass_rows},
                "sharding": self.shard_stats(),
            }

    def note_bypass(self, n: int) -> None:
        """Rows scored on a non-session path (row wire mode, batcher) while
        session state is on: counted, never silently unsessioned."""
        with self.lock:
            self.bypass_rows += n
            self._export(0, 0, n, 0, 0)

    # -- admission sync (the cache's CLOCK decides) ---------------------------

    def on_admit(self, account_ids, slots) -> None:
        """The cache's admission hook: each admitted slot gets its account's
        window from the host index (rehydration), or a clean one (cursor 0,
        length 0) for an account never seen, copied in place on the engine's
        stream."""
        k = len(slots)
        if k == 0:
            return
        with self.lock:
            w = np.zeros((k, self.n_events, EVENT_WIDTH), dtype=np.float32)
            lens = np.zeros((k,), dtype=np.int32)
            rehydrated = 0
            for i, raw in enumerate(account_ids):
                a = raw if isinstance(raw, str) else bytes(raw).decode()
                tw = self._twin.get(a)
                if tw is not None and tw.seq > 0:
                    win = tw.window_view(self.n_events)
                    w[i, :win.shape[0]] = win
                    lens[i] = win.shape[0]
                    rehydrated += 1
            cursors = np.mod(lens, self.n_events).astype(np.int32)
            dev = self.device
            # A launch between steps, counted like one (it shows only when
            # accounts are admitted).
            from igaming_platform_tpu_torch.serve.scorer import _device_dispatch

            mark = _device_dispatch("session_sync", (k, self.n_events), np.float32, dev)
            with self._on_stream(), mark:
                # One lookup admits a slot once: the copies have no duplicates.
                s = host_to_device(np.asarray(slots, dtype=np.int64), dev)
                self.session_ring.index_copy_(0, s, host_to_device(w, dev))
                self.session_cursor.index_copy_(0, s, host_to_device(cursors, dev))
                self.session_length.index_copy_(0, s, host_to_device(lens, dev))
            self.admissions += k
            self.rehydrations += rehydrated
            self._export(0, 0, 0, 0, rehydrated)

    # -- the append path ------------------------------------------------------

    def prepare_chunk(self, account_ids, amounts, tx_codes, now: float):
        """Under ``lock``: encode the chunk's events, compute each row's
        post-append window length, occurrence rank and event sequence number
        from the host index (duplicate accounts all see the chunk-start
        state), then commit the events to the index in row order. The
        caller launches the fused step, which applies the same semantics to
        the device ring, before it releases the lock.

        Returns (events [B, EVENT_WIDTH] f32, occ [B] i32, post_len [B] i32,
        seqs [B] i64, audit)."""
        b = len(account_ids)
        n_ev = self.n_events
        twin = self._twin
        uniq: dict[str, int] = {}
        uidx = np.empty((b,), np.int64)
        utw: list[_AcctSession] = []
        snaps: list[tuple[np.ndarray, int]] = []
        useq: list[int] = []
        ulast: list[float] = []
        for i, raw in enumerate(account_ids):
            a = raw if isinstance(raw, str) else bytes(raw).decode()
            u = uniq.get(a)
            if u is None:
                u = len(uniq)
                uniq[a] = u
                tw = twin.get(a)
                if tw is None:
                    tw = _AcctSession(n_ev)
                    twin[a] = tw
                utw.append(tw)
                snaps.append((tw.buf, tw.count))
                useq.append(tw.seq)
                ulast.append(tw.last_ts)
            uidx[i] = u
        seq0 = np.asarray(useq, np.int64)[uidx]
        last0 = np.asarray(ulast, np.float64)[uidx]
        occ = occurrence_rank_host(uidx)
        seqs = seq0 + occ + 1
        post_len = (np.minimum(seq0, n_ev - 1) + 1).astype(np.int32)
        dts = np.where(seq0 > 0, np.maximum(0.0, now - last0), 0.0)
        events = encode_events_host(amounts, tx_codes, dts)
        audit = SessionChunkAudit(events, post_len, uidx, snaps)

        # Commit per unique account, rows in chunk order.
        if len(utw) == b:
            for i in range(b):
                utw[i].append_rows(events[i:i + 1], n_ev, now)
        else:
            order = np.argsort(uidx, kind="stable")
            sorted_u = uidx[order]
            starts = np.flatnonzero(np.concatenate(([True], sorted_u[1:] != sorted_u[:-1])))
            bounds = np.append(starts, b)
            for r in range(len(starts)):
                rows = order[bounds[r]:bounds[r + 1]]
                utw[int(sorted_u[bounds[r]])].append_rows(events[rows], n_ev, now)
        warm = int(np.count_nonzero(post_len >= self.min_events))
        self.appends += b
        self.warm_rows += warm
        self.cold_rows += b - warm
        self._export(warm, b - warm, 0, b, 0)
        return events, occ, post_len, seqs, audit

    def adopt(self, ring, cursor, length) -> None:
        """Bind the step's ring state as the live one (the step writes in
        place and returns the same tensors; the caller holds ``lock``)."""
        self.session_ring = ring
        self.session_cursor = cursor
        self.session_length = length

    # -- test and debug helpers -----------------------------------------------

    def twin_window(self, account_id: str) -> np.ndarray:
        """The host index's window of one account ([count, D], in order)."""
        with self.lock:
            tw = self._twin.get(account_id)
            if tw is None:
                return np.zeros((0, EVENT_WIDTH), np.float32)
            return tw.window_view(self.n_events).copy()

    def twin_meta(self, account_id: str) -> dict:
        with self.lock:
            tw = self._twin.get(account_id)
            if tw is None:
                return {"count": 0, "seq": 0, "last_ts": 0.0}
            return {"count": min(tw.seq, self.n_events), "seq": tw.seq,
                    "last_ts": tw.last_ts}

    def device_window(self, slot: int) -> np.ndarray:
        """The ring's window of one slot ([length, D], in order), read back."""
        with self.lock, self._on_stream():
            if self.plan is not None:
                at = torch.tensor([slot], dtype=torch.int64, device=self.device)
                ring = self.session_ring.gather(at)[0].cpu().numpy()
                cur = int(self.session_cursor.gather(at)[0])
                ln = int(self.session_length.gather(at)[0])
            else:
                ring = self.session_ring[slot].cpu().numpy()
                cur = int(self.session_cursor[slot])
                ln = int(self.session_length[slot])
        pos = [(cur - ln + k) % self.n_events for k in range(ln)]
        return ring[pos]
