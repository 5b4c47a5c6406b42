"""The native (C++) feature store over ctypes: the host gather of the serving front.

The port's counterpart of ``igaming_platform_tpu/serve/native_store.py``.
``NativeFeatureStore`` has the ``InMemoryFeatureStore`` interface
(``serve/feature_store.py``: sliding windows, HLL cardinalities, TTL'd
sums, sessions, batch aggregates, blacklists) with the per-event update and
the [B, 30] gather run in C++ (``native/feature_store.cpp``, built by
``serve/_native_build.py``). ``decode_gather`` turns risk.v1
ScoreBatchRequest bytes into the [N, 30] matrix and the blacklist flags in
one call, with no per-row Python object.

String account ids map to dense indices inside the library; device and IP
strings hash to stable 64-bit values (blake2b, as ``serve/hll.py``). Every
gather takes ``now``; the store's ``clock`` stands in wherever a call gives
no time, so that a caller can pin it for a whole run. Every write calls
``delta_listener`` (when set) with the account id, as the Python store
does. A library that does not build raises: nothing falls back to the
Python store.
"""

from __future__ import annotations

import ctypes
import hashlib
import time
from typing import Callable

import numpy as np

from igaming_platform_tpu_torch.core.features import NUM_FEATURES, F
from igaming_platform_tpu_torch.serve import _native_build
from igaming_platform_tpu_torch.serve.wire import TX_TYPE_CODES

_hash_cache: dict[str, int] = {}


def _hash64(value: str) -> int:
    if not value:
        return 0
    h = _hash_cache.get(value)
    if h is None:
        h = int.from_bytes(hashlib.blake2b(value.encode(), digest_size=8).digest(), "little")
        h = h or 1  # 0 means "absent" on the C side
        if len(_hash_cache) < 1_000_000:
            _hash_cache[value] = h
    return h


def _bind(lib):
    lib.fs_create.restype = ctypes.c_void_p
    lib.fs_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fs_destroy.argtypes = [ctypes.c_void_p]
    lib.fs_capacity.restype = ctypes.c_int
    lib.fs_capacity.argtypes = [ctypes.c_void_p]
    lib.fs_update.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_int64,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64,
    ]
    lib.fs_update_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
    ]
    lib.fs_record_bonus.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
    lib.fs_load_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_double,
    ]
    lib.fs_velocity.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.POINTER(ctypes.c_int)
    ]
    lib.fs_fill_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_double,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
    ]
    lib.fs_resolve.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    lib.fs_num_accounts.restype = ctypes.c_int
    lib.fs_num_accounts.argtypes = [ctypes.c_void_p]
    lib.fs_blacklist_add.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int32
    ]
    lib.fs_wire_count.restype = ctypes.c_int64
    lib.fs_wire_count.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.fs_decode_gather.restype = ctypes.c_int64
    lib.fs_decode_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_double,
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int,
    ]
    return lib


_lib = None


def _library():
    """The bound library, built on first use; raises if it does not build."""
    global _lib
    if _lib is None:
        _lib = _bind(_native_build.load("feature_store"))
    return _lib


class NativeFeatureStore:
    """C++-backed feature store with the InMemoryFeatureStore interface."""

    def __init__(self, max_accounts: int = 1_000_000, history_capacity: int = 128,
                 hll_precision: int = 10, clock: Callable[[], float] = time.time):
        self._lib = _library()
        self._clock = clock
        self._handle = self._lib.fs_create(max_accounts, history_capacity, hll_precision)
        self._max_accounts = max_accounts
        # Python mirror for the string check_blacklist() API; the native
        # sets (fs_blacklist_add) are the ones the wire decoder consults.
        self._blacklists: dict[str, set[str]] = {"device": set(), "ip": set(), "fingerprint": set()}
        self._bl_codes = {"device": 0, "ip": 1, "fingerprint": 2}
        # Write-back hook of the device feature cache (see
        # InMemoryFeatureStore.delta_listener).
        self.delta_listener = None

    @property
    def clock(self) -> Callable[[], float]:
        return self._clock

    def _emit_delta(self, account_id: str) -> None:
        if self.delta_listener is not None:
            self.delta_listener(account_id)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.fs_destroy(handle)
            self._handle = None

    def _resolve_many(self, account_ids, create: bool = True) -> np.ndarray:
        """Batch string -> index resolution in ONE native call. The id map
        lives in C++, so the wire decoder and this path agree on every
        account's index."""
        n = len(account_ids)
        encoded = [a.encode() if isinstance(a, str) else bytes(a) for a in account_ids]
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(e) for e in encoded], out=offs[1:])
        out = np.empty(n, dtype=np.int32)
        self._lib.fs_resolve(self._handle, n, b"".join(encoded), offs, 1 if create else 0, out)
        return out

    def _idx(self, account_id: str, create: bool = True) -> int:
        return int(self._resolve_many([account_id], create)[0])

    # -- writes -------------------------------------------------------------

    def update(self, event) -> None:
        idx = self._idx(event.account_id)
        if idx < 0:
            return
        self._lib.fs_update(
            self._handle, idx, event.timestamp or self._clock(), int(event.amount),
            TX_TYPE_CODES.get(event.tx_type, 4),
            _hash64(event.device_id), _hash64(event.ip),
        )
        self._emit_delta(event.account_id)

    def update_batch(self, events) -> None:
        """Batched ingest: one native call for a whole event chunk."""
        events = list(events)
        if not events:
            return
        self.update_columns([e.account_id for e in events], [e.amount for e in events],
                            [e.tx_type for e in events], [e.ip for e in events],
                            [e.device_id for e in events], [e.timestamp for e in events])

    def load_batch_features(
        self, account_id: str, *,
        total_deposits: int = 0, total_withdrawals: int = 0,
        deposit_count: int = 0, withdraw_count: int = 0,
        total_bets: int = 0, total_wins: int = 0,
        bet_count: int = 0, win_count: int = 0,
        bonus_claim_count: int | None = None,
        created_at: float | None = None,
    ) -> None:
        """Bulk-overwrite the batch aggregates; the realtime windows stay."""
        self._lib.fs_load_batch(
            self._handle, self._idx(account_id),
            total_deposits, total_withdrawals, deposit_count, withdraw_count,
            total_bets, total_wins, bet_count, win_count,
            -1 if bonus_claim_count is None else bonus_claim_count,
            -1.0 if created_at is None else created_at,
        )
        self._emit_delta(account_id)

    def record_bonus_claim(self, account_id: str, wager_complete_rate: float | None = None) -> None:
        idx = self._idx(account_id)
        if idx >= 0:
            rate = -1.0 if wager_complete_rate is None else float(wager_complete_rate)
            self._lib.fs_record_bonus(self._handle, idx, rate)
            self._emit_delta(account_id)

    # -- reads --------------------------------------------------------------

    def velocity(self, account_id: str, now: float | None = None) -> tuple[int, int, int]:
        idx = self._idx(account_id, create=False)
        if idx < 0:
            return (0, 0, 0)
        out = (ctypes.c_int * 3)()
        self._lib.fs_velocity(self._handle, idx, now or self._clock(), out)
        return (out[0], out[1], out[2])

    def check_rate_limit(self, account_id: str, max_per_min: int, max_per_hour: int) -> bool:
        c1, _, ch = self.velocity(account_id)
        return c1 >= max_per_min or ch >= max_per_hour

    # -- blacklist (host-side sets; set membership isn't the hot path) ------

    def add_to_blacklist(self, list_type: str, value: str) -> None:
        if list_type not in self._blacklists:
            raise ValueError(f"unknown blacklist type: {list_type}")
        self._blacklists[list_type].add(value)
        raw = value.encode()
        self._lib.fs_blacklist_add(self._handle, self._bl_codes[list_type], raw, len(raw))

    def check_blacklist(self, device_id: str = "", fingerprint: str = "", ip: str = "") -> bool:
        return (
            (bool(device_id) and device_id in self._blacklists["device"])
            or (bool(fingerprint) and fingerprint in self._blacklists["fingerprint"])
            or (bool(ip) and ip in self._blacklists["ip"])
        )

    # -- batch assembly ------------------------------------------------------

    def fill_row(self, out: np.ndarray, account_id: str, amount: int, tx_type: str,
                 now: float | None = None) -> None:
        rows = np.zeros((1, NUM_FEATURES), dtype=np.float32)
        self._fill(rows, [account_id], [amount], [tx_type], now)
        out[:] = rows[0]

    def _fill(self, out: np.ndarray, account_ids, amounts, tx_types, now=None) -> None:
        n = out.shape[0]
        idxs = self._resolve_many(account_ids, create=False)
        amts = np.asarray(amounts, dtype=np.int64)
        types = np.fromiter((TX_TYPE_CODES.get(t, 4) for t in tx_types), np.int32, n)
        self._lib.fs_fill_rows(self._handle, n, idxs, amts, types, now or self._clock(), out)

    def gather_batch(self, requests, now: float | None = None):
        """Requests -> ([N, 30] float32, [N] bool blacklisted)."""
        reqs = list(requests)
        x = np.zeros((len(reqs), NUM_FEATURES), dtype=np.float32)
        self._fill(x, [r.account_id for r in reqs], [r.amount for r in reqs],
                   [r.tx_type for r in reqs], now)
        bl = np.zeros((len(reqs),), dtype=bool)
        for i, r in enumerate(reqs):
            ip_flags = getattr(r, "ip_flags", None)
            if ip_flags is not None:
                x[i, F.IS_VPN] = float(ip_flags[0])
                x[i, F.IS_PROXY] = float(ip_flags[1])
                x[i, F.IS_TOR] = float(ip_flags[2])
            bl[i] = self.check_blacklist(
                getattr(r, "device_id", ""), getattr(r, "fingerprint", ""), getattr(r, "ip", "")
            )
        return x, bl

    # -- columnar fast path (replay/ingest: no per-row request objects) ------

    def gather_columns(self, account_ids, amounts, tx_types,
                       ips=None, devices=None, fingerprints=None,
                       now: float | None = None):
        """[B, 30] gather straight from parallel columns; the blacklist
        check covers the same three keys as check_blacklist."""
        n = len(account_ids)
        x = np.zeros((n, NUM_FEATURES), dtype=np.float32)
        self._fill(x, account_ids, amounts, tx_types, now)
        bl = np.zeros((n,), dtype=bool)
        if any(self._blacklists.values()):
            for i in range(n):
                bl[i] = self.check_blacklist(
                    devices[i] if devices is not None else "",
                    fingerprints[i] if fingerprints is not None else "",
                    ips[i] if ips is not None else "",
                )
        return x, bl

    def update_columns(self, account_ids, amounts, tx_types, ips, devices, timestamps) -> None:
        """Batched ingest from parallel columns: one native call. An unset
        (zero) timestamp takes the clock, as ``update`` does."""
        n = len(account_ids)
        if n == 0:
            return
        idxs = self._resolve_many(account_ids)
        ts = np.asarray(timestamps, dtype=np.float64)
        if (ts == 0).any():
            ts = np.where(ts == 0, self._clock(), ts)
        amts = np.fromiter(amounts, np.int64, n)
        types = np.fromiter((TX_TYPE_CODES.get(t, 4) for t in tx_types), np.int32, n)
        dev = np.fromiter((_hash64(d) for d in devices), np.uint64, n)
        ip = np.fromiter((_hash64(i) for i in ips), np.uint64, n)
        self._lib.fs_update_batch(self._handle, n, idxs, ts, amts, types, dev, ip)
        if self.delta_listener is not None:
            for a in account_ids:
                self._emit_delta(a)

    def num_accounts(self) -> int:
        return int(self._lib.fs_num_accounts(self._handle))

    # -- native wire decode (ScoreBatchRequest bytes -> gather matrix) -------

    def decode_gather(
        self, payload: bytes, now: float | None = None, create: bool = False
    ) -> tuple[np.ndarray, np.ndarray]:
        """risk.v1 ScoreBatchRequest wire bytes -> ([N, 30] float32, [N]
        bool blacklisted) in one native call: no Python protobuf parse, no
        per-row host object. Raises ValueError on a malformed request."""
        n = self._lib.fs_wire_count(payload, len(payload))
        if n < 0:
            raise ValueError("malformed ScoreBatchRequest")
        x = np.zeros((int(n), NUM_FEATURES), dtype=np.float32)
        bl = np.zeros((int(n),), dtype=np.uint8)
        if n == 0:
            return x, bl.astype(bool)
        rc = self._lib.fs_decode_gather(
            self._handle, payload, len(payload), now or self._clock(),
            int(n), x, bl, 1 if create else 0,
        )
        if rc < 0:
            raise ValueError(f"malformed ScoreBatchRequest (rc={rc})")
        return x[:rc], bl[:rc].astype(bool)


def best_feature_store(**kwargs) -> NativeFeatureStore:
    """The serving store: the native one. Raises if its library does not
    build (the port keeps no Python fallback behind the server)."""
    return NativeFeatureStore(**kwargs)
