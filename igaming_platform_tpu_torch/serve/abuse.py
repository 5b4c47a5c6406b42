"""Bonus-abuse detection service: a sequence model over event histories.

The port's counterpart of ``igaming_platform_tpu/serve/abuse.py``.
Per-player event histories are kept in fixed-size ring buffers, encoded with
``models/sequence.py::encode_event`` and scored in [B, S, EVENT_DIM] batches
by the transformer on the detector's device; device sharing links accounts
for the MULTI_ACCOUNT signal (risk.proto reason codes). Every ``check`` and
``check_batch`` of the ``model`` policy is one forward pass, which launches
the flash-attention kernel once per layer on a CUDA device
(``device_steps`` counts the passes).

With ``mesh=`` and ``seq_mode="ring"`` or ``"ulysses"`` the attention
shards the batch over ``data`` and each history over ``seq``
(``models/sequence.sharded_attention``); the batch pads to a multiple of
the ``data`` axis and the padding is cut off the scores. Without a mesh
the mode is ``dense``.
"""

from __future__ import annotations

import copy
import threading
import time
from collections import deque

import numpy as np
import torch

from igaming_platform_tpu_torch.core.device import resolve_device
from igaming_platform_tpu_torch.models.sequence import (
    EVENT_DIM,
    TX_TYPE_INDEX,
    SeqConfig,
    SequenceModel,
    abuse_signals,
    encode_event,
    init_sequence_model,
)


class AbuseShed(RuntimeError):
    """Raised when the abuse path sheds load instead of serving a
    degraded score (``policy="shed"``). A serving layer maps it to
    UNAVAILABLE: loud, countable, never a silently different answer."""


class SequenceAbuseDetector:
    """Per-account event history + transformer scoring + device linking.

    ``policy`` selects the scoring path:

    - ``"model"`` (default): the sequence transformer on ``device``;
    - ``"heuristic"``: scalar pattern-matching over the same ring buffers
      (numpy, no device), for deployments without a card; responses carry
      a DEGRADED_CPU_HEURISTIC signal;
    - ``"shed"``: refuse with :class:`AbuseShed`.

    ``params`` is a ``SequenceModel`` (``convert.sequence_from_tree`` makes
    one from JAX params). The default is ``init_sequence_model(cfg, seed=0)``,
    drawn from a torch generator: not the JAX package's ``key(0)`` weights.
    """

    def __init__(
        self,
        params: SequenceModel | None = None,
        cfg: SeqConfig | None = None,
        *,
        max_history: int = 256,
        threshold: float = 0.5,
        policy: str = "model",
        device: str | torch.device = "cuda",
        mesh=None,
        seq_mode: str = "dense",
    ):
        if policy not in ("model", "heuristic", "shed"):
            raise ValueError(f"unknown abuse policy: {policy!r}")
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self.mesh = mesh
        self.seq_mode = seq_mode if mesh is not None else "dense"
        if self.seq_mode not in ("dense", "ring", "ulysses"):
            raise ValueError(f"unknown seq_mode: {seq_mode}")
        self._batch_multiple = (int(mesh.shape["data"])
                                if mesh is not None and self.seq_mode != "dense" else 1)
        # 2 heads of 32, as the JAX detector serves.
        self.cfg = cfg or SeqConfig(d_model=64, n_heads=2, n_layers=2, d_ff=128)
        self.params = self._install(
            params if params is not None else init_sequence_model(self.cfg, seed=0))
        self.max_history = max_history
        self.threshold = threshold
        self.policy = policy
        self._histories: dict[str, deque] = {}
        self._last_ts: dict[str, float] = {}
        self._device_accounts: dict[str, set[str]] = {}
        self._account_devices: dict[str, set[str]] = {}
        self._lock = threading.RLock()
        # Forward passes run (each launches the attention kernel once per
        # layer on a CUDA device); read by tests and the chip smoke.
        self.device_steps = 0

    def _install(self, model: SequenceModel) -> SequenceModel:
        if model.cfg != self.cfg:
            raise ValueError(f"params are for {model.cfg}, the detector serves {self.cfg}")
        # A model fresh from training brings trainable params and maybe their
        # gradients: the serving copy holds neither.
        served = copy.deepcopy(model).to(self.device).eval()
        for p in served.parameters():
            p.grad = None
            p.requires_grad_(False)
        return served

    # -- ingestion -----------------------------------------------------------

    def record_event(
        self, account_id: str, amount: int, tx_type: str,
        game_weight: float = 1.0, balance_ratio: float = 0.0,
        device_id: str = "", timestamp: float | None = None,
    ) -> None:
        now = timestamp or time.time()
        with self._lock:
            dt = now - self._last_ts.get(account_id, now)
            self._last_ts[account_id] = now
            hist = self._histories.setdefault(account_id, deque(maxlen=self.max_history))
            hist.append(encode_event(amount, dt, tx_type, game_weight, balance_ratio))
            if device_id:
                self._device_accounts.setdefault(device_id, set()).add(account_id)
                self._account_devices.setdefault(account_id, set()).add(device_id)

    def history_length(self, account_id: str) -> int:
        with self._lock:
            return len(self._histories.get(account_id, ()))

    # -- scoring -------------------------------------------------------------

    def _history_matrix(self, account_ids: list[str], seq_len: int) -> np.ndarray:
        x = np.zeros((len(account_ids), seq_len, EVENT_DIM), dtype=np.float32)
        with self._lock:
            for i, acct in enumerate(account_ids):
                hist = self._histories.get(acct)
                if not hist:
                    continue
                events = list(hist)[-seq_len:]
                x[i, -len(events):] = np.stack(events)  # right-aligned, left-padded
        return x

    def check(self, account_id: str, bonus_id: str = "") -> tuple[float, list[str], list[str]]:
        """(abuse_score, signals, linked_accounts): the CheckBonusAbuse
        contract (risk.proto:140-145)."""
        if self.policy == "heuristic":
            score, signals = self._heuristic_one(account_id)
        else:
            scores = self.check_batch([account_id])
            score = float(scores[0])
            signals = abuse_signals(score, self.threshold)
        linked = self.linked_accounts(account_id)
        if linked:
            signals.append("MULTI_ACCOUNT")
        return score, signals, linked

    def check_batch(self, account_ids: list[str], seq_len: int | None = None) -> np.ndarray:
        if self.policy == "shed":
            raise AbuseShed("abuse scoring shed: sequence model unavailable "
                            "on this deployment (policy=shed)")
        if self.policy == "heuristic":
            return np.array(
                [self._heuristic_one(a)[0] for a in account_ids], dtype=np.float32
            )
        if not account_ids:
            return np.zeros((0,), dtype=np.float32)
        seq_len = seq_len or min(self.max_history, 64)
        from igaming_platform_tpu_torch.serve.scorer import _device_dispatch

        hist = self._history_matrix(account_ids, seq_len)
        n = hist.shape[0]
        if n % self._batch_multiple:
            # On a mesh the batch shards over ``data``: pad, score, cut.
            padded = -(-n // self._batch_multiple) * self._batch_multiple
            hist = np.concatenate([hist, np.zeros((padded - n, *hist.shape[1:]), hist.dtype)])
        mark = _device_dispatch("abuse_seq_step", hist.shape, hist.dtype, self.device)
        model = self.params  # one read: a concurrent swap_params lands whole
        with torch.inference_mode(), mark:
            x = torch.from_numpy(hist).to(self.device)
            abuse = model(x, self.mesh, self.seq_mode)["abuse"]
        with self._lock:
            self.device_steps += 1
        return abuse[:n].cpu().numpy()

    def _heuristic_one(self, account_id: str) -> tuple[float, list[str]]:
        """Scalar pattern-matching over the encoded ring buffer, the
        reference's own abuse signal class (engine.go:462-466), kept as
        the no-card scorer. O(history) numpy, no device."""
        with self._lock:
            hist = self._histories.get(account_id)
            h = np.stack(hist) if hist else None
        signals = ["DEGRADED_CPU_HEURISTIC"]
        if h is None or not len(h):
            return 0.0, signals
        dt_s = np.expm1(h[:, 1])  # encode_event stores log1p(dt)
        types = h[:, 2:10]
        # First event's dt is a 0 placeholder (no predecessor), not a
        # rapid-fire gap: a single ordinary deposit must not look fast.
        rapid = float(np.mean(dt_s[1:] < 30.0)) if len(dt_s) > 1 else 0.0
        bonus_frac = float(
            types[:, TX_TYPE_INDEX["bonus_grant"]].mean()
            + types[:, TX_TYPE_INDEX["bonus_wager"]].mean()
        )
        gi = np.flatnonzero(types[:, TX_TYPE_INDEX["bonus_grant"]] > 0)
        wi = np.flatnonzero(types[:, TX_TYPE_INDEX["withdraw"]] > 0)
        quick_cashout = 0.0
        if gi.size and wi.size:
            # Wall-clock from grant to a later withdraw (< 1 h = abuse
            # shape: grant -> burn wagering -> cash out), via cumulative
            # inter-event time: event-count gaps would miss a grant
            # followed by many rapid wagers.
            t = np.cumsum(dt_s)
            gap_s = t[wi[None, :]] - t[gi[:, None]]
            after = wi[None, :] > gi[:, None]
            quick_cashout = float((after & (gap_s < 3600.0)).any())
        low_weight = float(
            np.mean((h[:, 10] < 0.2) & (types[:, TX_TYPE_INDEX["bonus_wager"]] > 0))
        )
        score = float(min(
            1.0,
            0.45 * rapid + 0.6 * bonus_frac + 0.35 * quick_cashout + 0.3 * low_weight,
        ))
        if rapid > 0.5:
            signals.append("RAPID_FIRE_WAGERING")
        if bonus_frac > 0.5:
            signals.append("BONUS_ONLY_PLAYER")
        if quick_cashout:
            signals.append("QUICK_BONUS_CASHOUT")
        if low_weight > 0.3:
            signals.append("LOW_WEIGHT_GAME_FOCUS")
        if score >= self.threshold:
            signals.append("SEQUENCE_MODEL_HIGH_RISK")
        return score, signals

    def is_abuser(self, account_id: str) -> bool:
        """BonusEngine RiskChecker seam (bonus_engine.go:139-141)."""
        score, _, _ = self.check(account_id)
        return score >= self.threshold

    # -- linking -------------------------------------------------------------

    def linked_accounts(self, account_id: str) -> list[str]:
        """Accounts sharing any device with this one (MULTI_ACCOUNT)."""
        with self._lock:
            linked: set[str] = set()
            for device in self._account_devices.get(account_id, ()):
                linked |= self._device_accounts.get(device, set())
            linked.discard(account_id)
            return sorted(linked)

    def swap_params(self, params: SequenceModel) -> None:
        """Install new params (copied to the device before the swap)."""
        self.params = self._install(params)
