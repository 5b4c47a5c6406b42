"""Gated promotion with instant rollback, and the params vault.

Counterpart of ``igaming_platform_tpu/train/promote.py``. A model change in
a fraud stack is gated, attributable and instantly reversible:

- **Gated**: ``PromotionController`` promotes a candidate only when every
  gate of ``train/gates.py`` passes: labelled-probe quality
  (``QualityProbe``: a floor, and no regression against the last-known-good
  params), live shadow evidence (enough rows, a flip rate under the bound;
  ``serve/shadow.py``), a quiet SLO plane and a quiet drift plane
  (``obs/drift.py``).
- **Attributable**: every promotion and rollback appends a
  ``PromotionRecord`` to the decision WAL with both params fingerprints and
  the gate table, and the promoted tree is stored in the params vault under
  its fingerprint, so ``tools/replay.py`` re-scores decisions taken across
  the boundary with the params that took them.
- **Reversible**: the swap rides the engine's ``swap_params``, and the
  controller keeps the last-known-good tree: a failing post-promotion gate
  rolls back within one tick.

Operator knobs: ``force_promote``, ``force_rollback``, ``pause``/``resume``
and the drill-only ``inject_regression`` (the served fraud head negated,
through the same seam, to rehearse the auto-rollback).

The SLO gates read ``slo_engine=``, any object with ``alerts_active() ->
{"fast", "slow"}`` (``obs/slo.SLOEngine`` is one); with none given they read
quiet, and the server does not bind the process's SLO engine yet
(``ROADMAP.md``). ``metrics=`` (an ``obs/metrics.py`` ``ServiceMetrics``)
feeds the ``promotion_*`` counters.

The vault: the JAX vault keeps an Orbax checkpoint per fingerprint; Orbax
is on neither machine the port runs on, so ``<vault>/<fp>.npz`` holds the
engine's installed tree, one array per ``key.name`` in the order
``serve/scorer.py::params_fingerprint`` walks it, and the backend's name
(``__backend__``). Loading rebuilds the same modules on the CPU, and an
entry whose rebuilt tree does not hash to its name raises.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from igaming_platform_tpu_torch.models.mlp import MLP, Dense
from igaming_platform_tpu_torch.models.multitask import MultiTask, fraud_predict
from igaming_platform_tpu_torch.obs import drift as drift_mod
from igaming_platform_tpu_torch.ops.quantize import QuantizedDense, QuantizedMLP
from igaming_platform_tpu_torch.serve import ledger as ledger_mod
from igaming_platform_tpu_torch.serve.scorer import params_fingerprint
from igaming_platform_tpu_torch.train import gates as gates_mod

logger = logging.getLogger(__name__)

_BACKEND = "__backend__"


def _entry(vault_dir: str, fp: str) -> str:
    return os.path.join(os.path.abspath(vault_dir), f"{fp}.npz")


def vault_save(vault_dir: str, params: Any, ml_backend: str) -> str:
    """Store a serving param tree under its fingerprint; returns the
    fingerprint. Idempotent: an existing entry is left in place."""
    fp = params_fingerprint(params)
    path = _entry(vault_dir, fp)
    if os.path.exists(path):
        return fp
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrays = {_BACKEND: np.array(ml_backend)}
    for key in sorted(params or {}):
        value = params[key]
        tensors = value.state_dict() if hasattr(value, "state_dict") else value
        for name, t in tensors.items():
            arrays[f"{key}.{name}"] = t.detach().cpu().numpy()
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # a reader sees the whole entry or none
    return fp


def _layers(t: dict, prefix: str) -> list[int]:
    return sorted({int(k[len(prefix):].split(".")[0]) for k in t if k.startswith(prefix)})


def _dense(t: dict, p: str) -> Dense:
    return Dense(t[f"{p}w_bf16"], t[f"{p}b"])


def _quantized(t: dict) -> QuantizedMLP:
    return QuantizedMLP(
        [QuantizedDense(t[f"layers.{i}.wq"].numpy(), t[f"layers.{i}.scale"].numpy(),
                        t[f"layers.{i}.b"].numpy()) for i in _layers(t, "layers.")],
        t["input_scale"].numpy() if "input_scale" in t else None)


# How each params key's tree is rebuilt from its tensors (a forest stays a
# dict of tensors). Dense keeps the bf16 rounding of its weight, and
# rounding it again changes nothing.
_REBUILD = {
    "mlp": lambda t: MLP([_dense(t, f"layers.{i}.") for i in _layers(t, "layers.")]),
    "multitask": lambda t: MultiTask([_dense(t, f"trunk.{i}.") for i in _layers(t, "trunk.")],
                                     _dense(t, "fraud_head."), _dense(t, "ltv_head."),
                                     _dense(t, "churn_head.")),
    "mlp_int8": _quantized,
    "multitask_int8": _quantized,
}


def vault_load(vault_dir: str, fp: str, ml_backend: str | None = None) -> Any | None:
    """The param tree stored under ``fp``, on the CPU, or None when the
    vault has no such entry. Raises ValueError when the entry is another
    backend's than ``ml_backend`` or its rebuilt tree's fingerprint is not
    ``fp`` (a corrupt or tampered entry)."""
    path = _entry(vault_dir, fp)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        backend = str(z[_BACKEND])
        grouped: dict[str, dict[str, torch.Tensor]] = {}
        for name in z.files:
            if name != _BACKEND:
                key, _, rest = name.partition(".")
                grouped.setdefault(key, {})[rest] = torch.from_numpy(z[name].copy())
    if ml_backend is not None and backend != ml_backend:
        raise ValueError(f"params vault entry {fp} holds {backend!r} params, not {ml_backend!r}")
    params = {key: _REBUILD[key](t) if key in _REBUILD else t for key, t in grouped.items()}
    got = params_fingerprint(params or None)
    if got != fp:
        raise ValueError(f"params vault entry {fp} rebuilt to fingerprint {got}: vault corrupt")
    return params or None


# ---------------------------------------------------------------------------
# Labelled probe: the controller's offline quality measurement


class QualityProbe:
    """A fixed labelled holdout (``train/fraudgen.py``, seeded) and the
    fraud head's forward: one AUC per call. The probe set never changes in
    a controller's life, so probe AUCs across ticks compare."""

    def __init__(self, *, rows: int | None = None, seed: int | None = None):
        from igaming_platform_tpu_torch.core.features import normalize, standardize_for_model
        from igaming_platform_tpu_torch.train.fraudgen import generate_labeled

        rows = rows or int(os.environ.get("PROMOTE_PROBE_ROWS", "2048"))
        seed = seed if seed is not None else int(os.environ.get("PROMOTE_PROBE_SEED", "7041"))
        x, y, _ = generate_labeled(np.random.default_rng(seed), rows)
        self._xn = standardize_for_model(normalize(torch.from_numpy(x)))
        self._y = y

    def auc(self, params: Any) -> float:
        """Fraud-head ROC-AUC of a serving tree (``{"multitask": MultiTask}``
        or the module) on the probe set, on the module's device."""
        from igaming_platform_tpu_torch.train.eval import roc_auc

        model = params.get("multitask") if isinstance(params, dict) else params
        device = next(model.buffers()).device
        with torch.no_grad():
            prob = fraud_predict(model, self._xn.to(device)).cpu().numpy().astype(np.float64)
        return float(roc_auc(self._y, prob))


# ---------------------------------------------------------------------------
# The controller


class PromotionController:
    """Admit/rollback state machine over the serving engine's params.

    ``tick()`` is the whole interface for the loop: evaluate the shadow's
    candidate against the gates and promote when they all pass; watch the
    post-promotion gates and roll back to last-known-good when they fail.
    Thread-safe; every transition is ledgered and vaulted.
    """

    def __init__(self, engine, shadow, *, ledger=None,
                 gates: gates_mod.PromotionGates | None = None,
                 probe: QualityProbe | None = None, slo_engine=None,
                 vault_dir: str | None = None, metrics=None, history_max: int = 64):
        backend = getattr(engine, "ml_backend", None)
        if backend != "multitask":
            raise ValueError(
                "PromotionController requires the trainable multitask backend (engine serves "
                f"ml_backend={backend!r}); online promotion of an untrainable backend is a "
                "config error")
        self.engine = engine
        self.shadow = shadow
        self._metrics = metrics
        self.ledger = ledger
        self.gates = gates or gates_mod.PromotionGates.from_env()
        self.probe = probe or QualityProbe()
        self._slo = slo_engine
        self.vault_dir = vault_dir
        self._lock = threading.Lock()
        self.paused = False
        self.history: deque = deque(maxlen=history_max)
        self.promotions = 0
        self.rollbacks = 0
        self.last_gate_table: dict | None = None
        self.last_post_check: dict | None = None

        # Last-known-good: the tree serving now, assumed good at construction
        # and re-anchored after every post-promotion check that passes.
        self._last_good_params = engine.get_params()
        self._last_good_fp = engine.params_fingerprint
        self._last_good_auc = self.probe.auc(self._last_good_params)
        if vault_dir:
            vault_save(vault_dir, self._last_good_params, backend)

    # -- gate inputs ---------------------------------------------------------

    def _slo_alerting(self) -> bool:
        """The SLO engine's fast or slow burn alert; none given reads quiet
        until obs/slo.py is ported."""
        if self._slo is None:
            return False
        try:
            alerts = self._slo.alerts_active()
            return bool(alerts.get("fast") or alerts.get("slow"))
        except Exception:  # noqa: BLE001 — a broken SLO read must not wedge promotion
            logger.warning("promotion SLO read failed", exc_info=True)
            return False

    def _drift_alerting(self) -> bool:
        """Any active drift alert of the process's drift engine; none
        installed (DRIFT=0) reads quiet."""
        drift = drift_mod.get_default()
        if drift is None:
            return False
        try:
            return any(drift.alerts_active().values())
        except Exception:  # noqa: BLE001 — a broken drift read must not wedge promotion
            logger.warning("promotion drift read failed", exc_info=True)
            return False

    def gate_check(self, candidate_params: Any) -> tuple[bool, dict]:
        """The admit gate table for a candidate."""
        table = gates_mod.promotion_gate_table(
            candidate_auc=self.probe.auc(candidate_params),
            baseline_auc=self._last_good_auc,
            shadow_rows=self.shadow.window_rows(),
            flip_rate=self.shadow.flip_rate(),
            slo_alerting=self._slo_alerting(),
            gates=self.gates,
            drift_alerting=self._drift_alerting(),
        )
        ok = gates_mod.gates_pass(table)
        if not ok and self._metrics is not None:
            for name, row in table.items():
                if not row["ok"]:
                    self._metrics.promotion_gate_failures_total.inc(gate=name)
        self.last_gate_table = table
        return ok, table

    # -- transitions ---------------------------------------------------------

    def _record(self, event: str, old_fp: str, new_fp: str, reason: str,
                table: dict | None) -> None:
        self.history.append({"event": event, "old_fp": old_fp, "new_fp": new_fp,
                             "reason": reason, "at_monotonic": time.monotonic(),
                             "gates": table})
        if self.ledger is not None:
            self.ledger.append_promotion(ledger_mod.PromotionRecord(
                event="rollback" if event.endswith("rollback") else "promote",
                old_fp=old_fp, new_fp=new_fp,
                model_version=getattr(self.engine, "ml_backend", "unknown"),
                reason=f"{event}: {reason}"[:500],
                gates_json=json.dumps(table, separators=(",", ":"))[:4000] if table else "{}",
                ts_unix=ledger_mod.wall_clock(),
            ))
        if self._metrics is not None:
            self._metrics.promotions_total.inc(event=event)
        logger.warning("promotion controller: %s %s -> %s (%s)", event, old_fp, new_fp, reason)

    def _swap(self, params: Any) -> tuple[str, str]:
        """The one path served params change on: the engine's swap."""
        old_fp = self.engine.params_fingerprint
        if self.vault_dir:
            vault_save(self.vault_dir, params, self.engine.ml_backend)
        self.engine.swap_params(params)
        return old_fp, self.engine.params_fingerprint

    def promote(self, candidate_params: Any, *, reason: str, table: dict | None,
                event: str = "promote") -> dict:
        with self._lock:
            old_fp, new_fp = self._swap(candidate_params)
            self.promotions += 1
            self._record(event, old_fp, new_fp, reason, table)
            # The shadow's evidence was about what now serves: a fresh window.
            self.shadow.set_candidate(candidate_params)
            return {"event": event, "old_fp": old_fp, "new_fp": new_fp}

    def rollback(self, *, reason: str, table: dict | None = None,
                 event: str = "rollback") -> dict:
        with self._lock:
            old_fp, new_fp = self._swap(self._last_good_params)
            self.rollbacks += 1
            self._record(event, old_fp, new_fp, reason, table)
            self.shadow.set_candidate(self._last_good_params)
            return {"event": event, "old_fp": old_fp, "new_fp": new_fp}

    # -- operator knobs ------------------------------------------------------

    def force_promote(self, candidate_params: Any, reason: str = "operator force") -> dict:
        """Promote without gate checks (recorded as such); the post-promotion
        watch still applies."""
        return self.promote(candidate_params, reason=reason, table=None, event="forced_promote")

    def force_rollback(self, reason: str = "operator force") -> dict:
        return self.rollback(reason=reason, event="forced_rollback")

    def pause(self) -> None:
        self.paused = True

    def resume(self) -> None:
        self.paused = False

    def inject_regression(self) -> dict:
        """Drill knob: force-promote the serving params with the fraud head
        negated (scores invert), to rehearse the auto-rollback. Negating a
        bf16-rounded weight is exact."""
        model = self.engine.get_params()["multitask"]
        head = model.fraud_head
        poisoned = MultiTask([Dense(layer.w_bf16.cpu(), layer.b.cpu()) for layer in model.trunk],
                             Dense(-head.w_bf16.cpu(), -head.b.cpu()),
                             *(Dense(h.w_bf16.cpu(), h.b.cpu())
                               for h in (model.ltv_head, model.churn_head)))
        return self.promote({"multitask": poisoned}, reason="drill: injected quality regression",
                            table=None, event="forced_promote")

    # -- the tick ------------------------------------------------------------

    def _post_promotion_check(self) -> tuple[bool, dict]:
        """Post-promotion gates over the params serving now: live probe
        quality and the SLO page state."""
        serving_auc = self.probe.auc(self.engine.get_params())
        slo_paging = self._slo_alerting()
        table = {
            "post_auc_floor": {"value": round(serving_auc, 4), "bound": self.gates.min_post_auc,
                               "ok": serving_auc >= self.gates.min_post_auc},
            "slo_not_paging": {"value": bool(slo_paging), "bound": False,
                               "ok": (not slo_paging) or not self.gates.rollback_on_slo_page},
        }
        self.last_post_check = table
        return gates_mod.gates_pass(table), table

    def tick(self) -> dict:
        """One evaluation tick: verify the serving params (rolling back when
        they fail), then admit a waiting candidate through the gates."""
        if self.paused:
            return {"action": "paused"}
        # The post-promotion watch first: a regressed serving model must not
        # wait behind candidate evaluation.
        ok, post_table = self._post_promotion_check()
        degraded_in_place = False
        if not ok:
            if self.engine.params_fingerprint != self._last_good_fp:
                result = self.rollback(
                    reason="post-promotion gate failed: " + ", ".join(
                        k for k, row in post_table.items() if not row["ok"]),
                    table=post_table)
                return {"action": "rollback", **result, "post_check": post_table}
            # Even last-known-good fails (an untrained cold boot, or an SLO
            # page with nothing in flight): nothing to roll back to, and
            # promoting a passing candidate is the only way out.
            degraded_in_place = True
        elif self.engine.params_fingerprint != self._last_good_fp:
            # The serving params verified good: re-anchor last-known-good.
            self._last_good_params = self.engine.get_params()
            self._last_good_fp = self.engine.params_fingerprint
            self._last_good_auc = post_table["post_auc_floor"]["value"]
        candidate = self.shadow.candidate_params
        if candidate is None or self.shadow.candidate_fp == self.engine.params_fingerprint:
            if degraded_in_place:
                return {"action": "degraded_no_rollback", "post_check": post_table}
            return {"action": "idle"}
        if self.gates.cooldown_s > 0 and self.history:
            since = time.monotonic() - self.history[-1]["at_monotonic"]
            if since < self.gates.cooldown_s:
                return {"action": "cooldown",
                        "retry_in_s": round(self.gates.cooldown_s - since, 1)}
        ok, table = self.gate_check(candidate)
        if not ok:
            return {"action": "held", "gates": table}
        result = self.promote(candidate, reason="all gates passed", table=table)
        return {"action": "promote", **result, "gates": table}

    def report(self) -> dict:
        """The promotion half of ``/debug/shadowz``."""
        with self._lock:
            history = list(self.history)
        return {
            "serving_fp": self.engine.params_fingerprint,
            "last_good_fp": self._last_good_fp,
            "last_good_probe_auc": round(self._last_good_auc, 4),
            "paused": self.paused,
            "promotions": self.promotions,
            "rollbacks": self.rollbacks,
            "gates": self.gates.as_dict(),
            "last_gate_table": self.last_gate_table,
            "last_post_check": self.last_post_check,
            "vault_dir": self.vault_dir,
            "history": history,
        }
