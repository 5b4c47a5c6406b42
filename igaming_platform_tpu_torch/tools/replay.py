"""Deterministic decision replay: re-score a decision ledger bit-exact.

The port's counterpart of ``tools/replay.py``::

    python -m igaming_platform_tpu_torch.tools.replay --dir LEDGER_DIR \\
        [--device cuda|cpu] [--batch N] \\
        [--params tree.npz|mock] [--params-vault DIR] [--out verdict.json]
    python -m igaming_platform_tpu_torch.tools.replay --verify [--device cpu]

It reads every :class:`DecisionRecord` of a WAL (``serve/ledger.py``),
rebuilds the scoring engine that took each decision, re-scores each record
from its feature snapshot, and diffs the outputs bit for bit: score,
action, reason mask, rule score and the ml score's IEEE-754 bits.
Decisions of the degraded heuristic tier replay through the same
conservative scorer (``serve/supervisor.heuristic_scores``). Session-scored
decisions, which carry no snapshot, have their windows rebuilt from the
ledger's order and their session hashes verified
(:func:`verify_session_chain`). The verdict has the JAX tool's keys, plus
``"device"``.

Replay runs on the device that scored. A record names no device (the v1
golden pins the format), and a card's float32 sums are not the CPU's: a WAL
written on the card and replayed with ``--device cpu`` differs in
``ml_score`` bits. ``--device`` defaults to ``cuda``, and the tool refuses
to start without a card unless it is asked for the CPU.

The params: ``--params`` names a JAX-layout params tree, carried over by
``convert.from_jax_params``: an Orbax checkpoint directory (a vault entry's
serving tree, or a trainer's ``step_*/``, whose ``params`` pin the
``multitask`` backend as the JAX tool's ``--checkpoint`` does; read by the
port's ``utils/orbax``), an ``.npz`` saved with ``convert.save_params_tree``
(numpy arrays, keys joined by ``/``), or ``mock`` for the mock backend,
which has none (a record the JAX service wrote names the JAX fingerprint
of its tree, ``convert.jax_fingerprint``, which the pinned tree also
matches); then the params vault
(``<dir>/params-vault`` unless ``--params-vault`` names another,
``train/promote.vault_load``) resolves any other fingerprint. A record whose
fingerprint no source resolves is counted and fails the verdict, never
re-scored against the wrong model. The JAX tool's default, the seeded
``init_multitask(jax.random.key(0))``, cannot be computed without JAX.

Two departures from the JAX tool:

- **The chunks the engine used.** The JAX tool re-chunks each group of
  records by ``batch`` and ignores how the rows were batched. This tool
  replays each note batch (each decision-id prefix) in the chunks the
  engine used: the same ``batch_size`` from the batch's first row, and the
  smallest shape of the same ladder for each chunk. Every row then meets
  the launch plan and the library algorithms it was scored with. From the
  command line the batch size is ``--batch``, by default the server's
  (``BATCH_SIZE``, as ``RiskServiceConfig.from_env`` reads it), and the
  ladder is ``BatcherConfig().latency_tiers``, the only one the server
  runs; an engine built with other tiers is replayed through
  :func:`replay_directory`'s ``tiers``.
- **The backend of a record** is its ``model_version`` less a
  ``+degraded-heuristic`` suffix; the JAX tool cuts at the first ``+``,
  which turns ``mlp+gbdt`` into ``mlp``.

``--verify`` is the self-contained smoke: a seeded mock engine scores
through ``score_batch``, the batcher and a wire RPC under ``CHAOS_PLAN``
(ledger-append delays by default), then its WAL is replayed and must show
no mismatch. Its engine runs without the supervisor
(``serve/supervisor.py``), so the smoke has no heuristic window; records of
the supervisor's degraded tier replay as described above.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from igaming_platform_tpu_torch.convert import jax_fingerprint, load_params_tree
from igaming_platform_tpu_torch.core.config import BatcherConfig, RiskServiceConfig

_COMPARE_FIELDS = ("score", "action", "reason_mask", "rule_score", "ml_score_bits")
_DEGRADED_SUFFIX = "+degraded-heuristic"


def _backend_of(model_version: str) -> str:
    if model_version.endswith(_DEGRADED_SUFFIX):
        return model_version[:-len(_DEGRADED_SUFFIX)]
    return model_version


def load_pinned_tree(path: str) -> dict:
    """The JAX-layout serving tree ``--params`` names (module docstring)."""
    if os.path.isdir(path):
        from igaming_platform_tpu_torch.utils.orbax import restore_tree

        tree = restore_tree(path)
        return {"multitask": tree["params"]} if "params" in tree else tree
    return load_params_tree(path)


class _EngineCache:
    """One warmed engine per (backend, params fingerprint). A fingerprint
    resolves to a param tree through the pinned params, then the params
    vault, so decisions scored across a swap replay against the tree that
    scored them."""

    def __init__(self, batch: int, tiers, params: str | None, device: str,
                 vault_dir: str | None = None):
        self.batch = batch
        self.tiers = tuple(tiers)
        # The pinned tree (``--params``), read once; a bad file raises here.
        self.tree = None if params in (None, "", "mock") else load_pinned_tree(params)
        self.tree_fp = None if self.tree is None else jax_fingerprint(self.tree)
        self.device = device
        self.vault_dir = vault_dir
        self._engines: dict[tuple[str, str], object] = {}

    def _build(self, backend: str, params):
        from igaming_platform_tpu_torch.core.config import ScoringConfig
        from igaming_platform_tpu_torch.serve.scorer import TorchScoringEngine

        return TorchScoringEngine(
            ScoringConfig(), ml_backend=backend, params=params, device=self.device,
            batcher_config=BatcherConfig(batch_size=self.batch, latency_tiers=self.tiers,
                                         max_wait_ms=1.0),
            # Replay re-scores recorded snapshots; session windows are
            # verified from the ledger's order (verify_session_chain), never
            # by moving live session state here.
            feature_cache=False, session_state=False)

    def _pinned(self, backend: str):
        """The pinned params of ``backend``, or None when the pinned tree
        lacks its keys (or it is the mock, which has none)."""
        from igaming_platform_tpu_torch.convert import BACKEND_KEYS, from_jax_params

        keys = BACKEND_KEYS.get(backend)
        if self.tree is None or not keys or any(k not in self.tree for k in keys):
            return None
        return from_jax_params(backend, self.tree)

    def get_for(self, backend: str, fp: str):
        """The engine whose params fingerprint is ``fp``, or None when no
        params source resolves it."""
        eng = self._engines.get((backend, fp))
        if eng is not None:
            return eng
        params = self._pinned(backend)
        if params is not None or backend == "mock":
            pinned = self._build(backend, params)
            # A record the JAX service wrote carries the JAX fingerprint
            # of the tree it served.
            if fp in (pinned.params_fingerprint, self.tree_fp):
                self._engines[(backend, fp)] = pinned
                return pinned
            pinned.close()
        if self.vault_dir:
            from igaming_platform_tpu_torch.train.promote import vault_load

            try:
                params = vault_load(self.vault_dir, fp, backend)
            except ValueError as exc:
                # A tampered or corrupt entry fails loudly, never re-scores
                # against the wrong model.
                raise RuntimeError(f"params vault entry {fp}: {exc}") from exc
            if params is not None:
                eng = self._build(backend, params)
                self._engines[(backend, fp)] = eng
                return eng
        return None

    def close(self) -> None:
        for eng in self._engines.values():
            eng.close()


def _fields(out: dict, n: int) -> list[dict]:
    bits = np.ascontiguousarray(out["ml_score"], np.float32).view(np.uint32)
    return [{"score": int(out["score"][i]), "action": int(out["action"][i]),
             "reason_mask": int(out["reason_mask"][i]), "rule_score": int(out["rule_score"][i]),
             "ml_score_bits": int(bits[i])} for i in range(n)]


def _replay_compiled(engine, records) -> list[dict]:
    """Re-score one note batch's records (row order) in the chunks the
    engine scored it in: ``batch_size`` rows from the first, each padded to
    the ladder's smallest shape that holds it (``_launch``), one packed
    readback a chunk."""
    params = engine.get_params()
    out_rows: list[dict] = []
    for lo in range(0, len(records), engine.batch_size):
        chunk = records[lo:lo + engine.batch_size]
        x = np.stack([r.features for r in chunk]).astype(np.float32)
        bl = np.array([r.blacklisted for r in chunk], dtype=bool)
        out_rows.extend(_fields(engine._readback(engine._launch(x, bl, params)), len(chunk)))
    return out_rows


def _replay_heuristic(records, thresholds) -> list[dict]:
    from igaming_platform_tpu_torch.serve.supervisor import heuristic_scores

    x = np.stack([r.features for r in records]).astype(np.float32)
    bl = np.array([r.blacklisted for r in records], dtype=bool)
    return _fields(heuristic_scores(x, bl, np.asarray(thresholds, np.int32)), len(records))


def _recorded_fields(r) -> dict:
    return {"score": r.score, "action": r.action, "reason_mask": r.reason_mask,
            "rule_score": r.rule_score, "ml_score_bits": r.ml_score_bits}


# ---------------------------------------------------------------------------
# Stateful decisions: session windows rebuilt from the ledger's order


def verify_session_chain(records, *, max_samples: int = 10, twin_keep: int = 64) -> dict:
    """Rebuild every session-scored decision's post-append window from the
    ledger's event order alone and verify its ``session_state_hash`` bit
    for bit (``serve/session_state.py`` is the other side).

    ``records`` is the WAL-ordered decision stream. Consecutive records
    sharing a decision-batch prefix form one chunk (one step, one
    batch-start snapshot): every row's window is computed from the
    chunk-start twin state (duplicate accounts included), then all events
    commit in row order, as the serving side did. ``seq == 1`` against a
    non-empty twin is a reset of the server's session index (a restart):
    the twin resets. A forward seq jump is a chain gap (a dropped ledger
    row): counted, that row unverifiable, the twin resyncs."""
    from igaming_platform_tpu_torch.serve.session_state import encode_events_host, window_hash
    from igaming_platform_tpu_torch.serve.wire import TX_TYPE_CODES

    twins: dict[str, dict] = {}
    stats = {
        "session_records": 0, "session_verified": 0,
        "session_hash_mismatch": 0, "session_chain_gaps": 0,
        "session_resets": 0, "session_reordered": 0,
        "session_mismatch_samples": [],
    }

    def _twin(acct: str) -> dict:
        tw = twins.get(acct)
        if tw is None:
            tw = {"events": [], "seq": 0, "last_ts": 0.0}
            twins[acct] = tw
        return tw

    def flush_chunk(chunk) -> None:
        snap: dict[str, dict] = {}
        occ: dict[str, int] = {}
        for rec in chunk:
            a = rec.account_id
            if a not in snap:
                tw = _twin(a)
                s = {"events": list(tw["events"]), "seq": tw["seq"],
                     "last_ts": tw["last_ts"], "reset": False}
                if rec.session_seq == 1 and tw["seq"] != 0:
                    stats["session_resets"] += 1
                    s = {"events": [], "seq": 0, "last_ts": 0.0, "reset": True}
                snap[a] = s
        committed: list = []  # (account_id, event, seq, ts)
        for rec in chunk:
            stats["session_records"] += 1
            s = snap[rec.account_id]
            k = occ.get(rec.account_id, 0)
            occ[rec.account_id] = k + 1
            expected = s["seq"] + k + 1
            dt = 0.0 if s["seq"] == 0 else max(0.0, rec.ts_unix - s["last_ts"])
            code = TX_TYPE_CODES.get(rec.tx_type, 4)
            event = encode_events_host([rec.amount], [code], [dt])[0]
            committed.append((rec.account_id, event, rec.session_seq, rec.ts_unix))
            hist = rec.session_len - 1
            if rec.session_seq != expected:
                if rec.session_seq > expected:
                    stats["session_chain_gaps"] += 1
                else:
                    stats["session_reordered"] += 1
                continue
            if len(s["events"]) < hist:
                stats["session_chain_gaps"] += 1
                continue
            window = s["events"][len(s["events"]) - hist:] + [event]
            redo = window_hash(np.stack(window)).hex()
            if redo == rec.session_hash:
                stats["session_verified"] += 1
            else:
                stats["session_hash_mismatch"] += 1
                if len(stats["session_mismatch_samples"]) < max_samples:
                    stats["session_mismatch_samples"].append({
                        "decision_id": rec.decision_id, "account_id": rec.account_id,
                        "session_seq": rec.session_seq, "session_len": rec.session_len,
                        "recorded": rec.session_hash, "recomputed": redo})
        # Commit in row order, adopting the recorded seqs so that a gap
        # resyncs forward instead of cascading mismatches.
        reset_done: set[str] = set()
        for a, event, seq, ts in committed:
            tw = _twin(a)
            if snap[a]["reset"] and a not in reset_done:
                tw["events"] = []
                reset_done.add(a)
            tw["events"].append(event)
            del tw["events"][:-twin_keep]
            tw["seq"] = seq
            tw["last_ts"] = ts

    chunk: list = []
    prefix = None
    for rec in records:
        if not rec.session_hash:
            continue
        p = rec.decision_id.rsplit(".", 1)[0]
        if prefix is not None and p != prefix and chunk:
            flush_chunk(chunk)
            chunk = []
        prefix = p
        chunk.append(rec)
    if chunk:
        flush_chunk(chunk)
    stats["session_ok"] = (stats["session_hash_mismatch"] == 0
                           and stats["session_reordered"] == 0)
    return stats


def _note_batches(records) -> list[list]:
    """The records with a snapshot grouped by decision-id prefix (one note
    batch each), in the order the WAL first shows each, rows in row order."""
    groups: dict[str, list] = {}
    for r in records:
        prefix, _, row = r.decision_id.rpartition(".")
        groups.setdefault(prefix, []).append((int(row) if row.isdigit() else 0, r))
    return [[r for _, r in sorted(g, key=lambda t: t[0])] for g in groups.values()]


def replay_directory(directory: str, *, batch: int = BatcherConfig().batch_size,
                     tiers=BatcherConfig().latency_tiers, params: str | None = None,
                     vault_dir: str | None = None, device: str = "cuda",
                     max_mismatch_samples: int = 10) -> dict:
    """Replay every record of a ledger directory on ``device``; returns the
    verdict (``ok`` iff no mismatch and no fingerprint left unresolved;
    index-mode records without a snapshot are counted as skipped, never as
    passes). ``batch`` and ``tiers`` must be the scoring engine's.

    Promotion side-records land in the verdict as the ``promotions``
    timeline; the params vault (default ``<directory>/params-vault``)
    resolves every fingerprint a swap put into service."""
    from igaming_platform_tpu_torch.core.device import resolve_device
    from igaming_platform_tpu_torch.serve import ledger as ledger_mod

    device = str(resolve_device(device))
    if vault_dir is None:
        default_vault = os.path.join(directory, "params-vault")
        vault_dir = default_vault if os.path.isdir(default_vault) else None

    records = []
    promotions = []
    for kind, rec in ledger_mod.iter_entries(directory):
        if kind == "decision":
            records.append(rec)
        elif kind == "promotion":
            promotions.append(rec)
    snapshots = [r for r in records if r.features is not None]
    skipped_no_snapshot = len(records) - len(snapshots)

    engines = _EngineCache(batch, tiers, params, device, vault_dir=vault_dir)
    mismatches: list[dict] = []
    params_mismatch = 0
    replayed_by_tier: dict[str, int] = {}
    replayed_by_fp: dict[str, int] = {}
    try:
        for recs in _note_batches(snapshots):
            head = recs[0]
            thresholds = (head.block_threshold, head.review_threshold)
            if head.tier == "heuristic":
                recomputed = _replay_heuristic(recs, thresholds)
            else:
                engine = engines.get_for(_backend_of(head.model_version), head.params_fp)
                if engine is None:
                    params_mismatch += len(recs)
                    continue
                if engine.get_thresholds() != thresholds:
                    engine.set_thresholds(*thresholds)
                replayed_by_fp[head.params_fp] = replayed_by_fp.get(head.params_fp, 0) + len(recs)
                recomputed = _replay_compiled(engine, recs)
            for rec, redo in zip(recs, recomputed):
                replayed_by_tier[rec.tier] = replayed_by_tier.get(rec.tier, 0) + 1
                was = _recorded_fields(rec)
                if was != redo and len(mismatches) < max_mismatch_samples:
                    mismatches.append({"decision_id": rec.decision_id,
                                       "account_id": rec.account_id, "tier": rec.tier,
                                       "recorded": was, "recomputed": redo})
                elif was != redo:
                    mismatches.append({"decision_id": rec.decision_id})
    finally:
        engines.close()

    # Session-scored decisions: every session hash verified from the
    # ledger's order, which covers the index-mode records the snapshot
    # replay skips.
    session = verify_session_chain(records)

    replayed = sum(replayed_by_tier.values())
    return {
        "metric": "decision_replay_bit_exact",
        "ledger_dir": directory,
        "records_total": len(records),
        "replayed": replayed,
        "replayed_by_tier": replayed_by_tier,
        "replayed_by_params_fp": replayed_by_fp,
        "skipped_no_snapshot": skipped_no_snapshot,
        "params_fingerprint_mismatch": params_mismatch,
        "params_vault": vault_dir,
        **session,
        "promotions": [{"event": p.event, "old_fp": p.old_fp, "new_fp": p.new_fp,
                        "reason": p.reason, "ts": round(p.ts_unix, 3)} for p in promotions],
        "fields_compared": list(_COMPARE_FIELDS),
        "mismatches": len(mismatches),
        "mismatch_samples": mismatches[:max_mismatch_samples],
        "ok": (not mismatches and params_mismatch == 0
               and (replayed > 0 or session["session_verified"] > 0)
               and session["session_ok"]),
        "device": device,
    }


# ---------------------------------------------------------------------------
# --verify: the self-contained smoke


def run_verify(ledger_dir: str | None = None, *, rows: int = 96, batch: int = 64,
               chaos_plan: str | None = None, device: str = "cuda") -> dict:
    """Score a seeded batch through ``score_batch``, the batcher and a wire
    RPC on a mock engine on ``device``, under a chaos plan with
    ledger-append faults, then replay the ledger and diff bit for bit."""
    import tempfile

    from igaming_platform_tpu_torch.core.config import ScoringConfig
    from igaming_platform_tpu_torch.core.device import resolve_device
    from igaming_platform_tpu_torch.serve import chaos as chaos_mod
    from igaming_platform_tpu_torch.serve import ledger as ledger_mod
    from igaming_platform_tpu_torch.serve.feature_store import TransactionEvent
    from igaming_platform_tpu_torch.serve.scorer import ScoreRequest, TorchScoringEngine

    resolve_device(device)  # no card and no device="cpu": refuse before anything runs
    directory = ledger_dir or tempfile.mkdtemp(prefix="ledger-verify-")
    plan = chaos_mod.install(chaos_plan or os.environ.get(
        "CHAOS_PLAN", "seed=5;ledger.append=delay:p=0.4:ms=1"))
    engine = TorchScoringEngine(ScoringConfig(), ml_backend="mock", device=device,
                                batcher_config=BatcherConfig(batch_size=batch, max_wait_ms=1.0))
    ledger = ledger_mod.DecisionLedger(directory)
    engine.ledger = ledger
    try:
        for i in range(64):
            engine.update_features(TransactionEvent(
                account_id=f"rv-{i % 32}", amount=500 + 37 * i,
                tx_type=("deposit", "bet", "withdraw")[i % 3],
                ip=f"10.9.{i % 20}.{i % 25}", device_id=f"dev-{i % 8}"))
        reqs = [ScoreRequest(f"rv-{i % 32}", amount=900 + 131 * i,
                             tx_type=("deposit", "bet", "withdraw")[i % 3]) for i in range(rows)]
        engine.score_batch(reqs)
        for i in range(8):
            engine.score(reqs[i])
        engine.score_batch_wire([r.account_id for r in reqs], [r.amount for r in reqs],
                                [r.tx_type for r in reqs])
    finally:
        ledger.close()
        chaos_mod.clear()
        engine.close()

    verdict = replay_directory(directory, batch=batch, device=device)
    verdict["scenario"] = "replay-verify smoke"
    verdict["chaos_plan"] = plan.snapshot()
    verdict["ledger_stats_note"] = (
        "append-fault drops are counted by the ledger, not replayed; replay covers every "
        "record that reached the WAL")
    verdict["ok"] = bool(verdict["ok"] and verdict["replayed"] > 0)
    return verdict


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Re-score a decision ledger bit-exact")
    parser.add_argument("--dir", help="ledger directory (WAL segments)")
    parser.add_argument("--out", help="write the verdict artifact here")
    parser.add_argument("--device", default="cuda",
                        help="the device that scored the ledger (cuda, or cpu)")
    parser.add_argument("--batch", type=int,
                        default=RiskServiceConfig.from_env().batcher.batch_size,
                        help="the scoring engine's batch size (default: the server's, "
                             "BATCH_SIZE)")
    parser.add_argument("--params",
                        help="pinned params: an Orbax checkpoint directory, a JAX-layout "
                             "tree .npz (convert.save_params_tree), or mock")
    parser.add_argument("--params-vault",
                        help="fingerprint-keyed params vault (default: <dir>/params-vault "
                             "when present)")
    parser.add_argument("--verify", action="store_true",
                        help="self-contained smoke: score under CHAOS_PLAN, replay, diff")
    args = parser.parse_args(argv)

    if args.verify:
        verdict = run_verify(device=args.device)
    elif args.dir:
        verdict = replay_directory(args.dir, batch=args.batch, params=args.params,
                                   vault_dir=args.params_vault, device=args.device)
    else:
        parser.error("need --dir or --verify")
    print(json.dumps(verdict))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=1)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
