"""Mint a pinned drift reference from a decision ledger.

The port's counterpart of ``tools/driftref.py``::

    python -m igaming_platform_tpu_torch.tools.driftref --ledger LEDGER_DIR --out ref.json
    python -m igaming_platform_tpu_torch.tools.driftref --ledger LEDGER_DIR --verify

It walks a ledger directory (``serve/ledger.py``), folds every decision's
feature snapshot, score and action into the drift sketch (``obs/drift.py``
``np_sketch``, the numpy twin of the on-path sketch), joins outcome records
into the calibration curve, and writes a reference the server loads at boot
(``DRIFT_REF=path``) or at run time (``POST /debug/driftz {"action":
"load", "path": ...}``). The file is the JAX package's format: a reference
minted from a WAL the port wrote loads in both packages.

``--verify`` mints from the ledger, round-trips the reference through save
and load, and checks that its self-PSI is about 0.
``--synthetic`` (minting from the labeled generator) needs
``train/fraudgen.py``, which comes with Queue 1 item 9 (``ROADMAP.md``):
until then it raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from igaming_platform_tpu_torch.obs import drift as drift_mod
from igaming_platform_tpu_torch.serve import ledger as ledger_mod


def sketch_from_ledger(directory: str, max_rows: int = 500_000,
                       pending_max: int = 262_144) -> tuple[np.ndarray, np.ndarray, dict]:
    """(sketch vector, calibration [N_SCORE_BINS, 2], stats) from every
    decision frame of a ledger directory. Records without a snapshot (index
    mode) have no feature vector to bin: skipped and counted."""
    xs: list[np.ndarray] = []
    scores: list[int] = []
    actions: list[int] = []
    # decision_id -> score, bounded, awaiting an outcome join.
    pending: dict[str, int] = {}
    cal = np.zeros((drift_mod.N_SCORE_BINS, 2), np.float64)
    stats = {"decisions": 0, "snapshotless": 0, "outcomes": 0,
             "outcomes_joined": 0, "frames": 0, "undecodable": 0}
    for _seq, path in ledger_mod.ledger_segments(directory):
        for payload, _end in ledger_mod.iter_segment_frames(path):
            stats["frames"] += 1
            try:
                kind, rec = ledger_mod.decode_entry(payload)
            except ledger_mod.LedgerSchemaError:
                stats["undecodable"] += 1
                continue
            if kind == "decision":
                stats["decisions"] += 1
                if len(pending) < pending_max:
                    pending[rec.decision_id] = int(rec.score)
                if rec.features is None:
                    stats["snapshotless"] += 1
                    continue
                xs.append(np.asarray(rec.features, np.float32))
                scores.append(int(rec.score))
                actions.append(int(rec.action))
                if len(xs) > max_rows:
                    # The newest rows win: recent traffic is the "normal" a
                    # drift comparison should anchor on.
                    xs = xs[-max_rows:]
                    scores = scores[-max_rows:]
                    actions = actions[-max_rows:]
            elif kind == "outcome":
                stats["outcomes"] += 1
                score = pending.get(rec.decision_id)
                if score is None:
                    continue
                stats["outcomes_joined"] += 1
                sbin = min(max(score // drift_mod.SCORE_BIN_WIDTH, 0), drift_mod.N_SCORE_BINS - 1)
                cal[sbin, 0] += 1
                cal[sbin, 1] += float(rec.label)
    if not xs:
        raise SystemExit(
            f"no snapshot-carrying decisions under {directory!r}: an index-mode-only "
            "ledger cannot mint a feature reference (capture a row-mode window first)")
    vec = drift_mod.np_sketch(np.stack(xs), np.asarray(scores, np.int64),
                              np.asarray(actions, np.int64))
    return vec, cal, stats


def mint(directory: str, max_rows: int = 500_000):
    """(the reference minted from a ledger directory, its sketch vector,
    the mint's stats)."""
    vec, cal, stats = sketch_from_ledger(directory, max_rows)
    ref = drift_mod.DriftReference.from_sketch(
        vec, source=f"ledger:{directory}", calibration=cal if cal[:, 0].sum() > 0 else None)
    return ref, vec, stats


def verify(directory: str) -> int:
    """Mint from ``directory``, round-trip the reference through save and
    load, and require its self-PSI to be about 0."""
    import os
    import tempfile

    ref, vec, _stats = mint(directory)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        ref.save(path)
        loaded = drift_mod.DriftReference.load(path)
    finally:
        os.unlink(path)
    assert loaded.fingerprint() == ref.fingerprint(), "round-trip fingerprint"
    table = drift_mod.psi_table(vec, loaded)
    assert table["max_feature_psi"] < 1e-6, table["max_feature_psi"]
    assert table["score_psi"] < 1e-6, table["score_psi"]
    print(json.dumps({"ok": True, "reference": ref.meta(),
                      "self_psi": table["max_feature_psi"]}))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--ledger", help="decision-ledger directory to mint from")
    ap.add_argument("--synthetic", action="store_true",
                    help="mint from the labeled synthetic generator (not ported yet)")
    ap.add_argument("--max-rows", type=int, default=500_000,
                    help="newest-N cap when minting from a large ledger")
    ap.add_argument("--out", default="drift-ref.json")
    ap.add_argument("--verify", action="store_true",
                    help="mint from --ledger, round-trip, check the self-PSI")
    args = ap.parse_args(argv)

    if args.synthetic:
        raise NotImplementedError(
            "--synthetic needs train/fraudgen.py, not ported yet (ROADMAP.md Queue 1 item 9)")
    if not args.ledger:
        ap.error("need --ledger DIR")
    if args.verify:
        return verify(args.ledger)
    ref, _vec, stats = mint(args.ledger, args.max_rows)
    ref.save(args.out)
    print(json.dumps({"ok": True, "out": args.out, "reference": ref.meta(), "stats": stats}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
