"""The LTV batch job: one scan of the wallet store, one device pass.

The port's counterpart of ``igaming_platform_tpu/serve/ltv_job.py``: one
read-only scan of the wallet store builds the [N, 25] LTV feature matrix,
one pass of ``models/ltv.py`` on the device predicts LTV, churn, segment,
survival and next-best-action for every player, and the job returns the
segment groupings and per-account records with the JAX job's keys and
values.

Usage::

    python -m igaming_platform_tpu_torch.serve.ltv_job <wallet.db> [out.json] [--device cuda|cpu]

It runs on the card unless ``--device cpu``. The store is a SQLite file
(a path or ``sqlite://`` URL), opened read-only (``mode=ro``), as the
JAX job's reader opens it; ``postgres://`` waits for the port's wire
client (``ROADMAP.md`` Queue 1 item 5). With ``metrics=`` (an
``obs/metrics.py`` ``ServiceMetrics``) the segment counts feed
``ltv_segment_total``, as the JAX job's do.
"""

from __future__ import annotations

import argparse
import json
import math
import sqlite3
import sys
import time

import numpy as np
import torch

from igaming_platform_tpu_torch.models.ltv import (ACTIONS, NUM_LTV_FEATURES, L, predict_batch,
                                                   to_host)

_SECONDS_PER_DAY = 86_400.0


def open_wallet_reader(db: str):
    """(query(sql) -> rows, close) over a SQLite wallet store opened
    read-only: a scan job must be unable to write to the store of record.
    SQLite builds without the math functions get ``floor`` from Python."""
    if db.startswith(("postgres://", "postgresql://")):
        raise NotImplementedError(
            "the LTV job reads SQLite only: postgres:// waits for the port's wire client "
            "(ROADMAP.md Queue 1 item 5)")
    path = db.removeprefix("sqlite://")
    ro = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        ro.execute("SELECT floor(1.5)")
    except sqlite3.OperationalError:
        ro.create_function("floor", 1, lambda v: None if v is None else math.floor(v),
                           deterministic=True)
    return (lambda sql: ro.execute(sql).fetchall()), ro.close


def ltv_features_from_wallet(db_path: str,
                             now: float | None = None) -> tuple[list[str], np.ndarray]:
    """Scan a wallet store into the [N, 25] LTV feature matrix.

    Behavioural features the wallet schema cannot know (sessions, push and
    email opt-ins, support tickets) stay zero, the degraded-confidence case
    of ``confidence``."""
    now = now or time.time()
    query, close = open_wallet_reader(db_path)
    try:
        accounts = query("SELECT id, created_at FROM accounts")
        rows = query(
            "SELECT account_id, type, COUNT(*), COALESCE(SUM(amount),0),"
            " COALESCE(MAX(amount),0), COALESCE(MAX(completed_at),0)"
            " FROM transactions WHERE status='completed' GROUP BY account_id, type"
        )
        # floor(), as the JAX job's SQL: its day buckets agree with PostgreSQL's.
        active = dict(query(
            "SELECT account_id, COUNT(DISTINCT floor(created_at / 86400))"
            " FROM transactions WHERE status='completed' GROUP BY account_id"
        ))
    finally:
        close()

    agg: dict[str, dict] = {a: {} for a, _ in accounts}
    for account_id, tx_type, count, total, largest, last_ts in rows:
        agg.setdefault(account_id, {})[tx_type] = (count, total, largest, last_ts)

    ids = [a for a, _ in accounts]
    x = np.zeros((len(ids), NUM_LTV_FEATURES), dtype=np.float32)
    for i, (account_id, created_at) in enumerate(accounts):
        per_type = agg.get(account_id, {})
        dep = per_type.get("deposit", (0, 0, 0, 0.0))
        bet = per_type.get("bet", (0, 0, 0, 0.0))
        win = per_type.get("win", (0, 0, 0, 0.0))
        wd = per_type.get("withdraw", (0, 0, 0, 0.0))
        bonus = per_type.get("bonus_grant", (0, 0, 0, 0.0))

        age_days = max(0.0, (now - created_at) / _SECONDS_PER_DAY)
        x[i, L.DAYS_SINCE_REGISTRATION] = age_days
        x[i, L.DAYS_SINCE_LAST_DEPOSIT] = (now - dep[3]) / _SECONDS_PER_DAY if dep[3] else age_days
        x[i, L.DAYS_SINCE_LAST_BET] = (now - bet[3]) / _SECONDS_PER_DAY if bet[3] else age_days
        x[i, L.TOTAL_ACTIVE_DAYS] = active.get(account_id, 0)
        x[i, L.TOTAL_DEPOSITS] = dep[1] / 100.0  # cents -> dollars
        x[i, L.TOTAL_WITHDRAWALS] = wd[1] / 100.0
        # net revenue = deposits - withdrawals - bonuses (ltv.go:50), not bets - wins.
        x[i, L.NET_REVENUE] = (dep[1] - wd[1] - bonus[1]) / 100.0
        x[i, L.AVG_DEPOSIT_AMOUNT] = (dep[1] / dep[0] / 100.0) if dep[0] else 0.0
        x[i, L.DEPOSIT_FREQUENCY] = dep[0] / max(age_days / 30.0, 1.0)  # per month
        x[i, L.LARGEST_DEPOSIT] = dep[2] / 100.0
        x[i, L.TOTAL_BETS] = bet[1] / 100.0
        x[i, L.TOTAL_WINS] = win[1] / 100.0
        x[i, L.BET_COUNT] = bet[0]
        x[i, L.WIN_RATE] = win[0] / bet[0] if bet[0] else 0.0
        x[i, L.AVG_BET_SIZE] = (bet[1] / bet[0] / 100.0) if bet[0] else 0.0
    return ids, x


def run_batch_job(db_path: str, now: float | None = None, device: str = "cuda",
                  timings: dict | None = None, metrics=None) -> dict:
    """Scan, one device pass, then the segment groupings and per-account
    records. ``timings``, when given, receives the seconds of the scan, the
    device pass (the outputs back on the host) and the records."""
    t0 = time.perf_counter()
    ids, x = ltv_features_from_wallet(db_path, now=now)
    if timings is not None:
        timings["scan_s"] = time.perf_counter() - t0
    return batch_result(ids, x, device, timings, metrics)


def batch_result(ids: list[str], x: np.ndarray, device: str = "cuda",
                 timings: dict | None = None, metrics=None) -> dict:
    """The job's answer for a scanned feature matrix: one device pass, then
    the records and the segment groupings. ``timings``, when given, receives
    the seconds of the device pass and of the records."""
    if not ids:
        return {"players": [], "segments": {}, "count": 0}
    t1 = time.perf_counter()
    out = to_host(predict_batch(x, device))
    t2 = time.perf_counter()
    records = [
        {
            "account_id": account_id,
            "predicted_ltv": round(float(out["ltv"][i]), 2),
            "segment": int(out["segment"][i]),
            "churn_risk": round(float(out["churn_risk"][i]), 4),
            "survival_days": int(out["survival_days"][i]),
            "confidence": round(float(out["confidence"][i]), 4),
            "next_best_action": ACTIONS[int(out["action"][i])],
        }
        for i, account_id in enumerate(ids)
    ]
    grouped: dict[str, list[str]] = {}
    for rec in records:
        grouped.setdefault(str(rec["segment"]), []).append(rec["account_id"])
    if timings is not None:
        timings.update(device_s=t2 - t1, records_s=time.perf_counter() - t2)
    if metrics is not None:
        for seg, members in grouped.items():
            metrics.ltv_segment_total.inc(len(members), segment=seg)
    return {"players": records, "segments": grouped, "count": len(records)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="The LTV batch job over a wallet store.")
    parser.add_argument("db", help="a SQLite wallet store (path or sqlite:// URL)")
    parser.add_argument("out", nargs="?", help="write the full result here as JSON")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    result = run_batch_job(args.db, device=args.device)
    result["device"] = (torch.cuda.get_device_name(0)
                        if args.device == "cuda" and torch.cuda.is_available() else args.device)
    payload = json.dumps(result, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
        print(json.dumps({"players_segmented": result["count"],
                          "segments": {k: len(v) for k, v in result["segments"].items()},
                          "out": args.out}))
    else:
        print(payload)
    return 0


if __name__ == "__main__":
    sys.exit(main())
