"""The number that decides ``correct``, and how a run prints it.

A scoring cell compares one: ``logit_gap``, the largest absolute gap
between an answer's abuse logit and the reference's for the same history,
over every answer the run produced.
"""

from __future__ import annotations

import sys

import torch


def scoring_readings(side: torch.Tensor, ref: torch.Tensor) -> tuple[dict[str, float], torch.Tensor]:
    """``side``: [calls, B] logits, call i of pool batch i mod n; ``ref``:
    [n, B]. Returns ({"logit_gap"}, each answer's gap as [calls, B]); a gap
    that is not a number makes the reading not a number (``max`` passes NaN
    on)."""
    n = ref.shape[0]
    idx = torch.arange(side.shape[0], device=side.device) % n
    gaps = (side.double() - ref.to(side.device).double()[idx]).abs()
    return {"logit_gap": float(gaps.max())}, gaps


def judge(readings: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(every reading within its limit, {name: {"value", "limit"}}). A
    reading that is not finite fails."""
    table = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"] for v in table.values())
    return ok, table


def print_table(table: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error."""
    for name, v in table.items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
