"""Readings that set a cell's limits, on the card at the cell's own size.

    python3 -m portbench.calibrate --workload <cell> --seeds 12 --control-seeds 3 [--out FILE]

In one process and with no measured window, for a scoring cell (driver
``score_sequence``): the program's readings on each seed (the lower end),
its pool batches each scored ``--calls`` times by the timed call; then on
the first ``--control-seeds`` seeds the control, the plain reference one
precision step lower (TF32 on) put in the program's place, and the
reference with each planted fault in its place: half of each batch's
answers left out (the first half's given twice), and one row's logit
altered.

Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from portbench import harness


def score_readings(cell: harness.Cell, seeds: list[int], control_seeds: int, calls: int,
                   device: torch.device) -> dict:
    from portbench.drivers.score_sequence import Scorer

    out = {"program": [], "control_tf32": [], "fault_half_batch": [], "fault_altered_logit": []}
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        sc = Scorer(cell.config, cell.traffic, seed, device)
        for c in range(calls * cell.traffic["pool_batches"]):
            sc.answers.append(sc.call(c))
        sc.release()
        ref = sc.reference_side()
        out["program"].append({"seed": seed, **sc.readings(ref=ref)[0]})
        if i < control_seeds:
            ctl = sc.reference_side(tf32=True)
            out["control_tf32"].append({"seed": seed, **sc.readings(ctl, ref)[0]})
            half = ref.shape[1] // 2
            gone = torch.cat([ref[:, :half], ref[:, :ref.shape[1] - half]], dim=1)
            out["fault_half_batch"].append({"seed": seed, **sc.readings(gone, ref)[0]})
            moved = ref.clone()
            moved[0, 0] += 1.0
            out["fault_altered_logit"].append({"seed": seed, **sc.readings(moved, ref)[0]})
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        del sc
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = harness.resolve(harness.load_spec(), args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    kind = cell.traffic["driver"]
    if kind != "score_sequence":
        raise SystemExit(f"calibrate: no calibration for driver {kind!r}")
    readings = score_readings(cell, seeds, args.control_seeds, args.calls, device)
    result = {"workload": args.workload, "device": torch.cuda.get_device_name(device),
              "first_seed": args.first_seed, **readings}
    text = json.dumps(result, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
