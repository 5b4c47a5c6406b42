"""The harness: finds a cell's files by name, runs it once, prints its line.

Everything a cell needs is found from ``BENCHMARK.json`` by name:

- the configuration's file (``configs/<name>.json``), its sizes as run;
- the traffic mix's file (``traffic/<name>.json``), parameters only; its
  ``driver`` names the one general driver (``drivers/<driver>.py``) that
  reads such a mix;
- each per-layer metric's reader (``metrics/<metric name>.py``, a
  ``read(run)`` that returns a number, or None when it finds nothing).

A driver's ``run(job)`` builds the system under test, warms it up, measures
its window and judges what the timed path produced; the harness adds the
set-up time, the per-layer metrics of a traced run and the device, and
checks that no JAX module was loaded.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench import compare

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "igaming_platform_tpu")


def load_spec(path: Path | None = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _applies(metric: dict, cell_name: str, reported: set[str]) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def resolve(spec: dict, workload: str) -> Cell:
    """A cell with its configuration, traffic and metrics, from their files."""
    w = _by_name(spec["workloads"], workload, "workload")
    centry = _by_name(spec["configs"], w["config"], "config")
    config = json.loads((ROOT / centry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, workload, reported)]
    return Cell(w, config, traffic, e2e, per_layer)


def driver(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``; the name may hold dots."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Job:
    """What a driver gets: the cell's sizes and the run's arguments."""

    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def run_cell(spec: dict, workload: str, seed: int, seconds: float, traced: bool,
             device: torch.device, process_start: float, overrides: dict | None = None) -> dict:
    """One run of one cell: the result line as a dict. ``overrides``
    ({"config": {...}, "traffic": {...}}) shrink a cell for a test on the
    CPU."""
    cell = resolve(spec, workload)
    config, traffic = dict(cell.config), dict(cell.traffic)
    for part, d in (("config", config), ("traffic", traffic)):
        d.update((overrides or {}).get(part, {}))
    job = Job(workload, config, traffic, seed, seconds, traced, device)
    out = driver(cell).run(job)
    metrics: dict[str, dict] = {}
    if traced:
        run = {"trace": out["trace"], "config": config, "traffic": traffic, **out["layer"]}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["end_to_end"], setup_s=out["t_open"] - process_start)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.workload["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = out["trace"]["busy_s"]
        dev["window_s"] = out["trace"]["window_s"]
        line["breakdown"] = out["trace"]["breakdown"]
    line["compared"] = out["compared"]
    return line


def main(argv: list[str], process_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="portbench.run", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    cell = resolve(spec, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available():
        print("portbench: no CUDA device: this benchmark runs on the card only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    print(f"setup: process start to harness {time.time() - process_start:.2f} s",
          file=sys.stderr, flush=True)
    line = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), process_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: JAX modules loaded in the run: {found}", file=sys.stderr)
        return 4
    compare.print_table(line["compared"])
    print(json.dumps(line), flush=True)
    return 0


def process_start_time() -> float:
    """When this process started, on ``time.time()``'s clock (Linux's
    /proc; else now)."""
    try:
        import os

        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / ticks)
    except (OSError, ValueError, IndexError):
        return time.time()
