"""The cell's whole run, shrunk to a size the CPU holds: the program's
answers against the plain reference (``correct`` true), the same run with
the timed path broken underneath (``correct`` false, once for each fault
the cell can have), and no JAX module loaded by a dry run."""

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness

SPEC = harness.load_spec()
# Each traffic file's "small" block shrinks its cell to a size the CPU holds.
SMALL = {w["name"]: harness.resolve(SPEC, w["name"]).traffic.get("small")
         for w in SPEC["workloads"]}
SEQUENCE_CELLS = sorted(w["name"] for w in SPEC["workloads"]
                        if harness.resolve(SPEC, w["name"]).traffic["driver"] == "score_sequence")
SEED = 2**31 + 12345


def run_small(cell: str, seconds: float = 1.0) -> dict:
    return harness.run_cell(SPEC, cell, SEED, seconds, False,
                            torch.device("cpu"), time.time(), SMALL[cell])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_is_correct_on_the_cpu(cell):
    line = run_small(cell)
    assert line["correct"], line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "compared"


def _altered_logit(monkeypatch):
    """The forward moves the first row's logit by one where it produces it."""
    from igaming_platform_tpu_torch.models import sequence

    forward = sequence.SequenceModel.forward

    def broken(self, x, mesh=None, seq_mode="dense"):
        out = forward(self, x, mesh, seq_mode)
        logit = out["abuse_logit"]
        out["abuse_logit"] = torch.cat([logit[:1] + 1.0, logit[1:]])
        return out
    monkeypatch.setattr(sequence.SequenceModel, "forward", broken)


def _scored_half(monkeypatch):
    """The forward scores the first half of each batch and gives those
    answers again for the rest."""
    from igaming_platform_tpu_torch.models import sequence

    forward = sequence.SequenceModel.forward

    def broken(self, x, mesh=None, seq_mode="dense"):
        half = x.shape[0] // 2
        out = forward(self, x[:half], mesh, seq_mode)
        logit = out["abuse_logit"]
        out["abuse_logit"] = torch.cat([logit, logit[: x.shape[0] - half]])
        return out
    monkeypatch.setattr(sequence.SequenceModel, "forward", broken)


@pytest.mark.parametrize("cell", SEQUENCE_CELLS)
@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
def test_score_fault_is_caught(monkeypatch, fault, cell):
    (_scored_half if fault == "half_batch" else _altered_logit)(monkeypatch)
    line = run_small(cell)
    assert not line["correct"] and line["failed"] > 0, line


def test_dry_run_loads_no_jax():
    """Every cell runs (shrunk, on the CPU) in a fresh interpreter, which
    then holds no module whose top-level name is jax's or the JAX
    package's, compared whole."""
    code = (
        "import json, time, torch\n"
        "from portbench import harness\n"
        "from portbench.tests.test_portbench_cells import SMALL, SEED\n"
        "spec = harness.load_spec()\n"
        "for cell, ov in SMALL.items():\n"
        "    line = harness.run_cell(spec, cell, SEED, 0.5, False, torch.device('cpu'),\n"
        "                            time.time(), ov)\n"
        "    assert line['correct'], line\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=str(harness.ROOT), text=True,
                         capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert "igaming_platform_tpu_torch" not in harness.FORBIDDEN


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_every_cell_has_a_small_size(cell):
    assert SMALL[cell] and set(SMALL[cell]) <= {"config", "traffic"}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_every_reader_reads_its_cell(cell):
    """Every per-layer metric of a cell finds what it reads in that cell's
    run (its trace stood in for by hand: a CPU run has no device trace)."""
    resolved = harness.resolve(SPEC, cell)
    config = dict(resolved.config, **SMALL[cell]["config"])
    traffic = dict(resolved.traffic, **SMALL[cell]["traffic"])
    job = harness.Job(cell, config, traffic, SEED, 0.5, False, torch.device("cpu"))
    out = harness.driver(resolved).run(job)
    kernels = {name: {"seconds": 0.01, "count": 12} for name in (
        "flash_attention_fwd_kernel", "dense_fixed_kernel<x>")}
    run = {"trace": {"window_s": 1.0, "busy_s": 0.5, "kernels": kernels},
           "config": config, "traffic": traffic, **out["layer"]}
    for m in resolved.per_layer:
        value = harness.metric_reader(m["name"])(run)
        assert value is not None and value == value and value >= 0, m["name"]
