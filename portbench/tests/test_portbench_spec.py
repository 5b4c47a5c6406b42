"""BENCHMARK.json resolves, entry by entry, to the files under portbench/."""

import json

import pytest

from portbench import harness

SPEC = harness.load_spec()


def test_command_and_paths_name_only_the_benchmark():
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"][1].startswith("portbench/")
    assert (harness.ROOT / SPEC["command"][1]).is_file()


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    cfg = json.loads((harness.ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("portbench/configs/")
    assert (harness.ROOT / cfg["reference"]).is_file()
    assert entry["reduced"] == []


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda e: e["name"])
def test_cell_resolves(cell):
    resolved = harness.resolve(SPEC, cell["name"])
    assert harness.driver(resolved).run
    names = {m["name"] for m in resolved.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert resolved.per_layer, "every cell reports a per-layer metric"
    assert all(m["moves"] in names for m in resolved.per_layer)


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert callable(harness.metric_reader(metric["name"]))
    assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
