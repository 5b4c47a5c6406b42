"""The control, on the card (marked ``card``; skipped without one).

The control must come out not correct: the plain reference one precision
step below the configuration's (TF32 on, against the reference with it
off) put in the program's place, at each scoring cell's own size. A
second test runs each cell whole, briefly and traced, and wants it
correct.
"""

import time

import pytest

from portbench import compare, harness
from portbench.tests.test_portbench_cells import SEED, SEQUENCE_CELLS, SPEC

pytestmark = pytest.mark.card


@pytest.mark.parametrize("name", SEQUENCE_CELLS)
def test_score_control_fails_at_the_cell_size(card, name):
    from portbench.drivers.score_sequence import Scorer

    cell = harness.resolve(SPEC, name)
    sc = Scorer(cell.config, cell.traffic, SEED, card)
    sc.warm()
    sc.release()
    ref = sc.reference_side()
    ok, table = compare.judge(sc.readings(ref=ref)[0], cell.traffic["limits"])
    assert ok, table
    ok, table = compare.judge(sc.readings(sc.reference_side(tf32=True), ref)[0],
                              cell.traffic["limits"])
    assert not ok, table


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_correct(card, name):
    line = harness.run_cell(SPEC, name, SEED + 1, 2.0, True, card, time.time())
    assert line["correct"], line["compared"]
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert line["metrics"], "a traced run reports its per-layer metrics"
