"""The control on the card: each cell of ``BENCHMARK.json`` at its own
widths, deployment and load for a short window, judged by the reference
and by the fp8 reference put in the program's place.  The program has to
stay within the cell's limit and the control has to exceed it.  The
limits in ``limits/`` were set from ``calibrate.py``'s readings over a
dozen seeds at the full window (PERF.md)."""
import json
import time

import pytest

from harness import report, spec
from harness.spec import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(card, workload):
    cell = spec.load_cell(workload)
    res = report.run_cell(cell, 2 ** 31 + 101, 12.0, False, card,
                          time.perf_counter(), control=True)
    limit = cell.limits["logit_gap"]
    assert res["correct"], res["checks"]
    assert res["checks"]["logit_gap"]["value"] <= limit
    assert res["_control_gap"] > limit
