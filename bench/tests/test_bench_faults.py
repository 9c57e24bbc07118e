"""A run with its timed path broken underneath reads not correct: each
fault a cell can have (a step that returns its state unchanged; half of
the batch left out, the mean taken over the rest; an answer altered where
it is produced), through the whole run but the look for a chip."""
import importlib
import time

import pytest

from bench import harness, tracing
from bench.tests import tiny

CASES = [(cell, fault) for cell in sorted(tiny.CELLS)
         for fault in importlib.import_module(
             "bench.drivers." + tiny.load(
                 tiny.BENCH / "workloads"
                 / f"{tiny.CELLS[cell][0]}.json")["driver"]).FAULTS]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_reads_not_correct(cell, fault, tmp_path):
    manifest = tiny.write(tmp_path, [cell])
    spec, _ = harness.load_cell(cell, tmp_path)
    driver = importlib.import_module(f"bench.drivers.{spec['driver']}")
    with tracing.patched(driver.faults(fault)):
        res = harness.run_cell(cell, 13, 0.3, False, time.perf_counter(),
                               device="cpu", bench=tmp_path,
                               manifest=manifest)
    line = harness.result_line(res, {})
    assert line["correct"] is False, line["checks"]
