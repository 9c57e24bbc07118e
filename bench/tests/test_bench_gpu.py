"""On the card: the control (the reference one precision below the
configuration's, in the program's place) reads not correct in every cell,
at the tiny cells' sizes; and a tiny cell's whole run reads correct.
``python -m pytest -q -m gpu bench/tests/test_bench_gpu.py`` on a machine
with a CUDA device; here they skip."""
import importlib
import time

import pytest
import torch

from bench import checks, harness
from bench.tests import tiny


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_reads_not_correct(cell, tmp_path):
    dev = card()
    tiny.write(tmp_path, [cell])
    spec, config = harness.load_cell(cell, tmp_path)
    driver = importlib.import_module(f"bench.drivers.{spec['driver']}")
    got = [driver.control_readings(spec, config, seed, dev)
           for seed in (1, 2, 3)]
    for g in got:
        assert not checks.verdict([(n, g[n], lim)
                                   for n, lim in spec["limits"].items()]), g


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_tiny_cell_reads_correct(cell, tmp_path):
    card()
    manifest = tiny.write(tmp_path, [cell])
    res = harness.run_cell(cell, 17, 1.0, False, time.perf_counter(),
                           bench=tmp_path, manifest=manifest)
    assert harness.result_line(res, {})["correct"], res["checks"]
