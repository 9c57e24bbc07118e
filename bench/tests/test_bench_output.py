"""The result line and the refusals: the keys in order, the numbers
compared beside their limits, no result without a card or without the
program beside the benchmark."""
import json
import shutil
import subprocess
import sys

from bench import harness, tracing
from bench.tests import tiny


def res(trace=None):
    out = {"peak": 123, "metrics": {"round_s": {"value": 1.5, "unit": "s"}},
           "attempted": 4, "failed": 0,
           "checks": [("loss", 1e-7, 2e-6), ("records", 0.0, 0.0)]}
    if trace is not None:
        out["trace"] = trace
    return out


def test_result_line_keys_in_order():
    dev = {"platform": "gpu", "kind": "X", "count": 1}
    line = harness.result_line(res(), dev)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["device"]["memory_peak_bytes"] == 123
    assert line["checks"]["loss"] == {"value": 1e-7, "limit": 2e-6}
    t = tracing.Trace(kind="round", busy_s=1.0, window_s=2.0,
                      device_ops=[("k", 0.5)], idle_gaps=[("x", 0.25)])
    line = harness.result_line(res(t), dev)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["device"]["busy_s"] == 1.0
    assert line["device"]["window_s"] == 2.0
    assert line["breakdown"] == {"device_ops": [["k", 0.5]],
                                 "idle_gaps": [["x", 0.25]]}
    json.dumps(line)


def test_a_number_over_its_limit_is_not_correct():
    r = res()
    r["checks"].append(("first_grad", 2.0, 1.0))
    assert harness.result_line(r, {})["correct"] is False
    r["checks"][-1] = ("first_grad", float("nan"), 1.0)
    assert harness.result_line(r, {})["correct"] is False


def test_no_result_without_a_card(capsys):
    """Here there is no CUDA device: a non-zero exit and no result."""
    import torch
    if torch.cuda.is_available():
        return
    code = harness.main(["--workload", "cnn_sampled_round", "--seed",
                         "3000000000", "--seconds", "1", "--trace", "0"])
    assert code != 0
    assert capsys.readouterr().out == ""


def test_no_result_beside_no_program(tmp_path):
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    run = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "cnn_sampled_round",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert run.stdout == ""
