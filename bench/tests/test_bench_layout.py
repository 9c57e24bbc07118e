"""The manifest and the files it names: every piece found by name, a cell
added by files alone, and the contract's limits on names and sizes."""
import re
import time

import pytest

from bench import harness
from bench.tests import tiny

MANIFEST = tiny.load(tiny.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_names():
    assert list(MANIFEST) == ["command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"]
    assert MANIFEST["paths"] == ["bench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MANIFEST[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    ends = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in ends
    assert all(0.01 <= m["bound"] <= 0.25 for m in MANIFEST["end_to_end"])
    assert all(m["moves"] in ends for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_found_by_name(cell):
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    spec, config = harness.load_cell(cell)
    assert spec["config"] == entry["config"] == config["name"]
    assert spec["chips"] == entry["chips"] == 1
    assert spec["traffic"] == entry["traffic"]
    assert spec["why"] == entry["why"] and len(entry["why"]) <= 200
    assert (harness.BENCH / "drivers" / f"{spec['driver']}.py").is_file()
    conf = next(c for c in MANIFEST["configs"] if c["name"] == config["name"])
    assert (tiny.ROOT / conf["file"]).is_file()
    assert set(conf["reduced"]) == set(config["reduced"])


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))
    m = next(x for x in MANIFEST["per_layer"] if x["name"] == metric)
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert set(m["workloads"]) <= cells


def test_cell_metrics_follow_the_manifest():
    ends, layers = harness.cell_metrics(
        MANIFEST, "cnn_ingest_k4096",
        {"setup_s": 0, "ingest_updates_per_s": 0, "ingest_round_p99_ms": 0})
    assert set(ends) == {"setup_s", "ingest_updates_per_s",
                         "ingest_round_p99_ms"}
    assert "server_agg_ms.ingest" in layers
    assert "server_agg_ms.round" not in layers


def test_a_cell_added_by_files_alone(tmp_path):
    """A new configuration and cell, as files in a directory laid out as
    ``bench/``, run through the harness unchanged."""
    manifest = tiny.write(tmp_path, ["tiny_round"])
    res = harness.run_cell("tiny_round", 7, 0.5, False,
                           time.perf_counter(), device="cpu", bench=tmp_path,
                           manifest=manifest)
    assert set(res["metrics"]) == {"setup_s", "round_s"}
    assert res["metrics"]["round_s"]["unit"] == "s"
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(v <= lim for _, v, lim in res["checks"])


def test_no_jax_check_compares_whole_top_level_names():
    found = harness.forbidden_modules(
        ["repro.x", "repro_torch.x", "repro_torch", "jax", "jaxlib.xla",
         "flax.linen", "reproduce", "jax_extra"])
    assert found == ["flax.linen", "jax", "jaxlib.xla", "repro.x"]
