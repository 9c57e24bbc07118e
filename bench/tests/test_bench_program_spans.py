"""The readers of the program's own spans and counters
(``repro_torch.trace``, through ``bench/program_spans.py``): each over a
hand-made snapshot, divided by the profile phase's steps; nothing for the
other kind of cell, for an empty aggregate, or for a program without the
module (a parent commit)."""
import sys

import pytest
import torch

from bench import harness, program_spans, tracing

SNAP = {"spans": {
    "round": {"calls": 4, "total_s": 4.0, "self_s": 0.1, "parents": [""]},
    "client_train": {"calls": 4, "total_s": 2.0, "self_s": 0.2,
                     "parents": ["round"]},
    "client_encode": {"calls": 400, "total_s": 0.8, "self_s": 0.3,
                      "parents": ["round"]},
    "server_agg": {"calls": 4, "total_s": 0.04, "self_s": 0.01,
                   "parents": ["round"]},
    "host_sync": {"calls": 100, "total_s": 0.02, "self_s": 0.02,
                  "parents": ["client_train"]},
    "ingest.decode_agg": {"calls": 4, "total_s": 0.012, "self_s": 0.002,
                          "parents": ["ingest_step"]},
    "kernel.fused_dense": {"calls": 4, "total_s": 0.004, "self_s": 0.004,
                           "parents": ["ingest.decode_agg"]},
    "kernel.fused_decode_agg": {"calls": 4, "total_s": 0.002,
                                "self_s": 0.002,
                                "parents": ["ingest.decode_agg"]}},
    "counters": {"host_syncs": 100, "cuda_frees": 6}}
# metric: (kind, value a step of SNAP over 4 profiled steps)
WANT = {"client_train_host_ms": ("round", 500.0),
        "client_encode_host_ms": ("round", 200.0),
        "server_agg_host_ms.round": ("round", 10.0),
        "server_agg_host_ms.ingest": ("ingest", 3.0),
        "kernel_host_ms": ("ingest", 1.5),
        "host_syncs.round": ("round", 25.0),
        "host_syncs.ingest": ("ingest", 25.0),
        "host_sync_ms.round": ("round", 5.0),
        "cuda_frees.round": ("round", 1.5)}


def traced(kind, steps=4):
    return tracing.Trace(kind=kind, steps={"plain": 9, "profile": steps,
                                           "spans": 7})


@pytest.fixture
def snap(monkeypatch):
    box = {"snap": SNAP}
    monkeypatch.setattr(program_spans, "snapshot", lambda: box["snap"])
    return box


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_over_a_snapshot(metric, snap):
    kind, want = WANT[metric]
    read = harness.reader(metric)
    assert read(traced(kind)) == pytest.approx(want)
    assert read(traced(kind, steps=8)) == pytest.approx(want / 2)
    other = "ingest" if kind == "round" else "round"
    assert read(traced(other)) is None
    assert read(traced(kind, steps=0)) is None
    snap["snap"] = None                            # an empty aggregate
    assert read(traced(kind)) is None


def test_counters_and_blocked_time_read_zero_where_nothing_counted(snap):
    snap["snap"] = {"spans": {"ingest_step": {"calls": 4, "total_s": 0.1,
                                              "self_s": 0.1,
                                              "parents": [""]}},
                    "counters": {}}
    assert harness.reader("host_syncs.ingest")(traced("ingest")) == 0.0
    assert harness.reader("host_sync_ms.round")(traced("round")) == 0.0
    assert harness.reader("client_train_host_ms")(traced("round")) is None


def test_snapshot_of_the_program_and_of_a_parent(monkeypatch):
    """The live aggregate: a span recorded under a profiler is read; a
    program without ``repro_torch.trace`` gives nothing."""
    from repro_torch import trace
    trace.reset()
    assert program_spans.snapshot() is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("client_encode"):
            trace.to_host(torch.ones(1))
    got = harness.reader("host_syncs.round")(traced("round", steps=1))
    assert got == 1.0
    assert harness.reader("client_encode_host_ms")(
        traced("round", steps=1)) > 0
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert program_spans.snapshot() is None
    assert harness.reader("host_syncs.round")(traced("round")) is None
    trace.reset()
