"""Cells whose step is one round of the serve loop (``core/serve.py``'s
``make_step``): an N-client population streams encoded payloads, the
first K arrivals are decoded and aggregated into the global model, those
K are re-dispatched. A closed loop: each step is enqueued as soon as the
host can.

Set-up draws the codec's autoencoder and the global model from ``--seed``,
builds the step and its initial state, and plays ``check_rounds`` steps
through it, keeping each step's state before and after for the
correctness check; the window keeps two more pairs at steps drawn from
the seed.
"""
from __future__ import annotations

import gc
import importlib
import math
import time
from types import SimpleNamespace
from typing import Dict, List

import torch

from bench import checks, data as bdata, tracing
from bench.drivers.fl_round import chunked_ae, clone, tf32

KIND = "ingest"
END_TO_END = ("ingest_updates_per_s", "ingest_round_p99_ms")
WARM_STEPS = 20            # past the checked steps: the allocator settles


def inputs(cell: Dict, config: Dict, seed: int, device: torch.device
           ) -> SimpleNamespace:
    w = bdata.seed_words(seed, 4)
    ae = chunked_ae(bdata.generator(w[0], device), config["codec"])
    size = config["model"]["n_params"]
    g = torch.randn((size,), generator=bdata.generator(w[1], device),
                    device=device) * 0.05
    # two steps of the window, kept for the check
    picks = sorted(torch.randint(5, 50, (2,), generator=torch.Generator()
                                 .manual_seed(w[3])).tolist())
    return SimpleNamespace(ae=ae, global_flat=g, serve_seed=w[2],
                           size=size, picks=picks)


def build_program(cell: Dict, config: Dict, x: SimpleNamespace,
                  device: torch.device):
    from repro_torch.core import (ChunkedAECompressor, ChunkedAEConfig,
                                  ComposedCompressor)
    from repro_torch.core.serve import ServeConfig, init_state, make_step
    c, t = config["codec"], cell["traffic_params"]
    ae_cfg = ChunkedAEConfig(chunk_size=c["chunk_size"],
                             hidden=tuple(c["hidden"]),
                             latent_chunk=c["latent_chunk"])
    ae = clone(x.ae)
    comp = ComposedCompressor(ChunkedAECompressor(ae, ae_cfg,
                                                  use_kernel=True),
                              bits=c["bits"], block=c["block"])
    cfg = ServeConfig(
        n_clients=t["n_clients"], buffer_k=t["buffer_k"],
        spec=comp.spec(x.size), staleness_power=t["staleness_power"],
        server_lr=t["server_lr"], base_latency=t["base_latency"],
        jitter=t["jitter"], straggler_frac=t["straggler_frac"],
        straggler_mult=t["straggler_mult"], seed=x.serve_seed)
    params = comp.codec_params()
    step = make_step(cfg, params, device)
    state = init_state(cfg, params, global_flat=x.global_flat.clone(),
                       device=device)
    return step, state


def snapshot(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in state.items()}


def setup(cell: Dict, config: Dict, seed: int, device: torch.device
          ) -> SimpleNamespace:
    x = inputs(cell, config, seed, device)
    step, state = build_program(cell, config, x, device)
    sut = SimpleNamespace(cell=cell, config=config, seed=seed,
                          device=device, x=x, step=step, state=state,
                          pairs=[], attempted=0, failed=0)
    for r in range(cell["check_rounds"] + WARM_STEPS):
        if r < cell["check_rounds"]:
            before = snapshot(sut.state)
            sut.state = step(sut.state)
            sut.pairs.append((before, snapshot(sut.state)))
        else:
            sut.state = step(sut.state)
    tracing.sync(device)
    return sut


def window(sut, seconds: float) -> Dict[str, float]:
    """Steps until ``seconds`` have passed, a CUDA event recorded after
    each (no synchronize), one synchronize at the end. The rate is the
    window's updates over its seconds; the tail is the 99th percentile of
    every gap between consecutive step-end events."""
    k = sut.cell["traffic_params"]["buffer_k"]
    on_cuda = sut.device.type == "cuda"
    picks = set(sut.x.picks)
    events: List = []
    tracing.sync(sut.device)
    t0, n = time.perf_counter(), 0
    start = torch.cuda.Event(enable_timing=True) if on_cuda else None
    if on_cuda:
        start.record()
    while n == 0 or time.perf_counter() - t0 < seconds:
        before = snapshot(sut.state) if n in picks else None
        sut.state = sut.step(sut.state)
        if before is not None:
            sut.pairs.append((before, snapshot(sut.state)))
        if on_cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append(e)
        n += 1
    tracing.sync(sut.device)
    dt = time.perf_counter() - t0
    sut.attempted = n * k
    out = {"ingest_updates_per_s": n * k / dt}
    if on_cuda:
        gaps = [a.elapsed_time(b) for a, b in zip([start] + events[:-1],
                                                  events)]
        out["ingest_round_p99_ms"] = p99(gaps)
    return out


def p99(xs) -> float:
    """The 99th percentile by nearest rank: the smallest value with at
    least 99 % of the values at or below it."""
    xs = sorted(xs)
    return float(xs[max(0, math.ceil(0.99 * len(xs)) - 1)])


def traced(sut, seconds: float) -> tracing.Trace:
    trace = tracing.Trace(kind=KIND)
    codec_mod = importlib.import_module("repro_torch.core.codec")
    serve_mod = importlib.import_module("repro_torch.core.serve")

    def step():
        sut.state = sut.step(sut.state)
    # long phases would only lengthen the trace's reduction
    tracing.run_phases(trace, step, seconds,
                       [("server_agg", codec_mod, "decode_and_aggregate"),
                        ("pop", serve_mod, "pop_k_device"),
                        ("payloads", serve_mod, "synthetic_payloads")],
                       sut.device, caps={"profile": 2.0})
    # the host's enqueue of a step, the device idle before it
    host, t_end = [], time.perf_counter() + min(seconds / 6.0, 1.0)
    while not host or time.perf_counter() < t_end:
        tracing.sync(sut.device)
        t0 = time.perf_counter()
        sut.state = sut.step(sut.state)
        host.append(time.perf_counter() - t0)
        tracing.sync(sut.device)
    trace.extra["host_step_ms"] = 1e3 * sum(host) / len(host)
    sut.attempted = (sum(trace.steps.values()) + len(host)) \
        * sut.cell["traffic_params"]["buffer_k"]
    return trace


def readings(pairs, refs, init_prog, init_ref) -> Dict[str, float]:
    """``state``: integer entries that differ (the pop order through the
    re-dispatched sequence numbers, versions, the global version and next
    sequence number); ``times``: the largest gap of an arrival time or
    the clock; ``update``: the largest gap of the global model's update
    over its largest value. The initial state is held too."""
    ints = ("seqs", "versions", "version", "next_seq")
    exact = sum(int((init_prog[k] != init_ref[k]).sum()) for k in ints)
    times = float((init_prog["times"] - init_ref["times"]).abs().max())
    upd = 0.0
    for (before, after), ref in zip(pairs, refs):
        exact += sum(int((after[k] != ref[k]).sum()) for k in ints)
        times = max(times, float((after["times"] - ref["times"]).abs().max()),
                    float((after["clock"] - ref["clock"]).abs()))
        d_prog = after["global_flat"] - before["global_flat"]
        d_ref = ref["global_flat"] - before["global_flat"]
        upd = max(upd, checks.max_gap(d_prog, d_ref))
    return {"state": float(exact), "times": times, "update": upd}


def reference_steps(cell: Dict, config: Dict, seed: int, pairs,
                    device: torch.device):
    """The reference's step from each kept state, and its initial state."""
    from bench.reference import serve_ingest
    x = inputs(cell, config, seed, device)
    t = cell["traffic_params"]
    refs = [serve_ingest.step(before, t, x.ae, config["codec"], x.size,
                              x.serve_seed) for before, _ in pairs]
    init = serve_ingest.initial(t, x.serve_seed, x.global_flat)
    return refs, init


def check_readings(sut) -> Dict[str, float]:
    cell, config, seed, dev = sut.cell, sut.config, sut.seed, sut.device
    pairs = sut.pairs
    sut.step = sut.state = sut.x = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tf32(False):
        refs, init = reference_steps(cell, config, seed, pairs, dev)
    return readings(pairs, refs, pairs[0][0], init)


def control_readings(cell: Dict, config: Dict, seed: int,
                     device: torch.device) -> Dict[str, float]:
    """The reference step computed with TF32 (the precision below the
    configuration's float32) in the program's place, from the reference's
    own states, held to the reference step at float32."""
    from bench.reference import serve_ingest
    x = inputs(cell, config, seed, device)
    t = cell["traffic_params"]
    init = serve_ingest.initial(t, x.serve_seed, x.global_flat)
    pairs, refs, st = [], [], init
    for _ in range(cell["check_rounds"]):
        with tf32(True):
            low = serve_ingest.step(st, t, x.ae, config["codec"], x.size,
                                    x.serve_seed)
        with tf32(False):
            ref = serve_ingest.step(st, t, x.ae, config["codec"], x.size,
                                    x.serve_seed)
        pairs.append((st, low))
        refs.append(ref)
        st = ref
    return readings(pairs, refs, init, init)


def faults(name: str) -> list:
    """Patch targets that break the timed path underneath: ``unchanged``,
    a step that returns its state as it was; ``half_batch``, the
    aggregate over the first half of the cohort, its weights
    renormalized; ``altered``, one re-dispatched client's arrival time
    moved where the step produces it."""
    serve_mod = importlib.import_module("repro_torch.core.serve")
    codec_mod = importlib.import_module("repro_torch.core.codec")
    if name == "unchanged":
        return [(serve_mod._Step, "__call__",
                 lambda fn: lambda self, state: state)]
    if name == "half_batch":
        def half(fn):
            depth = [0]

            def agg(spec, params, stacked, w, *a, **k):
                if depth[0]:                  # the codec's own recursion
                    return fn(spec, params, stacked, w, *a, **k)
                h = w.shape[0] // 2
                depth[0] += 1
                try:
                    return fn(spec, params, _rows(stacked, h),
                              w[:h] / w[:h].sum(), *a, **k)
                finally:
                    depth[0] -= 1
            return agg
        return [(codec_mod, "decode_and_aggregate", half)]
    if name == "altered":
        def alter(fn):
            def call(self, state):
                out = fn(self, state)
                out["times"][int(out["seqs"].argmax())] += 1.0
                return out
            return call
        return [(serve_mod._Step, "__call__", alter)]
    raise KeyError(name)


FAULTS = ("unchanged", "half_batch", "altered")


def _rows(tree, h: int):
    if isinstance(tree, dict):
        return {k: _rows(v, h) for k, v in tree.items()}
    return tree[:h]
