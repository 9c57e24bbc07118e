"""Spans, kernel-operation ranges and the reduction of a profiler trace,
all from the benchmark's own files: the program is wrapped at the bound
names its callers use, only inside a traced run, and restored after.

A traced run has three phases, each a whole number of steps:

* ``plain``: nothing wrapped; its steps and seconds give the rates that
  per-layer shares of a peak divide by.
* ``profile``: ``torch.profiler`` on, every span a ``record_function``
  range (``bench.span.<name>``) and every kernel wrapper a range
  (``bench.op.<op>``) whose call's bytes and operations are counted by
  :mod:`bench.cost.kernels`; nothing synchronizes. Device busy time, the
  idle share, the kernels' roofline share, launches and the breakdown
  come from here.
* ``spans``: no profiler; each span is timed on the host clock between two
  synchronizes, so it holds all of its layer's device work.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from bench.cost import kernels as kcost
from bench.cost.peaks import bound_s

SPAN_PREFIX = "bench.span."
OP_PREFIX = "bench.op."
TOP = 10                     # entries of each list of the breakdown
NAME_WIDTH = 120             # characters kept of a device operation's name

# (module, attribute, operation, cost function): every name a caller
# binds a kernel wrapper under. ``kernels/ops.py`` imports three of them
# by name; ``core/codec.py`` imports from the defining modules at call
# time; ``models/attention.py`` binds kernel 6's three entries at import.
KERNEL_BINDINGS = (
    ("repro_torch.kernels.quantize", "quantize_blocks_2d", "quantize",
     kcost.quantize),
    ("repro_torch.kernels.ops", "quantize_blocks_2d", "quantize",
     kcost.quantize),
    ("repro_torch.kernels.quantize", "dequantize_blocks_2d", "dequantize",
     kcost.dequantize),
    ("repro_torch.kernels.ops", "dequantize_blocks_2d", "dequantize",
     kcost.dequantize),
    ("repro_torch.kernels.fused_dense", "fused_dense", "dense",
     kcost.dense),
    ("repro_torch.kernels.ops", "fused_dense", "dense", kcost.dense),
    ("repro_torch.kernels.fused_decode_agg", "fused_decode_agg",
     "decode_agg", kcost.decode_agg),
    ("repro_torch.models.attention", "flash_kernel", "attention",
     kcost.attention),
    ("repro_torch.models.attention", "flash_kernel_padded", "attention",
     kcost.attention),
    ("repro_torch.models.attention", "flash_kernel_extra", "attention",
     kcost.attention_extra),
)


@dataclasses.dataclass
class Trace:
    """What a traced run measured, handed to every per-layer reader
    (``bench/metrics/<name>.py``). ``kind`` is the driver's (``round`` or
    ``ingest``); readers of another kind's metric return None."""

    kind: str
    steps: Dict[str, int] = dataclasses.field(default_factory=dict)
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    # op -> [bound seconds, device seconds of its kernels, calls]
    ops: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    device_ops: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)
    idle_gaps: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)
    step_flops: Optional[float] = None      # model operations a step
    peak_flops: Optional[float] = None      # of the model's precision
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)

    def span_ms_a_step(self, name: str) -> Optional[float]:
        """A span's milliseconds a step of the ``spans`` phase."""
        durs = self.spans.get(name)
        n = self.steps.get("spans", 0)
        if not durs or not n:
            return None
        return 1e3 * sum(durs) / n

    def plain_step_s(self) -> Optional[float]:
        n = self.steps.get("plain", 0)
        return self.seconds["plain"] / n if n else None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def patched(targets: Sequence[Tuple[object, str, Callable]]):
    """Set each ``(owner, attribute, wrapper factory)``: the attribute
    becomes ``factory(original)``; every one is restored on exit."""
    saved = []
    try:
        for owner, attr, factory in targets:
            orig = getattr(owner, attr)
            saved.append((owner, attr, orig, attr in vars(owner)))
            setattr(owner, attr, factory(orig))
        yield
    finally:
        for owner, attr, orig, own in reversed(saved):
            if own:
                setattr(owner, attr, orig)
            else:                    # a method found on the instance's class
                delattr(owner, attr)


def span_targets(spans: Sequence[Tuple[str, object, str]], mode: str,
                 trace: Trace, device: torch.device):
    """Wrappers for ``(span name, owner, attribute)``: a profiler range in
    ``profile`` mode, a host-clock span between synchronizes in ``spans``
    mode."""
    out = []
    for name, owner, attr in spans:
        def factory(fn, name=name):
            if mode == "profile":
                def wrapped(*a, **k):
                    with torch.profiler.record_function(SPAN_PREFIX + name):
                        return fn(*a, **k)
            else:
                def wrapped(*a, **k):
                    sync(device)
                    t0 = time.perf_counter()
                    out_ = fn(*a, **k)
                    sync(device)
                    trace.spans.setdefault(name, []).append(
                        time.perf_counter() - t0)
                    return out_
            return wrapped
        out.append((owner, attr, factory))
    return out


def op_targets(costs: List[Tuple[str, float]]):
    """Wrappers for every kernel binding: a ``bench.op.<op>`` range, and
    the call's bound (seconds) appended to ``costs``."""
    import importlib
    out = []
    for mod_name, attr, op, cost_fn in KERNEL_BINDINGS:
        mod = importlib.import_module(mod_name)

        def factory(fn, op=op, cost_fn=cost_fn):
            def wrapped(*a, **k):
                nbytes, flops, dtype = cost_fn(*a, **k)
                costs.append((op, bound_s(nbytes, flops, dtype)))
                with torch.profiler.record_function(OP_PREFIX + op):
                    return fn(*a, **k)
            return wrapped
        out.append((mod, attr, factory))
    return out


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _is_ours(name: str) -> bool:
    return name.startswith(SPAN_PREFIX) or name.startswith(OP_PREFIX)


def _merged(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_us(intervals) -> float:
    """Union of the device kernels' intervals (``chip_smoke.busy_ms``'s
    arithmetic)."""
    return sum(e - s for s, e in _merged(intervals))


def _kernel_us(evt) -> float:
    """Device microseconds of every kernel linked to a CPU event and its
    children (where the profiler draws no device-side range)."""
    total = sum(k.duration for k in evt.kernels if not _is_ours(k.name))
    return total + sum(_kernel_us(c) for c in evt.cpu_children)


def _contained_us(ranges, kernels) -> float:
    """Σ of the kernels' durations that lie inside any of the device-side
    ranges (both lists of ``(start, end)``, kernels sorted by start)."""
    import bisect
    starts = [s for s, _ in kernels]
    total = 0.0
    for a, b in ranges:
        i = bisect.bisect_left(starts, a)
        while i < len(kernels) and kernels[i][0] < b:
            if kernels[i][1] <= b:
                total += kernels[i][1] - kernels[i][0]
            i += 1
    return total


def reduce_profile(prof, trace: Trace, costs, wall_s: float) -> None:
    """Fill ``trace`` from one ``profile`` phase: busy seconds, the traced
    window, each operation's bound against the device time of the kernels
    that ran under its calls, the :data:`TOP` device operations that took
    longest (names cut to :data:`NAME_WIDTH` characters) and the idle gaps
    summed by the span the host was in at each gap's midpoint.

    The profiler draws each ``record_function`` range on the device's
    timeline too, spanning the kernels launched inside it; those ranges
    are no device work, and are what attributes kernels to an
    operation."""
    events = prof.events()
    dev = [e for e in events if _is_device(e) and not _is_ours(e.name)]
    trace.window_s = wall_s
    if not dev:
        return
    iv = sorted((e.time_range.start, e.time_range.end) for e in dev)
    trace.busy_s = busy_us(iv) / 1e6
    by_name: Dict[str, float] = {}
    for e in dev:
        name = e.name[:NAME_WIDTH]
        by_name[name] = by_name.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
    trace.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    for op, b in costs:
        row = trace.ops.setdefault(op, [0.0, 0.0, 0])
        row[0] += b
        row[2] += 1
    dev_ranges: Dict[str, list] = {}
    linked: Dict[str, float] = {}
    spans = []
    for e in events:
        if e.name.startswith(OP_PREFIX):
            op = e.name[len(OP_PREFIX):]
            if _is_device(e):
                dev_ranges.setdefault(op, []).append(
                    (e.time_range.start, e.time_range.end))
            else:
                linked[op] = linked.get(op, 0.0) + _kernel_us(e)
        elif e.name.startswith(SPAN_PREFIX) and not _is_device(e):
            spans.append((e.time_range.start, e.time_range.end,
                          e.name[len(SPAN_PREFIX):]))
    for op, row in trace.ops.items():
        us = (_contained_us(_merged(dev_ranges.get(op, [])), iv)
              if dev_ranges else linked.get(op, 0.0))
        row[1] = us / 1e6
    import bisect
    spans.sort()
    starts = [s for s, _, _ in spans]
    merged = _merged(iv)
    gaps: Dict[str, float] = {}
    for (_, a), (b, _) in zip(merged[:-1], merged[1:]):
        mid = 0.5 * (a + b)
        # the innermost span holding the midpoint: the latest to begin
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0 and spans[i][1] < mid:
            i -= 1
        label = spans[i][2] if i >= 0 else "outside_spans"
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    trace.idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]


def profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def launches() -> Dict[str, int]:
    from repro_torch.kernels import _lib
    return dict(_lib.LAUNCHES)


def run_phases(trace: Trace, step: Callable[[], None], seconds: float,
               spans: Sequence[Tuple[str, object, str]],
               device: torch.device, caps: Dict[str, float] = None) -> None:
    """The three phases of a traced run, a third of ``seconds`` each (or
    ``caps[phase]`` seconds where less), each at least one step of
    ``step``."""
    caps = caps or {}
    third = seconds / 3.0

    def loop(phase: str) -> None:
        limit = min(third, caps.get(phase, third))
        sync(device)
        n, t0 = 0, time.perf_counter()
        while n == 0 or time.perf_counter() - t0 < limit:
            step()
            n += 1
        sync(device)
        trace.steps[phase] = n
        trace.seconds[phase] = time.perf_counter() - t0

    loop("plain")
    costs: List[Tuple[str, float]] = []
    before = launches()
    with patched(span_targets(spans, "profile", trace, device)
                 + op_targets(costs)):
        with profiler(device) as prof:
            loop("profile")
    after = launches()
    trace.launches = {k: v - before.get(k, 0) for k, v in after.items()
                      if v - before.get(k, 0)}
    reduce_profile(prof, trace, costs, trace.seconds["profile"])
    with patched(span_targets(spans, "spans", trace, device)):
        loop("spans")
