"""What the program's own spans and counters (``repro_torch.trace``)
recorded in a traced run's ``profile`` phase, a step at a time, for the
per-layer readers that read them.

``repro_torch.trace`` records only while a profiler records, so after a
traced run its aggregate holds exactly the ``profile`` phase's steps.
Host times taken there include the profiler's cost for every operation:
they are compared between commits, not against an unprofiled round.
A program without ``repro_torch.trace``, or whose aggregate is empty,
gives nothing to read: every function here returns None then.
"""
from __future__ import annotations

import importlib
from typing import Dict, Iterable, Optional


def snapshot() -> Optional[Dict]:
    """The program's aggregate, or None when it has none or it is
    empty."""
    try:
        trace = importlib.import_module("repro_torch.trace")
    except ImportError:
        return None
    snap = trace.snapshot()
    return snap if snap["spans"] or snap["counters"] else None


def _steps(trace, kind: str) -> Optional[int]:
    n = trace.steps.get("profile", 0)
    return n if trace.kind == kind and n else None


def span_ms(trace, kind: str, names: Iterable[str]) -> Optional[float]:
    """Host milliseconds a step inside the spans ``names`` (their total
    time, summed); None where the trace is of another kind, the aggregate
    is empty, or none of the spans ran."""
    n, snap = _steps(trace, kind), snapshot()
    if n is None or snap is None:
        return None
    got = [snap["spans"][s]["total_s"] for s in names if s in snap["spans"]]
    return 1e3 * sum(got) / n if got else None


def counter(trace, kind: str, name: str) -> Optional[float]:
    """Counter ``name`` a step (0 where it never counted but the aggregate
    holds something); None where the trace is of another kind or the
    aggregate is empty."""
    n, snap = _steps(trace, kind), snapshot()
    if n is None or snap is None:
        return None
    return snap["counters"].get(name, 0) / n


def kernel_spans() -> Iterable[str]:
    snap = snapshot()
    return [s for s in (snap or {"spans": {}})["spans"]
            if s.startswith("kernel.")]
