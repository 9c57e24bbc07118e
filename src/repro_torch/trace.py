"""Spans and counters of the port, on the profiler's clock.

``span(name)`` (or the decorator ``spanned(name)``) marks a phase of the
round or the serve step; ``count(name, n)`` counts an event;
``to_host(t)`` and ``to_device(x, device, dtype)`` are the only way the
round and serve paths move data between the host and the device, each
counted as one ``host_syncs`` and timed as the span ``host_sync``.

All of it records only while a ``torch.profiler`` (or any autograd
profiler) records: every entry asks ``torch.autograd._profiler_enabled()``
afresh, and with no profiler a span is one shared no-op context and a
counter does nothing. While on, a span

* enters ``_RecordFunctionFast(name)``: an ordinary CPU operation of the
  trace, nested under its parent and beside the kernels it launched in an
  exported chrome trace. Unlike ``record_function`` it draws no user
  annotation on the device's timeline, so a span is never device work to
  whoever reduces the trace;
* adds its host seconds (``time.perf_counter_ns``) to an aggregate by
  name: calls, total seconds, and self seconds (total less the spans that
  ran directly inside it), with the names of the spans it ran inside.

``snapshot()`` returns the aggregate, ``reset()`` clears it. The
aggregate is per process and assumes one thread records. Host times taken
under a profiler include the profiler's cost for every operation: compare
them between commits, not against an unprofiled round's seconds.

``core/distributed.py``'s ``fl_round.*`` ranges stay ``record_function``
ranges: ``chip_smoke.py`` reads their device-side annotations.
"""
from __future__ import annotations

import functools
import time
from typing import Any, Dict, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

_on = torch.autograd._profiler_enabled

# name -> [calls, total ns, self ns, set of parent names]
_SPANS: Dict[str, list] = {}
_COUNTERS: Dict[str, int] = {}
_STACK: List["_Span"] = []


class _Null:
    """The context every span is while no profiler records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "frees", "rf", "t0", "inner", "stats")

    def __init__(self, name: str, frees: bool = False):
        self.name, self.frees = name, frees

    def __enter__(self):
        self.stats = _free_calls() if self.frees else None
        self.rf = _RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.inner = 0
        _STACK.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        _STACK.pop()
        parent = _STACK[-1] if _STACK else None
        if parent is not None:
            parent.inner += dt
        row = _SPANS.get(self.name)
        if row is None:
            row = _SPANS[self.name] = [0, 0, 0, set()]
        row[0] += 1
        row[1] += dt
        row[2] += dt - self.inner
        row[3].add(parent.name if parent is not None else "")
        self.rf.__exit__(*exc)
        if self.stats is not None:
            count("cuda_frees", _free_calls() - self.stats)
        return False


def _free_calls() -> int:
    """``cudaFree`` calls of the caching allocator so far, and the
    allocations it retried after freeing its cache; 0 without CUDA."""
    if not torch.cuda.is_initialized():
        return 0
    st = torch.cuda.memory_stats()
    return st["num_device_free"] + st["num_alloc_retries"]


def span(name: str, *, frees: bool = False):
    """A context over one phase named ``name`` (module docstring);
    ``frees`` also counts the allocator's ``cuda_frees`` inside it."""
    if not _on():
        return _NULL
    return _Span(name, frees)


def spanned(name: str, *, frees: bool = False):
    """:func:`span` as a decorator: every call of the function is one
    span."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on():
                return fn(*args, **kwargs)
            with _Span(name, frees):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (while a profiler records)."""
    if _on():
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the CPU: a device-to-host read that waits for the device.
    Counted wherever ``t`` lives, so a CPU run counts what a card run
    would."""
    if not _on():
        return t.cpu()
    count("host_syncs")
    with _Span("host_sync"):
        return t.cpu()


def to_device(x: Any, device, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``: host data (a
    list, a number, an array or a CPU tensor) copied to ``device``, from
    pageable memory, so the host waits for the device's queue. Counted as
    :func:`to_host` is."""
    if not _on():
        return torch.as_tensor(x, dtype=dtype, device=device)
    count("host_syncs")
    with _Span("host_sync"):
        return torch.as_tensor(x, dtype=dtype, device=device)


def snapshot() -> Dict[str, Dict]:
    """``{"spans": {name: {"calls", "total_s", "self_s", "parents"}},
    "counters": {name: n}}``, a copy of the aggregate."""
    return {"spans": {k: {"calls": r[0], "total_s": r[1] / 1e9,
                          "self_s": r[2] / 1e9, "parents": sorted(r[3])}
                      for k, r in _SPANS.items()},
            "counters": dict(_COUNTERS)}


def reset() -> None:
    _SPANS.clear()
    _COUNTERS.clear()
