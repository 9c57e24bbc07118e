"""Blockwise absmax quantization: wrappers over the CUDA kernels in
``csrc/quantize.cu`` (port of ``repro/kernels/quantize.py``).

:func:`kernel_route` picks each launch's body, block size and grid from the
shape and the pointers' alignment: ``rows`` (quantize) and ``stream``
(dequantize) take 16-byte accesses, ``generic`` takes any block and any
alignment. A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches a kernel or raises.
"""
from __future__ import annotations

import collections
from typing import NamedTuple, Tuple

import torch

from repro_torch import trace
from repro_torch.kernels import _lib, ref

VECTOR_BLOCKS = (64, 128, 256, 512, 1024)   # csrc quantize_vector<BLOCK>
_ROUTE_IDS = {"generic": 0, "rows": 1, "stream": 1}   # csrc kGeneric, kVector
_WARPS = 4                     # a block (csrc takes up to kMaxThreads / 32)
_STREAM_CODES = 32 * 2 * 4     # csrc: the codes a stream warp takes (kWords)
_MAX_GRID = 2 ** 31 - 1        # CUDA's grid, in x
# launches per "<kernel>/<route>" ("quantize/rows", "dequantize/stream",
# ...), beside ``_lib.LAUNCHES`` (which counts them per wrapper); cleared by
# callers that split a run's launches by route
ROUTE_LAUNCHES: collections.Counter = collections.Counter()


class Plan(NamedTuple):
    route: str       # "rows" / "stream", or "generic"
    threads: int     # a block
    grid: int        # blocks: a warp for each unit of work


def _rows_a_warp(block: int) -> int:
    """Rows a warp of csrc ``quantize_vector<block>`` takes: one, or two
    half-warp rows at block 64."""
    return 2 if block == 64 else 1


def _plan(route: str, units: int) -> Plan:
    """Each of ``units`` units of work its own warp, 4 warps a block. On the
    H100 4 warps a block timed as fast as 2 or 8 at every shape and faster
    than 1 (one block a unit on as many SMs) from 63 rows up, and a grid
    capped at one wave, each warp walking several units, timed slower: its
    last blocks ran alone (PERF.md §6)."""
    grid = max(1, -(-units // _WARPS))
    if grid > _MAX_GRID:
        raise ValueError(f"{units} warps of work exceed CUDA's grid")
    return Plan(route, 32 * _WARPS, grid)


def kernel_route(kind: str, nb: int, block: int, in_ptr: int,
                 out_ptr: int) -> Plan:
    """The launch of kernel 1 (``kind="quantize"``: ``in_ptr`` is x,
    ``out_ptr`` the codes) or kernel 2 (``"dequantize"``: the codes, then
    x) on ``nb`` rows of ``block`` values.

    Quantize takes ``rows`` at a block of :data:`VECTOR_BLOCKS` with x
    16-byte and the codes 4-byte aligned; dequantize takes ``stream`` at a
    block of whole 4-code words with the codes 4-byte and x 16-byte
    aligned; each takes ``generic`` (a warp a row) at every other block or
    alignment."""
    if kind == "quantize":
        if block in VECTOR_BLOCKS and in_ptr % 16 == 0 and out_ptr % 4 == 0:
            return _plan("rows", -(-nb // _rows_a_warp(block)))
    elif kind == "dequantize":
        if block % 4 == 0 and in_ptr % 4 == 0 and out_ptr % 16 == 0:
            return _plan("stream", -(-nb * block // _STREAM_CODES))
    else:
        raise ValueError(f"kind must be quantize or dequantize, got {kind}")
    return _plan("generic", nb)


@trace.spanned("kernel.quantize_blocks_2d")
def quantize_blocks_2d(x: torch.Tensor, *, bits: int = 8, block: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (n_blocks, block) f32 → (q int8 (n_blocks, block), scales f32
    (n_blocks,))."""
    nb, blk = x.shape
    if blk != block:
        raise ValueError(f"rows have {blk} values, block is {block}")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if x.device.type == "cpu":
        return ref.quantize_blocks_ref(x, bits)
    _lib.check_cuda("quantize_blocks_2d: x", x, torch.float32)
    q = torch.empty((nb, block), dtype=torch.int8, device=x.device)
    s = torch.empty((nb,), dtype=torch.float32, device=x.device)
    if nb:
        plan = kernel_route("quantize", nb, block, x.data_ptr(),
                            q.data_ptr())
        _lib.launch("quantize_blocks_2d", "repro_quantize_blocks", x, q, s,
                    nb, block, float(2 ** (bits - 1) - 1),
                    _ROUTE_IDS[plan.route], plan.grid, plan.threads)
        ROUTE_LAUNCHES["quantize/" + plan.route] += 1
    return q, s


@trace.spanned("kernel.dequantize_blocks_2d")
def dequantize_blocks_2d(q: torch.Tensor, scales: torch.Tensor, *,
                         block: int = 256) -> torch.Tensor:
    """q int8 (n_blocks, block), scales f32 (n_blocks,) → f32
    (n_blocks, block)."""
    nb, blk = q.shape
    if blk != block:
        raise ValueError(f"rows have {blk} values, block is {block}")
    if q.device.type == "cpu":
        return ref.dequantize_blocks_ref(q, scales)
    _lib.check_cuda("dequantize_blocks_2d: q", q, torch.int8)
    _lib.check_cuda("dequantize_blocks_2d: scales", scales, torch.float32,
                    (nb,))
    x = torch.empty((nb, block), dtype=torch.float32, device=q.device)
    if nb:
        plan = kernel_route("dequantize", nb, block, q.data_ptr(),
                            x.data_ptr())
        _lib.launch("dequantize_blocks_2d", "repro_dequantize_blocks", q,
                    scales, x, nb, block, _ROUTE_IDS[plan.route], plan.grid,
                    plan.threads)
        ROUTE_LAUNCHES["dequantize/" + plan.route] += 1
    return x
