"""Fused dense layer ``act(x @ w + b)``: wrapper over the CUDA kernels in
``csrc/fused_dense.cu`` (port of ``repro/kernels/fused_dense.py``).

Four routes, picked from ``(M, K, N, dtype)`` by :func:`kernel_route`:
``narrow`` at ``K <= NARROW_MAX_K`` (w staged once a block, a persistent
grid over row tiles of x), ``splitk`` at ``M <= SPLITK_MAX_M`` above it (a
stream of w in K slabs; with more than one slab, float32 partials summed
in slab order by a second kernel), and beyond both ``mma`` for bfloat16
(tensor cores, ``mma.sync``) and ``sgemm`` for float32 (register-tiled
IEEE FMA). A CPU tensor takes the plain version (``ref.py``); a CUDA
tensor launches a kernel or raises.
"""
from __future__ import annotations

import collections
from typing import Tuple

import torch

from repro_torch import trace
from repro_torch.kernels import _lib, ref

ACTS = {"relu": 0, "tanh": 1, "sigmoid": 2, "linear": 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLITK_MAX_M = 16
NARROW_MAX_K = 32            # csrc kNarrowMaxK: w's column tile in shared
_TILED_ROUTES = {"narrow": 0, "mma": 1, "sgemm": 2}   # csrc route ids
MMA_ROWS = (64, 32, 16)      # csrc mma_kernel's BM, widest first
MMA_COLS = 32                # csrc kMmaBN
# csrc sgemm_kernel's (BM, BN) by tile id
SGEMM_TILES = ((32, 32), (64, 64), (128, 64), (128, 128), (16, 32))
_SPLITK_WARPS = 8            # 256 threads a block (csrc SK_THREADS)
_SPLITK_MAX_ROWS = 512       # csrc SK_MAX_ROWS: the x slab in shared memory
_SPLITK_MIN_BYTES = 16384    # of w a block streams, where K allows
# launches per route, beside ``_lib.LAUNCHES["fused_dense"]`` (which counts
# them all); cleared by callers that split a run's launches by route
ROUTE_LAUNCHES: collections.Counter = collections.Counter()


def kernel_route(M: int, K: int, N: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call launches: ``"narrow"`` at ``K <= 32`` (w
    staged once a block; at M <= 16 too, where it beat split-K on the
    card), else ``"splitk"`` at ``M <= 16``, else ``"mma"`` for bfloat16
    and ``"sgemm"`` for float32. N does not move the route (the narrow
    route tiles N by 256 columns)."""
    if K <= NARROW_MAX_K:
        return "narrow"
    if M <= SPLITK_MAX_M:
        return "splitk"
    return "mma" if dtype == torch.bfloat16 else "sgemm"


def tile_plan(route: str, M: int, N: int, sms: int) -> int:
    """The tile of an ``mma`` or ``sgemm`` launch (0 for ``narrow``, whose
    kernel sizes its tiles and persistent grid itself): the widest tile
    whose grid still has at least half as many blocks as the card has
    SMs, else the narrowest. About a wave of wide blocks beats two of
    narrow ones, since each block loads all of w's column tile and ends in
    its own epilogue. ``mma``: BM rows of :data:`MMA_ROWS` (32 columns a
    block). ``sgemm``: an id of :data:`SGEMM_TILES` whose BN fits N (32 at
    N <= 32, else 64 or 128)."""
    half = -(-sms // 2)
    if route == "mma":
        cols = -(-N // MMA_COLS)
        for bm in MMA_ROWS:
            if -(-M // bm) * cols >= half:
                return bm
        return MMA_ROWS[-1]
    if route == "sgemm":
        ids = (0, 4) if N <= 32 else (2, 1) if N <= 64 else (3, 2, 1)
        for t in ids:
            bm, bn = SGEMM_TILES[t]
            if -(-M // bm) * -(-N // bn) >= half:
                return t
        return ids[-1]
    return 0


def splitk_plan(K: int, N: int, elem_size: int,
                sms: int) -> Tuple[int, int, int]:
    """``(rows, tpr, splits)`` of the split-K route: K rows of w a slab,
    threads a 16-byte column vector row, and slabs. A warp reads 32 / tpr
    rows at once, a block 8 times that; the column tiles take ``tpr``
    column vectors each. A wide layer whose K fits one slab gets narrower
    column tiles (down to 4 vectors, 64 bytes of a row) while the tiles
    give fewer than ``2 * sms`` blocks and each still streams 16 KB of w:
    tiles need no second pass. Where the tiles give fewer than ``sms``
    blocks, K is cut into ``2 * sms / tiles`` slabs, each streaming at
    least 16 KB of w, rounded up to whole block steps (at most 512 rows):
    about 2 blocks an SM."""
    vec = 16 // elem_size
    ncv = -(-N // vec)
    tpr = 1
    while tpr < min(ncv, 32):
        tpr *= 2
    while (K <= _SPLITK_MAX_ROWS and tpr > 4 and -(-ncv // tpr) < 2 * sms
           and K * (tpr // 2) * 16 >= _SPLITK_MIN_BYTES):
        tpr //= 2
    tiles = -(-ncv // tpr)
    step = _SPLITK_WARPS * (32 // tpr)
    min_rows = -(-_SPLITK_MIN_BYTES // (tpr * vec * elem_size))
    want = -(-2 * sms // tiles) if tiles < sms else 1
    rows = max(min_rows, -(-K // want))
    rows = min(_SPLITK_MAX_ROWS, -(-rows // step) * step)
    return rows, tpr, max(1, -(-K // rows))


@trace.spanned("kernel.fused_dense")
def fused_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                act: str = "relu") -> torch.Tensor:
    """act(x @ w + b). x: (M, K), w: (K, N), b: (N,) → (M, N) in x.dtype,
    float32 accumulation."""
    M, K = x.shape
    K2, N = w.shape
    if K != K2 or tuple(b.shape) != (N,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    if act not in ACTS:
        raise ValueError(f"unsupported activation {act}")
    if x.device.type == "cpu":
        return ref.fused_dense_ref(x, w, b, act)
    if x.dtype not in DTYPES:
        raise TypeError(f"fused_dense: x is {x.dtype}; float32 or bfloat16")
    _lib.check_cuda("fused_dense: x", x, x.dtype)
    _lib.check_cuda("fused_dense: w", w, x.dtype)
    _lib.check_cuda("fused_dense: b", b, x.dtype)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if not (M and N):
        return y
    route = kernel_route(M, K, N, x.dtype)
    sms = _lib.device_sms(x.device)
    if route == "splitk":
        rows, tpr, splits = splitk_plan(K, N, x.element_size(), sms)
        ws = (torch.empty((splits, M, N), dtype=torch.float32,
                          device=x.device) if splits > 1 else None)
        _lib.launch("fused_dense", "repro_fused_dense_splitk", x, w, b, y,
                    ws, M, K, N, ACTS[act], DTYPES[x.dtype], rows, tpr)
    else:
        _lib.launch("fused_dense", "repro_fused_dense", x, w, b, y, M, K, N,
                    ACTS[act], DTYPES[x.dtype], _TILED_ROUTES[route],
                    tile_plan(route, M, N, sms), sms)
    ROUTE_LAUNCHES[route] += 1
    return y
