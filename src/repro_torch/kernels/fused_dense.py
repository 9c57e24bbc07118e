"""Fused dense layer ``act(x @ w + b)``: wrapper over the CUDA kernels in
``csrc/fused_dense.cu`` (port of ``repro/kernels/fused_dense.py``).

Two routes, picked from M alone: ``M <= SPLITK_MAX_M`` rows take the
split-K kernel (a stream of w in K slabs; with more than one slab, float32
partials summed in slab order by a second kernel), every other M the tiled
kernel. A CPU tensor
takes the plain version (``ref.py``); a CUDA tensor launches a kernel or
raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _lib, ref

ACTS = {"relu": 0, "tanh": 1, "sigmoid": 2, "linear": 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLITK_MAX_M = 16
_SPLITK_WARPS = 8            # 256 threads a block (csrc SK_THREADS)
_SPLITK_MAX_ROWS = 512       # csrc SK_MAX_ROWS: the x slab in shared memory
_SPLITK_MIN_BYTES = 16384    # of w a block streams, where K allows


def kernel_route(M: int) -> str:
    """``"splitk"`` or ``"tiled"``: the kernel a CUDA call with M rows
    launches."""
    return "splitk" if M <= SPLITK_MAX_M else "tiled"


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
    if kernel_route(M) == "splitk":
        rows, tpr, splits = splitk_plan(K, N, x.element_size(),
                                        _lib.device_sms(x.device))
        ws = (torch.empty((splits, M, N), dtype=torch.float32,
                          device=x.device) if splits > 1 else None)
        _lib.launch("fused_dense", "repro_fused_dense_splitk", x, w, b, y,
                    ws, M, K, N, ACTS[act], DTYPES[x.dtype], rows, tpr)
    else:
        _lib.launch("fused_dense", "repro_fused_dense", x, w, b, y, M, K, N,
                    ACTS[act], DTYPES[x.dtype])
    return y
