"""Fused batched decode→aggregate epilogue: wrapper over the CUDA kernel in
``csrc/fused_decode_agg.cu`` (port of ``fused_decode_agg`` in
``repro/kernels/fused_decode_agg.py``; the grouped ragged launch is not
ported yet).

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _lib, ref

SMEM_MAX = 227 * 1024          # dynamic shared memory a Hopper block can use


def plan(M: int, N: int, K: int, sms: int) -> Tuple[int, int]:
    """``(bm, cols_per_split)`` for the launch: the largest row band
    (64..8 rows, ``bm·K`` floats of shared memory) that still gives two
    blocks per SM; when even 8-row bands are too few, split the columns
    too (each split repeats its band's client reduce)."""
    fits = [bm for bm in (64, 32, 16, 8) if bm * K * 4 <= SMEM_MAX]
    if not fits:
        raise ValueError(f"hidden width K={K} needs more shared memory "
                         f"than a block has")
    bm = next((b for b in fits if -(-M // b) >= 2 * sms), fits[-1])
    m_tiles = -(-M // bm)
    n_tiles = -(-N // 32)
    n_split = max(1, min(n_tiles, -(-2 * sms // m_tiles)))
    return bm, -(-n_tiles // n_split) * 32


def fused_decode_agg(h: torch.Tensor, weights: torch.Tensor,
                     w_last: torch.Tensor, b_last: torch.Tensor
                     ) -> torch.Tensor:
    """``Σ_c weights[c] · (h[c] @ w_last) + b_last`` without any per-client
    ``(M, N)`` tensor. h: (C, M, K) f32; weights: (C,) summing to 1 (the
    bias is added once); w_last: (K, N); b_last: (N,) → (M, N) f32."""
    C, M, K = h.shape
    K2, N = w_last.shape
    if K != K2 or tuple(b_last.shape) != (N,) or \
            tuple(weights.shape) != (C,):
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, weights "
                         f"{tuple(weights.shape)}, w_last "
                         f"{tuple(w_last.shape)}, b_last "
                         f"{tuple(b_last.shape)}")
    if h.device.type == "cpu":
        return ref.fused_decode_agg_ref(h, weights, w_last, b_last)
    for name, t in (("h", h), ("weights", weights), ("w_last", w_last),
                    ("b_last", b_last)):
        _lib.check_cuda(f"fused_decode_agg: {name}", t, torch.float32)
    out = torch.empty((M, N), dtype=torch.float32, device=h.device)
    if M and N:
        bm, cols = plan(M, N, K, _lib.device_sms(h.device))
        _lib.launch("fused_decode_agg", "repro_fused_decode_agg", h,
                    weights, w_last, b_last, out, C, M, K, N, bm, cols)
    return out
