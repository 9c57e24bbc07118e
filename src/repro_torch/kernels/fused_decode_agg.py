"""Fused batched decode→aggregate epilogue: wrappers over the CUDA kernels
in ``csrc/fused_decode_agg.cu`` and ``csrc/grouped_decode_agg.cu`` (port
of ``fused_decode_agg`` and ``grouped_fused_decode_agg`` in
``repro/kernels/fused_decode_agg.py``).

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _lib, ref

SMEM_MAX = 227 * 1024          # dynamic shared memory a Hopper block can use


def _plan_bands(ms: Sequence[int], N: int, K: int, sms: int
                ) -> Tuple[int, int]:
    """``(bm, cols_per_split)`` for row bands over outputs of ``ms`` rows
    each: the largest band height (64..8 rows, ``bm·K`` floats of shared
    memory) whose bands alone still give two blocks per SM; when even
    8-row bands are too few, split the columns too (each split repeats its
    band's client reduce)."""
    fits = [bm for bm in (64, 32, 16, 8) if bm * K * 4 <= SMEM_MAX]
    if not fits:
        raise ValueError(f"hidden width K={K} needs more shared memory "
                         f"than a block has")

    def tiles(bm):
        return sum(-(-m // bm) for m in ms)
    bm = next((b for b in fits if tiles(b) >= 2 * sms), fits[-1])
    n_tiles = -(-N // 32)
    n_split = max(1, min(n_tiles, -(-2 * sms // tiles(bm))))
    return bm, -(-n_tiles // n_split) * 32


def plan(M: int, N: int, K: int, sms: int) -> Tuple[int, int]:
    """``(bm, cols_per_split)`` for :func:`fused_decode_agg` on ``M``
    rows."""
    return _plan_bands((M,), N, K, sms)


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


# =====================================================================
# grouped ragged launch: every bucket of a round in one kernel
# =====================================================================
@dataclasses.dataclass
class GroupedLaunch:
    """A planned grouped launch: the tile table on the card, the packed
    output its tiles write, and the tensors the table points at (held
    here so they outlive every launch of the plan). :func:`grouped_launch`
    runs it; it does no host→device copy, so a CUDA graph can capture
    it."""

    table: torch.Tensor            # (T, 8) int64, csrc/grouped_decode_agg.cu
    out: torch.Tensor              # (Σ live M_b, N) f32
    w_stack: torch.Tensor
    b_stack: torch.Tensor
    K: int
    N: int
    bm: int
    cols: int
    views: List[torch.Tensor]      # per-bucket results
    keep: Tuple[torch.Tensor, ...]

    @property
    def tiles(self) -> int:
        return self.table.shape[0]


def _check_grouped(hs, weights, w_stack, b_stack, dec_idx
                   ) -> Tuple[int, int, int]:
    if not len(hs) == len(weights) == len(dec_idx):
        raise ValueError(f"{len(hs)} buckets, {len(weights)} weight "
                         f"vectors, {len(dec_idx)} decoder slots")
    if w_stack.dim() != 3:
        raise ValueError(f"w_stack must be (D, K, N), got "
                         f"{tuple(w_stack.shape)}")
    D, K, N = w_stack.shape
    if tuple(b_stack.shape) != (D, N):
        raise ValueError(f"b_stack {tuple(b_stack.shape)} != {(D, N)}")
    for b, (h, w, d) in enumerate(zip(hs, weights, dec_idx)):
        if h.dim() != 3 or h.shape[2] != K:
            raise ValueError(
                f"bucket {b}: h {tuple(h.shape)} has hidden width != {K} "
                f"— grouped launches require one (K, N) signature; split "
                f"the launch")
        if h.shape[0] == 0:
            continue
        if tuple(w.shape) != (h.shape[0],) or h.shape[1] == 0:
            raise ValueError(f"bucket {b}: h {tuple(h.shape)}, weights "
                             f"{tuple(w.shape)}")
        if not 0 <= d < D:
            raise ValueError(f"bucket {b}: decoder slot {d} not in "
                             f"[0, {D})")
    return D, K, N


def tile_table(shapes: Sequence[Tuple[int, int]], dec_idx: Sequence[int],
               bm: int, K: int, N: int, h_ptrs: Sequence[int],
               w_ptrs: Sequence[int], out_ptr: int
               ) -> Tuple[np.ndarray, List[int]]:
    """The grouped launch's tile table for buckets of ``(C_b, M_b)``: every
    non-empty bucket cut into bands of at most ``bm`` rows, laid end to
    end in the packed output, one row of 8 int64 per band (the layout
    ``csrc/grouped_decode_agg.cu`` reads: h band address, client stride,
    weights address, output band address, C_b, rows, decoder slot, 0).
    Also each bucket's first packed output row (-1 for an empty bucket,
    which gets no tile). Built with numpy: a round at cohort scale has
    hundreds of tiles, and a Python loop over them costs the host more
    than the launch costs the card."""
    blocks, offsets, pos = [], [], 0
    for (C_b, M_b), d, h_ptr, w_ptr in zip(shapes, dec_idx, h_ptrs, w_ptrs):
        if C_b == 0:
            offsets.append(-1)
            continue
        offsets.append(pos)
        m0 = np.arange(0, M_b, bm, dtype=np.int64)
        t = np.zeros((m0.size, 8), np.int64)
        t[:, 0] = h_ptr + m0 * (K * 4)
        t[:, 1] = M_b * K
        t[:, 2] = w_ptr
        t[:, 3] = out_ptr + (pos + m0) * (N * 4)
        t[:, 4] = C_b
        t[:, 5] = np.minimum(bm, M_b - m0)
        t[:, 6] = d
        blocks.append(t)
        pos += M_b
    table = (np.concatenate(blocks) if blocks
             else np.zeros((0, 8), np.int64))
    return table, offsets


def grouped_plan(hs: Sequence[torch.Tensor],
                 weights: Sequence[torch.Tensor], w_stack: torch.Tensor,
                 b_stack: torch.Tensor, dec_idx: Sequence[int]
                 ) -> Optional[GroupedLaunch]:
    """Check the buckets (CUDA tensors) and build the launch: band height
    and column split over the round's total tile count, one table row per
    row tile of every non-empty bucket (laid end to end in the packed
    output), copied to the card. None when every bucket is empty."""
    _, K, N = _check_grouped(hs, weights, w_stack, b_stack, dec_idx)
    dev = w_stack.device
    _lib.check_cuda("grouped_fused_decode_agg: w_stack", w_stack,
                    torch.float32)
    _lib.check_cuda("grouped_fused_decode_agg: b_stack", b_stack,
                    torch.float32)
    live = [b for b, h in enumerate(hs) if h.shape[0] > 0]
    for b in live:
        for name, t in (("h", hs[b]), ("weights", weights[b])):
            _lib.check_cuda(f"grouped_fused_decode_agg: bucket {b} {name}",
                            t, torch.float32)
            if t.device != dev:
                raise ValueError(f"grouped_fused_decode_agg: bucket {b} "
                                 f"{name} on {t.device}, decoders on {dev}")
    if not live or N == 0:
        return None
    bm, cols = _plan_bands([hs[b].shape[1] for b in live], N, K,
                           _lib.device_sms(dev))
    out = torch.empty((sum(hs[b].shape[1] for b in live), N),
                      dtype=torch.float32, device=dev)
    table, offsets = tile_table(
        [tuple(h.shape[:2]) for h in hs], dec_idx, bm, K, N,
        [h.data_ptr() for h in hs], [w.data_ptr() for w in weights],
        out.data_ptr())
    table = torch.from_numpy(table).to(dev)
    views = [torch.zeros((h.shape[1], N), dtype=torch.float32, device=dev)
             if o < 0 else out[o:o + h.shape[1]]
             for h, o in zip(hs, offsets)]
    return GroupedLaunch(table=table, out=out, w_stack=w_stack,
                         b_stack=b_stack, K=K, N=N, bm=bm, cols=cols,
                         views=views,
                         keep=tuple(hs[b] for b in live)
                         + tuple(weights[b] for b in live))


def grouped_launch(p: GroupedLaunch) -> List[torch.Tensor]:
    """Launch a planned grouped kernel; returns its per-bucket results."""
    _lib.launch("grouped_fused_decode_agg", "repro_grouped_decode_agg",
                p.table, p.w_stack, p.b_stack, p.tiles, p.K, p.N, p.bm,
                p.cols)
    return p.views


def grouped_fused_decode_agg(hs: Sequence[torch.Tensor],
                             weights: Sequence[torch.Tensor],
                             w_stack: torch.Tensor, b_stack: torch.Tensor,
                             dec_idx: Sequence[int]) -> List[torch.Tensor]:
    """One launch over every bucket of a round: per bucket ``b``,
    ``Σ_c weights[b][c] · (hs[b][c] @ w_stack[dec_idx[b]]) +
    b_stack[dec_idx[b]]``.

    hs[b]: (C_b, M_b, K) per-client penultimate decoder activations, C_b
    and M_b ragged across buckets, K and N shared (a mismatch raises).
    weights[b]: (C_b,) summing to 1 (the bias is added once). w_stack:
    (D, K, N) distinct final decoder layers, b_stack: (D, N); ``dec_idx[b]``
    picks bucket ``b``'s slot, so buckets sharing a decoder share it.
    A bucket with zero clients returns exact zeros and gets no tile; when
    every bucket is empty nothing is launched.

    Returns the per-bucket ``(M_b, N)`` results (views of one packed
    output). CPU tensors take the plain version."""
    if w_stack.device.type == "cpu":
        _check_grouped(hs, weights, w_stack, b_stack, dec_idx)
        return ref.grouped_fused_decode_agg_ref(hs, weights, w_stack,
                                                b_stack, dec_idx)
    p = grouped_plan(hs, weights, w_stack, b_stack, dec_idx)
    if p is None:
        return [torch.zeros((h.shape[1], w_stack.shape[2]),
                            dtype=torch.float32, device=w_stack.device)
                for h in hs]
    return grouped_launch(p)
