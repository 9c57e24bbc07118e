"""Fused batched decode→aggregate epilogue: wrappers over the CUDA kernels
in ``csrc/fused_decode_agg.cu`` and ``csrc/grouped_decode_agg.cu`` (port
of ``fused_decode_agg`` and ``grouped_fused_decode_agg`` in
``repro/kernels/fused_decode_agg.py``).

Each bucket takes one of two routes, from its own (M, K) alone
(:func:`kernel_route`): ``few_rows`` (M <= 16, K <= 512) streams the
decoder W once, column tiles of it a block; ``bands`` streams h, bands of
rows a block. The grouped launch carries the route, and each bucket's
decoder address, per tile. A CPU tensor takes the plain version
(``ref.py``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.kernels import _lib, ref

SMEM_MAX = 227 * 1024          # dynamic shared memory a Hopper block can use
ROWS_MAX_M = 16                # few_rows route: rows of a bucket
ROWS_MAX_K = 512               # csrc kRowsMaxK: hbar (K, 16) in shared memory
ROWS_MAX_TPR = 16              # csrc kRowsMaxTpr: the W tile (K, 64) too
_STAGE_BYTES = 4 * 1024        # csrc kStageFloats: the bands reduce's stage


def kernel_route(M: int, K: int) -> str:
    """``"few_rows"`` or ``"bands"``: the body a CUDA launch runs for a
    bucket of ``M`` rows and hidden width ``K`` (its own shape alone, so a
    bucket takes the same route alone and grouped). few_rows streams the
    decoder once and suits the slice's few chunks a client; bands streams h
    and suits cohort scale."""
    return ("few_rows" if M <= ROWS_MAX_M and K <= ROWS_MAX_K
            else "bands")


def rows_template(M: int) -> int:
    """The compiled row count (csrc ``MT``) of a few_rows launch whose
    tallest bucket has ``M`` rows."""
    return 4 if M <= 4 else 8 if M <= 8 else 16


def few_rows_plan(N: int, sms: int) -> int:
    """``tpr`` of the few_rows route: threads a 16-byte column vector of W
    (a block's column tile is ``4 * tpr`` columns wide, all K rows of it in
    shared memory, and ``256 / tpr`` threads share K). From 16, halved
    while one bucket's column tiles give fewer than half a block an SM:
    every block reduces its own copy of hbar, so a bucket takes about one
    block an SM (128 at N = 4096) and a grouped round of two buckets about
    two, one wave (PERF.md, PR 15: two blocks an SM a bucket were slower).
    The order of the route's additions depends on ``tpr`` alone, and
    ``tpr`` on (N, SMs) alone, so a bucket adds in the same order alone and
    in any grouped launch."""
    ncv = -(-N // 4)
    tpr = 1
    while tpr < min(ncv, ROWS_MAX_TPR):
        tpr *= 2
    while tpr > 1 and 2 * -(-ncv // tpr) < sms:
        tpr //= 2
    return tpr


def few_rows_blocks(N: int, tpr: int) -> int:
    """Blocks (column tiles) of one few_rows bucket."""
    ncv = -(-N // 4)
    return -(-ncv // tpr)


def _plan_bands(ms: Sequence[int], N: int, K: int, sms: int
                ) -> Tuple[int, int]:
    """``(bm, cols_per_split)`` for bands over outputs of ``ms`` rows each:
    the largest band height (64..8 rows, ``bm·K`` floats of shared memory
    beside the reduce's 4 KB stage) whose bands alone still give two blocks
    per SM; when even 8-row bands are too few, split the columns too, in
    whole 256-column strips (a thread a column; each split repeats its
    band's client reduce)."""
    fits = [bm for bm in (64, 32, 16, 8)
            if bm * K * 4 + _STAGE_BYTES <= SMEM_MAX]
    if not fits:
        raise ValueError(f"hidden width K={K} needs more shared memory "
                         f"than a block has")

    def tiles(bm):
        return sum(-(-m // bm) for m in ms)
    bm = next((b for b in fits if tiles(b) >= 2 * sms), fits[-1])
    strips = -(-N // 256)
    n_split = max(1, min(strips, -(-2 * sms // tiles(bm))))
    return bm, -(-strips // n_split) * 256


def plan(M: int, N: int, K: int, sms: int) -> Tuple[int, int]:
    """``(bm, cols_per_split)`` for :func:`fused_decode_agg` on ``M``
    rows, on the bands route."""
    return _plan_bands((M,), N, K, sms)


@trace.spanned("kernel.fused_decode_agg")
def fused_decode_agg(h: torch.Tensor, weights: torch.Tensor,
                     w_last: torch.Tensor, b_last: torch.Tensor
                     ) -> torch.Tensor:
    """``Σ_c weights[c] · (h[c] @ w_last) + b_last`` without any per-client
    ``(M, N)`` tensor. h: (C, M, K) f32; weights: (C,) summing to 1 (the
    bias is added once); w_last: (K, N); b_last: (N,) → (M, N) f32. A CUDA
    call takes the route :func:`kernel_route` names."""
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
    if not (M and N):
        return out
    sms = _lib.device_sms(h.device)
    if kernel_route(M, K) == "few_rows":
        _lib.launch("fused_decode_agg", "repro_fused_decode_agg_rows", h,
                    weights, w_last, b_last, out, C, M, K, N,
                    few_rows_plan(N, sms))
    else:
        bm, cols = plan(M, N, K, sms)
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
    K: int
    N: int
    bm: int                        # bands tiles (0: none)
    cols: int
    tpr: int                       # few_rows tiles (0: none)
    mt: int
    routes: List[str]              # per bucket ("" for an empty one)
    views: List[torch.Tensor]      # per-bucket results
    keep: Tuple[torch.Tensor, ...]

    @property
    def tiles(self) -> int:
        return self.table.shape[0]


Decoder = Tuple[torch.Tensor, torch.Tensor]      # (W (K, N), bias (N,))


def _check_grouped(hs, weights, decoders: Sequence[Decoder], dec_idx
                   ) -> Tuple[int, int]:
    if not len(hs) == len(weights) == len(dec_idx):
        raise ValueError(f"{len(hs)} buckets, {len(weights)} weight "
                         f"vectors, {len(dec_idx)} decoder slots")
    if not decoders:
        raise ValueError("no decoders")
    K, N = decoders[0][0].shape
    for d, (w, b) in enumerate(decoders):
        if tuple(w.shape) != (K, N) or tuple(b.shape) != (N,):
            raise ValueError(f"decoder {d}: W {tuple(w.shape)}, bias "
                             f"{tuple(b.shape)}, expected {(K, N)}, {(N,)}")
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
        if not 0 <= d < len(decoders):
            raise ValueError(f"bucket {b}: decoder slot {d} not in "
                             f"[0, {len(decoders)})")
    return K, N


def tile_table(shapes: Sequence[Tuple[int, int]], K: int, N: int,
               h_ptrs: Sequence[int], w_ptrs: Sequence[int],
               dec_ptrs: Sequence[Tuple[int, int]], out_ptr: int, bm: int,
               cols: int, tpr: int) -> Tuple[np.ndarray, List[int]]:
    """The grouped launch's tile table for buckets of ``(C_b, M_b)``, one
    row of 8 int64 per block, in the layout ``csrc/grouped_decode_agg.cu``
    reads (h address, weights address, output address, W address, bias
    address, client stride, ``C_b | rows << 32``, ``route | column tile <<
    8``). Every non-empty bucket is laid end to end in the packed output; a
    few_rows bucket gets one block a column tile of ``4 * tpr`` columns,
    all its rows; a bands bucket one block a band of at most ``bm`` rows
    and a split of ``cols`` columns, bands outer. ``dec_ptrs[b]`` is bucket
    ``b``'s (W, bias) addresses. Also each bucket's first packed output
    row (-1 for an empty bucket, which gets no tile). Built with numpy: a
    round at cohort scale has hundreds of tiles, and a Python loop over
    them costs the host more than the launch costs the card."""
    blocks, offsets, pos = [], [], 0
    for (C_b, M_b), h_ptr, w_ptr, (W_ptr, b_ptr) in zip(
            shapes, h_ptrs, w_ptrs, dec_ptrs):
        if C_b == 0:
            offsets.append(-1)
            continue
        offsets.append(pos)
        if kernel_route(M_b, K) == "few_rows":
            col = np.arange(few_rows_blocks(N, tpr), dtype=np.int64)
            m0 = np.zeros_like(col)
            rows = np.full_like(col, M_b)
            route = 1
        else:
            m0, col = (a.reshape(-1) for a in np.meshgrid(
                np.arange(0, M_b, bm, dtype=np.int64),
                np.arange(-(-N // cols), dtype=np.int64), indexing="ij"))
            rows = np.minimum(bm, M_b - m0)
            route = 0
        t = np.empty((col.size, 8), np.int64)
        t[:, 0] = h_ptr + m0 * (K * 4)
        t[:, 1] = w_ptr
        t[:, 2] = out_ptr + (pos + m0) * (N * 4)
        t[:, 3] = W_ptr
        t[:, 4] = b_ptr
        t[:, 5] = M_b * K
        t[:, 6] = C_b | (rows << 32)
        t[:, 7] = route | (col << 8)
        blocks.append(t)
        pos += M_b
    table = (np.concatenate(blocks) if blocks
             else np.zeros((0, 8), np.int64))
    return table, offsets


def grouped_plan(hs: Sequence[torch.Tensor],
                 weights: Sequence[torch.Tensor],
                 decoders: Sequence[Decoder], dec_idx: Sequence[int]
                 ) -> Optional[GroupedLaunch]:
    """Check the buckets (CUDA tensors) and build the launch: each live
    bucket's route (:func:`kernel_route`); the few_rows buckets' column
    tiles (:func:`few_rows_plan`, the per-bucket kernel's own) and row
    template; the bands buckets' band height and column split over their
    total tile count; one table row a block (laid end to end in the packed
    output), copied to the card. None when every bucket is empty."""
    K, N = _check_grouped(hs, weights, decoders, dec_idx)
    dev = decoders[0][0].device
    for d, (w, b) in enumerate(decoders):
        _lib.check_cuda(f"grouped_fused_decode_agg: decoder {d} W", w,
                        torch.float32)
        _lib.check_cuda(f"grouped_fused_decode_agg: decoder {d} bias", b,
                        torch.float32)
        if w.device != dev or b.device != dev:
            raise ValueError(f"grouped_fused_decode_agg: decoder {d} on "
                             f"{w.device}, decoder 0 on {dev}")
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
    sms = _lib.device_sms(dev)
    routes = ["" if h.shape[0] == 0 else kernel_route(h.shape[1], K)
              for h in hs]
    few = [hs[b].shape[1] for b in live if routes[b] == "few_rows"]
    many = [hs[b].shape[1] for b in live if routes[b] == "bands"]
    bm, cols = _plan_bands(many, N, K, sms) if many else (0, 0)
    tpr = few_rows_plan(N, sms) if few else 0
    out = torch.empty((sum(hs[b].shape[1] for b in live), N),
                      dtype=torch.float32, device=dev)
    table, offsets = tile_table(
        [tuple(h.shape[:2]) for h in hs], K, N,
        [h.data_ptr() for h in hs], [w.data_ptr() for w in weights],
        [(decoders[d][0].data_ptr(), decoders[d][1].data_ptr())
         if h.shape[0] else (0, 0) for h, d in zip(hs, dec_idx)],
        out.data_ptr(), bm, cols, tpr)
    table = trace.to_device(table, dev)
    views = [torch.zeros((h.shape[1], N), dtype=torch.float32, device=dev)
             if o < 0 else out[o:o + h.shape[1]]
             for h, o in zip(hs, offsets)]
    return GroupedLaunch(table=table, out=out, K=K, N=N, bm=bm, cols=cols,
                         tpr=tpr, mt=rows_template(max(few, default=4)),
                         routes=routes, views=views,
                         keep=tuple(hs[b] for b in live)
                         + tuple(weights[b] for b in live)
                         + tuple(t for dec in decoders for t in dec))


def grouped_launch(p: GroupedLaunch) -> List[torch.Tensor]:
    """Launch a planned grouped kernel; returns its per-bucket results."""
    _lib.launch("grouped_fused_decode_agg", "repro_grouped_decode_agg",
                p.table, p.tiles, p.K, p.N, p.bm, p.cols, p.tpr, p.mt)
    return p.views


@trace.spanned("kernel.grouped_fused_decode_agg")
def grouped_fused_decode_agg_decoders(hs: Sequence[torch.Tensor],
                                      weights: Sequence[torch.Tensor],
                                      decoders: Sequence[Decoder],
                                      dec_idx: Sequence[int]
                                      ) -> List[torch.Tensor]:
    """:func:`grouped_fused_decode_agg` with the distinct final decoder
    layers as ``(W (K, N), bias (N,))`` pairs wherever the caller holds
    them (``decoders[dec_idx[b]]`` is bucket ``b``'s): the tile table
    carries each one's address, so nothing is stacked."""
    if decoders and decoders[0][0].device.type == "cpu":
        _, N = _check_grouped(hs, weights, decoders, dec_idx)
        return ref.grouped_decode_agg_decoders_ref(hs, weights, decoders,
                                                   dec_idx, N)
    p = grouped_plan(hs, weights, decoders, dec_idx)
    if p is None:
        N = decoders[0][0].shape[1]
        return [torch.zeros((h.shape[1], N), dtype=torch.float32,
                            device=decoders[0][0].device) for h in hs]
    return grouped_launch(p)


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
    every bucket is empty nothing is launched. Each bucket takes the route
    :func:`kernel_route` names for it, bit-equal to :func:`fused_decode_agg`
    on that bucket alone.

    Returns the per-bucket ``(M_b, N)`` results (views of one packed
    output). CPU tensors take the plain version."""
    if w_stack.dim() != 3:
        raise ValueError(f"w_stack must be (D, K, N), got "
                         f"{tuple(w_stack.shape)}")
    D, K, N = w_stack.shape
    if tuple(b_stack.shape) != (D, N):
        raise ValueError(f"b_stack {tuple(b_stack.shape)} != {(D, N)}")
    return grouped_fused_decode_agg_decoders(
        hs, weights, [(w_stack[d], b_stack[d]) for d in range(D)], dec_idx)
