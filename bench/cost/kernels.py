"""Bytes and operations each kernel operation needs, from the shapes of
one call: frozen copies of ``chip_smoke.py`` phase 3's formulas, keyed by
the operation rather than the CUDA symbol, so the same work is counted
whatever implements it.

Every input byte is counted read once and every output byte written once,
whatever a kernel reads again. Each function takes the wrapper's own
arguments and returns ``(bytes, operations, dtype)``; ``dtype`` names the
peak the operations run against (:data:`bench.cost.peaks.PEAK_FLOPS`).
"""
from __future__ import annotations

from typing import Tuple

import torch

Cost = Tuple[float, float, str]


def _dtype(t: torch.Tensor) -> str:
    return "bfloat16" if t.dtype == torch.bfloat16 else "float32"


def quantize(x: torch.Tensor, *, bits: int = 8, block: int = 256) -> Cost:
    """Kernel 1, ``quantize_blocks_2d(x (nb, block) f32)``: reads ``4n``
    bytes, writes ``n`` int8 codes and ``nb`` float32 scales; about four
    operations a value (abs, max, divide, round)."""
    nb, blk = x.shape
    n = nb * blk
    return 4.0 * n + n + 4.0 * nb, 4.0 * n, "float32"


def dequantize(q: torch.Tensor, scales: torch.Tensor, *,
               block: int = 256) -> Cost:
    """Kernel 2, ``dequantize_blocks_2d(q (nb, block) int8, scales (nb,))``:
    reads ``n + 4 nb`` bytes, writes ``4n``; one multiply a value."""
    nb, blk = q.shape
    n = nb * blk
    return n + 4.0 * nb + 4.0 * n, float(n), "float32"


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
          act: str = "relu") -> Cost:
    """Kernel 3, ``fused_dense(x (M, K), w (K, N), b (N,))`` → ``(M, N)``:
    ``es (MK + KN + N + MN)`` bytes, ``2 MKN`` operations (the bias and the
    activation are left out, as phase 3 leaves them)."""
    M, K = x.shape
    N = w.shape[1]
    es = x.element_size()
    return (float(es * (M * K + K * N + N + M * N)), 2.0 * M * K * N,
            _dtype(x))


def decode_agg(h: torch.Tensor, weights: torch.Tensor, w_last: torch.Tensor,
               b_last: torch.Tensor) -> Cost:
    """Kernel 4, ``fused_decode_agg(h (C, M, K), weights (C,), W (K, N),
    b (N,))`` → ``(M, N)``: the weighted fold ``Σ_c w_c h_c`` (``2 CMK``),
    one product by ``W`` (``2 MKN``) and the bias (``MN``), not ``C``
    separate products; ``4 (CMK + C + KN + N + MN)`` bytes."""
    C, M, K = h.shape
    N = w_last.shape[1]
    return (4.0 * (C * M * K + C + K * N + N + M * N),
            2.0 * C * M * K + 2.0 * M * K * N + M * N, "float32")


def attention_pairs(Sq: int, Skv: int, mode: str, window, q_offset: int
                    ) -> int:
    """(query, key) pairs the mask lets through for one (batch, head);
    query row ``i`` sits at key position ``i + q_offset``."""
    total = 0
    for i in range(q_offset, Sq + q_offset):
        hi = Skv if mode == "full" else min(i + 1, Skv)
        lo = max(0, i - window + 1) if mode == "window" else 0
        total += max(0, hi - lo)
    return total


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              mode: str = "causal", window=None, scale=None,
              q_offset: int = 0, softcap: float = 0.0, **_) -> Cost:
    """Kernel 6, ``flash_attention(q (B, Sq, H, D), k (B, Skv, KV, D),
    v (B, Skv, KV, Dv))``: q, k and v read and o written once; ``2 (D +
    Dv)`` operations a visible (query, key) pair and head (``Q Kᵀ`` and
    ``P V``; at ``Dv = D`` phase 3's ``4 D``)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    es = q.element_size()
    nbytes = es * (B * Sq * H * D + B * Skv * KV * D + B * Skv * KV * Dv
                   + B * Sq * H * Dv)
    pairs = B * H * attention_pairs(Sq, Skv, mode, window, q_offset)
    return float(nbytes), 2.0 * (D + Dv) * pairs, _dtype(q)


def attention_extra(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    extra_qk, **kw) -> Cost:
    """Kernel 6 with a second, head-shared score term (MLA's decomposed
    scores): ``q2 (B, Sq, H, P2)`` and ``k2 (B, Skv, P2)`` read once more,
    ``2 P2`` more operations a visible pair and head."""
    q2, k2 = extra_qk
    nbytes, flops, dtype = attention(q, k, v, **kw)
    B, Sq, H, _ = q.shape
    P2 = q2.shape[-1]
    pairs = B * H * attention_pairs(Sq, k.shape[1], kw.get("mode", "causal"),
                                    kw.get("window"), kw.get("q_offset", 0))
    return (nbytes + q2.element_size() * (q2.numel() + k2.numel()),
            flops + 2.0 * P2 * pairs, dtype)
