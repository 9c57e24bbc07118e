"""Plain PyTorch versions of the five ported kernels.

Each is the same function as its CUDA kernel, written with ordinary torch
ops. The wrappers take them for CPU tensors (the CPU tests run the port on
these), and ``chip_smoke.py`` holds every kernel against its plain version
on the card.
"""
from __future__ import annotations

import torch


def fused_dense_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    act: str = "relu") -> torch.Tensor:
    y = x.float() @ w.float() + b.float()
    if act == "relu":
        y = torch.relu(y)
    elif act == "tanh":
        y = torch.tanh(y)
    elif act == "sigmoid":
        y = torch.sigmoid(y)
    elif act != "linear":
        raise ValueError(act)
    return y.to(x.dtype)


def quantize_blocks_ref(x: torch.Tensor, bits: int = 8):
    """x: (n_blocks, block) → (q int8, scales f32 (n_blocks,)). True
    divisions throughout (a divisor tensor, not a Python scalar, which
    PyTorch on CUDA turns into a reciprocal multiply) and half-to-even
    rounding, as the reference computes."""
    qmax = float(2 ** (bits - 1) - 1)
    xf = x.float()
    absmax = torch.amax(torch.abs(xf), dim=1, keepdim=True)
    scale = torch.clamp_min(absmax / torch.full_like(absmax, qmax), 1e-12)
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    return q.to(torch.int8), scale[:, 0]


def dequantize_blocks_ref(q: torch.Tensor, scales: torch.Tensor
                          ) -> torch.Tensor:
    return q.float() * scales[:, None]


def fused_decode_agg_ref(h: torch.Tensor, weights: torch.Tensor,
                         w_last: torch.Tensor, b_last: torch.Tensor
                         ) -> torch.Tensor:
    """``Σ_c w_c·(h_c @ W) + b`` reduced before the expand, as the kernel
    does: no per-client ``(M, N)`` tensor here either."""
    hbar = torch.einsum("c,cmk->mk", weights.float(), h.float())
    return hbar @ w_last.float() + b_last.float()


def grouped_fused_decode_agg_ref(hs, weights, w_stack: torch.Tensor,
                                 b_stack: torch.Tensor, dec_idx):
    """The grouped ragged launch as one materialize-then-reduce pass per
    bucket, in bucket order: every client's ``(M_b, N)`` decode is built,
    then weighted and summed. Empty buckets (zero clients) return exact
    zeros, as the kernel does."""
    N = w_stack.shape[2]
    out = []
    for h, w, d in zip(hs, weights, dec_idx):
        if h.shape[0] == 0:
            out.append(torch.zeros((h.shape[1], N), dtype=torch.float32,
                                   device=w_stack.device))
            continue
        per_client = h.float() @ w_stack[d].float()
        out.append(torch.einsum("c,cmn->mn", w.float(), per_client)
                   + b_stack[d].float())
    return out
