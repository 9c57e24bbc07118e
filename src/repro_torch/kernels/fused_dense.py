"""Fused dense layer ``act(x @ w + b)``: wrapper over the CUDA kernel in
``csrc/fused_dense.cu`` (port of ``repro/kernels/fused_dense.py``).

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref

ACTS = {"relu": 0, "tanh": 1, "sigmoid": 2, "linear": 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    if M and N:
        _lib.launch("fused_dense", "repro_fused_dense", x, w, b, y, M, K, N,
                    ACTS[act], DTYPES[x.dtype])
    return y
