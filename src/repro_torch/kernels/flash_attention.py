"""Flash attention forward: wrapper over the CUDA kernel in
``csrc/flash_attention.cu`` (port of ``repro/kernels/flash_attention.py``,
``flash_attention_pallas``).

q: (B, Sq, H, D), k and v: (B, Skv, KV, D) with ``H % KV == 0``; modes
``causal``, ``window`` and ``full``; scale ``D ** -0.5``; the output has
q's shape and dtype. A CPU tensor takes the plain version
(``ref.flash_attention_ref``); a CUDA tensor launches a kernel or raises.
The dtype picks the kernel: bfloat16 the wgmma kernel fed by TMA (its
tensor maps need 16-byte aligned q, k and v), float32 the FMA kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib, ref

MODES = {"causal": 0, "window": 1, "full": 2}
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_route(dtype: torch.dtype) -> str:
    """``"wgmma"`` or ``"fma"``: the kernel a CUDA call in ``dtype``
    launches."""
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mode: str, window: Optional[int]) -> None:
    """Raise unless the call is one the kernel (and the reference it ports)
    computes: matching batch and head dims, ``Dv == D``, a known mode, and
    a key that every query row can see — in window mode ``window >= 1``
    and ``Sq < Skv + window`` (a row with no visible key would average the
    reference's zero padding)."""
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"flash_attention: expected q (B, Sq, H, D) and k, v "
                         f"(B, Skv, KV, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    B2, Skv, KV, D2 = k.shape
    if B2 != B or D2 != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} disagree in batch or D (Dv must "
                         "equal D)")
    if KV == 0 or H % KV or Skv == 0:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"KV={KV}, or no keys (Skv={Skv})")
    if mode not in MODES:
        raise ValueError(f"flash_attention: unknown mode {mode!r}")
    if mode == "window" and (window is None or window < 1
                             or Sq >= Skv + window):
        raise ValueError(f"flash_attention: window={window} leaves a query "
                         f"row without a key (Sq={Sq}, Skv={Skv})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mode: str = "causal",
                    window: Optional[int] = None) -> torch.Tensor:
    check_shapes(q, k, v, mode, window)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, mode=mode, window=window)
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: q is {q.dtype}; float32 or "
                        "bfloat16")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} is not one of "
                         f"{HEAD_DIMS}")
    _lib.check_cuda("flash_attention: q", q, q.dtype)
    _lib.check_cuda("flash_attention: k", k, q.dtype)
    _lib.check_cuda("flash_attention: v", v, q.dtype)
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v on different devices")
    if kernel_route(q.dtype) == "wgmma" and any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bfloat16 q, k and v must start "
                         "on 16-byte boundaries (TMA)")
    o = torch.empty_like(q)
    if B and Sq and H:
        _lib.launch("flash_attention", "repro_flash_attention", q, k, v, o,
                    B, Sq, Skv, H, KV, D, MODES[mode],
                    window if mode == "window" else 0, D ** -0.5,
                    DTYPES[q.dtype])
    return o
