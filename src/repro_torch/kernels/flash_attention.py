"""Flash attention forward: wrapper over the CUDA kernel in
``csrc/flash_attention.cu`` (port of ``repro/kernels/flash_attention.py``,
``flash_attention_pallas``).

q: (B, Sq, H, D), k and v: (B, Skv, KV, D) with ``H % KV == 0``; modes
``causal``, ``window`` and ``full``; scale ``D ** -0.5`` unless given; the
output has q's shape and dtype. A CPU tensor takes the plain version
(``ref.flash_attention_ref``); a CUDA tensor launches a kernel or raises.
The dtype picks the kernel: bfloat16 the wgmma kernel fed by TMA (its
tensor maps need 16-byte aligned q, k and v), float32 the FMA kernel.

:func:`flash_attention_padded` takes the head dims the kernel has no
instantiation for — ``D`` outside :data:`HEAD_DIMS` (phi-3's 96, a 192
padded to 256), or a value head ``Dv != D`` (MLA's 96-wide query/key head
over a 64-wide value head): it
zero-pads q, k and v on the last axis to the smallest of ``HEAD_DIMS``
that holds both, launches the kernel with the scale of the unpadded ``D``
and returns the first ``Dv`` columns. The zero columns add exact zeros to
every float32 dot product, so this is the attention of the unpadded
inputs. Each launch counts one for ``flash_attention`` in ``_lib`` and one
for its route in :data:`ROUTE_LAUNCHES` (``wgmma``, ``fma``, or
``wgmma_padded``/``fma_padded`` for the padded calls).
"""
from __future__ import annotations

import collections
from typing import Optional

import torch

from repro_torch.kernels import _lib, ref

MODES = {"causal": 0, "window": 1, "full": 2}
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches per route, reset with ``ROUTE_LAUNCHES.clear()``
ROUTE_LAUNCHES: collections.Counter = collections.Counter()


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


def padded_head_dim(D: int, Dv: int) -> Optional[int]:
    """The smallest of :data:`HEAD_DIMS` that holds ``max(D, Dv)``, or
    None when none does."""
    return next((p for p in HEAD_DIMS if p >= max(D, Dv)), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mode: str = "causal", window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    return _flash(q, k, v, mode, window, scale, "")


def flash_attention_padded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, mode: str = "causal",
                           window: Optional[int] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q, k (B, S, *, D) and v (B, Skv, KV, Dv) through the
    kernel at the padded head dim (see the module docstring); ``scale``
    defaults to the unpadded ``D ** -0.5``."""
    D, Dv = q.shape[-1], v.shape[-1]
    P = padded_head_dim(D, Dv)
    if P is None:
        raise ValueError(f"flash_attention: head dims D={D}, Dv={Dv} exceed "
                         f"the largest the kernel takes, {HEAD_DIMS[-1]}")
    pad = torch.nn.functional.pad
    out = _flash(pad(q, (0, P - D)), pad(k, (0, P - D)), pad(v, (0, P - Dv)),
                 mode, window, D ** -0.5 if scale is None else scale,
                 "_padded")
    return out[..., :Dv]


def _flash(q, k, v, mode, window, scale, route_tag: str) -> torch.Tensor:
    check_shapes(q, k, v, mode, window)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, mode=mode, window=window,
                                       scale=scale)
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
                    window if mode == "window" else 0,
                    D ** -0.5 if scale is None else scale, DTYPES[q.dtype])
        ROUTE_LAUNCHES[kernel_route(q.dtype) + route_tag] += 1
    return o
