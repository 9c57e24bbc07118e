"""Flash attention forward: wrapper over the CUDA kernel in
``csrc/flash_attention.cu`` (port of ``repro/kernels/flash_attention.py``,
``flash_attention_pallas``).

q: (B, Sq, H, D), k (B, Skv, KV, D) and v (B, Skv, KV, Dv) with ``H % KV ==
0``; modes ``causal``, ``window`` and ``full``; scale ``D ** -0.5`` unless
given; the reference scan's ``q_offset`` (query row ``i`` sits at key
position ``i + q_offset``: a chunk of queries at the end of a longer cache)
and ``softcap`` (``tanh(s / softcap) * softcap`` after the scale, before
the mask); the output is (B, Sq, H, Dv) in q's dtype, as the TPU kernel's.
The kernel computes the head-dim pairs of :data:`HEAD_DIM_PAIRS`: ``Dv ==
D`` for each of :data:`HEAD_DIMS`, and MLA's ``(96, 64)`` (minicpm3-4b's
query/key heads of 64 + 32 over value heads of 64). A CPU tensor takes the
plain version (``ref.flash_attention_ref``); a CUDA tensor launches a
kernel or raises. The dtype picks the kernel: bfloat16 the wgmma kernel
fed by TMA (its tensor maps need 16-byte aligned q, k and v), float32 the
FMA kernel.

:func:`flash_attention_padded` takes the head dims the kernel has no
instantiation for (a 192 padded to 256, a 48 to 64, a ``Dv != D`` off
:data:`HEAD_DIM_PAIRS`): it zero-pads q, k and v on the last axis to the
smallest of ``HEAD_DIMS`` that holds both, launches the kernel with the
scale of the unpadded ``D`` and returns the first ``Dv`` columns. The
zero columns add exact zeros to every float32 dot product, so this is the
attention of the unpadded inputs.

:func:`flash_attention_extra` takes the reference's ``extra_qk=(q2 (B, Sq,
H, P2), k2 (B, Skv, P2))``, a second score term shared by the kv heads
(the decomposed MLA scores): ``q·k + q2·k2`` is ``[q | q2] · [k | k2]``
with ``k2`` broadcast over the kv heads, so it concatenates the operands
(:func:`concat_extra`) and launches the kernel on them, at the scale of q's
own head dim, ``D ** -0.5`` (the reference's default): natively when ``(D
+ P2, Dv)`` is a kernel pair (minicpm3-4b's 64 + 32 over 64), else through
the padded route.

Each launch counts one for ``flash_attention`` in ``_lib`` and one
for its route in :data:`ROUTE_LAUNCHES` (``wgmma``, ``fma`` for every
native pair, or ``wgmma_padded``/``fma_padded`` for the padded calls).
"""
from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch

from repro_torch import trace
from repro_torch.kernels import _lib, ref

MODES = {"causal": 0, "window": 1, "full": 2}
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
# (D, Dv) pairs the kernel instantiates: Dv == D, and MLA's 96 over 64
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((96, 64),)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches per route, reset with ``ROUTE_LAUNCHES.clear()``
ROUTE_LAUNCHES: collections.Counter = collections.Counter()


def kernel_route(dtype: torch.dtype) -> str:
    """``"wgmma"`` or ``"fma"``: the kernel a CUDA call in ``dtype``
    launches."""
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def kernel_pair(D: int, Dv: int) -> bool:
    """Whether the kernel instantiates the head dims ``(D, Dv)``."""
    return (D, Dv) in HEAD_DIM_PAIRS


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mode: str, window: Optional[int], q_offset: int = 0) -> None:
    """Raise unless the call is one the kernel (and the reference it ports)
    computes: matching batch and head dims, ``Dv == D`` or a pair of
    :data:`HEAD_DIM_PAIRS`, a known mode, and a key that every query row
    can see — outside full mode ``q_offset >= 0``, in window mode ``window
    >= 1`` and ``Sq + q_offset < Skv + window`` (a row with no visible key
    would average the reference's zero padding)."""
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4
            or tuple(k.shape[:3]) != tuple(v.shape[:3])
            or (v.shape[-1] != k.shape[-1]
                and not kernel_pair(k.shape[-1], v.shape[-1]))):
        raise ValueError(f"flash_attention: expected q (B, Sq, H, D) and k, v "
                         f"(B, Skv, KV, D / Dv), Dv == D or (D, Dv) one of "
                         f"{HEAD_DIM_PAIRS}; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    B2, Skv, KV, D2 = k.shape
    if B2 != B or D2 != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree in batch or D")
    if KV == 0 or H % KV or Skv == 0:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"KV={KV}, or no keys (Skv={Skv})")
    if mode not in MODES:
        raise ValueError(f"flash_attention: unknown mode {mode!r}")
    if mode != "full" and q_offset < 0:
        raise ValueError(f"flash_attention: q_offset={q_offset} leaves the "
                         "first query rows without a key")
    if mode == "window" and (window is None or window < 1
                             or Sq + q_offset >= Skv + window):
        raise ValueError(f"flash_attention: window={window} leaves a query "
                         f"row without a key (Sq={Sq}, Skv={Skv}, "
                         f"q_offset={q_offset})")


def padded_head_dim(D: int, Dv: int) -> Optional[int]:
    """The smallest of :data:`HEAD_DIMS` that holds ``max(D, Dv)``, or
    None when none does."""
    return next((p for p in HEAD_DIMS if p >= max(D, Dv)), None)


@trace.spanned("kernel.flash_attention")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mode: str = "causal", window: Optional[int] = None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    return _flash(q, k, v, mode, window, scale, q_offset, softcap, "")


@trace.spanned("kernel.flash_attention")
def flash_attention_padded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, mode: str = "causal",
                           window: Optional[int] = None,
                           scale: Optional[float] = None, q_offset: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """Attention of q, k (B, S, *, D) and v (B, Skv, KV, Dv) through the
    kernel at the padded head dim, for ``(D, Dv)`` off
    :data:`HEAD_DIM_PAIRS` (see the module docstring); ``scale`` defaults
    to the unpadded ``D ** -0.5``."""
    D, Dv = q.shape[-1], v.shape[-1]
    P = padded_head_dim(D, Dv)
    if P is None:
        raise ValueError(f"flash_attention: head dims D={D}, Dv={Dv} exceed "
                         f"the largest the kernel takes, {HEAD_DIMS[-1]}")
    pad = torch.nn.functional.pad
    out = _flash(pad(q, (0, P - D)), pad(k, (0, P - D)), pad(v, (0, P - Dv)),
                 mode, window, D ** -0.5 if scale is None else scale,
                 q_offset, softcap, "_padded")
    return out[..., :Dv]


def concat_extra(q: torch.Tensor, k: torch.Tensor,
                 extra_qk: Tuple[torch.Tensor, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[q | q2]`` (B, Sq, H, D + P2) and ``[k | k2]`` (B, Skv, KV, D +
    P2), ``k2`` (B, Skv, P2) repeated for every kv head: the operands whose
    product is the reference's ``q·k + q2·k2``."""
    q2, k2 = extra_qk
    B, Skv, KV, _ = k.shape
    k2h = k2[:, :, None, :].expand(B, Skv, KV, k2.shape[-1])
    return torch.cat([q, q2], dim=-1), torch.cat([k, k2h], dim=-1)


def flash_attention_extra(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          extra_qk: Tuple[torch.Tensor, torch.Tensor], *,
                          mode: str = "causal",
                          window: Optional[int] = None,
                          scale: Optional[float] = None, q_offset: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """The reference's ``extra_qk`` scores through the kernel (see the
    module docstring); ``scale`` defaults to q's own ``D ** -0.5``."""
    qc, kc = concat_extra(q, k, extra_qk)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if kernel_pair(qc.shape[-1], v.shape[-1]):
        return flash_attention(qc, kc, v, mode=mode, window=window,
                               scale=scale, q_offset=q_offset,
                               softcap=softcap)
    return flash_attention_padded(qc, kc, v, mode=mode, window=window,
                                  scale=scale, q_offset=q_offset,
                                  softcap=softcap)


def _flash(q, k, v, mode, window, scale, q_offset, softcap,
           route_tag: str) -> torch.Tensor:
    check_shapes(q, k, v, mode, window, q_offset)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, mode=mode, window=window,
                                       scale=scale, q_offset=q_offset,
                                       softcap=softcap)
    B, Sq, H, D = q.shape
    Skv, KV, Dv = v.shape[1], v.shape[2], v.shape[3]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: q is {q.dtype}; float32 or "
                        "bfloat16")
    if not kernel_pair(D, Dv):
        raise ValueError(f"flash_attention: head dims (D, Dv) = ({D}, {Dv}) "
                         f"are not one of {HEAD_DIM_PAIRS}")
    _lib.check_cuda("flash_attention: q", q, q.dtype)
    _lib.check_cuda("flash_attention: k", k, q.dtype)
    _lib.check_cuda("flash_attention: v", v, q.dtype)
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v on different devices")
    if kernel_route(q.dtype) == "wgmma" and any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bfloat16 q, k and v must start "
                         "on 16-byte boundaries (TMA)")
    o = q.new_empty((B, Sq, H, Dv))
    if B and Sq and H:
        _lib.launch("flash_attention", "repro_flash_attention", q, k, v, o,
                    B, Sq, Skv, H, KV, D, Dv, MODES[mode],
                    window if mode == "window" else 0, int(q_offset),
                    D ** -0.5 if scale is None else scale, float(softcap),
                    DTYPES[q.dtype])
        ROUTE_LAUNCHES[kernel_route(q.dtype) + route_tag] += 1
    return o
