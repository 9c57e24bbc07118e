"""GQA attention (port of the GQA part of ``repro.models.attention``):
full-sequence flash attention for training and prefill, single-token decode
attention against a linear or ring cache, and the GQA module.

``flash_attention`` keeps the reference's whole signature. On the CPU it
runs the reference's chunked online-softmax math
(``ref.chunked_attention_ref``: query chunks, and inside them kv chunks
with an (m, l, acc) carry), so no (Sq, Skv) matrix is built.
On a CUDA tensor :func:`attention_route` splits as the reference does: a
training path (autograd recording through q, k or v) takes the same
chunked math on the card, which is differentiable — the reference's
model-level ``flash_attention`` is that math, and its Pallas kernel has no
backward, so it never runs where a gradient is taken. Every other call
launches kernel 6 (``kernels/flash_attention.py``) when it is inside the
TPU kernel's contract — ``softcap == 0``, no ``extra_qk``,
``q_offset == 0``, ``Dv == D`` and the default scale — and raises
``NotImplementedError`` outside it. ``decode_attention`` is plain torch
on every device, as the reference runs no kernel there.

MLA (``init_mla``, ``mla_forward``, ``mla_decode``) is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import \
    flash_attention as flash_kernel
from repro_torch.models.common import (apply_rope, cast, dense_init,
                                       masked_softmax, pdt)

# where the arguments outside kernel 6's contract will be ported
_LATER = ("ROADMAP Queue A item 12c: MLA and the remaining flash_attention "
          "arguments")


# =====================================================================
# Flash-style chunked attention (training / prefill)
# =====================================================================
def kernel_contract(q: torch.Tensor, v: torch.Tensor, *, q_offset: int = 0,
                    softcap: float = 0.0, extra_qk=None,
                    scale: Optional[float] = None) -> Optional[str]:
    """Why a call lies outside kernel 6's contract, or None when the kernel
    computes it."""
    D, Dv = q.shape[-1], v.shape[-1]
    if softcap != 0.0:
        return f"softcap={softcap}"
    if extra_qk is not None:
        return "extra_qk (decomposed MLA scores)"
    if q_offset != 0:
        return f"q_offset={q_offset}"
    if Dv != D:
        return f"Dv={Dv} != D={D}"
    if scale is not None and scale != D ** -0.5:
        return f"scale={scale} (the kernel uses D ** -0.5)"
    return None


def attention_route(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> str:
    """``"plain"`` when autograd is recording and q, k or v requires grad
    (a training path: ``ref.chunked_attention_ref``, differentiable), else
    ``"kernel"`` (kernel 6 on a CUDA tensor). The CPU always runs the plain
    math."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return "plain"
    return "kernel"


def flash_attention(
    q: torch.Tensor,                 # (B, Sq, H, D)
    k: torch.Tensor,                 # (B, Skv, KV, D)
    v: torch.Tensor,                 # (B, Skv, KV, Dv)
    *,
    mode: str = "causal",            # causal | window | full
    q_offset: int = 0,               # absolute position of q[0] among kv
    window: Optional[int] = None,
    softcap: float = 0.0,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    extra_qk: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``extra_qk=(q2 (B,Sq,H,P2), k2 (B,Skv,P2))`` adds a second,
    head-shared score term (the decomposed MLA formulation)."""
    if q.device.type == "cuda" and attention_route(q, k, v) == "kernel":
        why = kernel_contract(q, v, q_offset=q_offset, softcap=softcap,
                              extra_qk=extra_qk, scale=scale)
        if why is not None:
            raise NotImplementedError(
                f"flash_attention on CUDA: {why} is outside kernel 6's "
                f"contract; see {_LATER}")
        return flash_kernel(q, k, v, mode=mode, window=window)
    return ref.chunked_attention_ref(q, k, v, mode=mode, q_offset=q_offset,
                                     window=window, softcap=softcap,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk,
                                     extra_qk=extra_qk, scale=scale)


# =====================================================================
# Single-token decode attention against a (possibly ring) cache
# =====================================================================
def decode_attention(
    q: torch.Tensor,                 # (B, 1, H, D)
    k_cache: torch.Tensor,           # (B, S, KV, D)
    v_cache: torch.Tensor,           # (B, S, KV, Dv)
    *,
    index: int,                      # current absolute position
    positions: Optional[torch.Tensor] = None,   # (B, S) for ring caches
    window: Optional[int] = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    B, S, KV, D = k_cache.shape
    H = q.shape[2]
    G = H // KV
    scale = q.shape[-1] ** -0.5
    qg = q.reshape(B, KV, G, q.shape[-1])
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    if positions is None:
        pos = torch.arange(S, device=q.device)[None, :]    # (1, S)
    else:
        pos = positions                                    # (B, S)
    mask = (pos <= index) & (pos >= 0)
    if window is not None:
        mask &= pos > index - window
    p = masked_softmax(s, mask[:, None, None, :], softcap)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


# =====================================================================
# GQA module
# =====================================================================
def init_gqa(gen: torch.Generator, cfg: ArchConfig,
             lead: Tuple[int, ...] = ()) -> dict:
    dtype = pdt(cfg)
    q_dim = cfg.n_heads * cfg.head_dim
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, q_dim, dtype, lead=lead),
        "wk": dense_init(gen, cfg.d_model, kv_dim, dtype, lead=lead),
        "wv": dense_init(gen, cfg.d_model, kv_dim, dtype, lead=lead),
        "wo": dense_init(gen, q_dim, cfg.d_model, dtype,
                         scale=q_dim ** -0.5, lead=lead),
    }


def gqa_project_kv(p: dict, x: torch.Tensor, cfg: ArchConfig,
                   positions: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V projection (+rope on K), for the full sequence and for decode."""
    B, S, _ = x.shape
    k = (x @ cast(p["wk"], cfg)).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ cast(p["wv"], cfg)).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.rope_theta > 0 and positions is not None:
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
    return k, v


def gqa_forward(
    p: dict,
    x: torch.Tensor,                           # (B, S, D)
    cfg: ArchConfig,
    *,
    positions: Optional[torch.Tensor] = None,  # (B, S) absolute positions
    mode: str = "causal",
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence self-attention (train / prefill). Returns (out, (k, v))
    so prefill can build the cache. The reference's cross-attention
    arguments (``kv_x``, ``kv_positions``, ``cached_kv``) come with the
    audio family."""
    B, S, _ = x.shape
    q = (x @ cast(p["wq"], cfg)).reshape(B, S, cfg.n_heads, cfg.head_dim)
    if cfg.rope_theta > 0 and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
    k, v = gqa_project_kv(p, x, cfg, positions)
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          mode=mode, window=window,
                          softcap=cfg.attn_logit_softcap)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ cast(p["wo"], cfg), (k, v)


def gqa_decode(
    p: dict,
    x: torch.Tensor,                           # (B, 1, D)
    cfg: ArchConfig,
    cache: dict,                               # {"k","v"[, "pos"]}
    index: int,                                # absolute position
    *,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, dict]:
    """One-token decode: write the new KV into the cache (a ring buffer when
    the cache is window-sized) and attend over it. The cache's tensors are
    written in place (the reference builds new arrays); the same dict is
    returned."""
    B = x.shape[0]
    pos_b = torch.full((B, 1), index, dtype=torch.int64, device=x.device)
    q = (x @ cast(p["wq"], cfg)).reshape(B, 1, cfg.n_heads, cfg.head_dim)
    k_new, v_new = gqa_project_kv(p, x, cfg, pos_b)
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos_b, cfg.rope_theta, cfg.rope_pct)

    S = cache["k"].shape[1]
    slot = index % S                                   # ring when S < index
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    positions = None
    if "pos" in cache:
        cache["pos"][:, slot] = index
        positions = cache["pos"]
    out = decode_attention(q, cache["k"], cache["v"], index=index,
                           positions=positions, window=window,
                           softcap=cfg.attn_logit_softcap)
    out = out.reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return out @ cast(p["wo"], cfg), cache
