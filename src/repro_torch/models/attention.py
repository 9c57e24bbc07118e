"""Attention (port of ``repro.models.attention``): full-sequence flash
attention for training, prefill, the audio encoder and cross-attention,
single-token decode attention against a linear or ring cache, the GQA
module and MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2
style).

``flash_attention`` keeps the reference's whole signature. On the CPU it
runs the reference's chunked online-softmax math
(``ref.chunked_attention_ref``: query chunks, and inside them kv chunks
with an (m, l, acc) carry), so no (Sq, Skv) matrix is built.
On a CUDA tensor :func:`attention_route` splits as the reference does: a
training path (autograd recording through q, k or v) takes the same
chunked math on the card, which is differentiable — the reference's
model-level ``flash_attention`` is that math, and its Pallas kernel has no
backward, so it never runs where a gradient is taken. Every other call
launches kernel 6 (``kernels/flash_attention.py``), which takes the whole
argument list: ``softcap`` and ``q_offset`` in the kernel itself, and
``extra_qk`` (the decomposed MLA scores) as ``[q | q2] · [k | k2]`` on
concatenated operands (``flash_attention_extra``). Outside
:func:`kernel_contract` (head dims above 256, a dtype other than bfloat16
or float32) a CUDA call raises. The head-dim pairs the kernel
instantiates (its ``HEAD_DIM_PAIRS``: ``Dv == D`` at 16, 32, 64, 96, 128
and 256, and MLA's 96 over 64) launch it directly with any scale, which
is how MLA's prefill (``D`` 96, ``Dv`` 64 at minicpm3-4b's width),
phi-3-vision's heads of 96 and recurrentgemma-9b's heads of 256 reach
it; other pairs take its padded route (``flash_attention_padded``: q, k
and v zero-padded to the next head dim it has, the unpadded scale, the
output sliced).
On the meta device (the dry-run's shapes-only run) the chunked math runs
as one query chunk over one kv chunk: the same products, counted once,
without the Python loop over chunk pairs.
``decode_attention`` and ``mla_decode`` are plain torch on every device,
as the reference runs no kernel there.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    DTYPES, HEAD_DIMS, flash_attention as flash_kernel,
    flash_attention_extra as flash_kernel_extra,
    flash_attention_padded as flash_kernel_padded, kernel_pair,
    padded_head_dim)
from repro_torch.models.common import (apply_norm, apply_rope, cast,
                                       dense_init, init_norm,
                                       masked_softmax, pdt)


# =====================================================================
# Flash-style chunked attention (training / prefill)
# =====================================================================
def kernel_contract(q: torch.Tensor, v: torch.Tensor, *,
                    extra_qk=None) -> Optional[str]:
    """Why a call lies outside kernel 6's contract, or None when the kernel
    computes it (natively, or through its padded route). Any scale,
    ``q_offset`` and ``softcap`` are in the contract, the kernel takes them
    as arguments; ``extra_qk`` widens the score head dim to ``D + P2``."""
    D, Dv = q.shape[-1], v.shape[-1]
    if extra_qk is not None:
        D += extra_qk[0].shape[-1]
    if q.dtype not in DTYPES:
        return f"dtype {q.dtype} (the kernel takes bfloat16 and float32)"
    if padded_head_dim(D, Dv) is None:
        return f"head dims D={D}, Dv={Dv} above {HEAD_DIMS[-1]}"
    return None


def kernel_padded(q: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether a call inside the contract takes the kernel's padded route:
    head dims ``(D, Dv)`` it has no instantiation for. The scale is an
    argument of every launch, so it routes nothing."""
    return not kernel_pair(q.shape[-1], v.shape[-1])


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
        why = kernel_contract(q, v, extra_qk=extra_qk)
        if why is not None:
            raise ValueError(f"flash_attention on CUDA: {why} is outside "
                             "kernel 6's contract")
        kw = dict(mode=mode, window=window, q_offset=q_offset,
                  softcap=softcap)
        if extra_qk is not None:
            return flash_kernel_extra(q, k, v, extra_qk, scale=scale, **kw)
        if kernel_padded(q, v):
            return flash_kernel_padded(q, k, v, scale=scale, **kw)
        return flash_kernel(q, k, v, scale=scale, **kw)
    if q.device.type == "meta":
        q_chunk, kv_chunk = q.shape[1], k.shape[1]
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
    kv_x: Optional[torch.Tensor] = None,       # cross-attention source
    kv_positions: Optional[torch.Tensor] = None,
    cached_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (train / prefill / encoder / cross).
    Returns (out, (k, v)) so prefill can build the cache and
    cross-attention can reuse the projected encoder K/V."""
    B, S, _ = x.shape
    q = (x @ cast(p["wq"], cfg)).reshape(B, S, cfg.n_heads, cfg.head_dim)
    if cfg.rope_theta > 0 and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
    if cached_kv is not None:
        k, v = cached_kv
    else:
        src = x if kv_x is None else kv_x
        pos = positions if kv_x is None else kv_positions
        k, v = gqa_project_kv(p, src, cfg, pos)
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


# =====================================================================
# MLA (Multi-head Latent Attention) — MiniCPM3 / DeepSeek-V2 style
# =====================================================================
def init_mla(gen: torch.Generator, cfg: ArchConfig,
             lead: Tuple[int, ...] = ()) -> dict:
    """Drawn in the reference's order of leaves; ``w_uk`` and ``w_uv`` are
    stored ``(..., r, H, dim)`` for the absorbed decode path, as there."""
    m = cfg.mla
    dtype = pdt(cfg)
    H = cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = gen.device
    return {
        "w_dq": dense_init(gen, cfg.d_model, m.q_lora_rank, dtype,
                           lead=lead),
        "q_norm": init_norm(cfg, m.q_lora_rank, lead=lead, device=dev),
        "w_uq": dense_init(gen, m.q_lora_rank, H * qk_dim, dtype, lead=lead),
        # joint down-projection: [c_kv | k_rope]
        "w_dkv": dense_init(gen, cfg.d_model,
                            m.kv_lora_rank + m.qk_rope_head_dim, dtype,
                            lead=lead),
        "kv_norm": init_norm(cfg, m.kv_lora_rank, lead=lead, device=dev),
        "w_uk": dense_init(gen, m.kv_lora_rank, H * m.qk_nope_head_dim,
                           dtype, lead=lead).reshape(
                               *lead, m.kv_lora_rank, H, m.qk_nope_head_dim),
        "w_uv": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, dtype,
                           lead=lead).reshape(
                               *lead, m.kv_lora_rank, H, m.v_head_dim),
        "wo": dense_init(gen, H * m.v_head_dim, cfg.d_model, dtype,
                         scale=(H * m.v_head_dim) ** -0.5, lead=lead),
    }


def _mla_q(p: dict, x: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    q_lat = apply_norm(p["q_norm"], x @ cast(p["w_dq"], cfg), cfg)
    q = (q_lat @ cast(p["w_uq"], cfg)).reshape(B, S, H, qk_dim)
    q_nope, q_rope = torch.split(
        q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_kv_latent(p: dict, x: torch.Tensor, cfg: ArchConfig,
                   positions: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg.mla
    dkv = x @ cast(p["w_dkv"], cfg)
    c_kv, k_rope = torch.split(
        dkv, [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = apply_norm(p["kv_norm"], c_kv, cfg)         # (B, S, r)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)                # (B, S, 1, rope_d)
    return c_kv, k_rope[:, :, 0, :]


def mla_forward(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                positions: torch.Tensor, mode: str = "causal",
                window: Optional[int] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence MLA (train / prefill): expand the latent to per-head
    K/V and run flash attention on the concatenated ``[nope | rope]``
    heads, as the reference keeps it. Returns (out, (c_kv, k_rope)) for
    the cache."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_kv_latent(p, x, cfg, positions)
    k_nope = torch.einsum("bsr,rhn->bshn", c_kv, cast(p["w_uk"], cfg))
    v = torch.einsum("bsr,rhv->bshv", c_kv, cast(p["w_uv"], cfg))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    out = flash_attention(q, k, v.contiguous(), mode=mode, window=window)
    out = out.reshape(B, S, H * m.v_head_dim)
    return out @ cast(p["wo"], cfg), (c_kv, k_rope)


def mla_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict,
               index: int) -> Tuple[torch.Tensor, dict]:
    """Absorbed-matrix MLA decode: attention runs in the latent space
    against the cache's ``c_kv (B, S, r)`` and ``k_rope (B, S, rope)``,
    which are written in place (the same dict is returned)."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    pos_b = torch.full((B, 1), index, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, pos_b)          # (B,1,H,*)
    c_new, kr_new = _mla_kv_latent(p, x, cfg, pos_b)   # (B,1,r), (B,1,rope)

    S = cache["c_kv"].shape[1]
    slot = index % S
    cache["c_kv"][:, slot] = c_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, slot] = kr_new[:, 0].to(cache["k_rope"].dtype)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]

    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    # absorb W_uk into q: (B,1,H,r)
    q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope, cast(p["w_uk"], cfg))
    s = (torch.einsum("bqhr,bsr->bhqs", q_abs.float(), c_kv.float())
         + torch.einsum("bqhp,bsp->bhqs", q_rope.float(),
                        k_rope.float())) * scale
    mask = (torch.arange(S, device=x.device) <= index)[None, None, None, :]
    probs = masked_softmax(s, mask)
    ctx = torch.einsum("bhqs,bsr->bqhr", probs, c_kv.float())
    out = torch.einsum("bqhr,rhv->bqhv", ctx.to(x.dtype),
                       cast(p["w_uv"], cfg))
    out = out.reshape(B, 1, H * m.v_head_dim)
    return out @ cast(p["wo"], cfg), cache
