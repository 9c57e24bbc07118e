"""Shared building blocks of the model zoo (port of ``repro.models.common``).

Everything is functional, as in the reference: parameters are nested dicts
of tensors with JAX's layouts (dense ``w`` is ``(in, out)``), and modules are
(init, apply) pairs of plain functions parameterised by ``ArchConfig``.

Initialisation draws from an explicit ``torch.Generator`` on the
generator's own device, with the reference's distributions: ``dense_init``
is a standard normal truncated to [-2, 2] (not renormalised) times the
fan-in scale, ``embed_init`` is ``N(0, 1) * 0.02``; both are drawn in
float32, in place, and then cast to the parameter dtype. ``lead``
prepends stacked dimensions (the layer axis of a scanned stack), which the
reference gets from ``vmap`` over split keys. The JAX key tree cannot be replayed, so
parity tests carry the reference's own weights across.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NEG_INF = -1e30


# --------------------------------------------------------------------- dtype
def dt(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def pdt(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def cast(x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return x.to(dt(cfg))


# ---------------------------------------------------------------------- init
def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None,
               lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """Truncated-normal fan-in init, ``(*lead, d_in, d_out)``. A stacked
    leaf in a narrower dtype than float32 is drawn one ``(d_in, d_out)``
    slab at a time into its own dtype, so no float32 copy of the whole
    stack exists (llama4-maverick's ``(128, 5120, 8192)`` bfloat16 expert
    stack would need 21 GB for one)."""
    if scale is None:
        scale = d_in ** -0.5
    if lead and dtype != torch.float32:
        out = torch.empty((*lead, d_in, d_out), dtype=dtype,
                          device=gen.device)
        for slab in out.view(-1, d_in, d_out):
            slab.copy_(dense_init(gen, d_in, d_out, dtype, scale))
        return out
    w = torch.empty((*lead, d_in, d_out), dtype=torch.float32,
                    device=gen.device)
    return _trunc_normal_(w, gen).mul_(scale).to(dtype)


def _trunc_normal_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], drawn in place by the inverse
    CDF: the distribution of ``torch.nn.init.trunc_normal_(std=1, a=-2,
    b=2)``, which in recent PyTorch versions redraws by rejection and
    allocates whole-size temporaries on each pass (a layer stack of the
    full-width models is gigabytes)."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
        (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    w.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=gen)
    return w.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


def embed_init(gen: torch.Generator, shape: Tuple[int, ...],
               dtype) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    w.normal_(generator=gen)
    return w.mul_(0.02).to(dtype)


# --------------------------------------------------------------------- norms
def init_norm(cfg: ArchConfig, width: Optional[int] = None,
              lead: Tuple[int, ...] = (), device=None) -> dict:
    width = width or cfg.d_model
    p = {"scale": torch.ones((*lead, width), dtype=pdt(cfg), device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((*lead, width), dtype=pdt(cfg),
                                device=device)
    return p


def apply_norm(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """RMSNorm or LayerNorm, computed in float32, returned in x's dtype."""
    orig_dtype = x.dtype
    x = x.float()
    if cfg.norm_type == "layernorm":
        x = x - x.mean(dim=-1, keepdim=True)
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + cfg.norm_eps)
    x = x * p["scale"].float()
    if cfg.norm_type == "layernorm":
        x = x + p["bias"].float()
    return x.to(orig_dtype)


# --------------------------------------------------------------- activations
def activation_fn(name: str):
    return {
        # jax.nn.gelu defaults to the tanh approximation
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": torch.relu,
        "silu": F.silu,
        "tanh": torch.tanh,
        "linear": lambda x: x,
        "sigmoid": torch.sigmoid,
    }[name]


# ---------------------------------------------------------------------- rope
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embedding over ``head_dim`` dims."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                       # (head_dim//2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_pct: float = 1.0) -> torch.Tensor:
    """Rotary position embedding, computed in float32.

    x: (..., S, H, D); positions: broadcastable to (..., S). ``rope_pct``
    rotates only the first ``pct`` of dims (StableLM-2 partial rotary).
    """
    d = x.shape[-1]
    rot_d = int(d * rope_pct)
    rot_d -= rot_d % 2
    if rot_d == 0:
        return x
    x_rot, x_pass = x[..., :rot_d], x[..., rot_d:]
    inv_freq = rope_frequencies(rot_d, theta, x.device)    # (rot_d//2,)
    angles = positions[..., :, None, None].float() * inv_freq
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


# ----------------------------------------------------------------------- mlp
def init_mlp(gen: torch.Generator, cfg: ArchConfig,
             d_ff: Optional[int] = None, lead: Tuple[int, ...] = ()) -> dict:
    d_ff = d_ff or cfg.d_ff
    dtype = pdt(cfg)
    if cfg.activation in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, cfg.d_model, d_ff, dtype, lead=lead),
            "w_up": dense_init(gen, cfg.d_model, d_ff, dtype, lead=lead),
            "w_down": dense_init(gen, d_ff, cfg.d_model, dtype,
                                 scale=d_ff ** -0.5, lead=lead),
        }
    return {
        "w_up": dense_init(gen, cfg.d_model, d_ff, dtype, lead=lead),
        "b_up": torch.zeros((*lead, d_ff), dtype=dtype, device=gen.device),
        "w_down": dense_init(gen, d_ff, cfg.d_model, dtype,
                             scale=d_ff ** -0.5, lead=lead),
        "b_down": torch.zeros((*lead, cfg.d_model), dtype=dtype,
                              device=gen.device),
    }


def apply_mlp(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.activation in ("swiglu", "geglu"):
        act = activation_fn("silu" if cfg.activation == "swiglu" else "gelu")
        gate = act(x @ cast(p["w_gate"], cfg))
        return (gate * (x @ cast(p["w_up"], cfg))) @ cast(p["w_down"], cfg)
    act = activation_fn("gelu" if cfg.activation == "gelu" else "relu")
    h = act(x @ cast(p["w_up"], cfg) + cast(p["b_up"], cfg))
    return h @ cast(p["w_down"], cfg) + cast(p["b_down"], cfg)


# ------------------------------------------------------------------- softmax
def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor],
                   softcap: float = 0.0) -> torch.Tensor:
    """Softmax in float32 with a bool mask (True = attend); masked scores
    are set to -1e30, not -inf, as the reference does."""
    scores = scores.float()
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    return torch.softmax(scores, dim=-1)


def causal_mask(q_len: int, kv_len: int, q_offset: int,
                device=None) -> torch.Tensor:
    """(q_len, kv_len) bool mask; query i attends kv j iff j <= i + offset."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    return kj <= qi


def window_mask(q_len: int, kv_len: int, q_offset: int, window: int,
                device=None) -> torch.Tensor:
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    return (kj <= qi) & (kj > qi - window)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       vocab_size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-level CE with padded-vocab masking. Returns (loss, accuracy)."""
    logits = logits.float()
    padded = logits.shape[-1]
    if padded > vocab_size:
        pad_mask = torch.arange(padded, device=logits.device) >= vocab_size
        logits = torch.where(pad_mask, NEG_INF, logits)
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    ll = logp.gather(-1, labels[..., None])[..., 0]
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return -ll.mean(), acc
