"""RG-LRU recurrent block (port of ``repro.models.rglru``; RecurrentGemma
/ Griffin, arXiv:2402.19427).

Recurrence: h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), with
a_t = exp(-c * softplus(Lambda) * r_t), r and i input-dependent sigmoid
gates. Training and prefill evaluate it with :func:`associative_scan`,
a log-depth scan in torch ops that mirrors ``jax.lax.associative_scan``'s
odd/even recursion (pairs combined, the half-length scan recursed, the
even elements filled in, interleaved), so the products are taken in the
reference's order: about ``2 log2(S)`` levels of element-wise work
instead of S sequential steps (4,096 a layer at recurrentgemma-9b's
prompts). Decode is one element-wise step over O(width) state.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import cast, dense_init, pdt
from repro_torch.models.ssm import softplus

_C = 8.0   # Griffin's fixed recurrence-sharpness constant


def init_rglru_block(gen: torch.Generator, cfg: ArchConfig,
                     lead: Tuple[int, ...] = ()) -> dict:
    """The reference's leaves and distributions, stacked over ``lead``:
    ``lambda`` so that a^c spans ~(0.9, 0.999)."""
    rg = cfg.rglru
    W = rg.lru_width
    dtype = pdt(cfg)
    dev = gen.device
    f32 = torch.float32
    conv_w = torch.empty((*lead, rg.conv_width, W), dtype=f32, device=dev)
    conv_w = conv_w.normal_(generator=gen).mul_(0.1).to(dtype)
    u = torch.empty((*lead, W), dtype=f32, device=dev).uniform_(
        0.9 ** 2, 0.999 ** 2, generator=gen)
    return {
        "w_x": dense_init(gen, cfg.d_model, W, dtype, lead=lead),
        "w_gate": dense_init(gen, cfg.d_model, W, dtype, lead=lead),
        "conv_w": conv_w,
        "conv_b": torch.zeros((*lead, W), dtype=dtype, device=dev),
        "w_a": dense_init(gen, W, W, dtype, lead=lead),
        "b_a": torch.zeros((*lead, W), dtype=f32, device=dev),
        "w_i": dense_init(gen, W, W, dtype, lead=lead),
        "b_i": torch.zeros((*lead, W), dtype=f32, device=dev),
        # softplus^-1(-log u / c)
        "lambda": torch.log(torch.expm1(-torch.log(u) / _C)),
        "w_out": dense_init(gen, W, cfg.d_model, dtype, scale=W ** -0.5,
                            lead=lead),
    }


def _gates(p: dict, xs: torch.Tensor, cfg: ArchConfig):
    """a_t (decay) and the scaled input, in float32."""
    r = torch.sigmoid(xs @ cast(p["w_a"], cfg) + p["b_a"].to(xs.dtype))
    i = torch.sigmoid(xs @ cast(p["w_i"], cfg) + p["b_i"].to(xs.dtype))
    log_a = (-_C * softplus(p["lambda"])) * r.float()      # (B,S,W)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = beta * i.float() * xs.float()
    return a, b, log_a


def _conv_full(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    w = cast(p["conv_w"], cfg)
    W = w.shape[0]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return out + cast(p["conv_b"], cfg)


def _combine(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[e0, o0, e1, o1, ...] along dim 1; ``even`` as long as ``odd`` or
    one longer."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n:]], dim=1)


def associative_scan(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``(a, b)`` along dim 1 under ``(a1, b1) . (a2, b2)
    = (a1 a2, a2 b1 + b2)``: ``jax.lax.associative_scan``'s recursion."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                  init_state: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence recurrent block. Returns (out, decode-ready state)."""
    xs_raw = x @ cast(p["w_x"], cfg)                      # (B,S,W)
    gate = x @ cast(p["w_gate"], cfg)
    xs = _conv_full(p, xs_raw, cfg)
    a, b, _ = _gates(p, xs, cfg)
    a_sc, h = associative_scan(a, b)
    if init_state is not None and "h" in init_state:
        # fold a prior hidden state in: h_t += (prod_{<=t} a) * h0
        h = h + a_sc * init_state["h"].float()[:, None, :]
    y = h.to(x.dtype) * F.gelu(gate, approximate="tanh")
    out = y @ cast(p["w_out"], cfg)
    state = {"conv": xs_raw[:, -(cfg.rglru.conv_width - 1):].float(),
             "h": h[:, -1].float()}
    return out, state


def rglru_decode(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 state: dict) -> Tuple[torch.Tensor, dict]:
    """One-token step. state: {"conv": (B, W-1, width), "h": (B, width)};
    returns new state tensors (the caller writes them into its cache)."""
    xs_raw = x @ cast(p["w_x"], cfg)                      # (B,1,W)
    gate = x @ cast(p["w_gate"], cfg)
    window = torch.cat([state["conv"], xs_raw.float()], dim=1)
    w = p["conv_w"].float()
    xs = (torch.einsum("bwc,wc->bc", window, w)
          + p["conv_b"].float())[:, None, :]              # (B,1,W)
    a, b, _ = _gates(p, xs.to(x.dtype), cfg)
    h = a[:, 0] * state["h"].float() + b[:, 0]
    y = h[:, None, :].to(x.dtype) * F.gelu(gate, approximate="tanh")
    out = y @ cast(p["w_out"], cfg)
    return out, {"conv": window[:, 1:], "h": h}


def init_rglru_state(cfg: ArchConfig, batch: int,
                     lead: Tuple[int, ...] = (), device=None) -> dict:
    rg = cfg.rglru
    f32 = torch.float32
    return {"conv": torch.zeros((*lead, batch, rg.conv_width - 1,
                                 rg.lru_width), dtype=f32, device=device),
            "h": torch.zeros((*lead, batch, rg.lru_width), dtype=f32,
                             device=device)}
