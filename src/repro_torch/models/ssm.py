"""Mamba-2 SSD mixer (port of ``repro.models.ssm``; state-space duality,
arXiv:2405.21060).

Training and prefill use the chunked dual form: inside a chunk the
quadratic, attention-like branch (``(chunk x chunk)`` products), across
chunks a linear recurrence over the per-chunk states. The reference writes
it with einsums and a ``lax.scan`` over the ``S / chunk`` chunk states and
runs no Pallas kernel, so here it is plain torch on every device: each
einsum a pairwise product (batched matrix products, no intermediate wider
than the ``(chunk x chunk)`` decay block of every head), the scan a Python
loop over the chunks (4 a layer at mamba2-2.7b's 1,024-token prompts).

Decode keeps O(1) state a layer: the depthwise conv's tail of the last
``conv_width - 1`` inputs and the ``(H, P, N)`` SSM state.

``softplus`` is the reference's ``jax.nn.softplus`` (``logaddexp(x, 0)``),
not ``F.softplus``, which switches to ``x`` above 20. Masked segment sums
are ``-inf`` and ``exp`` makes them exact zeros, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (apply_norm, cast, dense_init,
                                       init_norm, pdt)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) -> (..., T, T) with S[i, j] = sum_{k=j+1..i} x_k for
    i >= j and -inf elsewhere (log-space decay between positions)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, -torch.inf)


def ssd_scan(
    x: torch.Tensor,         # (B, S, H, P) — pre-scaled by dt
    dA: torch.Tensor,        # (B, S, H)    — dt * A (negative)
    Bm: torch.Tensor,        # (B, S, G, N)
    Cm: torch.Tensor,        # (B, S, G, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in float32. Returns (y (B, S, H, P) in x's dtype,
    final_state (B, H, P, N) float32)."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hg = h // g
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    S = s + pad
    nc = S // chunk

    f32 = torch.float32
    # heads into (group, heads-per-group), the sequence into chunks
    xc = x.reshape(b, nc, chunk, g, hg, p).to(f32)
    dAc = dA.reshape(b, nc, chunk, g, hg).permute(0, 3, 4, 1, 2)  # b,g,hg,c,i
    Bc = Bm.reshape(b, nc, chunk, g, n).to(f32)
    Cc = Cm.reshape(b, nc, chunk, g, n).to(f32)
    x_t = xc.permute(0, 1, 3, 4, 2, 5)                     # b,c,g,hg,j,p
    B_t = Bc.permute(0, 1, 3, 2, 4)[:, :, :, None]         # b,c,g,1,j,n
    C_t = Cc.permute(0, 1, 3, 2, 4)[:, :, :, None]         # b,c,g,1,i,n

    dA_cumsum = torch.cumsum(dAc, dim=-1)                  # (b,g,hg,c,i)

    # --- intra-chunk (quadratic, "attention-like") branch
    L = torch.exp(_segsum(dAc)).permute(0, 3, 1, 2, 4, 5)  # b,c,g,hg,i,j
    CB = C_t @ B_t.transpose(-1, -2)                       # b,c,g,1,i,j
    y_diag = (CB * L) @ x_t                                # b,c,g,hg,i,p

    # --- per-chunk input states
    decay_states = torch.exp(dA_cumsum[..., -1:] - dA_cumsum)  # b,g,hg,c,j
    xd = x_t * decay_states.permute(0, 3, 1, 2, 4)[..., None]
    states = xd.transpose(-1, -2) @ B_t                    # b,c,g,hg,p,n

    # --- inter-chunk linear recurrence over the chunk states
    chunk_decay = torch.exp(dA_cumsum[..., -1])            # (b,g,hg,c)
    if init_state is None:
        carry = torch.zeros((b, g, hg, p, n), dtype=f32, device=x.device)
    else:
        carry = init_state.reshape(b, g, hg, p, n).to(f32)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[..., c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # b,c,g,hg,p,n

    # --- inter-chunk output contribution
    state_decay_out = torch.exp(dA_cumsum).permute(0, 3, 1, 2, 4)  # b,c,g,hg,i
    y_off = (C_t @ prev_states.transpose(-1, -2)) * state_decay_out[..., None]

    y = (y_diag + y_off).permute(0, 1, 4, 2, 3, 5).reshape(b, S, h, p)[:, :s]
    return y.to(x.dtype), carry.reshape(b, h, p, n)


# =====================================================================
# Mamba-2 block
# =====================================================================
def _dims(cfg: ArchConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    n_heads = d_inner // ssm.head_dim
    conv_channels = d_inner + 2 * ssm.n_groups * ssm.d_state
    return ssm, d_inner, n_heads, conv_channels


def init_mamba2(gen: torch.Generator, cfg: ArchConfig,
                lead: Tuple[int, ...] = ()) -> dict:
    """The reference's leaves and distributions, stacked over ``lead``;
    ``A_log`` is ``log(linspace(1, 16, H))`` in every layer."""
    ssm, d_inner, n_heads, conv_ch = _dims(cfg)
    dtype = pdt(cfg)
    dev = gen.device
    f32 = torch.float32
    conv_w = torch.empty((*lead, ssm.conv_width, conv_ch), dtype=f32,
                         device=dev)
    return {
        # joint projection to [z | xBC | dt]
        "w_in": dense_init(gen, cfg.d_model, d_inner + conv_ch + n_heads,
                           dtype, lead=lead),
        "conv_w": conv_w.normal_(generator=gen).mul_(0.1).to(dtype),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((*lead, n_heads), dtype=f32, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=f32,
                                          device=dev)).expand(
                                              *lead, n_heads).clone(),
        "D": torch.ones((*lead, n_heads), dtype=f32, device=dev),
        "gate_norm": init_norm(cfg, d_inner, lead=lead, device=dev),
        "w_out": dense_init(gen, d_inner, cfg.d_model, dtype,
                            scale=d_inner ** -0.5, lead=lead),
    }


def _split_in(p: dict, x: torch.Tensor, cfg: ArchConfig):
    ssm, d_inner, n_heads, conv_ch = _dims(cfg)
    h = x @ cast(p["w_in"], cfg)
    z, xbc, dt = torch.split(h, [d_inner, conv_ch, n_heads], dim=-1)
    return z, xbc, dt


def _conv_full(p: dict, xbc: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Causal depthwise conv over the sequence (train / prefill)."""
    w = cast(p["conv_w"], cfg)                      # (W, C)
    W = w.shape[0]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + pad[:, i:i + xbc.shape[1], :] * w[i]
    return F.silu(out + cast(p["conv_b"], cfg))


def mamba2_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                   init_state: Optional[dict] = None
                   ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence mixer. Returns (out, final_state dict)."""
    ssm, d_inner, n_heads, conv_ch = _dims(cfg)
    B, S, _ = x.shape
    z, xbc, dt = _split_in(p, x, cfg)
    xbc = _conv_full(p, xbc, cfg)
    gn = ssm.n_groups * ssm.d_state
    xs, Bm, Cm = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    xs = xs.reshape(B, S, n_heads, ssm.head_dim)
    Bm = Bm.reshape(B, S, ssm.n_groups, ssm.d_state)
    Cm = Cm.reshape(B, S, ssm.n_groups, ssm.d_state)

    dt = softplus(dt.float() + p["dt_bias"])                     # (B,S,H)
    A = -torch.exp(p["A_log"])                                   # (H,)
    y, final = ssd_scan(xs * dt[..., None], dt * A, Bm, Cm,
                        ssm.chunk_size,
                        None if init_state is None else init_state["ssm"])
    y = y + xs * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = apply_norm(p["gate_norm"], y * F.silu(z), cfg)
    out = y @ cast(p["w_out"], cfg)

    # decode-ready state: the last (conv_width-1) pre-activation conv
    # inputs, re-projected from those tokens as the reference does
    _, xbc_raw, _ = _split_in(p, x[:, -(ssm.conv_width - 1):], cfg)
    state = {"conv": xbc_raw.float(), "ssm": final}
    return out, state


def mamba2_decode(p: dict, x: torch.Tensor, cfg: ArchConfig,
                  state: dict) -> Tuple[torch.Tensor, dict]:
    """One-token step. state: {"conv": (B, W-1, C), "ssm": (B, H, P, N)};
    returns new state tensors (the caller writes them into its cache)."""
    ssm, d_inner, n_heads, conv_ch = _dims(cfg)
    B = x.shape[0]
    z, xbc_new, dt = _split_in(p, x, cfg)                # (B,1,*)
    window = torch.cat([state["conv"], xbc_new.float()], dim=1)  # (B,W,C)
    w = p["conv_w"].float()                              # (W, C)
    conv = torch.einsum("bwc,wc->bc", window, w) + p["conv_b"].float()
    xbc = F.silu(conv)[:, None, :].to(x.dtype)           # (B,1,C)

    gn = ssm.n_groups * ssm.d_state
    xs, Bm, Cm = torch.split(xbc[:, 0], [d_inner, gn, gn], dim=-1)
    xs = xs.reshape(B, n_heads, ssm.head_dim)            # (B,H,P)
    Bm = Bm.reshape(B, ssm.n_groups, ssm.d_state)
    Cm = Cm.reshape(B, ssm.n_groups, ssm.d_state)
    hg = n_heads // ssm.n_groups

    dt1 = softplus(dt[:, 0].float() + p["dt_bias"])      # (B,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt1 * A)                           # (B,H)
    h_prev = state["ssm"].float()                        # (B,H,P,N)
    xbar = xs.float() * dt1[..., None]                   # (B,H,P)
    Bh = torch.repeat_interleave(Bm, hg, dim=1)          # (B,H,N)
    Ch = torch.repeat_interleave(Cm, hg, dim=1)
    h_new = (h_prev * decay[..., None, None]
             + xbar[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", h_new, Ch.float())
    y = y + xs.float() * p["D"][None, :, None]
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = apply_norm(p["gate_norm"], y * F.silu(z), cfg)
    out = y @ cast(p["w_out"], cfg)
    return out, {"conv": window[:, 1:], "ssm": h_new}


def init_mamba2_state(cfg: ArchConfig, batch: int,
                      lead: Tuple[int, ...] = (), device=None) -> dict:
    ssm, d_inner, n_heads, conv_ch = _dims(cfg)
    f32 = torch.float32
    return {
        "conv": torch.zeros((*lead, batch, ssm.conv_width - 1, conv_ch),
                            dtype=f32, device=device),
        "ssm": torch.zeros((*lead, batch, n_heads, ssm.head_dim,
                            ssm.d_state), dtype=f32, device=device),
    }
