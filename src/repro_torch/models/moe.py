"""Mixture-of-Experts layer (port of ``repro.models.moe``): a top-k router
with group-wise capacity dispatch, in the einsum-dispatch formulation
(Switch / GShard / MaxText).

Tokens are reshaped into groups; each group routes its tokens into
per-expert capacity slots by cumulative-sum position assignment, and the
expert FFN is one batched einsum over ``(expert, capacity)`` blocks. Slots
per expert ``C = group_size * capacity_factor * top_k / n_experts`` (at
least ``top_k``, at most the group); a token that overflows its expert's
slots in a group is dropped (its combine weight is zero). Dispatch and
combine are plain ``torch.einsum`` (cuBLAS on the card): the reference
runs no Pallas kernel here. ``torch.argmax`` returns the first maximal
index, as ``jnp.argmax`` does, so the dispatch masks are the reference's
exactly.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import apply_mlp, cast, dense_init, \
    init_mlp, pdt


def _capacity(group_size: int, cfg: ArchConfig) -> int:
    moe = cfg.moe
    c = int(group_size * moe.capacity_factor * moe.top_k / moe.n_experts)
    c = max(c, moe.top_k)
    return min(c, group_size)


def init_moe(gen: torch.Generator, cfg: ArchConfig,
             lead: Tuple[int, ...] = ()) -> dict:
    """The float32 router ``(D, E)``, the expert stacks ``(E, D, F)`` and
    ``(E, F, D)``, and the shared expert when the config has one, drawn in
    the reference's order of leaves."""
    moe = cfg.moe
    dtype = pdt(cfg)
    E, D, Fe = moe.n_experts, cfg.d_model, moe.d_ff_expert
    p = {
        "router": dense_init(gen, D, E, torch.float32, scale=D ** -0.5,
                             lead=lead),
        "w_gate": dense_init(gen, D, Fe, dtype, lead=(*lead, E)),
        "w_up": dense_init(gen, D, Fe, dtype, lead=(*lead, E)),
        "w_down": dense_init(gen, Fe, D, dtype, scale=Fe ** -0.5,
                             lead=(*lead, E)),
    }
    if moe.shared_expert:
        p["shared"] = init_mlp(gen, cfg, d_ff=moe.d_ff_expert, lead=lead)
    return p


def route(router_logits: torch.Tensor, cfg: ArchConfig, capacity: int
          ) -> Tuple[torch.Tensor, torch.Tensor,
                     Tuple[torch.Tensor, torch.Tensor]]:
    """Group-wise top-k routing with capacity assignment.

    router_logits: (G, S, E). Returns (dispatch (G, S, E, C) float32 0/1,
    combine (G, S, E, C) float32, (load-balance loss, router z-loss))."""
    moe = cfg.moe
    G, S, E = router_logits.shape
    logits = router_logits.float()
    probs = torch.softmax(logits, dim=-1)

    # aux losses (Switch-style load balance + z-loss)
    density = probs.mean(dim=1)                               # (G, E)
    top1 = F.one_hot(probs.argmax(-1), E).float()
    frac = top1.mean(dim=1)                                   # (G, E)
    lb_loss = E * torch.mean(torch.sum(frac * density, dim=-1))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # iterative top-k: mask out chosen experts each round
    dev = logits.device
    dispatch = torch.zeros((G, S, E, capacity), device=dev)
    combine = torch.zeros((G, S, E, capacity), device=dev)
    masked = probs
    # running per-expert slot counter across the k rounds
    fill = torch.zeros((G, E), dtype=torch.int32, device=dev)
    for _ in range(moe.top_k):
        idx = masked.argmax(dim=-1)                           # (G, S)
        onehot = F.one_hot(idx, E).to(torch.int32)            # (G, S, E)
        gate = torch.sum(masked * onehot.to(masked.dtype), dim=-1)
        # position of each token within its expert's slots this round
        pos_in_expert = (torch.cumsum(onehot, dim=1, dtype=torch.int32)
                         - onehot) + fill[:, None]
        pos = torch.sum(onehot * pos_in_expert, dim=-1)       # (G, S)
        keep = pos < capacity
        slot = F.one_hot(torch.where(keep, pos, capacity).long(),
                         capacity + 1)[..., :capacity].float()  # (G, S, C)
        d = onehot.float()[..., None] * slot[:, :, None, :]
        dispatch = dispatch + d
        combine = combine + d * gate[..., None, None]
        fill = fill + torch.sum(onehot * keep[..., None].to(torch.int32),
                                dim=1, dtype=torch.int32)
        masked = masked * (1.0 - onehot.to(masked.dtype))
    return dispatch, combine, (lb_loss, z_loss)


def apply_moe(p: dict, x: torch.Tensor, cfg: ArchConfig,
              group_size: int = 1024) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (out (B, S, D), aux-loss metrics)."""
    moe = cfg.moe
    B, S, D = x.shape
    tokens = x.reshape(B * S, D)
    n = tokens.shape[0]
    gs = min(group_size, n)
    G = n // gs
    if G * gs != n:
        raise ValueError(f"tokens {n} not divisible by group {gs}")
    xg = tokens.reshape(G, gs, D)
    capacity = _capacity(gs, cfg)

    logits = xg @ cast(p["router"], cfg).to(xg.dtype)         # (G, S, E)
    dispatch, combine, (lb, zl) = route(logits.float(), cfg, capacity)
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)

    # dispatch tokens into (G, E, C, D) expert blocks
    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)
    # expert FFN (swiglu), the expert dim contracted against the stacks
    gate = F.silu(torch.einsum("gecd,edf->gecf", xe, cast(p["w_gate"], cfg)))
    up = torch.einsum("gecd,edf->gecf", xe, cast(p["w_up"], cfg))
    ye = torch.einsum("gecf,efd->gecd", gate * up, cast(p["w_down"], cfg))
    # combine back to token order
    y = torch.einsum("gsec,gecd->gsd", combine, ye).reshape(B, S, D)

    if moe.shared_expert:
        y = y + apply_mlp(p["shared"], x, cfg)

    metrics = {"moe_lb_loss": lb, "moe_z_loss": zl,
               "moe_aux": moe.load_balance_loss * lb
               + moe.router_z_loss * zl}
    return y, metrics
