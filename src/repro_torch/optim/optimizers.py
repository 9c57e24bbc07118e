"""The reference's optimizers (``repro.optim.optimizers``) over tensor
trees: SGD, SGD with momentum (float32 or bfloat16 momentum), Adam and
AdamW, with global-norm gradient clipping. ``opt = make_optimizer(name,
lr, ...)``; ``state = opt.init(params)``; ``params, state =
opt.update(params, grads, state)``.

Not ``torch.optim``: every step is the reference's op chain in float32 —
Adam's ``m̂/(√v̂+ε)`` with the bias corrections ``1 - b**t`` computed as
float32 tensors from a float ``t``, momentum ``momentum·m + g`` rounded to
the momentum's dtype, each product rounded before the sum it feeds (no
fused multiply-add) — so one step agrees with the reference to float32
rounding, and the bfloat16 casts round to nearest even as JAX's do.
Weight decay (AdamW) applies to leaves with ``ndim >= 2`` only; the clip
happens before each update.

``update(..., inplace=True)`` writes the new parameters and state into
the tensors it was given, leaf by leaf, and scales the gradients in place
when clipping: the same values (``torch.equal``) with no second copy of
the parameters or the state, which a full-width model on one card needs.
The default returns new trees and leaves its arguments as they were.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch import trace
from repro_torch.core.pytree import flatten, leaves, tree_map, unflatten

Tree = Any

NAMES = ("sgd", "sgdm", "sgdm_bf16", "adam", "adamw")


def global_norm(tree: Tree) -> torch.Tensor:
    """``sqrt`` of the sum of every leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def _clip_scale(grads: Tree, max_norm: float) -> torch.Tensor:
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tree:
    scale = _clip_scale(grads, max_norm)
    return tree_map(lambda g: (g.float() * scale.to(g.device)).to(g.dtype),
                    grads)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Tree], Tree]
    update: Callable[..., Tuple[Tree, Tree]]


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def make_optimizer(name: str, lr: float, *, weight_decay: float = 0.0,
                   grad_clip: float = 0.0, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8,
                   momentum: float = 0.9) -> Optimizer:
    if name not in NAMES:
        raise ValueError(f"unknown optimizer {name}")
    wd = weight_decay if name == "adamw" else 0.0
    mdtype = torch.bfloat16 if name == "sgdm_bf16" else torch.float32
    slots = {"sgd": (), "sgdm": ("mu",), "sgdm_bf16": ("mu",),
             "adam": ("m", "v"), "adamw": ("m", "v")}[name]

    def init(params):
        dtype = mdtype if name.startswith("sgdm") else torch.float32
        state = {"count": 0}
        for s in slots:
            state[s] = tree_map(
                lambda p: torch.zeros_like(p, dtype=dtype), params)
        return state

    def step_fn(t: int):
        """The per-leaf update at step ``t``: ``(p, g, *slots) -> (new p,
        *new slots)``, every intermediate float32."""
        if name == "sgd":
            return lambda p, g: ((p.float() - lr * g.float()).to(p.dtype),)
        if name in ("sgdm", "sgdm_bf16"):
            def sgdm(p, g, mu):
                mu = (momentum * mu.float() + g.float()).to(mdtype)
                return (p.float() - lr * mu.float()).to(p.dtype), mu
            return sgdm
        tf = _f32(float(t))
        bc1 = 1 - torch.pow(_f32(b1), tf)       # float32, as jnp computes
        bc2 = 1 - torch.pow(_f32(b2), tf)

        def adam(p, g, m, v):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            step = (m / trace.to_device(bc1, m.device)) / (
                torch.sqrt(v / trace.to_device(bc2, v.device)) + eps)
            if wd > 0.0 and p.dim() >= 2:
                step = step + wd * p.float()
            return (p.float() - lr * step).to(p.dtype), m, v
        return adam

    @torch.no_grad()
    def update(params, grads, state, *, inplace: bool = False):
        if grad_clip > 0:
            if inplace:
                scale = _clip_scale(grads, grad_clip)
                for g in leaves(grads):
                    g.copy_((g.float() * scale.to(g.device)).to(g.dtype))
            else:
                grads = clip_by_global_norm(grads, grad_clip)
        t = state["count"] + 1
        fn = step_fn(t)
        ps, treedef = flatten(params)
        cols = [ps, leaves(grads)] + [leaves(state[s]) for s in slots]
        outs = []
        for xs in zip(*cols, strict=True):
            new = fn(*xs)
            if inplace:
                xs[0].copy_(new[0])
                for dst, src in zip(xs[2:], new[1:]):
                    dst.copy_(src)
                new = None
            outs.append(new)
        if inplace:
            new_state = dict(state, count=t)
            return params, new_state
        new_state = {"count": t}
        for i, s in enumerate(slots):
            new_state[s] = unflatten(treedef, [o[i + 1] for o in outs])
        return unflatten(treedef, [o[0] for o in outs]), new_state

    return Optimizer(name, init, update)
