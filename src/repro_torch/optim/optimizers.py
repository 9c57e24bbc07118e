"""Adam as the reference writes it (``repro.optim.optimizers``), over tensor
trees: ``opt = make_optimizer(name, lr)``; ``state = opt.init(params)``;
``params, state = opt.update(params, grads, state)``.

Not ``torch.optim.Adam``: the step is ``m̂/(√v̂+ε)`` with the bias
corrections ``1 - b**t`` computed as float32 tensors from a float ``t``,
the reference's op chain, so one step agrees with it to float32 rounding.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.core.pytree import tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def make_optimizer(name: str, lr: float, *, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    if name != "adam":
        raise ValueError(f"optimizer {name!r} is not ported (only adam)")

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa
        return {"count": 0, "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(params, grads, state):
        t = state["count"] + 1
        m = tree_map(lambda a, g: b1 * a + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda a, g: b2 * a + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        tf = _f32(float(t))
        bc1 = 1 - torch.pow(_f32(b1), tf)        # float32, as jnp computes
        bc2 = 1 - torch.pow(_f32(b2), tf)

        def upd(p, ml, vl):
            dev = ml.device
            mh = ml / bc1.to(dev)
            vh = vl / bc2.to(dev)
            step = mh / (torch.sqrt(vh) + eps)
            return (p.float() - lr * step).to(p.dtype)
        new = tree_map(upd, params, m, v)
        return new, {"count": t, "m": m, "v": v}

    return Optimizer(name, init, update)
