"""FedAvg aggregation over decoded collaborator updates (port of
``repro.core.aggregate``): the stacked reduction the server paths use, the
sequence API over a list of per-client trees (:func:`weighted_mean`,
:func:`fedavg`, :func:`buffered_aggregate`), and the async buffer's
staleness and distortion discounts."""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from repro_torch.core.pytree import stack, tree_map

Tree = Any


def normalize_weights(weights: Sequence[float]) -> List[float]:
    """Host-side normalization in Python floats, shared by every
    aggregation path so they agree bit for bit on the weights."""
    total = float(sum(weights))
    return [float(w) / total for w in weights]


def weighted_mean_stacked(stacked: Tree, weights: Sequence[float], *,
                          normalized: bool = False) -> Tree:
    """Weighted mean over the leading client axis of every leaf: one einsum
    per leaf, weights normalized on the host unless they already are."""
    if not normalized:
        weights = normalize_weights(weights)
    w = torch.tensor(weights, dtype=torch.float32)

    def combine(leaf):
        m = torch.einsum("c,c...->...", w.to(leaf.device), leaf.float())
        return m.to(leaf.dtype)

    return tree_map(combine, stacked)


def weighted_mean(updates: Sequence[Tree],
                  weights: Optional[Sequence[float]] = None) -> Tree:
    """The sequence API for callers holding per-client trees: stacks the
    leaves and delegates to :func:`weighted_mean_stacked` (equal weights
    when none are given)."""
    if weights is None:
        weights = [1.0] * len(updates)
    return weighted_mean_stacked(stack(list(updates)),
                                 normalize_weights(weights), normalized=True)


@torch.no_grad()
def apply_update(global_params: Tree, mean_update: Tree,
                 server_lr: float = 1.0) -> Tree:
    return tree_map(
        lambda p, u: (p.float() + server_lr * u.float()).to(p.dtype),
        global_params, mean_update)


def fedavg(global_params: Tree, updates: Sequence[Tree],
           weights: Optional[Sequence[float]] = None,
           server_lr: float = 1.0) -> Tree:
    return apply_update(global_params, weighted_mean(updates, weights),
                        server_lr)


def staleness_weights(base_weights: Sequence[float],
                      staleness: Sequence[int],
                      power: float = 0.5) -> List[float]:
    """FedBuff-style staleness discount (Nguyen et al., 2022): an update
    computed against global version ``v`` and applied at ``v + s`` is
    weighted by ``(1 + s) ** -power``; ``power=0`` is plain sample-count
    weighting (DESIGN.md §6.2). Only the relative discount matters: the
    server normalizes."""
    if len(base_weights) != len(staleness):
        raise ValueError("one staleness per weight")
    return [w * float(1 + s) ** (-power)
            for w, s in zip(base_weights, staleness)]


def distortion_weights(base_weights: Sequence[float],
                       distortions: Sequence[Optional[float]],
                       power: float = 1.0) -> List[float]:
    """Distortion discount for the async buffer (DESIGN.md §15.5): an
    update that rode a lossier codec is weighted by ``(1 + e_i) ** -power``,
    ``e_i`` the client's probed current-rung relative reconstruction error
    (``RateController.distortion_of``). ``None`` (not probed yet, or no
    controller) leaves the weight as it is. Host floats, as the reference
    computes them, so both packages give the same weights."""
    if len(base_weights) != len(distortions):
        raise ValueError("one distortion per weight")
    return [w if e is None else w * float(1 + e) ** (-power)
            for w, e in zip(base_weights, distortions)]


def buffered_aggregate(global_params: Tree, updates: Sequence[Tree],
                       base_weights: Sequence[float],
                       staleness: Sequence[int], *, power: float = 0.5,
                       server_lr: float = 1.0) -> Tree:
    """One async buffer flush: staleness-discounted FedAvg over the buffer's
    updates."""
    return fedavg(global_params, updates,
                  staleness_weights(base_weights, staleness, power),
                  server_lr)
