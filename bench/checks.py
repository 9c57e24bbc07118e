"""The numbers ``correct`` compares, each against the limit its cell file
states (``bench/workloads/<cell>.json``'s ``limits``).

Norms are taken by the worst leaf: for each leaf the gap between the
program's norm and the reference's, over the larger of the reference's
norm of that leaf and the median leaf's (some updates are all but zero).
Leaves whose reference update is under a thousandth of the median leaf's
are rounding in the reference and are left out, by that rule and never by
name.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

Check = Tuple[str, float, float]        # (name, number, limit)


def leaf_norms(tree, prefix: str = "") -> Dict[str, float]:
    """``/``-joined leaf path → float64 2-norm, dict keys sorted, lists in
    order."""
    out: Dict[str, float] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(leaf_norms(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            out.update(leaf_norms(x, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = float(
            torch.linalg.vector_norm(tree.detach().double()))
    return out


def tree_diff(a, b):
    if isinstance(a, dict):
        return {k: tree_diff(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [tree_diff(x, y) for x, y in zip(a, b)]
    return a.detach().float() - b.detach().float()


def tree_scale(a, c: float):
    if isinstance(a, dict):
        return {k: tree_scale(v, c) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return [tree_scale(v, c) for v in a]
    return a * c


def counted(ref_first: Dict[str, float]) -> List[str]:
    """The leaves the reference moves beyond rounding: first update at
    least a thousandth of the median leaf's."""
    med = statistics.median(ref_first.values())
    return [k for k, v in ref_first.items() if v >= 1e-3 * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> Dict[str, float]:
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   leaves: List[str]) -> float:
    return max(leaf_gaps(prog, ref, leaves).values())


def max_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest gap over the largest reference value (over 1e-30 where
    the reference is all zero, so a nonzero answer fails and a zero one
    reads 0)."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def verdict(checks: List[Check]) -> bool:
    return all(v == v and v <= lim for _, v, lim in checks)


def limit_of(limits: Dict[str, float], name: str) -> float:
    if name not in limits:
        raise KeyError(f"the cell states no limit for {name!r}")
    return float(limits[name])


def compare(got: Dict[str, float], limits: Dict[str, float]
            ) -> List[Check]:
    """Each number the cell's ``limits`` name, beside its limit."""
    return [(n, got[n], limit_of(limits, n)) for n in limits]


def table(checks: List[Check]) -> Dict[str, Dict[str, float]]:
    return {n: {"value": v, "limit": lim} for n, v, lim in checks}
