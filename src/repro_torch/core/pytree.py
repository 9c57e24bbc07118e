"""Parameter trees as nested dicts/lists of tensors, in JAX's flat order.

No JAX counterpart: the reference gets this from ``jax.tree_util`` and
``jax.flatten_util.ravel_pytree``. The order is the same — dict keys
sorted, lists and tuples in order — so ``dense0.b`` comes before
``dense0.w`` and AE params run ``dec``, ``enc``, ``norm``. Chunking,
quantize blocks and byte accounting all index into that flat order, so a
flat update vector is the same vector in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve

Tree = Any
TreeDef = Tuple[Any, ...]


def flatten(tree: Tree) -> Tuple[List[torch.Tensor], TreeDef]:
    """Leaves in JAX order plus the structure :func:`unflatten` rebuilds."""
    if isinstance(tree, dict):
        leaves: List[torch.Tensor] = []
        defs = []
        for k in sorted(tree):
            sub, d = flatten(tree[k])
            leaves += sub
            defs.append((k, d))
        return leaves, ("dict", tuple(defs))
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for item in tree:
            sub, d = flatten(item)
            leaves += sub
            defs.append(d)
        return leaves, (type(tree).__name__, tuple(defs))
    if tree is None:
        return [], ("none",)
    return [tree], ("leaf",)


def unflatten(treedef: TreeDef, leaves: List[Any]) -> Tree:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def _build(treedef: TreeDef, it) -> Tree:
    kind = treedef[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(d, it) for k, d in treedef[1]}
    items = [_build(d, it) for d in treedef[1]]
    return tuple(items) if kind == "tuple" else items


def leaves(tree: Tree) -> List[torch.Tensor]:
    return flatten(tree)[0]


def leaf_paths(tree: Tree) -> List[Tuple[str, int, int]]:
    """``(path, offset, size)`` per leaf in :func:`ravel` order, the path
    ``/``-joined from dict keys and list indices (``"dense0/b"``) — the
    counterpart of the reference's ``tree_flatten_with_path`` segments
    that partition maps are built from."""
    out: List[Tuple[str, int, int]] = []

    def walk(node: Tree, prefix: Tuple[str, ...]) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, item in enumerate(node):
                walk(item, prefix + (str(i),))
        elif node is not None:
            pos = out[-1][1] + out[-1][2] if out else 0
            out.append(("/".join(prefix), pos, int(node.numel())))
    walk(tree, ())
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    lv, td = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return unflatten(td, [fn(*xs) for xs in zip(lv, *others)])


def ravel(tree: Tree) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Tree]]:
    """``ravel_pytree``: one flat vector (leaves concatenated in JAX order)
    and the function that cuts a flat vector back into the tree."""
    lv, td = flatten(tree)
    shapes = [x.shape for x in lv]
    sizes = [x.numel() for x in lv]
    flat = torch.cat([x.reshape(-1) for x in lv])

    def unravel(vec: torch.Tensor) -> Tree:
        parts = torch.split(vec, sizes)
        return unflatten(td, [p.reshape(s) for p, s in zip(parts, shapes)])
    return flat, unravel


def stack(trees: List[Tree]) -> Tree:
    """Trees of equal structure → one tree with a leading axis per leaf."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def value_and_grad(fn: Callable, params: Tree, *args
                   ) -> Tuple[torch.Tensor, Any, Tree]:
    """``jax.value_and_grad(fn, has_aux=True)`` over a tensor tree:
    ``fn(params, *args) -> (loss, aux)`` → ``(loss, aux, grads)``."""
    lv, td = flatten(params)
    lv = [x.detach().requires_grad_(True) for x in lv]
    loss, aux = fn(unflatten(td, lv), *args)
    grads = torch.autograd.grad(loss, lv)
    if aux is not None:
        aux = tree_map(lambda x: x.detach(), aux)
    return loss.detach(), aux, unflatten(td, list(grads))


def from_jax_params(tree: Tree, device: DeviceLike = None) -> Tree:
    """Carry the JAX package's parameters (as numpy arrays, e.g. from
    ``jax.tree_util.tree_map(np.asarray, params)``) across into the port's
    tree: same keys, same layouts, same dtypes, on ``device``."""
    dev = resolve(device)
    lv, td = flatten(tree)
    return unflatten(td, [torch.as_tensor(np.array(x)).to(dev) for x in lv])

