"""Sharding rules (port of ``repro.models.sharding``): per-dim partition
specs for the parameter, batch and cache trees.

The rules are the reference's, name-based over the tree and
divisibility-guarded: a dim is sharded over the ``model`` axis only when
its size divides evenly; optimizer state can also be sharded over the
``data`` axis (ZeRO-1, :func:`zero1_spec`). A spec is a tuple with one
entry a dim — an axis name, a tuple of axis names or None — the entries
of the reference's ``PartitionSpec``.

A mesh is a ``{axis: size}`` dict or a
``torch.distributed.device_mesh.DeviceMesh`` (read through its
``mesh_dim_names`` and sizes), so a 2 x 16 x 16 production mesh can be
reasoned about without 512 processes, as the reference's ``AbstractMesh``
allows. :func:`named` turns specs into ``DTensor`` placements for
``distribute_tensor``, which needs a real ``DeviceMesh``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

Spec = Tuple[Any, ...]
MeshLike = Any

# weights sharded on their output (last) dim over `model`
_OUT_SHARDED = {
    "wq", "wk", "wv", "w_uq", "w_dkv", "w_gate", "w_up", "w_in",
    "w_x", "w_a", "w_i", "w_dq",
}
# weights sharded on their input (second-to-last) dim over `model`
_IN_SHARDED = {"wo", "w_down", "w_out"}
# MLA up-projections (rank, H, head_dim): shard the latent rank
_RANK_SHARDED = {"w_uk", "w_uv"}
_REPLICATED = {"router", "b_a", "b_i", "lambda", "A_log", "dt_bias", "D",
               "scale", "bias", "conv_b", "dt_bias", "b_up", "b_down"}


def mesh_shape(mesh: MeshLike) -> Dict[str, int]:
    """``{axis: size}`` of a dict or a ``DeviceMesh``."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("sharding: the DeviceMesh needs mesh_dim_names")
    return dict(zip(names, tuple(mesh.mesh.shape)))


def map_with_path(fn: Callable, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; the path
    holds dict keys as strings and sequence indices as ``"[i]"``, as
    ``repro.models.sharding._path_names`` spells them."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_with_path(fn, v, path + (f"[{i}]",))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    if tree is None:
        return None
    return fn(path, tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def _spec_for(names: Tuple[str, ...], shape: Tuple[int, ...],
              mesh: Dict[str, int]) -> Spec:
    name = names[-1]
    nd = len(shape)
    spec: list = [None] * nd

    def shard(dim: int):
        if shape[dim] % mesh["model"] == 0:
            spec[dim] = "model"

    if name in _REPLICATED or nd == 0 or nd == 1:
        pass
    elif name == "embed":
        shard(0)                                   # (V, D) vocab-sharded
    elif name == "lm_head":
        shard(nd - 1)                              # (D, V)
    elif name in _RANK_SHARDED:
        if nd >= 3:
            shard(nd - 3)
    elif name == "conv_w":
        shard(nd - 1)                              # (W, C) channel-sharded
    elif name in ("w_gate", "w_up", "w_down") and nd >= 4:
        shard(nd - 3)                              # stacked MoE experts
    elif name in _OUT_SHARDED:
        shard(nd - 1)
    elif name in _IN_SHARDED:
        shard(nd - 2)
    return tuple(spec)


def param_specs(param_shapes: Any, mesh: MeshLike) -> Any:
    """Spec tree matching a parameter (shape) tree."""
    m = mesh_shape(mesh)
    return map_with_path(lambda path, leaf: _spec_for(path, _shape(leaf), m),
                         param_shapes)


def batch_axes(mesh: MeshLike) -> Tuple[str, ...]:
    m = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in m)


def data_spec(mesh: MeshLike, global_batch: int, ndim: int) -> Spec:
    """Shard the leading batch dim over (pod, data) when divisible."""
    m = mesh_shape(mesh)
    axes = batch_axes(m)
    total = 1
    for a in axes:
        total *= m[a]
    if global_batch % total != 0:
        return (None,) * ndim
    # one axis stands bare, as PartitionSpec normalizes ('data',)
    return (axes[0] if len(axes) == 1 else axes,) + (None,) * (ndim - 1)


def batch_specs(batch_shapes: Any, mesh: MeshLike) -> Any:
    def spec(path, leaf):
        shape = _shape(leaf)
        return data_spec(mesh, shape[0] if shape else 1, len(shape))
    return map_with_path(spec, batch_shapes)


def cache_specs(cache_shapes: Any, mesh: MeshLike) -> Any:
    """Decode caches: leaves are (L, B, ...) stacked per layer (batch dim 1)
    or scalars (``index``)."""
    def spec(names, leaf):
        shape = _shape(leaf)
        if len(shape) == 0 or names[-1] == "index":
            return ()
        batch_dim = 1 if names[0] in ("layers", "tail") else 0
        if len(shape) <= batch_dim:
            return (None,) * len(shape)
        inner = data_spec(mesh, shape[batch_dim], len(shape) - batch_dim)
        return (None,) * batch_dim + inner
    return map_with_path(spec, cache_shapes)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def map_specs(fn: Callable, spec_tree: Any, *rest: Any) -> Any:
    """``fn(spec, *leaves)`` over a spec tree (specs are the leaves) and
    trees of the same structure."""
    if _is_spec(spec_tree):
        return fn(spec_tree, *rest)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(map_specs(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(spec_tree))
    return spec_tree


def fully_shard(spec_tree: Any, shape_tree: Any, mesh: MeshLike,
                min_size: int = 1 << 20) -> Any:
    """Inference-mode 2D weight sharding: additionally shard one unsharded
    dim of every large leaf over the ``data`` axis (serving has no
    gradient sync, so the data axis is free capacity)."""
    def upd(spec, shp):
        if any(d for d in spec if d is not None):
            size = 1
            for d in _shape(shp):
                size *= d
            if size >= min_size:
                return zero1_spec(spec, _shape(shp), mesh)
        return spec
    return map_specs(upd, spec_tree, shape_tree)


def zero1_spec(spec: Spec, shape: Tuple[int, ...], mesh: MeshLike) -> Spec:
    """Add ``data``-axis sharding to one unsharded dim (optimizer
    moments)."""
    m = mesh_shape(mesh)
    if "data" not in m:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (p, n) in enumerate(zip(parts, shape)):
        if p is None and n % m["data"] == 0 and n > 1:
            parts[i] = "data"
            return tuple(parts)
    return spec


def spec_shards(spec: Spec, mesh: MeshLike) -> int:
    """How many pieces a spec cuts a leaf into on ``mesh``."""
    m = mesh_shape(mesh)
    total = 1
    for entry in spec:
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            total *= m[a]
    return total


def placements(mesh, spec: Spec) -> list:
    """``DTensor`` placements for ``spec`` on a ``DeviceMesh``: per mesh
    dim, ``Shard(d)`` for the tensor dim whose entry names it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dim = next((d for d, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def named(mesh, spec_tree: Any) -> Any:
    """Placement lists, one a spec, for ``distribute_tensor``."""
    return map_specs(lambda s: placements(mesh, s), spec_tree)


def distribute(mesh, tree: Any, spec_tree: Any) -> Any:
    """``distribute_tensor`` every leaf of ``tree`` by its spec."""
    from torch.distributed.tensor import distribute_tensor
    return map_specs(lambda s, t: distribute_tensor(
        t, mesh, placements(mesh, s)) if isinstance(t, torch.Tensor) else t,
        spec_tree, tree)
