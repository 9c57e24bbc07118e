"""Tree checkpointing: flat-key npz with a dtype round trip, plus a
round-resumable federated-state wrapper (port of
``repro.checkpoint.checkpoint``).

The file layout is the reference's: one npz entry a leaf, keyed by the
leaf's path as JAX's ``tree_flatten_with_path`` spells it (dict keys
sorted, ``[i]`` for list and tuple entries, joined by ``/``), a
``__dtypes__`` JSON entry (bfloat16 leaves stored as a uint16 view) and a
``__meta__`` JSON entry. So a checkpoint saved by either package loads in
the other.
"""
from __future__ import annotations

import json
import os
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve

Tree = Any
_SEP = "/"


def _flatten_with_paths(tree: Tree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` in JAX's flat order (None holds no leaf)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, item in enumerate(tree):
            out += _flatten_with_paths(item, prefix + (f"[{i}]",))
        return out
    if tree is None:
        return []
    return [(_SEP.join(prefix), tree)]


def _rebuild(like: Tree, it) -> Tree:
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        items = [_rebuild(x, it) for x in like]
        return tuple(items) if isinstance(like, tuple) else items
    if like is None:
        return None
    return next(it)


def _dtype_name(dtype: torch.dtype) -> str:
    """The numpy spelling of a torch dtype ("float32", "bfloat16", ...)."""
    return str(dtype).replace("torch.", "")


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # bf16 has no numpy dtype: a uint16 view plus a dtype tag
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_pytree(path: str, tree: Tree, metadata: Optional[dict] = None
                ) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays, dtypes = {}, {}
    for k, v in _flatten_with_paths(tree):
        arrays[k], dtypes[k] = _to_numpy(v)
    arrays["__dtypes__"] = np.frombuffer(
        json.dumps(dtypes).encode(), dtype=np.uint8)
    if metadata is not None:
        arrays["__meta__"] = np.frombuffer(
            json.dumps(metadata).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_pytree(path: str, like: Tree, device: DeviceLike = None
                ) -> Tuple[Tree, Optional[dict]]:
    """Restore into the structure of ``like``: each leaf takes its ``like``
    leaf's dtype and goes to ``device`` (the ``like`` leaf's device when
    None)."""
    dev = None if device is None else resolve(device)
    with np.load(path) as data:
        dtypes = json.loads(bytes(data["__dtypes__"]).decode())
        meta = (json.loads(bytes(data["__meta__"]).decode())
                if "__meta__" in data else None)
        restored = []
        for key, leaf in _flatten_with_paths(like):
            arr = data[key]
            if dtypes[key] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            restored.append(t.to(device=dev if dev is not None
                                 else leaf.device, dtype=leaf.dtype))
        return _rebuild(like, iter(restored)), meta


def _reshare(like: Tree, got: Tree, memo: dict) -> Tree:
    """``got`` (restored into ``like``'s structure) with sharing put back:
    where one subtree object of ``like`` stands at several places (one AE
    params object that several clients' codecs hold) and the restored
    copies are equal, they become one object again, so the server's
    shared-params routes (one decoder for the bucket) take the same path
    after a load as before the save. Unequal copies stay apart."""
    if isinstance(like, dict):
        out = {k: _reshare(like[k], got[k], memo) for k in like}
    elif isinstance(like, (list, tuple)):
        out = type(like)(_reshare(a, b, memo) for a, b in zip(like, got))
    else:
        return got
    from repro_torch.core.pytree import leaves
    prev = memo.setdefault(id(like), out)
    if prev is not out and all(
            torch.equal(a, b) for a, b in zip(leaves(prev), leaves(out),
                                               strict=True)):
        return prev
    return out


def _like(shape, dtype: str) -> torch.Tensor:
    """A shape-and-dtype template that holds no memory."""
    return torch.empty(tuple(shape), dtype=getattr(torch, dtype),
                       device="meta")


def save_federated_state(path: str, round_idx: int, global_params: Tree,
                         clients: Optional[list] = None,
                         codec_params: Optional[list] = None,
                         ratecontrol: Optional[tuple] = None,
                         scheduler_state: Optional[dict] = None,
                         clients_soa: Optional[tuple] = None,
                         extra: Optional[dict] = None) -> None:
    """Checkpoint a federated run: global params, every ``ClientState``
    (error-feedback residuals, snapshot rings and lifecycle scalars, async
    ``dispatched`` snapshots), each client's codec params (a lifecycle
    refit moves them) and ``scheduler_state`` (``RoundScheduler.
    state_dict()``). ``ratecontrol`` is a rate controller's
    ``(state_meta(), state_tree())``: rung occupancy, switch rounds, fitted
    flags and cached distortions in the JSON metadata, every ladder rung's
    codec params in the ``ratecontrol`` section of the tree. Arrays go into
    the npz tree; what rebuilds them (which clients carry a residual, ring
    shapes, scalar fields) rides in the JSON metadata, key for key as the
    reference writes it. ``clients_soa`` is the struct-of-arrays
    alternative to ``clients`` (DESIGN.md §12.4): ``ClientPool.state()``'s
    ``(tree, meta)`` pair, whose ring contents, cursors, counts and residual
    block ride the ``clients_soa`` section as whole arrays. Pass at most one
    of the two."""
    if clients is not None and clients_soa is not None:
        raise ValueError("pass either the eager client list or the "
                         "struct-of-arrays pool state, not both")
    tree: dict = {"global": global_params}
    cmeta = None
    codec_meta = None
    rc_meta = None
    soa_meta = None
    if clients_soa is not None:
        soa_tree, soa_meta = clients_soa
        if soa_tree:
            tree["clients_soa"] = soa_tree
    if codec_params is not None:
        tree["codecs"] = [{"params": p} if p is not None else {}
                          for p in codec_params]
        codec_meta = [p is not None for p in codec_params]
    if ratecontrol is not None:
        rc_meta, tree["ratecontrol"] = ratecontrol
    if clients is not None:
        ctree, cmeta = [], []
        for st in clients:
            entry = {}
            if st.residual is not None:
                entry["residual"] = st.residual
            if st.snapshots:
                entry["snapshots"] = torch.stack(st.snapshots)
            if st.dispatched is not None:
                entry["dispatched"] = st.dispatched
            part_snaps = {name: snaps for name, snaps
                          in st.part_snapshots.items() if snaps}
            if part_snaps:
                entry["part_snapshots"] = {
                    name: torch.stack(snaps)
                    for name, snaps in part_snaps.items()}
            ctree.append(entry)
            cmeta.append({
                "has_residual": st.residual is not None,
                "has_dispatched": st.dispatched is not None,
                "snap_shape": [len(st.snapshots),
                               *(st.snapshots[0].shape
                                 if st.snapshots else [])],
                "snap_dtype": (_dtype_name(st.snapshots[0].dtype)
                               if st.snapshots else None),
                "version": st.version,
                "last_refresh": st.last_refresh,
                "ae_baseline": st.ae_baseline,
                "part_snap_shapes": {
                    name: [len(snaps), *snaps[0].shape]
                    for name, snaps in part_snaps.items()},
                "part_snap_dtypes": {
                    name: _dtype_name(snaps[0].dtype)
                    for name, snaps in part_snaps.items()},
                "part_last_refresh": dict(st.part_last_refresh),
                "part_baseline": dict(st.part_baseline),
            })
        tree["clients"] = ctree
    save_pytree(path, tree,
                metadata={"round": round_idx, "clients": cmeta,
                          "clients_soa": soa_meta,
                          "codecs": codec_meta, "ratecontrol": rc_meta,
                          "scheduler": scheduler_state, **(extra or {})})


def _peek_meta(path: str) -> dict:
    with np.load(path) as data:
        if "__meta__" not in data:
            return {}
        return json.loads(bytes(data["__meta__"]).decode())


def load_federated_state(path: str, like_params: Tree,
                         like_codec_params: Optional[list] = None,
                         like_ratecontrol: Optional[Tree] = None,
                         device: DeviceLike = None
                         ) -> Tuple[int, Tree, dict]:
    """Restore ``save_federated_state`` (either package's) onto ``device``
    (``like_params``' device when None). Returns (round, global params,
    meta): ``meta["client_states"]`` holds the rebuilt ``ClientState``
    list when client state was saved; ``meta["codec_params"]`` the
    restored per-client codec params when they were saved and
    ``like_codec_params`` gives their structures; ``meta["ratecontrol"]``
    the controller's JSON state and ``meta["ratecontrol_tree"]`` its ladder
    params when they were saved and ``like_ratecontrol`` (a freshly bound
    controller's ``state_tree()``) gives their structure;
    ``meta["scheduler"]`` the scheduler's ``state_dict()``. A
    struct-of-arrays checkpoint surfaces its restored tensors as
    ``meta["clients_soa_tree"]`` beside the JSON side in
    ``meta["clients_soa"]``; the caller rebuilds the pool with
    ``ClientPool.from_state``, which holds the model template.

    One deviation from the reference, whose load gives every client its
    own copy of the codec params: equal copies of one params object that
    several clients shared are one object again (:func:`_reshare`), so a
    resumed run's shared-AE buckets stay on the shared-decoder server
    route (the fused decode→aggregate; kernel 5 on the grouped round)
    where the reference's resume takes the batched-params route. The two
    routes agree in the golden band
    (``tests/test_torch_checkpoint.py::
    test_jax_checkpoint_resumes_shared_ae_on_shared_route``)."""
    from repro_torch.core.pytree import leaves
    dev = (resolve(device) if device is not None
           else leaves(like_params)[0].device)
    meta = _peek_meta(path)
    like: dict = {"global": like_params}
    soa_meta = meta.get("clients_soa")
    if soa_meta is not None:
        from repro_torch.core.soa import ClientPool
        soa_like = ClientPool.like_from_meta(soa_meta)
        if soa_like:
            like["clients_soa"] = soa_like
    codec_meta = meta.get("codecs")
    if codec_meta is not None and like_codec_params is not None:
        if len(codec_meta) != len(like_codec_params):
            raise ValueError(
                f"checkpoint holds {len(codec_meta)} clients' codecs, the "
                f"run has {len(like_codec_params)}")
        like["codecs"] = [
            {"params": lp} if has else {}
            for has, lp in zip(codec_meta, like_codec_params)]
    if meta.get("ratecontrol") is not None and like_ratecontrol is not None:
        like["ratecontrol"] = like_ratecontrol
    cmeta = meta.get("clients")
    if cmeta is not None:
        clike = []
        for cm in cmeta:
            entry = {}
            if cm["has_residual"]:
                entry["residual"] = like_params
            if cm.get("has_dispatched"):
                entry["dispatched"] = like_params
            if cm["snap_shape"][0]:
                entry["snapshots"] = _like(cm["snap_shape"],
                                           cm["snap_dtype"])
            if cm.get("part_snap_shapes"):
                entry["part_snapshots"] = {
                    name: _like(shape, cm["part_snap_dtypes"][name])
                    for name, shape in cm["part_snap_shapes"].items()}
            clike.append(entry)
        like["clients"] = clike
    tree, meta = load_pytree(path, like, dev)
    meta = dict(meta or {})
    if soa_meta is not None:
        meta["clients_soa_tree"] = tree.get("clients_soa") or {}
    memo: dict = {}
    if "codecs" in like:
        codecs = _reshare(like["codecs"], tree["codecs"], memo)
        meta["codec_params"] = [entry.get("params") for entry in codecs]
    if "ratecontrol" in like:
        meta["ratecontrol_tree"] = _reshare(like["ratecontrol"],
                                            tree["ratecontrol"], memo)
    if cmeta is not None:
        from repro_torch.core.scheduler import ClientState
        states = []
        for cm, entry in zip(cmeta, tree["clients"]):
            snaps = entry.get("snapshots")
            psnaps = entry.get("part_snapshots") or {}
            states.append(ClientState(
                residual=entry.get("residual"),
                version=int(cm["version"]),
                dispatched=entry.get("dispatched"),
                snapshots=([s for s in snaps] if snaps is not None else []),
                last_refresh=int(cm["last_refresh"]),
                ae_baseline=cm["ae_baseline"],
                part_snapshots={name: [s for s in stackd]
                                for name, stackd in psnaps.items()},
                part_last_refresh={
                    name: int(v) for name, v
                    in (cm.get("part_last_refresh") or {}).items()},
                part_baseline=dict(cm.get("part_baseline") or {})))
        meta["client_states"] = states
    return int(meta["round"]), tree["global"], meta
