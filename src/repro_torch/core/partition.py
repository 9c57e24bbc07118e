"""Per-layer codec partitions (port of ``repro.core.partition``,
DESIGN.md §10).

The paper trains one autoencoder per layer of the client model; this module
makes the mapping *leaf group → codec* first-class:

* :class:`PartitionMap` — the frozen structural half: named groups of model
  leaves, each group a tuple of ``(offset, size)`` slices into the
  :func:`~repro_torch.core.pytree.ravel` order of the model. Built once
  from a model template by :func:`identity_partition`,
  :func:`by_leaf_partition`, :func:`by_layer_partition` or
  :func:`by_role_partition` and shared by every client.
* :class:`PartitionSpec` — the map plus one frozen codec spec per group.
  Hashable, and a member of the ``codec.CodecSpec`` union:
  ``codec.encode/decode/decode_batched/decode_and_aggregate/wire_bytes``
  all dispatch on it.
* :func:`encode_tree` / :func:`decode_tree` — per-group gather → sub-codec
  encode; sub-codec decode → scatter.
* the server paths — :func:`server_decode_aggregate` buckets the cohort by
  each group's codec spec and issues one ``codec.decode_and_aggregate`` per
  (partition, spec) bucket (the sequential oracle), or, with the grouped
  flag, one round whose kernel-path chunked-AE buckets all share one
  grouped ragged launch per ``(hidden, chunk)`` signature
  (:func:`_grouped_round`, DESIGN.md §11.2).

Params for a partitioned spec are a dict ``{group_name: ae_params_or_None}``
(``PartitionedCompressor`` builds it), and payloads are
``{group_name: payload_dict}``, so they stack along a client axis like any
other payload.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import trace
from repro_torch.core import codec
from repro_torch.core.pytree import leaf_paths, leaves, stack

Tree = Any
Slices = Tuple[Tuple[int, int], ...]   # ((offset, size), ...) in ravel order


# =====================================================================
# structural half: named leaf groups as flat-vector slices
# =====================================================================
@dataclasses.dataclass(frozen=True)
class PartitionMap:
    """Frozen structural partition: ``groups[i] = (name, slices)``, the
    slices indexing the flat order of the model template. It carries no
    codec choice, so one map serves every rung of a per-partition ladder."""

    groups: Tuple[Tuple[str, Slices], ...]

    def __post_init__(self):
        names = [n for n, _ in self.groups]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate group names {names}")
        pos = 0
        for o, s in sorted((o, s) for _, sl in self.groups for o, s in sl):
            if s <= 0:
                raise ValueError("empty slice in partition map")
            if o != pos:
                raise ValueError(
                    f"partition slices must tile the flat vector: gap/"
                    f"overlap at offset {o} (expected {pos})")
            pos = o + s
        object.__setattr__(self, "_size", pos)

    @property
    def size(self) -> int:
        return self._size

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.groups)

    def group_size(self, name: str) -> int:
        return sum(s for _, s in self.slices_of(name))

    def slices_of(self, name: str) -> Slices:
        return dict(self.groups)[name]


def identity_partition(template: Tree, name: str = "all") -> PartitionMap:
    """One group covering every leaf in flat order: full-range gather and
    scatter, so its trajectories reproduce the flat path."""
    total = sum(s for _, _, s in leaf_paths(template))
    return PartitionMap(groups=((name, ((0, total),)),))


def by_leaf_partition(template: Tree) -> PartitionMap:
    """One group per model leaf, named by its ``/``-joined path."""
    return PartitionMap(groups=tuple(
        (name, ((off, size),)) for name, off, size in leaf_paths(template)))


def by_layer_partition(template: Tree,
                       key_fn: Optional[Callable[[str], str]] = None
                       ) -> PartitionMap:
    """Group leaves by ``key_fn`` of their path (default: the first path
    component, so ``dense0/w`` and ``dense0/b`` share the ``dense0``
    group). Groups keep first-seen order; a group's slices may be
    non-contiguous (its codec sees the concatenation)."""
    key_fn = key_fn or (lambda path: path.split("/")[0])
    grouped: Dict[str, List[Tuple[int, int]]] = {}
    for name, off, size in leaf_paths(template):
        grouped.setdefault(key_fn(name), []).append((off, size))
    return PartitionMap(groups=tuple(
        (k, tuple(v)) for k, v in grouped.items()))


# Transformer role taxonomy of the reference's model zoo: embeddings,
# attention/mixer projections, MLP/expert blocks and norm vectors. Checks
# run outermost component first.
_ROLE_NORM_KEYS = ("ln", "ln1", "ln2", "ln_x", "final_norm", "enc_norm")


def role_of_path(path: str) -> str:
    """A ``/``-joined path's architectural role: ``embedding`` |
    ``attention`` | ``mlp`` | ``norm``, or ``other``."""
    for comp in path.split("/"):
        if comp in ("embed", "lm_head", "pos_embed") or \
                comp.startswith("embed"):
            return "embedding"
        if comp in _ROLE_NORM_KEYS or "norm" in comp:
            return "norm"
        if "attn" in comp or comp == "mixer":
            return "attention"
        if comp in ("ffn", "mlp") or "expert" in comp or \
                "router" in comp or "moe" in comp:
            return "mlp"
    return "other"


def by_role_partition(template: Tree,
                      key_fn: Callable[[str], str] = role_of_path
                      ) -> PartitionMap:
    """:func:`by_layer_partition` keyed by :func:`role_of_path`."""
    return by_layer_partition(template, key_fn=key_fn)


# =====================================================================
# full spec: structure + one codec per group (a CodecSpec union member)
# =====================================================================
@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """A :class:`PartitionMap` with one frozen codec spec per group:
    ``groups[i] = (name, slices, codec_spec)``."""

    groups: Tuple[Tuple[str, Slices, Any], ...]

    def __post_init__(self):
        PartitionMap(groups=tuple((n, sl) for n, sl, _ in self.groups))
        for name, sl, spec in self.groups:
            gsize = sum(s for _, s in sl)
            if spec.size != gsize:
                raise ValueError(
                    f"group {name!r}: codec spec sized {spec.size} but the "
                    f"group's leaves total {gsize}")

    @property
    def size(self) -> int:
        return sum(s for _, sl, _ in self.groups for _, s in sl)

    @property
    def structure(self) -> Tuple[Tuple[str, Slices], ...]:
        """The codec-free structural half: what must agree across a cohort
        for the server path to aggregate it."""
        return tuple((n, sl) for n, sl, _ in self.groups)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _, _ in self.groups)

    def spec_of(self, name: str):
        return {n: sp for n, _, sp in self.groups}[name]


def make_partition_spec(pmap: PartitionMap, specs: Dict[str, Any]
                        ) -> PartitionSpec:
    """Bind one codec spec per group of ``pmap`` (keys must match)."""
    if set(specs) != set(pmap.names):
        raise ValueError(f"spec keys {sorted(specs)} != partition groups "
                         f"{sorted(pmap.names)}")
    return PartitionSpec(groups=tuple(
        (name, sl, specs[name]) for name, sl in pmap.groups))


# =====================================================================
# gather/scatter between the model-flat vector and group vectors
# =====================================================================
def gather(slices: Slices, flat: torch.Tensor) -> torch.Tensor:
    """Concatenate a group's slices out of the (possibly batched) flat
    vector; one full-range slice is the vector itself."""
    if len(slices) == 1:
        o, s = slices[0]
        return flat[..., o:o + s]
    return torch.cat([flat[..., o:o + s] for o, s in slices], dim=-1)


def scatter_groups(spec_structure: Sequence[Tuple[str, Slices]],
                   group_vecs: Dict[str, torch.Tensor], size: int,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of per-group :func:`gather`: place every group's
    ``(..., group_size)`` vector back into a ``(..., size)`` flat vector.
    Groups tile the vector, so every element is written exactly once."""
    first = next(iter(group_vecs.values()))
    out = torch.zeros(first.shape[:-1] + (size,), dtype=dtype,
                      device=first.device)
    for name, slices in spec_structure:
        vec = group_vecs[name]
        pos = 0
        for o, s in slices:
            out[..., o:o + s] = vec[..., pos:pos + s]
            pos += s
    return out


# =====================================================================
# per-partition encode/decode (the codec module dispatches here)
# =====================================================================
def _group_params(params: Optional[Dict[str, Tree]], name: str):
    return None if params is None else params.get(name)


def encode_tree(spec: PartitionSpec, params: Optional[Dict[str, Tree]],
                flat: torch.Tensor) -> Dict[str, codec.Payload]:
    """Collaborator side: gather each group and run its own codec →
    ``{group_name: payload}``."""
    return {name: codec.encode(cspec, _group_params(params, name),
                               gather(slices, flat))
            for name, slices, cspec in spec.groups}


def decode_tree(spec: PartitionSpec, params: Optional[Dict[str, Tree]],
                payloads: Dict[str, codec.Payload]) -> torch.Tensor:
    """Aggregator side: decode every group and scatter the results back
    into one ``(spec.size,)`` flat vector."""
    vecs = {name: codec.decode(cspec, _group_params(params, name),
                               payloads[name])
            for name, _, cspec in spec.groups}
    return scatter_groups(spec.structure, vecs, spec.size)


def decode_tree_batched(spec: PartitionSpec,
                        params: Optional[Dict[str, Tree]],
                        stacked: Dict[str, codec.Payload], *,
                        params_batched: bool = False) -> torch.Tensor:
    """Cohort-batched decode: per-group ``codec.decode_batched``, then a
    batched scatter → ``(C, spec.size)``."""
    vecs = {}
    for name, _, cspec in spec.groups:
        p = _group_params(params, name)
        vecs[name] = codec.decode_batched(
            cspec, p, stacked[name],
            # pointwise groups carry no params: keep their shared fast path
            params_batched=params_batched and p is not None)
    return scatter_groups(spec.structure, vecs, spec.size)


def wire_bytes_by_group(spec: PartitionSpec,
                        params: Optional[Dict[str, Tree]] = None
                        ) -> Dict[str, int]:
    """Per-partition uplink price list: ``codec.wire_bytes`` of each
    group's codec. Sums to ``codec.wire_bytes(spec, params)``."""
    return {name: codec.wire_bytes(cspec, _group_params(params, name))
            for name, _, cspec in spec.groups}


# =====================================================================
# server paths
# =====================================================================
def _bucket_params(plist: List[Optional[Tree]]) -> Tuple[Any, bool]:
    """Shared params (one object for the whole bucket) or a stacked
    per-client tree with ``params_batched``."""
    if all(p is plist[0] for p in plist):
        return plist[0], False
    return stack(plist), True


def _device_of(encoded: Sequence) -> torch.device:
    return leaves(encoded[0].payload)[0].device


def _group_buckets(encoded: Sequence, gi: int) -> Dict[Any, List[int]]:
    """Client indices per codec spec of partition group ``gi``, in
    first-seen order."""
    buckets: Dict[Any, List[int]] = {}
    for i, e in enumerate(encoded):
        buckets.setdefault(e.spec.groups[gi][2], []).append(i)
    return buckets


def server_decode_aggregate(encoded: Sequence, norm_weights: List[float],
                            base: Optional[torch.Tensor], *,
                            use_grouped_kernel: Optional[bool] = None
                            ) -> torch.Tensor:
    """Fused decode→aggregate for a partitioned cohort. ``encoded`` are the
    scheduler's ``EncodedUpdate``s whose ``spec`` is a
    :class:`PartitionSpec` of one shared structure; ``norm_weights`` sum
    to 1.

    Sequential (the default, and the differential oracle): for each group,
    bucket the cohort by that group's codec spec and call
    ``codec.decode_and_aggregate`` once per bucket. A single-bucket group
    reduces with the cohort weights directly; a multi-bucket group
    renormalizes each bucket to Σ=1 in host floats and scales its mean
    back by the bucket's weight mass ``s_g`` (DESIGN.md §9.2).

    ``use_grouped_kernel`` (resolved by ``ops.use_grouped_default``: off
    unless asked for) routes the round through :func:`_grouped_round`,
    where every kernel-path chunked-AE bucket joins one grouped ragged
    launch (``kernels.fused_decode_agg``'s
    ``grouped_fused_decode_agg_decoders``)."""
    spec0: PartitionSpec = encoded[0].spec
    structure = spec0.structure
    for e in encoded:
        if not (isinstance(e.spec, PartitionSpec)
                and e.spec.structure == structure):
            raise ValueError(
                "partitioned cohorts must share one partition structure "
                "(groups/slices); per-group codec specs may differ")
    from repro_torch.kernels.ops import use_grouped_default
    if use_grouped_default(use_grouped_kernel):
        groups_host = []
        for gi, (name, slices) in enumerate(structure):
            groups_host.append((name, slices, [
                (cspec, idx,
                 [encoded[i].payload[name] for i in idx],
                 [_group_params(encoded[i].params, name) for i in idx])
                for cspec, idx in _group_buckets(encoded, gi).items()]))
        return _grouped_server_round(groups_host, list(norm_weights), base,
                                     spec0.size, _device_of(encoded))
    dev = _device_of(encoded)
    norm_w = trace.to_device(norm_weights, dev, torch.float32)
    group_means: Dict[str, torch.Tensor] = {}
    for gi, (name, slices) in enumerate(structure):
        base_g = None if base is None else gather(slices, base)
        buckets = _group_buckets(encoded, gi)
        mean_g = None
        for cspec, idx in buckets.items():
            stacked = codec.stack_payloads(
                [encoded[i].payload[name] for i in idx])
            params, pb = _bucket_params(
                [_group_params(encoded[i].params, name) for i in idx])
            if len(buckets) == 1:
                mean_g = codec.decode_and_aggregate(
                    cspec, params, stacked, norm_w, base_g,
                    params_batched=pb)
                break
            s_g = sum(norm_weights[i] for i in idx)    # host float: stable
            w_g = trace.to_device([norm_weights[i] / s_g for i in idx],
                                  dev, torch.float32)
            part = codec.decode_and_aggregate(cspec, params, stacked, w_g,
                                              base_g, params_batched=pb)
            contrib = trace.to_device(s_g, dev, torch.float32) * part
            mean_g = contrib if mean_g is None else mean_g + contrib
        group_means[name] = mean_g
    return scatter_groups(structure, group_means, spec0.size)


def grouped_flat_server_aggregate(encoded: Sequence,
                                  norm_weights: List[float],
                                  base: Optional[torch.Tensor]
                                  ) -> torch.Tensor:
    """A flat (non-partitioned) mixed-spec cohort — e.g. rate-ladder rungs
    — as one pseudo-group over the whole vector, through the same grouped
    round as the partitioned path: the same per-bucket renormalization in
    host floats as the scheduler's sequential group-by-spec loop."""
    size = encoded[0].spec.size
    buckets: Dict[Any, List[int]] = {}
    for i, e in enumerate(encoded):
        buckets.setdefault(e.spec, []).append(i)
    groups_host = [("all", ((0, size),), [
        (cspec, idx,
         [encoded[i].payload for i in idx],
         [encoded[i].params for i in idx])
        for cspec, idx in buckets.items()])]
    return _grouped_server_round(groups_host, list(norm_weights), base,
                                 size, _device_of(encoded))


def _grouped_server_round(groups_host, norm_weights: List[float],
                          base: Optional[torch.Tensor], size: int,
                          dev: torch.device) -> torch.Tensor:
    """Host-side plan for :func:`_grouped_round`: per bucket its spec,
    params-batched flag, decoder slot and single-bucket flag, beside its
    stacked payloads, params, weights and weight mass.

    ``groups_host[g] = (name, slices, [(cspec, idx, payload_list,
    params_list), ...])``. A bucket joins the grouped launch when its spec
    is a kernel-path chunked AE and its clients share one params object;
    decoder slots key on the identity of the AE stage's params, in
    first-seen bucket order, so buckets sharing one decoder share one
    slot."""
    norm_w = trace.to_device(norm_weights, dev, torch.float32)
    plan, payloads, params_all, wlists, sgs = [], [], [], [], []
    dec_slots: Dict[int, int] = {}
    for name, slices, buckets in groups_host:
        single = len(buckets) == 1
        bplan, pays, prms, ws, sgl = [], [], [], [], []
        for cspec, idx, pay_list, prm_list in buckets:
            prm, pb = _bucket_params(prm_list)
            if single:
                w_b, s_g = norm_w, 1.0       # bit-stable homogeneous path
            else:
                s_g = sum(norm_weights[i] for i in idx)   # host float
                w_b = trace.to_device(
                    [norm_weights[i] / s_g for i in idx], dev, torch.float32)
            slot = None
            if codec.kernel_terminal_ae(cspec) is not None and not pb:
                slot = dec_slots.setdefault(
                    id(codec.ae_stage_params(cspec, prm)), len(dec_slots))
            bplan.append((cspec, pb, slot, single))
            pays.append(codec.stack_payloads(pay_list))
            prms.append(prm)
            ws.append(w_b)
            sgl.append(s_g)
        plan.append((name, slices, tuple(bplan)))
        payloads.append(pays)
        params_all.append(prms)
        wlists.append(ws)
        sgs.append(sgl)
    return _grouped_round(plan, size, payloads, params_all, wlists, sgs,
                          base)


@torch.no_grad()
def _grouped_round(plan, size: int, payloads, params, wlists, sgs,
                   base: Optional[torch.Tensor]) -> torch.Tensor:
    """The whole round. Pointwise and batched-params buckets call
    ``codec.decode_and_aggregate`` and are added as the loop meets them;
    kernel-path chunked-AE buckets compute their latent-side hidden
    activations and then share one grouped ragged launch per
    ``(hidden_width, chunk_size)`` signature, and are added after it, in
    job order. Decoders are deduped by slot and passed where they are
    held (the launch's tile table carries their addresses), not stacked."""
    from repro_torch.kernels.fused_decode_agg import (
        grouped_fused_decode_agg_decoders)

    group_means: Dict[str, torch.Tensor] = {}

    def _add(name, contrib):
        prev = group_means.get(name)
        group_means[name] = contrib if prev is None else prev + contrib

    def _scaled(s_g, x):
        return trace.to_device(s_g, x.device, torch.float32) * x

    jobs: Dict[Tuple[int, int], List[dict]] = {}
    for (name, slices, bplan), pays, prms, ws, sgl in zip(
            plan, payloads, params, wlists, sgs):
        base_g = None if base is None else gather(slices, base)
        for (cspec, pb, slot, single), pay, prm, w_b, s_g in zip(
                bplan, pays, prms, ws, sgl):
            if slot is not None:
                kspec = codec.kernel_terminal_ae(cspec)
                z, ae_prm = codec.kernel_chain_latents(cspec, prm, pay)
                h = codec.chunked_hidden(kspec, ae_prm, z)
                jobs.setdefault((h.shape[-1], kspec.cfg.chunk_size),
                                []).append(dict(
                    h=h, w=w_b, slot=slot, dec=ae_prm["dec"][-1],
                    norm=ae_prm["norm"], spec=cspec, sg=s_g, single=single,
                    base_g=base_g, name=name))
                continue
            mean_b = codec.decode_and_aggregate(cspec, prm, pay, w_b,
                                                base_g, params_batched=pb)
            _add(name, mean_b if single else _scaled(s_g, mean_b))
    for js in jobs.values():
        slots = sorted({j["slot"] for j in js})
        remap = {s: i for i, s in enumerate(slots)}
        by_slot = {}
        for j in js:
            by_slot.setdefault(j["slot"], j)
        outs = grouped_fused_decode_agg_decoders(
            [j["h"] for j in js], [j["w"] for j in js],
            [(by_slot[s]["dec"]["w"], by_slot[s]["dec"]["b"])
             for s in slots], [remap[j["slot"]] for j in js])
        for j, chunks in zip(js, outs):
            # Σw=1 per bucket ⇒ the weighted sum of normalized chunks
            # denorms like a single reconstruction (as in
            # codec._fused_chunked_decode_agg)
            norm = j["norm"]
            flat_b = (chunks * norm["std"] + norm["mean"]
                      ).reshape(-1)[:j["spec"].size]
            if j["base_g"] is not None:
                flat_b = flat_b - j["base_g"]
            _add(j["name"], flat_b if j["single"]
                 else _scaled(j["sg"], flat_b))
    structure = tuple((n, sl) for n, sl, _ in plan)
    return scatter_groups(structure, group_means, size)
