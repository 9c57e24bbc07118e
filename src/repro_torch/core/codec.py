"""Codec protocol: static specs + pure encode/decode functions (port of
``repro.core.codec``: the Identity, Quantize, TopK, FCAE, ChunkedAE and
k-means stages, chains of them with an optional entropy-pricing stage,
``ComposedSpec``, per-layer partitions and the measured-bytes channel).

A codec is a pair of functions driven by a frozen, hashable **spec** that
carries everything static (original length, bit widths, chunking, AE
shapes); payloads are dicts of fixed-shape tensors with no length metadata,
so the cohort's payloads stack along a client axis. Each stage spec
registers a small ops class (``fwd`` / ``inv`` / ``inv_batched`` /
``carry_key`` / ``carry_shape`` / ``out_size`` / ``payload_shapes``) in
``_STAGE_OPS`` (DESIGN.md §13.1). :class:`ChainSpec` composes stages
left to right (sparsify → AE → quantize or k-means → entropy-priced
wire); :class:`ComposedSpec` is the 2-stage ``(AE, quantize)`` chain with
its historical flat payload keys.

The server entry point is :func:`decode_and_aggregate` (DESIGN.md §7): the
generic route decodes the stacked cohort in one batched pass and reduces
with an einsum over the client axis; kernel-terminal AE stacks (the
kernel-path chunked AE, bare or behind pointwise suffix stages) run the
hidden decoder layers on the folded ``(C·n_chunks)`` batch and fold the
FedAvg weights into the final decoder product inside the fused
decode→aggregate kernel, so per-client decoded tensors never exist
(DESIGN.md §7.1); top-k-prefixed chains reduce by one weighted
``index_add_`` over the shipped indices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.paper import AEConfig
from repro_torch.core import autoencoder as ae
from repro_torch.core.autoencoder import ChunkedAEConfig
from repro_torch.core.pytree import stack as stack_trees

Params = Any
Payload = Dict[str, torch.Tensor]


# =====================================================================
# specs — frozen, hashable
# =====================================================================
@dataclasses.dataclass(frozen=True)
class IdentitySpec:
    """No compression: the flat update crosses the wire as-is."""
    size: int


@dataclasses.dataclass(frozen=True)
class QuantizeSpec:
    """Blockwise absmax int8 / packed-int4 (FedPAQ-style baseline)."""
    size: int
    bits: int = 8
    block: int = 256


@dataclasses.dataclass(frozen=True)
class TopKSpec:
    """Top-k magnitudes (DGC/STC-style); ships (values, int32 indices).

    As a chain prefix the values vector (length ``k``) is the carry fed to
    the next stage, and only the int32 indices ship from this stage."""
    size: int
    k: int


@dataclasses.dataclass(frozen=True)
class FCAESpec:
    """Paper-faithful full FC AE; ``cfg.input_dim ≥ size`` (padded)."""
    size: int
    cfg: AEConfig


@dataclasses.dataclass(frozen=True)
class ChunkedAESpec:
    """Shared-chunk AE (DESIGN.md §3.2); ``use_kernel`` routes through the
    fused-dense and fused decode→aggregate kernels."""
    size: int
    cfg: ChunkedAEConfig
    use_kernel: bool = False

    @property
    def n_chunks(self) -> int:
        return -(-self.size // self.cfg.chunk_size)


@dataclasses.dataclass(frozen=True)
class KMeansSpec:
    """K-means codebook quantization (FedZip's clustered quantization).

    The codebook is fit at encode time (``iters`` Lloyd steps,
    quantile-seeded or warm-started from ``params["codebook"]``) and ships
    with the codes: the payload is ``{"codes", "codebook"}``, codes uint8
    for ``k ≤ 256``. Terminal-only: codes are not a vector the next stage
    could transform."""
    size: int
    k: int = 16
    iters: int = 8


@dataclasses.dataclass(frozen=True)
class EntropySpec:
    """Entropy-coded wire size, priced analytically (DESIGN.md §13.3).

    A pure pricing stage: encode ships nothing for it, but
    :func:`measured_bytes` prices every integer payload leaf of the chain
    at its empirical Shannon entropy plus ``table_bytes_per_symbol`` per
    distinct symbol. Only valid as the last stage of a chain; chains
    carrying it are not shape-static (:func:`is_shape_static`), so
    :func:`wire_bytes` keeps the dense price."""
    table_bytes_per_symbol: int = 4


@dataclasses.dataclass(frozen=True)
class ComposedSpec:
    """AE latents further quantized (§4.2 "orthogonal add-on"): the 2-stage
    chain ``ChainSpec((inner, QuantizeSpec(n_latent, bits, block)))`` that
    every entry point canonicalizes through :func:`composed_chain`, with the
    flat payload keys ``{"z_q", "z_scales"}`` and bare AE params."""
    inner: Union[FCAESpec, ChunkedAESpec]
    bits: int = 8
    block: int = 64

    @property
    def size(self) -> int:
        return self.inner.size


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Composable codec stack: ``stages`` applied left to right at encode.

    Every non-terminal vector stage must be *carrying* (its payload has a
    carry entry the next stage consumes, flattened 1-D); Quantize and
    k-means are terminal-only. ``EntropySpec`` may trail the vector stages
    as a pure pricing stage. Payload entries are namespaced ``{"s0": {...},
    "s1": {...}}`` (stages that ship nothing are omitted); params are a
    tuple with one entry per vector stage (None for stateless stages)."""
    stages: Tuple[Any, ...]

    def __post_init__(self):
        stages = tuple(self.stages)
        object.__setattr__(self, "stages", stages)
        if not stages:
            raise ValueError("ChainSpec needs at least one stage")
        for s in stages:
            if isinstance(s, (ChainSpec, ComposedSpec)):
                raise TypeError(
                    f"ChainSpec stages must be atomic, got {type(s).__name__}"
                    " (flatten nested chains; use composed_chain() for"
                    " ComposedSpec)")
            if not isinstance(s, EntropySpec):
                stage_ops(s)
        if isinstance(stages[0], EntropySpec):
            raise ValueError("EntropySpec cannot lead a chain")
        if any(isinstance(s, EntropySpec) for s in stages[:-1]):
            raise ValueError("EntropySpec only valid as the last stage")
        vs = self.vector_stages
        n_ae = sum(isinstance(s, (FCAESpec, ChunkedAESpec)) for s in vs)
        if n_ae > 1:
            raise ValueError("at most one AE stage per chain")
        for i, s in enumerate(vs[:-1]):
            ops = stage_ops(s)
            if ops.carry_key is None:
                raise ValueError(
                    f"{type(s).__name__} is terminal-only (no carry) and "
                    f"cannot precede {type(vs[i + 1]).__name__}")
            out = ops.out_size(s)
            if vs[i + 1].size != out:
                raise ValueError(
                    f"chain size mismatch: {type(s).__name__} emits {out} "
                    f"values but {type(vs[i + 1]).__name__} expects "
                    f"{vs[i + 1].size}")

    @property
    def size(self) -> int:
        return self.stages[0].size

    @property
    def vector_stages(self) -> Tuple[Any, ...]:
        """The stages that transform data (everything but EntropySpec)."""
        return tuple(s for s in self.stages
                     if not isinstance(s, EntropySpec))


# ``partition.PartitionSpec`` (one frozen sub-spec per named leaf group,
# DESIGN.md §10) is also a member of this union: every entry point below
# dispatches it to the per-group functions in core/partition.py (imported
# lazily — partition.py imports this module at top level).
CodecSpec = Union[IdentitySpec, QuantizeSpec, TopKSpec, FCAESpec,
                  ChunkedAESpec, KMeansSpec, ComposedSpec, ChainSpec,
                  "PartitionSpec"]


def _partition_mod():
    from repro_torch.core import partition
    return partition


def is_partitioned(spec) -> bool:
    """True for a ``partition.PartitionSpec``: the scheduler routes those
    through the partitioned server path."""
    return isinstance(spec, _partition_mod().PartitionSpec)


# =====================================================================
# stage ops — one class per stage spec, registered in _STAGE_OPS
# =====================================================================
#   carry_key      payload entry the next chain stage consumes, or None for
#                  terminal-only stages (quantize, k-means)
#   carry_shape    natural (unbatched) shape of that carry entry
#   out_size       flattened carry length == next stage's ``size``
#   fwd            (spec, params, flat) → payload dict
#   inv            (spec, params, payload) → flat (spec.size,)
#   inv_batched    (spec, params, stacked) → (C, spec.size), shared params
#   payload_shapes (spec, params) → {key: (shape, dtype)} of one payload
def _dequant_to(bits: int, block: int, n: int, q: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import ops
    return ops.dequantize_blocks(q, scales, bits=bits, block=block,
                                 orig_len=n)


class _IdentityOps:
    carry_key = "flat"

    @staticmethod
    def carry_shape(spec):
        return (spec.size,)

    @staticmethod
    def out_size(spec):
        return spec.size

    @staticmethod
    def fwd(spec, params, flat):
        return {"flat": flat}

    @staticmethod
    def inv(spec, params, payload):
        return payload["flat"]

    @staticmethod
    def inv_batched(spec, params, stacked):
        return stacked["flat"]

    @staticmethod
    def payload_shapes(spec, params):
        return {"flat": ((spec.size,), torch.float32)}


class _QuantizeOps:
    carry_key = None

    @staticmethod
    def carry_shape(spec):
        raise TypeError("QuantizeSpec is terminal-only")

    @staticmethod
    def out_size(spec):
        return None

    @staticmethod
    def fwd(spec, params, flat):
        from repro_torch.kernels import ops
        q, scales, _ = ops.quantize_blocks(flat, bits=spec.bits,
                                           block=spec.block)
        return {"q": q, "scales": scales}

    @staticmethod
    def inv(spec, params, payload):
        return _dequant_to(spec.bits, spec.block, spec.size,
                           payload["q"], payload["scales"])

    @staticmethod
    def inv_batched(spec, params, stacked):
        from repro_torch.kernels import ops
        from repro_torch.kernels.quantize import dequantize_blocks_2d
        q, scales = stacked["q"], stacked["scales"]
        C = scales.shape[0]
        if spec.bits == 4:
            q = ops.unpack_nibbles(q).reshape(C, -1, spec.block)
        nb = q.shape[1]
        # the cohort folded into one (C·nb, block) launch
        x = dequantize_blocks_2d(q.reshape(C * nb, spec.block).contiguous(),
                                 scales.reshape(C * nb).contiguous(),
                                 block=spec.block)
        return x.reshape(C, -1)[:, :spec.size]

    @staticmethod
    def payload_shapes(spec, params):
        nb = -(-spec.size // spec.block)
        if spec.bits == 4:
            q = ((nb * spec.block // 2,), torch.uint8)
        else:
            q = ((nb, spec.block), torch.int8)
        return {"q": q, "scales": ((nb,), torch.float32)}


class _TopKOps:
    carry_key = "values"

    @staticmethod
    def carry_shape(spec):
        return (spec.k,)

    @staticmethod
    def out_size(spec):
        return spec.k

    @staticmethod
    def fwd(spec, params, flat):
        # ``lax.top_k``'s order: descending |x|, ties to the lower index —
        # a stable descending sort keeps equal magnitudes in index order
        # (``torch.topk`` promises no tie order on CUDA)
        order = torch.sort(torch.abs(flat), descending=True, stable=True)[1]
        idx = order[:spec.k].to(torch.int32)
        return {"values": flat[order[:spec.k]], "indices": idx}

    @staticmethod
    def inv(spec, params, payload):
        vals = payload["values"]
        flat = torch.zeros((spec.size,), dtype=vals.dtype, device=vals.device)
        flat[payload["indices"].long()] = vals
        return flat

    @staticmethod
    def inv_batched(spec, params, stacked):
        vals, idx = stacked["values"], stacked["indices"]
        out = torch.zeros((vals.shape[0], spec.size), dtype=vals.dtype,
                          device=vals.device)
        return out.scatter_(1, idx.long(), vals)

    @staticmethod
    def payload_shapes(spec, params):
        return {"values": ((spec.k,), torch.float32),
                "indices": ((spec.k,), torch.int32)}


class _FCAEOps:
    carry_key = "z"

    @staticmethod
    def carry_shape(spec):
        return (spec.cfg.latent_dim,)

    @staticmethod
    def out_size(spec):
        return spec.cfg.latent_dim

    @staticmethod
    def fwd(spec, params, flat):
        pad = spec.cfg.input_dim - spec.size
        assert pad >= 0, (
            f"AE input_dim {spec.cfg.input_dim} < update size {spec.size}")
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        return {"z": ae.fc_encode(params, spec.cfg, flat)}

    @staticmethod
    def inv(spec, params, payload):
        return ae.fc_decode(params, spec.cfg, payload["z"])[:spec.size]

    @staticmethod
    def inv_batched(spec, params, stacked):
        # fc_decode is rank-polymorphic: (C, latent) → (C, input_dim)
        return ae.fc_decode(params, spec.cfg, stacked["z"])[:, :spec.size]

    @staticmethod
    def payload_shapes(spec, params):
        return {"z": ((spec.cfg.latent_dim,), params["enc"][-1]["w"].dtype)}


class _ChunkedAEOps:
    carry_key = "z"

    @staticmethod
    def carry_shape(spec):
        return (spec.n_chunks, spec.cfg.latent_chunk)

    @staticmethod
    def out_size(spec):
        return spec.n_chunks * spec.cfg.latent_chunk

    @staticmethod
    def fwd(spec, params, flat):
        if spec.use_kernel:
            from repro_torch.kernels import ops
            return {"z": ops.ae_encode(params, spec.cfg, flat)}
        return {"z": ae.chunked_encode(params, spec.cfg, flat)}

    @staticmethod
    def inv(spec, params, payload):
        if spec.use_kernel:
            from repro_torch.kernels import ops
            return ops.ae_decode(params, spec.cfg, payload["z"], spec.size)
        return ae.chunked_decode(params, spec.cfg, payload["z"], spec.size)

    @staticmethod
    def inv_batched(spec, params, stacked):
        z = stacked["z"]                       # (C, n_chunks, latent)
        C = z.shape[0]
        chunks = _chunked_dec_chunks(spec, params, z)
        return chunks.reshape(C, -1)[:, :spec.size]

    @staticmethod
    def payload_shapes(spec, params):
        return {"z": ((spec.n_chunks, spec.cfg.latent_chunk),
                      params["enc"][-1]["w"].dtype)}


def _quantile_linear(x: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(x, probs)`` (method "linear") in float32: position
    ``p·(n − 1)`` in the sorted vector, its floor and ceil blended by the
    fractional part. A sort, not ``torch.quantile``, which refuses inputs
    over 2^24 elements; a NaN anywhere makes every quantile NaN, as in the
    reference."""
    a = torch.sort(x)[0]
    a = torch.where(torch.isnan(x).any(), torch.full_like(a, float("nan")),
                    a)
    n = torch.tensor(float(x.numel()), dtype=torch.float32, device=x.device)
    q = probs * (n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1 - hw
    low = torch.clamp(low, min=0).minimum(n - 1).long()
    high = torch.clamp(high, min=0).minimum(n - 1).long()
    return a[low] * lw + a[high] * hw


def _nearest(x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """Index of each value's nearest centroid, ties to the lower index
    (``argmin``'s first minimum, as ``jnp.argmin``)."""
    return torch.argmin(torch.abs(x[:, None] - cb[None, :]), dim=1)


class _KMeansOps:
    carry_key = None

    @staticmethod
    def carry_shape(spec):
        raise TypeError("KMeansSpec is terminal-only")

    @staticmethod
    def out_size(spec):
        return None

    @staticmethod
    def fwd(spec, params, flat):
        x = flat.float()
        if params is not None and "codebook" in params:
            cb = params["codebook"].float()
        else:
            probs = (torch.arange(spec.k, dtype=torch.float32,
                                  device=x.device) + 0.5) / spec.k
            cb = _quantile_linear(x, probs)
        ks = torch.arange(spec.k, device=x.device)
        for _ in range(spec.iters):
            # cluster sums as a one-hot product: a fixed addition order on
            # every device (a scatter-add adds with atomics on CUDA)
            onehot = (_nearest(x, cb)[:, None] == ks[None, :]).float()
            sums = x @ onehot
            cnts = onehot.sum(0)
            # empty clusters keep their old centroid instead of going NaN
            cb = torch.where(cnts > 0, sums / torch.clamp_min(cnts, 1.0), cb)
        codes = _nearest(x, cb)
        dt = torch.uint8 if spec.k <= 256 else torch.int32
        return {"codes": codes.to(dt), "codebook": cb}

    @staticmethod
    def inv(spec, params, payload):
        return payload["codebook"][payload["codes"].long()]

    @staticmethod
    def inv_batched(spec, params, stacked):
        return torch.gather(stacked["codebook"], 1, stacked["codes"].long())

    @staticmethod
    def payload_shapes(spec, params):
        dt = torch.uint8 if spec.k <= 256 else torch.int32
        return {"codes": ((spec.size,), dt),
                "codebook": ((spec.k,), torch.float32)}


_STAGE_OPS = {
    IdentitySpec: _IdentityOps,
    QuantizeSpec: _QuantizeOps,
    TopKSpec: _TopKOps,
    FCAESpec: _FCAEOps,
    ChunkedAESpec: _ChunkedAEOps,
    KMeansSpec: _KMeansOps,
}


def stage_ops(spec):
    """The registered ops class for an atomic stage spec."""
    try:
        return _STAGE_OPS[type(spec)]
    except KeyError:
        raise TypeError(
            f"unknown codec stage {type(spec).__name__}") from None


def stage_out_size(spec) -> Optional[int]:
    """Flattened carry length a stage emits (next stage's ``size``), or
    None for terminal-only stages."""
    return stage_ops(spec).out_size(spec)


def stage_carry_shape(spec) -> Tuple[int, ...]:
    """Natural (unbatched) shape of a carrying stage's carry entry."""
    return stage_ops(spec).carry_shape(spec)


def latent_shape(spec: Union[FCAESpec, ChunkedAESpec]) -> Tuple[int, ...]:
    """Static shape of the AE latent payload entry ``z``."""
    if isinstance(spec, (FCAESpec, ChunkedAESpec)):
        return stage_carry_shape(spec)
    raise TypeError(f"no latent for {type(spec).__name__}")


# =====================================================================
# chain helpers
# =====================================================================
def composed_chain(spec: ComposedSpec) -> ChainSpec:
    """The 2-stage chain a ``ComposedSpec`` canonicalizes to."""
    n_latent = 1
    for d in latent_shape(spec.inner):
        n_latent *= d
    return ChainSpec((spec.inner,
                      QuantizeSpec(size=n_latent, bits=spec.bits,
                                   block=spec.block)))


def _composed_wrap_payload(payload: Payload) -> Payload:
    """Chain payload ``{"s1": {q, scales}}`` → the flat keys."""
    return {"z_q": payload["s1"]["q"], "z_scales": payload["s1"]["scales"]}


def _composed_unwrap_payload(payload: Payload) -> Payload:
    """The flat keys → chain payload of the canonical 2-stage chain."""
    return {"s1": {"q": payload["z_q"], "scales": payload["z_scales"]}}


def _chain_params(spec: ChainSpec, params: Optional[Params]
                  ) -> Tuple[Optional[Params], ...]:
    """Per-stage params tuple (None-filled when ``params is None``)."""
    n = len(spec.vector_stages)
    if params is None:
        return (None,) * n
    if not isinstance(params, tuple) or len(params) != n:
        raise ValueError(
            f"ChainSpec params must be a tuple of {n} per-stage entries "
            f"(None for stateless stages), got {type(params).__name__}")
    return params


def _chain_encode(spec: ChainSpec, params, flat: torch.Tensor) -> Payload:
    vs = spec.vector_stages
    ps = _chain_params(spec, params)
    out: Payload = {}
    x = flat
    last = len(vs) - 1
    for i, st in enumerate(vs):
        ops = stage_ops(st)
        pl = ops.fwd(st, ps[i], x)
        if i < last:
            carry = pl.pop(ops.carry_key)
            if pl:                     # side entries (e.g. top-k indices)
                out[f"s{i}"] = pl
            x = carry.reshape(-1)      # mid-chain carries travel flat
        else:
            out[f"s{i}"] = pl          # terminal stage ships its carry too
    return out


def _chain_decode(spec: ChainSpec, params, payload: Payload) -> torch.Tensor:
    vs = spec.vector_stages
    ps = _chain_params(spec, params)
    last = len(vs) - 1
    x = stage_ops(vs[last]).inv(vs[last], ps[last], payload[f"s{last}"])
    for i in range(last - 1, -1, -1):
        st = vs[i]
        ops = stage_ops(st)
        pl = dict(payload.get(f"s{i}", {}))
        pl[ops.carry_key] = x.reshape(ops.carry_shape(st))
        x = ops.inv(st, ps[i], pl)
    return x


def _chain_decode_batched(spec: ChainSpec, params, stacked: Payload, *,
                          upto: int = 0) -> torch.Tensor:
    """Backward fold of ``inv_batched`` down to (and excluding) stage
    ``upto``: ``upto=0`` is the full batched decode → ``(C, spec.size)``;
    ``upto=i`` stops with stage ``i``'s carry, ``(C, out_size(stage i))``
    — how the scatter and kernel aggregate routes peel pointwise
    suffixes."""
    vs = spec.vector_stages
    ps = _chain_params(spec, params)
    last = len(vs) - 1
    X = stage_ops(vs[last]).inv_batched(vs[last], ps[last],
                                        stacked[f"s{last}"])
    for i in range(last - 1, upto - 1, -1):
        st = vs[i]
        ops = stage_ops(st)
        C = X.shape[0]
        pl = dict(stacked.get(f"s{i}", {}))
        pl[ops.carry_key] = X.reshape((C,) + ops.carry_shape(st))
        X = ops.inv_batched(st, ps[i], pl)
    return X


def ae_spec(spec: CodecSpec) -> Optional[Union[FCAESpec, ChunkedAESpec]]:
    """The AE spec inside ``spec`` (unwrapping ``ComposedSpec`` and chain
    interiors), or None for pointwise stacks: how the AE lifecycle finds
    the shapes to build refit datasets with."""
    if isinstance(spec, ComposedSpec):
        return ae_spec(spec.inner)
    if isinstance(spec, ChainSpec):
        for st in spec.vector_stages:
            if isinstance(st, (FCAESpec, ChunkedAESpec)):
                return st
        return None
    if isinstance(spec, (FCAESpec, ChunkedAESpec)):
        return spec
    return None


def ae_stage_params(spec: CodecSpec, params: Optional[Params]
                    ) -> Optional[Params]:
    """The AE stage's params entry inside a (possibly chained) spec — the
    object whose identity keys decoder slots in the grouped launch."""
    if isinstance(spec, ChainSpec):
        for st, p in zip(spec.vector_stages, _chain_params(spec, params)):
            if isinstance(st, (FCAESpec, ChunkedAESpec)):
                return p
        return None
    return params


def ae_stage_input(spec: CodecSpec, params: Optional[Params],
                   flat: torch.Tensor) -> torch.Tensor:
    """Forward-fold ``flat`` through a chain's prefix stages up to its AE
    stage: the vector the AE actually encodes. Identity for non-chain
    specs."""
    if not isinstance(spec, ChainSpec):
        return flat
    ps = _chain_params(spec, params)
    x = flat
    for i, st in enumerate(spec.vector_stages):
        if isinstance(st, (FCAESpec, ChunkedAESpec)):
            return x
        ops = stage_ops(st)
        x = ops.fwd(st, ps[i], x)[ops.carry_key].reshape(-1)
    return x


def kernel_terminal_ae(spec: CodecSpec) -> Optional[ChunkedAESpec]:
    """The kernel-path chunked-AE stage when ``spec`` can take the fused
    decode→aggregate launch: a bare ``ChunkedAESpec(use_kernel=True)``, or
    a chain whose AE expansion is the *last* decode transform
    (identity-only prefix, quantize or k-means suffix). None otherwise —
    e.g.
    sparsified chains, whose final decode transform is a scatter."""
    if isinstance(spec, ChunkedAESpec) and spec.use_kernel:
        return spec
    if isinstance(spec, ChainSpec):
        vs = spec.vector_stages
        idx = [i for i, s in enumerate(vs)
               if isinstance(s, (FCAESpec, ChunkedAESpec))]
        if len(idx) != 1:
            return None
        i = idx[0]
        st = vs[i]
        if not (isinstance(st, ChunkedAESpec) and st.use_kernel):
            return None
        if any(not isinstance(s, IdentitySpec) for s in vs[:i]):
            return None
        if any(not isinstance(s, (QuantizeSpec, KMeansSpec))
               for s in vs[i + 1:]):
            return None
        return st
    return None


def kernel_chain_latents(spec: CodecSpec, params: Optional[Params],
                         stacked: Payload) -> Tuple[torch.Tensor, Params]:
    """``(z, ae_params)`` feeding the fused kernel for a
    :func:`kernel_terminal_ae` spec: the stacked latents ``(C, n_chunks,
    latent)`` after batched-inverting any pointwise suffix stages."""
    if isinstance(spec, ChunkedAESpec):
        return stacked["z"], params
    vs = spec.vector_stages
    ps = _chain_params(spec, params)
    i = next(j for j, s in enumerate(vs) if isinstance(s, ChunkedAESpec))
    if i == len(vs) - 1:
        return stacked[f"s{i}"]["z"], ps[i]
    Z = _chain_decode_batched(spec, params, stacked, upto=i + 1)
    return Z.reshape((Z.shape[0],) + stage_carry_shape(vs[i])), ps[i]


# =====================================================================
# wire pricing
# =====================================================================
def _require_priceable(spec: CodecSpec, params: Optional[Params]) -> None:
    """AE-bearing specs cannot be priced without their parameter shapes."""
    if isinstance(spec, ComposedSpec):
        _require_priceable(spec.inner, params)
    elif isinstance(spec, ChainSpec):
        for st, p in zip(spec.vector_stages, _chain_params(spec, params)):
            _require_priceable(st, p)
    elif isinstance(spec, (FCAESpec, ChunkedAESpec)) and params is None:
        raise ValueError(
            f"wire_bytes({type(spec).__name__}(size={spec.size})): this "
            "spec encodes through an autoencoder, so pricing needs the AE "
            "parameter shapes — pass params (e.g. "
            "compressor.codec_params()) instead of None")


def _payload_shapes(spec: CodecSpec, params: Optional[Params]
                    ) -> Dict[Any, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{key: (shape, dtype)}`` of every leaf one encode ships (chain keys
    are ``(stage, key)`` pairs)."""
    if isinstance(spec, ComposedSpec):
        q = _payload_shapes(composed_chain(spec), (params, None))
        return {"z_q": q[("s1", "q")], "z_scales": q[("s1", "scales")]}
    if isinstance(spec, ChainSpec):
        vs = spec.vector_stages
        out = {}
        for i, (st, p) in enumerate(zip(vs, _chain_params(spec, params))):
            ops = stage_ops(st)
            for key, sd in ops.payload_shapes(st, p).items():
                if i == len(vs) - 1 or key != ops.carry_key:
                    out[(f"s{i}", key)] = sd
        return out
    return stage_ops(spec).payload_shapes(spec, params)


def wire_bytes(spec: CodecSpec, params: Optional[Params] = None) -> int:
    """Static uplink cost of one encoded payload for ``spec``, in bytes,
    from the payload's shapes and dtypes alone (nothing runs). Equal to
    ``tree_bytes`` of a real encode (tested for every ported spec); a
    partitioned spec sums its groups."""
    if is_partitioned(spec):
        return sum(_partition_mod().wire_bytes_by_group(spec,
                                                        params).values())
    _require_priceable(spec, params)
    total = 0
    for shape, dtype in _payload_shapes(spec, params).values():
        n = 1
        for d in shape:
            n *= d
        total += n * dtype.itemsize
    return int(total)


def is_shape_static(spec: CodecSpec) -> bool:
    """True when every payload's real wire size is the :func:`wire_bytes`
    price, i.e. the spec carries no entropy-coded stage."""
    if is_partitioned(spec):
        return all(is_shape_static(c) for _, _, c in spec.groups)
    if isinstance(spec, ChainSpec):
        return not any(isinstance(s, EntropySpec) for s in spec.stages)
    return True


def measured_bytes(spec: CodecSpec, payload: Payload) -> float:
    """Measured wire size of one real payload, in bytes.

    For shape-static specs this is ``tree_bytes(payload)``. For chains
    ending in :class:`EntropySpec` every integer payload leaf (quantize
    codes, k-means codes, top-k indices) is priced at ``min(raw, n·H/8 +
    table_bytes_per_symbol·n_distinct)``, its empirical Shannon entropy
    plus the code table, with the raw size for incompressible leaves;
    float leaves ship uncoded. Symbols are counted on the payload's device
    (``torch.unique``); the entropy is taken on the host in float64 with
    the reference's numpy operations, leaves in the reference's order, so
    the bytes equal the reference's."""
    import numpy as np
    from repro_torch.core.pytree import leaves

    if is_partitioned(spec):
        return float(sum(measured_bytes(c, payload[n])
                         for n, _, c in spec.groups))
    entropy = None
    if isinstance(spec, ChainSpec) and isinstance(spec.stages[-1],
                                                  EntropySpec):
        entropy = spec.stages[-1]
    total = 0.0
    for leaf in leaves(payload):
        if leaf.numel() == 0:
            continue
        raw = leaf.numel() * leaf.element_size()
        if (entropy is not None and not leaf.is_floating_point()
                and not leaf.is_complex() and leaf.dtype != torch.bool):
            cnts = torch.unique(leaf, sorted=True,
                                return_counts=True)[1].cpu().numpy()
            p = cnts / leaf.numel()
            H = float(-(p * np.log2(p)).sum())
            coded = (leaf.numel() * H / 8.0
                     + cnts.size * entropy.table_bytes_per_symbol)
            total += min(raw, coded)
        else:
            total += raw
    return float(total)


# =====================================================================
# encode / decode
# =====================================================================
def encode(spec: CodecSpec, params: Optional[Params],
           flat: torch.Tensor) -> Payload:
    """Collaborator-side encoder. ``params`` is the AE parameter tree for
    the AE specs, ``{group: params_or_None}`` for a partitioned spec,
    ``None`` otherwise."""
    if is_partitioned(spec):
        return _partition_mod().encode_tree(spec, params, flat)
    if isinstance(spec, ComposedSpec):
        return _composed_wrap_payload(
            _chain_encode(composed_chain(spec), (params, None), flat))
    if isinstance(spec, ChainSpec):
        return _chain_encode(spec, params, flat)
    return stage_ops(spec).fwd(spec, params, flat)


def decode(spec: CodecSpec, params: Optional[Params],
           payload: Payload) -> torch.Tensor:
    """Aggregator-side decoder → flat ``(spec.size,)`` vector."""
    if is_partitioned(spec):
        return _partition_mod().decode_tree(spec, params, payload)
    if isinstance(spec, ComposedSpec):
        return _chain_decode(composed_chain(spec), (params, None),
                             _composed_unwrap_payload(payload))
    if isinstance(spec, ChainSpec):
        return _chain_decode(spec, params, payload)
    return stage_ops(spec).inv(spec, params, payload)


def stack_payloads(payloads) -> Payload:
    """Stack per-client payload dicts along a new leading client axis."""
    return stack_trees(list(payloads))


def decode_batched(spec: CodecSpec, params: Optional[Params],
                   stacked: Payload, *,
                   params_batched: bool = False) -> torch.Tensor:
    """Decode a whole cohort: stacked payload ``(C, ...)`` → ``(C, size)``.
    With ``params_batched`` each client has its own AE params (a leading
    client axis on every leaf) and clients decode one by one; otherwise the
    client axis folds into each kernel's batch dimension."""
    if is_partitioned(spec):
        return _partition_mod().decode_tree_batched(
            spec, params, stacked, params_batched=params_batched)
    if params_batched:
        from repro_torch.core.pytree import leaves, tree_map
        C = leaves(stacked)[0].shape[0]
        return torch.stack([
            decode(spec, tree_map(lambda x, i=i: x[i], params),
                   tree_map(lambda x, i=i: x[i], stacked))
            for i in range(C)])
    if isinstance(spec, ComposedSpec):
        return _chain_decode_batched(composed_chain(spec), (params, None),
                                     _composed_unwrap_payload(stacked))
    if isinstance(spec, ChainSpec):
        return _chain_decode_batched(spec, params, stacked)
    return stage_ops(spec).inv_batched(spec, params, stacked)


def _chunked_dec_chunks(spec: ChunkedAESpec, params: Params,
                        z: torch.Tensor) -> torch.Tensor:
    """(C, n_chunks, latent) → (C, n_chunks, chunk_size): the client axis
    is folded into the chunk batch, so the decode is one product chain
    whichever path (kernels or plain) runs."""
    C, nc, latent = z.shape
    z2 = z.reshape(C * nc, latent)
    n = C * nc * spec.cfg.chunk_size
    if spec.use_kernel:
        from repro_torch.kernels import ops
        flat = ops.ae_decode(params, spec.cfg, z2, n)
    else:
        flat = ae.chunked_decode(params, spec.cfg, z2, n)
    return flat.reshape(C, nc, spec.cfg.chunk_size)


# =====================================================================
# fused decode→aggregate: one call per round on the server
# =====================================================================
@torch.no_grad()
def decode_and_aggregate(spec: CodecSpec, params: Optional[Params],
                         stacked: Payload, weights: torch.Tensor,
                         base: Optional[torch.Tensor] = None, *,
                         params_batched: bool = False,
                         partial: bool = False) -> torch.Tensor:
    """Decode the stacked cohort payloads and FedAvg-reduce along the
    client axis → mean flat update ``(size,)``.

    ``weights`` must already be normalized (Σ=1; see
    ``aggregate.normalize_weights``). ``base`` (the flat global params
    under the weights-payload protocol) is subtracted after the reduction
    (Σw=1). ``partial=True`` takes a slice of a normalized cohort's
    weights (Σw ≤ 1, ``base`` is None) and returns that slice's weighted
    sum, the share :func:`decode_and_aggregate_sharded` all-reduces.
    Routes, in the reference's order:

    * partitioned homogeneous cohort: one fused reduction per group, each
      by the routes below, scattered back (mixed partitioned cohorts go
      through ``partition.server_decode_aggregate`` instead);
    A ``ComposedSpec`` is first canonicalized into its 2-stage chain, as
    every other entry point does, so a composed kernel-path chunked AE
    takes the kernel-terminal route. (The reference picks the route on the
    bare ``ComposedSpec`` and takes the generic route there; the two agree
    to float tolerance.)

    * scatter-terminal chains (a top-k prefix and at least one more stage,
      shared params): batched-invert the suffix down to the top-k values
      ``(C, k)`` and reduce by weighted ``index_add_`` over the shipped
      indices — dense per-client rows are never built. One ``index_add_``
      a client, clients in order: a client's k indices are distinct, so no
      two adds of one call meet at an address, and every element sums its
      clients in client order on any device (one call over the whole
      cohort would add with atomics on CUDA, in no fixed order);
    * kernel-terminal AE stacks (:func:`kernel_terminal_ae`, shared
      params): hidden decoder layers on the folded cohort, then the fused
      decode→aggregate kernel folds ``weights`` into the final decoder
      product (DESIGN.md §7.1);
    * everything else: batched decode + einsum over the client axis."""
    w = weights.float()
    if partial and base is not None:
        raise ValueError("a partial sum takes no base")
    if is_partitioned(spec):
        part = _partition_mod()
        means = {}
        for name, slices, cspec in spec.groups:
            p = None if params is None else params.get(name)
            base_g = None if base is None else part.gather(slices, base)
            means[name] = decode_and_aggregate(
                cspec, p, stacked[name], w, base_g,
                params_batched=params_batched and p is not None,
                partial=partial)
        return part.scatter_groups(spec.structure, means, spec.size)
    if isinstance(spec, ComposedSpec):
        return decode_and_aggregate(
            composed_chain(spec), (params, None),
            _composed_unwrap_payload(stacked), w, base,
            params_batched=params_batched, partial=partial)
    if not params_batched:
        if (isinstance(spec, ChainSpec)
                and isinstance(spec.vector_stages[0], TopKSpec)
                and len(spec.vector_stages) > 1):
            vals = _chain_decode_batched(spec, params, stacked, upto=1)
            idx = stacked["s0"]["indices"]              # (C, k)
            wv = vals.float() * w[:, None]
            out = torch.zeros((spec.size,), dtype=torch.float32,
                              device=wv.device)
            for c in range(wv.shape[0]):
                out.index_add_(0, idx[c].long(), wv[c])
            return out if base is None else out - base  # Σw=1
        kspec = kernel_terminal_ae(spec)
        if kspec is not None:
            z, ae_prm = kernel_chain_latents(spec, params, stacked)
            mean = _fused_chunked_decode_agg(kspec, ae_prm, z, w,
                                             w.sum() if partial else None)
            return mean if base is None else mean - base
    rows = decode_batched(spec, params, stacked,
                          params_batched=params_batched)
    if base is not None:
        rows = rows - base[None, :]
    return torch.einsum("c,cp->p", w, rows.float())


def chunked_hidden(spec: ChunkedAESpec, params: Params,
                   z: torch.Tensor) -> torch.Tensor:
    """Kernel-path hidden decoder stack: ``(C, n_chunks, latent)`` →
    ``(C, n_chunks, K)`` penultimate activations, all latent-sided."""
    from repro_torch.kernels.fused_dense import fused_dense
    C, nc, latent = z.shape
    x = z.reshape(C * nc, latent)
    for layer in params["dec"][:-1]:           # hidden stack, act throughout
        x = fused_dense(x.contiguous(), layer["w"], layer["b"],
                        act=spec.cfg.activation)
    return x.reshape(C, nc, x.shape[-1])


def _fused_chunked_decode_agg(spec: ChunkedAESpec, params: Params,
                              z: torch.Tensor,
                              weights: torch.Tensor,
                              weight_sum: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Per-client work stays latent-sided (the hidden stack output
    ``(C, n_chunks, hidden)``); the chunk-wide expansion happens once,
    inside the weighted-accumulation kernel. The denorm's mean term is
    taken ``weight_sum`` times (``None``: once, Σw=1)."""
    from repro_torch.kernels.fused_decode_agg import fused_decode_agg
    dec = params["dec"]
    h = chunked_hidden(spec, params, z)
    chunks = fused_decode_agg(h.contiguous(), weights.contiguous(),
                              dec[-1]["w"], dec[-1]["b"])
    norm = params["norm"]                             # (nc, chunk_size)
    mean = norm["mean"] if weight_sum is None else weight_sum * norm["mean"]
    chunks = chunks * norm["std"] + mean              # Σw=1 ⇒ mean denorm
    return chunks.reshape(-1)[:spec.size]



# =====================================================================
# the client axis split across ranks (DESIGN.md §7.2)
# =====================================================================
@torch.no_grad()
def decode_and_aggregate_sharded(spec: CodecSpec, params: Optional[Params],
                                 stacked: Payload, weights: torch.Tensor,
                                 base: Optional[torch.Tensor] = None,
                                 group=None) -> torch.Tensor:
    """Large-cohort variant (the reference's ``shard_map`` over a 1-D
    ``clients`` mesh): the cohort is zero-weight padded to a multiple of
    the size of ``group`` (``None``: the initialised world group); each
    rank reduces its contiguous slice by :func:`decode_and_aggregate`'s
    routes to a weighted sum (``partial=True``: weights are globally
    pre-normalized, so no renormalization is needed; codec params are the
    same on every rank), and one ``all_reduce(SUM)`` makes the cohort mean
    on every rank. Every rank passes the whole stacked cohort. Zero
    payloads decode to finite values for every codec, so padded rows add
    exactly 0. ``base`` is subtracted after the reduction."""
    from repro_torch.core import collectives
    from repro_torch.core.pytree import tree_map
    n = collectives.group_size(group)
    rank = collectives.group_rank(group)
    C = weights.shape[0]
    pad = (-C) % n
    if pad:
        stacked = tree_map(lambda x: torch.nn.functional.pad(
            x, (0, 0) * (x.dim() - 1) + (0, pad)), stacked)
        weights = torch.nn.functional.pad(weights, (0, pad))
    per = (C + pad) // n
    sl = slice(rank * per, (rank + 1) * per)
    mean = decode_and_aggregate(spec, params,
                                tree_map(lambda x: x[sl], stacked),
                                weights[sl], partial=True).contiguous()
    collectives.all_reduce_sum(mean, group)
    return mean if base is None else mean - base
