"""Codec protocol: static specs + pure encode/decode functions (port of
``repro.core.codec`` for the bare specs and per-layer partitions; chains,
composed, top-k, k-means and entropy are not ported yet).

A codec is a pair of functions driven by a frozen, hashable **spec** that
carries everything static (original length, bit widths, chunking, AE
shapes); payloads are dicts of fixed-shape tensors with no length metadata,
so the cohort's payloads stack along a client axis. Each spec registers a
small ops class (``fwd`` / ``inv`` / ``inv_batched`` / ``payload_shapes``)
in ``_STAGE_OPS`` (DESIGN.md §13.1).

The server entry point is :func:`decode_and_aggregate` (DESIGN.md §7): the
generic route decodes the stacked cohort in one batched pass and reduces
with an einsum over the client axis; the kernel-path chunked AE runs its
hidden decoder layers on the folded ``(C·n_chunks)`` batch and folds the
FedAvg weights into the final decoder product inside the fused
decode→aggregate kernel, so per-client decoded tensors never exist
(DESIGN.md §7.1).
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


# ``partition.PartitionSpec`` (one frozen sub-spec per named leaf group,
# DESIGN.md §10) is also a member of this union: every entry point below
# dispatches it to the per-group functions in core/partition.py (imported
# lazily — partition.py imports this module at top level).
CodecSpec = Union[IdentitySpec, QuantizeSpec, FCAESpec, ChunkedAESpec,
                  "PartitionSpec"]


def _partition_mod():
    from repro_torch.core import partition
    return partition


def is_partitioned(spec) -> bool:
    """True for a ``partition.PartitionSpec``: the scheduler routes those
    through the partitioned server path."""
    return isinstance(spec, _partition_mod().PartitionSpec)


def kernel_terminal_ae(spec: CodecSpec) -> Optional[ChunkedAESpec]:
    """The kernel-path chunked-AE stage when ``spec`` can take the fused
    decode→aggregate launch: a bare ``ChunkedAESpec(use_kernel=True)``.
    None otherwise. (The reference also accepts chains whose AE expansion
    is the last decode transform; those wait for the chain stages.)"""
    if isinstance(spec, ChunkedAESpec) and spec.use_kernel:
        return spec
    return None


def kernel_chain_latents(spec: CodecSpec, params: Optional[Params],
                         stacked: Payload) -> Tuple[torch.Tensor, Params]:
    """``(z, ae_params)`` feeding the fused kernel for a
    :func:`kernel_terminal_ae` spec: the stacked latents ``(C, n_chunks,
    latent)``. (A chain's pointwise suffix would be inverted here first;
    chains are not ported yet.)"""
    return stacked["z"], params


def ae_stage_params(spec: CodecSpec, params: Optional[Params]
                    ) -> Optional[Params]:
    """The AE stage's params inside ``spec`` — the object whose identity
    keys decoder slots in the grouped launch. For the bare specs that is
    ``params`` itself (a chain's would be its AE stage's entry)."""
    return params


# =====================================================================
# stage ops — one class per spec, registered in _STAGE_OPS
# =====================================================================
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


class _FCAEOps:
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


_STAGE_OPS = {
    IdentitySpec: _IdentityOps,
    QuantizeSpec: _QuantizeOps,
    FCAESpec: _FCAEOps,
    ChunkedAESpec: _ChunkedAEOps,
}


def stage_ops(spec):
    """The registered ops class for a spec."""
    try:
        return _STAGE_OPS[type(spec)]
    except KeyError:
        raise TypeError(f"unknown or unported codec spec "
                        f"{type(spec).__name__}") from None


# =====================================================================
# wire pricing
# =====================================================================
def wire_bytes(spec: CodecSpec, params: Optional[Params] = None) -> int:
    """Static uplink cost of one encoded payload for ``spec``, in bytes,
    from the payload's shapes and dtypes alone (nothing runs). Equal to
    ``tree_bytes`` of a real encode (tested for every ported spec); a
    partitioned spec sums its groups."""
    if is_partitioned(spec):
        return sum(_partition_mod().wire_bytes_by_group(spec,
                                                        params).values())
    if isinstance(spec, (FCAESpec, ChunkedAESpec)) and params is None:
        raise ValueError(
            f"wire_bytes({type(spec).__name__}(size={spec.size})): this "
            "spec encodes through an autoencoder, so pricing needs the AE "
            "parameter shapes — pass params (e.g. "
            "compressor.codec_params()) instead of None")
    total = 0
    for shape, dtype in stage_ops(spec).payload_shapes(spec, params).values():
        n = 1
        for d in shape:
            n *= d
        total += n * dtype.itemsize
    return int(total)


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
    return stage_ops(spec).fwd(spec, params, flat)


def decode(spec: CodecSpec, params: Optional[Params],
           payload: Payload) -> torch.Tensor:
    """Aggregator-side decoder → flat ``(spec.size,)`` vector."""
    if is_partitioned(spec):
        return _partition_mod().decode_tree(spec, params, payload)
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
        from repro_torch.core.pytree import tree_map
        C = next(iter(stacked.values())).shape[0]
        return torch.stack([
            decode(spec, tree_map(lambda x, i=i: x[i], params),
                   {k: v[i] for k, v in stacked.items()})
            for i in range(C)])
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
                         params_batched: bool = False) -> torch.Tensor:
    """Decode the stacked cohort payloads and FedAvg-reduce along the
    client axis → mean flat update ``(size,)``.

    ``weights`` must already be normalized (Σ=1; see
    ``aggregate.normalize_weights``). ``base`` (the flat global params
    under the weights-payload protocol) is subtracted after the reduction
    (Σw=1). Three routes:

    * partitioned homogeneous cohort: one fused reduction per group, each
      by the routes below, scattered back (mixed partitioned cohorts go
      through ``partition.server_decode_aggregate`` instead);
    * kernel-path chunked AE (``ChunkedAESpec(use_kernel=True)``, shared
      params): hidden decoder layers on the folded cohort, then the fused
      decode→aggregate kernel folds ``weights`` into the final decoder
      product (DESIGN.md §7.1);
    * everything else: batched decode + einsum over the client axis."""
    w = weights.float()
    if is_partitioned(spec):
        part = _partition_mod()
        means = {}
        for name, slices, cspec in spec.groups:
            p = None if params is None else params.get(name)
            base_g = None if base is None else part.gather(slices, base)
            means[name] = decode_and_aggregate(
                cspec, p, stacked[name], w, base_g,
                params_batched=params_batched and p is not None)
        return part.scatter_groups(spec.structure, means, spec.size)
    if not params_batched and kernel_terminal_ae(spec) is not None:
        mean = _fused_chunked_decode_agg(spec, params, stacked["z"], w)
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
                              weights: torch.Tensor) -> torch.Tensor:
    """Per-client work stays latent-sided (the hidden stack output
    ``(C, n_chunks, hidden)``); the chunk-wide expansion happens once,
    inside the weighted-accumulation kernel."""
    from repro_torch.kernels.fused_decode_agg import fused_decode_agg
    dec = params["dec"]
    h = chunked_hidden(spec, params, z)
    chunks = fused_decode_agg(h.contiguous(), weights.contiguous(),
                              dec[-1]["w"], dec[-1]["b"])
    norm = params["norm"]                             # (nc, chunk_size)
    chunks = chunks * norm["std"] + norm["mean"]      # Σw=1 ⇒ mean denorm
    return chunks.reshape(-1)[:spec.size]

