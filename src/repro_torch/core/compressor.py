"""Weight-update compressors: the collaborator→aggregator codec API (port of
``repro.core.compressor``: Identity, Quantize, TopK, KMeans, FCAE,
ChunkedAE, Composed, Chain (optionally entropy-priced) and Partitioned).

Each compressor is a thin host-side adapter over ``core/codec.py``: a
static ``spec(n)`` plus its AE params; the math is ``codec.encode`` /
``codec.decode`` on the update flattened in JAX order (``core/pytree.py``).
Payload dtypes are the reference's (int8 ``q``, float32 scales, uint8
nibbles), and :func:`tree_bytes` prices them by dtype, so byte totals are
identical in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.paper import AEConfig
from repro_torch.core import autoencoder as ae
from repro_torch.core import codec
from repro_torch.core.pytree import leaves, ravel, tree_map

Tree = Any


def tree_bytes(tree: Tree) -> int:
    """Wire size of a payload tree: the sum of its leaves' bytes."""
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def codec_stats(flat: torch.Tensor, payload: Tree,
                spec: Optional[codec.CodecSpec] = None) -> Dict[str, float]:
    """The Eq.-4 byte accounting for one encoded update, in the reference's
    keys. With ``spec`` the measured-bytes channel (DESIGN.md §13.3) is the
    entropy-coded price for ``EntropySpec``-terminated chains; otherwise it
    equals the compressed bytes."""
    stats = {
        "original_bytes": float(flat.numel() * flat.element_size()),
        "compressed_bytes": float(tree_bytes(payload)),
    }
    stats["compression_ratio"] = (
        stats["original_bytes"] / max(stats["compressed_bytes"], 1.0))
    stats["measured_bytes"] = stats["compressed_bytes"]
    if spec is not None and not codec.is_shape_static(spec):
        stats["measured_bytes"] = float(codec.measured_bytes(spec, payload))
    return stats


# ---------------------------------------------------------------------------
# Error feedback (DGC/EF-SGD style): the residual is per-client state owned
# by the scheduler's ClientState (DESIGN.md §6.3).
# ---------------------------------------------------------------------------
def ef_compensate(payload: Tree, residual: Optional[Tree]) -> Tree:
    """Fold the previous round's reconstruction residual into this payload."""
    if residual is None:
        return payload
    return tree_map(lambda u, res: u + res, payload, residual)


def ef_residual(payload: Tree, decoded: Tree) -> Tree:
    """What the codec lost this round: kept locally, re-sent next round."""
    return tree_map(lambda u, d: u - d, payload, decoded)


class Compressor:
    """Base codec adapter over update trees: subclasses give :meth:`spec`
    and optionally :meth:`codec_params`."""

    def spec(self, n: int) -> codec.CodecSpec:
        raise NotImplementedError

    def codec_params(self) -> Optional[Any]:
        """AE parameter tree for the AE codecs; None for pointwise ones."""
        return None

    def ae_compressor(self) -> Optional["Compressor"]:
        """The AE-backed compressor inside this adapter: ``self`` for the
        AE codecs, None for the pointwise ones and for
        :class:`PartitionedCompressor` (which may hold several)."""
        return None

    def set_codec_params(self, restored: Any) -> None:
        """Restore codec params into this adapter (the inverse of
        :meth:`codec_params`)."""
        if restored is not None:
            self.ae_compressor().params = restored

    def encode(self, update: Tree) -> Tree:
        flat, _ = ravel(update)
        spec = self.spec(flat.numel())
        self._spec = spec                     # remembered for decode()
        return codec.encode(spec, self.codec_params(), flat)

    def decode(self, payload: Tree, unravel: Callable) -> Tree:
        spec = getattr(self, "_spec", None)
        assert spec is not None, (
            "decode() before encode(): the payload carries no length "
            "metadata, so the spec must come from this adapter's last "
            "encode (or use codec.decode(spec, ...) directly)")
        return unravel(codec.decode(spec, self.codec_params(), payload))

    def roundtrip(self, update: Tree) -> Tuple[Tree, Dict[str, float]]:
        flat, unravel = ravel(update)
        payload = self.encode(update)
        decoded = self.decode(payload, unravel)
        return decoded, codec_stats(flat, payload, spec=self._spec)


class IdentityCompressor(Compressor):
    def spec(self, n: int) -> codec.IdentitySpec:
        return codec.IdentitySpec(size=n)


@dataclasses.dataclass
class QuantizeCompressor(Compressor):
    """Blockwise absmax quantization to int8 (or packed int4)."""

    bits: int = 8
    block: int = 256

    def spec(self, n: int) -> codec.QuantizeSpec:
        return codec.QuantizeSpec(size=n, bits=self.bits, block=self.block)


@dataclasses.dataclass
class TopKCompressor(Compressor):
    """Keep the top-k magnitudes (DGC-style); ship (values, int32 indices)."""

    fraction: float = 0.01

    def spec(self, n: int) -> codec.TopKSpec:
        return codec.TopKSpec(size=n, k=max(1, int(n * self.fraction)))


@dataclasses.dataclass
class KMeansCompressor(Compressor):
    """FedZip-style clustered quantization: a k-means codebook fit at
    encode time ships with the codes. ``params`` is an optional warm-start
    ``{"codebook": (k,)}`` that seeds the Lloyd iterations."""

    k: int = 16
    iters: int = 8
    params: Any = None

    def spec(self, n: int) -> codec.KMeansSpec:
        return codec.KMeansSpec(size=n, k=self.k, iters=self.iters)

    def codec_params(self):
        return self.params

    def set_codec_params(self, restored) -> None:
        if restored is not None:
            self.params = restored


@dataclasses.dataclass
class ChainCompressor(Compressor):
    """Composable codec stack (DESIGN.md §13): ``inner`` sub-compressors
    chained left to right, each stage's spec sized from the previous
    stage's carry length. ``entropy_coded=True`` appends an
    ``EntropySpec`` pricing stage: the measured-bytes channel reports the
    entropy-coded size while the shape-static price stays dense.
    ``codec_params()`` is a per-stage tuple (None for stateless stages),
    cached by identity so the server's shared-params ``is`` check keeps
    grouping chain cohorts."""

    inner: Any                              # Sequence[Compressor]
    entropy_coded: bool = False
    table_bytes_per_symbol: int = 4

    def __post_init__(self):
        self.inner = list(self.inner)
        if not self.inner:
            raise ValueError("ChainCompressor needs at least one stage")

    def spec(self, n: int) -> codec.ChainSpec:
        stages = []
        size = n
        for i, comp in enumerate(self.inner):
            st = comp.spec(size)
            stages.append(st)
            if i < len(self.inner) - 1:
                size = codec.stage_out_size(st)
                if size is None:
                    raise ValueError(
                        f"{type(comp).__name__} is terminal-only and cannot "
                        f"precede {type(self.inner[i + 1]).__name__}")
        if self.entropy_coded:
            stages.append(codec.EntropySpec(
                table_bytes_per_symbol=self.table_bytes_per_symbol))
        return codec.ChainSpec(tuple(stages))

    def codec_params(self):
        ps = tuple(comp.codec_params() for comp in self.inner)
        if all(p is None for p in ps):
            return None
        cached = getattr(self, "_params_cache", None)
        if (cached is not None and len(cached) == len(ps)
                and all(a is b for a, b in zip(cached, ps))):
            return cached
        self._params_cache = ps
        return ps

    def ae_compressor(self):
        for comp in self.inner:
            sub = comp.ae_compressor()
            if sub is not None:
                return sub
        return None

    def set_codec_params(self, restored) -> None:
        if restored is None:
            return
        if len(restored) != len(self.inner):
            raise ValueError(f"restored chain params have {len(restored)} "
                             f"stages, the adapter has {len(self.inner)}")
        for comp, p in zip(self.inner, restored):
            comp.set_codec_params(p)


@dataclasses.dataclass
class FCAECompressor(Compressor):
    """Paper-faithful full FC AE: latent = the entire update's encoding.
    ``prefit`` (not a field) marks params that came from a fit, so a rate
    controller trusts this rung's probe from round 0."""

    params: Any
    cfg: AEConfig
    prefit = False

    def spec(self, n: int) -> codec.FCAESpec:
        return codec.FCAESpec(size=n, cfg=self.cfg)

    def codec_params(self):
        return self.params

    def ae_compressor(self):
        return self


@dataclasses.dataclass
class ChunkedAECompressor(Compressor):
    """Shared-chunk AE. ``use_kernel=None`` (the default) takes the kernel
    path wherever CUDA is available; ``use_kernel`` is the one switch
    (``kernels.ops.use_kernel_default``). ``prefit`` as for
    :class:`FCAECompressor`."""

    params: Any
    cfg: ae.ChunkedAEConfig
    use_kernel: Optional[bool] = None
    prefit = False

    def spec(self, n: int) -> codec.ChunkedAESpec:
        from repro_torch.kernels.ops import use_kernel_default
        return codec.ChunkedAESpec(
            size=n, cfg=self.cfg,
            use_kernel=use_kernel_default(self.use_kernel))

    def codec_params(self):
        return self.params

    def ae_compressor(self):
        return self


@dataclasses.dataclass
class ComposedCompressor(Compressor):
    """AE latents further quantized — the paper's "orthogonal combination"
    (§4.2): the ratio multiplies (AE ratio × 32/bits)."""

    inner: Compressor
    bits: int = 8
    block: int = 64

    def spec(self, n: int) -> codec.ComposedSpec:
        return codec.ComposedSpec(inner=self.inner.spec(n), bits=self.bits,
                                  block=self.block)

    def codec_params(self):
        return self.inner.codec_params()

    def ae_compressor(self):
        return self.inner.ae_compressor()


@dataclasses.dataclass
class PartitionedCompressor(Compressor):
    """Per-layer codec partitions (DESIGN.md §10): one sub-compressor per
    named leaf group of a frozen ``partition.PartitionMap``. ``spec(n)``
    assembles the ``partition.PartitionSpec`` from the current
    sub-compressors, and ``codec_params()`` is the per-group
    ``{name: params_or_None}`` dict the partition codec functions take."""

    pmap: Any                               # partition.PartitionMap
    compressors: Dict[str, Compressor]

    def __post_init__(self):
        if set(self.compressors) != set(self.pmap.names):
            raise ValueError(
                f"sub-compressor keys {sorted(self.compressors)} != "
                f"partition groups {sorted(self.pmap.names)}")

    def spec(self, n: int):
        from repro_torch.core import partition
        if n != self.pmap.size:
            raise ValueError(f"update has {n} params but the partition map "
                             f"covers {self.pmap.size}")
        subs = {name: comp.spec(self.pmap.group_size(name))
                for name, comp in self.compressors.items()}
        # sub-compressors change only when one is swapped, so the
        # assembled (and tiling-checked) spec is cached on its sub-specs
        key = tuple(sorted(subs.items(), key=lambda kv: kv[0]))
        cached = getattr(self, "_spec_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        spec = partition.make_partition_spec(self.pmap, subs)
        self._spec_cache = (key, spec)
        return spec

    def codec_params(self):
        return {name: comp.codec_params()
                for name, comp in self.compressors.items()}

    def set_codec_params(self, restored) -> None:
        if restored is None:
            return
        for name, p in restored.items():
            if p is not None:
                self.compressors[name].set_codec_params(p)

    def ae_groups(self) -> Dict[str, Compressor]:
        """The AE-backed sub-compressors, keyed by group name: what the
        lifecycle buffers and refits."""
        return {name: comp.ae_compressor()
                for name, comp in self.compressors.items()
                if comp.ae_compressor() is not None}


def partitioned(comp: Compressor) -> Optional[PartitionedCompressor]:
    """``comp`` as a :class:`PartitionedCompressor`, or None."""
    return comp if isinstance(comp, PartitionedCompressor) else None
