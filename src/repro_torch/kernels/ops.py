"""Dispatch layer over the kernels (port of ``repro/kernels/ops.py``).

``bits=4`` payloads are packed two nibbles per byte here, with torch ops
(a reshape and an or — not worth a kernel). :func:`use_kernel_default`
picks the chunked-AE kernel path (on wherever CUDA is available) and
:func:`use_grouped_default` the grouped server round (off); each has one
switch, the explicit field its caller passes, and reads no environment.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.autoencoder import ChunkedAEConfig, chunk_vector
from repro_torch.kernels.fused_dense import fused_dense
from repro_torch.kernels.quantize import (dequantize_blocks_2d,
                                          quantize_blocks_2d)


def use_kernel_default(override: Optional[bool] = None) -> bool:
    """Kernel-vs-plain dispatch for the AE codec path: the explicit
    ``override`` (``ChunkedAECompressor.use_kernel``) when given, else
    whether CUDA is available. The kernel path on CPU tensors runs the
    plain versions, so the choice never changes what a CPU run computes."""
    if override is not None:
        return bool(override)
    return torch.cuda.is_available()


def use_grouped_default(override: Optional[bool] = None) -> bool:
    """The grouped one-launch server round (``partition._grouped_round``):
    the explicit ``override`` (``FLConfig.use_grouped_kernel`` or a direct
    ``server_decode_aggregate`` argument) when given, else off — the
    per-bucket sequential path is the differential oracle the grouped
    launch is held against, so it stays the default."""
    if override is not None:
        return bool(override)
    return False


# ---------------------------------------------------------------- quantize
def quantize_blocks(flat: torch.Tensor, *, bits: int = 8, block: int = 256
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """flat f32 vector → (payload int8, scales f32, orig_len). bits=4 packs
    two values per byte."""
    orig_len = int(flat.numel())
    blocks, _ = chunk_vector(flat.float(), block)
    q, scales = quantize_blocks_2d(blocks.contiguous(), bits=bits,
                                   block=block)
    if bits == 4:
        q = pack_nibbles(q)
    return q, scales, orig_len


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7] → two-per-byte uint8 (bits=4 wire format)."""
    qf = q.reshape(-1)
    lo = (qf[0::2] + 8).to(torch.uint8)             # [-7,7] → [1,15]
    hi = (qf[1::2] + 8).to(torch.uint8)
    return lo | (hi << 4)


def unpack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`: uint8 bytes → int8 pairs, flat."""
    qf = q.reshape(-1)
    lo = (qf & 0xF).to(torch.int8) - 8
    hi = ((qf >> 4) & 0xF).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(-1)


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor, *,
                      orig_len: int, bits: int = 8,
                      block: int = 256) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks`; ``orig_len`` is mandatory (the
    padded tail is never payload)."""
    if orig_len <= 0:
        raise ValueError(f"orig_len must be positive, got {orig_len}")
    if bits == 4:
        q = unpack_nibbles(q).reshape(-1, block)
    x = dequantize_blocks_2d(q.contiguous(), scales.contiguous(), block=block)
    return x.reshape(-1)[:orig_len]


# ---------------------------------------------------------------- chunked AE
def _stack_forward(stack, x: torch.Tensor, act: str,
                   final_act: str) -> torch.Tensor:
    for i, layer in enumerate(stack):
        a = act if i < len(stack) - 1 else final_act
        x = fused_dense(x.contiguous(), layer["w"], layer["b"], act=a)
    return x


def ae_encode(params, cfg: ChunkedAEConfig, flat: torch.Tensor
              ) -> torch.Tensor:
    """Kernel-backed chunked encode: (n_chunks, chunk) → (n_chunks, latent)."""
    chunks, _ = chunk_vector(flat, cfg.chunk_size)
    norm = params["norm"]
    xn = (chunks - norm["mean"]) / norm["std"]
    return _stack_forward(params["enc"], xn, cfg.activation, cfg.activation)


def ae_decode(params, cfg: ChunkedAEConfig, z: torch.Tensor,
              orig_len: int) -> torch.Tensor:
    xn = _stack_forward(params["dec"], z, cfg.activation, "linear")
    norm = params["norm"]
    chunks = xn * norm["std"] + norm["mean"]
    return chunks.reshape(-1)[:orig_len]
