"""Blockwise absmax quantization: wrappers over the CUDA kernels in
``csrc/quantize.cu`` (port of ``repro/kernels/quantize.py``).

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _lib, ref


def quantize_blocks_2d(x: torch.Tensor, *, bits: int = 8, block: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (n_blocks, block) f32 → (q int8 (n_blocks, block), scales f32
    (n_blocks,))."""
    nb, blk = x.shape
    if blk != block:
        raise ValueError(f"rows have {blk} values, block is {block}")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if x.device.type == "cpu":
        return ref.quantize_blocks_ref(x, bits)
    _lib.check_cuda("quantize_blocks_2d: x", x, torch.float32)
    q = torch.empty((nb, block), dtype=torch.int8, device=x.device)
    s = torch.empty((nb,), dtype=torch.float32, device=x.device)
    if nb:
        _lib.launch("quantize_blocks_2d", "repro_quantize_blocks", x, q, s,
                    nb, block, float(2 ** (bits - 1) - 1))
    return q, s


def dequantize_blocks_2d(q: torch.Tensor, scales: torch.Tensor, *,
                         block: int = 256) -> torch.Tensor:
    """q int8 (n_blocks, block), scales f32 (n_blocks,) → f32
    (n_blocks, block)."""
    nb, blk = q.shape
    if blk != block:
        raise ValueError(f"rows have {blk} values, block is {block}")
    if q.device.type == "cpu":
        return ref.dequantize_blocks_ref(q, scales)
    _lib.check_cuda("dequantize_blocks_2d: q", q, torch.int8)
    _lib.check_cuda("dequantize_blocks_2d: scales", scales, torch.float32,
                    (nb,))
    x = torch.empty((nb, block), dtype=torch.float32, device=q.device)
    if nb:
        _lib.launch("dequantize_blocks_2d", "repro_dequantize_blocks", q,
                    scales, x, nb, block)
    return x
