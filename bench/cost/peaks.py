"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit), frozen here as the
benchmark's yardstick.

* HBM3: 80 GB at 3.35 TB/s.
* float32 outside the tensor cores: 67 TFLOP/s. The port's float32
  products run with TF32 off (the CNN's im2col products, kernel 3's
  ``sgemm`` and ``narrow`` routes), so 67 is their peak.
* bfloat16 on the tensor cores: 989 TFLOP/s.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the chip could take for an operation: the larger of
    its bytes over the HBM bandwidth and its operations over the peak of
    ``dtype`` (``chip_smoke.bound``'s arithmetic, in seconds)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
