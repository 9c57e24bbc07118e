"""Device resolution for the port's entry points.

Every entry point takes ``device=None`` and resolves it here: ``None`` means
CUDA, and a CUDA request on a machine without a card raises. Nothing falls
back to the CPU on its own; a CPU run is one the caller asked for.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):       # meta: shapes only
        raise ValueError(f"unsupported device {dev}")
    return dev
