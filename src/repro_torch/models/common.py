"""Shared building blocks (port of the parts of ``repro.models.common`` the
paper's models use)."""
from __future__ import annotations

import torch


def activation_fn(name: str):
    return {
        "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
        "relu": torch.relu,
        "silu": torch.nn.functional.silu,
        "tanh": torch.tanh,
        "linear": lambda x: x,
        "sigmoid": torch.sigmoid,
    }[name]
