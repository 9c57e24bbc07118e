"""Inputs made from ``--seed`` on the run's device, in a few large calls.

``cifar_like`` copies ``repro_torch/data/pipeline.py::cifar_like``'s
shapes and statistics (Gaussian class clusters: unit-norm centers times
8, noise 0.7, 10 classes, (32, 32, 3) HWC images) but draws with a
``torch.Generator`` on the device instead of numpy on the host. Seeds are
split with numpy's ``SeedSequence``, so any whole ``--seed`` (also past
2**32) gives its own streams.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def seed_words(seed: int, n: int, stream: int = 0) -> List[int]:
    """``n`` independent 31-bit seeds from one ``--seed`` (and another
    ``stream`` of them for each further use)."""
    entropy = int(seed) if not stream else [int(seed), int(stream)]
    words = np.random.SeedSequence(entropy).generate_state(n)
    return [int(w) & 0x7FFFFFFF for w in words]


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def cifar_like(gen: torch.Generator, n: int, input_shape=(32, 32, 3),
               n_classes: int = 10, sep: float = 8.0, noise: float = 0.7
               ) -> Dict[str, torch.Tensor]:
    dev = gen.device
    dim = int(np.prod(input_shape))
    centers = torch.randn((n_classes, dim), generator=gen, device=dev)
    centers = centers / torch.linalg.vector_norm(centers, dim=1,
                                                 keepdim=True)
    y = torch.randint(0, n_classes, (n,), generator=gen, device=dev)
    x = centers[y] * sep + torch.randn((n, dim), generator=gen,
                                       device=dev) * noise
    return {"x": x.reshape(n, *input_shape), "y": y}


def split_even(data: Dict[str, torch.Tensor], n_clients: int, per: int
               ) -> List[Dict[str, torch.Tensor]]:
    """Equal IID shards as views: client ``i`` holds rows ``[i·per,
    (i+1)·per)`` (the draws are already independent, so no shuffle)."""
    return [{k: v[i * per:(i + 1) * per] for k, v in data.items()}
            for i in range(n_clients)]


def lm_tokens(gen: torch.Generator, n: int, seq_len: int, vocab: int,
              exponent: float = 1.3) -> Dict[str, torch.Tensor]:
    """``synthetic_lm_batch``'s Zipf(1.3) token stream, drawn on the device
    by inverse transform of a uniform over the ranks ``1..R`` (``R`` the
    vocabulary), ids ``rank mod vocab``; next-token labels."""
    dev = gen.device
    ranks = torch.arange(1, vocab + 1, device=dev, dtype=torch.float64)
    cdf = torch.cumsum(ranks ** -exponent, 0)
    cdf = cdf / cdf[-1]
    u = torch.rand((n, seq_len + 1), generator=gen, device=dev,
                   dtype=torch.float64)
    ids = torch.searchsorted(cdf, u).clamp_max(vocab - 1) + 1
    toks = (ids % vocab).to(torch.int64)
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}
