"""Deterministic synthetic data pipeline (port of ``repro.data.pipeline``).

Every draw is ``np.random.RandomState``, exactly as in the reference, so
datasets, partitions and batch order are bit-identical to the JAX package's
for the same seeds. Datasets are host data: the functions return CPU
tensors (``x`` float32, ``y`` int64 — the index type ``torch.gather``
takes), and :class:`~repro_torch.core.federated.FederatedRun` and
:func:`~repro_torch.core.prepass.run_prepass` move them to their device.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch import trace

Data = Dict[str, torch.Tensor]


def synthetic_classification(
    seed: int, n: int, input_shape: Tuple[int, ...], n_classes: int,
    *, sep: float = 3.0, noise: float = 1.0,
) -> Data:
    """Gaussian-cluster classification with deterministic structure."""
    rng = np.random.RandomState(seed)
    dim = int(np.prod(input_shape))
    centers = rng.randn(n_classes, dim).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    y = rng.randint(0, n_classes, size=n).astype(np.int32)
    x = centers[y] * sep + rng.randn(n, dim).astype(np.float32) * noise
    x = x.reshape(n, *input_shape)
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y.astype(np.int64))}


def mnist_like(seed: int, n: int = 2048) -> Data:
    # sep chosen so the task generalizes from a few hundred samples (the
    # per-dim noise norm is sqrt(784)≈28; class structure must dominate it)
    return synthetic_classification(seed, n, (784,), 10, sep=8.0, noise=0.7)


def cifar_like(seed: int, n: int = 2048) -> Data:
    """CIFAR-shaped (32, 32, 3) HWC images, 10 classes."""
    return synthetic_classification(seed, n, (32, 32, 3), 10,
                                    sep=8.0, noise=0.7)


def to_grayscale(data: Data) -> Data:
    """Paper §5.2: the second collaborator sees grayscale images (the
    channel mean, replicated across the channels): the colour-imbalance
    non-IID condition."""
    x = data["x"]
    assert x.ndim == 4, "grayscale imbalance needs HWC images"
    # the channels summed in order, then times the float32 reciprocal of
    # the count: XLA's form of the reference's ``jnp.mean``, bit for bit
    c = x.shape[-1]
    g = x[..., 0:1]
    for i in range(1, c):
        g = g + x[..., i:i + 1]
    g = g * torch.tensor(1.0 / c, dtype=x.dtype, device=x.device)
    return {"x": g.expand(x.shape).contiguous(), "y": data["y"]}


def color_imbalance_split(seed: int, n_per_collab: int = 2048,
                          n_eval: int = 256) -> Tuple[List[Data], Data]:
    """Two CIFAR-like collaborators over one task (the same class
    centers): collaborator 0 sees colour images, collaborator 1 the
    grayscale version of a disjoint slice (paper §5.2). Returns
    ``([c0, c1], eval)``."""
    data = cifar_like(seed, 2 * n_per_collab + n_eval)
    c0 = {k: v[:n_per_collab] for k, v in data.items()}
    c1 = to_grayscale({k: v[n_per_collab:2 * n_per_collab]
                       for k, v in data.items()})
    evald = {k: v[2 * n_per_collab:] for k, v in data.items()}
    return [c0, c1], evald


def train_eval_split(data: Data, n_eval: int) -> Tuple[Data, Data]:
    """Split one dataset into train/eval; eval shares the generating seed
    (class centers) with train."""
    n = data["x"].shape[0]
    assert n_eval < n
    train = {k: v[:n - n_eval] for k, v in data.items()}
    evald = {k: v[n - n_eval:] for k, v in data.items()}
    return train, evald


def dirichlet_partition(seed: int, data: Data, n_clients: int,
                        alpha: float = 0.5, min_per_client: int = 1
                        ) -> List[Data]:
    """Label-skew non-IID partition; shards below ``min_per_client`` are
    topped up with index ``(ci + k) % n`` for the k-th filler."""
    rng = np.random.RandomState(seed)
    y = data["y"].cpu().numpy()
    n_classes = int(y.max()) + 1
    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.where(y == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for ci, part in enumerate(np.split(idx, cuts)):
            client_idx[ci].extend(part.tolist())
    out = []
    for ci in range(n_clients):
        sel = np.array(sorted(client_idx[ci]), dtype=np.int64)
        if len(sel) < min_per_client:
            extra = [(ci + k) % len(y)
                     for k in range(min_per_client - len(sel))]
            sel = np.concatenate([sel, np.array(extra, dtype=np.int64)])
        out.append(_take(data, sel))
    return out


def uniform_partition(seed: int, data: Data, n_clients: int) -> List[Data]:
    """Equal-sized IID shards (shuffle, then split evenly; the remainder is
    dropped)."""
    rng = np.random.RandomState(seed)
    n = data["x"].shape[0]
    order = rng.permutation(n)
    per = n // n_clients
    assert per > 0, "fewer samples than clients"
    return [_take(data, order[i * per:(i + 1) * per])
            for i in range(n_clients)]


def batch_indices(seed: int, n: int, batch_size: int
                  ) -> Iterator[np.ndarray]:
    """One epoch of shuffled batch index arrays (partial tail batch
    dropped) — the single source of batch order."""
    order = np.random.RandomState(seed).permutation(n)
    for i in range(0, n - batch_size + 1, batch_size):
        yield order[i:i + batch_size]


def batches(seed: int, data: Data, batch_size: int) -> Iterator[Data]:
    """One epoch of shuffled minibatches."""
    for sel in batch_indices(seed, data["x"].shape[0], batch_size):
        yield _take(data, sel)


def _take(data: Data, sel: np.ndarray) -> Data:
    """Rows ``sel`` of every field, indexed on the data's own device."""
    out = {}
    for k, v in data.items():
        out[k] = v[trace.to_device(sel, v.device, torch.int64)]
    return out


# ----------------------------------------------------------------- LM stream
def synthetic_lm_batch(seed: int, vocab_size: int, batch: int,
                       seq_len: int) -> Data:
    """Zipf-distributed token stream with next-token labels, drawn exactly
    as the reference draws it (int64 here, the reference's int32 values)."""
    rng = np.random.RandomState(seed)
    ranks = rng.zipf(1.3, size=(batch, seq_len + 1))
    tokens = torch.from_numpy((ranks % vocab_size).astype(np.int64))
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
