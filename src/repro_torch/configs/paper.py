"""The paper's collaborator model and AE shapes (paper §4.1, §5.1).

The port's own copy of the reference's ``configs/paper.py`` dataclasses,
kept identical so a config means the same experiment in both packages:

* MNIST classifier — a 784→20→10 MLP, exactly 15,910 parameters.
* MNIST AE — 15,910 → 64 → 32 → 64 → 15,910; latent 32 → ~497×.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    name: str
    kind: str                      # mlp | cnn
    input_shape: Tuple[int, ...]
    n_classes: int
    hidden: Tuple[int, ...] = ()
    # cnn-only
    conv_channels: Tuple[int, ...] = ()
    conv_kernel: int = 3
    dense_hidden: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class AEConfig:
    """Fully-connected funnel autoencoder over flat weight vectors (Fig. 1)."""

    input_dim: int
    encoder_hidden: Tuple[int, ...]    # widths after the input layer
    latent_dim: int                    # bottleneck ("reduced feature space")
    activation: str = "relu"
    final_activation: str = "linear"

    @property
    def compression_ratio(self) -> float:
        return self.input_dim / self.latent_dim

    @property
    def n_params(self) -> int:
        dims = ([self.input_dim] + list(self.encoder_hidden)
                + [self.latent_dim] + list(reversed(self.encoder_hidden))
                + [self.input_dim])
        return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


# paper §5.1: MNIST classifier, 784*20 + 20 + 20*10 + 10 = 15,910 params
MNIST_CLASSIFIER = ClassifierConfig(
    name="mnist-mlp",
    kind="mlp",
    input_shape=(784,),
    n_classes=10,
    hidden=(20,),
)

# AE: 15,910 → 64 → 32 → 64 → 15,910; latent 32 → ~497x ("about 500x").
MNIST_AE = AEConfig(input_dim=15_910, encoder_hidden=(64,), latent_dim=32)
