"""The paper's collaborator model and AE shapes (paper §4.1, §5.1).

The port's own copy of the reference's ``configs/paper.py`` dataclasses,
kept identical so a config means the same experiment in both packages:

* MNIST classifier — a 784→20→10 MLP, exactly 15,910 parameters.
* MNIST AE — 15,910 → 64 → 32 → 64 → 15,910; latent 32 → ~497×.
* CIFAR classifier — 4 VALID 3×3 convs (32, 32, 64, 64 channels, a 2×2
  max-pool after every second) and a 1600→288→80→10 head: 550,586
  parameters (the paper states 550,570).
* CIFAR AE — the paper's one-bottleneck funnel, 550,570 → 320 → 550,570.
* The scalable-runtime scenarios (DESIGN.md §6): N clients, a C-of-N
  cohort, a K-deep async buffer and a straggler latency model.
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

# paper §5.1: conv(3->32) 896 + conv(32->32) 9,248 + conv(32->64) 18,496
# + conv(64->64) 36,928 + dense(1600->288) 461,088 + dense(288->80) 23,120
# + dense(80->10) 810 = 550,586 params (paper: 550,570).
CIFAR_CLASSIFIER = ClassifierConfig(
    name="cifar-cnn",
    kind="cnn",
    input_shape=(32, 32, 3),
    n_classes=10,
    conv_channels=(32, 32, 64, 64),
    conv_kernel=3,
    dense_hidden=(288, 80),
)

# the paper's CIFAR AE: one 320-wide bottleneck over 550,570 inputs,
# 2*550570*320 + 320 + 550570 = 352,915,690 params, ~1720x
CIFAR_AE = AEConfig(input_dim=550_570, encoder_hidden=(), latent_dim=320)


def cifar_ae_for(n_params: int) -> AEConfig:
    """Paper-shaped CIFAR AE resized to the actual classifier param count."""
    return AEConfig(input_dim=n_params, encoder_hidden=(), latent_dim=320)


@dataclasses.dataclass(frozen=True)
class FLRuntimeScenario:
    """One scalable-runtime experiment: N clients, a C-of-N sampled cohort
    (``SampledSync``), a K-deep async buffer (``AsyncBuffered``) and the
    latency distribution the straggler scenario runs under
    (``LatencyModel``)."""

    n_clients: int
    cohort: int                       # SampledSync: C of N per round
    buffer_k: int                     # AsyncBuffered: aggregate first K
    rounds: int
    local_epochs: int = 1
    base_latency: float = 1.0
    latency_jitter: float = 0.5       # multiplicative U[1±j]
    straggler_frac: float = 0.0       # tail of straggler_mult-slower clients
    straggler_mult: float = 8.0


# the paper's Fig. 10 regime: ~1000 collaborators, ~40 rounds
PAPER_SCALE_SCENARIO = FLRuntimeScenario(
    n_clients=1000, cohort=100, buffer_k=50, rounds=40, local_epochs=5,
    straggler_frac=0.1)

# the same shape at 16 clients: quarter cohorts, a 25% straggler tail
SMOKE_SCALE_SCENARIO = FLRuntimeScenario(
    n_clients=16, cohort=4, buffer_k=4, rounds=3,
    straggler_frac=0.25)
