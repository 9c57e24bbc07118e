"""Client tasks: the model-side half of the federated runtime (port of
``repro.core.task``: the ``ClientTask`` protocol and ``ClassifierTask``;
``LMDeltaTask`` is not ported yet). DESIGN.md §14.1 describes the protocol.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike

Tree = Any


class ClientTask:
    """Strategy interface binding a model family to the federated runtime:
    the task owns model init, local training and evaluation; the runtime
    owns everything codec-, byte- and schedule-shaped."""

    name = "base"

    def init_params(self, gen: torch.Generator, device: DeviceLike) -> Tree:
        """The global model tree, drawn from the CPU generator ``gen`` and
        placed on ``device``."""
        raise NotImplementedError

    def local_update(self, params: Tree, data: Dict[str, torch.Tensor],
                     cfg, *, seed: int, anchor: Optional[Tree] = None
                     ) -> Tuple[Tree, Dict[str, float]]:
        """One client's local round → ``(trained params, final metrics)``;
        ``anchor`` is the round-start global model (FedProx target)."""
        raise NotImplementedError

    def evaluate(self, params: Tree, data: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
        raise NotImplementedError

    def num_examples(self, data: Dict[str, torch.Tensor]) -> int:
        raise NotImplementedError

    def data_weight(self, data: Dict[str, torch.Tensor]) -> float:
        """FedAvg weight of a client's shard (sample count by default)."""
        return float(self.num_examples(data))


@dataclasses.dataclass
class ClassifierTask(ClientTask):
    """The paper's small collaborator models: delegation to
    ``prepass.local_train``/``evaluate`` with the reference's argument
    plumbing and seed streams."""

    clf_cfg: Any                        # configs.paper.ClassifierConfig
    name: str = "classifier"

    def init_params(self, gen, device):
        from repro_torch.models.classifiers import init_classifier
        return init_classifier(gen, self.clf_cfg, device)

    def local_update(self, params, data, cfg, *, seed, anchor=None):
        from repro_torch.core.prepass import local_train
        local, _, hist = local_train(
            params, self.clf_cfg, data,
            epochs=cfg.local_epochs, lr=cfg.lr,
            batch_size=cfg.batch_size, seed=seed,
            optimizer=cfg.optimizer,
            prox_mu=(cfg.prox_mu if cfg.aggregation == "fedprox" else 0.0),
            anchor=anchor)
        return local, (hist[-1] if hist else {})

    def evaluate(self, params, data):
        from repro_torch.core.prepass import evaluate
        return evaluate(params, self.clf_cfg, data)

    def num_examples(self, data) -> int:
        return int(data["x"].shape[0])
