"""Client tasks: the model-side half of the federated runtime (port of
``repro.core.task``: the ``ClientTask`` protocol and ``ClassifierTask``
with its vmapped cohort path; ``LMDeltaTask`` is not ported yet).
DESIGN.md §14.1 describes the protocol.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

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

    def local_update_batched(self, params: Tree,
                             datasets: List[Dict[str, torch.Tensor]],
                             cfg, *, seed: int,
                             anchor: Optional[Tree] = None
                             ) -> Optional[List[Tuple[Tree,
                                                      Dict[str, float]]]]:
        """Cohort fast path: train every client of a homogeneous cohort in
        one vmapped pass. ``None`` (the default) when the task has no
        batched path or the cohort is ragged — the scheduler then calls
        :meth:`local_update` client by client."""
        return None

    def evaluate(self, params: Tree, data: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
        raise NotImplementedError

    def num_examples(self, data: Dict[str, torch.Tensor]) -> int:
        raise NotImplementedError

    def data_weight(self, data: Dict[str, torch.Tensor]) -> float:
        """FedAvg weight of a client's shard (sample count by default)."""
        return float(self.num_examples(data))

    def check_config(self, cfg) -> None:
        """Validate an ``FLConfig`` against this task (a construction-time
        hook of ``FederatedRun``)."""

    def checkpoint_key(self) -> str:
        """Stable identity stored in checkpoint metadata; a load whose saved
        key differs from the resuming run's task is refused."""
        return self.name


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

    def local_update_batched(self, params, datasets, cfg, *, seed,
                             anchor=None):
        from repro_torch.core.prepass import local_train_batched
        shapes = [{k: tuple(v.shape) for k, v in d.items()}
                  for d in datasets]
        if any(s != shapes[0] for s in shapes[1:]):
            return None
        stacked_data = {k: torch.stack([d[k] for d in datasets])
                        for k in datasets[0]}
        stacked, metrics = local_train_batched(
            params, self.clf_cfg, stacked_data,
            epochs=cfg.local_epochs, lr=cfg.lr, batch_size=cfg.batch_size,
            seed=seed, optimizer=cfg.optimizer,
            prox_mu=(cfg.prox_mu if cfg.aggregation == "fedprox" else 0.0),
            anchor=anchor)
        from repro_torch.core.pytree import tree_map
        locals_ = [tree_map(lambda x, i=i: x[i], stacked)
                   for i in range(len(datasets))]
        return list(zip(locals_, metrics))

    def evaluate(self, params, data):
        from repro_torch.core.prepass import evaluate
        return evaluate(params, self.clf_cfg, data)

    def num_examples(self, data) -> int:
        return int(data["x"].shape[0])

    def checkpoint_key(self) -> str:
        # the classifier's name pins the parameter tree a checkpoint must
        # restore into
        return f"classifier:{getattr(self.clf_cfg, 'name', 'clf')}"
