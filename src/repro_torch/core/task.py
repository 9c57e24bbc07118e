"""Client tasks: the model-side half of the federated runtime (port of
``repro.core.task``): the ``ClientTask`` protocol, ``ClassifierTask`` with
its vmapped cohort path, and ``LMDeltaTask``, federated delta fine-tuning
of the LM zoo's ported families (dense and MoE, GQA or MLA attention).
DESIGN.md §14.1 describes the protocol.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch import trace
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


# =====================================================================
# federated delta fine-tuning of the LM zoo
# =====================================================================
@functools.lru_cache(maxsize=16)
def _lm_step(arch_cfg, optimizer: str, lr: float, prox_mu: float,
             frozen_roles: Tuple[str, ...]):
    """The local training step, built once per ``(arch_cfg, optimizer, lr,
    prox_mu, frozen_roles)``: autograd through ``models.train_loss`` (whose
    attention takes the differentiable plain route while autograd records,
    and which checkpoints each layer where ``arch_cfg.remat`` is set), the
    gradients times the role mask, then ``make_optimizer(optimizer, lr)``.
    The FedProx term is added when ``prox_mu`` > 0."""
    from repro_torch.core.pytree import leaves, tree_map, value_and_grad
    from repro_torch.models import model as model_lib
    from repro_torch.optim.optimizers import make_optimizer
    opt = make_optimizer(optimizer, lr)

    def loss_fn(p, batch, anchor):
        loss, metrics = model_lib.train_loss(p, arch_cfg, batch)
        if prox_mu > 0.0:
            sq = sum(torch.sum(torch.square(a - b))
                     for a, b in zip(leaves(p), leaves(anchor)))
            loss = loss + 0.5 * prox_mu * sq
        return loss, metrics

    def step(p, s, batch, anchor, mask):
        with trace.span("client_train.grad"):
            _, metrics, grads = value_and_grad(loss_fn, p, batch, anchor)
        with trace.span("client_train.optimizer"):
            grads = tree_map(lambda g, m: g * m, grads, mask)
            p, s = opt.update(p, grads, s)
        return p, s, metrics

    return opt, step


@dataclasses.dataclass
class LMDeltaTask(ClientTask):
    """Federated delta fine-tuning of any ``configs/`` zoo model (dense,
    MLA, MoE, SSM, hybrid RG-LRU, audio, VLM). Each client shard is a token
    corpus ``{"tokens":
    (n, S), "labels": (n, S)}`` (``data.pipeline.synthetic_lm_batch``); a
    local round runs ``cfg.local_epochs`` epochs of next-token training in
    the ``batch_indices`` order the classifier path uses. The task needs
    ``FLConfig(payload="update")``: the post-error-feedback weight delta
    crosses the wire.

    ``freeze_roles`` masks the gradients of whole parameter roles (as
    :func:`~repro_torch.core.partition.role_of_path` names them; e.g.
    ``("embedding",)`` freezes the embedding and LM head): frozen roles
    ship exact-zero deltas."""

    arch_cfg: Any                       # configs.base.ArchConfig
    freeze_roles: Tuple[str, ...] = ()
    name: str = "lm_delta"

    def __post_init__(self):
        self._mask = None               # built from the first param tree

    def init_params(self, gen, device):
        from repro_torch.models import model as model_lib
        return model_lib.init_params(gen, self.arch_cfg, device)

    def _grad_mask(self, params: Tree) -> Tree:
        """1.0 for a trained leaf, 0.0 for a frozen one, by the role of its
        ``/``-joined path (the reference's ``_key_str`` joins)."""
        if self._mask is None:
            from repro_torch.core.partition import role_of_path
            from repro_torch.core.pytree import flatten, leaf_paths, unflatten
            frozen = set(self.freeze_roles)
            _, treedef = flatten(params)
            self._mask = unflatten(treedef, [
                0.0 if role_of_path(path) in frozen else 1.0
                for path, _, _ in leaf_paths(params)])
        return self._mask

    def local_update(self, params, data, cfg, *, seed, anchor=None):
        from repro_torch.data.pipeline import _take, batch_indices
        prox = (cfg.prox_mu if cfg.aggregation == "fedprox" else 0.0)
        opt, step = _lm_step(self.arch_cfg, cfg.optimizer, cfg.lr,
                             prox if anchor is not None else 0.0,
                             tuple(self.freeze_roles))
        mask = self._grad_mask(params)
        anchor_arg = anchor if anchor is not None else params
        state = opt.init(params)
        n = self.num_examples(data)
        last = None
        for epoch in range(cfg.local_epochs):
            # the classifier path's seed stream: epoch-keyed shuffles
            for sel in batch_indices(seed * 1000 + epoch, n,
                                     cfg.batch_size):
                batch = _take(data, sel)
                params, state, last = step(params, state, batch,
                                           anchor_arg, mask)
        metrics = ({} if last is None
                   else {k: float(trace.to_host(v)) for k, v in last.items()})
        return params, metrics

    @torch.no_grad()
    def evaluate(self, params, data):
        """``train_loss`` without autograd, so on the card each attention
        call launches the flash-attention kernel."""
        from repro_torch.models import model as model_lib
        _, metrics = model_lib.train_loss(params, self.arch_cfg, data)
        return {k: float(trace.to_host(v)) for k, v in metrics.items()}

    def make_batches(self, seed: int, data: Dict[str, torch.Tensor],
                     batch_size: int) -> Iterator[Dict[str, torch.Tensor]]:
        """One epoch of shuffled minibatches over a client shard."""
        from repro_torch.data.pipeline import _take, batch_indices
        n = self.num_examples(data)
        for sel in batch_indices(seed, n, batch_size):
            yield _take(data, sel)

    def num_examples(self, data) -> int:
        return int(data["tokens"].shape[0])

    def check_config(self, cfg) -> None:
        if cfg.payload != "update":
            raise ValueError(
                "LMDeltaTask ships weight deltas — construct the run with "
                f"FLConfig(payload='update'), got payload={cfg.payload!r}")

    def checkpoint_key(self) -> str:
        return f"lm_delta:{self.arch_cfg.name}"
