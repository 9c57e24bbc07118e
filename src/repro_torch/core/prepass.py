"""Pre-pass round (paper §3, Fig. 2) and local training (port of
``repro.core.prepass``).

The server ships the global model; each collaborator trains it locally
without aggregation, logging the flattened weight vector at the end of
every epoch — the *weights dataset* its AE trains on. The decoder half is
then shipped to the server (the ``Cost`` term of Eq. 5/6).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import trace
from repro_torch.configs.paper import AEConfig, ClassifierConfig
from repro_torch.core import autoencoder as ae
from repro_torch.core.pytree import leaves, ravel, tree_map, value_and_grad
from repro_torch.data.pipeline import batch_indices, batches
from repro_torch.device import DeviceLike, resolve
from repro_torch.models.classifiers import classifier_loss, init_classifier
from repro_torch.optim.optimizers import make_optimizer

Tree = Any


def local_train(
    params: Tree,
    clf_cfg: ClassifierConfig,
    data: Dict[str, torch.Tensor],
    *,
    epochs: int,
    lr: float = 1e-3,
    batch_size: int = 64,
    seed: int = 0,
    optimizer: str = "adam",
    prox_mu: float = 0.0,
    anchor: Optional[Tree] = None,
    snapshot_every_epoch: bool = False,
) -> Tuple[Tree, List[torch.Tensor], List[Dict[str, float]]]:
    """Train a classifier locally on ``data``'s device. Returns (params,
    weight snapshots, per-epoch metrics). ``prox_mu`` adds the FedProx
    proximal term against ``anchor`` (the round-start global params)."""
    opt = make_optimizer(optimizer, lr)
    state = opt.init(params)

    def loss_fn(p, batch):
        loss, metrics = classifier_loss(p, clf_cfg, batch)
        if prox_mu > 0.0 and anchor is not None:
            sq = sum(torch.sum(torch.square(a - b))
                     for a, b in zip(leaves(p), leaves(anchor)))
            loss = loss + 0.5 * prox_mu * sq
        return loss, metrics

    snapshots: List[torch.Tensor] = []
    history: List[Dict[str, float]] = []
    for epoch in range(epochs):
        last_metrics = None
        for b in batches(seed * 1000 + epoch, data, batch_size):
            with trace.span("client_train.grad"):
                _, last_metrics, grads = value_and_grad(loss_fn, params, b)
            with trace.span("client_train.optimizer"):
                params, state = opt.update(params, grads, state)
        if last_metrics is not None:
            history.append({k: float(trace.to_host(v))
                            for k, v in last_metrics.items()})
        if snapshot_every_epoch:
            snapshots.append(ravel(params)[0])
    return params, snapshots, history


def _batched_grad(clf_cfg: ClassifierConfig, prox_mu: float):
    """Per-client gradients over a homogeneous cohort: ``torch.func.vmap``
    of ``torch.func.grad`` of the functional loss, the params and the batch
    batched along a leading client axis, the FedProx anchor shared. No
    kernel wrapper runs inside (a batched tensor has no ``data_ptr``): the
    classifier loss is plain tensor ops."""

    def loss_fn(p, batch, anchor):
        loss, metrics = classifier_loss(p, clf_cfg, batch)
        if prox_mu > 0.0:
            sq = sum(torch.sum(torch.square(a - b))
                     for a, b in zip(leaves(p), leaves(anchor)))
            loss = loss + 0.5 * prox_mu * sq
        return loss, metrics

    return torch.func.vmap(torch.func.grad(loss_fn, has_aux=True),
                           in_dims=(0, 0, None))


def local_train_batched(
    params: Tree,
    clf_cfg: ClassifierConfig,
    stacked_data: Dict[str, torch.Tensor],     # leaves shaped (C, n, ...)
    *,
    epochs: int,
    lr: float = 1e-3,
    batch_size: int = 64,
    seed: int = 0,
    optimizer: str = "adam",
    prox_mu: float = 0.0,
    anchor: Optional[Tree] = None,
) -> Tuple[Tree, List[Dict[str, float]]]:
    """``local_train`` over a homogeneous cohort in one pass a step
    (DESIGN.md §6.4): all C clients start from ``params`` and train on
    their own shard of ``stacked_data``, in the batch order of
    ``batch_indices(seed * 1000 + epoch, ...)`` that the sequential path
    draws with the same shared ``seed``. Each step is one vmapped gradient
    (:func:`_batched_grad`) and one Adam update over the stacked tree:
    Adam is element-wise, so updating the stacked leaves is each client's
    update. Returns (stacked params with a leading client axis, per-client
    final metrics)."""
    C, n = stacked_data["x"].shape[0], stacked_data["x"].shape[1]
    opt = make_optimizer(optimizer, lr)
    grad_fn = _batched_grad(clf_cfg,
                            prox_mu if anchor is not None else 0.0)
    anchor_arg = anchor if anchor is not None else params
    stacked = tree_map(
        lambda x: x.detach()[None].expand((C,) + x.shape).clone(), params)
    state = opt.init(stacked)
    dev = stacked_data["x"].device
    last = None
    for epoch in range(epochs):
        for sel in batch_indices(seed * 1000 + epoch, n, batch_size):
            sel_t = trace.to_device(sel, dev, torch.int64)
            batch = {k: v[:, sel_t] for k, v in stacked_data.items()}
            with trace.span("client_train.grad"):
                grads, last = grad_fn(stacked, batch, anchor_arg)
            with trace.span("client_train.optimizer"):
                stacked, state = opt.update(stacked, grads, state)
    if last is None:
        return stacked, [{} for _ in range(C)]
    host = {k: trace.to_host(v.detach()).tolist() for k, v in last.items()}
    return stacked, [{k: float(v[ci]) for k, v in host.items()}
                     for ci in range(C)]


@torch.no_grad()
def evaluate(params: Tree, clf_cfg: ClassifierConfig,
             data: Dict[str, torch.Tensor]) -> Dict[str, float]:
    _, metrics = classifier_loss(params, clf_cfg, data)
    return {k: float(trace.to_host(v)) for k, v in metrics.items()}


def run_prepass(
    gen: torch.Generator,
    clf_cfg: ClassifierConfig,
    ae_cfg: AEConfig,
    data: Dict[str, torch.Tensor],
    *,
    prepass_epochs: int = 30,
    ae_epochs: int = 150,
    lr: float = 1e-3,
    seed: int = 0,
    collect_updates: bool = False,
    init_params: Optional[Tree] = None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Full pre-pass for one collaborator on ``device``: local training →
    weights dataset → AE training. ``collect_updates=True`` stores
    per-epoch deltas from the initial weights instead of raw weights;
    ``init_params`` starts local training from given weights instead of a
    fresh draw from ``gen`` (DESIGN.md §15.6)."""
    dev = resolve(device)
    data = {k: v.to(dev) for k, v in data.items()}
    params0 = (init_params if init_params is not None
               else init_classifier(gen, clf_cfg, dev))
    flat0, _ = ravel(params0)

    params, snaps, history = local_train(
        params0, clf_cfg, data, epochs=prepass_epochs, lr=lr, seed=seed,
        snapshot_every_epoch=True)
    dataset = torch.stack(snaps)                     # (E, P)
    if collect_updates:
        dataset = dataset - flat0[None, :]
    pad = ae_cfg.input_dim - dataset.shape[1]
    assert pad >= 0, "AE input smaller than model parameter count"
    if pad:
        dataset = torch.nn.functional.pad(dataset, (0, pad))

    ae_params, ae_history = ae.train_autoencoder(
        gen, ae_cfg, dataset, kind="fc", epochs=ae_epochs)
    return {
        "model_params": params,
        "weights_dataset": dataset,
        "ae_params": ae_params,
        "ae_history": ae_history,
        "train_history": history,
        "decoder_params": ae.decoder_param_count(ae_params),
    }
