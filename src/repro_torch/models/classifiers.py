"""The paper's collaborator models (§4.1) in PyTorch: the MLP branch of
``repro.models.classifiers``.

MNIST-MLP: 784→20→10, exactly 15,910 parameters (paper §5.1). Parameters
are plain dicts with JAX's layout (dense ``w`` is ``(in, out)``), so their
flat order and values match the reference's tree. The CNN branch is not
ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.paper import ClassifierConfig
from repro_torch.device import DeviceLike, resolve

Params = Dict[str, Any]


def _dense(gen: torch.Generator, d_in: int, d_out: int) -> Params:
    w = torch.randn((d_in, d_out), generator=gen,
                    dtype=torch.float32) * (d_in ** -0.5)
    return {"w": w, "b": torch.zeros((d_out,), dtype=torch.float32)}


def init_classifier(gen: torch.Generator, cfg: ClassifierConfig,
                    device: DeviceLike = None) -> Params:
    """Draw on the CPU generator ``gen``, then move to ``device``, so CPU
    and CUDA runs start from identical parameters."""
    if cfg.kind != "mlp":
        raise NotImplementedError(f"classifier kind {cfg.kind!r} is not "
                                  "ported yet (only 'mlp')")
    dev = resolve(device)
    dims = [cfg.input_shape[0], *cfg.hidden, cfg.n_classes]
    params = {f"dense{i}": _dense(gen, dims[i], dims[i + 1])
              for i in range(len(dims) - 1)}
    return {k: {n: t.to(dev) for n, t in p.items()}
            for k, p in params.items()}


def apply_classifier(params: Params, cfg: ClassifierConfig,
                     x: torch.Tensor) -> torch.Tensor:
    """x: (B, *input_shape) → logits (B, n_classes)."""
    if cfg.kind != "mlp":
        raise NotImplementedError(cfg.kind)
    h = x.reshape(x.shape[0], -1)
    n = len([k for k in params if k.startswith("dense")])
    for i in range(n):
        p = params[f"dense{i}"]
        h = h @ p["w"] + p["b"]
        if i < n - 1:
            h = torch.relu(h)
    return h


def classifier_loss(params: Params, cfg: ClassifierConfig,
                    batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean NLL of the log-softmax, plus accuracy."""
    logits = apply_classifier(params, cfg, batch["x"])
    logp = torch.log_softmax(logits, dim=-1)
    y = batch["y"].long()
    ll = logp.gather(-1, y[:, None])[:, 0]
    loss = -ll.mean()
    acc = (logits.argmax(-1) == y).float().mean()
    return loss, {"loss": loss, "accuracy": acc}

