"""The paper's collaborator models (§4.1) in PyTorch (port of
``repro.models.classifiers``).

MNIST-MLP: 784→20→10, exactly 15,910 parameters (paper §5.1).
CIFAR-CNN: 4 VALID 3×3 convs and a 3-layer dense head, 550,586 parameters.

Parameters are plain dicts in JAX's layout — dense ``w`` is ``(in, out)``,
conv ``w`` is HWIO ``(k, k, c_in, c_out)`` — so their flat order and values
match the reference's tree, and every codec chunks and quantizes the same
flat update. Images are NHWC, as in the reference; ``apply_classifier``
permutes to NCHW / OIHW for ``conv2d`` and flattens the conv stack's output
back in NHWC order, so ``dense0`` carries across unchanged.
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


def _conv(gen: torch.Generator, c_in: int, c_out: int, k: int) -> Params:
    fan_in = c_in * k * k
    w = torch.randn((k, k, c_in, c_out), generator=gen,
                    dtype=torch.float32) * (fan_in ** -0.5)
    return {"w": w, "b": torch.zeros((c_out,), dtype=torch.float32)}


def _cnn_flat_dim(cfg: ClassifierConfig) -> int:
    h = w = cfg.input_shape[0]
    for i in range(len(cfg.conv_channels)):
        h, w = h - cfg.conv_kernel + 1, w - cfg.conv_kernel + 1   # VALID
        if i % 2 == 1:                                            # pool 2x2
            h, w = h // 2, w // 2
    return h * w * cfg.conv_channels[-1]


def init_classifier(gen: torch.Generator, cfg: ClassifierConfig,
                    device: DeviceLike = None) -> Params:
    """Draw on the CPU generator ``gen``, then move to ``device``, so CPU
    and CUDA runs start from identical parameters."""
    if cfg.kind not in ("mlp", "cnn"):
        raise ValueError(f"unknown classifier kind {cfg.kind!r}")
    dev = resolve(device)
    if cfg.kind == "mlp":
        dims = [cfg.input_shape[0], *cfg.hidden, cfg.n_classes]
        params = {f"dense{i}": _dense(gen, dims[i], dims[i + 1])
                  for i in range(len(dims) - 1)}
    else:
        params = {}
        c_in = cfg.input_shape[-1]
        for i, c_out in enumerate(cfg.conv_channels):
            params[f"conv{i}"] = _conv(gen, c_in, c_out, cfg.conv_kernel)
            c_in = c_out
        dims = [_cnn_flat_dim(cfg), *cfg.dense_hidden, cfg.n_classes]
        for i in range(len(dims) - 1):
            params[f"dense{i}"] = _dense(gen, dims[i], dims[i + 1])
    return {k: {n: t.to(dev) for n, t in p.items()}
            for k, p in params.items()}


def conv2d_valid_gemm(h: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """A VALID, stride-1 2-D convolution of NCHW ``h`` by OIHW ``w`` as one
    float32 matrix product a kernel offset, over the shifted window of
    ``h``, summed: differentiable and vmappable with plain ops, and every
    product accumulates in float32 (cuBLAS on the card, with TF32 as
    ``torch.backends.cuda.matmul`` sets it)."""
    _, _, H, W = h.shape
    _, _, kh, kw = w.shape
    Ho, Wo = H - kh + 1, W - kw + 1
    out = b[:, None, None]
    for i in range(kh):
        for j in range(kw):
            out = out + torch.einsum("oc,nchw->nohw", w[:, :, i, j],
                                     h[:, :, i:i + Ho, j:j + Wo])
    return out


def _conv_stack(params: Params, cfg: ClassifierConfig,
                x: torch.Tensor) -> torch.Tensor:
    """NHWC images → the conv stack's output flattened in NHWC order.
    VALID convs in float32 (:func:`conv2d_valid_gemm` on every device, not
    cuDNN: cuDNN 9's float32 convolutions on the H100 give the CIFAR CNN's
    weight gradients up to 1.6e-4 away from float64, with TF32 off, in
    deterministic mode or not), ReLU, and a 2×2 stride-2 max-pool (floor)
    after every second conv."""
    F = torch.nn.functional
    h = x.permute(0, 3, 1, 2)                          # NHWC → NCHW
    for i in range(len(cfg.conv_channels)):
        p = params[f"conv{i}"]
        h = conv2d_valid_gemm(h, p["w"].permute(3, 2, 0, 1),  # HWIO→OIHW
                              p["b"])
        h = torch.relu(h)
        if i % 2 == 1:
            h = F.max_pool2d(h, 2, 2)
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def apply_classifier(params: Params, cfg: ClassifierConfig,
                     x: torch.Tensor) -> torch.Tensor:
    """x: (B, *input_shape) → logits (B, n_classes)."""
    if cfg.kind == "cnn":
        h = _conv_stack(params, cfg, x)
    else:
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

