"""The plain reference of the codecs the cells run, in PyTorch: the chunked
autoencoder (paper §3.2's shared-chunk AE: normalize, dense + ReLU layers
to the latent, dense + ReLU back, a linear last layer, denormalize),
blockwise absmax int8 quantization, their composition (AE latents
quantized, paper §4.2), and the server's weighted mean of decoded updates.

Nothing here comes from the program: the math follows the paper and the
codec's documented wire format (``{"z_q": (nb, block) int8, "z_scales":
(nb,) float32}``, latents flattened chunk-major). Products run in float32
unless the caller turns TF32 on (the control).
"""
from __future__ import annotations

from typing import Dict, List

import torch

AE = Dict[str, object]          # {"enc": [{w, b}], "dec": [{w, b}], "norm"}


def quantize(x: torch.Tensor, bits: int, block: int):
    """``x`` (…, n) → (codes (…, nb, block) int8, scales (…, nb)):
    zero-padded blocks of the last axis, scale = max(absmax / qmax,
    1e-12), codes round half to even and clip to ±qmax."""
    qmax = float(2 ** (bits - 1) - 1)
    pad = (-x.shape[-1]) % block
    xb = torch.nn.functional.pad(x, (0, pad))
    xb = xb.reshape(*x.shape[:-1], -1, block)
    amax = xb.abs().amax(dim=-1)
    scale = torch.clamp_min(amax / qmax, 1e-12)
    q = torch.clamp(torch.round(xb / scale[..., None]), -qmax, qmax)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """(…, nb, block) codes and (…, nb) scales → (…, n) floats."""
    x = q.to(scale.dtype) * scale[..., None]
    return x.reshape(*x.shape[:-2], -1)[..., :n]


def _dense_stack(layers: List, x: torch.Tensor, last_relu: bool
                 ) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1 or last_relu:
            x = torch.relu(x)
    return x


def ae_encode(ae: AE, flat: torch.Tensor, chunk: int) -> torch.Tensor:
    """(…, n) → (…, n_chunks, latent): zero-padded chunks, normalized,
    through the encoder with ReLU after every layer, the latent's too."""
    pad = (-flat.shape[-1]) % chunk
    x = torch.nn.functional.pad(flat, (0, pad))
    x = x.reshape(*flat.shape[:-1], -1, chunk)
    x = (x - ae["norm"]["mean"]) / ae["norm"]["std"]
    return _dense_stack(ae["enc"], x, last_relu=True)


def ae_hidden(ae: AE, z: torch.Tensor) -> torch.Tensor:
    """Latents → the decoder's last hidden activations."""
    return _dense_stack(ae["dec"][:-1], z, last_relu=True)


def ae_decode(ae: AE, z: torch.Tensor, n: int) -> torch.Tensor:
    """(…, n_chunks, latent) → (…, n): the hidden stack, a linear last
    layer, denormalized, the padding cut."""
    last = ae["dec"][-1]
    x = ae_hidden(ae, z) @ last["w"] + last["b"]
    x = x * ae["norm"]["std"] + ae["norm"]["mean"]
    return x.reshape(*x.shape[:-2], -1)[..., :n]


def composed_encode(ae: AE, flat: torch.Tensor, chunk: int, bits: int,
                    block: int):
    """AE latents, flattened chunk-major, quantized: ``(codes,
    scales)``."""
    z = ae_encode(ae, flat, chunk)
    return quantize(z.reshape(*z.shape[:-2], -1), bits, block)


def composed_latents(q: torch.Tensor, scale: torch.Tensor, n_chunks: int,
                     latent: int) -> torch.Tensor:
    """(…, nb, block) codes → (…, n_chunks, latent) latents."""
    z = dequantize(q, scale, n_chunks * latent)
    return z.reshape(*z.shape[:-1], n_chunks, latent)


def composed_decode(ae: AE, q: torch.Tensor, scale: torch.Tensor, n: int,
                    chunk: int) -> torch.Tensor:
    latent = ae["enc"][-1]["w"].shape[1]
    n_chunks = -(-n // chunk)
    return ae_decode(ae, composed_latents(q, scale, n_chunks, latent), n)


def weighted_mean_decode(ae: AE, z: torch.Tensor, w: torch.Tensor, n: int
                         ) -> torch.Tensor:
    """``Σ_c w_c · decode(z_c)`` for latents ``z`` (C, n_chunks, latent)
    and weights summing to 1. The last decoder layer is linear, so the
    weighted sum of hidden activations goes through it once:
    ``(Σ w_c h_c) W + b``, denormalized once."""
    last = ae["dec"][-1]
    hbar = torch.einsum("c,cmk->mk", w, ae_hidden(ae, z))
    x = hbar @ last["w"] + last["b"]
    x = x * ae["norm"]["std"] + ae["norm"]["mean"]
    return x.reshape(-1)[:n]
