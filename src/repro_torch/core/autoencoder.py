"""Autoencoders over weight-update vectors (port of ``repro.core.autoencoder``:
the FC funnel and the chunked AE; the conv AE is not ported yet).

* **FC funnel AE** (paper §3/§4): width = the flat parameter count; hidden
  widths shrink to ``latent_dim`` (Fig. 1), ``z = act(Wx+b)`` stacks
  (Eq. 1/2). Plain matrix products (``torch.matmul``).
* **Chunked AE** (DESIGN.md §3.2): the flat update is reshaped into
  ``(n_chunks, chunk_size)`` and one small funnel AE is shared across
  chunks. Its kernel path lives in ``kernels/ops.py``.

The trainer is the reference's scan trainer (paper Eq. 3 MSE with Adam,
trailing partial batch included, dataset-level normalizer kept in the AE
state) written as a Python loop. Its shuffles come from a torch generator
and so cannot replay ``jax.random``; one step on a fixed batch can.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.paper import AEConfig
from repro_torch.core.pytree import leaves, tree_map, value_and_grad
from repro_torch.device import DeviceLike, resolve
from repro_torch.models.common import activation_fn

Params = Dict[str, Any]


# =====================================================================
# fully-connected funnel AE (paper-faithful)
# =====================================================================
def _fc_dims(cfg: AEConfig) -> Tuple[List[int], List[int]]:
    enc = [cfg.input_dim, *cfg.encoder_hidden, cfg.latent_dim]
    dec = [cfg.latent_dim, *reversed(cfg.encoder_hidden), cfg.input_dim]
    return enc, dec


def init_fc_ae(gen: torch.Generator, cfg: AEConfig,
               device: DeviceLike = None) -> Params:
    """Draw on the CPU generator ``gen``, then move to ``device``."""
    dev = resolve(device)
    enc_dims, dec_dims = _fc_dims(cfg)

    def dense(a, b):
        w = torch.randn((a, b), generator=gen, dtype=torch.float32)
        return {"w": (w * (a ** -0.5)).to(dev),
                "b": torch.zeros((b,), dtype=torch.float32, device=dev)}

    return {
        "enc": [dense(a, b) for a, b in zip(enc_dims[:-1], enc_dims[1:])],
        "dec": [dense(a, b) for a, b in zip(dec_dims[:-1], dec_dims[1:])],
        "norm": {"mean": torch.zeros((), dtype=torch.float32, device=dev),
                 "std": torch.ones((), dtype=torch.float32, device=dev)},
    }


def _run_stack(stack: Sequence[Params], x: torch.Tensor, act,
               final_act) -> torch.Tensor:
    for i, layer in enumerate(stack):
        x = x @ layer["w"] + layer["b"]
        x = act(x) if i < len(stack) - 1 else final_act(x)
    return x


def fc_encode(params: Params, cfg: AEConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (..., input_dim) → latent (..., latent_dim). Eq. 1."""
    act = activation_fn(cfg.activation)
    xn = (x - params["norm"]["mean"]) / params["norm"]["std"]
    return _run_stack(params["enc"], xn, act, act)


def fc_decode(params: Params, cfg: AEConfig, z: torch.Tensor) -> torch.Tensor:
    """latent → reconstructed update (Eq. 2)."""
    act = activation_fn(cfg.activation)
    final = activation_fn(cfg.final_activation)
    xn = _run_stack(params["dec"], z, act, final)
    return xn * params["norm"]["std"] + params["norm"]["mean"]


def fc_reconstruct(params: Params, cfg: AEConfig,
                   x: torch.Tensor) -> torch.Tensor:
    return fc_decode(params, cfg, fc_encode(params, cfg, x))


# =====================================================================
# chunked shared AE
# =====================================================================
@dataclasses.dataclass(frozen=True)
class ChunkedAEConfig:
    chunk_size: int = 4096
    hidden: Tuple[int, ...] = (512,)
    latent_chunk: int = 8            # → 512x per-chunk compression
    activation: str = "relu"

    @property
    def compression_ratio(self) -> float:
        return self.chunk_size / self.latent_chunk

    def as_fc(self) -> AEConfig:
        return AEConfig(input_dim=self.chunk_size,
                        encoder_hidden=self.hidden,
                        latent_dim=self.latent_chunk,
                        activation=self.activation)


def init_chunked_ae(gen: torch.Generator, cfg: ChunkedAEConfig,
                    device: DeviceLike = None) -> Params:
    return init_fc_ae(gen, cfg.as_fc(), device)


def chunk_vector(flat: torch.Tensor, chunk_size: int
                 ) -> Tuple[torch.Tensor, int]:
    """Pad a flat vector to a chunk multiple and reshape (n_chunks, chunk)."""
    n = flat.shape[0]
    pad = (-n) % chunk_size
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, chunk_size), n


def unchunk_vector(chunks: torch.Tensor, orig_len: int) -> torch.Tensor:
    return chunks.reshape(-1)[:orig_len]


def chunked_encode(params: Params, cfg: ChunkedAEConfig,
                   flat: torch.Tensor) -> torch.Tensor:
    chunks, _ = chunk_vector(flat, cfg.chunk_size)
    return fc_encode(params, cfg.as_fc(), chunks)     # (n_chunks, latent)


def chunked_decode(params: Params, cfg: ChunkedAEConfig,
                   latents: torch.Tensor, orig_len: int) -> torch.Tensor:
    chunks = fc_decode(params, cfg.as_fc(), latents)
    return unchunk_vector(chunks, orig_len)


# =====================================================================
# AE training (paper Eq. 3: L = ||x - x'||^2) with Adam
# =====================================================================
def ae_loss(params: Params, cfg: AEConfig, x: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(x - fc_reconstruct(params, cfg, x)))


def ae_accuracy(params: Params, cfg: AEConfig, x: torch.Tensor,
                tol: float = 0.05) -> torch.Tensor:
    """The paper's AE "accuracy" (Figs. 4/6): fraction of reconstructed
    weights within ``tol`` dataset stds of the originals."""
    x_hat = fc_reconstruct(params, cfg, x)
    scale = params["norm"]["std"]
    return torch.mean((torch.abs(x - x_hat) <= tol * scale).float())


def fit_normalizer(params: Params, dataset: torch.Tensor) -> Params:
    mean = torch.mean(dataset)
    std = torch.clamp_min(torch.std(dataset, correction=0), 1e-8)
    return dict(params, norm={"mean": mean, "std": std})


def _masked_ae_loss(params: Params, cfg: AEConfig, xb: torch.Tensor,
                    wb: torch.Tensor) -> Tuple[torch.Tensor, None]:
    """Eq.-3 MSE over a batch with a 0/1 row mask ``wb`` (the reference's
    padded-tail form; equals ``ae_loss`` over the unmasked rows)."""
    sq = torch.square(xb - fc_reconstruct(params, cfg, xb))
    per_row = sq.reshape(sq.shape[0], -1)
    denom = torch.sum(wb) * per_row.shape[1]
    return torch.sum(per_row * wb[:, None]) / denom, None


@torch.no_grad()
def _adam_update(p: Params, g: Params, m: Params, v: Params, t: int,
                 lr: float):
    """One Adam step, the reference trainer's op chain; ``t`` is the
    1-based bias-correction step."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    m = tree_map(lambda a, b: b1 * a + (1 - b1) * b, m, g)
    v = tree_map(lambda a, b: b2 * a + (1 - b2) * b * b, v, g)
    tf = torch.tensor(float(t), dtype=torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), tf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), tf)

    def upd(pl, ml, vl):
        mh = ml / bc1.to(ml.device)
        vh = vl / bc2.to(vl.device)
        return pl - lr * mh / (torch.sqrt(vh) + eps)
    return tree_map(upd, p, m, v), m, v


def ae_step(params: Params, cfg: AEConfig, xb: torch.Tensor,
            wb: torch.Tensor, m: Params, v: Params, t: int, lr: float):
    """One trainer step: masked loss, gradient, Adam. The normalizer is a
    data statistic and gets a zero gradient. Returns
    ``(params, m, v, loss)``."""
    loss, _, g = value_and_grad(
        lambda p: _masked_ae_loss(p, cfg, xb, wb), params)
    g = dict(g, norm=tree_map(torch.zeros_like, g["norm"]))
    params, m, v = _adam_update(params, g, m, v, t, lr)
    return params, m, v, loss


def train_autoencoder(
    gen: torch.Generator,
    cfg: AEConfig,
    dataset: torch.Tensor,           # (n_samples, input_dim) weight vectors
    *,
    kind: str = "fc",
    epochs: int = 200,
    batch_size: int = 8,
    lr: float = 3e-3,
    val_fraction: float = 0.2,
    init: Optional[Params] = None,
    refit_normalizer: Optional[bool] = None,
) -> Tuple[Params, Dict[str, list]]:
    """Train an FC AE on a weights dataset on the dataset's device; returns
    (params, per-epoch history). Split, init, normalizer, warm-start and
    trailing-batch semantics follow the reference's scan trainer
    (DESIGN.md §8.1); shuffles and a fresh init draw from ``gen``."""
    if kind != "fc":
        raise NotImplementedError(f"AE kind {kind!r} is not ported yet")
    dev = dataset.device
    n = dataset.shape[0]
    n_val = max(1, int(n * val_fraction)) if n > 2 else 0
    if init is None:
        params = init_fc_ae(gen, cfg, dev)
        refit = True if refit_normalizer is None else refit_normalizer
    else:
        params = init
        refit = False if refit_normalizer is None else refit_normalizer
    order = torch.randperm(n, generator=gen).to(dev)
    shuffled_all = dataset[order]
    train_set, val_set = shuffled_all[:n - n_val], shuffled_all[n - n_val:]
    if refit:
        params = fit_normalizer(params, train_set)
    n_train = train_set.shape[0]
    bs = min(batch_size, max(1, n_train))
    nb = -(-n_train // bs)

    m = tree_map(torch.zeros_like, params)
    v = tree_map(torch.zeros_like, params)
    hist: Dict[str, list] = {"loss": [], "accuracy": [], "val_loss": [],
                             "val_accuracy": []}
    step = 0
    for _ in range(epochs):
        shuffled = train_set[torch.randperm(n_train, generator=gen).to(dev)]
        losses = []
        for i in range(nb):
            xb = shuffled[i * bs:(i + 1) * bs]        # tail batch may be < bs
            wb = torch.ones(xb.shape[0], dtype=xb.dtype, device=dev)
            step += 1
            params, m, v, loss = ae_step(params, cfg, xb, wb, m, v, step, lr)
            losses.append(loss)
        with torch.no_grad():
            hist["loss"].append(torch.stack(losses).sum() / nb)
            hist["accuracy"].append(ae_accuracy(params, cfg, train_set))
            if n_val:
                hist["val_loss"].append(ae_loss(params, cfg, val_set))
                hist["val_accuracy"].append(ae_accuracy(params, cfg, val_set))
    # the one host sync: per-epoch metrics → plain floats
    history = {k: [float(x) for x in vs] for k, vs in hist.items()}
    return params, history


def ae_param_count(params: Params) -> int:
    return sum(x.numel() for x in leaves({"enc": params["enc"],
                                          "dec": params["dec"]}))


def decoder_param_count(params: Params) -> int:
    """Size of the decoder half — the pre-pass shipping cost (Eq. 5/6)."""
    return sum(x.numel() for x in leaves(params["dec"]))


def decoder_tree(params: Params) -> Params:
    """What one decoder sync ships: the decoder stack plus the (mean, std)
    normalizer (DESIGN.md §8.3). The encoder never crosses the wire."""
    return {"dec": params["dec"], "norm": params["norm"]}


def decoder_sync_bytes(params: Params) -> float:
    """Wire bytes of one decoder sync (DESIGN.md §8.3)."""
    return float(sum(x.numel() * x.element_size()
                     for x in leaves(decoder_tree(params))))
