"""Autoencoders over weight-update vectors (port of
``repro.core.autoencoder``).

* **FC funnel AE** (paper §3/§4): width = the flat parameter count; hidden
  widths shrink to ``latent_dim`` (Fig. 1), ``z = act(Wx+b)`` stacks
  (Eq. 1/2). Plain matrix products (``torch.matmul``).
* **Chunked AE** (DESIGN.md §3.2): the flat update is reshaped into
  ``(n_chunks, chunk_size)`` and one small funnel AE is shared across
  chunks. Its kernel path lives in ``kernels/ops.py``.
* **Conv1d AE** (the paper's appendix variant): strided ``"SAME"`` convs
  down, transposed convs up, parameters in the reference's WIO layout.

The trainer is the reference's scan trainer (paper Eq. 3 MSE with Adam,
trailing partial batch included, dataset-level normalizer kept in the AE
state) written as a Python loop; :func:`train_autoencoder_cohort` runs C
of those fits at once, each step one ``torch.func.vmap`` over the
clients. Shuffles come from torch generators and so cannot replay
``jax.random``; one step on a fixed batch can.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.paper import AEConfig
from repro_torch.core.pytree import leaves, stack, tree_map
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
# conv1d AE (paper appendix variant)
# =====================================================================
@dataclasses.dataclass(frozen=True)
class ConvAEConfig:
    channels: Tuple[int, ...] = (16, 32)
    kernel: int = 9
    stride: int = 8                    # per stage → total ratio stride**n/ch
    latent_channels: int = 1

    def total_stride(self) -> int:
        return self.stride ** len(self.channels)


def init_conv_ae(gen: torch.Generator, cfg: ConvAEConfig,
                 device: DeviceLike = None) -> Params:
    """Conv weights in the reference's WIO layout ``(kernel, c_in,
    c_out)``, drawn on the CPU generator ``gen`` in the reference's layer
    order, then moved to ``device``."""
    dev = resolve(device)

    def conv(k, c_in, c_out):
        w = torch.randn((k, c_in, c_out), generator=gen, dtype=torch.float32)
        return {"w": (w * (k * c_in) ** -0.5).to(dev),
                "b": torch.zeros((c_out,), dtype=torch.float32, device=dev)}

    enc, dec = [], []
    c_in = 1
    for c_out in cfg.channels:
        enc.append(conv(cfg.kernel, c_in, c_out))
        c_in = c_out
    enc.append(conv(1, c_in, cfg.latent_channels))
    c_in = cfg.latent_channels
    for c_out in reversed(cfg.channels):
        dec.append(conv(cfg.kernel, c_in, c_out))
        c_in = c_out
    dec.append(conv(1, c_in, 1))
    return {"enc": enc, "dec": dec,
            "norm": {"mean": torch.zeros((), dtype=torch.float32, device=dev),
                     "std": torch.ones((), dtype=torch.float32, device=dev)}}


def _conv_same(h: torch.Tensor, layer: Params, stride: int) -> torch.Tensor:
    """``lax.conv_general_dilated(h, w, (stride,), "SAME")`` on NWC ``h``
    with a WIO kernel: XLA's SAME pads ``max((out-1)·s + k - L, 0)`` in
    all, the smaller half first, for ``out = ceil(L / s)``."""
    F = torch.nn.functional
    k = layer["w"].shape[0]
    L = h.shape[-2]
    out = -(-L // stride)
    total = max((out - 1) * stride + k - L, 0)
    x = F.pad(h.transpose(-1, -2), (total // 2, total - total // 2))
    y = F.conv1d(x, layer["w"].permute(2, 1, 0), layer["b"], stride=stride)
    return y.transpose(-1, -2)


def _conv_transpose_same(h: torch.Tensor, layer: Params,
                         stride: int) -> torch.Tensor:
    """``lax.conv_transpose(h, w, (stride,), "SAME")`` on NWC ``h``: no
    kernel flip (``transpose_kernel=False``), so it is a stride-1 conv of
    the stride-dilated input with lax's transpose padding — ``k + s - 2``
    in all, ``k - 1`` first when ``s > k - 1``, else the larger half
    first. Out length ``L · s``."""
    F = torch.nn.functional
    k = layer["w"].shape[0]
    x = h.transpose(-1, -2)                          # (B, C, L)
    B, C, L = x.shape
    # stride-dilate without writing in place (vmappable)
    dil = F.pad(x[..., None], (0, stride - 1)).reshape(B, C, L * stride)
    dil = dil[..., :(L - 1) * stride + 1]
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    dil = F.pad(dil, (pad_a, pad_len - pad_a))
    y = F.conv1d(dil, layer["w"].permute(2, 1, 0), layer["b"])
    return y.transpose(-1, -2)


def conv_encode(params: Params, cfg: ConvAEConfig,
                x: torch.Tensor) -> torch.Tensor:
    """x: (B, length) → (B, length / total_stride, latent_channels)."""
    h = ((x - params["norm"]["mean"]) / params["norm"]["std"])[..., None]
    for layer in params["enc"][:-1]:
        h = torch.relu(_conv_same(h, layer, cfg.stride))
    return _conv_same(h, params["enc"][-1], 1)


def conv_decode(params: Params, cfg: ConvAEConfig,
                z: torch.Tensor) -> torch.Tensor:
    h = z
    for layer in params["dec"][:-1]:
        h = torch.relu(_conv_transpose_same(h, layer, cfg.stride))
    h = _conv_same(h, params["dec"][-1], 1)
    return h[..., 0] * params["norm"]["std"] + params["norm"]["mean"]


# =====================================================================
# AE training (paper Eq. 3: L = ||x - x'||^2) with Adam
# =====================================================================
def _reconstruct(params: Params, cfg, x: torch.Tensor,
                 kind: str) -> torch.Tensor:
    if kind == "fc":
        return fc_reconstruct(params, cfg, x)
    if kind == "conv":
        return conv_decode(params, cfg, conv_encode(params, cfg, x))
    raise ValueError(kind)


def ae_loss(params: Params, cfg, x: torch.Tensor,
            kind: str = "fc") -> torch.Tensor:
    return torch.mean(torch.square(x - _reconstruct(params, cfg, x, kind)))


def ae_accuracy(params: Params, cfg, x: torch.Tensor, kind: str = "fc",
                tol: float = 0.05) -> torch.Tensor:
    """The paper's AE "accuracy" (Figs. 4/6): fraction of reconstructed
    weights within ``tol`` dataset stds of the originals."""
    x_hat = _reconstruct(params, cfg, x, kind)
    scale = params["norm"]["std"]
    return torch.mean((torch.abs(x - x_hat) <= tol * scale).float())


def fit_normalizer(params: Params, dataset: torch.Tensor) -> Params:
    mean = torch.mean(dataset)
    std = torch.clamp_min(torch.std(dataset, correction=0), 1e-8)
    return dict(params, norm={"mean": mean, "std": std})


def _masked_ae_loss(params: Params, cfg, xb: torch.Tensor,
                    wb: torch.Tensor, kind: str = "fc") -> torch.Tensor:
    """Eq.-3 MSE over a batch with a 0/1 row mask ``wb`` (the reference's
    padded-tail form; equals ``ae_loss`` over the unmasked rows)."""
    sq = torch.square(xb - _reconstruct(params, cfg, xb, kind))
    per_row = sq.reshape(sq.shape[0], -1)
    denom = torch.sum(wb) * per_row.shape[1]
    return torch.sum(per_row * wb[:, None]) / denom


@torch.no_grad()
def _adam_update(p: Params, g: Params, m: Params, v: Params, t: int,
                 lr: float):
    """One Adam step, the reference trainer's op chain; ``t`` is the
    1-based bias-correction step. Element-wise, so it updates a stacked
    cohort tree as it updates one client's."""
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


def _loss_grad(cfg, kind: str, batched: bool):
    """``(params, xb, wb) → (grads, loss)`` of the masked loss by
    ``torch.func``; vmapped over a leading client axis when ``batched``.
    The normalizer is a data statistic and gets a zero gradient."""
    def loss(p, xb, wb):
        return _masked_ae_loss(p, cfg, xb, wb, kind)
    fn = torch.func.grad_and_value(loss)
    if batched:
        fn = torch.func.vmap(fn)

    def step(params, xb, wb):
        g, value = fn(params, xb, wb)
        return dict(g, norm=tree_map(torch.zeros_like, g["norm"])), value
    return step


def ae_step(params: Params, cfg, xb: torch.Tensor, wb: torch.Tensor,
            m: Params, v: Params, t: int, lr: float, kind: str = "fc"):
    """One trainer step: masked loss, gradient, Adam. Returns
    ``(params, m, v, loss)``."""
    g, loss = _loss_grad(cfg, kind, batched=False)(params, xb, wb)
    params, m, v = _adam_update(params, g, m, v, t, lr)
    return params, m, v, loss.detach()


def _setup(gen: torch.Generator, cfg, dataset: torch.Tensor, kind: str,
           val_fraction: float, init: Optional[Params],
           refit_normalizer: Optional[bool]):
    """The trainer's prologue (init, split, normalizer), drawing from
    ``gen`` in a fixed order: a fresh init, then the split permutation."""
    dev = dataset.device
    n = dataset.shape[0]
    n_val = max(1, int(n * val_fraction)) if n > 2 else 0
    if init is None:
        params = (init_fc_ae(gen, cfg, dev) if kind == "fc"
                  else init_conv_ae(gen, cfg, dev))
        refit = True if refit_normalizer is None else refit_normalizer
    else:
        params = init
        refit = False if refit_normalizer is None else refit_normalizer
    order = torch.randperm(n, generator=gen).to(dev)
    shuffled_all = dataset[order]
    train_set, val_set = shuffled_all[:n - n_val], shuffled_all[n - n_val:]
    if refit:
        params = fit_normalizer(params, train_set)
    return params, train_set, val_set


def train_autoencoder(
    gen: torch.Generator,
    cfg,
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
    """Train an AE (``kind`` "fc" or "conv") on a weights dataset on the
    dataset's device; returns (params, per-epoch history). Split, init,
    normalizer, warm-start and trailing-batch semantics follow the
    reference's scan trainer (DESIGN.md §8.1); shuffles and a fresh init
    draw from ``gen``. It is :func:`train_autoencoder_cohort` at C = 1."""
    params, hist = train_autoencoder_cohort(
        [gen], cfg, dataset[None], kind=kind, epochs=epochs,
        batch_size=batch_size, lr=lr, val_fraction=val_fraction,
        init=None if init is None else tree_map(lambda x: x[None], init),
        refit_normalizer=refit_normalizer)
    return (tree_map(lambda x: x[0], params),
            {k: v[0].tolist() for k, v in hist.items()})


def train_autoencoder_cohort(
    gens: Sequence[torch.Generator],  # one generator per client
    cfg,
    datasets: torch.Tensor,           # (C, n_samples, input_dim)
    *,
    kind: str = "fc",
    epochs: int = 200,
    batch_size: int = 8,
    lr: float = 3e-3,
    val_fraction: float = 0.2,
    init: Optional[Params] = None,    # stacked params, leading client axis
    refit_normalizer: Optional[bool] = None,
) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """Fit C autoencoders at once (DESIGN.md §8.1): client c's init, split
    and shuffles draw from ``gens[c]`` exactly as :func:`train_autoencoder`
    would, and every step is one ``torch.func.vmap`` of the masked loss's
    gradient over the clients, then one Adam update of the stacked tree.
    Returns (stacked params with a leading client axis, history dict of
    ``(C, epochs)`` tensors; the val keys are empty when n ≤ 2)."""
    C, n = datasets.shape[0], datasets.shape[1]
    if len(gens) != C:
        raise ValueError(f"{len(gens)} generators for {C} clients")
    parts = [_setup(g, cfg, datasets[c], kind, val_fraction,
                    None if init is None else tree_map(lambda x: x[c], init),
                    refit_normalizer)
             for c, g in enumerate(gens)]
    params = stack([p for p, _, _ in parts])
    train_set = torch.stack([t for _, t, _ in parts])   # (C, n_train, d)
    val_set = torch.stack([v for _, _, v in parts])
    n_train, n_val = train_set.shape[1], val_set.shape[1]
    dev = datasets.device
    bs = min(batch_size, max(1, n_train))
    nb = -(-n_train // bs)
    grad = _loss_grad(cfg, kind, batched=True)
    rows = torch.arange(C, device=dev)[:, None]
    metric = torch.func.vmap(
        lambda p, x: (ae_loss(p, cfg, x, kind),
                      ae_accuracy(p, cfg, x, kind)))
    m = tree_map(torch.zeros_like, params)
    v = tree_map(torch.zeros_like, params)
    hist: Dict[str, list] = {"loss": [], "accuracy": [], "val_loss": [],
                             "val_accuracy": []}
    step = 0
    for _ in range(epochs):
        order = torch.stack([torch.randperm(n_train, generator=g)
                             for g in gens]).to(dev)
        shuffled = train_set[rows, order]
        losses = []
        for i in range(nb):
            xb = shuffled[:, i * bs:(i + 1) * bs]     # tail batch may be < bs
            wb = torch.ones(xb.shape[:2], dtype=xb.dtype, device=dev)
            step += 1
            g, loss = grad(params, xb, wb)
            params, m, v = _adam_update(params, g, m, v, step, lr)
            losses.append(loss.detach())
        with torch.no_grad():
            hist["loss"].append(torch.stack(losses).sum(0) / nb)
            _, acc = metric(params, train_set)
            hist["accuracy"].append(acc)
            if n_val:
                vl, va = metric(params, val_set)
                hist["val_loss"].append(vl)
                hist["val_accuracy"].append(va)
    out = {k: (torch.stack(vs, dim=1) if vs
               else torch.zeros((C, 0), device=dev))
           for k, vs in hist.items()}
    return params, out


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
