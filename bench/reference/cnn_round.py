"""The plain reference of an FL round over the paper's CIFAR CNN (§4.1,
§5.1): each sampled client trains the global model with Adam on its own
shard, ships its update (error-feedback compensated) through the composed
chunked-AE + int8 codec, and the server adds the weighted mean of the
decoded updates to the global model.

Plain PyTorch: the CNN's VALID convolutions as unfold + batched matrix
products over a client axis (a block of clients trained at once, each
client's own parameters), ReLU, 2×2 max-pools after every second conv, a
dense head, the mean negative log-likelihood; Adam written out. Parameter
trees flatten with dict keys sorted, leaf by leaf row-major: the flat
order the codec's chunks are cut from. Cohorts and batch orders follow the
traffic's documented streams (numpy ``RandomState`` seeds), which the
reference computes itself.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from bench.reference import codec

Tree = Dict[str, Dict[str, torch.Tensor]]


def ravel(tree: Tree) -> torch.Tensor:
    return torch.cat([tree[k][n].reshape(-1) for k in sorted(tree)
                      for n in sorted(tree[k])])


def ravel_stacked(tree: Tree) -> torch.Tensor:
    """Leaves with a leading client axis → (C, P)."""
    return torch.cat([tree[k][n].reshape(tree[k][n].shape[0], -1)
                      for k in sorted(tree) for n in sorted(tree[k])], 1)


def unravel(flat: torch.Tensor, like: Tree) -> Tree:
    out, i = {}, 0
    for k in sorted(like):
        out[k] = {}
        for n in sorted(like[k]):
            t = like[k][n]
            out[k][n] = flat[i:i + t.numel()].reshape(t.shape)
            i += t.numel()
    return out


def cohort(sample_seed: int, r: int, n: int, c: int) -> List[int]:
    """The sampled cohort of round ``r``: ``c`` of ``n`` without
    replacement, sorted."""
    rng = np.random.RandomState((sample_seed * 100003 + r) % 2 ** 31)
    return sorted(rng.choice(n, size=min(c, n), replace=False).tolist())


def batch_order(seed: int, n: int, batch: int) -> List[np.ndarray]:
    """One epoch's batches: a ``RandomState(seed)`` permutation cut into
    whole batches."""
    order = np.random.RandomState(seed).permutation(n)
    return [order[i:i + batch] for i in range(0, n - batch + 1, batch)]


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """VALID stride-1 convolution, client-batched: x (C, B, H, W, Cin),
    w (C, k, k, Cin, Cout) → (C, B, Ho, Wo, Cout)."""
    C, B, H, W, Cin = x.shape
    k, Cout = w.shape[1], w.shape[-1]
    Ho, Wo = H - k + 1, W - k + 1
    cols = x.unfold(2, k, 1).unfold(3, k, 1)     # (C, B, Ho, Wo, Cin, k, k)
    cols = cols.permute(0, 1, 2, 3, 5, 6, 4).reshape(C, B * Ho * Wo,
                                                     k * k * Cin)
    out = torch.bmm(cols, w.reshape(C, k * k * Cin, Cout)) + b[:, None, :]
    return out.reshape(C, B, Ho, Wo, Cout)


def _pool(x: torch.Tensor) -> torch.Tensor:
    C, B, H, W, Ch = x.shape
    x = x[:, :, :H // 2 * 2, :W // 2 * 2]
    return x.reshape(C, B, H // 2, 2, W // 2, 2, Ch).amax(dim=(3, 5))


def cnn_logits(p: Tree, x: torch.Tensor, model: Dict) -> torch.Tensor:
    """Client-batched CNN: x (C, B, 32, 32, 3) NHWC → (C, B, classes)."""
    h = x
    for i in range(len(model["conv_channels"])):
        h = torch.relu(_conv(h, p[f"conv{i}"]["w"], p[f"conv{i}"]["b"]))
        if i % 2 == 1:
            h = _pool(h)
    h = h.reshape(h.shape[0], h.shape[1], -1)
    n = len(model["dense_hidden"]) + 1
    for i in range(n):
        h = torch.matmul(h, p[f"dense{i}"]["w"]) + p[f"dense{i}"]["b"][:,
                                                                       None]
        if i < n - 1:
            h = torch.relu(h)
    return h


def client_losses(p: Tree, x: torch.Tensor, y: torch.Tensor,
                  model: Dict) -> torch.Tensor:
    """Each client's mean negative log-likelihood over its batch: (C,)."""
    logp = torch.log_softmax(cnn_logits(p, x, model), dim=-1)
    return -logp.gather(-1, y[..., None])[..., 0].mean(dim=1)


def adam_train(g: Tree, x: torch.Tensor, y: torch.Tensor, model: Dict,
               epochs: int, lr: float, batch: int, seed: int,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
               ) -> Tuple[Tree, torch.Tensor]:
    """Every client of a block starts from ``g`` and takes one Adam step a
    batch on its own shard (x (C, n, …), y (C, n)), batches in the order
    of ``batch_order(seed · 1000 + epoch)``. Returns the trained stacked
    parameters, each client's loss at the last step and at the first, and
    the first step's gradients (stacked, by leaf)."""
    C, n = y.shape
    keys = [(k, m) for k in sorted(g) for m in sorted(g[k])]
    p = {k: {m: g[k][m].detach()[None].repeat(C, *([1] * g[k][m].dim()))
             for m in g[k]} for k in g}
    mom = {km: torch.zeros_like(p[km[0]][km[1]]) for km in keys}
    vel = {km: torch.zeros_like(p[km[0]][km[1]]) for km in keys}
    t, last, first = 0, None, None
    for epoch in range(epochs):
        for sel in batch_order(seed * 1000 + epoch, n, batch):
            idx = torch.as_tensor(sel, device=x.device)
            leaves = [p[k][m].requires_grad_(True) for k, m in keys]
            losses = client_losses(p, x[:, idx], y[:, idx], model)
            grads = torch.autograd.grad(losses.sum(), leaves)
            last = losses.detach()
            if first is None:
                first = (last, {km: gr.detach() for km, gr in
                                zip(keys, grads)})
            t += 1
            with torch.no_grad():
                for (k, m), leaf, gr in zip(keys, leaves, grads):
                    mom[(k, m)] = b1 * mom[(k, m)] + (1 - b1) * gr
                    vel[(k, m)] = b2 * vel[(k, m)] + (1 - b2) * gr * gr
                    mhat = mom[(k, m)] / (1 - b1 ** t)
                    vhat = vel[(k, m)] / (1 - b2 ** t)
                    p[k][m] = (leaf - lr * mhat / (torch.sqrt(vhat) + eps)
                               ).detach()
    return p, last, first


def run_rounds(g0: Tree, data: Dict[str, torch.Tensor], ae: Dict,
               model: Dict, fl: Dict, codec_cfg: Dict, rounds: int,
               client_block: int = 25) -> List[Dict]:
    """``rounds`` rounds from ``g0`` over the clients' shards (``data``'s
    x (N, n, …) and y (N, n)). Returns per round the cohort, its mean
    last-step loss, its codes and scales (C, nb, block), the uplink bytes,
    the global parameters after the round, the codec's inputs (C, P) and
    the server's update (P,); and of the first round each client's first
    step loss and the squared norm of each leaf's first gradient over the
    cohort."""
    N = data["y"].shape[0]
    P = ravel(g0).numel()
    chunk, bits, block = (codec_cfg["chunk_size"], codec_cfg["bits"],
                          codec_cfg["block"])
    residual: Dict[int, torch.Tensor] = {}
    g, out = g0, []
    for r in range(rounds):
        clients = cohort(fl["sample_seed"], r, N, fl["cohort"])
        seed = fl["seed"] * 997 + r
        gflat = ravel(g)
        losses, codes, scales, inputs, firsts = [], [], [], [], []
        grad_sq: Dict[Tuple[str, str], float] = {}
        hsum = None
        w = 1.0 / len(clients)          # equal shards: equal FedAvg weights
        for i in range(0, len(clients), client_block):
            blk = clients[i:i + client_block]
            sel = torch.as_tensor(blk, device=gflat.device)
            p, loss, (first, grads) = adam_train(
                g, data["x"][sel], data["y"][sel], model,
                fl["local_epochs"], fl["lr"], fl["batch_size"], seed)
            losses.append(loss)
            firsts.append(first)
            for km, gr in grads.items():
                grad_sq[km] = grad_sq.get(km, 0.0) + float(
                    (gr.double() ** 2).sum())
            with torch.no_grad():
                upd = ravel_stacked(p) - gflat[None]
                upd = upd + torch.stack([residual.get(c, torch.zeros_like(
                    gflat)) for c in blk])
                q, s = codec.composed_encode(ae, upd, chunk, bits, block)
                dec = codec.composed_decode(ae, q, s, P, chunk)
                for j, c in enumerate(blk):
                    residual[c] = upd[j] - dec[j]
                latent = ae["enc"][-1]["w"].shape[1]
                z = codec.composed_latents(q, s, -(-P // chunk), latent)
                part = torch.einsum("c,cmk->mk",
                                    torch.full((len(blk),), w,
                                               device=z.device,
                                               dtype=z.dtype),
                                    codec.ae_hidden(ae, z))
                hsum = part if hsum is None else hsum + part
                codes.append(q)
                scales.append(s)
                inputs.append(upd)
        with torch.no_grad():
            last = ae["dec"][-1]
            mean = (hsum @ last["w"] + last["b"]) * ae["norm"]["std"] \
                + ae["norm"]["mean"]
            delta = mean.reshape(-1)[:P]
            g = unravel(gflat + delta, g0)
        q_all = torch.cat(codes)
        s_all = torch.cat(scales)
        out.append({"cohort": clients,
                    "loss": float(torch.cat(losses).double().mean()),
                    "codes": q_all, "scales": s_all,
                    "bytes_up": float(q_all.numel() * q_all.element_size()
                                      + s_all.numel() * 4),
                    "params": g, "inputs": torch.cat(inputs),
                    "delta": delta, "first_loss": torch.cat(firsts),
                    "grad_sq": grad_sq})
    return out
