"""The plain reference of one streaming-ingest round (FedBuff-style
buffered asynchronous aggregation, Nguyen et al. 2022, at the server):
pop the first K arrivals by (arrival time, dispatch sequence), weight each
by ``(1 + staleness) ** -power`` normalized, add the weighted mean of the
decoded payloads to the global model, and re-dispatch exactly those K
clients at the new clock with fresh latencies.

The traffic (payloads and latencies) is drawn from the round's seed by
the serve loop's documented draw contract: one ``torch.Generator`` on the
device seeded ``(seed << 32) + next_seq``, from which the payload leaves
are drawn in the order of their sorted keys (int8 codes uniform in
``[-127, 128)``, float32 scales standard normal), then the re-dispatched
clients' uniforms. The reference draws them again itself. The pop is
numpy's ``lexsort`` on the host; everything else is plain PyTorch.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from bench.reference import codec


def generator(seed: int, next_seq: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) << 32) + int(next_seq))


def latency(traffic: Dict, u: torch.Tensor, clients: torch.Tensor,
            n: int) -> torch.Tensor:
    """``base · (1 + jitter (2u − 1))``, times ``straggler_mult`` for the
    first ``ceil(straggler_frac · n)`` clients."""
    lat = traffic["base_latency"] * (
        1.0 + traffic["jitter"] * (2.0 * u - 1.0))
    slow = int(math.ceil(traffic["straggler_frac"] * n))
    return torch.where(clients < slow, lat * traffic["straggler_mult"], lat)


def initial(traffic: Dict, seed: int, global_flat: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
    """Every client dispatched at t = 0 with version 0."""
    n, dev = traffic["n_clients"], global_flat.device
    gen = generator(seed, 0, dev)
    cis = torch.arange(n, dtype=torch.int32, device=dev)
    u = torch.rand((n,), generator=gen, device=dev, dtype=torch.float32)
    return {"times": latency(traffic, u, cis, n), "seqs": cis.clone(),
            "versions": torch.zeros(n, dtype=torch.int32, device=dev),
            "global_flat": global_flat.clone(),
            "clock": torch.zeros((), device=dev),
            "version": torch.zeros((), dtype=torch.int32, device=dev),
            "next_seq": torch.full((), n, dtype=torch.int32, device=dev)}


def step(st: Dict[str, torch.Tensor], traffic: Dict, ae: Dict,
         codec_cfg: Dict, size: int, seed: int) -> Dict[str, torch.Tensor]:
    n, k = traffic["n_clients"], traffic["buffer_k"]
    dev = st["times"].device
    times = st["times"].cpu().numpy()
    seqs = st["seqs"].cpu().numpy()
    order = np.lexsort((seqs, times))[:k]            # time, then seq
    idx = torch.as_tensor(order, device=dev)
    clock = torch.maximum(st["clock"], st["times"][idx[-1]])
    version, next_seq = int(st["version"]), int(st["next_seq"])
    stale = (version - st["versions"][idx]).double()
    w = (1.0 + stale) ** -traffic["staleness_power"]
    w = (w / w.sum()).float()
    gen = generator(seed, next_seq, dev)
    latent = codec_cfg["latent_chunk"]
    n_chunks = -(-size // codec_cfg["chunk_size"])
    nb = -(-n_chunks * latent // codec_cfg["block"])
    q = torch.randint(-127, 128, (k, nb, codec_cfg["block"]),
                      generator=gen, device=dev,
                      dtype=torch.int32).to(torch.int8)
    s = torch.randn((k, nb), generator=gen, device=dev)
    u = torch.rand((k,), generator=gen, device=dev)
    z = codec.composed_latents(q, s, n_chunks, latent)
    mean = codec.weighted_mean_decode(ae, z, w, size)
    out = {k_: v.clone() for k_, v in st.items()}
    out["global_flat"] = st["global_flat"] + traffic["server_lr"] * mean
    out["times"][idx] = clock + latency(traffic, u, idx.to(torch.int32), n)
    out["seqs"][idx] = (next_seq + torch.arange(k, device=dev)).to(
        torch.int32)
    out["versions"][idx] = version + 1
    out["clock"] = clock
    out["version"] = st["version"] + 1
    out["next_seq"] = st["next_seq"] + k
    return out
