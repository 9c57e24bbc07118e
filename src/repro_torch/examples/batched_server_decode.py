"""Batched server decode→aggregate demo (DESIGN.md §7) on the port.

Builds a 64-client cohort of chunked-AE payloads for one simulated round and
runs the aggregator three ways:

1. per-client loop  — the seed server: one decode per client, then a Python
   accumulation (the path the refactor retires),
2. fused one-call   — ``codec.decode_and_aggregate`` on the kernel path:
   stack the cohort's payloads, decode the hidden layer with the
   ``fused_dense`` kernel and FedAvg-reduce with the fused decode→aggregate
   kernel,
3. shard_map        — ``codec.decode_and_aggregate_sharded``: the client
   axis split over a process group (one rank here, NCCL on the card, gloo
   on the CPU) with an all-reduce epilogue.

All three agree to float tolerance; the timing gap is the point. Times are
the host clock after a synchronize.

Run: PYTHONPATH=src python -m repro_torch.examples.batched_server_decode
"""
from __future__ import annotations

import torch

from repro_torch.core import codec, normalize_weights
from repro_torch.core.autoencoder import ChunkedAEConfig, init_chunked_ae
from repro_torch.examples._common import (Printer, clock, one_rank_group,
                                          parse, parser)

COHORT = 64
MODEL = 1 << 15                         # flat update length per client


def timed(fn, device, n: int = 3) -> float:
    fn()                                # warm-up
    t0 = clock(device)
    for _ in range(n):
        fn()
    return (clock(device) - t0) / n


def server_round(device, out: Printer, cohort: int = COHORT,
                 model: int = MODEL) -> dict:
    """One round's cohort through the three aggregators."""
    cfg = ChunkedAEConfig(chunk_size=256, hidden=(32,), latent_chunk=8)
    params = init_chunked_ae(torch.Generator().manual_seed(0), cfg, device)
    plain_spec = codec.ChunkedAESpec(size=model, cfg=cfg, use_kernel=False)
    kern_spec = codec.ChunkedAESpec(size=model, cfg=cfg, use_kernel=True)
    out(f"== cohort {cohort}, {model}-param updates, "
        f"{cfg.compression_ratio:.0f}x chunked AE ==")

    base = torch.randn(model, generator=torch.Generator().manual_seed(1)
                       ).to(device)
    payloads = [codec.encode(plain_spec, params, base * (1 + 0.01 * i))
                for i in range(cohort)]
    stacked = codec.stack_payloads(payloads)
    weights = normalize_weights([float(i + 1) for i in range(cohort)])
    nw = torch.tensor(weights, dtype=torch.float32, device=device)
    up_bytes = sum(sum(x.numel() * x.element_size() for x in p.values())
                   for p in payloads)
    raw_bytes = cohort * model * 4
    out(f"uplink this round: {up_bytes / 1e3:.0f} kB compressed "
        f"vs {raw_bytes / 1e3:.0f} kB raw")

    def loop():
        acc = torch.zeros((model,), dtype=torch.float32, device=device)
        for w, p in zip(weights, payloads):
            acc = acc + w * codec.decode(plain_spec, params, p)
        return acc

    def fused():
        return codec.decode_and_aggregate(kern_spec, params, stacked, nw)

    def sharded():
        return codec.decode_and_aggregate_sharded(plain_spec, params,
                                                  stacked, nw)

    rows = {}
    with one_rank_group(device):
        ref = loop()
        t_loop = timed(loop, device)
        out(f"per-client loop : {t_loop * 1e3:8.1f} ms/round  (seed server)")
        for name, fn in (("fused one-call", fused), ("shard_map", sharded)):
            got = fn()
            err = float((got - ref).abs().max())
            t = timed(fn, device)
            out(f"{name:16s}: {t * 1e3:8.1f} ms/round  "
                f"({t_loop / t:4.1f}x vs loop, max|Δ|={err:.2e})")
            rows[name] = {"ms": t * 1e3, "max_abs_err": err}
    return {"cohort": cohort, "model": model,
            "compression_ratio": cfg.compression_ratio,
            "up_bytes": up_bytes, "raw_bytes": raw_bytes,
            "loop_ms": t_loop * 1e3, "rows": rows,
            "aggregate": ref.cpu()}


def main(argv=None) -> dict:
    args = parse(parser(__doc__), argv)
    out = Printer()
    res = server_round(args.device, out)
    return dict(res, lines=out.lines)


if __name__ == "__main__":
    main()
