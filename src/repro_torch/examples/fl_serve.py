"""Streaming FL ingest demo (DESIGN.md §12.3) on the port: the
million-client serving pipeline.

A population of N clients streams encoded weight updates at the server; the
first-K buffer fires one step — device-side first-K pop (``pop_k_device``),
synthetic encoded cohort, fused decode→aggregate (the q8 and q4 codecs
dequantize on the blockwise dequantize kernel), staleness-weighted model
update, re-dispatch of exactly the drained cohort — and the loop reports
sustained rounds/sec and ingested uplink bytes/sec on the host clock.

This is FL *serving* throughput. The LLM token-serving demo is
``repro_torch.examples.llm_serve_decode``.

Run: PYTHONPATH=src python -m repro_torch.examples.fl_serve
     PYTHONPATH=src python -m repro_torch.examples.fl_serve \\
         --n-clients 1000000 --buffer-k 4096 --spec topk
"""
from __future__ import annotations

import contextlib

from repro_torch.core import codec
from repro_torch.core.serve import ServeConfig, round_bytes, run_serve
from repro_torch.examples._common import Printer, one_rank_group, parse, \
    parser

WARMUP = 2


def make_spec(kind: str, size: int):
    return {
        "q8": lambda: codec.QuantizeSpec(size=size, bits=8, block=256),
        "q4": lambda: codec.QuantizeSpec(size=size, bits=4, block=256),
        "topk": lambda: codec.TopKSpec(size=size, k=max(size // 64, 1)),
        "identity": lambda: codec.IdentitySpec(size=size),
    }[kind]()


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--n-clients", type=int, default=100_000)
    ap.add_argument("--buffer-k", type=int, default=256)
    ap.add_argument("--model-size", type=int, default=4096)
    ap.add_argument("--spec", default="q8",
                    choices=["q8", "q4", "topk", "identity"])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--straggler-frac", type=float, default=0.05)
    ap.add_argument("--shard", action="store_true",
                    help="split the cohort axis over a process group")
    args = parse(ap, argv)
    out = Printer()

    spec = make_spec(args.spec, args.model_size)
    cfg = ServeConfig(n_clients=args.n_clients, buffer_k=args.buffer_k,
                      spec=spec, jitter=0.4,
                      straggler_frac=args.straggler_frac, seed=0,
                      shard=args.shard)
    rb = round_bytes(cfg)
    out(f"population N={args.n_clients}  cohort K={args.buffer_k}  "
        f"codec={args.spec}({args.model_size})  "
        f"round uplink={rb / 1e6:.2f} MB")

    group = (one_rank_group(args.device) if args.shard
             else contextlib.nullcontext())
    with group:
        state, rep = run_serve(cfg, n_rounds=args.rounds, warmup=WARMUP,
                               device=args.device)
        version = int(state["version"])
    out(f"sustained: {rep['rounds_per_sec']:.2f} rounds/s  "
        f"{rep['bytes_per_sec'] / 1e6:.2f} MB/s ingested  "
        f"({rep['us_per_round'] / 1e3:.2f} ms/round)")
    out(f"model version {version}, "
        f"sim clock {rep['sim_time']:.1f}s simulated "
        f"({version * args.buffer_k} updates aggregated)")
    return {"round_bytes": rb, "version": version,
            "updates": version * args.buffer_k, "throughput": rep,
            "global_flat": state["global_flat"].cpu(), "lines": out.lines}


if __name__ == "__main__":
    main()
