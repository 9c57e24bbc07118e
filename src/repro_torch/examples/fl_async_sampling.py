"""Scalable federated runtime demo on the port: client sampling + async
aggregation.

Runs the same 16-client non-IID federation under all three round schedulers
(DESIGN.md §6) with int8-quantized updates (the blockwise quantize and
dequantize kernels on the card) and compares accuracy against
communication cost:

1. SyncFedAvg     — every client every round (the seed/paper baseline),
2. SampledSync    — a 4-of-16 cohort per round, vmap-batched local training,
3. AsyncBuffered  — FedBuff-style K=4 buffer over a latency model where a
   25% straggler tail is 8x slower; staleness-weighted aggregation keeps
   the fast clients from waiting on the slow ones.

Every RoundRecord carries up/down byte accounting and the compression
ratio; async records add participant staleness and the simulated clock.

Run: PYTHONPATH=src python -m repro_torch.examples.fl_async_sampling
"""
from __future__ import annotations

from repro_torch.configs.paper import MNIST_CLASSIFIER, SMOKE_SCALE_SCENARIO
from repro_torch.core import (AsyncBuffered, FLConfig, FederatedRun,
                              LatencyModel, QuantizeCompressor, SampledSync,
                              SyncFedAvg)
from repro_torch.data.pipeline import (mnist_like, train_eval_split,
                                       uniform_partition)
from repro_torch.examples._common import Printer, parse, parser

N_SAMPLES = 2048
N_EVAL = 256


def record_row(rec) -> dict:
    """A round record's printed fields."""
    return {"round": rec.round,
            "accuracy": rec.global_metrics["accuracy"],
            "bytes_up": rec.bytes_up, "bytes_down": rec.bytes_down,
            "compression_ratio": rec.compression_ratio,
            "participants": list(rec.participants),
            "staleness": (None if rec.staleness is None
                          else list(rec.staleness)),
            "sim_time": rec.sim_time}


def run_one(name, scheduler, data, eval_data, cfg, device, out: Printer
            ) -> dict:
    run = FederatedRun(
        MNIST_CLASSIFIER, data, cfg,
        compressors=[QuantizeCompressor(bits=8) for _ in range(len(data))],
        eval_data=eval_data, scheduler=scheduler, device=device)
    hist = run.run()
    tot = run.total_bytes()
    out(f"\n== {name} ==")
    for rec in hist:
        extra = ""
        if rec.staleness is not None:
            extra = (f"  staleness={rec.staleness}"
                     f"  t={rec.sim_time:.2f}")
        out(f"round {rec.round}: acc={rec.global_metrics['accuracy']:.3f}"
            f"  up={rec.bytes_up / 1e3:.0f}kB"
            f"  down={rec.bytes_down / 1e3:.0f}kB"
            f"  ratio={rec.compression_ratio:.1f}x"
            f"  cohort={rec.participants}{extra}")
    out(f"totals: up={tot['bytes_up'] / 1e3:.0f}kB "
        f"down={tot['bytes_down'] / 1e3:.0f}kB "
        f"effective_ratio={tot['effective_ratio']:.1f}x")
    return {"name": name, "rounds": [record_row(r) for r in hist],
            "totals": tot}


def schedulers(device, out: Printer, sc=SMOKE_SCALE_SCENARIO) -> dict:
    """The federation at scenario ``sc`` under the three schedulers."""
    out(f"scenario: {sc.n_clients} clients, cohort {sc.cohort}, "
        f"buffer K={sc.buffer_k}, {sc.rounds} rounds, "
        f"{sc.straggler_frac:.0%} stragglers {sc.straggler_mult:.0f}x slow")
    # equal-sized shards: the homogeneous layout the vmap cohort path needs
    train, eval_data = train_eval_split(mnist_like(0, N_SAMPLES), N_EVAL)
    data = uniform_partition(0, train, sc.n_clients)
    cfg = FLConfig(n_rounds=sc.rounds, local_epochs=sc.local_epochs,
                   lr=2e-3, payload="update")

    runs = [run_one("SyncFedAvg (all 16 every round)",
                    SyncFedAvg(), data, eval_data, cfg, device, out)]
    sampled = SampledSync(cohort=sc.cohort)
    runs.append(run_one(
        f"SampledSync ({sc.cohort}-of-{sc.n_clients}, vmap cohort)",
        sampled, data, eval_data, cfg, device, out))
    out(f"(vmap fast path took {sampled.vmap_rounds}/"
        f"{sampled.vmap_rounds + sampled.loop_rounds} rounds)")
    runs.append(run_one(
        f"AsyncBuffered (K={sc.buffer_k}, straggler tail)",
        AsyncBuffered(
            buffer_k=sc.buffer_k,
            latency=LatencyModel(base=sc.base_latency,
                                 jitter=sc.latency_jitter,
                                 straggler_frac=sc.straggler_frac,
                                 straggler_mult=sc.straggler_mult)),
        data, eval_data, cfg, device, out))
    return {"runs": runs, "vmap_rounds": sampled.vmap_rounds,
            "loop_rounds": sampled.loop_rounds}


def main(argv=None) -> dict:
    args = parse(parser(__doc__), argv)
    out = Printer()
    res = schedulers(args.device, out)
    return dict(res, lines=out.lines)


if __name__ == "__main__":
    main()
