"""Per-layer codec partitions demo (DESIGN.md §10) on the port: one codec
per model layer, grouped fused aggregation, per-partition decoder
accounting.

A 3-client federation on the paper's MNIST MLP, partitioned by layer:
``dense0`` (15,700 params — the bulk) rides a per-client FC autoencoder,
``dense1`` (the 210-param head, where reconstruction error hurts logits
directly) rides int8 quantization (the blockwise quantize and dequantize
kernels on the card). The run shows:

1. the per-partition wire price list (``wire_bytes_by_group``) and the
   mixed compression ratio on the wire,
2. the AE lifecycle shipping/refreshing ONLY the AE-backed group's decoder
   (``ae_syncs`` entries are ``(client, group)`` lanes),
3. ``savings.reconcile`` with a ``{group: SavingsModel}`` mapping — the
   Eq. 5 Cost term summed per partition's own decoder ships.

The per-client AEs start at a random init (no pre-pass, to keep the demo
fast), so early rounds sit near chance until the cadence refit at round 3
fits the decoders to the real weights distribution.

Run: PYTHONPATH=src python -m repro_torch.examples.per_layer_partitions
"""
from __future__ import annotations

import torch

from repro_torch.configs.paper import MNIST_CLASSIFIER, AEConfig
from repro_torch.core import (AELifecycle, FCAECompressor, FLConfig,
                              FederatedRun, PartitionedCompressor,
                              QuantizeCompressor, SavingsModel,
                              by_layer_partition, wire_bytes_by_group)
from repro_torch.core import autoencoder as ae
from repro_torch.data.pipeline import (mnist_like, train_eval_split,
                                       uniform_partition)
from repro_torch.examples._common import Printer, parse, parser
from repro_torch.models.classifiers import init_classifier

N_CLIENTS = 3
N_SAMPLES = 768
N_EVAL = 256
ROUNDS = 6
REFRESH_EPOCHS = 150


def partitioned_run(device, out: Printer, n_clients: int = N_CLIENTS,
                    rounds: int = ROUNDS,
                    refresh_epochs: int = REFRESH_EPOCHS) -> dict:
    """The layer-partitioned federation and its per-group reconcile."""
    template = init_classifier(torch.Generator().manual_seed(0),
                               MNIST_CLASSIFIER, device)
    pmap = by_layer_partition(template)
    d0 = pmap.group_size("dense0")
    ae_cfg = AEConfig(input_dim=d0, encoder_hidden=(64,), latent_dim=32)
    groups = {n: pmap.group_size(n) for n in pmap.names}
    out(f"partition groups: {groups}")

    train, ev = train_eval_split(mnist_like(0, N_SAMPLES), N_EVAL)
    data = uniform_partition(0, train, n_clients)
    comps = [PartitionedCompressor(pmap, {
        "dense0": FCAECompressor(
            ae.init_fc_ae(torch.Generator().manual_seed(10 + ci), ae_cfg,
                          device), ae_cfg),
        "dense1": QuantizeCompressor(bits=8),
    }) for ci in range(n_clients)]
    prices = wire_bytes_by_group(comps[0].spec(pmap.size),
                                 comps[0].codec_params())
    out(f"per-partition uplink bytes: {prices} "
        f"(raw: { {n: 4 * pmap.group_size(n) for n in pmap.names} })")

    run = FederatedRun(
        MNIST_CLASSIFIER, data,
        FLConfig(n_rounds=rounds, local_epochs=2, payload="weights"),
        compressors=comps, eval_data=ev,
        lifecycle=AELifecycle(refresh_every=3, min_snapshots=2,
                              refresh_epochs=refresh_epochs, batch_size=4),
        device=device)
    hist = run.run()
    rows = []
    for r in hist:
        out(f"round {r.round}: acc={r.global_metrics['accuracy']:.3f} "
            f"up={r.bytes_up / 1e3:.1f}kB (x{r.compression_ratio:.0f}) "
            f"decoder={r.bytes_decoder / 1e6:.2f}MB syncs={r.ae_syncs}")
        rows.append({"round": r.round,
                     "accuracy": r.global_metrics["accuracy"],
                     "bytes_up": r.bytes_up,
                     "compression_ratio": r.compression_ratio,
                     "bytes_decoder": r.bytes_decoder,
                     "ae_syncs": list(r.ae_syncs or [])})

    models = {
        "dense0": SavingsModel(
            original_size=d0, compressed_size=ae_cfg.latent_dim,
            autoencoder_size=ae_cfg.n_params, n_decoders=n_clients),
        "dense1": SavingsModel(
            original_size=pmap.group_size("dense1"),
            compressed_size=pmap.group_size("dense1") // 4,  # int8 + scales
            autoencoder_size=0, n_decoders=0),
    }
    report = run.savings_report(models)
    out("Eq. 4-6 reconciliation (per-partition decoder ships):")
    for k, v in report.items():
        out(f"  {k}: {v:.4g}")
    assert report["decoder_rel_err"] < 0.01, "structural gap bound blown"
    return {"groups": groups, "prices": dict(prices), "rounds": rows,
            "report": report}


def main(argv=None) -> dict:
    args = parse(parser(__doc__), argv)
    out = Printer()
    res = partitioned_run(args.device, out)
    return dict(res, lines=out.lines)


if __name__ == "__main__":
    main()
