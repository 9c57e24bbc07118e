"""AE training lifecycle demo (DESIGN.md §8) on the port: drift-triggered
decoder refresh with honest Eq. 4–6 accounting.

A 4-client federation runs the paper's §5.2 weights-payload protocol under
per-client FC autoencoders. An :class:`AELifecycle` with a refresh cadence
plus a reconstruction-drift trigger:

1. buffers each client's encoded weight vectors (``ClientState.snapshots``),
2. warm-start refits the AEs — same-round refits share ONE
   ``train_autoencoder_cohort`` dispatch,
3. charges every decoder sync (initial ship + each refresh) to
   ``RoundRecord.bytes_down``/``bytes_decoder``,
4. reconciles the observed totals against the paper's savings-ratio model
   (``savings.reconcile``).

Run: PYTHONPATH=src python -m repro_torch.examples.ae_lifecycle_refresh
"""
from __future__ import annotations

import torch

from repro_torch.configs.paper import MNIST_CLASSIFIER, AEConfig
from repro_torch.core import (AELifecycle, FCAECompressor, FLConfig,
                              FederatedRun, SavingsModel, ae_param_count,
                              run_prepass)
from repro_torch.data.pipeline import (mnist_like, train_eval_split,
                                       uniform_partition)
from repro_torch.examples._common import Printer, parse, parser

N_CLIENTS = 4
AE_CFG = AEConfig(input_dim=15_910, encoder_hidden=(64,), latent_dim=32)
N_SAMPLES = 768
N_EVAL = 256
PREPASS_EPOCHS = 6
AE_EPOCHS = 40
ROUNDS = 7
REFRESH_EPOCHS = 20


def lifecycle_run(device, out: Printer, n_clients: int = N_CLIENTS,
                  rounds: int = ROUNDS, ae_epochs: int = AE_EPOCHS,
                  refresh_epochs: int = REFRESH_EPOCHS) -> dict:
    """Pre-pass AEs per client, the lifecycle run, its reconciliation."""
    train, ev = train_eval_split(mnist_like(0, N_SAMPLES), N_EVAL)
    data = uniform_partition(0, train, n_clients)

    # pre-pass: one weights dataset + AE per client (paper Fig. 2)
    comps = []
    for ci in range(n_clients):
        res = run_prepass(torch.Generator().manual_seed(10 + ci),
                          MNIST_CLASSIFIER, AE_CFG, data[ci],
                          prepass_epochs=PREPASS_EPOCHS, ae_epochs=ae_epochs,
                          device=device)
        comps.append(FCAECompressor(res["ae_params"], AE_CFG))

    lifecycle = AELifecycle(refresh_every=3, drift_ratio=2.0,
                            min_snapshots=2, refresh_epochs=refresh_epochs,
                            buffer_size=8)
    run = FederatedRun(
        MNIST_CLASSIFIER, data,
        FLConfig(n_rounds=rounds, local_epochs=1, payload="weights"),
        compressors=comps, eval_data=ev, lifecycle=lifecycle, device=device)
    hist = run.run()

    out("round  acc    bytes_up  bytes_down  decoder_share  ae_syncs")
    rows = []
    for r in hist:
        share = r.bytes_decoder / max(r.bytes_down, 1.0)
        out(f"{r.round:>5}  {r.global_metrics['accuracy']:.3f}  "
            f"{r.bytes_up:>8.0f}  {r.bytes_down:>10.0f}  "
            f"{share:>12.1%}  {r.ae_syncs}")
        rows.append({"round": r.round,
                     "accuracy": r.global_metrics["accuracy"],
                     "bytes_up": r.bytes_up, "bytes_down": r.bytes_down,
                     "bytes_decoder": r.bytes_decoder,
                     "ae_syncs": list(r.ae_syncs or [])})

    model = SavingsModel(
        original_size=15_910, compressed_size=AE_CFG.latent_dim,
        autoencoder_size=ae_param_count(comps[0].params),
        n_decoders=n_clients)
    report = run.savings_report(model)
    out("\nEq. 4-6 reconciliation (savings.reconcile):")
    for k, v in report.items():
        out(f"  {k:>26}: {v:,.4f}")
    assert report["decoder_rel_err"] < 0.05, report
    out("\nobserved decoder traffic reconciles with Eq. 5/6 "
        f"({report['decoder_syncs']:.0f} syncs, "
        f"{report['decoder_rel_err']:.1%} structural error)")
    return {"rounds": rows, "report": report}


def main(argv=None) -> dict:
    args = parse(parser(__doc__), argv)
    out = Printer()
    res = lifecycle_run(args.device, out)
    return dict(res, lines=out.lines)


if __name__ == "__main__":
    main()
