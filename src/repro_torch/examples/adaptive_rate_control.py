"""Adaptive rate control demo (DESIGN.md §9) on the port: per-client
dynamic codec selection on a distortion target, with honest rung-switch
accounting.

A 3-client federation runs the paper's §5.2 weights-payload protocol over a
two-rung FC-AE ladder (latent 32 → cheap, latent 128 → accurate). Each
client's rung AEs are pre-pass trained (paper Fig. 2, once per rung). A
:class:`DistortionTarget` controller then walks every client toward the
cheapest rung whose observed post-EF reconstruction error stays under the
target:

1. the post-EF encode distribution is buffered per client
   (``ClientState.snapshots``) and each round's rung error is measured on
   the newest snapshot,
2. rung switches are decided at end of round (effective next round, once
   the server has the new decoder), refitting the switched-to AE on the
   snapshot buffer through the lifecycle cohort path,
3. every decoder ship — initial rung ships and switch re-ships alike — is
   charged to ``RoundRecord.bytes_down``/``bytes_decoder``, so the Eq. 4–6
   reconciliation (``savings.reconcile``) stays honest under rung churn,
4. heterogeneous-rung cohorts are grouped by spec server-side and each
   group still takes the fused decode→aggregate path (DESIGN.md §9.2),
5. the same ladder then runs under the Lagrangian :class:`RDBudget`
   water-filler (DESIGN.md §15): distortion probed at every rung in one
   batched dispatch, curves hull-pruned, λ swept until marginal
   distortion per byte is equalized under the shared uplink budget.

The assertions are the JAX example's own. At these sizes neither package
walks the ladder (``ROADMAP.md`` Queue C item 4 traces why), so the run
stops at the ladder-walk assertion, as the reference does.

Run: PYTHONPATH=src python -m repro_torch.examples.adaptive_rate_control
"""
from __future__ import annotations

import torch

from repro_torch.configs.paper import MNIST_CLASSIFIER, AEConfig
from repro_torch.core import (DistortionTarget, FLConfig, FederatedRun,
                              RDBudget, SavingsModel, ae_param_count,
                              fc_ae_ladder, run_prepass, train_autoencoder)
from repro_torch.data.pipeline import (dirichlet_partition, mnist_like,
                                       train_eval_split)
from repro_torch.examples._common import Printer, parse, parser
from repro_torch.models.classifiers import init_classifier

N_CLIENTS = 3
P = 15_910                         # MNIST classifier param count
LATENTS = (32, 128)
# hidden ≥ widest latent, or the hidden layer caps every rung at the same
# effective capacity and rung fidelity stops ordering (DESIGN.md §15.6)
HIDDEN = (128,)
N_SAMPLES = 768
N_EVAL = 128
PREPASS_EPOCHS = 8
RUNG_EPOCHS = 200
ROUNDS = 6


def prefit_ladder(device, rung_epochs: int = RUNG_EPOCHS):
    """The data split and every client's rung AEs, each fitted on that
    client's pre-pass weights dataset (paper Fig. 2, per rung)."""
    train, ev = train_eval_split(mnist_like(0, N_SAMPLES), N_EVAL)
    data = dirichlet_partition(0, train, N_CLIENTS, alpha=1.0,
                               min_per_client=32)
    # the pre-pass starts from the SAME initial global params the
    # federated runs below init with (FLConfig.seed) — an AE trained on a
    # foreign init's trajectory prices a weight basin the run never visits
    # (DESIGN.md §15.6)
    init0 = init_classifier(torch.Generator().manual_seed(FLConfig().seed),
                            MNIST_CLASSIFIER, device)
    params = []
    for ci in range(N_CLIENTS):
        res = run_prepass(torch.Generator().manual_seed(10 + ci),
                          MNIST_CLASSIFIER,
                          AEConfig(input_dim=P, encoder_hidden=HIDDEN,
                                   latent_dim=LATENTS[0]),
                          data[ci], prepass_epochs=PREPASS_EPOCHS,
                          ae_epochs=1, init_params=init0, device=device)
        row = []
        for latent in LATENTS:
            cfg = AEConfig(input_dim=P, encoder_hidden=HIDDEN,
                           latent_dim=latent)
            p, _ = train_autoencoder(
                torch.Generator().manual_seed(100 + ci), cfg,
                res["weights_dataset"], epochs=rung_epochs)
            row.append(p)
        params.append(row)
    return data, ev, params


def rate_runs(device, out: Printer, rounds: int = ROUNDS,
              rung_epochs: int = RUNG_EPOCHS, table: dict = None) -> dict:
    """The distortion-target run, its reconcile, then the RDBudget run.
    What was printed so far is also written into ``table`` as it comes,
    so a caller sees the round table when an assertion stops the run."""
    table = {} if table is None else table
    data, ev, params = prefit_ladder(device, rung_epochs)
    ladder = fc_ae_ladder(N_CLIENTS, P, latent_dims=LATENTS, hidden=HIDDEN,
                          params=params, device=device)
    rc = DistortionTarget(ladder=ladder, target=0.10, margin=0.5,
                          cooldown=2, min_snapshots=2, refit_epochs=30,
                          refit_batch=4)
    run = FederatedRun(
        MNIST_CLASSIFIER, data,
        FLConfig(n_rounds=rounds, local_epochs=2, payload="weights"),
        eval_data=ev, ratecontrol=rc, device=device)
    hist = run.run()

    out("round  acc    bytes_up  bytes_decoder  switches       rungs")
    table["rounds"] = []
    for r in hist:
        rungs = [rc.rung_of(ci) for ci in range(N_CLIENTS)]
        out(f"{r.round:>5}  {r.global_metrics['accuracy']:.3f}  "
            f"{r.bytes_up:>8.0f}  {r.bytes_decoder:>13.0f}  "
            f"{str(r.spec_switches):>12}  {rungs}")
        table["rounds"].append({
            "round": r.round, "accuracy": r.global_metrics["accuracy"],
            "bytes_up": r.bytes_up, "bytes_decoder": r.bytes_decoder,
            "spec_switches": r.spec_switches, "rungs": rungs})
    assert all(r.controller == "distortion_target" for r in hist)
    assert any(r.spec_switches for r in hist), \
        "the demo should actually walk the ladder"

    # Eq. 4-6 reconciliation, rung-switch decoder re-ships included: the
    # ladder shares its hidden stack, so the per-rung decoder sizes sit
    # within the documented structural gap of the Eq. 6 idealization
    mean_ae = sum(ae_param_count(ladder[0][k].params)
                  for k in range(len(LATENTS))) // len(LATENTS)
    model = SavingsModel(
        original_size=P, compressed_size=LATENTS[0],
        autoencoder_size=mean_ae, n_decoders=N_CLIENTS)
    report = run.savings_report(model)
    out("\nEq. 4-6 reconciliation (savings.reconcile):")
    for k, v in report.items():
        out(f"  {k:>26}: {v:,.4f}")
    assert report["decoder_rel_err"] < 0.05, report
    out(f"\n{report['decoder_syncs']:.0f} decoder ships (initial + rung "
        f"switches) reconcile with Eq. 5/6 at "
        f"{report['decoder_rel_err']:.1%} error")
    table["report"] = report

    # --- the same ladder under Lagrangian water-filling (DESIGN.md §15)
    # budget: the all-cheapest floor plus one rung upgrade's worth of
    # marginal uplink — the λ sweep decides WHICH client converts that
    # headroom into the most distortion reduction per byte
    budget = N_CLIENTS * LATENTS[0] * 4.0 + (LATENTS[1] - LATENTS[0]) * 4.0
    rd = RDBudget(ladder=fc_ae_ladder(N_CLIENTS, P, latent_dims=LATENTS,
                                      hidden=HIDDEN, params=params,
                                      device=device),
                  budget=budget, cooldown=2, min_snapshots=2,
                  refit_epochs=30, refit_batch=4)
    run_rd = FederatedRun(
        MNIST_CLASSIFIER, data,
        FLConfig(n_rounds=rounds, local_epochs=2, payload="weights"),
        eval_data=ev, ratecontrol=rd, device=device)
    hist_rd = run_rd.run()
    lam = dict(rd.lambda_trace)
    out(f"\nRDBudget at {budget:.0f} B/round shared uplink budget:")
    out("round  acc    bytes_up   lambda*        rungs")
    table["rd_rounds"] = []
    for r in hist_rd:
        lam_s = f"{lam[r.round]:.3e}" if lam.get(r.round) else "-"
        rungs = [rd.rung_of(ci) for ci in range(N_CLIENTS)]
        out(f"{r.round:>5}  {r.global_metrics['accuracy']:.3f}  "
            f"{r.bytes_up:>8.0f}  {lam_s:>9}  {rungs}")
        table["rd_rounds"].append({
            "round": r.round, "accuracy": r.global_metrics["accuracy"],
            "bytes_up": r.bytes_up, "lambda": lam.get(r.round),
            "rungs": rungs})
    assert all(r.controller == "rd_budget" for r in hist_rd)
    # the plan binds the full sync cohort, so realized per-round uplink
    # never exceeds the budget
    assert all(r.bytes_up <= budget for r in hist_rd), \
        [(r.round, r.bytes_up) for r in hist_rd]
    assert len(rd.lambda_trace) == len(hist_rd)
    return table


def main(argv=None, table: dict = None) -> dict:
    """``table`` (optional) receives the round tables as they are printed,
    so a caller can read them when an assertion stops the run."""
    args = parse(parser(__doc__), argv)
    out = Printer()
    res = rate_runs(args.device, out, table=table)
    return dict(res, lines=out.lines)


if __name__ == "__main__":
    main()
