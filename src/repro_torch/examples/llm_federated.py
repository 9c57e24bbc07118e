"""Federated delta fine-tuning of a real ``configs/`` transformer through
the port's full ``FederatedRun`` stack (DESIGN.md §14) — the paper's "one
AE per layer" claim exercised at transformer shapes instead of toy MLPs.

A small federation fine-tunes a reduced zoo model (default ``llama3-8b``)
with ``LMDeltaTask``: each client trains on its own token shard and ships
the post-error-feedback weight *delta* through the codec stack. Three
scenarios build the accuracy-vs-uplink table:

* ``identity`` — uncompressed deltas (the accuracy ceiling),
* ``q8``       — flat int8 quantization (the blockwise quantize and
  dequantize kernels on the card),
* ``role-ae``  — ``by_role_partition``: the bulk roles (embedding /
  attention / MLP) each ride a per-client chunked AE on the grouped
  decode→aggregate kernel (``FLConfig(use_grouped_kernel=True)``), the
  tiny norm vectors ride int8; the ``AELifecycle`` ships and refits each
  ``(client, role)`` decoder lane and every ship is reconciled against
  the paper's Eq. 4-6 within the documented ~1% structural gap.

Run: PYTHONPATH=src python -m repro_torch.examples.llm_federated \\
         [--arch llama3-8b]
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core import (AELifecycle, ChunkedAECompressor,
                              ChunkedAEConfig, FLConfig, FederatedRun,
                              IdentityCompressor, LMDeltaTask,
                              PartitionedCompressor, QuantizeCompressor,
                              SavingsModel, ae_param_count,
                              by_role_partition, init_chunked_ae, partition,
                              train_autoencoder, wire_bytes_by_group)
from repro_torch.core import autoencoder as ae_lib
from repro_torch.core.pytree import ravel
from repro_torch.data.pipeline import synthetic_lm_batch
from repro_torch.examples._common import Printer, parse, parser

AE_ROLES = ("embedding", "attention", "mlp")
SCENARIOS = ("identity", "q8", "role-ae")
PREPASS_EPOCHS = 40
REFRESH_EPOCHS = 20


def prepass_role_aes(args, cfg, pmap, ae_cfg, shards, fl, device,
                     epochs: int = PREPASS_EPOCHS,
                     fit_rows: Optional[int] = None):
    """The paper's pre-pass (§5.2) at transformer shapes: each client runs
    one local round from the shared init, and each AE role's chunked delta
    rows become that client's AE training set — so the codecs meet the
    actual delta distribution from round 0 instead of a random init.
    ``fit_rows`` fits on the first rows of each role only (``None``: all
    of them, as the reference)."""
    task = LMDeltaTask(cfg)
    global_params = task.init_params(torch.Generator().manual_seed(fl.seed),
                                     device)
    flat0 = ravel(global_params)[0]
    aes = []
    for ci in range(args.clients):
        local, _ = task.local_update(global_params, shards[ci], fl,
                                     seed=fl.seed * 997, anchor=global_params)
        delta = ravel(local)[0] - flat0
        del local
        fit = {}
        for role in AE_ROLES:
            seg = partition.gather(pmap.slices_of(role), delta)
            rows = ae_lib.chunk_vector(seg, ae_cfg.chunk_size)[0]
            if fit_rows is not None:
                rows = rows[:fit_rows]
            params, _ = train_autoencoder(
                torch.Generator().manual_seed(100 + ci), ae_cfg.as_fc(),
                rows, kind="fc", epochs=epochs, batch_size=64, lr=3e-3,
                init=init_chunked_ae(torch.Generator().manual_seed(100 + ci),
                                     ae_cfg, device))
            fit[role] = params
        aes.append(fit)
    return aes


def make_run(args, cfg, scenario, pmap, ae_cfg, device,
             prepass_epochs: int = PREPASS_EPOCHS,
             fit_rows: Optional[int] = None,
             refresh_epochs: int = REFRESH_EPOCHS):
    task = LMDeltaTask(cfg)
    shards = [{k: v.to(device) for k, v in synthetic_lm_batch(
        seed=10 + ci, vocab_size=cfg.vocab_size, batch=args.seqs,
        seq_len=args.seq).items()} for ci in range(args.clients)]
    ev = synthetic_lm_batch(seed=99, vocab_size=cfg.vocab_size,
                            batch=args.seqs, seq_len=args.seq)
    # error feedback is what makes lossy delta codecs converge here: adam
    # deltas are near-white per coordinate, so a single AE pass loses most
    # of the signal — the residual carries it into the next round instead
    # of dropping it (role-ae descends monotonically; without EF it stalls)
    fl = FLConfig(n_rounds=args.rounds, local_epochs=args.local_epochs,
                  lr=1e-3, batch_size=args.batch,
                  payload="update", error_feedback=True, seed=0,
                  use_grouped_kernel=(scenario == "role-ae"))
    lifecycle = None
    if scenario == "identity":
        comps = [IdentityCompressor() for _ in range(args.clients)]
    elif scenario == "q8":
        comps = [QuantizeCompressor(bits=8) for _ in range(args.clients)]
    else:                                    # role-ae
        aes = prepass_role_aes(args, cfg, pmap, ae_cfg, shards, fl, device,
                               prepass_epochs, fit_rows)
        comps = [PartitionedCompressor(pmap, dict(
            {role: ChunkedAECompressor(aes[ci][role], ae_cfg,
                                       use_kernel=True)
             for role in AE_ROLES},
            norm=QuantizeCompressor(bits=8))) for ci in range(args.clients)]
        lifecycle = AELifecycle(refresh_every=2, min_snapshots=2,
                                refresh_epochs=refresh_epochs, batch_size=32,
                                lr=3e-3)
    return FederatedRun(task, shards, fl, compressors=comps, eval_data=ev,
                        lifecycle=lifecycle, device=device), comps


def federate(args, cfg, out: Printer,
             prepass_epochs: int = PREPASS_EPOCHS,
             fit_rows: Optional[int] = None,
             refresh_epochs: int = REFRESH_EPOCHS) -> dict:
    """The three scenarios on ``cfg`` (the reference: ``get_config(arch)
    .reduced()``) and the accuracy-vs-uplink table."""
    device = args.device
    ae_cfg = ChunkedAEConfig(chunk_size=256, hidden=(64,), latent_chunk=8)
    template = LMDeltaTask(cfg).init_params(
        torch.Generator().manual_seed(0), "meta")
    pmap = by_role_partition(template)
    n_params = pmap.size
    groups = {n: pmap.group_size(n) for n in pmap.names}
    out(f"== federated {cfg.name}: {n_params:,} params, "
        f"{args.clients} clients x {args.rounds} rounds ==")
    out(f"role partition: {groups}")

    table, res = [], {"params": n_params, "groups": groups, "runs": {}}
    for scenario in SCENARIOS:
        run, comps = make_run(args, cfg, scenario, pmap, ae_cfg, device,
                              prepass_epochs, fit_rows, refresh_epochs)
        if scenario == "role-ae":
            prices = wire_bytes_by_group(comps[0].spec(pmap.size),
                                         comps[0].codec_params())
            out(f"\n[{scenario}] per-role uplink bytes: {prices}")
            res["prices"] = dict(prices)
        hist = run.run()
        rows = []
        for r in hist:
            out(f"[{scenario}] round {r.round}: "
                f"loss={r.global_metrics['ce_loss']:.4f} "
                f"acc={r.global_metrics['accuracy']:.3f} "
                f"up={r.bytes_up / 1e3:.1f}kB (x{r.compression_ratio:.1f})"
                + (f" decoder={r.bytes_decoder / 1e6:.2f}MB"
                   if r.bytes_decoder else ""))
            rows.append({"round": r.round,
                         "ce_loss": r.global_metrics["ce_loss"],
                         "accuracy": r.global_metrics["accuracy"],
                         "bytes_up": r.bytes_up,
                         "compression_ratio": r.compression_ratio,
                         "bytes_decoder": r.bytes_decoder,
                         "ae_syncs": list(r.ae_syncs or [])})
        tot = run.total_bytes()
        last = hist[-1]
        table.append((scenario, last.global_metrics["ce_loss"],
                      last.global_metrics["accuracy"], tot["bytes_up"],
                      tot["effective_ratio"], tot["bytes_decoder"]))
        res["runs"][scenario] = {"rounds": rows, "totals": tot}

        if scenario == "role-ae":
            # Eq. 4-6 reconciliation: each AE role's decoder ships priced
            # by its own SavingsModel; the chunked AE is shared-weights so
            # every role carries the same 256->8 autoencoder
            ae_size = ae_param_count(init_chunked_ae(
                torch.Generator().manual_seed(0), ae_cfg, "meta"))
            models = {}
            for name in pmap.names:
                gs = pmap.group_size(name)
                if name in AE_ROLES:
                    n_chunks = -(-gs // ae_cfg.chunk_size)
                    models[name] = SavingsModel(
                        original_size=gs,
                        compressed_size=n_chunks * ae_cfg.latent_chunk,
                        autoencoder_size=ae_size, n_decoders=args.clients)
                else:
                    models[name] = SavingsModel(
                        original_size=gs, compressed_size=gs // 4,
                        autoencoder_size=0, n_decoders=0)
            report = run.savings_report(models)
            out("Eq. 4-6 reconciliation (per-role decoder ships):")
            for k, v in report.items():
                out(f"  {k}: {v:.4g}")
            res["report"] = report
            assert report["decoder_rel_err"] < 0.01, \
                "structural gap bound blown"
        del run, comps

    out("\naccuracy vs uplink:")
    out(f"{'scenario':<10} {'ce_loss':>8} {'acc':>6} {'up_MB':>8} "
        f"{'ratio':>7} {'decoder_MB':>11}")
    for name, loss, acc, up, ratio, dec in table:
        out(f"{name:<10} {loss:>8.4f} {acc:>6.3f} {up / 1e6:>8.3f} "
            f"{ratio:>7.1f} {dec / 1e6:>11.2f}")
    return res


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--seqs", type=int, default=8, help="sequences/client")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--local-epochs", type=int, default=3)
    args = parse(ap, argv)
    out = Printer()
    res = federate(args, get_config(args.arch).reduced(), out)
    return dict(res, lines=out.lines)


if __name__ == "__main__":
    main()
