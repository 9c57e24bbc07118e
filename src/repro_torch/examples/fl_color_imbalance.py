"""Paper §5.2 (Figs. 8/9) on the port: two-collaborator FL with color
imbalance.

Collaborator 0 trains on color images, collaborator 1 on grayscale. Updates
are AE-compressed every communication round; the sawtooth accuracy/loss
pattern (dip after each aggregation) shows federation is really happening
while the pipe carries only latents.

``--stacks`` runs the composable-codec-stack comparison instead
(DESIGN.md §13): q8 vs topk→q8 vs topk→AE→q8 on a Dirichlet label-skew
split, printing an accuracy-vs-uplink table — the FedZip-direction
sparsify-then-compress stacks trade accuracy for steep uplink cuts. On the
card the stacks run the blockwise quantize and dequantize kernels, and the
chunked AE the ``fused_dense`` and fused decode→aggregate kernels.

Run: PYTHONPATH=src python -m repro_torch.examples.fl_color_imbalance \\
         [--rounds N]
     PYTHONPATH=src python -m repro_torch.examples.fl_color_imbalance \\
         --stacks
"""
from __future__ import annotations

import torch

from repro_torch.configs.paper import CIFAR_CLASSIFIER, cifar_ae_for
from repro_torch.core import (ChainCompressor, ChunkedAECompressor,
                              ChunkedAEConfig, FCAECompressor, FLConfig,
                              FederatedRun, QuantizeCompressor,
                              TopKCompressor, init_chunked_ae, run_prepass)
from repro_torch.core.pytree import ravel
from repro_torch.data.pipeline import (cifar_like, color_imbalance_split,
                                       dirichlet_partition, train_eval_split)
from repro_torch.examples._common import Printer, parse, parser
from repro_torch.models.classifiers import init_classifier

STACK_CLIENTS = 4
PREPASS_EPOCHS = 5
AE_EPOCHS = 6


def classifier_size(clf_cfg=CIFAR_CLASSIFIER) -> int:
    return int(ravel(init_classifier(torch.Generator().manual_seed(0),
                                     clf_cfg, "cpu"))[0].numel())


def run_stacks(args, out: Printer, n_clients: int = STACK_CLIENTS) -> dict:
    """Codec-stack comparison on a Dirichlet non-IID split: the same
    federation under three uplink codecs — blockwise q8, FedZip-style
    topk→q8, and the paper-direction topk→AE→q8 chain."""
    train, eval_data = train_eval_split(
        cifar_like(0, args.n * n_clients), max(32, args.n // 2))
    datasets = dirichlet_partition(0, train, n_clients, alpha=0.5,
                                   min_per_client=8)
    P = classifier_size()
    ccfg = ChunkedAEConfig(chunk_size=256, hidden=(64,), latent_chunk=16)
    ae_params = init_chunked_ae(torch.Generator().manual_seed(1), ccfg,
                                args.device)
    out(f"== codec stacks on Dirichlet(0.5) split, {n_clients} clients, "
        f"CIFAR-CNN {P} params ==")

    def stacks():
        return {
            "q8": lambda: QuantizeCompressor(bits=8),
            "topk->q8": lambda: ChainCompressor(
                [TopKCompressor(fraction=0.1),
                 QuantizeCompressor(bits=8, block=64)]),
            "topk->ae->q8": lambda: ChainCompressor(
                [TopKCompressor(fraction=0.05),
                 ChunkedAECompressor(ae_params, ccfg),
                 QuantizeCompressor(bits=8, block=64)]),
        }

    rows = []
    for name, mk in stacks().items():
        run = FederatedRun(
            CIFAR_CLASSIFIER, datasets,
            FLConfig(n_rounds=args.rounds, local_epochs=args.local_epochs,
                     payload="update", error_feedback=True),
            compressors=[mk() for _ in range(n_clients)],
            eval_data=eval_data, device=args.device)
        hist = run.run()
        totals = run.total_bytes()
        rows.append((name, hist[-1].global_metrics["accuracy"],
                     totals["bytes_up"], totals["effective_ratio"]))

    out(f"\n{'stack':>14} {'final_acc':>10} {'uplink_bytes':>13} "
        f"{'ratio':>7}")
    for name, acc, up, ratio in rows:
        out(f"{name:>14} {acc:>10.3f} {up:>13.3e} {ratio:>6.0f}x")
    return {"params": P, "stacks": [
        {"name": n, "accuracy": a, "bytes_up": u, "effective_ratio": r}
        for n, a, u, r in rows]}


def run_federation(args, out: Printer, clf_cfg=CIFAR_CLASSIFIER) -> dict:
    """The §5.2 federation: each collaborator's pre-pass and FC AE, then
    the weights-payload run. ``clf_cfg`` defaults to the paper's CIFAR
    CNN, whose FC AE is 550,586 → 320."""
    P = classifier_size(clf_cfg)
    ae_cfg = cifar_ae_for(P)
    out(f"== 2-collaborator FL, CIFAR-CNN {P} params, "
        f"AE {ae_cfg.n_params} params, {ae_cfg.compression_ratio:.0f}x ==")

    datasets, eval_data = color_imbalance_split(0, args.n)
    comps = []
    for ci, d in enumerate(datasets):
        kind = "color" if ci == 0 else "grayscale"
        out(f"pre-pass for collaborator {ci} ({kind}) ...")
        res = run_prepass(torch.Generator().manual_seed(10 + ci), clf_cfg,
                          ae_cfg, d, prepass_epochs=PREPASS_EPOCHS,
                          ae_epochs=AE_EPOCHS, device=args.device)
        comps.append(FCAECompressor(res["ae_params"], ae_cfg))
        del res

    run = FederatedRun(
        clf_cfg, datasets,
        FLConfig(n_rounds=args.rounds, local_epochs=args.local_epochs,
                 payload="weights"),    # paper §5.2: converged weights
        compressors=comps, eval_data=eval_data, device=args.device)
    rows = []

    def progress(rec):
        cacc = [m.get("accuracy", 0.0) for m in rec.collab_metrics]
        out(f"round {rec.round:3d}: global_acc="
            f"{rec.global_metrics['accuracy']:.3f} "
            f"collab_acc={[f'{a:.3f}' for a in cacc]} "
            f"ratio={rec.compression_ratio:.0f}x")
        rows.append({"round": rec.round,
                     "accuracy": rec.global_metrics["accuracy"],
                     "collab_accuracy": cacc,
                     "bytes_up": rec.bytes_up,
                     "compression_ratio": rec.compression_ratio})

    run.run(progress)
    totals = run.total_bytes()
    out(f"total upstream bytes: {totals['bytes_up']:.2e} "
        f"(raw {totals['bytes_up_raw']:.2e}) -> effective "
        f"{totals['effective_ratio']:.0f}x reduction")
    return {"params": P, "ae_params": ae_cfg.n_params, "rounds": rows,
            "totals": totals}


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--n", type=int, default=256, help="samples/collab")
    ap.add_argument("--stacks", action="store_true",
                    help="codec-stack comparison on a Dirichlet split")
    args = parse(ap, argv)
    out = Printer()
    res = (run_stacks if args.stacks else run_federation)(args, out)
    return dict(res, lines=out.lines)


if __name__ == "__main__":
    main()
