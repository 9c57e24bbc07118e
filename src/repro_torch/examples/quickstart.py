"""Quickstart: the paper's full pipeline through the port.

1. Pre-pass round (Fig. 2): train the MNIST classifier locally, log weights
   at every epoch, train the fully-connected funnel AE on that dataset.
2. Compress the model's weight update through the encoder (Eq. 1), "ship"
   the 32-float latent, reconstruct at the aggregator (Eq. 2).
3. Validation model (§5.1): accuracy with AE-predicted weights vs original.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch.configs.paper import MNIST_AE, MNIST_CLASSIFIER
from repro_torch.core import (FCAECompressor, fc_reconstruct, run_prepass,
                              validation_model_curve)
from repro_torch.data.pipeline import mnist_like
from repro_torch.examples._common import Printer, parse, parser

N_SAMPLES = 768
PREPASS_EPOCHS = 10
AE_EPOCHS = 80


def pipeline(device, out: Printer, n: int = N_SAMPLES,
             prepass_epochs: int = PREPASS_EPOCHS,
             ae_epochs: int = AE_EPOCHS) -> dict:
    """Pre-pass, AE round trip and validation model on ``device``."""
    out("== FedAE quickstart: MNIST classifier, 15,910 params ==")
    data = mnist_like(seed=0, n=n)
    res = run_prepass(torch.Generator().manual_seed(0), MNIST_CLASSIFIER,
                      MNIST_AE, data, prepass_epochs=prepass_epochs,
                      ae_epochs=ae_epochs, device=device)
    hist = res["ae_history"]
    out(f"pre-pass: {res['weights_dataset'].shape[0]} weight snapshots, "
        f"AE loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f}, "
        f"AE accuracy {hist['accuracy'][-1]:.3f} "
        f"(val {hist['val_accuracy'][-1]:.3f})")

    comp = FCAECompressor(res["ae_params"], MNIST_AE)
    _, stats = comp.roundtrip(res["model_params"])
    out(f"compression: {stats['original_bytes']:.0f} B -> "
        f"{stats['compressed_bytes']:.0f} B "
        f"= {stats['compression_ratio']:.0f}x (paper: ~500x)")

    curve = validation_model_curve(
        MNIST_CLASSIFIER, res["weights_dataset"],
        lambda w: fc_reconstruct(res["ae_params"], MNIST_AE, w),
        {k: v.to(device) for k, v in data.items()})
    out("validation model (orig vs AE-predicted accuracy per epoch):")
    for i, (o, p) in enumerate(zip(curve["original_acc"],
                                   curve["predicted_acc"])):
        out(f"  epoch {i:2d}: {o:.3f} vs {p:.3f}")
    return {"snapshots": int(res["weights_dataset"].shape[0]),
            "ae_history": hist,
            "original_bytes": stats["original_bytes"],
            "compressed_bytes": stats["compressed_bytes"],
            "compression_ratio": stats["compression_ratio"],
            "curve": curve}


def main(argv=None) -> dict:
    args = parse(parser(__doc__), argv)
    out = Printer()
    res = pipeline(args.device, out)
    return dict(res, lines=out.lines)


if __name__ == "__main__":
    main()
