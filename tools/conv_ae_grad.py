"""The conv AE's loss gradient on a device against the CPU's float64
gradient, at the paper appendix's configuration
(``ConvAEConfig(channels=(8, 16), kernel=9, stride=8)``, rows of 15,936
values: the MNIST classifier's 15,910 weights padded to a multiple of 64,
as ``benchmarks/tables.py:262-296`` pads them), 2 rows of unit scale drawn
from a seed and the normalizer fitted on them: the inputs of
``tests/test_torch_gpu.py::test_conv_ae_gradient_on_card_is_float32``.

    PYTHONPATH=src python tools/conv_ae_grad.py [--device cuda]

Prints one JSON line: by leaf and in all, the largest difference from
float64 and its largest share of the golden band (``atol=2e-5,
rtol=2e-4``; above 1 is outside), the largest difference over the largest
float64 gradient (``rel``), with the cuDNN version and TF32 flags
the device ran with (TF32 off). Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BAND = dict(atol=2e-5, rtol=2e-4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from repro_torch.core.autoencoder import (ConvAEConfig, ae_loss,
                                              fit_normalizer, init_conv_ae)
    from repro_torch.core.pytree import flatten, leaf_paths, tree_map
    from repro_torch.core.pytree import value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ConvAEConfig(channels=(8, 16), kernel=9, stride=8,
                       latent_channels=1)
    rows = torch.from_numpy(
        np.random.RandomState(9).randn(2, 15_936).astype(np.float32))
    params = fit_normalizer(
        init_conv_ae(torch.Generator().manual_seed(1), cfg, "cpu"), rows)

    def grad(dev, dtype):
        p = tree_map(lambda t: t.to(dev, dtype), params)
        g = value_and_grad(
            lambda p, x: (ae_loss(p, cfg, x, "conv"), None), p,
            rows.to(dev, dtype))[2]
        return [t.double().cpu() for t in flatten(g)[0]]
    got, want = grad(args.device, torch.float32), grad("cpu", torch.float64)
    leaves = {}
    for (path, _, _), a, b in zip(leaf_paths(params), got, want,
                                  strict=True):
        diff = (a - b).abs()
        leaves[path] = dict(
            max_abs_diff=float(diff.max()),
            band_share=float((diff / (BAND["atol"]
                                      + BAND["rtol"] * b.abs())).max()))
    print(json.dumps(dict(
        device=args.device,
        device_name=(torch.cuda.get_device_name(0)
                     if args.device == "cuda" else "cpu"),
        cudnn=torch.backends.cudnn.version(),
        max_abs_diff=max(r["max_abs_diff"] for r in leaves.values()),
        band_share=max(r["band_share"] for r in leaves.values()),
        rel=max(float((a - b).abs().max()) for a, b in zip(got, want))
        / max(float(b.abs().max()) for b in want),
        leaves=leaves)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
