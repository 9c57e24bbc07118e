"""Round times and peak device memory of ``chip_smoke.py``'s CIFAR CNN runs
(i) and (k) for A/B comparisons of checkouts on one card: the CNN's
convolution route (cuDNN in a parent, float32 matrix products after
it) is what runs (i) and (k) train through.

    python3 tools/cnn_rounds_ab.py ROOT [ROOT ...]   # one JSON line a ROOT

Each ROOT (a parent unpacked with ``git archive``, this checkout) runs in a
process of its own, importing ``repro_torch`` and ``chip_smoke.py`` from
that ROOT: its kernels built, TF32 off as ``chip_smoke.py`` sets it, then
run (i) (``run_sampled_cnn``: ``SampledSync``, 100 of 1,000 clients, two
rounds of the vmapped local step) and run (k) (``build_lifecycle_cnn`` and
``play``: 8 clients, six rounds, cuDNN in deterministic mode as
``chip_smoke.py`` runs it), each round's host seconds ended by a
synchronize, and each run's ``torch.cuda.max_memory_allocated``. List the
roots in turns (``build/parent . . build/parent``) so that both are
measured at two points of the call. Needs a CUDA card.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path


def one(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    import repro_torch
    from repro_torch.kernels import _lib
    if not torch.cuda.is_available():
        raise SystemExit("cnn_rounds_ab: needs a CUDA card")
    if not Path(repro_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"cnn_rounds_ab: repro_torch is not from {root}")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _lib.build()
    out = {"root": str(root), "device": torch.cuda.get_device_name(0)}
    torch.cuda.reset_peak_memory_stats()
    run, _, secs, _ = cs.run_sampled_cnn("cuda")
    torch.cuda.synchronize()
    out["i_round_s"] = secs
    out["i_peak_bytes"] = torch.cuda.max_memory_allocated()
    del run
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = True
    torch.cuda.reset_peak_memory_stats()
    run = cs.build_lifecycle_cnn("cuda")
    plays = cs.play(run, 6, "cuda")
    torch.cuda.synchronize()
    out["k_round_s"] = [p["s"] for p in plays]
    out["k_peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "_one":
        print(json.dumps(one(Path(argv[2]).resolve())), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__)
        return 2
    for root in argv[1:]:
        got = subprocess.run([sys.executable, __file__, "_one", root],
                             capture_output=True, text=True)
        if got.returncode:
            sys.stderr.write(got.stdout + got.stderr)
            return got.returncode
        print(got.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
