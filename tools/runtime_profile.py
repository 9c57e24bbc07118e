"""Where a round of the scalable runtime spends its time on the card.

    python3 tools/runtime_profile.py [--out build/runtime_profile.json]

Builds run (i) (``SampledSync`` over the CIFAR CNN, 100 of 1,000 clients,
the composed chunked AE) and run (j) (``AsyncBuffered`` over the MNIST MLP
at ``PAPER_SCALE_SCENARIO``, TopK 1 % → q8) as ``chip_smoke.py`` does,
plays one warm-up round of each, and then, for one more round:

* runs (i)'s round under ``torch.profiler`` and splits it by the
  program's own spans and counters (``repro_torch.trace.snapshot()``:
  each span's calls, total and self host seconds and parents — ``round``,
  ``client_train`` and its ``.grad`` / ``.optimizer``, ``client_encode``
  and its ``.codec`` / ``.ef``, ``server_agg``, ``global_eval``, the
  ``kernel.*`` wrappers, ``host_sync`` — and the ``host_syncs`` and
  ``cuda_frees`` counters);
* traces the whole round of (i) and of (j) with ``torch.profiler``: the
  round's wall time, the card's busy time (the union of its kernels'
  intervals) and idle share, and the ten kernels with the most device
  time.

Then it builds run (k) (the AE lifecycle on the kernel path, CIFAR CNN, 8
clients) and run (l) (the §5.2 federation with the full-width CIFAR FC
AE), plays rounds 0–1 of each and traces round 2 (a cadence refit of
every client) and round 3 (the first round decoded with the refit
decoders) the same way.

Needs a card; prints one JSON object and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _sync():
    import torch
    torch.cuda.synchronize()


def _phases_sampled(run, r: int) -> dict:
    """Round ``r`` of ``run`` (``run_round`` itself) under
    ``torch.profiler``, split by ``repro_torch.trace``'s spans and
    counters over that round alone. Host times include the profiler's
    cost for every operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import trace
    _sync()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run.history.append(run.scheduler.run_round(r))
        torch.cuda.synchronize()
    return trace.snapshot()


def _traced_round(run, r: int) -> dict:
    """Round ``r`` of ``run`` under ``torch.profiler``
    (``chip_smoke.traced_round``), the ten kernels with the most device
    time."""
    from chip_smoke import traced_round
    return traced_round(
        lambda: run.history.append(run.scheduler.run_round(r)), top=10,
        width=90)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/runtime_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("runtime_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"device": torch.cuda.get_device_name(0)}
    run_i = chip_smoke.run_sampled_cnn("cuda", rounds=1)[0]   # warm-up
    result["sampled_cnn_phases"] = _phases_sampled(run_i, 1)
    result["sampled_cnn_round"] = _traced_round(run_i, 2)
    del run_i
    run_j = chip_smoke.run_async_mlp("cuda", rounds=1)[0]     # warm-up
    result["async_mlp_round"] = _traced_round(run_j, 1)
    del run_j
    run_k = chip_smoke.build_lifecycle_cnn("cuda")
    chip_smoke.play(run_k, 2, "cuda")
    result["lifecycle_cnn_refit_round"] = _traced_round(run_k, 2)
    result["lifecycle_cnn_after_refit_round"] = _traced_round(run_k, 3)
    del run_k
    run_l = chip_smoke.build_color_imbalance(
        chip_smoke.prepass_color_imbalance("cuda"), "cuda", 4)
    chip_smoke.play(run_l, 2, "cuda")
    result["color_imbalance_refit_round"] = _traced_round(run_l, 2)
    result["color_imbalance_after_refit_round"] = _traced_round(run_l, 3)
    del run_l
    text = json.dumps(result)
    print(text)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
