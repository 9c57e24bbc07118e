"""Where a round of the scalable runtime spends its time on the card.

    python3 tools/runtime_profile.py [--out build/runtime_profile.json]

Builds run (i) (``SampledSync`` over the CIFAR CNN, 100 of 1,000 clients,
the composed chunked AE) and run (j) (``AsyncBuffered`` over the MNIST MLP
at ``PAPER_SCALE_SCENARIO``, TopK 1 % → q8) as ``chip_smoke.py`` does,
plays one warm-up round of each, and then, for one more round:

* splits (i)'s round into its phases on the host clock, each ended by a
  synchronize — the vmapped local training, the 100 client encodes with
  their EF decodes, the server's ``_server_aggregate`` and the global
  evaluation — calling the functions ``SampledSync.run_round`` calls, in
  its order;
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
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _sync():
    import torch
    torch.cuda.synchronize()


def _phases_sampled(run, r: int) -> dict:
    """One ``SampledSync`` round, phase by phase (the body of
    ``SampledSync.run_round``)."""
    from repro_torch.core.scheduler import _encode_local, _server_aggregate
    sched = run.scheduler
    out = {}
    _sync()
    t0 = time.perf_counter()
    cohort = sched.sampled(r)
    batched = sched._cohort_locals(cohort, r)
    _sync()
    out["local_train_vmapped_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    encoded = [_encode_local(run, ci, local, run.global_params,
                             run.clients[ci], m)
               for ci, (local, m) in zip(cohort, batched)]
    _sync()
    out["encode_and_ef_decode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run.global_params = _server_aggregate(run, encoded,
                                          [e.weight for e in encoded])
    _sync()
    out["server_aggregate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run.task.evaluate(run.global_params, run.eval_data)
    _sync()
    out["evaluate_s"] = time.perf_counter() - t0
    return out


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
