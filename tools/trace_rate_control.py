"""Why ``adaptive_rate_control`` never walks its ladder: the example's
distortion-target run (``repro_torch.examples.adaptive_rate_control``)
traced round by round.

    PYTHONPATH=src python tools/trace_rate_control.py [--device cpu]
        [--rung-epochs 200] [--rounds 6] [--own-init]

Prints, for each round, the lanes the controller may move (enough
snapshots, off cooldown), the probe matrix (rung x client: the squared
relative round-trip error ``_rel_recon_err``), the target and the planned
moves; then, at the end, how far the rung-0 AE's output moves when its
input moves (its reconstruction of the newest snapshot against its
reconstruction of the initial weights), and the accuracy a round.
``--own-init`` runs the pre-pass from each client's own fresh draw instead
of the run's initial weights (the example before the JAX package's
commit 8bf4666), which does walk the ladder.

The port mirrors the JAX example (``tests/test_torch_examples_rate.py``
holds the two round tables and probe matrices equal), so the trace reads
the reference's failure too. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import codec, ratecontrol  # noqa: E402
from repro_torch.core.pytree import ravel  # noqa: E402
from repro_torch.device import resolve  # noqa: E402
from repro_torch.examples import adaptive_rate_control as arc  # noqa: E402
from repro_torch.examples._common import Printer  # noqa: E402


def trace(device, rung_epochs: int, rounds: int, own_init: bool) -> dict:
    rows, runs = [], []
    orig_plan = ratecontrol.DistortionTarget.plan
    orig_probe = ratecontrol.RateController._probe_all
    orig_run = arc.FederatedRun
    orig_prepass = arc.run_prepass

    def plan(self, run, r, parts):
        eligible = self._eligible(run, r, parts, self.cooldown)
        rows.append({"round": r, "eligible": eligible,
                     "snapshots": [len(run.clients[ci].snapshots)
                                   for ci in parts],
                     "target": self.target, "margin": self.margin})
        moves = orig_plan(self, run, r, parts)
        rows[-1]["moves"] = dict(moves)
        return moves

    def probe(self, run, lanes):
        errs = orig_probe(self, run, lanes)
        rows[-1]["probe"] = errs.tolist()
        return errs

    class Run(orig_run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append(self)

    def prepass(*a, **kw):
        if own_init:
            kw.pop("init_params", None)
        return orig_prepass(*a, **kw)

    ratecontrol.DistortionTarget.plan = plan
    ratecontrol.RateController._probe_all = probe
    arc.FederatedRun, arc.run_prepass = Run, prepass
    table, outcome = {}, None
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            arc.rate_runs(device, Printer(), rounds=rounds,
                          rung_epochs=rung_epochs, table=table)
    except AssertionError as e:
        outcome = str(e)
    finally:
        ratecontrol.DistortionTarget.plan = orig_plan
        ratecontrol.RateController._probe_all = orig_probe
        arc.FederatedRun, arc.run_prepass = orig_run, orig_prepass

    run = runs[0]
    comp = run.ratecontrol._comps[0][0]
    spec, params = comp.spec(arc.P), comp.codec_params()
    snap = run.clients[0].snapshots[-1]
    init0 = ravel(run.task.init_params(
        torch.Generator().manual_seed(run.cfg.seed), device))[0]

    def rec(x):
        return codec.decode(spec, params, codec.encode(spec, params, x))
    return {
        "rows": rows, "table": table, "outcome": outcome,
        "snapshot_minus_init": float((snap - init0).norm()),
        "rec_snapshot_minus_rec_init": float((rec(snap) - rec(init0))
                                             .norm()),
        "global_minus_init": float((ravel(run.global_params)[0] - init0)
                                   .norm()),
        "init_norm": float(init0.norm()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None)
    ap.add_argument("--rung-epochs", type=int, default=arc.RUNG_EPOCHS)
    ap.add_argument("--rounds", type=int, default=arc.ROUNDS)
    ap.add_argument("--own-init", action="store_true")
    args = ap.parse_args(argv)
    res = trace(resolve(args.device), args.rung_epochs, args.rounds,
                args.own_init)
    for r in res["rows"]:
        probe = ([[round(e, 5) for e in row] for row in r["probe"]]
                 if "probe" in r else "-")
        print(f"round {r['round']}: snapshots {r['snapshots']}, eligible "
              f"{r['eligible']}, target {r['target']} (step down under "
              f"{r['margin'] * r['target']:.3g}), probe (rung x client) "
              f"{probe}, moves {r['moves']}")
    for t in res["table"].get("rounds", []):
        print(f"round {t['round']}: acc {t['accuracy']:.4f}, up "
              f"{t['bytes_up']:.0f} B, switches {t['spec_switches']}, "
              f"rungs {t['rungs']}")
    print(f"rung-0 AE of client 0: |snapshot - init| "
          f"{res['snapshot_minus_init']:.4f}, |rec(snapshot) - rec(init)| "
          f"{res['rec_snapshot_minus_rec_init']:.4f}; |global - init| "
          f"{res['global_minus_init']:.4f} of |init| {res['init_norm']:.4f}")
    print(f"outcome: {res['outcome'] or 'walked the ladder, passed'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
