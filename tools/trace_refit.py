"""Where a warm-started AE refit parts between a device and the CPU: the
``ae_lifecycle_refresh`` example's refit at one round, Adam step by Adam
step.

    PYTHONPATH=src python tools/trace_refit.py [--device cuda] [--round 3]
        [--small] [--no-cpu-run] [--out build/trace_refit.json]

Runs the example (``repro_torch.examples.ae_lifecycle_refresh``; ``--small``
at 2 clients, 4 rounds, 10 + 5 epochs) on ``--device`` with spies on
``AELifecycle._refit`` (the refit's datasets, inits and lane generators'
seeds) and on the AE trainer's gradient (each step's batch), and every
Adam step recorded by ``chip_smoke.AdamSpy`` with ``every_step`` (each
step's gradient, resulting parameters and moments). Then the same fit
runs on the CPU from the device's datasets and inits (the same shuffles),
free, and the trace reports:

* per step, the parameters whose values part beyond the golden band
  (``atol=2e-5, rtol=2e-4``), and how many of them took a partial step on
  both sides (an update smaller than 0.99 lr: at a fit's first step a
  gradient under 99 times Adam's eps);
* at the first such step, the parameters (lane, leaf, index), both
  gradients, both updates and both values;
* at every step, one step on the CPU from the device's parameters and
  moments on the device's batch: the gradient against the device's
  (largest absolute and relative difference) and ``_adam_update`` given
  the device's gradient against the device's result, so the op that gives
  a differing value is named; and the parameters that this forced step
  leaves out of the band, full and partial;
* the float32 matmul settings and the kernel launches during the refit;
* unless ``--no-cpu-run``, the example run free on the CPU as well: the
  refit's datasets, initial and resulting AEs against the device's, each
  round's global params and accuracy, at the first round whose accuracy
  differs the evaluation samples whose predicted class differs with both
  models' top-two logit gaps, and each stream's first Adam step of the
  run (``AdamSpy``'s streams: local training, the optimizers' ``update``;
  AE fits, ``_adam_update``) up to the traced refit whose result parts
  beyond the band, with what had parted in its input already.

Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core import autoencoder as ae  # noqa: E402
from repro_torch.core import lifecycle as lc  # noqa: E402
from repro_torch.core.pytree import leaf_paths, ravel, tree_map  # noqa: E402
from repro_torch.device import resolve  # noqa: E402
from repro_torch.examples import ae_lifecycle_refresh as ex  # noqa: E402
from repro_torch.examples._common import Printer  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402

ATOL, RTOL = 2e-5, 2e-4        # tests/test_golden_trajectory.py


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def _flat(tree) -> torch.Tensor:
    return ravel(tree)[0].detach().cpu().clone()


class FitSpy:
    """Patches the AE trainer while ``active``: the cohort fit's inputs
    and each gradient step's batch (on the CPU)."""

    def __init__(self):
        self.active, self.fits, self.batches = False, [], []

    def __enter__(self):
        self.real = (ae.train_autoencoder_cohort, ae._loss_grad)
        cohort, loss_grad = self.real

        def fit(gens, cfg, datasets, **kw):
            if self.active:
                self.fits.append(dict(
                    seeds=[g.initial_seed() for g in gens], cfg=cfg,
                    datasets=datasets.detach().cpu().clone(),
                    init=tree_map(lambda x: x.detach().cpu().clone(),
                                  kw["init"]),
                    kw={k: v for k, v in kw.items() if k != "init"}))
            return cohort(gens, cfg, datasets, **kw)

        def grad_of(cfg, kind, batched):
            fn = loss_grad(cfg, kind, batched)

            def step(params, xb, wb):
                if self.active:
                    self.batches.append((xb.detach().cpu().clone(),
                                         wb.detach().cpu().clone()))
                return fn(params, xb, wb)
            return step
        ae.train_autoencoder_cohort, ae._loss_grad = fit, grad_of
        return self

    def __exit__(self, *exc):
        ae.train_autoencoder_cohort, ae._loss_grad = self.real


def unrolled(stream: list) -> list:
    """An ``AdamSpy`` stream recorded with ``every_step`` as one dict a
    step: t, lr, the input parameters and moments (the step before's
    result; at a fit's first step its input and zero moments), the
    gradient and the resulting parameters, flat on the CPU."""
    out = []
    for j, e in enumerate(stream):
        if e["t"] == 1:
            p, m, v = (e["in_p"], torch.zeros_like(e["in_p"]),
                       torch.zeros_like(e["in_p"]))
        else:
            p, m, v = stream[j - 1]["out"]
        out.append(dict(t=e["t"], lr=e["lr"], p=p, m=m, v=v, g=e["g"],
                        out=e["out"][0]))
    return out


def first_parting(card: dict, cpu: dict) -> dict:
    """Each stream's first Adam step (in call order) whose result parts
    beyond the golden band between two free runs: how many values part,
    how many of them had parted in the step's input already, and the
    largest newly parted values with both gradients, updates and
    the partial flag (an update under 0.99 lr on both devices)."""
    out = {}
    for s in ("opt", "ae"):
        row = None
        for i, (a, b) in enumerate(zip(card[s], cpu[s])):
            d, parted, partial = _parted(a["p"], a["out"], b["p"], b["out"],
                                         a["lr"])
            if not bool(parted.any()):
                continue
            was = (a["p"] - b["p"]).abs() > ATOL + RTOL * b["p"].abs()
            new = parted & ~was
            idx = torch.nonzero(new if bool(new.any()) else parted).flatten()
            top = idx[torch.argsort(d[idx], descending=True)[:5]].tolist()
            row = {"step": i, "t": a["t"], "size": a["p"].numel(),
                   "parted": int(parted.sum()),
                   "parted_in_the_input": int((parted & was).sum()),
                   "newly_parted": int(new.sum()),
                   "newly_parted_partial": int((new & partial).sum()),
                   "largest": [dict(index=j, card=float(a["out"][j]),
                                    cpu=float(b["out"][j]),
                                    card_grad=float(a["g"][j]),
                                    cpu_grad=float(b["g"][j]),
                                    card_update=float(a["out"][j]
                                                      - a["p"][j]),
                                    cpu_update=float(b["out"][j]
                                                     - b["p"][j]),
                                    partial=bool(partial[j]))
                               for j in top]}
            break
        out[s] = {"steps_compared": min(len(card[s]), len(cpu[s])),
                  "first": row}
    return out


def _where(paths, C: int, i: int) -> dict:
    """A flat index of a stacked (C, ...) tree: its leaf, lane and index
    within the lane's leaf."""
    for path, off, size in paths:
        if off <= i < off + size:
            per = size // C
            return {"leaf": path, "lane": (i - off) // per,
                    "index": (i - off) % per}
    raise IndexError(i)


def _parted(card_in, card_out, cpu_in, cpu_out, lr: float):
    d = (card_out - cpu_out).abs()
    out = d > ATOL + RTOL * cpu_out.abs()
    partial = (((card_out - card_in).abs() < 0.99 * lr)
               & ((cpu_out - cpu_in).abs() < 0.99 * lr))
    return d, out, partial


def run_example(device, round_: int, kw: dict) -> dict:
    """The example on ``device`` with the trainer spies active during the
    refit at ``round_``: its inputs and steps, its result per lane, and
    the global params each evaluation saw."""
    from repro_torch.core.task import ClassifierTask
    real_refit, real_eval = lc.AELifecycle._refit, ClassifierTask.evaluate
    got = {"refits": [], "launches": {}, "results": [], "evals": []}

    with cs.AdamSpy(every_step=True) as adam, FitSpy() as spy:
        def refit(self, run, r, todo):
            got["refits"].append({"round": r,
                                  "lanes": [str(x) for x in todo]})
            spy.active = r == round_
            before, i0 = _lib.counts(), len(adam.steps["ae"])
            try:
                out = real_refit(self, run, r, todo)
            finally:
                if spy.active:
                    after = _lib.counts()
                    got["launches"].update(
                        {k: after[k] - before.get(k, 0) for k in after})
                spy.active = False
            if r == round_:
                got["results"] = [(str(lane), _flat(p)) for lane, p in out]
                got["refit_steps"] = (i0, len(adam.steps["ae"]))
                # the step log ends with this refit
                got["ends"] = {s: len(adam.steps[s]) for s in adam.STREAMS}
            return out

        def evaluate(self, params, data):
            got["evals"].append(_flat(params))
            got["eval_data"] = {k: v.detach().cpu() for k, v in data.items()}
            got["clf_cfg"] = self.clf_cfg
            return real_eval(self, params, data)
        lc.AELifecycle._refit, ClassifierTask.evaluate = refit, evaluate
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                got["res"] = ex.lifecycle_run(device, Printer(), **kw)
        finally:
            lc.AELifecycle._refit, ClassifierTask.evaluate = (real_refit,
                                                              real_eval)
    if not spy.fits:
        raise SystemExit(f"no refit at round {round_}: {got['refits']}")
    rec = adam.record()
    got["spy"] = spy
    got["steps"] = {s: unrolled(rec[s])[:got["ends"][s]] for s in rec}
    i0, i1 = got["refit_steps"]
    got["refit"] = [dict(st, batch=b) for st, b in
                    zip(got["steps"]["ae"][i0:i1], spy.batches, strict=True)]
    return got


def _apart(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a - b).abs()
    return {"max_abs_err": float(d.max()),
            "out_of_band": int((d > ATOL + RTOL * b.abs()).sum())}


def free_runs(card: dict, cpu: dict) -> dict:
    """The device's run against a free CPU run of the example: the traced
    refit's inputs and results, each round's global params and accuracy,
    and at the first round whose accuracy differs the samples whose
    predicted class differs, with both models' top-two logit gaps."""
    from repro_torch.models.classifiers import apply_classifier
    fg, fc = card["spy"].fits[0], cpu["spy"].fits[0]
    out = {"refit_datasets": _apart(fg["datasets"], fc["datasets"]),
           "refit_init": _apart(ravel(fg["init"])[0], ravel(fc["init"])[0]),
           "refit_results": {lane: _apart(a, b) for (lane, a), (_, b)
                             in zip(card["results"], cpu["results"],
                                    strict=True)},
           "rounds": []}
    flip = None
    data, cfg = cpu["eval_data"], cpu["clf_cfg"]
    _, unravel = ravel(tree_map(lambda x: x.detach().cpu(),
                                ex_params(cfg)))
    for r, (ga, gc, ra, rc) in enumerate(zip(
            card["evals"], cpu["evals"], card["res"]["rounds"],
            cpu["res"]["rounds"], strict=True)):
        out["rounds"].append(dict(round=r, accuracy_card=ra["accuracy"],
                                  accuracy_cpu=rc["accuracy"],
                                  global_params=_apart(ga, gc)))
        if flip is None and ra["accuracy"] != rc["accuracy"]:
            with torch.no_grad():
                la = apply_classifier(unravel(ga), cfg, data["x"])
                lb = apply_classifier(unravel(gc), cfg, data["x"])
            diff = torch.nonzero(la.argmax(-1) != lb.argmax(-1)).flatten()

            def gap(lg, i):
                top = torch.topk(lg[i], 2).values
                return float(top[0] - top[1])
            flip = {"round": r, "logits": _apart(la, lb),
                    "samples": [dict(sample=int(i), label=int(data["y"][i]),
                                     card_class=int(la[i].argmax()),
                                     cpu_class=int(lb[i].argmax()),
                                     card_top2_gap=gap(la, i),
                                     cpu_top2_gap=gap(lb, i))
                                for i in diff.tolist()]}
    out["first_accuracy_flip"] = flip
    out["first_parting_step"] = first_parting(card["steps"], cpu["steps"])
    return out


def ex_params(cfg):
    from repro_torch.models.classifiers import init_classifier
    return init_classifier(torch.Generator().manual_seed(0), cfg, "cpu")


def trace(device, round_: int, small: bool, cpu_run: bool) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = (dict(n_clients=2, rounds=4, ae_epochs=10, refresh_epochs=5)
          if small else {})
    got = run_example(device, round_, kw)
    fit = got["spy"].fits[0]
    C = fit["datasets"].shape[0]
    gens = [torch.Generator().manual_seed(s) for s in fit["seeds"]]
    with cs.AdamSpy(every_step=True) as cpu_adam:
        ae.train_autoencoder_cohort(gens, fit["cfg"], fit["datasets"],
                                    init=fit["init"], **fit["kw"])
    cpu = unrolled(cpu_adam.record()["ae"])
    card = got["refit"][:len(cpu)]
    paths = leaf_paths(fit["init"])
    _, unravel = ravel(fit["init"])
    grad_fn = ae._loss_grad(fit["cfg"], "fc", True)
    adam = ae._adam_update

    per_step, first = [], None
    for s, (a, b) in enumerate(zip(card, cpu, strict=True)):
        lr = a["lr"]
        d, out, partial = _parted(a["p"], a["out"], b["p"], b["out"], lr)
        # one step on the CPU from the device's state on its batch
        xb, wb = a["batch"]
        g_cpu, _ = grad_fn(unravel(a["p"]), xb, wb)
        g_cpu = ravel(g_cpu)[0]
        gd = (g_cpu - a["g"]).abs()
        nz = a["g"].abs() > 0
        rel = float((gd[nz] / a["g"].abs()[nz]).max()) if nz.any() else 0.0
        from_card_g = ravel(adam(unravel(a["p"]), unravel(a["g"]),
                                 unravel(a["m"]), unravel(a["v"]),
                                 a["t"], lr)[0])[0]
        forced = ravel(adam(unravel(a["p"]), unravel(g_cpu),
                            unravel(a["m"]), unravel(a["v"]),
                            a["t"], lr)[0])[0]
        fd, fout, fpartial = _parted(a["p"], a["out"], a["p"], forced, lr)
        row = {"step": s + 1, "t": a["t"],
               "free_out_of_band": int(out.sum()),
               "free_out_of_band_partial": int((out & partial).sum()),
               "free_max_abs_err": float(d.max()),
               "grad_max_abs_diff": float(gd.max()),
               "grad_max_rel_diff": rel,
               "adam_equal_given_device_grad": bool(torch.equal(
                   from_card_g, a["out"])),
               "adam_max_abs_diff_given_device_grad": float(
                   (from_card_g - a["out"]).abs().max()),
               "forced_out_of_band": int(fout.sum()),
               "forced_out_of_band_full": int((fout & ~fpartial).sum()),
               "forced_partial": int((fpartial & ((a["out"] != a["p"])
                                                  | (forced != a["p"]))
                                      ).sum()),
               "forced_max_abs_err_full": float(fd[~fpartial].max())
               if bool((~fpartial).any()) else 0.0}
        per_step.append(row)
        if first is None and bool(out.any()):
            idx = torch.nonzero(out).flatten()
            order = torch.argsort(d[idx], descending=True)[:10]
            first = {"step": s + 1, "t": a["t"], "lr": lr,
                     "parameters": int(out.sum()),
                     "partial": int((out & partial).sum()), "largest": []}
            for i in idx[order].tolist():
                first["largest"].append(dict(
                    _where(paths, C, i),
                    card=float(a["out"][i]), cpu=float(b["out"][i]),
                    card_grad=float(a["g"][i]), cpu_grad=float(b["g"][i]),
                    cpu_grad_at_card_params=float(g_cpu[i]),
                    card_update=float(a["out"][i] - a["p"][i]),
                    cpu_update=float(b["out"][i] - b["p"][i]),
                    partial=bool(partial[i])))
    rep = {"device": str(device),
            "device_name": (torch.cuda.get_device_name(0)
                            if device.type == "cuda" else "cpu"),
            "small": small, "round": round_, "refits": got["refits"],
            "lanes": C, "rows": list(fit["datasets"].shape[1:]),
            "ae_values": sum(x for _, _, x in paths) // C,
            "steps": len(cpu), "epochs": fit["kw"]["epochs"],
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision(),
            "launches_during_refit": got["launches"],
            "first_parting": first, "per_step": per_step,
            "accuracy": [r["accuracy"] for r in got["res"]["rounds"]]}
    if cpu_run:
        rep["free_cpu_run"] = free_runs(
            got, run_example(torch.device("cpu"), round_, kw))
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None)
    ap.add_argument("--round", type=int, default=3)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-cpu-run", action="store_true",
                    help="skip the free run of the example on the CPU")
    args = ap.parse_args(argv)
    rep = trace(resolve(args.device), args.round, args.small,
                not args.no_cpu_run)
    text = json.dumps(rep, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    keep = {k: v for k, v in rep.items() if k != "per_step"}
    print(json.dumps(keep, indent=1))
    for row in rep["per_step"]:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
