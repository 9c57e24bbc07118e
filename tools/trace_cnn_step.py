"""Why a CIFAR-CNN local step of ``fl_color_imbalance --stacks`` parts
between a device and the CPU: the gradient at one first local step,
compared route by route against float64.

    PYTHONPATH=src python tools/trace_cnn_step.py [--device cuda]
        [--step 6] [--out build/trace_cnn_step.json]

Runs the example (``chip_smoke.ac_call("fl_color_imbalance_stacks")``) on
``--device`` under ``chip_smoke.ExampleSpies``, keeping each local
training's start and data, and takes the first batch of the local training
whose first Adam step is the optimizer stream's step ``--step`` (a
client's first local step; the default is client 1's in round 0). At
those params and that batch it reports:

* the gradient's largest difference from the CPU's float64 gradient, by
  leaf: on the device in float32 through the port's convs, through cuDNN
  (``F.conv2d``) as set by default, in deterministic mode, with
  ``cudnn.conv.fp32_precision = "ieee"`` and with ``benchmark``, and
  without cuDNN; in float64; on the CPU in float32;
* the values whose sign the device's float32 gradient (the port's route)
  and the CPU's take apart where either would take a full Adam step
  (|g| above 99 times eps);
* where the forward's decisions part, device against CPU float32 and
  float64: ReLU inputs on either side of zero, and 2x2 max-pool argmaxes,
  with the smallest |pre-activation| among the ReLUs decided apart.

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
import torch.nn.functional as F  # noqa: E402

from repro_torch.core import prepass  # noqa: E402
from repro_torch.core.pytree import (leaf_paths, ravel, tree_map,  # noqa
                                     value_and_grad)
from repro_torch.data.pipeline import batches  # noqa: E402
from repro_torch.device import resolve  # noqa: E402
from repro_torch.models import classifiers as C  # noqa: E402


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def first_batch(cs, device, step: int):
    """(start params, batch, classifier config) of the local training
    whose first optimizer step is ``step``."""
    calls = []
    real = prepass.local_train
    spies = cs.ExampleSpies(tag="stacks")

    def local_train(params, clf_cfg, data, **kw):
        calls.append(dict(params=cs._to_cpu(params), data=cs._to_cpu(data),
                          kw=kw, clf=clf_cfg,
                          step0=len(spies.spies["adam"].steps["opt"])))
        return real(params, clf_cfg, data, **kw)
    prepass.local_train = local_train
    try:
        with contextlib.redirect_stdout(io.StringIO()), spies:
            cs.ac_call("fl_color_imbalance_stacks", device.type)
    finally:
        prepass.local_train = real
    call = next((c for c in calls if c["step0"] == step), None)
    if call is None:
        raise SystemExit(f"no local training starts at step {step}: "
                         f"{[c['step0'] for c in calls]}")
    b = next(batches(call["kw"]["seed"] * 1000, call["data"],
                     call["kw"]["batch_size"]))
    return call["params"], b, call["clf"]


def gradient(params, b, clf, device, dtype, conv=None, **flags) -> tuple:
    """(flat float64 gradient on the CPU, pre-activations and pool
    argmaxes of the forward) at ``params`` on ``b``; ``conv`` replaces
    the port's conv route on the device, ``flags`` set cuDNN around the
    forward and the backward."""
    cudnn = torch.backends.cudnn
    p = tree_map(lambda t: t.to(device, dtype), params)
    x = {"x": b["x"].to(device, dtype), "y": b["y"].to(device)}
    old = (C.conv2d_valid_gemm, cudnn.conv.fp32_precision)
    prec = flags.pop("fp32_precision", None)
    if conv is not None:
        C.conv2d_valid_gemm = conv
    try:
        with cudnn.flags(enabled=flags.get("enabled", True),
                         benchmark=flags.get("benchmark", False),
                         deterministic=flags.get("deterministic", False),
                         allow_tf32=False):
            if prec:
                cudnn.conv.fp32_precision = prec
            g = value_and_grad(lambda q, d: C.classifier_loss(q, clf, d),
                               p, x)[2]
    finally:
        C.conv2d_valid_gemm, cudnn.conv.fp32_precision = old
    with torch.no_grad():
        h = x["x"].permute(0, 3, 1, 2)
        route = C.conv2d_valid_gemm
        acts = []
        for i in range(len(clf.conv_channels)):
            q = p[f"conv{i}"]
            pre = route(h, q["w"].permute(3, 2, 0, 1), q["b"])
            acts.append(("relu", i, pre.cpu()))
            h = torch.relu(pre)
            if i % 2 == 1:
                h, idx = F.max_pool2d(h, 2, 2, return_indices=True)
                acts.append(("pool", i, idx.cpu()))
    return ravel(g)[0].double().cpu(), acts


def trace(device, step: int) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _chip_smoke()
    if device.type == "cuda":
        from repro_torch.kernels import _lib
        _lib.build()
    params, b, clf = first_batch(cs, device, step)
    cpu = torch.device("cpu")
    runs = {"device_f32": gradient(params, b, clf, device, torch.float32),
            "device_f64": gradient(params, b, clf, device, torch.float64),
            "cpu_f32": gradient(params, b, clf, cpu, torch.float32),
            "cpu_f64": gradient(params, b, clf, cpu, torch.float64)}
    if device.type == "cuda":
        for name, flags in (("cudnn", {}),
                            ("cudnn_deterministic", {"deterministic": True}),
                            ("cudnn_ieee", {"fp32_precision": "ieee"}),
                            ("cudnn_benchmark", {"benchmark": True}),
                            ("no_cudnn", {"enabled": False})):
            runs[name] = gradient(params, b, clf, device, torch.float32,
                                  conv=F.conv2d, **flags)
    truth = runs["cpu_f64"][0]
    paths = leaf_paths(params)
    rep = {"device": str(device), "step": step,
           "torch": torch.__version__,
           "cudnn": torch.backends.cudnn.version(),
           "max_abs_err_vs_cpu_f64": {}}
    for name, (g, _) in runs.items():
        d = (g - truth).abs()
        rep["max_abs_err_vs_cpu_f64"][name] = {
            path: float(d[off:off + size].max()) for path, off, size in paths}
    a, c = runs["device_f32"][0], runs["cpu_f32"][0]
    apart = ((torch.sign(a) != torch.sign(c))
             & (torch.maximum(a.abs(), c.abs()) > 99e-8))

    def where(i):
        return next((path, i - off) for path, off, size in paths
                    if off <= i < off + size)
    rep["signs_apart"] = [dict(zip(("leaf", "index"), where(i)),
                               **{k: float(g[i]) for k, (g, _) in
                                  runs.items()})
                          for i in torch.nonzero(apart).flatten().tolist()]
    rep["decisions"] = []
    for (kind, layer, ta), (_, _, tc), (_, _, t64) in zip(
            runs["device_f32"][1], runs["cpu_f32"][1], runs["cpu_f64"][1]):
        if kind == "pool":
            row = dict(kind=kind, layer=layer, device_vs_cpu=int(
                (ta != tc).sum()), device_vs_f64=int((ta != t64).sum()))
        else:
            apart_f64 = (ta > 0) != (t64 > 0)
            row = dict(kind=kind, layer=layer,
                       device_vs_cpu=int(((ta > 0) != (tc > 0)).sum()),
                       device_vs_f64=int(apart_f64.sum()),
                       nearest_zero_apart=(float(t64[apart_f64].abs().min())
                                           if bool(apart_f64.any())
                                           else None))
        rep["decisions"].append(row)
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None)
    ap.add_argument("--step", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rep = trace(resolve(args.device), args.step)
    text = json.dumps(rep, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
