"""Dry-run every (architecture x input shape) at full width on the
production meshes and emit roofline rows on the H100's terms (port of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh multi --fl --out build/dryrun.jsonl

Each step is built on the meta device and run once there
(``roofline/cost.py``): no card, no allocation and no 512 processes — the
meshes are ``{axis: size}`` (``launch/mesh.py``) and the FL round's pod
group a ``CountingGroup``. The rows keep the reference's schema
(``roofline/analysis.RooflineReport.row``) with the H100's constants.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_shape
from repro_torch.core.collectives import CountingGroup
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.launch.steps import build_step
from repro_torch.roofline.analysis import model_flops
from repro_torch.roofline.cost import analyze_step


def run_one(arch: str, shape_name: str, *, multi_pod: bool,
            fl: bool = False, verbose: bool = True, constrain: bool = True,
            bf16_grads: bool = False, cfg=None, shape=None) -> dict:
    """One row; ``cfg``/``shape`` override the named ones (tests pass
    reduced configs)."""
    cfg = cfg or get_config(arch)
    if bf16_grads:
        cfg = dataclasses.replace(cfg, grad_reduce_dtype="bfloat16")
    shape = shape or get_shape(shape_name)
    mesh = production_mesh_shape(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    tag = f"{cfg.name}|{shape.name}|{mesh_name}" + ("|fl" if fl else "")
    group = CountingGroup(mesh.get("pod", 1)) if fl else None
    t0 = time.time()
    bundle = build_step(cfg, shape, mesh, fl=fl, constrain=constrain,
                        group=group)
    t_build = time.time() - t0
    report = analyze_step(bundle, mesh, model_flops(cfg, shape), group)
    t_run = time.time() - t0 - t_build
    row = report.row()
    row.update({
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "fl": fl, "mode": shape.mode,
        "build_s": round(t_build, 1), "meta_run_s": round(t_run, 1),
        "collective_breakdown_gb": {
            k: round(v / 2**30, 4)
            for k, v in report.collective_breakdown.items()},
    })
    if verbose:
        print(f"[ok] {tag:55s} compute={row['compute_ms']:9.3f}ms "
              f"memory={row['memory_ms']:9.3f}ms "
              f"coll={row['collective_ms']:9.3f}ms "
              f"dom={row['dominant']:10s} hbm={row['hbm_gb_per_dev']:7.2f}GB "
              f"useful={row['model_flops_frac']:.3f}", flush=True)
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--fl", action="store_true",
                    help="the federated (AE-compressed) round instead of "
                         "the baseline train step (train shapes only)")
    ap.add_argument("--out", default=None, help="write JSONL results here")
    ap.add_argument("--bf16-grads", action="store_true",
                    help="bfloat16 gradients (grad_reduce_dtype)")
    ap.add_argument("--no-constrain", action="store_true",
                    help="no activation-sharding context")
    ap.add_argument("--keep-going", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    rows, failures = [], []
    for arch in archs:
        for shape in shapes:
            if args.fl and SHAPES[shape].mode != "train":
                continue
            for multi_pod in meshes:
                if args.fl and not multi_pod:
                    continue                 # the FL round needs pods
                try:
                    rows.append(run_one(
                        arch, shape, multi_pod=multi_pod, fl=args.fl,
                        constrain=not args.no_constrain,
                        bf16_grads=args.bf16_grads))
                except Exception as e:           # noqa: BLE001
                    failures.append((arch, shape, multi_pod, repr(e)))
                    print(f"[FAIL] {arch}|{shape}|"
                          f"{'multi' if multi_pod else 'single'}: {e}",
                          flush=True)
                    if not args.keep_going:
                        traceback.print_exc()
                        raise
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    print(f"\n{len(rows)} configurations built and run on meta tensors, "
          f"{len(failures)} failures")
    for f_ in failures:
        print("  FAIL:", f_)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
