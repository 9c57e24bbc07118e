"""The benchmark's one command: run one cell once and print its result.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>``. Everything is found by name: the cell in
``bench/workloads/<cell>.json``, its configuration in
``bench/configs/<config>.json``, its driver in ``bench/drivers/<driver>.py``
and each per-layer metric's reader in ``bench/metrics/<metric>.py``;
``BENCHMARK.json`` says which metrics a cell reports and their units.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (``busy_s`` and
``window_s`` too when traced), ``breakdown`` when traced, and last
``checks``, every number compared beside its limit, which standard error
repeats as its last lines.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: Path = BENCH):
    cell = load_json(bench / "workloads" / f"{name}.json")
    config = load_json(bench / "configs" / f"{cell['config']}.json")
    return cell, config


def forbidden_modules(names) -> List[str]:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of :data:`FORBIDDEN`, compared whole: ``repro.x`` is caught,
    ``repro_torch.x`` is not."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def reader(name: str, bench: Path = BENCH):
    """The ``read(trace)`` function of ``bench/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}",
        bench / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(manifest: Optional[Dict], cell: str, e2e: Dict[str, float]
                 ) -> tuple:
    """The cell's end-to-end metrics (those the driver measured that the
    manifest lists for it) and per-layer metrics (listed for it by
    ``workloads``, or, without that key, moving one of its end-to-end
    metrics), each ``name -> unit``."""
    if manifest is None:
        return {k: "" for k in e2e}, {}
    ends = {m["name"]: m["unit"] for m in manifest["end_to_end"]
            if m["name"] in e2e
            and cell in m.get("workloads", [cell])}
    layers = {m["name"]: m["unit"] for m in manifest["per_layer"]
              if ((cell in m["workloads"]) if "workloads" in m
                  else (m["moves"] in ends))}
    return ends, layers


def gpu_kind() -> Dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", bench: Path = BENCH,
             manifest: Optional[Dict] = None) -> Dict:
    """One run of one cell; returns the result object (``device`` left for
    the caller to fill)."""
    import torch
    from bench import checks
    cell, config = load_cell(name, bench)
    driver = importlib.import_module(f"bench.drivers.{cell['driver']}")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
        # the kernels' library: built by nvcc into the checkout's
        # build/repro_torch/<hash>/ on a checkout's first run, loaded after
        from repro_torch.kernels import _lib
        t0 = time.perf_counter()
        _lib.load()
        print(f"bench: kernels' library built or loaded in "
              f"{time.perf_counter() - t0!r} s, part of setup_s",
              file=sys.stderr, flush=True)
    sut = driver.setup(cell, config, seed, dev)
    setup_s = time.perf_counter() - t_start
    result: Dict = {}
    if not trace:
        e2e = dict(driver.window(sut, seconds), setup_s=setup_s)
        ends, _ = cell_metrics(manifest, name, e2e)
        metrics = {k: {"value": e2e[k], "unit": u} for k, u in ends.items()}
    else:
        tr = driver.traced(sut, seconds)
        _, layers = cell_metrics(manifest, name,
                                 {"setup_s": 0.0, **driver_ends(driver)})
        metrics = {}
        for k, u in layers.items():
            v = reader(k, bench)(tr)
            if v is not None:
                metrics[k] = {"value": v, "unit": u}
        result["trace"] = tr
    result["peak"] = (torch.cuda.max_memory_allocated()
                      if dev.type == "cuda" else 0)
    print(f"bench: peak memory of the program's run {result['peak']} bytes,"
          f" reckoned {config.get('memory', {}).get('reckoned_peak_bytes')}"
          " (the configuration's memory reckoning)",
          file=sys.stderr, flush=True)
    if dev.type == "cuda":
        st = torch.cuda.memory_stats()
        print(f"bench: allocator retries {st.get('num_alloc_retries')}, "
              f"reserved peak {st.get('reserved_bytes.all.peak')} bytes",
              file=sys.stderr, flush=True)
    result["metrics"] = metrics
    result["attempted"], result["failed"] = sut.attempted, sut.failed
    result["checks"] = checks.compare(driver.check_readings(sut),
                                      cell["limits"])
    return result


def driver_ends(driver) -> Dict[str, float]:
    return {k: 0.0 for k in driver.END_TO_END}


def result_line(res: Dict, device: Dict) -> Dict:
    """The result object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (with ``busy_s`` and ``window_s`` when
    traced), ``breakdown`` when traced, and last ``checks``."""
    from bench import checks
    device = dict(device, memory_peak_bytes=int(res["peak"]))
    out = {"correct": checks.verdict(res["checks"]),
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": res["metrics"], "device": device}
    tr = res.get("trace")
    if tr is not None:
        device["busy_s"] = tr.busy_s if tr.busy_s is not None else 0.0
        device["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                            "idle_gaps": [list(x) for x in tr.idle_gaps]}
    out["checks"] = checks.table(res["checks"])
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"bench: no program beside the benchmark ({src}/repro_torch)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    cell, _ = load_cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"bench: {args.workload} needs {cell['chips']} CUDA "
              "device(s); none here", file=sys.stderr)
        return 3
    manifest = load_json(ROOT / "BENCHMARK.json")
    res = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), t_start, manifest=manifest)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    out = result_line(res, gpu_kind())
    for n, v, lim in res["checks"]:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
