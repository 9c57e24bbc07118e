"""Chip smoke test for the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device — requires CUDA (exits non-zero without it) and prints the card's
   name and power limit as ``nvidia-smi`` reports them;
2. build — compiles the four kernels from ``src/repro_torch/csrc`` with
   ``nvcc`` for ``sm_90a`` and prints ``ptxas``'s registers, shared memory
   and spills per kernel;
3. kernels vs plain — every kernel against its plain PyTorch version on
   the card, at every shape the slice gives it and at the cohort scale of
   the ``fl_decode_agg`` table (flat update 2^20, ``ChunkedAEConfig(256,
   (32,), 8)``, cohort 256), with times, bounds and the library call.
   ``ms``, ``plain_ms`` and ``library_ms`` are device times (calls
   captured in a CUDA graph and replayed); ``host_ms`` is the time per
   call of the wrapper called back to back from Python;
4. slice — the paper's pipeline through the port's entry points on
   ``cuda`` with the MNIST MLP at full width: (a) SyncFedAvg, 3 clients,
   q8, update payload + error feedback, 2 rounds; (b) ``run_prepass``
   with ``MNIST_AE`` then an FC-AE run; (c) a kernel-path
   ``ChunkedAECompressor`` run at the default ``ChunkedAEConfig()``. Runs
   (a) and (c) are repeated on the CPU and compared. Launch counters are
   zeroed just before each run and read just after.

The second-to-last line is the ``kernels`` JSON record, the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # dense, no sparsity
GOLDEN_BAND = dict(atol=2e-5, rtol=2e-4)   # tests/test_golden_trajectory.py


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ----------------------------------------------------------------- timing
def host_ms(fn, iters: int) -> float:
    """Time per call of ``fn`` called back to back from Python (CUDA
    events around the loop, after a warm-up). At small shapes this is the
    host's cost of a call — checks, allocation, the launch itself — not
    the card's."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int, reps: int = 3) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events, so the host's cost
    of each call is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (reps * iters)


def bound(nbytes: float, flops: float, dtype: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def close(got, want, atol: float, rtol: float) -> float:
    """Max |got - want|; raises unless within ``atol + rtol·|want|``."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool((err <= atol + rtol * w.abs()).all())
    worst = float(err.max()) if err.numel() else 0.0
    require(ok, f"mismatch: max abs err {worst} (atol={atol}, rtol={rtol})")
    require(bool(torch.isfinite(g).all()), "non-finite kernel output")
    return worst


# ------------------------------------------------------- kernels vs plain
def tie_rows(x, qmax: float, every: int):
    """Overwrite every ``every``-th row so that absmax == qmax (scale 1.0)
    and the other values sit on .5 ties: half-to-even and half-away
    rounding give different codes there."""
    import torch
    nb, block = x.shape
    vals = (torch.arange(block - 1, device=x.device) % (2 * int(qmax) - 1)
            - (qmax - 1)) + 0.5
    x[::every, 0] = qmax
    x[::every, 1:] = vals
    return x


def check_quantize(nb: int, bits: int, seed: int, iters: int) -> dict:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.quantize import (dequantize_blocks_2d,
                                              quantize_blocks_2d)
    g = torch.Generator(device="cuda").manual_seed(seed)
    qmax = float(2 ** (bits - 1) - 1)
    x = torch.randn((nb, 256), generator=g, device="cuda") * 3.0
    x = tie_rows(x, qmax, 7).contiguous()
    q, s = quantize_blocks_2d(x, bits=bits, block=256)
    q_r, s_r = ref.quantize_blocks_ref(x, bits)
    torch.cuda.synchronize()
    require(torch.equal(q, q_r), f"quantize codes differ (bits={bits})")
    require(torch.equal(s, s_r), f"quantize scales differ (bits={bits})")
    d = dequantize_blocks_2d(q, s, block=256)
    d_r = ref.dequantize_blocks_ref(q_r, s_r)
    require(torch.equal(d, d_r), "dequantize differs")
    # the one PyTorch call with the same function: int8 · f32 promotes to f32
    require(torch.equal(d, torch.mul(q, s[:, None])), "dequantize != torch.mul")
    n = nb * 256
    rows = []
    for name, kern, plain, lib, nbytes, flops in (
            ("quantize_blocks_2d",
             lambda: quantize_blocks_2d(x, bits=bits, block=256),
             lambda: ref.quantize_blocks_ref(x, bits), None,
             4 * n + n + 4 * nb, 4 * n),
            ("dequantize_blocks_2d",
             lambda: dequantize_blocks_2d(q, s, block=256),
             lambda: ref.dequantize_blocks_ref(q, s),
             lambda: torch.mul(q, s[:, None]),
             n + 4 * nb + 4 * n, n)):
        b_ms, b_by = bound(nbytes, flops, "float32")
        rows.append(dict(name=name, shape=[nb, 256], bits=bits,
                         max_abs_err=0.0, ms=time_ms(kern, iters),
                         host_ms=host_ms(kern, iters),
                         plain_ms=time_ms(plain, iters),
                         bound_ms=b_ms, bound_by=b_by,
                         library_ms=None if lib is None
                         else time_ms(lib, iters)))
    return {r["name"]: r for r in rows}


def check_fused_dense(M: int, K: int, N: int, act: str, dtype, seed: int,
                      iters: int) -> dict:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_dense import fused_dense
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
    w = (torch.randn((K, N), generator=g, device="cuda")
         * K ** -0.5).to(dtype)
    b = torch.randn((N,), generator=g, device="cuda").to(dtype)
    got = fused_dense(x, w, b, act=act)
    want = ref.fused_dense_ref(x, w, b, act)
    torch.cuda.synchronize()
    require(got.dtype == dtype, "fused_dense output dtype")
    # float32: FMA accumulation in another order than cuBLAS, no TF32;
    # bfloat16: one bf16 ulp where the float32 sums round differently
    tol = (dict(atol=1e-5, rtol=1e-4) if dtype == torch.float32
           else dict(atol=5e-2, rtol=1e-2))
    err = close(got, want, **tol)
    es = x.element_size()
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    b_ms, b_by = bound(es * (M * K + K * N + N + M * N), 2.0 * M * K * N,
                       dname)
    lib_ms = None
    if act == "linear":
        lib_ms = time_ms(lambda: torch.addmm(b, x, w), iters)
    kern = lambda: fused_dense(x, w, b, act=act)             # noqa: E731
    return dict(name="fused_dense", shape=[M, K, N], act=act, dtype=dname,
                max_abs_err=err, ms=time_ms(kern, iters),
                host_ms=host_ms(kern, iters),
                plain_ms=time_ms(lambda: ref.fused_dense_ref(x, w, b, act),
                                 iters),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def check_decode_agg(C: int, M: int, K: int, N: int, seed: int,
                     iters: int) -> dict:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_decode_agg import fused_decode_agg
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn((C, M, K), generator=g, device="cuda")
    w = torch.rand((C,), generator=g, device="cuda") + 0.1
    w = (w / w.sum()).contiguous()
    wl = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
    bl = torch.randn((N,), generator=g, device="cuda")
    got = fused_decode_agg(h, w, wl, bl)
    want = ref.fused_decode_agg_ref(h, w, wl, bl)
    torch.cuda.synchronize()
    err = close(got, want, atol=2e-5, rtol=1e-4)   # tests/test_kernels.py
    # a client with weight ~1 must dominate (weighting, not averaging)
    h2 = torch.stack([torch.ones((16, 8), device="cuda"),
                      100.0 * torch.ones((16, 8), device="cuda")])
    probe = fused_decode_agg(h2, torch.tensor([0.999, 0.001], device="cuda"),
                             torch.eye(8, device="cuda"),
                             torch.zeros(8, device="cuda"))
    close(probe, torch.full((16, 8), 0.999 + 0.1, device="cuda"), 0.0, 1e-5)
    b_ms, b_by = bound(4 * (C * M * K + C + K * N + N + M * N),
                       2.0 * C * M * K + 2.0 * M * K * N + M * N, "float32")
    kern = lambda: fused_decode_agg(h, w, wl, bl)            # noqa: E731
    return dict(name="fused_decode_agg", shape=[C, M, K, N], max_abs_err=err,
                ms=time_ms(kern, iters), host_ms=host_ms(kern, iters),
                plain_ms=time_ms(lambda: ref.fused_decode_agg_ref(
                    h, w, wl, bl), iters),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


# ------------------------------------------------------------------ slice
def run_golden(device: str):
    """Run (a): the golden configuration (tests/test_golden_trajectory.py)."""
    from repro_torch.configs.paper import MNIST_CLASSIFIER
    from repro_torch.core import FederatedRun, FLConfig, QuantizeCompressor
    from repro_torch.data.pipeline import (mnist_like, train_eval_split,
                                           uniform_partition)
    train, ev = train_eval_split(mnist_like(0, 256), 64)
    run = FederatedRun(
        MNIST_CLASSIFIER, uniform_partition(0, train, 3),
        FLConfig(n_rounds=2, local_epochs=1, payload="update",
                 error_feedback=True, seed=0),
        compressors=[QuantizeCompressor(bits=8) for _ in range(3)],
        eval_data=ev, device=device)
    return run, run.run()


def run_fc_ae(device: str):
    """Run (b): pre-pass + FC-AE training, then the FC-AE FL run
    (tests/test_system.py)."""
    import torch
    from repro_torch.configs.paper import MNIST_AE, MNIST_CLASSIFIER
    from repro_torch.core import (FCAECompressor, FederatedRun, FLConfig,
                                  run_prepass)
    from repro_torch.data.pipeline import (dirichlet_partition, mnist_like,
                                           train_eval_split)
    out = run_prepass(torch.Generator().manual_seed(0), MNIST_CLASSIFIER,
                      MNIST_AE, mnist_like(0, 512), prepass_epochs=12,
                      ae_epochs=200, device=device)
    train, ev = train_eval_split(mnist_like(1, 768), 256)
    run = FederatedRun(
        MNIST_CLASSIFIER, dirichlet_partition(0, train, 2, alpha=1.0),
        FLConfig(n_rounds=2, local_epochs=1, error_feedback=True),
        compressors=[FCAECompressor(out["ae_params"], MNIST_AE)
                     for _ in range(2)],
        eval_data=ev, device=device)
    return out, run, run.run()


def run_chunked(device: str):
    """Run (c): kernel-path chunked AE at the default ChunkedAEConfig()."""
    import torch
    from repro_torch.configs.paper import MNIST_CLASSIFIER
    from repro_torch.core import (ChunkedAECompressor, ChunkedAEConfig,
                                  FederatedRun, FLConfig, init_chunked_ae)
    from repro_torch.data.pipeline import (mnist_like, train_eval_split,
                                           uniform_partition)
    cfg = ChunkedAEConfig()
    params = init_chunked_ae(torch.Generator().manual_seed(2), cfg, device)
    train, ev = train_eval_split(mnist_like(0, 256), 64)
    run = FederatedRun(
        MNIST_CLASSIFIER, uniform_partition(0, train, 3),
        FLConfig(n_rounds=2, local_epochs=1, payload="update",
                 error_feedback=True, seed=0),
        compressors=[ChunkedAECompressor(params, cfg, use_kernel=True)
                     for _ in range(3)],
        eval_data=ev, device=device)
    return run, run.run()


def check_records(hist, up: float, raw: float, down: float) -> None:
    for r in hist:
        require(r.bytes_up == up, f"bytes_up {r.bytes_up} != {up}")
        require(r.bytes_up_raw == raw, f"bytes_up_raw {r.bytes_up_raw}")
        require(r.bytes_down == down, f"bytes_down {r.bytes_down}")
        require(math.isfinite(r.global_metrics["loss"]), "non-finite loss")


def check_cuda_vs_cpu(tag: str, run_gpu, hist_gpu, run_cpu, hist_cpu) -> float:
    """The same run on the card and on the CPU: bytes exact; loss,
    accuracy and the final global parameters within the golden band.
    Returns the largest parameter difference."""
    from repro_torch.core.pytree import ravel
    band = GOLDEN_BAND["atol"], GOLDEN_BAND["rtol"]
    for g, c in zip(hist_gpu, hist_cpu, strict=True):
        for k in ("bytes_up", "bytes_up_raw", "bytes_down",
                  "compression_ratio"):
            require(getattr(g, k) == getattr(c, k),
                    f"{tag}: cuda/cpu {k} differ")
        for k in ("loss", "accuracy"):
            gv, cv = g.global_metrics[k], c.global_metrics[k]
            require(abs(gv - cv) <= band[0] + band[1] * abs(cv),
                    f"{tag}: cuda/cpu {k} differ beyond the golden band: "
                    f"{gv} {cv}")
    pg = ravel(run_gpu.global_params)[0].cpu()
    pc = ravel(run_cpu.global_params)[0]
    try:
        return close(pg, pc, *band)
    except AssertionError as e:
        raise AssertionError(f"{tag}: cuda/cpu global params: {e}") from None


def main() -> int:
    # ---------------------------------------------------------- 1. device
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    require(Path(repro_torch.__file__).resolve().is_relative_to(ROOT),
            "repro_torch must come from this checkout")
    from repro_torch.kernels import _lib
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 references
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")

    # ----------------------------------------------------------- 2. build
    path, secs, ptxas = _lib.build()
    log(f"build: {len(_lib.SOURCES)} sources -> {path.name} in {secs:.1f} s")
    entry, spills = "?", ""
    for line in ptxas.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line:
            log(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}; {spills}")

    # -------------------------------------------------- 3. kernels vs plain
    slice_rows = {}
    slice_rows.update(check_quantize(63, 8, 0, 200))        # 15,910 / 256
    check_quantize(189, 4, 1, 20)                           # 4-bit ties
    # every layer shape of run (c): client encode 4096→512→8, client EF
    # decode and server decode 8→512→4096 (4 chunks a client, 3 clients)
    fd = [check_fused_dense(4, 4096, 512, "relu", torch.float32, 2, 50),
          check_fused_dense(4, 512, 8, "relu", torch.float32, 11, 50),
          check_fused_dense(4, 8, 512, "relu", torch.float32, 12, 50),
          check_fused_dense(4, 512, 4096, "linear", torch.float32, 3, 50),
          check_fused_dense(12, 8, 512, "relu", torch.float32, 4, 50),
          check_fused_dense(4096, 256, 32, "relu", torch.bfloat16, 5, 50)]
    slice_rows["fused_dense"] = fd[0]
    slice_rows["fused_decode_agg"] = check_decode_agg(3, 4, 512, 4096, 6, 50)
    cohort = list(check_quantize(256 * 4096, 8, 7, 10).values())
    cohort.append(check_fused_dense(256 * 4096, 8, 32, "relu",
                                    torch.float32, 8, 10))
    cohort.append(check_fused_dense(256 * 4096, 32, 256, "linear",
                                    torch.float32, 9, 5))
    cohort.append(check_decode_agg(256, 4096, 32, 256, 10, 10))
    for r in fd[1:] + cohort:
        log("kernel " + json.dumps(r))
    log("kernels vs plain: all within tolerance")

    # ------------------------------------------------------------ 4. slice
    launches = {}
    _lib.reset_launches()
    run_a, hist_a = run_golden("cuda")
    torch.cuda.synchronize()
    counts_a = _lib.counts()
    log(f"slice (a) q8 golden config: launches {counts_a}; "
        + "; ".join(f"r{r.round} loss {r.global_metrics['loss']!r} acc "
                    f"{r.global_metrics['accuracy']!r}" for r in hist_a))
    check_records(hist_a, 3 * (63 * 256 + 63 * 4), 3 * 15_910 * 4,
                  3 * 15_910 * 4)
    for k in ("quantize_blocks_2d", "dequantize_blocks_2d"):
        require(counts_a.get(k, 0) > 0, f"run (a) never launched {k}")
        launches[k] = counts_a[k]
    err = check_cuda_vs_cpu("run (a)", run_a, hist_a, *run_golden("cpu"))
    log("slice (a) cuda == cpu: bytes exact, loss/accuracy/params within "
        f"atol=2e-5 rtol=2e-4 (params max abs err {err!r})")

    _lib.reset_launches()
    t0 = time.perf_counter()
    pre, run_b, hist_b = run_fc_ae("cuda")
    torch.cuda.synchronize()
    counts_b = _lib.counts()
    ae_hist = pre["ae_history"]["loss"]
    log(f"slice (b) prepass + FC-AE: {time.perf_counter() - t0:.1f} s, AE "
        f"loss {ae_hist[0]!r} -> {ae_hist[-1]!r}, ratio "
        f"{hist_b[-1].compression_ratio!r}, launches {counts_b} (the FC AE "
        "is plain matrix products)")
    require(ae_hist[-1] < ae_hist[0], "AE training did not descend")
    check_records(hist_b, 2 * 32 * 4, 2 * 15_910 * 4, 2 * 15_910 * 4)
    require(hist_b[-1].compression_ratio > 300, "FC-AE ratio <= 300")
    require(run_b.total_bytes()["effective_ratio"] > 300, "effective ratio")

    _lib.reset_launches()
    run_c, hist_c = run_chunked("cuda")
    torch.cuda.synchronize()
    counts_c = _lib.counts()
    log(f"slice (c) chunked AE 4096/(512,)/8 kernel path: launches "
        f"{counts_c}; loss {hist_c[-1].global_metrics['loss']!r}")
    check_records(hist_c, 3 * 4 * 8 * 4, 3 * 15_910 * 4, 3 * 15_910 * 4)
    for k in ("fused_dense", "fused_decode_agg"):
        require(counts_c.get(k, 0) > 0, f"run (c) never launched {k}")
        launches[k] = counts_c[k]
    err = check_cuda_vs_cpu("run (c)", run_c, hist_c, *run_chunked("cpu"))
    log("slice (c) cuda == cpu: bytes exact, loss/accuracy/params within "
        f"atol=2e-5 rtol=2e-4 (params max abs err {err!r})")

    # ---------------------------------------------------------- 5. report
    src = {"quantize_blocks_2d": ("src/repro_torch/csrc/quantize.cu",
                                  "src/repro/kernels/quantize.py:22"),
           "dequantize_blocks_2d": ("src/repro_torch/csrc/quantize.cu",
                                    "src/repro/kernels/quantize.py:31"),
           "fused_dense": ("src/repro_torch/csrc/fused_dense.cu",
                           "src/repro/kernels/fused_dense.py:39"),
           "fused_decode_agg": ("src/repro_torch/csrc/fused_decode_agg.cu",
                                "src/repro/kernels/fused_decode_agg.py:53")}
    kernels = []
    for name, (source, replaces) in src.items():
        r = slice_rows[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            host_ms=r["host_ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"], shape=r["shape"]))
    for line in smi:
        log(line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
