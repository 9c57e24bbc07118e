"""Chip smoke test for the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device — requires CUDA (exits non-zero without it) and prints the card's
   name and power limit as ``nvidia-smi`` reports them;
2. build — compiles the kernels of the six TPU kernels from
   ``src/repro_torch/csrc`` with ``nvcc`` for ``sm_90a`` (one process a
   source, in parallel) and prints ``ptxas``'s registers, shared memory
   and spills per kernel;
3. kernels vs plain — every kernel against its plain PyTorch version on
   the card, at every shape the slice gives it and at the cohort scale of
   the ``fl_decode_agg`` table (flat update 2^20, ``ChunkedAEConfig(256,
   (32,), 8)``, cohort 256), with times, bounds and the library call. The
   grouped decode→aggregate is also held bucket by bucket against the
   per-bucket kernel (bit-equal) and timed beside it, at run (d)'s shapes,
   a ragged round and the cohort point of the ``fl_partition`` table.
   Flash attention (kernel 6) runs at run (f)'s shape (bf16, causal,
   beside ``scaled_dot_product_attention`` as the library call), at a
   window and a full, kv-padded shape, and in float32 at head dim 64.
   Kernels 3 and 6 have two routes each, named in every row as
   ``kernel_route``: ``fused_dense`` at M <= 16 ``splitk``, else
   ``tiled``; flash attention in bf16 ``wgmma``, in float32 ``fma``.
   ``fused_dense``'s ``library_ms`` is ``torch.addmm(b, x, w)`` at every
   shape, which leaves out a relu, tanh or sigmoid (``library_call`` says
   so). ``ms``, ``plain_ms``, ``library_ms`` and ``per_bucket_ms`` are
   device times (calls captured in a CUDA graph and replayed); ``host_ms``
   is the time per call of the wrapper called back to back from Python;
4. slice — the paper's pipeline through the port's entry points on
   ``cuda`` with the MNIST MLP at full width: (a) SyncFedAvg, 3 clients,
   q8, update payload + error feedback, 2 rounds; (b) ``run_prepass``
   with ``MNIST_AE`` then an FC-AE run; (c) a kernel-path
   ``ChunkedAECompressor`` run at the default ``ChunkedAEConfig()``;
   (d) a partitioned cohort (dense0 on two chunked-AE rungs, dense1 on
   q8/q4) and (e) a flat mixed cohort (two chunked-AE rungs, q8, q4), both
   with ``use_grouped_kernel=True``. Runs (a), (c), (d) and (e) are
   repeated on the CPU and compared; (d) and (e) also against the same run
   with the grouped round off. Launch counters are zeroed just before each
   run and read just after;
5. LM serving — the dense GQA model zoo through ``prefill`` and
   ``decode_step``: (f) deepseek-coder-33b at full width (d_model 7168, 56
   query heads over 8 KV heads, d_ff 19,200, vocab 32,256), 16 of its 62
   layers, its own dtypes (float32 parameters, bf16 compute), weights drawn
   on the card from a seed; 4 prompts of 1,024 tokens from
   ``synthetic_lm_batch``, then 16 greedy decode steps; flash attention
   must launch once a layer in prefill and never in decode; one more
   prefill then holds each layer's kernel-6 call against the plain version
   at the model's own inputs. (g) the same architecture at 2 layers in
   float32 compute, on the card and on the CPU from the same weights (1
   prompt of 128 tokens, 4 decode steps, the CPU fed the card's tokens):
   logits and cache within ``atol=1e-4, rtol=1e-3``; and a prefill in
   bf16 compute on both, within twice the CPU's own bf16-vs-float32
   error.

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
# kernel 6 against its plain version: float32 at the reference's
# Pallas-vs-oracle tolerance (tests/test_kernels.py); bfloat16 at two ulps
# of the output (2 * 2**-7 relative, 1e-3 near zero), since both sum in
# float32 and round once, so they differ by at most one ulp
FLASH_F32_TOL = dict(atol=3e-5, rtol=1e-3)
FLASH_BF16_TOL = dict(atol=1e-3, rtol=1.6e-2)


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
    from repro_torch.kernels.fused_dense import fused_dense, kernel_route
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
    # the library call computes x @ w + b; the activation is left out
    lib_ms = time_ms(lambda: torch.addmm(b, x, w), iters)
    kern = lambda: fused_dense(x, w, b, act=act)             # noqa: E731
    return dict(name="fused_dense", shape=[M, K, N], act=act, dtype=dname,
                kernel_route=kernel_route(M), max_abs_err=err,
                library_call="torch.addmm" + (
                    "" if act == "linear" else f" (without the {act})"),
                ms=time_ms(kern, iters),
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


def check_grouped_decode_agg(shapes, K: int, N: int, dec_idx, seed: int,
                             iters: int) -> dict:
    """The grouped ragged launch on buckets of ``(C_b, M_b)``: against its
    plain version, and each bucket bit-equal to the per-bucket kernel
    (``fused_decode_agg``) on that bucket alone, an empty bucket exact
    zeros. ``ms`` times the launch of a plan built once (the plan's table
    copy is the host's work, in ``host_ms`` with the whole wrapper);
    ``per_bucket_ms`` is the per-bucket kernel launched once per live
    bucket, the yardstick where no single PyTorch call computes this."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_decode_agg import (
        fused_decode_agg, grouped_fused_decode_agg, grouped_launch,
        grouped_plan)
    g = torch.Generator(device="cuda").manual_seed(seed)
    D = max(dec_idx) + 1
    hs, ws = [], []
    for C_b, M_b in shapes:
        hs.append(torch.randn((C_b, M_b, K), generator=g, device="cuda"))
        w = torch.rand((C_b,), generator=g, device="cuda") + 0.1
        ws.append((w / w.sum() if C_b else w).contiguous())
    w_stack = torch.randn((D, K, N), generator=g, device="cuda") * K ** -0.5
    b_stack = torch.randn((D, N), generator=g, device="cuda")
    decs = [(w_stack[d].contiguous(), b_stack[d].contiguous())
            for d in range(D)]
    args = (hs, ws, w_stack, b_stack, dec_idx)
    got = grouped_fused_decode_agg(*args)
    want = ref.grouped_fused_decode_agg_ref(*args)
    live = [b for b, h in enumerate(hs) if h.shape[0] > 0]
    torch.cuda.synchronize()
    err = 0.0
    for b, (h, gb, wb) in enumerate(zip(hs, got, want)):
        require(tuple(gb.shape) == (h.shape[1], N), "grouped output shape")
        if b not in live:
            require(not bool(gb.any()), "empty bucket is not exact zeros")
            continue
        err = max(err, close(gb, wb, atol=2e-5, rtol=1e-4))
        per = fused_decode_agg(h, ws[b], *decs[dec_idx[b]])
        require(torch.equal(gb, per),
                f"bucket {b}: grouped != per-bucket kernel (bit-equality)")
    plan = grouped_plan(*args)
    n_bytes = 4 * (sum(h.numel() for h in hs) + sum(w.numel() for w in ws)
                   + D * (K * N + N) + sum(h.shape[1] for h in hs) * N)
    flops = sum(2.0 * h.numel() + 2.0 * h.shape[1] * K * N + h.shape[1] * N
                for h in hs if h.shape[0] > 0)
    b_ms, b_by = bound(n_bytes, flops, "float32")
    return dict(
        name="grouped_fused_decode_agg", shape=[list(s) for s in shapes],
        K=K, N=N, dec_idx=list(dec_idx), bm=plan.bm, cols=plan.cols,
        tiles=plan.tiles, max_abs_err=err, bit_equal_per_bucket=True,
        ms=time_ms(lambda: grouped_launch(plan), iters),
        host_ms=host_ms(lambda: grouped_fused_decode_agg(*args), iters),
        plain_ms=time_ms(lambda: ref.grouped_fused_decode_agg_ref(*args),
                         iters),
        per_bucket_ms=time_ms(lambda: [fused_decode_agg(
            hs[b], ws[b], *decs[dec_idx[b]]) for b in live], iters),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def attention_pairs(Sq: int, Skv: int, mode: str, window) -> int:
    """(query, key) pairs the mask lets through, for one (batch, head)."""
    total = 0
    for i in range(Sq):
        hi = Skv if mode == "full" else min(i + 1, Skv)
        lo = max(0, i - window + 1) if mode == "window" else 0
        total += max(0, hi - lo)
    return total


def check_flash(B: int, Sq: int, Skv: int, H: int, KV: int, D: int,
                mode: str, window, dtype, seed: int, iters: int) -> dict:
    """Kernel 6 against its plain version. ``bound_ms``: q, k, v and the
    output moved once, against 4·D operations for each (query, key) pair
    the mask lets through at the input type's peak; ``library_ms``:
    ``scaled_dot_product_attention`` on the (B, H, S, D) views, in causal
    mode with ``Sq == Skv`` only (its causal mask is the same there)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     kernel_route)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, Skv, KV, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, Skv, KV, D), generator=g, device="cuda").to(dtype)
    got = flash_attention(q, k, v, mode=mode, window=window)
    want = ref.flash_attention_ref(q, k, v, mode=mode, window=window)
    torch.cuda.synchronize()
    require(got.dtype == dtype and got.shape == q.shape, "flash output")
    tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    err = close(got, want, **tol)
    es = q.element_size()
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    pairs = B * H * attention_pairs(Sq, Skv, mode, window)
    b_ms, b_by = bound(es * (2 * B * Sq * H * D + 2 * B * Skv * KV * D),
                       4.0 * D * pairs, dname)
    lib_ms = lib_err = None
    if mode == "causal" and Sq == Skv:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        lib_err = float((lib.transpose(1, 2).float() - want.float()).abs()
                        .max())
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters)
    kern = lambda: flash_attention(q, k, v, mode=mode,       # noqa: E731
                                   window=window)
    return dict(name="flash_attention", shape=[B, Sq, Skv, H, KV, D],
                mode=mode, window=window, dtype=dname,
                kernel_route=kernel_route(dtype), max_abs_err=err,
                ms=time_ms(kern, iters), host_ms=host_ms(kern, iters),
                plain_ms=time_ms(lambda: ref.flash_attention_ref(
                    q, k, v, mode=mode, window=window), iters),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                library_max_abs_err=lib_err, gflop=4.0 * D * pairs / 1e9)


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


def _rung_params(device: str):
    """Two kernel-path chunked-AE rungs at full width: the default
    ``ChunkedAEConfig()`` (4096/(512,)/8) and its latent-4 sibling, each
    freshly initialised from a seed; one params object per rung."""
    import torch
    from repro_torch.core import ChunkedAEConfig, init_chunked_ae
    cfgs = (ChunkedAEConfig(), ChunkedAEConfig(latent_chunk=4))
    return cfgs, [init_chunked_ae(torch.Generator().manual_seed(2 + i), c,
                                  device) for i, c in enumerate(cfgs)]


def _four_client_run(device: str, comps, grouped: bool):
    from repro_torch.configs.paper import MNIST_CLASSIFIER
    from repro_torch.core import FederatedRun, FLConfig
    from repro_torch.data.pipeline import (mnist_like, train_eval_split,
                                           uniform_partition)
    # 128 examples a client: two local batches of 64
    train, ev = train_eval_split(mnist_like(0, 576), 64)
    run = FederatedRun(
        MNIST_CLASSIFIER, uniform_partition(0, train, 4),
        FLConfig(n_rounds=2, local_epochs=1, payload="update",
                 error_feedback=True, use_grouped_kernel=grouped, seed=0),
        compressors=comps, eval_data=ev, device=device)
    return run, run.run()


def run_partitioned(device: str, grouped: bool = True):
    """Run (d): ``by_layer_partition`` of the MLP; dense0 (15,700 values)
    on the chunked AE, clients 0-1 latent 8 and 2-3 latent 4 (one grouped
    launch, two decoder slots a round); dense1 (210) q8 for even clients,
    q4 for odd."""
    import torch
    from repro_torch.configs.paper import MNIST_CLASSIFIER
    from repro_torch.core import (ChunkedAECompressor, PartitionedCompressor,
                                  QuantizeCompressor, by_layer_partition)
    from repro_torch.models.classifiers import init_classifier
    pmap = by_layer_partition(init_classifier(torch.Generator(),
                                              MNIST_CLASSIFIER, device))
    cfgs, prms = _rung_params(device)
    comps = [PartitionedCompressor(pmap, {
        "dense0": ChunkedAECompressor(prms[i // 2], cfgs[i // 2],
                                      use_kernel=True),
        "dense1": QuantizeCompressor(bits=8 if i % 2 == 0 else 4)})
        for i in range(4)]
    return _four_client_run(device, comps, grouped)


def run_flat_mixed(device: str, grouped: bool = True):
    """Run (e): a flat mixed cohort — chunked AE latent 8, latent 4, q8,
    q4 — through ``grouped_flat_server_aggregate``."""
    from repro_torch.core import ChunkedAECompressor, QuantizeCompressor
    cfgs, prms = _rung_params(device)
    comps = [ChunkedAECompressor(prms[0], cfgs[0], use_kernel=True),
             ChunkedAECompressor(prms[1], cfgs[1], use_kernel=True),
             QuantizeCompressor(bits=8), QuantizeCompressor(bits=4)]
    return _four_client_run(device, comps, grouped)


def deepseek(n_layers: int, **changes):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("deepseek-coder-33b"),
                               n_layers=n_layers, **changes)


def in_model_flash_errs(run) -> list:
    """Call ``run()`` with every kernel-6 call that the model makes held
    against the plain version on the same inputs: the model's own q, k and
    v after the rope, the cast to the compute type and ``.contiguous()``.
    Returns each call's max abs err; raises outside the tolerance."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models import attention
    kernel = attention.flash_kernel
    errs = []

    def checked(q, k, v, *, mode, window):
        out = kernel(q, k, v, mode=mode, window=window)
        want = ref.flash_attention_ref(q, k, v, mode=mode, window=window)
        tol = FLASH_F32_TOL if q.dtype == torch.float32 else FLASH_BF16_TOL
        errs.append(close(out, want, **tol))
        return out

    attention.flash_kernel = checked
    try:
        run()
    finally:
        attention.flash_kernel = kernel
    return errs


def run_lm_serving() -> dict:
    """Run (f): deepseek-coder-33b at full width, 16 layers, serving 4
    prompts of 1,024 tokens then 16 greedy decode steps on the card."""
    import torch
    from repro_torch import models
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.kernels import _lib
    B, S, steps = 4, 1024, 16
    cfg = deepseek(16)
    t0 = time.perf_counter()
    params = models.init_params(torch.Generator(device="cuda").manual_seed(0),
                                cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = models.param_count(params)
    require(n_params == 8_947_735_552, f"run (f) holds {n_params} parameters")
    batch = {k: t.cuda() for k, t in
             synthetic_lm_batch(0, cfg.vocab_size, B, S).items()}
    models.prefill(params, cfg, batch, S + steps)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    t0 = time.perf_counter()
    logits, cache = models.prefill(params, cfg, batch, S + steps)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts_prefill = _lib.counts()
    require(counts_prefill == {"flash_attention": cfg.n_layers},
            f"run (f) prefill launches {counts_prefill}")
    require(tuple(logits.shape) == (B, cfg.padded_vocab), "logits shape")
    require(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    seen = cache["layers"]["k"].abs().amax(dim=(-1, -2)) > 0  # (L, B, C)
    require(cache["index"] == S and bool(seen[:, :, :S].all())
            and not bool(seen[:, :, S:].any()), "prefill cache not filled")
    _lib.reset_launches()
    step_s = []
    tokens = []
    for _ in range(steps):
        token = logits[:, :cfg.vocab_size].argmax(-1)[:, None]
        tokens.append(token)
        t0 = time.perf_counter()
        logits, cache = models.decode_step(params, cfg, token, cache)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        require(bool(torch.isfinite(logits).all()), "non-finite decode")
    counts_decode = _lib.counts()
    require(counts_decode == {}, f"run (f) decode launches {counts_decode}")
    seen = cache["layers"]["k"].abs().amax(dim=(-1, -2)) > 0
    require(cache["index"] == S + steps and bool(seen.all()),
            "decode did not fill the cache")
    peak = torch.cuda.max_memory_allocated()
    # after the counts and the peak were read: one more prefill, each
    # layer's kernel-6 call held against the plain version at the model's
    # own inputs
    attn_errs = in_model_flash_errs(
        lambda: models.prefill(params, cfg, batch, S + steps))
    require(len(attn_errs) == cfg.n_layers, "in-model kernel-6 checks")
    return dict(arch=cfg.name, n_layers=cfg.n_layers, params=n_params,
                batch=B, prompt=S, decode_steps=steps, init_s=init_s,
                prefill_s=prefill_s, prefill_tokens_per_s=B * S / prefill_s,
                decode_step_s=step_s,
                decode_step_median_s=sorted(step_s)[steps // 2],
                peak_memory_bytes=peak,
                launches_prefill=counts_prefill,
                launches_decode=counts_decode,
                attention_in_model_max_abs_err=attn_errs,
                first_tokens=torch.cat(tokens, 1)[:, :4].tolist())


def bf16_close(card, cpu, cpu_f32, tag: str) -> dict:
    """The card's bfloat16 result against the CPU's, relative to bfloat16
    rounding: both round at every cast to the compute type, so the card may
    differ from the CPU by at most twice the CPU's own bfloat16 error (its
    distance from the same model in float32 compute)."""
    import torch
    err = float((card.cpu().float() - cpu.float()).abs().max())
    own = float((cpu.float() - cpu_f32.float()).abs().max())
    require(bool(torch.isfinite(card).all()) and err <= 2 * own,
            f"run (g) bfloat16 {tag}: card vs CPU max abs err {err} > 2 x "
            f"the CPU's bfloat16-vs-float32 error {own}")
    return dict(max_abs_err=err, cpu_bf16_vs_f32=own)


def run_lm_card_vs_cpu() -> dict:
    """Run (g): 2 layers in float32 compute, the card against the CPU from
    the same weights; the CPU decode is fed the card's greedy tokens. Then
    a prefill in the config's own bfloat16 compute on both, held against
    the CPU by ``bf16_close``."""
    import torch
    from repro_torch import models
    from repro_torch.core.pytree import tree_map
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.kernels import _lib
    cfg = deepseek(2, compute_dtype="float32")
    tol = dict(atol=1e-4, rtol=1e-3)
    gparams = models.init_params(
        torch.Generator(device="cuda").manual_seed(1), cfg, "cuda")
    cparams = tree_map(lambda t: t.cpu(), gparams)
    n_params = models.param_count(gparams)
    require(n_params == 1_523_092_480, f"run (g) holds {n_params}")
    batch = synthetic_lm_batch(1, cfg.vocab_size, 1, 128)
    gbatch = {k: t.cuda() for k, t in batch.items()}
    _lib.reset_launches()
    glogits, gcache = models.prefill(gparams, cfg, gbatch, 132)
    torch.cuda.synchronize()
    counts = _lib.counts()
    require(counts == {"flash_attention": cfg.n_layers},
            f"run (g) prefill launches {counts}")
    clogits, ccache = models.prefill(cparams, cfg, batch, 132)
    errs = [close(glogits.cpu(), clogits, **tol)]
    bcfg = deepseek(2)                        # bfloat16 compute
    _lib.reset_launches()
    blogits, bcache = models.prefill(gparams, bcfg, gbatch, 132)
    torch.cuda.synchronize()
    require(_lib.counts() == {"flash_attention": bcfg.n_layers},
            f"run (g) bfloat16 prefill launches {_lib.counts()}")
    clogits16, ccache16 = models.prefill(cparams, bcfg, batch, 132)
    bf16 = {"logits": bf16_close(blogits, clogits16, clogits, "logits")}
    for k in ("k", "v"):
        bf16[f"cache_{k}"] = bf16_close(bcache["layers"][k],
                                        ccache16["layers"][k],
                                        ccache["layers"][k], f"cache {k}")
    del blogits, bcache, clogits16, ccache16
    for _ in range(4):
        token = glogits[:, :cfg.vocab_size].argmax(-1)[:, None]
        glogits, gcache = models.decode_step(gparams, cfg, token, gcache)
        clogits, ccache = models.decode_step(cparams, cfg, token.cpu(),
                                             ccache)
        errs.append(close(glogits.cpu(), clogits, **tol))
    require(gcache["index"] == ccache["index"] == 132, "cache index")
    cache_err = max(close(gcache["layers"][k].cpu(), ccache["layers"][k],
                          **tol) for k in ("k", "v"))
    return dict(arch=cfg.name, n_layers=cfg.n_layers, params=n_params,
                logits_max_abs_err=errs, cache_max_abs_err=cache_err,
                bf16_prefill=bf16)


def check_records(hist, up: float, raw: float, down: float) -> None:
    for r in hist:
        require(r.bytes_up == up, f"bytes_up {r.bytes_up} != {up}")
        require(r.bytes_up_raw == raw, f"bytes_up_raw {r.bytes_up_raw}")
        require(r.bytes_down == down, f"bytes_down {r.bytes_down}")
        require(math.isfinite(r.global_metrics["loss"]), "non-finite loss")


def check_cuda_vs_cpu(tag: str, run_gpu, hist_gpu, run_cpu, hist_cpu,
                      atol: float = GOLDEN_BAND["atol"],
                      rtol: float = GOLDEN_BAND["rtol"]) -> float:
    """Two runs of one configuration (the card and the CPU, or grouped and
    sequential): bytes exact; loss, accuracy and the final global
    parameters within ``atol``/``rtol`` (the golden band by default).
    Returns the largest parameter difference."""
    from repro_torch.core.pytree import ravel
    for g, c in zip(hist_gpu, hist_cpu, strict=True):
        for k in ("bytes_up", "bytes_up_raw", "bytes_down",
                  "compression_ratio"):
            require(getattr(g, k) == getattr(c, k), f"{tag}: {k} differ")
        for k in ("loss", "accuracy"):
            gv, cv = g.global_metrics[k], c.global_metrics[k]
            require(abs(gv - cv) <= atol + rtol * abs(cv),
                    f"{tag}: {k} differ beyond atol={atol} rtol={rtol}: "
                    f"{gv} {cv}")
    pg = ravel(run_gpu.global_params)[0].cpu()
    pc = ravel(run_cpu.global_params)[0].cpu()
    try:
        return close(pg, pc, atol, rtol)
    except AssertionError as e:
        raise AssertionError(f"{tag}: global params: {e}") from None


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
    # run (d)'s launch: 2 rungs of 2 clients, 4 chunks, 512 → 4096, 2 slots
    slice_rows["grouped_fused_decode_agg"] = check_grouped_decode_agg(
        [(2, 4), (2, 4)], 512, 4096, [0, 1], 13, 50)
    # ragged: uneven C_b and M_b, C_b = 1, an empty bucket, a shared slot
    grouped = [check_grouped_decode_agg(
        [(3, 37), (0, 8), (1, 8), (6, 100)], 32, 256, [1, 0, 0, 1], 14, 50)]
    cohort = list(check_quantize(256 * 4096, 8, 7, 10).values())
    cohort.append(check_fused_dense(256 * 4096, 8, 32, "relu",
                                    torch.float32, 8, 10))
    cohort.append(check_fused_dense(256 * 4096, 32, 256, "linear",
                                    torch.float32, 9, 5))
    cohort.append(check_decode_agg(256, 4096, 32, 256, 10, 10))
    # fl_partition's REPRO_BENCH_FULL point: bulk 983,040 = 3,840 chunks of
    # 256, hidden 32, cohort 64 as two rungs of 32 clients, two slots
    cohort.append(check_grouped_decode_agg(
        [(32, 3840), (32, 3840)], 32, 256, [0, 1], 15, 10))
    # kernel 6: run (f)'s attention (deepseek-coder-33b, 4 x 1,024 tokens,
    # 56 query heads over 8 KV heads, head dim 128, bf16, causal); a window;
    # full attention with kv lengths off the 64-row tile; float32 at D = 64
    slice_rows["flash_attention"] = check_flash(
        4, 1024, 1024, 56, 8, 128, "causal", None, torch.bfloat16, 16, 10)
    flash = [check_flash(2, 1000, 1000, 56, 8, 128, "window", 256,
                         torch.bfloat16, 17, 10),
             check_flash(2, 333, 517, 56, 8, 128, "full", None,
                         torch.bfloat16, 18, 10),
             check_flash(2, 512, 512, 32, 32, 64, "causal", None,
                         torch.float32, 19, 10)]
    for r in (fd[1:] + grouped + cohort + [slice_rows["flash_attention"]]
              + flash):
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

    raw4 = 4 * 15_910 * 4
    for tag, runner, up in (("(d) partitioned", run_partitioned,
                             2 * 128 + 2 * 64 + 2 * 260 + 2 * 132),
                            ("(e) flat mixed", run_flat_mixed,
                             128 + 64 + 16_380 + 8_316)):
        _lib.reset_launches()
        run_x, hist_x = runner("cuda")
        torch.cuda.synchronize()
        counts_x = _lib.counts()
        log(f"slice {tag} grouped: launches {counts_x}; "
            + "; ".join(f"r{r.round} loss {r.global_metrics['loss']!r} acc "
                        f"{r.global_metrics['accuracy']!r}" for r in hist_x))
        check_records(hist_x, up, raw4, raw4)
        require(counts_x.get("grouped_fused_decode_agg", 0) > 0,
                f"run {tag} never launched grouped_fused_decode_agg")
        require("fused_decode_agg" not in counts_x,
                f"run {tag} launched the per-bucket fused_decode_agg")
        launches.setdefault("grouped_fused_decode_agg",
                            counts_x["grouped_fused_decode_agg"])
        err = check_cuda_vs_cpu(f"run {tag} cuda/cpu", run_x, hist_x,
                                *runner("cpu"))
        err_off = check_cuda_vs_cpu(f"run {tag} grouped/sequential", run_x,
                                    hist_x, *runner("cuda", grouped=False),
                                    atol=1e-5, rtol=1e-4)
        log(f"slice {tag} cuda == cpu: bytes exact, loss/accuracy/params "
            f"within atol=2e-5 rtol=2e-4 (params max abs err {err!r}); "
            "== grouped off on the card within atol=1e-5 rtol=1e-4 "
            f"(params max abs err {err_off!r})")

    # ----------------------------------------------------- 5. LM serving
    lm = run_lm_serving()
    launches["flash_attention"] = lm["launches_prefill"]["flash_attention"]
    log("lm (f) " + json.dumps(lm))
    log(f"lm (f) deepseek-coder-33b x16 layers: prefill 4 x 1024 tokens in "
        f"{lm['prefill_s']:.4f} s, decode step median "
        f"{lm['decode_step_median_s']:.4f} s, peak "
        f"{lm['peak_memory_bytes'] / 2**30:.2f} GiB; flash_attention "
        f"{lm['launches_prefill']} in prefill, none in decode")
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    lm_g = run_lm_card_vs_cpu()
    log("lm (g) cuda == cpu within atol=1e-4 rtol=1e-3 (float32 compute), "
        "bfloat16 prefill within 2 x the CPU's bfloat16 error: "
        + json.dumps(lm_g))

    # ---------------------------------------------------------- 6. report
    src = {"quantize_blocks_2d": ("src/repro_torch/csrc/quantize.cu",
                                  "src/repro/kernels/quantize.py:22"),
           "dequantize_blocks_2d": ("src/repro_torch/csrc/quantize.cu",
                                    "src/repro/kernels/quantize.py:31"),
           "fused_dense": ("src/repro_torch/csrc/fused_dense.cu",
                           "src/repro/kernels/fused_dense.py:39"),
           "fused_decode_agg": ("src/repro_torch/csrc/fused_decode_agg.cu",
                                "src/repro/kernels/fused_decode_agg.py:53"),
           "grouped_fused_decode_agg": (
               "src/repro_torch/csrc/grouped_decode_agg.cu",
               "src/repro/kernels/fused_decode_agg.py:120"),
           "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:29")}
    kernels = []
    for name, (source, replaces) in src.items():
        r = slice_rows[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            host_ms=r["host_ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"], shape=r["shape"],
                            **{k: r[k] for k in ("kernel_route",
                                                 "library_call",
                                                 "per_bucket_ms") if k in r}))
    for line in smi:
        log(line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
