"""Device times of the six kernels (``quantize_blocks_2d``,
``dequantize_blocks_2d``, ``fused_dense``, ``fused_decode_agg``,
``grouped_fused_decode_agg``, ``flash_attention``) for A/B comparisons on
one card, probes of their CUDA routes, and copies of a checkout with one
edit each.

    python3 tools/kernel_ab.py time ROOT [ROOT ...]   # one JSON line a ROOT
    python3 tools/kernel_ab.py quant [ROOT]           # kernels 1-2 by route
    python3 tools/kernel_ab.py sweep                  # plans, profiler
    python3 tools/kernel_ab.py probe                  # structured inputs
    python3 tools/kernel_ab.py copy NAME SRC DEST     # SRC with edit NAME
    python3 tools/kernel_ab.py slabs ROOT             # a "slabs" copy
    python3 tools/kernel_ab.py bits ROOT ROOT         # kernel 6, same bits?
    python3 tools/kernel_ab.py flash ROOT [ROOT ...]  # kernel 6 by run

``time`` imports ``repro_torch`` from each checkout ROOT in its own process
(a parent unpacked with ``git archive``, this checkout, a copy with one
edit) and times the main-path shapes and the library calls beside them, so
comparisons are made within one run on one card: list the roots in turns,
e.g. ``parent . . parent``; kernels 1 and 2 at :data:`QUANT_SHAPES`
come first, each with the route it took (``warp_rows`` for a tree without
``kernel_route``, whose one body was a warp a row), their inputs cycled
over copies larger than twice the L2 (:func:`_cold`). ``quant ROOT``
runs kernels 1 and 2 of a checkout through their wrappers with each route
and plan forced (``generic``; the vector routes ``rows`` / ``stream`` at
1, 2, 4 and 8 warps a block; ``generic`` at 8 warps a block, as the first
port launched it; in copies made with ``copy bulk`` or ``copy
rows_stride``, the TMA-fed route or a grid capped at one wave) at
:data:`QUANT_SHAPES` and (2^20, 1024), each checked ``torch.equal`` to the
plain version, with its share of the bytes bound; the copies
``rows_4f4``, ``dq_words4``, ``dq_chunks`` and ``dq_chunks_direct`` hold
the other designs tried. ``sweep`` launches the split-K kernel with
slab rows and column-tile widths other than ``splitk_plan``'s, and the
decode→aggregate few_rows route with every column-tile width, alone and
grouped, and splits a call's device time by kernel with
``torch.profiler``. ``probe`` holds the bf16 flash route against its plain
version on inputs that isolate Q K^T (identity V) and P V (q = 0, uniform
P) at each head dim. ``copy`` writes SRC's ``src/`` to DEST with one of
:data:`VARIANTS` applied (each edit must match SRC exactly once); ``slabs``
times, in a copy made with ``copy slabs``, the few_rows route against a
K-slab form of it (each block reduces hbar for its slab only; a second
kernel adds the slabs in order). ``bits`` runs kernel 6 in each of two
checkouts (one process each) on the same inputs, at :data:`FLASH_SHAPES`
and every head dim in both dtypes, with no ``q_offset`` and no
``softcap``, and prints whether the outputs are ``torch.equal``. ``flash``
times kernel 6 in each checkout (one process each) at runs (r), (t), (y)
and (f)'s shapes, MLA's and phi-3's pairs natively where the checkout has
them and else through its padded route, with each output's largest share of
``FLASH_BF16_TOL``; the ``flash_*`` copies time designs of the bf16 body
(no turns between the warpgroups, a 2- or 5-stage ring, 64-key tiles
where the body takes 96) and, as diagnostics whose outputs are
wrong, the body without P_lo V, without P V, without the softmax's
arithmetic or without P_lo's split, which show what each costs. Times are
device times from
``chip_smoke.time_ms`` (calls captured in a CUDA graph). Needs a CUDA card
(``copy`` does not).
"""
from __future__ import annotations

import inspect
import itertools
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# kernel 3 (M, K, N, act, dtype): run (c)'s layers (split-K), then the
# chunked-AE layers at the cohort scale (chunk 256, hidden 32, latent 8):
# a client's encode and EF decode at 4096 chunks, the server's hidden
# layer at run (h)'s cohort of 64 and the cohort of 256
FD_SHAPES = ((4, 4096, 512, "relu", "float32"), (4, 512, 8, "relu", "float32"),
             (4, 8, 512, "relu", "float32"),
             (4, 512, 4096, "linear", "float32"),
             (12, 8, 512, "relu", "float32"),
             (4096, 256, 32, "relu", "bfloat16"),
             (256 * 4096, 8, 32, "relu", "float32"),
             (256 * 4096, 32, 256, "linear", "float32"),
             (4096, 256, 32, "relu", "float32"),
             (4096, 32, 8, "relu", "float32"),
             (4096, 8, 32, "relu", "float32"),
             (4096, 32, 256, "linear", "float32"),
             (64 * 4096, 8, 32, "relu", "float32"))
# kernel 4 (C, M, K, N): run (c), cohort scale; kernel 5 (buckets, K, N,
# decoder slots): run (d), the ragged round, fl_partition's point, the
# mixed-route round (chip_smoke.py's shapes)
DA_SHAPES = ((3, 4, 512, 4096), (256, 4096, 32, 256))
GROUPED_SHAPES = (([(2, 4), (2, 4)], 512, 4096, [0, 1]),
                  ([(3, 37), (0, 8), (1, 8), (6, 100)], 32, 256,
                   [1, 0, 0, 1]),
                  ([(32, 3840), (32, 3840)], 32, 256, [0, 1]),
                  ([(3, 4), (0, 8), (2, 100), (1, 16)], 512, 4096,
                   [0, 1, 0, 1]))
# kernels 1 and 2 (nb, block): the paper's MLP (15,910 values), the launch
# floor, run (o)'s q8 at K 256 and 65,536, run (q)'s attention group, 2^28
# values, run (q)'s embedding group
QUANT_SHAPES = ((63, 256), (1, 256), (65_536, 256), (65_536, 1024),
                (131_072, 256), (1_048_576, 256), (1_605_632, 256))
COLD_BYTES = 2 * 50 * 2 ** 20        # twice the H100's 50 MB L2
HBM_BYTES_PER_S = 3.35e12
FLASH_SHAPES = ((4, 1024, 1024, 56, 8, 128, "causal", None, "bfloat16"),
                (2, 1000, 1000, 56, 8, 128, "window", 256, "bfloat16"),
                (2, 333, 517, 56, 8, 128, "full", None, "bfloat16"),
                (2, 512, 512, 32, 32, 64, "causal", None, "float32"))


def _setup(root: Path):
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(HERE))
    import torch
    import repro_torch
    from repro_torch.kernels import _lib
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    if not Path(repro_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"kernel_ab: repro_torch is not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _lib.build()
    return torch


def _decode_agg_inputs(torch, g, shapes, K, N, D):
    """Buckets of (C_b, M_b) with weights summing to 1, and D decoders."""
    hs, ws = [], []
    for C_b, M_b in shapes:
        hs.append(torch.randn((C_b, M_b, K), generator=g, device="cuda"))
        w = torch.rand((C_b,), generator=g, device="cuda") + 0.1
        ws.append(w / w.sum() if C_b else w)
    w_stack = torch.randn((D, K, N), generator=g, device="cuda") * K ** -0.5
    b_stack = torch.randn((D, N), generator=g, device="cuda")
    return hs, ws, w_stack, b_stack


def _grouped_plan(fda, hs, ws, w_stack, b_stack, dec_idx):
    """The root's own grouped plan: a (D, K, N) stack before the tile
    table carried decoder addresses, (W, bias) pairs since."""
    if "w_stack" in inspect.signature(fda.grouped_plan).parameters:
        return fda.grouped_plan(hs, ws, w_stack, b_stack, dec_idx)
    return fda.grouped_plan(hs, ws, [(w_stack[d], b_stack[d])
                                     for d in range(w_stack.shape[0])],
                            dec_idx)


def _cold(make, nbytes: int, iters: int):
    """A callable that returns the next of ``k`` input sets from ``make``,
    ``k`` large enough that the sets together exceed :data:`COLD_BYTES`
    (at most ``iters``): repeated launches then read their inputs from HBM,
    as a caller's first touch does, and not from the L2."""
    sets = [make() for _ in range(max(1, min(iters,
                                             -(-COLD_BYTES // nbytes))))]
    cyc = itertools.cycle(sets)
    return lambda: next(cyc)


def _quant_bound_ms(nb: int, block: int) -> float:
    """Kernels 1 and 2 move 5 bytes a value and 4 a row (HBM at 3.35 TB/s)."""
    return (5 * nb * block + 4 * nb) / HBM_BYTES_PER_S * 1e3


def _quant_iters(nb: int, block: int) -> int:
    return 10 if nb * block >= 1 << 24 else 200


def time_quant(torch, g, out: dict) -> None:
    """Kernels 1 and 2 through their wrappers at :data:`QUANT_SHAPES`
    (bits 8), inputs cold, with the route each took."""
    from chip_smoke import time_ms
    from repro_torch.kernels import quantize as qz
    route = getattr(qz, "kernel_route", None)
    for nb, block in QUANT_SHAPES:
        iters = _quant_iters(nb, block)
        nxt_x = _cold(lambda: torch.randn((nb, block), generator=g,
                                          device="cuda") * 3,
                      4 * nb * block, iters)
        nxt_q = _cold(lambda: qz.quantize_blocks_2d(nxt_x(), block=block),
                      nb * block, iters)
        key = f"{nb},{block}"
        out[f"quantize {key}"] = time_ms(
            lambda: qz.quantize_blocks_2d(nxt_x(), block=block), iters)
        out[f"dequantize {key}"] = time_ms(
            lambda: qz.dequantize_blocks_2d(*nxt_q(), block=block), iters)
        out[f"bound {key}"] = _quant_bound_ms(nb, block)
        if route is None:
            out[f"route {key}"] = ["warp_rows", "warp_rows"]
        else:
            x, (q, _) = nxt_x(), nxt_q()
            out[f"route {key}"] = [
                route("quantize", nb, block, x.data_ptr(), q.data_ptr()),
                route("dequantize", nb, block, q.data_ptr(), x.data_ptr())]
        torch.cuda.empty_cache()


def quant(root: Path = HERE) -> list:
    """Kernels 1 and 2 of ``root`` through their wrappers with each route
    and plan forced, at :data:`QUANT_SHAPES` and (2^20, 1024), bits 8,
    inputs cold as in ``time``; the outputs of each ``torch.equal`` to the
    plain version. From 2^24 values, ``zero_`` and ``copy_`` over as many
    floats as yardsticks of the card's write and copy rates."""
    torch = _setup(root)
    from chip_smoke import tie_rows, time_ms
    from repro_torch.kernels import _lib, ref
    from repro_torch.kernels import quantize as qz
    g = torch.Generator(device="cuda").manual_seed(0)
    sms = _lib.device_sms(torch.device("cuda"))
    res = []
    for nb, block in QUANT_SHAPES + ((1 << 20, 1024),):
        iters = _quant_iters(nb, block)
        nxt_x = _cold(lambda: tie_rows(torch.randn(
            (nb, block), generator=g, device="cuda") * 3, 127.0, 7),
            4 * nb * block, iters)
        nxt_q = _cold(lambda: ref.quantize_blocks_ref(nxt_x(), 8),
                      nb * block, iters)
        x = nxt_x()
        q_r, s_r = ref.quantize_blocks_ref(x, 8)
        d_r = ref.dequantize_blocks_ref(q_r, s_r)
        plans = {}
        for kind, n_iter in (("quantize", -(-nb // qz._rows_a_warp(block))),
                             ("dequantize",
                              -(-nb * block // qz._STREAM_CODES))):
            vec = qz.kernel_route(kind, nb, block, 0, 0)
            generic = qz.kernel_route(kind, nb, block, 1, 1)
            plans[kind] = [("generic", generic)] + ([
                ("bulk", qz.bulk_plan(kind, nb, block, sms))]
                if hasattr(qz, "bulk_plan") else []) + [
                # the vector route at 1-8 warps a block, a warp an
                # iteration; "*" marks the wrapper's own plan
                (f"{vec.route}_{w * 32}" + ("*" if w * 32 == vec.threads
                                             else ""),
                 qz.Plan(vec.route, w * 32, -(-n_iter // w)))
                for w in (1, 2, 4, 8)]
            if kind == "quantize" and getattr(qz, "GRID_STRIDE", False):
                # a "rows_stride" copy: the grid capped at 64 warps an SM
                plans[kind].append((vec.route + "_stride", qz.Plan(
                    vec.route, 256, min(-(-n_iter // 8), sms * 8))))
            # the generic route as the parent launched it: 8 warps a block
            plans[kind].append(("generic_256", qz.Plan(
                "generic", 256, -(-nb // 8))))
        route = qz.kernel_route
        try:
            for kind, name, plan in [(k, *p) for k in plans
                                     for p in plans[k]]:
                # the wrapper's own call path, launching ``plan``
                qz.kernel_route = lambda *a, plan=plan: plan
                if kind == "quantize":
                    q, s = qz.quantize_blocks_2d(x, block=block)
                    equal = torch.equal(q, q_r) and torch.equal(s, s_r)
                    fn = lambda: qz.quantize_blocks_2d(nxt_x(), block=block)
                else:
                    equal = torch.equal(qz.dequantize_blocks_2d(
                        q_r, s_r, block=block), d_r)
                    fn = lambda: qz.dequantize_blocks_2d(*nxt_q(),
                                                         block=block)
                res.append(dict(kernel=kind + "_blocks_2d",
                                shape=[nb, block], route=name,
                                threads=plan.threads, grid=plan.grid,
                                equal=bool(equal), ms=time_ms(fn, iters),
                                bound_ms=_quant_bound_ms(nb, block)))
        finally:
            qz.kernel_route = route
        if nb * block >= 1 << 24:
            # yardsticks (PyTorch's own kernels, no part of the port): a
            # write of 4 bytes a value, and a read plus a write of 4
            y = torch.empty((nb, block), device="cuda")
            for name, fn, nbytes in (
                    ("zero_", lambda: y.zero_(), 4 * nb * block),
                    ("copy_", lambda: y.copy_(nxt_x()), 8 * nb * block)):
                res.append(dict(kernel=name, shape=[nb, block],
                                ms=time_ms(fn, iters),
                                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3))
            del y
        for r in res:
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
        del x, q_r, s_r, d_r, nxt_x, nxt_q
        torch.cuda.empty_cache()
    return res


def time_root(root: Path) -> dict:
    torch = _setup(root)
    import torch.nn.functional as F
    from chip_smoke import time_ms
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_dense import fused_dense, kernel_route
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(root)}
    time_quant(torch, g, out)
    # kernel 3's routes; an older root routes by M alone
    four = len(inspect.signature(kernel_route).parameters) == 4
    for M, K, N, act, dt in FD_SHAPES:
        dtype = getattr(torch, dt)
        out[f"route {M},{K},{N} {dt}"] = (kernel_route(M, K, N, dtype)
                                          if four else kernel_route(M))
        x, w, b = (torch.randn(s, generator=g, device="cuda").to(dtype)
                   for s in ((M, K), (K, N), (N,)))
        iters = 10 if M > 100_000 else 50
        out[f"fd {M},{K},{N} {act} {dt}"] = time_ms(
            lambda: fused_dense(x, w, b, act=act), iters)
        out[f"addmm {M},{K},{N} {dt}"] = time_ms(
            lambda: torch.addmm(b, x, w), iters)
    from repro_torch.kernels import fused_decode_agg as fda
    for C, M, K, N in DA_SHAPES:
        (h,), (w,), w_stack, b_stack = _decode_agg_inputs(
            torch, g, [(C, M)], K, N, 1)
        wl, bl = w_stack[0], b_stack[0]
        iters = 10 if M > 100 else 50
        out[f"fda {C},{M},{K},{N}"] = time_ms(
            lambda: fda.fused_decode_agg(h, w, wl, bl), iters)
        out[f"einsum {C},{M},{K},{N}"] = time_ms(
            lambda: torch.einsum("c,cmk,kn->mn", w, h, wl), iters)
    for shapes, K, N, dec_idx in GROUPED_SHAPES:
        hs, ws, w_stack, b_stack = _decode_agg_inputs(
            torch, g, shapes, K, N, max(dec_idx) + 1)
        p = _grouped_plan(fda, hs, ws, w_stack, b_stack, dec_idx)
        big = max(C * M for C, M in shapes) > 10_000
        out[f"grouped {shapes} {K},{N}"] = time_ms(
            lambda: fda.grouped_launch(p), 10 if big else 50)
    for B, Sq, Skv, H, KV, D, mode, win, dt in FLASH_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(s, generator=g, device="cuda").to(dtype)
                   for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
        out[f"flash {B},{Sq},{Skv},{H},{KV},{D} {mode} {dt}"] = time_ms(
            lambda: flash_attention(q, k, v, mode=mode, window=win), 10)
        if mode == "causal" and Sq == Skv:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            out[f"sdpa {B},{Sq},{H},{KV},{D} {dt}"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), 10)
    return out


def sweep() -> list:
    torch = _setup(HERE)
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import time_ms
    from repro_torch.kernels import _lib, ref
    from repro_torch.kernels.fused_dense import fused_dense
    g = torch.Generator(device="cuda").manual_seed(0)
    rows_out = []

    def run(M, K, N, rows, tpr):
        x = torch.randn((M, K), generator=g, device="cuda")
        w = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
        b = torch.randn((N,), generator=g, device="cuda")
        S = max(1, -(-K // rows))
        ws = torch.empty((S, M, N), device="cuda") if S > 1 else None
        y = torch.empty((M, N), device="cuda")

        def call():
            _lib.launch("fused_dense", "repro_fused_dense_splitk", x, w, b,
                        y, ws, M, K, N, 0, 0, rows, tpr)
        call()
        torch.cuda.synchronize()
        err = float((y - ref.fused_dense_ref(x, w, b, "relu")).abs().max())
        return dict(shape=[M, K, N], rows=rows, tpr=tpr, S=S,
                    ms=time_ms(call, 50), max_abs_err=err)

    for rows, tpr in ((56, 32), (64, 32), (128, 32), (256, 32), (112, 16),
                      (224, 16), (224, 8), (448, 8), (448, 4), (512, 4)):
        rows_out.append(run(4, 4096, 512, rows, tpr))
    for M in (12, 4):
        for tpr in (32, 16, 8):
            rows_out.append(run(M, 8, 512, 32, tpr))
    for rows, tpr in ((512, 4), (256, 4), (512, 8), (56, 32)):
        rows_out.append(run(4, 512, 4096, rows, tpr))
    rows_out += _sweep_few_rows(torch, g, time_ms, _lib, ref)
    rows_out += _sweep_tiles(torch, g, time_ms, _lib, ref)
    for M, K, N, act in ((4, 4096, 512, "relu"), (4, 512, 4096, "linear"),
                         (12, 8, 512, "relu")):
        x, w, b = (torch.randn(s, generator=g, device="cuda")
                   for s in ((M, K), (K, N), (N,)))
        for _ in range(5):
            fused_dense(x, w, b, act=act)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fused_dense(x, w, b, act=act)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type.name == "CUDA":
                us = getattr(e, "device_time", None)
                if us is None:
                    us = e.cuda_time
                rows_out.append(dict(shape=[M, K, N], kernel=e.key[:80],
                                     calls=e.count, device_us=us))
    return rows_out


def _sweep_few_rows(torch, g, time_ms, _lib, ref) -> list:
    """The few_rows route at every column-tile width (tpr = 1..16): kernel
    4 at run (c)'s shape, kernel 5 at run (d)'s round and at the mixed
    round (its few_rows tiles rebuilt with each tpr)."""
    import dataclasses
    from repro_torch.kernels import fused_decode_agg as fda
    res = []
    (h,), (w,), w_stack, b_stack = _decode_agg_inputs(torch, g, [(3, 4)],
                                                      512, 4096, 1)
    wl, bl = w_stack[0], b_stack[0]
    want = ref.fused_decode_agg_ref(h, w, wl, bl)
    y = torch.empty_like(want)
    for tpr in (1, 2, 4, 8, 16):
        def call():
            _lib.launch("fused_decode_agg", "repro_fused_decode_agg_rows", h,
                        w, wl, bl, y, 3, 4, 512, 4096, tpr)
        call()
        torch.cuda.synchronize()
        res.append(dict(kernel="fused_decode_agg", shape=[3, 4, 512, 4096],
                        tpr=tpr, blocks=fda.few_rows_blocks(4096, tpr),
                        ms=time_ms(call, 50),
                        max_abs_err=float((y - want).abs().max())))
    for shapes, K, N, dec_idx in (GROUPED_SHAPES[0], GROUPED_SHAPES[3]):
        hs, ws, w_stack, b_stack = _decode_agg_inputs(
            torch, g, shapes, K, N, max(dec_idx) + 1)
        decs = [(w_stack[d], b_stack[d]) for d in range(w_stack.shape[0])]
        p = fda.grouped_plan(hs, ws, decs, dec_idx)
        want = ref.grouped_fused_decode_agg_ref(hs, ws, w_stack, b_stack,
                                                dec_idx)
        for tpr in (1, 2, 4, 8, 16):
            table, _ = fda.tile_table(
                [tuple(t.shape[:2]) for t in hs], K, N,
                [t.data_ptr() for t in hs], [t.data_ptr() for t in ws],
                [(decs[d][0].data_ptr(), decs[d][1].data_ptr())
                 for d in dec_idx], p.out.data_ptr(), p.bm, p.cols, tpr)
            q = dataclasses.replace(p, tpr=tpr,
                                    table=torch.from_numpy(table).cuda())
            got = fda.grouped_launch(q)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b, t in
                      zip(got, want, hs) if t.shape[0])
            res.append(dict(kernel="grouped_fused_decode_agg",
                            shape=[shapes, K, N], tpr=tpr, tiles=q.tiles,
                            ms=time_ms(lambda: fda.grouped_launch(q), 50),
                            max_abs_err=err))
    return res


def _sweep_tiles(torch, g, time_ms, _lib, ref) -> list:
    """Kernel 3 above M = 16: the narrow route at 1, 2, 4 and 8 rows a
    thread at the chunked-AE shapes, every compiled tile of the mma and
    sgemm routes at the encode's first layer (4096, 256, 32), and the
    narrow route launched directly at split-K's K = 8 shapes (4, 8, 512)
    and (12, 8, 512), beside the split-K route that the wrapper takes
    there (narrow's tile 0: its own rule for the rows a thread)."""
    from repro_torch.kernels import fused_dense as fd
    res = []

    def one(M, K, N, dtype, route, tile, act="relu"):
        x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
        w = (torch.randn((K, N), generator=g, device="cuda")
             * K ** -0.5).to(dtype)
        b = torch.randn((N,), generator=g, device="cuda").to(dtype)
        y = torch.empty((M, N), dtype=dtype, device="cuda")
        sms = _lib.device_sms(x.device)

        def call():
            _lib.launch("fused_dense", "repro_fused_dense", x, w, b, y, M, K,
                        N, fd.ACTS[act], fd.DTYPES[dtype],
                        fd._TILED_ROUTES[route], tile, sms)
        call()
        torch.cuda.synchronize()
        err = float((y.float() - ref.fused_dense_ref(x, w, b, act).float())
                    .abs().max())
        return dict(kernel="fused_dense", shape=[M, K, N],
                    dtype=str(dtype).split(".")[-1], route=route, tile=tile,
                    ms=time_ms(call, 50), max_abs_err=err,
                    splitk_ms=(time_ms(lambda: fd.fused_dense(x, w, b,
                                                              act=act), 50)
                               if M <= fd.SPLITK_MAX_M else None))

    for M, K, N, act in ((1 << 20, 8, 32, "relu"),
                         (1 << 20, 32, 256, "linear"),
                         (4096, 32, 8, "relu"), (4096, 8, 32, "relu"),
                         (4096, 32, 256, "linear"), (1 << 18, 8, 32, "relu")):
        for rm in (1, 2, 4, 8):
            res.append(one(M, K, N, torch.float32, "narrow", rm, act))
    for bm in fd.MMA_ROWS:
        res.append(one(4096, 256, 32, torch.bfloat16, "mma", bm))
    for t in range(len(fd.SGEMM_TILES)):
        res.append(one(4096, 256, 32, torch.float32, "sgemm", t))
    for M in (4, 12):
        res.append(one(M, 8, 512, torch.float32, "narrow", 0))
    return res


def slabs(root: Path) -> list:
    """Run (c)'s kernel 4, (3, 4, 512, 4096), in a ``copy slabs`` of a
    checkout: the few_rows route as shipped (each block reduces hbar for
    all K) against the K-slab form at 2, 4 and 8 slabs (the same 512
    blocks: column tiles widened as K is cut), both against the plain
    version."""
    torch = _setup(root)
    import ctypes
    from chip_smoke import time_ms
    from repro_torch.kernels import _lib, ref
    from repro_torch.kernels import fused_decode_agg as fda
    lib = _lib.load()
    fn = lib.repro_fused_decode_agg_slabs
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = torch.Generator(device="cuda").manual_seed(0)
    C, M, K, N = 3, 4, 512, 4096
    (h,), (w,), w_stack, b_stack = _decode_agg_inputs(torch, g, [(C, M)],
                                                      K, N, 1)
    wl, bl = w_stack[0], b_stack[0]
    want = ref.fused_decode_agg_ref(h, w, wl, bl)
    res = [dict(form="one slab (shipped)", tpr=fda.few_rows_plan(N, 132),
                ms=time_ms(lambda: fda.fused_decode_agg(h, w, wl, bl), 50),
                max_abs_err=float((fda.fused_decode_agg(h, w, wl, bl)
                                   - want).abs().max()))]
    for S, tpr in ((2, 4), (4, 8), (8, 16)):
        ws = torch.empty((S, M, N), device="cuda")
        y = torch.empty((M, N), device="cuda")

        def call():
            rc = fn(h.data_ptr(), w.data_ptr(), wl.data_ptr(), bl.data_ptr(),
                    ws.data_ptr(), y.data_ptr(), C, M, K, N, tpr, K // S,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"slabs: {rc}")
        call()
        torch.cuda.synchronize()
        res.append(dict(form=f"{S} slabs", tpr=tpr, ms=time_ms(call, 50),
                        max_abs_err=float((y - want).abs().max())))
    return res


# ------------------------------------------------------------- variants
HEADER = "src/repro_torch/csrc/decode_agg_tile.cuh"
FD_CU = "src/repro_torch/csrc/fused_dense.cu"
Q_CU = "src/repro_torch/csrc/quantize.cu"
Q_PY = "src/repro_torch/kernels/quantize.py"
# a slab's products only after every copy in flight has landed: loads and
# products do not overlap (the effect of a single-buffered K)
_WAIT_ALL = "    cp_async_wait<0>();\n    __syncthreads();\n"
_MMA_NEXT = ("      load(kt + kMmaStages - 1, (kt + kMmaStages - 1) % "
             "kMmaStages);\n    cp_async_commit();\n")
_SGEMM_NEXT = ("      load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);\n"
               "    cp_async_commit();\n")
FDA_CU = "src/repro_torch/csrc/fused_decode_agg.cu"
FLASH_CU = "src/repro_torch/csrc/flash_attention.cu"
GDA_CU = "src/repro_torch/csrc/grouped_decode_agg.cu"
# (ii) of the few_rows design question: K slabs, each block reducing hbar
# for its slab only, float32 partials added in slab order by a second
# kernel. Written for run (c)'s shape: M <= 4, N % 4 == 0, 16-byte
# aligned W.
_SLABS_KERNELS = r"""
__global__ void __launch_bounds__(kThreads)
slab_partial_kernel(const float* __restrict__ h,
                    const float* __restrict__ wts,
                    const float* __restrict__ W, float* __restrict__ ws,
                    int C, int M, int K, int N, int tpr, int R) {
  constexpr int MT = 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, wid = tid / 32, lane = tid % 32;
  const int tx = lane % tpr, sub = lane / tpr, rw = 32 / tpr;
  const int cols = 4 * tpr, n0 = blockIdx.x * cols, n = n0 + 4 * tx;
  const int step = kWarps * rw, k0 = blockIdx.y * R;
  const int nr = min(K, k0 + R) - k0;
  int r0 = wid * rw + sub;
  float4 raw[kUnroll];
  auto load_rows = [&](int r) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (n < N && r + u * step < nr)
        raw[u] = __ldg(reinterpret_cast<const float4*>(
            W + (long long)(k0 + r + u * step) * N + n));
  };
  load_rows(r0);
  for (int e = tid; e < MT * nr; e += kThreads) {
    const int m = e / nr, k = e % nr;
    float a = 0.f;
    if (m < M)
      for (int c = 0; c < C; ++c)
        a = fmaf(__ldg(wts + c),
                 __ldg(h + ((long long)c * M + m) * K + k0 + k), a);
    sm[k * MT + m] = a;
  }
  __syncthreads();
  float acc[MT][4] = {};
  if (n < N)
    while (r0 < nr) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + u * step >= nr) break;
        const float v[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
        const float* xr = sm + (r0 + u * step) * MT;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xr[m], v[j], acc[m][j]);
      }
      r0 += kUnroll * step;
      load_rows(r0);
    }
  for (int off = tpr; off < 32; off *= 2)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
  __syncthreads();
  if (sub == 0)
    for (int m = 0; m < M; ++m)
      *reinterpret_cast<float4*>(sm + (wid * M + m) * cols + 4 * tx) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  const int t = tid % cols;
  if (n0 + t < N)
    for (int m = tid / cols; m < M; m += kThreads / cols) {
      float sum = sm[m * cols + t];
      for (int q = 1; q < kWarps; ++q) sum += sm[(q * M + m) * cols + t];
      ws[((long long)blockIdx.y * M + m) * N + n0 + t] = sum;
    }
}

__global__ void slab_finish_kernel(const float* __restrict__ ws,
                                   const float* __restrict__ b,
                                   float* __restrict__ out, int M, int N,
                                   int S) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long MN = (long long)M * N;
  if (i >= MN) return;
  float s = ws[i];
  for (int q = 1; q < S; ++q) s += ws[q * MN + i];
  out[i] = s + b[i % N];
}

}  // namespace

extern "C" int repro_fused_decode_agg_slabs(
    const float* h, const float* wts, const float* W, const float* b,
    float* ws, float* out, int C, int M, int K, int N, int tpr, int R,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int S = (K + R - 1) / R, tiles = ((N + 3) / 4 + tpr - 1) / tpr;
  const int red = kWarps * 4 * 4 * tpr, xs = R * 4;
  const size_t smem = (size_t)(red > xs ? red : xs) * sizeof(float);
  if (int e = allow_smem(slab_partial_kernel, smem)) return e;
  slab_partial_kernel<<<dim3(tiles, S), kThreads, smem, s>>>(
      h, wts, W, ws, C, M, K, N, tpr, R);
  slab_finish_kernel<<<(unsigned)((M * N + 255) / 256), 256, 0, s>>>(
      ws, b, out, M, N, S);
  return (int)cudaGetLastError();
}

namespace {
"""
# the few_rows body before W went through shared memory: 4 rows of W a
# batch in registers a thread, loaded before the hbar reduce (runs 2-3)
_ROWS_W_IN_REGISTERS = r"""template <int MT>
__device__ __forceinline__ void decode_agg_rows(
    const float* __restrict__ hb, long long client_stride,
    const float* __restrict__ wts, int C, int M, int K,
    const float* __restrict__ W, const float* __restrict__ b, int N,
    int tpr, int tile, float* __restrict__ out, float* sm) {
  const int tid = threadIdx.x, wid = tid / 32, lane = tid % 32;
  const int tx = lane % tpr, sub = lane / tpr, rw = 32 / tpr;
  const int cols = 4 * tpr, n0 = tile * cols, n = n0 + 4 * tx;
  const int step = kWarps * rw;                  // G: threads along K
  const bool wvec = N % 4 == 0 && aligned16(W);

  // 1) this thread's first rows of W go out before anything waits
  int r0 = wid * rw + sub;
  float4 raw[kRowsBatch];
  auto load_rows = [&](int r) {
#pragma unroll
    for (int u = 0; u < kRowsBatch; ++u)
      if (n < N && r + u * step < K)
        raw[u] = ld4(W + (long long)(r + u * step) * N + n, N - n, wvec);
  };
  load_rows(r0);
  const int t = tid % cols;                      // column in the block sum
  const float bias = n0 + t < N ? __ldg(b + n0 + t) : 0.f;

  // 2) hbar[k][m] = sum_c w_c * h_c[m][k], clients ascending, one fmaf
  //    chain an element from 0
  const int band = M * K;
  const bool hvec = client_stride % 4 == 0 && aligned16(hb);
  for (int e = 4 * tid; e < band; e += 4 * kThreads) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < C; c0 += kRowsBatch) {
      float4 v[kRowsBatch];
      float wv[kRowsBatch];
#pragma unroll
      for (int u = 0; u < kRowsBatch; ++u)
        if (c0 + u < C) {
          wv[u] = __ldg(wts + c0 + u);
          v[u] = ld4(hb + (long long)(c0 + u) * client_stride + e, band - e,
                     hvec);
        }
#pragma unroll
      for (int u = 0; u < kRowsBatch; ++u)
        if (c0 + u < C) {
          a.x = fmaf(wv[u], v[u].x, a.x);
          a.y = fmaf(wv[u], v[u].y, a.y);
          a.z = fmaf(wv[u], v[u].z, a.z);
          a.w = fmaf(wv[u], v[u].w, a.w);
        }
    }
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e + j < band) sm[((e + j) % K) * MT + (e + j) / K] = av[j];
  }
  for (int e = tid; e < (MT - M) * K; e += kThreads)
    sm[(e % K) * MT + M + e / K] = 0.f;
  __syncthreads();

  // 3) M x 4 partial sums over rows r0, r0 + G, ...
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  if (n < N) {
    while (r0 < K) {
#pragma unroll
      for (int u = 0; u < kRowsBatch; ++u) {
        if (r0 + u * step >= K) break;
        const float v[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
        const float* xr = sm + (r0 + u * step) * MT;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xm = xr[m];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xm, v[j], acc[m][j]);
        }
      }
      r0 += kRowsBatch * step;
      load_rows(r0);
    }
  }
  // 4) lanes of one column vector: a fixed xor tree
  for (int off = tpr; off < 32; off *= 2)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
  // 5) the 8 warps' sums in warp order, then the bias
  __syncthreads();                               // hbar is read
  if (sub == 0)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m >= M) break;
      *reinterpret_cast<float4*>(sm + (wid * M + m) * cols + 4 * tx) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
  __syncthreads();
  if (n0 + t < N)
    for (int m = tid / cols; m < M; m += kThreads / cols) {
      float sum = sm[m * cols + t];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) sum += sm[(q * M + m) * cols + t];
      out[(long long)m * N + n0 + t] = sum + bias;
    }
}

"""
_RETURN_AFTER_REDUCE = (
    "  if (threadIdx.x < rows && n_begin < n_end)\n"
    "    out[(long long)threadIdx.x * N + n_begin] = hbar[threadIdx.x];\n"
    "  return;\n")
# Designs of kernels 1 and 2 tried against the shipped ones (PERF.md §6;
# each keeps the shipped launch check that the grid gives every unit of
# work a warp). Kernel 2 as 16-byte code chunks, a lane loading one chunk
# (16 codes, one scale), two a warp: DQ_CHUNKS stages the warp's 1,024
# codes in shared memory and writes them back as 512 contiguous bytes a
# store instruction, DQ_CHUNKS_DIRECT writes each lane's four float4s
# itself (64 bytes apart across the warp). Both need block % 16 == 0; a
# warp's unit is 1,024 codes (kWords 8 in the check).
DQ_CHUNKS = """__global__ void __launch_bounds__(kMaxThreads)
dequantize_stream(const int8_t* __restrict__ q, const float* __restrict__ s,
                  float* __restrict__ x, long long n, int block, int shift) {
  constexpr int kSpanCodes = 512, kSpans = 2;
  __shared__ __align__(16) uint32_t stage[kMaxThreads / 32][kSpans]
                                         [kSpanCodes / 4];
  const int lane = threadIdx.x & 31, w = threadIdx.x / 32;
  const long long chunks = n / 16, it = warp_id();
  const uint4* q16 = reinterpret_cast<const uint4*>(q);
  uint4 c[kSpans];
#pragma unroll
  for (int u = 0; u < kSpans; ++u) {              // every load first
    const long long k = (it * kSpans + u) * 32 + lane;
    c[u] = k < chunks ? q16[k] : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int u = 0; u < kSpans; ++u)
    *reinterpret_cast<uint4*>(&stage[w][u][4 * lane]) = c[u];
  __syncwarp();
#pragma unroll
  for (int u = 0; u < kSpans; ++u) {
    const long long e0 = (it * kSpans + u) * kSpanCodes;
#pragma unroll
    for (int j = 0; j < 4; ++j) {                 // 512 bytes a store
      const int word = 32 * j + lane;
      const long long e = e0 + 4 * word;
      if (e < n)
        *reinterpret_cast<float4*>(x + e) =
            dequant4(stage[w][u][word], s[row_of(e, block, shift)]);
    }
  }
}

"""
DQ_CHUNKS_DIRECT = """__global__ void __launch_bounds__(kMaxThreads)
dequantize_stream(const int8_t* __restrict__ q, const float* __restrict__ s,
                  float* __restrict__ x, long long n, int block, int shift) {
  const long long chunks = n / 16;
  const long long k0 = warp_id() * 64 + (threadIdx.x & 31);
  const uint4* q16 = reinterpret_cast<const uint4*>(q);
  float4* x4 = reinterpret_cast<float4*>(x);
  uint4 c[2];
  float sc[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const long long k = k0 + 32 * u;
    c[u] = k < chunks ? q16[k] : make_uint4(0, 0, 0, 0);
    sc[u] = k < chunks ? s[row_of(16 * k, block, shift)] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const long long k = k0 + 32 * u;
    if (k < chunks) {
      x4[4 * k] = dequant4(c[u].x, sc[u]);
      x4[4 * k + 1] = dequant4(c[u].y, sc[u]);
      x4[4 * k + 2] = dequant4(c[u].z, sc[u]);
      x4[4 * k + 3] = dequant4(c[u].w, sc[u]);
    }
  }
}

"""
_CHUNK_UNITS = [(Q_CU, "constexpr int kWords = 2;",
                 "constexpr int kWords = 8;"),
                (Q_PY, "_STREAM_CODES = 32 * 2 * 4 ", "_STREAM_CODES = 1024 ")]
# Kernel 1 with R rows a warp, all loaded before any is reduced, so at least
# 4 float4s a lane are in flight (2 rows of 256, 4 of 128 or of 64)
ROWS_4F4 = """template <int BLOCK>
__global__ void __launch_bounds__(kMaxThreads)
quantize_vector(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ s, long long nb, float qmax) {
  using S = Rows<BLOCK>;
  constexpr int R = S::V >= 4 ? 1 : 4 / S::V, ROWS = S::RW * R;
  const long long it = warp_id();
  if (it * ROWS >= nb) return;
  const int lane = threadIdx.x & 31, sub = lane % S::LPR,
            half = lane / S::LPR;
  float4 v[R][S::V];
#pragma unroll
  for (int r = 0; r < R; ++r) {                   // every load first
    const long long row = it * ROWS + r * S::RW + half;
    const float4* xr = reinterpret_cast<const float4*>(x + row * BLOCK);
#pragma unroll
    for (int j = 0; j < S::V; ++j)
      v[r][j] = row < nb ? xr[j * S::LPR + sub] : make_float4(0, 0, 0, 0);
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    quantize_row<BLOCK>(v[r], it * ROWS + r * S::RW + half, nb, sub, q, s,
                        qmax);
}

"""
# Kernel 1 in a grid-stride loop, so a grid capped at one wave (8 warps a
# block, 8 blocks an SM) covers any number of rows
ROWS_STRIDE = """template <int BLOCK>
__global__ void __launch_bounds__(kMaxThreads)
quantize_vector(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ s, long long nb, float qmax) {
  using S = Rows<BLOCK>;
  const int lane = threadIdx.x & 31, sub = lane % S::LPR,
            half = lane / S::LPR;
  const long long units = (nb + S::RW - 1) / S::RW;
  for (long long it = warp_id(); it < units;
       it += (long long)gridDim.x * (blockDim.x / 32)) {
    const long long row = it * S::RW + half;
    const float4* xr = reinterpret_cast<const float4*>(x + row * BLOCK);
    float4 v[S::V];
#pragma unroll
    for (int j = 0; j < S::V; ++j)
      v[j] = row < nb ? xr[j * S::LPR + sub] : make_float4(0, 0, 0, 0);
    quantize_row<BLOCK>(v, row, nb, sub, q, s, qmax);
  }
}

"""
_ROWS = ("template <int BLOCK>\n__global__ void __launch_bounds__(kMaxThreads)"
         "\nquantize_vector(",
         "__global__ void __launch_bounds__(kMaxThreads)\ndequantize_stream(")
# the bulk route (TMA): 1D cp.async.bulk copies of consecutive rows
# (quantize) or codes (dequantize) into a ring of 4 shared-memory stages,
# one elected producer thread and 8 consumer warps on mbarriers, a
# persistent grid; kernel 2's consumers stage their floats and store them
# with bulk copies too. Timed slower than the vector routes at every shape
# (PERF.md §6), so the shipped kernels leave it out; "bulk" adds it back as
# route 2 and ``bulk_plan``, which ``quant`` times beside the others.
BULK_CU = r"""// -------------------------------------------------------------- bulk route
// 1D cp.async.bulk (TMA) copies of consecutive rows (quantize) or codes
// (dequantize) into a ring of kStages shared-memory stages, one elected
// producer thread and kConsumers consumer warps, completion on mbarriers;
// a persistent grid, each block walking tiles blockIdx.x + k * gridDim.x.
constexpr int kBulk = 2;
constexpr int kConsumers = 8;                         // consumer warps
constexpr int kBulkThreads = 32 * (kConsumers + 1);   // + a producer warp
constexpr int kStages = 4;                            // ring depth
constexpr int kDqTile = 8192;                         // codes a stage
constexpr int kDqOutOffset = kStages * kDqTile + 128;  // ring, its barriers
// + two output buffers a consumer warp, 4 bytes a code each
constexpr int kDqSmem = kDqOutOffset + 2 * 4 * kDqTile;

template <int BLOCK>
struct BulkRows : Rows<BLOCK> {
  // rows a stage (16 KB, and a step for each consumer warp)
  static constexpr int TILE = 16384 / (4 * BLOCK) > kConsumers * Rows<BLOCK>::RW
                                  ? 16384 / (4 * BLOCK)
                                  : kConsumers * Rows<BLOCK>::RW;
  static constexpr int STAGE = TILE * BLOCK * 4;       // bytes
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// Returns once the barrier's phase of parity `parity` has completed; traps
// after 2^24 polls (a lost copy or arrival) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (polls == (1u << 24)) __trap();
  }
}
// `bytes` (a multiple of 16) from 16-byte aligned global `src` into shared
// `dst`, completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
        "r"(bar) : "memory");
}

// The ring both bulk kernels share: `stage_bytes` a stage, then a full and
// an empty mbarrier a stage. The producer warp's lane 0 walks the block's
// tiles (blockIdx.x, + gridDim.x, ...) and copies tile t's `bytes_of(t)`
// from `src_of(t)`; each consumer warp calls `body(t, stage)` on every
// tile in the same order, then releases the stage.
template <typename Src, typename Bytes, typename Body>
__device__ __forceinline__ void bulk_ring(unsigned char* smem, int stage_bytes,
                                          long long tiles, Src src_of,
                                          Bytes bytes_of, Body body) {
  const uint32_t bars = smem_u32(smem + kStages * stage_bytes);
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 16 * st, 1);                  // full
      mbar_init(bars + 16 * st + 8, kConsumers);     // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (w == kConsumers) {                             // producer warp
    if (lane == 0) {
      int it = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
        const int st = it % kStages;
        if (it >= kStages)
          mbar_wait(bars + 16 * st + 8, (it / kStages - 1) & 1);
        const uint32_t bytes = bytes_of(t);
        mbar_expect_tx(bars + 16 * st, bytes);
        bulk_load(smem_u32(smem + st * stage_bytes), src_of(t), bytes,
                  bars + 16 * st);
      }
    }
    return;
  }
  int it = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int st = it % kStages;
    mbar_wait(bars + 16 * st, (it / kStages) & 1);
    body(t, smem + st * stage_bytes);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 16 * st + 8);
  }
}

template <int BLOCK>
__global__ void __launch_bounds__(kBulkThreads)
quantize_bulk(const float* __restrict__ x, int8_t* __restrict__ q,
              float* __restrict__ s, long long nb, float qmax) {
  using S = BulkRows<BLOCK>;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int RPW = S::TILE / kConsumers;          // rows a consumer warp
  const int lane = threadIdx.x & 31, w = threadIdx.x / 32;
  const int sub = lane % S::LPR, half = lane / S::LPR;
  const long long tiles = (nb + S::TILE - 1) / S::TILE;
  bulk_ring(
      smem, S::STAGE, tiles,
      [&](long long t) { return x + t * S::TILE * BLOCK; },
      [&](long long t) {
        const long long rows = nb - t * S::TILE;
        return (uint32_t)((rows < S::TILE ? rows : S::TILE) * BLOCK * 4);
      },
      [&](long long t, unsigned char* stage) {
#pragma unroll
        for (int k = 0; k < RPW / S::RW; ++k) {
          const int r = w * RPW + k * S::RW + half;   // row in the tile
          const long long row = t * S::TILE + r;
          const float4* xr =
              reinterpret_cast<const float4*>(stage) + r * (BLOCK / 4);
          float4 v[S::V];
#pragma unroll
          for (int j = 0; j < S::V; ++j)
            v[j] = row < nb ? xr[j * S::LPR + sub] : make_float4(0, 0, 0, 0);
          quantize_row<BLOCK>(v, row, nb, sub, q, s, qmax);
        }
      });
}

// `bytes` (a multiple of 16) from shared `src` to 16-byte aligned global
// `dst`, in the thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
      ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(src), "r"(bytes)
      : "memory");
}

// Codes in by the ring; each consumer warp converts its 1,024 codes of a
// tile into one of its two 4 KB output buffers and stores them with one
// bulk copy, waiting (cp.async.bulk.wait_group.read 1) only until the
// buffer's previous copy has been read.
__global__ void __launch_bounds__(kBulkThreads)
dequantize_bulk(const int8_t* __restrict__ q, const float* __restrict__ s,
                float* __restrict__ x, long long n, int block, int shift) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CODES = kDqTile / kConsumers;        // a warp a tile
  const int lane = threadIdx.x & 31, w = threadIdx.x / 32;
  const long long tiles = (n + kDqTile - 1) / kDqTile;
  int used = 0;
  bulk_ring(
      smem, kDqTile, tiles, [&](long long t) { return q + t * kDqTile; },
      [&](long long t) {
        const long long left = n - t * kDqTile;
        return (uint32_t)(left < kDqTile ? left : kDqTile);
      },
      [&](long long t, unsigned char* stage) {
        const uint32_t* words =
            reinterpret_cast<const uint32_t*>(stage) + w * (CODES / 4);
        float4* ob = reinterpret_cast<float4*>(smem + kDqOutOffset) +
                     (2 * w + (used & 1)) * (CODES / 4);
        if (used++ >= 2) {
          if (lane == 0)
            asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
          __syncwarp();
        }
        const long long e0 = t * kDqTile + w * CODES;
#pragma unroll
        for (int j = 0; j < CODES / 128; ++j) {
          const long long e = e0 + 4 * (32 * j + lane);
          ob[32 * j + lane] =
              e < n ? dequant4(words[32 * j + lane],
                               s[row_of(e, block, shift)])
                    : make_float4(0, 0, 0, 0);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (lane == 0 && e0 < n) {
          const long long left = n - e0;
          bulk_store(x + e0, smem_u32(ob),
                     (uint32_t)(4 * (left < CODES ? left : CODES)));
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
      });
  if (w < kConsumers && lane == 0)          // the last stores out of smem
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int BLOCK>
int launch_bulk_rows(const float* x, int8_t* q, float* s, long long nb,
                     float qmax, int grid, cudaStream_t stream) {
  const int smem = kStages * BulkRows<BLOCK>::STAGE + 16 * kStages;
  static const cudaError_t set = cudaFuncSetAttribute(
      quantize_bulk<BLOCK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (set != cudaSuccess) return (int)set;
  quantize_bulk<BLOCK><<<grid, kBulkThreads, smem, stream>>>(x, q, s, nb,
                                                             qmax);
  return (int)cudaGetLastError();
}

int launch_bulk_quantize(const float* x, int8_t* q, float* s, long long nb,
                         int block, float qmax, int grid, cudaStream_t st) {
  if (grid < 1 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 4)
    return (int)cudaErrorInvalidValue;
  switch (block) {
    case 64: return launch_bulk_rows<64>(x, q, s, nb, qmax, grid, st);
    case 128: return launch_bulk_rows<128>(x, q, s, nb, qmax, grid, st);
    case 256: return launch_bulk_rows<256>(x, q, s, nb, qmax, grid, st);
    case 512: return launch_bulk_rows<512>(x, q, s, nb, qmax, grid, st);
    case 1024: return launch_bulk_rows<1024>(x, q, s, nb, qmax, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_bulk_dequantize(const int8_t* q, const float* s, float* x,
                           long long nb, int block, int grid,
                           cudaStream_t st) {
  if (grid < 1 || block % 16 || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t set = cudaFuncSetAttribute(
      dequantize_bulk, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (set != cudaSuccess) return (int)set;
  const int shift = (block & (block - 1)) ? -1 : __builtin_ctz(block);
  dequantize_bulk<<<grid, kBulkThreads, kDqSmem, st>>>(q, s, x, nb * block,
                                                       block, shift);
  return (int)cudaGetLastError();
}

"""
BULK_PY = '''def bulk_plan(kind: str, nb: int, block: int, sms: int) -> Plan:
    """The bulk route's launch: 8 consumer warps and a producer, as many
    blocks as are resident at once (by threads and shared memory), each
    walking its tiles through its ring."""
    if kind == "quantize":
        tile = max(8 * _rows_a_warp(block), 16384 // (4 * block))
        smem, tiles = 4 * (tile * block * 4 + 16), -(-nb // tile)
    else:
        smem, tiles = 4 * 8192 + 128 + 8 * 8192, -(-nb * block // 8192)
    per_sm = min(2048 // 288, 228 * 1024 // (smem + 1024))
    return Plan("bulk", 288, max(1, min(tiles, sms * per_sm)))


'''
_BULK_GENERIC = "  if (route == kGeneric) {\n    if (!covers(grid, threads, nb)) " \
    "return (int)cudaErrorInvalidValue;\n    "
_STREAM = ("__global__ void __launch_bounds__(kMaxThreads)\n"
           "dequantize_stream(",
           "// ----------------------------------------------------------- "
           "generic route")
VARIANTS = {
    "bulk": [
        (Q_CU, "// ---------------------------------------------------------"
               "------ launchers",
         BULK_CU + "// -------------------------------------------------------"
                   "-------- launchers"),
        (Q_CU, _BULK_GENERIC + "quantize_generic",
         "  if (route == kBulk)\n    return launch_bulk_quantize(x, q, s, nb, "
         "block, qmax, grid, st);\n" + _BULK_GENERIC + "quantize_generic"),
        (Q_CU, _BULK_GENERIC + "dequantize_generic",
         "  if (route == kBulk)\n    return launch_bulk_dequantize(q, s, x, "
         "nb, block, grid, st);\n" + _BULK_GENERIC + "dequantize_generic"),
        (Q_PY, '_ROUTE_IDS = {"generic": 0, "rows": 1, "stream": 1}',
         '_ROUTE_IDS = {"generic": 0, "rows": 1, "stream": 1, "bulk": 2}'),
        (Q_PY, "def quantize_blocks_2d(", BULK_PY + "def quantize_blocks_2d(")],
    "rows_4f4": [(Q_CU, _ROWS, ROWS_4F4),
                 (Q_CU, "  constexpr int RW = Rows<BLOCK>::RW;\n",
                  "  constexpr int RW = Rows<BLOCK>::RW * (\n"
                  "      Rows<BLOCK>::V >= 4 ? 1 : 4 / Rows<BLOCK>::V);\n"),
                 (Q_PY, "    return 2 if block == 64 else 1",
                  "    return (2 if block == 64 else 1) * max(\n"
                  "        1, 4 // max(1, block // 128))")],
    "rows_stride": [(Q_CU, _ROWS, ROWS_STRIDE),
                    (Q_CU, "  if (!covers(grid, threads, (nb + RW - 1) / RW))",
                     "  if (!covers(grid, threads, 1))"),
                    (Q_PY, "_MAX_GRID = 2 ** 31 - 1 ",
                     "GRID_STRIDE = True\n_MAX_GRID = 2 ** 31 - 1 ")],
    # kernel 2's stream route with 4 words a lane, not 2
    "dq_words4": [(Q_CU, "constexpr int kWords = 2;",
                   "constexpr int kWords = 4;"),
                  (Q_PY, "_STREAM_CODES = 32 * 2 * 4 ",
                   "_STREAM_CODES = 32 * 4 * 4 ")],
    "dq_chunks": [(Q_CU, _STREAM, DQ_CHUNKS), *_CHUNK_UNITS],
    "dq_chunks_direct": [(Q_CU, _STREAM, DQ_CHUNKS_DIRECT), *_CHUNK_UNITS],
    # kernel 3's narrow route with one row a thread at every width (each
    # float4 of w read from shared memory feeds one row's FMAs), and with
    # two x tiles in flight instead of three
    "narrow_one_row": [(FD_CU, "  if (M <= 16) return 1;\n",
                        "  if (M > 0) return 1;\n")],
    "narrow_two_stages": [
        (FD_CU, "constexpr int kNarrowStages = 3;",
         "constexpr int kNarrowStages = 2;")],
    # ... and with w's tile staged one element a load, converted (the
    # ragged shapes' branch), instead of 16-byte copies all in flight
    "narrow_w_scalar": [
        (FD_CU, "if constexpr (ALIGNED && std::is_same<T, float>::value) {",
         "if constexpr (false) {"),
        (FD_CU, "} else if constexpr (ALIGNED) {\n    const int cpn = nt / 8;",
         "} else if constexpr (false) {\n    const int cpn = nt / 8;")],
    # kernel 3's mma route with one slab in flight at a time, with 64-deep
    # slabs (K = 256 in four)
    "mma_bk64": [
        (FD_CU, "kMmaBN = 32, kMmaBK = 128,", "kMmaBN = 32, kMmaBK = 64,")],
    # ... with 256-deep slabs (K = 256 in one), and with 8 k warps (one
    # 16-deep step of a slab each)
    "mma_bk256": [
        (FD_CU, "kMmaBN = 32, kMmaBK = 128,", "kMmaBN = 32, kMmaBK = 256,")],
    "mma_kwarps8": [
        (FD_CU, "kMmaKWarps = 4, kMmaStages", "kMmaKWarps = 8, kMmaStages")],
    # ... with one k warp (each warp all of K for its 16 rows, no sum
    # across warps), and with each block loading w's slab from a place of
    # its own (blocks that start at once ask for different lines of w)
    "mma_kwarps1": [
        (FD_CU, "kMmaKWarps = 4, kMmaStages", "kMmaKWarps = 1, kMmaStages")],
    "mma_w_staggered": [
        (FD_CU, "        const int r = e / (kMmaBN / 8), "
                "q = e % (kMmaBN / 8);",
         "        const int f = (e + 64 * (int)blockIdx.x) % (kMmaBK * "
         "(kMmaBN / 8));\n"
         "        const int r = f / (kMmaBN / 8), q = f % (kMmaBN / 8);")],
    "mma_one_stage": [
        (FD_CU, "kMmaKWarps = 4, kMmaStages = 3;",
         "kMmaKWarps = 4, kMmaStages = 2;"),
        (FD_CU, _MMA_NEXT, _MMA_NEXT + _WAIT_ALL)],
    # kernel 3's narrow-N sgemm tiles (32 x 32, 16 x 32) without the k
    # groups (128 threads a block), and with one slab in flight at a time
    "sgemm_no_kgroups": [
        (FD_CU, "launch_sgemm_inst<32, 32, 4, 2, 32, 4, 4, ALIGNED>",
         "launch_sgemm_inst<32, 32, 4, 2, 32, 4, 1, ALIGNED>"),
        (FD_CU, "launch_sgemm_inst<16, 32, 2, 2, 32, 4, 4, ALIGNED>",
         "launch_sgemm_inst<16, 32, 2, 2, 32, 4, 1, ALIGNED>")],
    "sgemm_one_stage": [
        (FD_CU, "launch_sgemm_inst<32, 32, 4, 2, 32, 4, 4, ALIGNED>",
         "launch_sgemm_inst<32, 32, 4, 2, 32, 2, 4, ALIGNED>"),
        (FD_CU, "launch_sgemm_inst<16, 32, 2, 2, 32, 4, 4, ALIGNED>",
         "launch_sgemm_inst<16, 32, 2, 2, 32, 2, 4, ALIGNED>"),
        (FD_CU, _SGEMM_NEXT, _SGEMM_NEXT + _WAIT_ALL)],
    # the bands body split into its two phases: the client reduce alone
    # (one value a row written, the expand skipped), the expand alone (no
    # client read); "parent_*" on the body before the bands redesign
    "reduce_only": [(
        HEADER,
        "  // 2) expand: a thread a column, 8 rows at a time, k ascending\n",
        _RETURN_AFTER_REDUCE
        + "  // 2) expand: a thread a column, 8 rows at a time, k ascending\n"
    )],
    "expand_only": [(
        HEADER,
        "    if (e < band)\n      for (int c0 = q;",
        "    if (e < band && C < 0)\n      for (int c0 = q;")],
    "parent_reduce_only": [(
        HEADER,
        "  // 2) expand: out[rows, cols] = hbar @ W[:, cols] + b[cols]\n",
        _RETURN_AFTER_REDUCE
        + "  // 2) expand: out[rows, cols] = hbar @ W[:, cols] + b[cols]\n")],
    "parent_expand_only": [(
        HEADER, "      for (int c = 0; c < C; ++c)\n",
        "      for (int c = 0; c < C && C < 0; ++c)\n")],
    # the few_rows kernels without the blocks-an-SM request of the
    # compiler
    "no_launch_bounds": [
        (FDA_CU, "__launch_bounds__(kThreads, rows_min_blocks<MT>())\n"
                 "fused_decode_agg_rows_kernel",
         "__launch_bounds__(kThreads)\nfused_decode_agg_rows_kernel"),
        (GDA_CU, "__launch_bounds__(kThreads, rows_min_blocks<MT>())\n"
                 "grouped_decode_agg_kernel",
         "__launch_bounds__(kThreads)\ngrouped_decode_agg_kernel")],
    "w_in_registers": [
        (HEADER, ("// 16 bytes from global to shared memory",
                  "// ------------------------------------------------------"
                  "------- bands"), _ROWS_W_IN_REGISTERS),
        (HEADER, "return K * 4 * tpr + (red > xs ? red : xs);",
         "return red > xs ? red : xs;")],
    # the bands route: 4 blocks an SM asked of the per-bucket kernel; the
    # expand's k loop unrolled 16 deep
    "band_min_blocks_4": [(FDA_CU, "__launch_bounds__(kThreads)\n"
                                   "fused_decode_agg_band_kernel",
                           "__launch_bounds__(kThreads, 4)\n"
                           "fused_decode_agg_band_kernel")],
    "expand_unroll_16": [(HEADER, "#pragma unroll 8\n      for (int k = 0;",
                          "#pragma unroll 16\n      for (int k = 0;")],
    # kernel 6's bf16 body: without the warpgroups' turns, a 2- or 5-stage
    # ring, 64-key tiles at every head dim; diagnostics (wrong outputs): no
    # P_lo V, no P V, no softmax arithmetic, P_lo not split off
    "flash_no_turns": [
        (FLASH_CU, "    mbar_wait(my_turn, g & 1);\n", ""),
        (FLASH_CU, "    if (lane == 0) mbar_arrive(next_turn);\n", "")],
    "flash_kv64": [
        (FLASH_CU, "BKV = DV <= 64 ? 96 : 64;", "BKV = 64;")],
    "flash_two_stages": [
        (FLASH_CU, "NSTAGE = SPLIT ? 3 : 4;", "NSTAGE = 2;")],
    "flash_five_stages": [
        (FLASH_CU, "NSTAGE = SPLIT ? 3 : 4;", "NSTAGE = SPLIT ? 3 : 5;")],
    "flash_no_pv": [
        (FLASH_CU, "        issue_pv<G>(acc, ph, pl, k_tile(g + it - 1) + "
                   "v_col);\n        wgmma_commit();\n        pass_turn();\n",
         "        wgmma_commit();\n        pass_turn();\n")],
    "flash_no_softmax": [
        (FLASH_CU, ("    reg_fence(sc);\n    const int k0 = kt * BKV;\n",
                    "    l0 = l0 * f0 + s0;"),
         "    reg_fence(sc);\n    f0 = 1.f;\n    f1 = 1.f;\n    (void)kt;\n"
         "    const float s0 = 0.f, s1 = 0.f;\n")],
    "flash_no_lo_split": [
        (FLASH_CU, "      pl[i] = bf16x2_bits(__floats2bfloat162_rn("
                   "sc[2 * i] - hf.x,\n"
                   "                                                "
                   "sc[2 * i + 1] - hf.y));\n",
         "      pl[i] = ph[i] + 0 * (uint32_t)hf.x;\n")],
    "flash_single_p": [
        (FLASH_CU, "    wgmma_pv<G::DO>(acc, al, db);\n", "")],
    "slabs": [(FDA_CU, "}  // namespace\n",
               "// (variant) K slabs" + _SLABS_KERNELS
               + "}  // namespace\n")],
}


def copy(name: str, src: Path, dest: Path) -> None:
    """``src``'s ``src/`` and ``chip_smoke.py`` into ``dest`` with variant
    ``name`` applied."""
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(src / "src", dest / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(src / "chip_smoke.py", dest / "chip_smoke.py")
    for path, old, new in VARIANTS[name]:
        f = dest / path
        text = f.read_text()
        if isinstance(old, tuple):           # the region [start, end)
            start, end = old
            if text.count(start) != 1 or text.count(end) != 1:
                raise SystemExit(f"kernel_ab copy {name}: {path} does not "
                                 f"hold the region's ends once each")
            i, j = text.index(start), text.index(end)
            old = text[i:j]
        if text.count(old) != 1:
            raise SystemExit(f"kernel_ab copy {name}: {path} holds the edit's "
                             f"text {text.count(old)} times, not once")
        f.write_text(text.replace(old, new))


def probe() -> list:
    torch = _setup(HERE)
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from chip_smoke import FLASH_BF16_TOL
    res = []
    for D in (16, 32, 64, 128):
        for kind in ("q0", "v_identity", "random"):
            g = torch.Generator(device="cuda").manual_seed(D)
            q, k, v = (torch.randn((1, 64, 1, D), generator=g, device="cuda")
                       for _ in range(3))
            if kind == "q0":                 # uniform P: tests P V alone
                q.zero_()
            if kind == "v_identity":         # out = P: tests Q K^T
                v.zero_()
                for s in range(min(64, D)):
                    v[0, s, 0, s] = 1.0
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
            got = flash_attention(q, k, v, mode="full").float()
            want = ref.flash_attention_ref(q, k, v, mode="full").float()
            err = (got - want).abs()
            lim = FLASH_BF16_TOL["atol"] + FLASH_BF16_TOL["rtol"] * want.abs()
            res.append(dict(D=D, input=kind, max_abs_err=float(err.max()),
                            within=bool((err <= lim).all())))
    return res


# the head dims whose bf16 kv tile is 64 keys in both checkouts (128, 256;
# since the pipelined body, D <= 64 takes 96-key tiles, which change the
# bf16 outputs' rounding), and the float32 kernel at every D
BITS_SHAPES = FLASH_SHAPES + tuple(
    (2, 200, 331, 4, 2, D, mode, 50 if mode == "window" else None, dt)
    for D in (16, 32, 64, 256) for mode in ("causal", "window", "full")
    for dt in ("bfloat16", "float32") if D == 256 or dt == "float32")


def bits_root(root: Path, out: Path) -> None:
    """Kernel 6's outputs at :data:`BITS_SHAPES` from ``root``'s
    ``repro_torch``, inputs drawn on the CPU from fixed seeds, saved to
    ``out``."""
    torch = _setup(root)
    from repro_torch.kernels.flash_attention import flash_attention
    res = []
    for i, (B, Sq, Skv, H, KV, D, mode, win, dt) in enumerate(BITS_SHAPES):
        g = torch.Generator().manual_seed(i)
        q, k, v = (torch.randn(s, generator=g).to(getattr(torch, dt)).cuda()
                   for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
        res.append(flash_attention(q, k, v, mode=mode, window=win).cpu())
    torch.save(res, out)


def bits(a: Path, b: Path) -> list:
    import torch
    outs = []
    for i, root in enumerate((a, b)):
        out = HERE / "build" / "kernel_ab" / f"bits_{i}.pt"
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([sys.executable, __file__, "_bits", str(root),
                        str(out)], check=True, env=dict(os.environ))
        outs.append(torch.load(out))
    return [dict(shape=list(s), equal=bool(torch.equal(x, y)))
            for s, x, y in zip(BITS_SHAPES, *outs, strict=True)]


# kernel 6 at the runs' shapes: (label, B, S, H, KV, D, Dv), bf16 causal
FLASH_RUNS = (("r", 4, 1024, 40, 40, 96, 64), ("t", 2, 512, 40, 40, 96, 64),
              ("y", 4, 1024, 32, 32, 96, 96), ("f", 4, 1024, 56, 8, 128, 128))


def flash_root(root: Path) -> dict:
    """Kernel 6 from ``root`` at :data:`FLASH_RUNS`: device ms and the
    output's largest share of ``FLASH_BF16_TOL`` against the plain
    version; a pair the checkout has no instantiation for goes through its
    padded route."""
    torch = _setup(root)
    from chip_smoke import FLASH_BF16_TOL, time_ms
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    out = {"root": str(root)}
    for label, B, S, H, KV, D, Dv in FLASH_RUNS:
        g = torch.Generator(device="cuda").manual_seed(D + Dv + H)
        q, k, v = (torch.randn(s, generator=g, device="cuda").to(
            torch.bfloat16) for s in ((B, S, H, D), (B, S, KV, D),
                                      (B, S, KV, Dv)))
        native = Dv == D and D in fa.HEAD_DIMS or (
            getattr(fa, "kernel_pair", None) is not None
            and fa.kernel_pair(D, Dv))
        call = fa.flash_attention if native else fa.flash_attention_padded
        got = call(q, k, v).float()
        want = ref.flash_attention_ref(q, k, v).float()
        share = float(((got - want).abs() / (
            FLASH_BF16_TOL["atol"] + FLASH_BF16_TOL["rtol"] * want.abs()))
            .max())
        out[label] = dict(native=native, tol_share=share,
                          ms=time_ms(lambda: call(q, k, v), 20))
    return out


def main(argv) -> int:
    if len(argv) >= 3 and argv[1] == "time":
        for root in argv[2:]:
            # one process a checkout: each imports its own repro_torch
            subprocess.run([sys.executable, __file__, "_time", root],
                           check=True, env=dict(os.environ))
        return 0
    if len(argv) >= 3 and argv[1] == "flash":
        for root in argv[2:]:
            subprocess.run([sys.executable, __file__, "_flash", root],
                           check=True, env=dict(os.environ))
        return 0
    if len(argv) == 3 and argv[1] == "_flash":
        print(json.dumps(flash_root(Path(argv[2]).resolve())), flush=True)
        return 0
    if len(argv) == 3 and argv[1] == "_time":
        print(json.dumps(time_root(Path(argv[2]).resolve())), flush=True)
        return 0
    if len(argv) == 2 and argv[1] in ("sweep", "probe"):
        for r in (sweep() if argv[1] == "sweep" else probe()):
            print(json.dumps(r), flush=True)
        return 0
    if len(argv) in (2, 3) and argv[1] == "quant":
        for r in quant(*[Path(a).resolve() for a in argv[2:]]):
            print(json.dumps(r), flush=True)
        return 0
    if len(argv) == 4 and argv[1] == "bits":
        rows = bits(Path(argv[2]).resolve(), Path(argv[3]).resolve())
        for r in rows:
            print(json.dumps(r), flush=True)
        print(json.dumps({"all_equal": all(r["equal"] for r in rows),
                          "n": len(rows)}), flush=True)
        return 0
    if len(argv) == 4 and argv[1] == "_bits":
        bits_root(Path(argv[2]).resolve(), Path(argv[3]))
        return 0
    if len(argv) == 3 and argv[1] == "slabs":
        for r in slabs(Path(argv[2]).resolve()):
            print(json.dumps(r), flush=True)
        return 0
    if len(argv) == 5 and argv[1] == "copy" and argv[2] in VARIANTS:
        copy(argv[2], Path(argv[3]).resolve(), Path(argv[4]).resolve())
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv))
