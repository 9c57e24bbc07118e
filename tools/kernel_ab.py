"""Device times of kernels 3 and 6 (``fused_dense``, ``flash_attention``)
for A/B comparisons on one card, and probes of their CUDA routes.

    python3 tools/kernel_ab.py time ROOT [ROOT ...]   # one JSON line a ROOT
    python3 tools/kernel_ab.py sweep                  # split-K plans, profiler
    python3 tools/kernel_ab.py probe                  # structured inputs

``time`` imports ``repro_torch`` from each checkout ROOT in its own process
(a parent unpacked with ``git archive``, this checkout, a copy with one
edit) and times the main-path shapes and the library calls beside them, so
comparisons are made within one run on one card: list the roots in turns,
e.g. ``parent . . parent``. ``sweep`` launches the split-K kernel with
slab rows and column-tile widths other than ``splitk_plan``'s and splits a
call's device time by kernel with ``torch.profiler``. ``probe`` holds the
bf16 flash route against its plain version on inputs that isolate Q K^T
(identity V) and P V (q = 0, uniform P) at each head dim. Times are device
times from ``chip_smoke.time_ms`` (calls captured in a CUDA graph).
Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FD_SHAPES = ((4, 4096, 512, "relu", "float32"), (4, 512, 8, "relu", "float32"),
             (4, 8, 512, "relu", "float32"),
             (4, 512, 4096, "linear", "float32"),
             (12, 8, 512, "relu", "float32"),
             (4096, 256, 32, "relu", "bfloat16"),
             (256 * 4096, 8, 32, "relu", "float32"),
             (256 * 4096, 32, 256, "linear", "float32"))
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


def time_root(root: Path) -> dict:
    torch = _setup(root)
    import torch.nn.functional as F
    from chip_smoke import time_ms
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_dense import fused_dense
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(root)}
    for M, K, N, act, dt in FD_SHAPES:
        dtype = getattr(torch, dt)
        x, w, b = (torch.randn(s, generator=g, device="cuda").to(dtype)
                   for s in ((M, K), (K, N), (N,)))
        iters = 10 if M > 100_000 else 50
        out[f"fd {M},{K},{N} {act} {dt}"] = time_ms(
            lambda: fused_dense(x, w, b, act=act), iters)
        out[f"addmm {M},{K},{N} {dt}"] = time_ms(
            lambda: torch.addmm(b, x, w), iters)
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


def main(argv) -> int:
    if len(argv) >= 3 and argv[1] == "time":
        for root in argv[2:]:
            # one process a checkout: each imports its own repro_torch
            subprocess.run([sys.executable, __file__, "_time", root],
                           check=True, env=dict(os.environ))
        return 0
    if len(argv) == 3 and argv[1] == "_time":
        print(json.dumps(time_root(Path(argv[2]).resolve())), flush=True)
        return 0
    if len(argv) == 2 and argv[1] in ("sweep", "probe"):
        for r in (sweep() if argv[1] == "sweep" else probe()):
            print(json.dumps(r), flush=True)
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv))
