"""Build, load and launch the port's CUDA kernels (``src/repro_torch/csrc``).

The sources have a plain C interface; ``nvcc`` compiles each one for
``sm_90a`` (all started together), links them into one shared library and
``ctypes`` loads it. The library lands in ``build/repro_torch/<hash>/`` at
the repository root, keyed by a hash of the sources and flags, at first
use — never at import, so the CPU tests import every module without a
compiler. ``--use_fast_math`` stays off: the quantizer's ties depend on
IEEE division.

Every launch goes through :func:`launch`, which refuses tensors that
autograd is recording (:func:`check_no_grad`), passes tensor pointers and
PyTorch's current stream, raises on a non-zero ``cudaGetLastError`` and
counts one launch for its wrapper in :data:`LAUNCHES`.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("quantize.cu", "fused_dense.cu", "fused_decode_agg.cu",
           "grouped_decode_agg.cu", "flash_attention.cu")
HEADERS = ("decode_agg_tile.cuh", "repro_errors.h")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

# launches per wrapper name, reset by callers that measure a run
LAUNCHES: collections.Counter = collections.Counter()

_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
_SIGNATURES = {
    # x, q, s, nb, block, qmax, route, grid, threads, stream
    "repro_quantize_blocks": [_P, _P, _P, _LL, _I, _F, _I, _I, _I, _P],
    # q, s, x, nb, block, route, grid, threads, stream
    "repro_dequantize_blocks": [_P, _P, _P, _LL, _I, _I, _I, _I, _P],
    # x, w, b, y, M, K, N, act, dtype, route, tile, sms, stream
    "repro_fused_dense": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    # x, w, b, y, ws, M, K, N, act, dtype, rows, tpr, stream
    "repro_fused_dense_splitk": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _P],
    # h, w, W, b, out, C, M, K, N, bm, cols_per_split, stream
    "repro_fused_decode_agg": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _P],
    # h, w, W, b, out, C, M, K, N, tpr, stream
    "repro_fused_decode_agg_rows": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _P],
    # table, T, K, N, bm, cols_per_split, tpr, mt, stream
    "repro_grouped_decode_agg": [_P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, o, B, Sq, Skv, H, KV, D, Dv, mode, window, q_offset, scale,
    # softcap, dtype, stream
    "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _F, _F, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    LAUNCHES.clear()


def _build_root() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the port's kernels cannot be built")
    return found


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Tuple[Path, float, str]:
    """Compile every source (one ``nvcc`` each, run in parallel), link one
    shared library. Returns ``(path, seconds, compiler output)`` — the
    output holds ``ptxas``'s registers, shared memory and spills per
    kernel; a cached library built from the same sources and flags is
    reused (0 seconds, no output)."""
    out_dir = _build_root() / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *FLAGS, "-c", str(CSRC / name), "-o",
                   str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log: List[str] = []
        failed = []
        for name, _, p in procs:
            text, _ = p.communicate()
            log.append(f"--- {name}\n{text}")
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)          # atomic for concurrent builds
    return lib_path, time.perf_counter() - t0, "\n".join(log)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               shape: Optional[Tuple[int, ...]] = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``shape``
    — what the kernels take."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_no_grad(counter: str, args) -> None:
    """Raise when autograd is recording and a tensor among ``args``
    requires grad: a kernel writes its output through a raw pointer, so
    the output would carry no ``grad_fn`` and the gradient would be cut
    without an error. (No kernel of the port has a backward; the
    reference's Pallas kernels have none either.)"""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        raise RuntimeError(
            f"{counter}: a tensor argument requires grad while autograd is "
            "recording; the kernel has no backward and would cut the "
            "gradient (call it under torch.no_grad(), or take the plain "
            "differentiable path)")


def launch(counter: str, fn: str, *args) -> None:
    """Call C launcher ``fn`` with tensor pointers, ints and floats, on the
    current stream of the tensors' device; raise on a launch error and
    count one launch for ``counter``."""
    check_no_grad(counter, args)
    lib = load()
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn)(*conv, stream)
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{counter}: kernel launch failed: {msg} ({rc})")
    LAUNCHES[counter] += 1


def device_sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def counts() -> Dict[str, int]:
    return dict(LAUNCHES)
