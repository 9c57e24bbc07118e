"""A process group on one host: ``world`` processes, each a rank of a
``torch.distributed`` group, each calling the same function.

    results = spawn("pkg.module:function", world=2, kwargs={...},
                    out_dir=path, backend="gloo")

Each child initialises its group from a ``FileStore`` under ``out_dir``
(``file://``; nothing outside it is read or written), imports the target
and calls ``function(rank=rank, world=world, **kwargs)``, saves the
return value with ``torch.save`` and destroys the group. The parent
waits for every child with its own deadline; a child that fails or
outlives it fails the call (the others are killed) with the child's
output in the error. Two ranks on one card take ``backend="gloo"``, which
reduces CUDA tensors through the host (NCCL refuses two ranks on one
device).
"""
from __future__ import annotations

import datetime
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

SRC = Path(__file__).resolve().parents[2]


def spawn(target: str, world: int, kwargs: Dict[str, Any], out_dir,
          backend: str = "gloo", timeout: float = 600.0,
          path: Sequence[str] = ()) -> List[Any]:
    """Run ``target`` (``"module:function"``) on ``world`` ranks; returns
    each rank's return value, in rank order. ``path`` adds directories
    the children import from (``src/`` is always there)."""
    import torch
    out = Path(out_dir).resolve()
    out.mkdir(parents=True, exist_ok=True)
    store = out / "store"
    if store.exists():
        store.unlink()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC), *map(str, path)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = []
    for rank in range(world):
        cmd = [sys.executable, "-m", "repro_torch.launch.local", target,
               str(rank), str(world), backend, str(out), str(timeout),
               json.dumps(kwargs)]
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    logs, failed = [], []
    try:
        for rank, p in enumerate(procs):
            try:
                text, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                if p.returncode != 0:
                    failed.append(f"rank {rank} exited {p.returncode}")
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
                failed.append(f"rank {rank} outlived {timeout} s")
            logs.append(text)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        tails = "\n".join(f"--- rank {r}\n{t[-4000:]}"
                          for r, t in enumerate(logs))
        raise RuntimeError(f"spawn({target}, world={world}): "
                           f"{'; '.join(failed)}\n{tails}")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _child(target: str, rank: int, world: int, backend: str, out: Path,
           timeout: float, kwargs: Dict[str, Any]) -> None:
    import torch
    import torch.distributed as dist
    dist.init_process_group(
        backend, init_method=f"file://{out / 'store'}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        mod, fn = target.split(":")
        result = getattr(importlib.import_module(mod), fn)(
            rank=rank, world=world, **kwargs)
        torch.save(result, out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> int:
    a = list(sys.argv[1:] if argv is None else argv)
    _child(a[0], int(a[1]), int(a[2]), a[3], Path(a[4]), float(a[5]),
           json.loads(a[6]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
