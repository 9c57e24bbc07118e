"""Plumbing shared by the example entry points: the ``--device`` flag,
a printer that keeps what it printed, and the card's clock."""
from __future__ import annotations

import argparse
import contextlib
import socket
import time
from typing import List, Optional, Sequence

import torch

from repro_torch.device import resolve


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the ``--device`` flag every example takes."""
    ap = argparse.ArgumentParser(
        description=doc.strip().splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where to run (default cuda; raises without a card)")
    return ap


def parse(ap: argparse.ArgumentParser,
          argv: Optional[Sequence[str]]) -> argparse.Namespace:
    """Parse ``argv`` and resolve ``--device`` (``None`` → ``cuda``)."""
    args = ap.parse_args(argv)
    args.device = resolve(args.device)
    return args


class Printer:
    """``print`` that also keeps every line it printed."""

    def __init__(self) -> None:
        self.lines: List[str] = []

    def __call__(self, text: str = "") -> None:
        print(text, flush=True)
        self.lines.extend(text.split("\n"))


def clock(device: torch.device) -> float:
    """The host clock after the device has finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@contextlib.contextmanager
def one_rank_group(device: torch.device):
    """A one-rank process group for the sharded server paths (NCCL on the
    card, gloo on the CPU), destroyed on exit; an already initialised
    group is used as it is and left alone."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield None
        return
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cuda = device.type == "cuda"
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1,
        device_id=(torch.device("cuda", torch.cuda.current_device()
                                if device.index is None else device.index)
                   if cuda else None))
    try:
        yield None
    finally:
        dist.destroy_process_group()
