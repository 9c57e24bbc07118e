"""The port's calls into ``torch.distributed``: the reference's ``pmean``
over the ``pod`` axis and ``psum`` over the ``clients`` axis become one
``all_reduce`` over a process group.

Every function takes the group explicitly: ``None`` means the default
(world) group, which must be initialised — with no initialised group they
raise, never running quietly as a world of one. A one-rank group is the
reference's degenerate ``(1, 1, 1)`` mesh.

:class:`CountingGroup` stands in for a group where nothing is
communicated: it records the bytes each call hands over (the operand's
bytes, as the reference's HLO analysis counts a collective's operands)
and leaves the tensor as it is. ``roofline/cost.py`` runs a step on meta
tensors against it to read the step's collective bytes from the step
itself.
"""
from __future__ import annotations

import collections
from typing import List, Tuple

import torch


class CountingGroup:
    """A process group of ``size`` ranks (this one ``rank``) that records
    ``(kind, bytes)`` for every call and communicates nothing."""

    def __init__(self, size: int = 1, rank: int = 0):
        self.size, self.rank = size, rank
        self.calls: List[Tuple[str, int]] = []

    def bytes_by_kind(self) -> dict:
        out: collections.Counter = collections.Counter()
        for kind, n in self.calls:
            out[kind] += n
        return dict(out)

    def total_bytes(self) -> int:
        return sum(n for _, n in self.calls)


def _dist():
    import torch.distributed as dist
    return dist


def _check(group) -> None:
    if isinstance(group, CountingGroup):
        return
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialised; call "
            "torch.distributed.init_process_group (a one-rank group for a "
            "single pod or card) and pass the group")


def group_size(group=None) -> int:
    _check(group)
    if isinstance(group, CountingGroup):
        return group.size
    return _dist().get_world_size(group)


def group_rank(group=None) -> int:
    _check(group)
    if isinstance(group, CountingGroup):
        return group.rank
    return _dist().get_rank(group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the group, in place; returns ``t``."""
    _check(group)
    if isinstance(group, CountingGroup):
        group.calls.append(("all-reduce", t.numel() * t.element_size()))
        return t
    _dist().all_reduce(t, op=_dist().ReduceOp.SUM, group=group)
    return t


def all_reduce_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The reference's ``pmean``: a SUM ``all_reduce`` then a division by
    the group's size (gloo has no AVG), in place; returns ``t``."""
    n = group_size(group)
    all_reduce_sum(t, group)
    if n != 1:
        t.div_(n)
    return t
