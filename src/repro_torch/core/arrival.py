"""Vectorized event simulation for buffered-async FL (port of
``repro.core.arrival``, DESIGN.md §12.2).

:class:`ArrivalEngine` holds the async scheduler's event queue as
struct-of-arrays numpy state: one ``float64`` next-arrival time per client
and one ``int64`` dispatch sequence number (the FIFO tie-break the heap's
``(time, seq, ci)`` tuples encode). Popping the first-K buffer is one
vectorized selection instead of K heap pops. It is **order-exact**
against the heap: times stay ``float64``, sequence numbers are assigned
identically, and :meth:`ArrivalEngine.pop_k` returns exactly the K
lexicographically smallest ``(time, seq)`` entries in pop order.

:func:`pop_k_device` is the same selection on a tensor's device: two
stable sorts (by ``seq``, then by ``time``) give the lexicographic
``(time, seq)`` order with no host work.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


class ArrivalEngine:
    """Struct-of-arrays event queue over a fixed client population:
    ``times[ci]`` is the arrival time of the client's in-flight dispatch
    (``+inf`` = not in flight), ``seqs[ci]`` its dispatch sequence number
    (``-1`` = not in flight). A client has at most one in-flight update
    (the FedBuff dispatch discipline)."""

    def __init__(self, n_clients: int):
        self.n = int(n_clients)
        self.times = np.full(self.n, np.inf, dtype=np.float64)
        self.seqs = np.full(self.n, -1, dtype=np.int64)
        self.next_seq = 0

    def in_flight(self) -> int:
        return int(np.count_nonzero(np.isfinite(self.times)))

    def push(self, ci: int, t: float) -> None:
        """Dispatch client ``ci`` with arrival time ``t``."""
        if np.isfinite(self.times[ci]):
            raise ValueError(f"client {ci} already has an in-flight dispatch")
        self.times[ci] = float(t)
        self.seqs[ci] = self.next_seq
        self.next_seq += 1

    def push_many(self, cis: Sequence[int], ts: Sequence[float]) -> None:
        """Dispatch a cohort: sequence numbers in ``cis`` order, as one
        :meth:`push` per client would assign them."""
        cis = np.asarray(cis, dtype=np.int64)
        if np.isfinite(self.times[cis]).any():
            raise ValueError("push_many over clients with in-flight "
                             "dispatches")
        self.times[cis] = np.asarray(ts, dtype=np.float64)
        self.seqs[cis] = self.next_seq + np.arange(len(cis), dtype=np.int64)
        self.next_seq += len(cis)

    def pop_k(self, k: int) -> List[Tuple[float, int]]:
        """Drain the first-K buffer: the K in-flight entries with the
        smallest ``(time, seq)``, in pop order, as ``(time, client)`` —
        what K ``heapq.heappop`` calls on ``(time, seq, ci)`` return."""
        if not 0 < k <= self.in_flight():
            raise ValueError(f"pop_k({k}) with {self.in_flight()} in flight")
        # the K-th smallest time bounds the candidates; ties at the bound
        # make it a superset, resolved by the (time, seq) lexsort
        kth = np.partition(self.times, k - 1)[k - 1]
        cand = np.flatnonzero(self.times <= kth)
        order = np.lexsort((self.seqs[cand], self.times[cand]))
        take = cand[order[:k]]
        out = [(float(self.times[ci]), int(ci)) for ci in take]
        self.times[take] = np.inf
        self.seqs[take] = -1
        return out

    def entries(self) -> List[List[float]]:
        """In-flight ``[time, seq, client]`` rows, the heap's shape."""
        live = np.flatnonzero(np.isfinite(self.times))
        return [[float(self.times[ci]), int(self.seqs[ci]), int(ci)]
                for ci in live]

    @classmethod
    def from_entries(cls, n_clients: int, entries, next_seq: int
                     ) -> "ArrivalEngine":
        eng = cls(n_clients)
        for t, s, ci in entries:
            eng.times[int(ci)] = float(t)
            eng.seqs[int(ci)] = int(s)
        eng.next_seq = int(next_seq)
        return eng


def pop_k_device(times: torch.Tensor, seqs: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-K selection on the tensors' device: the popped arrival times
    ``(k,)`` and client indices ``(k,)`` (int32) in ascending
    lexicographic ``(time, seq)`` order — a stable sort by ``seq``, then a
    stable sort by ``time``, so equal times keep ``seq`` order."""
    by_seq = torch.sort(seqs, stable=True)[1]
    by_time = torch.sort(times[by_seq], stable=True)[1]
    idx = by_seq[by_time[:k]]
    return times[idx], idx.to(torch.int32)
