"""Adaptive rate control: per-client codec selection along a ladder of
compressors (port of ``repro.core.ratecontrol``, DESIGN.md §9 and §15).

The paper's ratio "can be modified based on the accuracy requirements"
(§4.2); this module makes the operating point a policy:

* a **ladder** is a per-client list of compressors ordered
  cheapest-uplink-first (:func:`fc_ae_ladder`), or per client a
  ``{group: [rungs]}`` dict over a partition map (:func:`partition_ladder`);
  rung ``k`` has one spec for every client, so the server's
  decode→aggregate groups a mixed cohort by spec;
* a :class:`RateController` decides at the end of each round which rung
  each participant (or each ``(client, group)`` lane) takes next:
  :class:`FixedRate` never moves, :class:`DistortionTarget` walks toward
  the cheapest rung under a distortion target, :class:`ByteBudget` spends
  an uplink budget greedily by drift, :class:`RDBudget` water-fills it by
  marginal distortion per byte over each lane's convex hull;
* every decision reads one **batched probe** a round (one a group for
  partitioned ladders): the relative reconstruction error of each probed
  lane's newest snapshot through every rung (:func:`_batched_rel_errs`).
  The reference vmaps its probe under one jit; here lanes that share a
  codec's params are folded into the rows of one call (a quantizer's
  blocks, a chunked AE's chunks: one kernel launch a layer on the card),
  FC AEs run as batched matrix products, and any other codec is probed
  lane by lane;
* a switch onto an AE rung refits that rung on the lane's snapshot ring
  through the lifecycle's cohort refit and ships its decoder, charged to
  the round's ``bytes_decoder``; the whole controller state rides the
  run's checkpoint in the reference's layout.

The allocator helpers (:func:`_hull_prune`, :func:`_quantized_gain`,
:func:`_rd_waterfill`, :func:`_rd_topup`) are plain Python over host
floats, copied from the reference so that ties and insertion order
resolve alike.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.paper import AEConfig
from repro_torch.core import autoencoder as ae
from repro_torch.core import codec
from repro_torch.core.compressor import (ComposedCompressor, Compressor,
                                         FCAECompressor,
                                         PartitionedCompressor, partitioned)
from repro_torch.core.lifecycle import (AELifecycle, _rel_recon_err,
                                        buffer_snapshot)
from repro_torch.core.pytree import leaves, stack
from repro_torch.device import DeviceLike, resolve

Tree = Any
# [client][rung] (flat), or [client]{group: [rung]} (per-partition ladders)
# — cheapest-uplink-first within every rung list
Ladder = List[Any]


def fc_ae_ladder(n_clients: int, input_dim: int,
                 latent_dims: Sequence[int] = (8, 32, 128),
                 hidden: Tuple[int, ...] = (64,),
                 bits: Optional[int] = None,
                 seed: int = 0,
                 params: Optional[Sequence[Sequence[Tree]]] = None,
                 device: DeviceLike = None) -> Ladder:
    """Per-client FC autoencoders at ascending latent widths, optionally
    composed with ``bits``-wide latent quantization. ``params[ci][k]``
    supplies fitted AE params (marked ``prefit``, so the policies trust
    their probes at once); an omitted rung is drawn on a CPU generator
    seeded with the reference's integer ``(seed·1,000,003 + ci·1009 + k)
    mod 2^31``, moved to ``device``, and stays unfit until a refit lands."""
    assert list(latent_dims) == sorted(latent_dims), (
        "ladder rungs must be ordered cheapest-uplink-first "
        f"(ascending latent dims), got {latent_dims}")
    dev = resolve(device)
    out: Ladder = []
    for ci in range(n_clients):
        row: List[Compressor] = []
        for k, latent in enumerate(latent_dims):
            cfg = AEConfig(input_dim=input_dim, encoder_hidden=hidden,
                           latent_dim=latent)
            seeded = params is not None and params[ci][k] is not None
            if seeded:
                p = params[ci][k]
            else:
                gen = torch.Generator().manual_seed(
                    (seed * 1_000_003 + ci * 1009 + k) % 2 ** 31)
                p = ae.init_fc_ae(gen, cfg, dev)
            inner = FCAECompressor(p, cfg)
            inner.prefit = seeded
            comp: Compressor = inner
            if bits is not None:
                comp = ComposedCompressor(comp, bits=bits)
            row.append(comp)
        out.append(row)
    return out


def partition_ladder(n_clients: int, pmap,
                     rung_factories: Dict[str, Sequence]) -> Ladder:
    """Per-(client, partition) ladder: ``rung_factories[group]`` lists
    ``factory(ci, group_size) -> Compressor`` cheapest-uplink-first. Every
    group of ``pmap`` needs an entry; a one-rung group is pinned."""
    assert set(rung_factories) == set(pmap.names), (
        f"rung factories {sorted(rung_factories)} != partition groups "
        f"{sorted(pmap.names)}")
    return [{name: [factory(ci, pmap.group_size(name))
                    for factory in rung_factories[name]]
             for name in pmap.names}
            for ci in range(n_clients)]


# ---------------------------------------------------------------- probe
def _rel_err_rows(flats: torch.Tensor, decoded: torch.Tensor
                  ) -> torch.Tensor:
    """Row-wise ``_rel_recon_err``: roundtrip MSE over the input's
    variance, per lane."""
    num = torch.mean(torch.square(flats - decoded), dim=-1)
    den = torch.mean(torch.square(
        flats - torch.mean(flats, dim=-1, keepdim=True)), dim=-1) + 1e-12
    return num / den


def _fold_roundtrip(spec, params: Optional[Tree], flats: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """Encode→decode of lanes that share ``params`` as one call: each lane
    is zero-padded to a multiple of the codec's row width (as its own
    encode pads it), the lanes are laid end to end, and one spec of the
    whole length runs them, so each block or chunk is coded exactly as in
    the lane's own call."""
    m, n = flats.shape
    pad = (-n) % stride
    x = torch.nn.functional.pad(flats, (0, pad)) if pad else flats
    big = dataclasses.replace(spec, size=m * (n + pad))
    out = codec.decode(big, params,
                       codec.encode(big, params, x.reshape(-1)))
    return out.reshape(m, n + pad)[:, :n]


@torch.no_grad()
def _rung_rel_errs(spec, plist: List[Optional[Tree]],
                   flats: torch.Tensor) -> torch.Tensor:
    """One rung's relative error for every lane (``flats`` is ``(L, n)``,
    ``plist[j]`` lane ``j``'s codec params)."""
    if isinstance(spec, (codec.QuantizeSpec, codec.ChunkedAESpec)):
        stride = (spec.block if isinstance(spec, codec.QuantizeSpec)
                  else spec.cfg.chunk_size)
        shared: Dict[int, List[int]] = {}
        for j, p in enumerate(plist):
            shared.setdefault(id(p), []).append(j)
        decoded = torch.empty_like(flats)
        for idx in shared.values():
            decoded[idx] = _fold_roundtrip(spec, plist[idx[0]], flats[idx],
                                           stride)
        return _rel_err_rows(flats, decoded)
    if isinstance(spec, codec.FCAESpec):
        n = flats.shape[1]
        pad = spec.cfg.input_dim - n
        x = torch.nn.functional.pad(flats, (0, pad)) if pad else flats
        if all(p is plist[0] for p in plist):
            decoded = ae.fc_reconstruct(plist[0], spec.cfg, x)
        else:
            decoded = torch.func.vmap(
                lambda p, v: ae.fc_reconstruct(p, spec.cfg, v))(
                    stack(plist), x)
        return _rel_err_rows(flats, decoded[:, :n])
    return torch.stack([_rel_recon_err(spec, p, f)
                        for p, f in zip(plist, flats)])


def _batched_rel_errs(specs: Tuple[Any, ...],
                      params_cols: Sequence[List[Optional[Tree]]],
                      flats: torch.Tensor) -> torch.Tensor:
    """The whole ``(rung, lane)`` distortion matrix: ``flats`` stacks the
    probed lanes' newest snapshots ``(L, n)`` and ``params_cols[k]`` lists
    every lane's rung-``k`` codec params. One host transfer of the result
    follows, instead of one blocking read a lane and rung."""
    return torch.stack([_rung_rel_errs(spec, plist, flats)
                        for spec, plist in zip(specs, params_cols)])


def _rung_prefit(comp: Compressor) -> bool:
    """Whether a rung's probe is honest from round 0: pointwise codecs
    always, AE-backed rungs only when their params came from a fit
    (``prefit``). Fresh-init AE rungs measure garbage until refit."""
    sub = comp.ae_compressor()
    return sub is None or bool(getattr(sub, "prefit", False))


# ------------------------------------------------------------ allocator
def _hull_prune(points: List[Tuple[int, float, float, float]]
                ) -> List[Tuple[int, float, float, float]]:
    """Lower convex hull of one lane's ``(rung, cost, price, dist)``
    operating points (DESIGN.md §15.3): dominated points fall away, points
    above the chord of their neighbours are pruned, collinear points stay
    (with a relative tolerance, so a point 1 ulp above an exact chord
    keeps its single-rung step)."""
    pts = sorted(points, key=lambda p: (p[2], p[3], p[0]))
    mono: List[Tuple[int, float, float, float]] = []
    for p in pts:
        if mono and p[3] >= mono[-1][3]:
            continue                      # dominated: pricier, not better
        mono.append(p)
    hull: List[Tuple[int, float, float, float]] = []
    for p in mono:
        while len(hull) >= 2:
            a, b = hull[-2], hull[-1]
            direct = (a[3] - p[3]) / (p[2] - a[2])
            through = (a[3] - b[3]) / (b[2] - a[2])
            if direct > through * (1.0 + 1e-9):  # b above the chord a→p
                hull.pop()
            else:
                break
        hull.append(p)
    return hull


def _quantized_gain(gain: float) -> float:
    """A gain at 7 significant digits, so near-tied hull steps fall through
    to the ``(step, -drift, lane)`` tie-break rather than rounding."""
    return float(f"{gain:.6e}")


def _lane_sort_key(ln) -> Tuple:
    """Flat lanes are ints, partitioned lanes ``(client, group)`` tuples:
    both as tuples, so heap keys compare."""
    return ln if isinstance(ln, tuple) else (ln,)


def _rd_waterfill(curves: Dict[Any, Tuple[List[Tuple[int, float, float,
                                                     float]], float]],
                  budget: float, fixed_spend: float
                  ) -> Tuple[Optional[Dict[Any, int]], Optional[float]]:
    """The λ sweep over every lane's hull steps (DESIGN.md §15.3):
    ``curves[lane] = (hull, tiebreak drift)``. Lanes start at their
    cheapest hull point; a heap takes next steps in descending quantized
    gain (then step, drift, lane) while the true uplink ``cost`` fits the
    budget. Returns ``(hull index per lane, λ*)``, or ``(None, None)`` when
    the all-cheapest floor overflows."""
    take = {ln: 0 for ln in curves}
    spent = fixed_spend + sum(h[0][1] for h, _ in curves.values())
    if spent > budget:
        return None, None

    def step(ln, i):
        hull, score = curves[ln]
        if i >= len(hull):
            return None
        gain = ((hull[i - 1][3] - hull[i][3])
                / (hull[i][2] - hull[i - 1][2]))
        key = (-_quantized_gain(gain), i, -score, _lane_sort_key(ln))
        return (key, gain, i, ln, hull[i][1] - hull[i - 1][1])

    heap = [s for ln in curves if (s := step(ln, 1)) is not None]
    heapq.heapify(heap)
    lam = None
    while heap:
        _key, gain, i, ln, dcost = heapq.heappop(heap)
        if spent + dcost > budget:
            continue                      # lane done: later steps unreachable
        take[ln] = i
        spent += dcost
        lam = gain
        nxt = step(ln, i + 1)
        if nxt is not None:
            heapq.heappush(heap, nxt)
    return take, lam


def _rd_topup(raw: Dict[Any, List[Tuple[int, float, float, float]]],
              chosen: Dict[Any, Tuple[int, float, float, float]],
              budget: float, spent: float) -> Optional[float]:
    """Spend what the hull sweep stranded on the best affordable raw-point
    upgrade, repeatedly (a pruned interior rung can fit where the hull's
    jump cannot). Mutates ``chosen``; returns the gain of the last
    accepted upgrade, or None."""
    lam = None
    while True:
        best = None
        for ln in sorted(raw, key=_lane_sort_key):
            cpt = chosen[ln]
            for p in raw[ln]:
                if p[3] >= cpt[3]:
                    continue              # not a distortion improvement
                if spent + (p[1] - cpt[1]) > budget:
                    continue              # true uplink cost infeasible
                dprice = p[2] - cpt[2]
                gain = ((cpt[3] - p[3]) / dprice if dprice > 0
                        else float("inf"))
                key = (-_quantized_gain(gain), _lane_sort_key(ln), p[0])
                if best is None or key < best[0]:
                    best = (key, ln, p, gain)
        if best is None:
            return lam
        _, ln, p, gain = best
        spent += p[1] - chosen[ln][1]
        chosen[ln] = p
        lam = gain


# ----------------------------------------------------------- controller
@dataclasses.dataclass
class RateController:
    """Base policy: owns the ladder, the rung occupancy and the
    switch → refit → decoder-ship mechanics; subclasses implement
    :meth:`plan`. ``ladder=None`` makes the run's compressors a one-rung
    ladder. ``min_snapshots`` gates switching, ``buffer_size`` bounds the
    snapshot ring kept for lanes the lifecycle does not buffer, and the
    ``refit_*`` knobs configure the internal lifecycle used for
    switch-time refits when the run has none of its own.

    ``probe_dispatches`` counts batched probes (a diagnostic: it feeds no
    decision and rides no checkpoint)."""

    ladder: Optional[Ladder] = None
    initial_rung: int = 0
    min_snapshots: int = 2
    buffer_size: int = 8
    refit_epochs: int = 30
    refit_batch: int = 8
    refit_lr: float = 3e-3
    seed: int = 0
    # the partition.PartitionMap behind a per-partition ladder (rows are
    # {group: [rungs]} dicts, see partition_ladder) — None for flat ladders
    partition: Optional[Any] = None
    name: str = "fixed"

    # ------------------------------------------------------------------
    def bind(self, run) -> None:
        """Attach to a ``FederatedRun`` and install each client's initial
        rung. Called once from the run's constructor, before the
        scheduler binds."""
        assert getattr(self, "run", None) is None, (
            "controller is already bound to a FederatedRun; create a fresh "
            "controller instance per run")
        self.run = run
        n = len(run.datasets)
        self.probe_dispatches = 0
        self._partitioned = bool(self.ladder is not None and len(self.ladder)
                                 and isinstance(self.ladder[0], dict))
        if self._partitioned:
            self._bind_partitioned(run, n)
            return
        if self.ladder is not None:
            assert len(self.ladder) == n, (
                f"ladder has {len(self.ladder)} clients, run has {n}")
            widths = {len(row) for row in self.ladder}
            assert len(widths) == 1, "every client needs the same rung count"
            self._comps = [list(row) for row in self.ladder]
            assert 0 <= self.initial_rung < len(self._comps[0])
            for ci in range(n):
                run.compressors[ci] = self._comps[ci][self.initial_rung]
        else:
            self._comps = [[c] for c in run.compressors]
        self.n_rungs = len(self._comps[0])
        start = self.initial_rung if self.ladder is not None else 0
        self._rung = np.full(n, start, dtype=np.int64)
        self._last_switch = np.full(n, -(10 ** 9), dtype=np.int64)
        self._any_ae = any(c.ae_compressor() is not None
                           for row in self._comps for c in row)
        self._refitter = self._make_refitter()
        self._n = sum(x.numel() for x in leaves(run.global_params))
        # one price list serves every client: rung k must mean the same
        # spec for all of them (params may differ)
        for ci, row in enumerate(self._comps[1:], start=1):
            for k, c in enumerate(row):
                assert c.spec(self._n) == self._comps[0][k].spec(self._n), (
                    f"client {ci} rung {k} spec differs from client 0's — "
                    "per-rung specs must agree across the ladder")
        self._costs = [codec.wire_bytes(self._comps[0][k].spec(self._n),
                                        self._comps[0][k].codec_params())
                       for k in range(self.n_rungs)]
        assert all(a <= b for a, b in zip(self._costs, self._costs[1:])), (
            "ladder rungs must be ordered cheapest-uplink-first, got wire "
            f"costs {self._costs}")
        self._fitted = np.array(
            [[_rung_prefit(c) for c in row] for row in self._comps],
            dtype=bool)
        self._last_err: Dict[int, float] = {}

    def _make_refitter(self) -> AELifecycle:
        return AELifecycle(
            buffer_size=self.buffer_size, min_snapshots=self.min_snapshots,
            refresh_epochs=self.refit_epochs, batch_size=self.refit_batch,
            lr=self.refit_lr, seed=self.seed)

    def _bind_partitioned(self, run, n: int) -> None:
        """Per-partition ladders: the unit of control is the lane
        ``(client, group)``; each walks its own rung list under the shared
        policy. Installs a ``PartitionedCompressor`` per client; a switch
        swaps that group's sub-compressor in place."""
        assert self.partition is not None, (
            "a per-partition ladder (dict rows) needs the controller's "
            "``partition=`` PartitionMap")
        assert len(self.ladder) == n, (
            f"ladder has {len(self.ladder)} clients, run has {n}")
        names = list(self.partition.names)
        for ci, row in enumerate(self.ladder):
            assert set(row) == set(names), (
                f"client {ci} ladder groups {sorted(row)} != partition "
                f"groups {sorted(names)}")
        self._pcomps = [
            {name: list(self.ladder[ci][name]) for name in names}
            for ci in range(n)]
        self._pnrungs = {name: len(self._pcomps[0][name]) for name in names}
        for ci in range(1, n):
            for name in names:
                assert len(self._pcomps[ci][name]) == self._pnrungs[name], (
                    f"client {ci} group {name!r}: rung count differs")
        self._prung = {
            name: np.full(n, min(self.initial_rung,
                                 self._pnrungs[name] - 1), dtype=np.int64)
            for name in names}
        self._plast = {name: np.full(n, -(10 ** 9), dtype=np.int64)
                       for name in names}
        for ci in range(n):
            run.compressors[ci] = PartitionedCompressor(
                self.partition,
                {name: self._pcomps[ci][name][self._prung[name][ci]]
                 for name in names})
        self._any_ae = any(c.ae_compressor() is not None
                           for row in self._pcomps
                           for rungs in row.values() for c in rungs)
        self._refitter = self._make_refitter()
        self._n = sum(x.numel() for x in leaves(run.global_params))
        assert self._n == self.partition.size, (
            f"partition map covers {self.partition.size} params but the "
            f"model has {self._n}")
        for name in names:
            gsize = self.partition.group_size(name)
            for ci in range(1, n):
                for k, c in enumerate(self._pcomps[ci][name]):
                    assert c.spec(gsize) == \
                        self._pcomps[0][name][k].spec(gsize), (
                            f"client {ci} group {name!r} rung {k} spec "
                            "differs from client 0's — per-rung specs must "
                            "agree across the ladder")
        self._pcosts = {
            name: [codec.wire_bytes(
                self._pcomps[0][name][k].spec(
                    self.partition.group_size(name)),
                self._pcomps[0][name][k].codec_params())
                for k in range(self._pnrungs[name])]
            for name in names}
        for name, costs in self._pcosts.items():
            assert all(a <= b for a, b in zip(costs, costs[1:])), (
                f"group {name!r} rungs must be ordered "
                f"cheapest-uplink-first, got wire costs {costs}")
        self._pfitted = {
            name: np.array([[_rung_prefit(c)
                             for c in self._pcomps[ci][name]]
                            for ci in range(n)], dtype=bool)
            for name in names}
        self._last_err: Dict[int, float] = {}

    # ------------------------------------------------------------------
    def rung_of(self, ci: int) -> int:
        return int(self._rung[ci])

    def rung_of_group(self, ci: int, name: str) -> int:
        """Current rung of the ``(ci, name)`` lane (per-partition ladders)."""
        return int(self._prung[name][ci])

    def wire_cost(self, rung: int) -> float:
        """Planned uplink bytes of one payload at ``rung``
        (``codec.wire_bytes``, equal to an observed encode)."""
        return float(self._costs[rung])

    def wire_cost_group(self, name: str, rung: int) -> float:
        return float(self._pcosts[name][rung])

    # ------------------------------------------------------------------
    def observe(self, run, state, comp, flat: torch.Tensor) -> None:
        """Buffer the post-EF flat vector a client just encoded, for lanes
        the AE lifecycle does not buffer (pointwise rungs, or no lifecycle
        attached). A ladder that cannot move buffers nothing."""
        if self._partitioned:
            from repro_torch.core import partition
            pc = partitioned(comp)
            ae_groups = pc.ae_groups()
            for name in self.partition.names:
                if self._pnrungs[name] <= 1:
                    continue             # pinned lane: nothing to decide
                if run.lifecycle is not None and name in ae_groups:
                    continue             # lifecycle buffered this group
                seg = partition.gather(pc.pmap.slices_of(name), flat)
                ring = state.part_snapshots.setdefault(name, [])
                ring.append(seg)
                del ring[:-self.buffer_size]
            return
        if self.n_rungs <= 1:
            return
        if run.lifecycle is not None and comp.ae_compressor() is not None:
            return                   # lifecycle buffered this one already
        buffer_snapshot(state, flat, self.buffer_size)

    # ------------------------------------------------------------------
    def plan(self, run, r: int, participants: List[int]) -> Dict[int, int]:
        """Policy hook: proposed rung per client or lane (omit = stay). The
        base controller is FixedRate: it never proposes a move."""
        return {}

    # ------------------------------------------------------------------
    def end_of_round(self, run, r: int, participants: Sequence[int]
                     ) -> Tuple[float, List, List]:
        """After round ``r``'s aggregation and the lifecycle's own
        ``end_of_round``: apply the policy's moves, refit switched-to AE
        rungs on the snapshot rings (one cohort dispatch a shape group)
        and ship their decoders. Returns ``(decoder_bytes, synced lanes,
        switches)``, each switch ``(client or lane, from_rung, to_rung)``."""
        bytes_dec, synced = 0.0, []
        if run.lifecycle is None and self._any_ae:
            # no user lifecycle: the internal refitter still owes the
            # initial decoder ships of Eq. 5/6
            bytes_dec, synced = self._refitter.end_of_round(
                run, r, participants)
        moves = self.plan(run, r, sorted(set(participants)))
        if self._partitioned:
            b, s, switches = self._apply_lane_moves(run, r, moves)
            return bytes_dec + b, sorted(synced + s), switches
        switches: List[Tuple[int, int, int]] = []
        refit_todo: List[int] = []
        for ci in sorted(moves):
            new = int(moves[ci])
            old = int(self._rung[ci])
            if new == old:
                continue
            self._rung[ci] = new
            run.compressors[ci] = self._comps[ci][new]
            self._last_switch[ci] = r
            switches.append((ci, old, new))
            if run.compressors[ci].ae_compressor() is not None:
                refit_todo.append(ci)
            else:
                run.clients[ci].ae_baseline = None   # stale vs old AE rung
        lc = run.lifecycle if run.lifecycle is not None else self._refitter
        fit_now = [ci for ci in refit_todo
                   if len(run.clients[ci].snapshots) >= self.min_snapshots]
        refit = dict(lc._refit(run, r, fit_now))
        for ci in refit_todo:
            comp = run.compressors[ci].ae_compressor()
            if ci in refit:
                comp.params = refit[ci]
                self._fitted[ci, int(self._rung[ci])] = True
            st = run.clients[ci]
            st.last_refresh = r
            st.ae_baseline = lc._lane_baseline(run, ci)
            # every switch onto an AE rung ships its decoder, refit or not
            bytes_dec += ae.decoder_sync_bytes(comp.params)
            synced.append(ci)
        # multiset: initial ship + switch re-ship in one round = 2 syncs
        return bytes_dec, sorted(synced), switches

    def _apply_lane_moves(self, run, r: int, moves: Dict
                          ) -> Tuple[float, List, List]:
        """Per-partition half of :meth:`end_of_round`: moves keyed by
        ``(client, group)``; a switched-onto AE lane refits on the group's
        own ring and ships that group's decoder."""
        bytes_dec, synced = 0.0, []
        switches: List[Tuple[Any, int, int]] = []
        refit_todo: List[Tuple[int, str]] = []
        for lane in sorted(moves):
            ci, name = lane
            new = int(moves[lane])
            old = int(self._prung[name][ci])
            if new == old:
                continue
            self._prung[name][ci] = new
            pc = partitioned(run.compressors[ci])
            pc.compressors[name] = self._pcomps[ci][name][new]
            self._plast[name][ci] = r
            switches.append((lane, old, new))
            if pc.compressors[name].ae_compressor() is not None:
                refit_todo.append(lane)
            else:
                run.clients[ci].part_baseline[name] = None
        lc = run.lifecycle if run.lifecycle is not None else self._refitter
        fit_now = [
            lane for lane in refit_todo
            if len(run.clients[lane[0]].part_snapshots.get(lane[1], []))
            >= self.min_snapshots]
        refit = dict(lc._refit(run, r, fit_now))
        for lane in refit_todo:
            ci, name = lane
            comp = partitioned(run.compressors[ci]).ae_groups()[name]
            if lane in refit:
                comp.params = refit[lane]
                self._pfitted[name][ci, int(self._prung[name][ci])] = True
            st = run.clients[ci]
            st.part_last_refresh[name] = r
            st.part_baseline[name] = lc._lane_baseline(run, lane)
            bytes_dec += ae.decoder_sync_bytes(comp.params)
            synced.append(lane)
        return bytes_dec, synced, switches

    # ------------------------------------------------------------------
    def note_refit(self, lane) -> None:
        """Lifecycle hook: a refresh refit landed on ``lane``'s active
        rung, so its probe is honest from here on (DESIGN.md §15.2)."""
        if isinstance(lane, tuple):
            ci, name = lane
            if getattr(self, "_partitioned", False) and name in self._pfitted:
                self._pfitted[name][ci, int(self._prung[name][ci])] = True
            return
        if not getattr(self, "_partitioned", False):
            self._fitted[lane, int(self._rung[lane])] = True

    def distortion_of(self, ci: int) -> Optional[float]:
        """Latest probed current-rung distortion of client ``ci``
        (group-size-weighted across lanes for partitioned ladders), or
        None before its first probe: the async scheduler's ``d_i``."""
        return self._last_err.get(int(ci))

    # ------------------------------------------------------------------
    def _probe(self, specs, cols, flats: torch.Tensor, group, lanes
               ) -> np.ndarray:
        """One batched probe of ``lanes`` (of partition ``group``, or None
        for a flat ladder): the ``(rung, lane)`` matrix on the host."""
        self.probe_dispatches += 1
        return _batched_rel_errs(specs, cols, flats).cpu().numpy()

    def _probe_all(self, run, lanes: List[int]) -> np.ndarray:
        """Every rung's distortion for every probed client from one batched
        probe: the newest snapshots stacked lane-major, each rung's codec
        params alongside. Returns the ``(n_rungs, len(lanes))`` matrix and
        caches the current-rung row for :meth:`distortion_of`."""
        flats = torch.stack([run.clients[ci].snapshots[-1] for ci in lanes])
        specs = tuple(self._comps[lanes[0]][k].spec(self._n)
                      for k in range(self.n_rungs))
        cols = [[self._comps[ci][k].codec_params() for ci in lanes]
                for k in range(self.n_rungs)]
        errs = self._probe(specs, cols, flats, None, lanes)
        for j, ci in enumerate(lanes):
            self._last_err[ci] = float(errs[int(self._rung[ci]), j])
        return errs

    def _probe_all_lanes(self, run, lanes: List[Tuple[int, str]]
                         ) -> Dict[Tuple[int, str], np.ndarray]:
        """Per-partition twin of :meth:`_probe_all`: lanes group by
        partition name (segment sizes differ), one batched probe a group.
        Returns each lane's per-rung column and caches a group-size-
        weighted current-rung distortion per client."""
        out: Dict[Tuple[int, str], np.ndarray] = {}
        acc: Dict[int, List[Tuple[float, float]]] = {}
        by_name: Dict[str, List[int]] = {}
        for ci, name in lanes:
            by_name.setdefault(name, []).append(ci)
        for name, cis in sorted(by_name.items()):
            gsize = self.partition.group_size(name)
            flats = torch.stack([run.clients[ci].part_snapshots[name][-1]
                                 for ci in cis])
            specs = tuple(self._pcomps[cis[0]][name][k].spec(gsize)
                          for k in range(self._pnrungs[name]))
            cols = [[self._pcomps[ci][name][k].codec_params() for ci in cis]
                    for k in range(self._pnrungs[name])]
            errs = self._probe(specs, cols, flats, name, cis)
            for j, ci in enumerate(cis):
                out[(ci, name)] = errs[:, j]
                acc.setdefault(ci, []).append(
                    (float(errs[int(self._prung[name][ci]), j]),
                     float(gsize)))
        for ci, pairs in acc.items():
            tot = sum(w for _, w in pairs)
            self._last_err[ci] = sum(e * w for e, w in pairs) / max(tot,
                                                                    1.0)
        return out

    # ------------------------------------------------------------------
    def _rung_err(self, run, ci: int, rung: int, flat: torch.Tensor
                  ) -> float:
        """One lane's error through one rung, alone: the differential
        oracle for :meth:`_probe_all` (the policies plan off the batched
        matrix)."""
        comp = self._comps[ci][rung]
        spec = comp.spec(flat.shape[0])
        return float(_rel_recon_err(spec, comp.codec_params(), flat))

    def _lane_rung_err(self, ci: int, name: str, rung: int,
                       seg: torch.Tensor) -> float:
        """Per-partition variant of :meth:`_rung_err`."""
        comp = self._pcomps[ci][name][rung]
        spec = comp.spec(seg.shape[0])
        return float(_rel_recon_err(spec, comp.codec_params(), seg))

    def _eligible(self, run, r: int, participants: List[int], cooldown: int
                  ) -> List[int]:
        return [ci for ci in participants
                if len(run.clients[ci].snapshots) >= self.min_snapshots
                and r - self._last_switch[ci] >= cooldown]

    def _eligible_lanes(self, run, r: int, participants: List[int],
                        cooldown: int) -> List[Tuple[int, str]]:
        """Movable lanes: more than one rung, enough of the group's own
        snapshots, off cooldown."""
        return [
            (ci, name)
            for ci in participants for name in self.partition.names
            if self._pnrungs[name] > 1
            and len(run.clients[ci].part_snapshots.get(name, []))
            >= self.min_snapshots
            and r - int(self._plast[name][ci]) >= cooldown]

    # ------------------------------------------------------------------
    # checkpointing, in the reference's layout: the JSON meta holds rung
    # occupancy, switch rounds, fitted flags and cached distortions; the
    # tree every rung's codec params (a refit on a rung the client has
    # since left must survive too)
    # ------------------------------------------------------------------
    def state_meta(self) -> Dict[str, Any]:
        dist = {str(ci): float(e)
                for ci, e in sorted(self._last_err.items())}
        if self._partitioned:
            n = len(self._pcomps)
            return {"name": self.name, "partitioned": True,
                    "rung": [{name: int(arr[ci])
                              for name, arr in self._prung.items()}
                             for ci in range(n)],
                    "last_switch": [{name: int(arr[ci])
                                     for name, arr in self._plast.items()}
                                    for ci in range(n)],
                    "fitted": [{name: [bool(x) for x in arr[ci]]
                                for name, arr in self._pfitted.items()}
                               for ci in range(n)],
                    "distortion": dist}
        return {"name": self.name,
                "rung": [int(x) for x in self._rung],
                "last_switch": [int(x) for x in self._last_switch],
                "fitted": [[bool(x) for x in row] for row in self._fitted],
                "distortion": dist}

    def state_tree(self) -> Tree:
        if self._partitioned:
            return {"codecs": [
                {name: [({"params": c.codec_params()}
                         if c.codec_params() is not None else {})
                        for c in rungs]
                 for name, rungs in row.items()}
                for row in self._pcomps]}
        return {"codecs": [
            [({"params": c.codec_params()}
              if c.codec_params() is not None else {}) for c in row]
            for row in self._comps]}

    def load_state(self, meta: Dict[str, Any], tree: Tree) -> None:
        if self._partitioned:
            assert meta.get("partitioned"), (
                "checkpoint holds a flat controller state but this run's "
                "controller is per-partition — rebuild the run to match")
            assert len(meta["rung"]) == len(self._pcomps)
            self._prung = {
                name: np.asarray([int(d[name]) for d in meta["rung"]],
                                 dtype=np.int64)
                for name in self.partition.names}
            self._plast = {
                name: np.asarray([int(d[name])
                                  for d in meta["last_switch"]],
                                 dtype=np.int64)
                for name in self.partition.names}
            if "fitted" in meta:     # absent in pre-§15 checkpoints
                self._pfitted = {
                    name: np.asarray([[bool(x) for x in d[name]]
                                      for d in meta["fitted"]], dtype=bool)
                    for name in self.partition.names}
            self._last_err = {int(k): float(v)
                              for k, v in meta.get("distortion",
                                                   {}).items()}
            for ci, row in enumerate(tree["codecs"]):
                for name, rungs in row.items():
                    for k, entry in enumerate(rungs):
                        if entry.get("params") is not None:
                            self._pcomps[ci][name][k].set_codec_params(
                                entry["params"])
                pc = partitioned(self.run.compressors[ci])
                for name in self.partition.names:
                    pc.compressors[name] = \
                        self._pcomps[ci][name][self._prung[name][ci]]
            return
        assert not meta.get("partitioned"), (
            "checkpoint holds a per-partition controller state but this "
            "run's controller is flat — rebuild the run to match")
        assert len(meta["rung"]) == len(self._comps)
        self._rung = np.asarray([int(x) for x in meta["rung"]],
                                dtype=np.int64)
        self._last_switch = np.asarray(
            [int(x) for x in meta["last_switch"]], dtype=np.int64)
        if "fitted" in meta:         # absent in pre-§15 checkpoints
            self._fitted = np.asarray([[bool(x) for x in row]
                                       for row in meta["fitted"]],
                                      dtype=bool)
        self._last_err = {int(k): float(v)
                          for k, v in meta.get("distortion", {}).items()}
        for ci, row in enumerate(tree["codecs"]):
            for k, entry in enumerate(row):
                if entry.get("params") is not None:
                    self._comps[ci][k].set_codec_params(entry["params"])
            self.run.compressors[ci] = self._comps[ci][self._rung[ci]]


@dataclasses.dataclass
class FixedRate(RateController):
    """Pin every client to ``initial_rung``: params, metrics and
    ``bytes_up`` equal a controller-less run's; with AE rungs and no
    lifecycle it adds only the initial decoder charges. Buffers no
    snapshots."""

    def observe(self, run, state, comp, flat: torch.Tensor) -> None:
        return


@dataclasses.dataclass
class DistortionTarget(RateController):
    """Walk the ladder toward the cheapest rung under ``target``: one rung
    up when the current rung's probed error exceeds the target, one rung
    down when the cheaper neighbour is fitted and measures under
    ``margin * target``. ``cooldown`` is the least number of rounds between
    a lane's switches."""

    target: float = 0.1
    margin: float = 0.7
    cooldown: int = 1
    name: str = "distortion_target"

    def plan(self, run, r: int, participants: List[int]) -> Dict:
        if self._partitioned:
            moves: Dict[Tuple[int, str], int] = {}
            lanes = self._eligible_lanes(run, r, participants,
                                         self.cooldown)
            if not lanes:
                return moves
            errs = self._probe_all_lanes(run, lanes)
            for ci, name in lanes:
                cur = int(self._prung[name][ci])
                col = errs[(ci, name)]
                if col[cur] > self.target and cur + 1 < self._pnrungs[name]:
                    moves[(ci, name)] = cur + 1
                elif (cur > 0 and self._pfitted[name][ci, cur - 1]
                        and col[cur - 1] <= self.margin * self.target):
                    moves[(ci, name)] = cur - 1
            return moves
        moves: Dict[int, int] = {}
        parts = self._eligible(run, r, participants, self.cooldown)
        if not parts:
            return moves
        errs = self._probe_all(run, parts)
        for j, ci in enumerate(parts):
            cur = int(self._rung[ci])
            if errs[cur, j] > self.target and cur + 1 < self.n_rungs:
                moves[ci] = cur + 1
            elif (cur > 0 and self._fitted[ci, cur - 1]
                    and errs[cur - 1, j] <= self.margin * self.target):
                moves[ci] = cur - 1
        return moves


@dataclasses.dataclass
class ByteBudget(RateController):
    """Greedy allocation of an uplink ``budget`` (bytes a round) across the
    observed cohort: movable lanes start at the cheapest rung, frozen ones
    are priced at their current rung, and upgrade passes bump lanes one
    rung at a time in descending current-rung drift (0 for an unfit
    current rung) while the budget holds. After any switch a lane waits
    ``switch_hysteresis`` rounds before it may move up onto an AE rung;
    downgrades are never blocked (DESIGN.md §15.4)."""

    budget: float = float("inf")
    cooldown: int = 0
    switch_hysteresis: int = 2
    name: str = "byte_budget"

    def plan(self, run, r: int, participants: List[int]) -> Dict:
        if self._partitioned:
            return self._plan_lanes(run, r, participants)
        parts = self._eligible(run, r, participants, self.cooldown)
        if not parts:
            return {}
        fixed_spend = sum(self._costs[self._rung[ci]]
                          for ci in set(participants) - set(parts))
        errs = self._probe_all(run, parts)
        score = {ci: (float(errs[int(self._rung[ci]), j])
                      if self._fitted[ci, int(self._rung[ci])] else 0.0)
                 for j, ci in enumerate(parts)}
        order = sorted(parts, key=lambda ci: (-score[ci], ci))
        alloc = {ci: 0 for ci in parts}
        spent = fixed_spend + self._costs[0] * len(parts)
        if spent > self.budget:      # budget below the all-cheapest floor
            return {ci: 0 for ci in parts if self._rung[ci] != 0}
        changed = True
        while changed:
            changed = False
            for ci in order:
                nxt = alloc[ci] + 1
                if nxt >= self.n_rungs:
                    continue
                if (nxt > int(self._rung[ci])
                        and self._comps[ci][nxt].ae_compressor() is not None
                        and r - int(self._last_switch[ci])
                        < self.switch_hysteresis):
                    continue         # decoder re-ship hysteresis (§15.4)
                delta = self._costs[nxt] - self._costs[alloc[ci]]
                if spent + delta <= self.budget:
                    alloc[ci] = nxt
                    spent += delta
                    changed = True
        return {ci: k for ci, k in alloc.items() if k != self._rung[ci]}

    def _plan_lanes(self, run, r: int, participants: List[int]) -> Dict:
        """Per-partition greedy under the one shared budget: every
        ``(client, group)`` lane competes for the same marginal bytes."""
        participants = sorted(set(participants))
        lanes = self._eligible_lanes(run, r, participants, self.cooldown)
        if not lanes:
            return {}
        all_lanes = [(ci, name) for ci in participants
                     for name in self.partition.names]
        lane_set = set(lanes)
        frozen = [ln for ln in all_lanes if ln not in lane_set]
        fixed_spend = sum(self._pcosts[name][self._prung[name][ci]]
                          for ci, name in frozen)
        errs = self._probe_all_lanes(run, lanes)
        score = {
            (ci, name): (float(errs[(ci, name)][int(self._prung[name][ci])])
                         if self._pfitted[name][ci,
                                               int(self._prung[name][ci])]
                         else 0.0)
            for ci, name in lanes}
        order = sorted(lanes, key=lambda ln: (-score[ln], ln))
        alloc = {ln: 0 for ln in lanes}
        spent = fixed_spend + sum(self._pcosts[name][0]
                                  for _, name in lanes)
        if spent > self.budget:      # budget below the all-cheapest floor
            return {(ci, name): 0 for ci, name in lanes
                    if self._prung[name][ci] != 0}
        changed = True
        while changed:
            changed = False
            for ln in order:
                ci, name = ln
                nxt = alloc[ln] + 1
                if nxt >= self._pnrungs[name]:
                    continue
                if (nxt > int(self._prung[name][ci])
                        and self._pcomps[ci][name][nxt].ae_compressor()
                        is not None
                        and r - int(self._plast[name][ci])
                        < self.switch_hysteresis):
                    continue         # decoder re-ship hysteresis (§15.4)
                delta = self._pcosts[name][nxt] - \
                    self._pcosts[name][alloc[ln]]
                if spent + delta <= self.budget:
                    alloc[ln] = nxt
                    spent += delta
                    changed = True
        return {(ci, name): k for (ci, name), k in alloc.items()
                if k != self._prung[name][ci]}


@dataclasses.dataclass
class RDBudget(RateController):
    """Lagrangian rate-distortion water-filling of the uplink budget
    (DESIGN.md §15.3): each movable lane's probed curve over its fitted
    rungs, a switch onto an AE rung priced with its decoder ship spread
    over ``ship_amortize_rounds``, pruned to its lower convex hull
    (:func:`_hull_prune`); the λ sweep (:func:`_rd_waterfill`) and the
    integer top-up (:func:`_rd_topup`) then spend the budget. A lane whose
    current rung is unfit is held at its current price; below the
    all-cheapest floor every movable lane drops to rung 0, as
    :class:`ByteBudget` does. ``last_lambda`` is λ* of the last plan and
    ``lambda_trace`` its per-round history (diagnostic only)."""

    budget: float = float("inf")
    cooldown: int = 0
    ship_amortize_rounds: float = 8.0
    name: str = "rd_budget"
    lambda_trace: List[Tuple[int, Optional[float]]] = dataclasses.field(
        default_factory=list, repr=False)

    # λ* of the last plan (None when no step was taken / no plan yet)
    last_lambda = None

    def _lane_points(self, ci: int, cur: int, col: np.ndarray
                     ) -> Optional[List[Tuple[int, float, float, float]]]:
        """One client's ``(rung, cost, price, dist)`` points from its
        probed column; None when its current rung is unfit."""
        if not self._fitted[ci, cur]:
            return None
        pts = []
        for k in range(self.n_rungs):
            if not self._fitted[ci, k]:
                continue
            price = cost = float(self._costs[k])
            sub = self._comps[ci][k].ae_compressor()
            if k != cur and sub is not None:
                price += (ae.decoder_sync_bytes(sub.codec_params())
                          / max(self.ship_amortize_rounds, 1e-9))
            pts.append((k, cost, price, float(col[k])))
        return pts

    def _lane_points_group(self, ci: int, name: str, cur: int,
                           col: np.ndarray
                           ) -> Optional[List[Tuple[int, float, float,
                                                    float]]]:
        """Per-partition twin of :meth:`_lane_points`."""
        if not self._pfitted[name][ci, cur]:
            return None
        pts = []
        for k in range(self._pnrungs[name]):
            if not self._pfitted[name][ci, k]:
                continue
            price = cost = float(self._pcosts[name][k])
            sub = self._pcomps[ci][name][k].ae_compressor()
            if k != cur and sub is not None:
                price += (ae.decoder_sync_bytes(sub.codec_params())
                          / max(self.ship_amortize_rounds, 1e-9))
            pts.append((k, cost, price, float(col[k])))
        return pts

    def plan(self, run, r: int, participants: List[int]) -> Dict:
        moves = (self._plan_lanes(run, r, participants)
                 if self._partitioned
                 else self._plan_flat(run, r, participants))
        self.lambda_trace.append((r, self.last_lambda))
        return moves

    def _plan_flat(self, run, r: int, participants: List[int]) -> Dict:
        parts = self._eligible(run, r, participants, self.cooldown)
        if not parts:
            self.last_lambda = None
            return {}
        fixed_spend = sum(self._costs[self._rung[ci]]
                          for ci in set(participants) - set(parts))
        errs = self._probe_all(run, parts)
        curves: Dict[int, Tuple[List, float]] = {}
        raw: Dict[int, List] = {}
        for j, ci in enumerate(parts):
            cur = int(self._rung[ci])
            pts = self._lane_points(ci, cur, errs[:, j])
            if pts is None:          # unfit current rung: hold the lane
                fixed_spend += self._costs[cur]
                continue
            curves[ci] = (_hull_prune(pts), float(errs[cur, j]))
            raw[ci] = pts
        alloc, lam = (_rd_waterfill(curves, self.budget, fixed_spend)
                      if curves else ({}, None))
        if alloc is None:            # below the all-cheapest floor:
            self.last_lambda = None  # mirror ByteBudget exactly
            return {ci: 0 for ci in parts if self._rung[ci] != 0}
        chosen = {ci: curves[ci][0][idx] for ci, idx in alloc.items()}
        spent = fixed_spend + sum(p[1] for p in chosen.values())
        tlam = _rd_topup(raw, chosen, self.budget, spent)
        self.last_lambda = tlam if tlam is not None else lam
        return {ci: p[0] for ci, p in chosen.items()
                if p[0] != int(self._rung[ci])}

    def _plan_lanes(self, run, r: int, participants: List[int]) -> Dict:
        """Per-partition water-fill under the one shared budget: every
        lane's hull competes in the same λ sweep."""
        participants = sorted(set(participants))
        lanes = self._eligible_lanes(run, r, participants, self.cooldown)
        if not lanes:
            self.last_lambda = None
            return {}
        lane_set = set(lanes)
        fixed_spend = sum(
            self._pcosts[name][self._prung[name][ci]]
            for ci in participants for name in self.partition.names
            if (ci, name) not in lane_set)
        errs = self._probe_all_lanes(run, lanes)
        curves: Dict[Tuple[int, str], Tuple[List, float]] = {}
        raw: Dict[Tuple[int, str], List] = {}
        for ln in lanes:
            ci, name = ln
            cur = int(self._prung[name][ci])
            pts = self._lane_points_group(ci, name, cur, errs[ln])
            if pts is None:          # unfit current rung: hold the lane
                fixed_spend += self._pcosts[name][cur]
                continue
            curves[ln] = (_hull_prune(pts), float(errs[ln][cur]))
            raw[ln] = pts
        alloc, lam = (_rd_waterfill(curves, self.budget, fixed_spend)
                      if curves else ({}, None))
        if alloc is None:            # below the all-cheapest floor:
            self.last_lambda = None  # mirror ByteBudget exactly
            return {(ci, name): 0 for ci, name in lanes
                    if self._prung[name][ci] != 0}
        chosen = {ln: curves[ln][0][idx] for ln, idx in alloc.items()}
        spent = fixed_spend + sum(p[1] for p in chosen.values())
        tlam = _rd_topup(raw, chosen, self.budget, spent)
        self.last_lambda = tlam if tlam is not None else lam
        return {ln: p[0] for ln, p in chosen.items()
                if p[0] != int(self._prung[ln[1]][ln[0]])}
