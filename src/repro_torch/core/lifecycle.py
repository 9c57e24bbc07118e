"""AE training lifecycle: per-round snapshot buffers, refresh scheduling and
decoder-sync accounting (port of ``repro.core.lifecycle``, DESIGN.md §8).

Each collaborator trains its autoencoder on its own stream of weight-update
snapshots and re-ships the decoder whenever the codec is refit; that
decoder traffic is the ``Cost`` term of the savings ratio (Eq. 5/6).
:class:`AELifecycle` runs the loop for every scheduler:

* **snapshot buffers**: each AE-backed client keeps a bounded ring of the
  flat vectors it encoded (post error feedback, the codec's true input) in
  ``ClientState.snapshots``; partitioned clients keep one ring a group;
* **refresh triggers**: a round cadence (``refresh_every``) and a drift
  trigger (``drift_ratio``: refit once the relative reconstruction error
  of the newest snapshot exceeds that multiple of the post-refresh
  baseline);
* **warm-start refits**: lanes refitting in the same round with the same
  AE config and dataset shape share one ``train_autoencoder_cohort``
  dispatch; each lane draws from a CPU generator seeded with the
  reference's integer ``(seed·1,000,003 + r·1009 + ci [+ (gi+1)·7919]) mod
  2^31``, so a run on the card and one on the CPU shuffle alike and a
  resumed run refits as the uninterrupted one does;
* **decoder-sync accounting**: every shipped decoder (the pre-pass decoder
  on first participation, then one a refresh) is charged to the round's
  ``bytes_down`` and itemized in ``bytes_decoder`` / ``ae_syncs``, which
  ``savings.reconcile`` checks against Eq. 4–6;
* a refresh refit tells the run's rate controller (``note_refit``) that
  the lane's active rung is fitted.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import autoencoder as ae
from repro_torch.core import codec
from repro_torch.core.pytree import stack, tree_map

Tree = Any


@torch.no_grad()
def _rel_recon_err(spec: codec.CodecSpec, params: Optional[Tree],
                   flat: torch.Tensor) -> torch.Tensor:
    """Scale-free codec fidelity probe: MSE of an encode→decode roundtrip
    over the variance of the input, so weight growth across rounds does not
    read as drift."""
    decoded = codec.decode(spec, params, codec.encode(spec, params, flat))
    num = torch.mean(torch.square(flat - decoded))
    den = torch.mean(torch.square(flat - torch.mean(flat))) + 1e-12
    return num / den


def buffer_snapshot(state, flat: torch.Tensor, buffer_size: int) -> None:
    """Append one post-EF flat payload vector to a client's bounded
    snapshot ring (``ClientState.snapshots``)."""
    state.snapshots.append(flat)
    del state.snapshots[:-buffer_size]


@dataclasses.dataclass
class AELifecycle:
    """Policy object consumed by the three schedulers (DESIGN.md §8.2).

    Stateless apart from its config: the per-client lifecycle state
    (snapshot ring, last refresh round, drift baseline) lives in
    ``ClientState``, so it checkpoints and survives partial participation.
    With neither ``refresh_every`` nor ``drift_ratio`` set, the lifecycle
    still ships (and accounts) the initial pre-pass decoders."""

    refresh_every: Optional[int] = None   # cadence: refit every k-th round
    drift_ratio: Optional[float] = None   # refit at err > ratio * baseline
    buffer_size: int = 16                 # snapshots kept per client
    min_snapshots: int = 4                # don't refit on fewer samples
    refresh_epochs: int = 40
    batch_size: int = 8
    lr: float = 3e-3
    val_fraction: float = 0.2
    refit_normalizer: bool = False        # warm starts keep norm by default
    ship_initial: bool = True             # charge the pre-pass decoder ship
    seed: int = 0

    # ------------------------------------------------------------------
    def observe(self, state, compressor, flat: torch.Tensor) -> None:
        """Record the flat vector a client just encoded. Pointwise codecs
        have nothing to refit; a partitioned client buffers each AE-backed
        group's segment in its own ``ClientState.part_snapshots`` ring."""
        from repro_torch.core.compressor import partitioned
        pc = partitioned(compressor)
        if pc is not None:
            from repro_torch.core import partition
            for name in pc.ae_groups():
                seg = partition.gather(pc.pmap.slices_of(name), flat)
                ring = state.part_snapshots.setdefault(name, [])
                ring.append(seg)
                del ring[:-self.buffer_size]
            return
        if compressor.ae_compressor() is None:
            return
        buffer_snapshot(state, flat, self.buffer_size)

    # ------------------------------------------------------------------
    # Lanes: a client index (flat codecs) or a ``(client, group)`` pair
    # (per-layer partitions) — one lane per decoder the server holds.
    # ------------------------------------------------------------------
    def _lane_comp(self, run, lane):
        """The refittable AE sub-compressor behind ``lane``."""
        from repro_torch.core.compressor import partitioned
        if isinstance(lane, tuple):
            ci, name = lane
            return partitioned(run.compressors[ci]).ae_groups()[name]
        return run.compressors[lane].ae_compressor()

    def _lane_adapter(self, run, lane):
        """The whole wire adapter behind ``lane`` (chains included)."""
        from repro_torch.core.compressor import partitioned
        if isinstance(lane, tuple):
            ci, name = lane
            return partitioned(run.compressors[ci]).compressors[name]
        return run.compressors[lane]

    def _lane_probe(self, run, lane):
        """The adapter whose roundtrip measures the lane's fidelity: the
        whole chain for chain lanes (drift is end to end), the AE
        sub-compressor otherwise."""
        from repro_torch.core.compressor import ChainCompressor
        adapter = self._lane_adapter(run, lane)
        if isinstance(adapter, ChainCompressor):
            return adapter
        return self._lane_comp(run, lane)

    def _lane_snaps(self, run, lane) -> List[torch.Tensor]:
        if isinstance(lane, tuple):
            ci, name = lane
            return run.clients[ci].part_snapshots.get(name, [])
        return run.clients[lane].snapshots

    def _lane_baseline(self, run, lane) -> Optional[float]:
        snaps = self._lane_snaps(run, lane)
        if not snaps:
            return None
        return self._rel_err(self._lane_probe(run, lane), snaps[-1])

    # ------------------------------------------------------------------
    def end_of_round(self, run, r: int, participants: Sequence[int]
                     ) -> Tuple[float, List]:
        """Advance the lifecycle after round ``r``'s aggregation: decide
        refreshes for this round's participants, refit (cohort-batched
        where shapes allow) and return ``(decoder_bytes, synced_lanes)``
        for the round's record. Runs after the server aggregate: this
        round's payloads were decoded with the decoder that encoded them,
        and a refreshed decoder takes effect next round."""
        from repro_torch.core.compressor import partitioned
        bytes_dec = 0.0
        synced: List = []
        todo: List = []
        for ci in sorted(set(participants)):
            st = run.clients[ci]
            pc = partitioned(run.compressors[ci])
            if pc is not None:
                for name, sub in sorted(pc.ae_groups().items()):
                    lane = (ci, name)
                    if st.part_last_refresh.get(name, -1) < 0:
                        # the group's first participation: its pre-pass
                        # decoder ships (one Eq.-5 sync a group)
                        st.part_last_refresh[name] = r
                        if self.ship_initial:
                            bytes_dec += ae.decoder_sync_bytes(
                                sub.codec_params())
                            synced.append(lane)
                        st.part_baseline[name] = \
                            self._lane_baseline(run, lane)
                        continue
                    if self._should_refresh(
                            r, self._lane_probe(run, lane),
                            self._lane_snaps(run, lane),
                            st.part_last_refresh[name],
                            st.part_baseline.get(name)):
                        todo.append(lane)
                continue
            comp = run.compressors[ci].ae_compressor()
            if comp is None:
                continue
            if st.last_refresh < 0:
                # first participation: the pre-pass decoder the server has
                # been decoding with ships now (one Eq.-5 sync)
                st.last_refresh = r
                if self.ship_initial:
                    bytes_dec += ae.decoder_sync_bytes(comp.codec_params())
                    synced.append(ci)
                st.ae_baseline = self._lane_baseline(run, ci)
                continue
            if self._should_refresh(r, self._lane_probe(run, ci),
                                    st.snapshots, st.last_refresh,
                                    st.ae_baseline):
                todo.append(ci)
        rc = getattr(run, "ratecontrol", None)
        for lane, new_params in self._refit(run, r, todo):
            self._lane_comp(run, lane).params = new_params
            if rc is not None:
                # the active rung's probe is honest from here on: the rate
                # policies gate unfit rungs on it (DESIGN.md §15.2)
                rc.note_refit(lane)
            if isinstance(lane, tuple):
                ci, name = lane
                st = run.clients[ci]
                st.part_last_refresh[name] = r
                st.part_baseline[name] = self._lane_baseline(run, lane)
            else:
                st = run.clients[lane]
                st.last_refresh = r
                st.ae_baseline = self._lane_baseline(run, lane)
            bytes_dec += ae.decoder_sync_bytes(new_params)
            synced.append(lane)
        return bytes_dec, synced

    # ------------------------------------------------------------------
    def _should_refresh(self, r: int, comp, snaps: List[torch.Tensor],
                        last_refresh: int, baseline: Optional[float]
                        ) -> bool:
        if len(snaps) < self.min_snapshots:
            return False
        if (self.refresh_every is not None
                and r - last_refresh >= self.refresh_every):
            return True
        if self.drift_ratio is not None and baseline is not None:
            err = self._rel_err(comp, snaps[-1])
            return err > self.drift_ratio * baseline
        return False

    def _rel_err(self, comp, flat: torch.Tensor) -> float:
        spec = comp.spec(flat.numel())
        return float(_rel_recon_err(spec, comp.codec_params(), flat))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _refit_dataset(self, run, lane) -> Tuple[Any, torch.Tensor]:
        """(fc-config, training rows) for one lane's refit. The FC AE
        trains on padded snapshot rows; the chunked AE trains its shared
        funnel on every chunk of every snapshot. Chain lanes first fold
        each snapshot through the chain's prefix stages
        (``codec.ae_stage_input``), so a sparsify→AE chain refits on the
        top-k values it encodes."""
        adapter = self._lane_adapter(run, lane)
        snaps = self._lane_snaps(run, lane)
        wire_spec = adapter.spec(snaps[0].shape[0])
        params = adapter.codec_params()
        spec = codec.ae_spec(wire_spec)
        vecs = [codec.ae_stage_input(wire_spec, params, s) for s in snaps]
        stackd = torch.stack(vecs)
        if isinstance(spec, codec.FCAESpec):
            pad = spec.cfg.input_dim - stackd.shape[1]
            if pad:
                stackd = torch.nn.functional.pad(stackd, (0, pad))
            return spec.cfg, stackd
        assert isinstance(spec, codec.ChunkedAESpec)
        rows = torch.cat([ae.chunk_vector(v, spec.cfg.chunk_size)[0]
                          for v in vecs])
        return spec.cfg.as_fc(), rows

    def _rng(self, r: int, ci: int) -> torch.Generator:
        return torch.Generator().manual_seed(
            (self.seed * 1_000_003 + r * 1009 + ci) % 2 ** 31)

    def _lane_rng(self, run, r: int, lane) -> torch.Generator:
        """Per-lane refit generator. Flat lanes take ``_rng(r, ci)``;
        partition lanes fold the group's index in the client's partition
        map into the seed, so two groups refitting in one round draw
        distinct shuffles."""
        if not isinstance(lane, tuple):
            return self._rng(r, lane)
        ci, name = lane
        from repro_torch.core.compressor import partitioned
        gi = list(partitioned(run.compressors[ci]).pmap.names).index(name)
        return torch.Generator().manual_seed(
            (self.seed * 1_000_003 + r * 1009 + ci + (gi + 1) * 7919)
            % 2 ** 31)

    def _refit(self, run, r: int, todo: List) -> List[Tuple[Any, Tree]]:
        """Warm-start refits for the ``todo`` lanes: lanes with the same AE
        config and dataset shape (across clients and partition groups)
        share one ``train_autoencoder_cohort`` dispatch; a group of one
        takes ``train_autoencoder`` (that fit at C = 1)."""
        groups: Dict[Tuple[Any, Tuple[int, ...]],
                     List[Tuple[Any, torch.Tensor]]] = {}
        for lane in todo:
            fc_cfg, rows = self._refit_dataset(run, lane)
            groups.setdefault((fc_cfg, tuple(rows.shape)), []).append(
                (lane, rows))

        out: List[Tuple[Any, Tree]] = []
        kw = dict(epochs=self.refresh_epochs, batch_size=self.batch_size,
                  lr=self.lr, val_fraction=self.val_fraction,
                  refit_normalizer=self.refit_normalizer)
        for (fc_cfg, _), members in groups.items():
            if len(members) == 1:
                lane, rows = members[0]
                params, _ = ae.train_autoencoder(
                    self._lane_rng(run, r, lane), fc_cfg, rows,
                    init=self._lane_comp(run, lane).codec_params(), **kw)
                out.append((lane, params))
                continue
            init = stack([self._lane_comp(run, lane).codec_params()
                          for lane, _ in members])
            stacked, _ = ae.train_autoencoder_cohort(
                [self._lane_rng(run, r, lane) for lane, _ in members],
                fc_cfg, torch.stack([rows for _, rows in members]),
                init=init, **kw)
            for k, (lane, _) in enumerate(members):
                # a copy a lane, so the stacked cohort tree can be freed
                out.append((lane, tree_map(lambda x, k=k: x[k].clone(),
                                           stacked)))
        return out
