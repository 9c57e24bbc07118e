"""Round schedulers (port of ``repro.core.scheduler``, DESIGN.md §6):

* :class:`SyncFedAvg` — every collaborator trains every round;
* :class:`SampledSync` — a C-of-N cohort a round, trained in one vmapped
  pass when the cohort's shards have equal shapes;
* :class:`AsyncBuffered` — FedBuff-style: a simulated-latency event loop
  (a ``heapq`` or the vectorized ``ArrivalEngine``) delivers updates, the
  first K are staleness-weighted and aggregated, those clients are
  re-dispatched with the new model. :class:`LatencyModel` gives each
  (client, dispatch) its round-trip time.

After each round's aggregation every scheduler advances the AE lifecycle
and then the rate controller (:func:`_lifecycle_sync`, DESIGN.md §8–§9):
decoder ships are charged to the round's downlink, rung switches land in
the record. Each scheduler checkpoints through ``state_dict``/
``on_restore``; ``AsyncBuffered`` carries its whole event loop, in one
shape for both engines.

Clients ship *encoded payloads*. The server stacks the round's cohort
along a client axis and runs one ``codec.decode_and_aggregate`` call per
spec group (:func:`_server_aggregate`, DESIGN.md §7) — batched decode and
an einsum generically, the fused decode→aggregate kernel for the
kernel-path chunked AE. Partitioned cohorts go through
``partition.server_decode_aggregate``, and with
``FLConfig.use_grouped_kernel`` mixed cohorts take the grouped round,
whose chunked-AE buckets share one grouped ragged launch. The only
per-client decode left is the collaborator-side one that error feedback
needs, in :func:`_encode_local`.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import codec
from repro_torch.core.aggregate import (apply_update, distortion_weights,
                                        normalize_weights, staleness_weights)
from repro_torch.core.compressor import (codec_stats, ef_compensate,
                                         ef_residual, tree_bytes)
from repro_torch.core.pytree import ravel, stack, tree_map

Tree = Any


@dataclasses.dataclass
class ClientState:
    """Server-side bookkeeping for one collaborator: ``residual`` is its
    error-feedback state (DESIGN.md §6.3), ``version`` the global-model
    version it last received, ``dispatched`` the global params shipped at
    dispatch (async only: the client trains against this snapshot).

    The AE-lifecycle fields (DESIGN.md §8.2): ``snapshots`` is the bounded
    ring of flat payload vectors the client's AE refits train on,
    ``last_refresh`` the round its decoder last shipped (−1 = never; the
    pre-pass decoder is charged on first participation), ``ae_baseline``
    the post-refresh relative reconstruction error the drift trigger
    compares against. Under per-layer partitions (DESIGN.md §10) they split
    per group into ``part_snapshots``, ``part_last_refresh`` and
    ``part_baseline``. All of it is run state and checkpoints with the
    run."""

    residual: Optional[Tree] = None
    version: int = 0
    dispatched: Optional[Tree] = None
    snapshots: List[torch.Tensor] = dataclasses.field(default_factory=list)
    last_refresh: int = -1
    ae_baseline: Optional[float] = None
    part_snapshots: Dict[str, List[torch.Tensor]] = \
        dataclasses.field(default_factory=dict)
    part_last_refresh: Dict[str, int] = \
        dataclasses.field(default_factory=dict)
    part_baseline: Dict[str, Optional[float]] = \
        dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class EncodedUpdate:
    """What one collaborator ships for one round: the wire payload, the
    static spec that decodes it, the AE decoder params (None = pointwise),
    the sample weight, codec byte stats and local metrics."""

    payload: Tree
    spec: codec.CodecSpec
    params: Optional[Tree]
    weight: float
    stats: Dict[str, float]
    metrics: Dict[str, float]


def _client_round(run, ci: int, global_params: Tree, round_seed: int
                  ) -> EncodedUpdate:
    """One collaborator's round against ``global_params``: train (via the
    run's task), build the payload, error-feedback compensate, encode."""
    with trace.span("client_train"):
        local, metrics = run.task.local_update(
            global_params, run.datasets[ci], run.cfg, seed=round_seed,
            anchor=global_params)
    return _encode_local(run, ci, local, global_params, run.clients[ci],
                         metrics)


@trace.spanned("client_encode")
@torch.no_grad()
def _encode_local(run, ci: int, local: Tree, global_params: Tree,
                  state: ClientState, metrics: Dict[str, float]
                  ) -> EncodedUpdate:
    """Payload selection + error feedback + encode for a trained ``local``
    model. Error feedback decodes here because the residual is
    collaborator-side state."""
    cfg = run.cfg
    if cfg.payload == "weights":
        payload_tree = local               # paper §5.2 protocol
    else:
        payload_tree = tree_map(lambda a, b: a - b, local, global_params)
    if cfg.error_feedback:
        payload_tree = ef_compensate(payload_tree, state.residual)

    comp = run.compressors[ci]
    flat, unravel = ravel(payload_tree)
    if run.lifecycle is not None:
        # snapshot exactly what the codec is about to see (post-EF): the
        # refit distribution is the encode distribution (DESIGN.md §8.2)
        run.lifecycle.observe(state, comp, flat)
    rc = getattr(run, "ratecontrol", None)
    if rc is not None:
        # the controller's distortion decisions need the same input,
        # including lanes the lifecycle does not buffer (DESIGN.md §9.1)
        rc.observe(run, state, comp, flat)
    spec = comp.spec(flat.numel())
    params = comp.codec_params()
    with trace.span("client_encode.codec"):
        payload = codec.encode(spec, params, flat)
    stats = codec_stats(flat, payload, spec=spec)
    if cfg.error_feedback:
        with trace.span("client_encode.ef"):
            decoded = unravel(codec.decode(spec, params, payload))
            state.residual = ef_residual(payload_tree, decoded)
    weight = run.task.data_weight(run.datasets[ci])
    return EncodedUpdate(payload=payload, spec=spec, params=params,
                         weight=weight, stats=stats, metrics=metrics)


def _fused_group(spec: codec.CodecSpec, encoded: Sequence[EncodedUpdate],
                 w: torch.Tensor, base) -> torch.Tensor:
    """One decode→aggregate call for a same-spec group: payloads (and,
    when they differ, per-client AE params) stacked along the client
    axis."""
    stacked = codec.stack_payloads([e.payload for e in encoded])
    if all(e.params is encoded[0].params for e in encoded):
        params, params_batched = encoded[0].params, False
    else:
        params = stack([e.params for e in encoded])
        params_batched = True
    return codec.decode_and_aggregate(spec, params, stacked, w, base,
                                      params_batched=params_batched)


@trace.spanned("server_agg")
@torch.no_grad()
def _server_aggregate(run, encoded: Sequence[EncodedUpdate],
                      weights: Sequence[float]) -> Tree:
    """The aggregator's round step: fused decode→aggregate over the stacked
    cohort, then the server-lr update. In the reference's order:

    * a partitioned cohort (homogeneous or not) goes through
      ``partition.server_decode_aggregate``, grouped or sequential;
    * a homogeneous cohort takes one fused call;
    * a mixed cohort with the grouped flag takes
      ``partition.grouped_flat_server_aggregate``;
    * otherwise it is grouped by spec, each group's weights renormalized
      to Σ=1 and its mean scaled back by the group's weight mass
      (DESIGN.md §9.2)."""
    from repro_torch.kernels.ops import use_grouped_default
    cfg = run.cfg
    g_flat, unravel = ravel(run.global_params)
    dev = g_flat.device
    base = g_flat if cfg.payload == "weights" else None
    norm_list = normalize_weights(weights)
    grouped = use_grouped_default(cfg.use_grouped_kernel)
    with trace.span("server_agg.decode_agg"):
        mean_flat = _decode_aggregate(encoded, norm_list, base, dev,
                                      grouped)
    return apply_update(run.global_params, unravel(mean_flat), cfg.server_lr)


def _decode_aggregate(encoded: Sequence[EncodedUpdate],
                      norm_list: List[float], base, dev: torch.device,
                      grouped: bool) -> torch.Tensor:
    """The cohort's weighted mean update, flat (:func:`_server_aggregate`
    says which route each cohort takes)."""
    spec0 = encoded[0].spec
    if codec.is_partitioned(spec0):
        from repro_torch.core import partition
        return partition.server_decode_aggregate(
            encoded, norm_list, base, use_grouped_kernel=grouped)
    if all(e.spec == spec0 for e in encoded):
        norm_w = trace.to_device(norm_list, dev, torch.float32)
        return _fused_group(spec0, encoded, norm_w, base)
    if grouped:
        from repro_torch.core import partition
        return partition.grouped_flat_server_aggregate(
            encoded, norm_list, base)
    groups: Dict[codec.CodecSpec, List[int]] = {}
    for i, e in enumerate(encoded):
        groups.setdefault(e.spec, []).append(i)
    mean_flat = None
    for spec, idx in groups.items():
        s_g = sum(norm_list[i] for i in idx)    # host float: bit-stable
        w_g = trace.to_device([norm_list[i] / s_g for i in idx], dev,
                              torch.float32)
        part = _fused_group(spec, [encoded[i] for i in idx], w_g, base)
        contrib = trace.to_device(s_g, dev, torch.float32) * part
        mean_flat = contrib if mean_flat is None else mean_flat + contrib
    return mean_flat


def _lifecycle_sync(run, r: int, participants
                    ) -> Tuple[float, Optional[list], Optional[list]]:
    """Advance the AE lifecycle (DESIGN.md §8) and then the rate controller
    (DESIGN.md §9) after the round's server aggregate: the decoder that
    served this round is charged before the controller switches a client
    off it. Returns (decoder-sync bytes to charge to ``bytes_down``, synced
    lanes, rung switches), (0.0, None, None) when neither is attached."""
    dec_bytes, syncs = 0.0, None
    if run.lifecycle is not None:
        dec_bytes, syncs = run.lifecycle.end_of_round(run, r, participants)
    switches = None
    rc = getattr(run, "ratecontrol", None)
    if rc is not None:
        rc_bytes, rc_syncs, switches = rc.end_of_round(run, r, participants)
        dec_bytes += rc_bytes
        # a multiset of ships: an initial ship and a switch re-ship in one
        # round count twice (Eq. 5's NumDecoders, savings.reconcile)
        syncs = sorted((syncs or []) + rc_syncs)
    return dec_bytes, syncs, switches


def _controller_name(run) -> Optional[str]:
    rc = getattr(run, "ratecontrol", None)
    return rc.name if rc is not None else None


def _measured_up(encoded: Sequence[EncodedUpdate]) -> float:
    """Round uplink on the measured-bytes channel (DESIGN.md §13.3):
    entropy-coded stacks price below the dense wire size, every other spec
    measures its compressed bytes."""
    return sum(e.stats.get("measured_bytes", e.stats["compressed_bytes"])
               for e in encoded)


def _finish_record(run, r: int, metrics, bytes_up, bytes_raw, ratios,
                   **extra):
    """Evaluate the (already-updated) global model and build a RoundRecord.
    The mean compression ratio is a float32 mean, as the reference takes
    it."""
    from repro_torch.core.federated import RoundRecord
    gmetrics = {}
    if run.eval_data is not None:
        with trace.span("global_eval"):
            gmetrics = run.task.evaluate(run.global_params, run.eval_data)
    return RoundRecord(
        round=r, collab_metrics=metrics, global_metrics=gmetrics,
        bytes_up=bytes_up, bytes_up_raw=bytes_raw,
        compression_ratio=float(torch.tensor(ratios,
                                             dtype=torch.float32).mean()),
        **extra)


class RoundScheduler:
    """Strategy interface: one ``run_round`` call advances the federation by
    one aggregation and returns its ``RoundRecord``."""

    def bind(self, run) -> None:
        assert getattr(self, "run", None) is None, (
            "scheduler is already bound to a FederatedRun; create a fresh "
            "scheduler instance per run")
        self.run = run

    def run_round(self, r: int):
        raise NotImplementedError

    def state_dict(self) -> Optional[dict]:
        """JSON-able scheduler state for ``save_federated_state`` (None =
        stateless)."""
        return None

    def on_restore(self, state: Optional[dict] = None) -> None:
        """Called by ``FederatedRun.load_state`` after the run's clients and
        params are replaced, with what :meth:`state_dict` returned at save
        time. The sync schedulers hold nothing to restore."""


class SyncFedAvg(RoundScheduler):
    """Every collaborator trains every round; FedAvg over all updates through
    the one-call server path. Downlink is the global model broadcast to
    every participant."""

    @trace.spanned("round", frees=True)
    def run_round(self, r: int):
        run, cfg = self.run, self.run.cfg
        model_bytes = float(tree_bytes(run.global_params))
        encoded = [
            _client_round(run, ci, run.global_params, cfg.seed * 997 + r)
            for ci in range(len(run.datasets))]
        run.global_params = _server_aggregate(
            run, encoded, [e.weight for e in encoded])
        n = len(run.datasets)
        dec_bytes, syncs, switches = _lifecycle_sync(run, r, range(n))
        return _finish_record(
            run, r, [e.metrics for e in encoded],
            sum(e.stats["compressed_bytes"] for e in encoded),
            sum(e.stats["original_bytes"] for e in encoded),
            [e.stats["compression_ratio"] for e in encoded],
            bytes_up_measured=_measured_up(encoded),
            bytes_down=model_bytes * n + dec_bytes,
            bytes_down_raw=model_bytes * n + dec_bytes,
            bytes_decoder=dec_bytes, ae_syncs=syncs,
            spec_switches=switches, controller=_controller_name(run),
            participants=list(range(n)))


@dataclasses.dataclass
class SampledSync(RoundScheduler):
    """Partial participation: each round samples ``cohort`` of the N clients
    without replacement (McMahan et al., 2017), broadcasts the global model
    to exactly that cohort and FedAvgs their compressed updates. Unsampled
    clients keep their error-feedback residual.

    With ``use_vmap`` and a homogeneous cohort (equal shard shapes), local
    training for the cohort is one vmapped pass a step
    (``task.local_update_batched``, DESIGN.md §6.4); a ragged cohort falls
    back to the loop. ``vmap_rounds`` and ``loop_rounds`` count which path
    each round took."""

    cohort: int = 2
    sample_seed: int = 0
    use_vmap: bool = True
    vmap_rounds: int = dataclasses.field(default=0, init=False)
    loop_rounds: int = dataclasses.field(default=0, init=False)

    def sampled(self, r: int) -> List[int]:
        n = len(self.run.datasets)
        c = min(self.cohort, n)
        rng = np.random.RandomState((self.sample_seed * 100003 + r) % 2 ** 31)
        return sorted(rng.choice(n, size=c, replace=False).tolist())

    def _cohort_locals(self, cohort: List[int], r: int) -> Optional[list]:
        run, cfg = self.run, self.run.cfg
        if not self.use_vmap or len(cohort) < 2:
            return None
        with trace.span("client_train"):
            return run.task.local_update_batched(
                run.global_params, [run.datasets[ci] for ci in cohort], cfg,
                seed=cfg.seed * 997 + r, anchor=run.global_params)

    @trace.spanned("round", frees=True)
    def run_round(self, r: int):
        run, cfg = self.run, self.run.cfg
        cohort = self.sampled(r)
        model_bytes = float(tree_bytes(run.global_params))
        batched = self._cohort_locals(cohort, r)
        if batched is not None:
            self.vmap_rounds += 1
        else:
            self.loop_rounds += 1
        encoded = []
        for k, ci in enumerate(cohort):
            run.clients[ci].version = r
            if batched is not None:
                local, m = batched[k]
                encoded.append(_encode_local(
                    run, ci, local, run.global_params, run.clients[ci], m))
            else:
                encoded.append(_client_round(
                    run, ci, run.global_params, cfg.seed * 997 + r))
        run.global_params = _server_aggregate(
            run, encoded, [e.weight for e in encoded])
        c = len(cohort)
        dec_bytes, syncs, switches = _lifecycle_sync(run, r, cohort)
        return _finish_record(
            run, r, [e.metrics for e in encoded],
            sum(e.stats["compressed_bytes"] for e in encoded),
            sum(e.stats["original_bytes"] for e in encoded),
            [e.stats["compression_ratio"] for e in encoded],
            bytes_up_measured=_measured_up(encoded),
            bytes_down=model_bytes * c + dec_bytes,
            bytes_down_raw=model_bytes * c + dec_bytes,
            bytes_decoder=dec_bytes, ae_syncs=syncs,
            spec_switches=switches, controller=_controller_name(run),
            participants=cohort)


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Deterministic per-(client, dispatch) round-trip latency in abstract
    simulation units: ``base`` × U[1 − jitter, 1 + jitter], times
    ``straggler_mult`` for the first ``ceil(straggler_frac · N)`` clients.
    The uniform draw comes from ``np.random.SeedSequence([seed, client,
    dispatch])``; ``legacy_hash`` reproduces the older
    ``RandomState((seed·7919 + client·104729 + dispatch) mod 2^31)``
    stream, which collides across (client, dispatch) pairs at large N."""

    base: float = 1.0
    jitter: float = 0.0
    straggler_frac: float = 0.0
    straggler_mult: float = 10.0
    seed: int = 0
    legacy_hash: bool = False

    def is_straggler(self, client: int, n_clients: int) -> bool:
        return client < int(np.ceil(self.straggler_frac * n_clients))

    def sample(self, client: int, dispatch: int, n_clients: int) -> float:
        lat = self.base
        if self.jitter > 0.0:
            if self.legacy_hash:
                rng = np.random.RandomState(
                    (self.seed * 7919 + client * 104729 + dispatch) % 2 ** 31)
                u = rng.rand()
            else:
                u = np.random.default_rng(np.random.SeedSequence(
                    [self.seed, client, dispatch])).random()
            lat *= 1.0 + self.jitter * (2.0 * u - 1.0)
        if self.is_straggler(client, n_clients):
            lat *= self.straggler_mult
        return float(lat)


@dataclasses.dataclass
class AsyncBuffered(RoundScheduler):
    """FedBuff-style buffered asynchronous aggregation (Nguyen et al., 2022).

    Every client is dispatched at t=0 with the v0 global model. A simulated
    event loop (arrival time, FIFO tie-break) delivers updates; each
    ``run_round`` drains the first ``buffer_k`` arrivals, trains each
    lazily against the snapshot it was dispatched with (seed keyed to its
    dispatch version), aggregates them in one server call with weights
    ``w_i · (1 + s_i) ** -staleness_power`` (``s_i`` = global versions
    elapsed since dispatch), bumps the version and re-dispatches those
    clients at the start of the next round, so every broadcast byte lands
    in a record. With ``buffer_k == N`` and a zero-jitter, straggler-free
    latency model the trajectory equals :class:`SyncFedAvg`.

    ``engine="heap"`` is the host ``heapq`` loop; ``"vector"`` the
    struct-of-arrays :class:`~repro_torch.core.arrival.ArrivalEngine`,
    order-exact against it (same ``(time, seq)`` contract, ``float64``
    times), so the two give bit-identical runs.

    ``distortion_power`` (DESIGN.md §15.5) further discounts each drained
    update by ``(1 + e_i) ** -distortion_power``, ``e_i`` the client's
    probed current-rung error (``RateController.distortion_of``); 0 (the
    default) leaves the weights as they were, and so does a client not
    probed yet or a run without a controller."""

    buffer_k: int = 2
    latency: LatencyModel = dataclasses.field(default_factory=LatencyModel)
    staleness_power: float = 0.5
    distortion_power: float = 0.0
    engine: str = "heap"               # "heap" | "vector"

    def bind(self, run) -> None:
        if self.engine not in ("heap", "vector"):
            raise ValueError(f"unknown AsyncBuffered engine {self.engine!r}")
        super().bind(run)
        self._reset()

    def state_dict(self) -> dict:
        """The whole event loop, JSON-able: entries reference clients by
        index, and the per-client ``dispatched`` snapshots ride the
        checkpoint's client tree, so a resumed run continues the simulation
        exactly (same arrivals, staleness and downlink bytes). Both engines
        emit the same ``{"heap": [[t, seq, ci], ...]}`` shape (the vector
        engine's finite-time rows), so either restores the other's
        checkpoint."""
        return {"heap": self._entries(), "seq": self._next_seq(),
                "version": self._version,
                "clock": self._clock, "pending_down": self._pending_down,
                "to_redispatch": list(self._to_redispatch)}

    def on_restore(self, state: Optional[dict] = None) -> None:
        if state is None:
            # a checkpoint without scheduler state: restart the simulation,
            # every restored client re-dispatched against the restored
            # global model at version 0 (the broadcast charged again)
            self._reset()
            return
        self._bcast_cache = None
        if self.engine == "vector":
            from repro_torch.core.arrival import ArrivalEngine
            self._arrivals = ArrivalEngine.from_entries(
                len(self.run.datasets), state["heap"], int(state["seq"]))
        else:
            self._heap = [(float(t), int(s), int(ci))
                          for t, s, ci in state["heap"]]
            heapq.heapify(self._heap)
            self._seq = int(state["seq"])
        self._version = int(state["version"])
        self._clock = float(state["clock"])
        self._pending_down = float(state["pending_down"])
        self._to_redispatch = [int(ci) for ci in state["to_redispatch"]]

    def _reset(self) -> None:
        run = self.run
        # broadcast size per global version (it changes only when the
        # global model is replaced, i.e. when the version bumps)
        self._bcast_cache: Optional[Tuple[int, float]] = None
        if self.engine == "vector":
            from repro_torch.core.arrival import ArrivalEngine
            self._arrivals = ArrivalEngine(len(run.datasets))
        else:
            self._heap: List[Tuple[float, int, int]] = []  # (arrival,seq,ci)
            self._seq = 0                                  # FIFO tie-break
        self._version = 0
        self._clock = 0.0
        self._pending_down = 0.0    # downlink dispatched, not yet recorded
        self._to_redispatch: List[int] = []
        for ci in range(len(run.datasets)):
            self._dispatch(ci)

    def _push(self, ci: int, t: float) -> None:
        if self.engine == "vector":
            self._arrivals.push(ci, t)
        else:
            heapq.heappush(self._heap, (t, self._seq, ci))
            self._seq += 1

    def _pop_k(self, k: int) -> List[Tuple[float, int]]:
        """First-K arrivals as ``(time, ci)`` in pop order. Nothing is
        pushed mid-drain (re-dispatch is deferred), so the vector engine's
        one K-selection equals K heap pops."""
        if self.engine == "vector":
            return self._arrivals.pop_k(k)
        out = []
        for _ in range(k):
            t, _, ci = heapq.heappop(self._heap)
            out.append((t, ci))
        return out

    def _in_flight(self) -> int:
        return (self._arrivals.in_flight() if self.engine == "vector"
                else len(self._heap))

    def _next_seq(self) -> int:
        return (self._arrivals.next_seq if self.engine == "vector"
                else self._seq)

    def _entries(self) -> List[List[float]]:
        if self.engine == "vector":
            return self._arrivals.entries()
        return [[float(t), int(s), int(ci)] for t, s, ci in self._heap]

    def _broadcast_bytes(self) -> float:
        if self._bcast_cache is None or self._bcast_cache[0] != self._version:
            self._bcast_cache = (
                self._version, float(tree_bytes(self.run.global_params)))
        return self._bcast_cache[1]

    def _dispatch(self, ci: int) -> None:
        run = self.run
        state = run.clients[ci]
        state.version = self._version
        state.dispatched = run.global_params
        self._pending_down += self._broadcast_bytes()
        lat = self.latency.sample(ci, self._version, len(run.datasets))
        self._push(ci, self._clock + lat)

    @trace.spanned("round", frees=True)
    def run_round(self, r: int):
        run, cfg = self.run, self.run.cfg
        for ci in self._to_redispatch:     # deferred from the previous flush
            self._dispatch(ci)
        self._to_redispatch = []
        k = min(self.buffer_k, self._in_flight())
        if k <= 0:
            raise RuntimeError("async scheduler has no in-flight clients")
        bytes_down = self._pending_down
        self._pending_down = 0.0

        encoded, stales, arrived = [], [], []
        for t, ci in self._pop_k(k):
            self._clock = max(self._clock, t)
            state = run.clients[ci]
            encoded.append(_client_round(
                run, ci, state.dispatched, cfg.seed * 997 + state.version))
            stales.append(self._version - state.version)
            arrived.append(ci)

        weights = staleness_weights([e.weight for e in encoded], stales,
                                    self.staleness_power)
        if self.distortion_power:
            rc = getattr(run, "ratecontrol", None)
            weights = distortion_weights(
                weights,
                [rc.distortion_of(ci) if rc is not None else None
                 for ci in arrived],
                self.distortion_power)
        run.global_params = _server_aggregate(run, encoded, weights)
        self._version += 1
        for ci in arrived:
            run.clients[ci].dispatched = None
        self._to_redispatch = list(arrived)
        dec_bytes, syncs, switches = _lifecycle_sync(run, r, arrived)
        return _finish_record(
            run, r, [e.metrics for e in encoded],
            sum(e.stats["compressed_bytes"] for e in encoded),
            sum(e.stats["original_bytes"] for e in encoded),
            [e.stats["compression_ratio"] for e in encoded],
            bytes_up_measured=_measured_up(encoded),
            bytes_down=bytes_down + dec_bytes,
            bytes_down_raw=bytes_down + dec_bytes,
            bytes_decoder=dec_bytes, ae_syncs=syncs,
            spec_switches=switches, controller=_controller_name(run),
            participants=arrived, staleness=stales, sim_time=self._clock)
