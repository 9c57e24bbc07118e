"""Round schedulers (port of ``repro.core.scheduler``: ``SyncFedAvg`` and the
server path every scheduler shares; ``SampledSync``, ``AsyncBuffered`` and
the lifecycle/rate-control hooks are not ported yet). DESIGN.md §6.

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
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.core import codec
from repro_torch.core.aggregate import apply_update, normalize_weights
from repro_torch.core.compressor import (codec_stats, ef_compensate,
                                         ef_residual, tree_bytes)
from repro_torch.core.pytree import ravel, stack, tree_map

Tree = Any


@dataclasses.dataclass
class ClientState:
    """Server-side bookkeeping for one collaborator: ``residual`` is its
    error-feedback state (DESIGN.md §6.3)."""

    residual: Optional[Tree] = None


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
    local, metrics = run.task.local_update(
        global_params, run.datasets[ci], run.cfg, seed=round_seed,
        anchor=global_params)
    return _encode_local(run, ci, local, global_params, run.clients[ci],
                         metrics)


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
    spec = comp.spec(flat.numel())
    params = comp.codec_params()
    payload = codec.encode(spec, params, flat)
    stats = codec_stats(flat, payload)
    if cfg.error_feedback:
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
    spec0 = encoded[0].spec
    if codec.is_partitioned(spec0):
        from repro_torch.core import partition
        mean_flat = partition.server_decode_aggregate(
            encoded, norm_list, base, use_grouped_kernel=grouped)
    elif all(e.spec == spec0 for e in encoded):
        norm_w = torch.tensor(norm_list, dtype=torch.float32, device=dev)
        mean_flat = _fused_group(spec0, encoded, norm_w, base)
    elif grouped:
        from repro_torch.core import partition
        mean_flat = partition.grouped_flat_server_aggregate(
            encoded, norm_list, base)
    else:
        groups: Dict[codec.CodecSpec, List[int]] = {}
        for i, e in enumerate(encoded):
            groups.setdefault(e.spec, []).append(i)
        mean_flat = None
        for spec, idx in groups.items():
            s_g = sum(norm_list[i] for i in idx)    # host float: bit-stable
            w_g = torch.tensor([norm_list[i] / s_g for i in idx],
                               dtype=torch.float32, device=dev)
            part = _fused_group(spec, [encoded[i] for i in idx], w_g, base)
            contrib = torch.tensor(s_g, dtype=torch.float32,
                                   device=dev) * part
            mean_flat = contrib if mean_flat is None else mean_flat + contrib
    return apply_update(run.global_params, unravel(mean_flat), cfg.server_lr)


def _finish_record(run, r: int, metrics, bytes_up, bytes_raw, ratios,
                   **extra):
    """Evaluate the (already-updated) global model and build a RoundRecord.
    The mean compression ratio is a float32 mean, as the reference takes
    it."""
    from repro_torch.core.federated import RoundRecord
    gmetrics = {}
    if run.eval_data is not None:
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


class SyncFedAvg(RoundScheduler):
    """Every collaborator trains every round; FedAvg over all updates through
    the one-call server path. Downlink is the global model broadcast to
    every participant."""

    def run_round(self, r: int):
        run, cfg = self.run, self.run.cfg
        model_bytes = float(tree_bytes(run.global_params))
        encoded = [
            _client_round(run, ci, run.global_params, cfg.seed * 997 + r)
            for ci in range(len(run.datasets))]
        run.global_params = _server_aggregate(
            run, encoded, [e.weight for e in encoded])
        n = len(run.datasets)
        return _finish_record(
            run, r, [e.metrics for e in encoded],
            sum(e.stats["compressed_bytes"] for e in encoded),
            sum(e.stats["original_bytes"] for e in encoded),
            [e.stats["compression_ratio"] for e in encoded],
            bytes_down=model_bytes * n, bytes_down_raw=model_bytes * n,
            participants=list(range(n)))
