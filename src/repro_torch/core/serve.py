"""Streaming FL ingest: the sustained-throughput serving loop (port of
``repro.core.serve``, DESIGN.md §12.3).

``AsyncBuffered`` answers "is buffered-async correct"; this module answers
"how fast can the server ingest": encoded payloads stream in from an
N-client population, the first-K buffer fires one fused decode→aggregate,
the global model updates and exactly those K clients are re-dispatched.

* The state is a dict of tensors on the run's device: next-arrival times,
  dispatch sequence numbers, per-client model versions, the flat global
  model, the clock, the global version and the next sequence number. The
  first-K pop is :func:`~repro_torch.core.arrival.pop_k_device` (two
  stable sorts on the ``(time, seq)`` key pair).
* Payloads are synthesized in encoded space on the device (a generator
  seeded from ``(cfg.seed, next_seq)`` each round), so a round prices
  exactly the server's work: decode, staleness-weighted aggregate and
  re-dispatch, with no host payload traffic.
* Double buffering in place of the reference's ``donate_argnums``:
  :func:`make_step` preallocates two generations of every state tensor and
  each round writes its result into the generation the previous round
  read from. The state passed in is consumed (the dict is emptied), as a
  donated argument is; callers hold only the returned state. Allocated
  memory is flat from the second round on.
* Host work a round is a fixed number of launches, whatever N and K: no
  per-client Python loop, and no device-to-host read after the first
  round. The re-dispatched clients' versions are filled from the device's
  global version (``index_copy_``), and the step keeps a host copy of
  ``next_seq`` for the generator's seed; only a state the step did not
  return itself has its ``next_seq`` read back, through
  :func:`repro_torch.trace.to_host`, whose ``host_syncs`` counter counts
  it. So the host enqueues a round while the card still runs the one
  before: every round's work is ordered on the one stream.

The draws cannot be bit-equal to ``jax.random``'s, so the two draw sites
are module-level seams, as in the reference: :func:`synthetic_payloads`
and :func:`_uniform` (the latency model's uniform draw). Tests feed both
packages identical draws through them.

``ServeConfig(shard=True)`` splits the cohort over the ranks of a
``torch.distributed`` process group (the reference's ``shard_map`` over a
1-D ``clients`` device mesh): every rank runs the same step, reduces its
``buffer_k / world`` slice of the cohort to a weighted sum and one
``all_reduce`` makes the mean (``codec.decode_and_aggregate_sharded``).
``buffer_k`` must divide over the group's ranks. The group is :func:`make_step`'s and
:func:`run_serve`'s ``group`` (``None``: the initialised world group).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import codec
from repro_torch.core.arrival import pop_k_device
from repro_torch.core.pytree import flatten, unflatten
from repro_torch.device import DeviceLike, resolve

Tree = Any
State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static shape of the serving simulation. ``spec`` is any codec spec;
    its ``size`` fixes the flat model width the aggregate updates."""

    n_clients: int
    buffer_k: int
    spec: codec.CodecSpec
    staleness_power: float = 0.5
    server_lr: float = 1.0
    base_latency: float = 1.0
    jitter: float = 0.5                # latency ~ base * U[1-j, 1+j]
    straggler_frac: float = 0.0        # first ceil(frac*N) clients slow
    straggler_mult: float = 10.0
    seed: int = 0
    shard: bool = False

    def __post_init__(self):
        assert 0 < self.buffer_k <= self.n_clients


def _uniform(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    """The latency model's uniform draw: float32 U[0, 1) on ``gen``'s
    device."""
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=torch.float32)


def _latency(cfg: ServeConfig, gen: torch.Generator,
             cis: torch.Tensor) -> torch.Tensor:
    """Simulated round-trip latency for clients ``cis``: base × uniform
    jitter × straggler tail, the in-step counterpart of
    ``LatencyModel.sample``."""
    u = _uniform(gen, tuple(cis.shape))
    lat = cfg.base_latency * (1.0 + cfg.jitter * (2.0 * u - 1.0))
    n_slow = int(np.ceil(cfg.straggler_frac * cfg.n_clients))
    if n_slow:
        lat = torch.where(cis < n_slow, lat * cfg.straggler_mult, lat)
    return lat


def _signature(params: Optional[Tree]) -> Tuple:
    leaves, treedef = flatten(params)
    return treedef, tuple((tuple(x.shape), x.dtype) for x in leaves)


@functools.lru_cache(maxsize=32)
def _payload_structure(spec: codec.CodecSpec, signature: Tuple) -> Tuple:
    """``(treedef, ((shape, dtype), ...))`` of one ``codec.encode`` of
    ``spec``: an encode of a zero vector on the CPU with zero params of the
    signature's shapes (the counterpart of ``jax.eval_shape``; no kernel
    launches)."""
    treedef, leaf_sig = signature
    params = unflatten(treedef, [torch.zeros(s, dtype=d) for s, d in leaf_sig])
    with torch.no_grad():
        payload = codec.encode(spec, params,
                               torch.zeros(int(spec.size),
                                           dtype=torch.float32))
    leaves, pdef = flatten(payload)
    return pdef, tuple((tuple(x.shape), x.dtype) for x in leaves)


def synthetic_payloads(spec: codec.CodecSpec, params: Optional[Tree],
                       k: int, gen: torch.Generator) -> codec.Payload:
    """A stacked cohort of ``k`` synthetic encoded payloads with exactly
    the structure, shapes and dtypes ``codec.encode`` ships for ``spec``,
    drawn on ``gen``'s device. Floats draw standard normals; integer
    leaves (quantized values, top-k indices) draw uniformly, ``[-127,
    128)`` for int8 and ``[0, max(size, 2))`` otherwise. The decode cost
    the loop prices does not depend on payload values."""
    pdef, leaf_sig = _payload_structure(spec, _signature(params))
    dev = gen.device
    out = []
    for shape, dtype in leaf_sig:
        full = (k, *shape)
        if dtype.is_floating_point:
            out.append(torch.randn(full, generator=gen, device=dev,
                                   dtype=torch.float32).to(dtype))
        elif not dtype.is_complex and dtype != torch.bool:
            lo, hi = ((-127, 128) if dtype == torch.int8
                      else (0, max(int(spec.size), 2)))
            out.append(torch.randint(lo, hi, full, generator=gen,
                                     device=dev, dtype=torch.int32
                                     ).to(dtype))
        else:
            out.append(torch.zeros(full, dtype=dtype, device=dev))
    return unflatten(pdef, out)


def _seed(cfg: ServeConfig, next_seq: int) -> int:
    """The generator seed of the round that dispatches from ``next_seq``:
    the counterpart of ``fold_in(PRNGKey(cfg.seed), next_seq)``."""
    return (int(cfg.seed) << 32) + int(next_seq)


def init_state(cfg: ServeConfig, codec_params: Optional[Tree] = None,
               global_flat: Optional[torch.Tensor] = None,
               device: DeviceLike = None) -> State:
    """The serve state on ``device`` (CUDA unless the caller asks for the
    CPU): every client dispatched at t=0 with the v0 model — the opening
    position of ``AsyncBuffered``."""
    dev = resolve(device)
    n = cfg.n_clients
    gen = torch.Generator(device=dev).manual_seed(_seed(cfg, 0))
    cis = torch.arange(n, dtype=torch.int32, device=dev)
    if global_flat is None:
        global_flat = torch.zeros((int(cfg.spec.size),), dtype=torch.float32)
    return {
        "times": _latency(cfg, gen, cis),              # (N,) next arrival
        "seqs": cis.clone(),                           # (N,) dispatch seq
        "versions": torch.zeros(n, dtype=torch.int32, device=dev),
        "global_flat": global_flat.to(device=dev, dtype=torch.float32,
                                      copy=True),
        "clock": torch.zeros((), dtype=torch.float32, device=dev),
        "version": torch.zeros((), dtype=torch.int32, device=dev),
        "next_seq": torch.full((), n, dtype=torch.int32, device=dev),
    }


class _Step:
    """One ingest round, state → state, over two preallocated generations
    (module docstring). Host work is a fixed number of launches, with no
    wait on the card once the step has returned a state."""

    def __init__(self, cfg: ServeConfig, codec_params: Optional[Tree],
                 dev: torch.device, group=None):
        n, k = cfg.n_clients, cfg.buffer_k
        self.cfg, self.params, self.dev = cfg, codec_params, dev
        self.group = group
        if cfg.shard:
            from repro_torch.core.collectives import group_size
            world = group_size(group)
            assert k % world == 0, (
                f"buffer_k={k} must divide over {world} ranks")
        self.gen = torch.Generator(device=dev)
        self.arange_k = torch.arange(k, dtype=torch.int32, device=dev)

        def generation() -> State:
            return {
                "times": torch.empty(n, dtype=torch.float32, device=dev),
                "seqs": torch.empty(n, dtype=torch.int32, device=dev),
                "versions": torch.empty(n, dtype=torch.int32, device=dev),
                "global_flat": torch.empty(int(cfg.spec.size),
                                           dtype=torch.float32, device=dev),
                "clock": torch.empty((), dtype=torch.float32, device=dev),
                "version": torch.empty((), dtype=torch.int32, device=dev),
                "next_seq": torch.empty((), dtype=torch.int32, device=dev),
            }
        self.gens = (generation(), generation())
        # host copy of the last returned state's next_seq: the generator
        # seed without a device-to-host read a round
        self._last: Optional[Tuple[int, int]] = None   # (data_ptr, seq)

    @trace.spanned("ingest_step")
    @torch.no_grad()
    def __call__(self, state: State) -> State:
        cfg, k = self.cfg, self.cfg.buffer_k
        g_in = state["global_flat"]
        out = (self.gens[1] if g_in.data_ptr()
               == self.gens[0]["global_flat"].data_ptr() else self.gens[0])
        if self._last is not None and self._last[0] == g_in.data_ptr():
            next_seq = self._last[1]
        else:
            next_seq = int(trace.to_host(state["next_seq"]))

        with trace.span("ingest.pop"):
            times, seqs = state["times"], state["seqs"]
            popped_t, idx = pop_k_device(times, seqs, k)
            clock = torch.maximum(state["clock"], popped_t[-1])
            idx64 = idx.long()
            # staleness-discounted FedBuff weights, normalized on the device
            stale = (state["version"] - state["versions"][idx64]).float()
            w = (1.0 + stale) ** (-cfg.staleness_power)
            w = w / torch.sum(w)

        with trace.span("ingest.payloads"):
            self.gen.manual_seed(_seed(cfg, next_seq))
            stacked = synthetic_payloads(cfg.spec, self.params, k, self.gen)
        with trace.span("ingest.decode_agg"):
            if cfg.shard:
                mean = codec.decode_and_aggregate_sharded(
                    cfg.spec, self.params, stacked, w, group=self.group)
            else:
                mean = codec.decode_and_aggregate(cfg.spec, self.params,
                                                  stacked, w)
            torch.add(g_in, cfg.server_lr * mean, out=out["global_flat"])

        # re-dispatch exactly the drained cohort with the new model
        with trace.span("ingest.redispatch"):
            lat = _latency(cfg, self.gen, idx)
            out["times"].copy_(times).index_copy_(0, idx64, clock + lat)
            out["seqs"].copy_(seqs).index_copy_(
                0, idx64, state["next_seq"] + self.arange_k)
            # the new version from the device tensor: nothing read back
            out["versions"].copy_(state["versions"]).index_copy_(
                0, idx64, (state["version"] + 1).expand(k))
            out["clock"].copy_(clock)
            torch.add(state["version"], 1, out=out["version"])
            torch.add(state["next_seq"], k, out=out["next_seq"])
        state.clear()                  # consumed, as a donated argument
        self._last = (out["global_flat"].data_ptr(), next_seq + k)
        return dict(out)


def make_step(cfg: ServeConfig, codec_params: Optional[Tree] = None,
              device: DeviceLike = None, group=None):
    """Build the serve step on ``device``: state → state, one ingest round
    (pop, payload synthesis, fused decode→aggregate — sharded over
    ``group`` when ``cfg.shard`` — model update, re-dispatch). The passed
    state is consumed; each round's result lands in the generation the
    round before read from."""
    return _Step(cfg, codec_params, resolve(device), group)


def round_bytes(cfg: ServeConfig,
                codec_params: Optional[Tree] = None) -> int:
    """Uplink bytes one ingest round consumes: K encoded payloads at the
    spec's static wire price (``codec.wire_bytes``)."""
    return cfg.buffer_k * codec.wire_bytes(cfg.spec, codec_params)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_serve(cfg: ServeConfig, n_rounds: int,
              codec_params: Optional[Tree] = None,
              warmup: int = 1,
              global_flat: Optional[torch.Tensor] = None,
              device: DeviceLike = None, group=None
              ) -> Tuple[State, Dict[str, float]]:
    """Drive the serve loop for ``n_rounds`` timed rounds after ``warmup``
    untimed ones and report sustained throughput on the host clock (each
    end a synchronize): ``rounds_per_sec``, ``bytes_per_sec`` (ingested
    uplink), ``us_per_round``, ``round_bytes`` and ``sim_time``. The state
    is rebound to each step's return; the consumed one is never read."""
    dev = resolve(device)
    step = make_step(cfg, codec_params, dev, group)
    state = init_state(cfg, codec_params, global_flat=global_flat,
                       device=dev)
    for _ in range(max(warmup, 1)):
        state = step(state)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        state = step(state)
    _sync(dev)
    dt = time.perf_counter() - t0
    per_round = round_bytes(cfg, codec_params)
    report = {
        "rounds_per_sec": n_rounds / dt,
        "bytes_per_sec": n_rounds * per_round / dt,
        "us_per_round": dt / n_rounds * 1e6,
        "round_bytes": float(per_round),
        "sim_time": float(state["clock"]),
    }
    return state, report
