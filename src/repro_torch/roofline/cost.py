"""A step's roofline inputs, read from the step itself: the port's
counterpart of ``repro.roofline.hlo_parse.analyze_hlo`` plus
``analysis.analyze_compiled``.

PyTorch compiles no HLO, so the reference's HLO-text grammar has nothing
to parse here. :func:`analyze_step` instead runs the bundle's step once on
its meta-tensor inputs (no memory, no card):

* FLOPs — ``torch.utils.flop_counter.FlopCounterMode`` around the call
  (matmuls, convolutions and attention products, forward and backward);
  the FL round runs one pod's batch, the other steps the global batch, so
  a device's share is the count over the devices that run it;
* bytes — per device, each input and output leaf's bytes over the pieces
  its partition spec (``models/sharding.py``) cuts it into on the mesh:
  the step's parameters, optimizer state, batch and cache read once and
  its outputs written once (the memory term), and the inputs held at once
  (the peak); activations are not counted;
* collective bytes — what the step hands to ``torch.distributed``,
  recorded by a ``CountingGroup`` standing in for the pod group
  (``core/collectives.py``): in the FL round every byte of it crosses the
  pod axis. The other steps make no call, so their collective term is 0.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.collectives import CountingGroup
from repro_torch.models import sharding as shard_lib
from repro_torch.roofline.analysis import RooflineReport


def _sharded_bytes(tree: Any, specs: Any, mesh) -> float:
    """Σ leaf bytes / the pieces its spec cuts it into."""
    if specs is None or tree is None:
        return 0.0
    total = [0.0]

    def add(spec, leaf):
        if isinstance(leaf, torch.Tensor):
            total[0] += (leaf.numel() * leaf.element_size()
                         / shard_lib.spec_shards(spec, mesh))
        return spec
    shard_lib.map_specs(add, specs, tree)
    return total[0]


def _local_batch(batch: dict, pods: int) -> dict:
    return {k: torch.empty((v.shape[0] // pods, *v.shape[1:]),
                           dtype=v.dtype, device=v.device)
            for k, v in batch.items()}


def analyze_step(bundle, mesh, model_flops: float = 0.0,
                 group: Optional[CountingGroup] = None) -> RooflineReport:
    """Roofline terms of ``bundle`` (``launch.steps.build_step``) on
    ``mesh``; ``group`` is the ``CountingGroup`` the FL round was built
    over (``None`` for the other steps)."""
    m = shard_lib.mesh_shape(mesh)
    n_dev = 1
    for v in m.values():
        n_dev *= v
    fl = group is not None
    pods = m.get("pod", 1) if fl else 1
    args = list(bundle.args)
    if fl:
        args[3] = _local_batch(args[3], pods)
    with FlopCounterMode(display=False) as counter:
        outs = bundle.fn(*args)
    flops = counter.get_total_flops() / (n_dev // pods)
    ins = sum(_sharded_bytes(a, s, m)
              for a, s in zip(bundle.args, bundle.in_shardings))
    written = _sharded_bytes(outs, bundle.out_shardings, m)
    coll = float(group.total_bytes()) if group is not None else 0.0
    return RooflineReport(
        name=bundle.name, n_devices=n_dev, flops_per_device=float(flops),
        hbm_bytes_per_device=ins + written,
        collective_bytes_per_device=coll,
        collective_breakdown=(group.bytes_by_kind() if group is not None
                              else {}),
        peak_memory_per_device=ins, model_flops=model_flops,
        cross_pod_bytes_per_device=coll if fl else 0.0)
