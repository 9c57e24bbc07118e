"""Production meshes and the card's roofline constants (port of
``repro.launch.mesh``).

Single pod: 16 x 16 = 256 cards, axes (data, model). Multi-pod: 2 x 16 x
16 = 512 cards, axes (pod, data, model); the ``pod`` axis is the federated
collaborator axis, the only traffic across it the AE latents
(``core/distributed.py``). :func:`make_production_mesh` and
:func:`make_host_mesh` build ``DeviceMesh`` objects and need that many
initialised ranks; the dry-run reasons about the production meshes
through :func:`production_mesh_shape` (``{axis: size}``), which needs
none.
Both are functions, never called at import.

The constants are NVIDIA's public H100 SXM5 80GB spec sheet figures, for
the card ``nvidia-smi --query-gpu=name,power.limit`` reports as ``NVIDIA
H100 80GB HBM3, 700.00 W``; they are the bounds ``PERF.md`` §6 uses.
"""
from __future__ import annotations

from typing import Dict

HBM_BW = 3.35e12               # B/s, HBM3
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense bf16 tensor cores
PEAK_FLOPS_F32 = 67e12         # FLOP/s, float32 (no tensor cores)
NVLINK_BW = 450e9              # B/s a direction a card (NVLink 4, 900 GB/s
                               # both ways)
CROSS_NODE_BW = 50e9           # B/s a card across nodes (one 400 Gb/s NDR
                               # port)

def production_mesh_shape(*, multi_pod: bool = False) -> Dict[str, int]:
    """``{axis: size}`` of the production mesh."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False):
    """The production ``DeviceMesh`` over an initialised world of 256 (or
    512) ranks, one card each."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = production_mesh_shape(multi_pod=multi_pod)
    return init_device_mesh("cuda", tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def make_host_mesh():
    """A (1, n) (data, model) mesh over the initialised world's n ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: no process group is "
                           "initialised")
    return init_device_mesh("cuda", (1, dist.get_world_size()),
                            mesh_dim_names=("data", "model"))
