"""Activation-sharding context (port of ``repro.models.partition_ctx``):
step builders install the batch axes here, and the model constrains the
residual stream at layer boundaries.

On a plain tensor :func:`constrain_activations` is the identity, as the
reference's is without a context. On a ``DTensor`` (parameters spread over
a ``DeviceMesh`` with ``distribute_tensor``) inside the context it
redistributes the activation to ``Shard(0)`` over the batch axes, plus
``Shard(1)`` over ``seq_axis`` when the sequence length is a multiple of
16, with the feature dims replicated (the reference's
``with_sharding_constraint`` spec, ``src/repro/models/partition_ctx.py:39-50``).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple, Union

import torch

_ACTIVATION_AXES: contextvars.ContextVar[Optional[Tuple]] = \
    contextvars.ContextVar("activation_axes", default=None)
_SEQ_AXIS: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("seq_axis", default=None)


@contextlib.contextmanager
def activation_sharding(batch_axes: Optional[Union[str, Tuple[str, ...]]],
                        seq_axis: Optional[str] = None):
    """batch_axes: mesh axis names for the batch dim, e.g. ('pod', 'data').
    seq_axis: optional mesh axis for the sequence dim (sequence
    parallelism for long-context prefill and training)."""
    t1 = _ACTIVATION_AXES.set(batch_axes)
    t2 = _SEQ_AXIS.set(seq_axis)
    try:
        yield
    finally:
        _ACTIVATION_AXES.reset(t1)
        _SEQ_AXIS.reset(t2)


def activation_spec(ndim: int, seq_len: int) -> Optional[tuple]:
    """The spec the context asks of an activation of ``ndim`` dims and
    sequence length ``seq_len`` (one entry a dim, as a ``PartitionSpec``'s
    entries), or None outside a context."""
    axes = _ACTIVATION_AXES.get()
    if axes is None:
        return None
    seq = _SEQ_AXIS.get()
    if ndim >= 3 and seq is not None and seq_len % 16 == 0:
        return (axes, seq) + (None,) * (ndim - 2)
    return (axes,) + (None,) * (ndim - 1)


def constrain_activations(x: torch.Tensor) -> torch.Tensor:
    """Constrain a (B, S, D) activation: batch over the data axes,
    optionally sequence over the model axis, features replicated."""
    spec = activation_spec(x.dim(), x.shape[1] if x.dim() > 1 else 0)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.models.sharding import placements
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(mesh, spec))
