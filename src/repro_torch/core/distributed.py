"""The paper's technique at datacenter scale (port of
``repro.core.distributed``): a federated round in which the ``pod`` group
is the collaborator axis.

``build_fl_round_step`` assembles one round. Each pod (a rank of the
group) computes its local gradients, then, instead of all-reducing full
gradients across pods:

1. chunk-encodes every gradient leaf with the shared chunked AE
   (collaborator-side encoder, Eq. 1);
2. averages only the latents across the group: one ``all_reduce`` over a
   flat buffer of every leaf's latents, the only cross-pod traffic,
   smaller than the gradients by the compression ratio
   (:func:`compressed_fraction` predicts its bytes);
3. decodes (aggregator-side decoder, Eq. 2) and applies the optimizer.

A pod here is one card, so there is no model parallelism inside a pod to
misalign the chunks with the shards: the reference's ``aligned`` option
(encode each device's local shard) has no counterpart and is not taken.
The encode and decode are plain matmuls (``fc_encode``/``fc_decode``) in
the reference too, so they are ``torch.matmul`` (cuBLAS) here.

The round's phases are ``record_function`` ranges (``fl_round.*``), not
:mod:`repro_torch.trace` spans: ``chip_smoke.py`` splits a traced round by
the ranges' device-side annotations, which a ``trace`` span does not draw.
This is the one place the program draws on the device's timeline.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import collectives
from repro_torch.core.autoencoder import (ChunkedAEConfig, fc_decode,
                                          fc_encode, init_chunked_ae)
from repro_torch.core.pytree import flatten, tree_map, unflatten
from repro_torch.models import model as model_lib
from repro_torch.optim.optimizers import make_optimizer

Tree = Any

# default production codec: 4096-element chunks → 8 latents = 512x
DEFAULT_AE = ChunkedAEConfig(chunk_size=4096, hidden=(512,), latent_chunk=8)


def leaf_encode(ae_params: Tree, ae_cfg: ChunkedAEConfig,
                leaf: torch.Tensor) -> torch.Tensor:
    """Flatten a param leaf into chunks and encode: (n_chunks, latent)."""
    flat = leaf.float().reshape(-1)
    pad = (-flat.numel()) % ae_cfg.chunk_size
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return fc_encode(ae_params, ae_cfg.as_fc(),
                     flat.reshape(-1, ae_cfg.chunk_size))


def leaf_decode(ae_params: Tree, ae_cfg: ChunkedAEConfig,
                latents: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    chunks = fc_decode(ae_params, ae_cfg.as_fc(), latents)
    flat = chunks.reshape(-1)[:like.numel()]
    return flat.reshape(like.shape).to(like.dtype)


def encode_tree(ae_params: Tree, ae_cfg: ChunkedAEConfig,
                tree: Tree) -> Tree:
    return tree_map(lambda leaf: leaf_encode(ae_params, ae_cfg, leaf), tree)


def decode_tree(ae_params: Tree, ae_cfg: ChunkedAEConfig, latents: Tree,
                like: Tree) -> Tree:
    return tree_map(lambda z, l: leaf_decode(ae_params, ae_cfg, z, l),
                    latents, like)


def compressed_fraction(tree: Tree, ae_cfg: ChunkedAEConfig) -> float:
    """Latent bytes / original bytes for a param tree (exactly what crosses
    the pod group against what a full all-reduce would move)."""
    orig = comp = 0
    for leaf in flatten(tree)[0]:
        n = leaf.numel()
        chunks = -(-n // ae_cfg.chunk_size)
        orig += n * 4
        comp += chunks * ae_cfg.latent_chunk * 4
    return comp / max(orig, 1)


def build_fl_round_step(cfg: ArchConfig, shape: ShapeConfig, group=None,
                        ae_cfg: ChunkedAEConfig = DEFAULT_AE, *, mesh=None):
    """``StepBundle`` for one federated round over the pod ``group`` (a
    ``torch.distributed`` process group, ``None`` for the default world
    group, or a ``CountingGroup`` on meta tensors; it must exist when the
    step runs).

    ``fn(params, opt_state, ae_params, batch)`` takes this pod's batch
    (``shape.global_batch // pods`` rows) and, in the reference's order:
    computes the input embeddings ``h0`` with the embedding detached (the
    frozen input path; a tied head's gradient still flows through the
    logits); takes the gradients of ``models.train_loss`` under autograd
    (with respect to a bfloat16 view when ``cfg.grad_reduce_dtype ==
    "bfloat16"``, cast back to float32); encodes each gradient leaf;
    averages the latents of all leaves across the group in one
    ``all_reduce`` (a SUM, then a division by the group's size); decodes;
    applies ``make_optimizer(cfg.optimizer, ...)``, in place (the
    reference donates params and optimizer state); averages loss and
    accuracy across the group. It returns ``(params, opt_state, {"loss",
    "accuracy"})``. Each phase runs under a ``record_function`` range
    (``fl_round.forward_backward``, ``.encode``, ``.all_reduce``,
    ``.decode``, ``.optimizer``) that ``torch.profiler`` reads.
    ``bundle.stats["last_round"]`` holds the round's ``latent_bytes`` (the
    all-reduced buffer) and ``grad_bytes`` (the float32 gradients a full
    all-reduce would move).

    ``mesh`` (``{axis: size}`` or a ``DeviceMesh`` with a ``pod`` axis)
    fills the bundle's partition specs for the dry-run."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import sharding as shard_lib

    opt = make_optimizer(cfg.optimizer, cfg.learning_rate,
                         weight_decay=cfg.weight_decay,
                         grad_clip=cfg.grad_clip)
    stats: Dict[str, Any] = {}

    @torch.no_grad()
    def _exchange(g_leaves: List[torch.Tensor], ae_params: Tree
                  ) -> List[torch.Tensor]:
        """Encode every leaf (each gradient dropped once encoded), average
        the latents across the group in one all-reduce, decode."""
        like = [torch.empty(g.shape, dtype=g.dtype, device="meta")
                for g in g_leaves]
        lat = []
        with record_function("fl_round.encode"):
            while g_leaves:
                lat.append(leaf_encode(ae_params, ae_cfg, g_leaves.pop(0)))
            flat = torch.cat([z.reshape(-1) for z in lat])
        with record_function("fl_round.all_reduce"):
            collectives.all_reduce_mean(flat, group)
        stats["last_round"] = dict(
            latent_bytes=flat.numel() * flat.element_size(),
            grad_bytes=sum(4 * t.numel() for t in like))
        out, off = [], 0
        with record_function("fl_round.decode"):
            for z, l in zip(lat, like):
                zz = flat[off:off + z.numel()].view(z.shape)
                off += z.numel()
                out.append(leaf_decode(ae_params, ae_cfg, zz, l))
        return out

    def step(params, opt_state, ae_params, batch):
        tokens = batch["tokens"]
        B, S = tokens.shape
        with torch.no_grad():
            frozen = dict(params, embed=params["embed"].detach())
            h0 = model_lib._embed_inputs(
                frozen, cfg, batch, model_lib._positions(B, S, tokens.device))
        with record_function("fl_round.forward_backward"):
            metrics, grads = steps_lib.grads_of_train_loss(
                cfg, params, dict(batch, h0=h0), grad_dtype=torch.float32)
        g_leaves, td = flatten(grads)
        del grads
        decoded = unflatten(td, _exchange(g_leaves, ae_params))
        with record_function("fl_round.optimizer"):
            params, opt_state = opt.update(params, decoded, opt_state,
                                           inplace=True)
        m = torch.stack([metrics["loss"].float(),
                         metrics["accuracy"].float()])
        collectives.all_reduce_mean(m, group)
        return params, opt_state, {"loss": m[0], "accuracy": m[1]}

    p_shapes = steps_lib.param_shapes(cfg)
    o_shapes = opt.init(p_shapes)
    b_shapes = steps_lib.batch_shapes(cfg, shape)
    ae_shapes = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                               device="meta"),
                         init_chunked_ae(torch.Generator(), ae_cfg, "cpu"))
    specs = (None, None, None, None)
    out_specs = None
    if mesh is not None:
        m = shard_lib.mesh_shape(mesh)
        if "pod" not in m:
            raise ValueError("the FL round step needs a mesh with a pod "
                             "axis")
        p_specs = shard_lib.param_specs(p_shapes, m)
        o_specs = steps_lib._opt_specs(cfg, m, p_specs, p_shapes, o_shapes)
        b_specs = shard_lib.batch_specs(b_shapes, m)
        ae_specs = tree_map(lambda t: (None,) * t.dim(), ae_shapes)
        specs = (p_specs, o_specs, ae_specs, b_specs)
        out_specs = (p_specs, o_specs, {"loss": (), "accuracy": ()})
    return steps_lib.StepBundle(
        name=f"fl_round:{cfg.name}:{shape.name}", fn=step,
        args=(p_shapes, o_shapes, ae_shapes, b_shapes),
        in_shardings=specs, out_shardings=out_specs,
        donate_argnums=(0, 1), stats=stats)
