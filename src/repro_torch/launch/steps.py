"""Step builders and meta-device input shapes for every (arch x shape)
(port of ``repro.launch.steps``).

``build_step(cfg, shape, mesh)`` returns a :class:`StepBundle`: the step
function, its example inputs as meta tensors (shapes and dtypes, no
allocation, as ``jax.eval_shape`` gives), and per-dim partition specs
(``models/sharding.py``) for the inputs and outputs on ``mesh`` (a
``{axis: size}`` dict or a ``DeviceMesh``). The dry-run
(``launch/dryrun.py``) runs these bundles on the meta device; the real
launchers run them on the card.

Step kinds by ``shape.mode``:

* train — loss, gradient (autograd) and the optimizer's update, in place
  (the reference donates params and optimizer state);
* prefill — full-sequence forward returning (last logits, decode cache);
* decode — one-token serve step against a pre-filled cache (updated in
  place, the reference donates it);
* fl — a federated round: local gradients, chunked-AE latents averaged
  across the ``pod`` group (``core/distributed.py``).

The port's steps run on one card a process: a mesh's specs say how the
reference would lay the step out, and a step's only calls into
``torch.distributed`` are the FL round's (``core/collectives.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.pytree import flatten, unflatten
from repro_torch.models import model as model_lib
from repro_torch.models import sharding as shard_lib
from repro_torch.optim.optimizers import make_optimizer

Tree = Any
META = torch.device("meta")


@dataclasses.dataclass
class StepBundle:
    name: str
    fn: Callable
    args: Tuple[Tree, ...]              # meta-tensor trees
    in_shardings: Tuple[Tree, ...]
    out_shardings: Tree
    donate_argnums: Tuple[int, ...] = ()
    static_broadcasted: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    # what the last call measured (the FL round: its latent and gradient
    # bytes)
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def param_shapes(cfg: ArchConfig) -> Tree:
    """The parameter tree as meta tensors: ``init_params`` traced under
    ``FakeTensorMode`` (nothing drawn, nothing allocated), each leaf then
    an empty meta tensor of its shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = model_lib.init_params(torch.Generator(), cfg, "cpu")
        sig = [(tuple(t.shape), t.dtype) for t in flatten(fake)[0]]
        treedef = flatten(fake)[1]
    return unflatten(treedef, [_meta(s, d) for s, d in sig])


def opt_shapes(cfg: ArchConfig, p_shapes: Tree) -> Tree:
    opt = make_optimizer(cfg.optimizer, cfg.learning_rate,
                         weight_decay=cfg.weight_decay,
                         grad_clip=cfg.grad_clip)
    return opt.init(p_shapes)


def batch_shapes(cfg: ArchConfig, shape: ShapeConfig,
                 with_labels: bool = True) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": _meta((B, S), torch.int32)}
    if with_labels:
        out["labels"] = _meta((B, S), torch.int32)
    if cfg.family == "audio":
        out["frames"] = _meta((B, cfg.encdec.n_frames, cfg.d_model),
                              _dtype(cfg.compute_dtype))
    if cfg.family == "vlm":
        out["image_embeds"] = _meta((B, cfg.vlm.n_image_tokens, cfg.d_model),
                                    _dtype(cfg.compute_dtype))
    return out


def decode_window(cfg: ArchConfig, shape: ShapeConfig) -> Optional[int]:
    """Sliding-window fallback for quadratic archs on very long contexts."""
    if shape.name == "long_500k" and cfg.long_context_window:
        return cfg.long_context_window
    return None


def cache_shapes(cfg: ArchConfig, shape: ShapeConfig) -> Tree:
    return model_lib.init_cache(cfg, shape.global_batch, shape.seq_len,
                                decode_window(cfg, shape), device=META)


# =====================================================================
# sharding assembly
# =====================================================================
def _opt_specs(cfg: ArchConfig, mesh, p_specs: Tree, p_shapes: Tree,
               opt_state_shape: Tree) -> Tree:
    """Optimizer state specs: moments follow params (+ZeRO-1 data
    sharding)."""
    def moment_spec(spec, shp):
        return (shard_lib.zero1_spec(spec, tuple(shp.shape), mesh)
                if cfg.zero1 else spec)
    moment = shard_lib.map_specs(moment_spec, p_specs, p_shapes)
    return {k: (() if k == "count" else moment) for k in opt_state_shape}


def _activation_axes(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """(batch_axes, seq_axis) for residual-stream sharding constraints:
    batch over (pod, data) when divisible; sequence over ``model`` for
    full-sequence modes on attention-bearing archs (SSM and hybrid keep
    1D sharding — their scans run along the sequence)."""
    m = shard_lib.mesh_shape(mesh)
    axes = shard_lib.batch_axes(m)
    total = 1
    for a in axes:
        total *= m[a]
    if shape.global_batch % total != 0:
        return None, None
    seq_axis = None
    seq_ok = (cfg.family in ("dense", "moe", "vlm", "audio")
              and shape.seq_len % m.get("model", 1) == 0)
    if seq_ok and (shape.mode == "prefill"
                   or (shape.mode == "train" and cfg.train_seq_shard)):
        seq_axis = "model"
    return axes, seq_axis


def _with_activation_ctx(fn, axes, seq_axis=None):
    if axes is None:
        return fn
    from repro_torch.models.partition_ctx import activation_sharding

    def wrapped(*a):
        with activation_sharding(axes, seq_axis):
            return fn(*a)
    return wrapped


def build_step(cfg: ArchConfig, shape: ShapeConfig, mesh, fl: bool = False,
               constrain: bool = True, group=None) -> StepBundle:
    """The step for ``shape.mode`` on ``mesh``; ``fl`` builds the
    federated round over ``group`` (the ``pod`` group) instead of the
    train step."""
    if shape.mode == "train":
        if fl:
            from repro_torch.core.distributed import build_fl_round_step
            bundle = build_fl_round_step(cfg, shape, group, mesh=mesh)
        else:
            bundle = build_train_step(cfg, shape, mesh)
    elif shape.mode == "prefill":
        bundle = build_prefill_step(cfg, shape, mesh)
    elif shape.mode == "decode":
        bundle = build_decode_step(cfg, shape, mesh)
    else:
        raise ValueError(shape.mode)
    if constrain:
        axes, seq_axis = _activation_axes(cfg, shape, mesh)
        if fl and axes is not None:
            # inside a pod the residual stream is sharded over its own
            # axes only
            axes = tuple(a for a in axes if a != "pod") or None
        bundle.fn = _with_activation_ctx(bundle.fn, axes, seq_axis)
    return bundle


def grads_of_train_loss(cfg: ArchConfig, params: Tree, batch: Dict,
                        grad_dtype: Optional[torch.dtype] = None
                        ) -> Tuple[Dict[str, torch.Tensor], Tree]:
    """``(metrics, grads)`` of ``models.train_loss`` under autograd. With
    ``cfg.grad_reduce_dtype == "bfloat16"`` the gradient is taken with
    respect to a bfloat16 view of the float32 leaves, then cast to
    ``grad_dtype`` (the reference's train step casts to each param's
    dtype, its FL round to float32). A leaf the loss does not reach gets a
    zero gradient, as ``jax.grad`` gives."""
    lv, td = flatten(params)
    if cfg.grad_reduce_dtype == "bfloat16":
        xs = [(p.detach().to(torch.bfloat16) if p.dtype == torch.float32
               else p.detach()) for p in lv]
    else:
        xs = [p.detach() for p in lv]
    xs = [x.requires_grad_(True) for x in xs]
    _, metrics = model_lib.train_loss(unflatten(td, xs), cfg, batch)
    grads = torch.autograd.grad(metrics["loss"], xs, allow_unused=True,
                                materialize_grads=True)
    if cfg.grad_reduce_dtype == "bfloat16":
        grads = [g.to(grad_dtype or p.dtype) for g, p in zip(grads, lv)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics, unflatten(td, list(grads))


def build_train_step(cfg: ArchConfig, shape: ShapeConfig,
                     mesh) -> StepBundle:
    opt = make_optimizer(cfg.optimizer, cfg.learning_rate,
                         weight_decay=cfg.weight_decay,
                         grad_clip=cfg.grad_clip)

    def step(params, opt_state, batch):
        metrics, grads = grads_of_train_loss(cfg, params, batch)
        params, opt_state = opt.update(params, grads, opt_state,
                                       inplace=True)
        return params, opt_state, {"loss": metrics["loss"],
                                   "accuracy": metrics["accuracy"]}

    p_shapes = param_shapes(cfg)
    o_shapes = opt.init(p_shapes)
    b_shapes = batch_shapes(cfg, shape)
    p_specs = shard_lib.param_specs(p_shapes, mesh)
    o_specs = _opt_specs(cfg, mesh, p_specs, p_shapes, o_shapes)
    b_specs = shard_lib.batch_specs(b_shapes, mesh)
    metric_specs = {"loss": (), "accuracy": ()}
    return StepBundle(
        name=f"train:{cfg.name}:{shape.name}", fn=step,
        args=(p_shapes, o_shapes, b_shapes),
        in_shardings=(p_specs, o_specs, b_specs),
        out_shardings=(p_specs, o_specs, metric_specs),
        donate_argnums=(0, 1))


def build_prefill_step(cfg: ArchConfig, shape: ShapeConfig, mesh,
                       two_d_weights: bool = True) -> StepBundle:
    window = decode_window(cfg, shape)

    @torch.no_grad()
    def step(params, batch):
        return model_lib.prefill(params, cfg, batch, cache_len=shape.seq_len,
                                 window=window)

    p_shapes = param_shapes(cfg)
    b_shapes = batch_shapes(cfg, shape, with_labels=False)
    c_shapes = model_lib.init_cache(cfg, shape.global_batch, shape.seq_len,
                                    window, device=META)
    p_specs = shard_lib.param_specs(p_shapes, mesh)
    if two_d_weights:
        p_specs = shard_lib.fully_shard(p_specs, p_shapes, mesh)
    b_specs = shard_lib.batch_specs(b_shapes, mesh)
    c_specs = shard_lib.cache_specs(c_shapes, mesh)
    logits_spec = shard_lib.data_spec(mesh, shape.global_batch, 2)
    return StepBundle(
        name=f"prefill:{cfg.name}:{shape.name}", fn=step,
        args=(p_shapes, b_shapes), in_shardings=(p_specs, b_specs),
        out_shardings=(logits_spec, c_specs))


def build_decode_step(cfg: ArchConfig, shape: ShapeConfig, mesh,
                      two_d_weights: bool = True) -> StepBundle:
    window = decode_window(cfg, shape)

    @torch.no_grad()
    def step(params, cache, token):
        return model_lib.decode_step(params, cfg, token, cache,
                                     window=window)

    p_shapes = param_shapes(cfg)
    c_shapes = cache_shapes(cfg, shape)
    t_shape = _meta((shape.global_batch, 1), torch.int32)
    p_specs = shard_lib.param_specs(p_shapes, mesh)
    if two_d_weights:
        p_specs = shard_lib.fully_shard(p_specs, p_shapes, mesh)
    c_specs = shard_lib.cache_specs(c_shapes, mesh)
    t_spec = shard_lib.data_spec(mesh, shape.global_batch, 2)
    logits_spec = shard_lib.data_spec(mesh, shape.global_batch, 2)
    return StepBundle(
        name=f"decode:{cfg.name}:{shape.name}", fn=step,
        args=(p_shapes, c_shapes, t_shape),
        in_shardings=(p_specs, c_specs, t_spec),
        out_shardings=(logits_spec, c_specs), donate_argnums=(1,))
