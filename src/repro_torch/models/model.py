"""The LM model zoo: one functional LM covering all six families (port of
``repro.models.model``).

Public API, as in the reference:

``init_params(gen, cfg, device)``                  → param tree
``train_loss(params, cfg, batch)``                 → (loss, metrics)
``prefill(params, cfg, batch, cache_len, window)`` → (last_logits, cache)
``decode_step(params, cfg, token, cache, window)`` → (logits, cache)
``init_cache(cfg, batch, cache_len, window)``      → zeroed cache tree

Families and their block stacks:

* dense / vlm : [GQA|MLA attn + MLP] x L   (vlm: image embeddings merged
  at positions ``0 … n_image_tokens-1``)
* moe         : [GQA attn + MoE] x L
* ssm         : [Mamba-2 mixer] x L        (``models/ssm.py``)
* hybrid      : [(RG-LRU, RG-LRU, local attn) + MLP each] x L/3, then the
  remaining RG-LRU layers as ``tail`` (``models/rglru.py``)
* audio       : encoder [bidirectional attn + MLP] x Le over
  ``batch["frames"]``, decoder [self + cross attn + MLP] x Ld

What differs from the reference, and why:

* The tree is JAX's: every stack's leaves are stacked ``(L, ...)``
  (``layers``; the hybrid's groups of ``sub0``-``sub2`` and its ``tail``;
  the audio encoder's ``enc_layers``), so the flat order and
  ``by_role_partition`` match the reference's. The ``lax.scan`` over a
  stack is a Python loop that indexes layer ``i`` (a view, no copy).
* Weights are cast to the compute dtype where they are used, one matrix at
  a time, as the reference does. Embedding rows are gathered and then
  cast, which gives the same bits as casting the table first without its
  transient copy. The VLM's image embeddings replace the first rows with
  ``torch.cat`` (the reference's ``dynamic_update_slice``), out of place,
  so the gradient reaches the token embeddings after them.
* ``constrain_activations`` (``models/partition_ctx.py``) is called where
  the reference calls it; it is the identity on a plain tensor and
  redistributes a ``DTensor`` residual stream inside a sharding context.
  ``_maybe_remat`` is per unit of a stack: where ``cfg.remat`` is
  set, the trunk is run for training and autograd is recording, each
  layer (each hybrid group and tail layer, each encoder and decoder layer)
  runs under ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``
  — ``jax.checkpoint`` with ``nothing_saveable`` at that granularity: only
  its inputs are kept, its activations are recomputed in the backward
  pass, and the gradients are the same bits. Prefill and evaluation (no
  autograd) never checkpoint.
* ``cache["index"]`` is a Python int, and ``decode_step`` writes the new
  token's K/V (or MLA latents) and the new recurrent states (SSM, RG-LRU)
  into the cache's tensors in place and returns the same dict (the
  reference returns new arrays), so a step copies no cache.
* Initialisation draws from a ``torch.Generator`` on its own device (a CUDA
  generator draws the full-width weights on the card); the reference's key
  tree cannot be replayed, so parity runs carry its weights across.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.pytree import leaves, stack, tree_map
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (apply_mlp, apply_norm, cast,
                                       cross_entropy_loss, dt, embed_init,
                                       init_mlp, init_norm, pdt)
from repro_torch.models.partition_ctx import constrain_activations

Params = Dict[str, Any]
Cache = Dict[str, Any]


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal position encoding; positions (B, S) -> (B, S, d), in
    float32 as the reference computes it."""
    half = d // 2
    f32 = torch.float32
    freqs = torch.exp(-torch.log(torch.tensor(10000.0, dtype=f32))
                      * torch.arange(half, dtype=f32) / max(half - 1, 1))
    ang = positions[..., None].to(f32) * freqs.to(positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _group_size(n_tokens: int) -> int:
    """MoE group size: divides n_tokens, <= 1024, prefers >= 16 groups."""
    for gs in range(min(1024, n_tokens), 0, -1):
        if n_tokens % gs == 0 and (n_tokens // gs >= 16 or gs == n_tokens):
            if n_tokens // gs >= 16:
                return gs
    for gs in range(min(1024, n_tokens), 0, -1):
        if n_tokens % gs == 0:
            return gs
    return n_tokens


def _logits(params: Params, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ cast(head, cfg)


def _at(stacked: Any, i: int) -> Any:
    """Entry ``i`` of a stacked ``(L, ...)`` tree, as views."""
    return tree_map(lambda t: t[i], stacked)


def _layer(params: Params, i: int) -> Params:
    """Layer ``i`` of the stacked ``(L, ...)`` tree, as views."""
    return _at(params["layers"], i)


def _n_stack(stacked: Any) -> int:
    return int(leaves(stacked)[0].shape[0])


def _hybrid_counts(cfg: ArchConfig) -> Tuple[int, int]:
    """(groups of ``cfg.rglru.pattern``, trailing RG-LRU layers)."""
    return divmod(cfg.n_layers, len(cfg.rglru.pattern))


# =====================================================================
# init
# =====================================================================
def _init_attn(gen: torch.Generator, cfg: ArchConfig,
               lead: Tuple[int, ...]) -> Params:
    if cfg.attn_type == "mla":
        return attn.init_mla(gen, cfg, lead=lead)
    return attn.init_gqa(gen, cfg, lead=lead)


def _init_dense_block(gen, cfg: ArchConfig, lead) -> Params:
    dev = gen.device
    return {"ln1": init_norm(cfg, lead=lead, device=dev),
            "attn": _init_attn(gen, cfg, lead),
            "ln2": init_norm(cfg, lead=lead, device=dev),
            "ffn": (moe_lib.init_moe(gen, cfg, lead=lead)
                    if cfg.family == "moe" else init_mlp(gen, cfg, lead=lead))}


def _init_hybrid_sub(gen, cfg: ArchConfig, kind: str, lead) -> Params:
    dev = gen.device
    mixer = (rglru_lib.init_rglru_block(gen, cfg, lead=lead)
             if kind == "rglru" else attn.init_gqa(gen, cfg, lead=lead))
    return {"ln1": init_norm(cfg, lead=lead, device=dev), "mixer": mixer,
            "ln2": init_norm(cfg, lead=lead, device=dev),
            "mlp": init_mlp(gen, cfg, lead=lead)}


def _init_enc_block(gen, cfg: ArchConfig, lead) -> Params:
    dev = gen.device
    return {"ln1": init_norm(cfg, lead=lead, device=dev),
            "attn": attn.init_gqa(gen, cfg, lead=lead),
            "ln2": init_norm(cfg, lead=lead, device=dev),
            "ffn": init_mlp(gen, cfg, lead=lead)}


def _init_dec_block(gen, cfg: ArchConfig, lead) -> Params:
    dev = gen.device
    return {"ln1": init_norm(cfg, lead=lead, device=dev),
            "self_attn": attn.init_gqa(gen, cfg, lead=lead),
            "ln_x": init_norm(cfg, lead=lead, device=dev),
            "cross_attn": attn.init_gqa(gen, cfg, lead=lead),
            "ln2": init_norm(cfg, lead=lead, device=dev),
            "ffn": init_mlp(gen, cfg, lead=lead)}


def init_params(gen: torch.Generator, cfg: ArchConfig,
                device: DeviceLike = None) -> Params:
    """Draw on ``gen``'s device (embedding, then the stacks, then the LM
    head), then move each leaf to ``device``."""
    dev = resolve(device)
    dtype = pdt(cfg)
    L = (cfg.n_layers,)
    params: Params = {
        "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype),
        "final_norm": init_norm(cfg, device=gen.device),
    }
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        params["layers"] = _init_dense_block(gen, cfg, L)
    elif fam == "ssm":
        params["layers"] = {"ln": init_norm(cfg, lead=L, device=gen.device),
                            "mixer": ssm_lib.init_mamba2(gen, cfg, lead=L)}
    elif fam == "hybrid":
        n_groups, n_tail = _hybrid_counts(cfg)
        params["layers"] = {
            f"sub{i}": _init_hybrid_sub(gen, cfg, kind, (n_groups,))
            for i, kind in enumerate(cfg.rglru.pattern)}
        if n_tail:
            params["tail"] = _init_hybrid_sub(gen, cfg, "rglru", (n_tail,))
    elif fam == "audio":
        params["enc_layers"] = _init_enc_block(
            gen, cfg, (cfg.encdec.n_encoder_layers,))
        params["enc_norm"] = init_norm(cfg, device=gen.device)
        params["layers"] = _init_dec_block(gen, cfg, L)
    else:
        raise ValueError(f"unknown family {fam}")
    if not cfg.tie_embeddings:
        # stored (d_model, vocab) so ``h @ lm_head`` needs no transpose
        params["lm_head"] = embed_init(gen, (cfg.d_model, cfg.padded_vocab),
                                       dtype)
    return tree_map(lambda t: t.to(dev), params)


# =====================================================================
# full-sequence block application (train / prefill)
# =====================================================================
def _attn_full(p, x, cfg, positions, mode="causal", window=None):
    if cfg.attn_type == "mla":
        return attn.mla_forward(p, x, cfg, positions=positions, mode=mode,
                                window=window)
    return attn.gqa_forward(p, x, cfg, positions=positions, mode=mode,
                            window=window)


def _dense_block_full(p, x, cfg, positions, window=None):
    """Returns (x, (kv_for_cache, moe_aux)) — ``moe_aux`` a float32
    scalar, zero outside the MoE family."""
    x = constrain_activations(x)
    a, kv = _attn_full(p["attn"], apply_norm(p["ln1"], x, cfg), cfg,
                       positions, window=window)
    x = constrain_activations(x + a)
    h = apply_norm(p["ln2"], x, cfg)
    if cfg.family == "moe":
        f, aux = moe_lib.apply_moe(p["ffn"], h, cfg,
                                   _group_size(h.shape[0] * h.shape[1]))
        return x + f, (kv, aux["moe_aux"])
    return (x + apply_mlp(p["ffn"], h, cfg),
            (kv, torch.zeros((), dtype=torch.float32, device=x.device)))


def _ssm_block_full(p, x, cfg):
    x = constrain_activations(x)
    m, state = ssm_lib.mamba2_forward(p["mixer"],
                                      apply_norm(p["ln"], x, cfg), cfg)
    return x + m, state


def _hybrid_sub_full(p, x, cfg, positions, kind):
    x = constrain_activations(x)
    h = apply_norm(p["ln1"], x, cfg)
    if kind == "rglru":
        m, state = rglru_lib.rglru_forward(p["mixer"], h, cfg)
    else:
        m, state = attn.gqa_forward(p["mixer"], h, cfg, positions=positions,
                                    mode="window", window=cfg.rglru.window)
    x = x + m
    x = x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)
    return x, state


def _hybrid_group_full(gp, x, cfg, positions):
    states = {}
    for i, kind in enumerate(cfg.rglru.pattern):
        x, states[f"sub{i}"] = _hybrid_sub_full(gp[f"sub{i}"], x, cfg,
                                                positions, kind)
    return x, states


def _dec_block_full(lp, x, cfg, positions, window, enc_out):
    x = constrain_activations(x)
    a, kv = attn.gqa_forward(lp["self_attn"], apply_norm(lp["ln1"], x, cfg),
                             cfg, positions=positions, mode="causal",
                             window=window)
    x = x + a
    c, cross_kv = attn.gqa_forward(
        lp["cross_attn"], apply_norm(lp["ln_x"], x, cfg), cfg,
        positions=None, mode="full", kv_x=enc_out, kv_positions=None)
    x = x + c
    x = x + apply_mlp(lp["ffn"], apply_norm(lp["ln2"], x, cfg), cfg)
    return x, {"self": kv, "cross": cross_kv}


def _enc_block_full(lp, x, cfg):
    x = constrain_activations(x)
    a, _ = attn.gqa_forward(lp["attn"], apply_norm(lp["ln1"], x, cfg), cfg,
                            positions=None, mode="full")
    x = x + a
    x = x + apply_mlp(lp["ffn"], apply_norm(lp["ln2"], x, cfg), cfg)
    return x, None


def _remat_unit(block: Callable, p, x, *args):
    """A training unit of a stack (the unit that remat checkpoints), its
    output cut to what training reads: the dense block's ``moe_aux``, no
    cache entry."""
    x, out = block(p, x, *args)
    return x, ((None, out[1]) if block is _dense_block_full else None)


def _run_stack(block: Callable, stacked: Params, h: torch.Tensor,
               remat: bool, *args) -> Tuple[torch.Tensor, List[Any]]:
    """``block(p_i, h, *args) -> (h, out_i)`` over a stacked tree (the
    reference's ``lax.scan``); under remat each unit is checkpointed and
    its ``out_i`` cut by :func:`_remat_unit`."""
    outs = []
    for i in range(_n_stack(stacked)):
        if remat:
            h, out = checkpoint(_remat_unit, block, _at(stacked, i), h,
                                *args, use_reentrant=False)
        else:
            h, out = block(_at(stacked, i), h, *args)
        outs.append(out)
    return h, outs


def _trunk_full(params: Params, h: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, *, train: bool,
                enc_out: Optional[torch.Tensor] = None,
                window: Optional[int] = None
                ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Run the main stack full-sequence. Returns (h, per-layer cache
    outputs — a list a stack, None under remat — and the float32
    ``moe_aux`` summed over layers)."""
    remat = cfg.remat and train and torch.is_grad_enabled()
    fam = cfg.family
    aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    if fam in ("dense", "moe", "vlm"):
        h, outs = _run_stack(_dense_block_full, params["layers"], h, remat,
                             cfg, positions, window)
        for _, aux in outs:
            aux_sum = aux_sum + aux
        return h, [kv for kv, _ in outs], aux_sum
    if fam == "ssm":
        h, states = _run_stack(_ssm_block_full, params["layers"], h, remat,
                               cfg)
        return h, states, aux_sum
    if fam == "hybrid":
        h, groups = _run_stack(_hybrid_group_full, params["layers"], h,
                               remat, cfg, positions)
        tail = None
        if "tail" in params:
            h, tail = _run_stack(_hybrid_sub_full, params["tail"], h,
                                 remat, cfg, positions, "rglru")
        return h, {"groups": groups, "tail": tail}, aux_sum
    if fam == "audio":
        h, kvs = _run_stack(_dec_block_full, params["layers"], h, remat,
                            cfg, positions, window, enc_out)
        return h, kvs, aux_sum
    raise ValueError(fam)


def _encode_audio(params: Params, frames: torch.Tensor, cfg: ArchConfig,
                  train: bool) -> torch.Tensor:
    """Whisper encoder over precomputed (stub-frontend) frame embeddings."""
    B, Fr, _ = frames.shape
    h = frames.to(dt(cfg))
    h = h + _sinusoid(_positions(B, Fr, h.device), cfg.d_model).to(h.dtype)
    remat = cfg.remat and train and torch.is_grad_enabled()
    h, _ = _run_stack(_enc_block_full, params["enc_layers"], h, remat, cfg)
    return apply_norm(params["enc_norm"], h, cfg)


def _embed_inputs(params: Params, cfg: ArchConfig, batch: Dict[str, Any],
                  positions: torch.Tensor) -> torch.Tensor:
    if "h0" in batch:
        # precomputed input embeddings: the FL round computes the token
        # gather with the embedding detached (core/distributed.py)
        return batch["h0"].to(dt(cfg))
    h = cast(params["embed"][batch["tokens"]], cfg)
    if cfg.family == "vlm" and "image_embeds" in batch:
        img = batch["image_embeds"].to(h.dtype)
        h = torch.cat([img, h[:, img.shape[1]:]], dim=1)
    if cfg.family == "audio":
        h = h + _sinusoid(positions, cfg.d_model).to(h.dtype)
    return h


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


def _encoded(params, cfg, batch, train: bool) -> Optional[torch.Tensor]:
    if cfg.family != "audio":
        return None
    return _encode_audio(params, batch["frames"], cfg, train)


# =====================================================================
# training
# =====================================================================
def train_loss(params: Params, cfg: ArchConfig, batch: Dict[str, Any]
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    h = _embed_inputs(params, cfg, batch, positions)
    h, _, aux = _trunk_full(params, h, cfg, positions, train=True,
                            enc_out=_encoded(params, cfg, batch, True))
    h = apply_norm(params["final_norm"], h, cfg)
    logits = _logits(params, h, cfg)
    loss, acc = cross_entropy_loss(logits, batch["labels"], cfg.vocab_size)
    metrics = {"ce_loss": loss, "accuracy": acc}
    total = loss
    if cfg.family == "moe":
        total = total + aux
        metrics["moe_aux"] = aux
    metrics["loss"] = total
    return total, metrics


# =====================================================================
# caches
# =====================================================================
def _attn_cache_zeros(cfg: ArchConfig, lead: Tuple[int, ...], B: int, C: int,
                      ring: bool, device) -> Cache:
    dtype = dt(cfg)
    if cfg.attn_type == "mla":
        m = cfg.mla
        return {"c_kv": torch.zeros((*lead, B, C, m.kv_lora_rank),
                                    dtype=dtype, device=device),
                "k_rope": torch.zeros((*lead, B, C, m.qk_rope_head_dim),
                                      dtype=dtype, device=device)}
    shape = (*lead, B, C, cfg.n_kv_heads, cfg.head_dim)
    c = {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
    if ring:
        c["pos"] = torch.full((*lead, B, C), -1, dtype=torch.int32,
                              device=device)
    return c


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               window: Optional[int] = None,
               device: DeviceLike = None) -> Cache:
    """Zeroed decode cache; ``window < cache_len`` → ring (sliding)
    caches. The hybrid's local-attention sub-layers take a ring of
    ``min(cfg.rglru.window, cache_len)`` whatever ``window`` is."""
    dev = resolve(device)
    ring = window is not None and window < cache_len
    C = min(cache_len, window) if ring else cache_len
    L = (cfg.n_layers,)
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        layers = _attn_cache_zeros(cfg, L, batch, C, ring, dev)
    elif fam == "ssm":
        layers = ssm_lib.init_mamba2_state(cfg, batch, lead=L, device=dev)
    elif fam == "hybrid":
        n_groups, n_tail = _hybrid_counts(cfg)
        W = cfg.rglru.window
        layers = {f"sub{i}": (
            rglru_lib.init_rglru_state(cfg, batch, (n_groups,), dev)
            if kind == "rglru" else _attn_cache_zeros(
                cfg, (n_groups,), batch, min(W, cache_len), cache_len > W,
                dev))
            for i, kind in enumerate(cfg.rglru.pattern)}
        if n_tail:
            return {"index": 0, "layers": layers,
                    "tail": rglru_lib.init_rglru_state(cfg, batch, (n_tail,),
                                                       dev)}
    elif fam == "audio":
        cross = (*L, batch, cfg.encdec.n_frames, cfg.n_kv_heads,
                 cfg.head_dim)
        layers = {"self": _attn_cache_zeros(cfg, L, batch, C, ring, dev),
                  "cross": {"k": torch.zeros(cross, dtype=dt(cfg),
                                             device=dev),
                            "v": torch.zeros(cross, dtype=dt(cfg),
                                             device=dev)}}
    else:
        raise ValueError(f"unknown family {fam}")
    return {"index": 0, "layers": layers}


def _fill_attn_cache(entry: Cache, kv: Tuple[torch.Tensor, torch.Tensor],
                     prefill_len: int) -> None:
    """Write prefill K/V (or MLA latents) into one layer's zeroed cache
    entry (views into the stacked cache)."""
    if "c_kv" in entry:                       # MLA: the last ``take`` tokens
        c_kv, k_rope = kv
        take = min(prefill_len, entry["c_kv"].shape[1])
        entry["c_kv"][:, :take] = c_kv[:, -take:].to(entry["c_kv"].dtype)
        entry["k_rope"][:, :take] = k_rope[:, -take:].to(
            entry["k_rope"].dtype)
        return
    k, v = kv
    C = entry["k"].shape[1]
    take = min(prefill_len, C)
    if "pos" in entry:                        # ring: slot = pos % C
        pos = torch.arange(prefill_len - take, prefill_len,
                           device=k.device)
        slots = pos % C
        entry["k"][:, slots] = k[:, -take:].to(entry["k"].dtype)
        entry["v"][:, slots] = v[:, -take:].to(entry["v"].dtype)
        entry["pos"][:, slots] = pos.to(torch.int32)[None, :]
    else:                                     # the last ``take`` tokens
        entry["k"][:, :take] = k[:, -take:].to(entry["k"].dtype)
        entry["v"][:, :take] = v[:, -take:].to(entry["v"].dtype)


# =====================================================================
# prefill
# =====================================================================
def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, Any],
            cache_len: Optional[int] = None,
            window: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence forward that also builds the decode cache.

    Returns (last-position logits (B, V), cache). ``cache_len`` defaults to
    the prompt length (cache exactly full after prefill). Recurrent states
    (SSM, RG-LRU) are the forward's final states, stacked, as the
    reference's cache holds them.
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache_len = cache_len or S
    positions = _positions(B, S, tokens.device)
    h = _embed_inputs(params, cfg, batch, positions)
    h, out, _ = _trunk_full(params, h, cfg, positions, train=False,
                            enc_out=_encoded(params, cfg, batch, False),
                            window=window)
    h = apply_norm(params["final_norm"], h[:, -1:], cfg)
    logits = _logits(params, h, cfg)[:, 0]

    fam = cfg.family
    if fam == "ssm":
        return logits, {"index": S, "layers": stack(out)}
    cache = init_cache(cfg, B, cache_len, window, device=h.device)
    cache["index"] = S
    if fam in ("dense", "moe", "vlm"):
        for i, kv in enumerate(out):
            _fill_attn_cache(_at(cache["layers"], i), kv, S)
    elif fam == "hybrid":
        for i, kind in enumerate(cfg.rglru.pattern):
            key = f"sub{i}"
            if kind == "rglru":
                cache["layers"][key] = stack([g[key] for g in out["groups"]])
            else:
                for gi, g in enumerate(out["groups"]):
                    _fill_attn_cache(_at(cache["layers"][key], gi), g[key],
                                     S)
        if out["tail"] is not None:
            cache["tail"] = stack(out["tail"])
    elif fam == "audio":
        for i, kv in enumerate(out):
            _fill_attn_cache(_at(cache["layers"]["self"], i), kv["self"], S)
        cache["layers"]["cross"] = {
            name: torch.stack([kv["cross"][j] for kv in out]).to(dt(cfg))
            for j, name in enumerate(("k", "v"))}
    return logits, cache


# =====================================================================
# decode
# =====================================================================
def _write_state(entry: Cache, new: Cache) -> None:
    for k, t in new.items():
        entry[k].copy_(t)


def _hybrid_sub_decode(sp, x, cfg, st, index, kind):
    hh = apply_norm(sp["ln1"], x, cfg)
    if kind == "rglru":
        m, new = rglru_lib.rglru_decode(sp["mixer"], hh, cfg, st)
        _write_state(st, new)
    else:
        m, _ = attn.gqa_decode(sp["mixer"], hh, cfg, st, index,
                               window=cfg.rglru.window)
    x = x + m
    return x + apply_mlp(sp["mlp"], apply_norm(sp["ln2"], x, cfg), cfg)


def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                cache: Cache, window: Optional[int] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode. token: (B, 1) integer. Returns (logits (B, V),
    cache), the cache updated in place."""
    index = cache["index"]
    h = cast(params["embed"][token], cfg)               # (B, 1, D)
    B = token.shape[0]
    fam = cfg.family
    if fam == "audio":
        pos = torch.full((B, 1), index, dtype=torch.int64, device=h.device)
        h = h + _sinusoid(pos, cfg.d_model).to(h.dtype)

    if fam in ("dense", "moe", "vlm"):
        for i in range(cfg.n_layers):
            lp, entry = _layer(params, i), _at(cache["layers"], i)
            hh = apply_norm(lp["ln1"], h, cfg)
            if cfg.attn_type == "mla":
                a, _ = attn.mla_decode(lp["attn"], hh, cfg, entry, index)
            else:
                a, _ = attn.gqa_decode(lp["attn"], hh, cfg, entry, index,
                                       window=window)
            h = h + a
            hh = apply_norm(lp["ln2"], h, cfg)
            if cfg.family == "moe":
                f, _ = moe_lib.apply_moe(lp["ffn"], hh, cfg, _group_size(B))
            else:
                f = apply_mlp(lp["ffn"], hh, cfg)
            h = h + f
    elif fam == "ssm":
        for i in range(cfg.n_layers):
            lp, entry = _layer(params, i), _at(cache["layers"], i)
            m, new = ssm_lib.mamba2_decode(
                lp["mixer"], apply_norm(lp["ln"], h, cfg), cfg, entry)
            _write_state(entry, new)
            h = h + m
    elif fam == "hybrid":
        n_groups, _ = _hybrid_counts(cfg)
        for g in range(n_groups):
            gp, gst = _layer(params, g), _at(cache["layers"], g)
            for i, kind in enumerate(cfg.rglru.pattern):
                h = _hybrid_sub_decode(gp[f"sub{i}"], h, cfg, gst[f"sub{i}"],
                                       index, kind)
        if "tail" in cache:
            for i in range(_n_stack(params["tail"])):
                h = _hybrid_sub_decode(_at(params["tail"], i), h, cfg,
                                       _at(cache["tail"], i), index, "rglru")
    elif fam == "audio":
        for i in range(cfg.n_layers):
            lp, entry = _layer(params, i), _at(cache["layers"], i)
            a, _ = attn.gqa_decode(lp["self_attn"],
                                   apply_norm(lp["ln1"], h, cfg), cfg,
                                   entry["self"], index, window=window)
            h = h + a
            hh = apply_norm(lp["ln_x"], h, cfg)
            q = (hh @ cast(lp["cross_attn"]["wq"], cfg)).reshape(
                B, 1, cfg.n_heads, cfg.head_dim)
            c = attn.decode_attention(q, entry["cross"]["k"],
                                      entry["cross"]["v"],
                                      index=10 ** 9)   # all frames visible
            c = c.reshape(B, 1, cfg.n_heads * cfg.head_dim)
            h = h + c @ cast(lp["cross_attn"]["wo"], cfg)
            h = h + apply_mlp(lp["ffn"], apply_norm(lp["ln2"], h, cfg), cfg)
    else:
        raise ValueError(fam)
    h = apply_norm(params["final_norm"], h, cfg)
    logits = _logits(params, h, cfg)[:, 0]
    cache["index"] = index + 1
    return logits, cache


def param_count(params: Params) -> int:
    return sum(int(x.numel()) for x in leaves(params))
