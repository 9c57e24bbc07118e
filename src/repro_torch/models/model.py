"""The LM model zoo's dense and MoE families, with GQA or MLA attention
(port of ``repro.models.model``).

Public API, as in the reference:

``init_params(gen, cfg, device)``                  → param tree
``train_loss(params, cfg, batch)``                 → (loss, metrics)
``prefill(params, cfg, batch, cache_len, window)`` → (last_logits, cache)
``decode_step(params, cfg, token, cache, window)`` → (logits, cache)
``init_cache(cfg, batch, cache_len, window)``      → zeroed cache tree

Ported: ``[attn + MLP] x L`` (the dense family: llama3-8b, stablelm-1.6b,
deepseek-coder-33b, and minicpm3-4b with MLA attention) and ``[attn + MoE]
x L`` (the MoE family: dbrx-132b, llama4-maverick-400b-a17b), where attn
is GQA or MLA. SSM, hybrid (RG-LRU), audio and VLM raise
``NotImplementedError`` naming their ROADMAP item.

What differs from the reference, and why:

* The tree is JAX's: ``params["layers"]`` leaves are stacked ``(L, ...)``,
  so the flat order and ``by_role_partition`` match the reference's. The
  ``lax.scan`` over layers is a Python loop that indexes layer ``i`` (a
  view, no copy).
* Weights are cast to the compute dtype where they are used, one matrix at
  a time, as the reference does. Embedding rows are gathered and then
  cast, which gives the same bits as casting the table first without its
  transient copy.
* ``constrain_activations`` (a no-op without a sharding context) is
  dropped. ``_maybe_remat`` is per layer: where ``cfg.remat`` is set, the
  trunk is run for training and autograd is recording, each layer of the
  loop runs under ``torch.utils.checkpoint.checkpoint(...,
  use_reentrant=False)`` — ``jax.checkpoint`` with ``nothing_saveable`` at
  layer granularity: only the layer's inputs are kept, its activations
  are recomputed in the backward pass, and the gradients are the same
  bits. Prefill and evaluation (no autograd) never checkpoint.
* ``cache["index"]`` is a Python int, and ``decode_step`` writes the new
  token's K/V (or MLA latents) into the cache's tensors in place and
  returns the same dict (the reference returns new arrays), so a step
  copies no cache.
* Initialisation draws from a ``torch.Generator`` on its own device (a CUDA
  generator draws the full-width weights on the card); the reference's key
  tree cannot be replayed, so parity runs carry its weights across.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.pytree import leaves, tree_map
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (apply_mlp, apply_norm, cast,
                                       cross_entropy_loss, dt, embed_init,
                                       init_mlp, init_norm, pdt)

Params = Dict[str, Any]
Cache = Dict[str, Any]


# where each family that is not ported yet will be
_LATER = {"ssm": "11e: SSM", "hybrid": "11f: RG-LRU",
          "audio": "11g: audio", "vlm": "11h: VLM"}


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        item = _LATER.get(cfg.family, "11")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"Queue A item {item})")
    if cfg.attn_type not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.name}: attn_type {cfg.attn_type!r} is not ported (only "
            "gqa and mla)")


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


def _layer(params: Params, i: int) -> Params:
    """Layer ``i`` of the stacked ``(L, ...)`` tree, as views."""
    return tree_map(lambda t: t[i], params["layers"])


# =====================================================================
# init
# =====================================================================
def _init_attn(gen: torch.Generator, cfg: ArchConfig,
               lead: Tuple[int, ...]) -> Params:
    if cfg.attn_type == "mla":
        return attn.init_mla(gen, cfg, lead=lead)
    return attn.init_gqa(gen, cfg, lead=lead)


def init_params(gen: torch.Generator, cfg: ArchConfig,
                device: DeviceLike = None) -> Params:
    """Draw on ``gen``'s device (embedding, then the stacked layers, then
    the LM head), then move each leaf to ``device``."""
    _require_ported(cfg)
    dev = resolve(device)
    dtype = pdt(cfg)
    L = (cfg.n_layers,)
    params: Params = {
        "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype),
        "final_norm": init_norm(cfg, device=gen.device),
        "layers": {"ln1": init_norm(cfg, lead=L, device=gen.device),
                   "attn": _init_attn(gen, cfg, L),
                   "ln2": init_norm(cfg, lead=L, device=gen.device),
                   "ffn": (moe_lib.init_moe(gen, cfg, lead=L)
                           if cfg.family == "moe"
                           else init_mlp(gen, cfg, lead=L))},
    }
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
    """Returns (x, kv_for_cache, moe_aux) — ``moe_aux`` a float32 scalar,
    zero outside the MoE family."""
    a, kv = _attn_full(p["attn"], apply_norm(p["ln1"], x, cfg), cfg,
                       positions, window=window)
    x = x + a
    h = apply_norm(p["ln2"], x, cfg)
    if cfg.family == "moe":
        f, aux = moe_lib.apply_moe(p["ffn"], h, cfg,
                                   _group_size(h.shape[0] * h.shape[1]))
        return x + f, kv, aux["moe_aux"]
    return (x + apply_mlp(p["ffn"], h, cfg), kv,
            torch.zeros((), dtype=torch.float32, device=x.device))


def _remat_block(p, x, cfg, positions):
    """A training layer without its cache entry, the unit that remat
    checkpoints."""
    x, _, aux = _dense_block_full(p, x, cfg, positions)
    return x, aux


def _trunk_full(params: Params, h: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, *, train: bool,
                window: Optional[int] = None
                ) -> Tuple[torch.Tensor, List[Any], torch.Tensor]:
    """Run the stack full-sequence. Returns (h, per-layer cache entries —
    GQA ``(k, v)`` or MLA ``(c_kv, k_rope)``, None under remat — and the
    float32 ``moe_aux`` summed over layers)."""
    remat = cfg.remat and train and torch.is_grad_enabled()
    kvs = []
    aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        if remat:
            h, aux = checkpoint(_remat_block, lp, h, cfg, positions,
                                use_reentrant=False)
            kv = None
        else:
            h, kv, aux = _dense_block_full(lp, h, cfg, positions,
                                           window=window)
        aux_sum = aux_sum + aux
        kvs.append(kv)
    return h, kvs, aux_sum


def _embed_inputs(params: Params, cfg: ArchConfig,
                  batch: Dict[str, Any]) -> torch.Tensor:
    return cast(params["embed"][batch["tokens"]], cfg)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


# =====================================================================
# training
# =====================================================================
def train_loss(params: Params, cfg: ArchConfig, batch: Dict[str, Any]
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    _require_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = _embed_inputs(params, cfg, batch)
    h, _, aux = _trunk_full(params, h, cfg, _positions(B, S, h.device),
                            train=True)
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
    caches."""
    _require_ported(cfg)
    ring = window is not None and window < cache_len
    C = min(cache_len, window) if ring else cache_len
    return {"index": 0,
            "layers": _attn_cache_zeros(cfg, (cfg.n_layers,), batch, C, ring,
                                        resolve(device))}


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
    the prompt length (cache exactly full after prefill).
    """
    _require_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache_len = cache_len or S
    h = _embed_inputs(params, cfg, batch)
    h, kvs, _ = _trunk_full(params, h, cfg, _positions(B, S, h.device),
                            train=False, window=window)
    h = apply_norm(params["final_norm"], h[:, -1:], cfg)
    logits = _logits(params, h, cfg)[:, 0]

    cache = init_cache(cfg, B, cache_len, window, device=h.device)
    for i, kv in enumerate(kvs):
        _fill_attn_cache(tree_map(lambda t: t[i], cache["layers"]), kv, S)
    cache["index"] = S
    return logits, cache


# =====================================================================
# decode
# =====================================================================
def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                cache: Cache, window: Optional[int] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode. token: (B, 1) integer. Returns (logits (B, V),
    cache), the cache updated in place."""
    _require_ported(cfg)
    index = cache["index"]
    h = cast(params["embed"][token], cfg)               # (B, 1, D)
    B = token.shape[0]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        entry = tree_map(lambda t: t[i], cache["layers"])
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
    h = apply_norm(params["final_norm"], h, cfg)
    logits = _logits(params, h, cfg)[:, 0]
    cache["index"] = index + 1
    return logits, cache


def param_count(params: Params) -> int:
    return sum(int(x.numel()) for x in leaves(params))
