"""The LM model zoo's dense GQA family (port of ``repro.models.model``).

Public API, as in the reference:

``init_params(gen, cfg, device)``                  → param tree
``train_loss(params, cfg, batch)``                 → (loss, metrics)
``prefill(params, cfg, batch, cache_len, window)`` → (last_logits, cache)
``decode_step(params, cfg, token, cache, window)`` → (logits, cache)
``init_cache(cfg, batch, cache_len, window)``      → zeroed cache tree

Ported: the dense family with GQA attention, ``[attn + MLP] x L``
(llama3-8b, stablelm-1.6b, deepseek-coder-33b). MoE, SSM, hybrid, audio,
VLM and ``attn_type="mla"`` raise ``NotImplementedError`` naming their
ROADMAP item.

What differs from the reference, and why:

* The tree is JAX's: ``params["layers"]`` leaves are stacked ``(L, ...)``,
  so the flat order and ``by_role_partition`` match the reference's. The
  ``lax.scan`` over layers is a Python loop that indexes layer ``i`` (a
  view, no copy).
* Weights are cast to the compute dtype where they are used, one matrix at
  a time, as the reference does. Embedding rows are gathered and then
  cast, which gives the same bits as casting the table first without its
  transient copy.
* ``constrain_activations`` (a no-op without a sharding context) and
  ``_maybe_remat`` (training memory only) are dropped.
* ``cache["index"]`` is a Python int, and ``decode_step`` writes the new
  token's K/V into the cache's tensors in place and returns the same dict
  (the reference returns new arrays), so a step copies no cache.
* Initialisation draws from a ``torch.Generator`` on its own device (a CUDA
  generator draws the full-width weights on the card); the reference's key
  tree cannot be replayed, so parity runs carry its weights across.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.pytree import leaves, tree_map
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_mlp, apply_norm, cast,
                                       cross_entropy_loss, dt, embed_init,
                                       init_mlp, init_norm, pdt)

Params = Dict[str, Any]
Cache = Dict[str, Any]


def _require_dense_gqa(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            "Queue A item 12: MoE, SSM, RG-LRU, audio and VLM each come with "
            "a slice of their own)")
    if cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: attn_type {cfg.attn_type!r} is not ported yet "
            "(ROADMAP Queue A item 12c: MLA)")


def _logits(params: Params, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ cast(head, cfg)


def _layer(params: Params, i: int) -> Params:
    """Layer ``i`` of the stacked ``(L, ...)`` tree, as views."""
    return tree_map(lambda t: t[i], params["layers"])


# =====================================================================
# init
# =====================================================================
def init_params(gen: torch.Generator, cfg: ArchConfig,
                device: DeviceLike = None) -> Params:
    """Draw on ``gen``'s device (embedding, then the stacked layers, then
    the LM head), then move each leaf to ``device``."""
    _require_dense_gqa(cfg)
    dev = resolve(device)
    dtype = pdt(cfg)
    L = (cfg.n_layers,)
    params: Params = {
        "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype),
        "final_norm": init_norm(cfg, device=gen.device),
        "layers": {"ln1": init_norm(cfg, lead=L, device=gen.device),
                   "attn": attn.init_gqa(gen, cfg, lead=L),
                   "ln2": init_norm(cfg, lead=L, device=gen.device),
                   "ffn": init_mlp(gen, cfg, lead=L)},
    }
    if not cfg.tie_embeddings:
        # stored (d_model, vocab) so ``h @ lm_head`` needs no transpose
        params["lm_head"] = embed_init(gen, (cfg.d_model, cfg.padded_vocab),
                                       dtype)
    return tree_map(lambda t: t.to(dev), params)


# =====================================================================
# full-sequence block application (train / prefill)
# =====================================================================
def _dense_block_full(p, x, cfg, positions, window=None):
    """Returns (x, kv_for_cache)."""
    a, kv = attn.gqa_forward(p["attn"], apply_norm(p["ln1"], x, cfg), cfg,
                             positions=positions, mode="causal",
                             window=window)
    x = x + a
    f = apply_mlp(p["ffn"], apply_norm(p["ln2"], x, cfg), cfg)
    return x + f, kv


def _trunk_full(params: Params, h: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, window: Optional[int] = None
                ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor,
                                                    torch.Tensor]]]:
    """Run the stack full-sequence. Returns (h, per-layer (k, v))."""
    kvs = []
    for i in range(cfg.n_layers):
        h, kv = _dense_block_full(_layer(params, i), h, cfg, positions,
                                  window=window)
        kvs.append(kv)
    return h, kvs


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
    _require_dense_gqa(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = _embed_inputs(params, cfg, batch)
    h, _ = _trunk_full(params, h, cfg, _positions(B, S, h.device))
    h = apply_norm(params["final_norm"], h, cfg)
    logits = _logits(params, h, cfg)
    loss, acc = cross_entropy_loss(logits, batch["labels"], cfg.vocab_size)
    return loss, {"ce_loss": loss, "accuracy": acc, "loss": loss}


# =====================================================================
# caches
# =====================================================================
def _attn_cache_zeros(cfg: ArchConfig, lead: Tuple[int, ...], B: int, C: int,
                      ring: bool, device) -> Cache:
    dtype = dt(cfg)
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
    _require_dense_gqa(cfg)
    ring = window is not None and window < cache_len
    C = min(cache_len, window) if ring else cache_len
    return {"index": 0,
            "layers": _attn_cache_zeros(cfg, (cfg.n_layers,), batch, C, ring,
                                        resolve(device))}


def _fill_attn_cache(entry: Cache, kv: Tuple[torch.Tensor, torch.Tensor],
                     prefill_len: int) -> None:
    """Write prefill K/V into one layer's zeroed cache entry (views into
    the stacked cache)."""
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
    _require_dense_gqa(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache_len = cache_len or S
    h = _embed_inputs(params, cfg, batch)
    h, kvs = _trunk_full(params, h, cfg, _positions(B, S, h.device),
                         window=window)
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
    _require_dense_gqa(cfg)
    index = cache["index"]
    h = cast(params["embed"][token], cfg)               # (B, 1, D)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        entry = tree_map(lambda t: t[i], cache["layers"])
        a, _ = attn.gqa_decode(lp["attn"], apply_norm(lp["ln1"], h, cfg),
                               cfg, entry, index, window=window)
        h = h + a
        h = h + apply_mlp(lp["ffn"], apply_norm(lp["ln2"], h, cfg), cfg)
    h = apply_norm(params["final_norm"], h, cfg)
    logits = _logits(params, h, cfg)[:, 0]
    cache["index"] = index + 1
    return logits, cache


def param_count(params: Params) -> int:
    return sum(int(x.numel()) for x in leaves(params))
