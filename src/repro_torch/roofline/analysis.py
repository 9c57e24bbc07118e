"""Roofline terms on the H100's constants (port of
``repro.roofline.analysis``).

Terms per (arch x shape x mesh), in seconds:

  compute    = FLOPs_per_device / PEAK_FLOPS_BF16
  memory     = HBM_bytes_per_device / HBM_BW
  collective = in-pod collective bytes / NVLINK_BW
               + cross-pod bytes / CROSS_NODE_BW

with the constants of ``launch/mesh.py`` (NVIDIA's H100 SXM5 80GB sheet).
The reference reads its inputs from XLA's compiled HLO; PyTorch has no
HLO, so ``roofline/cost.py`` takes them from the step itself (FLOPs
counted on meta tensors, bytes from the partition specs, collective
bytes from what the step hands to ``torch.distributed``). What only XLA
gives — the fused-attention memory term (``memory_fused_ms``, the
attention loop's bytes) — is left out of the row and named in its
``left_out`` entry. ``active_params``, ``attention_flops``,
``model_flops`` and ``decode_agg_roofline`` are the reference's
arithmetic; only ``decode_agg_roofline``'s machine block (and with it the
intensities' placement on the roof) moves with the constants.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.launch.mesh import (CROSS_NODE_BW, HBM_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16)

LEFT_OUT = ("memory_fused_ms", "attn_loop_bytes")


@dataclasses.dataclass
class RooflineReport:
    name: str
    n_devices: int
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, float]
    peak_memory_per_device: float
    model_flops: float                  # 6*N*D (or mode-appropriate)
    cross_pod_bytes_per_device: float = 0.0
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def __post_init__(self):
        self.compute_s = self.flops_per_device / PEAK_FLOPS_BF16
        self.memory_s = self.hbm_bytes_per_device / HBM_BW
        in_pod = self.collective_bytes_per_device \
            - self.cross_pod_bytes_per_device
        self.collective_s = (in_pod / NVLINK_BW
                             + self.cross_pod_bytes_per_device
                             / CROSS_NODE_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else 0.0

    def row(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "devices": self.n_devices,
            "compute_ms": round(self.compute_s * 1e3, 3),
            "memory_ms": round(self.memory_s * 1e3, 3),
            "collective_ms": round(self.collective_s * 1e3, 3),
            "dominant": self.dominant,
            "hbm_gb_per_dev": round(self.peak_memory_per_device / 2**30, 2),
            "model_flops_frac": round(self.useful_flops_fraction, 3),
            "collective_gb_per_dev": round(
                self.collective_bytes_per_device / 2**30, 4),
            "cross_pod_gb_per_dev": round(
                self.cross_pod_bytes_per_device / 2**30, 6),
            "left_out": list(LEFT_OUT),
        }


# =====================================================================
# MODEL_FLOPS estimates (6·N·D dense / 6·N_active·D MoE)
# =====================================================================
def active_params(cfg) -> float:
    """Approximate active parameter count per token."""
    D, L, V = cfg.d_model, cfg.n_layers, cfg.padded_vocab
    emb = V * D * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "ssm":
        s = cfg.ssm
        d_in = s.expand * D
        nh = d_in // s.head_dim
        per_layer = D * (2 * d_in + 2 * s.n_groups * s.d_state + nh) \
            + d_in * D
        return emb + L * per_layer
    if cfg.attn_type == "mla":
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        attn = (D * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qk
                + D * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * cfg.n_heads
                * (m.qk_nope_head_dim + m.v_head_dim)
                + cfg.n_heads * m.v_head_dim * D)
    else:
        attn = D * (cfg.n_heads * cfg.head_dim) * 2 \
            + D * (cfg.n_kv_heads * cfg.head_dim) * 2
    if cfg.family == "moe":
        moe = cfg.moe
        ff = 3 * D * moe.d_ff_expert * moe.top_k
        if moe.shared_expert:
            ff += 3 * D * moe.d_ff_expert
        ff += D * moe.n_experts                      # router
    else:
        n_mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
        ff = n_mats * D * cfg.d_ff if cfg.d_ff else 0
    per_layer = attn + ff
    if cfg.family == "hybrid":
        rg = cfg.rglru
        W = rg.lru_width
        rec = D * W * 2 + 2 * W * W + W * D          # rglru block
        n_rec = sum(1 for k in cfg.rglru.pattern if k == "rglru")
        plen = len(cfg.rglru.pattern)
        frac_attn = (plen - n_rec) / plen
        per_layer = frac_attn * (attn + ff) + (1 - frac_attn) * (rec + ff)
    total_layers = L
    if cfg.family == "audio":
        total_layers = L + cfg.encdec.n_encoder_layers
        per_layer = per_layer + attn / 2             # cross-attn on dec half
    return emb + total_layers * per_layer


def attention_flops(cfg, shape) -> float:
    """Exact-ish attention MODEL_FLOPS (scores + PV, causal-halved)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        return 0.0
    if cfg.attn_type == "mla":
        m = cfg.mla
        width = cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim
                               + m.v_head_dim)
    else:
        width = cfg.n_heads * cfg.head_dim * 2          # scores + pv
    L_attn = cfg.n_layers
    ctx = S
    if cfg.family == "hybrid":
        rg = cfg.rglru
        plen = len(rg.pattern)
        n_attn = sum(1 for k in rg.pattern if k == "attn")
        L_attn = (cfg.n_layers // plen) * n_attn
        ctx = min(S, rg.window)
    if shape.mode == "decode":
        # one query token against the cached context
        window = cfg.long_context_window
        if shape.name == "long_500k" and window:
            ctx = min(ctx, window)
        fwd = 2.0 * B * ctx * width * L_attn
        return fwd
    causal = 0.5
    fwd = 2.0 * B * S * ctx * causal * width * L_attn
    if cfg.family == "audio":
        F = cfg.encdec.n_frames
        enc = 2.0 * B * F * F * width * cfg.encdec.n_encoder_layers
        cross = 2.0 * B * S * F * width * cfg.n_layers
        fwd += enc + cross
    return fwd * (3.0 if shape.mode == "train" else 1.0)


def model_flops(cfg, shape) -> float:
    n_act = active_params(cfg)
    attn = attention_flops(cfg, shape)
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * tokens + attn
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_act * tokens + attn
    # decode: one token per sequence
    return 2.0 * n_act * shape.global_batch + attn


# =====================================================================
# analytic decode→aggregate roofline (DESIGN.md §11.3): where the four
# server-aggregation variants sit against the HBM roof, from shapes alone
# =====================================================================
def decode_agg_roofline(cohort: int, n_chunks: int, latent: int,
                        hidden: Tuple[int, ...], chunk: int, *,
                        n_buckets: int = 1,
                        dtype_bytes: int = 4) -> Dict[str, Dict]:
    """Place the chunked-AE decode→aggregate variants on the memory roofline.

    Every variant runs the same decoder math — ``cohort`` clients ×
    ``n_chunks`` chunks through ``latent → hidden... → chunk`` per bucket,
    ``n_buckets`` buckets per round — so FLOPs are identical; what differs
    is HBM traffic and launch count:

    * ``loop``    — per-client sequential decode + host reduce: every client
      materializes its full reconstruction to HBM and it is read back for
      the reduction; decoder params are re-read per client. C·B launches.
    * ``vmap``    — batched decode per bucket: params read once per bucket,
      but the (C, model) reconstruction block still round-trips HBM before
      the einsum. B launches.
    * ``fused``   — the per-bucket Pallas kernel (DESIGN.md §7.1): hidden
      activations round-trip at latent width, the chunk-wide expansion is
      reduced in-kernel, only the (model)-sized mean is written. B launches.
    * ``grouped`` — the ragged grouped launch (DESIGN.md §11.1): same
      traffic as ``fused`` minus repeated decoder-stack reads (each distinct
      decoder ships once into the stacked operand), in ONE launch.

    Returns per-variant dicts with ``flops``, ``hbm_bytes``,
    ``arith_intensity`` (FLOPs/byte), ``pct_of_roof`` (attainable FLOP/s at
    that intensity over peak), ``bound`` and ``launches``, plus the machine
    constants used — all finite for any positive shapes
    (tests/test_roofline_decode_agg.py)."""
    assert cohort > 0 and n_chunks > 0 and latent > 0 and chunk > 0
    assert n_buckets > 0 and dtype_bytes > 0
    widths = (latent,) + tuple(hidden) + (chunk,)
    K = widths[-2]                                  # penultimate width
    # identical compute for every variant: 2mnk per layer matmul, per
    # (client, chunk) row, per bucket
    flops_per_row = sum(2.0 * a * b for a, b in zip(widths[:-1], widths[1:]))
    flops = n_buckets * cohort * n_chunks * flops_per_row
    param_bytes = sum((a * b + b) * dtype_bytes
                      for a, b in zip(widths[:-1], widths[1:]))
    z_bytes = n_buckets * cohort * n_chunks * latent * dtype_bytes
    model_bytes = n_buckets * n_chunks * chunk * dtype_bytes   # one mean
    recon_bytes = cohort * model_bytes          # C materialized decodes
    hidden_rt = n_buckets * cohort * n_chunks * K * dtype_bytes
    ridge = PEAK_FLOPS_BF16 / HBM_BW

    def variant(hbm_bytes: float, launches: int) -> Dict[str, float]:
        ai = flops / hbm_bytes
        attainable = min(PEAK_FLOPS_BF16, ai * HBM_BW)
        return {
            "flops": flops,
            "hbm_bytes": hbm_bytes,
            "arith_intensity": ai,
            "pct_of_roof": 100.0 * attainable / PEAK_FLOPS_BF16,
            "bound": "memory" if ai < ridge else "compute",
            "launches": launches,
        }

    return {
        "shape": {"cohort": cohort, "n_chunks": n_chunks, "latent": latent,
                  "hidden": list(hidden), "chunk": chunk,
                  "n_buckets": n_buckets},
        "machine": {"hbm_bw": HBM_BW, "peak_flops": PEAK_FLOPS_BF16,
                    "ridge_intensity": ridge},
        "loop": variant(
            z_bytes + n_buckets * cohort * param_bytes    # params per client
            + 2.0 * recon_bytes                           # write + read back
            + model_bytes,                                # mean write
            launches=cohort * n_buckets),
        "vmap": variant(
            z_bytes + n_buckets * param_bytes
            + 2.0 * recon_bytes + model_bytes,
            launches=n_buckets),
        "fused": variant(
            z_bytes + n_buckets * param_bytes
            + 2.0 * hidden_rt                             # latent-sided only
            + model_bytes,
            launches=n_buckets),
        "grouped": variant(
            z_bytes + param_bytes                         # deduped decoders
            + 2.0 * hidden_rt + model_bytes,
            launches=1),
    }
