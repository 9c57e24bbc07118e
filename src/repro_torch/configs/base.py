"""Architecture configurations of the LM model zoo (the port's own copy of
``repro.configs.base``, kept field for field identical so a config means the
same model in both packages).

Every architecture has a module ``repro_torch/configs/<id>.py`` exporting
``CONFIG: ArchConfig``. This module resolves ``--arch <id>`` strings
(:func:`get_config`), holds the four input shapes and builds the reduced
smoke-test variants.

* ``ArchConfig`` is a frozen dataclass, so it is hashable and compares by
  value.
* ``vocab_size`` is the model card's vocabulary; ``padded_vocab`` rounds it
  up to a multiple of 256. Logits of the padding ids are masked downstream.
* ``reduced()`` is the CPU smoke-test variant (2 layers, d_model <= 256,
  <= 4 experts) of the same family: the same code paths at tiny shapes.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 1
    d_ff_expert: int = 0           # expert hidden width
    capacity_factor: float = 1.25  # tokens-per-expert capacity multiplier
    shared_expert: bool = False    # Llama-4 style always-on shared expert
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD (state-space duality, arXiv:2405.21060)."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma / Griffin RG-LRU hybrid (arXiv:2402.19427)."""

    lru_width: int = 4096
    conv_width: int = 4
    window: int = 2048            # local-attention window
    pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")  # repeating block


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder; the conv/mel frontend is a stub that
    supplies precomputed frame embeddings of shape (B, n_frames, d_model)."""

    n_encoder_layers: int = 24
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """Phi-3-vision style: a stub vision tower supplies patch embeddings of
    shape (B, n_image_tokens, d_model) merged at reserved positions."""

    n_image_tokens: int = 576


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str = "unnamed"
    family: str = "dense"          # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""               # citation from the assignment table

    # trunk
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 32000

    # attention flavour
    attn_type: str = "gqa"         # gqa | mla | none (ssm)
    rope_theta: float = 10000.0
    rope_pct: float = 1.0          # stablelm partial rotary
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    norm_eps: float = 1e-5
    activation: str = "swiglu"     # swiglu | gelu | geglu
    parallel_block: bool = False   # attn+mlp in parallel (not used by defaults)
    tie_embeddings: bool = False
    attn_logit_softcap: float = 0.0

    # sub-configs (None when family doesn't use them)
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None

    # long-context decode fallback: sliding-window width used for the
    # long_500k shape on otherwise-quadratic architectures. None → native
    # sub-quadratic path (ssm/hybrid) or window from rglru config.
    long_context_window: Optional[int] = 8192

    # training policy
    # sequence-shard the residual stream during training too
    # (launch/steps.py::_activation_axes)
    train_seq_shard: bool = False
    grad_reduce_dtype: str = "float32"   # bfloat16 halves grad all-reduces
    optimizer: str = "adamw"       # adamw | adam | sgdm | sgdm_bf16
    zero1: bool = True             # shard optimizer state over the data axis
    param_dtype: str = "float32"   # float32 | bfloat16 (giant archs)
    compute_dtype: str = "bfloat16"
    remat: bool = True             # activation checkpointing across layers
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    # ----------------------------------------------------------------- utils
    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, 256)

    @property
    def q_dim(self) -> int:
        if self.attn_type == "mla":
            m = self.mla
            return self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_decoder_only(self) -> bool:
        return self.encdec is None

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/code paths, tiny shapes."""
        d_model = min(self.d_model, 256)
        head_dim = 32
        n_heads = max(2, min(self.n_heads, d_model // head_dim))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        changes = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 1024),
            rope_theta=10000.0,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            zero1=False,
        )
        if self.mla is not None:
            changes["mla"] = MLAConfig(
                q_lora_rank=64, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=32)
            changes["head_dim"] = 32
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 256))
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk_size=32)
        if self.rglru is not None:
            changes["rglru"] = dataclasses.replace(
                self.rglru, lru_width=d_model, window=64)
            changes["n_layers"] = 3      # one full (R,R,A) pattern block
        if self.encdec is not None:
            changes["encdec"] = dataclasses.replace(
                self.encdec, n_encoder_layers=2, n_frames=16)
        if self.vlm is not None:
            changes["vlm"] = dataclasses.replace(self.vlm, n_image_tokens=8)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}

ARCH_IDS = (
    "minicpm3_4b",
    "llama4_maverick_400b_a17b",
    "stablelm_1_6b",
    "deepseek_coder_33b",
    "whisper_medium",
    "phi3_vision_4_2b",
    "recurrentgemma_9b",
    "dbrx_132b",
    "mamba2_2_7b",
    "llama3_8b",
)

# CLI aliases: assignment-table ids (with dashes/dots) → module names.
_ALIASES = {
    "minicpm3-4b": "minicpm3_4b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "stablelm-1.6b": "stablelm_1_6b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "whisper-medium": "whisper_medium",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "dbrx-132b": "dbrx_132b",
    "mamba2-2.7b": "mamba2_2_7b",
    "llama3-8b": "llama3_8b",
    # paper collaborator models
    "mnist-mlp": "mnist_mlp",
    "cifar-cnn": "cifar_cnn",
}


def canonical_arch_id(arch: str) -> str:
    key = arch.strip()
    return _ALIASES.get(key, key.replace("-", "_").replace(".", "_"))


def get_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical_arch_id(arch)}")
    return mod.CONFIG


def get_shape(shape: str) -> ShapeConfig:
    return SHAPES[shape]
