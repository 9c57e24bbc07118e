"""mamba2-2.7b [ssm] — arXiv:2405.21060 (SSD, state-space duality).

64L d_model=2560 (attention-free) vocab=50280, ssm_state=128. d_inner =
2*d_model = 5120, head_dim 64 → 80 SSD heads, depthwise conv width 4,
chunked-dual scan with chunk 256. Decode state is O(1) in sequence length, so
long_500k runs natively.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=64,
    d_model=2560,
    n_heads=1,                         # unused by the SSD mixer
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,                            # no separate MLP block in mamba2
    vocab_size=50280,
    attn_type="none",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256, n_groups=1),
    activation="swiglu",
    long_context_window=None,          # native sub-quadratic
    tie_embeddings=True,
)
