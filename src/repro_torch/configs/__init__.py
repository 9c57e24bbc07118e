"""Configurations: the paper's models (``paper.py``) and the LM model zoo
(``base.py`` and one ``<id>.py`` per architecture)."""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    SHAPES,
    ArchConfig,
    EncDecConfig,
    MLAConfig,
    MoEConfig,
    RGLRUConfig,
    SSMConfig,
    ShapeConfig,
    VLMConfig,
    canonical_arch_id,
    get_config,
    get_shape,
)
