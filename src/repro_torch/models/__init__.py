"""The model zoo: the paper's classifiers (``classifiers.py``) and the LM
(``model.py``: the dense, MoE, SSM (``ssm.py``), hybrid RG-LRU
(``rglru.py``), audio encoder-decoder and VLM families, GQA or MLA
attention), with the names ``repro.models`` exports."""
from repro_torch.models.model import (  # noqa: F401
    decode_step,
    init_cache,
    init_params,
    param_count,
    prefill,
    train_loss,
)
