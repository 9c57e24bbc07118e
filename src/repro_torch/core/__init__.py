"""The paper's contribution in PyTorch: AE-compressed weight-update
communication for federated learning (port of ``repro.core``)."""
from repro_torch.core.aggregate import (  # noqa: F401
    apply_update,
    normalize_weights,
    weighted_mean_stacked,
)
from repro_torch.core.autoencoder import (  # noqa: F401
    ChunkedAEConfig,
    fc_decode,
    fc_encode,
    fc_reconstruct,
    init_chunked_ae,
    init_fc_ae,
    train_autoencoder,
)
from repro_torch.core.codec import (  # noqa: F401
    ChunkedAESpec,
    FCAESpec,
    IdentitySpec,
    QuantizeSpec,
    decode_and_aggregate,
    stack_payloads,
    wire_bytes,
)
from repro_torch.core import codec  # noqa: F401
from repro_torch.core.partition import (  # noqa: F401
    PartitionMap,
    PartitionSpec,
    by_layer_partition,
    by_leaf_partition,
    by_role_partition,
    identity_partition,
    make_partition_spec,
    role_of_path,
    wire_bytes_by_group,
)
from repro_torch.core import partition  # noqa: F401
from repro_torch.core.compressor import (  # noqa: F401
    ChunkedAECompressor,
    Compressor,
    FCAECompressor,
    IdentityCompressor,
    PartitionedCompressor,
    QuantizeCompressor,
    partitioned,
    tree_bytes,
)
from repro_torch.core.federated import (  # noqa: F401
    FederatedRun,
    FLConfig,
    RoundRecord,
)
from repro_torch.core.prepass import evaluate, local_train, run_prepass  # noqa: F401
from repro_torch.core.savings import SavingsModel, reconcile  # noqa: F401
from repro_torch.core.scheduler import SyncFedAvg  # noqa: F401
from repro_torch.core.task import ClassifierTask, ClientTask  # noqa: F401
