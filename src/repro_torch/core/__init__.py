"""The paper's contribution in PyTorch: AE-compressed weight-update
communication for federated learning (port of ``repro.core``)."""
from repro_torch.core.aggregate import (  # noqa: F401
    apply_update,
    buffered_aggregate,
    distortion_weights,
    fedavg,
    normalize_weights,
    staleness_weights,
    weighted_mean,
    weighted_mean_stacked,
)
from repro_torch.core.arrival import ArrivalEngine, pop_k_device  # noqa: F401
from repro_torch.core.soa import ClientPool, ClientView  # noqa: F401
from repro_torch.core.serve import (  # noqa: F401
    ServeConfig,
    init_state as init_serve_state,
    make_step as make_serve_step,
    round_bytes,
    run_serve,
    synthetic_payloads,
)
from repro_torch.core.autoencoder import (  # noqa: F401
    ChunkedAEConfig,
    ConvAEConfig,
    ae_accuracy,
    ae_loss,
    ae_param_count,
    chunked_decode,
    chunked_encode,
    conv_decode,
    conv_encode,
    decoder_param_count,
    decoder_sync_bytes,
    decoder_tree,
    fc_decode,
    fc_encode,
    fc_reconstruct,
    init_chunked_ae,
    init_conv_ae,
    init_fc_ae,
    train_autoencoder,
    train_autoencoder_cohort,
)
from repro_torch.core.codec import (  # noqa: F401
    ChainSpec,
    ChunkedAESpec,
    ComposedSpec,
    EntropySpec,
    FCAESpec,
    IdentitySpec,
    KMeansSpec,
    QuantizeSpec,
    TopKSpec,
    ae_spec,
    composed_chain,
    decode_and_aggregate,
    decode_and_aggregate_sharded,
    decode_batched,
    is_shape_static,
    measured_bytes,
    stack_payloads,
    stage_ops,
    stage_out_size,
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
from repro_torch.core.lifecycle import AELifecycle  # noqa: F401
from repro_torch.core.ratecontrol import (  # noqa: F401
    ByteBudget,
    DistortionTarget,
    FixedRate,
    RateController,
    RDBudget,
    fc_ae_ladder,
    partition_ladder,
)
from repro_torch.core.compressor import (  # noqa: F401
    ChainCompressor,
    ChunkedAECompressor,
    ComposedCompressor,
    Compressor,
    FCAECompressor,
    IdentityCompressor,
    KMeansCompressor,
    PartitionedCompressor,
    QuantizeCompressor,
    TopKCompressor,
    ef_compensate,
    ef_residual,
    partitioned,
    tree_bytes,
)
from repro_torch.core.federated import (  # noqa: F401
    FederatedRun,
    FLConfig,
    RoundRecord,
    validation_model_curve,
)
from repro_torch.core.prepass import (  # noqa: F401
    evaluate,
    local_train,
    local_train_batched,
    run_prepass,
)
from repro_torch.core.savings import (  # noqa: F401
    SavingsModel,
    reconcile,
    sweep_collaborators,
    sweep_rounds,
)
from repro_torch.core.scheduler import (  # noqa: F401
    AsyncBuffered,
    ClientState,
    LatencyModel,
    RoundScheduler,
    SampledSync,
    SyncFedAvg,
)
from repro_torch.core.task import (  # noqa: F401
    ClassifierTask,
    ClientTask,
    LMDeltaTask,
)
from repro_torch.core.collectives import CountingGroup  # noqa: F401
from repro_torch.core.distributed import (  # noqa: F401
    DEFAULT_AE,
    build_fl_round_step,
    compressed_fraction,
    decode_tree,
    encode_tree,
    leaf_decode,
    leaf_encode,
)
