"""Federated-learning orchestration with compressed update communication
(port of ``repro.core.federated``; lifecycle, rate control, SoA client
state and checkpointing are not ported yet). ``SyncFedAvg``,
``SampledSync`` and ``AsyncBuffered`` drive it.

The paper's FL scheme (§1, §3, Fig. 3): a server ships a global model to
collaborators; each trains locally for E epochs; the weight update (or the
weights, under the §5.2 protocol) is encoded on the collaborator, byte
accounted, decoded on the server and FedAvg'd into the next global model.
Error feedback optionally keeps the reconstruction residual local. Round
orchestration is a ``RoundScheduler`` (DESIGN.md §6); ``SyncFedAvg`` is
the default.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs.paper import ClassifierConfig
from repro_torch.core.compressor import Compressor, IdentityCompressor
from repro_torch.core.scheduler import ClientState, RoundScheduler, SyncFedAvg
from repro_torch.core.task import ClassifierTask, ClientTask
from repro_torch.device import DeviceLike, resolve


@dataclasses.dataclass
class FLConfig:
    n_rounds: int = 40
    local_epochs: int = 5              # paper §5.2: 40 rounds x 5 epochs
    lr: float = 1e-3
    batch_size: int = 64
    optimizer: str = "adam"
    aggregation: str = "fedavg"        # fedavg | fedprox
    prox_mu: float = 0.01              # fedprox only
    server_lr: float = 1.0
    error_feedback: bool = False
    # what crosses the wire: "weights" (paper §5.2, the collaborators'
    # converged weights) or "update" (deltas, the quantizers' target)
    payload: str = "weights"
    # server aggregation of a mixed-spec or partitioned cohort: None or
    # False takes the per-bucket sequential path; True makes one round
    # whose kernel-path chunked-AE buckets share a single grouped ragged
    # launch (kernels.ops.use_grouped_default, DESIGN.md §11.2)
    use_grouped_kernel: Optional[bool] = None
    seed: int = 0


@dataclasses.dataclass
class RoundRecord:
    round: int
    collab_metrics: List[Dict[str, float]]
    global_metrics: Dict[str, float]
    bytes_up: float                    # collaborator→server this round
    bytes_up_raw: float                # uncompressed equivalent
    compression_ratio: float
    bytes_down: float = 0.0            # server→collaborator model syncs
    bytes_down_raw: float = 0.0
    bytes_decoder: float = 0.0         # decoder-sync share of bytes_down
    participants: Optional[List[int]] = None
    staleness: Optional[List[int]] = None   # async only, per participant
    sim_time: float = 0.0              # async only: simulated clock


class FederatedRun:
    """One FL experiment over a :class:`~repro_torch.core.task.ClientTask`
    on ``device`` (CUDA unless the caller passes ``device="cpu"``; without
    a card it raises). Datasets move to the device once; the global model
    is drawn from a CPU generator seeded with ``fl_cfg.seed`` and moved, so
    CPU and CUDA runs start from identical parameters."""

    def __init__(
        self,
        task: "ClientTask | ClassifierConfig",
        datasets: Sequence[Dict[str, torch.Tensor]],
        fl_cfg: FLConfig,
        compressors: Optional[Sequence[Compressor]] = None,
        eval_data: Optional[Dict[str, torch.Tensor]] = None,
        scheduler: Optional[RoundScheduler] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve(device)
        if isinstance(task, ClassifierConfig):
            task = ClassifierTask(task)
        self.task = task
        self.datasets = [{k: v.to(self.device) for k, v in d.items()}
                         for d in datasets]
        self.cfg = fl_cfg
        n = len(self.datasets)
        if compressors is None:
            compressors = [IdentityCompressor() for _ in range(n)]
        assert len(compressors) == n
        self.compressors = list(compressors)
        self.eval_data = (None if eval_data is None else
                          {k: v.to(self.device) for k, v in eval_data.items()})
        gen = torch.Generator().manual_seed(fl_cfg.seed)
        self.global_params = task.init_params(gen, self.device)
        self.clients = [ClientState() for _ in range(n)]
        self.history: List[RoundRecord] = []
        self.scheduler = scheduler if scheduler is not None else SyncFedAvg()
        self.scheduler.bind(self)

    def run(self) -> List[RoundRecord]:
        start = len(self.history)
        for r in range(start, start + self.cfg.n_rounds):
            self.history.append(self.scheduler.run_round(r))
        return self.history

    def total_bytes(self) -> Dict[str, float]:
        up = sum(r.bytes_up for r in self.history)
        raw = sum(r.bytes_up_raw for r in self.history)
        down = sum(r.bytes_down for r in self.history)
        dec = sum(r.bytes_decoder for r in self.history)
        return {"bytes_up": up, "bytes_up_raw": raw,
                "bytes_down": down,
                "bytes_decoder": dec,
                "bytes_total": up + down,
                "effective_ratio": raw / max(up, 1.0)}

    def savings_report(self, model) -> Dict[str, float]:
        """Reconcile this run's byte accounting against Eq. 4–6
        (``savings.reconcile``, DESIGN.md §8.3)."""
        from repro_torch.core.savings import reconcile
        return reconcile(model, self.history)
