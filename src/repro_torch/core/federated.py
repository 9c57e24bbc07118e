"""Federated-learning orchestration with compressed update communication
(port of ``repro.core.federated``, with the AE lifecycle, rate control,
checkpoint resume and struct-of-arrays client state).
``SyncFedAvg``, ``SampledSync`` and ``AsyncBuffered`` drive it.

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
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.configs.paper import ClassifierConfig
from repro_torch.core.compressor import Compressor, IdentityCompressor
from repro_torch.core.lifecycle import AELifecycle
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
    # measured-bytes channel (DESIGN.md §13.3): uplink priced from the
    # encoded payloads; below ``bytes_up`` only for entropy-coded chains
    bytes_up_measured: float = 0.0
    # ``bytes_down`` is the global-model broadcast to each participant plus
    # the decoder syncs the AE lifecycle shipped this round;
    # ``bytes_decoder`` itemizes the decoder share, and ``ae_syncs`` lists
    # the lanes that shipped one (client ids, or (client, group) pairs for
    # partitioned runs) — savings.reconcile consumes both
    bytes_down: float = 0.0
    bytes_down_raw: float = 0.0
    bytes_decoder: float = 0.0
    ae_syncs: Optional[List] = None
    participants: Optional[List[int]] = None
    staleness: Optional[List[int]] = None   # async only, per participant
    sim_time: float = 0.0              # async only: simulated clock
    # rate control (DESIGN.md §9): the policy that drove this round and
    # its ladder moves, each (client or (client, group), from, to),
    # effective next round; None without a controller
    controller: Optional[str] = None
    spec_switches: Optional[List] = None


class FederatedRun:
    """One FL experiment over a :class:`~repro_torch.core.task.ClientTask`
    on ``device`` (CUDA unless the caller passes ``device="cpu"``; without
    a card it raises). Datasets move to the device once; the global model
    is drawn from a CPU generator seeded with ``fl_cfg.seed`` and moved, so
    CPU and CUDA runs start from identical parameters. ``lifecycle`` (an
    :class:`~repro_torch.core.lifecycle.AELifecycle`) buffers snapshots,
    refits the clients' AEs and charges their decoder ships;
    ``ratecontrol`` (a :class:`~repro_torch.core.ratecontrol.
    RateController`) moves clients along a ladder of compressors.
    ``soa_state`` keeps the per-client state as a struct-of-arrays
    :class:`~repro_torch.core.soa.ClientPool` (snapshot rings
    ``ring_depth`` deep, by default the largest consumer's
    ``buffer_size`` and at least 8) in place of a ``ClientState`` list."""

    def __init__(
        self,
        task: "ClientTask | ClassifierConfig",
        datasets: Sequence[Dict[str, torch.Tensor]],
        fl_cfg: FLConfig,
        compressors: Optional[Sequence[Compressor]] = None,
        eval_data: Optional[Dict[str, torch.Tensor]] = None,
        scheduler: Optional[RoundScheduler] = None,
        lifecycle: Optional[AELifecycle] = None,
        ratecontrol=None,
        soa_state: bool = False,
        ring_depth: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve(device)
        if isinstance(task, ClassifierConfig):
            task = ClassifierTask(task)
        self.task = task
        task.check_config(fl_cfg)
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
        if soa_state:
            # struct-of-arrays client state (DESIGN.md §12.1): the
            # ClientState surface through views, stacked tensors beneath.
            # Every snapshot consumer truncates to its buffer_size right
            # after appending, so a ring as deep as the largest one
            # reproduces the eager lists exactly
            from repro_torch.core.soa import ClientPool
            if ring_depth is None:
                ring_depth = max(
                    8,
                    int(getattr(lifecycle, "buffer_size", 0) or 0),
                    int(getattr(ratecontrol, "buffer_size", 0) or 0))
            self.clients = ClientPool(n, self.global_params,
                                      ring_depth=ring_depth)
        else:
            self.clients = [ClientState() for _ in range(n)]
        self.history: List[RoundRecord] = []
        self.round_offset = 0              # set by load_state on resume
        self.lifecycle = lifecycle
        # the controller binds before the scheduler: its ladder installs
        # each client's initial rung, which the scheduler's first dispatch
        # must see (DESIGN.md §9.1)
        self.ratecontrol = ratecontrol
        if ratecontrol is not None:
            ratecontrol.bind(self)
        self.scheduler = scheduler if scheduler is not None else SyncFedAvg()
        self.scheduler.bind(self)

    def run(self, progress: Optional[Callable[[RoundRecord], None]] = None
            ) -> List[RoundRecord]:
        """Play ``cfg.n_rounds`` rounds. Resumable: within a process from
        the history's length, across processes from ``load_state``'s round
        offset."""
        start = self.round_offset + len(self.history)
        for r in range(start, start + self.cfg.n_rounds):
            rec = self.scheduler.run_round(r)
            self.history.append(rec)
            if progress:
                progress(rec)
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

    def save_state(self, path: str) -> None:
        """Checkpoint the resumable run state in the reference's file
        layout: round index, global params, every ``ClientState`` (residuals,
        snapshot rings, lifecycle scalars, async dispatch snapshots), each
        client's codec params (a lifecycle refit moves them) and the
        scheduler's event-loop state. Under a rate controller the codec
        params ride its ladder tree (every rung's params, with the rung
        occupancy in the metadata) instead of the flat ``codecs``
        section. A struct-of-arrays pool saves its stacked arrays whole
        (``ClientPool.state()``)."""
        from repro_torch.checkpoint.checkpoint import save_federated_state
        from repro_torch.core.soa import ClientPool
        rc = self.ratecontrol
        is_pool = isinstance(self.clients, ClientPool)
        save_federated_state(
            path, self.round_offset + len(self.history), self.global_params,
            clients=(None if is_pool else self.clients),
            clients_soa=(self.clients.state() if is_pool else None),
            codec_params=(None if rc is not None else
                          [c.codec_params() for c in self.compressors]),
            ratecontrol=((rc.state_meta(), rc.state_tree())
                         if rc is not None else None),
            scheduler_state=self.scheduler.state_dict(),
            extra={"task": self.task.checkpoint_key()})

    def load_state(self, path: str) -> int:
        """Restore a checkpoint (this package's or the reference's) into
        this freshly constructed run, onto its device; later ``run()``
        calls continue from the saved round. Returns the next round
        index. A checkpoint of another task, or one whose rate-controller
        presence differs from this run's, is refused before any state is
        touched. The checkpoint's client-state layout, not this run's
        ``soa_state``, decides what is restored: a struct-of-arrays
        checkpoint rebuilds a ``ClientPool``, an eager one a
        ``ClientState`` list."""
        from repro_torch.checkpoint.checkpoint import (_peek_meta,
                                                       load_federated_state)
        meta = _peek_meta(path)
        saved_task = meta.get("task")
        if saved_task is not None and saved_task != self.task.checkpoint_key():
            raise ValueError(
                f"task mismatch: checkpoint was saved by task "
                f"{saved_task!r} but this run's task is "
                f"{self.task.checkpoint_key()!r} — params cannot be "
                "restored; rebuild the run with the matching task")
        rc = self.ratecontrol
        # codec params ride the controller's ladder tree when one is
        # attached and the flat ``codecs`` section otherwise: a mismatch
        # would leave every compressor at its construction-time params
        saved_rc = meta.get("ratecontrol") is not None
        if (rc is not None) != saved_rc:
            raise ValueError(
                "rate-controller mismatch: checkpoint was saved "
                f"{'with' if saved_rc else 'without'} a RateController but "
                f"this run was constructed "
                f"{'with' if rc is not None else 'without'} one — codec "
                "params cannot be restored; rebuild the run to match the "
                "checkpoint")
        rnd, params, meta = load_federated_state(
            path, self.global_params,
            like_codec_params=(None if rc is not None else
                               [c.codec_params() for c in self.compressors]),
            like_ratecontrol=(rc.state_tree() if rc is not None else None),
            device=self.device)
        self.global_params = params
        if meta.get("clients_soa") is not None:
            from repro_torch.core.soa import ClientPool
            soa = meta["clients_soa"]
            if int(soa["n"]) != len(self.clients):
                raise ValueError(
                    f"checkpoint holds {soa['n']} clients, the run has "
                    f"{len(self.clients)}")
            self.clients = ClientPool.from_state(
                meta.get("clients_soa_tree") or {}, soa, self.global_params)
        elif meta.get("client_states") is not None:
            if len(meta["client_states"]) != len(self.clients):
                raise ValueError(
                    f"checkpoint holds {len(meta['client_states'])} "
                    f"clients, the run has {len(self.clients)}")
            self.clients = meta["client_states"]
        for comp, restored in zip(self.compressors,
                                  meta.get("codec_params") or []):
            comp.set_codec_params(restored)
        if rc is not None:
            rc.load_state(meta["ratecontrol"], meta["ratecontrol_tree"])
        self.history = []
        self.round_offset = rnd
        self.scheduler.on_restore(meta.get("scheduler"))
        return rnd


# =====================================================================
# paper §5.1 "validation model": set AE-reconstructed weights into a fresh
# model and check the loss/accuracy curve matches the original training
# =====================================================================
def validation_model_curve(
    clf_cfg: ClassifierConfig,
    weight_vectors: torch.Tensor,          # (E, P) original snapshots
    reconstruct: Callable[[torch.Tensor], torch.Tensor],
    data: Dict[str, torch.Tensor],
) -> Dict[str, List[float]]:
    """For each training snapshot: evaluate the model with (a) original
    and (b) AE-reconstructed weights, the paper's Figs. 5/7 overlay. Runs
    on ``weight_vectors``' device."""
    from repro_torch.core.prepass import evaluate
    from repro_torch.core.pytree import ravel
    from repro_torch.models.classifiers import init_classifier
    dev = weight_vectors.device
    template = init_classifier(torch.Generator().manual_seed(0), clf_cfg,
                               dev)
    flat0, unravel = ravel(template)
    P = flat0.numel()
    data = {k: v.to(dev) for k, v in data.items()}

    out = {"original_acc": [], "predicted_acc": [],
           "original_loss": [], "predicted_loss": []}
    for i in range(weight_vectors.shape[0]):
        w = weight_vectors[i][:P]
        w_hat = reconstruct(weight_vectors[i])[:P]
        m_orig = evaluate(unravel(w), clf_cfg, data)
        m_pred = evaluate(unravel(w_hat), clf_cfg, data)
        out["original_acc"].append(m_orig["accuracy"])
        out["predicted_acc"].append(m_pred["accuracy"])
        out["original_loss"].append(m_orig["loss"])
        out["predicted_loss"].append(m_pred["loss"])
    return out
