"""Cells whose step is one FL round of LM delta fine-tuning:
``FederatedRun`` over ``LMDeltaTask`` under ``SyncFedAvg`` (the window's
call ``scheduler.run_round(r)``, as :mod:`bench.drivers.fl_round`), with a
``by_role_partition`` codec a client: the MLP's weights through a
kernel-path chunked AE, every other role through int8.

Set-up draws the model, the AE and the token shards on the device from
``--seed`` and plays ``check_rounds`` rounds through the window's call,
keeping each round's record, of the first round each client's first
step (its loss and the optimizer's first moment) and each codec input and
payload over the roles' pieces (one in each layer), and each leaf's norm
of the server's first update and of the model's change over the whole
leaf (the start drawn again from the seed).
"""
from __future__ import annotations

import gc
import importlib
from types import SimpleNamespace
from typing import Dict, List

import torch

from bench import checks, data as bdata, tracing
from bench.cost import models as mcost
from bench.cost.peaks import PEAK_FLOPS
# the window, its step and the numbers compared are the CNN round cells'
from bench.drivers.fl_round import (chunked_ae, free, readings,  # noqa
                                    step, tf32, window)
from bench.reference import codec as rcodec, lm as rlm

KIND = "round"
END_TO_END = ("round_s",)


def arch(config: Dict):
    from repro_torch.configs.base import ArchConfig
    m = config["model"]
    return ArchConfig(
        name=m["name"], family="dense", source=config["source"],
        n_layers=m["n_layers"], d_model=m["d_model"], n_heads=m["n_heads"],
        n_kv_heads=m["n_kv_heads"], head_dim=m["head_dim"], d_ff=m["d_ff"],
        vocab_size=m["vocab_size"], attn_type="gqa",
        rope_theta=m["rope_theta"], rope_pct=m["rope_pct"],
        norm_type="layernorm", norm_eps=m["norm_eps"], activation="swiglu",
        param_dtype="float32", compute_dtype="bfloat16",
        remat=config["remat"])


def model0(config: Dict, seed: int, device: torch.device):
    """The global model the run starts from, drawn on the device."""
    return rlm.init_params(
        bdata.generator(bdata.seed_words(seed, 4)[0], device),
        config["model"])


def inputs(cell: Dict, config: Dict, seed: int, device: torch.device
           ) -> SimpleNamespace:
    w = bdata.seed_words(seed, 4)
    m = config["model"]
    g0 = model0(config, seed, device)
    ae = chunked_ae(bdata.generator(w[1], device), config["codec"])
    n, per, S = cell["n_clients"], cell["seqs"], cell["seq_len"]
    toks = bdata.lm_tokens(bdata.generator(w[2], device), n * per
                           + cell["eval"], S, m["vocab_size"])
    shards = [{k: v[i * per:(i + 1) * per] for k, v in toks.items()}
              for i in range(n)]
    ev = {k: v[n * per:] for k, v in toks.items()}
    fl = dict(config["fl"], local_epochs=cell["local_epochs"],
              seed=w[3] % 4000)
    return SimpleNamespace(g0=g0, ae=ae, shards=shards, eval=ev, fl=fl)


def build_program(cell: Dict, config: Dict, x: SimpleNamespace,
                  device: torch.device):
    from repro_torch.core import (ChunkedAECompressor, ChunkedAEConfig,
                                  FederatedRun, FLConfig, LMDeltaTask,
                                  PartitionedCompressor, QuantizeCompressor,
                                  SyncFedAvg, by_role_partition)
    c, fl = config["codec"], x.fl
    task = LMDeltaTask(arch(config), freeze_roles=("embedding",))
    g0 = x.g0
    task.init_params = lambda gen, dev: g0
    ae_cfg = ChunkedAEConfig(chunk_size=c["chunk_size"],
                             hidden=tuple(c["hidden"]),
                             latent_chunk=c["latent_chunk"])
    pmap = by_role_partition(g0)
    comps = [PartitionedCompressor(pmap, {
        name: (ChunkedAECompressor(x.ae, ae_cfg, use_kernel=True)
               if name == "mlp" else
               QuantizeCompressor(bits=c["bits"], block=c["q_block"]))
        for name in pmap.names}) for _ in x.shards]
    sched = SyncFedAvg()
    run = FederatedRun(
        task, x.shards,
        FLConfig(n_rounds=1, local_epochs=fl["local_epochs"], lr=fl["lr"],
                 batch_size=fl["batch_size"], optimizer=fl["optimizer"],
                 payload="update", error_feedback=fl["error_feedback"],
                 server_lr=fl["server_lr"], seed=fl["seed"]),
        compressors=comps, eval_data=x.eval, scheduler=sched, device=device)
    del task.init_params             # the run holds the model from here on
    return run, sched


def comparison_windows(config: Dict, seed: int) -> Dict:
    return rlm.windows(rlm.shapes(config["model"]),
                       bdata.seed_words(seed, 1, stream=1)[0])


class _FirstSteps:
    """Of the first round: each client's first step (its loss, and the
    squared norm of each leaf of the gradient the optimizer got, from its
    first moment after the step) through ``task._lm_step``, and of each
    top-level ``codec.encode`` the input and the payload rows over the
    roles' pieces."""

    def __init__(self, b1: float, win: Dict, codec_cfg: Dict):
        self.b1, self.win, self.codec_cfg = b1, win, codec_cfg
        self.loss: List[float] = []
        self.grad_sq: Dict[str, float] = {}
        self.inputs: List[Dict] = []
        self.payloads: List[Dict] = []

    def targets(self):
        task_mod = importlib.import_module("repro_torch.core.task")
        codec_mod = importlib.import_module("repro_torch.core.codec")

        def lm_step_factory(fn):
            def build(*a, **k):
                opt, stp = fn(*a, **k)
                seen = []

                def first(p, s, batch, anchor, mask):
                    out = stp(p, s, batch, anchor, mask)
                    if not seen:
                        seen.append(True)
                        self.loss.append(float(out[2]["loss"]))
                        norms = checks.leaf_norms(out[1]["m"])
                        for key, v in norms.items():
                            self.grad_sq[key] = self.grad_sq.get(key, 0.0) \
                                + (v / (1.0 - self.b1)) ** 2
                    return out
                return opt, first
            return build

        depth = [0]

        def encode_factory(fn):
            def encode(spec, params, flat):
                depth[0] += 1
                try:
                    payload = fn(spec, params, flat)
                finally:
                    depth[0] -= 1
                if depth[0] == 0:
                    self.inputs.append(rlm.window_values(flat, self.win))
                    self.payloads.append(rlm.window_payload(
                        payload, self.win, self.codec_cfg))
                return payload
            return encode

        return [(task_mod, "_lm_step", lm_step_factory),
                (codec_mod, "encode", encode_factory)]


def setup(cell: Dict, config: Dict, seed: int, device: torch.device
          ) -> SimpleNamespace:
    x = inputs(cell, config, seed, device)
    win = comparison_windows(config, seed)
    g0 = rlm.tree_pieces(x.g0, win)
    run, sched = build_program(cell, config, x, device)
    x.g0 = None                      # the program holds the model
    sut = SimpleNamespace(cell=cell, config=config, seed=seed,
                          device=device, x=x, run=run, sched=sched,
                          next_round=0, attempted=0, failed=0, records=[])
    first = _FirstSteps(config["fl"]["adam_b1"], win, config["codec"])
    for r in range(cell["check_rounds"]):
        if r == 0:
            with tracing.patched(first.targets()):
                rec = sched.run_round(r)
            sut.first_loss = torch.tensor(first.loss, dtype=torch.float64)
            sut.first_grad = {k: v ** 0.5 for k, v in first.grad_sq.items()}
            sut.enc_in, sut.payloads = first.inputs, first.payloads
            sut.first = change_norms(run.global_params, config, seed, device)
            g1 = rlm.tree_pieces(run.global_params, win)
            sut.delta1 = {g: g1[g] - g0[g] for g in g1}
        else:
            rec = sched.run_round(r)
        sut.records.append({
            "cohort": list(rec.participants), "bytes_up": rec.bytes_up,
            "loss": sum(m["loss"] for m in rec.collab_metrics)
            / len(rec.collab_metrics)})
    sut.change = change_norms(run.global_params, config, seed, device)
    sut.next_round = cell["check_rounds"]
    tracing.sync(device)
    return sut


def change_norms(params, config: Dict, seed: int, device: torch.device
                 ) -> Dict[str, float]:
    """Each leaf's norm of the model's change since the start, over the
    whole leaf; the start drawn again from the seed, and freed."""
    start = dict(rlm.leaves(model0(config, seed, device)))
    return {path: rlm.norm64(now.detach() - start.pop(path))
            for path, now in rlm.leaves(params)}


def round_flops(cell: Dict, config: Dict) -> float:
    """Every client's trained tokens (forward and backward, the embedding
    and head frozen) and the evaluation's forward."""
    m = dict(config["model"], seq_len=cell["seq_len"])
    bs = config["fl"]["batch_size"]
    tokens = cell["n_clients"] * cell["local_epochs"] \
        * (cell["seqs"] // bs * bs) * cell["seq_len"]
    _, train = mcost.lm_train_flops(m, tokens)
    fwd, _ = mcost.lm_train_flops(m, cell["eval"] * cell["seq_len"])
    return train + fwd


def traced(sut, seconds: float) -> tracing.Trace:
    trace = tracing.Trace(kind=KIND)
    sched_mod = importlib.import_module("repro_torch.core.scheduler")
    task = sut.run.task
    spans = [("client_train", task, "local_update"),
             ("client_encode", sched_mod, "_encode_local"),
             ("server_agg", sched_mod, "_server_aggregate"),
             ("global_eval", task, "evaluate")]
    tracing.run_phases(trace, lambda: step(sut), seconds, spans, sut.device)
    sut.attempted = sum(trace.steps.values())
    trace.step_flops = round_flops(sut.cell, sut.config)
    trace.peak_flops = PEAK_FLOPS[sut.config["compute_dtype"]]
    return trace


# ------------------------------------------------------------ correctness
def program_readings(sut) -> Dict:
    return {k: getattr(sut, k) for k in (
        "records", "first_loss", "first_grad", "first", "change", "enc_in",
        "payloads", "delta1")}


def reference_readings(cell: Dict, config: Dict, seed: int,
                       device: torch.device, mm=rlm.mm_bf16) -> Dict:
    x = inputs(cell, config, seed, device)
    layout = rlm.shapes(config["model"])
    gflat0 = rlm.ravel(x.g0)
    x.g0 = None
    out = rlm.run_rounds(gflat0, layout, comparison_windows(config, seed),
                         x.shards, x.ae, config["model"], x.fl,
                         config["codec"], cell["check_rounds"], mm)
    o = out[0]
    return {"records": [{"cohort": r["cohort"], "bytes_up": r["bytes_up"],
                         "loss": r["loss"]} for r in out],
            "first_loss": torch.tensor(o["first_loss"], dtype=torch.float64),
            "first_grad": {k: v ** 0.5 for k, v in o["grad_sq"].items()},
            "first": o["change"], "change": out[-1]["change"],
            "enc_in": o["inputs"], "payloads": o["payloads"],
            "delta1": o["delta"]}


def staged(side: Dict, cell: Dict, config: Dict, seed: int,
           device: torch.device) -> Dict[str, float]:
    """The codec and the server held stage by stage from ``side``'s own
    state over each role's pieces: the reference encodes
    ``side``'s first-round codec inputs (the share of int8 codes that
    differ; the largest gap of the AE latents over their largest value)
    and aggregates ``side``'s payload rows into the server's update (the
    largest gap over the largest value)."""
    ae = chunked_ae(bdata.generator(bdata.seed_words(seed, 4)[1], device),
                    config["codec"])
    c = config["codec"]
    differ = total = 0
    z_gap = agg = 0.0
    for values, rows in zip(side["enc_in"], side["payloads"]):
        for g, x in values.items():
            if g == "mlp":
                z = rcodec.ae_encode(ae, x, c["chunk_size"])
                z_gap = max(z_gap, checks.max_gap(rows[g]["z"], z))
            else:
                q, _ = rcodec.quantize(x, c["bits"], c["q_block"])
                differ += int((rows[g]["q"] != q).sum())
                total += q.numel()
    w = 1.0 / len(side["payloads"])
    for g, d in side["delta1"].items():
        n = d.numel()
        if g == "mlp":
            z = torch.stack([rows[g]["z"] for rows in side["payloads"]])
            mean = rcodec.weighted_mean_decode(
                ae, z, torch.full((z.shape[0],), w, device=device), n)
        else:
            mean = sum(w * rcodec.dequantize(rows[g]["q"], rows[g]["scales"],
                                             n)
                       for rows in side["payloads"])
        agg = max(agg, checks.max_gap(d, mean))
    return {"encode": differ / total, "encode_ae": z_gap, "aggregate": agg}


def check_readings(sut) -> Dict[str, float]:
    prog = program_readings(sut)
    cell, config, seed, dev = sut.cell, sut.config, sut.seed, sut.device
    free(sut)
    with tf32(False):
        ref = reference_readings(cell, config, seed, dev)
        gc.collect()
        stages = staged(prog, cell, config, seed, dev)
    return readings(prog, ref, stages)


def control_readings(cell: Dict, config: Dict, seed: int,
                     device: torch.device) -> Dict[str, float]:
    """The reference one precision below the configuration's in the
    program's place: float8 operands where the model's products take
    bfloat16, TF32 where the codec's and attention's take float32; held to
    the reference."""
    with tf32(True):
        low = reference_readings(cell, config, seed, device, rlm.mm_fp8)
    gc.collect()
    with tf32(False):
        ref = reference_readings(cell, config, seed, device)
        gc.collect()
        stages = staged(low, cell, config, seed, device)
    return readings(low, ref, stages)


def faults(name: str) -> list:
    """``unchanged``: a round that leaves the global model as it was;
    ``half_batch``: each step's loss over half of its batch's
    sequences."""
    sched_mod = importlib.import_module("repro_torch.core.scheduler")
    model_mod = importlib.import_module("repro_torch.models.model")
    if name == "unchanged":
        return [(sched_mod, "_server_aggregate",
                 lambda fn: lambda run, *a, **k: run.global_params)]
    if name == "half_batch":
        def half(fn):
            def loss(params, cfg, batch):
                return fn(params, cfg, {k: v[:v.shape[0] // 2]
                                        for k, v in batch.items()})
            return loss
        return [(model_mod, "train_loss", half)]
    raise KeyError(name)


FAULTS = ("unchanged", "half_batch")
