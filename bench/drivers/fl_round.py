"""Cells whose step is one FL round of ``FederatedRun``'s scheduler
(``scheduler.run_round(r)``): ``SampledSync`` or ``SyncFedAvg`` over the
task the configuration names.

Set-up draws the global model, the codec's autoencoder and the clients'
data on the device from ``--seed``, builds the run and plays the cell's
``check_rounds`` first rounds through the window's own call, keeping what
the correctness check reads of them: each round's cohort, uplink bytes
and mean local loss, the first round's codes, the norms of the server's
first update and of the global model's change over those rounds. The
window then goes on from that run.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import sys
import time
from types import SimpleNamespace
from typing import Dict, List

import torch

from bench import checks, data as bdata, tracing
from bench.cost import models as mcost
from bench.cost.peaks import PEAK_FLOPS
from bench.reference import codec as rcodec

KIND = "round"
END_TO_END = ("round_s",)
ENCODE_BLOCK = 25            # clients the reference encodes at a time


# ------------------------------------------------------------ weights
def cnn_params(gen: torch.Generator, model: Dict) -> Dict:
    """The CNN's tree (HWIO convs, (in, out) dense), weights normal over
    ``sqrt(fan_in)``, biases zero."""
    dev = gen.device
    p, c_in, k = {}, model["input_shape"][-1], model["conv_kernel"]
    for i, c_out in enumerate(model["conv_channels"]):
        w = torch.randn((k, k, c_in, c_out), generator=gen, device=dev)
        p[f"conv{i}"] = {"w": w * (k * k * c_in) ** -0.5,
                         "b": torch.zeros(c_out, device=dev)}
        c_in = c_out
    h = model["input_shape"][0]
    for i in range(len(model["conv_channels"])):
        h = h - k + 1
        if i % 2 == 1:
            h //= 2
    dims = [h * h * c_in, *model["dense_hidden"], model["n_classes"]]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn((a, b), generator=gen, device=dev)
        p[f"dense{i}"] = {"w": w * a ** -0.5,
                          "b": torch.zeros(b, device=dev)}
    return p


def chunked_ae(gen: torch.Generator, codec_cfg: Dict) -> Dict:
    """A chunked AE drawn from ``gen``: layers ``chunk → hidden… →
    latent`` and back, weights normal over ``sqrt(fan_in)``, biases zero,
    the normalizer ``(0, norm_std)``."""
    dev = gen.device
    enc = [codec_cfg["chunk_size"], *codec_cfg["hidden"],
           codec_cfg["latent_chunk"]]
    dec = enc[::-1]

    def dense(a, b):
        w = torch.randn((a, b), generator=gen, device=dev)
        return {"w": w * a ** -0.5, "b": torch.zeros(b, device=dev)}
    return {"enc": [dense(a, b) for a, b in zip(enc[:-1], enc[1:])],
            "dec": [dense(a, b) for a, b in zip(dec[:-1], dec[1:])],
            "norm": {"mean": torch.zeros((), device=dev),
                     "std": torch.full((), codec_cfg["norm_std"],
                                       device=dev)}}


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.clone()


# ------------------------------------------------------------ inputs
def inputs(cell: Dict, config: Dict, seed: int, device: torch.device
           ) -> SimpleNamespace:
    """Everything the cell draws from ``--seed``: the same for the
    program and for the reference."""
    w = bdata.seed_words(seed, 5)
    model, n, per = config["model"], cell["n_clients"], cell["shard"]
    g0 = cnn_params(bdata.generator(w[0], device), model)
    ae = chunked_ae(bdata.generator(w[1], device), config["codec"])
    full = bdata.cifar_like(bdata.generator(w[2], device),
                            n * per + cell["eval"],
                            tuple(model["input_shape"]), model["n_classes"])
    train = {k: v[:n * per] for k, v in full.items()}
    ev = {k: v[n * per:] for k, v in full.items()}
    fl = dict(config["fl"], cohort=cell["cohort"],
              local_epochs=cell["local_epochs"],
              sample_seed=w[3], seed=w[4] % 4000)
    return SimpleNamespace(g0=g0, ae=ae, train=train, eval=ev, fl=fl,
                           per=per, n=n)


def build_program(cell: Dict, config: Dict, x: SimpleNamespace,
                  device: torch.device):
    """The port's ``FederatedRun`` on the drawn inputs; the global model
    handed in through the task's ``init_params``."""
    from repro_torch.configs.paper import ClassifierConfig
    from repro_torch.core import (ChunkedAECompressor, ChunkedAEConfig,
                                  ComposedCompressor, FederatedRun,
                                  FLConfig, SampledSync, SyncFedAvg)
    from repro_torch.core.task import ClassifierTask
    m, c = config["model"], config["codec"]
    clf = ClassifierConfig(
        name=m["name"], kind=m["kind"], input_shape=tuple(m["input_shape"]),
        n_classes=m["n_classes"], conv_channels=tuple(m["conv_channels"]),
        conv_kernel=m["conv_kernel"], dense_hidden=tuple(m["dense_hidden"]))
    task = ClassifierTask(clf)
    g_prog = clone(x.g0)
    task.init_params = lambda gen, dev: g_prog
    ae_cfg = ChunkedAEConfig(chunk_size=c["chunk_size"],
                             hidden=tuple(c["hidden"]),
                             latent_chunk=c["latent_chunk"])
    ae = clone(x.ae)
    comps = [ComposedCompressor(ChunkedAECompressor(ae, ae_cfg,
                                                    use_kernel=True),
                                bits=c["bits"], block=c["block"])
             for _ in range(x.n)]
    sched = (SampledSync(cohort=x.fl["cohort"],
                         sample_seed=x.fl["sample_seed"])
             if cell["scheduler"] == "sampled" else SyncFedAvg())
    fl = x.fl
    run = FederatedRun(
        task, bdata.split_even(x.train, x.n, x.per),
        FLConfig(n_rounds=1, local_epochs=fl["local_epochs"], lr=fl["lr"],
                 batch_size=fl["batch_size"], optimizer=fl["optimizer"],
                 payload=fl["payload"], error_feedback=fl["error_feedback"],
                 server_lr=fl["server_lr"], seed=fl["seed"]),
        compressors=comps, eval_data=x.eval, scheduler=sched, device=device)
    return run, sched


# ------------------------------------------------------------ the cell
class _FirstSteps:
    """Wrappers that keep, of the first round's client training, the first
    step's losses (``prepass._batched_grad``'s first call) and the
    optimizer's first moments after its first update (``make_optimizer``
    as ``prepass`` binds it), and of its encodes each codec input and
    payload (``codec.encode``)."""

    def __init__(self):
        self.loss = None
        self.moment = None
        self.inputs: List[torch.Tensor] = []
        self.codes: List = []

    def targets(self):
        prepass = importlib.import_module("repro_torch.core.prepass")
        codec_mod = importlib.import_module("repro_torch.core.codec")

        def grad_factory(fn):
            def build(*a, **k):
                grad_fn = fn(*a, **k)

                def first(*b, **kw):
                    out = grad_fn(*b, **kw)
                    if self.loss is None:
                        self.loss = out[1]["loss"].detach().clone()
                    return out
                return first
            return build

        def opt_factory(fn):
            def build(*a, **k):
                opt = fn(*a, **k)

                def update(params, grads, state, **kw):
                    new = opt.update(params, grads, state, **kw)
                    if self.moment is None:
                        self.moment = clone(new[1]["m"])
                    return new
                return dataclasses.replace(opt, update=update)
            return build

        def encode_factory(fn):
            def encode(spec, params, flat):
                payload = fn(spec, params, flat)
                self.inputs.append(flat.detach().clone())
                self.codes.append((payload["z_q"].clone(),
                                   payload["z_scales"].clone()))
                return payload
            return encode

        return [(prepass, "_batched_grad", grad_factory),
                (prepass, "make_optimizer", opt_factory),
                (codec_mod, "encode", encode_factory)]


def setup(cell: Dict, config: Dict, seed: int, device: torch.device
          ) -> SimpleNamespace:
    from repro_torch.core.pytree import ravel
    x = inputs(cell, config, seed, device)
    run, sched = build_program(cell, config, x, device)
    sut = SimpleNamespace(cell=cell, config=config, seed=seed,
                          device=device, x=x, run=run, sched=sched,
                          next_round=0, attempted=0, failed=0, records=[])
    first = _FirstSteps()
    for r in range(cell["check_rounds"]):
        if r == 0:
            with tracing.patched(first.targets()):
                rec = sched.run_round(r)
            b1 = config["fl"]["adam_b1"]
            sut.first_loss = first.loss
            sut.first_grad = checks.leaf_norms(
                checks.tree_scale(first.moment, 1.0 / (1.0 - b1)))
            sut.enc_in = torch.stack(first.inputs)
            sut.codes = (torch.stack([q for q, _ in first.codes]),
                         torch.stack([s for _, s in first.codes]))
            sut.delta1 = ravel(run.global_params)[0] - ravel(x.g0)[0]
            sut.first = checks.leaf_norms(
                checks.tree_diff(run.global_params, x.g0))
        else:
            rec = sched.run_round(r)
        sut.records.append({
            "cohort": list(rec.participants), "bytes_up": rec.bytes_up,
            "loss": sum(m["loss"] for m in rec.collab_metrics)
            / len(rec.collab_metrics)})
    sut.change = checks.leaf_norms(checks.tree_diff(run.global_params, x.g0))
    sut.next_round = cell["check_rounds"]
    tracing.sync(device)
    return sut


def step(sut) -> None:
    sut.sched.run_round(sut.next_round)
    sut.next_round += 1


def window(sut, seconds: float) -> Dict[str, float]:
    """Whole rounds until ``seconds`` have passed, one synchronize at the
    end: the window's seconds over its rounds."""
    tracing.sync(sut.device)
    t0, n = time.perf_counter(), 0
    marks = [t0]
    while n == 0 or time.perf_counter() - t0 < seconds:
        step(sut)
        n += 1
        marks.append(time.perf_counter())
    tracing.sync(sut.device)
    dt = time.perf_counter() - t0
    sut.attempted = n
    print("bench: host seconds of each round "
          + " ".join(f"{b - a:.4f}" for a, b in zip(marks[:-1], marks[1:])),
          file=sys.stderr, flush=True)
    return {"round_s": dt / n}


def round_flops(cell: Dict, config: Dict) -> float:
    """Operations the round's forward and backward passes require: each
    cohort client's trained images, every epoch, and the evaluation's
    forward."""
    fwd, train = mcost.cnn_train_flops(config["model"])
    bs = config["fl"]["batch_size"]
    images = cell["shard"] // bs * bs
    return (cell["cohort"] * cell["local_epochs"] * images * train
            + cell["eval"] * fwd)


def traced(sut, seconds: float) -> tracing.Trace:
    trace = tracing.Trace(kind=KIND)
    sched_mod = importlib.import_module("repro_torch.core.scheduler")
    task = sut.run.task
    spans = [("client_train", task, "local_update_batched"),
             ("client_train", task, "local_update"),
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
        "records", "first_loss", "first_grad", "first", "change", "codes",
        "enc_in", "delta1")}


def reference_readings(cell: Dict, config: Dict, seed: int,
                       device: torch.device) -> Dict:
    """The reference's first ``check_rounds`` rounds, on inputs drawn
    again from the seed."""
    from bench.reference import cnn_round
    x = inputs(cell, config, seed, device)
    data = {"x": x.train["x"].reshape(x.n, x.per, *x.train["x"].shape[1:]),
            "y": x.train["y"].reshape(x.n, x.per)}
    out = cnn_round.run_rounds(x.g0, data, x.ae, config["model"], x.fl,
                               config["codec"], cell["check_rounds"])
    o = out[0]
    return {"records": [{"cohort": r["cohort"], "bytes_up": r["bytes_up"],
                         "loss": r["loss"]} for r in out],
            "first_loss": o["first_loss"],
            "first_grad": {f"{k}/{m}": v ** 0.5
                           for (k, m), v in o["grad_sq"].items()},
            "first": checks.leaf_norms(checks.tree_diff(o["params"], x.g0)),
            "change": checks.leaf_norms(
                checks.tree_diff(out[-1]["params"], x.g0)),
            "codes": (o["codes"], o["scales"]),
            "enc_in": o["inputs"], "delta1": o["delta"]}


def staged(side: Dict, cell: Dict, config: Dict, seed: int,
           device: torch.device) -> Dict[str, float]:
    """The codec and the server held stage by stage, from ``side``'s own
    state: the reference encodes ``side``'s first-round codec inputs (the
    share of codes that differ from ``side``'s), and aggregates ``side``'s
    codes into the server's update (the largest gap over the largest
    value)."""
    c = config["codec"]
    x = inputs(cell, config, seed, device)
    q_side, s_side = side["codes"]
    diff = 0
    for i in range(0, side["enc_in"].shape[0], ENCODE_BLOCK):
        q, _ = rcodec.composed_encode(
            x.ae, side["enc_in"][i:i + ENCODE_BLOCK], c["chunk_size"],
            c["bits"], c["block"])
        diff += int((q != q_side[i:i + ENCODE_BLOCK]).sum())
    size = side["delta1"].numel()
    n_chunks = -(-size // c["chunk_size"])
    z = rcodec.composed_latents(q_side, s_side, n_chunks, c["latent_chunk"])
    w = torch.full((z.shape[0],), 1.0 / z.shape[0], device=z.device)
    mean = rcodec.weighted_mean_decode(x.ae, z, w, size)
    return {"encode": diff / q_side.numel(),
            "aggregate": checks.max_gap(side["delta1"], mean)}


def readings(prog: Dict, ref: Dict, stages: Dict[str, float]
             ) -> Dict[str, float]:
    """Every number the round cells (CNN and LM) compare, by name."""
    leaves = checks.counted(ref["first_grad"])
    pairs = list(zip(prog["records"], ref["records"]))
    out = {"records": float(sum(int(p["cohort"] != r["cohort"])
                                + int(p["bytes_up"] != r["bytes_up"])
                                for p, r in pairs))}
    lp, lr = prog["first_loss"].double(), ref["first_loss"].double()
    out["first_loss"] = float(((lp - lr).abs() / lr.abs()).max())
    out["first_grad"] = checks.worst_leaf_gap(
        prog["first_grad"], ref["first_grad"], leaves)
    out.update(stages)
    out["loss"] = max(checks.rel_gap(p["loss"], r["loss"]) for p, r in pairs)
    out["first_update"] = checks.worst_leaf_gap(prog["first"], ref["first"],
                                                leaves)
    out["change"] = checks.worst_leaf_gap(prog["change"], ref["change"],
                                          leaves)
    return out


def free(sut) -> None:
    sut.run = sut.sched = sut.x = None
    gc.collect()
    if sut.device.type == "cuda":
        torch.cuda.empty_cache()


def check_readings(sut) -> Dict[str, float]:
    prog = program_readings(sut)
    cell, config, seed, dev = sut.cell, sut.config, sut.seed, sut.device
    free(sut)
    with tf32(False):
        ref = reference_readings(cell, config, seed, dev)
        stages = staged(prog, cell, config, seed, dev)
    return readings(prog, ref, stages)


def control_readings(cell: Dict, config: Dict, seed: int,
                     device: torch.device) -> Dict[str, float]:
    """The reference computed with TF32 (the precision below the
    configuration's float32) in the program's place, held to the
    reference at float32."""
    with tf32(True):
        low = reference_readings(cell, config, seed, device)
    with tf32(False):
        ref = reference_readings(cell, config, seed, device)
        stages = staged(low, cell, config, seed, device)
    return readings(low, ref, stages)


def faults(name: str) -> list:
    """Patch targets that break the timed path underneath: ``unchanged``,
    a round that leaves the global model as it was; ``half_batch``, each
    client's loss taken over half of its batch."""
    sched_mod = importlib.import_module("repro_torch.core.scheduler")
    prepass = importlib.import_module("repro_torch.core.prepass")
    if name == "unchanged":
        return [(sched_mod, "_server_aggregate",
                 lambda fn: lambda run, *a, **k: run.global_params)]
    if name == "half_batch":
        def half(fn):
            def loss(p, cfg, batch):
                return fn(p, cfg, {k: v[:v.shape[0] // 2]
                                   for k, v in batch.items()})
            return loss
        return [(prepass, "classifier_loss", half)]
    raise KeyError(name)


FAULTS = ("unchanged", "half_batch")


class tf32:
    """Sets TF32 for float32 products and convolutions, restoring it on
    exit."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
