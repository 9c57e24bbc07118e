"""End-to-end training driver (port of ``repro.launch.train``).

Two modes:

* ``--mode train`` — training of any ``--arch`` (reduced or full) on
  synthetic LM data: ``train_loss`` under autograd, then the config's
  optimizer;
* ``--mode fl`` — federated rounds with chunked-AE-compressed update
  exchange (the paper's technique, ``core/distributed.py``) on a pod group
  of one rank, which this driver initialises itself (NCCL on the card,
  gloo with ``--device cpu``, at ``tcp://127.0.0.1`` on a free port) and
  destroys at the end.

Runs on the card unless ``--device cpu``. Examples:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --reduced --steps 50 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --preset lm100m \\
      --steps 300
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --reduced --mode fl --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import socket
import time

import torch

from repro_torch.checkpoint.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.pytree import value_and_grad
from repro_torch.data.pipeline import synthetic_lm_batch
from repro_torch.device import resolve
from repro_torch.models import init_params, param_count, train_loss
from repro_torch.optim.optimizers import make_optimizer

# ~100M-parameter preset for the end-to-end example driver
LM100M = ArchConfig(
    name="lm100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, head_dim=64, d_ff=3072, vocab_size=16384,
    tie_embeddings=True, rope_theta=10000.0, activation="swiglu",
    remat=False, zero1=False, param_dtype="float32",
    compute_dtype="float32")

LM25M = dataclasses.replace(LM100M, name="lm25m", n_layers=8, d_model=384,
                            n_heads=6, n_kv_heads=2, d_ff=1536,
                            vocab_size=8192)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--preset", default=None, choices=["lm100m", "lm25m"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", default="train", choices=["train", "fl"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    if args.preset:
        cfg = LM100M if args.preset == "lm100m" else LM25M
    else:
        cfg = get_config(args.arch or "llama3-8b")
        if args.reduced:
            cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, learning_rate=args.lr)

    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)
    print(f"arch={cfg.name} params={param_count(params):,} "
          f"mode={args.mode}", flush=True)
    opt = make_optimizer(cfg.optimizer, cfg.learning_rate,
                         weight_decay=cfg.weight_decay,
                         grad_clip=cfg.grad_clip)
    opt_state = opt.init(params)

    def batch_at(i):
        return {k: v.to(dev) for k, v in synthetic_lm_batch(
            i, cfg.vocab_size, args.batch, args.seq).items()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if args.mode == "fl":
        import torch.distributed as dist
        from repro_torch.core.autoencoder import (ChunkedAEConfig,
                                                  init_chunked_ae)
        from repro_torch.core.distributed import build_fl_round_step
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
            world_size=1, device_id=dev if dev.type == "cuda" else None)
        try:
            shape = ShapeConfig("cli", args.seq, args.batch, "train")
            ae_cfg = ChunkedAEConfig(chunk_size=512, hidden=(128,),
                                     latent_chunk=16)
            bundle = build_fl_round_step(cfg, shape, None, ae_cfg)
            ae_params = init_chunked_ae(torch.Generator().manual_seed(1),
                                        ae_cfg, dev)
            t0 = time.time()
            for i in range(args.steps):
                params, opt_state, metrics = bundle.fn(
                    params, opt_state, ae_params, batch_at(i))
                if i % args.log_every == 0 or i == args.steps - 1:
                    sync()
                    print(f"fl round {i:4d} loss={float(metrics['loss']):.4f} "
                          f"acc={float(metrics['accuracy']):.3f} "
                          f"({(time.time() - t0) / (i + 1):.2f}s/round)",
                          flush=True)
        finally:
            dist.destroy_process_group()
    else:
        def loss_fn(p, b):
            return train_loss(p, cfg, b)
        t0 = time.time()
        for i in range(args.steps):
            _, metrics, grads = value_and_grad(loss_fn, params, batch_at(i))
            params, opt_state = opt.update(params, grads, opt_state,
                                           inplace=True)
            if i % args.log_every == 0 or i == args.steps - 1:
                sync()
                print(f"step {i:4d} loss={float(metrics['loss']):.4f} "
                      f"acc={float(metrics['accuracy']):.3f} "
                      f"({(time.time() - t0) / (i + 1):.2f}s/step)",
                      flush=True)

    if args.checkpoint:
        save_pytree(args.checkpoint, params,
                    metadata={"arch": cfg.name, "steps": args.steps})
        print(f"saved checkpoint to {args.checkpoint}")


if __name__ == "__main__":
    main()
