"""Batched serving example on the port: prefill a prompt batch, then decode
tokens with the KV/state cache — the same prefill/decode steps the dry-run
builds at (32, 32768) and (128, 32768) scale, here at the config's reduced
widths. On the card the prefill's attention runs the flash-attention
kernel.

Works for every architecture family, including attention-free (mamba2) and
hybrid (recurrentgemma) whose decode state is O(1) in context length.

Run: PYTHONPATH=src python -m repro_torch.examples.llm_serve_decode \\
         --arch mamba2-2.7b
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.examples._common import Printer, clock, parse, parser
from repro_torch.models import decode_step, init_params, prefill


def prompt_batch(cfg, B: int, S: int, device) -> dict:
    """B prompts of S tokens, and the audio frames or image embeddings the
    family's stub frontend takes, drawn from one CPU generator."""
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=g)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((B, cfg.encdec.n_frames, cfg.d_model),
                                      generator=g)
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(
            (B, cfg.vlm.n_image_tokens, cfg.d_model), generator=g)
    return {k: v.to(device) for k, v in batch.items()}


@torch.no_grad()
def serve(cfg, params, batch: dict, new_tokens: int, device, out: Printer,
          window: Optional[int] = None, forced: Optional[list] = None
          ) -> dict:
    """Prefill ``batch`` and decode ``new_tokens - 1`` greedy tokens.
    ``forced`` (a list of (B, 1) token tensors) feeds the given tokens in
    place of the greedy ones, so two devices' logits can be compared
    along one token path. Returns the logits of every step on the host."""
    B, S = batch["tokens"].shape
    cache_len = S + new_tokens
    t0 = clock(device)
    logits, cache = prefill(params, cfg, batch, cache_len=cache_len,
                            window=window)
    prefill_s = clock(device) - t0
    out(f"== {cfg.name}: prefilled {B}x{S} in {prefill_s:.2f}s ==")
    steps = [logits.float().cpu()]

    def next_token(i, logits):
        if forced is not None:
            return forced[i].to(device)
        return logits[:, :cfg.vocab_size].argmax(-1)[:, None].to(
            torch.int32)

    tok = next_token(0, logits)
    out_tokens = [tok]
    t0 = clock(device)
    for i in range(new_tokens - 1):
        logits, cache = decode_step(params, cfg, tok, cache, window=window)
        steps.append(logits.float().cpu())
        tok = next_token(i + 1, logits)
        out_tokens.append(tok)
    dt = clock(device) - t0
    gen = torch.cat(out_tokens, dim=1).cpu()
    out(f"decoded {new_tokens - 1} tokens/seq in {dt:.2f}s "
        f"({(new_tokens - 1) * B / max(dt, 1e-9):.1f} tok/s)")
    out(f"sample: {gen[0][:12].tolist()}")
    return {"arch": cfg.name, "batch": B, "prompt": S,
            "new_tokens": new_tokens, "prefill_s": prefill_s,
            "decode_s": dt, "tokens": gen, "logits": steps}


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--window", type=int, default=None,
                    help="sliding-window decode (long-context mode)")
    args = parse(ap, argv)
    out = Printer()
    cfg = get_config(args.arch).reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, args.device)
    batch = prompt_batch(cfg, args.batch, args.prompt_len, args.device)
    res = serve(cfg, params, batch, args.new_tokens, args.device, out,
                window=args.window)
    return dict(res, lines=out.lines)


if __name__ == "__main__":
    main()
