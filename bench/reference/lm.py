"""The plain reference of an FL round of LM delta fine-tuning over a dense
decoder (StableLM-2's block: pre-LayerNorm, attention with rotary
embedding on the first quarter of each head's dims, a SwiGLU MLP, no
biases on the projections; an untied LM head), with the embedding and the
head frozen.

Every client starts from the global model, takes one Adam step a batch
on its own sequences, ships its update (error-feedback compensated)
through a codec a parameter role (the MLP's weights through a chunked
autoencoder, every other role through blockwise int8), and the server adds
the weighted mean of the decoded updates to the global model.

Precision as the configuration states it: parameters, optimizer and
codec in float32; the model's products on bfloat16 operands (the
activations between layers in bfloat16), norms, rotary angles, attention
scores, softmax and the loss in float32. ``mm`` carries every product with
bfloat16 operands, so the control swaps it for products on float8
operands (:class:`Fp8Matmul`). Parameter trees flatten with dict keys
sorted, leaf by leaf row-major (stacked layers leading), the flat order
the codec's groups are cut from.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from bench.reference import codec
from bench.reference.cnn_round import batch_order

Tree = Dict[str, object]
BF16 = torch.bfloat16


# ------------------------------------------------------------ products
def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.to(BF16) @ b.to(BF16)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, returned in bfloat16."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    s = 448.0 / amax
    q = (x.float() * s).to(torch.float8_e4m3fn).float() / s
    return q.to(BF16)


class Fp8Matmul(torch.autograd.Function):
    """A product on float8 operands, forward and backward (each backward
    product's operands rounded to float8 too), accumulated as bfloat16
    products are."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _fp8(a) @ _fp8(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = _fp8(g) @ _fp8(b).transpose(-1, -2)
        gb = _fp8(a).transpose(-1, -2) @ _fp8(g)
        while gb.dim() > b.dim():            # products broadcast over b
            gb = gb.sum(0)
        return ga.to(a.dtype), gb.to(b.dtype)


def mm_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return Fp8Matmul.apply(a.to(BF16), b.to(BF16))


# ------------------------------------------------------------ weights
def role(path: str) -> str:
    """A leaf's role by the names on its path: the embedding and the LM
    head, norms, attention projections, the MLP."""
    parts = path.split("/")
    if parts[0] in ("embed", "lm_head"):
        return "embedding"
    if any(p in ("final_norm", "ln1", "ln2") for p in parts):
        return "norm"
    if "attn" in parts:
        return "attention"
    if "ffn" in parts:
        return "mlp"
    raise ValueError(f"no role for {path}")


def init_params(gen: torch.Generator, m: Dict) -> Tree:
    """The model drawn on ``gen``'s device, one call a leaf: products'
    weights normal over ``sqrt(fan_in)``, the embedding and head normal
    times 0.02, norm scales one and biases zero. Stacked ``(L, …)``
    layers, ``(in, out)`` products, the head ``(d, vocab)``."""
    dev, L = gen.device, m["n_layers"]
    d, F, V = m["d_model"], m["d_ff"], m["vocab_size"]
    q, kv = m["n_heads"] * m["head_dim"], m["n_kv_heads"] * m["head_dim"]

    def w(*shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev) * fan_in ** -0.5

    def norm(*lead):
        return {"bias": torch.zeros(*lead, d, device=dev),
                "scale": torch.ones(*lead, d, device=dev)}
    return {
        "embed": torch.randn((V, d), generator=gen, device=dev) * 0.02,
        "final_norm": norm(),
        "layers": {
            "attn": {"wq": w(L, d, q, fan_in=d), "wk": w(L, d, kv, fan_in=d),
                     "wv": w(L, d, kv, fan_in=d), "wo": w(L, q, d, fan_in=q)},
            "ffn": {"w_gate": w(L, d, F, fan_in=d),
                    "w_up": w(L, d, F, fan_in=d),
                    "w_down": w(L, F, d, fan_in=F)},
            "ln1": norm(L), "ln2": norm(L)},
        "lm_head": torch.randn((d, V), generator=gen, device=dev) * 0.02,
    }


def leaves(tree: Tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += leaves(v, f"{prefix}{k}/")
        else:
            out.append((prefix + k, v))
    return out


def ravel(tree: Tree) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for _, t in leaves(tree)])


def shapes(m: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Each leaf's path and shape, in flat order (:func:`init_params`'s
    tree without drawing it)."""
    L, d, F, V = m["n_layers"], m["d_model"], m["d_ff"], m["vocab_size"]
    q, kv = m["n_heads"] * m["head_dim"], m["n_kv_heads"] * m["head_dim"]
    tree = {"embed": (V, d), "final_norm": {"bias": (d,), "scale": (d,)},
            "layers": {"attn": {"wq": (L, d, q), "wk": (L, d, kv),
                                "wv": (L, d, kv), "wo": (L, q, d)},
                       "ffn": {"w_gate": (L, d, F), "w_up": (L, d, F),
                               "w_down": (L, F, d)},
                       "ln1": {"bias": (L, d), "scale": (L, d)},
                       "ln2": {"bias": (L, d), "scale": (L, d)}},
            "lm_head": (d, V)}
    return leaves(tree)


def unravel(flat: torch.Tensor, layout) -> Tree:
    """Views of ``flat`` as the tree of ``layout`` (:func:`shapes`)."""
    out, i = {}, 0
    for path, shape in layout:
        n = int(np.prod(shape))
        node = out
        parts = path.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = flat[i:i + n].reshape(shape)
        i += n
    return out


def groups(layout) -> Dict[str, List[Tuple[int, int]]]:
    """Role → the ``(offset, size)`` slices of its leaves in flat order,
    roles in the order they first appear."""
    out: Dict[str, List[Tuple[int, int]]] = {}
    off = 0
    for path, shape in layout:
        n = int(np.prod(shape))
        out.setdefault(role(path), []).append((off, n))
        off += n
    return out


def windows(layout, seed: int, size: int = 1 << 20, align: int = 256
            ) -> Dict:
    """Where the codec and the server are compared stage by stage, drawn
    from ``seed``: of each trained role, in its largest leaf, one piece in
    each slice of the leaf's leading (layer) axis, ``size`` values in all,
    each piece whole codec blocks and chunks (``align``-ed in the role's
    gathered vector). Role → ``(path, pieces, length)``, a piece ``(flat
    offset, offset in the role's vector, offset in the leaf)``; a role
    whose slices hold no aligned piece has none."""
    rng = np.random.default_rng(seed)
    best: Dict[str, tuple] = {}
    off, goff = 0, {}
    for path, shape in layout:
        n, r = int(np.prod(shape)), role(path)
        gs = goff.get(r, 0)
        if r != "embedding" and n > best.get(r, (0,))[0]:
            best[r] = (n, path, shape, off, gs)
        goff[r] = gs + n
        off += n
    out = {}
    for r, (n, path, shape, off, gs) in best.items():
        slices = shape[0] if len(shape) > 1 else 1
        per = n // slices
        firsts = [-(-(gs + i * per) // align) * align for i in range(slices)]
        room = min(gs + (i + 1) * per - f for i, f in enumerate(firsts))
        length = min(size // slices, room) // align * align
        if length <= 0:
            continue
        pieces = []
        for i, first in enumerate(firsts):
            top = (gs + (i + 1) * per - first - length) // align
            go = first + align * int(rng.integers(0, top + 1))
            pieces.append((off + go - gs, go, go - gs))
        out[r] = (path, pieces, length)
    return out


def leaf_norms(flat: torch.Tensor, layout) -> Dict[str, float]:
    """Each leaf's float64 norm over the whole leaf of ``flat``."""
    out, off = {}, 0
    for path, shape in layout:
        n = int(np.prod(shape))
        out[path] = norm64(flat[off:off + n])
        off += n
    return out


def norm64(x: torch.Tensor, step: int = 1 << 24) -> float:
    """The float64 2-norm of ``x``, ``step`` values at a time."""
    x = x.reshape(-1)
    return float(sum(torch.linalg.vector_norm(x[i:i + step].double()) ** 2
                     for i in range(0, x.numel(), step)) ** 0.5)


def tree_pieces(tree: Tree, win: Dict) -> Dict[str, torch.Tensor]:
    """Each role's pieces of a model tree, one vector a role."""
    flat = dict(leaves(tree))
    return {g: torch.cat([flat[path].reshape(-1)[lo:lo + n]
                          for _, _, lo in pieces])
            for g, (path, pieces, n) in win.items()}


def window_payload(payload: Dict, win: Dict, c: Dict) -> Dict:
    """The rows of each role's payload that encode its pieces: int8 code
    blocks and their scales, or AE latent chunks."""
    out = {}
    for g, (_, pieces, n) in win.items():
        pl = payload[g]
        b = c["chunk_size"] if g == "mlp" else c["q_block"]
        keys = ("z",) if g == "mlp" else ("q", "scales")
        out[g] = {k: torch.cat([pl[k][go // b:(go + n) // b]
                                for _, go, _ in pieces]) for k in keys}
    return out


def window_values(flat: torch.Tensor, win: Dict) -> Dict[str, torch.Tensor]:
    """Each trained role's pieces of a flat vector, one vector a role."""
    return {g: torch.cat([flat[o:o + n] for o, _, _ in pieces])
            for g, (_, pieces, n) in win.items()}


# ------------------------------------------------------------ the model
def _norm(p: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    xf = xf - xf.mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * p["scale"] + p["bias"]).to(x.dtype)


def _rope(x: torch.Tensor, pct: float, theta: float) -> torch.Tensor:
    """Rotary embedding on the first ``pct`` of the head's dims, the two
    halves of that part rotated against each other, in float32."""
    S, D = x.shape[1], x.shape[-1]
    r = int(D * pct) // 2 * 2
    inv = 1.0 / theta ** (torch.arange(0, r, 2, device=x.device,
                                       dtype=torch.float32) / r)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :r // 2].float(), x[..., r // 2:r].float()
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([rot.to(x.dtype), x[..., r:]], -1)


def _attention(q, k, v) -> torch.Tensor:
    """Causal softmax attention in float32, (B, S, H, D) → bfloat16."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def loss(p: Tree, batch: Dict[str, torch.Tensor], m: Dict,
         mm: Callable = mm_bf16) -> torch.Tensor:
    """Mean next-token cross entropy over the batch."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    H, KV, Dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    eps = m["norm_eps"]
    x = p["embed"][tokens].to(BF16)
    lay = p["layers"]

    def block(x, ln1, attn, ln2, ffn):
        h = _norm(ln1, x, eps)
        q = mm(h, attn["wq"]).reshape(B, S, H, Dh)
        k = mm(h, attn["wk"]).reshape(B, S, KV, Dh)
        v = mm(h, attn["wv"]).reshape(B, S, KV, Dh)
        q = _rope(q, m["rope_pct"], m["rope_theta"])
        k = _rope(k, m["rope_pct"], m["rope_theta"])
        o = _attention(q, k, v).reshape(B, S, H * Dh)
        x = x + mm(o, attn["wo"])
        h = _norm(ln2, x, eps)
        g = torch.nn.functional.silu(mm(h, ffn["w_gate"]))
        return x + mm(g * mm(h, ffn["w_up"]), ffn["w_down"])

    for i in range(m["n_layers"]):
        args = [{k: v[i] for k, v in lay[n].items()}
                for n in ("ln1", "attn", "ln2", "ffn")]
        # a layer's activations are recomputed in the backward: only its
        # input is kept
        x = checkpoint(block, x, *args, use_reentrant=False)
    h = _norm(p["final_norm"], x, eps)
    logits = mm(h, p["lm_head"]).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, batch["labels"][..., None])[..., 0].mean()


# ------------------------------------------------------------ the round
def adam_train(g: Tree, data: Dict[str, torch.Tensor], m: Dict, fl: Dict,
               seed: int, mm: Callable, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8):
    """One client's local training from ``g``: one Adam step a batch, the
    embedding and head frozen (their gradient zero). Returns the trained
    tree, the last step's loss, and the first step's loss and each leaf's
    squared gradient norm."""
    p = {k: (v.detach() if role(k) == "embedding" else v.detach().clone())
         for k, v in leaves(g)}
    train = [k for k in p if role(k) != "embedding"]
    mom = {k: torch.zeros_like(p[k]) for k in train}
    vel = {k: torch.zeros_like(p[k]) for k in train}
    n = data["tokens"].shape[0]
    t, last, first = 0, None, None
    for epoch in range(fl["local_epochs"]):
        for sel in batch_order(seed * 1000 + epoch, n, fl["batch_size"]):
            idx = torch.as_tensor(sel, device=data["tokens"].device)
            batch = {k: v[idx] for k, v in data.items()}
            for k in train:
                p[k].requires_grad_(True)
            val = loss(nest(p), batch, m, mm)
            grads = dict(zip(train, torch.autograd.grad(
                val, [p[k] for k in train])))
            last = float(val.detach())
            if first is None:
                first = (last, {k: float((gr.double() ** 2).sum())
                                for k, gr in grads.items()})
            t += 1
            with torch.no_grad():
                for k in train:
                    gr = grads[k].float()
                    mom[k] = b1 * mom[k] + (1 - b1) * gr
                    vel[k] = b2 * vel[k] + (1 - b2) * gr * gr
                    mhat = mom[k] / (1 - b1 ** t)
                    vhat = vel[k] / (1 - b2 ** t)
                    p[k] = (p[k] - fl["lr"] * mhat /
                            (torch.sqrt(vhat) + eps)).detach()
    return nest(p), last, first


def nest(flat: Dict[str, torch.Tensor]) -> Tree:
    out: Tree = {}
    for path, t in flat.items():
        node = out
        parts = path.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = t
    return out


def encode(flat: torch.Tensor, grp: Dict, ae: Dict, c: Dict) -> Dict:
    """Each role's gathered slice through its codec: the MLP's to AE
    latents ``z``, every other role's to int8 ``(q, scales)``."""
    out = {}
    for name, sl in grp.items():
        x = torch.cat([flat[o:o + s] for o, s in sl])
        if name == "mlp":
            out[name] = {"z": codec.ae_encode(ae, x, c["chunk_size"])}
        else:
            q, s = codec.quantize(x, c["bits"], c["q_block"])
            out[name] = {"q": q, "scales": s}
    return out


def decode(payload: Dict, grp: Dict, ae: Dict, size: int) -> torch.Tensor:
    out = torch.zeros(size, device=next(iter(
        next(iter(payload.values())).values())).device)
    for name, sl in grp.items():
        n = sum(s for _, s in sl)
        pl = payload[name]
        x = (codec.ae_decode(ae, pl["z"], n) if name == "mlp"
             else codec.dequantize(pl["q"], pl["scales"], n))
        pos = 0
        for o, s in sl:
            out[o:o + s] = x[pos:pos + s]
            pos += s
    return out


def aggregate(payloads: List[Dict], w: torch.Tensor, grp: Dict, ae: Dict,
              size: int) -> torch.Tensor:
    """The weighted mean of the decoded updates, the MLP's through one
    pass of the AE's linear last layer over the weighted hidden sum."""
    out = torch.zeros(size, device=w.device)
    for name, sl in grp.items():
        n = sum(s for _, s in sl)
        if name == "mlp":
            z = torch.stack([pl[name]["z"] for pl in payloads])
            x = codec.weighted_mean_decode(ae, z, w, n)
        else:
            x = sum(wc * codec.dequantize(pl[name]["q"], pl[name]["scales"],
                                          n)
                    for wc, pl in zip(w, payloads))
        pos = 0
        for o, s in sl:
            out[o:o + s] = x[pos:pos + s]
            pos += s
    return out


def payload_bytes(payload: Dict) -> float:
    return float(sum(t.numel() * t.element_size()
                     for pl in payload.values() for t in pl.values()))


def run_rounds(gflat0: torch.Tensor, layout, win: Dict, shards: List[Dict],
               ae: Dict, m: Dict, fl: Dict, c: Dict, rounds: int,
               mm: Callable = mm_bf16) -> List[Dict]:
    """``rounds`` synchronous rounds from the flat model ``gflat0`` (laid
    out as ``layout``) over every client's shard. Returns per round the
    cohort, the mean last-step loss, the uplink bytes and each leaf's
    norm of the model's change so far, over the whole leaf; of the first
    round each client's first-step loss, the
    squared norm of each leaf's first gradient over the clients, and over
    the roles' pieces (``win``, :func:`windows`) the codec inputs, the payloads' rows and the
    server's update."""
    grp = groups(layout)
    size = gflat0.numel()
    w = torch.full((len(shards),), 1.0 / len(shards), device=gflat0.device)
    residual: Dict[int, torch.Tensor] = {}
    gflat, out = gflat0.clone(), []
    for r in range(rounds):
        seed = fl["seed"] * 997 + r
        g = unravel(gflat, layout)
        losses, payloads, inputs, rows, firsts = [], [], [], [], []
        grad_sq: Dict[str, float] = {}
        for ci, data in enumerate(shards):
            local, last, (f_loss, f_grad) = adam_train(g, data, m, fl, seed,
                                                       mm)
            losses.append(last)
            firsts.append(f_loss)
            for k, sq in f_grad.items():
                grad_sq[k] = grad_sq.get(k, 0.0) + sq
            with torch.no_grad():
                upd = ravel(local)
                del local
                upd.sub_(gflat)
                if ci in residual:
                    upd.add_(residual.pop(ci))
                pl = encode(upd, grp, ae, c)
                if r == 0:
                    inputs.append(window_values(upd, win))
                    rows.append(window_payload(pl, win, c))
                dec = decode(pl, grp, ae, size)
                residual[ci] = dec.neg_().add_(upd)
                del upd, dec
            payloads.append(pl)
        with torch.no_grad():
            delta = aggregate(payloads, w, grp, ae, size)
            before = window_values(gflat, win) if r == 0 else None
            gflat.add_(delta)
            del delta
            change = gflat - gflat0
            rec = {"cohort": list(range(len(shards))),
                   "loss": float(np.mean(losses)),
                   "bytes_up": sum(payload_bytes(pl) for pl in payloads),
                   "change": leaf_norms(change, layout)}
            del change
            if r == 0:
                after = window_values(gflat, win)
                rec.update(first_loss=firsts, grad_sq=grad_sq,
                           inputs=inputs, payloads=rows,
                           delta={g_: after[g_] - before[g_]
                                  for g_ in after})
        out.append(rec)
    return out
