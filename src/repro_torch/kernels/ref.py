"""Plain PyTorch versions of the six ported kernels.

Each is the same function as its CUDA kernel, written with ordinary torch
ops. The wrappers take them for CPU tensors (the CPU tests run the port on
these), and ``chip_smoke.py`` holds every kernel against its plain version
on the card. Kernel 6's plain version is a case of
``chunked_attention_ref``, the chunked attention math that the model's
``flash_attention`` also runs on the CPU outside the kernel's contract.
"""
from __future__ import annotations

import torch


def fused_dense_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    act: str = "relu") -> torch.Tensor:
    y = x.float() @ w.float() + b.float()
    if act == "relu":
        y = torch.relu(y)
    elif act == "tanh":
        y = torch.tanh(y)
    elif act == "sigmoid":
        y = torch.sigmoid(y)
    elif act != "linear":
        raise ValueError(act)
    return y.to(x.dtype)


def quantize_blocks_ref(x: torch.Tensor, bits: int = 8):
    """x: (n_blocks, block) → (q int8, scales f32 (n_blocks,)). True
    divisions throughout (a divisor tensor, not a Python scalar, which
    PyTorch on CUDA turns into a reciprocal multiply) and half-to-even
    rounding, as the reference computes."""
    qmax = float(2 ** (bits - 1) - 1)
    xf = x.float()
    absmax = torch.amax(torch.abs(xf), dim=1, keepdim=True)
    scale = torch.clamp_min(absmax / torch.full_like(absmax, qmax), 1e-12)
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    return q.to(torch.int8), scale[:, 0]


def dequantize_blocks_ref(q: torch.Tensor, scales: torch.Tensor
                          ) -> torch.Tensor:
    return q.float() * scales[:, None]


def fused_decode_agg_ref(h: torch.Tensor, weights: torch.Tensor,
                         w_last: torch.Tensor, b_last: torch.Tensor
                         ) -> torch.Tensor:
    """``Σ_c w_c·(h_c @ W) + b`` reduced before the expand, as the kernel
    does: no per-client ``(M, N)`` tensor here either."""
    hbar = torch.einsum("c,cmk->mk", weights.float(), h.float())
    return hbar @ w_last.float() + b_last.float()


def grouped_fused_decode_agg_ref(hs, weights, w_stack: torch.Tensor,
                                 b_stack: torch.Tensor, dec_idx):
    """The grouped ragged launch on a ``(D, K, N)`` decoder stack: see
    :func:`grouped_decode_agg_decoders_ref`."""
    return grouped_decode_agg_decoders_ref(
        hs, weights, [(w_stack[d], b_stack[d])
                      for d in range(w_stack.shape[0])],
        dec_idx, w_stack.shape[2])


def grouped_decode_agg_decoders_ref(hs, weights, decoders, dec_idx,
                                    N: int):
    """The grouped ragged launch as one materialize-then-reduce pass per
    bucket, in bucket order: every client's ``(M_b, N)`` decode is built,
    then weighted and summed; ``decoders[dec_idx[b]]`` is bucket ``b``'s
    ``(W, bias)``. Empty buckets (zero clients) return exact zeros, as the
    kernel does."""
    out = []
    for h, w, d in zip(hs, weights, dec_idx):
        if h.shape[0] == 0:
            out.append(torch.zeros((h.shape[1], N), dtype=torch.float32,
                                   device=h.device))
            continue
        W, b = decoders[d]
        per_client = h.float() @ W.float()
        out.append(torch.einsum("c,cmn->mn", w.float(), per_client)
                   + b.float())
    return out


def chunked_attention_ref(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, mode: str = "causal",
                          q_offset: int = 0, window=None,
                          softcap: float = 0.0, q_chunk: int = 512,
                          kv_chunk: int = 1024, extra_qk=None,
                          scale=None) -> torch.Tensor:
    """Chunked online-softmax attention, the plain math of the reference's
    ``models.attention.flash_attention`` (``lax.map`` over query chunks,
    ``lax.scan`` over kv chunks, here two Python loops), so no (Sq, Skv)
    matrix is built.

    q: (B, Sq, H, D); k: (B, Skv, KV, D); v: (B, Skv, KV, Dv); head ``h``
    reads kv head ``h // G`` with ``G = H // KV``. Blocks are cast to
    float32 and the scores scaled (by ``D ** -0.5`` unless ``scale`` is
    given); ``extra_qk=(q2 (B, Sq, H, P2), k2 (B, Skv, P2))`` adds a
    head-shared score term before the scale, ``softcap`` a tanh cap after
    it. The masks are kv padding ``k_ids < Skv``, causal ``k_ids <= q_ids``
    and window ``k_ids > q_ids - window`` (``q_ids`` counted from
    ``q_offset``), masked scores set to -1e30; q, k and v are zero-padded
    to whole chunks and the output is ``acc / max(l, 1e-30)`` cast to q's
    dtype.
    """
    B, Sq, H, D = q.shape
    _, Skv, KV, Dv = v.shape
    G = H // KV
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    pad = torch.nn.functional.pad

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    nq, nk = -(-Sq // q_chunk), -(-Skv // kv_chunk)
    q_pad, kv_pad = nq * q_chunk - Sq, nk * kv_chunk - Skv
    qb = pad(q, (0, 0, 0, 0, 0, q_pad)).reshape(B, nq, q_chunk, KV, G, D)
    kb = pad(k, (0, 0, 0, 0, 0, kv_pad)).reshape(B, nk, kv_chunk, KV, D)
    vb = pad(v, (0, 0, 0, 0, 0, kv_pad)).reshape(B, nk, kv_chunk, KV, Dv)
    if extra_qk is not None:
        q2, k2 = extra_qk
        P2 = q2.shape[-1]
        q2b = pad(q2, (0, 0, 0, 0, 0, q_pad)).reshape(
            B, nq, q_chunk, KV, G, P2)
        k2b = pad(k2, (0, 0, 0, kv_pad)).reshape(B, nk, kv_chunk, P2)

    def mask_block(qi: int, kj: int) -> torch.Tensor:
        """(qc, kc) bool mask for query block qi vs kv block kj."""
        q_ids = (qi * q_chunk + torch.arange(q_chunk, device=dev)[:, None]
                 + q_offset)
        k_ids = kj * kv_chunk + torch.arange(kv_chunk, device=dev)[None, :]
        valid = k_ids < Skv                        # kv padding
        if mode == "full":
            return valid
        m = k_ids <= q_ids
        if mode == "window":
            m &= k_ids > q_ids - window
        return m & valid

    outs = []
    for qi in range(nq):
        q_blk = qb[:, qi].float()                  # (B, qc, KV, G, D)
        m_run = torch.full((B, KV, G, q_chunk), -1e30, device=dev)
        l_run = torch.zeros((B, KV, G, q_chunk), device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, Dv), device=dev)
        for kj in range(nk):
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, kb[:, kj].float())
            if extra_qk is not None:
                s = s + torch.einsum("bqkgp,bsp->bkgqs",
                                     q2b[:, qi].float(), k2b[:, kj].float())
            s = s * scale
            if softcap > 0.0:
                s = torch.tanh(s / softcap) * softcap
            s = torch.where(mask_block(qi, kj), s, -1e30)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vb[:, kj].float())
            m_run = m_new
        out = acc / torch.clamp_min(l_run, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))    # (B, qc, KV, G, Dv)
    out = torch.cat(outs, dim=1).reshape(B, nq * q_chunk, H, Dv)
    return out[:, :Sq].to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, mode: str = "causal", window=None,
                        kv_block: int = 128, scale=None, q_offset: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """Forward attention the way kernel 6 computes it:
    ``chunked_attention_ref`` in one query chunk over kv blocks of
    ``kv_block``, which at ``q_offset == 0``, ``softcap == 0`` is block for
    block the Pallas kernel's online softmax (``flash_attention_pallas``).
    ``scale`` defaults to ``D ** -0.5``; ``q_offset`` and ``softcap`` are
    the reference scan's (``models.attention.flash_attention``), which the
    CUDA kernel also takes."""
    return chunked_attention_ref(q, k, v, mode=mode, window=window,
                                 q_chunk=q.shape[1], kv_chunk=kv_block,
                                 scale=scale, q_offset=q_offset,
                                 softcap=softcap)
