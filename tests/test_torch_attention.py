"""Kernel 6 (flash attention) and the port's attention module against the
JAX package on the CPU.

* ``flash_attention_ref`` — kernel 6's plain version, the one a CPU tensor
  takes — against ``flash_attention_pallas(..., interpret=True)`` over the
  reference's own grid (``tests/test_kernels.py``) plus a GQA group of 7,
  at the reference's float32 tolerance ``atol=3e-5, rtol=1e-3``; in
  bfloat16 within two ulps of the output, ``atol=1e-3, rtol=1.6e-2``
  (both sum in float32 and round once, so they differ by at most one);
* the model-level ``flash_attention`` (the chunked math, with ``softcap``,
  ``q_offset``, ``extra_qk``, ``Dv != D`` and a scale) and
  ``decode_attention`` against ``repro.models.attention`` in the golden
  band ``atol=2e-5, rtol=2e-4``: the same float32 arithmetic;
* kernel 6's contract: the calls that raise instead of running, and the
  calls that take its padded route (head dims ``(D, Dv)`` it has no
  instantiation for; MLA's (96, 64) and phi-3's (96, 96) are native, and
  a scale routes nothing); the native pairs at their full head widths
  (40 x 96/64, 32 x 96), the wrapper, the model-level call and
  ``mla_forward`` against the reference; the padded route's arithmetic on
  the CPU (pad, the plain version with the unpadded scale, slice) against
  ``chunked_attention_ref`` on the unpadded inputs at MLA's ``D 96 / Dv
  64`` and at the reduced MLA config's shapes;
* the port of ``tests/test_perf_features.py::
  test_flash_attention_extra_qk_matches_concat`` (decomposed scores equal
  concatenated q/k) on the CPU route, and the MLA module
  (``mla_forward``, ``mla_decode``) against the reference's on its own
  weights.

Inputs are drawn with numpy from a seed and handed to both packages.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import attention as jattn  # noqa: E402

from repro_torch.kernels import _lib, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    check_shapes, flash_attention as flash_kernel)
from repro_torch.models import attention as tattn  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)        # tests/test_golden_trajectory.py
PALLAS_TOL = dict(atol=3e-5, rtol=1e-3)  # tests/test_kernels.py
# two bfloat16 ulps (2 * 2**-7 relative) of the output, 1e-3 near zero
BF16_TOL = dict(atol=1e-3, rtol=1.6e-2)


def _qkv(seed, B, Sq, Skv, H, KV, D, Dv=None):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Sq, H, D).astype(np.float32)
    k = rs.randn(B, Skv, KV, D).astype(np.float32)
    v = rs.randn(B, Skv, KV, Dv or D).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,S,H,KV,D", [(1, 17, 2, 1, 16), (2, 64, 4, 2, 32),
                                        (1, 130, 8, 8, 64),
                                        (2, 45, 14, 2, 32)])   # G = 7
@pytest.mark.parametrize("mode,window", [("causal", None), ("window", 13),
                                         ("full", None)])
def test_flash_ref_matches_pallas_interpret(B, S, H, KV, D, mode, window):
    q, k, v = _qkv(B * S + H, B, S, S, H, KV, D)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), mode=mode, window=window,
                                  q_block=32, kv_block=32, interpret=True)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), mode=mode,
                                  window=window, kv_block=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PALLAS_TOL)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = _lib.counts()
    wrapped = flash_kernel(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), mode=mode, window=window)
    assert _lib.counts() == before
    np.testing.assert_allclose(wrapped.numpy(), np.asarray(want),
                               **PALLAS_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_dtypes_match_pallas(dtype):
    q, k, v = _qkv(3, 1, 48, 48, 4, 2, 32)
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    want = flash_attention_pallas(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                  jnp.asarray(v, jd), q_block=16,
                                  kv_block=16, interpret=True)
    got = ref.flash_attention_ref(torch.from_numpy(q).to(td),
                                  torch.from_numpy(k).to(td),
                                  torch.from_numpy(v).to(td), kv_block=16)
    assert got.dtype == td
    tol = BF16_TOL if dtype == "bfloat16" else PALLAS_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("Sq,Skv,mode,window,q_offset,softcap", [
    (40, 40, "causal", None, 0, 0.0),
    (40, 40, "window", 7, 0, 0.0),
    (33, 33, "full", None, 0, 0.0),
    (40, 40, "causal", None, 0, 30.0),        # logit softcap
    (12, 40, "causal", None, 28, 0.0),        # a chunk of queries late in kv
    (12, 40, "window", 9, 28, 0.0),
])
def test_model_flash_attention_matches_jax(Sq, Skv, mode, window, q_offset,
                                           softcap):
    q, k, v = _qkv(Sq + Skv, 2, Sq, Skv, 6, 2, 16)
    kw = dict(mode=mode, window=window, q_offset=q_offset, softcap=softcap,
              q_chunk=16, kv_chunk=8)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **kw)
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)


def test_model_flash_attention_extra_qk_and_dv_match_jax():
    """The decomposed-MLA arguments: a head-shared score term, Dv != D and
    an explicit scale."""
    B, S, H, KV, D, Dv, P2 = 2, 37, 4, 4, 16, 8, 6
    q, k, v = _qkv(11, B, S, S, H, KV, D, Dv)
    rs = np.random.RandomState(12)
    q2 = rs.randn(B, S, H, P2).astype(np.float32)
    k2 = rs.randn(B, S, P2).astype(np.float32)
    kw = dict(q_chunk=16, kv_chunk=16, scale=(D + P2) ** -0.5)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **kw,
                                 extra_qk=(jnp.asarray(q2), jnp.asarray(k2)))
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), **kw,
                                extra_qk=(torch.from_numpy(q2),
                                          torch.from_numpy(k2)))
    assert tuple(got.shape) == (B, S, H, Dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)


@pytest.mark.parametrize("ring,window", [(False, None), (False, 5),
                                         (True, 6)])
def test_decode_attention_matches_jax(ring, window):
    B, S, H, KV, D = 2, 10, 6, 2, 16
    q, k, v = _qkv(21, B, 1, S, H, KV, D)
    index = 12 if ring else 7
    pos = None
    if ring:           # slot = position % S; slot 3 not written yet (-1)
        pos = np.array([[p if p <= index else -1
                         for p in range(4, 14)]] * B, np.int32)
        pos = np.roll(pos, 4, axis=1)
    want = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        index=jnp.int32(index),
        positions=None if pos is None else jnp.asarray(pos), window=window)
    got = tattn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        index=index, positions=None if pos is None else torch.from_numpy(pos),
        window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)


@pytest.mark.parametrize("q_len,kv_len,q_offset,window", [
    (7, 7, 0, 3), (4, 11, 7, 5), (9, 9, 0, 1)])
def test_masks_match_jax(q_len, kv_len, q_offset, window):
    from repro.models import common as jcommon
    from repro_torch.models import common as tcommon
    assert np.array_equal(
        tcommon.causal_mask(q_len, kv_len, q_offset).numpy(),
        np.asarray(jcommon.causal_mask(q_len, kv_len, q_offset)))
    assert np.array_equal(
        tcommon.window_mask(q_len, kv_len, q_offset, window).numpy(),
        np.asarray(jcommon.window_mask(q_len, kv_len, q_offset, window)))


def test_kernel_contract():
    """What a CUDA call of the model-level ``flash_attention`` hands to
    kernel 6, and what it refuses (a ``ValueError`` naming the reason):
    the check, as a function, on the shapes of a call. Head dims the
    kernel has no instantiation for and ``Dv != D`` are in the contract,
    as is any scale, ``q_offset`` and ``softcap`` (``kernel_padded`` sends
    the first two to the padded route, unless the pair is one the kernel
    instantiates: a D of 192 is padded to 256, MLA's 96 over 64 and
    phi-3's 96 are not; a scale is a kernel argument and routes nothing);
    ``extra_qk`` widens the score head dim to ``D + P2``; head dims above
    256 and dtypes other than bfloat16 and float32 are out."""
    q = torch.zeros((1, 8, 4, 32))
    v = torch.zeros((1, 8, 2, 32))
    assert tattn.kernel_contract(q, v) is None
    q2 = torch.zeros((1, 8, 4, 16))
    assert tattn.kernel_contract(q, v, extra_qk=(q2, q2[:, :, 0])) is None
    assert "head dims" in tattn.kernel_contract(
        torch.zeros((1, 8, 4, 192)), torch.zeros((1, 8, 2, 128)),
        extra_qk=(torch.zeros((1, 8, 4, 96)), torch.zeros((1, 8, 96))))
    assert "dtype" in tattn.kernel_contract(q.half(), v.half())
    assert tattn.kernel_contract(q, torch.zeros((1, 8, 2, 16))) is None
    assert tattn.kernel_contract(torch.zeros((1, 8, 4, 96)),
                                 torch.zeros((1, 8, 2, 64))) is None
    assert tattn.kernel_contract(torch.zeros((1, 8, 4, 192)),
                                 torch.zeros((1, 8, 2, 128))) is None
    assert tattn.kernel_padded(torch.zeros((1, 8, 4, 192)),
                               torch.zeros((1, 8, 2, 192)))
    assert not tattn.kernel_padded(torch.zeros((1, 8, 4, 256)),
                                   torch.zeros((1, 8, 2, 256)))
    assert "head dims" in tattn.kernel_contract(
        torch.zeros((1, 8, 4, 320)), torch.zeros((1, 8, 2, 128)))
    assert "head dims" in tattn.kernel_contract(
        torch.zeros((1, 8, 4, 128)), torch.zeros((1, 8, 2, 264)))
    assert not tattn.kernel_padded(q, v)
    # the scale is an argument of every launch: it routes nothing
    assert "scale" not in inspect.signature(tattn.kernel_padded).parameters
    assert tattn.kernel_padded(q, torch.zeros((1, 8, 2, 16)))
    # MLA's 96 over 64 and phi-3's 96 are instantiated: no padding
    assert not tattn.kernel_padded(torch.zeros((1, 8, 4, 96)),
                                   torch.zeros((1, 8, 2, 96)))
    assert not tattn.kernel_padded(torch.zeros((1, 8, 4, 96)),
                                   torch.zeros((1, 8, 2, 64)))


@pytest.mark.parametrize("D,Dv,padded,P", [
    (96, 64, False, 96),      # minicpm3-4b's MLA heads: native
    (96, 96, False, 96),      # phi-3's heads: native
    (192, 192, True, 256),    # no instantiation: padded to 256
    (48, 48, True, 64),
    (32, 16, True, 32),       # Dv != D off the pairs: padded to 32
])
def test_head_dim_pair_routing(D, Dv, padded, P):
    """What a call at head dims ``(D, Dv)`` takes: ``kernel_contract``
    admits each (none is above 256); ``kernel_padded`` sends exactly the
    pairs off ``HEAD_DIM_PAIRS`` to the padded route, at
    ``padded_head_dim``; ``check_shapes`` admits D = Dv and the pairs and
    refuses any other ``Dv != D`` (which only the padded route takes),
    on the CPU route too."""
    from repro_torch.kernels.flash_attention import (
        HEAD_DIM_PAIRS, flash_attention_padded, kernel_pair,
        padded_head_dim)
    q = torch.zeros((1, 8, 4, D))
    k = torch.zeros((1, 8, 2, D))
    v = torch.zeros((1, 8, 2, Dv))
    assert tattn.kernel_contract(q, v) is None
    assert tattn.kernel_padded(q, v) == padded
    assert kernel_pair(D, Dv) == ((D, Dv) in HEAD_DIM_PAIRS) == (not padded)
    assert padded_head_dim(D, Dv) == P
    if Dv == D or not padded:
        check_shapes(q, k, v, "causal", None)
        assert tuple(flash_kernel(q, k, v).shape) == (1, 8, 4, Dv)
    else:
        with pytest.raises(ValueError, match="k, v"):
            check_shapes(q, k, v, "causal", None)
    # the padded route takes every pair, native or not, on the CPU
    assert tuple(flash_attention_padded(q, k, v).shape) == (1, 8, 4, Dv)


@pytest.mark.parametrize("H,Dv,mode,window,scale", [
    (40, 64, "causal", None, None),      # minicpm3-4b: 40 x 96 over 64
    (40, 64, "window", 7, None),
    (40, 64, "causal", None, 0.07),      # an explicit scale, native too
    (32, 96, "causal", None, None),      # phi-3: 32 x 96
    (32, 96, "full", None, None),
])
def test_full_head_width_pairs_match_jax(H, Dv, mode, window, scale):
    """Kernel 6's native pairs at their full head widths on the CPU, small
    S: the wrapper (the plain version a CUDA launch is held against) and
    the model-level ``flash_attention`` against the reference's scan
    ``models.attention.flash_attention``, in the golden band; no launch."""
    q, k, v = _qkv(H + Dv, 2, 23, 23, H, H, 96, Dv)
    kw = dict(mode=mode, window=window)
    skw = {} if scale is None else dict(scale=scale)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), q_chunk=16, kv_chunk=16,
                                 **kw, **skw)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = _lib.counts()
    got = flash_kernel(tq, tk, tv, **kw, **skw)
    model = tattn.flash_attention(tq, tk, tv, q_chunk=16, kv_chunk=16, **kw,
                                  **skw)
    assert _lib.counts() == before
    assert tuple(got.shape) == (2, 23, H, Dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)
    np.testing.assert_allclose(model.numpy(), np.asarray(want), **BAND)


def test_mla_forward_full_head_width_matches_jax():
    """``mla_forward`` at minicpm3-4b's full heads (40 x nope 64 + rope 32
    over value heads of 64: kernel 6's native (96, 64) pair on the card),
    its latent ranks and d_model cut (256, 64, 32), float32: the output
    and the cached latents against the reference's on its own weights."""
    import dataclasses
    import jax
    import repro.configs as jconfigs
    import repro_torch.configs as tconfigs
    from repro_torch.core.pytree import from_jax_params
    cfgs = []
    for mod in (tconfigs, jconfigs):
        c = mod.get_config("minicpm3_4b")
        cfgs.append(dataclasses.replace(
            c, d_model=256, param_dtype="float32", compute_dtype="float32",
            remat=False, mla=dataclasses.replace(c.mla, q_lora_rank=64,
                                                 kv_lora_rank=32)))
    cfg, jcfg = cfgs
    assert (cfg.n_heads, cfg.mla.qk_nope_head_dim, cfg.mla.qk_rope_head_dim,
            cfg.mla.v_head_dim) == (40, 64, 32, 64)
    jp = jattn.init_mla(jax.random.PRNGKey(5), jcfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.array, jp), "cpu")
    B, S = 2, 19
    x = np.random.RandomState(6).randn(B, S, 256).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    out, (c_kv, k_rope) = tattn.mla_forward(
        tp, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos.copy()))
    jout, (jc, jr) = jattn.mla_forward(jp, jnp.asarray(x), jcfg,
                                       positions=jnp.asarray(pos))
    for got, want in ((out, jout), (c_kv, jc), (k_rope, jr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)


@pytest.mark.parametrize("B,S,H,KV,D,Dv,mode,window", [
    (2, 40, 8, 8, 96, 64, "causal", None),   # minicpm3-4b's MLA heads
    (1, 33, 4, 4, 96, 64, "full", None),
    (2, 37, 4, 2, 96, 64, "window", 9),
    (2, 24, 2, 2, 32, 32, "causal", None),   # the reduced MLA config's
    (1, 20, 4, 2, 48, 48, "causal", None),   # D off the kernel's dims
    (1, 21, 2, 1, 192, 192, "window", 7),    # padded to 256
])
def test_padded_route_arithmetic(B, S, H, KV, D, Dv, mode, window):
    """Kernel 6's padded route on the CPU: zero-pad q, k and v to the next
    head dim the kernel has, the plain version with the unpadded scale,
    the first Dv columns; against ``chunked_attention_ref`` on the
    unpadded inputs in the golden band, and the wrapper
    (``flash_attention_padded``) is exactly that arithmetic."""
    from repro_torch.kernels.flash_attention import (flash_attention_padded,
                                                     padded_head_dim)
    q, k, v = (torch.from_numpy(a) for a in
               _qkv(D + Dv + S, B, S, S, H, KV, D, Dv))
    P = padded_head_dim(D, Dv)
    assert P == min(p for p in (16, 32, 64, 96, 128, 256) if p >= max(D, Dv))
    pad = torch.nn.functional.pad
    got = ref.flash_attention_ref(pad(q, (0, P - D)), pad(k, (0, P - D)),
                                  pad(v, (0, P - Dv)), mode=mode,
                                  window=window, scale=D ** -0.5)[..., :Dv]
    want = ref.chunked_attention_ref(q, k, v, mode=mode, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **BAND)
    before = _lib.counts()
    wrapped = flash_attention_padded(q, k, v, mode=mode, window=window)
    assert _lib.counts() == before
    assert torch.equal(wrapped, got)
    j = jattn.flash_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                              jnp.asarray(v.numpy()), mode=mode,
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(j), **BAND)


def test_flash_attention_extra_qk_matches_concat():
    """Decomposed scores == concatenated q/k (the MLA formulation), the
    port of ``tests/test_perf_features.py``'s case on the CPU route."""
    B, S, H, D, P2 = 2, 33, 4, 16, 8
    rs = np.random.RandomState(0)
    q1, k1, v = (torch.from_numpy(rs.randn(B, S, H, D).astype(np.float32))
                 for _ in range(3))
    q2 = torch.from_numpy(rs.randn(B, S, H, P2).astype(np.float32))
    k2 = torch.from_numpy(rs.randn(B, S, P2).astype(np.float32))
    scale = (D + P2) ** -0.5
    got = tattn.flash_attention(q1, k1, v, extra_qk=(q2, k2), scale=scale,
                                q_chunk=16, kv_chunk=16)
    q_cat = torch.cat([q1, q2], dim=-1)
    k_cat = torch.cat([k1, k2[:, :, None, :].expand(B, S, H, P2)], dim=-1)
    want = tattn.flash_attention(q_cat, k_cat, v, q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5,
                               rtol=1e-3)


def test_mla_module_matches_jax():
    """``mla_forward`` (output and the cached latents) and three
    ``mla_decode`` steps (output and the cache written in place) against
    the reference's on its own weights, reduced minicpm3-4b."""
    import jax
    import repro.configs as jconfigs
    import repro_torch.configs as tconfigs
    from repro_torch.core.pytree import from_jax_params
    cfg = tconfigs.get_config("minicpm3_4b").reduced()
    jcfg = jconfigs.get_config("minicpm3_4b").reduced()
    jp = jattn.init_mla(jax.random.PRNGKey(2), jcfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.array, jp), "cpu")
    assert tuple(tp["w_uk"].shape) == (32, cfg.n_heads, 16)
    B, S = 2, 12
    x = np.random.RandomState(4).randn(B, S + 3, cfg.d_model).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    out, (c_kv, k_rope) = tattn.mla_forward(
        tp, torch.from_numpy(x[:, :S]), cfg,
        positions=torch.from_numpy(pos.copy()))
    jout, (jc, jr) = jattn.mla_forward(jp, jnp.asarray(x[:, :S]), jcfg,
                                       positions=jnp.asarray(pos))
    for got, want in ((out, jout), (c_kv, jc), (k_rope, jr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)
    C = S + 3
    cache = {"c_kv": torch.zeros((B, C, 32)), "k_rope": torch.zeros((B, C,
                                                                      16))}
    cache["c_kv"][:, :S], cache["k_rope"][:, :S] = c_kv, k_rope
    jcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    for i in range(3):
        xi = x[:, S + i:S + i + 1]
        got, cache2 = tattn.mla_decode(tp, torch.from_numpy(xi), cfg, cache,
                                       S + i)
        assert cache2 is cache
        want, jcache = jattn.mla_decode(jp, jnp.asarray(xi), jcfg, jcache,
                                        jnp.int32(S + i))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   **BAND)


@pytest.mark.parametrize("shapes,mode,window,match", [
    (((1, 8, 4, 32), (1, 8, 2, 32), (1, 8, 2, 16)), "causal", None, "k, v"),
    (((1, 8, 4, 32), (1, 8, 3, 32), (1, 8, 3, 32)), "causal", None, "KV"),
    (((1, 8, 4, 32), (1, 8, 2, 32), (1, 8, 2, 32)), "sliding", None, "mode"),
    (((1, 8, 4, 32), (1, 8, 2, 32), (1, 8, 2, 32)), "window", 0, "window"),
    (((1, 12, 4, 32), (1, 4, 2, 32), (1, 4, 2, 32)), "window", 8, "window"),
])
def test_kernel_wrapper_refuses_calls_outside_reference(shapes, mode, window,
                                                        match):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match=match):
        check_shapes(q, k, v, mode, window)
    with pytest.raises(ValueError, match=match):
        flash_kernel(q, k, v, mode=mode, window=window)


def _bf16_route_model(q, k, v, *, split: bool, tile: int = 64):
    """Kernel 6's bfloat16 route as torch arithmetic on the CPU, causal,
    G = 1: bfloat16 q, k, v; float32 scores scaled by D^-0.5; an online
    softmax over ``tile``-key tiles in float32 with ``l`` summed from the
    float32 P; P V from ``bf16(P)`` alone, or (``split``) from
    ``P_hi = bf16(P)`` and ``P_lo = bf16(P - P_hi)`` accumulated in
    float32; ``acc / max(l, 1e-30)`` cast to bfloat16."""
    B, S, H, D = q.shape
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, D))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, tile):
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2) * D ** -0.5
        cols = k0 + torch.arange(s.shape[-1])[None, :]
        s = torch.where(cols <= rows, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        p_hi = p.to(torch.bfloat16).float()
        pv = p_hi @ vf[:, :, k0:k0 + tile]
        if split:
            p_lo = (p - p_hi).to(torch.bfloat16).float()
            pv = pv + p_lo @ vf[:, :, k0:k0 + tile]
        acc = acc * corr + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def test_bf16_route_p_split_within_two_ulps():
    """The design argument of kernel 6's bfloat16 route: with P split into
    two bfloat16 halves the route stays within two bfloat16 ulps
    (``BF16_TOL``, the card's check) of the plain version, which keeps P
    in float32, at S = 1024, 8 heads, D = 128, causal; a single bfloat16 P
    lands further from it."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(14, 1, 1024, 1024, 8, 8, 128))
    want = ref.flash_attention_ref(q, k, v, mode="causal").float()
    limit = BF16_TOL["atol"] + BF16_TOL["rtol"] * want.abs()
    worst = {}
    for split in (True, False):
        got = _bf16_route_model(q, k, v, split=split).float()
        worst[split] = float(((got - want).abs() / limit).max())
    assert worst[True] <= 1.0, worst
    assert worst[False] > 1.0, worst


@pytest.mark.parametrize("Sq,Skv,H,KV,D,P2,Dv,mode,window,q_offset,softcap", [
    (40, 40, 4, 2, 32, 0, 32, "causal", None, 0, 30.0),   # softcap, direct
    (12, 40, 4, 2, 32, 0, 32, "causal", None, 28, 0.0),   # late queries
    (12, 40, 4, 2, 32, 0, 32, "window", 9, 28, 0.0),
    (12, 40, 6, 2, 16, 0, 16, "window", 9, 28, 20.0),     # all three
    (20, 50, 4, 4, 96, 0, 96, "causal", None, 30, 10.0),  # padded 96 -> 128
    (33, 33, 4, 4, 16, 16, 32, "causal", None, 0, 0.0),   # extra: 16 + 16
    (24, 40, 4, 4, 64, 32, 64, "causal", None, 16, 0.0),  # minicpm3's heads
    (24, 24, 4, 4, 64, 32, 64, "full", None, 0, 25.0),
    (16, 48, 4, 4, 16, 8, 16, "window", 12, 32, 0.0),     # 24 -> padded 32
])
def test_kernel_arguments_match_jax(Sq, Skv, H, KV, D, P2, Dv, mode, window,
                                    q_offset, softcap):
    """Kernel 6's whole argument list through its wrapper on CPU tensors
    (the plain version a CUDA launch is held against): ``softcap`` and
    ``q_offset`` in the kernel call, the padded route, and ``extra_qk`` as
    the concatenated operands ``[q | q2] · [k | k2]`` at q's own scale
    (``flash_attention_extra``), against the reference's scan
    ``models.attention.flash_attention`` in the golden band. No launch."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_extra, flash_attention_padded)
    q, k, v = _qkv(Sq * Skv + D + P2, 2, Sq, Skv, H, KV, D, Dv)
    kw = dict(mode=mode, window=window, q_offset=q_offset, softcap=softcap)
    jkw = {}
    rs = np.random.RandomState(D + P2)
    if P2:
        q2 = rs.randn(2, Sq, H, P2).astype(np.float32)
        k2 = rs.randn(2, Skv, P2).astype(np.float32)
        jkw["extra_qk"] = (jnp.asarray(q2), jnp.asarray(k2))
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), q_chunk=16, kv_chunk=16,
                                 **kw, **jkw)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = _lib.counts()
    if P2:
        got = flash_attention_extra(tq, tk, tv, (torch.from_numpy(q2),
                                                 torch.from_numpy(k2)), **kw)
    elif D in (16, 32, 64, 128, 256) and Dv == D:
        got = flash_kernel(tq, tk, tv, **kw)
    else:
        got = flash_attention_padded(tq, tk, tv, **kw)
    assert _lib.counts() == before
    assert tuple(got.shape) == (2, Sq, H, Dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)
    # the model-level call on the CPU takes the chunked math: the same
    model = tattn.flash_attention(
        tq, tk, tv, **kw, q_chunk=16, kv_chunk=16,
        extra_qk=(torch.from_numpy(q2), torch.from_numpy(k2)) if P2 else None)
    np.testing.assert_allclose(model.numpy(), np.asarray(want), **BAND)


def test_check_shapes_q_offset():
    """``q_offset`` in the wrapper's shape check: a negative offset leaves
    the first rows without a key outside full mode, and in window mode
    ``Sq + q_offset`` must stay below ``Skv + window``."""
    q = torch.zeros((1, 8, 2, 16))
    k = torch.zeros((1, 16, 2, 16))
    check_shapes(q, k, k, "causal", None, 8)
    check_shapes(q, k, k, "full", None, -3)
    with pytest.raises(ValueError, match="q_offset"):
        check_shapes(q, k, k, "causal", None, -1)
    check_shapes(q, k, k, "window", 4, 11)
    with pytest.raises(ValueError, match="window"):
        check_shapes(q, k, k, "window", 4, 12)
