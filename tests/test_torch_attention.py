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
* kernel 6's contract: the calls that raise instead of running.

Inputs are drawn with numpy from a seed and handed to both packages.
"""
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
    kernel 6, and what it refuses (``NotImplementedError`` naming the
    reason): the check, as a function, on the shapes of a call."""
    q = torch.zeros((1, 8, 4, 32))
    v = torch.zeros((1, 8, 2, 32))
    assert tattn.kernel_contract(q, v) is None
    assert tattn.kernel_contract(q, v, scale=32 ** -0.5) is None
    assert "softcap" in tattn.kernel_contract(q, v, softcap=50.0)
    assert "extra_qk" in tattn.kernel_contract(q, v, extra_qk=(q, v))
    assert "q_offset" in tattn.kernel_contract(q, v, q_offset=3)
    assert "Dv" in tattn.kernel_contract(q, torch.zeros((1, 8, 2, 16)))
    assert "scale" in tattn.kernel_contract(q, v, scale=0.1)


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
