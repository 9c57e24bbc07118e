"""The port's four kernels (``src/repro_torch/kernels``) against the JAX
package's, on the same numpy-seeded inputs.

On the CPU every wrapper runs its plain PyTorch version (``ref.py``); the
JAX side runs as its own tests run it: the Pallas kernel in interpret mode,
or ``repro.kernels.ref``. Tolerances are ``tests/test_kernels.py``'s.
The CUDA kernels themselves are held against their plain versions on the
card by tests/test_torch_gpu.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.autoencoder import (ChunkedAEConfig as JChunkedAEConfig,  # noqa: E402
                                    init_chunked_ae as j_init_chunked_ae)
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_decode_agg import fused_decode_agg as j_fda  # noqa: E402
from repro.kernels.quantize import (dequantize_blocks_2d as j_deq,  # noqa: E402
                                    quantize_blocks_2d as j_quant)

from repro_torch.core.autoencoder import ChunkedAEConfig  # noqa: E402
from repro_torch.core.pytree import from_jax_params  # noqa: E402
from repro_torch.kernels import _lib, ops  # noqa: E402
from repro_torch.kernels.fused_decode_agg import (fused_decode_agg,  # noqa: E402
                                                  plan)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    kernel_route as flash_route)
from repro_torch.kernels.fused_dense import (fused_dense,  # noqa: E402
                                             kernel_route, splitk_plan)
from repro_torch.kernels.quantize import (dequantize_blocks_2d,  # noqa: E402
                                          quantize_blocks_2d)

SHAPES = [(8, 16, 8), (100, 64, 32), (128, 128, 128), (257, 300, 65),
          (1, 4096, 8)]


def _np_params(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _with_ties(x: np.ndarray, qmax: float) -> np.ndarray:
    """Every third row gets absmax == qmax (scale 1) and .5 ties elsewhere,
    where half-to-even and half-away rounding disagree."""
    x = x.copy()
    block = x.shape[1]
    vals = (np.arange(block - 1) % (2 * int(qmax) - 1) - (qmax - 1)) + 0.5
    x[::3, 0] = qmax
    x[::3, 1:] = vals
    return x


# ------------------------------------------------------------- fused dense
@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["relu", "linear"])
def test_fused_dense_plain_matches_jax(M, K, N, dtype, act):
    rng = np.random.RandomState(M * 1000 + K + N)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) * K ** -0.5).astype(np.float32)
    b = rng.randn(N).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = jref.fused_dense_ref(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                jnp.asarray(b, jdt), act)
    got = fused_dense(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                      torch.from_numpy(b).to(tdt), act=act)
    assert got.dtype == tdt
    atol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=1e-2)


def test_fused_dense_plain_matches_pallas_interpret():
    rng = np.random.RandomState(7)
    x = rng.randn(37, 96).astype(np.float32)
    w = (rng.randn(96, 40) * 96 ** -0.5).astype(np.float32)
    b = rng.randn(40).astype(np.float32)
    from repro.kernels.fused_dense import fused_dense as j_fused_dense
    for act in ("relu", "tanh", "sigmoid", "linear"):
        want = j_fused_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             act=act, interpret=True)
        got = fused_dense(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), act=act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-4)


# the split-K route's shapes on the main path and at its edges
SPLITK_SHAPES = [(4, 4096, 512), (4, 512, 8), (4, 512, 4096), (4, 8, 512),
                 (12, 8, 512), (16, 4095, 65), (1, 300, 7), (3, 0, 5)]


def test_kernel_routes():
    """Each wrapper's CUDA route comes from shape and dtype alone."""
    assert [kernel_route(m) for m in (1, 4, 16, 17, 4096)] == [
        "splitk", "splitk", "splitk", "tiled", "tiled"]
    assert flash_route(torch.bfloat16) == "wgmma"
    assert flash_route(torch.float32) == "fma"


@pytest.mark.parametrize("M,K,N", SPLITK_SHAPES)
@pytest.mark.parametrize("elem", [4, 2])
def test_fused_dense_splitk_plan(M, K, N, elem):
    """The split-K launch plan: column tiles of a power of two of 16-byte
    vectors, at least 4 (64 bytes of a row) unless N is narrower, narrowed
    from 32 only where K fits one slab and while the tiles give fewer than
    2 x 132 blocks; slabs of
    whole block steps (8 warps of 32 / tpr rows), at most 512 rows,
    covering K exactly once; where the column tiles give fewer than 132
    blocks and K is long enough for 2 x 132 blocks of 16 KB of w, about 2
    blocks an SM."""
    rows, tpr, splits = splitk_plan(K, N, elem, 132)
    vec = 16 // elem
    ncv = -(-N // vec)
    widest = min(32, 1 << (ncv - 1).bit_length())
    assert tpr in (1, 2, 4, 8, 16, 32) and min(4, widest) <= tpr <= widest
    assert tpr == widest or (K <= 512 and -(-ncv // (2 * tpr)) < 2 * 132)
    step = 8 * (32 // tpr)
    assert rows % step == 0 and step <= rows <= 512
    assert (splits - 1) * rows < max(K, 1) <= splits * rows
    tiles = -(-ncv // tpr)
    floor_rows = -(-16384 // (tpr * vec * elem))
    if tiles < 132 and K >= 2 * 132 * floor_rows // tiles:
        assert 132 <= splits * tiles <= 2 * 132 + tiles


@pytest.mark.parametrize("M,K,N", SPLITK_SHAPES[:3])
def test_fused_dense_splitk_order_keeps_tolerance(M, K, N):
    """The split-K route's float32 arithmetic on the CPU: one float32
    partial product per slab of the plan, summed in slab order, then bias
    and activation, stays within the card check's float32 tolerance of the
    plain version."""
    rng = np.random.RandomState(M + K + N)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32))
    w = torch.from_numpy((rng.randn(K, N) * K ** -0.5).astype(np.float32))
    b = torch.from_numpy(rng.randn(N).astype(np.float32))
    rows, _, splits = splitk_plan(K, N, 4, 132)
    acc = torch.zeros((M, N))
    for s in range(splits):
        acc = acc + x[:, s * rows:(s + 1) * rows] @ w[s * rows:(s + 1) * rows]
    for act, fn in (("relu", torch.relu), ("linear", lambda t: t)):
        np.testing.assert_allclose(
            fn(acc + b).numpy(), fused_dense(x, w, b, act=act).numpy(),
            atol=1e-5, rtol=1e-4)


# --------------------------------------------------------------- quantize
@pytest.mark.parametrize("n_blocks,block", [(1, 64), (7, 256), (64, 128),
                                            (300, 256)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_plain_matches_pallas(n_blocks, block, bits):
    qmax = float(2 ** (bits - 1) - 1)
    x = _with_ties(np.random.RandomState(n_blocks).randn(n_blocks, block)
                   .astype(np.float32) * 3.0, qmax)
    q_j, s_j = j_quant(jnp.asarray(x), bits=bits, block=block,
                       interpret=True)
    q_t, s_t = quantize_blocks_2d(torch.from_numpy(x), bits=bits,
                                  block=block)
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    # XLA on the CPU rewrites absmax / qmax (a constant divisor) into a
    # reciprocal multiply; the port divides, so a scale may differ by one
    # ulp (rtol 1e-6, test_kernels.py's scale tolerance)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)
    d_j = j_deq(q_j, s_j, block=block, interpret=True)
    # on the same payload, dequantize is one multiply per value: exact
    d_same = dequantize_blocks_2d(torch.from_numpy(np.array(q_j)),
                                  torch.from_numpy(np.array(s_j)),
                                  block=block)
    np.testing.assert_array_equal(d_same.numpy(), np.asarray(d_j))
    d_t = dequantize_blocks_2d(q_t, s_t, block=block)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6)


def test_quantize_rounds_half_to_even():
    """Codes at exact .5 ties follow half-to-even (``jnp.round``), not
    half-away (``roundf``)."""
    row = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]],
                   np.float32)
    want = np.array([[127, 0, 2, 2, 0, -2, -2, 126]], np.int8)
    q_t, s_t = quantize_blocks_2d(torch.from_numpy(row), bits=8, block=8)
    q_j, _ = jref.quantize_blocks_ref(jnp.asarray(row), bits=8)
    assert float(s_t[0]) == 1.0
    np.testing.assert_array_equal(q_t.numpy(), want)
    np.testing.assert_array_equal(np.asarray(q_j), want)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n", [100, 4096, 10000])
def test_ops_quantize_payload_matches_jax(bits, n):
    x = (np.random.RandomState(n).randn(n) * 5.0).astype(np.float32)
    q_j, s_j, _ = jops.quantize_blocks(jnp.asarray(x), bits=bits, block=256)
    q_t, s_t, orig = ops.quantize_blocks(torch.from_numpy(x), bits=bits,
                                         block=256)
    assert orig == n
    assert q_t.dtype == (torch.uint8 if bits == 4 else torch.int8)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)
    back_t = ops.dequantize_blocks(q_t, s_t, bits=bits, block=256,
                                   orig_len=n)
    back_j = jops.dequantize_blocks(q_j, s_j, bits=bits, block=256,
                                    orig_len=n)
    assert back_t.shape == (n,)
    np.testing.assert_allclose(back_t.numpy(), np.asarray(back_j), rtol=1e-6)
    with pytest.raises(ValueError):
        ops.dequantize_blocks(q_t, s_t, bits=bits, block=256, orig_len=0)


def test_nibble_packing_matches_jax():
    q = np.random.RandomState(0).randint(-7, 8, size=512).astype(np.int8)
    packed_t = ops.pack_nibbles(torch.from_numpy(q))
    packed_j = jops.pack_nibbles(jnp.asarray(q))
    assert packed_t.dtype == torch.uint8
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    np.testing.assert_array_equal(ops.unpack_nibbles(packed_t).numpy(), q)


# ------------------------------------------------------ fused decode→agg
@pytest.mark.parametrize("C,M,K,N", [(1, 8, 4, 64), (4, 17, 8, 64),
                                     (8, 128, 32, 256), (3, 100, 64, 130)])
def test_fused_decode_agg_plain_matches_pallas(C, M, K, N):
    rng = np.random.RandomState(C * 7 + M)
    h = rng.randn(C, M, K).astype(np.float32)
    w = rng.dirichlet(np.ones(C)).astype(np.float32)
    wl = (rng.randn(K, N) * K ** -0.5).astype(np.float32)
    bl = rng.randn(N).astype(np.float32)
    want = j_fda(jnp.asarray(h), jnp.asarray(w), jnp.asarray(wl),
                 jnp.asarray(bl), bm=32, bc=2, interpret=True)
    got = fused_decode_agg(torch.from_numpy(h), torch.from_numpy(w),
                           torch.from_numpy(wl), torch.from_numpy(bl))
    assert got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=1e-4)


def test_fused_decode_agg_weighting_not_uniform():
    """A client with weight≈1 dominates: catches averaging instead of
    weighting."""
    h = torch.stack([torch.ones((16, 8)), 100.0 * torch.ones((16, 8))])
    out = fused_decode_agg(h, torch.tensor([0.999, 0.001]), torch.eye(8),
                           torch.zeros(8))
    np.testing.assert_allclose(out.numpy(), np.full((16, 8), 0.999 + 0.1),
                               rtol=1e-5)


@pytest.mark.parametrize("M,N,K,bm,cols", [
    (4096, 256, 32, 8, 256),      # cohort scale: row bands fill the card
    (4, 4096, 512, 8, 32),        # slice: columns split, reduce repeats
    (100_000, 64, 16, 64, 64),    # tall: widest band, one split
    (64, 64, 8192, 0, 0),         # K too wide for shared memory
])
def test_fused_decode_agg_launch_plan(M, N, K, bm, cols):
    if bm == 0:
        with pytest.raises(ValueError):
            plan(M, N, K, 132)
        return
    assert plan(M, N, K, 132) == (bm, cols)
    assert bm * K * 4 <= 227 * 1024 and cols % 32 == 0


# -------------------------------------------------------- chunked AE ops
@pytest.mark.parametrize("chunk,hidden,latent", [(64, (32,), 4),
                                                 (256, (64, 32), 8),
                                                 (1024, (), 16)])
def test_chunked_ae_kernel_path_matches_pallas(chunk, hidden, latent):
    jcfg = JChunkedAEConfig(chunk_size=chunk, hidden=hidden,
                            latent_chunk=latent)
    tcfg = ChunkedAEConfig(chunk_size=chunk, hidden=hidden,
                           latent_chunk=latent)
    pj = j_init_chunked_ae(jax.random.PRNGKey(0), jcfg)
    pt = from_jax_params(_np_params(pj), "cpu")
    n = 5000
    flat = np.random.RandomState(1).randn(n).astype(np.float32)
    z_j = jops.ae_encode(pj, jcfg, jnp.asarray(flat))
    z_t = ops.ae_encode(pt, tcfg, torch.from_numpy(flat))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-5,
                               rtol=1e-4)
    d_j = jops.ae_decode(pj, jcfg, z_j, n)
    d_t = ops.ae_decode(pt, tcfg, z_t, n)
    assert d_t.shape == (n,)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5,
                               rtol=1e-4)


# --------------------------------------------------------- dispatch rules
def test_use_kernel_default(monkeypatch):
    """The explicit field is the one switch: no environment variable moves
    the dispatch (the reference's ``REPRO_USE_KERNEL`` is not read)."""
    monkeypatch.delenv("REPRO_USE_KERNEL", raising=False)
    assert ops.use_kernel_default(True) is True
    assert ops.use_kernel_default(False) is False
    assert ops.use_kernel_default() is torch.cuda.is_available()
    for value in ("0", "1"):
        monkeypatch.setenv("REPRO_USE_KERNEL", value)
        assert ops.use_kernel_default() is torch.cuda.is_available()
        assert ops.use_kernel_default(True) is True
        assert ops.use_kernel_default(False) is False


def test_wrappers_take_plain_path_only_for_cpu_tensors():
    """A tensor that is not on the CPU never reaches a plain version: the
    wrappers check it for the kernel and raise on what it cannot take."""
    x = torch.empty((4, 256), device="meta")
    before = _lib.counts()
    with pytest.raises(ValueError, match="CUDA"):
        quantize_blocks_2d(x, bits=8, block=256)
    with pytest.raises(ValueError, match="CUDA"):
        dequantize_blocks_2d(x.to(torch.int8), torch.empty(4, device="meta"),
                             block=256)
    with pytest.raises(ValueError, match="CUDA"):
        fused_dense(x, torch.empty((256, 8), device="meta"),
                    torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        fused_decode_agg(torch.empty((2, 4, 256), device="meta"),
                         torch.empty(2, device="meta"),
                         torch.empty((256, 8), device="meta"),
                         torch.empty(8, device="meta"))
    assert _lib.counts() == before          # nothing launched
