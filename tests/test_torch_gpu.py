"""The port's CUDA kernels on the card: each against its plain PyTorch
version, the grouped decode→aggregate bucket by bucket against the
per-bucket kernel, the q8 and partitioned grouped runs on CUDA against
the same runs on the CPU, and the reduced deepseek-coder-33b prefill and
decode on CUDA (flash attention on kernel 6) against the CPU.

Every test here carries the ``gpu`` marker and skips without a card. The
file imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import collections
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _lib, ref  # noqa: E402
from repro_torch.kernels.fused_decode_agg import (  # noqa: E402
    fused_decode_agg, grouped_fused_decode_agg,
    grouped_fused_decode_agg_decoders, grouped_plan)
from repro_torch.kernels.fused_decode_agg import (  # noqa: E402
    kernel_route as decode_agg_route)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention)
from repro_torch.kernels.fused_dense import (  # noqa: E402
    ACTS, DTYPES, MMA_ROWS, SGEMM_TILES, fused_dense, kernel_route,
    tile_plan)
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.kernels.quantize import (dequantize_blocks_2d,  # noqa: E402
                                          quantize_blocks_2d)

SHAPES = [(8, 16, 8), (100, 64, 32), (128, 128, 128), (257, 300, 65),
          (1, 4096, 8)]
BAND = dict(atol=2e-5, rtol=2e-4)    # tests/test_golden_trajectory.py
# kernel 6: float32 the reference's Pallas test's; bfloat16 two ulps
FLASH_TOL = {torch.float32: dict(atol=3e-5, rtol=1e-3),
             torch.bfloat16: dict(atol=1e-3, rtol=1.6e-2)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_kernels_equal_plain(bits):
    _card()
    qmax = float(2 ** (bits - 1) - 1)
    x = np.random.RandomState(bits).randn(300, 256).astype(np.float32) * 3
    x[::3, 0] = qmax                      # scale 1 and .5 ties elsewhere
    x[::3, 1:] = (np.arange(255) % (2 * int(qmax) - 1) - (qmax - 1)) + 0.5
    xc = torch.from_numpy(x).cuda()
    before = _lib.counts()
    q, s = quantize_blocks_2d(xc, bits=bits, block=256)
    q_r, s_r = ref.quantize_blocks_ref(xc, bits)
    assert torch.equal(q, q_r) and torch.equal(s, s_r)
    assert torch.equal(dequantize_blocks_2d(q, s, block=256),
                       ref.dequantize_blocks_ref(q, s))
    after = _lib.counts()
    for k in ("quantize_blocks_2d", "dequantize_blocks_2d"):
        assert after.get(k, 0) == before.get(k, 0) + 1


def _tied_rows(nb, block, bits, seed, offset=0):
    """(nb, block) float32 on the card, every third row a tie row (absmax
    qmax, so scale 1, and the other values on .5), as a view ``offset``
    floats into a larger buffer (offset 1: 4 bytes off 16-byte alignment,
    as ``buf[k:]`` can be)."""
    qmax = float(2 ** (bits - 1) - 1)
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.empty(nb * block + offset, device="cuda")
    x = buf[offset:].view(nb, block)
    x.copy_(torch.randn((nb, block), generator=g, device="cuda") * 3)
    x[::3, 0] = qmax
    x[::3, 1:] = ((torch.arange(block - 1, device="cuda")
                   % (2 * int(qmax) - 1) - (qmax - 1)) + 0.5)
    return x


def _expected_routes(block, aligned):
    quant = ("rows" if aligned and block in qz.VECTOR_BLOCKS
             else "generic")
    dequant = "stream" if aligned and block % 4 == 0 else "generic"
    return quant, dequant


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block", [64, 100, 256, 1024])
@pytest.mark.parametrize("nb", [1, 63, 1802, 70_001])
@pytest.mark.parametrize("aligned", [True, False])
def test_quantize_routes_equal_plain(bits, block, nb, aligned):
    """Kernels 1 and 2 through their wrappers on each route the shapes and
    pointers give (70,001 rows: more warps than the card holds at once),
    tie rows included: codes, scales and dequantized values ``torch.equal``
    to the plain versions and to ``torch.mul``, one launch each under the
    route expected. Unaligned: x 4 bytes and the codes 3 bytes off 16-byte
    alignment."""
    _card()
    x = _tied_rows(nb, block, bits, nb + block + bits, 0 if aligned else 1)
    before = qz.ROUTE_LAUNCHES.copy()
    q, s = quantize_blocks_2d(x, bits=bits, block=block)
    q_r, s_r = ref.quantize_blocks_ref(x, bits)
    assert torch.equal(q, q_r) and torch.equal(s, s_r)
    buf = torch.empty(nb * block + 3, dtype=torch.int8, device="cuda")
    qv = buf[0 if aligned else 3:][:nb * block].view(nb, block)
    qv.copy_(q)
    d = dequantize_blocks_2d(qv, s, block=block)
    assert torch.equal(d, ref.dequantize_blocks_ref(q_r, s_r))
    assert torch.equal(d, torch.mul(q, s[:, None]))
    quant, dequant = _expected_routes(block, aligned)
    assert qz.ROUTE_LAUNCHES - before == collections.Counter(
        {"quantize/" + quant: 1, "dequantize/" + dequant: 1})


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["generic", "vector"])
@pytest.mark.parametrize("block", [64, 100, 128, 256, 512, 1024, 50])
@pytest.mark.parametrize("nb", [1, 63, 1802, 70_001])
def test_quantize_every_route_launched_directly(route, block, nb):
    """Each route of kernels 1 and 2 launched directly, at every templated
    block, at 100 and at 50, on a grid of 2-warp blocks that just covers
    the work: ``torch.equal`` to the plain versions. Refused, nothing
    launched: a block the route does not take (quantize's vector body
    takes the templated blocks, dequantize's whole 4-code words) and a
    grid one block short."""
    _card()
    x = _tied_rows(nb, block, 8, 3 * nb + block)
    q_r, s_r = ref.quantize_blocks_ref(x, 8)
    d_r = ref.dequantize_blocks_ref(q_r, s_r)
    q = torch.full((nb, block), 99, dtype=torch.int8, device="cuda")
    s = torch.zeros((nb,), device="cuda")
    y = torch.zeros((nb, block), device="cuda")
    vector = route == "vector"
    units = ((-(-nb // qz._rows_a_warp(block)) if vector else nb),
             (-(-nb * block // qz._STREAM_CODES) if vector else nb))
    admits = ((block in qz.VECTOR_BLOCKS, block % 4 == 0) if vector
              else (True, True))
    for (counter, fn, args), ok, n in zip((
            ("quantize_blocks_2d", "repro_quantize_blocks",
             (x, q, s, nb, block, 127.0, int(vector))),
            ("dequantize_blocks_2d", "repro_dequantize_blocks",
             (q_r, s_r, y, nb, block, int(vector)))), admits, units):
        before = _lib.counts().get(counter, 0)
        grid = -(-n // 2)
        for g in ((grid, grid - 1) if ok else (grid,)):
            if ok and g == grid:
                _lib.launch(counter, fn, *args, g, 64)
                continue
            with pytest.raises(RuntimeError, match="launch failed"):
                _lib.launch(counter, fn, *args, g, 64)
        assert _lib.counts().get(counter, 0) == before + ok
    torch.cuda.synchronize()
    if admits[0]:
        assert torch.equal(q, q_r) and torch.equal(s, s_r)
    if admits[1]:
        assert torch.equal(y, d_r)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_dense_kernel_matches_plain(M, K, N, dtype):
    _card()
    g = torch.Generator(device="cuda").manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
    w = (torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
         ).to(dtype)
    b = torch.randn((N,), generator=g, device="cuda").to(dtype)
    tol = (dict(atol=1e-5, rtol=1e-4) if dtype == torch.float32
           else dict(atol=5e-2, rtol=1e-2))
    for act in ("relu", "tanh", "sigmoid", "linear"):
        got = fused_dense(x, w, b, act=act)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(),
                                   ref.fused_dense_ref(x, w, b, act).float(),
                                   **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(4, 4096, 512), (4, 512, 8),
                                   (4, 512, 4096), (12, 8, 512),
                                   (16, 4095, 65), (1, 300, 7),
                                   (16, 4096, 64), (17, 4096, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_dense_splitk_route_matches_plain(M, K, N, dtype):
    """The split-K route (M <= 16, K > 32) at the client's encode and
    decode shapes, with a ragged N (scalar loads) and the M = 16 / 17
    boundary, where sgemm or mma takes over (at K = 8 narrow takes every
    M): every activation against the plain version at the float32 and
    bf16 tolerances, one launch a call, and the same bits from run to run
    (partials summed in slab order, no atomics)."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
    w = (torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
         ).to(dtype)
    b = torch.randn((N,), generator=g, device="cuda").to(dtype)
    tol = (dict(atol=1e-5, rtol=1e-4) if dtype == torch.float32
           else dict(atol=5e-2, rtol=1e-2))
    assert kernel_route(M, K, N, dtype) == (
        "narrow" if K <= 32 else "splitk" if M <= 16
        else "mma" if dtype == torch.bfloat16 else "sgemm")
    for act in ("relu", "tanh", "sigmoid", "linear"):
        before = _lib.counts().get("fused_dense", 0)
        got = fused_dense(x, w, b, act=act)
        torch.cuda.synchronize()
        assert _lib.counts()["fused_dense"] == before + 1
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(),
                                   ref.fused_dense_ref(x, w, b, act).float(),
                                   **tol)
        assert torch.equal(got, fused_dense(x, w, b, act=act))


def _dense_inputs(M, K, N, dtype):
    g = torch.Generator(device="cuda").manual_seed(M + 3 * K + 7 * N)
    x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
    w = (torch.randn((K, N), generator=g, device="cuda") * max(K, 1) ** -0.5
         ).to(dtype)
    b = torch.randn((N,), generator=g, device="cuda").to(dtype)
    return x, w, b


def _dense_tol(dtype):
    return (dict(atol=1e-5, rtol=1e-4) if dtype == torch.float32
            else dict(atol=5e-2, rtol=1e-2))


TILED_SHAPES = [
    # narrow (K <= 32): the chunked-AE layers at 2^20 values a client, the
    # server's hidden layer, the K = 32 boundary, ragged K and N (N not a
    # multiple of 4 or 8), M = 16 / 17, M off the row tile, N over two
    # column tiles, K = 1, and run (c)'s K = 8 layers at 4 and 12 rows
    (4096, 8, 32), (4096, 32, 8), (4096, 32, 256), (65536, 8, 32),
    (17, 32, 256), (16, 32, 256), (17, 8, 32), (1000, 7, 30),
    (333, 32, 513), (130, 1, 4), (129, 12, 6), (300, 32, 64), (4, 8, 512),
    (12, 8, 512), (3, 5, 4100),
    # mma (bf16) / sgemm (f32), K > 32: the encode's first layer, the
    # K = 33 boundary, M = 17, ragged K and N, a wide layer, long K
    (4096, 256, 32), (300, 33, 64), (17, 4096, 64), (1000, 100, 130),
    (513, 64, 7), (257, 300, 65), (300, 512, 256), (129, 1024, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", TILED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_dense_tiled_routes_match_plain(M, K, N, dtype):
    """The routes other than split-K (narrow at K <= 32, any M; mma for
    bf16 and sgemm for f32 above it at M > 16) against the plain version
    with every activation, at the route boundaries and with ragged edges:
    one launch a call, and the same bits on a second call (a fixed order,
    no atomics)."""
    _card()
    x, w, b = _dense_inputs(M, K, N, dtype)
    route = kernel_route(M, K, N, dtype)
    assert route == ("narrow" if K <= 32 else
                     "mma" if dtype == torch.bfloat16 else "sgemm")
    for act in ("relu", "tanh", "sigmoid", "linear"):
        before = _lib.counts().get("fused_dense", 0)
        got = fused_dense(x, w, b, act=act)
        torch.cuda.synchronize()
        assert _lib.counts()["fused_dense"] == before + 1
        assert got.dtype == dtype and got.shape == (M, N)
        torch.testing.assert_close(got.float(),
                                   ref.fused_dense_ref(x, w, b, act).float(),
                                   **_dense_tol(dtype))
        assert torch.equal(got, fused_dense(x, w, b, act=act))


@pytest.mark.gpu
@pytest.mark.parametrize("route,tile", [("mma", bm) for bm in MMA_ROWS]
                         + [("sgemm", t) for t in range(len(SGEMM_TILES))])
@pytest.mark.parametrize("M,K,N", [(300, 256, 160), (77, 100, 90)])
def test_fused_dense_every_tile_matches_plain(route, tile, M, K, N):
    """Every compiled tile of the mma and sgemm routes, launched directly
    (the plan picks one a shape), on 16-byte rows and off them (K = 100,
    N = 90: the element-wise staging branch), against the plain version."""
    _card()
    dtype = torch.bfloat16 if route == "mma" else torch.float32
    x, w, b = _dense_inputs(M, K, N, dtype)
    y = torch.empty((M, N), dtype=dtype, device="cuda")
    sms = _lib.device_sms(x.device)
    _lib.launch("fused_dense", "repro_fused_dense", x, w, b, y, M, K, N,
                ACTS["tanh"], DTYPES[dtype], {"mma": 1, "sgemm": 2}[route],
                tile, sms)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(),
                               ref.fused_dense_ref(x, w, b, "tanh").float(),
                               **_dense_tol(dtype))


@pytest.mark.gpu
def test_fused_dense_tile_plans_fill_the_card():
    """At the chunked-AE encode's first layer (4096, 256, 32) the plans
    give about a wave of blocks: at least half the card's SMs, at most
    two blocks an SM."""
    _card()
    sms = _lib.device_sms(torch.device("cuda"))
    bm = tile_plan("mma", 4096, 32, sms)
    assert sms / 2 <= -(-4096 // bm) <= 2 * sms
    t = tile_plan("sgemm", 4096, 32, sms)
    assert sms / 2 <= -(-4096 // SGEMM_TILES[t][0]) <= 2 * sms


@pytest.mark.gpu
def test_launch_refuses_a_tensor_that_requires_grad():
    """A kernel cannot carry a gradient: while autograd records, a tensor
    argument that requires grad is refused before anything launches; under
    ``torch.no_grad()`` the same call runs."""
    _card()
    x, w, b = _dense_inputs(64, 32, 32, torch.float32)
    x.requires_grad_(True)
    before = _lib.counts().get("fused_dense", 0)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused_dense(x, w, b)
    assert _lib.counts().get("fused_dense", 0) == before
    with torch.no_grad():
        got = fused_dense(x, w, b)
    assert _lib.counts()["fused_dense"] == before + 1
    torch.testing.assert_close(got, ref.fused_dense_ref(x.detach(), w, b),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("C,M,K,N", [(1, 8, 4, 64), (4, 17, 8, 64),
                                     (8, 128, 32, 256), (3, 100, 64, 130),
                                     (3, 4, 512, 4096)])
def test_fused_decode_agg_kernel_matches_plain(C, M, K, N):
    _card()
    g = torch.Generator(device="cuda").manual_seed(C * 7 + M)
    h = torch.randn((C, M, K), generator=g, device="cuda")
    w = torch.rand((C,), generator=g, device="cuda") + 0.1
    w = w / w.sum()
    wl = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
    bl = torch.randn((N,), generator=g, device="cuda")
    torch.testing.assert_close(fused_decode_agg(h, w, wl, bl),
                               ref.fused_decode_agg_ref(h, w, wl, bl),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("C,M,K,N", [
    (3, 4, 512, 4096),            # run (c): few_rows
    (1, 16, 512, 4096),           # few_rows at its row limit
    (2, 17, 512, 4096),           # bands just past it
    (2, 100, 512, 4096),          # bands at K 512: column strips
    (3, 4, 513, 4096),            # bands: K past one slab
    (5, 3, 64, 130),              # few_rows, ragged N (scalar loads)
    (40, 12, 32, 256),            # few_rows, more clients than a batch
    (256, 4096, 32, 256)])        # cohort scale: bands, client groups
def test_fused_decode_agg_routes_match_plain(C, M, K, N):
    """Each route of kernel 4 against its plain version: one launch a
    call, the route from (M, K), the same bits from run to run (fixed
    order, no atomics)."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(C + M + K + N)
    h = torch.randn((C, M, K), generator=g, device="cuda")
    w = torch.rand((C,), generator=g, device="cuda") + 0.1
    w = w / w.sum()
    wl = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
    bl = torch.randn((N,), generator=g, device="cuda")
    assert decode_agg_route(M, K) == (
        "few_rows" if M <= 16 and K <= 512 else "bands")
    before = _lib.counts().get("fused_decode_agg", 0)
    got = fused_decode_agg(h, w, wl, bl)
    torch.cuda.synchronize()
    assert _lib.counts()["fused_decode_agg"] == before + 1
    torch.testing.assert_close(got, ref.fused_decode_agg_ref(h, w, wl, bl),
                               atol=2e-5, rtol=1e-4)
    assert torch.equal(got, fused_decode_agg(h, w, wl, bl))


MIXED_ROUNDS = [
    # chip_smoke.py's mixed round: few_rows (3, 4) and (1, 16), an empty
    # bucket, bands (2, 100), two decoders
    ([(3, 4), (0, 8), (2, 100), (1, 16)], 512, 4096, [0, 1, 0, 1]),
    # ragged N, many clients in a few_rows bucket, a shared decoder
    ([(5, 3), (2, 40), (0, 4), (33, 16)], 32, 130, [1, 0, 0, 1]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shapes,K,N,dec_idx", MIXED_ROUNDS)
def test_grouped_decode_agg_mixed_routes_bit_equal(shapes, K, N, dec_idx):
    """A round that mixes routes is one grouped launch; each bucket is
    within the tolerance of the plain version and bit-equal to kernel 4 on
    that bucket alone; decoders passed as separate tensors (the grouped
    round's own) give the same bits as the stacked form."""
    _card()
    hs, ws, w_stack, b_stack = _ragged(len(shapes) + K, shapes, K, N,
                                       max(dec_idx) + 1)
    p = grouped_plan(hs, ws, [(w_stack[d], b_stack[d])
                              for d in range(w_stack.shape[0])], dec_idx)
    assert p.routes == ["" if C == 0 else decode_agg_route(M, K)
                        for C, M in shapes]
    assert {"few_rows", "bands"} <= set(p.routes)
    before = _lib.counts().get("grouped_fused_decode_agg", 0)
    got = grouped_fused_decode_agg(hs, ws, w_stack, b_stack, dec_idx)
    torch.cuda.synchronize()
    assert _lib.counts()["grouped_fused_decode_agg"] == before + 1
    decs = [(w_stack[d].clone(), b_stack[d].clone())
            for d in range(w_stack.shape[0])]
    apart = grouped_fused_decode_agg_decoders(hs, ws, decs, dec_idx)
    want = ref.grouped_fused_decode_agg_ref(hs, ws, w_stack, b_stack,
                                            dec_idx)
    for h, w, d, g, a, r in zip(hs, ws, dec_idx, got, apart, want):
        assert tuple(g.shape) == (h.shape[1], N)
        assert torch.equal(g, a)
        if h.shape[0] == 0:
            assert not g.any()
            continue
        torch.testing.assert_close(g, r, atol=2e-5, rtol=1e-4)
        assert torch.equal(g, fused_decode_agg(h, w, *decs[d]))


@pytest.mark.gpu
def test_q8_slice_on_card_matches_cpu():
    """The golden configuration on CUDA and on the CPU: the kernels ran,
    bytes are exact, metrics are in the golden band."""
    _card()
    from repro_torch.configs.paper import MNIST_CLASSIFIER
    from repro_torch.core import FederatedRun, FLConfig, QuantizeCompressor
    from repro_torch.data.pipeline import (mnist_like, train_eval_split,
                                           uniform_partition)
    runs = {}
    for dev in ("cuda", "cpu"):
        train, ev = train_eval_split(mnist_like(0, 256), 64)
        _lib.reset_launches()
        run = FederatedRun(
            MNIST_CLASSIFIER, uniform_partition(0, train, 3),
            FLConfig(n_rounds=2, local_epochs=1, payload="update",
                     error_feedback=True, seed=0),
            compressors=[QuantizeCompressor(bits=8) for _ in range(3)],
            eval_data=ev, device=dev)
        run.run()
        runs[dev] = (run.history, _lib.counts())
    assert runs["cuda"][1]["quantize_blocks_2d"] == 6       # 3 clients x 2
    assert runs["cuda"][1]["dequantize_blocks_2d"] == 8     # + 1 server x 2
    assert runs["cpu"][1] == {}
    for a, b in zip(runs["cpu"][0], runs["cuda"][0]):
        assert a.bytes_up == b.bytes_up and a.bytes_down == b.bytes_down
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(b.global_metrics[k],
                                       a.global_metrics[k], **BAND)


def _ragged(seed, shapes, K, N, D):
    """Buckets of ``(C_b, M_b)`` on the card, weights Σ=1 per bucket."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    hs, ws = [], []
    for C_b, M_b in shapes:
        hs.append(torch.randn((C_b, M_b, K), generator=g, device="cuda"))
        w = torch.rand((C_b,), generator=g, device="cuda") + 0.1
        ws.append(w / w.sum() if C_b else w)
    w_stack = torch.randn((D, K, N), generator=g, device="cuda") * K ** -0.5
    b_stack = torch.randn((D, N), generator=g, device="cuda")
    return hs, ws, w_stack, b_stack


GROUPED_CASES = [
    # run (d): two rungs of 2 clients, 4 chunks, two slots
    ([(2, 4), (2, 4)], 512, 4096, [0, 1]),
    # ragged M and C, C_b = 1, an empty bucket between live ones, a shared
    # slot
    ([(3, 20), (0, 8), (1, 8), (5, 33)], 32, 256, [1, 0, 0, 1]),
    ([(7, 100), (2, 3)], 64, 130, [0, 0]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shapes,K,N,dec_idx", GROUPED_CASES)
def test_grouped_kernel_matches_plain_and_per_bucket(shapes, K, N, dec_idx):
    _card()
    hs, ws, w_stack, b_stack = _ragged(len(shapes) * K, shapes, K, N,
                                       max(dec_idx) + 1)
    before = _lib.counts().get("grouped_fused_decode_agg", 0)
    got = grouped_fused_decode_agg(hs, ws, w_stack, b_stack, dec_idx)
    torch.cuda.synchronize()
    assert _lib.counts()["grouped_fused_decode_agg"] == before + 1
    want = ref.grouped_fused_decode_agg_ref(hs, ws, w_stack, b_stack,
                                            dec_idx)
    for h, w, d, g, r in zip(hs, ws, dec_idx, got, want):
        assert tuple(g.shape) == (h.shape[1], N)
        if h.shape[0] == 0:
            assert not g.any()                     # exact zeros
            continue
        torch.testing.assert_close(g, r, atol=2e-5, rtol=1e-4)
        # the shared body: bit-equal to kernel 4 on this bucket alone
        assert torch.equal(g, fused_decode_agg(h, w, w_stack[d].contiguous(),
                                               b_stack[d].contiguous()))


@pytest.mark.gpu
def test_grouped_kernel_all_empty_launches_nothing():
    _card()
    before = _lib.counts().get("grouped_fused_decode_agg", 0)
    out = grouped_fused_decode_agg(
        [torch.zeros((0, 16, 8), device="cuda")],
        [torch.zeros(0, device="cuda")], torch.ones((1, 8, 32), device="cuda"),
        torch.ones((1, 32), device="cuda"), [0])
    assert tuple(out[0].shape) == (16, 32) and not out[0].any()
    assert _lib.counts().get("grouped_fused_decode_agg", 0) == before


@pytest.mark.gpu
def test_partitioned_grouped_run_on_card_matches_cpu():
    """Run (d) of chip_smoke.py: a partitioned cohort at full width, two
    chunked-AE rungs in one grouped launch a round, on CUDA and on the
    CPU."""
    _card()
    from repro_torch.configs.paper import MNIST_CLASSIFIER
    from repro_torch.core import (ChunkedAECompressor, ChunkedAEConfig,
                                  FederatedRun, FLConfig,
                                  PartitionedCompressor, QuantizeCompressor,
                                  by_layer_partition, init_chunked_ae)
    from repro_torch.core.pytree import ravel
    from repro_torch.core.task import ClassifierTask
    from repro_torch.data.pipeline import (mnist_like, train_eval_split,
                                           uniform_partition)
    cfgs = (ChunkedAEConfig(), ChunkedAEConfig(latent_chunk=4))
    task = ClassifierTask(MNIST_CLASSIFIER)
    runs = {}
    for dev in ("cuda", "cpu"):
        pmap = by_layer_partition(task.init_params(torch.Generator(), dev))
        prms = [init_chunked_ae(torch.Generator().manual_seed(2 + i), c, dev)
                for i, c in enumerate(cfgs)]
        comps = [PartitionedCompressor(pmap, {
            "dense0": ChunkedAECompressor(prms[i // 2], cfgs[i // 2],
                                          use_kernel=True),
            "dense1": QuantizeCompressor(bits=8 if i % 2 == 0 else 4)})
            for i in range(4)]
        train, ev = train_eval_split(mnist_like(0, 576), 64)
        _lib.reset_launches()
        run = FederatedRun(
            MNIST_CLASSIFIER, uniform_partition(0, train, 4),
            FLConfig(n_rounds=2, local_epochs=1, payload="update",
                     error_feedback=True, use_grouped_kernel=True, seed=0),
            compressors=comps, eval_data=ev, device=dev)
        run.run()
        runs[dev] = (run, _lib.counts())
    counts = runs["cuda"][1]
    assert counts["grouped_fused_decode_agg"] == 2            # one a round
    assert "fused_decode_agg" not in counts
    assert runs["cpu"][1] == {}
    for a, b in zip(runs["cpu"][0].history, runs["cuda"][0].history):
        assert a.bytes_up == b.bytes_up == 1168
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(b.global_metrics[k],
                                       a.global_metrics[k], **BAND)
    np.testing.assert_allclose(
        ravel(runs["cuda"][0].global_params)[0].cpu().numpy(),
        ravel(runs["cpu"][0].global_params)[0].numpy(), **BAND)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,window", [("causal", None), ("window", 50),
                                         ("full", None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 4, 7])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_kernel_matches_plain(mode, window, dtype, G, D):
    """Kernel 6 against its plain version: ragged lengths (not multiples of
    the 64-row tiles), a q shorter than kv, GQA groups up to 7. Tolerance:
    float32 that of the reference's Pallas test; bfloat16 two ulps of the
    output (2 * 2**-7 relative, 1e-3 near zero): both sum in float32 and
    round once, so they differ by at most one ulp."""
    _card()
    tol = (dict(atol=3e-5, rtol=1e-3) if dtype == torch.float32
           else dict(atol=1e-3, rtol=1.6e-2))
    for B, Sq, Skv, KV in ((2, 77, 77, 2), (1, 200, 200, 1),
                           (2, 130, 203, 2)):
        g = torch.Generator(device="cuda").manual_seed(Sq * G + D)
        q = torch.randn((B, Sq, KV * G, D), generator=g, device="cuda")
        k = torch.randn((B, Skv, KV, D), generator=g, device="cuda")
        v = torch.randn((B, Skv, KV, D), generator=g, device="cuda")
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        before = _lib.counts().get("flash_attention", 0)
        got = flash_attention(q, k, v, mode=mode, window=window)
        torch.cuda.synchronize()
        assert _lib.counts()["flash_attention"] == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(
            got.float(),
            ref.flash_attention_ref(q, k, v, mode=mode,
                                    window=window).float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,mode,window", [
    (2, 77, 77, 4, 2, 16, "causal", None),
    (1, 300, 300, 7, 1, 16, "window", 40),
    (2, 130, 203, 4, 4, 16, "full", None),
    (2, 77, 77, 4, 2, 32, "causal", None),
    (1, 300, 300, 7, 1, 32, "window", 40),
    (2, 130, 203, 4, 4, 32, "full", None),
    (1, 1024, 1024, 56, 8, 128, "causal", None),   # run (f), one prompt
    (1, 459, 459, 8, 2, 128, "causal", None),      # four q tiles, ragged
    (2, 387, 387, 8, 8, 64, "window", 100),
    (1, 259, 517, 4, 1, 128, "full", None),
])
def test_flash_attention_bf16_wgmma_matches_plain(B, Sq, Skv, H, KV, D, mode,
                                                  window):
    """Kernel 6's bfloat16 route (wgmma fed by TMA) at head dims 16 and 32
    (32- and 64-byte swizzles), at a run (f)-like shape, and with Sq over
    several 128-row q tiles with ragged tails (rows past Sq not stored,
    kv rows past Skv zero-filled and masked): against the plain version
    within two bf16 ulps, one launch a call."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(Sq * H + D)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(
        torch.bfloat16) for shape in ((B, Sq, H, D), (B, Skv, KV, D),
                                      (B, Skv, KV, D)))
    before = _lib.counts().get("flash_attention", 0)
    got = flash_attention(q, k, v, mode=mode, window=window)
    torch.cuda.synchronize()
    assert _lib.counts()["flash_attention"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(
        got.float(), ref.flash_attention_ref(q, k, v, mode=mode,
                                             window=window).float(),
        atol=1e-3, rtol=1.6e-2)


NATIVE_PAIR_CASES = [
    # B, Sq, Skv, H, KV, mode, window, q_offset, softcap
    (2, 77, 77, 4, 4, "causal", None, 0, 0.0),      # Sq off 128, Skv off 64
    (1, 459, 459, 8, 2, "causal", None, 0, 0.0),    # four q tiles, GQA 4
    (1, 300, 300, 7, 1, "window", 40, 0, 0.0),      # MQA, G = 7
    (2, 130, 203, 4, 2, "full", None, 0, 0.0),      # Sq < Skv
    (1, 203, 130, 4, 4, "full", None, 0, 0.0),      # Sq > Skv
    (2, 70, 331, 4, 2, "causal", None, 261, 0.0),   # queries late in kv
    (2, 70, 331, 4, 2, "window", 90, 261, 0.0),
    (2, 150, 150, 4, 2, "causal", None, 0, 30.0),   # softcap
    (1, 100, 400, 4, 1, "window", 120, 250, 40.0),  # all three
    (1, 1024, 1024, 40, 40, "causal", None, 0, 0.0),  # run (r), one prompt
]


@pytest.mark.gpu
@pytest.mark.parametrize("D,Dv", [(96, 64), (96, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,mode,window,q_offset,softcap",
                         NATIVE_PAIR_CASES)
def test_flash_attention_native_pairs_match_plain(D, Dv, dtype, B, Sq, Skv, H,
                                                  KV, mode, window, q_offset,
                                                  softcap):
    """Kernel 6 at MLA's (96, 64) and phi-3's (96, 96) head dims, natively
    (q and k three 32-column panels at a 64-byte swizzle, v and the output
    Dv wide): causal, window and full, GQA and MQA, ``q_offset``,
    ``softcap``, Skv off the 64-key tiles and Sq off the 128-row q tiles;
    against the plain version at ``FLASH_TOL``, one launch a call on the
    native route (``wgmma`` / ``fma``), none padded."""
    _card()
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(Sq * H + Skv + Dv)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((B, Sq, H, D), (B, Skv, KV, D),
                             (B, Skv, KV, Dv)))
    kw = dict(mode=mode, window=window, q_offset=q_offset, softcap=softcap)
    before = _lib.counts().get("flash_attention", 0)
    routes = dict(fa.ROUTE_LAUNCHES)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _lib.counts()["flash_attention"] == before + 1
    route = fa.kernel_route(dtype)
    assert dict(fa.ROUTE_LAUNCHES - collections.Counter(routes)) == {route: 1}
    assert got.dtype == dtype and tuple(got.shape) == (B, Sq, H, Dv)
    torch.testing.assert_close(
        got.float(), ref.flash_attention_ref(q, k, v, **kw).float(),
        **FLASH_TOL[dtype])


@pytest.mark.gpu
def test_flash_attention_kernel_refuses_what_it_cannot_compute():
    _card()
    q = torch.zeros((1, 16, 4, 48), device="cuda")        # D = 48
    k = torch.zeros((1, 16, 2, 48), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, k)
    q = torch.zeros((1, 16, 4, 64), device="cuda", dtype=torch.float16)
    k = torch.zeros((1, 16, 2, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, k, k)
    q = torch.zeros((1, 4, 16, 64), device="cuda").transpose(1, 2)
    k = torch.zeros((1, 16, 2, 64), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, k, k)
    q = torch.zeros(1 + 16 * 4 * 64, device="cuda",
                    dtype=torch.bfloat16)[1:].view(1, 16, 4, 64)
    k = torch.zeros((1, 16, 2, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, k, k)
    from repro_torch.models.attention import flash_attention as model_flash
    q = torch.zeros((1, 16, 4, 64), device="cuda", dtype=torch.float16)
    k = torch.zeros((1, 16, 2, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        model_flash(q, k, k, softcap=30.0)


@pytest.mark.gpu
def test_reduced_lm_on_card_matches_cpu():
    """deepseek-coder-33b reduced (2 layers, 14 heads over 2 KV heads,
    float32): prefill and 4 greedy decode steps on the card against the CPU
    from the same weights, the CPU fed the card's tokens. Prefill launches
    kernel 6 once a layer; decode launches nothing."""
    _card()
    import dataclasses
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_map
    from repro_torch.data.pipeline import synthetic_lm_batch
    cfg = dataclasses.replace(get_config("deepseek_coder_33b").reduced(),
                              n_heads=14, n_kv_heads=2)
    params = models.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    gparams = tree_map(lambda t: t.cuda(), params)
    batch = synthetic_lm_batch(0, cfg.vocab_size, 2, 100)
    gbatch = {k: v.cuda() for k, v in batch.items()}
    _lib.reset_launches()
    glogits, gcache = models.prefill(gparams, cfg, gbatch, 104)
    torch.cuda.synchronize()
    assert _lib.counts() == {"flash_attention": cfg.n_layers}
    logits, cache = models.prefill(params, cfg, batch, 104)
    torch.testing.assert_close(glogits.cpu(), logits, **BAND)
    for step in range(4):
        token = glogits[:, :cfg.vocab_size].argmax(-1)[:, None]
        glogits, gcache = models.decode_step(gparams, cfg, token, gcache)
        logits, cache = models.decode_step(params, cfg, token.cpu(), cache)
        torch.testing.assert_close(glogits.cpu(), logits, **BAND)
    torch.cuda.synchronize()
    assert _lib.counts() == {"flash_attention": cfg.n_layers}
    assert gcache["index"] == cache["index"] == 104
    for key in ("k", "v"):
        torch.testing.assert_close(gcache["layers"][key].cpu(),
                                   cache["layers"][key], **BAND)


@pytest.mark.gpu
def test_train_loss_gradient_on_card_matches_cpu():
    """``train_loss``'s gradient on the card against the CPU's, every
    parameter leaf in the golden band: with q, k and v requiring grad the
    model's attention takes the differentiable chunked math, so kernel 6
    launches neither in the forward nor in the backward pass; a
    ``torch.no_grad()`` prefill of the same weights still launches it once
    a layer."""
    _card()
    import dataclasses
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import flatten, tree_map, value_and_grad
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.models.attention import attention_route
    cfg = dataclasses.replace(get_config("deepseek_coder_33b").reduced(),
                              n_heads=14, n_kv_heads=2)
    params = models.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    gparams = tree_map(lambda t: t.cuda(), params)
    batch = synthetic_lm_batch(0, cfg.vocab_size, 2, 64)
    gbatch = {k: v.cuda() for k, v in batch.items()}
    q = torch.zeros((1, 4, 2, 16), device="cuda", requires_grad=True)
    assert attention_route(q, q, q) == "plain"
    with torch.no_grad():
        assert attention_route(q, q, q) == "kernel"

    def loss_fn(p, bt):
        return models.train_loss(p, cfg, bt)

    before = _lib.counts().get("flash_attention", 0)
    gloss, _, ggrads = value_and_grad(loss_fn, gparams, gbatch)
    torch.cuda.synchronize()
    assert _lib.counts().get("flash_attention", 0) == before
    loss, _, grads = value_and_grad(loss_fn, params, batch)
    torch.testing.assert_close(gloss.cpu(), loss, **BAND)
    gl, _ = flatten(ggrads)
    cl, _ = flatten(grads)
    assert len(gl) == len(cl) > 0
    for gg, cg in zip(gl, cl):
        torch.testing.assert_close(gg.cpu(), cg, **BAND)
    assert any(float(g.abs().max()) > 0 for g in gl)
    with torch.no_grad():
        models.prefill(gparams, cfg, gbatch, 64)
    torch.cuda.synchronize()
    assert (_lib.counts().get("flash_attention", 0)
            == before + cfg.n_layers)


# ------------------------------------------------- the scalable runtime
def _tied_cuda(seed: int, n: int = 15_910) -> torch.Tensor:
    """Repeated magnitudes: zeros, ± pairs of one value, a block of equal
    values across the top-k cut."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * 0.1).astype(np.float32)
    x[: n // 10] = 0.0
    x[n // 4: n // 4 + 400] = 0.25
    x[n // 2: n // 2 + 400] = -0.25
    return torch.from_numpy(x)


@pytest.mark.gpu
@pytest.mark.parametrize("seed,k", [(0, 159), (1, 500), (2, 1200)])
def test_topk_on_card_equals_cpu_bit_for_bit(seed, k):
    _card()
    from repro_torch.core import codec
    spec = codec.ChainSpec((codec.TopKSpec(15_910, k),
                            codec.QuantizeSpec(k)))
    x = _tied_cuda(seed)
    pg = codec.encode(spec, None, x.cuda())
    pc = codec.encode(spec, None, x)
    for st in pg:
        for key in pg[st]:
            assert torch.equal(pg[st][key].cpu(), pc[st][key]), (st, key)
    assert pg["s0"]["indices"].dtype == torch.int32
    assert torch.equal(codec.decode(spec, None, pg).cpu(),
                       codec.decode(spec, None, pc))


@pytest.mark.gpu
def test_cifar_cnn_logits_and_gradient_on_card_match_cpu():
    """Full CIFAR width; the classifier turns TF32 off for its convs itself,
    so the global cuDNN flag is left on here."""
    _card()
    from repro_torch.configs.paper import CIFAR_CLASSIFIER
    from repro_torch.core.pytree import ravel, tree_map, value_and_grad
    from repro_torch.data.pipeline import cifar_like
    from repro_torch.models.classifiers import (apply_classifier,
                                                classifier_loss,
                                                init_classifier)
    params = init_classifier(torch.Generator().manual_seed(0),
                             CIFAR_CLASSIFIER, "cpu")
    pg = tree_map(lambda t: t.cuda(), params)
    data = cifar_like(0, 64)
    dg = {k: v.cuda() for k, v in data.items()}
    torch.backends.cudnn.allow_tf32 = True
    try:
        lg = apply_classifier(pg, CIFAR_CLASSIFIER, dg["x"])
        _, _, gg = value_and_grad(
            lambda p, b: classifier_loss(p, CIFAR_CLASSIFIER, b), pg, dg)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cudnn.allow_tf32 is False
    lc = apply_classifier(params, CIFAR_CLASSIFIER, data["x"])
    _, _, gc_ = value_and_grad(
        lambda p, b: classifier_loss(p, CIFAR_CLASSIFIER, b), params, data)
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), **BAND)
    np.testing.assert_allclose(ravel(gg)[0].cpu().numpy(),
                               ravel(gc_)[0].numpy(), **BAND)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 7, 50])
def test_pop_k_device_on_card_equals_arrival_engine(k):
    _card()
    from repro_torch.core import ArrivalEngine, LatencyModel, pop_k_device
    n = 200
    lat = LatencyModel(jitter=0.5, straggler_frac=0.1, seed=4)
    eng = ArrivalEngine(n)
    for ci in range(n):
        # every fifth client on one time: equal-time ties across seqs
        eng.push(ci, 1.0 if ci % 5 == 0 else lat.sample(ci, 0, n))
    times = torch.from_numpy(eng.times).cuda()
    seqs = torch.from_numpy(eng.seqs).cuda()
    t_dev, i_dev = pop_k_device(times, seqs, k)
    popped = eng.pop_k(k)
    assert i_dev.cpu().tolist() == [ci for _, ci in popped]
    assert t_dev.cpu().tolist() == [t for t, _ in popped]


@pytest.mark.gpu
def test_async_engines_bit_identical_on_card():
    _card()
    from repro_torch.configs.paper import MNIST_CLASSIFIER
    from repro_torch.core import (AsyncBuffered, ChainCompressor,
                                  FederatedRun, FLConfig, LatencyModel,
                                  QuantizeCompressor, TopKCompressor)
    from repro_torch.core.pytree import ravel
    from repro_torch.data.pipeline import (mnist_like, train_eval_split,
                                           uniform_partition)
    train, ev = train_eval_split(mnist_like(0, 16 * 128 + 64), 64)
    shards = uniform_partition(0, train, 16)
    out = {}
    for engine in ("heap", "vector"):
        run = FederatedRun(
            MNIST_CLASSIFIER, shards,
            FLConfig(n_rounds=4, local_epochs=2, payload="update",
                     error_feedback=True),
            compressors=[ChainCompressor([TopKCompressor(0.01),
                                          QuantizeCompressor(bits=8)])
                         for _ in range(16)],
            eval_data=ev, device="cuda",
            scheduler=AsyncBuffered(buffer_k=4, engine=engine,
                                    latency=LatencyModel(
                                        jitter=0.5, straggler_frac=0.25,
                                        straggler_mult=8.0)))
        out[engine] = (run.run(), ravel(run.global_params)[0])
    (hh, ph), (hv, pv) = out["heap"], out["vector"]
    for a, b in zip(hh, hv, strict=True):
        assert (a.participants, a.staleness, a.sim_time, a.bytes_up,
                a.bytes_down) == (b.participants, b.staleness, b.sim_time,
                                  b.bytes_up, b.bytes_down)
        assert a.global_metrics == b.global_metrics
    assert torch.equal(ph, pv)


# ---------------------------------------------- lifecycle and checkpoints
def _lifecycle_run(device, n_rounds, engine=None):
    """The MLP, 3 clients of 64 examples, the kernel-path chunked AE
    (``ChunkedAEConfig(256, (32,), 8)``, 63 chunks) on one params object,
    an ``AELifecycle`` refitting every round from round 1 (2 epochs), update
    payload with error feedback; ``SyncFedAvg``, or ``AsyncBuffered`` with
    ``engine``."""
    from repro_torch.configs.paper import MNIST_CLASSIFIER
    from repro_torch.core import (AELifecycle, AsyncBuffered,
                                  ChunkedAECompressor, ChunkedAEConfig,
                                  FederatedRun, FLConfig, LatencyModel,
                                  init_chunked_ae)
    from repro_torch.data.pipeline import (mnist_like, train_eval_split,
                                           uniform_partition)
    cfg = ChunkedAEConfig(256, (32,), 8)
    ae = init_chunked_ae(torch.Generator().manual_seed(3), cfg, device)
    ae["norm"] = {"mean": torch.zeros((), device=device),
                  "std": torch.full((), 1e-3, device=device)}
    train, ev = train_eval_split(mnist_like(0, 3 * 64 + 64), 64)
    sched = (None if engine is None else AsyncBuffered(
        buffer_k=2, engine=engine, latency=LatencyModel(jitter=0.3)))
    return FederatedRun(
        MNIST_CLASSIFIER, uniform_partition(0, train, 3),
        FLConfig(n_rounds=n_rounds, local_epochs=1, payload="update",
                 error_feedback=True),
        compressors=[ChunkedAECompressor(ae, cfg, use_kernel=True)
                     for _ in range(3)],
        eval_data=ev, device=device, scheduler=sched,
        lifecycle=AELifecycle(refresh_every=1, min_snapshots=1,
                              refresh_epochs=2))


def _state_leaves(run):
    from repro_torch.core.pytree import leaves
    return leaves([run.global_params,
                   [[c.residual, c.dispatched, c.snapshots]
                    for c in run.clients],
                   [c.codec_params() for c in run.compressors]])


@pytest.mark.gpu
def test_lifecycle_refit_on_card_matches_cpu():
    _card()
    runs = {dev: _lifecycle_run(dev, 3) for dev in ("cuda", "cpu")}
    hists = {dev: r.run() for dev, r in runs.items()}
    for a, b in zip(hists["cuda"], hists["cpu"], strict=True):
        assert (a.ae_syncs, a.bytes_decoder, a.bytes_down, a.bytes_up) == \
            (b.ae_syncs, b.bytes_decoder, b.bytes_down, b.bytes_up)
    assert hists["cuda"][1].ae_syncs == [0, 1, 2]
    for x, y in zip(_state_leaves(runs["cuda"]), _state_leaves(runs["cpu"]),
                    strict=True):
        torch.testing.assert_close(x.cpu(), y, **BAND)
    for a, b in zip(runs["cuda"].clients, runs["cpu"].clients):
        np.testing.assert_allclose(a.ae_baseline, b.ae_baseline, **BAND)


@pytest.mark.gpu
def test_checkpoint_saved_on_card_loads_on_cpu_and_back(tmp_path):
    """Two rounds on one device, saved, restored on the other: the state
    restores exactly; the next round there matches the uninterrupted run
    on the first device within the golden band."""
    _card()
    for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
        full = _lifecycle_run(src, 3)
        full.run()
        first = _lifecycle_run(src, 2)
        first.run()
        path = str(tmp_path / f"{src}.npz")
        first.save_state(path)
        resumed = _lifecycle_run(dst, 1)
        assert resumed.load_state(path) == 2
        for x, y in zip(_state_leaves(first), _state_leaves(resumed),
                        strict=True):
            assert y.device.type == dst and torch.equal(x.cpu(), y.cpu())
        resumed.run()
        a, b = full.history[2], resumed.history[0]
        assert (a.ae_syncs, a.bytes_decoder, a.bytes_down) == \
            (b.ae_syncs, b.bytes_decoder, b.bytes_down)
        for x, y in zip(_state_leaves(full), _state_leaves(resumed),
                        strict=True):
            torch.testing.assert_close(y.cpu(), x.cpu(), **BAND)


@pytest.mark.gpu
@pytest.mark.parametrize("saver,loader", [("heap", "vector"),
                                          ("vector", "heap")])
def test_async_checkpoint_restores_into_the_other_engine_on_card(
        saver, loader, tmp_path):
    _card()
    full = _lifecycle_run("cuda", 3, engine=loader)
    full.run()
    first = _lifecycle_run("cuda", 2, engine=saver)
    first.run()
    path = str(tmp_path / "async.npz")
    first.save_state(path)
    resumed = _lifecycle_run("cuda", 1, engine=loader)
    resumed.load_state(path)
    resumed.run()
    a, b = full.history[2], resumed.history[0]
    for k in ("participants", "staleness", "sim_time", "bytes_up",
              "bytes_down", "bytes_decoder", "ae_syncs", "global_metrics"):
        assert getattr(a, k) == getattr(b, k), k
    for x, y in zip(_state_leaves(full), _state_leaves(resumed),
                    strict=True):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(100_000, 16), (30_000, 300)])
def test_kmeans_on_card_matches_cpu_and_repeats(n, k):
    _card()
    from repro_torch.core import (ChainCompressor, KMeansCompressor,
                                  TopKCompressor, codec)
    x = torch.randn((n,), generator=torch.Generator().manual_seed(k)) * 1e-2
    spec = codec.KMeansSpec(n, k, 8)
    cpu = codec.encode(spec, None, x)
    card = [codec.encode(spec, None, x.cuda()) for _ in range(2)]
    assert torch.equal(card[0]["codes"], card[1]["codes"])
    assert torch.equal(card[0]["codebook"], card[1]["codebook"])
    torch.testing.assert_close(card[0]["codebook"].cpu(), cpu["codebook"],
                               **BAND)
    err = float((card[0]["codebook"].cpu() - cpu["codebook"]).abs().max())
    cb = torch.sort(cpu["codebook"])[0]
    mids = (cb[1:] + cb[:-1]) / 2
    near = ((x[:, None] - mids[None, :]).abs() <= 2 * err + 1e-9).any(1)
    differ = card[0]["codes"].cpu() != cpu["codes"]
    assert not bool((differ & ~near).any())
    chain = ChainCompressor([TopKCompressor(0.01), KMeansCompressor()],
                            entropy_coded=True)
    cspec = chain.spec(n)
    assert codec.measured_bytes(cspec, codec.encode(cspec, None, x.cuda())) \
        == codec.measured_bytes(cspec, codec.encode(cspec, None, x))


# ------------------------------------------------------------ rate control
def _chip_smoke():
    """``chip_smoke.py`` as a module, for run (n)'s constructors."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probe_ladder(dev):
    """An FC AE a client (vmapped), a kernel-path chunked AE shared by
    clients 0 and 1 and another for client 2 (folded rows, one call per
    params object), q4 off the block size (folded blocks)."""
    from repro_torch import core as T
    from repro_torch.configs.paper import AEConfig
    ccfg = T.ChunkedAEConfig(chunk_size=256, hidden=(32,), latent_chunk=4)
    fcfg = AEConfig(input_dim=15_910, encoder_hidden=(16,), latent_dim=8)
    chunked = []
    for seed in (1, 2):
        p = T.init_chunked_ae(torch.Generator().manual_seed(seed), ccfg, dev)
        p["norm"] = {"mean": torch.zeros((), device=dev),
                     "std": torch.full((), 1e-3, device=dev)}
        chunked.append(p)
    return [[T.FCAECompressor(T.init_fc_ae(
        torch.Generator().manual_seed(10 + ci), fcfg, dev), fcfg),
        T.ChunkedAECompressor(chunked[ci // 2], ccfg, use_kernel=True),
        T.QuantizeCompressor(bits=4, block=100)] for ci in range(3)]


@pytest.mark.gpu
def test_rate_probe_on_card_matches_per_lane_oracle():
    """The batched probe on the card: one q4 quantize and dequantize for
    the three lanes, four ``fused_dense`` launches for each chunked-AE
    params object (never the plain version); every entry against the
    lane's own probe at rtol 1e-5, and the CPU's matrix in the band."""
    _card()
    from repro_torch import core as T
    from repro_torch.configs.paper import MNIST_CLASSIFIER
    from repro_torch.data import pipeline as tpipe
    snaps = (np.random.RandomState(0).randn(3, 15_910) * 1e-3).astype(
        np.float32)
    mats = {}
    for dev in ("cuda", "cpu"):
        train, ev = tpipe.train_eval_split(tpipe.mnist_like(0, 256), 64)
        rc = T.RateController(ladder=_probe_ladder(dev), min_snapshots=1)
        run = T.FederatedRun(MNIST_CLASSIFIER,
                             tpipe.uniform_partition(0, train, 3),
                             T.FLConfig(n_rounds=1), eval_data=ev,
                             ratecontrol=rc, device=dev)
        for ci in range(3):
            run.clients[ci].snapshots = [torch.from_numpy(snaps[ci]).to(dev)]
        before = _lib.counts()
        mats[dev] = rc._probe_all(run, [0, 1, 2])
        delta = {k: v - before.get(k, 0) for k, v in _lib.counts().items()
                 if v - before.get(k, 0)}
        if dev == "cuda":
            card_rc, card_run, card_delta = rc, run, delta
    assert card_delta == {"fused_dense": 8, "quantize_blocks_2d": 1,
                          "dequantize_blocks_2d": 1}
    assert card_rc.probe_dispatches == 1
    errs = mats["cuda"]
    for k in range(3):
        for ci in range(3):
            want = card_rc._rung_err(card_run, ci, k,
                                     card_run.clients[ci].snapshots[-1])
            np.testing.assert_allclose(errs[k, ci], want, rtol=1e-5,
                                       atol=1e-12)
    np.testing.assert_allclose(errs, mats["cpu"], **BAND)


@pytest.mark.gpu
def test_rate_cnn_reduced_card_vs_cpu():
    """Run (n)'s reduced copy (``chip_smoke.rate_cnn_replay``: 2 clients,
    3 rounds, the CIFAR CNN's per-partition ladder under RDBudget, shared
    AE rungs fitted on the card) on the card and the CPU, the CPU encoding
    the card's trained local models: codes, switches, occupancy and bytes
    exact, payloads, global params, loss, accuracy and the controller
    state in the golden band, the local models too but where both
    devices' Adam step is partial; the card's grouped round launched
    kernel 5."""
    _card()
    cs = _chip_smoke()
    torch.backends.cudnn.deterministic = True
    try:
        fit = cs.prefit_cnn_rungs("cuda", prepass_epochs=4, fit_epochs=10)
        before = _lib.counts()
        cs.rate_cnn_replay(fit)
        after = _lib.counts()
    finally:
        torch.backends.cudnn.deterministic = False
    assert after.get("grouped_fused_decode_agg", 0) > \
        before.get("grouped_fused_decode_agg", 0)


@pytest.mark.gpu
def test_async_distortion_power_card_vs_cpu():
    """``AsyncBuffered(distortion_power=1)`` under a DistortionTarget
    ladder on the card and the CPU: arrivals, staleness, switches and
    bytes exact; the probed distortions and parameters in the band."""
    _card()
    from repro_torch import core as T
    from repro_torch.configs.paper import MNIST_CLASSIFIER
    from repro_torch.core.pytree import ravel
    from repro_torch.data import pipeline as tpipe
    runs = {}
    for dev in ("cuda", "cpu"):
        train, ev = tpipe.train_eval_split(tpipe.mnist_like(0, 320), 64)
        rc = T.DistortionTarget(
            ladder=[[T.QuantizeCompressor(bits=4),
                     T.QuantizeCompressor(bits=8), T.IdentityCompressor()]
                    for _ in range(4)],
            target=1e-3, margin=1e-3, min_snapshots=1)
        run = T.FederatedRun(
            MNIST_CLASSIFIER, tpipe.uniform_partition(0, train, 4),
            T.FLConfig(n_rounds=4, local_epochs=1, batch_size=16,
                       payload="update"),
            eval_data=ev, ratecontrol=rc, device=dev,
            scheduler=T.AsyncBuffered(
                buffer_k=2, distortion_power=1.0,
                latency=T.LatencyModel(jitter=0.3, straggler_frac=0.25)))
        run.run()
        runs[dev] = run
    g, c = runs["cuda"], runs["cpu"]
    for a, b in zip(g.history, c.history, strict=True):
        for k in ("participants", "staleness", "sim_time", "spec_switches",
                  "bytes_up", "bytes_down", "bytes_decoder"):
            assert getattr(a, k) == getattr(b, k), k
    for ci in range(4):
        da, db = (g.ratecontrol.distortion_of(ci),
                  c.ratecontrol.distortion_of(ci))
        assert (da is None) == (db is None)
        if da is not None:
            np.testing.assert_allclose(da, db, **BAND)
    torch.testing.assert_close(ravel(g.global_params)[0].cpu(),
                               ravel(c.global_params)[0], **BAND)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["q8", "chunked_ae"])
def test_serve_step_flat_memory_and_deterministic_on_card(kind):
    """The serve loop on the card: allocated memory equal after every
    round from the second on (two preallocated generations), the kernels
    launched every round, and two fresh runs ``torch.equal``. Each reading
    follows a ``gc.collect()``, so garbage that earlier tests left in
    reference cycles cannot be freed between two readings (the step
    makes no cycles: a leak would survive the collection)."""
    _card()
    import gc
    from repro_torch.core import codec, serve
    from repro_torch.core.autoencoder import ChunkedAEConfig, init_chunked_ae
    if kind == "q8":
        spec, params = codec.QuantizeSpec(size=1 << 14, bits=8), None
        want = {"dequantize_blocks_2d"}
    else:
        ch = ChunkedAEConfig(256, (32,), 8)
        spec = codec.ChunkedAESpec(1 << 14, ch, use_kernel=True)
        params = init_chunked_ae(torch.Generator().manual_seed(0), ch,
                                 "cuda")
        want = {"fused_dense", "fused_decode_agg"}
    cfg = serve.ServeConfig(n_clients=20_000, buffer_k=128, spec=spec,
                            jitter=0.4, straggler_frac=0.05, seed=0)
    finals = []
    for _ in range(2):
        step = serve.make_step(cfg, params)
        state = serve.init_state(cfg, params)
        mem = []
        for _ in range(5):
            before = _lib.counts()
            state = step(state)
            torch.cuda.synchronize()
            after = _lib.counts()
            assert all(after.get(k, 0) > before.get(k, 0) for k in want)
            gc.collect()
            mem.append(torch.cuda.memory_allocated())
        assert len(set(mem[1:])) == 1, mem
        finals.append(state)
    for key in finals[0]:
        assert torch.equal(finals[0][key], finals[1][key]), key
    assert int(finals[0]["version"]) == 5


@pytest.mark.gpu
@pytest.mark.parametrize("sched", ["async", "sampled"])
def test_soa_matches_eager_on_card(sched):
    """``soa_state=True`` (the vector engine for async) ``torch.equal`` to
    the eager run (the heap engine) on the card: records, params and
    residuals."""
    _card()
    from repro_torch import core as T
    from repro_torch.configs.paper import MNIST_CLASSIFIER
    from repro_torch.core.pytree import ravel
    from repro_torch.data import pipeline as tpipe

    def mk(soa):
        train, ev = tpipe.train_eval_split(tpipe.mnist_like(0, 352), 32)
        s = (T.AsyncBuffered(buffer_k=2, engine="vector" if soa else "heap",
                             latency=T.LatencyModel(jitter=0.3,
                                                    straggler_frac=0.3))
             if sched == "async" else T.SampledSync(cohort=3))
        return T.FederatedRun(
            MNIST_CLASSIFIER, tpipe.uniform_partition(0, train, 5),
            T.FLConfig(n_rounds=4, local_epochs=1, batch_size=16,
                       payload="update", error_feedback=True, seed=3),
            eval_data=ev, scheduler=s, soa_state=soa,
            compressors=[T.QuantizeCompressor(bits=8) for _ in range(5)])

    eager, pooled = mk(False), mk(True)
    for a, b in zip(eager.run(), pooled.run(), strict=True):
        for k in ("participants", "staleness", "sim_time", "bytes_up",
                  "bytes_down", "global_metrics"):
            assert getattr(a, k) == getattr(b, k), k
    assert isinstance(pooled.clients, T.ClientPool)
    assert torch.equal(ravel(eager.global_params)[0],
                       ravel(pooled.global_params)[0])
    for ce, cp in zip(eager.clients, pooled.clients, strict=True):
        assert (ce.residual is None) == (cp.residual is None)
        if ce.residual is not None:
            assert torch.equal(ravel(ce.residual)[0], ravel(cp.residual)[0])


@pytest.mark.gpu
def test_lm_delta_frozen_roles_exactly_zero_on_card():
    """``LMDeltaTask(freeze_roles=("embedding",))`` on the card: the
    embedding and LM head keep their values bit for bit through two local
    epochs while every other role moves; evaluate launches kernel 6 once a
    layer and the local round launches it never (autograd's route)."""
    _card()
    import dataclasses
    from repro_torch import configs
    from repro_torch import core as T
    from repro_torch.core.pytree import leaf_paths, leaves
    from repro_torch.data import pipeline as tpipe
    cfg = dataclasses.replace(configs.get_config("stablelm_1_6b").reduced(),
                              compute_dtype="bfloat16")
    task = T.LMDeltaTask(cfg, freeze_roles=("embedding",))
    params = task.init_params(torch.Generator(device="cuda").manual_seed(0),
                              "cuda")
    data = {k: v.cuda() for k, v in tpipe.synthetic_lm_batch(
        1, cfg.vocab_size, 4, 64).items()}
    before = _lib.counts().get("flash_attention", 0)
    local, m = task.local_update(
        params, data, T.FLConfig(local_epochs=2, batch_size=2, lr=1e-3,
                                 payload="update"), seed=0, anchor=params)
    assert _lib.counts().get("flash_attention", 0) == before
    assert np.isfinite(m["ce_loss"])
    for (path, _, _), a, b in zip(leaf_paths(params), leaves(local),
                                  leaves(params), strict=True):
        role = T.role_of_path(path)
        if role == "embedding":
            assert torch.equal(a, b), path
        elif role in ("attention", "mlp"):
            assert not torch.equal(a, b), path
    metrics = task.evaluate(local, data)
    assert np.isfinite(metrics["ce_loss"])
    assert _lib.counts().get("flash_attention", 0) == before + cfg.n_layers


# ------------------------------------------- MLA, MoE, optimizers, remat
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_padded_route_matches_plain(dtype):
    """Kernel 6's padded route at a head dim it has no instantiation for,
    (2, 256, 8 x 192/128), causal: q and k zero-padded from 192 to 256, v
    from 128, the kernel at the unpadded scale, the first 128 columns;
    against the plain version on the unpadded inputs. The model-level call
    takes it and counts one padded launch. An explicit scale at a kernel
    head-dim pair (MLA's 96 over 64) launches the kernel natively."""
    _card()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import flash_attention as model_flash
    g = torch.Generator(device="cuda").manual_seed(192)
    q = torch.randn((2, 256, 8, 192), generator=g, device="cuda").to(dtype)
    k = torch.randn((2, 256, 8, 192), generator=g, device="cuda").to(dtype)
    v = torch.randn((2, 256, 8, 128), generator=g, device="cuda").to(dtype)
    want = ref.flash_attention_ref(q, k, v, scale=192 ** -0.5)
    route = fa.kernel_route(dtype) + "_padded"
    before, r0 = _lib.counts(), fa.ROUTE_LAUNCHES[route]
    got = fa.flash_attention_padded(q, k, v)
    via_model = model_flash(q, k, v)
    torch.cuda.synchronize()
    assert fa.padded_head_dim(192, 128) == 256
    assert got.shape == v.shape[:3] + (128,) and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    assert torch.equal(via_model, got)
    assert (_lib.counts()["flash_attention"]
            == before.get("flash_attention", 0) + 2)
    assert fa.ROUTE_LAUNCHES[route] == r0 + 2
    # an explicit scale at a kernel pair takes the native route
    native, n0 = fa.kernel_route(dtype), fa.ROUTE_LAUNCHES[fa.kernel_route(
        dtype)]
    q96, k96 = q[..., :96].contiguous(), k[..., :96].contiguous()
    v64 = v[..., :64].contiguous()
    got = model_flash(q96, k96, v64, scale=0.1)
    torch.testing.assert_close(
        got.float(), ref.flash_attention_ref(q96, k96, v64,
                                             scale=0.1).float(),
        **FLASH_TOL[dtype])
    assert fa.ROUTE_LAUNCHES[native] == n0 + 1
    assert fa.ROUTE_LAUNCHES[route] == r0 + 2


@pytest.mark.gpu
@pytest.mark.parametrize("arch,D,Dv", [("minicpm3-4b", 96, 64),
                                       ("phi-3-vision-4.2b", 96, 96)])
def test_native_pair_prefill_takes_no_padded_route(arch, D, Dv):
    """minicpm3-4b's and phi-3-vision's prefills at full width and 2
    layers (bf16, their own dtypes; two prompts of 640 tokens, phi-3's 576
    image rows first): kernel 6
    launches once a layer on the native ``wgmma`` route, 0 launches padded,
    each call at ``(D, Dv)`` and held against the plain version on the
    model's own q, k and v; the logits finite."""
    _card()
    import dataclasses
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    params = models.init_params(
        torch.Generator(device="cuda").manual_seed(5), cfg, "cuda")
    batch = _family_batch(cfg, 640, 7)
    del batch["labels"]
    gbatch = {k: t.cuda() for k, t in batch.items()}
    kernel, seen = attention.flash_kernel, []

    def held(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        torch.testing.assert_close(
            out.float(), ref.flash_attention_ref(q, k, v, **kw).float(),
            **FLASH_TOL[q.dtype])
        seen.append((q.shape[-1], v.shape[-1]))
        return out
    _lib.reset_launches()
    fa.ROUTE_LAUNCHES.clear()
    attention.flash_kernel = held
    try:
        with torch.no_grad():
            logits, _ = models.prefill(params, cfg, gbatch, 644)
        torch.cuda.synchronize()
    finally:
        attention.flash_kernel = kernel
    assert _lib.counts() == {"flash_attention": cfg.n_layers}
    assert dict(fa.ROUTE_LAUNCHES) == {"wgmma": cfg.n_layers}
    assert seen == [(D, Dv)] * cfg.n_layers
    assert torch.isfinite(logits.float()).all()


def _route_spy():
    """Wraps ``models.moe.route``: records every call's dispatch mask by
    the device it ran on."""
    from repro_torch.models import moe
    real, seen = moe.route, {"cuda": [], "cpu": []}

    def spy(logits, cfg, capacity):
        out = real(logits, cfg, capacity)
        seen[logits.device.type].append(out[0].cpu())
        return out
    return moe, real, spy, seen


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["minicpm3_4b", "dbrx_132b",
                                  "llama4_maverick_400b_a17b"])
def test_mla_moe_reduced_on_card_matches_cpu(arch):
    """Reduced MLA and MoE configs (float32): prefill and 3 greedy decode
    steps on the card against the CPU from the same weights, the CPU fed
    the card's tokens; logits and caches in the golden band, every MoE
    dispatch mask equal; prefill launches kernel 6 once a layer, decode
    never."""
    _card()
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_map
    from repro_torch.data.pipeline import synthetic_lm_batch
    cfg = get_config(arch).reduced()
    params = models.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    gparams = tree_map(lambda t: t.cuda(), params)
    batch = synthetic_lm_batch(0, cfg.vocab_size, 2, 64)
    gbatch = {k: v.cuda() for k, v in batch.items()}
    moe, real, spy, seen = _route_spy()
    moe.route = spy
    try:
        _lib.reset_launches()
        glogits, gcache = models.prefill(gparams, cfg, gbatch, 67)
        torch.cuda.synchronize()
        assert _lib.counts() == {"flash_attention": cfg.n_layers}
        logits, cache = models.prefill(params, cfg, batch, 67)
        torch.testing.assert_close(glogits.cpu(), logits, **BAND)
        for _ in range(3):
            token = glogits[:, :cfg.vocab_size].argmax(-1)[:, None]
            glogits, gcache = models.decode_step(gparams, cfg, token, gcache)
            logits, cache = models.decode_step(params, cfg, token.cpu(),
                                               cache)
            torch.testing.assert_close(glogits.cpu(), logits, **BAND)
    finally:
        moe.route = real
    torch.cuda.synchronize()
    assert _lib.counts() == {"flash_attention": cfg.n_layers}
    for key in gcache["layers"]:
        torch.testing.assert_close(gcache["layers"][key].cpu(),
                                   cache["layers"][key], **BAND)
    n_calls = 4 * cfg.n_layers if cfg.family == "moe" else 0
    assert len(seen["cuda"]) == len(seen["cpu"]) == n_calls
    for a, b in zip(seen["cuda"], seen["cpu"], strict=True):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["minicpm3_4b", "dbrx_132b"])
def test_remat_gradients_equal_on_card(arch):
    """``cfg.remat`` on and off give ``torch.equal`` gradients on the card
    (deterministic algorithms on, as chip_smoke's run (t) has them)."""
    _card()
    import dataclasses
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import flatten, value_and_grad
    from repro_torch.data.pipeline import synthetic_lm_batch
    cfg = get_config(arch).reduced()
    params = models.init_params(
        torch.Generator(device="cuda").manual_seed(1), cfg, "cuda")
    batch = {k: v.cuda() for k, v in
             synthetic_lm_batch(1, cfg.vocab_size, 2, 64).items()}
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for remat in (False, True):
            c = dataclasses.replace(cfg, remat=remat)
            out[remat] = value_and_grad(
                lambda p, bt, c=c: models.train_loss(p, c, bt), params,
                batch)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(flatten(out[False][2])[0], flatten(out[True][2])[0],
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_sgdm_bf16_step_on_card_equals_cpu():
    """One ``sgdm_bf16`` step (bfloat16 momentum, a bfloat16 and a float32
    parameter, grad clip on) on the card equals the CPU's bit for bit, in
    place and not."""
    _card()
    from repro_torch.core.pytree import leaves, tree_map
    from repro_torch.optim.optimizers import make_optimizer
    rs = np.random.RandomState(0)
    p = {"w": torch.from_numpy(rs.randn(64, 48).astype(np.float32)),
         "h": torch.from_numpy(rs.randn(33, 17).astype(np.float32)).to(
             torch.bfloat16)}
    g = tree_map(lambda t: (t.float() * 3.0).to(t.dtype) + 0.25, p)
    opt = make_optimizer("sgdm_bf16", 0.05, grad_clip=5.0)
    outs = {}
    for dev in ("cpu", "cuda"):
        pd, gd = (tree_map(lambda t, d=dev: t.to(d), x) for x in (p, g))
        s = opt.init(pd)
        s["mu"] = tree_map(lambda t: torch.full_like(t, 0.5), s["mu"])
        outs[dev] = opt.update(pd, gd, s)
        ip = tree_map(lambda t: t.clone(), pd)
        is_ = dict(s, mu=tree_map(lambda t: t.clone(), s["mu"]))
        outs[dev + "_inplace"] = opt.update(ip, tree_map(
            lambda t: t.clone(), gd), is_, inplace=True)
    for key in ("cuda", "cpu_inplace", "cuda_inplace"):
        (pa, sa), (pb, sb) = outs[key], outs["cpu"]
        assert sa["mu"]["h"].dtype == torch.bfloat16
        for a, b in zip(leaves(pa) + leaves(sa["mu"]),
                        leaves(pb) + leaves(sb["mu"]), strict=True):
            assert torch.equal(a.cpu(), b), key


# =====================================================================
# kernel 6 at head dim 256 and the SSM, hybrid, audio and VLM families
# =====================================================================
@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,H,KV,mode,window", [
    (2, 77, 77, 4, 1, "causal", None),
    (1, 300, 300, 4, 1, "window", 40),
    (2, 130, 203, 4, 1, "full", None),       # Sq < Skv (cross-attention)
    (1, 203, 130, 2, 2, "full", None),       # Sq > Skv
    (1, 459, 459, 8, 2, "causal", None),     # eight 64-row q tiles, ragged
    (1, 333, 517, 6, 1, "window", 70),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_d256_matches_plain(B, Sq, Skv, H, KV, mode, window,
                                            dtype):
    """Kernel 6 at head dim 256 (recurrentgemma-9b's local attention):
    the float32 FMA kernel and the bfloat16 wgmma kernel, whose two
    consumer warpgroups split O's columns; causal, window and full,
    ragged lengths, Sq != Skv, MQA (one kv head) and GQA; against the
    plain version at ``FLASH_TOL``, one launch a call."""
    _card()
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(Sq * H + Skv)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((B, Sq, H, 256), (B, Skv, KV, 256),
                             (B, Skv, KV, 256)))
    before = _lib.counts().get("flash_attention", 0)
    r0 = fa.ROUTE_LAUNCHES[fa.kernel_route(dtype)]
    got = flash_attention(q, k, v, mode=mode, window=window)
    torch.cuda.synchronize()
    assert _lib.counts()["flash_attention"] == before + 1
    assert fa.ROUTE_LAUNCHES[fa.kernel_route(dtype)] == r0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(
        got.float(), ref.flash_attention_ref(q, k, v, mode=mode,
                                             window=window).float(),
        **FLASH_TOL[dtype])


@pytest.mark.gpu
def test_flash_attention_d256_model_routes():
    """At the model level a head dim of 256 launches the kernel directly,
    one of 192 takes the padded route (to 256), and one above 256 is
    refused naming ROADMAP item 11i."""
    _card()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import flash_attention as model_flash
    g = torch.Generator(device="cuda").manual_seed(192)
    for D, route in ((256, "wgmma"), (192, "wgmma_padded")):
        q, k, v = (torch.randn((1, 150, 4, D), generator=g,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        r0 = fa.ROUTE_LAUNCHES[route]
        got = model_flash(q, k, v, mode="window", window=64)
        torch.cuda.synchronize()
        assert fa.ROUTE_LAUNCHES[route] == r0 + 1
        torch.testing.assert_close(
            got.float(), ref.flash_attention_ref(
                q, k, v, mode="window", window=64).float(),
            **FLASH_TOL[torch.bfloat16])
    q = torch.zeros((1, 16, 2, 320), device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        model_flash(q, q, q)


def _family_batch(cfg, seq, seed):
    """Tokens and, per family, the stub frontend's inputs, on the CPU."""
    from repro_torch.data.pipeline import synthetic_lm_batch
    batch = synthetic_lm_batch(seed, cfg.vocab_size, 2, seq)
    g = torch.Generator().manual_seed(seed)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, cfg.encdec.n_frames, cfg.d_model),
                                      generator=g)
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(
            (2, cfg.vlm.n_image_tokens, cfg.d_model), generator=g)
    return batch


@pytest.mark.gpu
@pytest.mark.parametrize("arch,n_attn", [
    ("mamba2_2_7b", 0), ("recurrentgemma_9b", 1), ("whisper_medium", 6),
    ("phi3_vision_4_2b", 2)])
def test_new_family_reduced_on_card_matches_cpu(arch, n_attn):
    """Reduced SSM, hybrid, audio and VLM configs (float32) on the card
    against the CPU from the same weights: prefill of 2 x 80 tokens (the
    hybrid's window of 64 binds, its ring wraps) and 3 greedy decode steps,
    the CPU fed the card's tokens, logits and every cache leaf in the
    golden band; prefill launches kernel 6 once an attention call, decode
    never; then ``train_loss``'s gradient, every leaf in the golden band,
    with no kernel launch (the attention's differentiable route)."""
    _card()
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import flatten, tree_map, value_and_grad
    cfg = get_config(arch).reduced()
    params = models.init_params(torch.Generator().manual_seed(4), cfg, "cpu")
    gparams = tree_map(lambda t: t.cuda(), params)
    batch = _family_batch(cfg, 80, 5)
    del batch["labels"]
    gbatch = {k: v.cuda() for k, v in batch.items()}
    _lib.reset_launches()
    glogits, gcache = models.prefill(gparams, cfg, gbatch, 83)
    torch.cuda.synchronize()
    assert _lib.counts() == ({"flash_attention": n_attn} if n_attn else {})
    logits, cache = models.prefill(params, cfg, batch, 83)
    torch.testing.assert_close(glogits.cpu(), logits, **BAND)
    for _ in range(3):
        token = glogits[:, :cfg.vocab_size].argmax(-1)[:, None]
        glogits, gcache = models.decode_step(gparams, cfg, token, gcache)
        logits, cache = models.decode_step(params, cfg, token.cpu(), cache)
        torch.testing.assert_close(glogits.cpu(), logits, **BAND)
    torch.cuda.synchronize()
    assert _lib.counts() == ({"flash_attention": n_attn} if n_attn else {})
    gl, gdef = flatten({k: v for k, v in gcache.items() if k != "index"})
    cl, cdef = flatten({k: v for k, v in cache.items() if k != "index"})
    assert gdef == cdef and len(gl) > 0
    for a, b in zip(gl, cl, strict=True):
        torch.testing.assert_close(a.cpu(), b, **BAND)

    tbatch = _family_batch(cfg, 24, 6)
    gtbatch = {k: v.cuda() for k, v in tbatch.items()}

    def loss_fn(p, bt):
        return models.train_loss(p, cfg, bt)
    gloss, _, ggrads = value_and_grad(loss_fn, gparams, gtbatch)
    torch.cuda.synchronize()
    assert _lib.counts() == ({"flash_attention": n_attn} if n_attn else {})
    loss, _, grads = value_and_grad(loss_fn, params, tbatch)
    torch.testing.assert_close(gloss.cpu(), loss, **BAND)
    for a, b in zip(flatten(ggrads)[0], flatten(grads)[0], strict=True):
        torch.testing.assert_close(a.cpu(), b, **BAND)


# =====================================================================
# kernel 6's whole argument list: softcap, q_offset, extra_qk
# =====================================================================
@pytest.mark.gpu
@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,mode,window,q_offset,softcap", [
    (150, 150, "causal", None, 0, 30.0),        # softcap alone
    (70, 331, "causal", None, 261, 0.0),        # queries at the end of kv
    (70, 331, "causal", None, 200, 0.0),        # not at the end either
    (70, 331, "window", 90, 261, 0.0),
    (130, 203, "full", None, 40, 25.0),         # full ignores the offset
    (100, 400, "window", 120, 250, 40.0),       # all three
])
def test_flash_attention_arguments_match_plain(D, dtype, Sq, Skv, mode,
                                               window, q_offset, softcap):
    """Kernel 6 with the reference scan's ``q_offset`` (query row i at key
    position i + q_offset, so the causal block skip and the window's
    first tile shift with it) and ``softcap`` (the capped instantiations
    of the bf16 kernel), at every head dim it instantiates: against the
    plain version at ``FLASH_TOL``, one launch a call."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(Sq * D + q_offset)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((2, Sq, 4, D), (2, Skv, 2, D), (2, Skv, 2, D)))
    kw = dict(mode=mode, window=window, q_offset=q_offset, softcap=softcap)
    before = _lib.counts().get("flash_attention", 0)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _lib.counts()["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(
        got.float(), ref.flash_attention_ref(q, k, v, **kw).float(),
        **FLASH_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,P2,Dv,mode,q_offset,softcap", [
    (64, 32, 64, "causal", 0, 0.0),     # minicpm3-4b's decomposed scores
    (64, 32, 64, "causal", 64, 30.0),
    (96, 32, 128, "full", 0, 0.0),      # 128 wide: the direct route
    (224, 32, 256, "causal", 0, 0.0),   # 256 wide
])
def test_flash_attention_extra_qk_matches_plain(dtype, D, P2, Dv, mode,
                                                q_offset, softcap):
    """``extra_qk`` on the card: the model-level ``flash_attention``
    concatenates ``[q | q2]`` and ``[k | k2]`` and launches kernel 6 once
    (padded when ``D + P2`` or ``Dv`` asks for it), at q's own scale;
    against the plain chunked math of the reference's scan."""
    _card()
    from repro_torch.models.attention import flash_attention as model_flash
    g = torch.Generator(device="cuda").manual_seed(D + P2 + q_offset)
    B, Sq, Skv, H = 2, 96, 160, 4
    q, k, v, q2, k2 = (
        torch.randn(shape, generator=g, device="cuda").to(dtype)
        for shape in ((B, Sq, H, D), (B, Skv, H, D), (B, Skv, H, Dv),
                      (B, Sq, H, P2), (B, Skv, P2)))
    kw = dict(mode=mode, q_offset=q_offset, softcap=softcap)
    before = _lib.counts().get("flash_attention", 0)
    with torch.no_grad():
        got = model_flash(q, k, v, extra_qk=(q2, k2), **kw)
    torch.cuda.synchronize()
    assert _lib.counts()["flash_attention"] == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (B, Sq, H, Dv)
    want = ref.chunked_attention_ref(q, k, v, extra_qk=(q2, k2), **kw)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


# =====================================================================
# the pod-axis FL round and the sharded server paths on a one-rank group
# =====================================================================
@pytest.fixture
def nccl_world(tmp_path):
    """A one-rank NCCL group on the card, and a gloo group beside it for
    CPU tensors."""
    _card()
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    gloo = dist.new_group(backend="gloo")
    yield gloo
    dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["q8", "chunked_ae"])
def test_sharded_decode_and_serve_match_unsharded(nccl_world, kind):
    """``decode_and_aggregate_sharded`` (cohorts 5 and 64: zero-weight
    padding is a no-op at one rank) and ``ServeConfig(shard=True)`` (three
    rounds) on a one-rank NCCL group against the unsharded calls on the
    card, in the golden band; the kernels launch as in the unsharded call
    (kernel 2 for q8; for the chunked AE the kernel-terminal route, kernel
    3's hidden stack then kernel 4)."""
    from repro_torch.core import codec, serve
    from repro_torch.core.autoencoder import (ChunkedAEConfig,
                                              init_chunked_ae)
    if kind == "q8":
        spec, p = codec.QuantizeSpec(size=1 << 16, bits=8, block=256), None
    else:
        cfg = ChunkedAEConfig(256, (32,), 8)
        spec = codec.ChunkedAESpec(size=1 << 16, cfg=cfg, use_kernel=True)
        p = init_chunked_ae(torch.Generator().manual_seed(0), cfg, "cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    for C in (5, 64):
        stacked = serve.synthetic_payloads(spec, p, C, g)
        w = torch.rand((C,), generator=g, device="cuda") + 0.1
        w = w / w.sum()
        want = codec.decode_and_aggregate(spec, p, stacked, w)
        before = _lib.counts()
        got = codec.decode_and_aggregate_sharded(spec, p, stacked, w)
        torch.cuda.synchronize()
        launched = {k: v - before.get(k, 0) for k, v in _lib.counts().items()
                    if v != before.get(k, 0)}
        for k in (("dequantize_blocks_2d",) if kind == "q8"
                  else ("fused_dense", "fused_decode_agg")):
            assert launched.get(k, 0) >= 1, launched
        torch.testing.assert_close(got, want, **BAND)
    kw = dict(n_clients=4096, buffer_k=64, spec=spec, jitter=0.4,
              straggler_frac=0.05)
    plain, _ = serve.run_serve(serve.ServeConfig(**kw), 3, p, warmup=0)
    shard, _ = serve.run_serve(serve.ServeConfig(shard=True, **kw), 3, p,
                               warmup=0)
    for key in ("times", "seqs", "versions"):
        assert torch.equal(plain[key], shard[key]), key
    torch.testing.assert_close(shard["global_flat"], plain["global_flat"],
                               **BAND)


@pytest.mark.gpu
def test_fl_round_card_matches_cpu(nccl_world):
    """One FL round of reduced stablelm-1.6b (float32) on the card over
    the NCCL group against the same round on the CPU over the gloo group,
    from the same params, AE and batch: loss, accuracy, optimizer moments
    and params in the golden band, the latent bytes equal."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import distributed as tdist
    from repro_torch.core.autoencoder import (ChunkedAEConfig,
                                              init_chunked_ae)
    from repro_torch.core.pytree import flatten, tree_map
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.models import init_params
    from repro_torch.optim.optimizers import make_optimizer
    cfg = get_config("stablelm-1.6b").reduced()
    ae_cfg = ChunkedAEConfig(128, (32,), 4)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    ae = init_chunked_ae(torch.Generator().manual_seed(1), ae_cfg, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in
             synthetic_lm_batch(0, cfg.vocab_size, 2, 64).items()}
    out = {}
    for dev, group in (("cuda", None), ("cpu", nccl_world)):
        bundle = tdist.build_fl_round_step(
            cfg, ShapeConfig("t", 64, 2, "train"), group, ae_cfg)
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        opt = make_optimizer(cfg.optimizer, cfg.learning_rate,
                             weight_decay=cfg.weight_decay,
                             grad_clip=cfg.grad_clip)
        o = opt.init(p)
        p, o, m = bundle.fn(p, o, tree_map(lambda t: t.to(dev), ae),
                            {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (p, o, m, bundle.stats["last_round"])
    (gp, go, gm, gl), (cp, co, cm, cl) = out["cuda"], out["cpu"]
    assert gl == cl
    for k in ("loss", "accuracy"):
        torch.testing.assert_close(gm[k].cpu(), cm[k], **BAND)
    for a, b in zip(flatten(go["v"])[0], flatten(co["v"])[0], strict=True):
        torch.testing.assert_close(a.cpu(), b, **BAND)
    for a, b in zip(flatten(gp)[0], flatten(cp)[0], strict=True):
        torch.testing.assert_close(a.cpu(), b, **BAND)


@pytest.mark.gpu
def test_cnn_gradient_on_card_is_float32():
    """The CIFAR CNN's loss gradient on the card in the golden band of the
    CPU's float64 gradient, at the first local step of client 1 in
    ``fl_color_imbalance --stacks`` (the initial params, the first batch
    of its Dirichlet shard): the card's convs are ``conv2d_valid_gemm``
    (float32 matrix products, one a kernel offset). Through cuDNN 9's float32
    convolutions ``conv1/w``'s gradient lay up to 1.6e-4 off float64 there,
    TF32 off or not, one value with the wrong sign at 2.1e-5."""
    _card()
    from repro_torch.configs.paper import CIFAR_CLASSIFIER
    from repro_torch.core.pytree import ravel, tree_map, value_and_grad
    from repro_torch.data.pipeline import (batches, cifar_like,
                                           dirichlet_partition,
                                           train_eval_split)
    from repro_torch.models.classifiers import (classifier_loss,
                                                init_classifier)
    params = init_classifier(torch.Generator().manual_seed(0),
                             CIFAR_CLASSIFIER, "cpu")
    train, _ = train_eval_split(cifar_like(0, 4 * 256), 128)
    shard = dirichlet_partition(0, train, 4, alpha=0.5, min_per_client=8)[1]
    batch = next(batches(0, shard, 64))

    def grad(dev, dtype):
        p = tree_map(lambda t: t.to(dev, dtype), params)
        b = {"x": batch["x"].to(dev, dtype), "y": batch["y"].to(dev)}
        g = value_and_grad(
            lambda p, b: classifier_loss(p, CIFAR_CLASSIFIER, b), p, b)[2]
        return ravel(g)[0].double().cpu()
    torch.testing.assert_close(grad("cuda", torch.float32),
                               grad("cpu", torch.float64), **BAND)


@pytest.mark.gpu
def test_conv_ae_gradient_on_card_is_float32():
    """The conv AE's loss gradient on the card in the golden band of the
    CPU's float64 gradient, at the paper appendix's configuration
    (``ConvAEConfig(channels=(8, 16), kernel=9, stride=8)``, rows of 15,936
    values: the MNIST classifier's 15,910 weights padded to a multiple of
    64, as ``benchmarks/tables.py:262-296`` pads them), 2 rows of unit scale
    drawn from a seed (the scale the normalizer gives the network; so few
    rows that the mean loss's largest gradients reach 0.05, where the
    band's rtol binds), the normalizer fitted on them."""
    _card()
    from repro_torch.core.autoencoder import (ConvAEConfig, ae_loss,
                                              fit_normalizer, init_conv_ae)
    from repro_torch.core.pytree import ravel, tree_map, value_and_grad
    cfg = ConvAEConfig(channels=(8, 16), kernel=9, stride=8,
                       latent_channels=1)
    rows = torch.from_numpy(
        np.random.RandomState(9).randn(2, 15_936).astype(np.float32))
    params = fit_normalizer(
        init_conv_ae(torch.Generator().manual_seed(1), cfg, "cpu"), rows)

    def grad(dev, dtype):
        p = tree_map(lambda t: t.to(dev, dtype), params)
        g = value_and_grad(
            lambda p, x: (ae_loss(p, cfg, x, "conv"), None), p,
            rows.to(dev, dtype))[2]
        return ravel(g)[0].double().cpu()
    torch.testing.assert_close(grad("cuda", torch.float32),
                               grad("cpu", torch.float64), **BAND)


# ======================================================================
# the example entry points (repro_torch.examples; chip_smoke.py run (ac))
# ======================================================================
AC_SMALL = ("quickstart", "batched_server_decode", "fl_serve",
            "fl_serve_q4_shard", "fl_async_sampling", "ae_lifecycle_refresh",
            "per_layer_partitions", "adaptive_rate_control",
            "fl_color_imbalance_reduced", "fl_color_imbalance_stacks",
            "llm_federated_reduced", "llm_serve_decode")


@pytest.mark.gpu
@pytest.mark.parametrize("label", AC_SMALL)
def test_example_on_card_matches_cpu(label):
    """Each example at its smallest arguments (the CPU parity tests'
    sizes; ``chip_smoke.ac_call(..., small=True)``; the §5.2 federation and
    the LM federation are their reduced twins) on the card: every
    kernel of run (ac)'s table launches (``chip_smoke.AC_KERNELS``); the
    CPU replays the card's record (``chip_smoke.ac_replay``: every Adam
    step, AE refit, client encode, quantizer input and serve draw, held and
    taken from the card), and every byte count, ratio, cohort, staleness,
    sync list, rung and outcome equals the card's, every round's floats in
    the golden band (``chip_smoke.ac_hold``); for ``chip_smoke.AC_FREE``,
    a free CPU run too, its floats in the band up to the first refit
    (``chip_smoke.ac_hold_free``); the LM server's logits in run (g)'s
    band with the CPU fed the card's tokens."""
    _card()
    cs = _chip_smoke()
    card, launches, _, _, record = cs.ac_card(label, small=True)
    if label == "llm_serve_decode":
        cs.ac_lm_serve_vs_cpu(card)
        return
    cpu, holds = cs.ac_replay(label, record, small=True)
    cs.ac_hold(label, card, cpu)
    if label in cs.AC_FREE:
        with contextlib.redirect_stdout(io.StringIO()):
            free = cs.ac_call(label, "cpu", small=True)
        cs.ac_hold_free(label, card, free)


AC_TRAINED = ("quickstart", "fl_async_sampling", "ae_lifecycle_refresh",
              "per_layer_partitions", "adaptive_rate_control",
              "fl_color_imbalance_reduced", "fl_color_imbalance_stacks",
              "llm_federated_reduced")


@pytest.mark.gpu
@pytest.mark.parametrize("label", AC_TRAINED)
def test_example_replay_refuses_tf32_on_card(label):
    """The replay catches a gradient taken at too low a precision: each
    example that trains, run on the card with TF32 matrix products and
    convolutions forced on, fails its CPU replay: at an Adam step's
    gradient hold (``chip_smoke.step_rule``), or, in the CNN examples,
    first at a ReLU the card decided apart from the CPU outside the band
    (``chip_smoke.DecisionSpy``)."""
    _card()
    cs = _chip_smoke()
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    mm.allow_tf32 = dnn.allow_tf32 = True
    try:
        _, _, _, _, record = cs.ac_card(label, small=True)
    finally:
        mm.allow_tf32 = dnn.allow_tf32 = False
    with pytest.raises(AssertionError, match="gradient|decision") as err:
        cs.ac_replay(label, record, small=True)
    print(f"{label}: {err.value}")


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["cnn_round", "lm_round", "serve_step"])
def test_only_trace_transfers_synchronize(path, monkeypatch):
    """A reduced CNN round (``SampledSync``, vmapped, composed chunked AE,
    EF), a reduced LM delta round (by-role codec) and two serve steps under
    ``torch.cuda.set_sync_debug_mode("error")``, with only
    ``repro_torch.trace.to_host`` / ``to_device`` let through: every wait
    of the host on the card goes through them, so their ``host_syncs``
    counter misses none. A serve step after the first makes none: any
    wait of the host in it raises."""
    _card()
    import test_torch_trace as tt
    from repro_torch import trace
    dev = torch.device("cuda")
    if path == "serve_step":
        step, state = tt.serve_step(dev)
        state = step(state)            # the first step reads next_seq back
        run_it = lambda: step(state)   # noqa: E731
    else:
        run = tt.cnn_run(dev) if path == "cnn_round" else tt.lm_run(dev)
        run.scheduler.run_round(0)     # warm: library, handles, allocator
        run_it = lambda: run.scheduler.run_round(1)  # noqa: E731
    torch.cuda.synchronize()
    calls = collections.Counter()

    def allowed(fn):
        def call(*a, **k):
            calls[fn.__name__] += 1
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return call
    monkeypatch.setattr(trace, "to_host", allowed(trace.to_host))
    monkeypatch.setattr(trace, "to_device", allowed(trace.to_device))
    torch.cuda.set_sync_debug_mode("error")
    try:
        run_it()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"{path}: {dict(calls)}")
    if path == "serve_step":
        assert calls == {}
    else:
        assert calls["to_host"] > 0 and calls["to_device"] > 0
