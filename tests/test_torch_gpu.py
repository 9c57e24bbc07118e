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
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _lib, ref  # noqa: E402
from repro_torch.kernels.fused_decode_agg import (  # noqa: E402
    fused_decode_agg, grouped_fused_decode_agg)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention)
from repro_torch.kernels.fused_dense import (fused_dense,  # noqa: E402
                                             kernel_route)
from repro_torch.kernels.quantize import (dequantize_blocks_2d,  # noqa: E402
                                          quantize_blocks_2d)

SHAPES = [(8, 16, 8), (100, 64, 32), (128, 128, 128), (257, 300, 65),
          (1, 4096, 8)]
BAND = dict(atol=2e-5, rtol=2e-4)    # tests/test_golden_trajectory.py


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
    """The split-K route (M <= 16) at the client's encode and decode shapes,
    with a ragged N (scalar loads) and the M = 16 / 17 boundary, where the
    tiled route takes over: every activation against the plain version at
    the tiled route's tolerances, one launch a call, and the same bits
    from run to run (partials summed in slab order, no atomics)."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
    w = (torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
         ).to(dtype)
    b = torch.randn((N,), generator=g, device="cuda").to(dtype)
    tol = (dict(atol=1e-5, rtol=1e-4) if dtype == torch.float32
           else dict(atol=5e-2, rtol=1e-2))
    assert kernel_route(M) == ("splitk" if M <= 16 else "tiled")
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
    q = torch.zeros((1, 16, 4, 64), device="cuda")
    with pytest.raises(NotImplementedError, match="softcap"):
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
