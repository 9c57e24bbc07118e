"""The port's TopK stage, codec chains and ``ComposedSpec`` against a live
JAX run: payloads, ``wire_bytes``, ``decode`` and the three
``decode_and_aggregate`` routes they take — the scatter route (top-k
prefix), the kernel-terminal route (kernel-path chunked AE behind an
identity prefix or ahead of a quantize suffix; the reference's Pallas
kernels in interpret mode, the port's plain versions on CPU tensors) and
the generic batched route.

Bytes and top-k indices exact; floats in the golden band
``atol=2e-5, rtol=2e-4``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper import AEConfig as JAEConfig  # noqa: E402
from repro.core import autoencoder as jae  # noqa: E402
from repro.core import codec as jc  # noqa: E402
from repro.core.aggregate import normalize_weights  # noqa: E402

from repro_torch.configs.paper import AEConfig as TAEConfig  # noqa: E402
from repro_torch.core import autoencoder as tae  # noqa: E402
from repro_torch.core import codec as tc  # noqa: E402
from repro_torch.core import compressor as tcomp  # noqa: E402
from repro_torch.core.compressor import tree_bytes  # noqa: E402
from repro_torch.core.pytree import from_jax_params, leaves  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)
N = 3000


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _tied(seed: int, n: int = N) -> np.ndarray:
    """A vector whose magnitudes repeat: zeros, ± pairs of one magnitude
    and a block of equal values straddling the top-k cut."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * 0.1).astype(np.float32)
    x[: n // 10] = 0.0
    x[n // 4: n // 4 + 40] = 0.25
    x[n // 2: n // 2 + 40] = -0.25
    x[rng.choice(n, 30, replace=False)] = 0.5
    return x


@pytest.mark.parametrize("seed,k", [(0, 30), (1, 45), (2, 70), (3, 100)])
def test_topk_payload_equals_reference_with_ties(seed, k):
    x = _tied(seed)
    pj = jc.encode(jc.TopKSpec(N, k), None, jnp.asarray(x))
    pt = tc.encode(tc.TopKSpec(N, k), None, torch.from_numpy(x))
    assert pt["indices"].dtype == torch.int32
    np.testing.assert_array_equal(pt["indices"].numpy(),
                                  np.asarray(pj["indices"]))
    np.testing.assert_array_equal(pt["values"].numpy(),
                                  np.asarray(pj["values"]))
    np.testing.assert_array_equal(
        tc.decode(tc.TopKSpec(N, k), None, pt).numpy(),
        np.asarray(jc.decode(jc.TopKSpec(N, k), None, pj)))


# ------------------------------------------------------------- chains
J_CH = jae.ChunkedAEConfig(chunk_size=256, hidden=(32,), latent_chunk=8)
T_CH = tae.ChunkedAEConfig(chunk_size=256, hidden=(32,), latent_chunk=8)
J_FC = JAEConfig(input_dim=N, encoder_hidden=(16,), latent_dim=8)
T_FC = TAEConfig(input_dim=N, encoder_hidden=(16,), latent_dim=8)


def _spec_pair(kind: str):
    """(reference spec, port spec, reference params, port params, route)."""
    ch = jae.init_chunked_ae(jax.random.PRNGKey(5), J_CH)
    fc = jae.init_fc_ae(jax.random.PRNGKey(6), J_FC)
    chp, fcp = from_jax_params(_np(ch), "cpu"), from_jax_params(_np(fc),
                                                                  "cpu")

    def chunked(pkg, size, kernel=True):
        cfg = J_CH if pkg is jc else T_CH
        return pkg.ChunkedAESpec(size, cfg, use_kernel=kernel)

    def both(build):
        return build(jc), build(tc)

    if kind == "topk_q8":
        sj, st = both(lambda m: m.ChainSpec((m.TopKSpec(N, 300),
                                             m.QuantizeSpec(300))))
        return sj, st, None, None, "scatter"
    if kind == "topk_chunked_q8":
        sj, st = both(lambda m: m.ChainSpec((
            m.TopKSpec(N, 1024), chunked(m, 1024),
            m.QuantizeSpec(32, block=64))))
        return sj, st, (None, ch, None), (None, chp, None), "scatter"
    if kind == "identity_chunked_q8":
        sj, st = both(lambda m: m.ChainSpec((
            m.IdentitySpec(N), chunked(m, N), m.QuantizeSpec(96, block=64))))
        return sj, st, (None, ch, None), (None, chp, None), "kernel"
    if kind == "composed_chunked":
        sj, st = both(lambda m: m.ComposedSpec(chunked(m, N)))
        return sj, st, ch, chp, "kernel"
    if kind == "composed_chunked_plain":
        sj, st = both(lambda m: m.ComposedSpec(chunked(m, N, kernel=False),
                                               bits=4))
        return sj, st, ch, chp, "generic"
    if kind == "composed_fc":
        sj, st = both(lambda m: m.ComposedSpec(
            m.FCAESpec(N, J_FC if m is jc else T_FC)))
        return sj, st, fc, fcp, "generic"
    raise ValueError(kind)


KINDS = ["topk_q8", "topk_chunked_q8", "identity_chunked_q8",
         "composed_chunked", "composed_chunked_plain", "composed_fc"]


@pytest.mark.parametrize("kind", KINDS)
def test_chain_encode_decode_aggregate_matches_reference(kind):
    sj, st, pj, pt, route = _spec_pair(kind)
    # the route decode_and_aggregate takes: a ComposedSpec as its chain
    canon = (tc.composed_chain(st) if isinstance(st, tc.ComposedSpec)
             else st)
    assert (tc.kernel_terminal_ae(canon) is not None) == (route == "kernel")
    rng = np.random.RandomState(9)
    xs = [(rng.randn(N) * 0.05).astype(np.float32) for _ in range(3)]
    enc_j = [jc.encode(sj, pj, jnp.asarray(x)) for x in xs]
    enc_t = [tc.encode(st, pt, torch.from_numpy(x)) for x in xs]
    wire = tc.wire_bytes(st, pt)
    assert wire == jc.wire_bytes(sj, pj) == tree_bytes(enc_t[0])
    for a, b in zip(enc_j, enc_t):
        fa, ta = jax.tree_util.tree_flatten(a)
        assert [tuple(x.shape) for x in fa] == [tuple(y.shape)
                                               for y in leaves(b)]
        for x, y in zip(fa, leaves(b)):
            assert str(y.dtype).split(".")[-1] == str(x.dtype)
        if kind.startswith("topk"):
            np.testing.assert_array_equal(b["s0"]["indices"].numpy(),
                                          np.asarray(a["s0"]["indices"]))
        np.testing.assert_allclose(tc.decode(st, pt, b).numpy(),
                                   np.asarray(jc.decode(sj, pj, a)), **BAND)
    w = normalize_weights([64.0, 32.0, 100.0])
    base = rng.randn(N).astype(np.float32) * 0.01
    mj = jc.decode_and_aggregate(sj, pj, jc.stack_payloads(enc_j),
                                 jnp.asarray(w, jnp.float32),
                                 jnp.asarray(base))
    mt = tc.decode_and_aggregate(st, pt, tc.stack_payloads(enc_t),
                                 torch.tensor(w, dtype=torch.float32),
                                 torch.from_numpy(base))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), **BAND)
    # the route's result equals the generic batched decode + einsum
    rows = tc.decode_batched(st, pt, tc.stack_payloads(enc_t))
    generic = torch.einsum("c,cp->p", torch.tensor(w), rows) - \
        torch.from_numpy(base)
    np.testing.assert_allclose(mt.numpy(), generic.numpy(), **BAND)


def test_compressors_build_the_reference_specs():
    from repro.core import compressor as jcomp
    ch = jae.init_chunked_ae(jax.random.PRNGKey(5), J_CH)
    chp = from_jax_params(_np(ch), "cpu")
    pairs = [
        (jcomp.TopKCompressor(0.02), tcomp.TopKCompressor(0.02)),
        (jcomp.ChainCompressor([jcomp.TopKCompressor(0.5),
                                jcomp.ChunkedAECompressor(ch, J_CH, True),
                                jcomp.QuantizeCompressor(8, 64)]),
         tcomp.ChainCompressor([tcomp.TopKCompressor(0.5),
                                tcomp.ChunkedAECompressor(chp, T_CH, True),
                                tcomp.QuantizeCompressor(8, 64)])),
        (jcomp.ComposedCompressor(jcomp.ChunkedAECompressor(ch, J_CH, True),
                                  bits=4, block=32),
         tcomp.ComposedCompressor(tcomp.ChunkedAECompressor(chp, T_CH, True),
                                  bits=4, block=32)),
    ]
    for cj, ct in pairs:
        sj, st = cj.spec(N), ct.spec(N)
        assert tc.wire_bytes(st, ct.codec_params()) == \
            jc.wire_bytes(sj, cj.codec_params())
        x = np.random.RandomState(2).randn(N).astype(np.float32) * 0.05
        tree_t = {"w": torch.from_numpy(x)}
        dec_t, stats_t = ct.roundtrip(tree_t)
        dec_j, stats_j = cj.roundtrip({"w": jnp.asarray(x)})
        assert stats_t["compressed_bytes"] == stats_j["compressed_bytes"]
        np.testing.assert_allclose(dec_t["w"].numpy(),
                                   np.asarray(dec_j["w"]), **BAND)
    chain = pairs[1][1]
    assert chain.ae_compressor() is chain.inner[1]
    assert chain.codec_params() is chain.codec_params()      # cached


def test_chain_validation():
    with pytest.raises(ValueError, match="terminal-only"):
        tc.ChainSpec((tc.QuantizeSpec(N), tc.IdentitySpec(N)))
    with pytest.raises(ValueError, match="size mismatch"):
        tc.ChainSpec((tc.TopKSpec(N, 10), tc.QuantizeSpec(11)))
    with pytest.raises(TypeError, match="atomic"):
        tc.ChainSpec((tc.ChainSpec((tc.IdentitySpec(N),)),))
    with pytest.raises(ValueError, match="terminal-only"):
        tc.ChainSpec((tc.KMeansSpec(N), tc.IdentitySpec(N)))
    with pytest.raises(TypeError, match="unknown codec stage"):
        tc.ChainSpec((tc.IdentitySpec(N), jc.KMeansSpec(N)))
    with pytest.raises(ValueError, match="autoencoder"):
        tc.wire_bytes(tc.ComposedSpec(tc.ChunkedAESpec(N, T_CH)))


def test_runtime_runs_wire_bytes_equal_reference():
    """The uplink price of chip_smoke.py's runs (i) and (j): the composed
    chunked AE over the CIFAR CNN's 550,586 values (135 chunks of 4,096 →
    1,080 latents → q8 at block 64) and TopK 1 % → q8 over the MLP."""
    from repro.core import compressor as jcomp
    jcfg, tcfg = jae.ChunkedAEConfig(), tae.ChunkedAEConfig()
    ch = jae.init_chunked_ae(jax.random.PRNGKey(0), jcfg)
    chp = from_jax_params(_np(ch), "cpu")
    cj = jcomp.ComposedCompressor(jcomp.ChunkedAECompressor(ch, jcfg, True))
    ct = tcomp.ComposedCompressor(tcomp.ChunkedAECompressor(chp, tcfg, True))
    wire = tc.wire_bytes(ct.spec(550_586), ct.codec_params())
    assert wire == jc.wire_bytes(cj.spec(550_586), cj.codec_params())
    assert wire == 17 * 64 + 17 * 4
    cj = jcomp.ChainCompressor([jcomp.TopKCompressor(0.01),
                                jcomp.QuantizeCompressor(bits=8)])
    ct = tcomp.ChainCompressor([tcomp.TopKCompressor(0.01),
                                tcomp.QuantizeCompressor(bits=8)])
    assert tc.wire_bytes(ct.spec(15_910)) == jc.wire_bytes(cj.spec(15_910)) \
        == 159 * 4 + 256 + 4
