"""The port's k-means stage, entropy pricing and measured-bytes channel
against a live JAX run: ``KMeansSpec`` codes and codebooks (quantile
seeded and warm started, uint8 and int32 codes), k-means as a chain's
terminal stage behind the kernel-path chunked AE (the reference's Pallas
kernels in interpret mode), ``measured_bytes`` of entropy-coded chains,
``RoundRecord.bytes_up_measured`` of a run, and ``is_shape_static``.

Codes and bytes exact; codebooks and decoded vectors in the golden band
``atol=2e-5, rtol=2e-4``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as J  # noqa: E402
from repro.configs.paper import MNIST_CLASSIFIER as J_MLP  # noqa: E402
from repro.core import codec as jc  # noqa: E402
from repro.core.aggregate import normalize_weights  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.classifiers import init_classifier  # noqa: E402

from repro_torch import core as T  # noqa: E402
from repro_torch.configs.paper import MNIST_CLASSIFIER  # noqa: E402
from repro_torch.core import codec as tc  # noqa: E402
from repro_torch.core.pytree import from_jax_params  # noqa: E402
from repro_torch.core.task import ClassifierTask  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _vec(seed, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) * 1e-2 + rng.randn(1) * 1e-3).astype(np.float32)


@pytest.mark.parametrize("n,k,iters,seed", [(3000, 16, 8, 0),
                                            (12_345, 16, 8, 1),
                                            (999, 7, 3, 2),
                                            (4000, 300, 4, 3)])
def test_kmeans_codes_and_codebook_match_reference(n, k, iters, seed):
    x = _vec(seed, n)
    pj = jc.encode(jc.KMeansSpec(n, k, iters), None, jnp.asarray(x))
    pt = tc.encode(tc.KMeansSpec(n, k, iters), None, torch.from_numpy(x))
    assert pt["codes"].dtype == (torch.uint8 if k <= 256 else torch.int32)
    assert str(pt["codes"].numpy().dtype) == str(pj["codes"].dtype)
    np.testing.assert_allclose(pt["codebook"].numpy(),
                               np.asarray(pj["codebook"]), **BAND)
    np.testing.assert_array_equal(pt["codes"].numpy(),
                                  np.asarray(pj["codes"]))
    spec = tc.KMeansSpec(n, k, iters)
    assert tc.wire_bytes(spec) == jc.wire_bytes(jc.KMeansSpec(n, k, iters))
    np.testing.assert_allclose(
        tc.decode(spec, None, pt).numpy(),
        np.asarray(jc.decode(jc.KMeansSpec(n, k, iters), None, pj)), **BAND)


def test_kmeans_quantile_seed_matches_jnp_quantile():
    """The seeding quantiles alone (0 Lloyd steps): ``jnp.quantile``'s
    linear interpolation through a sort, at sizes where the positions
    fall between elements."""
    for n, k in ((10, 4), (1001, 16), (70_000, 32)):
        x = _vec(n, n)
        probs = (np.arange(k, dtype=np.float32) + 0.5) / k
        want = np.asarray(jnp.quantile(jnp.asarray(x), jnp.asarray(probs)))
        got = tc._quantile_linear(torch.from_numpy(x),
                                  torch.from_numpy(probs)).numpy()
        np.testing.assert_allclose(got, want, **BAND)


def test_kmeans_warm_start_matches_reference():
    n, k = 5000, 16
    x = _vec(4, n)
    cb = np.linspace(-0.02, 0.02, k).astype(np.float32)
    comp_j = J.KMeansCompressor(k=k, iters=2, params={"codebook":
                                                      jnp.asarray(cb)})
    comp_t = T.KMeansCompressor(k=k, iters=2, params={"codebook":
                                                      torch.from_numpy(cb)})
    pj = jc.encode(comp_j.spec(n), comp_j.codec_params(), jnp.asarray(x))
    pt = tc.encode(comp_t.spec(n), comp_t.codec_params(), torch.from_numpy(x))
    np.testing.assert_array_equal(pt["codes"].numpy(),
                                  np.asarray(pj["codes"]))
    np.testing.assert_allclose(pt["codebook"].numpy(),
                               np.asarray(pj["codebook"]), **BAND)
    # a warm start is not the quantile seed
    cold = tc.encode(tc.KMeansSpec(n, k, 2), None, torch.from_numpy(x))
    assert not torch.equal(cold["codebook"], pt["codebook"])
    comp_t.set_codec_params({"codebook": pt["codebook"]})
    assert comp_t.codec_params()["codebook"] is pt["codebook"]


def test_kmeans_after_kernel_path_chunked_ae_aggregates_like_reference():
    """A chain whose AE latents are k-means coded takes the kernel-terminal
    route in both packages."""
    ccfg = dict(chunk_size=256, hidden=(32,), latent_chunk=8)
    n, C = 3000, 3
    pj = J.init_chunked_ae(jax.random.PRNGKey(1), J.ChunkedAEConfig(**ccfg))
    pt = from_jax_params(_np(pj), "cpu")
    nl = 12 * 8
    sj = jc.ChainSpec((jc.ChunkedAESpec(n, J.ChunkedAEConfig(**ccfg), True),
                       jc.KMeansSpec(nl, 16, 4)))
    st = tc.ChainSpec((tc.ChunkedAESpec(n, T.ChunkedAEConfig(**ccfg), True),
                       tc.KMeansSpec(nl, 16, 4)))
    assert tc.kernel_terminal_ae(st) is st.stages[0]
    xs = [np.random.RandomState(10 + c).randn(n).astype(np.float32)
          for c in range(C)]
    plj = [jc.encode(sj, (pj, None), jnp.asarray(x)) for x in xs]
    plt = [tc.encode(st, (pt, None), torch.from_numpy(x)) for x in xs]
    for a, b in zip(plj, plt):
        np.testing.assert_array_equal(b["s1"]["codes"].numpy(),
                                      np.asarray(a["s1"]["codes"]))
    w = normalize_weights([1.0, 2.0, 3.0])
    mj = jc.decode_and_aggregate(sj, (pj, None), jc.stack_payloads(plj),
                                 jnp.asarray(w, jnp.float32))
    mt = tc.decode_and_aggregate(st, (pt, None), tc.stack_payloads(plt),
                                 torch.tensor(w))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), **BAND)


def _entropy_pairs():
    return {
        "topk-kmeans": (
            J.ChainCompressor([J.TopKCompressor(0.1), J.KMeansCompressor()],
                              entropy_coded=True),
            T.ChainCompressor([T.TopKCompressor(0.1), T.KMeansCompressor()],
                              entropy_coded=True)),
        "q8": (J.ChainCompressor([J.QuantizeCompressor(bits=8)],
                                 entropy_coded=True, table_bytes_per_symbol=2),
               T.ChainCompressor([T.QuantizeCompressor(bits=8)],
                                 entropy_coded=True, table_bytes_per_symbol=2)),
        "q4": (J.ChainCompressor([J.QuantizeCompressor(bits=4, block=64)],
                                 entropy_coded=True),
               T.ChainCompressor([T.QuantizeCompressor(bits=4, block=64)],
                                 entropy_coded=True)),
    }


@pytest.mark.parametrize("name", ["topk-kmeans", "q8", "q4"])
def test_measured_bytes_of_entropy_chains_equal_reference(name):
    cj, ct = _entropy_pairs()[name]
    n = 15_910
    x = _vec(5, n)
    sj, st = cj.spec(n), ct.spec(n)
    assert isinstance(st.stages[-1], tc.EntropySpec)
    assert not tc.is_shape_static(st)
    pj = jc.encode(sj, cj.codec_params(), jnp.asarray(x))
    pt = tc.encode(st, ct.codec_params(), torch.from_numpy(x))
    for a, b in zip(jax.tree_util.tree_leaves(pj), T.pytree.leaves(pt)):
        if not np.issubdtype(np.asarray(a).dtype, np.floating):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    mt = tc.measured_bytes(st, pt)
    assert mt == jc.measured_bytes(sj, pj)
    assert mt < tc.wire_bytes(st) == jc.wire_bytes(sj)
    stats = T.compressor.codec_stats(torch.from_numpy(x), pt, spec=st)
    assert stats["measured_bytes"] == mt
    assert stats["compressed_bytes"] == float(tc.wire_bytes(st))


class _JaxInitTask(ClassifierTask):
    def __init__(self, clf_cfg, params_np):
        super().__init__(clf_cfg)
        self.params_np = params_np

    def init_params(self, gen, device):
        return from_jax_params(self.params_np, device)


def test_bytes_up_measured_of_a_run_equals_reference():
    """Three MLP clients on an entropy-coded q8 chain for two rounds: the
    measured uplink below the dense one, equal to the reference's."""
    def data(pkg):
        train, ev = pkg.train_eval_split(pkg.mnist_like(0, 256), 64)
        return pkg.uniform_partition(0, train, 3), ev
    cfg = dict(n_rounds=2, local_epochs=1, payload="update",
               error_feedback=True)
    dj, evj = data(jpipe)
    dt, evt = data(tpipe)
    p0 = _np(init_classifier(jax.random.PRNGKey(0), J_MLP))
    run_j = J.FederatedRun(J_MLP, dj, J.FLConfig(**cfg), eval_data=evj,
                           compressors=[_entropy_pairs()["q8"][0]
                                        for _ in range(3)])
    run_t = T.FederatedRun(_JaxInitTask(MNIST_CLASSIFIER, p0), dt,
                           T.FLConfig(**cfg), eval_data=evt, device="cpu",
                           compressors=[_entropy_pairs()["q8"][1]
                                        for _ in range(3)])
    for a, b in zip(run_j.run(), run_t.run(), strict=True):
        assert b.bytes_up == a.bytes_up
        assert b.bytes_up_measured == a.bytes_up_measured < a.bytes_up


def test_is_shape_static_matches_reference():
    n = 4000
    tmpl = init_classifier(jax.random.PRNGKey(0), J_MLP)
    pmj = J.by_layer_partition(tmpl)
    pmt = T.by_layer_partition(from_jax_params(_np(tmpl), "cpu"))
    cases = [
        (jc.QuantizeSpec(n), tc.QuantizeSpec(n)),
        (jc.KMeansSpec(n), tc.KMeansSpec(n)),
        (jc.ChainSpec((jc.TopKSpec(n, 40), jc.KMeansSpec(40))),
         tc.ChainSpec((tc.TopKSpec(n, 40), tc.KMeansSpec(40)))),
        (jc.ChainSpec((jc.TopKSpec(n, 40), jc.KMeansSpec(40),
                       jc.EntropySpec())),
         tc.ChainSpec((tc.TopKSpec(n, 40), tc.KMeansSpec(40),
                       tc.EntropySpec()))),
        (J.PartitionedCompressor(pmj, {
            "dense0": J.QuantizeCompressor(),
            "dense1": J.ChainCompressor([J.QuantizeCompressor()],
                                        entropy_coded=True)}).spec(15_910),
         T.PartitionedCompressor(pmt, {
             "dense0": T.QuantizeCompressor(),
             "dense1": T.ChainCompressor([T.QuantizeCompressor()],
                                         entropy_coded=True)}).spec(15_910)),
    ]
    for sj, st in cases:
        assert tc.is_shape_static(st) == jc.is_shape_static(sj)
    assert [tc.is_shape_static(st) for _, st in cases] == \
        [True, True, True, False, False]
    with pytest.raises(ValueError, match="cannot lead"):
        tc.ChainSpec((tc.EntropySpec(), tc.QuantizeSpec(n)))
    with pytest.raises(ValueError, match="last stage"):
        tc.ChainSpec((tc.TopKSpec(n, 40), tc.EntropySpec(),
                      tc.KMeansSpec(40)))
