"""The port's modules against the JAX package's, one step at a time, on the
same numpy-seeded inputs and the JAX package's own initial parameters
(carried across with ``from_jax_params``): flatten order, classifier,
Adam, the AE trainer's step, every ported codec spec, the aggregation
helpers and the savings analytics.

Bytes are compared integer-exact; floats at ``atol=2e-5, rtol=2e-4``
(the golden band of tests/test_golden_trajectory.py) unless a comment
states a wider one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.configs.paper import AEConfig as JAEConfig  # noqa: E402
from repro.configs.paper import MNIST_AE as J_MNIST_AE  # noqa: E402
from repro.configs.paper import MNIST_CLASSIFIER as J_MLP  # noqa: E402
from repro.core import aggregate as jagg  # noqa: E402
from repro.core import autoencoder as jae  # noqa: E402
from repro.core import codec as jcodec  # noqa: E402
from repro.core import savings as jsavings  # noqa: E402
from repro.models.classifiers import classifier_loss as j_loss  # noqa: E402
from repro.models.classifiers import init_classifier as j_init  # noqa: E402
from repro.optim.optimizers import make_optimizer as j_make_opt  # noqa: E402

from repro_torch.configs.paper import AEConfig, MNIST_AE, MNIST_CLASSIFIER  # noqa: E402
from repro_torch.core import aggregate as tagg  # noqa: E402
from repro_torch.core import autoencoder as tae  # noqa: E402
from repro_torch.core import codec as tcodec  # noqa: E402
from repro_torch.core import compressor as tcomp  # noqa: E402
from repro_torch.core import savings as tsavings  # noqa: E402
from repro_torch.core.pytree import (from_jax_params, ravel,  # noqa: E402
                                     value_and_grad)
from repro_torch.models.classifiers import classifier_loss  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()),
                               np.asarray(want), **(tol or BAND))


def _batch(n=32, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 784).astype(np.float32)
    y = rng.randint(0, 10, size=n)
    return ({"x": jnp.asarray(x), "y": jnp.asarray(y, jnp.int32)},
            {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})


# ------------------------------------------------------------- flat order
def test_flatten_order_matches_ravel_pytree():
    pj = j_init(jax.random.PRNGKey(0), J_MLP)
    aej = jae.init_fc_ae(jax.random.PRNGKey(1),
                         JAEConfig(input_dim=40, encoder_hidden=(8,),
                                   latent_dim=4))
    for tree in (pj, aej):
        flat_j, _ = ravel_pytree(tree)
        pt = from_jax_params(_np(tree), "cpu")
        flat_t, unravel = ravel(pt)
        np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
        back = unravel(flat_t * 2)
        np.testing.assert_array_equal(ravel(back)[0].numpy(),
                                      2 * np.asarray(flat_j))
    # dense0.b precedes dense0.w; AE params run dec, enc, norm
    flat_t, _ = ravel(from_jax_params(_np(pj), "cpu"))
    np.testing.assert_array_equal(flat_t[:20].numpy(),
                                  np.asarray(pj["dense0"]["b"]))


# ------------------------------------------------ classifier and Adam
def test_classifier_loss_and_adam_step_match_jax():
    pj = j_init(jax.random.PRNGKey(3), J_MLP)
    pt = from_jax_params(_np(pj), "cpu")
    bj, bt = _batch()
    (lj, mj), gj = jax.value_and_grad(
        lambda p: j_loss(p, J_MLP, bj), has_aux=True)(pj)
    lt, mt, gt = value_and_grad(
        lambda p: classifier_loss(p, MNIST_CLASSIFIER, bt), pt)
    _close(lt, lj)
    _close(mt["accuracy"], mj["accuracy"])
    _close(ravel(gt)[0], ravel_pytree(gj)[0], atol=1e-6, rtol=1e-4)
    # three Adam steps on the same gradients: state and params
    oj, ot = j_make_opt("adam", 1e-3), make_optimizer("adam", 1e-3)
    sj, st = oj.init(pj), ot.init(pt)
    for _ in range(3):
        pj, sj = oj.update(pj, gj, sj)
        pt, st = ot.update(pt, gt, st)
    assert st["count"] == int(sj["count"]) == 3
    # golden band: Adam divides by sqrt(v), so a near-zero gradient whose
    # float32 sums differ in the last bits moves by up to ~lr·1e-3
    _close(ravel(pt)[0], ravel_pytree(pj)[0])
    _close(ravel(st["v"])[0], ravel_pytree(sj["v"])[0], atol=1e-9,
           rtol=1e-4)


# --------------------------------------------------------- AE trainer
def test_ae_loss_grad_and_adam_step_match_jax():
    cfg_j = JAEConfig(input_dim=96, encoder_hidden=(16,), latent_dim=4)
    cfg_t = AEConfig(input_dim=96, encoder_hidden=(16,), latent_dim=4)
    rng = np.random.RandomState(5)
    data = (rng.randn(9, 96) * 0.1).astype(np.float32)
    pj = jae.fit_normalizer(jae.init_fc_ae(jax.random.PRNGKey(4), cfg_j),
                            jnp.asarray(data))
    pt = tae.fit_normalizer(from_jax_params(
        _np(jae.init_fc_ae(jax.random.PRNGKey(4), cfg_j)), "cpu"),
        torch.from_numpy(data))
    _close(pt["norm"]["std"], pj["norm"]["std"], atol=0, rtol=1e-6)
    xb = data[:8]
    wb = np.array([1] * 5 + [0] * 3, np.float32)       # padded tail rows
    lj, gj = jax.value_and_grad(jae._masked_ae_loss)(
        pj, cfg_j, jnp.asarray(xb), jnp.asarray(wb), "fc")
    gj = dict(gj, norm=jax.tree_util.tree_map(jnp.zeros_like, gj["norm"]))
    zeros_j = jax.tree_util.tree_map(jnp.zeros_like, pj)
    pj1, _, _ = jae._adam_update(pj, gj, zeros_j, zeros_j, 1, 3e-3)
    zeros_t = {"enc": [dict((k, torch.zeros_like(v)) for k, v in l.items())
                       for l in pt["enc"]],
               "dec": [dict((k, torch.zeros_like(v)) for k, v in l.items())
                       for l in pt["dec"]],
               "norm": {k: torch.zeros_like(v)
                        for k, v in pt["norm"].items()}}
    pt1, _, _, lt = tae.ae_step(pt, cfg_t, torch.from_numpy(xb),
                                torch.from_numpy(wb), zeros_t, zeros_t, 1,
                                3e-3)
    _close(lt, lj)
    _close(ravel(pt1)[0], ravel_pytree(pj1)[0], atol=1e-6, rtol=1e-5)
    # the masked loss equals the plain loss over the unmasked rows
    _close(tae.ae_loss(pt, cfg_t, torch.from_numpy(xb[:5])), lj)


def test_train_autoencoder_descends():
    """The whole fit cannot replay ``jax.random`` shuffles; it must descend
    and keep the reference's history layout (trailing batch included)."""
    cfg = AEConfig(input_dim=64, encoder_hidden=(16,), latent_dim=4)
    rng = np.random.RandomState(0)
    base = rng.randn(1, 64).astype(np.float32)
    data = torch.from_numpy(base + 0.1 * rng.randn(11, 64)
                            .astype(np.float32))
    params, hist = tae.train_autoencoder(torch.Generator().manual_seed(0),
                                         cfg, data, epochs=30)
    assert set(hist) == {"loss", "accuracy", "val_loss", "val_accuracy"}
    assert len(hist["loss"]) == len(hist["val_loss"]) == 30
    assert hist["loss"][-1] < 0.5 * hist["loss"][0]
    assert float(params["norm"]["std"]) > 0


def test_decoder_accounting_matches_jax():
    pj = jae.init_fc_ae(jax.random.PRNGKey(0), J_MNIST_AE)
    pt = from_jax_params(_np(pj), "cpu")
    assert tae.decoder_sync_bytes(pt) == jae.decoder_sync_bytes(pj)
    assert tae.decoder_param_count(pt) == jae.decoder_param_count(pj)
    assert tae.ae_param_count(pt) == jae.ae_param_count(pj)
    assert MNIST_AE.n_params == J_MNIST_AE.n_params


# ---------------------------------------------------------------- codecs
def _spec_pairs():
    """(name, jax spec, port spec, jax params, port params) per ported
    spec, at small sizes."""
    n = 1000
    ae_j = JAEConfig(input_dim=1024, encoder_hidden=(32,), latent_dim=8)
    ae_t = AEConfig(input_dim=1024, encoder_hidden=(32,), latent_dim=8)
    fc_j = jae.init_fc_ae(jax.random.PRNGKey(1), ae_j)
    ch_jcfg = jae.ChunkedAEConfig(chunk_size=128, hidden=(16,),
                                  latent_chunk=4)
    ch_tcfg = tae.ChunkedAEConfig(chunk_size=128, hidden=(16,),
                                  latent_chunk=4)
    ch_j = jae.init_chunked_ae(jax.random.PRNGKey(2), ch_jcfg)
    out = {
        "identity": (jcodec.IdentitySpec(n), tcodec.IdentitySpec(n),
                     None, None),
        "q8": (jcodec.QuantizeSpec(n, 8), tcodec.QuantizeSpec(n, 8),
               None, None),
        "q4": (jcodec.QuantizeSpec(n, 4), tcodec.QuantizeSpec(n, 4),
               None, None),
        "fcae": (jcodec.FCAESpec(n, ae_j), tcodec.FCAESpec(n, ae_t),
                 fc_j, from_jax_params(_np(fc_j), "cpu")),
    }
    for uk in (False, True):
        out[f"chunked_kernel{int(uk)}"] = (
            jcodec.ChunkedAESpec(n, ch_jcfg, use_kernel=uk),
            tcodec.ChunkedAESpec(n, ch_tcfg, use_kernel=uk),
            ch_j, from_jax_params(_np(ch_j), "cpu"))
    return out


SPECS = ["identity", "q8", "q4", "fcae", "chunked_kernel0",
         "chunked_kernel1"]


@pytest.mark.parametrize("name", SPECS)
def test_codec_encode_decode_bytes_match_jax(name):
    sj, st, pj, pt = _spec_pairs()[name]
    flat = (np.random.RandomState(0).randn(st.size) * 0.05).astype(np.float32)
    plj = jcodec.encode(sj, pj, jnp.asarray(flat))
    plt = tcodec.encode(st, pt, torch.from_numpy(flat))
    assert sorted(plt) == sorted(plj)
    for k in plj:
        assert plt[k].shape == plj[k].shape
        assert plt[k].element_size() == plj[k].dtype.itemsize
        if plt[k].dtype in (torch.int8, torch.uint8):
            np.testing.assert_array_equal(plt[k].numpy(), np.asarray(plj[k]))
        else:
            # scales: one ulp apart where XLA multiplies by 1/qmax
            _close(plt[k], plj[k], atol=1e-6, rtol=1e-5)
    wb = tcodec.wire_bytes(st, pt)
    assert wb == jcodec.wire_bytes(sj, pj) == tcomp.tree_bytes(plt)
    _close(tcodec.decode(st, pt, plt), jcodec.decode(sj, pj, plj),
           atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("with_base", [False, True])
def test_decode_and_aggregate_matches_jax(name, with_base):
    sj, st, pj, pt = _spec_pairs()[name]
    rng = np.random.RandomState(1)
    C = 3
    flats = (rng.randn(C, st.size) * 0.05).astype(np.float32)
    w = tagg.normalize_weights([1.0, 2.0, 5.0])
    base = rng.randn(st.size).astype(np.float32) if with_base else None
    stk_j = jcodec.stack_payloads(
        [jcodec.encode(sj, pj, jnp.asarray(f)) for f in flats])
    stk_t = tcodec.stack_payloads(
        [tcodec.encode(st, pt, torch.from_numpy(f)) for f in flats])
    want = jcodec.decode_and_aggregate(
        sj, pj, stk_j, jnp.asarray(w, jnp.float32),
        None if base is None else jnp.asarray(base))
    got = tcodec.decode_and_aggregate(
        st, pt, stk_t, torch.tensor(w, dtype=torch.float32),
        None if base is None else torch.from_numpy(base))
    assert got.shape == (st.size,)
    _close(got, want, atol=1e-5, rtol=1e-4)
    # the one-call path equals decode-then-weighted-mean
    rows = torch.stack([tcodec.decode(st, pt, {k: v[i] for k, v in
                                               stk_t.items()})
                        for i in range(C)])
    seq = tagg.weighted_mean_stacked(rows, w, normalized=True)
    if base is not None:
        seq = seq - torch.from_numpy(base)
    _close(got, seq.numpy(), atol=1e-5, rtol=1e-4)


def test_decode_batched_per_client_params_match_jax():
    sj, st, pj, pt = _spec_pairs()["fcae"]
    flats = (np.random.RandomState(2).randn(2, st.size) * 0.05
             ).astype(np.float32)
    pj2 = jax.tree_util.tree_map(lambda x: jnp.stack([x, 1.5 * x]), pj)
    pt2 = from_jax_params(_np(pj2), "cpu")
    stk_j = jcodec.stack_payloads(
        [jcodec.encode(sj, pj, jnp.asarray(f)) for f in flats])
    stk_t = tcodec.stack_payloads(
        [tcodec.encode(st, pt, torch.from_numpy(f)) for f in flats])
    w = [0.25, 0.75]
    want = jcodec.decode_and_aggregate(sj, pj2, stk_j,
                                       jnp.asarray(w, jnp.float32),
                                       params_batched=True)
    got = tcodec.decode_and_aggregate(st, pt2, stk_t, torch.tensor(w),
                                      params_batched=True)
    _close(got, want, atol=1e-5, rtol=1e-4)


def test_wire_bytes_needs_ae_params():
    _, st, _, _ = _spec_pairs()["fcae"]
    with pytest.raises(ValueError, match="codec_params"):
        tcodec.wire_bytes(st, None)


# ------------------------------------------------- compressors, EF, agg
@pytest.mark.parametrize("bits", [8, 4])
def test_compressor_roundtrip_and_stats_match_jax(bits):
    from repro.core.compressor import QuantizeCompressor as JQ
    pj = j_init(jax.random.PRNGKey(1), J_MLP)
    pt = from_jax_params(_np(pj), "cpu")
    dj, stats_j = JQ(bits=bits).roundtrip(pj)
    dt, stats_t = tcomp.QuantizeCompressor(bits=bits).roundtrip(pt)
    assert stats_t == stats_j
    _close(ravel(dt)[0], ravel_pytree(dj)[0], atol=1e-6, rtol=1e-5)
    res = tcomp.ef_residual(pt, dt)
    back = tcomp.ef_compensate(dt, res)
    _close(ravel(back)[0], ravel(pt)[0], atol=1e-7, rtol=0)


def test_aggregation_helpers_match_jax():
    rng = np.random.RandomState(3)
    stacked = rng.randn(4, 6, 5).astype(np.float32)
    w = [3.0, 1.0, 2.0, 2.0]
    assert tagg.normalize_weights(w) == jagg.normalize_weights(w)
    _close(tagg.weighted_mean_stacked(torch.from_numpy(stacked), w),
           jagg.weighted_mean_stacked(jnp.asarray(stacked), w))
    g = {"a": rng.randn(5).astype(np.float32)}
    u = {"a": rng.randn(5).astype(np.float32)}
    got = tagg.apply_update(from_jax_params(g, "cpu"),
                            from_jax_params(u, "cpu"), 0.5)
    want = jagg.apply_update(jax.tree_util.tree_map(jnp.asarray, g),
                             jax.tree_util.tree_map(jnp.asarray, u), 0.5)
    _close(got["a"], want["a"], atol=0, rtol=0)


def test_savings_copy_matches_jax():
    for args in ((15_910, 32, J_MNIST_AE.n_params, 1),
                 (15_910, 32, J_MNIST_AE.n_params, 8), (100, 0, 10, 1)):
        mt, mj = tsavings.SavingsModel(*args), jsavings.SavingsModel(*args)
        assert mt.savings_ratio(40, 100) == mj.savings_ratio(40, 100)
        assert mt.break_even_collabs(10) == mj.break_even_collabs(10)
        assert mt.break_even_rounds(4) == mj.break_even_rounds(4)
    with pytest.raises(ValueError):
        tsavings.SavingsModel(-1, 1, 1)


# -------------------------------------------------- the cohort round
def test_cohort_round_matches_jax_kernel_path():
    """Run (h) of chip_smoke.py at the small point of the ``fl_decode_agg``
    table (``benchmarks/tables.py:405-419``): a 2^15-value update,
    ``ChunkedAEConfig(256, (32,), 8)``, 8 clients, update i the base x
    (1 + 0.01 i), weights i + 1 normalised. Every client's
    ``codec.encode`` and the server's ``stack_payloads`` +
    ``decode_and_aggregate`` on the kernel path, the port's plain versions
    against the reference's Pallas kernels in interpret mode, from the
    reference's own AE parameters: latents and mean update in the golden
    band, nothing launched."""
    from repro_torch.kernels import _lib
    model, cohort = 1 << 15, 8
    jcfg = jae.ChunkedAEConfig(chunk_size=256, hidden=(32,), latent_chunk=8)
    tcfg = tae.ChunkedAEConfig(chunk_size=256, hidden=(32,), latent_chunk=8)
    pj = jae.init_chunked_ae(jax.random.PRNGKey(0), jcfg)
    pt = from_jax_params(_np(pj), "cpu")
    jspec = jcodec.ChunkedAESpec(size=model, cfg=jcfg, use_kernel=True)
    tspec = tcodec.ChunkedAESpec(size=model, cfg=tcfg, use_kernel=True)
    flat = np.random.RandomState(1).randn(model).astype(np.float32)
    w = jagg.normalize_weights([float(i + 1) for i in range(cohort)])
    assert tagg.normalize_weights([float(i + 1) for i in range(cohort)]) == w
    before = _lib.counts()
    jp = [jcodec.encode(jspec, pj, jnp.asarray(flat) * (1 + 0.01 * i))
          for i in range(cohort)]
    tp = [tcodec.encode(tspec, pt, torch.from_numpy(flat) * (1 + 0.01 * i))
          for i in range(cohort)]
    jstack, tstack = jcodec.stack_payloads(jp), tcodec.stack_payloads(tp)
    assert tuple(tstack["z"].shape) == (cohort, model // 256, 8)
    _close(tstack["z"], jstack["z"])
    jmean = jcodec.decode_and_aggregate(jspec, pj, jstack,
                                        jnp.asarray(w, jnp.float32))
    tmean = tcodec.decode_and_aggregate(tspec, pt, tstack,
                                        torch.tensor(w, dtype=torch.float32))
    assert tuple(tmean.shape) == (model,)
    _close(tmean, jmean)
    assert _lib.counts() == before            # CPU tensors: plain versions


# ------------------------------------------ the client axis over ranks
def _sharded_cases():
    """The reference's ``test_decode_and_aggregate_sharded_matches_fused``
    cases: q8 (block 64) and the kernel-path chunked AE over a chunk-ragged
    1,250 values, cohorts 1 and 5; the JAX payloads carried across, so both
    packages decode the same codes."""
    from repro.core.compressor import (ChunkedAECompressor as JChunked,
                                       QuantizeCompressor as JQ)
    n = 1250
    jcfg = jae.ChunkedAEConfig(chunk_size=128, hidden=(32,), latent_chunk=4)
    jparams = jae.init_chunked_ae(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(_np(jparams), "cpu")
    comps = {
        "quantize8": (JQ(bits=8, block=64),
                      tcodec.QuantizeSpec(n, 8, block=64), None),
        "chunked_ae_kernel": (
            JChunked(jparams, jcfg, use_kernel=True),
            tcodec.ChunkedAESpec(n, tae.ChunkedAEConfig(128, (32,), 4),
                                 use_kernel=True), tparams),
    }
    out = []
    for name, (jc, tspec, tp) in comps.items():
        jspec, jp = jc.spec(n), jc.codec_params()
        for cohort in (1, 5):
            stacked = jcodec.stack_payloads([jcodec.encode(
                jspec, jp, jax.random.normal(jax.random.PRNGKey(i), (n,))
                * (1.0 + i)) for i in range(cohort)])
            w = jnp.asarray(jagg.normalize_weights(
                [1.0 + i for i in range(cohort)]), jnp.float32)
            fused = jcodec.decode_and_aggregate(jspec, jp, stacked, w)
            sharded = jcodec.decode_and_aggregate_sharded(jspec, jp,
                                                          stacked, w)
            tstk = {k: torch.from_numpy(np.array(v))
                    for k, v in stacked.items()}
            out.append((f"{name}-{cohort}", tspec, tp, tstk,
                        torch.from_numpy(np.array(w)), np.asarray(fused),
                        np.asarray(sharded)))
    return out


def _sharded_worker(rank, world, inputs):
    cases = torch.load(inputs, weights_only=False)
    return [tcodec.decode_and_aggregate_sharded(spec, p, stk, w)
            for spec, p, stk, w in cases]


SHARDED = ["quantize8-1", "quantize8-5", "chunked_ae_kernel-1",
           "chunked_ae_kernel-5"]


@pytest.mark.parametrize("case", SHARDED)
def test_decode_and_aggregate_sharded_one_rank_matches_jax(case, tmp_path):
    """``decode_and_aggregate_sharded`` on a one-rank gloo group against
    the reference's sharded and fused calls on its one device, in the
    golden band; ``base`` subtracted after the reduction. No group, no
    call."""
    import torch.distributed as dist
    name, spec, p, stk, w, fused, sharded = next(
        c for c in _sharded_cases() if c[0] == case)
    with pytest.raises(RuntimeError, match="process group"):
        tcodec.decode_and_aggregate_sharded(spec, p, stk, w)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        got = tcodec.decode_and_aggregate_sharded(spec, p, stk, w)
        base = torch.full((spec.size,), 0.25)
        minus = tcodec.decode_and_aggregate_sharded(spec, p, stk, w, base)
    finally:
        dist.destroy_process_group()
    _close(got, sharded)
    _close(got, fused)
    _close(minus, fused - 0.25)


@pytest.mark.parametrize("case", ["quantize8-5", "chunked_ae_kernel-5"])
def test_partial_sums_add_up_to_the_mean(case):
    """``decode_and_aggregate(partial=True)`` over two slices of a cohort
    (the share each rank all-reduces) sums to the whole cohort's mean in
    the golden band, through the same route: for the kernel-path chunked
    AE (given a normalizer with a nonzero mean) the denorm's mean term is
    taken Σw of the slice times. Both are held against the einsum over
    ``decode_batched``'s rows. A partial sum takes no ``base``."""
    name, spec, p, stk, w, fused, _ = next(
        c for c in _sharded_cases() if c[0] == case)
    if p is not None:
        p = dict(p, norm={"mean": torch.tensor(0.5),
                          "std": torch.tensor(1.5)})
    halves = [tcodec.decode_and_aggregate(
        spec, p, {k: v[sl] for k, v in stk.items()}, w[sl], partial=True)
        for sl in (slice(0, 2), slice(2, None))]
    rows = torch.einsum("c,cp->p", w, tcodec.decode_batched(spec, p, stk))
    _close(halves[0] + halves[1], rows)
    _close(tcodec.decode_and_aggregate(spec, p, stk, w), rows)
    with pytest.raises(ValueError, match="no base"):
        tcodec.decode_and_aggregate(spec, p, stk, w,
                                    torch.zeros(spec.size), partial=True)


def test_decode_and_aggregate_sharded_two_ranks_matches_jax(tmp_path):
    """The same four cases on two gloo ranks (two processes; cohorts 1
    and 5 pad to 2 and 6 with zero-weight rows): each rank's result
    against the reference's sharded and fused calls in the golden band,
    and the two ranks' results equal."""
    from repro_torch.launch.local import spawn
    cases = _sharded_cases()
    inputs = tmp_path / "cases.pt"
    torch.save([c[1:5] for c in cases], inputs)
    res = spawn("test_torch_codec:_sharded_worker", 2,
                {"inputs": str(inputs)}, tmp_path / "run", backend="gloo",
                timeout=180, path=[__file__.rsplit("/", 1)[0]])
    for r in res:
        for got, (name, *_, fused, sharded) in zip(r, cases, strict=True):
            _close(got, sharded)
            _close(got, fused)
    for a, b in zip(*res):
        assert torch.equal(a, b)
