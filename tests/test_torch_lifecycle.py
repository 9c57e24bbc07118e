"""The port's AE lifecycle (``core/lifecycle.py``) against a live JAX run:
``observe`` on flat, partitioned and chain lanes; the drift probe
``_rel_recon_err``; multi-round ``end_of_round`` trajectories (initial
ships, cadence and drift triggers, ``ship_initial=False``) through
``FederatedRun`` under ``SyncFedAvg`` and ``SampledSync``; refit datasets;
one cohort dispatch per shape group; decoder bytes through
``savings.reconcile``; pointwise codecs ignored.

Refits cannot replay ``jax.random`` shuffles, so the trajectories run at
``refresh_epochs=0``: a warm-started refit then returns its init in both
packages, and every trigger, ``ae_syncs`` entry, decoder byte, refresh
round, baseline and snapshot can be held against the reference. Refits
with epochs > 0 are held against the port's own cohort fit drawn from the
lane seeds, and must descend. Bytes and rounds exact; floats in the golden
band ``atol=2e-5, rtol=2e-4``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as J  # noqa: E402
from repro.configs.paper import AEConfig as JAEConfig  # noqa: E402
from repro.configs.paper import MNIST_CLASSIFIER as J_MLP  # noqa: E402
from repro.core import lifecycle as jlc  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.classifiers import init_classifier  # noqa: E402

from repro_torch import core as T  # noqa: E402
from repro_torch.configs.paper import AEConfig as TAEConfig  # noqa: E402
from repro_torch.configs.paper import MNIST_CLASSIFIER  # noqa: E402
from repro_torch.core import lifecycle as tlc  # noqa: E402
from repro_torch.core.pytree import from_jax_params  # noqa: E402
from repro_torch.core.task import ClassifierTask  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)
N_CLIENTS = 3
P_MLP = 15_910
CH = dict(chunk_size=256, hidden=(32,), latent_chunk=8)
FC = dict(input_dim=16_000, encoder_hidden=(), latent_dim=16)
PART_CH = dict(chunk_size=128, hidden=(16,), latent_chunk=4)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


class _JaxInitTask(ClassifierTask):
    """The port's classifier task started from the JAX package's params."""

    def __init__(self, clf_cfg, params_np):
        super().__init__(clf_cfg)
        self.params_np = params_np

    def init_params(self, gen, device):
        return from_jax_params(self.params_np, device)


def _ae_params(kind):
    """One AE's params in both packages (numpy-identical)."""
    key = jax.random.PRNGKey(7)
    if kind == "fc":
        pj = J.init_fc_ae(key, JAEConfig(**FC))
    elif kind == "part":
        pj = J.init_chunked_ae(key, J.ChunkedAEConfig(**PART_CH))
    else:
        pj = J.init_chunked_ae(key, J.ChunkedAEConfig(**CH))
    # a normalizer at the update's scale, so the codec is not degenerate
    pj = dict(pj, norm={"mean": jnp.float32(0.0), "std": jnp.float32(1e-3)})
    return pj, from_jax_params(_np(pj), "cpu")


def _comps(kind):
    """A compressor per client in each package: ``fc``, ``chunked``,
    ``chain`` (TopK 1 % → chunked AE → q8), ``part`` (dense0 on a chunked
    AE, dense1 on q8), ``mixed`` (two clients on one chunked AE, the third
    on the FC AE) or ``q8``. Clients share one params object, as a
    pre-pass AE shipped to every client would."""
    jcomp, tcomp = J.compressor, T.compressor
    if kind == "q8":
        return ([jcomp.QuantizeCompressor(bits=8) for _ in range(N_CLIENTS)],
                [tcomp.QuantizeCompressor(bits=8) for _ in range(N_CLIENTS)])
    if kind == "fc":
        pj, pt = _ae_params("fc")
        return ([jcomp.FCAECompressor(pj, JAEConfig(**FC))
                 for _ in range(N_CLIENTS)],
                [tcomp.FCAECompressor(pt, TAEConfig(**FC))
                 for _ in range(N_CLIENTS)])
    if kind == "mixed":
        cj, ct = _comps("chunked")
        fj, ft = _comps("fc")
        return cj[:2] + fj[2:], ct[:2] + ft[2:]
    if kind == "part":
        pj, pt = _ae_params("part")
        tmpl = init_classifier(jax.random.PRNGKey(0), J_MLP)
        pmj = J.by_layer_partition(tmpl)
        pmt = T.by_layer_partition(from_jax_params(_np(tmpl), "cpu"))
        cfg_j, cfg_t = (J.ChunkedAEConfig(**PART_CH),
                        T.ChunkedAEConfig(**PART_CH))
        return ([jcomp.PartitionedCompressor(pmj, {
                    "dense0": jcomp.ChunkedAECompressor(pj, cfg_j, False),
                    "dense1": jcomp.QuantizeCompressor(bits=8)})
                 for _ in range(N_CLIENTS)],
                [tcomp.PartitionedCompressor(pmt, {
                    "dense0": tcomp.ChunkedAECompressor(pt, cfg_t, False),
                    "dense1": tcomp.QuantizeCompressor(bits=8)})
                 for _ in range(N_CLIENTS)])
    pj, pt = _ae_params("chunked")
    cfg_j, cfg_t = J.ChunkedAEConfig(**CH), T.ChunkedAEConfig(**CH)
    if kind == "chunked":
        return ([jcomp.ChunkedAECompressor(pj, cfg_j, False)
                 for _ in range(N_CLIENTS)],
                [tcomp.ChunkedAECompressor(pt, cfg_t, False)
                 for _ in range(N_CLIENTS)])
    assert kind == "chain"
    return ([jcomp.ChainCompressor([
                jcomp.TopKCompressor(0.01),
                jcomp.ChunkedAECompressor(pj, cfg_j, False),
                jcomp.QuantizeCompressor(bits=8, block=64)])
             for _ in range(N_CLIENTS)],
            [tcomp.ChainCompressor([
                tcomp.TopKCompressor(0.01),
                tcomp.ChunkedAECompressor(pt, cfg_t, False),
                tcomp.QuantizeCompressor(bits=8, block=64)])
             for _ in range(N_CLIENTS)])


def _data(pkg):
    train, ev = pkg.train_eval_split(pkg.mnist_like(0, N_CLIENTS * 64 + 64),
                                     64)
    return pkg.uniform_partition(0, train, N_CLIENTS), ev


def _runs(kind, lc_kw, n_rounds=4, sched=None):
    """The same lifecycle run in both packages. The chain ships weights
    (paper §5.2) without error feedback: top-k is discontinuous, and an
    update after a few Adam steps has many entries of one magnitude
    (about steps × lr), so its ranking would follow rounding; the
    weights' magnitudes are well apart."""
    chain = kind == "chain"
    cfg = dict(n_rounds=n_rounds, local_epochs=2,
               payload="weights" if chain else "update",
               error_feedback=not chain, lr=2e-3)
    p0 = _np(init_classifier(jax.random.PRNGKey(0), J_MLP))
    cj, ct = _comps(kind)
    dj, evj = _data(jpipe)
    dt, evt = _data(tpipe)
    run_j = J.FederatedRun(
        J_MLP, dj, J.FLConfig(**cfg), compressors=cj, eval_data=evj,
        lifecycle=J.AELifecycle(**lc_kw),
        scheduler=None if sched is None else J.SampledSync(**sched))
    run_t = T.FederatedRun(
        _JaxInitTask(MNIST_CLASSIFIER, p0), dt, T.FLConfig(**cfg),
        compressors=ct, eval_data=evt, lifecycle=T.AELifecycle(**lc_kw),
        scheduler=None if sched is None else T.SampledSync(**sched),
        device="cpu")
    run_j.run()
    run_t.run()
    return run_j, run_t


def _close_opt(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_allclose(b, a, **BAND)


def _compare(run_j, run_t):
    """Every record's bytes and syncs exact; every client's lifecycle
    state (refresh rounds exact, baselines and snapshot rings in band)."""
    for a, b in zip(run_j.history, run_t.history, strict=True):
        for k in ("bytes_up", "bytes_up_measured", "bytes_up_raw",
                  "bytes_down", "bytes_decoder", "participants"):
            assert getattr(b, k) == getattr(a, k), (a.round, k)
        assert b.ae_syncs == a.ae_syncs, a.round
        np.testing.assert_allclose(b.global_metrics["loss"],
                                   a.global_metrics["loss"], **BAND)
    for sj, st in zip(run_j.clients, run_t.clients, strict=True):
        assert st.last_refresh == sj.last_refresh
        _close_opt(sj.ae_baseline, st.ae_baseline)
        assert st.part_last_refresh == sj.part_last_refresh
        assert st.part_baseline.keys() == sj.part_baseline.keys()
        for name in sj.part_baseline:
            _close_opt(sj.part_baseline[name], st.part_baseline[name])
        rings = [(sj.snapshots, st.snapshots)] + [
            (sj.part_snapshots[n], st.part_snapshots[n])
            for n in sj.part_snapshots]
        assert st.part_snapshots.keys() == sj.part_snapshots.keys()
        for rj, rt in rings:
            assert len(rt) == len(rj)
            for a, b in zip(rj, rt):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), **BAND)


# ------------------------------------------------------------ trajectories
TRAJECTORIES = {
    # cadence every 2 rounds, a ring of 2, refits from 1 snapshot
    "fc-cadence": ("fc", dict(refresh_every=2, buffer_size=2,
                              min_snapshots=1, refresh_epochs=0), 3),
    # drift only: any growth of the error past the baseline refits
    "chunked-drift": ("chunked", dict(drift_ratio=1.0, buffer_size=2,
                                      min_snapshots=2, refresh_epochs=0)),
    "chunked-no-initial-ship": ("chunked", dict(
        refresh_every=1, min_snapshots=2, refresh_epochs=0,
        ship_initial=False)),
    # 2 rounds: a weights payload through top-k zeroes 99 % of the model,
    # and from round 2 on most weights are about steps × lr apart from the
    # kept ones, so the probe's top-k would rank rounding
    "chain-drift": ("chain", dict(drift_ratio=1.0, min_snapshots=1,
                                  refresh_epochs=0), 2),
    "partitioned": ("part", dict(refresh_every=1, min_snapshots=1,
                                 buffer_size=2, refresh_epochs=0), 3),
    "mixed-shapes": ("mixed", dict(refresh_every=1, min_snapshots=1,
                                   buffer_size=2, refresh_epochs=0), 3),
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_lifecycle_trajectory_matches_reference(name):
    kind, lc_kw, *rounds = TRAJECTORIES[name]
    run_j, run_t = _runs(kind, lc_kw, *rounds)
    _compare(run_j, run_t)
    syncs = [s for r in run_t.history for s in (r.ae_syncs or [])]
    assert syncs, "the run shipped no decoder"


def test_lifecycle_sampled_sync_matches_reference():
    """Partial participation: unsampled clients keep their rings and
    refresh rounds; first participation charges the initial ship."""
    run_j, run_t = _runs("chunked", dict(refresh_every=2, min_snapshots=1,
                                         refresh_epochs=0),
                         n_rounds=5, sched=dict(cohort=2, sample_seed=3))
    _compare(run_j, run_t)


def test_pointwise_codecs_are_ignored():
    run_j, run_t = _runs("q8", dict(refresh_every=1, min_snapshots=1),
                         n_rounds=2)
    _compare(run_j, run_t)
    for r in run_t.history:
        assert r.ae_syncs == [] and r.bytes_decoder == 0.0
    assert all(not c.snapshots and c.last_refresh == -1
               for c in run_t.clients)


# ------------------------------------------------------------ pieces
def test_observe_rings_and_rel_recon_err_match_reference():
    """``observe`` on a flat, a partitioned and a chain client fed the same
    vectors, then the drift probe of each lane in both packages."""
    lc_j, lc_t = J.AELifecycle(buffer_size=2), T.AELifecycle(buffer_size=2)
    rng = np.random.RandomState(0)
    vecs = [(rng.randn(P_MLP) * 1e-3).astype(np.float32) for _ in range(3)]
    for kind in ("chunked", "part", "chain", "fc"):
        cj, ct = _comps(kind)
        sj, st = J.ClientState(), T.ClientState()
        for v in vecs:
            lc_j.observe(sj, cj[0], jnp.asarray(v))
            lc_t.observe(st, ct[0], torch.from_numpy(v))
        if kind == "part":
            assert list(st.part_snapshots) == ["dense0"] and not st.snapshots
            rj, rt = sj.part_snapshots["dense0"], st.part_snapshots["dense0"]
        else:
            rj, rt = sj.snapshots, st.snapshots
        assert len(rt) == len(rj) == 2
        for a, b in zip(rj, rt):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))

        class _Run:
            def __init__(self, comps, state):
                self.compressors, self.clients = comps, [state]
        lane = (0, "dense0") if kind == "part" else 0
        ej = lc_j._lane_baseline(_Run(cj, sj), lane)
        et = lc_t._lane_baseline(_Run(ct, st), lane)
        np.testing.assert_allclose(et, ej, **BAND)
        probe_t = lc_t._lane_probe(_Run(ct, st), lane)
        assert isinstance(probe_t, T.ChainCompressor) == (kind == "chain")
        spec_j = lc_j._lane_probe(_Run(cj, sj), lane).spec(rj[-1].size)
        spec_t = probe_t.spec(rt[-1].numel())
        np.testing.assert_allclose(
            float(tlc._rel_recon_err(spec_t, probe_t.codec_params(),
                                     rt[0])),
            float(jlc._rel_recon_err(
                spec_j, lc_j._lane_probe(_Run(cj, sj), lane).codec_params(),
                rj[0])), **BAND)


@pytest.mark.parametrize("kind", ["fc", "chunked", "chain"])
def test_refit_dataset_rows_equal_reference(kind):
    """The same snapshot ring in both packages gives the same refit rows:
    the FC AE's padded snapshots, the chunked AE's chunks, and the TopK →
    chunked-AE chain's top-k values cut into chunks."""
    cj, ct = _comps(kind)
    rng = np.random.RandomState(1)
    vecs = [(rng.randn(P_MLP) * 1e-3).astype(np.float32) for _ in range(3)]

    class _Run:
        def __init__(self, comps, state):
            self.compressors, self.clients = comps, [state]
    sj = J.ClientState(snapshots=[jnp.asarray(v) for v in vecs])
    st = T.ClientState(snapshots=[torch.from_numpy(v) for v in vecs])
    cfg_j, rows_j = J.AELifecycle()._refit_dataset(_Run(cj, sj), 0)
    cfg_t, rows_t = T.AELifecycle()._refit_dataset(_Run(ct, st), 0)
    assert tuple(rows_t.shape) == rows_j.shape
    assert (cfg_t.input_dim, cfg_t.encoder_hidden, cfg_t.latent_dim) == \
        (cfg_j.input_dim, cfg_j.encoder_hidden, cfg_j.latent_dim)
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))


def test_one_cohort_dispatch_per_shape_group(monkeypatch):
    """Round 1 of the mixed run refits all three clients: the two
    chunked-AE clients share one dispatch of C = 2, the FC-AE client takes
    ``train_autoencoder`` (one dispatch of C = 1)."""
    calls = []
    real = T.autoencoder.train_autoencoder_cohort

    def spy(gens, cfg, datasets, **kw):
        calls.append((cfg.input_dim, tuple(datasets.shape)))
        return real(gens, cfg, datasets, **kw)
    monkeypatch.setattr(T.autoencoder, "train_autoencoder_cohort", spy)
    _, ct = _comps("mixed")
    dt, evt = _data(tpipe)
    run = T.FederatedRun(
        MNIST_CLASSIFIER, dt,
        T.FLConfig(n_rounds=2, local_epochs=1, payload="update"),
        compressors=ct, eval_data=evt, device="cpu",
        lifecycle=T.AELifecycle(refresh_every=1, min_snapshots=1,
                                refresh_epochs=1))
    run.run()
    assert sorted(calls) == sorted([(256, (2, 2 * 63, 256)),
                                    (16_000, (1, 2, 16_000))])
    assert run.history[1].ae_syncs == [0, 1, 2]


def test_refits_equal_own_cohort_fit_and_descend():
    """At epochs > 0 a cadence refit installs exactly the cohort fit drawn
    from the lane seeds (the reference's integers as CPU generators) on
    the lane's refit rows, warm-started from its params, and the fit
    descends."""
    lc = T.AELifecycle(refresh_every=1, min_snapshots=2, refresh_epochs=4,
                       seed=5)
    _, ct = _comps("chunked")
    init = ct[0].codec_params()
    dt, evt = _data(tpipe)
    run = T.FederatedRun(MNIST_CLASSIFIER, dt,
                         T.FLConfig(n_rounds=2, local_epochs=1,
                                    payload="update", error_feedback=True),
                         compressors=ct, eval_data=evt, lifecycle=lc,
                         device="cpu")
    run.run()                             # round 1 refits all three
    assert [r.ae_syncs for r in run.history] == [[0, 1, 2], [0, 1, 2]]
    rows = torch.stack([lc._refit_dataset(run, ci)[1]
                        for ci in range(N_CLIENTS)])
    assert rows.shape == (3, 2 * 63, 256)
    gens = [torch.Generator().manual_seed(
        (5 * 1_000_003 + 1 * 1009 + ci) % 2 ** 31) for ci in range(3)]
    want, hist = T.train_autoencoder_cohort(
        gens, T.ChunkedAEConfig(**CH).as_fc(), rows,
        init=T.pytree.stack([init] * 3), epochs=4, batch_size=8, lr=3e-3,
        val_fraction=0.2, refit_normalizer=False)
    for ci, comp in enumerate(ct):
        assert comp.codec_params() is not init
        for a, b in zip(T.pytree.leaves(comp.codec_params()),
                        T.pytree.leaves(want)):
            assert torch.equal(a, b[ci])
    loss = hist["loss"]
    assert bool((loss[:, -1] < loss[:, 0]).all()), loss


def test_decoder_bytes_reconcile_equals_reference():
    run_j, run_t = _runs("chunked", dict(refresh_every=2, min_snapshots=1,
                                         refresh_epochs=0))
    ae_j = run_j.compressors[0].codec_params()
    model = dict(original_size=P_MLP, compressed_size=63 * 8,
                 autoencoder_size=J.ae_param_count(ae_j))
    want = run_j.savings_report(J.SavingsModel(**model))
    got = run_t.savings_report(T.SavingsModel(**model))
    assert got == want
    assert got["decoder_syncs"] == 6.0
    assert got["observed_decoder_bytes"] == sum(
        r.bytes_decoder for r in run_t.history)
