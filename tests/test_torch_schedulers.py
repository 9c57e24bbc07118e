"""The port's scalable runtime against a live JAX run: ``LatencyModel``,
``ArrivalEngine`` and ``pop_k_device``, ``local_train_batched``, and
``FederatedRun`` under ``SampledSync`` and ``AsyncBuffered`` (both event
engines) over the MNIST MLP and a reduced CIFAR CNN. Both packages get the
same numpy data and the JAX package's own initial parameters.

Integers exact (latency draws, arrival traces, participants, staleness,
simulated time, bytes, vmap/loop round counts); losses and parameters in
the golden band ``atol=2e-5, rtol=2e-4``.
"""
import heapq

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro import core as J  # noqa: E402
from repro.configs.paper import ClassifierConfig as JClf  # noqa: E402
from repro.configs.paper import MNIST_CLASSIFIER as J_MLP  # noqa: E402
from repro.core.arrival import pop_k_device as j_pop_k_device  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.classifiers import init_classifier  # noqa: E402

from repro_torch import core as T  # noqa: E402
from repro_torch.configs.paper import ClassifierConfig as TClf  # noqa: E402
from repro_torch.configs.paper import MNIST_CLASSIFIER  # noqa: E402
from repro_torch.core.pytree import (from_jax_params, ravel,  # noqa: E402
                                     tree_map)
from repro_torch.core.task import ClassifierTask  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)
# a CIFAR-shaped CNN cut to 12x12 images, 4/4 channels and a 16-wide head:
# the same conv / pool / NHWC-flatten code path as CIFAR_CLASSIFIER
SMALL_CNN = dict(name="cifar-cnn-small", kind="cnn", input_shape=(12, 12, 3),
                 n_classes=10, conv_channels=(4, 4), conv_kernel=3,
                 dense_hidden=(16,))


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


class _JaxInitTask(ClassifierTask):
    """The port's classifier task started from the JAX package's params."""

    def __init__(self, clf_cfg, params_np):
        super().__init__(clf_cfg)
        self.params_np = params_np

    def init_params(self, gen, device):
        return from_jax_params(self.params_np, device)


def _compare(run_j, run_t):
    """Records and final parameters of two runs of one configuration."""
    for a, b in zip(run_j.history, run_t.history, strict=True):
        for k in ("bytes_up", "bytes_up_raw", "bytes_down", "participants",
                  "staleness", "sim_time"):
            assert getattr(b, k) == getattr(a, k), k
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(b.global_metrics[k],
                                       a.global_metrics[k], **BAND)
        for mj, mt in zip(a.collab_metrics, b.collab_metrics, strict=True):
            assert mt.keys() == mj.keys()
            for k in mj:
                np.testing.assert_allclose(mt[k], mj[k], **BAND)
    np.testing.assert_allclose(
        ravel(run_t.global_params)[0].numpy(),
        np.asarray(ravel_pytree(run_j.global_params)[0]), **BAND)


def _uniform(pkg, n_clients, per, like="mnist", seed=0):
    data = (pkg.mnist_like(seed, n_clients * per + 64) if like == "mnist"
            else pkg.cifar_like(seed, n_clients * per + 64))
    if like == "small_cnn":
        data = pkg.synthetic_classification(seed, n_clients * per + 64,
                                            (12, 12, 3), 10, sep=8.0,
                                            noise=0.7)
    train, ev = pkg.train_eval_split(data, 64)
    return pkg.uniform_partition(0, train, n_clients), ev


def _runs(clf_j, clf_t, data_j, ev_j, data_t, ev_t, cfg, comps_j, comps_t,
          sched_j, sched_t, seed=0):
    p0 = _np(init_classifier(jax.random.PRNGKey(seed), clf_j))
    run_j = J.FederatedRun(clf_j, data_j, J.FLConfig(**cfg),
                           compressors=comps_j, eval_data=ev_j,
                           scheduler=sched_j)
    run_j.run()
    run_t = T.FederatedRun(_JaxInitTask(clf_t, p0), data_t, T.FLConfig(**cfg),
                           compressors=comps_t, eval_data=ev_t,
                           scheduler=sched_t, device="cpu")
    run_t.run()
    return run_j, run_t


# ------------------------------------------------------------ latency
@pytest.mark.parametrize("legacy_hash", [False, True])
def test_latency_model_draws_equal_reference(legacy_hash):
    kw = dict(base=1.5, jitter=0.5, straggler_frac=0.1, straggler_mult=8.0,
              seed=3, legacy_hash=legacy_hash)
    lj, lt = J.LatencyModel(**kw), T.LatencyModel(**kw)
    for c in (0, 1, 99, 100, 517, 999):
        for d in range(4):
            assert lt.sample(c, d, 1000) == lj.sample(c, d, 1000)
            assert lt.is_straggler(c, 1000) == lj.is_straggler(c, 1000)


# ------------------------------------------------------------ arrivals
def test_arrival_engine_trace_equals_reference_and_heap():
    """Both engines and a heap through the FedBuff discipline (all at t=0,
    drain K, re-dispatch those K), ties included (jitter 0 gives every
    non-straggler the same time)."""
    n, k = 40, 7
    for jitter in (0.0, 0.5):
        lat = J.LatencyModel(jitter=jitter, straggler_frac=0.2,
                             straggler_mult=4.0, seed=1)
        ej, et, heap, seq = J.ArrivalEngine(n), T.ArrivalEngine(n), [], 0
        for ci in range(n):
            t = lat.sample(ci, 0, n)
            ej.push(ci, t)
            et.push(ci, t)
            heapq.heappush(heap, (t, seq, ci))
            seq += 1
        clock = 0.0
        for r in range(1, 8):
            got = et.pop_k(k)
            assert got == ej.pop_k(k)
            assert got == [(t, ci) for t, _, ci in
                           (heapq.heappop(heap) for _ in range(k))]
            clock = max(clock, got[-1][0])
            ts = [clock + lat.sample(ci, r, n) for _, ci in got]
            et.push_many([ci for _, ci in got], ts)
            for (_, ci), t in zip(got, ts):
                ej.push(ci, t)
                heapq.heappush(heap, (t, seq, ci))
                seq += 1
            assert et.entries() == ej.entries()
            assert et.next_seq == ej.next_seq


def test_pop_k_device_equals_reference():
    rng = np.random.RandomState(0)
    times = rng.choice([1.0, 2.0, 2.5, np.inf], size=64).astype(np.float32)
    seqs = rng.permutation(64).astype(np.int32)
    seqs[times == np.inf] = -1
    for k in (1, 5, 20):
        tj, ij = j_pop_k_device(jnp.asarray(times), jnp.asarray(seqs), k)
        tt, it = T.pop_k_device(torch.from_numpy(times),
                                torch.from_numpy(seqs), k)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        assert it.dtype == torch.int32


def test_staleness_weights_equal_reference():
    w, s = [64.0, 32.0, 10.0], [0, 3, 7]
    assert T.staleness_weights(w, s, 0.5) == J.staleness_weights(w, s, 0.5)


# ---------------------------------------------------- batched training
@pytest.mark.parametrize("model", ["mlp", "small_cnn"])
def test_local_train_batched_matches_reference_and_own_loop(model):
    clf_j = J_MLP if model == "mlp" else JClf(**SMALL_CNN)
    clf_t = MNIST_CLASSIFIER if model == "mlp" else TClf(**SMALL_CNN)
    like = "mnist" if model == "mlp" else "small_cnn"
    dj, _ = _uniform(jpipe, 3, 96, like)
    dt, _ = _uniform(tpipe, 3, 96, like)
    p0 = init_classifier(jax.random.PRNGKey(0), clf_j)
    kw = dict(epochs=2, lr=1e-3, batch_size=32, seed=7, prox_mu=0.01)
    bj, mj = J.local_train_batched(
        p0, clf_j, {k: jnp.stack([d[k] for d in dj]) for k in dj[0]},
        anchor=p0, **kw)
    pt = from_jax_params(_np(p0), "cpu")
    bt, mt = T.local_train_batched(
        pt, clf_t, {k: torch.stack([d[k] for d in dt]) for k in dt[0]},
        anchor=pt, **kw)
    for ci in range(3):
        got = ravel(tree_map(lambda x, i=ci: x[i], bt))[0]
        want = ravel_pytree(jax.tree_util.tree_map(lambda x, i=ci: x[i],
                                                   bj))[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)
        np.testing.assert_allclose(mt[ci]["loss"], mj[ci]["loss"], **BAND)
        own, _, hist = T.local_train(pt, clf_t, dt[ci], anchor=pt, **kw)
        np.testing.assert_allclose(got.numpy(), ravel(own)[0].numpy(),
                                   atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(mt[ci]["loss"], hist[-1]["loss"],
                                   atol=1e-6, rtol=1e-5)


# -------------------------------------------------------- SampledSync
@pytest.mark.parametrize("use_vmap,ragged", [(True, False), (False, False),
                                             (True, True)])
def test_sampled_sync_matches_reference(use_vmap, ragged):
    """q8 update payload + error feedback, 6 clients, cohort 3, 2 rounds:
    equal shards take the vmap path, a Dirichlet split falls back to the
    loop — in both packages alike."""
    if ragged:
        trj, evj = jpipe.train_eval_split(jpipe.mnist_like(0, 448), 64)
        trt, evt = tpipe.train_eval_split(tpipe.mnist_like(0, 448), 64)
        dj = jpipe.dirichlet_partition(0, trj, 6, alpha=1.0)
        dt = tpipe.dirichlet_partition(0, trt, 6, alpha=1.0)
    else:
        dj, evj = _uniform(jpipe, 6, 64)
        dt, evt = _uniform(tpipe, 6, 64)
    cfg = dict(n_rounds=2, local_epochs=1, payload="update",
               error_feedback=True, seed=0)
    sj = J.SampledSync(cohort=3, sample_seed=1, use_vmap=use_vmap)
    st = T.SampledSync(cohort=3, sample_seed=1, use_vmap=use_vmap)
    run_j, run_t = _runs(
        J_MLP, MNIST_CLASSIFIER, dj, evj, dt, evt, cfg,
        [J.QuantizeCompressor(bits=8) for _ in range(6)],
        [T.QuantizeCompressor(bits=8) for _ in range(6)], sj, st)
    _compare(run_j, run_t)
    assert (st.vmap_rounds, st.loop_rounds) == (sj.vmap_rounds,
                                                sj.loop_rounds)
    assert st.vmap_rounds == (2 if use_vmap and not ragged else 0)
    assert run_t.history[0].bytes_up == 3 * (63 * 256 + 63 * 4)
    assert run_t.history[0].bytes_down == 3 * 15_910 * 4


def test_sampled_sync_small_cnn_composed_chunked_ae_matches_reference():
    """Run (i) of chip_smoke.py cut to size: the CNN under SampledSync with
    the vmap path, EF, and the kernel-path chunked AE with q8 latents
    (``ComposedCompressor``) — kernel-terminal server route on both
    sides (the reference's Pallas kernels in interpret mode, the port's
    plain versions on CPU tensors)."""
    from repro.core import autoencoder as jae
    jcfg = jae.ChunkedAEConfig(chunk_size=256, hidden=(32,), latent_chunk=8)
    tcfg = T.ChunkedAEConfig(chunk_size=256, hidden=(32,), latent_chunk=8)
    aej = jae.init_chunked_ae(jax.random.PRNGKey(2), jcfg)
    aet = from_jax_params(_np(aej), "cpu")
    dj, evj = _uniform(jpipe, 4, 64, "small_cnn")
    dt, evt = _uniform(tpipe, 4, 64, "small_cnn")
    cfg = dict(n_rounds=2, local_epochs=1, payload="update",
               error_feedback=True, seed=0)
    sj, st = J.SampledSync(cohort=3), T.SampledSync(cohort=3)
    run_j, run_t = _runs(
        JClf(**SMALL_CNN), TClf(**SMALL_CNN), dj, evj, dt, evt, cfg,
        [J.ComposedCompressor(J.ChunkedAECompressor(aej, jcfg,
                                                    use_kernel=True))
         for _ in range(4)],
        [T.ComposedCompressor(T.ChunkedAECompressor(aet, tcfg,
                                                    use_kernel=True))
         for _ in range(4)], sj, st)
    _compare(run_j, run_t)
    assert st.vmap_rounds == sj.vmap_rounds == 2
    n = ravel(run_t.global_params)[0].numel()
    nc = -(-n // 256)
    # q8 of nc * 8 latents at block 64: codes + one f32 scale a block
    nb = -(-nc * 8 // 64)
    assert run_t.history[0].bytes_up == 3 * (nb * 64 + nb * 4)


# ------------------------------------------------------- AsyncBuffered
def test_async_buffered_matches_reference():
    """8 clients, K 3, jitter and a 25 % straggler tail, TopK→q8 chain
    (the scatter server route), both of the port's event engines against
    the reference's heap run: arrival traces, staleness, simulated time
    and bytes exact; losses and parameters in the golden band.

    Four Adam steps a client (2 epochs of 2 batches): after a single step
    every moved parameter has moved by lr·g/(|g|+eps), i.e. by lr to within
    float rounding, so top-k would rank rounding noise and any two
    implementations (or one on two devices) may keep different indices."""
    dj, evj = _uniform(jpipe, 8, 64)
    dt, evt = _uniform(tpipe, 8, 64)
    lat = dict(jitter=0.5, straggler_frac=0.25, straggler_mult=8.0)
    cfg = dict(n_rounds=3, local_epochs=2, batch_size=32, payload="update",
               error_feedback=True, seed=0)
    p0 = _np(init_classifier(jax.random.PRNGKey(0), J_MLP))
    run_j = J.FederatedRun(
        J_MLP, dj, J.FLConfig(**cfg), eval_data=evj,
        compressors=[J.ChainCompressor([J.TopKCompressor(0.01),
                                        J.QuantizeCompressor(bits=8)])
                     for _ in range(8)],
        scheduler=J.AsyncBuffered(buffer_k=3, latency=J.LatencyModel(**lat)))
    run_j.run()
    for engine in ("heap", "vector"):
        run_t = T.FederatedRun(
            _JaxInitTask(MNIST_CLASSIFIER, p0), dt, T.FLConfig(**cfg),
            eval_data=evt, device="cpu",
            compressors=[T.ChainCompressor([T.TopKCompressor(0.01),
                                            T.QuantizeCompressor(bits=8)])
                         for _ in range(8)],
            scheduler=T.AsyncBuffered(buffer_k=3, engine=engine,
                                      latency=T.LatencyModel(**lat)))
        run_t.run()
        _compare(run_j, run_t)
        assert any(s > 0 for r in run_t.history for s in r.staleness)
        # k = 159 top-k values: int32 indices + q8 of the values (1 block)
        assert run_t.history[0].bytes_up == 3 * (159 * 4 + 256 + 4)


def test_async_engines_bit_identical_and_zero_jitter_equals_sync():
    dt, evt = _uniform(tpipe, 4, 64)
    cfg = T.FLConfig(n_rounds=3, local_epochs=1, lr=2e-3)
    lat = T.LatencyModel(jitter=0.5, straggler_frac=0.25)
    runs = {}
    for engine in ("heap", "vector"):
        run = T.FederatedRun(MNIST_CLASSIFIER, dt, cfg, eval_data=evt,
                             scheduler=T.AsyncBuffered(buffer_k=2,
                                                       latency=lat,
                                                       engine=engine),
                             device="cpu")
        runs[engine] = (run, run.run())
    (rh, hh), (rv, hv) = runs["heap"], runs["vector"]
    for a, b in zip(hh, hv, strict=True):
        assert (a.participants, a.staleness, a.sim_time, a.bytes_up,
                a.bytes_down) == (b.participants, b.staleness, b.sim_time,
                                  b.bytes_up, b.bytes_down)
    assert torch.equal(ravel(rh.global_params)[0],
                       ravel(rv.global_params)[0])

    sync = T.FederatedRun(MNIST_CLASSIFIER, dt, cfg, eval_data=evt,
                          device="cpu")
    asyn = T.FederatedRun(MNIST_CLASSIFIER, dt, cfg, eval_data=evt,
                          scheduler=T.AsyncBuffered(
                              buffer_k=4, latency=T.LatencyModel()),
                          device="cpu")
    for a, b in zip(sync.run(), asyn.run(), strict=True):
        assert a.global_metrics == b.global_metrics
        assert (a.bytes_up, a.bytes_down) == (b.bytes_up, b.bytes_down)
        assert sorted(b.participants) == a.participants
        assert b.staleness == [0, 0, 0, 0]


def test_async_refuses_what_is_not_ported():
    dt, _ = _uniform(tpipe, 2, 64)
    cfg = T.FLConfig(n_rounds=1)
    with pytest.raises(ValueError, match="engine"):
        T.FederatedRun(MNIST_CLASSIFIER, dt, cfg, device="cpu",
                       scheduler=T.AsyncBuffered(engine="other"))
    # distortion-weighted staleness is ported (rate control): without a
    # controller it binds and leaves the weights as they are
    T.FederatedRun(MNIST_CLASSIFIER, dt, cfg, device="cpu",
                   scheduler=T.AsyncBuffered(distortion_power=1.0)).run()
    # the checkpoint state is ported: the event loop round-trips
    sched = T.AsyncBuffered()
    T.FederatedRun(MNIST_CLASSIFIER, dt, cfg, device="cpu", scheduler=sched)
    state = sched.state_dict()
    assert [ci for _, _, ci in state["heap"]] == [0, 1]
    sched.on_restore(state)
    assert sched.state_dict() == state
