"""The port's struct-of-arrays client state (``repro_torch.core.soa``)
against a live JAX run on the CPU: every case of
``tests/test_soa_state.py``, through the reference's own objects on the
same numpy inputs and the reference's initial params carried across.

* view semantics: the ring's list discipline through wraparound, its
  cohort-wide append, the empty ring of an absent lane, the client view's
  scalars and per-partition dicts, the cohort gather and scatter — each
  read equal to the reference pool fed the same writes;
* differential runs: ``FederatedRun(soa_state=True)`` with the vector
  engine ``torch.equal`` to the eager heap-engine run (records, params,
  residuals), for ``AsyncBuffered`` and ``SampledSync``; its bytes equal
  the reference's SoA run's, its params in the golden band ``atol=2e-5,
  rtol=2e-4``;
* checkpoints: an SoA resume, across engines too, ``torch.equal`` to the
  uninterrupted run; ``ClientPool.state()`` equal to the reference's tree
  and metadata key for key; a JAX SoA checkpoint resumed in the port and
  a port SoA checkpoint resumed by the JAX package, each continuing to
  the other's next round (bytes exact, floats in the band);
* the broadcast-bytes cache: one ``tree_bytes`` a model version.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro import core as J  # noqa: E402
from repro.configs.paper import MNIST_CLASSIFIER as J_MLP  # noqa: E402
from repro.core import soa as jsoa  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.classifiers import init_classifier  # noqa: E402

from repro_torch import core as T  # noqa: E402
from repro_torch.configs.paper import MNIST_CLASSIFIER  # noqa: E402
from repro_torch.core import scheduler as scheduler_mod  # noqa: E402
from repro_torch.core.pytree import from_jax_params, leaves, ravel  # noqa: E402,E501
from repro_torch.core.soa import (ClientPool, RingStore,  # noqa: E402
                                  RingView, _EmptyRing)
from repro_torch.core.task import ClassifierTask  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)        # tests/test_golden_trajectory.py
N_CLIENTS = 5
P0 = jax.tree_util.tree_map(np.array,
                            init_classifier(jax.random.PRNGKey(0), J_MLP))
TMPL = from_jax_params(P0, "cpu")


class _JaxInitTask(ClassifierTask):
    """The port's classifier task started from the params the reference
    draws for ``FLConfig(seed=seed)``."""

    def __init__(self, clf_cfg, seed: int):
        super().__init__(clf_cfg)
        self.params_np = jax.tree_util.tree_map(
            np.array, init_classifier(jax.random.PRNGKey(seed), J_MLP))

    def init_params(self, gen, device):
        return from_jax_params(self.params_np, device)


def _data(pkg, n=N_CLIENTS):
    train, ev = pkg.train_eval_split(pkg.mnist_like(0, 96), 32)
    return pkg.uniform_partition(0, train, n), ev


def _async_sched(pkg, engine):
    return pkg.AsyncBuffered(
        buffer_k=2,
        latency=pkg.LatencyModel(base=1.0, jitter=0.3, straggler_frac=0.3,
                                 seed=5),
        engine=engine)


def _sched(pkg, kind, soa):
    if kind == "async":
        return _async_sched(pkg, "vector" if soa else "heap")
    return pkg.SampledSync(cohort=3)


def _mk(pkg, kind, soa, n_rounds=4, engine=None, compress=True):
    d, ev = _data(jpipe if pkg is J else tpipe)
    cfg = pkg.FLConfig(n_rounds=n_rounds, local_epochs=1,
                       error_feedback=True, seed=3)
    sched = (_async_sched(pkg, engine) if engine is not None
             else _sched(pkg, kind, soa))
    comps = ([pkg.QuantizeCompressor(bits=8) for _ in range(N_CLIENTS)]
             if compress else None)
    if pkg is J:
        return J.FederatedRun(J_MLP, d, cfg, eval_data=ev, scheduler=sched,
                              compressors=comps, soa_state=soa)
    return T.FederatedRun(_JaxInitTask(MNIST_CLASSIFIER, 3), d, cfg,
                          eval_data=ev, scheduler=sched, compressors=comps,
                          soa_state=soa, device="cpu")


def _records_equal(a, b, exact_metrics=True):
    for k in ("participants", "staleness", "bytes_up", "bytes_up_raw",
              "bytes_down", "bytes_decoder", "sim_time"):
        assert getattr(a, k) == getattr(b, k), k
    if exact_metrics:
        assert a.global_metrics == b.global_metrics
    else:
        for k in b.global_metrics:
            np.testing.assert_allclose(a.global_metrics[k],
                                       b.global_metrics[k], **BAND)


def _tflat(tree):
    return ravel(tree)[0]


def _jflat(tree):
    return np.asarray(ravel_pytree(tree)[0])


# =====================================================================
# view semantics
# =====================================================================
def test_ring_view_list_discipline():
    """append + ``del v[:-k]`` against a plain list and the reference's
    ring, through wraparound; ``del v[:]`` empties it."""
    store, jstore = RingStore(2, depth=3), jsoa.RingStore(2, depth=3)
    view, jview, oracle = RingView(store, 1), jsoa.RingView(jstore, 1), []
    for i in range(7):
        row = np.full(4, float(i), np.float32)
        view.append(torch.from_numpy(row))
        jview.append(jnp.asarray(row))
        oracle.append(row)
        del oracle[:-3]
        assert len(view) == len(oracle) == len(jview)
        for j in range(len(oracle)):
            np.testing.assert_array_equal(view[j].numpy(), oracle[j])
            np.testing.assert_array_equal(view[j].numpy(),
                                          np.asarray(jview[j]))
        np.testing.assert_array_equal(view[-1].numpy(), oracle[-1])
        assert np.array_equal(store.cursor, jstore.cursor)
        assert np.array_equal(store.count, jstore.count)
    np.testing.assert_array_equal(torch.stack(list(view)).numpy(),
                                  np.stack(oracle))
    del view[:2]                       # drop the oldest two
    del jview[:2]
    assert len(view) == len(jview) == 1
    np.testing.assert_array_equal(view[0].numpy(), oracle[-1])
    del view[:]
    assert len(view) == 0 and not view


def test_ring_append_rows_and_empty_ring():
    """The cohort-wide append equals the reference's (one scatter at each
    client's cursor, wrapping at the depth); an absent partition lane's
    empty ring refuses writes."""
    store, jstore = RingStore(4, depth=2), jsoa.RingStore(4, depth=2)
    rng = np.random.RandomState(0)
    for cis in ([0, 2], [2, 3], [0, 2, 3], [1]):
        rows = rng.randn(len(cis), 5).astype(np.float32)
        store.append_rows(cis, torch.from_numpy(rows))
        jstore.append_rows(cis, jnp.asarray(rows))
        assert np.array_equal(store.cursor, jstore.cursor)
        assert np.array_equal(store.count, jstore.count)
        np.testing.assert_array_equal(store.buf.numpy(),
                                      np.asarray(jstore.buf))
    for ci in range(4):
        for a, b in zip(store.rows(ci), jstore.rows(ci), strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    empty = _EmptyRing()
    assert len(empty) == 0 and not empty and list(empty) == []
    with pytest.raises(KeyError, match="absent partition ring"):
        empty.append(torch.ones(2))
    with pytest.raises(IndexError):
        empty[0]


def test_client_view_scalars_and_part_dicts():
    pool, jpool = ClientPool(3, TMPL, ring_depth=4), \
        jsoa.ClientPool(3, P0, ring_depth=4)
    for v in (pool[2], jpool[2]):
        assert v.residual is None and v.ae_baseline is None
        assert v.last_refresh == -1 and v.version == 0
    v = pool[2]
    v.residual = TMPL
    assert torch.equal(_tflat(v.residual), _tflat(TMPL))
    v.residual = None
    assert v.residual is None
    v.ae_baseline = 0.25
    v.version, v.last_refresh = 7, 3
    assert (v.ae_baseline, v.version, v.last_refresh) == (0.25, 7, 3)
    jv = jpool[2]
    for view, ones in ((v, torch.ones(6)), (jv, jnp.ones(6))):
        view.part_snapshots.setdefault("dense0", []).append(ones)
        view.part_last_refresh["dense0"] = 5
        view.part_baseline["dense0"] = None
    for view in (v, jv):
        assert len(view.part_snapshots["dense0"]) == 1
        assert view.part_snapshots.get("missing", []) == []
        assert "dense0" in view.part_snapshots
        assert "missing" not in view.part_snapshots
        assert view.part_last_refresh.get("dense0", -1) == 5
        assert view.part_last_refresh.get("other", -1) == -1
        assert view.part_baseline.get("dense0") is None
        assert view.part_baseline.items() == []
    assert pool[0].part_snapshots.get("dense0") is None
    assert jpool[0].part_snapshots.get("dense0") is None
    v.part_baseline["dense0"] = 0.5
    assert v.part_baseline["dense0"] == 0.5
    assert v.part_snapshots.keys() == jv.part_snapshots.keys() == ["dense0"]
    assert len(pool) == 3 and len(list(pool)) == 3


def test_gather_scatter_residual_rows():
    pool, jpool = ClientPool(4, TMPL, ring_depth=2), \
        jsoa.ClientPool(4, P0, ring_depth=2)
    rows = np.stack([np.full(pool.psize, float(i), np.float32)
                     for i in (1, 3)])
    pool.scatter_residuals([1, 3], torch.from_numpy(rows))
    jpool.scatter_residuals([1, 3], jnp.asarray(rows))
    got, mask = pool.gather_residuals([0, 1, 3])
    jgot, jmask = jpool.gather_residuals([0, 1, 3])
    assert list(mask) == list(jmask) == [False, True, True]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    flat = _tflat(pool[3].residual).numpy()
    assert set(np.unique(flat)) == {3.0}
    with pytest.raises(AssertionError, match="duplicate"):
        pool.scatter_residuals([2, 2], torch.from_numpy(rows))


# =====================================================================
# differential: SoA + vector engine ≡ eager + heap
# =====================================================================
@pytest.mark.parametrize("sched", ["async", "sampled"])
def test_soa_vector_matches_eager_heap(sched):
    eager = _mk(T, sched, False)
    hist_e = eager.run()
    pooled = _mk(T, sched, True)
    hist_p = pooled.run()
    assert isinstance(pooled.clients, ClientPool)
    for a, b in zip(hist_e, hist_p, strict=True):
        _records_equal(a, b)
    assert torch.equal(_tflat(eager.global_params),
                       _tflat(pooled.global_params))
    for ce, cp in zip(eager.clients, pooled.clients, strict=True):
        if ce.residual is None:
            assert cp.residual is None
        else:
            assert torch.equal(_tflat(ce.residual), _tflat(cp.residual))
    ref = _mk(J, sched, True)
    hist_j = ref.run()
    for a, j in zip(hist_p, hist_j, strict=True):
        _records_equal(a, j, exact_metrics=False)
    np.testing.assert_allclose(_tflat(pooled.global_params).numpy(),
                               _jflat(ref.global_params), **BAND)


# =====================================================================
# checkpoints
# =====================================================================
@pytest.mark.parametrize("save_engine,load_engine",
                         [("vector", "vector"), ("heap", "vector"),
                          ("vector", "heap")])
def test_soa_resume_and_engine_cross_restore(save_engine, load_engine,
                                             tmp_path):
    full = _mk(T, "async", True, 4, engine=save_engine, compress=False)
    hist_full = full.run()
    first = _mk(T, "async", True, 2, engine=save_engine, compress=False)
    first.run()
    path = os.path.join(tmp_path, "ckpt.npz")
    first.save_state(path)
    resumed = _mk(T, "async", True, 2, engine=load_engine, compress=False)
    assert resumed.load_state(path) == 2
    assert isinstance(resumed.clients, ClientPool)
    hist_resumed = resumed.run()
    for a, b in zip(hist_full[2:], hist_resumed, strict=True):
        _records_equal(a, b)
    assert torch.equal(_tflat(full.global_params),
                       _tflat(resumed.global_params))


def _fill(pool, mk_row, tmpl):
    for i in range(5):                       # wraps the depth-3 ring
        pool[1].snapshots.append(mk_row(np.full(4, float(i), np.float32)))
    pool[1].residual = tmpl
    pool[2].dispatched = tmpl
    pool[0].part_snapshots.setdefault("g", []).append(
        mk_row(np.ones(2, np.float32)))
    pool[0].part_last_refresh["g"] = 4
    pool[0].part_baseline["g"] = 0.125
    pool[2].ae_baseline = None
    pool[1].ae_baseline = 0.3
    pool[1].version = 9


def test_pool_state_round_trip_preserves_rings_and_scalars():
    """``state()`` equals the reference's tree and metadata key for key,
    and ``from_state`` restores the rings (depth-capped, newest kept),
    residual, dispatched snapshot and scalars."""
    pool, jpool = ClientPool(3, TMPL, ring_depth=3), \
        jsoa.ClientPool(3, P0, ring_depth=3)
    _fill(pool, torch.from_numpy, TMPL)
    _fill(jpool, jnp.asarray, jax.tree_util.tree_map(jnp.asarray, P0))
    tree, meta = pool.state()
    jtree, jmeta = jpool.state()
    assert meta == jmeta
    from repro.checkpoint.checkpoint import _flatten
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    t_items = _flatten_with_paths(tree)
    j_items = list(_flatten(jtree).items())
    assert [k for k, _ in t_items] == [k for k, _ in j_items]
    for (_, t), (_, j) in zip(t_items, j_items, strict=True):
        assert str(t.dtype).replace("torch.", "") == str(np.asarray(j).dtype)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    clone = ClientPool.from_state(tree, meta, TMPL)
    assert len(clone[1].snapshots) == 3
    np.testing.assert_array_equal(clone[1].snapshots[-1].numpy(),
                                  np.full(4, 4.0))
    np.testing.assert_array_equal(clone[1].snapshots[0].numpy(),
                                  np.full(4, 2.0))
    assert torch.equal(_tflat(clone[1].residual), _tflat(TMPL))
    assert torch.equal(_tflat(clone[2].dispatched), _tflat(TMPL))
    assert clone[0].part_last_refresh["g"] == 4
    assert clone[0].part_baseline["g"] == 0.125
    assert clone[2].ae_baseline is None and clone[1].ae_baseline == 0.3
    assert clone[1].version == 9
    assert clone[0].residual is None and clone[0].dispatched is None


def _soa_ckpt_run(pkg, n_rounds, lifecycle=False):
    """3 clients, q8 + error feedback, SampledSync(2), an SoA pool; with
    ``lifecycle`` a chunked-AE client set and an ``AELifecycle`` so the
    snapshot rings ride the checkpoint."""
    train, ev = (jpipe if pkg is J else tpipe).train_eval_split(
        (jpipe if pkg is J else tpipe).mnist_like(0, 128), 32)
    d = (jpipe if pkg is J else tpipe).uniform_partition(0, train, 3)
    cfg = pkg.FLConfig(n_rounds=n_rounds, local_epochs=1, batch_size=16,
                       payload="update", error_feedback=True)
    kw = {}
    if lifecycle:
        ch = dict(chunk_size=256, hidden=(32,), latent_chunk=8)
        pj = J.init_chunked_ae(jax.random.PRNGKey(7), J.ChunkedAEConfig(**ch))
        pj = dict(pj, norm={"mean": jnp.float32(0.0),
                            "std": jnp.float32(1e-3)})
        prm = (pj if pkg is J else from_jax_params(
            jax.tree_util.tree_map(np.array, pj), "cpu"))
        comps = [pkg.ChunkedAECompressor(prm, pkg.ChunkedAEConfig(**ch),
                                         False) for _ in range(3)]
        kw["lifecycle"] = pkg.AELifecycle(refresh_every=None,
                                          min_snapshots=1, buffer_size=2)
    else:
        comps = [pkg.QuantizeCompressor(bits=8) for _ in range(3)]
    sched = pkg.SampledSync(cohort=2)
    if pkg is J:
        return J.FederatedRun(J_MLP, d, cfg, compressors=comps, eval_data=ev,
                              scheduler=sched, soa_state=True, **kw)
    return T.FederatedRun(_JaxInitTask(MNIST_CLASSIFIER, 0), d, cfg,
                          compressors=comps, eval_data=ev, scheduler=sched,
                          soa_state=True, device="cpu", **kw)


@pytest.mark.parametrize("lifecycle", [False, True])
def test_soa_checkpoint_interchange_with_jax(lifecycle, tmp_path):
    """A JAX SoA checkpoint resumes in the port, and a port SoA checkpoint
    in the JAX package, each next round matching the other package's."""
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    for pkg, path in ((J, pj), (T, pt)):
        run = _soa_ckpt_run(pkg, 2, lifecycle)
        run.run()
        run.save_state(path)
    with np.load(pj) as dj, np.load(pt) as dt:
        assert dj.files == dt.files
    for path in (pj, pt):
        res_j = _soa_ckpt_run(J, 1, lifecycle)
        assert res_j.load_state(path) == 2
        res_j.run()
        res_t = _soa_ckpt_run(T, 1, lifecycle)
        assert res_t.load_state(path) == 2
        assert isinstance(res_t.clients, ClientPool)
        res_t.run()
        _records_equal(res_t.history[0], res_j.history[0],
                       exact_metrics=False)
        np.testing.assert_allclose(_tflat(res_t.global_params).numpy(),
                                   _jflat(res_j.global_params), **BAND)
        for ct, cj in zip(res_t.clients, res_j.clients, strict=True):
            assert (ct.residual is None) == (cj.residual is None)
            if ct.residual is not None:
                np.testing.assert_allclose(_tflat(ct.residual).numpy(),
                                           _jflat(cj.residual), **BAND)
            assert len(ct.snapshots) == len(cj.snapshots)
            assert (ct.version, ct.last_refresh) == \
                (cj.version, cj.last_refresh)
        if lifecycle:
            assert any(len(c.snapshots) for c in res_t.clients)


# =====================================================================
# the dispatch broadcast-bytes cache
# =====================================================================
def test_dispatch_broadcast_bytes_cached_per_version(monkeypatch):
    """``tree_bytes(global_params)`` once a model version, not once a
    client a dispatch; byte totals equal an uninstrumented run's and the
    reference's."""
    def mk():
        d, ev = _data(tpipe)
        cfg = T.FLConfig(n_rounds=3, local_epochs=1, seed=3)
        return T.FederatedRun(_JaxInitTask(MNIST_CLASSIFIER, 3), d, cfg,
                              eval_data=ev,
                              scheduler=_async_sched(T, "heap"),
                              device="cpu")

    calls = {"n": 0}
    real = scheduler_mod.tree_bytes

    def counting(tree):
        calls["n"] += 1
        return real(tree)

    monkeypatch.setattr(scheduler_mod, "tree_bytes", counting)
    run = mk()
    reset_calls = calls["n"]
    hist = run.run()
    monkeypatch.setattr(scheduler_mod, "tree_bytes", real)
    assert reset_calls == 1
    assert calls["n"] - reset_calls <= 2 * len(hist)
    ref = mk()
    jd, jev = _data(jpipe)
    jref = J.FederatedRun(J_MLP, jd, J.FLConfig(n_rounds=3, local_epochs=1,
                                                seed=3),
                          eval_data=jev, scheduler=_async_sched(J, "heap"))
    for a, b, j in zip(hist, ref.run(), jref.run(), strict=True):
        for k in ("bytes_down", "bytes_down_raw", "bytes_up"):
            assert getattr(a, k) == getattr(b, k) == getattr(j, k), k
    assert leaves(run.global_params)[0].dtype == torch.float32
