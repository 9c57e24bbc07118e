"""The port's checkpoints (``checkpoint/checkpoint.py``,
``FederatedRun.save_state``/``load_state``) against a live JAX run:

* tree round trips for float32, bfloat16, int8 and uint8 leaves, with npz
  keys and dtype tags equal to the reference's on the same tree;
* interchange: a checkpoint the JAX package saves of a 3-client q8 + error
  feedback MLP run loads in the port, whose next round matches the JAX
  run's next round, and the reverse;
* the resume matrix (modelled on ``tests/test_resume_matrix.py``):
  ``SyncFedAvg``, ``SampledSync`` and ``AsyncBuffered`` (heap and vector
  engines) × flat and partitioned codecs, with an AE lifecycle attached;
  and its controller rows, the three schedulers × ``DistortionTarget`` /
  ``ByteBudget`` / ``RDBudget`` × flat and per-partition ladders at the
  reference's own ladders and settings: the resumed run ``torch.equal`` to
  the uninterrupted one, its bytes and switches equal to the reference's
  resumed run;
* controller checkpoints interchange: one the JAX package saves resumes in
  the port to the reference's own resumed trajectory, and the reverse,
  flat (an FC-AE ladder) and per-partition (a shared chunked-AE rung);
  after a load, clients that shared one AE params object share it again;
* an async checkpoint restored into the other engine;
* refusals: a checkpoint of another task, an SoA checkpoint of another
  population; struct-of-arrays checkpoints interchange both ways.

Bytes exact; floats in the golden band ``atol=2e-5, rtol=2e-4``.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro import core as J  # noqa: E402
from repro.checkpoint import checkpoint as jck  # noqa: E402
from repro.configs.paper import MNIST_CLASSIFIER as J_MLP  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.classifiers import init_classifier  # noqa: E402

from repro_torch import core as T  # noqa: E402
from repro_torch.checkpoint import checkpoint as tck  # noqa: E402
from repro_torch.configs.paper import AEConfig as TAEConfig  # noqa: E402
from repro_torch.configs.paper import ClassifierConfig  # noqa: E402
from repro_torch.configs.paper import MNIST_CLASSIFIER  # noqa: E402
from repro_torch.core.pytree import from_jax_params, leaves, ravel  # noqa: E402
from repro_torch.core.task import ClassifierTask  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)
N_CLIENTS = 3
CH = dict(chunk_size=256, hidden=(32,), latent_chunk=8)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


class _JaxInitTask(ClassifierTask):
    """The port's classifier task started from the JAX package's params
    (its checkpoint key is the classifier's, as the reference's is)."""

    def __init__(self, clf_cfg, params_np):
        super().__init__(clf_cfg)
        self.params_np = params_np

    def init_params(self, gen, device):
        return from_jax_params(self.params_np, device)


P0 = _np(init_classifier(jax.random.PRNGKey(0), J_MLP))


def _data(pkg):
    train, ev = pkg.train_eval_split(pkg.mnist_like(0, 128), 32)
    return pkg.uniform_partition(0, train, N_CLIENTS), ev


def _npz(path):
    with np.load(path) as d:
        return ({k: d[k] for k in d.files if not k.startswith("__")},
                json.loads(bytes(d["__dtypes__"]).decode()),
                json.loads(bytes(d["__meta__"]).decode())
                if "__meta__" in d.files else None)


# ------------------------------------------------------------ pytrees
def test_pytree_round_trip_and_keys_equal_reference(tmp_path):
    rng = np.random.RandomState(0)
    tree_np = {
        "b": {"w": rng.randn(3, 4).astype(np.float32),
              "codes": rng.randint(0, 255, (7,)).astype(np.uint8)},
        "a": [rng.randint(-127, 127, (2, 5)).astype(np.int8),
              {"z": rng.randn(6).astype(np.float32)}, None],
        "t": (rng.randn(4).astype(np.float32),
              {"s": np.float32(1.5)}),
    }
    bf = rng.randn(9).astype(np.float32)
    tree_t = from_jax_params(tree_np, "cpu")
    tree_t["h"] = torch.from_numpy(bf).to(torch.bfloat16)
    tree_j = jax.tree_util.tree_map(jnp.asarray, tree_np)
    tree_j["h"] = jnp.asarray(bf).astype(jnp.bfloat16)

    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tck.save_pytree(pt, tree_t, metadata={"round": 3})
    jck.save_pytree(pj, tree_j, metadata={"round": 3})
    at, dt_, mt = _npz(pt)
    aj, dj, mj = _npz(pj)
    assert list(at) == list(aj) == list(jck._flatten(tree_j))
    assert dt_ == dj and mt == mj
    for k in aj:
        assert at[k].dtype == aj[k].dtype
        np.testing.assert_array_equal(at[k], aj[k])

    back, meta = tck.load_pytree(pj, tree_t)
    assert meta == {"round": 3}
    for a, b in zip(leaves(back), leaves(tree_t), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    back_j, _ = jck.load_pytree(pt, tree_j)
    for a, b in zip(jax.tree_util.tree_leaves(back_j),
                    jax.tree_util.tree_leaves(tree_j), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


# ------------------------------------------------------------ interchange
def _q8_cfg(n_rounds):
    return dict(n_rounds=n_rounds, local_epochs=1, batch_size=16,
                payload="update", error_feedback=True)


def _jax_q8(n_rounds):
    d, ev = _data(jpipe)
    return J.FederatedRun(J_MLP, d, J.FLConfig(**_q8_cfg(n_rounds)),
                          compressors=[J.QuantizeCompressor(bits=8)
                                       for _ in range(N_CLIENTS)],
                          eval_data=ev)


def _torch_q8(n_rounds):
    d, ev = _data(tpipe)
    return T.FederatedRun(_JaxInitTask(MNIST_CLASSIFIER, P0), d,
                          T.FLConfig(**_q8_cfg(n_rounds)),
                          compressors=[T.QuantizeCompressor(bits=8)
                                       for _ in range(N_CLIENTS)],
                          eval_data=ev, device="cpu")


def _same_round(rj, rt):
    a, b = rj.history[-1], rt.history[-1]
    assert b.round == a.round
    for k in ("bytes_up", "bytes_up_raw", "bytes_up_measured",
              "bytes_down", "bytes_decoder", "ae_syncs", "participants"):
        assert getattr(b, k) == getattr(a, k), k
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(b.global_metrics[k],
                                   a.global_metrics[k], **BAND)
    np.testing.assert_allclose(ravel(rt.global_params)[0].numpy(),
                               np.asarray(ravel_pytree(rj.global_params)[0]),
                               **BAND)
    for sj, st in zip(rj.clients, rt.clients, strict=True):
        np.testing.assert_allclose(
            ravel(st.residual)[0].numpy(),
            np.asarray(ravel_pytree(sj.residual)[0]), **BAND)


def test_jax_checkpoint_resumes_in_port_and_reverse(tmp_path):
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    first_j = _jax_q8(1)
    first_j.run()
    first_j.save_state(pj)
    first_t = _torch_q8(1)
    first_t.run()
    first_t.save_state(pt)
    # one file layout: the same keys, dtype tags and metadata keys
    aj, dj, mj = _npz(pj)
    at, dt_, mt = _npz(pt)
    assert list(at) == list(aj) and dt_ == dj
    assert mt.keys() == mj.keys() and mt["task"] == mj["task"]
    assert [c.keys() for c in mt["clients"]] == \
        [c.keys() for c in mj["clients"]]

    # JAX → port: the port continues the JAX run's round 1
    res_j = _jax_q8(1)
    assert res_j.load_state(pj) == 1
    res_j.run()
    res_t = _torch_q8(1)
    assert res_t.load_state(pj) == 1
    res_t.run()
    _same_round(res_j, res_t)

    # port → JAX: the JAX package continues the port's round 1
    rev_j = _jax_q8(1)
    assert rev_j.load_state(pt) == 1
    rev_j.run()
    rev_t = _torch_q8(1)
    assert rev_t.load_state(pt) == 1
    rev_t.run()
    _same_round(rev_j, rev_t)


# ------------------------------------------------------------ matrix
def _ae_pair():
    pj = J.init_chunked_ae(jax.random.PRNGKey(7), J.ChunkedAEConfig(**CH))
    pj = dict(pj, norm={"mean": jnp.float32(0.0), "std": jnp.float32(1e-3)})
    return pj, from_jax_params(_np(pj), "cpu")


def _compressors(pkg, layout, ae_params):
    cfg = pkg.ChunkedAEConfig(**CH)
    if layout == "partitioned":
        tmpl = (init_classifier(jax.random.PRNGKey(0), J_MLP) if pkg is J
                else from_jax_params(P0, "cpu"))
        pm = pkg.by_layer_partition(tmpl)
        return [pkg.PartitionedCompressor(pm, {
            "dense0": pkg.ChunkedAECompressor(ae_params, cfg, False),
            "dense1": pkg.QuantizeCompressor(bits=8)})
            for _ in range(N_CLIENTS)]
    return [pkg.ChunkedAECompressor(ae_params, cfg, False)
            for _ in range(N_CLIENTS)]


def _scheduler(pkg, kind):
    if kind == "sync":
        return None
    if kind == "sampled":
        return pkg.SampledSync(cohort=2)
    return pkg.AsyncBuffered(buffer_k=2, latency=pkg.LatencyModel(jitter=0.3),
                             engine="vector" if kind == "async-vector"
                             else "heap")


def _mk(pkg, sched, layout, n_rounds, engine=None):
    cfg = dict(n_rounds=n_rounds, local_epochs=1, batch_size=16,
               payload="update", error_feedback=True)
    lc = dict(refresh_every=1, min_snapshots=1, buffer_size=2,
              refresh_epochs=1)
    pj, pt = _ae_pair()
    d, ev = _data(jpipe if pkg is J else tpipe)
    if engine is not None:
        sched = "async-vector" if engine == "vector" else "async"
    if pkg is J:
        return J.FederatedRun(J_MLP, d, J.FLConfig(**cfg),
                              compressors=_compressors(J, layout, pj),
                              eval_data=ev, scheduler=_scheduler(J, sched),
                              lifecycle=J.AELifecycle(**lc))
    return T.FederatedRun(_JaxInitTask(MNIST_CLASSIFIER, P0), d,
                          T.FLConfig(**cfg),
                          compressors=_compressors(T, layout, pt),
                          eval_data=ev, scheduler=_scheduler(T, sched),
                          lifecycle=T.AELifecycle(**lc), device="cpu")


def _records_equal(a, b, exact_metrics=True):
    assert b.round == a.round
    for k in ("bytes_up", "bytes_up_raw", "bytes_up_measured",
              "bytes_down", "bytes_down_raw", "bytes_decoder", "ae_syncs",
              "participants", "staleness", "sim_time"):
        assert getattr(b, k) == getattr(a, k), k
    if exact_metrics:
        assert b.global_metrics == a.global_metrics


def _states_equal(sa, sb):
    for a, b in zip(sa, sb, strict=True):
        assert (a.version, a.last_refresh, a.ae_baseline,
                a.part_last_refresh, a.part_baseline) == \
            (b.version, b.last_refresh, b.ae_baseline, b.part_last_refresh,
             b.part_baseline)
        for x, y in zip(leaves([a.residual, a.dispatched, a.snapshots,
                                a.part_snapshots]),
                        leaves([b.residual, b.dispatched, b.snapshots,
                                b.part_snapshots]), strict=True):
            assert torch.equal(x, y)


@pytest.mark.parametrize("layout", ["flat", "partitioned"])
@pytest.mark.parametrize("sched", ["sync", "sampled", "async",
                                   "async-vector"])
def test_resume_matrix_with_lifecycle(sched, layout, tmp_path):
    """3 rounds uninterrupted against 2 rounds, save, load into a fresh
    run, 1 more round (round 0 ships the decoders, rounds 1 and 2 refit):
    parameters, client state and codec params ``torch.equal``, records
    equal; the bytes equal the reference's own resumed run."""
    full = _mk(T, sched, layout, 3)
    full.run()
    first = _mk(T, sched, layout, 2)
    first.run()
    path = str(tmp_path / "ckpt.npz")
    first.save_state(path)
    resumed = _mk(T, sched, layout, 1)
    assert resumed.load_state(path) == 2
    hist = resumed.run()
    assert torch.equal(ravel(full.global_params)[0],
                       ravel(resumed.global_params)[0])
    _records_equal(full.history[2], hist[0])
    _states_equal(full.clients, resumed.clients)
    for a, b in zip(full.compressors, resumed.compressors, strict=True):
        for x, y in zip(leaves(a.codec_params()), leaves(b.codec_params()),
                        strict=True):
            assert torch.equal(x, y)
    assert full.history[2].ae_syncs, "round 2 refit nothing"

    ref_first = _mk(J, sched, layout, 2)
    ref_first.run()
    ref_path = str(tmp_path / "ref.npz")
    ref_first.save_state(ref_path)
    ref = _mk(J, sched, layout, 1)
    ref.load_state(ref_path)
    ref.run()
    _records_equal(ref.history[0], hist[0], exact_metrics=False)


@pytest.mark.parametrize("saver,loader", [("heap", "vector"),
                                          ("vector", "heap")])
def test_async_checkpoint_restores_into_the_other_engine(saver, loader,
                                                         tmp_path):
    full = _mk(T, None, "flat", 3, engine=loader)
    full.run()
    first = _mk(T, None, "flat", 2, engine=saver)
    first.run()
    path = str(tmp_path / "ckpt.npz")
    first.save_state(path)
    resumed = _mk(T, None, "flat", 1, engine=loader)
    resumed.load_state(path)
    hist = resumed.run()
    assert torch.equal(ravel(full.global_params)[0],
                       ravel(resumed.global_params)[0])
    _records_equal(full.history[2], hist[0])
    _states_equal(full.clients, resumed.clients)


# ------------------------------------------------------------ refusals
def test_load_refuses_another_task_and_soa_state(tmp_path):
    """A checkpoint of another task is refused before any state is
    touched; struct-of-arrays client state now interchanges both ways (a
    JAX SoA checkpoint restores a ``ClientPool`` in the port whose state
    equals the reference's pool, and a port SoA checkpoint loads in the
    JAX package), while an SoA checkpoint of another population, and a
    save given both layouts, are refused."""
    path = str(tmp_path / "mlp.npz")
    run = _torch_q8(1)
    run.run()
    run.save_state(path)
    other = ClassifierConfig(name="mnist-mlp-wide", kind="mlp",
                             input_shape=(784,), n_classes=10, hidden=(20,))
    d, ev = _data(tpipe)
    wrong = T.FederatedRun(other, d, T.FLConfig(n_rounds=1), eval_data=ev,
                           device="cpu")
    before = ravel(wrong.global_params)[0].clone()
    with pytest.raises(ValueError, match="task mismatch"):
        wrong.load_state(path)
    assert torch.equal(ravel(wrong.global_params)[0], before)

    with pytest.raises(ValueError, match="not both"):
        tck.save_federated_state(str(tmp_path / "x.npz"), 0,
                                 run.global_params, clients=run.clients,
                                 clients_soa=({}, {}))
    # JAX → port: the restored pool holds the reference's pool state
    soa = str(tmp_path / "soa.npz")
    dj, evj = _data(jpipe)
    jcfg = J.FLConfig(n_rounds=1, batch_size=16, payload="update",
                      error_feedback=True)
    jrun = J.FederatedRun(J_MLP, dj, jcfg, eval_data=evj, soa_state=True,
                          compressors=[J.QuantizeCompressor(bits=8)
                                       for _ in range(N_CLIENTS)])
    jrun.run()
    jrun.save_state(soa)
    into = _torch_q8(1)
    assert into.load_state(soa) == 1
    assert isinstance(into.clients, T.ClientPool)
    jtree, jmeta = jrun.clients.state()
    ttree, tmeta = into.clients.state()
    assert tmeta == jmeta
    np.testing.assert_array_equal(ttree["residuals"].numpy(),
                                  np.asarray(jtree["residuals"]))
    # port → JAX: the reference restores the port's pool
    tsoa = str(tmp_path / "tsoa.npz")
    into.save_state(tsoa)
    back = J.FederatedRun(J_MLP, dj, jcfg, eval_data=evj,
                          compressors=[J.QuantizeCompressor(bits=8)
                                       for _ in range(N_CLIENTS)])
    assert back.load_state(tsoa) == 1
    btree, bmeta = back.clients.state()
    assert bmeta == jmeta
    np.testing.assert_array_equal(np.asarray(btree["residuals"]),
                                  np.asarray(jtree["residuals"]))
    # an SoA checkpoint of another population is refused
    d2, ev2 = tpipe.train_eval_split(tpipe.mnist_like(0, 128), 32)
    two = T.FederatedRun(_JaxInitTask(MNIST_CLASSIFIER, P0),
                         tpipe.uniform_partition(0, d2, 2),
                         T.FLConfig(**_q8_cfg(1)), eval_data=ev2,
                         device="cpu")
    with pytest.raises(ValueError, match="3 clients"):
        two.load_state(soa)


# ------------------------------------------------------------ controllers
def _flat_ladder(pkg):
    return [[pkg.QuantizeCompressor(bits=4), pkg.QuantizeCompressor(bits=8),
             pkg.IdentityCompressor()] for _ in range(N_CLIENTS)]


def _part_pm(pkg):
    return pkg.by_layer_partition(
        init_classifier(jax.random.PRNGKey(0), J_MLP) if pkg is J
        else from_jax_params(P0, "cpu"))


def _part_ladder(pkg):
    pm = _part_pm(pkg)
    rungs = {name: [lambda ci, n: pkg.QuantizeCompressor(bits=4),
                    lambda ci, n: pkg.QuantizeCompressor(bits=8),
                    lambda ci, n: pkg.IdentityCompressor()]
             for name in pm.names}
    return pkg.partition_ladder(N_CLIENTS, pm, rungs), pm


def _controller(pkg, kind, layout):
    """``tests/test_resume_matrix.py``'s controllers, in either package."""
    if layout == "partitioned":
        ladder, pm = _part_ladder(pkg)
    else:
        ladder, pm = _flat_ladder(pkg), None
    if kind == "distortion":
        return pkg.DistortionTarget(ladder=ladder, partition=pm, target=5e-9,
                                    margin=1e-3, min_snapshots=1, cooldown=1)
    cls = pkg.RDBudget if kind == "rd" else pkg.ByteBudget
    return cls(ladder=ladder, partition=pm, budget=float("inf"),
               min_snapshots=1)


def _mk_rc(pkg, sched, kind, layout, n_rounds):
    cfg = dict(n_rounds=n_rounds, local_epochs=1, batch_size=16,
               payload="update")
    d, ev = _data(jpipe if pkg is J else tpipe)
    rc = _controller(pkg, kind, layout)
    if pkg is J:
        return J.FederatedRun(J_MLP, d, J.FLConfig(**cfg), eval_data=ev,
                              scheduler=_scheduler(J, sched), ratecontrol=rc)
    return T.FederatedRun(_JaxInitTask(MNIST_CLASSIFIER, P0), d,
                          T.FLConfig(**cfg), eval_data=ev,
                          scheduler=_scheduler(T, sched), ratecontrol=rc,
                          device="cpu")


def _controllers_equal(a, b):
    assert a.state_meta() == b.state_meta()
    for x, y in zip(leaves(a.state_tree()), leaves(b.state_tree()),
                    strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("layout", ["flat", "partitioned"])
@pytest.mark.parametrize("rc", ["distortion", "bytebudget", "rd"])
@pytest.mark.parametrize("sched", ["sync", "sampled", "async"])
def test_resume_matrix_with_controller(sched, rc, layout, tmp_path):
    """2 rounds uninterrupted against 1 round, save, load into a fresh run,
    1 more round: parameters, client state and the controller's state
    ``torch.equal``, records equal (switches included); the records equal
    the reference's own resumed run, bytes exact."""
    full = _mk_rc(T, sched, rc, layout, 2)
    full.run()
    first = _mk_rc(T, sched, rc, layout, 1)
    first.run()
    path = str(tmp_path / "ckpt.npz")
    first.save_state(path)
    resumed = _mk_rc(T, sched, rc, layout, 1)
    assert resumed.load_state(path) == 1
    hist = resumed.run()
    assert torch.equal(ravel(full.global_params)[0],
                       ravel(resumed.global_params)[0])
    _records_equal(full.history[1], hist[0])
    assert hist[0].spec_switches == full.history[1].spec_switches
    _states_equal(full.clients, resumed.clients)
    _controllers_equal(full.ratecontrol, resumed.ratecontrol)
    assert any(r.spec_switches for r in full.history), "nothing switched"

    ref_first = _mk_rc(J, sched, rc, layout, 1)
    ref_first.run()
    ref_path = str(tmp_path / "ref.npz")
    ref_first.save_state(ref_path)
    ref = _mk_rc(J, sched, rc, layout, 1)
    ref.load_state(ref_path)
    ref.run()
    _records_equal(ref.history[0], hist[0], exact_metrics=False)
    assert hist[0].spec_switches == ref.history[0].spec_switches
    assert hist[0].controller == ref.history[0].controller


def _interchange_run(pkg, layout, n_rounds, ladders):
    """Flat: a fresh-init FC-AE ladder (the reference's params) under
    ``DistortionTarget``; per-partition: dense0 on a chunked AE shared by
    every client, then q8; dense1 on q4, q8. Refits at 0 epochs, so both
    packages' trajectories can be compared."""
    cfg = dict(n_rounds=n_rounds, local_epochs=1, batch_size=16,
               payload="weights" if layout == "flat" else "update")
    d, ev = _data(jpipe if pkg is J else tpipe)
    lj, lt = ladders
    kw = dict(min_snapshots=1, refit_epochs=0, refit_batch=2)
    if layout == "flat":
        rc = pkg.DistortionTarget(ladder=lj if pkg is J else lt,
                                  target=1e-12, **kw)
    else:
        rc = pkg.RDBudget(ladder=lj if pkg is J else lt,
                          partition=_part_pm(pkg), budget=float("inf"), **kw)
    if pkg is J:
        return J.FederatedRun(J_MLP, d, J.FLConfig(**cfg), eval_data=ev,
                              ratecontrol=rc)
    return T.FederatedRun(_JaxInitTask(MNIST_CLASSIFIER, P0), d,
                          T.FLConfig(**cfg), eval_data=ev, ratecontrol=rc,
                          device="cpu")


def _interchange_ladders(layout):
    """A fresh pair of ladders (the JAX one and its port copy)."""
    if layout == "flat":
        lj = J.fc_ae_ladder(N_CLIENTS, 15_910, latent_dims=(8, 32),
                            hidden=(16,))
        lt = [[T.FCAECompressor(from_jax_params(_np(c.params), "cpu"),
                                TAEConfig(input_dim=15_910,
                                          encoder_hidden=(16,),
                                          latent_dim=c.cfg.latent_dim))
               for c in row] for row in lj]
        return lj, lt
    pj, pt = _ae_pair()
    cj, ct = J.ChunkedAEConfig(**CH), T.ChunkedAEConfig(**CH)

    def ladder(pkg, params, cfg):
        pm = _part_pm(pkg)

        def ae(ci, n):
            comp = pkg.ChunkedAECompressor(params, cfg, False)
            comp.prefit = True
            return comp
        return pkg.partition_ladder(N_CLIENTS, pm, {
            "dense0": [ae, lambda ci, n: pkg.QuantizeCompressor(bits=8)],
            "dense1": [lambda ci, n: pkg.QuantizeCompressor(bits=4),
                       lambda ci, n: pkg.QuantizeCompressor(bits=8)]})
    return ladder(J, pj, cj), ladder(T, pt, ct)


@pytest.mark.parametrize("layout", ["flat", "partitioned"])
def test_controller_checkpoint_interchange(layout, tmp_path):
    """A JAX controller checkpoint after round 0 resumes in the port to the
    reference's own resumed round 1, and the reverse: one file layout
    (keys, dtype tags, metadata), switches and bytes exact, loss and
    parameters in the golden band; the port's restored controller state
    equals the saver's."""
    saved = {}
    for pkg in (J, T):
        first = _interchange_run(pkg, layout, 1, _interchange_ladders(layout))
        first.run()
        saved[pkg] = str(tmp_path / f"{pkg.__name__}.npz")
        first.save_state(saved[pkg])
        if pkg is J:
            meta_j = first.ratecontrol.state_meta()
        assert any(first.history[0].spec_switches), "nothing switched"
    aj, dj, mj = _npz(saved[J])
    at, dt_, mt = _npz(saved[T])
    assert list(at) == list(aj) and dt_ == dj and mt.keys() == mj.keys()
    assert mt["ratecontrol"].keys() == mj["ratecontrol"].keys()
    assert mt["ratecontrol"]["rung"] == mj["ratecontrol"]["rung"]
    assert mt["ratecontrol"]["fitted"] == mj["ratecontrol"]["fitted"]
    assert any(k.startswith("ratecontrol/") for k in at)
    for path in saved.values():
        res = {}
        for pkg in (J, T):
            run = _interchange_run(pkg, layout, 1,
                                   _interchange_ladders(layout))
            assert run.load_state(path) == 1
            run.run()
            res[pkg] = run
        rj, rt = res[J], res[T]
        _records_equal(rj.history[0], rt.history[0], exact_metrics=False)
        assert rt.history[0].spec_switches == rj.history[0].spec_switches
        np.testing.assert_allclose(rt.history[0].global_metrics["loss"],
                                   rj.history[0].global_metrics["loss"],
                                   **BAND)
        np.testing.assert_allclose(
            ravel(rt.global_params)[0].numpy(),
            np.asarray(ravel_pytree(rj.global_params)[0]), **BAND)
        if path == saved[J]:
            loaded = _interchange_run(T, layout, 1,
                                      _interchange_ladders(layout))
            loaded.load_state(path)
            assert loaded.ratecontrol.state_meta() == meta_j


def test_load_restores_shared_ae_params():
    """Clients that shared one AE params object before the save share one
    after the load (their restored values are equal), so the server's
    shared-decoder route is taken after a resume as before it; a rung that
    a refit gave its own params keeps them."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.npz")
        first = _interchange_run(T, "partitioned", 1,
                                 _interchange_ladders("partitioned"))
        first.run()
        first.save_state(path)
        res = _interchange_run(T, "partitioned", 1,
                               _interchange_ladders("partitioned"))
        res.load_state(path)
    rungs = [res.ratecontrol._pcomps[ci]["dense0"][0].codec_params()
             for ci in range(N_CLIENTS)]
    assert all(p is rungs[0] for p in rungs)
    before = [first.ratecontrol._pcomps[ci]["dense0"][0].codec_params()
              for ci in range(N_CLIENTS)]
    assert all(p is before[0] for p in before)


def _shared_ae_run(pkg, n_rounds):
    """dense0 on one chunked AE shared by every client (kernel path in the
    port), dense1 on q8, ``FixedRate`` holding every lane there."""
    pj, pt = _ae_pair()
    cfg = pkg.ChunkedAEConfig(**CH)
    params = pj if pkg is J else pt

    def ae(ci, n):
        comp = pkg.ChunkedAECompressor(params, cfg, pkg is T)
        comp.prefit = True
        return comp
    pm = _part_pm(pkg)
    rc = pkg.FixedRate(ladder=pkg.partition_ladder(N_CLIENTS, pm, {
        "dense0": [ae],
        "dense1": [lambda ci, n: pkg.QuantizeCompressor(bits=8)]}),
        partition=pm)
    cfg_fl = dict(n_rounds=n_rounds, local_epochs=1, batch_size=16,
                  payload="update")
    d, ev = _data(jpipe if pkg is J else tpipe)
    if pkg is J:
        return J.FederatedRun(J_MLP, d, J.FLConfig(**cfg_fl), eval_data=ev,
                              ratecontrol=rc)
    return T.FederatedRun(_JaxInitTask(MNIST_CLASSIFIER, P0), d,
                          T.FLConfig(**cfg_fl), eval_data=ev, ratecontrol=rc,
                          device="cpu")


def test_jax_checkpoint_resumes_shared_ae_on_shared_route(tmp_path,
                                                          monkeypatch):
    """A JAX checkpoint of lanes sharing one chunked AE resumes in the
    port with the sharing put back: round 1 reduces dense0 once over the
    bucket on the shared-decoder route (the fused decode→aggregate), where
    the reference's own resume restores a copy a client and takes the
    batched-params route; bytes exact, loss and parameters in the golden
    band against the reference's resumed round."""
    from repro_torch.core import codec as tcodec
    first = _shared_ae_run(J, 1)
    first.run()
    path = str(tmp_path / "jax.npz")
    first.save_state(path)
    ref = _shared_ae_run(J, 1)
    ref.load_state(path)
    ref_dec = [ref.ratecontrol._pcomps[ci]["dense0"][0].params
               for ci in range(N_CLIENTS)]
    assert all(p is not ref_dec[0] for p in ref_dec[1:])
    ref.run()
    routes, real = [], tcodec.decode_and_aggregate

    def spy(spec, params, *a, params_batched=False, **k):
        if isinstance(spec, T.ChunkedAESpec):
            routes.append(params_batched)
        return real(spec, params, *a, params_batched=params_batched, **k)
    monkeypatch.setattr(tcodec, "decode_and_aggregate", spy)
    res = _shared_ae_run(T, 1)
    assert res.load_state(path) == 1
    dec = [res.ratecontrol._pcomps[ci]["dense0"][0].params
           for ci in range(N_CLIENTS)]
    assert all(p is dec[0] for p in dec)
    res.run()
    assert routes == [False]                 # one call, shared params
    _records_equal(ref.history[0], res.history[0], exact_metrics=False)
    np.testing.assert_allclose(res.history[0].global_metrics["loss"],
                               ref.history[0].global_metrics["loss"], **BAND)
    np.testing.assert_allclose(
        ravel(res.global_params)[0].numpy(),
        np.asarray(ravel_pytree(ref.global_params)[0]), **BAND)
