"""The port's checkpoints (``checkpoint/checkpoint.py``,
``FederatedRun.save_state``/``load_state``) against a live JAX run:

* tree round trips for float32, bfloat16, int8 and uint8 leaves, with npz
  keys and dtype tags equal to the reference's on the same tree;
* interchange: a checkpoint the JAX package saves of a 3-client q8 + error
  feedback MLP run loads in the port, whose next round matches the JAX
  run's next round, and the reverse;
* the resume matrix (modelled on ``tests/test_resume_matrix.py``, no rate
  control): ``SyncFedAvg``, ``SampledSync`` and ``AsyncBuffered`` (heap and
  vector engines) × flat and partitioned codecs, with an AE lifecycle
  attached: the resumed run ``torch.equal`` to the uninterrupted one, its
  bytes equal to the reference's resumed run;
* an async checkpoint restored into the other engine;
* refusals: a checkpoint of another task, and struct-of-arrays state.

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

    with pytest.raises(NotImplementedError, match="item 10"):
        tck.save_federated_state(str(tmp_path / "x.npz"), 0,
                                 run.global_params, clients_soa=({}, {}))
    soa = str(tmp_path / "soa.npz")
    dj, evj = _data(jpipe)
    jrun = J.FederatedRun(J_MLP, dj, J.FLConfig(n_rounds=1, batch_size=16),
                          eval_data=evj, soa_state=True)
    jrun.run()
    jrun.save_state(soa)
    with pytest.raises(NotImplementedError, match="item 10"):
        _torch_q8(1).load_state(soa)
