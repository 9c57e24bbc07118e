"""The port's ``LMDeltaTask`` (``repro_torch.core.task``) against a live
JAX run on the CPU: the ``LMDeltaTask`` cases of ``tests/test_task.py``
and the LM cells of ``tests/test_resume_matrix.py``.

* the task's surface (examples, weights, batches, evaluate, a local round
  that moves the params), the payload check's ``ValueError`` and the
  checkpoint key; a classifier checkpoint refused by an LM run;
* the gradient mask: path strings equal to the reference's ``_key_str``
  joins, roles equal; frozen roles keep exactly their values (a zero
  delta) while the rest train;
* a local round and ``evaluate`` on the reference's own params carried
  across, against the reference's (golden band ``atol=2e-5, rtol=2e-4``),
  with and without FedProx;
* the resume matrix's LM cells: eager under ``SyncFedAvg``,
  ``SampledSync`` and ``AsyncBuffered``; struct-of-arrays under
  ``SampledSync`` and ``AsyncBuffered`` (vector engine); and eager ↔ SoA
  cross restores. The resumed run is ``torch.equal`` to the uninterrupted
  one, its bytes and records equal the reference's resumed run's, its
  parameters and metrics in the golden band of the reference's;
* the new families: on reduced minicpm3-4b (MLA) and dbrx-132b (MoE) the
  roles of every leaf equal the reference's (``q_norm``/``kv_norm`` under
  ``attn/`` are attention, the router and expert stacks mlp) and
  ``by_role_partition`` leaves no ``other`` group; one ``SyncFedAvg``
  round of ``LMDeltaTask`` under ``optimizer="sgdm"`` against the
  reference's, records exact, parameters and metrics in the golden band.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro import core as J  # noqa: E402
from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.core.partition import _leaf_segments as j_leaf_segments  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402

from repro_torch import core as T  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.configs.paper import MNIST_CLASSIFIER  # noqa: E402
from repro_torch.core.pytree import (from_jax_params, leaf_paths,  # noqa: E402
                                     leaves, ravel)
from repro_torch.core.task import LMDeltaTask  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)        # tests/test_golden_trajectory.py
N_CLIENTS = 3
LM = dict(name="task-lm", family="dense", n_layers=1, d_model=32,
          n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64,
          tie_embeddings=True, param_dtype="float32",
          compute_dtype="float32", remat=False, zero1=False)
T_CFG, J_CFG = ArchConfig(**LM), JArchConfig(**LM)
P0 = jax.tree_util.tree_map(np.array,
                            j_init_params(jax.random.PRNGKey(0), J_CFG))


class _JaxInitLM(LMDeltaTask):
    """The port's task started from the reference's initial params (its
    checkpoint key is the reference's)."""

    def init_params(self, gen, device):
        return from_jax_params(P0, device)


def _lm_data(pkg, n=N_CLIENTS, seed0=10, batch=4, seq=16):
    shards = [pkg.synthetic_lm_batch(seed=seed0 + i, vocab_size=64,
                                     batch=batch, seq_len=seq)
              for i in range(n)]
    ev = pkg.synthetic_lm_batch(seed=99, vocab_size=64, batch=4, seq_len=16)
    return shards, ev


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **BAND,
                               err_msg=what)


def _tflat(tree):
    return ravel(tree)[0].numpy()


def _jflat(tree):
    return np.asarray(ravel_pytree(tree)[0])


# ------------------------------------------------------------ surface
def test_lm_task_requires_update_payload():
    shards, _ = _lm_data(tpipe)
    with pytest.raises(ValueError, match="payload"):
        T.FederatedRun(LMDeltaTask(T_CFG), shards,
                       T.FLConfig(n_rounds=1, payload="weights"),
                       device="cpu")
    with pytest.raises(ValueError, match="payload"):
        J.FederatedRun(J.LMDeltaTask(J_CFG), _lm_data(jpipe)[0],
                       J.FLConfig(n_rounds=1, payload="weights"))


def test_lm_task_surface():
    task = LMDeltaTask(T_CFG)
    data = tpipe.synthetic_lm_batch(seed=0, vocab_size=64, batch=8,
                                    seq_len=16)
    assert task.num_examples(data) == 8 and task.data_weight(data) == 8.0
    batches = list(task.make_batches(0, data, batch_size=4))
    assert sum(b["tokens"].shape[0] for b in batches) == 8
    jbatches = list(J.LMDeltaTask(J_CFG).make_batches(
        0, jpipe.synthetic_lm_batch(seed=0, vocab_size=64, batch=8,
                                    seq_len=16), batch_size=4))
    for b, jb in zip(batches, jbatches, strict=True):
        assert np.array_equal(b["tokens"].numpy(), np.asarray(jb["tokens"]))
    params = task.init_params(torch.Generator().manual_seed(0), "cpu")
    metrics = task.evaluate(params, data)
    assert np.isfinite(metrics["ce_loss"])
    cfg = T.FLConfig(local_epochs=1, batch_size=4)
    local, m = task.local_update(params, data, cfg, seed=0, anchor=params)
    assert np.isfinite(m["ce_loss"])
    assert any(float((a - b).abs().max()) > 0
               for a, b in zip(leaves(local), leaves(params)))
    assert task.local_update_batched(params, [data, data], cfg,
                                     seed=0) is None
    assert task.checkpoint_key() == J.LMDeltaTask(J_CFG).checkpoint_key() \
        == "lm_delta:task-lm"


def test_lm_task_freeze_roles_zero_delta_and_mask_paths():
    """The mask's paths and roles equal the reference's; frozen roles keep
    their values exactly while the MLP trains."""
    task = _JaxInitLM(T_CFG, freeze_roles=("embedding",))
    params = task.init_params(None, "cpu")
    assert [p for p, _, _ in leaf_paths(params)] == \
        [p for p, _, _ in j_leaf_segments(P0)]
    jmask = J.LMDeltaTask(J_CFG, freeze_roles=("embedding",))._grad_mask(P0)
    assert [float(m) for m in leaves(task._grad_mask(params))] == \
        [float(m) for m in jax.tree_util.tree_leaves(jmask)]
    data = tpipe.synthetic_lm_batch(seed=0, vocab_size=64, batch=4,
                                    seq_len=16)
    cfg = T.FLConfig(local_epochs=1, batch_size=2)
    local, _ = task.local_update(params, data, cfg, seed=0, anchor=params)
    assert torch.equal(local["embed"], params["embed"])
    assert float((local["layers"]["ffn"]["w_gate"]
                  - params["layers"]["ffn"]["w_gate"]).abs().max()) > 0


@pytest.mark.parametrize("aggregation", ["fedavg", "fedprox"])
def test_local_update_and_evaluate_match_reference(aggregation):
    """Two local epochs of two Adam steps each, and evaluate, on the
    reference's params and data."""
    kw = dict(local_epochs=2, batch_size=2, lr=1e-2, aggregation=aggregation,
              prox_mu=0.5)
    freeze = ("norm",)
    tdata = tpipe.synthetic_lm_batch(seed=4, vocab_size=64, batch=4,
                                     seq_len=16)
    jdata = jpipe.synthetic_lm_batch(seed=4, vocab_size=64, batch=4,
                                     seq_len=16)
    task = _JaxInitLM(T_CFG, freeze_roles=freeze)
    jtask = J.LMDeltaTask(J_CFG, freeze_roles=freeze)
    params = task.init_params(None, "cpu")
    anchor = jax.tree_util.tree_map(lambda x: x * 0.9, P0)
    t_anchor = from_jax_params(anchor, "cpu")
    local, m = task.local_update(params, tdata, T.FLConfig(**kw), seed=3,
                                 anchor=t_anchor)
    jlocal, jm = jtask.local_update(
        jax.tree_util.tree_map(jax.numpy.asarray, P0), jdata,
        J.FLConfig(**kw), seed=3,
        anchor=jax.tree_util.tree_map(jax.numpy.asarray, anchor))
    _close(_tflat(local), _jflat(jlocal), "local params")
    assert m.keys() == jm.keys()
    for k in m:
        _close(m[k], jm[k], k)
    ev, jev = task.evaluate(local, tdata), jtask.evaluate(jlocal, jdata)
    for k in jev:
        _close(ev[k], jev[k], k)


def test_checkpoint_task_mismatch_refused(tmp_path):
    train, ev = tpipe.train_eval_split(tpipe.mnist_like(0, 128), 32)
    data = tpipe.uniform_partition(0, train, N_CLIENTS)
    run = T.FederatedRun(MNIST_CLASSIFIER, data,
                         T.FLConfig(n_rounds=1, local_epochs=1,
                                    payload="update"),
                         compressors=[T.QuantizeCompressor(bits=8)
                                      for _ in range(N_CLIENTS)],
                         eval_data=ev, device="cpu")
    run.run()
    path = os.path.join(tmp_path, "ckpt.npz")
    run.save_state(path)
    shards, _ = _lm_data(tpipe)
    lm = T.FederatedRun(LMDeltaTask(T_CFG), shards,
                        T.FLConfig(n_rounds=1, local_epochs=1,
                                   payload="update"),
                        compressors=[T.QuantizeCompressor(bits=8)
                                     for _ in range(N_CLIENTS)],
                        device="cpu")
    with pytest.raises(ValueError, match="task mismatch"):
        lm.load_state(path)


# ------------------------------------------------------------ resume
def _scheduler(pkg, kind):
    return {
        "sync": lambda: None,
        "sampled": lambda: pkg.SampledSync(cohort=2),
        "async": lambda: pkg.AsyncBuffered(
            buffer_k=2, latency=pkg.LatencyModel(jitter=0.3)),
        "async-vector": lambda: pkg.AsyncBuffered(
            buffer_k=2, latency=pkg.LatencyModel(jitter=0.3),
            engine="vector"),
    }[kind]()


def _mk_lm(pkg, sched, n_rounds, soa=False):
    data, ev = _lm_data(jpipe if pkg is J else tpipe)
    cfg = pkg.FLConfig(n_rounds=n_rounds, local_epochs=1, batch_size=2,
                       payload="update", error_feedback=True)
    comps = [pkg.QuantizeCompressor(bits=8) for _ in range(N_CLIENTS)]
    if pkg is J:
        return J.FederatedRun(J.LMDeltaTask(J_CFG), data, cfg,
                              compressors=comps, eval_data=ev,
                              scheduler=_scheduler(J, sched), soa_state=soa)
    return T.FederatedRun(_JaxInitLM(T_CFG), data, cfg, compressors=comps,
                          eval_data=ev, scheduler=_scheduler(T, sched),
                          soa_state=soa, device="cpu")


def _resumed(pkg, sched, tmp_path, soa, resume_soa):
    first = _mk_lm(pkg, sched, 1, soa=soa)
    first.run()
    path = os.path.join(tmp_path, f"{'j' if pkg is J else 't'}.npz")
    first.save_state(path)
    resumed = _mk_lm(pkg, sched, 1, soa=resume_soa)
    assert resumed.load_state(path) == 1
    resumed.run()
    return resumed


def _run_lm_cell(sched, tmp_path, soa=False, resume_soa=None):
    """Same bar as the reference's ``_run_lm_cell``; ``resume_soa`` (when
    not None) builds the resuming run in the other layout — the
    checkpoint's layout must win."""
    if resume_soa is None:
        resume_soa = soa
    full = _mk_lm(T, sched, 2, soa=soa)
    hist_full = full.run()
    resumed = _resumed(T, sched, tmp_path, soa, resume_soa)
    assert isinstance(resumed.clients, T.ClientPool) == soa
    assert torch.equal(ravel(full.global_params)[0],
                       ravel(resumed.global_params)[0])
    ref = _resumed(J, sched, tmp_path, soa, resume_soa)
    for a, b, j in zip(hist_full[1:], resumed.history, ref.history,
                       strict=True):
        for k in ("round", "bytes_up", "bytes_up_raw", "bytes_down",
                  "participants", "staleness", "sim_time"):
            assert getattr(a, k) == getattr(b, k) == getattr(j, k), k
        assert a.global_metrics == b.global_metrics
        for k in j.global_metrics:
            _close(b.global_metrics[k], j.global_metrics[k], k)
    _close(_tflat(resumed.global_params), _jflat(ref.global_params),
           "resumed global params")


@pytest.mark.parametrize("sched", ["sync", "sampled", "async"])
def test_resume_matrix_lm(sched, tmp_path):
    _run_lm_cell(sched, tmp_path)


@pytest.mark.parametrize("sched", ["sampled", "async-vector"])
def test_resume_matrix_lm_soa(sched, tmp_path):
    _run_lm_cell(sched, tmp_path, soa=True)


@pytest.mark.parametrize("save_soa,load_soa", [(False, True), (True, False)])
def test_resume_matrix_lm_cross_restore(save_soa, load_soa, tmp_path):
    _run_lm_cell("sync", tmp_path, soa=save_soa, resume_soa=load_soa)


# ------------------------------------------------------- MLA and MoE
@pytest.mark.parametrize("arch", ["minicpm3_4b", "dbrx_132b"])
def test_roles_of_new_families_match_reference(arch):
    from repro.configs import get_config as jget
    from repro.core.partition import role_of_path as j_role
    from repro_torch.core.partition import by_role_partition, role_of_path
    jp = jax.tree_util.tree_map(np.array, j_init_params(
        jax.random.PRNGKey(0), jget(arch).reduced()))
    params = from_jax_params(jp, "cpu")
    paths = [p for p, _, _ in leaf_paths(params)]
    assert paths == [p for p, _, _ in j_leaf_segments(jp)]
    roles = {p: role_of_path(p) for p in paths}
    assert roles == {p: j_role(p) for p in paths}
    assert "other" not in roles.values()
    if arch == "minicpm3_4b":
        assert roles["layers/attn/q_norm/scale"] == "attention"
        assert roles["layers/attn/kv_norm/scale"] == "attention"
    else:
        assert roles["layers/ffn/router"] == "mlp"
        assert roles["layers/ffn/w_gate"] == "mlp"
    names = by_role_partition(params).names
    assert sorted(names) == ["attention", "embedding", "mlp", "norm"]


@pytest.mark.parametrize("arch", ["minicpm3_4b", "dbrx_132b"])
def test_lm_delta_round_new_families_match_reference(arch):
    """One ``SyncFedAvg`` round of ``LMDeltaTask`` (2 clients of 4
    sequences of 16 tokens, batch 2, ``optimizer="sgdm"``, update payload)
    on the reference's initial params, against the reference's run.

    Momentum SGD moves each parameter in proportion to its gradient, so
    the gradients' float32 agreement carries to the parameters. Under
    Adam the same round leaves 4 (dbrx) to 6 (minicpm3) of 1.3–2.4 M
    parameters out of the band by up to 1.5e-4: where the second step's
    ``m = 0.09 g1 + 0.1 g2`` cancels, ``m / sqrt(v)`` turns a rounding
    difference in the gradients into a share of ``lr``."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    # the reference's run draws its params from PRNGKey(FLConfig.seed = 0)
    p0 = jax.tree_util.tree_map(np.array,
                                j_init_params(jax.random.PRNGKey(0), jcfg))

    class _From(LMDeltaTask):
        def init_params(self, gen, device):
            return from_jax_params(p0, device)

    def data(pkg):
        shards = [pkg.synthetic_lm_batch(seed=30 + i,
                                         vocab_size=tcfg.vocab_size,
                                         batch=4, seq_len=16)
                  for i in range(2)]
        return shards, pkg.synthetic_lm_batch(
            seed=98, vocab_size=tcfg.vocab_size, batch=2, seq_len=16)

    kw = dict(n_rounds=1, local_epochs=1, batch_size=2, payload="update",
              optimizer="sgdm", lr=1e-3)
    tshards, tev = data(tpipe)
    jshards, jev = data(jpipe)
    trun = T.FederatedRun(_From(tcfg), tshards, T.FLConfig(**kw),
                          eval_data=tev, device="cpu")
    jrun = J.FederatedRun(J.LMDeltaTask(jcfg), jshards, J.FLConfig(**kw),
                          eval_data=jev)
    th, jh = trun.run(), jrun.run()
    for a, b in zip(th, jh, strict=True):
        for k in ("round", "bytes_up", "bytes_up_raw", "bytes_down",
                  "participants"):
            assert getattr(a, k) == getattr(b, k), k
        assert a.global_metrics.keys() == b.global_metrics.keys()
        for k in b.global_metrics:
            _close(a.global_metrics[k], b.global_metrics[k], k)
    assert float(np.abs(_tflat(trun.global_params) - ravel(
        from_jax_params(p0, "cpu"))[0].numpy()).max()) > 0
    _close(_tflat(trun.global_params), _jflat(jrun.global_params),
           "global params")
