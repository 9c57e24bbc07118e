"""The port's slice end to end against a live JAX run: ``FederatedRun`` with
the default ``SyncFedAvg`` over the paper's MNIST MLP, both packages fed
the same numpy data and the JAX package's own initial parameters (a
``ClassifierTask`` whose ``init_params`` carries them across).

* gate 1 — the golden configuration (tests/test_golden_trajectory.py):
  3 clients, q8, update payload + error feedback, 2 rounds;
* gate 2 — the FC-AE run of tests/test_system.py with JAX-initialised
  ``MNIST_AE`` params (no pre-pass, to keep it fast);
* gate 3 — the chunked AE with ``use_kernel=True`` on both sides: JAX's
  Pallas kernels in interpret mode, the port's kernels on their plain
  versions (CPU tensors).

Live JAX, not ``tests/golden/sync_q8.json``: the live reference no longer
replays that fixture on this JAX version. Bytes integer-exact; metrics and
final parameters in the golden band ``atol=2e-5, rtol=2e-4``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro import core as J  # noqa: E402
from repro.configs.paper import MNIST_AE as J_MNIST_AE  # noqa: E402
from repro.configs.paper import MNIST_CLASSIFIER as J_MLP  # noqa: E402
from repro.core import autoencoder as jae  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.classifiers import init_classifier  # noqa: E402

from repro_torch import core as T  # noqa: E402
from repro_torch.configs.paper import MNIST_AE, MNIST_CLASSIFIER  # noqa: E402
from repro_torch.core.pytree import from_jax_params, ravel  # noqa: E402
from repro_torch.core.task import ClassifierTask  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAND = dict(atol=2e-5, rtol=2e-4)


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
    hj, ht = run_j.history, run_t.history
    assert len(hj) == len(ht)
    for a, b in zip(hj, ht):
        for k in ("bytes_up", "bytes_up_raw", "bytes_down", "bytes_decoder"):
            assert getattr(b, k) == getattr(a, k), k
        np.testing.assert_allclose(b.compression_ratio, a.compression_ratio,
                                   **BAND)
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(b.global_metrics[k],
                                       a.global_metrics[k], **BAND)
    np.testing.assert_allclose(ravel(run_t.global_params)[0].numpy(),
                               np.asarray(ravel_pytree(run_j.global_params)[0]),
                               **BAND)
    assert run_t.total_bytes() == run_j.total_bytes()


def _golden_data(pkg):
    train, ev = pkg.train_eval_split(pkg.mnist_like(0, 256), 64)
    return pkg.uniform_partition(0, train, 3), ev


def test_pipeline_data_bit_identical():
    dj, evj = _golden_data(jpipe)
    dt, evt = _golden_data(tpipe)
    for a, b in zip(dj + [evj], dt + [evt]):
        np.testing.assert_array_equal(b["x"].numpy(), np.asarray(a["x"]))
        np.testing.assert_array_equal(b["y"].numpy(), np.asarray(a["y"]))
    pj = jpipe.dirichlet_partition(3, jpipe.mnist_like(1, 300), 4, alpha=0.3)
    pt = tpipe.dirichlet_partition(3, tpipe.mnist_like(1, 300), 4, alpha=0.3)
    for a, b in zip(pj, pt):
        np.testing.assert_array_equal(b["y"].numpy(), np.asarray(a["y"]))
    for a, b in zip(jpipe.batches(5, dj[0], 16), tpipe.batches(5, dt[0], 16)):
        np.testing.assert_array_equal(b["x"].numpy(), np.asarray(a["x"]))


def test_gate1_golden_config_matches_jax():
    p0 = _np(init_classifier(jax.random.PRNGKey(0), J_MLP))
    dj, evj = _golden_data(jpipe)
    run_j = J.FederatedRun(
        J_MLP, dj, J.FLConfig(n_rounds=2, local_epochs=1, payload="update",
                              error_feedback=True, seed=0),
        compressors=[J.QuantizeCompressor(bits=8) for _ in range(3)],
        eval_data=evj)
    run_j.run()
    dt, evt = _golden_data(tpipe)
    run_t = T.FederatedRun(
        _JaxInitTask(MNIST_CLASSIFIER, p0), dt,
        T.FLConfig(n_rounds=2, local_epochs=1, payload="update",
                   error_feedback=True, seed=0),
        compressors=[T.QuantizeCompressor(bits=8) for _ in range(3)],
        eval_data=evt, device="cpu")
    run_t.run()
    _compare(run_j, run_t)
    assert run_t.history[0].bytes_up == 3 * (63 * 256 + 63 * 4)


def test_mixed_spec_cohort_groups_by_spec_like_jax():
    """A cohort mixing q8 and q4 takes the group-by-spec server branch:
    one decode→aggregate per spec, weights renormalized per group."""
    p0 = _np(init_classifier(jax.random.PRNGKey(0), J_MLP))
    dj, evj = _golden_data(jpipe)
    dt, evt = _golden_data(tpipe)
    cfg = dict(n_rounds=1, local_epochs=1, payload="update",
               error_feedback=True, seed=0)
    run_j = J.FederatedRun(
        J_MLP, dj, J.FLConfig(**cfg),
        compressors=[J.QuantizeCompressor(bits=b) for b in (8, 4, 8)],
        eval_data=evj)
    run_j.run()
    run_t = T.FederatedRun(
        _JaxInitTask(MNIST_CLASSIFIER, p0), dt, T.FLConfig(**cfg),
        compressors=[T.QuantizeCompressor(bits=b) for b in (8, 4, 8)],
        eval_data=evt, device="cpu")
    run_t.run()
    _compare(run_j, run_t)


def test_gate2_fc_ae_run_matches_jax():
    p0 = _np(init_classifier(jax.random.PRNGKey(0), J_MLP))
    aej = jae.init_fc_ae(jax.random.PRNGKey(1), J_MNIST_AE)
    aet = from_jax_params(_np(aej), "cpu")
    trj, evj = jpipe.train_eval_split(jpipe.mnist_like(1, 384), 128)
    trt, evt = tpipe.train_eval_split(tpipe.mnist_like(1, 384), 128)
    cfg = dict(n_rounds=2, local_epochs=1, error_feedback=True)
    run_j = J.FederatedRun(
        J_MLP, jpipe.dirichlet_partition(0, trj, 2, alpha=1.0),
        J.FLConfig(**cfg),
        compressors=[J.FCAECompressor(aej, J_MNIST_AE) for _ in range(2)],
        eval_data=evj)
    run_j.run()
    run_t = T.FederatedRun(
        _JaxInitTask(MNIST_CLASSIFIER, p0),
        tpipe.dirichlet_partition(0, trt, 2, alpha=1.0), T.FLConfig(**cfg),
        compressors=[T.FCAECompressor(aet, MNIST_AE) for _ in range(2)],
        eval_data=evt, device="cpu")
    run_t.run()
    _compare(run_j, run_t)
    assert run_t.history[-1].compression_ratio > 300


def test_gate3_chunked_ae_kernel_path_matches_jax_interpret():
    p0 = _np(init_classifier(jax.random.PRNGKey(0), J_MLP))
    jcfg = jae.ChunkedAEConfig(chunk_size=1024, hidden=(32,), latent_chunk=8)
    tcfg = T.ChunkedAEConfig(chunk_size=1024, hidden=(32,), latent_chunk=8)
    aej = jae.init_chunked_ae(jax.random.PRNGKey(2), jcfg)
    aet = from_jax_params(_np(aej), "cpu")
    dj, evj = _golden_data(jpipe)
    dt, evt = _golden_data(tpipe)
    cfg = dict(n_rounds=2, local_epochs=1, payload="update",
               error_feedback=True, seed=0)
    run_j = J.FederatedRun(
        J_MLP, dj, J.FLConfig(**cfg),
        compressors=[J.ChunkedAECompressor(aej, jcfg, use_kernel=True)
                     for _ in range(3)], eval_data=evj)
    run_j.run()
    from repro_torch.kernels import _lib
    run_t = T.FederatedRun(
        _JaxInitTask(MNIST_CLASSIFIER, p0), dt, T.FLConfig(**cfg),
        compressors=[T.ChunkedAECompressor(aet, tcfg, use_kernel=True)
                     for _ in range(3)], eval_data=evt, device="cpu")
    before = _lib.counts()
    run_t.run()
    assert _lib.counts() == before          # CPU tensors: plain versions
    _compare(run_j, run_t)
    assert run_t.history[0].bytes_up == 3 * 16 * 8 * 4


def test_entry_points_raise_without_a_card():
    """No fallback: without CUDA, the default device is refused."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal path cannot run")
    dt, _ = _golden_data(tpipe)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.FederatedRun(MNIST_CLASSIFIER, dt, T.FLConfig(n_rounds=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        T.run_prepass(torch.Generator(), MNIST_CLASSIFIER, MNIST_AE, dt[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params({"w": np.zeros(3, np.float32)})


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules\n"
        "                 if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
