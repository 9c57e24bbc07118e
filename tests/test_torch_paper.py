"""The port's paper-protocol helpers against the JAX package: the §5.2
colour-imbalance data (``to_grayscale``, ``color_imbalance_split``,
bit-equal arrays) and the §5.1 validation model
(``validation_model_curve``, losses and accuracies in the golden band
``atol=2e-5, rtol=2e-4``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as J  # noqa: E402
from repro.configs.paper import MNIST_CLASSIFIER as J_MLP  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402

from repro_torch import core as T  # noqa: E402
from repro_torch.configs.paper import MNIST_CLASSIFIER  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)


def test_color_imbalance_split_bit_equal_reference():
    dj, evj = jpipe.color_imbalance_split(3, n_per_collab=40, n_eval=16)
    dt, evt = tpipe.color_imbalance_split(3, n_per_collab=40, n_eval=16)
    for a, b in zip(dj + [evj], dt + [evt], strict=True):
        assert b.keys() == a.keys()
        np.testing.assert_array_equal(b["x"].numpy(), np.asarray(a["x"]))
        np.testing.assert_array_equal(b["y"].numpy(), np.asarray(a["y"]))
    gray = dt[1]["x"]
    assert gray.shape == (40, 32, 32, 3) and gray.is_contiguous()
    assert torch.equal(gray[..., 0], gray[..., 2])
    assert not torch.equal(dt[0]["x"][..., 0], dt[0]["x"][..., 2])
    x = jpipe.cifar_like(5, 8)
    np.testing.assert_array_equal(
        tpipe.to_grayscale(tpipe.cifar_like(5, 8))["x"].numpy(),
        np.asarray(jpipe.to_grayscale(x)["x"]))


def test_validation_model_curve_matches_reference():
    """Five weight snapshots of the MLP and a lossy reconstruction (every
    value scaled by 0.9 and shifted): both curves in the golden band."""
    rng = np.random.RandomState(0)
    w = (rng.randn(5, 15_910) * 0.05).astype(np.float32)
    dj = jpipe.mnist_like(1, 128)
    dt = tpipe.mnist_like(1, 128)
    want = J.validation_model_curve(J_MLP, jnp.asarray(w),
                                    lambda v: v * 0.9 + 1e-3, dj)
    got = T.validation_model_curve(MNIST_CLASSIFIER, torch.from_numpy(w),
                                   lambda v: v * 0.9 + 1e-3, dt)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **BAND)
    assert got["original_loss"] != got["predicted_loss"]
