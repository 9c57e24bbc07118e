"""The paper's CIFAR collaborator model and the conv AE in the port against
a live JAX run: ``cifar_like`` data, the CNN's logits at full CIFAR width
(550,586 parameters, the reference's HWIO / NHWC tree), its gradient
against ``jax.grad`` on reduced CNNs (the convs as float32 products, one
a kernel offset; vmapped too), the conv1d AE's encode and decode
(strided "SAME" convs and ``lax.conv_transpose``), one trainer step of
the conv AE, and ``train_autoencoder_cohort`` against per-client
``train_autoencoder`` fits from the same generators.

Floats in the golden band ``atol=2e-5, rtol=2e-4``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.configs import paper as jpaper  # noqa: E402
from repro.core import autoencoder as jae  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import classifiers as jclf  # noqa: E402

from repro_torch.configs import paper as tpaper  # noqa: E402
from repro_torch.core import autoencoder as tae  # noqa: E402
from repro_torch.core.pytree import (from_jax_params, ravel,  # noqa: E402
                                     tree_map, value_and_grad)
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.models import classifiers as tclf  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def test_cifar_configs_and_data_equal_reference():
    for name in ("CIFAR_CLASSIFIER", "CIFAR_AE", "PAPER_SCALE_SCENARIO",
                 "SMOKE_SCALE_SCENARIO"):
        a, b = getattr(jpaper, name), getattr(tpaper, name)
        assert repr(b) == repr(a), name
    assert tpaper.cifar_ae_for(550_586) == tpaper.AEConfig(550_586, (), 320)
    assert tpaper.CIFAR_AE.n_params == jpaper.CIFAR_AE.n_params
    dj, dt = jpipe.cifar_like(3, 40), tpipe.cifar_like(3, 40)
    np.testing.assert_array_equal(dt["x"].numpy(), np.asarray(dj["x"]))
    np.testing.assert_array_equal(dt["y"].numpy(), np.asarray(dj["y"]))
    p = tclf.init_classifier(torch.Generator().manual_seed(0),
                             tpaper.CIFAR_CLASSIFIER, "cpu")
    pj = jax.eval_shape(lambda: jclf.init_classifier(
        jax.random.PRNGKey(0), jpaper.CIFAR_CLASSIFIER))
    assert (jax.tree_util.tree_map(lambda x: tuple(x.shape), pj)
            == tree_map(lambda x: tuple(x.shape), p))
    assert ravel(p)[0].numel() == 550_586


def test_cifar_cnn_logits_at_full_width_match_reference():
    pj = jclf.init_classifier(jax.random.PRNGKey(1), jpaper.CIFAR_CLASSIFIER)
    pt = from_jax_params(_np(pj), "cpu")
    dj, dt = jpipe.cifar_like(0, 16), tpipe.cifar_like(0, 16)
    lj = jclf.apply_classifier(pj, jpaper.CIFAR_CLASSIFIER, dj["x"])
    lt = tclf.apply_classifier(pt, tpaper.CIFAR_CLASSIFIER, dt["x"])
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BAND)


def test_cnn_loss_and_gradient_match_jax_grad():
    kw = dict(name="cnn-small", kind="cnn", input_shape=(13, 13, 3),
              n_classes=10, conv_channels=(4, 6, 5), conv_kernel=3,
              dense_hidden=(12,))
    cj, ct = jpaper.ClassifierConfig(**kw), tpaper.ClassifierConfig(**kw)
    pj = jclf.init_classifier(jax.random.PRNGKey(2), cj)
    pt = from_jax_params(_np(pj), "cpu")
    dj = jpipe.synthetic_classification(1, 24, (13, 13, 3), 10)
    dt = tpipe.synthetic_classification(1, 24, (13, 13, 3), 10)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jclf.classifier_loss(p, cj, dj), has_aux=True))(pj)
    lt, mt, gt = value_and_grad(
        lambda p, b: tclf.classifier_loss(p, ct, b), pt, dt)
    np.testing.assert_allclose(float(lt), float(lj), **BAND)
    np.testing.assert_allclose(float(mt["accuracy"]),
                               float(mj["accuracy"]), **BAND)
    np.testing.assert_allclose(ravel(gt)[0].numpy(),
                               np.asarray(ravel_pytree(gj)[0]), **BAND)


def test_cnn_gemm_route_matches_jax_grad():
    """The CNN's convs (``conv2d_valid_gemm``: one float32 matrix product
    a kernel offset, summed; the route of every device) at another shape, an odd
    image side and three convs: the loss and gradient against ``jax.grad``
    in the golden band, and a vmapped two-client gradient
    (``local_train_batched``'s form) equal to the per-client ones."""
    kw = dict(name="cnn-small", kind="cnn", input_shape=(13, 13, 3),
              n_classes=10, conv_channels=(4, 6, 5), conv_kernel=3,
              dense_hidden=(12,))
    cj, ct = jpaper.ClassifierConfig(**kw), tpaper.ClassifierConfig(**kw)
    pj = jclf.init_classifier(jax.random.PRNGKey(2), cj)
    pt = from_jax_params(_np(pj), "cpu")
    dj = jpipe.synthetic_classification(1, 24, (13, 13, 3), 10)
    dt = tpipe.synthetic_classification(1, 24, (13, 13, 3), 10)
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: jclf.classifier_loss(p, cj, dj), has_aux=True))(pj)
    lt, _, gt = value_and_grad(
        lambda p, b: tclf.classifier_loss(p, ct, b), pt, dt)
    np.testing.assert_allclose(float(lt), float(lj), **BAND)
    np.testing.assert_allclose(ravel(gt)[0].numpy(),
                               np.asarray(ravel_pytree(gj)[0]), **BAND)
    halves = [{k: v[i::2] for k, v in dt.items()} for i in range(2)]
    stacked = {k: torch.stack([h[k] for h in halves]) for k in dt}
    grad = torch.func.grad(lambda p, b: tclf.classifier_loss(p, ct, b)[0])
    both = torch.func.vmap(grad, in_dims=(None, 0))(pt, stacked)
    for i, h in enumerate(halves):
        torch.testing.assert_close(ravel(tree_map(lambda x: x[i], both))[0],
                                   ravel(grad(pt, h))[0], **BAND)


# ------------------------------------------------------------ conv AE
@pytest.mark.parametrize("length,stride,kernel", [(512, 8, 9), (200, 4, 9),
                                                  (97, 4, 3), (130, 3, 5)])
def test_conv_ae_encode_decode_match_reference(length, stride, kernel):
    """Asymmetric "SAME" pads (k - s odd, L off the stride) included, and
    both of lax's transpose-padding branches (s > k - 1 at (4, 3))."""
    kw = dict(channels=(4, 6), kernel=kernel, stride=stride,
              latent_channels=2)
    cj, ct = jae.ConvAEConfig(**kw), tae.ConvAEConfig(**kw)
    pj = jae.fit_normalizer(jae.init_conv_ae(jax.random.PRNGKey(3), cj),
                            jnp.ones((1,)) * 0.5)
    pj = dict(pj, norm={"mean": jnp.float32(0.01), "std": jnp.float32(0.2)})
    pt = from_jax_params(_np(pj), "cpu")
    x = (np.random.RandomState(length).randn(3, length) * 0.2
         ).astype(np.float32)
    zj = jax.jit(lambda p, v: jae.conv_encode(p, cj, v))(pj, x)
    zt = tae.conv_encode(pt, ct, torch.from_numpy(x))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **BAND)
    rj = jax.jit(lambda p, z: jae.conv_decode(p, cj, z))(pj, zj)
    rt = tae.conv_decode(pt, ct, torch.from_numpy(np.array(zj)))
    assert tuple(rt.shape) == tuple(rj.shape)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), **BAND)


def test_conv_ae_trainer_step_matches_reference():
    cj, ct = jae.ConvAEConfig(channels=(4,)), tae.ConvAEConfig(channels=(4,))
    data = (np.random.RandomState(0).randn(6, 256) * 0.1).astype(np.float32)
    pj = jae.fit_normalizer(jae.init_conv_ae(jax.random.PRNGKey(4), cj),
                            jnp.asarray(data))
    pt = from_jax_params(_np(pj), "cpu")
    wb = np.array([1, 1, 1, 1, 0, 0], np.float32)
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p, x, w: jae._masked_ae_loss(p, cj, x, w, "conv")))(
        pj, jnp.asarray(data), jnp.asarray(wb))
    gj = dict(gj, norm=jax.tree_util.tree_map(jnp.zeros_like, gj["norm"]))
    zj = jax.tree_util.tree_map(jnp.zeros_like, pj)
    pj1, _, _ = jae._adam_update(pj, gj, zj, zj, 1, 3e-3)
    zt = tree_map(torch.zeros_like, pt)
    pt1, _, _, lt = tae.ae_step(pt, ct, torch.from_numpy(data),
                                torch.from_numpy(wb), zt, zt, 1, 3e-3,
                                kind="conv")
    np.testing.assert_allclose(float(lt), float(lj), **BAND)
    np.testing.assert_allclose(ravel(pt1)[0].numpy(),
                               np.asarray(ravel_pytree(pj1)[0]),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("kind", ["fc", "conv"])
def test_train_autoencoder_cohort_equals_per_client_fits(kind):
    """Three clients with 7 snapshots each (a trailing partial batch of
    the 6-row train split at batch size 4): the cohort fit equals the
    three ``train_autoencoder`` fits from identically seeded generators."""
    cfg = (tae.ConvAEConfig(channels=(4,)) if kind == "conv"
           else tpaper.AEConfig(input_dim=64, encoder_hidden=(16,),
                                latent_dim=4))
    d = 256 if kind == "conv" else 64
    rng = np.random.RandomState(1)
    data = torch.from_numpy(
        (rng.randn(3, 1, d) + 0.1 * rng.randn(3, 7, d)).astype(np.float32))
    kw = dict(kind=kind, epochs=5, batch_size=4)
    params, hist = tae.train_autoencoder_cohort(
        [torch.Generator().manual_seed(10 + c) for c in range(3)], cfg,
        data, **kw)
    assert {k: tuple(v.shape) for k, v in hist.items()} == {
        k: (3, 5) for k in ("loss", "accuracy", "val_loss", "val_accuracy")}
    for c in range(3):
        pc, hc = tae.train_autoencoder(torch.Generator().manual_seed(10 + c),
                                       cfg, data[c], **kw)
        np.testing.assert_allclose(
            ravel(tree_map(lambda x, c=c: x[c], params))[0].numpy(),
            ravel(pc)[0].numpy(), **BAND)
        for k, v in hc.items():
            np.testing.assert_allclose(hist[k][c].numpy(), v, **BAND)
    if kind == "fc":
        assert float(hist["loss"][:, -1].max()) < float(
            hist["loss"][:, 0].min())
