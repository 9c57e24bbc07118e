"""The port's optimizer suite (``repro_torch.optim.optimizers``) against
``repro.optim.optimizers`` on the CPU.

* every name — ``sgd``, ``sgdm``, ``sgdm_bf16``, ``adam``, ``adamw`` —
  five steps on a mixed tree (a float32 matrix, a float32 vector, a
  bfloat16 matrix) with weight decay and gradient clipping on and off:
  parameters and float32 state in the golden band ``atol=2e-5,
  rtol=2e-4``, ``sgdm_bf16``'s bfloat16 momentum bit-equal, the step
  count exact;
* ``update(..., inplace=True)`` gives the same bits as the functional
  update, in the tensors it was given;
* ``global_norm`` and ``clip_by_global_norm`` against the reference;
* the ports of ``tests/test_substrates.py:32-53``
  (``test_optimizer_reduces_quadratic`` for the five names,
  ``test_grad_clip``).

Inputs are drawn with numpy from a seed and handed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import optimizers as jopt  # noqa: E402

from repro_torch.core.pytree import leaves  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)        # tests/test_golden_trajectory.py
NAMES = ("sgd", "sgdm", "sgdm_bf16", "adam", "adamw")


def _tree(rs, scale=1.0):
    """A mixed tree: float32 matrix and vector, a bfloat16 matrix."""
    return {"w": (rs.randn(6, 5) * scale).astype(np.float32),
            "b": (rs.randn(5) * scale).astype(np.float32),
            "h": (rs.randn(3, 4) * scale).astype(np.float32)}


def _to_jax(tree):
    return {"w": jnp.asarray(tree["w"]), "b": jnp.asarray(tree["b"]),
            "h": jnp.asarray(tree["h"], jnp.bfloat16)}


def _to_torch(tree):
    return {"w": torch.from_numpy(tree["w"]), "b": torch.from_numpy(tree["b"]),
            "h": torch.from_numpy(tree["h"]).to(torch.bfloat16)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(
        x, jax.Array) else x.float().numpy()


def _kw(wd, clip):
    return dict(lr=0.05, weight_decay=wd, grad_clip=clip)


@pytest.mark.parametrize("wd,clip", [(0.0, 0.0), (0.1, 0.0), (0.0, 1.0),
                                     (0.1, 1.0)])
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_steps_match_jax(name, wd, clip):
    rs = np.random.RandomState(7)
    p0 = _tree(rs)
    grads = [_tree(rs, scale=2.0) for _ in range(5)]
    jo = jopt.make_optimizer(name, **_kw(wd, clip))
    to = topt.make_optimizer(name, **_kw(wd, clip))
    jp, tp = _to_jax(p0), _to_torch(p0)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(jp, _to_jax(g), js)
        tp, ts = to.update(tp, _to_torch(g), ts)
    assert ts["count"] == int(js["count"]) == 5
    for k in jp:
        assert tp[k].dtype == getattr(torch, str(jp[k].dtype))
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **BAND,
                                   err_msg=f"{name} param {k}")
    for slot in (s for s in js if s != "count"):
        for k in js[slot]:
            got, want = ts[slot][k], js[slot][k]
            assert got.dtype == getattr(torch, str(want.dtype)), (slot, k)
            if want.dtype == jnp.bfloat16:
                assert np.array_equal(_np(got), _np(want)), (slot, k)
            else:
                np.testing.assert_allclose(_np(got), _np(want), **BAND,
                                           err_msg=f"{name} {slot}/{k}")


@pytest.mark.parametrize("name", NAMES)
def test_inplace_update_equals_functional(name):
    """``inplace=True`` writes the functional update's exact values into
    the parameter and state tensors it was given."""
    rs = np.random.RandomState(3)
    p0 = _to_torch(_tree(rs))
    opt = topt.make_optimizer(name, **_kw(0.1, 0.5))
    fp, fs = p0, opt.init(p0)
    ip = {k: v.clone() for k, v in p0.items()}
    is_ = opt.init(ip)
    tensors = leaves(ip) + leaves({k: v for k, v in is_.items()
                                   if k != "count"})
    for _ in range(3):
        g = _to_torch(_tree(rs, scale=3.0))
        fp, fs = opt.update(fp, {k: v.clone() for k, v in g.items()}, fs)
        ip2, is_ = opt.update(ip, g, is_, inplace=True)
        assert ip2 is ip
    assert all(a is b for a, b in zip(
        tensors, leaves(ip) + leaves({k: v for k, v in is_.items()
                                      if k != "count"})))
    assert is_["count"] == fs["count"] == 3
    for a, b in zip(leaves(fp), leaves(ip)):
        assert torch.equal(a, b)
    for a, b in zip(leaves({k: v for k, v in fs.items() if k != "count"}),
                    leaves({k: v for k, v in is_.items() if k != "count"})):
        assert torch.equal(a, b)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_jax(max_norm):
    g = _tree(np.random.RandomState(5), scale=4.0)
    np.testing.assert_allclose(
        topt.global_norm(_to_torch(g)).item(),
        float(jopt.global_norm(_to_jax(g))), **BAND)
    got = topt.clip_by_global_norm(_to_torch(g), max_norm)
    want = jopt.clip_by_global_norm(_to_jax(g), max_norm)
    for k in want:
        assert got[k].dtype == getattr(torch, str(want[k].dtype))
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **BAND,
                                   err_msg=k)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("lion", 0.1)


# ------------------------------- ports of tests/test_substrates.py:32-53
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_reduces_quadratic(name):
    opt = topt.make_optimizer(name, lr=0.1)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(60):
        g = {"w": 2.0 * params["w"]}            # d/dw sum(w ** 2)
        params, state = opt.update(params, g, state)
    assert float(torch.sum(params["w"] ** 2)) < 0.05


def test_grad_clip():
    g = {"a": torch.full((4,), 10.0)}
    clipped = topt.clip_by_global_norm(g, 1.0)
    assert float(topt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    small = {"a": torch.full((4,), 0.01)}
    same = topt.clip_by_global_norm(small, 1.0)
    np.testing.assert_allclose(same["a"].numpy(), 0.01, rtol=1e-6)
