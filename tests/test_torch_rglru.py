"""The port's RG-LRU block (``repro_torch.models.rglru``) against a live
JAX run of ``repro.models.rglru`` on the CPU.

* ``associative_scan`` against ``jax.lax.associative_scan`` of the same
  combine on numpy inputs, at even, odd and power-of-two lengths (the
  recursion's every branch), in the golden band ``atol=2e-5, rtol=2e-4``,
  and against a sequential loop;
* ``rglru_forward`` on reduced recurrentgemma's weights carried across
  (output, conv tail and hidden state; with and without an initial
  state), ``rglru_decode`` steps after it, and the gradient of the
  forward through the scan, against the reference's;
* the port of ``tests/test_model_consistency.py:126``: the scan equals the
  block's own step-by-step decode, at the reference's tolerance
  ``atol=1e-4, rtol=1e-3``;
* ``init_rglru_block``: the reference's leaves, and ``lambda`` such that
  a^c = exp(-c softplus(lambda)) lies in (0.9^2, 0.999^2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.core.pytree import (flatten, from_jax_params,  # noqa: E402
                                     leaf_paths, value_and_grad)
from repro_torch.models import rglru as trglru  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)        # tests/test_golden_trajectory.py
REF_TOL = dict(atol=1e-4, rtol=1e-3)     # the reference's own scan test


def _close(got, want, what, tol=BAND):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol,
                               err_msg=what)


def _jcombine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("S", [1, 2, 3, 5, 8, 9, 31, 64, 100])
def test_associative_scan_matches_jax(S):
    rs = np.random.RandomState(S)
    a = rs.uniform(0.5, 1.0, (2, S, 6)).astype(np.float32)
    b = rs.randn(2, S, 6).astype(np.float32)
    ta, tb = trglru.associative_scan(torch.from_numpy(a),
                                     torch.from_numpy(b))
    ja, jb = jax.jit(lambda x, y: jax.lax.associative_scan(
        _jcombine, (x, y), axis=1))(jnp.asarray(a), jnp.asarray(b))
    _close(ta.numpy(), ja, "prod a")
    _close(tb.numpy(), jb, "h")
    h = np.zeros((2, 6), np.float32)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        _close(tb[:, t].numpy(), h, f"sequential h at {t}")


def _block(seed=0):
    cfg = tconfigs.get_config("recurrentgemma_9b").reduced()
    jcfg = jconfigs.get_config("recurrentgemma_9b").reduced()
    jp = jrglru.init_rglru_block(jax.random.PRNGKey(seed), jcfg)
    return (cfg, jcfg, jp,
            from_jax_params(jax.tree_util.tree_map(np.array, jp), "cpu"))


@pytest.mark.parametrize("with_init", [False, True])
def test_rglru_forward_and_decode_match_jax(with_init):
    cfg, jcfg, jp, p = _block()
    rs = np.random.RandomState(3)
    x = (rs.randn(2, 70, cfg.d_model) * 0.3).astype(np.float32)
    init = ({"h": rs.randn(2, cfg.rglru.lru_width).astype(np.float32)}
            if with_init else None)
    out, state = trglru.rglru_forward(
        p, torch.from_numpy(x), cfg,
        None if init is None else {"h": torch.from_numpy(init["h"])})
    jout, jstate = jax.jit(lambda q, xx, st: jrglru.rglru_forward(
        q, xx, jcfg, st))(jp, jnp.asarray(x), init)
    _close(out.numpy(), jout, "forward")
    assert sorted(state) == sorted(jstate)
    for k in jstate:
        assert tuple(state[k].shape) == jstate[k].shape, k
        _close(state[k].numpy(), jstate[k], f"state {k}")
    jdecode = jax.jit(lambda q, xx, st: jrglru.rglru_decode(q, xx, jcfg, st))
    for t in range(3):
        xt = (rs.randn(2, 1, cfg.d_model) * 0.3).astype(np.float32)
        out, state = trglru.rglru_decode(p, torch.from_numpy(xt), cfg, state)
        jout, jstate = jdecode(jp, jnp.asarray(xt), jstate)
        _close(out.numpy(), jout, f"decode {t}")
        for k in jstate:
            _close(state[k].numpy(), jstate[k], f"decode {t} state {k}")


def test_rglru_forward_gradient_matches_jax():
    """The gradient through the log-depth scan (every parameter leaf and
    the input) against ``jax.grad`` of the reference's."""
    cfg, jcfg, jp, p = _block(1)
    rs = np.random.RandomState(4)
    x = (rs.randn(2, 37, cfg.d_model) * 0.3).astype(np.float32)
    w = rs.randn(2, 37, cfg.d_model).astype(np.float32)

    def loss(tree, _):
        out = trglru.rglru_forward(tree["p"], tree["x"], cfg)[0]
        return (out * torch.from_numpy(w)).sum(), None
    _, _, grads = value_and_grad(loss, {"p": p, "x": torch.from_numpy(x)},
                                 None)
    jgrads = jax.jit(jax.grad(lambda t: (jrglru.rglru_forward(
        t["p"], t["x"], jcfg)[0] * w).sum()))({"p": jp, "x": jnp.asarray(x)})
    for (path, _, _), g, j in zip(leaf_paths(grads), flatten(grads)[0],
                                  jax.tree_util.tree_leaves(jgrads),
                                  strict=True):
        _close(g.numpy(), j, f"d / d {path}")


def test_rglru_scan_matches_stepwise():
    """``tests/test_model_consistency.py:126``: the full-sequence scan
    equals the block's own one-token decode, step by step."""
    cfg = tconfigs.get_config("recurrentgemma_9b").reduced()
    p = trglru.init_rglru_block(torch.Generator().manual_seed(0), cfg)
    B, S = 2, 9
    x = torch.from_numpy((np.random.RandomState(1).randn(
        B, S, cfg.d_model) * 0.3).astype(np.float32))
    y_full, final = trglru.rglru_forward(p, x, cfg)
    st = trglru.init_rglru_state(cfg, B)
    ys = []
    for t in range(S):
        y_t, st = trglru.rglru_decode(p, x[:, t:t + 1], cfg, st)
        ys.append(y_t)
    _close(y_full.numpy(), torch.cat(ys, dim=1).numpy(), "y", REF_TOL)
    _close(final["h"].numpy(), st["h"].numpy(), "h", REF_TOL)
    _close(final["conv"].numpy(), st["conv"].numpy(), "conv", REF_TOL)


def test_init_rglru_block_matches_reference_leaves():
    cfg = tconfigs.get_config("recurrentgemma_9b").reduced()
    jcfg = jconfigs.get_config("recurrentgemma_9b").reduced()
    p = trglru.init_rglru_block(torch.Generator().manual_seed(0), cfg,
                                lead=(2,))
    jp = jax.eval_shape(lambda k: jrglru.init_rglru_block(k, jcfg),
                        jax.random.PRNGKey(0))
    assert [q for q, _, _ in leaf_paths(p)] == sorted(jp)
    for t, j in zip(flatten(p)[0], jax.tree_util.tree_leaves(jp),
                    strict=True):
        assert tuple(t.shape) == (2,) + j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
    a_c = torch.exp(-trglru._C * trglru.softplus(p["lambda"]))
    assert float(a_c.min()) >= 0.9 ** 2 - 1e-6
    assert float(a_c.max()) <= 0.999 ** 2 + 1e-6
