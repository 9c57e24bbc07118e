"""The port's Mamba-2 SSD mixer (``repro_torch.models.ssm``) against a
live JAX run of ``repro.models.ssm`` on the CPU.

* ``ssd_scan`` on numpy inputs against the reference's, as hypothesis
  cases over batch, length (ragged against the chunk), heads, groups,
  state size, chunk (below, at and above the length) and an initial
  state; output and final state in the golden band ``atol=2e-5,
  rtol=2e-4``;
* the ports of ``tests/test_model_consistency.py:100`` (the chunked dual
  form equals the sequential recurrence) and of
  ``tests/test_perf_features.py:97`` (the output does not depend on the
  chunk, hypothesis over the reference's chunks), at the reference's
  tolerance ``atol=1e-4, rtol=1e-3``;
* ``_segsum``'s masked entries are ``-inf`` and ``exp`` makes them exact
  zeros, with a finite gradient; ``softplus`` is ``jax.nn.softplus``;
* the mixer on reduced mamba2's weights carried across: ``mamba2_forward``
  (output and decode state, also for a prompt shorter than the conv
  tail), 3 ``mamba2_decode`` steps, and the gradient of the forward;
  ``init_mamba2``'s leaves and distributions.
"""
try:
    import hypothesis
    import hypothesis.strategies as st
except ModuleNotFoundError:       # dev extra absent: property tests skip
    from _hypothesis_stub import hypothesis, st
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.core.pytree import (flatten, from_jax_params,  # noqa: E402
                                     leaf_paths, value_and_grad)
from repro_torch.models import ssm as tssm  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)        # tests/test_golden_trajectory.py
REF_TOL = dict(atol=1e-4, rtol=1e-3)     # the reference's own SSD tests


def _close(got, want, what, tol=BAND):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol,
                               err_msg=what)


def _inputs(seed, b, s, h, p, g, n):
    """The reference tests' distributions, drawn with numpy."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(b, s, h, p) * 0.5).astype(np.float32)
    dA = -np.logaddexp(rs.randn(b, s, h), 0.0).astype(np.float32)
    B = (rs.randn(b, s, g, n) * 0.5).astype(np.float32)
    C = (rs.randn(b, s, g, n) * 0.5).astype(np.float32)
    return x, dA, B, C


@hypothesis.given(st.integers(1, 2), st.integers(1, 40),
                  st.sampled_from([(2, 1), (4, 2), (4, 4)]),
                  st.sampled_from([4, 8]), st.sampled_from([3, 6]),
                  st.integers(1, 48), st.booleans(), st.integers(0, 99))
@hypothesis.settings(deadline=None, max_examples=12)
def test_ssd_scan_matches_jax(b, s, hg, p, n, chunk, with_init, seed):
    h, g = hg
    x, dA, B, C = _inputs(seed, b, s, h, p, g, n)
    init = (np.random.RandomState(seed + 1).randn(b, h, p, n).astype(
        np.float32) if with_init else None)
    y, final = tssm.ssd_scan(
        *(torch.from_numpy(a) for a in (x, dA, B, C)), chunk,
        None if init is None else torch.from_numpy(init))
    jy, jfinal = jax.jit(jssm.ssd_scan, static_argnums=4)(
        *(jnp.asarray(a) for a in (x, dA, B, C)), chunk,
        None if init is None else jnp.asarray(init))
    assert tuple(y.shape) == jy.shape and tuple(final.shape) == jfinal.shape
    assert y.dtype == torch.float32
    _close(y.numpy(), jy, "y")
    _close(final.numpy(), jfinal, "final state")


def test_ssd_scan_matches_naive_recurrence():
    """``tests/test_model_consistency.py:100``: chunked SSD (dual form) ==
    the sequential SSM recurrence."""
    b, s, h, p, g, n = 2, 23, 4, 8, 2, 6
    x, dA, B, C = (torch.from_numpy(a) for a in _inputs(0, b, s, h, p, g, n))
    y_chunk, final = tssm.ssd_scan(x, dA, B, C, chunk=5)
    hg = h // g
    Bh = torch.repeat_interleave(B, hg, dim=2)
    Ch = torch.repeat_interleave(C, hg, dim=2)
    state = torch.zeros((b, h, p, n))
    ys = []
    for t in range(s):
        decay = torch.exp(dA[:, t])                   # (b,h)
        state = (state * decay[..., None, None]
                 + x[:, t][..., None] * Bh[:, t][:, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    _close(y_chunk.numpy(), torch.stack(ys, dim=1).numpy(), "y", REF_TOL)
    _close(final.numpy(), state.numpy(), "final", REF_TOL)


@hypothesis.given(st.sampled_from([2, 3, 5, 7, 16, 23]))
@hypothesis.settings(deadline=None)
def test_ssd_scan_chunk_invariance(chunk):
    """``tests/test_perf_features.py:97``: the output does not depend on
    the chunk size (the dual-form identity)."""
    b, s, h, p, g, n = 1, 24, 2, 4, 1, 3
    args = [torch.from_numpy(a) for a in _inputs(1, b, s, h, p, g, n)]
    y_ref, st_ref = tssm.ssd_scan(*args, chunk=s)
    y, stt = tssm.ssd_scan(*args, chunk=chunk)
    _close(y.numpy(), y_ref.numpy(), "y", REF_TOL)
    _close(stt.numpy(), st_ref.numpy(), "state", REF_TOL)


def test_segsum_masked_entries_are_exact_zeros():
    x = torch.randn(3, 7, dtype=torch.float32, requires_grad=True)
    seg = tssm._segsum(x)
    L = torch.exp(seg)
    upper = ~torch.tril(torch.ones(7, 7, dtype=torch.bool))
    assert bool((seg[:, upper] == -torch.inf).all())
    assert bool((L[:, upper] == 0).all())
    # the -inf entries equal, the rest in the band (XLA's cumsum sums in
    # another order)
    _close(seg.detach().numpy(), jssm._segsum(jnp.asarray(
        x.detach().numpy())), "segsum")
    L.sum().backward()
    assert bool(torch.isfinite(x.grad).all())


def test_softplus_is_jax_softplus():
    """``logaddexp(x, 0)`` at every x, the reference's form (the two
    libraries' ``log1p`` and ``exp`` may differ by an ulp: the band)."""
    x = np.array([-100.0, -20.0, -1.5, 0.0, 1e-3, 3.0, 10.0, 15.0, 19.9,
                  20.0, 20.5, 35.0, 100.0], np.float32)
    _close(tssm.softplus(torch.from_numpy(x)).numpy(),
           jax.nn.softplus(jnp.asarray(x)), "softplus")


def _mixer(seed=0):
    cfg = tconfigs.get_config("mamba2_2_7b").reduced()
    jcfg = jconfigs.get_config("mamba2_2_7b").reduced()
    jp = jssm.init_mamba2(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, dt_bias=jp["dt_bias"] + 0.3)        # a non-zero bias
    return (cfg, jcfg, jp,
            from_jax_params(jax.tree_util.tree_map(np.array, jp), "cpu"))


@pytest.mark.parametrize("S", [37, 2])     # ragged vs chunk 32; < conv tail
def test_mamba2_forward_and_decode_match_jax(S):
    cfg, jcfg, jp, p = _mixer()
    x = (np.random.RandomState(S).randn(2, S, cfg.d_model) * 0.5).astype(
        np.float32)
    out, state = tssm.mamba2_forward(p, torch.from_numpy(x), cfg)
    jout, jstate = jax.jit(lambda q, xx: jssm.mamba2_forward(q, xx, jcfg))(
        jp, jnp.asarray(x))
    _close(out.numpy(), jout, "forward")
    assert sorted(state) == sorted(jstate)
    for k in jstate:
        assert tuple(state[k].shape) == jstate[k].shape, k
        assert state[k].dtype == torch.float32
        _close(state[k].numpy(), jstate[k], f"state {k}")
    if S < cfg.ssm.conv_width - 1:           # the reference's shape, kept
        assert state["conv"].shape[1] == S
        return
    jdecode = jax.jit(lambda q, xx, st: jssm.mamba2_decode(q, xx, jcfg, st))
    for t in range(3):
        xt = (np.random.RandomState(100 + t).randn(2, 1, cfg.d_model)
              * 0.5).astype(np.float32)
        out, state = tssm.mamba2_decode(p, torch.from_numpy(xt), cfg, state)
        jout, jstate = jdecode(jp, jnp.asarray(xt), jstate)
        _close(out.numpy(), jout, f"decode {t}")
        for k in jstate:
            _close(state[k].numpy(), jstate[k], f"decode {t} state {k}")


def test_mamba2_forward_gradient_matches_jax():
    cfg, jcfg, jp, p = _mixer(1)
    x = (np.random.RandomState(7).randn(2, 40, cfg.d_model) * 0.5).astype(
        np.float32)
    w = np.random.RandomState(8).randn(2, 40, cfg.d_model).astype(np.float32)

    def loss(params, xx):
        return (tssm.mamba2_forward(params, xx, cfg)[0]
                * torch.from_numpy(w)).sum(), None
    _, _, grads = value_and_grad(loss, p, torch.from_numpy(x))
    jgrads = jax.jit(jax.grad(lambda q: (jssm.mamba2_forward(
        q, jnp.asarray(x), jcfg)[0] * w).sum()))(jp)
    for (path, _, _), g, j in zip(leaf_paths(grads), flatten(grads)[0],
                                  jax.tree_util.tree_leaves(jgrads),
                                  strict=True):
        _close(g.numpy(), j, f"d / d {path}")


def test_init_mamba2_matches_reference_leaves():
    """Leaves, shapes and dtypes of the reference's ``init_mamba2`` with a
    layer axis; ``A_log`` and ``D`` equal, ``conv_w`` N(0, 0.1)."""
    cfg = tconfigs.get_config("mamba2_2_7b").reduced()
    jcfg = jconfigs.get_config("mamba2_2_7b").reduced()
    p = tssm.init_mamba2(torch.Generator().manual_seed(0), cfg, lead=(3,))
    jp = jssm.init_mamba2(jax.random.PRNGKey(0), jcfg)
    assert [q for q, _, _ in leaf_paths(p)] == [
        jax.tree_util.keystr(k) .replace("']['", "/").strip("[]'")
        for k, _ in jax.tree_util.tree_leaves_with_path(jp)]
    for t, j in zip(flatten(p)[0], jax.tree_util.tree_leaves(jp),
                    strict=True):
        assert tuple(t.shape) == (3,) + j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
    for k in ("A_log", "D", "dt_bias"):      # log may differ by an ulp
        for layer in p[k]:
            _close(layer.numpy(), jp[k], k)
    assert abs(float(p["conv_w"].std()) - 0.1) < 0.01
