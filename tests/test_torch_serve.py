"""The port's serving loop (``repro_torch.core.serve``) against a live JAX
run on the CPU: every case of ``tests/test_serve.py``, and a parity test.

* FedBuff bookkeeping invariants round over round (clock monotone, the
  version up by one, one in-flight dispatch a client), payloads with the
  encode's structure (held against the reference's ``jax.eval_shape``),
  determinism, the re-dispatched versions filled from the device's global
  version equal to ``index_fill_`` of it read back, the double buffer
  (the input state consumed, round r+1 written into the generation round
  r read from, allocation flat), the report and its bytes (equal to the
  reference's ``round_bytes``), a caller's flat model; ``shard=True``
  needs an initialised ``torch.distributed`` group and raises without
  one;
* parity: under ``jax.disable_jit()`` (so a patched draw is read every
  round, not baked into one trace) ``monkeypatch`` hands the reference's
  ``synthetic_payloads`` and ``jax.random.uniform`` the same numpy draws
  that go into the port's two seams (``serve.synthetic_payloads``,
  ``serve._uniform``); six rounds of q8 and of the chunked AE (the
  port's kernel path, plain on the CPU): times, seqs and versions exact,
  ``global_flat`` and the clock in the golden band ``atol=2e-5,
  rtol=2e-4``; the same with ``shard=True`` on a one-rank gloo group
  against the reference's ``shard=True`` on its one device, and on two
  gloo ranks (two processes, each reducing half the cohort) against the
  reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import codec as jcodec  # noqa: E402
from repro.core import serve as jserve  # noqa: E402
from repro.core.autoencoder import ChunkedAEConfig as JChunkedAEConfig  # noqa: E402,E501
from repro.core.autoencoder import init_chunked_ae  # noqa: E402

from repro_torch.core import codec  # noqa: E402
from repro_torch.core import serve  # noqa: E402
from repro_torch.core.autoencoder import ChunkedAEConfig  # noqa: E402
from repro_torch.core.pytree import (flatten, from_jax_params,  # noqa: E402
                                     unflatten)
from repro_torch.core.serve import (init_state, make_step,  # noqa: E402
                                    round_bytes, run_serve,
                                    synthetic_payloads)

BAND = dict(atol=2e-5, rtol=2e-4)        # tests/test_golden_trajectory.py
Q8 = codec.QuantizeSpec(size=512, bits=8, block=128)
CPU = "cpu"


def _cfg(pkg=None, **kw):
    base = dict(n_clients=64, buffer_k=8, spec=Q8, jitter=0.4,
                straggler_frac=0.1, seed=1)
    base.update(kw)
    return (pkg or serve).ServeConfig(**base)


def test_step_invariants_over_rounds():
    cfg = _cfg()
    step = make_step(cfg, device=CPU)
    state = init_state(cfg, device=CPU)
    prev_clock = -1.0
    for r in range(6):
        state = step(state)
        assert int(state["version"]) == r + 1
        clock = float(state["clock"])
        assert clock >= prev_clock
        prev_clock = clock
        times = state["times"].numpy()
        assert np.all(np.isfinite(times))
        seqs = state["seqs"].numpy()
        assert len(np.unique(seqs)) == cfg.n_clients
        assert int(state["next_seq"]) == cfg.n_clients + (r + 1) * cfg.buffer_k
        assert np.all(times[seqs >= int(state["next_seq"]) - cfg.buffer_k]
                      >= clock)
        assert int(state["versions"].max()) <= int(state["version"])


@pytest.mark.parametrize("spec", [
    Q8,
    codec.IdentitySpec(size=256),
    codec.TopKSpec(size=1024, k=64),
])
def test_synthetic_payloads_match_encode_structure(spec):
    """Same tree, per-leaf shapes ``(k, *encode_shape)`` and dtypes as the
    port's encode and as the reference's ``jax.eval_shape``; the port's
    batched decode consumes them."""
    k = 4
    want = codec.encode(spec, None, torch.zeros(spec.size))
    got = synthetic_payloads(spec, None, k, torch.Generator().manual_seed(0))
    w_leaves, w_def = flatten(want)
    g_leaves, g_def = flatten(got)
    assert w_def == g_def
    for w, g in zip(w_leaves, g_leaves, strict=True):
        assert tuple(g.shape) == (k, *w.shape) and g.dtype == w.dtype
    jspec = getattr(jcodec, type(spec).__name__)(
        **{f: getattr(spec, f) for f in spec.__dataclass_fields__})
    ref = jax.eval_shape(lambda f: jcodec.encode(jspec, None, f),
                         jax.ShapeDtypeStruct((spec.size,), jnp.float32))
    r_leaves = jax.tree_util.tree_leaves(ref)
    for r, g in zip(r_leaves, g_leaves, strict=True):
        assert tuple(g.shape) == (k, *r.shape)
        assert str(g.dtype).replace("torch.", "") == str(r.dtype)
    rows = codec.decode_batched(spec, None, got)
    assert tuple(rows.shape) == (k, spec.size)


def test_step_deterministic():
    cfg = _cfg()
    sa, sb = init_state(cfg, device=CPU), init_state(cfg, device=CPU)
    step_a, step_b = make_step(cfg, device=CPU), make_step(cfg, device=CPU)
    for _ in range(4):
        sa, sb = step_a(sa), step_b(sb)
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key


def test_versions_fill_equals_the_read_back_fill():
    """The re-dispatched clients' versions, filled from the device's
    global version, ``torch.equal`` round by round to ``index_fill_`` with
    that version read back as a host scalar, from a state whose global
    version is not zero and whose clients hold differing versions."""
    cfg = _cfg(n_clients=48, buffer_k=6)
    step = make_step(cfg, device=CPU)
    state = init_state(cfg, device=CPU)
    state["version"].fill_(37)
    state["versions"].copy_(torch.randint(
        30, 38, (cfg.n_clients,), generator=torch.Generator().manual_seed(3),
        dtype=torch.int32))
    for r in range(6):
        versions, version = state["versions"].clone(), int(state["version"])
        next_seq = int(state["next_seq"])
        _, idx = serve.pop_k_device(state["times"], state["seqs"],
                                    cfg.buffer_k)
        want = versions.index_fill_(0, idx.long(), version + 1)
        state = step(state)
        assert state["versions"].dtype == torch.int32
        assert torch.equal(state["versions"], want), r
        assert torch.equal(torch.nonzero(state["seqs"] >= next_seq).ravel(),
                           idx.long().sort()[0])
        assert int(state["version"]) == 38 + r


def test_double_buffer_consumes_input_state():
    """The counterpart of donation: the passed state is consumed, round
    r+1 lands in the generation round r read from, and nothing new is
    held from the second round on."""
    cfg = _cfg(n_clients=32, buffer_k=4)
    step = make_step(cfg, device=CPU)
    state = init_state(cfg, device=CPU)
    out = step(state)
    assert state == {}
    out2 = step(out)
    assert out == {} and torch.isfinite(out2["global_flat"]).all()
    ptrs = {k: v.data_ptr() for k, v in out2.items()}
    out3 = step(out2)
    assert all(out3[k].data_ptr() != ptrs[k] for k in ptrs)
    out4 = step(out3)
    assert {k: v.data_ptr() for k, v in out4.items()} == ptrs
    assert int(out4["version"]) == 4


def test_run_serve_report_and_bytes():
    cfg = _cfg(n_clients=128, buffer_k=16)
    state, report = run_serve(cfg, n_rounds=3, warmup=1, device=CPU)
    assert int(state["version"]) == 4
    assert report["rounds_per_sec"] > 0
    assert report["round_bytes"] == round_bytes(cfg)
    assert round_bytes(cfg) == jserve.round_bytes(_cfg(
        jserve, n_clients=128, buffer_k=16,
        spec=jcodec.QuantizeSpec(size=512, bits=8, block=128)))
    assert report["bytes_per_sec"] == pytest.approx(
        report["rounds_per_sec"] * report["round_bytes"])
    assert report["sim_time"] > 0


def test_global_flat_seed_passthrough():
    cfg = _cfg(n_clients=32, buffer_k=4)
    g0 = torch.full((Q8.size,), 2.0)
    state = init_state(cfg, global_flat=g0, device=CPU)
    assert torch.equal(state["global_flat"], g0)
    assert state["global_flat"].data_ptr() != g0.data_ptr()


def test_shard_raises_naming_item_12():
    """The reference's ``shard=True`` inlines a ``shard_map`` over a device
    mesh; the port's counterpart reduces over a ``torch.distributed``
    group, so with no initialised group building its step raises (it
    never runs quietly as a world of one)."""
    cfg = _cfg(shard=True)
    with pytest.raises(RuntimeError, match="process group"):
        make_step(cfg, device=CPU)
    with pytest.raises(RuntimeError, match="process group"):
        run_serve(cfg, n_rounds=1, device=CPU)


# ------------------------------------------------------------ parity
class _Draws:
    """One numpy stream of draws a package; both packages ask in the same
    order with the same shapes, so they receive identical arrays."""

    def __init__(self, seed: int):
        self.rng = np.random.RandomState(seed)

    def uniform(self, shape):
        return self.rng.uniform(size=shape).astype(np.float32)

    def leaf(self, shape, dtype: str, size: int):
        if dtype.startswith("float"):
            return self.rng.standard_normal(shape).astype(dtype)
        if dtype == "int8":
            return self.rng.randint(-127, 128, size=shape).astype(np.int8)
        # top-k style indices: distinct within a client's row
        rows = [self.rng.permutation(max(size, 2))[:shape[-1]]
                for _ in range(int(np.prod(shape[:-1])))]
        return np.asarray(rows).reshape(shape).astype(dtype)


def _port_draws(seed):
    """The port's two seams fed from one numpy stream."""
    td = _Draws(seed)

    def t_uniform(gen, shape):
        return torch.from_numpy(td.uniform(tuple(shape))).to(gen.device)

    def t_synth(spec, params, k, gen):
        treedef, leaf_sig = serve._payload_structure(
            spec, serve._signature(params))
        return unflatten(treedef, [
            torch.from_numpy(td.leaf((k, *shape),
                                     str(dtype).replace("torch.", ""),
                                     spec.size))
            for shape, dtype in leaf_sig])
    return t_uniform, t_synth


def _patch(monkeypatch, seed):
    jd = _Draws(seed)

    def j_uniform(key, shape, dtype=jnp.float32, *a, **kw):
        return jnp.asarray(jd.uniform(tuple(shape)))

    def j_synth(spec, params, k, key):
        shapes = jax.eval_shape(
            lambda f: jcodec.encode(spec, params, f),
            jax.ShapeDtypeStruct((spec.size,), jnp.float32))
        leaves, treedef = jax.tree_util.tree_flatten(shapes)
        return jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(jd.leaf((k, *x.shape), str(x.dtype), spec.size))
            for x in leaves])

    t_uniform, t_synth = _port_draws(seed)
    monkeypatch.setattr(jax.random, "uniform", j_uniform)
    monkeypatch.setattr(jserve, "synthetic_payloads", j_synth)
    monkeypatch.setattr(serve, "_uniform", t_uniform)
    monkeypatch.setattr(serve, "synthetic_payloads", t_synth)


def _specs(kind):
    if kind == "q8":
        return (jcodec.QuantizeSpec(size=512, bits=8, block=128), None,
                codec.QuantizeSpec(size=512, bits=8, block=128), None)
    jcfg = JChunkedAEConfig(chunk_size=64, hidden=(16,), latent_chunk=4)
    pj = init_chunked_ae(jax.random.PRNGKey(3), jcfg)
    pj = dict(pj, norm={"mean": jnp.float32(0.01), "std": jnp.float32(0.5)})
    pt = from_jax_params(jax.tree_util.tree_map(np.array, pj), CPU)
    return (jcodec.ChunkedAESpec(size=640, cfg=jcfg, use_kernel=False), pj,
            codec.ChunkedAESpec(size=640, cfg=ChunkedAEConfig(64, (16,), 4),
                                use_kernel=True), pt)


@pytest.mark.parametrize("kind", ["q8", "chunked_ae"])
def test_step_matches_reference_on_identical_draws(kind, monkeypatch):
    jspec, pj, tspec, pt = _specs(kind)
    kw = dict(n_clients=48, buffer_k=6, jitter=0.4, straggler_frac=0.1,
              seed=2, staleness_power=0.5, server_lr=0.5)
    _patch(monkeypatch, seed=11)
    jcfg = jserve.ServeConfig(spec=jspec, **kw)
    tcfg = serve.ServeConfig(spec=tspec, **kw)
    assert serve.round_bytes(tcfg, pt) == jserve.round_bytes(jcfg, pj)
    with jax.disable_jit():
        js = jserve.init_state(jcfg, pj)
        ts = serve.init_state(tcfg, pt, device=CPU)
        jstep, tstep = jserve.make_step(jcfg, pj), serve.make_step(tcfg, pt,
                                                                   device=CPU)
        for r in range(7):
            for key in ("times", "seqs", "versions"):
                np.testing.assert_array_equal(ts[key].numpy(),
                                              np.asarray(js[key]),
                                              err_msg=f"{key} round {r}")
            for key in ("version", "next_seq"):
                assert int(ts[key]) == int(js[key]), (key, r)
            np.testing.assert_allclose(float(ts["clock"]),
                                       float(js["clock"]), **BAND)
            np.testing.assert_allclose(ts["global_flat"].numpy(),
                                       np.asarray(js["global_flat"]), **BAND)
            if r < 6:
                js, ts = jstep(js), tstep(ts)
    assert int(ts["version"]) == 6
    assert float(ts["clock"]) > 0 and float(ts["global_flat"].abs().max()) > 0


KW = dict(n_clients=48, buffer_k=6, jitter=0.4, straggler_frac=0.1,
          seed=2, staleness_power=0.5, server_lr=0.5)


def _reference_rounds(jspec, pj, rounds, shard):
    jcfg = jserve.ServeConfig(spec=jspec, shard=shard, **KW)
    with jax.disable_jit():
        js = jserve.init_state(jcfg, pj)
        jstep = jserve.make_step(jcfg, pj)
        for _ in range(rounds):
            js = jstep(js)
    return {k: np.asarray(v) for k, v in js.items()}


def _hold(ts, js):
    for key in ("times", "seqs", "versions"):
        np.testing.assert_array_equal(np.asarray(ts[key]), js[key],
                                      err_msg=key)
    for key in ("version", "next_seq"):
        assert int(ts[key]) == int(js[key]), key
    np.testing.assert_allclose(float(ts["clock"]), float(js["clock"]),
                               **BAND)
    np.testing.assert_allclose(np.asarray(ts["global_flat"]),
                               js["global_flat"], **BAND)


@pytest.mark.parametrize("kind", ["q8", "chunked_ae"])
def test_shard_step_matches_reference_on_identical_draws(kind, monkeypatch,
                                                         tmp_path):
    """``ServeConfig(shard=True)`` on a one-rank gloo group against the
    reference's ``shard=True`` (a ``shard_map`` over its one device) on
    identical draws, four rounds."""
    import torch.distributed as dist
    jspec, pj, tspec, pt = _specs(kind)
    _patch(monkeypatch, seed=11)
    js = _reference_rounds(jspec, pj, 4, shard=True)
    tcfg = serve.ServeConfig(spec=tspec, shard=True, **KW)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        ts = serve.init_state(tcfg, pt, device=CPU)
        tstep = serve.make_step(tcfg, pt, device=CPU)
        for _ in range(4):
            ts = tstep(ts)
    finally:
        dist.destroy_process_group()
    _hold(ts, js)


def _shard_worker(rank, world, kind, rounds):
    """One rank of a sharded serve run on the port's seams, fed the same
    numpy draws on every rank."""
    _, _, tspec, pt = _specs(kind)
    serve._uniform, serve.synthetic_payloads = _port_draws(11)
    tcfg = serve.ServeConfig(spec=tspec, shard=True, **KW)
    ts = serve.init_state(tcfg, pt, device=CPU)
    step = serve.make_step(tcfg, pt, device=CPU)
    for _ in range(rounds):
        ts = step(ts)
    return {k: v.clone() for k, v in ts.items()}


def test_shard_two_ranks_matches_reference(monkeypatch, tmp_path):
    """Two gloo ranks, each reducing 3 of the 6 buffered clients: four
    rounds of the chunked AE on identical draws, against the reference's
    unsharded serve; both ranks hold the same state."""
    from repro_torch.launch.local import spawn
    jspec, pj, _, _ = _specs("chunked_ae")
    _patch(monkeypatch, seed=11)
    js = _reference_rounds(jspec, pj, 4, shard=False)
    res = spawn("test_torch_serve:_shard_worker", 2,
                {"kind": "chunked_ae", "rounds": 4}, tmp_path / "run",
                backend="gloo", timeout=180,
                path=[__file__.rsplit("/", 1)[0]])
    for ts in res:
        _hold(ts, js)
    for k in res[0]:
        assert torch.equal(res[0][k], res[1][k]), k
