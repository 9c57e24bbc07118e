"""The port's LM (the dense and MoE families, GQA and MLA attention)
against a live JAX run on the CPU.

* the config copies equal the JAX package's for all ten architectures, and
  so do their ``reduced()`` variants;
* ``llama3_8b.reduced()``, ``stablelm_1_6b.reduced()`` (LayerNorm, partial
  rope) and ``deepseek_coder_33b.reduced()`` with 14 heads over 2 KV heads
  (a GQA group of 7): ``train_loss``, prefill logits and cache, then 4
  ``decode_step``s, on the JAX package's own weights carried across, with a
  linear cache and with a ring cache (``window < cache_len``); everything
  in the golden band ``atol=2e-5, rtol=2e-4``;
* ``train_loss``'s gradient on the reduced llama3 / stablelm configs
  against ``jax.grad`` of the reference's, every parameter leaf in the
  golden band, and the attention route that takes it (the differentiable
  chunked math wherever autograd records through q, k or v);
* the full-width deepseek-coder-33b tree (33.3 billion parameters): leaf
  paths, shapes and dtypes equal ``jax.eval_shape`` of the reference's
  ``init_params`` in flat order, built under ``FakeTensorMode`` so nothing
  is allocated;
* reduced minicpm3-4b (MLA), dbrx-132b (MoE, top-2 of 4 experts) and
  llama4-maverick (MoE, top-1, a shared expert): ``train_loss`` (with
  ``moe_aux``) and its gradient against ``jax.grad``, prefill logits and
  cache (MLA's ``c_kv``/``k_rope`` latents), 3 decode steps, and the port
  of ``tests/test_model_consistency.py:33-46`` (decode equals the full
  forward) for minicpm3-4b and dbrx-132b;
* MoE ``route``: dispatch and combine masks exact against the reference's
  (including capacities that drop tokens), combine weights and the
  aux-loss terms in the golden band; ``_group_size`` equal;
* remat: ``train_loss``'s gradients with ``cfg.remat`` on and off are
  ``torch.equal`` for a dense, an MLA and an MoE reduced config, and
  prefill never checkpoints;
* the full-width minicpm3-4b and dbrx-132b trees against
  ``jax.eval_shape`` (``FakeTensorMode``).

The SSM, hybrid, audio and VLM families are held in
``tests/test_torch_families.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.models as tmodels  # noqa: E402
from repro_torch.core.pytree import (flatten, from_jax_params,  # noqa: E402
                                     leaf_paths, value_and_grad)
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)        # tests/test_golden_trajectory.py
B, S, N_DECODE = 2, 24, 4


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **BAND,
                               err_msg=what)


def _reduced(arch):
    cfg = tconfigs.get_config(arch).reduced()
    jcfg = jconfigs.get_config(arch).reduced()
    if arch == "deepseek_coder_33b":          # G = 7, as at full width
        cfg = dataclasses.replace(cfg, n_heads=14, n_kv_heads=2)
        jcfg = dataclasses.replace(jcfg, n_heads=14, n_kv_heads=2)
    return cfg, jcfg


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_configs_equal_jax(arch):
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.padded_vocab == j.padded_vocab and t.q_dim == j.q_dim
    assert tconfigs.canonical_arch_id(t.name) == arch


def test_synthetic_lm_batch_bit_identical():
    t = tpipe.synthetic_lm_batch(5, 1000, 3, 17)
    j = jpipe.synthetic_lm_batch(5, 1000, 3, 17)
    for k in ("tokens", "labels"):
        assert np.array_equal(t[k].numpy(), np.asarray(j[k]))


def _compare_cache(tc, jc, what):
    assert tc["index"] == int(jc["index"]), what
    assert sorted(tc["layers"]) == sorted(jc["layers"]), what
    for k, jv in jc["layers"].items():
        tv = tc["layers"][k]
        assert tuple(tv.shape) == jv.shape, (what, k)
        if k == "pos":
            assert np.array_equal(tv.numpy(), np.asarray(jv)), (what, k)
        else:
            _close(tv.numpy(), jv, f"{what}: cache {k}")


@pytest.mark.parametrize("window", [None, 16])    # linear / ring cache
@pytest.mark.parametrize("arch", ["llama3_8b", "stablelm_1_6b",
                                  "deepseek_coder_33b"])
def test_dense_lm_matches_jax(arch, window):
    cfg, jcfg = _reduced(arch)
    jparams = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(_np(jparams), "cpu")
    batch = tpipe.synthetic_lm_batch(1, cfg.vocab_size, B, S)
    jbatch = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()}
    before = _lib.counts()

    loss, metrics = tmodels.train_loss(params, cfg, batch)
    jloss, jmetrics = jmodels.train_loss(jparams, jcfg, jbatch)
    _close(loss.item(), float(jloss), "train_loss")
    _close(metrics["accuracy"].item(), float(jmetrics["accuracy"]),
           "accuracy")

    cache_len = S + N_DECODE
    logits, cache = tmodels.prefill(params, cfg, batch, cache_len, window)
    jlogits, jcache = jmodels.prefill(jparams, jcfg, jbatch, cache_len,
                                      window)
    assert tuple(logits.shape) == (B, cfg.padded_vocab)
    _close(logits.numpy(), jlogits, "prefill logits")
    _compare_cache(cache, jcache, "prefill")
    if window is not None:
        assert cache["layers"]["k"].shape[2] == window     # ring of 16

    token = jnp.argmax(jlogits[:, :cfg.vocab_size], axis=-1)[:, None]
    for step in range(N_DECODE):
        logits, cache = tmodels.decode_step(
            params, cfg, torch.from_numpy(np.array(token, np.int64)), cache,
            window)
        jlogits, jcache = jmodels.decode_step(jparams, jcfg, token, jcache,
                                              window)
        _close(logits.numpy(), jlogits, f"decode step {step}")
        token = jnp.argmax(jlogits[:, :cfg.vocab_size], axis=-1)[:, None]
    _compare_cache(cache, jcache, "after decode")
    assert _lib.counts() == before            # CPU tensors: plain versions


@pytest.mark.parametrize("arch", ["llama3_8b", "stablelm_1_6b",
                                  "minicpm3_4b", "dbrx_132b",
                                  "llama4_maverick_400b_a17b"])
def test_train_loss_gradient_matches_jax(arch):
    """The gradient of ``train_loss`` with respect to every parameter leaf,
    the port's autograd against ``jax.grad`` of the reference, from the
    reference's own weights carried across: the attention is the chunked
    online-softmax math on both sides, differentiated through."""
    cfg, jcfg = _reduced(arch)
    jparams = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(_np(jparams), "cpu")
    batch = tpipe.synthetic_lm_batch(1, cfg.vocab_size, B, S)
    jbatch = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()}
    loss, _, grads = value_and_grad(
        lambda p, bt: tmodels.train_loss(p, cfg, bt), params, batch)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodels.train_loss(p, jcfg, jbatch)[0])(jparams)
    _close(loss.item(), float(jloss), "train_loss")
    got, _ = flatten(grads)
    want = jax.tree_util.tree_leaves(jgrads)
    paths = [p for p, _, _ in leaf_paths(grads)]
    assert len(got) == len(want) == len(paths) > 0
    for path, g, j in zip(paths, got, want):
        assert tuple(g.shape) == j.shape, path
        _close(g.numpy(), j, f"d train_loss / d {path}")
    assert any(float(g.abs().max()) > 0 for g in got)


def test_attention_route_follows_autograd():
    """The model-level attention takes the plain, differentiable route
    exactly where autograd records through q, k or v; every other call
    takes kernel 6 on a CUDA tensor."""
    from repro_torch.models.attention import attention_route
    q = torch.zeros((1, 4, 2, 16))
    k = torch.zeros((1, 4, 1, 16), requires_grad=True)
    assert attention_route(q, q, q) == "kernel"
    assert attention_route(q, k, q) == "plain"
    with torch.no_grad():
        assert attention_route(q, k, q) == "kernel"


def test_full_width_tree_matches_jax_eval_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = tconfigs.get_config("deepseek_coder_33b")
    shapes = jax.eval_shape(
        lambda k: jmodels.init_params(k, jconfigs.get_config(
            "deepseek_coder_33b")), jax.random.PRNGKey(0))
    jleaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    with FakeTensorMode():
        params = tmodels.init_params(torch.Generator(), cfg, "cpu")
        got = [(tuple(t.shape), str(t.dtype).split(".")[-1])
               for t in flatten(params)[0]]
        paths = [p for p, _, _ in leaf_paths(params)]
        n = tmodels.param_count(params)
    want = [(tuple(s.shape), str(s.dtype)) for _, s in jleaves]
    want_paths = ["/".join(str(getattr(e, "key", e)) for e in path)
                  for path, _ in jleaves]
    assert paths == want_paths
    assert got == want
    assert n == sum(int(np.prod(s.shape)) for _, s in jleaves) \
        == 33_342_991_360


def test_init_params_seeded_and_distributed():
    """Same generator seed, same weights; the reference's distributions
    (truncated normal within ±2 × the fan-in scale, embeddings
    N(0, 0.02))."""
    cfg, _ = _reduced("llama3_8b")
    a = tmodels.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    b = tmodels.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    for x, y in zip(flatten(a)[0], flatten(b)[0]):
        assert torch.equal(x, y)
    wq = a["layers"]["attn"]["wq"]
    assert tuple(wq.shape) == (cfg.n_layers, cfg.d_model, cfg.q_dim)
    assert float(wq.abs().max()) <= 2.0 * cfg.d_model ** -0.5 + 1e-7
    assert abs(float(a["embed"].std()) - 0.02) < 1e-3
    assert tmodels.param_count(a) == jmodels.param_count(
        jax.eval_shape(lambda k: jmodels.init_params(k, _reduced(
            "llama3_8b")[1]), jax.random.PRNGKey(0)))


def test_lm_entry_points_raise_without_a_card():
    """No fallback: the default device is CUDA, refused without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal path cannot run")
    cfg, _ = _reduced("llama3_8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.init_cache(cfg, 1, 8)


# =====================================================================
# MLA and MoE
# =====================================================================
NEW_ARCHS = ["minicpm3_4b", "dbrx_132b", "llama4_maverick_400b_a17b"]
S_NEW = 16


def _carried(arch, seed=0):
    cfg, jcfg = _reduced(arch)
    jparams = jmodels.init_params(jax.random.PRNGKey(seed), jcfg)
    return cfg, jcfg, jparams, from_jax_params(_np(jparams), "cpu")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_mla_moe_lm_matches_jax(arch):
    """``train_loss`` and its metrics (``moe_aux`` on the MoE family),
    prefill logits and cache, 3 decode steps and the cache after them."""
    cfg, jcfg, jparams, params = _carried(arch)
    batch = tpipe.synthetic_lm_batch(2, cfg.vocab_size, B, S_NEW)
    jbatch = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()}
    loss, metrics = tmodels.train_loss(params, cfg, batch)
    jloss, jmetrics = jmodels.train_loss(jparams, jcfg, jbatch)
    assert sorted(metrics) == sorted(jmetrics)
    assert ("moe_aux" in metrics) == (cfg.family == "moe")
    for k in jmetrics:
        _close(metrics[k].item(), float(jmetrics[k]), k)

    cache_len = S_NEW + 3
    logits, cache = tmodels.prefill(params, cfg, batch, cache_len)
    jlogits, jcache = jmodels.prefill(jparams, jcfg, jbatch, cache_len)
    _close(logits.numpy(), jlogits, "prefill logits")
    _compare_cache(cache, jcache, "prefill")
    if cfg.attn_type == "mla":
        assert sorted(cache["layers"]) == ["c_kv", "k_rope"]
    token = jnp.argmax(jlogits[:, :cfg.vocab_size], axis=-1)[:, None]
    for step in range(3):
        logits, cache = tmodels.decode_step(
            params, cfg, torch.from_numpy(np.array(token, np.int64)), cache)
        jlogits, jcache = jmodels.decode_step(jparams, jcfg, token, jcache)
        _close(logits.numpy(), jlogits, f"decode step {step}")
        token = jnp.argmax(jlogits[:, :cfg.vocab_size], axis=-1)[:, None]
    _compare_cache(cache, jcache, "after decode")


@pytest.mark.parametrize("arch", ["minicpm3_4b", "dbrx_132b"])
def test_decode_matches_full_forward(arch):
    """The port of ``tests/test_model_consistency.py:33-46``: decoding
    token S after prefilling S tokens equals the last-position logits of a
    full (S+1)-token forward, at the reference's tolerance."""
    cfg = tconfigs.get_config(arch).reduced()
    params = tmodels.init_params(torch.Generator().manual_seed(1), cfg,
                                 "cpu")
    S = 12
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (B, S + 1)))
    _, cache = tmodels.prefill(params, cfg, {"tokens": toks[:, :S]},
                               cache_len=32)
    lg_dec, _ = tmodels.decode_step(params, cfg, toks[:, S:S + 1], cache)
    lg_full, _ = tmodels.prefill(params, cfg, {"tokens": toks},
                                 cache_len=33)
    np.testing.assert_allclose(lg_dec.numpy(), lg_full.numpy(), atol=2e-5,
                               rtol=2e-3)


@pytest.mark.parametrize("G,S,E,top_k,capacity,kept", [
    (4, 16, 4, 2, 10, 126),  # reduced dbrx: 16 * 1.25 * 2 / 4; 2 dropped
    (2, 16, 4, 2, 3, 24),    # capacity drops 40 of 64
    (3, 8, 4, 1, 2, 16),     # top-1, drops 8 of 24
    (1, 32, 8, 4, 4, 32),    # top-4 of 8
])
def test_route_matches_jax(G, S, E, top_k, capacity, kept):
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    cfg = dataclasses.replace(
        tconfigs.get_config("dbrx_132b").reduced(),
        moe=tconfigs.base.MoEConfig(n_experts=E, top_k=top_k,
                                    d_ff_expert=64))
    jcfg = dataclasses.replace(
        jconfigs.get_config("dbrx_132b").reduced(),
        moe=jconfigs.base.MoEConfig(n_experts=E, top_k=top_k,
                                    d_ff_expert=64))
    logits = np.random.RandomState(G * S + E).randn(G, S, E).astype(
        np.float32)
    logits[0, :4] = 0.5                         # ties: the first index wins
    d, c, (lb, zl) = tmoe.route(torch.from_numpy(logits), cfg, capacity)
    jd, jc, (jlb, jzl) = jmoe.route(jnp.asarray(logits), jcfg, capacity)
    assert np.array_equal(d.numpy(), np.asarray(jd))
    assert np.array_equal(c.numpy() > 0, np.asarray(jc) > 0)
    _close(c.numpy(), jc, "combine")
    _close(lb.item(), float(jlb), "load balance")
    _close(zl.item(), float(jzl), "z loss")
    assert int(d.sum()) == kept < top_k * G * S     # tokens dropped
    assert int(d.sum(dim=1).amax()) <= 1            # a slot holds one token


def test_group_size_matches_jax():
    from repro.models.model import _group_size as jgs
    from repro_torch.models.model import _group_size as tgs
    for n in (1, 2, 7, 16, 24, 32, 100, 256, 1024, 4096, 8192, 3000):
        assert tgs(n) == jgs(n), n


@pytest.mark.parametrize("arch", ["llama3_8b", "minicpm3_4b", "dbrx_132b"])
def test_remat_gradients_equal(arch):
    """``cfg.remat`` checkpoints each layer while autograd records: the
    gradients are the same bits, the loss too; prefill and no-grad
    evaluation never checkpoint."""
    cfg, _ = _reduced(arch)
    params = tmodels.init_params(torch.Generator().manual_seed(5), cfg,
                                 "cpu")
    batch = tpipe.synthetic_lm_batch(3, cfg.vocab_size, B, S_NEW)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = value_and_grad(
            lambda p, bt, c=c: tmodels.train_loss(p, c, bt), params, batch)
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(flatten(out[False][2])[0], flatten(out[True][2])[0],
                    strict=True):
        assert torch.equal(a, b)
    import torch.utils.checkpoint as ckpt
    from repro_torch.models import model as model_lib
    calls = []
    real = model_lib.checkpoint

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    model_lib.checkpoint = spy
    try:
        rc = dataclasses.replace(cfg, remat=True)
        value_and_grad(lambda p, bt: tmodels.train_loss(p, rc, bt), params,
                       batch)
        assert len(calls) == cfg.n_layers
        with torch.no_grad():
            tmodels.train_loss(params, rc, batch)
        tmodels.prefill(params, rc, batch)
        assert len(calls) == cfg.n_layers
    finally:
        model_lib.checkpoint = real
    assert real is ckpt.checkpoint


@pytest.mark.parametrize("arch", ["minicpm3_4b", "dbrx_132b"])
def test_full_width_new_families_match_jax_eval_shape(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = tconfigs.get_config(arch)
    shapes = jax.eval_shape(
        lambda k: jmodels.init_params(k, jconfigs.get_config(arch)),
        jax.random.PRNGKey(0))
    jleaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    with FakeTensorMode():
        params = tmodels.init_params(torch.Generator(), cfg, "cpu")
        got = [(tuple(t.shape), str(t.dtype).split(".")[-1])
               for t in flatten(params)[0]]
        paths = [p for p, _, _ in leaf_paths(params)]
    want = [(tuple(s.shape), str(s.dtype)) for _, s in jleaves]
    want_paths = ["/".join(str(getattr(e, "key", e)) for e in path)
                  for path, _ in jleaves]
    assert paths == want_paths
    assert got == want
