"""The port's LM (dense GQA family) against a live JAX run on the CPU.

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
* the families and attention kinds not ported yet raise.
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


@pytest.mark.parametrize("arch", ["llama3_8b", "stablelm_1_6b"])
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


@pytest.mark.parametrize("arch", ["minicpm3_4b", "llama4_maverick_400b_a17b",
                                  "mamba2_2_7b", "recurrentgemma_9b",
                                  "whisper_medium", "phi3_vision_4_2b",
                                  "dbrx_132b"])
def test_unported_families_raise(arch):
    cfg = tconfigs.get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 12"):
        tmodels.init_params(torch.Generator(), cfg, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 12"):
        tmodels.init_cache(cfg, 1, 8, device="cpu")


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
