"""The port's SSM, hybrid (RG-LRU + local attention), audio
(encoder-decoder) and VLM families against a live JAX run on the CPU, the
cases of ``tests/test_arch_smoke.py`` on reduced mamba2-2.7b,
recurrentgemma-9b (one (R, R, A) group, and five layers: a group and a
two-layer ``tail`` as at full width), whisper-medium and
phi-3-vision-4.2b, on the reference's own weights carried across:

* ``train_loss`` and its metrics, prefill logits and every cache leaf (the
  SSM's conv tails and states, the hybrid's RG-LRU states and its local
  attention's ring cache — 80 tokens into a window of 64, so the window
  binds and the ring wraps — the audio decoder's self and cross K/V), 3
  greedy ``decode_step``s and the cache after them, all in the golden
  band ``atol=2e-5, rtol=2e-4``;
* ``train_loss``'s gradient with respect to every parameter leaf against
  ``jax.grad`` of the reference's;
* ``by_role_partition`` of every new tree equal to the reference's (the
  roles of every leaf, no ``other`` group);
* the full-width trees against ``jax.eval_shape`` of the reference's
  ``init_params`` (``FakeTensorMode``, nothing allocated);
* decode equals the full forward (``tests/test_model_consistency.py``'s
  check) and remat: gradients ``torch.equal`` with ``cfg.remat`` on and
  off, one checkpoint a layer, group, tail layer, encoder and decoder
  layer, none in prefill;
* ``gqa_forward``'s cross-attention arguments and the VLM's merge of
  image embeddings against the reference's; phi-3's attention at its full
  heads (32 x 96) over a narrow stream, causal, window and full;
* one ``LMDeltaTask`` round on reduced mamba2 against the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro import core as J  # noqa: E402
import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402

from repro_torch import core as T  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.models as tmodels  # noqa: E402
from repro_torch.core.pytree import (flatten, from_jax_params,  # noqa: E402
                                     leaf_paths, ravel, value_and_grad)
from repro_torch.core.task import LMDeltaTask  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)        # tests/test_golden_trajectory.py
B, S, N_DECODE = 2, 80, 3
ARCHS = ["mamba2_2_7b", "recurrentgemma_9b", "recurrentgemma_9b+tail",
         "whisper_medium", "phi3_vision_4_2b"]
FULL = ["mamba2_2_7b", "recurrentgemma_9b", "whisper_medium",
        "phi3_vision_4_2b"]


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **BAND,
                               err_msg=what)


def _reduced(arch):
    name, _, variant = arch.partition("+")
    cfg = tconfigs.get_config(name).reduced()
    jcfg = jconfigs.get_config(name).reduced()
    if variant == "tail":                     # (R, R, A) + 2 RG-LRU layers
        cfg = dataclasses.replace(cfg, n_layers=5)
        jcfg = dataclasses.replace(jcfg, n_layers=5)
    return cfg, jcfg


def _carried(arch, seed=0):
    cfg, jcfg = _reduced(arch)
    jparams = jmodels.init_params(jax.random.PRNGKey(seed), jcfg)
    return cfg, jcfg, jparams, from_jax_params(
        jax.tree_util.tree_map(np.array, jparams), "cpu")


def _batch(cfg, seed=1, seq=S):
    """Tokens from ``synthetic_lm_batch`` (bit-identical in both packages)
    and, per family, frames or image embeddings drawn with numpy."""
    b = {k: v.numpy() for k, v in
         tpipe.synthetic_lm_batch(seed, cfg.vocab_size, B, seq).items()}
    rs = np.random.RandomState(seed)
    if cfg.family == "audio":
        b["frames"] = rs.randn(B, cfg.encdec.n_frames,
                               cfg.d_model).astype(np.float32)
    if cfg.family == "vlm":
        b["image_embeds"] = rs.randn(B, cfg.vlm.n_image_tokens,
                                     cfg.d_model).astype(np.float32)
    return ({k: torch.from_numpy(v) for k, v in b.items()},
            {k: jnp.asarray(v) for k, v in b.items()})


def _compare_tree(got, want, what):
    """Every leaf of the reference's cache: shapes equal, ring positions
    exact, the rest in the band."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _compare_tree(got[k], want[k], f"{what}/{k}")
        return
    if not hasattr(got, "shape"):                  # the index
        assert got == int(want), what
        return
    assert tuple(got.shape) == want.shape, what
    if what.endswith("/pos"):
        assert np.array_equal(got.numpy(), np.asarray(want)), what
    else:
        _close(got.float().numpy(), want, what)


@pytest.mark.parametrize("arch", ARCHS)
def test_family_lm_matches_jax(arch):
    cfg, jcfg, jparams, params = _carried(arch)
    tb, jb = _batch(cfg)
    before = _lib.counts()
    loss, metrics = tmodels.train_loss(params, cfg, tb)
    jloss, jmetrics = jax.jit(lambda p, b: jmodels.train_loss(p, jcfg, b))(
        jparams, jb)
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        _close(metrics[k].item(), float(jmetrics[k]), k)

    cache_len = S + N_DECODE
    del tb["labels"], jb["labels"]
    logits, cache = tmodels.prefill(params, cfg, tb, cache_len)
    jlogits, jcache = jax.jit(lambda p, b: jmodels.prefill(
        p, jcfg, b, cache_len))(jparams, jb)
    assert tuple(logits.shape) == (B, cfg.padded_vocab)
    _close(logits.numpy(), jlogits, "prefill logits")
    _compare_tree(cache, jcache, "prefill cache")
    if cfg.family == "hybrid":                 # the window binds: a ring
        ring = cache["layers"]["sub2"]
        assert ring["k"].shape[2] == cfg.rglru.window < cache_len
        assert int(ring["pos"].max()) == S - 1
        assert ("tail" in cache) == (cfg.n_layers % 3 > 0)
    step = jax.jit(lambda p, t, c: jmodels.decode_step(p, jcfg, t, c))
    token = jnp.argmax(jlogits[:, :cfg.vocab_size], axis=-1)[:, None]
    for i in range(N_DECODE):
        logits, cache = tmodels.decode_step(
            params, cfg, torch.from_numpy(np.array(token, np.int64)), cache)
        jlogits, jcache = step(jparams, token, jcache)
        _close(logits.numpy(), jlogits, f"decode step {i}")
        token = jnp.argmax(jlogits[:, :cfg.vocab_size], axis=-1)[:, None]
    _compare_tree(cache, jcache, "cache after decode")
    assert _lib.counts() == before            # CPU tensors: plain versions


@pytest.mark.parametrize("arch", ARCHS)
def test_family_gradient_matches_jax(arch):
    """``train_loss``'s gradient (the SSD scan, the RG-LRU's log-depth
    scan, cross-attention, the merged image embeddings) against
    ``jax.grad``, every leaf."""
    cfg, jcfg, jparams, params = _carried(arch, seed=2)
    tb, jb = _batch(cfg, seed=3, seq=24)
    loss, _, grads = value_and_grad(
        lambda p, bt: tmodels.train_loss(p, cfg, bt), params, tb)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodels.train_loss(p, jcfg, b)[0]))(jparams, jb)
    _close(loss.item(), float(jloss), "train_loss")
    got = flatten(grads)[0]
    want = jax.tree_util.tree_leaves(jgrads)
    paths = [p for p, _, _ in leaf_paths(grads)]
    assert len(got) == len(want) == len(paths) > 0
    for path, g, j in zip(paths, got, want):
        assert tuple(g.shape) == j.shape, path
        _close(g.numpy(), j, f"d train_loss / d {path}")
    if cfg.family == "vlm":       # the image rows replace the first tokens'
        assert float(grads["embed"].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_by_role_partition_matches_jax(arch):
    from repro.core.partition import _leaf_segments as jsegs
    from repro.core.partition import by_role_partition as jpart
    from repro.core.partition import role_of_path as jrole
    from repro_torch.core.partition import by_role_partition, role_of_path
    _, _, jparams, params = _carried(arch)
    jp = jax.tree_util.tree_map(np.array, jparams)
    paths = [p for p, _, _ in leaf_paths(params)]
    assert paths == [p for p, _, _ in jsegs(jp)]
    roles = {p: role_of_path(p) for p in paths}
    assert roles == {p: jrole(p) for p in paths}
    assert "other" not in roles.values()

    def norm(pm):
        return tuple((n, tuple(map(tuple, sl))) for n, sl in pm.groups)
    assert norm(by_role_partition(params)) == norm(jpart(jp))


@pytest.mark.parametrize("arch", FULL)
def test_full_width_tree_matches_jax_eval_shape(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    shapes = jax.eval_shape(
        lambda k: jmodels.init_params(k, jconfigs.get_config(arch)),
        jax.random.PRNGKey(0))
    jleaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    with FakeTensorMode():
        params = tmodels.init_params(torch.Generator(),
                                     tconfigs.get_config(arch), "cpu")
        got = [(tuple(t.shape), str(t.dtype).split(".")[-1])
               for t in flatten(params)[0]]
        paths = [p for p, _, _ in leaf_paths(params)]
        n = tmodels.param_count(params)
    assert paths == ["/".join(str(getattr(e, "key", e)) for e in path)
                     for path, _ in jleaves]
    assert got == [(tuple(s.shape), str(s.dtype)) for _, s in jleaves]
    assert n == sum(int(np.prod(s.shape)) for _, s in jleaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """Decoding token S after prefilling S tokens equals the last-position
    logits of a full (S+1)-token forward (``tests/test_model_consistency.py
    :33-46``'s tolerance)."""
    cfg, _ = _reduced(arch)
    params = tmodels.init_params(torch.Generator().manual_seed(1), cfg,
                                 "cpu")
    tb, _ = _batch(cfg, seed=4, seq=S + 1)
    part = dict(tb, tokens=tb["tokens"][:, :S])
    del part["labels"]
    _, cache = tmodels.prefill(params, cfg, part, cache_len=S + 8)
    lg_dec, _ = tmodels.decode_step(params, cfg, tb["tokens"][:, S:S + 1],
                                    cache)
    full = dict(tb)
    del full["labels"]
    lg_full, _ = tmodels.prefill(params, cfg, full, cache_len=S + 8)
    np.testing.assert_allclose(lg_dec.numpy(), lg_full.numpy(), atol=2e-5,
                               rtol=2e-3)


@pytest.mark.parametrize("arch,units", [
    ("mamba2_2_7b", 2), ("recurrentgemma_9b+tail", 3),
    ("whisper_medium", 4), ("phi3_vision_4_2b", 2)])
def test_remat_gradients_equal(arch, units):
    """One checkpoint a unit of each stack (a layer; a hybrid group and
    each tail layer; each encoder and decoder layer): gradients and loss
    the same bits with remat on and off; prefill never checkpoints."""
    cfg, _ = _reduced(arch)
    params = tmodels.init_params(torch.Generator().manual_seed(5), cfg,
                                 "cpu")
    tb, _ = _batch(cfg, seed=6, seq=16)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = value_and_grad(
            lambda p, bt, c=c: tmodels.train_loss(p, c, bt), params, tb)
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(flatten(out[False][2])[0], flatten(out[True][2])[0],
                    strict=True):
        assert torch.equal(a, b)
    from repro_torch.models import model as model_lib
    calls, real = [], model_lib.checkpoint

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    model_lib.checkpoint = spy
    try:
        rc = dataclasses.replace(cfg, remat=True)
        value_and_grad(lambda p, bt: tmodels.train_loss(p, rc, bt), params,
                       tb)
        assert len(calls) == units
        del tb["labels"]
        tmodels.prefill(params, rc, tb)
        assert len(calls) == units
    finally:
        model_lib.checkpoint = real


def test_gqa_cross_attention_matches_jax():
    """``gqa_forward`` with ``kv_x`` (the encoder output as K/V source, no
    rope on it) and with ``cached_kv`` against the reference's."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    cfg, jcfg = _reduced("whisper_medium")
    jp = jattn.init_gqa(jax.random.PRNGKey(0), jcfg)
    p = from_jax_params(jax.tree_util.tree_map(np.array, jp), "cpu")
    rs = np.random.RandomState(0)
    x = rs.randn(2, 12, cfg.d_model).astype(np.float32)
    enc = rs.randn(2, 21, cfg.d_model).astype(np.float32)
    pos = np.tile(np.arange(12), (2, 1))
    out, (k, v) = tattn.gqa_forward(
        p, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos),
        mode="full", kv_x=torch.from_numpy(enc))
    jout, (jk, jv) = jattn.gqa_forward(
        jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos), mode="full",
        kv_x=jnp.asarray(enc))
    assert tuple(k.shape) == jk.shape == (2, 21, cfg.n_kv_heads,
                                          cfg.head_dim)
    for a, b, w in ((out, jout, "out"), (k, jk, "k"), (v, jv, "v")):
        _close(a.numpy(), b, w)
    again, kv = tattn.gqa_forward(p, torch.from_numpy(x), cfg,
                                  positions=torch.from_numpy(pos),
                                  mode="full", cached_kv=(k, v))
    assert torch.equal(again, out) and kv[0] is k


def _full_heads(name, **changes):
    """``name``'s config with its full attention heads (head count and
    widths) over a narrow residual stream, float32, both packages."""
    kw = dict(param_dtype="float32", compute_dtype="float32", remat=False,
              **changes)
    return (dataclasses.replace(tconfigs.get_config(name), **kw),
            dataclasses.replace(jconfigs.get_config(name), **kw))


@pytest.mark.parametrize("mode,window,S_", [("causal", None, 24),
                                            ("window", 9, 21),
                                            ("full", None, 17)])
def test_phi3_attention_full_head_width_matches_jax(mode, window, S_):
    """phi-3's attention at its full heads (32 x 96, the pair kernel 6
    now instantiates natively; d_model cut to 256): ``gqa_forward`` — the
    model-level ``flash_attention`` at (96, 96) on the CPU — against the
    reference's, output and K/V in the golden band."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    cfg, jcfg = _full_heads("phi3_vision_4_2b", d_model=256)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (32, 32, 96)
    jp = jattn.init_gqa(jax.random.PRNGKey(3), jcfg)
    p = from_jax_params(jax.tree_util.tree_map(np.array, jp), "cpu")
    x = np.random.RandomState(S_).randn(2, S_, 256).astype(np.float32)
    pos = np.tile(np.arange(S_), (2, 1))
    out, (k, v) = tattn.gqa_forward(p, torch.from_numpy(x), cfg,
                                    positions=torch.from_numpy(pos),
                                    mode=mode, window=window)
    jout, (jk, jv) = jattn.gqa_forward(jp, jnp.asarray(x), jcfg,
                                       positions=jnp.asarray(pos), mode=mode,
                                       window=window)
    assert tuple(v.shape) == (2, S_, 32, 96)
    for a, b, w in ((out, jout, "out"), (k, jk, "k"), (v, jv, "v")):
        _close(a.numpy(), b, w)


def test_vlm_image_embeds_merge_matches_jax():
    from repro.models.model import _embed_inputs as jembed
    from repro_torch.models.model import _embed_inputs as tembed
    cfg, jcfg, jparams, params = _carried("phi3_vision_4_2b")
    tb, jb = _batch(cfg, seed=7, seq=20)
    pos = torch.arange(20)[None].expand(B, 20)
    h = tembed(params, cfg, tb, pos)
    jh = jembed(jparams, jcfg, jb, jnp.asarray(pos.numpy()), train=False)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    n = cfg.vlm.n_image_tokens
    assert torch.equal(h[:, :n], tb["image_embeds"])


def test_lm_delta_round_mamba2_matches_reference():
    """One ``SyncFedAvg`` round of ``LMDeltaTask`` on reduced mamba2 (2
    clients of 4 sequences of 16 tokens, batch 2, ``optimizer="sgdm"``,
    update payload) on the reference's initial params, against the
    reference's run: records exact, parameters and metrics in the golden
    band."""
    jcfg = jconfigs.get_config("mamba2_2_7b").reduced()
    tcfg = tconfigs.get_config("mamba2_2_7b").reduced()
    # the reference's run draws its params from PRNGKey(FLConfig.seed = 0)
    p0 = jax.tree_util.tree_map(np.array,
                                jmodels.init_params(jax.random.PRNGKey(0),
                                                    jcfg))

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
    moved = ravel(trun.global_params)[0].numpy()
    assert float(np.abs(moved - ravel(from_jax_params(p0, "cpu"))[0]
                        .numpy()).max()) > 0
    _close(moved, np.asarray(ravel_pytree(jrun.global_params)[0]),
           "global params")


def test_init_params_new_families_seeded():
    """Same generator seed, same weights; the parameter count equals the
    reference's tree's."""
    for arch in FULL:
        cfg, jcfg = _reduced(arch)
        a = tmodels.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
        b = tmodels.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
        for x, y in zip(flatten(a)[0], flatten(b)[0], strict=True):
            assert torch.equal(x, y)
        shapes = jax.eval_shape(lambda k, c=jcfg: jmodels.init_params(k, c),
                                jax.random.PRNGKey(0))
        assert tmodels.param_count(a) == jmodels.param_count(shapes)
