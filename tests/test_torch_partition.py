"""The port's per-layer partitions and grouped server round against the JAX
package's, on the same numpy-seeded inputs and the JAX package's own
initial parameters.

* the grouped decode→aggregate plain version against JAX's
  ``grouped_fused_decode_agg`` (Pallas, interpret mode) over the reference's
  grid (tests/test_grouped_kernel.py), plus a single-client bucket, a
  shared decoder slot and an all-empty round, at ``atol=2e-5, rtol=1e-4``;
* ``PartitionMap`` checks, and the builders' groups on the MNIST MLP equal
  to JAX's;
* partitioned encode, decode and ``wire_bytes_by_group``, bytes exact;
* ``server_decode_aggregate`` (sequential and grouped) and
  ``grouped_flat_server_aggregate`` on the reference's mixed cohort;
* gate 4 (a partitioned cohort, two chunked-AE rungs and q8/q4, grouped)
  and gate 5 (a flat mixed cohort, grouped) end to end against a live JAX
  run: bytes exact, metrics and final parameters in the golden band.

The JAX side runs its Pallas kernels in interpret mode (``use_kernel=True``
off the TPU), the port its plain versions (CPU tensors).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as J  # noqa: E402
from repro.configs.paper import MNIST_CLASSIFIER as J_MLP  # noqa: E402
from repro.core import autoencoder as jae  # noqa: E402
from repro.core import codec as jcodec  # noqa: E402
from repro.core import partition as jpart  # noqa: E402
from repro.core.scheduler import EncodedUpdate as JEncoded  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.kernels.fused_decode_agg import (  # noqa: E402
    grouped_fused_decode_agg as j_grouped)
from repro.models.classifiers import init_classifier  # noqa: E402

from repro_torch import core as T  # noqa: E402
from repro_torch.configs.paper import MNIST_CLASSIFIER  # noqa: E402
from repro_torch.core import codec as tcodec  # noqa: E402
from repro_torch.core import partition as tpart  # noqa: E402
from repro_torch.core.pytree import from_jax_params, leaf_paths  # noqa: E402
from repro_torch.core.scheduler import EncodedUpdate as TEncoded  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import fused_decode_agg as tfda  # noqa: E402
from repro_torch.kernels.fused_decode_agg import (  # noqa: E402
    _plan_bands, few_rows_plan, grouped_fused_decode_agg, kernel_route,
    tile_table)
from test_torch_slice import (BAND, _JaxInitTask, _compare,  # noqa: E402
                              _golden_data, _np)

KERNEL_TOL = dict(atol=2e-5, rtol=1e-4)     # tests/test_grouped_kernel.py
SERVER_TOL = dict(atol=1e-5, rtol=1e-4)     # tests/test_grouped_kernel.py


# ----------------------------------------------------------- kernel level
def _buckets(seed, cohort, rungs, K=8, N=32):
    """``cohort`` clients over ``rungs`` buckets of ragged (C, M); a cohort
    smaller than ``rungs`` leaves trailing buckets empty. Weights Σ=1 per
    bucket. numpy arrays, for both packages."""
    rng = np.random.RandomState(seed)
    w_stack = (0.1 * rng.randn(rungs, K, N)).astype(np.float32)
    b_stack = (0.1 * rng.randn(rungs, N)).astype(np.float32)
    sizes = [cohort // rungs + (1 if r < cohort % rungs else 0)
             for r in range(rungs)]
    Ms = [16, 24, 8, 40]
    hs, ws = [], []
    for r, C_b in enumerate(sizes):
        hs.append(rng.randn(C_b, Ms[r % 4], K).astype(np.float32))
        raw = rng.uniform(size=C_b).astype(np.float32) + 0.1
        ws.append((raw / raw.sum() if C_b else raw).astype(np.float32))
    return hs, ws, w_stack, b_stack, list(range(rungs))


def _both(hs, ws, w_stack, b_stack, dec_idx, **jkw):
    got = grouped_fused_decode_agg(
        [torch.from_numpy(h) for h in hs], [torch.from_numpy(w) for w in ws],
        torch.from_numpy(w_stack), torch.from_numpy(b_stack), dec_idx)
    want = j_grouped([jnp.asarray(h) for h in hs],
                     [jnp.asarray(w) for w in ws], jnp.asarray(w_stack),
                     jnp.asarray(b_stack), dec_idx, interpret=True, **jkw)
    assert len(got) == len(want) == len(hs)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KERNEL_TOL)
    return got


@pytest.mark.parametrize("cohort", [1, 8, 64])
@pytest.mark.parametrize("rungs", [1, 2, 4])
def test_grouped_plain_matches_pallas_interpret(cohort, rungs):
    hs, ws, w_stack, b_stack, dec_idx = _buckets(cohort * 10 + rungs,
                                                 cohort, rungs)
    got = _both(hs, ws, w_stack, b_stack, dec_idx, bc=16)
    for h, g in zip(hs, got):
        if h.shape[0] == 0:
            assert not g.any()                     # exact zeros


def test_grouped_plain_single_client_and_shared_slot():
    rng = np.random.RandomState(3)
    K, N = 8, 32
    w_stack = (0.1 * rng.randn(2, K, N)).astype(np.float32)
    b_stack = (0.1 * rng.randn(2, N)).astype(np.float32)
    hs = [rng.randn(1, 16, K).astype(np.float32),
          rng.randn(5, 24, K).astype(np.float32),
          np.zeros((0, 8, K), np.float32),        # empty between live ones
          rng.randn(3, 24, K).astype(np.float32)]
    ws = [np.ones(1, np.float32), np.full(5, 0.2, np.float32),
          np.zeros(0, np.float32), np.asarray([0.5, 0.25, 0.25], np.float32)]
    got = _both(hs, ws, w_stack, b_stack, [0, 1, 0, 1])  # 1 and 3 share
    assert tuple(got[2].shape) == (8, N) and not got[2].any()


def test_grouped_decoders_list_equals_stack():
    """The grouped round's form, decoders as separate ``(W, bias)``
    tensors, gives the stacked form's result (CPU, plain version)."""
    hs, ws, w_stack, b_stack, dec_idx = _buckets(5, 9, 3)
    th = [torch.from_numpy(h) for h in hs]
    tw = [torch.from_numpy(w) for w in ws]
    ws_t, bs_t = torch.from_numpy(w_stack), torch.from_numpy(b_stack)
    stacked = grouped_fused_decode_agg(th, tw, ws_t, bs_t, dec_idx)
    apart = tfda.grouped_fused_decode_agg_decoders(
        th, tw, [(ws_t[d].clone(), bs_t[d].clone()) for d in range(3)],
        dec_idx)
    for a, b in zip(stacked, apart):
        assert torch.equal(a, b)


def test_grouped_plain_all_empty_returns_zeros():
    out = grouped_fused_decode_agg(
        [torch.zeros((0, 16, 4))], [torch.zeros(0)], torch.ones((1, 4, 8)),
        torch.ones((1, 8)), [0])
    assert tuple(out[0].shape) == (16, 8) and not out[0].any()


def test_grouped_wrapper_checks_and_never_falls_back():
    """A (K, N) mismatch raises; a tensor that is not on the CPU goes to
    the kernel's checks, never to the plain version."""
    w_stack, b_stack = torch.ones((1, 4, 8)), torch.ones((1, 8))
    with pytest.raises(ValueError, match="one \\(K, N\\) signature"):
        grouped_fused_decode_agg([torch.ones((2, 3, 5))], [torch.ones(2)],
                                 w_stack, b_stack, [0])
    with pytest.raises(ValueError, match="decoder slot"):
        grouped_fused_decode_agg([torch.ones((2, 3, 4))], [torch.ones(2)],
                                 w_stack, b_stack, [1])
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        grouped_fused_decode_agg(
            [torch.empty((2, 3, 4), device=meta)],
            [torch.empty(2, device=meta)], torch.empty((1, 4, 8), device=meta),
            torch.empty((1, 8), device=meta), [0])


def _table_rows(table):
    """The table's rows as (h, w, out, W, b, stride, C, rows, route,
    column) with the two packed words unpacked."""
    return [tuple(r[:6]) + (r[6] & 0xffffffff, r[6] >> 32, r[7] & 0xff,
                            r[7] >> 8) for r in table.tolist()]


@pytest.mark.parametrize("shapes,bm,tiles,offsets", [
    # run (d): two few_rows buckets of 2 clients, 4 chunks each
    ([(2, 4), (2, 4)], 8,
     [(0, 0, 4, 0, 1, 0), (1, 0, 4, 4, 1, 0)], [0, 4]),
    # mixed routes: a bands bucket (20 rows, bands of 8), an empty bucket
    # between live ones, a few_rows bucket with C_b = 1
    ([(3, 20), (0, 8), (1, 8)], 8,
     [(0, 0, 8, 0, 0, 0), (0, 8, 8, 8, 0, 0), (0, 16, 4, 16, 0, 0),
      (2, 0, 8, 20, 1, 0)],
     [0, -1, 20]),
    ([(0, 5)], 8, [], [-1]),
])
def test_grouped_tile_table(shapes, bm, tiles, offsets):
    """``tiles`` as (bucket, first row in it, rows, first packed output
    row, route, column tile); with h at 1e6·(b+1), weights at 1e9·(b+1),
    W at 1e12·(b+1), the bias at 1e12·(b+1)+1e9 and the output at 0 the
    table's addresses read back as those rows (K=4, N=2: one column tile
    a bucket)."""
    K, N = 4, 2
    n = len(shapes)
    table, got_offsets = tile_table(
        shapes, K, N, [10 ** 6 * (b + 1) for b in range(n)],
        [10 ** 9 * (b + 1) for b in range(n)],
        [(10 ** 12 * (b + 1), 10 ** 12 * (b + 1) + 10 ** 9)
         for b in range(n)], 0, bm, 256, 1)
    assert got_offsets == offsets
    assert table.shape == (len(tiles), 8) and table.dtype == np.int64
    for row, (b, m0, rows, o, route, col) in zip(_table_rows(table), tiles):
        C_b, M_b = shapes[b]
        assert route == (kernel_route(M_b, K) == "few_rows")
        assert row == (10 ** 6 * (b + 1) + m0 * K * 4, 10 ** 9 * (b + 1),
                       o * N * 4, 10 ** 12 * (b + 1),
                       10 ** 12 * (b + 1) + 10 ** 9, M_b * K, C_b, rows,
                       route, col)


def test_grouped_tile_table_mixed_route_round():
    """chip_smoke.py's mixed round at K 512, N 4096 — buckets (3, 4),
    (0, 8), (2, 100), (1, 16), two decoders — as one launch: each few_rows
    bucket one block a column tile (tpr from the per-bucket plan), the
    bands bucket bands of 8 rows by 256-column strips, each tile with its
    bucket's decoder addresses, the empty bucket none."""
    shapes, K, N, dec = [(3, 4), (0, 8), (2, 100), (1, 16)], 512, 4096, \
        [0, 1, 0, 1]
    bm, cols = _plan_bands([100], N, K, 132)
    tpr = few_rows_plan(N, 132)
    assert (bm, cols, tpr) == (8, 256, 8)
    decs = [(7 << 40, (7 << 40) + 4096), (9 << 40, (9 << 40) + 4096)]
    table, offsets = tile_table(
        shapes, K, N, [(b + 1) << 32 for b in range(4)],
        [(b + 1) << 36 for b in range(4)], [decs[d] for d in dec], 0, bm,
        cols, tpr)
    assert offsets == [0, -1, 4, 104]
    rows = _table_rows(table)
    per = {b: [r for r in rows if r[1] == (b + 1) << 36] for b in range(4)}
    assert [len(per[b]) for b in range(4)] == [128, 0, 13 * 16, 128]
    assert len(rows) == 464 >= 2 * 132
    for b in (0, 2, 3):
        for r in per[b]:
            assert (r[3], r[4]) == decs[dec[b]]
            assert r[8] == (b != 2) and r[6] == shapes[b][0]
    assert sorted(r[9] for r in per[0]) == list(range(128))
    assert {r[7] for r in per[2]} == {8, 4}          # 12 bands of 8, one of 4
    assert sorted({r[9] for r in per[2]}) == list(range(16))


@pytest.mark.parametrize("ms,K,N,want", [
    ([4, 4], 512, 4096, (8, 256)),           # few rows: 256-column strips
    ([3840, 3840], 32, 256, (16, 256)),      # fl_partition cohort point
    ([4, 4], 64 * 1024, 32, None),           # K too wide for a block
])
def test_grouped_band_plan(ms, K, N, want):
    if want is None:
        with pytest.raises(ValueError, match="shared memory"):
            _plan_bands(ms, N, K, 132)
        return
    bm, cols = _plan_bands(ms, N, K, 132)
    assert (bm, cols) == want
    assert bm * K * 4 + 4096 <= 227 * 1024 and cols % 256 == 0


# ------------------------------------------------------- partition maps
def _mlp_templates():
    pj = _np(init_classifier(jax.random.PRNGKey(0), J_MLP))
    return pj, from_jax_params(pj, "cpu")


def test_leaf_paths_match_jax_and_params_dict_carries_across():
    pj, pt = _mlp_templates()
    assert leaf_paths(pt) == jpart._leaf_segments(pj)
    assert [s for _, _, s in leaf_paths(pt)] == [20, 15680, 10, 200]
    # a per-group {name: ae_params or None} dict crosses like any tree
    aej = _np(jae.init_chunked_ae(jax.random.PRNGKey(1),
                                  jae.ChunkedAEConfig(64, (8,), 4)))
    got = from_jax_params({"dense0": aej, "dense1": None}, "cpu")
    assert got["dense1"] is None
    np.testing.assert_array_equal(got["dense0"]["dec"][-1]["w"].numpy(),
                                  aej["dec"][-1]["w"])


@pytest.mark.parametrize("builder", ["identity_partition",
                                     "by_leaf_partition",
                                     "by_layer_partition",
                                     "by_role_partition"])
def test_partition_builders_equal_jax(builder):
    pj, pt = _mlp_templates()
    got = getattr(tpart, builder)(pt)
    want = getattr(jpart, builder)(pj)
    assert got.groups == want.groups
    assert got.size == want.size == 15_910
    assert got.names == want.names


def test_role_of_path_equals_jax():
    paths = ["embed/w", "layers/attn/q", "layers/mixer/conv_w", "ffn/w1",
             "layers/moe/experts/w", "final_norm/scale", "ln1/b", "dense0/w",
             "lm_head/w", "layers/router/w"]
    assert [tpart.role_of_path(p) for p in paths] == \
        [jpart.role_of_path(p) for p in paths]


@pytest.mark.parametrize("groups,match", [
    ((("a", ((0, 4),)), ("a", ((4, 4),))), "duplicate"),
    ((("a", ((0, 4),)), ("b", ((5, 4),))), "gap/overlap"),
    ((("a", ((0, 4),)), ("b", ((2, 4),))), "gap/overlap"),
    ((("a", ((0, 0),)),), "empty slice"),
])
def test_partition_map_rejects_bad_tilings(groups, match):
    with pytest.raises(ValueError, match=match):
        tpart.PartitionMap(groups=groups)
    with pytest.raises(AssertionError):
        jpart.PartitionMap(groups=groups)


def test_partition_map_non_contiguous_groups_and_spec_checks():
    pmap = tpart.PartitionMap(groups=(("x", ((0, 3), (7, 2))),
                                      ("y", ((3, 4),))))
    assert pmap.size == 9 and pmap.group_size("x") == 5
    assert pmap.slices_of("y") == ((3, 4),)
    with pytest.raises(ValueError, match="codec spec sized"):
        tpart.make_partition_spec(pmap, {
            "x": tcodec.QuantizeSpec(size=4), "y": tcodec.IdentitySpec(4)})
    with pytest.raises(ValueError, match="spec keys"):
        tpart.make_partition_spec(pmap, {"x": tcodec.IdentitySpec(5)})
    flat = torch.arange(9.0)
    spec = tpart.make_partition_spec(pmap, {"x": tcodec.IdentitySpec(5),
                                            "y": tcodec.IdentitySpec(4)})
    assert tpart.gather(((0, 3), (7, 2)), flat).tolist() == [0, 1, 2, 7, 8]
    assert torch.equal(tcodec.decode(spec, None,
                                     tcodec.encode(spec, None, flat)), flat)


# ------------------------------------------------ partitioned encode/decode
CFG8 = dict(chunk_size=128, hidden=(16,), latent_chunk=8)
CFG4 = dict(chunk_size=128, hidden=(16,), latent_chunk=4)
SIZE = 1280


class _Side:
    """One package's half of the reference's mixed partitioned cohort
    (tests/test_grouped_kernel.py): bulk 768 on two kernel-path chunked-AE
    rungs, head 512 on q8/q4."""

    def __init__(self, pkg, codec_mod, part_mod, make_params):
        self.pmap = part_mod.PartitionMap(groups=(("bulk", ((0, 768),)),
                                                  ("head", ((768, 512),))))
        self.cfg_hi = pkg.ChunkedAEConfig(**CFG8)
        self.cfg_lo = pkg.ChunkedAEConfig(**CFG4)
        self.prm_hi, self.prm_lo = make_params()
        self.spec_hi = part_mod.make_partition_spec(self.pmap, {
            "bulk": codec_mod.ChunkedAESpec(size=768, cfg=self.cfg_hi,
                                            use_kernel=True),
            "head": codec_mod.QuantizeSpec(size=512, bits=8)})
        self.spec_lo = part_mod.make_partition_spec(self.pmap, {
            "bulk": codec_mod.ChunkedAESpec(size=768, cfg=self.cfg_lo,
                                            use_kernel=True),
            "head": codec_mod.QuantizeSpec(size=512, bits=4)})


def _sides():
    pj_hi = jae.init_chunked_ae(jax.random.PRNGKey(20),
                                jae.ChunkedAEConfig(**CFG8))
    pj_lo = jae.init_chunked_ae(jax.random.PRNGKey(21),
                                jae.ChunkedAEConfig(**CFG4))
    js = _Side(J, jcodec, jpart, lambda: (pj_hi, pj_lo))
    ts = _Side(T, tcodec, tpart,
               lambda: (from_jax_params(_np(pj_hi), "cpu"),
                        from_jax_params(_np(pj_lo), "cpu")))
    return js, ts


def test_partitioned_encode_decode_and_bytes_match_jax():
    js, ts = _sides()
    flat = np.random.RandomState(4).randn(SIZE).astype(np.float32)
    for lo in (False, True):
        sj = js.spec_lo if lo else js.spec_hi
        st = ts.spec_lo if lo else ts.spec_hi
        pj = {"bulk": js.prm_lo if lo else js.prm_hi, "head": None}
        pt = {"bulk": ts.prm_lo if lo else ts.prm_hi, "head": None}
        plj = jcodec.encode(sj, pj, jnp.asarray(flat))
        plt = tcodec.encode(st, pt, torch.from_numpy(flat))
        assert set(plt) == set(plj) == {"bulk", "head"}
        np.testing.assert_allclose(plt["bulk"]["z"].numpy(),
                                   np.asarray(plj["bulk"]["z"]), **BAND)
        np.testing.assert_array_equal(plt["head"]["q"].numpy(),
                                      np.asarray(plj["head"]["q"]))
        assert T.tree_bytes(plt) == sum(
            np.asarray(x).nbytes for x in jax.tree_util.tree_leaves(plj))
        by_t = tpart.wire_bytes_by_group(st, pt)
        assert by_t == jpart.wire_bytes_by_group(sj, pj)
        assert tcodec.wire_bytes(st, pt) == jcodec.wire_bytes(sj, pj) == \
            sum(by_t.values()) == T.tree_bytes(plt)
        np.testing.assert_allclose(
            tcodec.decode(st, pt, plt).numpy(),
            np.asarray(jcodec.decode(sj, pj, plj)), **BAND)
    with pytest.raises(ValueError, match="autoencoder"):
        tcodec.wire_bytes(ts.spec_hi, None)


def _mixed_cohort(n, js, ts):
    """The reference's mixed cohort: every third client on the low rung.
    Both packages encode the same numpy updates."""
    rng = np.random.RandomState(5)
    ej, et, weights = [], [], []
    for i in range(n):
        flat = rng.randn(SIZE).astype(np.float32)
        lo = i % 3 == 0
        for side, out, enc, arr in ((js, ej, JEncoded, jnp.asarray),
                                    (ts, et, TEncoded, torch.from_numpy)):
            sp = side.spec_lo if lo else side.spec_hi
            prm = {"bulk": side.prm_lo if lo else side.prm_hi, "head": None}
            cod = jcodec if side is js else tcodec
            out.append(enc(payload=cod.encode(sp, prm, arr(flat)), spec=sp,
                           params=prm, weight=1.0 + i, stats={},
                           metrics={}))
        weights.append(1.0 + i)
    return ej, et, T.normalize_weights(weights)


@pytest.mark.parametrize("with_base", [False, True])
def test_server_decode_aggregate_matches_jax(with_base):
    js, ts = _sides()
    ej, et, nw = _mixed_cohort(7, js, ts)
    base = (np.random.RandomState(9).randn(SIZE).astype(np.float32)
            if with_base else None)
    bj = None if base is None else jnp.asarray(base)
    bt = None if base is None else torch.from_numpy(base)
    want = jpart.server_decode_aggregate(ej, nw, bj, use_grouped_kernel=True)
    seq = tpart.server_decode_aggregate(et, nw, bt, use_grouped_kernel=False)
    grp = tpart.server_decode_aggregate(et, nw, bt, use_grouped_kernel=True)
    assert tuple(grp.shape) == (SIZE,)
    np.testing.assert_allclose(grp.numpy(), np.asarray(want), **SERVER_TOL)
    np.testing.assert_allclose(seq.numpy(), np.asarray(
        jpart.server_decode_aggregate(ej, nw, bj, use_grouped_kernel=False)),
        **SERVER_TOL)
    np.testing.assert_allclose(grp.numpy(), seq.numpy(), **SERVER_TOL)
    # the per-client decode oracle
    rows = torch.stack([tcodec.decode(e.spec, e.params, e.payload)
                        for e in et])
    if bt is not None:
        rows = rows - bt[None, :]
    oracle = torch.einsum("c,cp->p", torch.tensor(nw), rows)
    np.testing.assert_allclose(grp.numpy(), oracle.numpy(), **SERVER_TOL)


def test_server_homogeneous_partitioned_cohort_matches_fused_call():
    """One bucket per group: the grouped round reduces with the cohort
    weights, as ``decode_and_aggregate`` on the partitioned spec does."""
    js, ts = _sides()
    rng = np.random.RandomState(6)
    et = []
    prm = {"bulk": ts.prm_hi, "head": None}
    for _ in range(5):
        flat = torch.from_numpy(rng.randn(SIZE).astype(np.float32))
        et.append(TEncoded(payload=tcodec.encode(ts.spec_hi, prm, flat),
                           spec=ts.spec_hi, params=prm, weight=1.0,
                           stats={}, metrics={}))
    nw = T.normalize_weights([1.0] * 5)
    fused = tcodec.decode_and_aggregate(
        ts.spec_hi, prm, tcodec.stack_payloads([e.payload for e in et]),
        torch.tensor(nw))
    for grouped in (False, True):
        got = tpart.server_decode_aggregate(et, nw, None,
                                            use_grouped_kernel=grouped)
        np.testing.assert_allclose(got.numpy(), fused.numpy(), atol=2e-6,
                                   rtol=1e-5)


@pytest.mark.parametrize("with_base", [False, True])
def test_grouped_flat_server_aggregate_matches_jax(with_base):
    js, ts = _sides()
    rng = np.random.RandomState(7)
    ej, et = [], []
    for i in range(9):
        flat = rng.randn(768).astype(np.float32)
        for side, out, enc, cod, arr in (
                (js, ej, JEncoded, jcodec, jnp.asarray),
                (ts, et, TEncoded, tcodec, torch.from_numpy)):
            sp, prm = [(cod.ChunkedAESpec(size=768, cfg=side.cfg_hi,
                                          use_kernel=True), side.prm_hi),
                       (cod.ChunkedAESpec(size=768, cfg=side.cfg_lo,
                                          use_kernel=True), side.prm_lo),
                       (cod.QuantizeSpec(size=768, bits=8), None)][i % 3]
            out.append(enc(payload=cod.encode(sp, prm, arr(flat)), spec=sp,
                           params=prm, weight=2.0 + i, stats={}, metrics={}))
    nw = T.normalize_weights([2.0 + i for i in range(9)])
    base = (rng.randn(768).astype(np.float32) if with_base else None)
    want = jpart.grouped_flat_server_aggregate(
        ej, nw, None if base is None else jnp.asarray(base))
    got = tpart.grouped_flat_server_aggregate(
        et, nw, None if base is None else torch.from_numpy(base))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SERVER_TOL)


def test_partitioned_compressor_spec_cache_and_params():
    _, pt = _mlp_templates()
    pmap = tpart.by_layer_partition(pt)
    cfg = T.ChunkedAEConfig(chunk_size=1024, hidden=(32,), latent_chunk=8)
    prm = T.init_chunked_ae(torch.Generator().manual_seed(0), cfg, "cpu")
    comp = T.PartitionedCompressor(pmap, {
        "dense0": T.ChunkedAECompressor(prm, cfg, use_kernel=True),
        "dense1": T.QuantizeCompressor(bits=8)})
    spec = comp.spec(15_910)
    assert comp.spec(15_910) is spec                    # cached
    assert T.partitioned(comp) is comp
    assert T.partitioned(T.QuantizeCompressor()) is None
    assert comp.codec_params()["dense1"] is None
    assert comp.codec_params()["dense0"] is prm
    comp.compressors["dense1"] = T.QuantizeCompressor(bits=4)
    assert comp.spec(15_910).spec_of("dense1").bits == 4  # rebuilt
    new = T.init_chunked_ae(torch.Generator().manual_seed(1), cfg, "cpu")
    comp.set_codec_params({"dense0": new, "dense1": None})
    assert comp.codec_params()["dense0"] is new
    with pytest.raises(ValueError, match="partition map covers"):
        comp.spec(100)
    with pytest.raises(ValueError, match="sub-compressor keys"):
        T.PartitionedCompressor(pmap, {"dense0": T.QuantizeCompressor()})


def test_use_grouped_default(monkeypatch):
    """Off unless asked for; no environment variable changes it."""
    monkeypatch.setenv("REPRO_GROUPED_KERNEL", "1")
    assert ops.use_grouped_default() is False
    assert ops.use_grouped_default(True) is True
    assert ops.use_grouped_default(False) is False


# ------------------------------------------------------------- end to end
AE_HI = dict(chunk_size=1024, hidden=(32,), latent_chunk=8)
AE_LO = dict(chunk_size=1024, hidden=(32,), latent_chunk=4)


def _ae_params():
    pj_hi = jae.init_chunked_ae(jax.random.PRNGKey(2),
                                jae.ChunkedAEConfig(**AE_HI))
    pj_lo = jae.init_chunked_ae(jax.random.PRNGKey(3),
                                jae.ChunkedAEConfig(**AE_LO))
    return (pj_hi, pj_lo), (from_jax_params(_np(pj_hi), "cpu"),
                            from_jax_params(_np(pj_lo), "cpu"))


def _partitioned_comps(pkg, pmap, prms):
    """Run (d)'s cohort: dense0 on the chunked AE (clients 0-1 latent 8,
    2-3 latent 4, one params object per rung), dense1 q8 / q4."""
    cfgs = (pkg.ChunkedAEConfig(**AE_HI), pkg.ChunkedAEConfig(**AE_LO))
    return [pkg.PartitionedCompressor(pmap, {
        "dense0": pkg.ChunkedAECompressor(prms[i // 2], cfgs[i // 2],
                                          use_kernel=True),
        "dense1": pkg.QuantizeCompressor(bits=8 if i % 2 == 0 else 4)})
        for i in range(4)]


def _flat_comps(pkg, prms):
    """Run (e)'s cohort: two chunked-AE rungs, q8 and q4."""
    return [pkg.ChunkedAECompressor(prms[0], pkg.ChunkedAEConfig(**AE_HI),
                                    use_kernel=True),
            pkg.ChunkedAECompressor(prms[1], pkg.ChunkedAEConfig(**AE_LO),
                                    use_kernel=True),
            pkg.QuantizeCompressor(bits=8), pkg.QuantizeCompressor(bits=4)]


def _four_clients(pkg):
    """128 examples a client: two local batches of 64."""
    train, ev = pkg.train_eval_split(pkg.mnist_like(0, 576), 64)
    return pkg.uniform_partition(0, train, 4), ev


def _count_server_kernels(monkeypatch):
    """Count the port's grouped and per-bucket decode→aggregate calls (CPU
    tensors launch nothing, so the launch counters stay at zero)."""
    calls = {"grouped": 0, "per_bucket": 0}
    for key, name in (("grouped", "grouped_fused_decode_agg_decoders"),
                      ("per_bucket", "fused_decode_agg")):
        fn = getattr(tfda, name)

        def wrapped(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tfda, name, wrapped)
    return calls


def _gate(monkeypatch, make_comps):
    p0 = _np(init_classifier(jax.random.PRNGKey(0), J_MLP))
    (pj_hi, pj_lo), (pt_hi, pt_lo) = _ae_params()
    cfg = dict(n_rounds=2, local_epochs=1, payload="update",
               error_feedback=True, use_grouped_kernel=True, seed=0)
    dj, evj = _four_clients(jpipe)
    run_j = J.FederatedRun(J_MLP, dj, J.FLConfig(**cfg),
                           compressors=make_comps(J, p0, (pj_hi, pj_lo)),
                           eval_data=evj)
    run_j.run()
    dt, evt = _four_clients(tpipe)
    task = _JaxInitTask(MNIST_CLASSIFIER, p0)
    run_t = T.FederatedRun(
        task, dt, T.FLConfig(**cfg),
        compressors=make_comps(T, from_jax_params(p0, "cpu"),
                               (pt_hi, pt_lo)),
        eval_data=evt, device="cpu")
    calls = _count_server_kernels(monkeypatch)
    run_t.run()
    _compare(run_j, run_t)
    return run_t, calls


def test_gate4_partitioned_grouped_run_matches_jax(monkeypatch):
    def comps(pkg, template, prms):
        part = jpart if pkg is J else tpart
        return _partitioned_comps(pkg, part.by_layer_partition(template),
                                  prms)
    run_t, calls = _gate(monkeypatch, comps)
    # dense0: 16 chunks × (8 | 4) latents × 4 B; dense1: q8 260, q4 132
    assert run_t.history[0].bytes_up == 2 * 512 + 2 * 256 + 2 * 260 + 2 * 132
    assert calls == {"grouped": 2, "per_bucket": 0}      # one per round


def test_gate5_flat_mixed_grouped_run_matches_jax(monkeypatch):
    run_t, calls = _gate(monkeypatch,
                         lambda pkg, template, prms: _flat_comps(pkg, prms))
    assert run_t.history[0].bytes_up == 512 + 256 + 16_380 + 8_316
    assert calls == {"grouped": 2, "per_bucket": 0}
