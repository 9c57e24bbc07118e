"""The port's roofline (``repro_torch.roofline``), step builders
(``repro_torch.launch.steps``), dry-run and training driver against the
JAX package on the CPU.

* ``decode_agg_roofline``: ``flops``, ``hbm_bytes`` and ``launches``
  equal the reference's on ``tests/test_roofline_decode_agg.py``'s
  shapes (the machine block is the H100's, so intensities' placement
  moves), and that file's finiteness and ordering cases;
* ``active_params``, ``attention_flops`` and ``model_flops`` equal the
  reference's for every config and shape, and
  ``tests/test_perf_features.py:114-128``'s ordering case;
* ``RooflineReport``'s row: the reference's keys, bar the XLA-only
  ``memory_fused_ms``, named under ``left_out``;
* ``batch_shapes``/``cache_shapes`` (meta tensors) for every shape in
  ``SHAPES`` equal the reference's ``jax.eval_shape`` trees
  (``tests/test_system.py:111-122``);
* the dry-run on two reduced archs (train, prefill, decode and the FL
  round): finite rows, the counted FLOPs within 25 % of ``model_flops``
  in training, the FL round's cross-pod bytes exactly its latents and
  metrics; the training driver's ``--mode fl`` and ``--mode train`` on
  the CPU.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCH_IDS, SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402

from repro_torch.configs import SHAPES, ShapeConfig, get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.roofline import analysis as tanalysis  # noqa: E402

VARIANTS = ("loop", "vmap", "fused", "grouped")
DA_SHAPES = [
    dict(cohort=8, n_chunks=128, latent=8, hidden=(32,), chunk=256),
    dict(cohort=64, n_chunks=120, latent=4, hidden=(32,), chunk=256,
         n_buckets=2),
    dict(cohort=1, n_chunks=1, latent=2, hidden=(), chunk=8),
    dict(cohort=256, n_chunks=4096, latent=8, hidden=(64, 32), chunk=512,
         n_buckets=4),
]


@pytest.mark.parametrize("shape", DA_SHAPES)
def test_decode_agg_roofline_matches_jax(shape):
    want = janalysis.decode_agg_roofline(**shape)
    got = tanalysis.decode_agg_roofline(**shape)
    assert got["shape"] == want["shape"]
    for v in VARIANTS:
        for field in ("flops", "hbm_bytes", "launches"):
            assert got[v][field] == want[v][field], (v, field)
        for field in ("flops", "hbm_bytes", "arith_intensity",
                      "pct_of_roof"):
            assert math.isfinite(got[v][field]) and got[v][field] > 0
        assert 0.0 < got[v]["pct_of_roof"] <= 100.0
        assert got[v]["bound"] in ("memory", "compute")
        ai = got[v]["flops"] / got[v]["hbm_bytes"]
        assert got[v]["arith_intensity"] == ai
        assert got[v]["bound"] == ("memory" if ai < 989e12 / 3.35e12
                                   else "compute")
    m = got["machine"]
    assert (m["hbm_bw"], m["peak_flops"]) == (3.35e12, 989e12)
    assert m["ridge_intensity"] == 989e12 / 3.35e12


def test_decode_agg_ordering_and_degenerate_shapes():
    roof = tanalysis.decode_agg_roofline(cohort=64, n_chunks=128, latent=8,
                                         hidden=(32,), chunk=256,
                                         n_buckets=2)
    assert len({roof[v]["flops"] for v in VARIANTS}) == 1
    assert (roof["loop"]["hbm_bytes"] > roof["vmap"]["hbm_bytes"]
            > roof["fused"]["hbm_bytes"] > roof["grouped"]["hbm_bytes"])
    assert roof["loop"]["launches"] == 64 * 2
    assert roof["grouped"]["launches"] == 1
    with pytest.raises(AssertionError):
        tanalysis.decode_agg_roofline(cohort=0, n_chunks=1, latent=1,
                                      hidden=(), chunk=1)


def test_mesh_constants_are_the_h100s():
    assert tmesh.HBM_BW == 3.35e12
    assert tmesh.PEAK_FLOPS_BF16 == 989e12
    assert tmesh.PEAK_FLOPS_F32 == 67e12
    assert tmesh.NVLINK_BW == 450e9 and tmesh.CROSS_NODE_BW == 50e9
    assert tmesh.production_mesh_shape(multi_pod=True) == {
        "pod": 2, "data": 16, "model": 16}
    assert not hasattr(tmesh, "ICI_BW")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_jax(arch):
    jcfg, tcfg = jget(arch), get_config(arch)
    assert tanalysis.active_params(tcfg) == janalysis.active_params(jcfg)
    for name in SHAPES:
        assert tanalysis.attention_flops(tcfg, SHAPES[name]) == \
            janalysis.attention_flops(jcfg, JSHAPES[name])
        assert tanalysis.model_flops(tcfg, SHAPES[name]) == \
            janalysis.model_flops(jcfg, JSHAPES[name])


def test_model_flops_estimates_positive_and_ordered():
    cfg = get_config("llama3-8b")
    f_train = tanalysis.model_flops(cfg, SHAPES["train_4k"])
    f_prefill = tanalysis.model_flops(cfg, SHAPES["prefill_32k"])
    f_decode = tanalysis.model_flops(cfg, SHAPES["decode_32k"])
    assert f_train > f_prefill > f_decode > 0
    assert tanalysis.attention_flops(cfg, SHAPES["prefill_32k"]) > \
        0.25 * f_prefill
    assert tanalysis.attention_flops(get_config("mamba2-2.7b"),
                                     SHAPES["prefill_32k"]) == 0.0


def test_report_row_keys():
    kw = dict(name="x", n_devices=4, flops_per_device=1e12,
              hbm_bytes_per_device=1e9, collective_bytes_per_device=2e8,
              collective_breakdown={"all-reduce": 2e8},
              peak_memory_per_device=2**30, model_flops=3e12,
              cross_pod_bytes_per_device=1e8)
    want = janalysis.RooflineReport(**kw).row()
    got = tanalysis.RooflineReport(**kw)
    row = got.row()
    assert set(row) == (set(want) - {"memory_fused_ms"}) | {"left_out"}
    assert row["left_out"] == ["memory_fused_ms", "attn_loop_bytes"]
    assert row["compute_ms"] == round(1e12 / 989e12 * 1e3, 3)
    assert row["memory_ms"] == round(1e9 / 3.35e12 * 1e3, 3)
    assert got.collective_s == 1e8 / 450e9 + 1e8 / 50e9
    assert row["model_flops_frac"] == want["model_flops_frac"]
    assert row["hbm_gb_per_dev"] == want["hbm_gb_per_dev"]


def _sig(tree):
    if isinstance(tree, dict):
        return {k: _sig(v) for k, v in tree.items()}
    if isinstance(tree, int):
        return ((), "int32")                 # the port's Python index
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", ["llama3-8b", "minicpm3-4b",
                                  "recurrentgemma-9b", "whisper-medium",
                                  "mamba2-2.7b", "phi-3-vision-4.2b"])
def test_step_shapes_cover_all_shapes(arch):
    jcfg, tcfg = jget(arch), get_config(arch)
    for name, shape in SHAPES.items():
        b = tsteps.batch_shapes(tcfg, shape)
        assert b["tokens"].device.type == "meta"
        jb = jsteps.batch_shapes(jcfg, JSHAPES[name])
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in b.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in jb.items()}
        if shape.mode == "decode":
            c = tsteps.cache_shapes(tcfg, shape)
            assert c["index"] == 0
            jc = jax.tree_util.tree_map(
                lambda s: (tuple(s.shape), str(s.dtype)),
                jsteps.cache_shapes(jcfg, JSHAPES[name]))
            assert _sig(c) == jc
        assert tsteps.decode_window(tcfg, shape) == \
            jsteps.decode_window(jcfg, JSHAPES[name])


@pytest.mark.parametrize("arch", ["llama3-8b", "stablelm-1.6b"])
def test_dryrun_reduced_rows(arch):
    from repro_torch.core import distributed as tdist
    from repro_torch.launch.dryrun import run_one
    cfg = get_config(arch).reduced()
    rows = {}
    for mode, fl in (("train", False), ("train", True), ("prefill", False),
                     ("decode", False)):
        shape = ShapeConfig(f"t_{mode}", 64, 32, mode)
        row = run_one(arch, shape.name, multi_pod=True, fl=fl, cfg=cfg,
                      shape=shape, verbose=False)
        for k in ("compute_ms", "memory_ms", "collective_ms",
                  "hbm_gb_per_dev", "model_flops_frac"):
            assert math.isfinite(row[k]) and row[k] >= 0, (mode, k)
        assert row["model_flops_frac"] > 0 and row["hbm_gb_per_dev"] >= 0
        assert row["devices"] == 512
        rows[(mode, fl)] = row
    for key in (("train", False), ("train", True)):
        assert 0.8 <= rows[key]["model_flops_frac"] <= 1.25, rows[key]
    assert rows[("train", False)]["collective_ms"] == 0.0
    # the FL round's cross-pod traffic is its latents and two metrics
    from repro_torch.core.pytree import flatten
    params = tsteps.param_shapes(cfg)
    n = sum(x.numel() for x in flatten(params)[0])
    lat = tdist.compressed_fraction(params, tdist.DEFAULT_AE) * 4 * n
    assert rows[("train", True)]["cross_pod_gb_per_dev"] == round(
        (lat + 8) / 2**30, 6)


def test_train_driver_fl_and_train_modes(tmp_path, capsys):
    from repro_torch.checkpoint.checkpoint import load_pytree
    from repro_torch.launch import train
    from repro_torch.models import init_params
    ck = tmp_path / "fl.npz"
    train.main(["--arch", "llama3-8b", "--reduced", "--mode", "fl",
                "--steps", "2", "--batch", "2", "--seq", "32",
                "--log-every", "1", "--device", "cpu",
                "--checkpoint", str(ck)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=llama3-8b-smoke params=1,836,288 mode=fl")
    fl = [ln for ln in out if ln.startswith("fl round")]
    assert len(fl) == 2
    assert all(np.isfinite(float(ln.split("loss=")[1].split()[0]))
               for ln in fl)
    cfg = get_config("llama3-8b").reduced()
    like = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    got, meta = load_pytree(str(ck), like, device="cpu")
    assert meta == {"arch": "llama3-8b-smoke", "steps": 2}
    assert not torch.equal(got["layers"]["attn"]["wq"],
                           like["layers"]["attn"]["wq"])
    import torch.distributed as dist
    assert not dist.is_initialized()           # the driver destroyed it
    train.main(["--preset", "lm25m", "--steps", "1", "--batch", "1",
                "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=lm25m") and out[1].startswith("step    0")
