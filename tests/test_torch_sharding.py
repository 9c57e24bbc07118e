"""The port's sharding rules (``repro_torch.models.sharding``) and
activation-sharding context (``repro_torch.models.partition_ctx``)
against the JAX package.

* ``param_specs``, ``fully_shard``, the optimizer's ZeRO-1 specs
  (``zero1_spec`` through ``launch.steps._opt_specs``), ``batch_specs``
  and ``cache_specs`` equal the reference's ``PartitionSpec`` tuples for
  every config in ``ARCH_IDS`` at full width, on ``{data: 16, model:
  16}`` and ``{pod: 2, data: 16, model: 16}`` (the reference reasons
  about them on an ``AbstractMesh``; the port on ``{axis: size}``),
  the ports of ``tests/test_substrates.py``'s sharding cases and
  ``tests/test_perf_features.py::test_fully_shard_adds_data_axis_to_big_leaves``;
* the context: a no-op without it and on a plain tensor, the reference's
  spec inside it, and on a one-rank ``DeviceMesh`` over gloo parameters
  spread with ``distribute_tensor`` give ``train_loss`` the same bits.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import sharding as jshard  # noqa: E402

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import partition_ctx as tctx  # noqa: E402
from repro_torch.models import sharding as tshard  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _abstract(shape):
    try:
        return AbstractMesh(tuple(shape.items()))
    except TypeError:                       # older AbstractMesh ctor
        return AbstractMesh(tuple(shape.values()), tuple(shape))


def _jspecs(tree):
    """{path: spec tuple} of a reference spec tree."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        out["/".join(str(getattr(e, "key", e)) for e in path)] = tuple(spec)
    return out


def _tspecs(tree, prefix=""):
    """{path: spec tuple} of a port spec tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tspecs(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """Both packages' full-width param shapes (built once an arch)."""
    return (jsteps.param_shapes(jget(arch)),
            tsteps.param_shapes(get_config(arch)))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax_at_full_width(arch, mesh_name):
    m = MESHES[mesh_name]
    jm = _abstract(m)
    jcfg, tcfg = jget(arch), get_config(arch)
    jp, tp = _shapes(arch)
    jps = jshard.param_specs(jp, jm)
    tps = tshard.param_specs(tp, m)
    assert _tspecs(tps) == _jspecs(jps)
    assert _tspecs(tshard.fully_shard(tps, tp, m)) == \
        _jspecs(jshard.fully_shard(jps, jp, jm))
    jo = jsteps._opt_specs(jcfg, jm, jps, jp, {"count": 0, "m": 0, "v": 0})
    to = tsteps._opt_specs(tcfg, m, tps, tp, {"count": 0, "m": 0, "v": 0})
    assert _tspecs(to) == _jspecs(jo)
    for name in ("train_4k", "decode_32k"):
        jb = jsteps.batch_shapes(jcfg, JSHAPES[name])
        tb = tsteps.batch_shapes(tcfg, SHAPES[name])
        assert _tspecs(tshard.batch_specs(tb, m)) == \
            _jspecs(jshard.batch_specs(jb, jm))
    for name in ("decode_32k", "long_500k"):
        jc = jsteps.cache_shapes(jcfg, JSHAPES[name])
        tc = tsteps.cache_shapes(tcfg, SHAPES[name])
        assert _tspecs(tshard.cache_specs(tc, m)) == \
            _jspecs(jshard.cache_specs(jc, jm))
    assert tshard.batch_axes(m) == jshard.batch_axes(jm)
    assert tshard.data_spec(m, 256, 3) == tuple(jshard.data_spec(jm, 256, 3))
    assert tshard.data_spec(m, 7, 2) == tuple(jshard.data_spec(jm, 7, 2))


def test_fully_shard_adds_data_axis_to_big_leaves():
    m = MESHES["16x16"]
    shapes = tsteps.param_shapes(get_config("llama3-8b"))
    specs = tshard.param_specs(shapes, m)
    specs2 = tshard.fully_shard(specs, shapes, m)
    a, b = _tspecs(specs), _tspecs(specs2)
    assert sum(1 for k in a if a[k] != b[k] and "data" in b[k]) > 0
    flat = _tspecs(tshard.map_specs(lambda s, t: (s, tuple(t.shape)),
                                    specs2, shapes))
    for spec, shp in flat.values():
        for dim, axis in zip(shp, tuple(spec) + (None,) * 8):
            if axis is not None:
                assert dim % tshard.spec_shards((axis,), m) == 0


def test_zero1_spec_and_mesh_shape():
    m = {"data": 16, "model": 16}
    assert tshard.zero1_spec((None, "model"), (32, 64), m) == ("data", "model")
    assert tshard.zero1_spec((None,), (7,), m) == (None,)
    assert tshard.zero1_spec((None,), (32,), {"model": 4}) == (None,)
    assert tshard.spec_shards((("pod", "data"), "model"),
                              {"pod": 2, "data": 16, "model": 16}) == 512


def test_activation_context_specs():
    x = torch.ones((2, 32, 8))
    assert tctx.constrain_activations(x) is x
    assert tctx.activation_spec(3, 32) is None
    with tctx.activation_sharding(("data",), "model"):
        assert tctx.constrain_activations(x) is x        # plain tensor
        assert tctx.activation_spec(3, 32) == (("data",), "model", None)
        assert tctx.activation_spec(3, 33) == (("data",), None, None)
        assert tctx.activation_spec(2, 32) == (("data",), None)
        with tctx.activation_sharding(("pod", "data")):
            assert tctx.activation_spec(2, 32) == (("pod", "data"), None)
        assert tctx.activation_spec(3, 32) == (("data",), "model", None)
    assert tctx.activation_spec(3, 32) is None


def test_distributed_params_give_train_loss_the_same_bits(tmp_path):
    """A one-rank (data, model) ``DeviceMesh`` over gloo: the reduced
    llama3-8b's params spread by their specs (``distribute_tensor``),
    ``train_loss`` inside the activation context (every residual-stream
    constraint redistributes a ``DTensor``) equals the plain call's bits."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.models import model as tmodel
    cfg = get_config("llama3-8b").reduced()
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in
             synthetic_lm_batch(0, cfg.vocab_size, 2, 32).items()}
    want, _ = tmodel.train_loss(params, cfg, batch)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        dp = tshard.distribute(mesh, params,
                               tshard.param_specs(params, mesh))
        assert isinstance(dp["layers"]["attn"]["wq"], DTensor)
        seen = []
        real = tctx.constrain_activations

        def spy(x):
            seen.append(isinstance(x, DTensor))
            return real(x)
        tmodel.constrain_activations = spy
        try:
            with implicit_replication(), \
                    tctx.activation_sharding(("data",), "model"):
                got, _ = tmodel.train_loss(dp, cfg, batch)
        finally:
            tmodel.constrain_activations = real
    finally:
        dist.destroy_process_group()
    assert len(seen) == 2 * cfg.n_layers and all(seen)
    got = got.full_tensor() if isinstance(got, DTensor) else got
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
