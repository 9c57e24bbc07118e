"""The port's sequence aggregation API (``weighted_mean``, ``fedavg``,
``buffered_aggregate`` in ``repro_torch.core.aggregate``) against
``repro.core.aggregate`` on the CPU.

* the ports of ``tests/test_core_fl.py:63-77`` (``weighted_mean`` exact;
  FedAvg over identical updates is applying the update, for 1 to 5
  clients);
* ``weighted_mean``, ``fedavg`` (with a server learning rate) and
  ``buffered_aggregate`` against the reference on a mixed tree, in the
  golden band ``atol=2e-5, rtol=2e-4``, with and without weights;
* ``tests/test_codec.py:116-137``'s use: one ``decode_and_aggregate`` over
  the cohort equals per-client ``decode`` then ``weighted_mean``;
* the exports of ``repro_torch.core`` equal ``repro.core``'s aggregation
  names.

Inputs are drawn with numpy from a seed and handed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import core as J  # noqa: E402

from repro_torch import core as T  # noqa: E402
from repro_torch.core import codec  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)        # tests/test_golden_trajectory.py


def _trees(seed, n):
    rs = np.random.RandomState(seed)
    return [{"w": rs.randn(4, 3).astype(np.float32),
             "b": {"x": rs.randn(5).astype(np.float32)}} for _ in range(n)]


def _t(tree):
    return {"w": torch.from_numpy(tree["w"]),
            "b": {"x": torch.from_numpy(tree["b"]["x"])}}


def _j(tree):
    return {"w": jnp.asarray(tree["w"]), "b": {"x": jnp.asarray(tree["b"]["x"])}}


def _close(got, want, what):
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               **BAND, err_msg=what)
    np.testing.assert_allclose(got["b"]["x"].numpy(),
                               np.asarray(want["b"]["x"]), **BAND,
                               err_msg=what)


# ---------------------------------- ports of tests/test_core_fl.py:63-77
def test_weighted_mean_exact():
    t1 = {"w": torch.ones((3,))}
    t2 = {"w": torch.full((3,), 3.0)}
    m = T.weighted_mean([t1, t2], [1.0, 3.0])
    np.testing.assert_allclose(m["w"].numpy(), 2.5)


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 11), (3, 5), (4, 977),
                                    (5, 123456)])
def test_fedavg_identical_updates_fixed_point(n, seed):
    """FedAvg over identical updates == applying the single update."""
    rs = np.random.RandomState(seed)
    g = {"w": torch.from_numpy(rs.randn(4, 3).astype(np.float32))}
    u = {"w": torch.from_numpy(
        (np.random.RandomState(1).randn(4, 3) * 0.1).astype(np.float32))}
    new = T.fedavg(g, [u] * n)
    np.testing.assert_allclose(new["w"].numpy(), (g["w"] + u["w"]).numpy(),
                               atol=1e-6)


# ----------------------------------------------- against the reference
@pytest.mark.parametrize("weights", [None, [512.0, 317.0, 100.0]])
def test_weighted_mean_and_fedavg_match_jax(weights):
    ups = _trees(3, 3)
    glob = _trees(4, 1)[0]
    _close(T.weighted_mean([_t(u) for u in ups], weights),
           J.weighted_mean([_j(u) for u in ups], weights), "weighted_mean")
    _close(T.fedavg(_t(glob), [_t(u) for u in ups], weights, 0.7),
           J.fedavg(_j(glob), [_j(u) for u in ups], weights, 0.7), "fedavg")


@pytest.mark.parametrize("power", [0.0, 0.5, 2.0])
def test_buffered_aggregate_matches_jax(power):
    ups = _trees(8, 4)
    glob = _trees(9, 1)[0]
    base, stale = [64.0, 32.0, 64.0, 16.0], [0, 3, 1, 7]
    got = T.buffered_aggregate(_t(glob), [_t(u) for u in ups], base, stale,
                               power=power, server_lr=0.5)
    want = J.buffered_aggregate(_j(glob), [_j(u) for u in ups], base, stale,
                                power=power, server_lr=0.5)
    _close(got, want, "buffered_aggregate")


@pytest.mark.parametrize("bits", [8, 4])
def test_decode_and_aggregate_matches_sequential(bits):
    """``tests/test_codec.py``'s equivalence on the port: the one-call
    server path equals per-client decode then ``weighted_mean``."""
    n = 1000
    comp = T.QuantizeCompressor(bits=bits)
    spec, p = comp.spec(n), comp.codec_params()
    weights = [512.0, 317.0, 100.0]
    rs = np.random.RandomState(2)
    flats = [torch.from_numpy((rs.randn(n) * (1.0 + i)).astype(np.float32))
             for i in range(3)]
    payloads = [codec.encode(spec, p, f) for f in flats]
    nw = torch.tensor(T.normalize_weights(weights), dtype=torch.float32)
    got = codec.decode_and_aggregate(spec, p, codec.stack_payloads(payloads),
                                     nw)
    want = T.weighted_mean([{"u": codec.decode(spec, p, pl)}
                            for pl in payloads], weights)["u"]
    scale = float(want.abs().max()) + 1e-6
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               atol=1e-5 * scale, rtol=1e-5)


def test_core_exports_the_sequence_api():
    for name in ("weighted_mean", "fedavg", "buffered_aggregate",
                 "weighted_mean_stacked", "apply_update", "normalize_weights",
                 "staleness_weights", "distortion_weights"):
        assert hasattr(J, name) and hasattr(T, name), name
