"""The plain reference against the port on the CPU at tiny sizes: the
codec piece by piece, and each driver's whole check within its cell's
limits."""
import time

import pytest
import torch

from bench import data as bdata, harness
from bench.drivers import fl_round
from bench.reference import codec as rc
from bench.tests import tiny


def test_reference_codec_matches_the_port():
    from repro_torch.core import codec
    from repro_torch.core.autoencoder import ChunkedAEConfig
    gen = bdata.generator(3, torch.device("cpu"))
    ae = fl_round.chunked_ae(gen, {"chunk_size": 256, "hidden": [32],
                                   "latent_chunk": 8, "norm_std": 1e-3})
    flat = torch.randn(3000, generator=gen) * 1e-3
    spec = codec.ComposedSpec(
        inner=codec.ChunkedAESpec(size=3000,
                                  cfg=ChunkedAEConfig(256, (32,), 8),
                                  use_kernel=True), bits=8, block=64)
    got = codec.encode(spec, ae, flat)
    q, s = rc.composed_encode(ae, flat, 256, 8, 64)
    assert torch.equal(got["z_q"], q)
    torch.testing.assert_close(got["z_scales"], s)
    torch.testing.assert_close(codec.decode(spec, ae, got),
                               rc.composed_decode(ae, q, s, 3000, 256))
    stacked = codec.stack_payloads([got, got])
    w = torch.tensor([0.25, 0.75])
    z = rc.composed_latents(torch.stack([q, q]), torch.stack([s, s]), 12, 8)
    torch.testing.assert_close(
        codec.decode_and_aggregate(spec, ae, stacked, w),
        rc.weighted_mean_decode(ae, z, w, 3000), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_program_within_the_limits(cell, tmp_path):
    manifest = tiny.write(tmp_path, [cell])
    res = harness.run_cell(cell, 11, 0.3, False, time.perf_counter(),
                           device="cpu", bench=tmp_path, manifest=manifest)
    for name, value, limit in res["checks"]:
        assert value <= limit, (name, value, limit)
