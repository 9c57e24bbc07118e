"""The metric arithmetic: a rate over the whole window, the 99th
percentile over every gap, roofline shares and MFU from shapes, each moved
by a known stall; and the cost functions held to hand counts at shapes
of PERF.md's kernel table."""
import time
from types import SimpleNamespace

import pytest
import torch

from bench import harness, tracing
from bench.cost import kernels as kc
from bench.cost import models as mc
from bench.cost.peaks import bound_s
from bench.drivers import fl_round, serve_ingest


def test_round_rate_covers_the_whole_window():
    """A stall of one round moves the window's mean round: no chunk
    statistic hides it."""
    waits = iter([0.01] * 5 + [0.2] + [0.01] * 100)

    class Sched:
        def run_round(self, r):
            time.sleep(next(waits))

    sut = SimpleNamespace(sched=Sched(), next_round=0,
                          device=torch.device("cpu"), attempted=0)
    got = fl_round.window(sut, 0.3)["round_s"]
    assert got > 1.5 * 0.01
    assert sut.attempted * got == pytest.approx(0.01 * (sut.attempted - 1)
                                                + 0.2, rel=0.3)


def test_p99_takes_every_gap():
    gaps = [1.0] * 980 + [5.0] * 20
    assert serve_ingest.p99(gaps) == 5.0          # 20 gaps beyond the 99th
    assert serve_ingest.p99([1.0] * 991 + [5.0] * 9) == 1.0
    assert serve_ingest.p99([2.0]) == 2.0


def test_cnn_flops_by_hand():
    model = tiny_model = harness.load_cell("cnn_sampled_round")[1]["model"]
    assert mc.cnn_layer_flops(model) == [1_555_200, 14_450_688, 5_308_416,
                                         7_372_800, 921_600, 46_080, 1_600]
    assert mc.cnn_train_flops(tiny_model) == (29_656_384, 87_413_952)


def test_lm_flops_by_hand():
    m = dict(d_model=4, n_heads=2, n_kv_heads=1, head_dim=2, d_ff=8,
             n_layers=1, vocab_size=10, seq_len=3)
    proj = 2 * 4 * (4 + 4) + 2 * 4 * 4 + 6 * 4 * 8     # 64 + 32 + 192
    attn = 2 * 2 * 4 * 2                              # (S + 1) / 2 = 2
    fwd, total = mc.lm_train_flops(m, 3)
    assert fwd == 3 * (proj + attn + 2 * 4 * 10)
    assert total == fwd + 3 * (2 * proj + 2 * attn + 2 * 4 * 10)


def ms(cost) -> float:
    return 1e3 * bound_s(*cost)


def test_kernel_bounds_at_the_table_shapes():
    """PERF.md's kernel table: kernel 1 at (2^20, 256), kernel 3 sgemm at
    run (h)'s (4096, 256, 32), kernel 4 at run (i)'s (100, 135, 512,
    4096), kernel 6 at run (f)'s (4, 1024, 56 over 8 × 128) bf16
    causal."""
    x = torch.empty((1 << 20, 256), device="meta")
    assert ms(kc.quantize(x, bits=8, block=256)) == pytest.approx(0.40190,
                                                                  rel=1e-4)
    q = torch.empty((1 << 20, 256), dtype=torch.int8, device="meta")
    s = torch.empty((1 << 20,), device="meta")
    assert ms(kc.dequantize(q, s, block=256)) == pytest.approx(0.40190,
                                                               rel=1e-4)
    a, w, b = (torch.empty(shape, device="meta")
               for shape in ((4096, 256), (256, 32), (32,)))
    assert ms(kc.dense(a, w, b)) == pytest.approx(0.0014184, rel=1e-4)
    h, cw, W, B = (torch.empty(shape, device="meta")
                   for shape in ((100, 135, 512), (100,), (512, 4096),
                                 (4096,)))
    assert ms(kc.decode_agg(h, cw, W, B)) == pytest.approx(0.011422,
                                                           rel=1e-4)
    qq = torch.empty((4, 1024, 56, 128), dtype=torch.bfloat16, device="meta")
    kk = torch.empty((4, 1024, 8, 128), dtype=torch.bfloat16, device="meta")
    assert ms(kc.attention(qq, kk, kk, mode="causal")) == pytest.approx(
        0.060858, rel=1e-4)


def ev(name, start, end, device=False, kernels=(), children=()):
    dt = (torch.autograd.DeviceType.CUDA if device
          else torch.autograd.DeviceType.CPU)
    return SimpleNamespace(name=name, device_type=dt,
                           time_range=SimpleNamespace(start=start, end=end),
                           kernels=list(kernels), cpu_children=list(children))


def reduce(events, costs, wall):
    trace = tracing.Trace(kind="round")
    tracing.reduce_profile(SimpleNamespace(events=lambda: events), trace,
                           costs, wall)
    return trace


def test_profile_reduction_and_readers():
    """Kernels under an operation's device-side range count towards its
    roofline; the ranges themselves are no device work; an idle gap is
    named by the span the host was in."""
    events = [
        ev("bench.span.client_encode", 0, 60),
        ev("bench.op.dense", 10, 20),
        ev("bench.op.dense", 100, 140, device=True),
        ev("k_dense", 100, 140, device=True),
        ev("k_other", 200, 300, device=True),
        ev("bench.span.client_encode", 150, 190, device=True),
    ]
    t = reduce(events, [("dense", 20e-6)], 400e-6)
    assert t.busy_s == pytest.approx(140e-6)
    assert t.ops["dense"][:2] == pytest.approx([20e-6, 40e-6])
    assert dict(t.idle_gaps) == pytest.approx({"outside_spans": 60e-6})
    assert harness.reader("kernel_roofline.round")(t) == pytest.approx(50.0)
    assert harness.reader("device_idle_share.round")(t) == pytest.approx(65.0)
    # a stall in the operation's kernel halves its roofline share
    events[3] = ev("k_dense", 100, 180, device=True)
    events[2] = ev("bench.op.dense", 100, 180, device=True)
    assert harness.reader("kernel_roofline.round")(
        reduce(events, [("dense", 20e-6)], 400e-6)) == pytest.approx(25.0)


def test_readers_return_nothing_without_a_device():
    t = reduce([ev("bench.op.dense", 0, 1)], [("dense", 1e-6)], 1.0)
    for name in ("kernel_roofline.round", "device_idle_share.round",
                 "kernel_roofline.ingest", "device_idle_share.ingest"):
        assert harness.reader(name)(t) is None


def test_mfu_and_span_readers():
    t = tracing.Trace(kind="round", steps={"plain": 4, "spans": 2},
                      seconds={"plain": 2.0},
                      spans={"client_train": [0.1, 0.3]},
                      step_flops=67e12 * 0.05, peak_flops=67e12)
    assert harness.reader("round_mfu")(t) == pytest.approx(10.0)
    assert harness.reader("client_train_ms")(t) == pytest.approx(200.0)
    assert harness.reader("server_agg_ms.ingest")(t) is None
    t.seconds["plain"] = 4.0                       # a stall halves it
    assert harness.reader("round_mfu")(t) == pytest.approx(5.0)
