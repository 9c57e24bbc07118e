"""``repro_torch.trace``: spans and counters that record only under a
profiler, on the profiler's clock as CPU operations, nested; and the
spans and transfer counts of a round of each scheduler, an LM delta round
and the serve step, on the CPU. A run traced gives the same results
(``torch.equal``) as one that is not.

The round builders here are the card test's too
(``tests/test_torch_gpu.py``): the file imports neither JAX nor the JAX
package.
"""
import time

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import core as T  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.configs.paper import ClassifierConfig  # noqa: E402
from repro_torch.core.pytree import leaves, ravel  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402

SMALL_CNN = dict(name="cifar-cnn-small", kind="cnn", input_shape=(12, 12, 3),
                 n_classes=10, conv_channels=(4, 4), conv_kernel=3,
                 dense_hidden=(16,))
TINY_LM = ArchConfig(name="tiny-lm", n_layers=2, d_model=32, n_heads=2,
                     n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=128,
                     norm_type="layernorm", param_dtype="float32",
                     compute_dtype="float32", remat=False)
PER, EPOCHS, BATCH = 32, 2, 16          # a CNN client's shard and steps
ROUND_CHILDREN = {"client_encode.codec": "client_encode",
                  "client_encode.ef": "client_encode",
                  "server_agg.decode_agg": "server_agg"}
INGEST_CHILDREN = ("ingest.pop", "ingest.payloads", "ingest.decode_agg",
                   "ingest.redispatch")


def profiled():
    """A CPU profiler: what turns the spans on."""
    return profile(activities=[ProfilerActivity.CPU])


def cnn_run(device, scheduler: str = "sampled", n_clients: int = 4):
    """The CIFAR CNN cut to 12×12 images over ``n_clients`` shards of
    :data:`PER` images, a composed chunked AE (kernel path) a client, EF
    on: ``scheduler`` is ``sync``, ``sampled`` (cohort 3, vmapped) or
    ``async`` (buffer 2)."""
    clf = ClassifierConfig(**SMALL_CNN)
    data = tpipe.synthetic_classification(0, n_clients * PER + 16,
                                          (12, 12, 3), 10)
    train, ev = tpipe.train_eval_split(data, 16)
    shards = tpipe.uniform_partition(1, train, n_clients)
    ae_cfg = T.ChunkedAEConfig(chunk_size=256, hidden=(32,), latent_chunk=8)
    ae = T.init_chunked_ae(torch.Generator().manual_seed(2), ae_cfg, device)
    comps = [T.ComposedCompressor(T.ChunkedAECompressor(ae, ae_cfg,
                                                        use_kernel=True))
             for _ in range(n_clients)]
    sched = {"sync": lambda: T.SyncFedAvg(),
             "sampled": lambda: T.SampledSync(cohort=3, sample_seed=1),
             "async": lambda: T.AsyncBuffered(buffer_k=2)}[scheduler]()
    cfg = T.FLConfig(n_rounds=1, local_epochs=EPOCHS, batch_size=BATCH,
                     payload="update", error_feedback=True, seed=0)
    return T.FederatedRun(clf, shards, cfg, compressors=comps,
                          eval_data=ev, scheduler=sched, device=device)


def lm_run(device):
    """An LM delta round (``SyncFedAvg``, two clients of 4 × 16 tokens,
    batch 2) with the benchmark's by-role codec: the MLP through a
    kernel-path chunked AE, every other role through int8."""
    from repro_torch.core import LMDeltaTask
    task = LMDeltaTask(TINY_LM, freeze_roles=("embedding",))
    params = task.init_params(torch.Generator().manual_seed(0), device)
    task.init_params = lambda gen, dev: params
    toks = tpipe.synthetic_lm_batch(3, TINY_LM.vocab_size, 8, 16)
    shards = [{k: v[i * 4:(i + 1) * 4] for k, v in toks.items()}
              for i in range(2)]
    ae_cfg = T.ChunkedAEConfig(chunk_size=256, hidden=(32,), latent_chunk=8)
    ae = T.init_chunked_ae(torch.Generator().manual_seed(4), ae_cfg, device)
    pmap = T.by_role_partition(params)
    comps = [T.PartitionedCompressor(pmap, {
        name: (T.ChunkedAECompressor(ae, ae_cfg, use_kernel=True)
               if name == "mlp" else T.QuantizeCompressor(bits=8, block=256))
        for name in pmap.names}) for _ in shards]
    cfg = T.FLConfig(n_rounds=1, local_epochs=1, batch_size=2, lr=1e-3,
                     optimizer="adam", payload="update", error_feedback=True,
                     seed=0)
    return T.FederatedRun(task, shards, cfg, compressors=comps,
                          eval_data={k: v[:2] for k, v in toks.items()},
                          scheduler=T.SyncFedAvg(), device=device)


def serve_step(device):
    """The serve loop at 2,000 clients, K 64, a composed chunked AE over
    8,000 values; returns ``(step, state)``."""
    from repro_torch.core.serve import ServeConfig, init_state, make_step
    ae_cfg = T.ChunkedAEConfig(chunk_size=256, hidden=(32,), latent_chunk=8)
    ae = T.init_chunked_ae(torch.Generator().manual_seed(5), ae_cfg, device)
    comp = T.ComposedCompressor(T.ChunkedAECompressor(ae, ae_cfg,
                                                      use_kernel=True))
    cfg = ServeConfig(n_clients=2000, buffer_k=64, spec=comp.spec(8000),
                      jitter=0.4, straggler_frac=0.05, seed=7)
    params = comp.codec_params()
    return (make_step(cfg, params, device),
            init_state(cfg, params, device=device))


def spans():
    return trace.snapshot()["spans"]


# ------------------------------------------------------------ the module
def test_off_records_nothing():
    trace.reset()
    assert not torch.autograd._profiler_enabled()
    assert trace.span("a") is trace.span("b")          # the shared no-op
    with trace.span("a"):
        trace.count("n", 3)
        trace.to_host(torch.ones(2))
        trace.to_device([1.0], "cpu", torch.float32)

    @trace.spanned("c")
    def f():
        return 4
    assert f() == 4
    assert trace.snapshot() == {"spans": {}, "counters": {}}


def test_on_nests_self_and_counts():
    trace.reset()
    with profiled():
        for _ in range(2):
            with trace.span("outer"):
                time.sleep(0.002)
                for _ in range(3):
                    with trace.span("inner"):
                        time.sleep(0.001)
                trace.count("n", 2)
    snap = trace.snapshot()
    out, inn = snap["spans"]["outer"], snap["spans"]["inner"]
    assert (out["calls"], inn["calls"]) == (2, 6)
    assert (out["parents"], inn["parents"]) == ([""], ["outer"])
    assert inn["self_s"] == inn["total_s"] >= 0.006
    assert out["self_s"] == pytest.approx(out["total_s"] - inn["total_s"],
                                          abs=1e-9)
    assert out["self_s"] >= 0.004
    assert snap["counters"] == {"n": 4}
    trace.reset()
    assert trace.snapshot() == {"spans": {}, "counters": {}}


def test_spans_are_cpu_operations_under_their_parent():
    """Each span is an ordinary CPU operation of the trace (no user
    annotation, so nothing on a device's timeline), nested under the span
    it ran in."""
    trace.reset()
    with profiled() as prof:
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(4).sum()
    events = {e.name: e for e in prof.events()
              if e.name in ("outer", "inner")}
    assert set(events) == {"outer", "inner"}
    for e in events.values():
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation
    assert events["inner"].cpu_parent.name == "outer"
    assert any(c.name == "aten::sum" for c in events["inner"].cpu_children)


# ------------------------------------------------------------ the paths
@pytest.mark.parametrize("scheduler", ["sync", "sampled", "async"])
def test_round_spans(scheduler):
    run = cnn_run("cpu", scheduler)
    n = {"sync": 4, "sampled": 3, "async": 2}[scheduler]
    trace.reset()
    with profiled():
        run.scheduler.run_round(0)
    s = spans()
    assert s["round"]["calls"] == 1 and s["round"]["parents"] == [""]
    for name in ("client_encode", "client_encode.codec", "client_encode.ef"):
        assert s[name]["calls"] == n, name
    for name in ("server_agg", "server_agg.decode_agg", "global_eval"):
        assert s[name]["calls"] == 1, name
    for child, parent in ROUND_CHILDREN.items():
        assert s[child]["parents"] == [parent]
    # the vmapped cohort trains in one call; the others a call a client
    assert s["client_train"]["calls"] == (1 if scheduler == "sampled" else n)
    assert s["client_train.grad"]["parents"] == ["client_train"]
    assert s["kernel.fused_dense"]["calls"] > 0
    assert s["kernel.fused_decode_agg"]["parents"] == ["server_agg.decode_agg"]
    assert trace.snapshot()["counters"]["cuda_frees"] == 0     # no CUDA here


def test_round_counts_its_transfers_and_computes_the_same():
    """One sampled round: each step uploads its batch's indices and two
    Adam bias corrections a leaf, the cohort's metrics and the evaluation's
    come back a value each, the server uploads the cohort's weights. The
    traced round's model equals the untraced one's."""
    plain = cnn_run("cpu")
    rec = plain.scheduler.run_round(0)
    run = cnn_run("cpu")
    trace.reset()
    with profiled():
        rec_t = run.scheduler.run_round(0)
    assert torch.equal(ravel(run.global_params)[0],
                       ravel(plain.global_params)[0])
    assert rec_t.global_metrics == rec.global_metrics
    steps = EPOCHS * (PER // BATCH)
    n_leaves = len(leaves(run.global_params))
    want = (steps * (1 + 2 * n_leaves) + len(rec.collab_metrics[0])
            + 1 + len(rec.global_metrics))
    snap = trace.snapshot()
    assert snap["counters"]["host_syncs"] == want
    assert snap["spans"]["host_sync"]["calls"] == want


def test_lm_round_spans_split_the_training_step():
    run = lm_run("cpu")
    trace.reset()
    with profiled():
        run.scheduler.run_round(0)
    s = spans()
    steps = 2 * 2                      # two clients, two batches of two
    assert s["client_train"]["calls"] == 2
    assert s["client_train.grad"]["calls"] == steps
    assert s["client_train.optimizer"]["calls"] == steps
    assert s["client_train.grad"]["parents"] == ["client_train"]
    assert s["client_encode"]["calls"] == 2
    assert s["kernel.quantize_blocks_2d"]["calls"] > 0
    assert s["server_agg.decode_agg"]["parents"] == ["server_agg"]


def test_serve_step_spans_and_one_transfer_in_the_first_step_only():
    step, state = serve_step("cpu")
    trace.reset()
    with profiled():
        state = step(state)
        first = trace.snapshot()["counters"].get("host_syncs", 0)
        state = step(state)
    snap = trace.snapshot()
    s = snap["spans"]
    assert s["ingest_step"]["calls"] == 2
    for name in INGEST_CHILDREN:
        assert s[name]["calls"] == 2 and s[name]["parents"] == ["ingest_step"]
    assert s["kernel.fused_decode_agg"]["parents"] == ["ingest.decode_agg"]
    # the first step reads next_seq back, of which later steps keep a host
    # copy; the versions are filled from the device's global version
    assert first == 1
    assert snap["counters"]["host_syncs"] == 1
