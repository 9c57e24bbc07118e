"""The port's example entry points (``repro_torch.examples``) against the
JAX package's ``examples/*.py`` on the CPU: the paper pipeline
(``quickstart``), the batched server (``batched_server_decode``), the
serve loop (``fl_serve``), the schedulers (``fl_async_sampling``) and the
AE lifecycle (``ae_lifecycle_refresh``); and every example module imported
without ``jax`` or ``repro``, raising without a card.

Each JAX example runs in process (``examples/<name>.py`` imported afresh,
``sys.argv`` set, stdout captured); the port runs the same arguments on
the CPU with the reference's random draws replayed at its seams
(``_torch_examples_util.JaxDraws``). The two printouts are compared line
for line: the same words, integers (bytes, cohorts, staleness, syncs)
exact, floats within the golden band ``atol=2e-5, rtol=2e-4`` widened by
half a unit of the last printed digit; times are left out.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_examples_util import (BAND, JaxDraws, ROOT,  # noqa: E402
                                  assert_same_printout, run_jax_example,
                                  run_port_example, few_threads)
from repro import core as J  # noqa: E402

from repro_torch.examples import NAMES  # noqa: E402
from repro_torch.examples import (ae_lifecycle_refresh,  # noqa: E402
                                  batched_server_decode, fl_async_sampling,
                                  fl_serve, quickstart)
from repro_torch.examples._common import Printer  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads(few_threads):
    yield


def _port_fn(fn, *a, **kw):
    """A port example's factored function with a printer; returns (the
    printed text, its result)."""
    out = Printer()
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        res = fn(CPU, out, *a, **kw)
    return "\n".join(out.lines), res


def test_quickstart_matches_reference(monkeypatch):
    """At the example's own size: the pre-pass AE fit (loss, accuracy),
    the compression line and the validation-model curve."""
    jax_text, jerr = run_jax_example("quickstart")
    JaxDraws(monkeypatch)
    text, res, err = run_port_example(quickstart)
    assert jerr is None and err is None
    assert_same_printout(jax_text, text)
    assert res["lines"] == text.splitlines()
    assert res["compressed_bytes"] == 128 and res["snapshots"] == 10


def test_batched_server_decode_matches_reference(monkeypatch):
    """At the example's own size: the cohort line and uplink bytes exact;
    both aggregators agree with the per-client loop (the reference's and
    the port's max|Δ| under 1e-5); the loop's aggregate against the
    reference's loop over the same draws in the golden band."""
    mask = (r" *[\d.]+ ms/round",
            r"\( ?[\d.]+x vs loop, max\|Δ\|=[\d.e+-]+\)")
    jax_text, jerr = run_jax_example("batched_server_decode")
    draws = JaxDraws(monkeypatch)
    draws.normal_seeds = {1}
    text, res, err = run_port_example(batched_server_decode)
    assert jerr is None and err is None
    assert_same_printout(jax_text, text, mask=mask)
    for line in jax_text.splitlines()[-2:]:
        assert float(line.rsplit("=", 1)[1].rstrip(")")) < 1e-5, line
    for row in res["rows"].values():
        assert row["max_abs_err"] < 1e-5, res["rows"]
    assert res["up_bytes"] == 64 * 4096

    cfg = J.ChunkedAEConfig(chunk_size=256, hidden=(32,), latent_chunk=8)
    params = J.init_chunked_ae(jax.random.PRNGKey(0), cfg)
    spec = J.codec.ChunkedAESpec(size=1 << 15, cfg=cfg, use_kernel=False)
    base = jax.random.normal(jax.random.PRNGKey(1), (1 << 15,))
    weights = J.normalize_weights([float(i + 1) for i in range(64)])
    acc = jnp.zeros((1 << 15,), jnp.float32)
    for i, w in enumerate(weights):
        acc = acc + w * J.codec.decode(
            spec, params, J.codec.encode(spec, params, base * (1 + 0.01 * i)))
    np.testing.assert_allclose(res["aggregate"].numpy(), np.asarray(acc),
                               **BAND)


@pytest.mark.parametrize("argv", [
    ("--rounds", "3"),
    ("--spec", "q4", "--shard", "--buffer-k", "64", "--rounds", "3"),
    ("--spec", "topk", "--model-size", "1024", "--rounds", "2"),
], ids=["q8", "q4-shard", "topk"])
def test_fl_serve_matches_reference(argv):
    """The round's uplink bytes, the model version, the simulated clock
    and the updates aggregated; the throughput line is host time. The
    latency draws are each package's own: at N = 100,000 the clock after a
    few rounds is the population's fastest tail, 0.6 s at one decimal in
    both (``tests/test_torch_serve.py`` replays the draws)."""
    jax_text, jerr = run_jax_example("fl_serve", argv)
    text, res, err = run_port_example(fl_serve, argv)
    assert jerr is None and err is None
    assert_same_printout(jax_text, text, skip_lines=(r"^sustained",))
    assert res["version"] == int(argv[-1]) + fl_serve.WARMUP


def test_fl_async_sampling_matches_reference(monkeypatch):
    """Reduced: ``SMOKE_SCALE_SCENARIO`` at 8 clients and 2 rounds (the
    example's own 16 x 3 takes ~40 s in the reference alone). Cohorts,
    staleness, the clock, bytes and ratios exact; accuracies in the band."""
    import repro.configs.paper as jpaper
    from repro_torch.configs.paper import SMOKE_SCALE_SCENARIO
    small = dict(n_clients=8, rounds=2)

    def patch(mod):
        mod.SMOKE_SCALE_SCENARIO = dataclasses.replace(
            jpaper.SMOKE_SCALE_SCENARIO, **small)
    jax_text, jerr = run_jax_example("fl_async_sampling", patch=patch)
    JaxDraws(monkeypatch)
    text, res = _port_fn(fl_async_sampling.schedulers,
                         dataclasses.replace(SMOKE_SCALE_SCENARIO, **small))
    assert jerr is None
    assert_same_printout(jax_text, text)
    assert res["vmap_rounds"] == 2 and res["loop_rounds"] == 0
    assert all(r["staleness"] is not None
               for r in res["runs"][2]["rounds"])


def test_ae_lifecycle_refresh_matches_reference(monkeypatch):
    """Reduced: 2 clients, 4 rounds, 10-epoch pre-pass AE fits and
    5-epoch refits (the example's own 4 clients x 7 rounds take ~35 s in
    the reference alone); the cadence refits at round 3. Syncs, bytes and
    the reconciliation exact or in the band, and the example's own
    ``decoder_rel_err < 5%`` assertion passes in both."""
    def patch(mod):
        prepass, lifecycle, fl = mod.run_prepass, mod.AELifecycle, \
            mod.FLConfig
        mod.N_CLIENTS = 2
        mod.run_prepass = lambda *a, **kw: prepass(*a, **dict(
            kw, ae_epochs=10))
        mod.AELifecycle = lambda **kw: lifecycle(**dict(
            kw, refresh_epochs=5))
        mod.FLConfig = lambda **kw: fl(**dict(kw, n_rounds=4))
    jax_text, jerr = run_jax_example("ae_lifecycle_refresh", patch=patch)
    draws = JaxDraws(monkeypatch)
    text, res = _port_fn(ae_lifecycle_refresh.lifecycle_run, n_clients=2,
                         rounds=4, ae_epochs=10, refresh_epochs=5)
    assert jerr is None
    assert_same_printout(jax_text, text)
    assert draws.fits == 2 + 1      # two pre-passes, one cohort refit
    assert [r["ae_syncs"] for r in res["rounds"]] == [[0, 1], [], [],
                                                      [0, 1]]


_NO_JAX = textwrap.dedent("""
    import importlib, sys
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    from repro_torch.examples import NAMES
    for name in NAMES:
        mod = importlib.import_module("repro_torch.examples." + name)
        try:
            mod.main([])
        except RuntimeError as e:
            assert "no CUDA device is available" in str(e), (name, e)
        else:
            raise AssertionError(name + " ran without a card")
    assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                   for m, v in sys.modules.items() if v is not None)
    print("ok", len(NAMES))
""")


def test_examples_import_without_jax_and_raise_without_a_card():
    """Every example module imports with ``jax`` and ``repro`` blocked,
    and ``main([])`` (device ``cuda``) raises ``device.resolve``'s error
    on a machine without a card, before any work."""
    assert len(NAMES) == 10
    assert {p.stem for p in (ROOT / "examples").glob("*.py")} == set(NAMES)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", _NO_JAX], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok 10"
