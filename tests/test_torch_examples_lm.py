"""The port's LM example entry points against the JAX package's examples
on the CPU: LM delta federation (``llm_federated``) and LM serving
(``llm_serve_decode``). The method is that of
``tests/test_torch_examples.py``: the reference's draws replayed at the
port's seams, the printouts compared line for line (integers exact, floats
in the golden band ``atol=2e-5, rtol=2e-4`` widened by half a unit of the
last printed digit, times left out).
"""
import argparse
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_examples_util import (BAND, JaxDraws, arch_pair,  # noqa: E402
                                  assert_same_printout, few_threads,
                                  run_jax_example)
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402

from repro_torch.examples import (llm_federated,  # noqa: E402
                                  llm_serve_decode)
from repro_torch.examples._common import Printer  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads(few_threads):
    yield


def _printed(fn, *a, **kw):
    """(what ``fn(..., out, ...)`` printed, its result)."""
    out = Printer()
    with contextlib.redirect_stdout(io.StringIO()):
        res = fn(*a, out=out, **kw)
    return "\n".join(out.lines), res


def _args(**kw):
    return argparse.Namespace(device=CPU, **kw)


def test_llm_federated_matches_reference(monkeypatch):
    """Reduced by the example's flags (2 clients, 2 rounds of 1 local
    epoch, 2 sequences of 16 tokens) and, inside, 4-epoch pre-pass AE fits
    and 2-epoch lifecycle refits (40 and 20 in the example: ~3 minutes in
    the port and two in the reference on this CPU). All three scenarios:
    the role partition, per-role prices, uplink and decoder bytes exact,
    losses and accuracies in the band, and the example's own
    ``decoder_rel_err < 0.01`` assertion in both."""
    argv = ("--rounds", "2", "--clients", "2", "--seqs", "2", "--seq", "16",
            "--batch", "2", "--local-epochs", "1")

    def patch(mod):
        fit, lifecycle = mod.train_autoencoder, mod.AELifecycle
        mod.train_autoencoder = lambda *a, **kw: fit(*a, **dict(
            kw, epochs=4))
        mod.AELifecycle = lambda **kw: lifecycle(**dict(
            kw, refresh_epochs=2))
    jax_text, jerr = run_jax_example("llm_federated", argv, patch=patch)
    cfg, jcfgs = arch_pair("llama3-8b")
    JaxDraws(monkeypatch, jcfgs)
    args = _args(arch="llama3-8b", rounds=2, clients=2, seqs=2, seq=16,
                 batch=2, local_epochs=1)
    text, res = _printed(llm_federated.federate, args, cfg,
                         prepass_epochs=4, refresh_epochs=2)
    assert jerr is None
    assert_same_printout(jax_text, text)
    assert res["runs"]["role-ae"]["rounds"][0]["ae_syncs"]


def _jax_batch(cfg, B, S):
    """``examples/llm_serve_decode.py:32-40``'s prompt batch."""
    k = jax.random.PRNGKey(1)
    batch = {"tokens": jax.random.randint(k, (B, S), 0, cfg.vocab_size)}
    if cfg.family == "audio":
        batch["frames"] = jax.random.normal(
            k, (B, cfg.encdec.n_frames, cfg.d_model))
    if cfg.family == "vlm":
        batch["image_embeds"] = jax.random.normal(
            k, (B, cfg.vlm.n_image_tokens, cfg.d_model))
    return batch


@pytest.mark.parametrize("arch,window", [
    ("llama3-8b", None), ("mamba2-2.7b", None), ("whisper-medium", None),
    ("phi-3-vision-4.2b", 16)])
def test_llm_serve_decode_matches_reference(monkeypatch, arch, window):
    """The example's own sizes (4 x 32 prompt, 16 tokens) on the reduced
    configs of four families, the last in sliding-window mode: the port's
    ``serve`` on the reference's weights and prompt batch prints the same
    greedy tokens, and its prefill logits equal the reference's
    ``prefill`` in the golden band."""
    argv = ["--arch", arch] + (["--window", str(window)] if window else [])
    jax_text, jerr = run_jax_example("llm_serve_decode", argv)
    cfg, jcfgs = arch_pair(arch)
    jcfg = jcfgs[cfg.name]
    draws = JaxDraws(monkeypatch, jcfgs)
    params = draws.init_params(torch.Generator().manual_seed(0), cfg, CPU)
    jbatch = _jax_batch(jcfg, 4, 32)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    text, res = _printed(llm_serve_decode.serve, cfg, params, batch, 16,
                         CPU, window=window)
    assert jerr is None
    assert_same_printout(jax_text, text, mask=(r"in [\d.]+s",
                                               r"\([\d.]+ tok/s\)"))
    want, _ = j_prefill(j_init_params(jax.random.PRNGKey(0), jcfg), jcfg,
                        jbatch, cache_len=48, window=window)
    np.testing.assert_allclose(res["logits"][0].numpy(), np.asarray(want),
                               **BAND)
