"""Shared plumbing of the example parity tests (``test_torch_examples*.py``):
running a JAX example in process, replaying ``jax.random`` draws at the
port's random seams, and comparing what two runs printed.

The port draws from ``torch.Generator``s seeded with the reference's
integers (``PRNGKey(s)`` ↔ ``Generator().manual_seed(s)``), so its draws
differ from the reference's. :class:`JaxDraws` makes them the same: every
port function that draws an initial tree (``init_classifier``,
``init_fc_ae``, ``init_chunked_ae``, ``models.init_params``) returns the
JAX package's tree drawn from the corresponding key, and every AE fit
(``train_autoencoder_cohort``, which ``train_autoencoder`` and the lifecycle
refits go through) takes the reference's split and epoch permutations
(``repro.core.autoencoder._train_setup`` / ``_scan_fit``) from a queue that
``torch.randperm`` pops for that generator; ``torch.randn`` replays
``jax.random.normal`` for the generator seeds a test names.
``run_prepass`` splits its key into a model key and an AE key, as the
reference does. Nothing of the port
changes; only its draws do.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import re
import sys
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro import core as J
from repro.configs import get_config as j_get_config
from repro.configs.paper import AEConfig as JAEConfig
from repro.configs.paper import ClassifierConfig as JClassifierConfig
from repro.models import init_params as j_init_params
from repro.models.classifiers import init_classifier as j_init_classifier

from repro_torch.core.pytree import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
BAND = dict(atol=2e-5, rtol=2e-4)


@pytest.fixture
def few_threads():
    """Two intra-op threads for the test: the reference's XLA pool and
    torch's both size themselves to the machine, and the suite runs
    several workers at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def run_jax_example(name: str, argv=(), patch=None):
    """Import ``examples/<name>.py`` afresh, let ``patch(module)`` change
    names in its namespace (sizes, wrapped reference calls), run its
    ``main()`` with ``sys.argv`` set, and return (stdout, exception or
    None). The example's own exceptions are returned, not raised."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if patch is not None:
        patch(mod)
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [f"{name}.py", *argv]
    err = None
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    except AssertionError as e:
        err = e
    finally:
        sys.argv = old
    return buf.getvalue(), err


def run_port_example(mod, argv=()):
    """The port example's ``main(["--device", "cpu", *argv])``; returns
    (printed text, result dict or None, exception or None)."""
    buf = io.StringIO()
    err, res = None, None
    try:
        with contextlib.redirect_stdout(buf):
            res = mod.main(["--device", "cpu", *argv])
    except AssertionError as e:
        err = e
    return buf.getvalue(), res, err


# ------------------------------------------------------------ draw replay
def _jax_cfg(cls, cfg):
    return cls(**dataclasses.asdict(cfg))


class JaxDraws:
    """Patches the port's random seams (see the module docstring) for the
    duration of a test; ``arch_cfgs`` maps a port ``ArchConfig`` name to
    the JAX config it was built from (``models.init_params``)."""

    def __init__(self, monkeypatch, arch_cfgs=None):
        self.mp = monkeypatch
        self.arch_cfgs = dict(arch_cfgs or {})
        self.keys = {}          # id(gen) -> {"model": key, "ae": key}
        self.perms = {}         # id(gen) -> deque of numpy permutations
        self.ae_init = {}       # id(gen) -> key of the next fresh AE init
        self.gens = []          # keeps registered generators alive
        self.fits = 0
        import repro_torch.core.autoencoder as tae
        import repro_torch.core.prepass as tprep
        import repro_torch.models.classifiers as tclf
        import repro_torch.models.model as tmodel
        self._orig = {
            "init_classifier": tclf.init_classifier,
            "init_fc_ae": tae.init_fc_ae,
            "init_chunked_ae": tae.init_chunked_ae,
            "init_params": tmodel.init_params,
            "run_prepass": tprep.run_prepass,
            "train_autoencoder_cohort": tae.train_autoencoder_cohort,
            "randperm": torch.randperm,
            "randn": torch.randn,
        }
        self.normal_seeds = set()   # CPU generators whose randn replays
        for name, fn in (("init_classifier", self.init_classifier),
                         ("init_fc_ae", self.init_fc_ae),
                         ("init_chunked_ae", self.init_chunked_ae),
                         ("init_params", self.init_params),
                         ("run_prepass", self.run_prepass),
                         ("train_autoencoder_cohort", self.cohort)):
            self._patch_everywhere(self._orig[name], fn)
        monkeypatch.setattr(torch, "randperm", self.randperm)
        monkeypatch.setattr(torch, "randn", self.randn)

    def _patch_everywhere(self, orig, fn):
        """Rebind ``orig`` to ``fn`` in every loaded port module that holds
        it (``from x import f`` copies the name)."""
        for modname, m in list(sys.modules.items()):
            if not modname.startswith("repro_torch") or m is None:
                continue
            for attr, val in list(vars(m).items()):
                if val is orig:
                    self.mp.setattr(m, attr, fn)

    def _key(self, gen, role):
        own = self.keys.get(id(gen), {})
        if role in own:
            return own[role]
        return jax.random.PRNGKey(gen.initial_seed())

    def _hold(self, gen):
        self.gens.append(gen)
        return id(gen)

    # the initial trees
    def init_classifier(self, gen, cfg, device=None):
        p = j_init_classifier(self._key(gen, "model"),
                              _jax_cfg(JClassifierConfig, cfg))
        return from_jax_params(np_tree(p), device)

    def init_fc_ae(self, gen, cfg, device=None):
        key = self.ae_init.pop(id(gen), None)
        if key is None:
            key = self._key(gen, "ae_init")
        return from_jax_params(
            np_tree(J.init_fc_ae(key, _jax_cfg(JAEConfig, cfg))), device)

    def init_chunked_ae(self, gen, cfg, device=None):
        jcfg = J.ChunkedAEConfig(**dataclasses.asdict(cfg))
        return from_jax_params(
            np_tree(J.init_chunked_ae(self._key(gen, "ae_init"), jcfg)),
            device)

    def init_params(self, gen, cfg, device=None):
        jcfg = self.arch_cfgs[cfg.name]
        assert jcfg.name == cfg.name, (jcfg.name, cfg.name)
        return from_jax_params(
            np_tree(j_init_params(self._key(gen, "model"), jcfg)), device)

    # the pre-pass's split key and the AE fits' permutations
    def run_prepass(self, gen, *a, **kw):
        k_model, k_ae = jax.random.split(self._key(gen, "model"))
        self.keys[self._hold(gen)] = {"model": k_model, "ae": k_ae}
        try:
            return self._orig["run_prepass"](gen, *a, **kw)
        finally:
            self.keys.pop(id(gen), None)

    def cohort(self, gens, cfg, datasets, *, epochs=200, val_fraction=0.2,
               init=None, **kw):
        n = datasets.shape[1]
        n_val = max(1, int(n * val_fraction)) if n > 2 else 0
        for g in gens:
            key = self._key(g, "ae")
            k_init, k_shuf, k_split = jax.random.split(key, 3)
            q = deque([np.asarray(jax.random.permutation(k_split, n))])
            for _ in range(epochs):
                ks = jax.random.split(k_shuf)
                k_shuf, k = ks[0], ks[1]
                q.append(np.asarray(jax.random.permutation(k, n - n_val)))
            self.perms[self._hold(g)] = q
            if init is None:
                self.ae_init[id(g)] = k_init
        self.fits += 1
        try:
            return self._orig["train_autoencoder_cohort"](
                gens, cfg, datasets, epochs=epochs,
                val_fraction=val_fraction, init=init, **kw)
        finally:
            for g in gens:
                assert not self.perms.pop(id(g), None), \
                    "the fit drew fewer permutations than the reference"
                self.ae_init.pop(id(g), None)

    def randperm(self, n, *a, generator=None, **kw):
        q = self.perms.get(id(generator)) if generator is not None else None
        if not q:
            return self._orig["randperm"](n, *a, generator=generator, **kw)
        perm = q.popleft()
        assert perm.shape == (n,), (perm.shape, n)
        return torch.from_numpy(perm.astype(np.int64)).to(
            kw.get("device") or "cpu")


    def randn(self, *size, generator=None, **kw):
        """``jax.random.normal(PRNGKey(s), shape)`` for a CPU generator
        seeded ``s`` in ``normal_seeds``; torch's own draw otherwise."""
        if (generator is None or generator.device.type != "cpu"
                or generator.initial_seed() not in self.normal_seeds):
            return self._orig["randn"](*size, generator=generator, **kw)
        shape = (size[0] if len(size) == 1 and not isinstance(size[0], int)
                 else size)
        v = jax.random.normal(jax.random.PRNGKey(generator.initial_seed()),
                              tuple(int(d) for d in shape))
        return torch.from_numpy(np.array(v)).to(
            kw.get("dtype") or torch.float32)


def arch_pair(arch: str):
    """The reduced config of ``arch`` in both packages."""
    from repro_torch.configs import get_config
    cfg_t = get_config(arch).reduced()
    cfg_j = j_get_config(arch).reduced()
    assert cfg_t.name == cfg_j.name
    return cfg_t, {cfg_j.name: cfg_j}


# ------------------------------------------------------- printed numbers
_NUM = re.compile(r"-?\d[\d,]*(?:\.\d+)?(?:e[+-]?\d+)?")


def _value(tok: str):
    """(value, is_int, half a unit of the last printed digit)."""
    t = tok.replace(",", "")
    if "." not in t and "e" not in t:
        return int(t), True, 0.0
    mant, _, exp = t.partition("e")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    return float(t), False, 0.5 * 10.0 ** (int(exp or 0) - decimals)


def printed_numbers(text: str, mask=()):
    """Each printed line as (its text with numbers replaced by ``#``, its
    numbers); spans matching a ``mask`` regex (times) become ``<t>``."""
    rows = []
    for line in text.splitlines():
        for pat in mask:
            line = re.sub(pat, "<t>", line)
        rows.append((_NUM.sub("#", line),
                     [_value(m) for m in _NUM.findall(line)]))
    return rows


def assert_same_printout(jax_text: str, port_text: str, mask=(),
                         skip_lines=()):
    """The two printouts line for line: the same words, integers equal,
    floats within the golden band widened by half a unit of the last
    printed digit. Lines matching a ``skip_lines`` regex are left out of
    both."""
    def keep(text):
        return "\n".join(ln for ln in text.splitlines()
                         if not any(re.search(p, ln) for p in skip_lines))
    want = printed_numbers(keep(jax_text), mask)
    got = printed_numbers(keep(port_text), mask)
    assert len(got) == len(want), (port_text, jax_text)
    n = 0
    for i, ((wf, wn), (gf, gn)) in enumerate(zip(want, got)):
        assert gf == wf, f"line {i}: {gf!r} != {wf!r}"
        for (a, a_int, a_half), (b, b_int, b_half) in zip(wn, gn):
            assert a_int == b_int, f"line {i}: {wn} vs {gn}"
            if a_int:
                assert a == b, f"line {i}: {b} != {a}"
            else:
                tol = (BAND["atol"] + BAND["rtol"] * abs(a)
                       + max(a_half, b_half))
                assert abs(a - b) <= tol, f"line {i}: {b} vs {a} (±{tol})"
            n += 1
    assert n, "no numbers compared"
    return n

