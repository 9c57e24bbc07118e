"""The port's example entry points against the JAX package's examples on
the CPU, part two: per-layer partitions (``per_layer_partitions``), the
§5.2 colour-imbalance federation and the codec stacks
(``fl_color_imbalance``). The method is that of
``tests/test_torch_examples.py``: the reference's draws replayed at the
port's seams, the printouts compared line for line (integers exact, floats
in the golden band ``atol=2e-5, rtol=2e-4`` widened by half a unit of the
last printed digit, times left out).
"""
import argparse
import contextlib
import io

import pytest

torch = pytest.importorskip("torch")

from _torch_examples_util import (JaxDraws,  # noqa: E402
                                  assert_same_printout, run_jax_example,
                                  run_port_example, few_threads)
from repro.configs import paper as jpaper  # noqa: E402

from repro_torch.configs.paper import ClassifierConfig  # noqa: E402
from repro_torch.examples import (fl_color_imbalance,  # noqa: E402
                                  per_layer_partitions)
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


def test_per_layer_partitions_matches_reference(monkeypatch):
    """Reduced: 2 clients, 4 rounds, 20-epoch refits (the example's own 3
    clients x 6 rounds with 150-epoch refits take ~30 s in the reference
    alone); the cadence refit lands at round 3. The partition groups, the
    per-group wire prices, the ``(client, group)`` sync lanes and decoder
    bytes exact, the reconcile in the band; the example's own
    ``decoder_rel_err < 0.01`` assertion passes in both."""
    def patch(mod):
        lifecycle, fl = mod.AELifecycle, mod.FLConfig
        mod.N_CLIENTS = 2
        mod.AELifecycle = lambda **kw: lifecycle(**dict(
            kw, refresh_epochs=20))
        mod.FLConfig = lambda **kw: fl(**dict(kw, n_rounds=4))
    jax_text, jerr = run_jax_example("per_layer_partitions", patch=patch)
    JaxDraws(monkeypatch)
    text, res = _printed(per_layer_partitions.partitioned_run, CPU,
                         n_clients=2, rounds=4, refresh_epochs=20)
    assert jerr is None
    assert_same_printout(jax_text, text)
    assert res["prices"] == {"dense0": 128, "dense1": 260}
    assert res["rounds"][3]["ae_syncs"] == [(0, "dense0"), (1, "dense0")]


def _args(**kw):
    return argparse.Namespace(device=CPU, **kw)


def test_color_imbalance_stacks_match_reference(monkeypatch):
    """Reduced by the example's own flags: ``--stacks --rounds 2 --n 32``
    (the defaults take ~90 s in the reference alone). Uplink bytes and
    ratios exact, final accuracies in the band."""
    argv = ("--stacks", "--rounds", "2", "--n", "32")
    jax_text, jerr = run_jax_example("fl_color_imbalance", argv)
    JaxDraws(monkeypatch)
    text, res, err = run_port_example(fl_color_imbalance, argv)
    assert jerr is None and err is None
    assert_same_printout(jax_text, text)
    assert [s["name"] for s in res["stacks"]] == ["q8", "topk->q8",
                                                 "topk->ae->q8"]


NARROW_CNN = dict(name="cifar-cnn-narrow", kind="cnn",
                  input_shape=(32, 32, 3), n_classes=10,
                  conv_channels=(4, 4, 8, 8), conv_kernel=3,
                  dense_hidden=(16,))


def test_color_imbalance_federation_matches_reference(monkeypatch):
    """Reduced: the §5.2 path with a narrow CNN of the paper's layout
    (conv 4-4-8-8, dense 16: 4,526 parameters, its FC AE 4,526 -> 320)
    and ``--rounds 2 --n 32``: the paper's CNN puts a 352.9 M-parameter
    AE (1.4 GB, three times that with Adam) on each collaborator, past
    this CPU's test budget. Both pre-passes (5 epochs, a 6-epoch AE fit),
    then the weights-payload run: bytes and ratios exact, global and
    collaborator accuracies in the band."""
    argv = ("--rounds", "2", "--n", "32")

    def patch(mod):
        mod.CIFAR_CLASSIFIER = jpaper.ClassifierConfig(**NARROW_CNN)
    jax_text, jerr = run_jax_example("fl_color_imbalance", argv,
                                     patch=patch)
    JaxDraws(monkeypatch)
    text, res = _printed(fl_color_imbalance.run_federation,
                         _args(rounds=2, n=32, local_epochs=1),
                         clf_cfg=ClassifierConfig(**NARROW_CNN))
    assert jerr is None
    assert_same_printout(jax_text, text)
    assert res["params"] == 4526 and res["ae_params"] == 4526 * 640 + 4846
