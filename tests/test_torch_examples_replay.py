"""The replayed holds of ``chip_smoke.py``'s run (ac) on the CPU: each
example records a run under ``chip_smoke.ExampleSpies`` (every Adam step's
gradient and result, local training's start, classifier ReLU and max-pool
tie, AE refit, client encode, quantizer input and serve-loop draw) and
replays that record in a second run, as the CPU replays the card's. A run
replaying its own record must be the free run value for value; a refit AE
taken from the record steers the rounds after the refit; a gradient off
the record fails the replay, and so does a result out of the band that is
not a partial step on a rounding-level gradient.

The examples run at the card tests' sizes (``ac_call(..., small=True)``:
the CPU parity tests' arguments, the §5.2 federation and the LM federation
as their reduced twins). Imports nothing of JAX.
"""
import contextlib
import importlib.util
import io
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import FCAECompressor  # noqa: E402
from repro_torch.core.autoencoder import init_fc_ae  # noqa: E402
from repro_torch.examples import ae_lifecycle_refresh as lifecycle  # noqa
from repro_torch.examples._common import Printer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _recorded(fn):
    with contextlib.redirect_stdout(io.StringIO()), \
            cs.ExampleSpies() as spies:
        res = fn()
    return res, spies.record()


@pytest.mark.parametrize("label", cs.AC_REPLAYED)
def test_replay_of_own_record_is_the_free_run(label):
    """A CPU run replaying its own record (``ac_replay``) gives the free
    run ``torch.equal``, field for field (``ac_same``), and every spy that
    the example reaches held something."""
    free, record = _recorded(lambda: cs.ac_call(label, "cpu", small=True))
    res, holds = cs.ac_replay(label, record, small=True)
    assert cs.ac_same(label, free, res) > 0
    cs.ac_hold(label, free, res)
    if label in cs.AC_FREE:
        assert cs.ac_hold_free(label, free, res)["floats"] > 0
    reached = {"adam": record["adam"]["opt"] or record["adam"]["ae"],
               "start": record["start"],
               "decision": record["decision"]["relu"],
               "refit": any(c["lanes"] for c in record["refit"]),
               "encode": record["encode"], "quant": record["quant"],
               "serve": record["serve"]["rounds"]}
    for s in ("opt", "ae"):
        assert holds["adam"][s].get("grad_values", 0) == sum(
            e["g"].numel() for e in record["adam"][s] if e.get("held"))
    counts = {"adam": holds["adam"]["opt"]["held"]
              + holds["adam"]["ae"]["held"],
              "start": holds["start"]["starts"],
              "decision": holds["decision"]["relu"]["calls"],
              "refit": holds["refit"]["lanes"],
              "encode": holds["encode"]["encodes"],
              "quant": holds["quant"]["calls"],
              "serve": holds["serve"]["rounds"]}
    for kind, seen in reached.items():
        assert bool(seen) == (counts[kind] > 0), (kind, counts)


def test_replay_takes_the_refit_ae_from_the_record():
    """The lifecycle example at 2 clients and 5 rounds (client 1's drift
    refit at round 2; client 0's cadence refit at round 3, used in round
    4), its record's round-3 refit AE nudged one ulp up: the replay holds
    the nudge (in the band) and takes the nudged AE, so round 4's payload
    of client 0 is the nudged AE's encode of the recorded input, not the
    free run's, while client 1's and every earlier round's payloads are
    the free run's."""
    def run():
        return lifecycle.lifecycle_run(CPU, Printer(), n_clients=2, rounds=5,
                                       ae_epochs=10, refresh_epochs=5)
    free, record = _recorded(run)
    fit = next(c for c in record["refit"] if c["round"] == 3)
    assert fit["lanes"] == ["0"]
    nudged = torch.nextafter(fit["params"][0],
                             torch.full_like(fit["params"][0], torch.inf))
    fit["params"][0] = nudged
    with contextlib.redirect_stdout(io.StringIO()), \
            cs.ExampleSpies(record) as spies:
        run()
    assert spies.report()["refit"]["lanes"] == 2     # rounds 2 and 3
    calls = spies.spies["encode"].calls
    assert [c["key"] for c in calls] == [c["key"] for c in record["encode"]]
    for got, want in zip(calls, record["encode"]):
        (_, r, ci) = got["key"]
        same = all(torch.equal(a, b) for a, b in zip(
            got["payload"].values(), want["payload"].values()))
        assert same == (r < 4 or ci == 1), got["key"]
        if r == 4 and ci == 0:
            params = cs._unravel_like(init_fc_ae(
                torch.Generator().manual_seed(0), lifecycle.AE_CFG, CPU),
                nudged)
            comp = FCAECompressor(params, lifecycle.AE_CFG)
            from repro_torch.core import codec
            enc = codec.encode(comp.spec(want["own"].numel()),
                               comp.codec_params(), want["own"])
            assert all(torch.equal(a, b) for a, b in zip(
                got["payload"].values(), enc.values()))


def test_decision_replay_takes_the_card_decision_at_a_tie():
    """``chip_smoke.DecisionSpy`` on the classifiers' ReLU and 2x2
    max-pool: a record whose decisions at ties are turned over (a ReLU
    input 1e-7 either side of zero; a window whose two largest values are
    equal) makes the replay take them, values and gradients, and count
    them; a decision apart from the record's where the values are no tie
    fails the replay."""
    from repro_torch.models import classifiers
    x = torch.tensor([1e-7, -1e-7, 1.0, -1.0])
    h = torch.tensor([[[[2.0, 0.5], [0.25, 2.0]]]])

    def run(record=None):
        xs, hs = x.clone().requires_grad_(), h.clone().requires_grad_()
        with cs.DecisionSpy(record) as spy:
            F = classifiers.torch.nn.functional
            out = (classifiers.torch.relu(xs).sum()
                   + F.max_pool2d(hs, 2, 2).sum())
        out.backward()
        return spy, out.detach(), xs.grad, hs.grad
    spy, _, gx, gh = run()
    record = spy.record()
    assert gx.tolist() == [1.0, 0.0, 1.0, 0.0]
    assert gh.flatten().tolist() == [1.0, 0.0, 0.0, 0.0]
    (ri, rd), (pi, pd) = record["relu"][0], record["pool"][0]
    assert ri.tolist() == [0, 1] and pi.tolist() == [0]
    record["relu"][0] = (ri, ~rd)
    record["pool"][0] = (pi, torch.tensor([3]))
    spy, out, gx, gh = run(record)
    assert gx.tolist() == [0.0, 1.0, 1.0, 0.0]
    assert gh.flatten().tolist() == [0.0, 0.0, 0.0, 1.0]
    assert float(out) == pytest.approx(3.0 - 1e-7, abs=1e-6)
    assert spy.rep["relu"]["flips"] == 2 and spy.rep["pool"]["flips"] == 1
    record["relu"][0] = (torch.tensor([2]), torch.tensor([False]))
    record["pool"][0] = (pi, torch.tensor([0]))
    with pytest.raises(AssertionError, match="decision apart"):
        run(record)


def test_step_rule_holds_the_gradient_and_exempts_only_rounding():
    """``chip_smoke.step_rule`` on one Adam step, card against CPU: a
    gradient out of the golden band fails though the results agree; a
    result out of the band passes only where both updates are partial on
    a rounding-level gradient (the fit's first step, or both gradients
    under 99 times Adam's eps), and is counted there."""
    lr, eps = 1e-3, cs.ADAM_EPS
    p = torch.zeros(3)
    g = torch.tensor([1.0, -0.5, 0.25])
    out = p - lr * torch.sign(g)
    rep = {}
    cs.step_rule("same", p, out, p, out, lr, 2, g, g.clone(), rep)
    assert rep["grad_values"] == 3 and rep["full_max_abs_err"] == 0.0
    with pytest.raises(AssertionError, match="gradient"):
        cs.step_rule("tf32", p, out, p, out, lr, 2, g, g * (1 + 1e-3), {})
    tiny = torch.tensor([50 * eps, -50 * eps, 0.0])
    card, cpu = p + 0.5 * lr, p - 0.5 * lr     # partial, out of the band
    for t, grad in ((1, g), (7, tiny)):
        rep = {}
        cs.step_rule("partial", p, card, p, cpu, lr, t, grad, grad, rep)
        assert rep["partial_out_of_band"] == 3
    with pytest.raises(AssertionError, match="out of the band"):
        cs.step_rule("partial, t 7", p, card, p, cpu, lr, 7, g, g, {})


def test_replay_refuses_a_gradient_off_the_record():
    """A record whose held gradients are all scaled by 1 + 1e-3 (the
    relative error of a TF32 product), results unchanged: the replay
    fails at the first gradient hold out of the band."""
    free, record = _recorded(
        lambda: cs.ac_call("quickstart", "cpu", small=True))
    for s in ("ae", "opt"):
        for e in record["adam"][s]:
            if e.get("held"):
                e["g"] = e["g"] * (1 + 1e-3)
    with pytest.raises(AssertionError, match="gradient"):
        cs.ac_replay("quickstart", record, small=True)
