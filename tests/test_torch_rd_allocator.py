"""The port's rate-distortion allocator (``core/ratecontrol.py``) against
the reference's (``tests/test_rd_allocator.py``, one counterpart a case):

* hull pruning, the λ water-fill and the integer top-up on the same
  points in both packages: outputs equal, ties and insertion order
  included;
* the hypothesis properties (budget feasibility, client-order
  invariance) on curves drawn once and fed to both packages;
* the RD ≡ greedy contract on affine equal-slope curves and RD beating
  greedy on unequal slopes, in the port, with the reference's plans on
  the same probed matrices;
* the end-to-end accuracy-per-byte check on a Dirichlet split, both
  packages on the same numpy data and the reference's initial params.

Allocations, λ and bytes exact; accuracies in the golden band
``atol=2e-5, rtol=2e-4``.
"""
try:
    import hypothesis
    import hypothesis.strategies as st
    _HAVE_HYPOTHESIS = True
except ModuleNotFoundError:       # dev extra absent: property tests skip
    from _hypothesis_stub import hypothesis, st
    _HAVE_HYPOTHESIS = False
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import core as J  # noqa: E402
from repro.configs.paper import MNIST_CLASSIFIER as J_MLP  # noqa: E402
from repro.core import ratecontrol as jrc  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.classifiers import init_classifier  # noqa: E402

from repro_torch import core as T  # noqa: E402
from repro_torch.configs.paper import MNIST_CLASSIFIER  # noqa: E402
from repro_torch.core import ratecontrol as trc  # noqa: E402
from repro_torch.core.pytree import from_jax_params  # noqa: E402
from repro_torch.core.task import ClassifierTask  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402

BAND = dict(atol=2e-5, rtol=2e-4)
P0 = jax.tree_util.tree_map(
    np.array, init_classifier(jax.random.PRNGKey(0), J_MLP))


class _JaxInitTask(ClassifierTask):
    """The port's classifier task started from the JAX package's params."""

    def __init__(self, clf_cfg, params_np):
        super().__init__(clf_cfg)
        self.params_np = params_np

    def init_params(self, gen, device):
        return from_jax_params(self.params_np, device)


def _pointwise_ladder(pkg, n_clients):
    return [[pkg.QuantizeCompressor(bits=4), pkg.QuantizeCompressor(bits=8),
             pkg.IdentityCompressor()] for _ in range(n_clients)]


def _both(fn_name, *args):
    """The same allocator call in both packages (deep-copied inputs: the
    top-up mutates ``chosen``)."""
    import copy
    return (getattr(jrc, fn_name)(*copy.deepcopy(args)),
            getattr(trc, fn_name)(*copy.deepcopy(args)))


# ---------------------------------------------------- hull pruning units
HULL_CASES = {
    "dominated-and-concave": [(0, 0.0, 0.0, 10.0), (1, 4.0, 4.0, 9.0),
                              (2, 8.0, 8.0, 0.0), (3, 9.0, 9.0, 0.5)],
    "convex": [(0, 0.0, 0.0, 10.0), (1, 1.0, 1.0, 4.0), (2, 3.0, 3.0, 1.0)],
    "collinear": [(0, 0.0, 0.0, 9.0), (1, 1.0, 1.0, 6.0),
                  (2, 2.0, 2.0, 3.0), (3, 3.0, 3.0, 0.0)],
    "by-price": [(0, 1.0, 1.0, 5.0), (1, 2.0, 6.0, 4.0), (2, 4.0, 4.0, 0.5)],
    # a point 1 ulp above an exactly collinear chord keeps its step
    "ulp-above-chord": [(0, 0.0, 0.0, 1.0),
                        (1, 1.0, 1.0, float(np.nextafter(0.5, 1.0))),
                        (2, 2.0, 2.0, 0.0)],
}
HULL_WANT = {"dominated-and-concave": [0, 2], "convex": [0, 1, 2],
             "collinear": [0, 1, 2, 3], "by-price": [0, 2],
             "ulp-above-chord": [0, 1, 2]}


@pytest.mark.parametrize("case", sorted(HULL_CASES))
def test_hull_prune_equals_reference(case):
    j, t = _both("_hull_prune", HULL_CASES[case])
    assert t == j
    assert [p[0] for p in t] == HULL_WANT[case]


def test_quantized_gain_and_lane_keys_equal_reference():
    rng = np.random.RandomState(0)
    gains = list(rng.lognormal(0, 20, 200)) + [1.0, 1.0 + 1e-9, 3e-300,
                                                float("inf")]
    for g in gains:
        assert trc._quantized_gain(float(g)) == jrc._quantized_gain(float(g))
    for ln in (3, (1, "dense0"), (0, "a")):
        assert trc._lane_sort_key(ln) == jrc._lane_sort_key(ln)


# ------------------------------------------------------- water-fill units
def test_waterfill_equals_reference_in_gain_order():
    curves = {
        "a": ([(0, 0.0, 0.0, 10.0), (1, 1.0, 1.0, 5.0),
               (2, 2.0, 2.0, 4.0)], 0.0),   # gains 5, then 1
        "b": ([(0, 0.0, 0.0, 10.0), (1, 1.0, 1.0, 7.0)], 0.0),  # gain 3
    }
    for budget, want in ((2.0, ({"a": 1, "b": 1}, 3.0)),
                         (3.0, ({"a": 2, "b": 1}, 1.0))):
        j, t = _both("_rd_waterfill", curves, budget, 0.0)
        assert t == j == want


def test_waterfill_below_floor_equals_reference():
    curves = {0: ([(0, 5.0, 5.0, 1.0)], 0.0), 1: ([(0, 5.0, 5.0, 1.0)], 0.0)}
    for budget, fixed, want in ((9.0, 0.0, (None, None)),
                                (4.0, 6.0, (None, None)),
                                (10.0, 0.0, ({0: 0, 1: 0}, None))):
        j, t = _both("_rd_waterfill", curves, budget, fixed)
        assert t == j == want


def test_waterfill_feasibility_uses_cost_not_price_as_reference():
    curves = {
        "ae": ([(0, 0.0, 0.0, 10.0), (1, 2.0, 50.0, 1.0)], 0.0),
        "pw": ([(0, 0.0, 0.0, 10.0), (1, 2.0, 2.0, 8.0)], 0.0),
    }
    j, t = _both("_rd_waterfill", curves, 2.0, 0.0)
    assert t == j and t[0] == {"pw": 1, "ae": 0}
    j, t = _both("_rd_waterfill", curves, 4.0, 0.0)
    assert t == j and t[0] == {"pw": 1, "ae": 1}


def test_waterfill_noise_tied_gains_resolve_by_drift_then_lane():
    """Gains equal to 7 digits but not in their last bits fall through to
    the ``(step, -drift, lane)`` tie-break in both packages."""
    curves = {
        (0, "g"): ([(0, 0.0, 0.0, 1.0), (1, 1.0, 1.0, 0.5)], 0.2),
        (1, "g"): ([(0, 0.0, 0.0, 1.0), (1, 1.0, 1.0, 0.5 + 1e-12)], 0.9),
        (2, "g"): ([(0, 0.0, 0.0, 1.0), (1, 1.0, 1.0, 0.5 - 1e-12)], 0.2),
    }
    for budget in (1.0, 2.0, 3.0):
        j, t = _both("_rd_waterfill", curves, budget, 0.0)
        assert t == j
    assert t[0] == {(0, "g"): 1, (1, "g"): 1, (2, "g"): 1}
    j, t = _both("_rd_waterfill", curves, 1.0, 0.0)
    assert t[0] == {(0, "g"): 0, (1, "g"): 1, (2, "g"): 0}


# -------------------------------------------- integer-allocation top-up
def test_topup_equals_reference_on_pruned_interior_rung():
    pts = {ln: [(0, 32.0, 32.0, 1.0), (1, 128.0, 135_628.0, 0.6),
                (2, 512.0, 136_012.0, 0.1)] for ln in range(4)}
    curves = {ln: (trc._hull_prune(p), 0.0) for ln, p in pts.items()}
    budget = 4 * 32.0 + 4 * (128.0 - 32.0)
    (aj, lj), (at, lt) = _both("_rd_waterfill", curves, budget, 0.0)
    assert (at, lt) == (aj, lj)
    chosen_j = {ln: curves[ln][0][i] for ln, i in aj.items()}
    chosen_t = dict(chosen_j)
    spent = sum(p[1] for p in chosen_j.values())
    tj = jrc._rd_topup(pts, chosen_j, budget, spent)
    tt = trc._rd_topup(pts, chosen_t, budget, spent)
    assert tt == tj == pytest.approx(0.4 / (135_628.0 - 32.0))
    assert chosen_t == chosen_j
    assert [chosen_t[ln][0] for ln in range(4)] == [1, 1, 1, 1]
    # insertion order of the lanes does not change the outcome
    chosen2 = {ln: curves[ln][0][i] for ln, i in reversed(at.items())}
    pts2 = {ln: pts[ln] for ln in reversed(list(pts))}
    assert trc._rd_topup(pts2, chosen2, budget, spent) == tt
    assert chosen2 == chosen_t


def test_topup_noop_when_sweep_exhausts_budget_as_reference():
    pts = {"a": [(0, 0.0, 0.0, 10.0), (1, 1.0, 1.0, 5.0),
                 (2, 2.0, 2.0, 4.0)],
           "b": [(0, 0.0, 0.0, 10.0), (1, 1.0, 1.0, 7.0)]}
    curves = {ln: (trc._hull_prune(p), 0.0) for ln, p in pts.items()}
    alloc, _ = trc._rd_waterfill(curves, 2.0, 0.0)
    chosen = {ln: curves[ln][0][i] for ln, i in alloc.items()}
    spent = sum(p[1] for p in chosen.values())
    j, t = _both("_rd_topup", pts, chosen, 2.0, spent)
    assert t is None and j is None
    assert {ln: p[0] for ln, p in chosen.items()} == {"a": 1, "b": 1}


# ------------------------------------------------ hypothesis properties
def _curve_sets_impl(draw):
    n_lanes = draw(st.integers(min_value=1, max_value=4))
    curves = {}
    floor = 0.0
    for ln in range(n_lanes):
        n_pts = draw(st.integers(min_value=1, max_value=4))
        costs = sorted(draw(st.lists(
            st.integers(min_value=0, max_value=50), min_size=n_pts,
            max_size=n_pts, unique=True)))
        dists = sorted(draw(st.lists(
            st.floats(min_value=0.0, max_value=10.0, allow_nan=False,
                      width=32), min_size=n_pts, max_size=n_pts,
            unique=True)), reverse=True)
        pts = [(k, float(c), float(c), d)
               for k, (c, d) in enumerate(zip(costs, dists))]
        hj = jrc._hull_prune(pts)
        assert trc._hull_prune(pts) == hj
        curves[ln] = (hj, float(draw(st.floats(
            min_value=0.0, max_value=1.0, allow_nan=False, width=32))))
        floor += curves[ln][0][0][1]
    budget = float(draw(st.integers(min_value=0, max_value=250)))
    return curves, budget, floor


_curve_sets = (st.composite(_curve_sets_impl) if _HAVE_HYPOTHESIS
               else (lambda: None))


@hypothesis.given(_curve_sets())
@hypothesis.settings(deadline=None, max_examples=100)
def test_waterfill_never_exceeds_budget_as_reference(case):
    curves, budget, floor = case
    j, (take, lam) = _both("_rd_waterfill", curves, budget, 0.0)
    assert (take, lam) == j
    if take is None:
        assert floor > budget
        return
    spent = sum(hull[take[ln]][1] for ln, (hull, _) in curves.items())
    assert spent <= budget
    for ln, (hull, _) in curves.items():
        assert 0 <= take[ln] < len(hull)


@hypothesis.given(_curve_sets(), st.randoms())
@hypothesis.settings(deadline=None, max_examples=100)
def test_waterfill_invariant_to_client_insertion_order_as_reference(case,
                                                                     rng):
    curves, budget, _ = case
    take, lam = trc._rd_waterfill(curves, budget, 0.0)
    lanes = list(curves)
    rng.shuffle(lanes)
    shuffled = {ln: curves[ln] for ln in lanes}
    j, (take2, lam2) = _both("_rd_waterfill", shuffled, budget, 0.0)
    assert (take2, lam2) == j
    assert take == take2 and lam == lam2


# --------------------------------------- RD ≡ greedy differential contract
def _bound_pair(pkg):
    """Two identically seeded 4-client federations, one a policy, after one
    round under a budget that cannot move anyone."""
    data_pkg = jpipe if pkg is J else tpipe
    train, ev = data_pkg.train_eval_split(data_pkg.mnist_like(0, 320), 64)
    data = data_pkg.uniform_partition(0, train, 4)

    def mk(rc):
        cfg = pkg.FLConfig(n_rounds=1, local_epochs=1, payload="update")
        if pkg is J:
            run = J.FederatedRun(J_MLP, data, cfg, eval_data=ev,
                                 ratecontrol=rc)
        else:
            run = T.FederatedRun(_JaxInitTask(MNIST_CLASSIFIER, P0), data,
                                 cfg, eval_data=ev, ratecontrol=rc,
                                 device="cpu")
        run.run()
        return run

    bb = pkg.ByteBudget(ladder=_pointwise_ladder(pkg, 4), budget=0.0,
                        min_snapshots=1)
    rd = pkg.RDBudget(ladder=_pointwise_ladder(pkg, 4), budget=0.0,
                      min_snapshots=1)
    return (bb, mk(bb)), (rd, mk(rd))


@pytest.fixture(scope="module")
def bound_pairs():
    return {pkg: _bound_pair(pkg) for pkg in (J, T)}


def test_rd_matches_greedy_on_affine_equal_slope_curves(bound_pairs):
    """The port's RDBudget and ByteBudget plan identical moves at every
    budget on affine equal-slope curves, and so do the reference's on the
    same matrices."""
    costs = bound_pairs[T][0][0]._costs
    assert costs == bound_pairs[J][0][0]._costs
    a = {0: 1.0, 1: 0.8, 2: 0.6, 3: 0.4}
    slope = 5e-6

    def probe(run, lanes):
        return np.array([[a[ci] - slope * costs[k] for ci in lanes]
                         for k in range(3)])

    d01, d12 = costs[1] - costs[0], costs[2] - costs[1]
    floor = 4 * costs[0]
    budgets = [floor - 1, floor, floor + d01, floor + 2 * d01 + 1,
               floor + 4 * d01, floor + 4 * d01 + d12,
               floor + 4 * (d01 + d12), float("inf")]
    for start in ([0, 0, 0, 0], [2, 0, 1, 0]):
        for b in budgets:
            plans = {}
            for pkg in (J, T):
                (bb, run_bb), (rd, run_rd) = bound_pairs[pkg]
                for rc in (bb, rd):
                    rc._probe_all = probe
                    rc._rung[:] = start
                    rc.budget = b
                plans[pkg] = (bb.plan(run_bb, 5, [0, 1, 2, 3]),
                              rd.plan(run_rd, 5, [0, 1, 2, 3]),
                              rd.plan(run_rd, 5, [3, 1, 0, 2]),
                              rd.last_lambda)
            moves_bb, moves_rd, shuffled, _ = plans[T]
            assert moves_rd == moves_bb == shuffled, (start, b)
            assert plans[T] == plans[J], (start, b)


def test_rd_beats_greedy_on_unequal_slope_curves(bound_pairs):
    errs = {0: [0.9, 0.89, 0.88], 1: [0.8, 0.2, 0.1],
            2: [0.7, 0.2, 0.1], 3: [0.6, 0.2, 0.1]}

    def probe(run, lanes):
        return np.array([[errs[ci][k] for ci in lanes] for k in range(3)])

    out = {}
    for pkg in (J, T):
        (bb, run_bb), (rd, run_rd) = bound_pairs[pkg]
        costs = bb._costs
        gains = []
        for rc, run in ((bb, run_bb), (rd, run_rd)):
            rc._probe_all = probe
            rc._rung[:] = 0
            rc.budget = 4 * costs[0] + (costs[1] - costs[0])
            moves = rc.plan(run, 5, [0, 1, 2, 3])
            alloc = {ci: moves.get(ci, 0) for ci in range(4)}
            gains.append(sum(errs[ci][0] - errs[ci][k]
                             for ci, k in alloc.items()))
        out[pkg] = gains
    gain_bb, gain_rd = out[T]
    assert gain_bb == pytest.approx(0.01)
    assert gain_rd == pytest.approx(0.6)
    assert out[T] == out[J]


# ----------------------------------- end-to-end Pareto check (Dirichlet)
def _dirichlet_policy(pkg, cls_name):
    data_pkg = jpipe if pkg is J else tpipe
    train, ev = data_pkg.train_eval_split(data_pkg.mnist_like(0, 512), 128)
    data = data_pkg.dirichlet_partition(1, train, 4, alpha=0.5)
    rc = getattr(pkg, cls_name)(ladder=_pointwise_ladder(pkg, 4),
                                budget=1.0, min_snapshots=1)
    cfg = pkg.FLConfig(n_rounds=3, local_epochs=1, payload="update",
                       batch_size=16)
    if pkg is J:
        run = J.FederatedRun(J_MLP, data, cfg, eval_data=ev, ratecontrol=rc)
    else:
        run = T.FederatedRun(_JaxInitTask(MNIST_CLASSIFIER, P0), data, cfg,
                             eval_data=ev, ratecontrol=rc, device="cpu")
    rc.budget = 4 * rc._costs[0] + 2 * (rc._costs[1] - rc._costs[0])
    hist = run.run()
    return (hist[-1].global_metrics["accuracy"],
            sum(r.bytes_up for r in hist), hist)


def test_rd_accuracy_per_byte_matches_or_beats_greedy_on_dirichlet():
    res = {(pkg, c): _dirichlet_policy(pkg, c)
           for pkg in (J, T) for c in ("ByteBudget", "RDBudget")}
    acc_bb, up_bb, _ = res[(T, "ByteBudget")]
    acc_rd, up_rd, _ = res[(T, "RDBudget")]
    assert up_rd > 0 and up_bb > 0
    assert acc_rd / up_rd >= (acc_bb / up_bb) * (1 - 1e-9)
    for c in ("ByteBudget", "RDBudget"):
        aj, uj, hj = res[(J, c)]
        at, ut, ht = res[(T, c)]
        assert ut == uj
        for a, b in zip(hj, ht, strict=True):
            assert b.spec_switches == a.spec_switches
            assert b.bytes_up == a.bytes_up
        np.testing.assert_allclose(at, aj, **BAND)
