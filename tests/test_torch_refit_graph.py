"""The refits' stretch-move step replayed as a CUDA graph
(``lrt.batched_max_loglike``, ``sampler.graph.StepGraph``), and what the
capture needs of the likelihood's path: the prior's bounds made once
(``Term.log_prior``) and the data prepared once
(``solver.batched.batched_log_prob_fn`` on ``ops.celerite._prepare``).

On the CPU:
- the graph engages only for one local run on the card that holds the data:
  not on the CPU, not over a two-shard mesh (``graph_steps`` stays 0);
- the loop's replays, with a stand-in for the graph that runs the captured
  step at each replay, equal the eager steps bit for bit, counts and all;
- the cached bounds give the list-built bounds' priors bit for bit, and the
  prepared data the plain recursion's log-probabilities.

The ``cuda`` cases hold the graph against the eager step on the card (the
private ``lrt._graph_engages`` patched to refuse), bit for bit: the refits
of the null (R=1) and the alternative (R=3), with and without the early
stop, at G=512 and a small G, the launch counters, and a whole
``protassov_lrt``.  JAX is not imported, so they run where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_refit_graph.py
"""
import math
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

import mind_the_gaps_tpu_torch.kernels as tk  # noqa: E402
from mind_the_gaps_tpu_torch import GappyLightcurve, lrt  # noqa: E402
from mind_the_gaps_tpu_torch.lrt import _derived_generator, batched_max_loglike, protassov_lrt  # noqa: E402
from mind_the_gaps_tpu_torch.ops import celerite_log_likelihood  # noqa: E402
from mind_the_gaps_tpu_torch.ops.celerite import _prepare, celerite_log_likelihood_plain  # noqa: E402
from mind_the_gaps_tpu_torch.parallel import Mesh  # noqa: E402
from mind_the_gaps_tpu_torch.solver.batched import batched_log_prob_fn  # noqa: E402

CPU = torch.device("cpu")


def _kernels():
    null = tk.DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    alt = null + tk.Lorentzian(log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)])
    return {"null": null, "alt": alt}


def _batch(G, n, seed=0):
    """G lightcurves (G, n) sharing sorted times, dy 0.3."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    ys = 10.0 + rng.normal(0.0, 1.0, (G, n))
    return torch.as_tensor(t), torch.as_tensor(ys), torch.full((G, n), 0.09, dtype=torch.float64)


def _refit(kernel, t, ys, diags, early_stop, n_steps, dtype=None, mesh=None):
    """(best_lp, best_x, steps, graph_steps, shard_launches, the op's launches and its launches by layout)."""
    op = celerite_log_likelihood
    before = op.launches, dict(op.team_launches)
    lp, x = batched_max_loglike(kernel, t, ys, diags, kernel.get_parameter_vector(), walkers=12, n_steps=n_steps,
                                dtype=dtype, early_stop=early_stop, generator=_derived_generator(ys.device, 5, 1),
                                mesh=mesh)
    bm = batched_max_loglike
    return (lp, x, bm.steps, bm.graph_steps, list(bm.shard_launches), op.launches - before[0],
            {k: n - before[1][k] for k, n in op.team_launches.items()})


# --------------------------------------------------------------------------- #
# where the graph engages
# --------------------------------------------------------------------------- #
def _runs(*devices):
    return [(i, SimpleNamespace(device=torch.device(d))) for i, d in enumerate(devices)]


@pytest.mark.parametrize("runs, lead, engages", [
    (_runs("cuda:0"), "cuda:0", True),  # one local run on the card of the data
    (_runs("cuda:0", "cuda:0"), "cuda:0", False),  # two shards on one card
    (_runs("cuda:0", "cuda:1"), "cuda:0", False),  # two shards on two cards
    (_runs("cuda:1"), "cuda:0", False),  # the run on another card than the draws
    (_runs("cpu"), "cpu", False),
])
def test_where_the_graph_engages(runs, lead, engages):
    assert lrt._graph_engages(runs, torch.device(lead)) is engages


@pytest.mark.parametrize("mesh", [None, Mesh((CPU, CPU))])
def test_the_cpu_and_a_two_shard_mesh_step_eagerly(mesh):
    t, ys, diags = _batch(G=5, n=40)
    _, _, steps, graph_steps, launches, _, _ = _refit(_kernels()["null"], t, ys, diags, (0.05, 4), 30, mesh=mesh)
    assert steps > 1 and graph_steps == 0
    assert launches == [2 + 2 * steps] * (1 if mesh is None else 2)


class _ReplayedStep:
    """``StepGraph``'s stand-in off a card: the capture records nothing, and
    each replay runs the captured step (its Python and its device work)."""

    def __init__(self, step, device, generator=None):
        self._step = step

    def replay(self):
        return self._step()


@pytest.mark.parametrize("which", ["null", "alt"])
@pytest.mark.parametrize("early_stop, n_steps", [((0.05, 4), 40), (None, 12)])
@pytest.mark.parametrize("G", [6, 1])
def test_replayed_steps_equal_eager_steps(monkeypatch, which, early_stop, n_steps, G):
    """The loop with the graph engaged: step 0 eager, then one capture and a
    replay a step, writing into the run's tensors in place."""
    t, ys, diags = _batch(G=G, n=40)
    kernel = _kernels()[which]
    eager = _refit(kernel, t, ys, diags, early_stop, n_steps)
    monkeypatch.setattr(lrt, "_graph_engages", lambda runs, lead: True)
    monkeypatch.setattr(lrt, "StepGraph", _ReplayedStep)
    replayed = _refit(kernel, t, ys, diags, early_stop, n_steps)
    assert torch.equal(replayed[0], eager[0]) and torch.equal(replayed[1], eager[1])
    assert replayed[2] == eager[2] and replayed[4] == eager[4]
    assert eager[3] == 0 and replayed[3] == replayed[2] - 1
    if early_stop is not None:
        assert eager[2] < n_steps, "the early stop never stopped early: the case tests nothing"


# --------------------------------------------------------------------------- #
# what a capture needs: bounds made once, data prepared once
# --------------------------------------------------------------------------- #
def _list_built_prior(term, theta):
    """``Term.log_prior`` as it was: bounds made from the Python list at
    every call."""
    lo = theta.new_tensor([b[0] for b in term._bounds])
    hi = theta.new_tensor([b[1] for b in term._bounds])
    inside = torch.all((theta >= lo) & (theta <= hi), dim=-1)
    return torch.where(inside, theta.new_zeros(()), theta.new_full((), -math.inf))


def _half_open():
    """A sum whose bounds are open on some sides (None: -inf or inf)."""
    return (tk.RealTerm(0.0, 0.0, bounds=[(None, 2.0), (-1.0, None)])
            + tk.DampedRandomWalk(1.0, -3.0, bounds=[(-5, 10), (None, None)]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("which", ["null", "alt", "half-open"])
def test_cached_bounds_give_the_list_built_priors(dtype, which):
    kernel = _half_open() if which == "half-open" else _kernels()[which]
    bounds = np.asarray(kernel.get_parameter_bounds(), dtype=np.float64)
    finite = np.isfinite(bounds)
    rng = np.random.default_rng(3)
    inside = rng.uniform(np.where(finite[:, 0], bounds[:, 0], -20.0), np.where(finite[:, 1], bounds[:, 1], 20.0),
                         (32, kernel.ndim))
    outside = inside.copy()  # row k beyond one finite bound, the bounds in turn
    edges = [(j, side) for j in range(kernel.ndim) for side in (0, 1) if finite[j, side]]
    for k in range(len(outside)):
        j, side = edges[k % len(edges)]
        outside[k, j] = bounds[j, side] + (0.5 if side else -0.5)
    at_edges = np.where(finite.T, bounds.T, 0.0)  # the low bounds, then the high ones: inside
    theta = torch.as_tensor(np.concatenate([inside, outside, at_edges]), dtype=dtype)
    for th in (theta, theta[0], theta[40]):
        if len(kernel.terms) > 1:
            expected = sum(_list_built_prior(term, sub) for term, sub in zip(kernel.terms, kernel._split(th)))
        else:
            expected = _list_built_prior(kernel, th)
        for _ in range(2):  # the first call makes the bounds, the second reads them
            assert torch.equal(kernel.log_prior(th), expected)
    assert torch.isinf(kernel.log_prior(theta)).sum() == len(outside)
    made = [term._bound_tensors[(dtype, CPU)] for term in kernel.terms]
    kernel.log_prior(theta)
    assert all(term._bound_tensors[(dtype, CPU)] is m for term, m in zip(kernel.terms, made))


@pytest.mark.parametrize("layout", ["grouped", "shared", "per-element"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prepared_data_give_the_plain_recursion(layout, dtype):
    """``batched_log_prob_fn`` on its prepared data equals the prior plus the
    plain recursion on the data as given, bit for bit; the prepared data are
    the float64 gaps cast to the dtype and the batch-last copies."""
    kernel = _kernels()["alt"]
    t, ys, diags = _batch(G=4, n=50, seed=2)
    y, diag, repeats, B = {"grouped": (ys, diags, 3, 12), "shared": (ys[0], diags[0], 1, 12),
                           "per-element": (ys, diags, 1, 4)}[layout]
    rng = np.random.default_rng(4)
    thetas = torch.as_tensor(kernel.get_parameter_vector() + rng.normal(0.0, 0.3, (B, kernel.ndim)), dtype=dtype)
    thetas[1, 2] = 7.0  # outside the Lorentzian's bounds
    got = batched_log_prob_fn(kernel, t, y, diag, repeats=repeats, dtype=dtype)(thetas)

    yd, dd = y.to(dtype), diag.to(dtype)
    means = yd.mean().repeat(B) if y.dim() == 1 else yd.mean(1).repeat_interleave(repeats)
    lp = kernel.log_prior(thetas)
    ll = celerite_log_likelihood_plain(kernel.coefficients(thetas), t, yd, dd, mean=means,
                                       repeats=repeats if y.dim() > 1 else 1, extra_diag=kernel.jitter(thetas))
    expected = torch.where(torch.isfinite(lp), lp + ll, ll.new_full((), -math.inf))
    assert torch.equal(got, expected) and torch.isinf(got[1]) and torch.isfinite(got[0])

    data = _prepare(t, yd, dd, dtype, CPU)
    assert torch.equal(data.dt, torch.diff(t, prepend=t[:1]).to(dtype)) and data.dt.is_contiguous()
    assert torch.equal(data.y_t, yd.T if yd.dim() > 1 else yd) and data.y_t.is_contiguous()
    assert torch.equal(data.d_t, dd.T if dd.dim() > 1 else dd) and data.d_t.is_contiguous()


# --------------------------------------------------------------------------- #
# on a card: the graph against the eager step, bit for bit
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph and the celerite kernel have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _eager(monkeypatch):
    monkeypatch.setattr(lrt, "_graph_engages", lambda runs, lead: False)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["null", "alt"])
@pytest.mark.parametrize("early_stop, n_steps", [((0.01, 50), 500), (None, 60)])
@pytest.mark.parametrize("G", [512, 5])
def test_graph_equals_eager_on_card(cuda, monkeypatch, which, early_stop, n_steps, G):
    t, ys, diags = (x.to(cuda) for x in _batch(G=G, n=5000, seed=G))
    kernel = _kernels()[which]
    graphed = _refit(kernel, t, ys, diags, early_stop, n_steps, dtype=torch.float32)
    _eager(monkeypatch)
    eager = _refit(kernel, t, ys, diags, early_stop, n_steps, dtype=torch.float32)
    assert torch.equal(graphed[0], eager[0]) and torch.equal(graphed[1], eager[1])
    assert graphed[2] == eager[2] and graphed[4:] == eager[4:]
    assert eager[3] == 0 and graphed[3] == graphed[2] - 1 > 0
    assert eager[5] == 2 + 2 * eager[2]  # every likelihood call one launch


@pytest.mark.cuda
def test_protassov_lrt_graph_equals_eager_on_card(cuda, monkeypatch):
    rng = np.random.default_rng(8)
    n = 1000
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    lc = GappyLightcurve(t, 10.0 + rng.normal(0.0, 1.0, n), np.full(n, 0.3), exposures=1.0)
    kernels = _kernels()
    settings = dict(nsims=63, chunk=32, seed=11, sim_max_steps=300, sim_walkers=12, device=cuda)
    fitted = protassov_lrt(lc, kernels["null"], kernels["alt"], observed_max_steps=300, observed_walkers=16,
                           **dict(settings, nsims=3))
    models = dict(null_model=fitted.null_model, alt_model=fitted.alt_model)
    graphed = protassov_lrt(lc, kernels["null"], kernels["alt"], **models, **settings)
    _eager(monkeypatch)
    eager = protassov_lrt(lc, kernels["null"], kernels["alt"], **models, **settings)
    for name in ("t_dist", "null_sim_loglikes", "alt_sim_loglikes"):
        assert np.array_equal(getattr(graphed, name), getattr(eager, name)), name
    assert graphed.t_obs == eager.t_obs and graphed.p_value == eager.p_value
    runs = 2 * 2  # two chunks (64 rows at chunk 32), two models each
    assert graphed.timings["refit_steps"] == eager.timings["refit_steps"]
    assert graphed.timings["refit_graph_steps"] == graphed.timings["refit_steps"] - runs
    assert eager.timings["refit_graph_steps"] == 0
