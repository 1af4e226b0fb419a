"""The observed sampler's step replayed as a CUDA graph
(``GPModelling.derive_posteriors``, ``sampler.graph.StepGraph``).

On the CPU:
- the graph engages only on a card without a mesh: on the CPU and over a
  two-shard mesh every step runs eagerly (``sampling_graph_steps`` and each
  ``sampler.segment`` span's ``graph_steps`` read 0), and the public
  ``sample_ensemble_grouped`` never captures;
- the loop with the graph engaged, with a stand-in for the graph that runs
  the captured step at each replay, equals the eager loop bit for bit: the
  chain, its log-probabilities, the acceptance fractions and the launch
  counts, over several segments, one ensemble and four, float64 and the
  float32 exploration, and a fitted mean model;
- a capture gives back the counts its Python moved, and each replay adds
  those of one eager step.

The ``cuda`` cases hold the graph against the eager loop on the card (the
private ``gpmodelling._graph_engages`` patched to refuse), bit for bit.  JAX
is not imported, so they run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_observed_graph.py
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import mind_the_gaps_tpu_torch.kernels as tk  # noqa: E402
from mind_the_gaps_tpu_torch import GappyLightcurve, gpmodelling, tracing  # noqa: E402
from mind_the_gaps_tpu_torch.gpmodelling import GPModelling, _captured  # noqa: E402
from mind_the_gaps_tpu_torch.ops import celerite_log_likelihood  # noqa: E402
from mind_the_gaps_tpu_torch.parallel import Mesh  # noqa: E402
from mind_the_gaps_tpu_torch.sampler import graph, sample_ensemble_grouped  # noqa: E402
from mind_the_gaps_tpu_torch.sampler.ensemble import EnsembleChain  # noqa: E402

CPU = torch.device("cpu")


def _kernel(which):
    null = tk.DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    if which == "null":
        return null
    return null + tk.Lorentzian(log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)])


def _lightcurve(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    return GappyLightcurve(t, 10.0 + rng.normal(0.0, 1.0, n), np.full(n, 0.3), exposures=1.0)


def _sample(lc, which, device, mean_model=None, **kw):
    """(chain, log-probs, acceptance fractions, timings, the op's launches,
    each segment span's (steps, graph_steps), the kept samples) of one
    seeded call."""
    model = GPModelling(lc, _kernel(which), mean_model=mean_model, device=device)
    before = celerite_log_likelihood.launches
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.clear()
        model.derive_posteriors(fit=False, converge=False, seed=5, **kw)
    segments = [(s.counts["steps"], s.counts["graph_steps"]) for s in tracing.spans() if s.name == "sampler.segment"]
    s = model.sampler
    return (s.get_chain(), s.get_log_prob(), s.acceptance_fraction, model.timings,
            celerite_log_likelihood.launches - before, segments, len(model.mcmc_samples))


def _assert_same_chain(got, expected):
    for a, b in zip(got[:3], expected[:3]):
        assert np.array_equal(a, b)
    for key in ("sampling_launches", "shard_launches", "mesh_shards"):
        assert got[3][key] == expected[3][key], key
    assert got[4] == expected[4]


# --------------------------------------------------------------------------- #
# where the graph engages
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("device, mesh, engages", [
    ("cuda:0", None, True),
    ("cuda:0", Mesh((torch.device("cuda:0"), torch.device("cuda:1"))), False),  # gathers across cards
    ("cpu", None, False),
    ("cpu", Mesh((CPU, CPU)), False),
])
def test_where_the_observed_graph_engages(device, mesh, engages):
    assert gpmodelling._graph_engages(torch.device(device), mesh) is engages


@pytest.mark.parametrize("mesh", [None, Mesh((CPU, CPU))])
def test_the_cpu_and_a_mesh_sample_eagerly(mesh):
    steps, segment = 25, 10
    got = _sample(_lightcurve(40), "null", "cpu", max_steps=steps, convergence_steps=segment, walkers=8, mesh=mesh)
    timings = got[3]
    assert timings["sampling_graph_steps"] == 0
    assert got[5] == [(10, 0), (10, 0), (5, 0)]
    # each shard: two calls of the op a step and two a segment (a kernel launch each on a card)
    assert timings["shard_launches"] == [2 * steps + 2 * 3] * (1 if mesh is None else 2)
    assert timings["sampling_launches"] == 0  # the plain version on the CPU launches no kernel


def test_the_public_grouped_sampler_never_captures(monkeypatch):
    """A user's log-probability may sync, which a capture refuses: the public
    sampler keeps its eager loop, whatever ``derive_posteriors`` does."""
    def refuse(*args, **kwargs):
        raise AssertionError("the public sampler captured a graph")

    monkeypatch.setattr(graph.StepGraph, "__init__", refuse)
    monkeypatch.setattr(gpmodelling, "_graph_engages", lambda device, mesh: True)

    def log_prob(x):  # reads a value on the host at every call
        lp = -0.5 * (x * x).sum(-1)
        assert np.isfinite(float(lp.sum()))
        return lp

    init = torch.as_tensor(np.random.default_rng(0).normal(size=(2, 8, 3)))
    chain, lps, acc, final = sample_ensemble_grouped(log_prob, init, 20, torch.Generator().manual_seed(1))
    assert chain.shape == (20, 2, 8, 3) and torch.equal(chain[-1], final) and 0 < float(acc) < 1


# --------------------------------------------------------------------------- #
# the graphed loop off a card, with a stand-in for the graph
# --------------------------------------------------------------------------- #
class _ReplayedStep:
    """``StepGraph``'s stand-in off a card: the capture records nothing, and
    each replay runs the captured step (its Python and its device work)."""

    def __init__(self, step, device, generator=None):
        self._step = step

    def replay(self):
        return self._step()


@pytest.mark.parametrize("which, chains, fast, mean_model", [
    ("null", 1, None, None),
    ("null", 4, None, None),
    ("alt", 1, True, None),
    ("alt", 4, True, None),
    ("null", 2, None, "linear"),
])
def test_replayed_steps_equal_eager_steps(monkeypatch, which, chains, fast, mean_model):
    """Step 0 eager, then one capture and a replay a step, over three
    segments, reading each step's draws at the index on the device."""
    lc = _lightcurve(40, seed=chains)
    kw = dict(max_steps=23, convergence_steps=10, walkers=8, chains=chains, fast=fast, mean_model=mean_model)
    eager = _sample(lc, which, "cpu", **kw)
    monkeypatch.setattr(gpmodelling, "_graph_engages", lambda device, mesh: True)
    monkeypatch.setattr(gpmodelling, "StepGraph", _ReplayedStep)
    replayed = _sample(lc, which, "cpu", **kw)
    _assert_same_chain(replayed, eager)
    assert eager[3]["sampling_graph_steps"] == 0 and replayed[3]["sampling_graph_steps"] == 23 - 1
    assert eager[5] == [(10, 0), (10, 0), (3, 0)] and replayed[5] == [(10, 9), (10, 10), (3, 3)]
    assert eager[0].shape == (23, chains * 8, (2 if which == "null" else 5) + (2 if mean_model else 0))
    assert np.all((eager[2] > 0) & (eager[2] < 1))


class _CountedCapture:
    """``StepGraph``'s stand-in that, as a capture does, runs the step's
    Python once (its counters move) and keeps none of its work; a replay
    runs nothing."""

    def __init__(self, step, device, generator=None):
        chain = step.__self__
        saved = {k: v.clone() for k, v in vars(chain).items() if isinstance(v, torch.Tensor)}
        draws = [x.clone() for x in chain.draws]
        step()
        for k, v in saved.items():
            getattr(chain, k).copy_(v)
        for x, d in zip(chain.draws, draws):
            x.copy_(d)

    def replay(self):
        return None


def test_a_capture_gives_its_counts_back_and_each_replay_adds_a_step(monkeypatch):
    op = celerite_log_likelihood
    calls = [0]

    def log_prob(x):  # counts as a launch on a card would, on the op's counters and the caller's
        calls[0] += 1
        op.launches += 1
        op.team_launches[8] += 1
        return -0.5 * (x * x).sum(-1)

    monkeypatch.setattr(gpmodelling, "StepGraph", _CountedCapture)
    monkeypatch.setattr(op, "launches", op.launches)
    monkeypatch.setattr(op, "team_launches", dict(op.team_launches))
    run = EnsembleChain(log_prob, torch.zeros((1, 8, 2), dtype=torch.float64), max_steps=4)
    run.segment(0, 4, torch.Generator().manual_seed(0))
    before = op.launches, dict(op.team_launches), list(calls)
    replay = _captured(run, calls)
    assert (op.launches, op.team_launches, calls) == before
    assert int(run.index) == 0 and not run.accepted.any() and not run.chain.any()
    replay()
    replay()
    assert op.launches == before[0] + 4 and op.team_launches[8] == before[1][8] + 4 and calls == [before[2][0] + 4]
    assert {k: n for k, n in op.team_launches.items() if k != 8} == {k: n for k, n in before[1].items() if k != 8}


# --------------------------------------------------------------------------- #
# on a card: the graph against the eager loop, bit for bit
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph and the celerite kernel have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("which, chains, fast, mean_model", [
    ("null", 1, None, None),
    ("alt", 1, None, None),
    ("null", 4, None, None),
    ("alt", 4, True, None),
    ("alt", 1, True, None),
    ("null", 1, None, "linear"),
])
def test_graph_equals_eager_on_card(cuda, monkeypatch, which, chains, fast, mean_model):
    lc = _lightcurve(5000, seed=chains)
    kw = dict(max_steps=120, convergence_steps=50, walkers=32, chains=chains, fast=fast, mean_model=mean_model)
    graphed = _sample(lc, which, cuda, **kw)
    monkeypatch.setattr(gpmodelling, "_graph_engages", lambda device, mesh: False)
    eager = _sample(lc, which, cuda, **kw)
    _assert_same_chain(graphed, eager)
    assert eager[3]["sampling_graph_steps"] == 0 and graphed[3]["sampling_graph_steps"] == 120 - 1
    assert graphed[5] == [(50, 49), (50, 50), (20, 20)]
    # every likelihood call of the sampling one launch, two a step and two a segment; with fast, the float64
    # log-probabilities of the kept samples after, one launch a 4096 of them
    recompute = -(-eager[6] // 4096) if fast else 0
    assert eager[3]["sampling_launches"] == 2 * 120 + 2 * 3 + recompute
