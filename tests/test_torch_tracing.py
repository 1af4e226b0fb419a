"""The port's spans (``tracing``) and the counts ``LRTResult.timings`` gains
with them.

- Nothing is recorded without a profiler; a ``phase`` times its block
  either way, and not a block that raised.
- Under ``torch.profiler`` the observed fits and a lognormal
  ``protassov_lrt`` record their spans, nested as named, each under its
  parent's interval and its root call.
- Recording changes no result: the chains, the LRT's log-likelihoods and a
  ``batched_max_loglike`` result equal the unrecorded ones bit for bit.
- ``timings`` keeps its keys and gains ``refit_steps`` (the refit runs'
  likelihood calls in ``batched_max_loglike.shard_launches``, less two a
  run, halved: a counter that counts on any device), ``refit_graph_steps``
  (0 on the CPU, where no step is a graph replay), ``e13_passes``,
  ``simulator_s`` (the ``lrt.simulator`` phase) and the Kraft counts
  (0 without a background; ``test_torch_kraft_lrt.py`` has them with one).
- A span shares the profiler's clock: around a ``record_function`` block
  it contains the profiler's event for the block (on the CPU), and on a
  card it contains the runtime's ``cudaLaunchKernel`` and
  ``cudaDeviceSynchronize``.

JAX is not imported, so the ``cuda`` case runs where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -s
"""
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from mind_the_gaps_tpu_torch import GappyLightcurve, lrt, tracing  # noqa: E402
from mind_the_gaps_tpu_torch.gpmodelling import GPModelling  # noqa: E402
from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, Lorentzian  # noqa: E402

N = 24
NSIMS, CHUNK = 6, 4  # two chunks, the observed row in the second
PARENTS = {
    "lrt.simulator": {"lrt.protassov_lrt"},
    "lrt.chunk": {"lrt.protassov_lrt"},
    "lrt.generation": {"lrt.chunk"},
    "lrt.refits": {"lrt.chunk"},
    "lrt.refine": {"lrt.chunk"},
    "sim.e13_pass": {"lrt.generation"},
    "refits.run": {"lrt.refits"},
    "refits.step": {"refits.run"},
    "refits.early_stop": {"refits.step"},
    "sampler.half_step": {"refits.step", "sampler.segment"},
    "sampler.log_prob": {"sampler.half_step"},
    "gp.map_fit": {"gp.derive_posteriors"},
    "gp.sampling": {"gp.derive_posteriors"},
    "sampler.segment": {"gp.sampling"},
    "sampler.autocorr": {"gp.sampling"},
    "gp.chain_copy": {"gp.sampling"},
}


def _lightcurve():
    rng = np.random.default_rng(7)
    t = np.cumsum(rng.uniform(2.0, 8.0, N))
    return GappyLightcurve(t, rng.normal(10.0, 1.0, N), np.full(N, 0.3), exposures=np.ones(N))


def _kernels():
    null = DampedRandomWalk(np.log(1.0), np.log(0.05))
    alt = DampedRandomWalk(np.log(1.0), np.log(0.05)) + Lorentzian(np.log(0.5), np.log(5.0), np.log(0.1))
    return null, alt


def _observed_fits(lc, kernels):
    models = []
    for seed, (kernel, walkers) in enumerate(zip(kernels, (8, 12))):
        model = GPModelling(lc, kernel, device="cpu")
        model.derive_posteriors(fit=seed == 0, max_steps=20, convergence_steps=10, walkers=walkers, seed=seed,
                                converge=False)
        models.append(model)
    return models


def _lrt(lc, kernels, models, runs):
    """protassov_lrt at a tiny size, each refit run's likelihood calls in ``runs``."""
    inner = lrt.batched_max_loglike

    def counted(*args, **kwargs):
        out = inner(*args, **kwargs)
        runs.append(list(lrt.batched_max_loglike.shard_launches))  # set where the function is looked up
        return out

    lrt.batched_max_loglike = counted
    try:
        return lrt.protassov_lrt(lc, *kernels, nsims=NSIMS, chunk=CHUNK, null_model=models[0],
                                 alt_model=models[1], sim_max_steps=10, sim_walkers=4, pdf="Lognormal", seed=3,
                                 device="cpu")
    finally:
        lrt.batched_max_loglike = inner


@pytest.fixture(scope="module")
def runs():
    """The observed fits and the LRT, unrecorded and then recorded."""
    lc, kernels = _lightcurve(), _kernels()
    tracing.clear()
    off_runs, on_runs = [], []
    off_models = _observed_fits(lc, kernels)
    off = _lrt(lc, kernels, off_models, off_runs)
    unrecorded = tracing.spans()
    with profile(activities=[ProfilerActivity.CPU]):
        on_models = _observed_fits(lc, kernels)
        on = _lrt(lc, kernels, on_models, on_runs)
    return dict(off=off, on=on, off_models=off_models, on_models=on_models, off_runs=off_runs, on_runs=on_runs,
                unrecorded=unrecorded, spans=tracing.spans())


def test_nothing_is_recorded_without_a_profiler(runs):
    assert runs["unrecorded"] == []
    assert tracing.span("test.a", rows=1) is tracing.span("test.b")  # one shared no-op context
    before = len(tracing.spans())
    with tracing.span("test.a"):
        pass
    assert len(tracing.spans()) == before


def test_a_phase_times_its_block_recording_or_not():
    timings = {}
    for _ in range(2):
        with tracing.phase("test.phase", timings, "block_s"):
            time.sleep(0.002)
    assert timings["block_s"] >= 0.004
    with pytest.raises(RuntimeError):
        with tracing.phase("test.phase", timings, "raised_s"):
            raise RuntimeError("the block fails")
    assert set(timings) == {"block_s"}


def test_spans_nest_as_named_under_their_root_calls(runs):
    spans = runs["spans"]
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    roots = [s for s in spans if s.parent is None]
    assert sorted(s.name for s in roots) == ["gp.derive_posteriors"] * 2 + ["lrt.protassov_lrt"]
    assert all(s.root == s.id for s in roots)
    for s in spans:
        if s.parent is None:
            continue
        parent = by_id[s.parent]
        assert parent.name in PARENTS[s.name], (s.name, parent.name)
        assert s.root == parent.root and parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    names = {s.name for s in spans}
    assert names == set(PARENTS) | {"gp.derive_posteriors", "lrt.protassov_lrt"}
    lrt_root = next(s.id for s in roots if s.name == "lrt.protassov_lrt")
    named = lambda name: [s for s in spans if s.name == name]  # noqa: E731
    assert all(s.root == lrt_root for s in named("refits.step") + named("sim.e13_pass"))
    assert sum(s.counts["rows"] for s in named("lrt.chunk")) == NSIMS + 1
    assert sorted(s.counts["params"] for s in named("refits.run")) == [2, 2, 5, 5]
    assert [s.counts["steps"] for s in named("sampler.segment")] == [10] * 4
    # the sampler's half-steps: two a step, in the observed fits and in the refits
    timings = runs["on"].timings
    assert len(named("refits.step")) == timings["refit_steps"] == len(named("refits.early_stop"))
    assert len(named("sampler.half_step")) == 2 * (2 * 20 + timings["refit_steps"])
    assert len(named("sim.e13_pass")) == timings["e13_passes"] > 0


def test_recording_changes_no_result(runs):
    for off, on in zip(runs["off_models"], runs["on_models"]):
        assert np.array_equal(off.sampler.get_chain(), on.sampler.get_chain())
        assert np.array_equal(off.sampler.get_log_prob(), on.sampler.get_log_prob())
    off, on = runs["off"], runs["on"]
    for name in ("t_dist", "null_sim_loglikes", "alt_sim_loglikes"):
        assert np.array_equal(getattr(off, name), getattr(on, name))
    assert off.t_obs == on.t_obs and off.p_value == on.p_value
    assert runs["off_runs"] == runs["on_runs"]

    null, _ = _kernels()
    rng = np.random.default_rng(11)
    ys = torch.as_tensor(rng.normal(10.0, 1.0, (3, N)))
    diags = torch.full((3, N), 0.09, dtype=torch.float64)
    t = torch.as_tensor(_lightcurve().times)

    def refit():
        return lrt.batched_max_loglike(null, t, ys, diags, null.get_parameter_vector(), walkers=4, n_steps=30,
                                       early_stop=(0.01, 5), generator=torch.Generator().manual_seed(5))

    plain = refit()
    with profile(activities=[ProfilerActivity.CPU]):
        recorded = refit()
    assert all(torch.equal(a, b) for a, b in zip(plain, recorded))
    launches = lrt.batched_max_loglike.shard_launches
    assert launches == [2 + 2 * lrt.batched_max_loglike.steps]


def test_lrt_timings_keep_their_keys_and_count_the_steps_and_passes(runs):
    off = runs["off"].timings
    assert set(off) == {"map_fit_s", "observed_sampling_s", "generation_s", "refits_s", "refine_s",
                        "checkpoint_s", "refit_steps", "refit_graph_steps", "e13_passes",
                        "simulator_s", "kraft_bins", "kraft_bins_replaced"}
    assert off["refit_graph_steps"] == 0  # the CPU steps eagerly
    assert all(off[k] > 0 for k in ("simulator_s", "generation_s", "refits_s", "refine_s"))
    assert off["kraft_bins"] == off["kraft_bins_replaced"] == 0  # Poisson noise: no background
    chunks = -(-(NSIMS + 1) // CHUNK)
    assert len(runs["off_runs"]) == 2 * chunks and all(len(r) == 1 for r in runs["off_runs"])
    assert off["refit_steps"] == sum(r[0] - 2 for r in runs["off_runs"]) // 2
    assert off["refit_steps"] == runs["on"].timings["refit_steps"]
    assert off["e13_passes"] == runs["on"].timings["e13_passes"] > 0


def test_a_span_lies_on_the_profilers_clock():
    """A span around a ``record_function`` block contains the profiler's own
    event for the block, to within 50 us (on the CPU)."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with tracing.span("test.outer"):
                with record_function("test.inner"):
                    torch.ones(1000).sum()
    events = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                    for ev in prof.profiler.kineto_results.events() if ev.name() == "test.inner")
    spans = sorted((s.start_ns, s.end_ns) for s in tracing.spans() if s.name == "test.outer")
    assert len(events) == len(spans) == 5
    for (e0, e1), (s0, s1) in zip(events, spans):
        assert s0 - 50_000 <= e0 <= e1 <= s1 + 50_000, (e0 - s0, s1 - e1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the runtime's host calls are traced there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_span_holds_the_runtime_calls_it_makes_on_a_card(cuda):
    """Under the benchmark's profiler (CUDA activity alone), a span around a
    launch contains its ``cudaLaunchKernel`` and one around
    ``torch.cuda.synchronize`` its ``cudaDeviceSynchronize``, to within
    20 us; the margins are printed."""
    x = torch.ones(1 << 20, device=cuda)
    (x * 2).sum()
    torch.cuda.synchronize(cuda)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            with tracing.span("test.launch"):
                y = x * 2
            with tracing.span("test.sync"):
                torch.cuda.synchronize(cuda)
    del y
    host = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
            for ev in prof.profiler.kineto_results.events() if ev.device_type() != torch.autograd.DeviceType.CUDA]
    for span_name, call in (("test.launch", "cudaLaunchKernel"), ("test.sync", "cudaDeviceSynchronize")):
        calls = [(s, e) for name, s, e in host if name.startswith(call)]
        spans = sorted((s.start_ns, s.end_ns) for s in tracing.spans() if s.name == span_name)
        assert len(spans) == 50
        before, after = [], []
        for s0, s1 in spans:  # the one call that overlaps the span (the profiler's own stop synchronises too)
            inside = [(e0, e1) for e0, e1 in calls if e0 < s1 + 20_000 and e1 > s0 - 20_000]
            assert len(inside) == 1, (call, s0, s1, inside)
            before.append(inside[0][0] - s0)
            after.append(s1 - inside[0][1])
        print(f"{call}: span start to call start {min(before)}..{max(before)} ns, "
              f"call end to span end {min(after)}..{max(after)} ns, span {np.median([s1 - s0 for s0, s1 in spans])} "
              f"ns median; torch {torch.__version__}, {torch.cuda.get_device_name(cuda)}")
        assert min(before) >= -20_000 and min(after) >= -20_000
