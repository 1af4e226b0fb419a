"""Port parity: the non-Gaussian (Emmanoulopoulos+13) flux-PDF path.

- ``sample_pdf`` given the JAX package's own standard draws: rtol 1e-12.
- ``e13_adjust_batch`` (CPU, plain remap) against the JAX package's
  ``e13_adjust_batch(sort_impl="xla")`` given JAX's draws, B=6, m=512,
  max_iter 200.  Exact: each output row is a permutation of its own
  float64 draws, and a row's permutation does not depend on the rest of
  its chunk.  The float64 draws agree with JAX's to rtol 1e-14 (measured
  2.2e-15: the segment std and exp round differently).  The float32 FFTs
  of the two packages differ (up to ~2e-5), which reorders near-equal
  ranks, and the discrete remap carries that on: measured on these inputs,
  after 3 iterations the rank permutations differ in 0.07% (lognormal) and
  0% (uniform) of the elements (bound 1%); run to convergence, in 12.9% and
  10.2% (bound 20%), with mean |iteration count difference| 1.17 for both
  (bound 2.0).
- The max_iter freeze: every count equal to max_iter = 3, as JAX's.
- ``Simulator.simulate_batch`` given the JAX draws: the tolerance is in
  the test's docstring.
- E13 statistics as tests/test_simulator.py::TestPDF checks them, on an
  8001-point segment: the moments of the target PDF, lognormality (skewness
  of log x), uniformity (kurtosis ~1.8), the Gaussian no-op.
- The non-convergence count, its reset and the deferred report.
- The lognormal LRT: JAX runs test_lrt.py's tiny lognormal LRT whole (cut
  to 60 points and shorter chains); the
  port runs the bootstrap from the JAX posteriors (convert.py) with
  ``keep_simulations=True``: T_obs_posterior equal, T_obs within 4.0 (the
  tolerance of test_torch_lrt.py, different random streams), finite T and
  simulations, and two seeded port runs identical.
"""
import warnings

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import mind_the_gaps_tpu as mtg  # noqa: E402
import mind_the_gaps_tpu.kernels as jk  # noqa: E402
from mind_the_gaps_tpu.lrt import protassov_lrt as j_protassov_lrt  # noqa: E402
from mind_the_gaps_tpu.models import psd_models  # noqa: E402
from mind_the_gaps_tpu.simulator.core import e13_adjust_batch as j_e13_adjust_batch  # noqa: E402
from mind_the_gaps_tpu.stats import sample_pdf as j_sample_pdf  # noqa: E402
from mind_the_gaps_tpu_torch.convert import (  # noqa: E402
    kernel_from_jax,
    lightcurve_from_jax,
    posteriors_from_jax,
)
from mind_the_gaps_tpu_torch.gpmodelling import GPModelling as TGP  # noqa: E402
from mind_the_gaps_tpu_torch.lrt import protassov_lrt  # noqa: E402
from mind_the_gaps_tpu_torch.simulator import E13Simulator, Simulator, e13_adjust_batch  # noqa: E402
from mind_the_gaps_tpu_torch.stats import sample_pdf  # noqa: E402

MEAN = 10.0


def _jax_draws(keys, pdf, m):
    draw = jax.random.uniform if pdf == "uniform" else jax.random.normal
    return np.stack([np.array(draw(k, (m,))) for k in keys])


@pytest.mark.parametrize("pdf", ["gaussian", "lognormal", "uniform"])
def test_sample_pdf_matches_jax(pdf):
    key = jax.random.key(4)
    std = np.array([0.5, 2.0, 3.0])[:, None]
    ref = np.asarray(j_sample_pdf(key, pdf, MEAN, jnp.asarray(std), (3, 200)))
    draws = np.array((jax.random.uniform if pdf == "uniform" else jax.random.normal)(key, (3, 200)))
    out = sample_pdf(pdf, MEAN, torch.as_tensor(std), (3, 200), draws=torch.as_tensor(draws))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12)
    gen = sample_pdf(pdf, MEAN, 2.0, (4, 5), generator=torch.Generator().manual_seed(0))
    assert gen.shape == (4, 5) and torch.all(torch.isfinite(gen))
    with pytest.raises(ValueError):
        sample_pdf("cauchy", MEAN, 1.0, (3,))


@pytest.mark.parametrize("pdf", ["gaussian", "lognormal", "uniform"])
def test_sample_pdf_draws_on_the_card_unless_told(monkeypatch, pdf):
    """A float ``std`` with no generator and no draws draws on the card (the
    draw function sees ``device="cuda"``); ``device="cpu"`` draws on the
    CPU, and a tensor ``std`` or a generator still sets the device."""
    name = "rand" if pdf == "uniform" else "randn"
    draw, seen = getattr(torch, name), []

    def recorded(*args, device=None, **kwargs):
        seen.append(str(device))
        return draw(*args, device="cpu", **kwargs)

    monkeypatch.setattr(torch, name, recorded)
    sample_pdf(pdf, MEAN, 2.0, (4, 5))
    assert seen == ["cuda"]
    monkeypatch.setattr(torch, name, draw)
    out = sample_pdf(pdf, MEAN, 2.0, (4, 5), device="cpu")
    assert out.device.type == "cpu" and out.shape == (4, 5) and out.dtype == torch.float64
    assert torch.all(torch.isfinite(out))
    assert sample_pdf(pdf, MEAN, torch.full((4, 1), 2.0), (4, 5)).device.type == "cpu"
    assert sample_pdf(pdf, MEAN, 2.0, (4, 5), generator=torch.Generator().manual_seed(0)).device.type == "cpu"


def _e13_pair(pdf, max_iter, B=6, m=512, seed=0):
    segs = MEAN + 2.0 * np.random.default_rng(seed).standard_normal((B, m))
    keys = jax.random.split(jax.random.key(3 + seed), B)
    out_j, it_j = jax.jit(lambda k, s: j_e13_adjust_batch(k, s, pdf, MEAN, max_iter, sort_impl="xla"))(
        keys, jnp.asarray(segs)
    )
    draws = torch.as_tensor(_jax_draws(keys, pdf, m))
    out_t, it_t = e13_adjust_batch(torch.as_tensor(segs), pdf, MEAN, max_iter, draws=draws)
    xsim = sample_pdf(pdf, MEAN, torch.as_tensor(segs).std(dim=-1, correction=0)[:, None], (B, m), draws=draws)
    return segs, draws, xsim.numpy(), (np.asarray(out_j), np.asarray(it_j)), (out_t.numpy(), it_t.numpy())


def _rank_mismatch(a, b):
    ranks = [np.argsort(np.argsort(x, axis=-1, kind="stable"), axis=-1) for x in (a, b)]
    return np.mean(ranks[0] != ranks[1])


@pytest.mark.parametrize("pdf", ["lognormal", "uniform"])
def test_e13_adjust_batch_against_jax(pdf):
    _, _, xsim, (out_j, it_j), (out_t, it_t) = _e13_pair(pdf, 200)
    assert out_t.dtype == np.float64 and it_t.dtype == np.int32
    np.testing.assert_array_equal(np.sort(out_t, axis=-1), np.sort(xsim, axis=-1))
    np.testing.assert_allclose(np.sort(out_t, axis=-1), np.sort(out_j, axis=-1), rtol=1e-14)
    assert _rank_mismatch(out_t, out_j) < 0.2
    assert np.mean(np.abs(it_t - it_j)) < 2.0

    _, _, _, (short_j, _), (short_t, _) = _e13_pair(pdf, 3)
    assert _rank_mismatch(short_t, short_j) < 0.01


def test_e13_freeze_at_max_iter_and_row_independence():
    segs, draws, _, (_, it_j), (out_t, it_t) = _e13_pair("uniform", 3, B=4, m=256, seed=1)
    assert np.all(it_t == 3) and np.array_equal(it_t, it_j)
    # per-row freeze: each row alone gives its row of the batch, the same
    # permutation (the values to rtol 1e-14: torch's CPU reductions round a
    # (1, m) and a (4, m) std differently)
    segs_t = torch.as_tensor(segs)
    for b in (0, 3):
        alone, it = e13_adjust_batch(segs_t[b : b + 1], "uniform", MEAN, 3, draws=draws[b : b + 1])
        assert _rank_mismatch(alone.numpy(), out_t[b : b + 1]) == 0.0
        np.testing.assert_allclose(alone.numpy()[0], out_t[b], rtol=1e-14)
        assert int(it[0]) == it_t[b]


@pytest.mark.parametrize("pdf", ["Lognormal", "Uniform"])
def test_simulate_batch_with_jax_draws(pdf):
    """The whole E13 generation (TK95 draw, power-of-two cut, E13 loop,
    downsampling) fed the JAX package's own draws: the cut geometry is
    equal, the rates agree within 0.15 std at most and 0.03 std on average
    (measured 0.078 / 0.012: the spectrum is complex64 in JAX, complex128
    here, and the E13 ranks drift as in test_e13_adjust_batch_against_jax)."""
    from mind_the_gaps_tpu.simulator import Simulator as JSimulator

    t = np.cumsum(np.random.default_rng(5).uniform(2.0, 8.0, 60))
    psd_model = psd_models.BendingPowerlaw(S0=5.0, omega0=0.05)
    a = JSimulator(psd_model, t, 1.0, 7.0, pdf, extension_factor=2.0)
    b = Simulator(psd_model, t, 1.0, 7.0, pdf, extension_factor=2.0, device="cpu")
    assert a._e13_cut_len == b._e13_cut_len == 1024 and b._e13_chunk_default() == a._e13_chunk_default()
    psd, B = np.asarray(a._psd_values()), 6
    key = jax.random.key(9)
    ref = np.asarray(a.simulate_batch(key, jnp.broadcast_to(jnp.asarray(psd), (B, psd.size))))
    normals, shifts, draws = [], [], []
    for k in jax.random.split(key, B):
        k_fft, k_cut, k_pdf = jax.random.split(k, 3)
        normals.append(np.array(jax.random.normal(k_fft, (2, psd.size), dtype=jnp.float64)))
        shifts.append(float(jax.random.uniform(k_cut, (), minval=a.sim_timestamps[0],
                                               maxval=a.sim_timestamps[-1] - a.sim_duration, dtype=jnp.float64)))
        draws.append(_jax_draws([k_pdf], pdf.lower(), a._e13_cut_len)[0])
    out = b.simulate_batch(
        torch.as_tensor(np.broadcast_to(psd, (B, psd.size)).copy()), normals=torch.as_tensor(np.stack(normals)),
        shifts=torch.as_tensor(shifts), pdf_draws=torch.as_tensor(np.stack(draws)),
    ).numpy()
    assert out.shape == ref.shape == (B, t.size)
    diff = np.abs(out - ref) / ref.std()
    assert diff.max() < 0.15 and diff.mean() < 0.03


def _segment(pdf, seed, n=8000):
    """An 8001-point segment of a long TK95 series (TestPDF's setup at a
    cut of at most 8192)."""
    simu = Simulator(psd_models.BendingPowerlaw(S0=10, omega0=2 * np.pi / 1000), np.arange(0, n, 1.0), 1.0,
                     MEAN, pdf, extension_factor=1.05, aliasing_factor=1, max_iter=1000, random_state=seed,
                     device="cpu")
    lc = simu.simulate_regularly_sampled()
    start = np.random.default_rng(seed).uniform(lc.time[0], lc.time[-1] - simu.sim_duration)
    segment = lc.truncate(start=start, stop=start + simu.sim_duration)
    assert segment.n <= 8192
    return simu, segment


def test_e13_lognormal_statistics():
    simu, segment = _segment("Lognormal", 10)
    x = simu.simulator.adjust_pdf(segment).countrate
    np.testing.assert_allclose(np.mean(x), MEAN, atol=0.15)
    np.testing.assert_allclose(np.var(x), np.var(segment.countrate), rtol=0.05)
    assert np.all(x > 0)
    logx = np.log(x)
    assert abs(np.mean((logx - logx.mean()) ** 3) / logx.std() ** 3) < 0.2


def test_e13_uniform_statistics():
    simu, segment = _segment("Uniform", 11)
    x = simu.simulator.adjust_pdf(segment).countrate
    np.testing.assert_allclose(np.mean(x), MEAN, atol=0.1)
    np.testing.assert_allclose(np.var(x), np.var(segment.countrate), rtol=0.1)
    np.testing.assert_allclose(np.mean((x - x.mean()) ** 4) / x.var() ** 2, 1.8, atol=0.15)
    # the reference's adjust_lightcurve_pdf form, with the target given
    target = simu.simulator.pdfmethod(MEAN, 2.0)
    y = E13Simulator(MEAN, "uniform", device="cpu").adjust_lightcurve_pdf(segment, target).countrate
    np.testing.assert_allclose(np.std(y), 2.0, rtol=0.05)


def test_e13_gaussian_is_a_no_op():
    simu, segment = _segment("Gaussian", 12)
    np.testing.assert_array_equal(simu.simulator.adjust_pdf(segment).countrate, segment.countrate)


def test_simulate_batch_nonconvergence_report():
    simu = Simulator(psd_models.BendingPowerlaw(S0=5.0, omega0=np.exp(-3)), np.arange(0, 600, 1.0), 1.0, 7.0,
                     "Lognormal", extension_factor=1.05, aliasing_factor=1, random_state=11, max_iter=1,
                     device="cpu")
    assert simu._e13_cut_len == simu._segment_len == 601  # the power of two does not fit: m stays
    psd_b = simu._psd_values().expand(4, -1).contiguous()
    with pytest.warns(UserWarning, match="4 simulated lightcurve\\(s\\) did not converge"):
        out = simu.simulate_batch(psd_b, generator=torch.Generator().manual_seed(1))
    assert out.shape == (4, 600) and torch.all(simu._last_e13_iters == 1)
    assert simu.report_nonconverged(warn=False) == 0
    for s in (2, 3):
        simu.simulate_batch(psd_b, generator=torch.Generator().manual_seed(s), warn_nonconverged=False)
    with pytest.warns(UserWarning, match="8 simulated lightcurve"):
        assert simu.report_nonconverged() == 8


def _drw_lc(seed=11, n=60):
    """test_lrt.py's lightcurve: an exact DRW realization plus noise."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    true = jk.DampedRandomWalk(log_S0=np.log(4.0), log_omega0=np.log(0.05))
    K = np.array(true.covariance(np.abs(t[:, None] - t[None, :]))) + np.diag(np.full(n, 0.09))
    y = 10.0 + np.linalg.cholesky(K) @ rng.normal(size=n)
    return mtg.GappyLightcurve(t, y, np.full(n, 0.3), exposures=1.0)


def test_lognormal_lrt_ab_against_jax():
    lc = _drw_lc()
    null_j = jk.DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    alt_j = jk.DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)]) + jk.Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)]
    )
    settings = dict(nsims=8, pdf="Lognormal", sim_max_steps=20, sim_walkers=8, seed=5, keep_simulations=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # short chains: "did not converge"
        ref = j_protassov_lrt(lc, null_j, alt_j, observed_max_steps=100, observed_walkers=8, **settings)

    lc_t = lightcurve_from_jax(lc)
    null_t, alt_t = kernel_from_jax(null_j), kernel_from_jax(alt_j)
    results = []
    for _ in range(2):
        models = []
        for gj, kern in ((ref.null_model, null_t), (ref.alt_model, alt_t)):
            gt = TGP(lc_t, kern, device="cpu")
            posteriors_from_jax(gj, gt)
            models.append(gt)
        results.append(protassov_lrt(lc_t, null_t, alt_t, null_model=models[0], alt_model=models[1],
                                     chunk=8, device="cpu", **settings))
    a, b = results
    assert a.t_obs_posterior == ref.t_obs_posterior
    np.testing.assert_allclose(a.t_obs, ref.t_obs, atol=4.0)
    assert a.t_dist.shape == (8,) and np.all(np.isfinite(a.t_dist))
    assert 0.0 <= a.p_value <= 1.0
    assert a.sim_rates.shape == a.sim_dy.shape == (8, lc.n) and np.all(np.isfinite(a.sim_rates))
    assert a.t_obs == b.t_obs and a.p_value == b.p_value
    np.testing.assert_array_equal(a.t_dist, b.t_dist)
    np.testing.assert_array_equal(a.sim_rates, b.sim_rates)
    # the lognormal generation's own entry: a list of GappyLightcurve
    lcs = results[0].null_model.generate_from_posteriors(nsims=3, pdf="Lognormal", seed=1)
    assert len(lcs) == 3 and all(np.all(np.isfinite(x.y)) for x in lcs)
