"""The port's ``stats.py`` against the JAX package's: the Kraft+91
posterior median and HPD interval (torch float64 on the CPU) on a grid of
counts and backgrounds, the ports of ``tests/test_stats.py``'s Kraft cases
(scipy's median, the interval's mass and equal-density ends, its minimal
width), and the host statistics (periodogram fit statistics, information
criteria, the rv classes).

Tolerances: the Kraft quantities within rtol 1e-9 of the JAX package's
(the same bisections; the two packages' regularized incomplete gamma
functions agree to ~1e-14 for N <= 15, the counts ``KraftNoise`` uses,
and torch's drifts to ~1e-9 for N + 1 > 16, where it takes an asymptotic
series); the host statistics equal (the same numpy arithmetic) or within
1e-12; the scipy and quadrature checks keep ``test_stats.py``'s tolerances.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import scipy.integrate  # noqa: E402
from scipy import special  # noqa: E402
from scipy.optimize import brentq  # noqa: E402

from mind_the_gaps_tpu import stats as jstats  # noqa: E402
from mind_the_gaps_tpu_torch import stats as tstats  # noqa: E402

GRID_N = np.repeat(np.arange(21.0), 4)
GRID_B = np.tile([0.0, 0.3, 2.5, 10.0], 21)


def _np_kraft_pdf(x, N, B):
    n = np.arange(N + 1)
    C = (np.sum(np.exp(-B) * B**n / special.factorial(n))) ** -1
    return C * np.exp(-x - B) * (x + B) ** N / special.factorial(N)


def test_kraft_median_matches_jax_on_grid():
    ours = tstats.kraft_posterior_median(GRID_N, GRID_B, device="cpu")
    assert ours.dtype == torch.float64 and ours.shape == GRID_N.shape
    ref = np.asarray(jstats.kraft_posterior_median(GRID_N, GRID_B))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-9, atol=0)


def test_kraft_hpd_matches_jax_on_grid():
    lo, hi = tstats.kraft_hpd_interval(GRID_N, GRID_B, cl=0.68, device="cpu")
    lo_j, hi_j = (np.asarray(v) for v in jstats.kraft_hpd_interval(GRID_N, GRID_B, cl=0.68))
    np.testing.assert_allclose(lo.numpy(), lo_j, rtol=1e-9, atol=1e-12)  # lo is 0 in the upper-limit cases
    np.testing.assert_allclose(hi.numpy(), hi_j, rtol=1e-9, atol=0)


def test_kraft_functions_broadcast_tensors():
    """(K, 1) counts against (1, n) backgrounds, as KraftNoise's tables
    call them, give the elementwise values; tensors keep their own device
    (the default ``device="cuda"`` is for arrays and lists)."""
    N = torch.arange(4, dtype=torch.float64)[:, None]
    B = torch.tensor([[0.0, 0.5, 3.0]], dtype=torch.float64)
    med = tstats.kraft_posterior_median(N, B)
    lo, hi = tstats.kraft_hpd_interval(N, B)
    assert med.shape == lo.shape == hi.shape == (4, 3)
    Nf, Bf = (v.numpy().ravel() for v in torch.broadcast_tensors(N, B))
    np.testing.assert_array_equal(med.numpy().ravel(), tstats.kraft_posterior_median(Nf, Bf, device="cpu").numpy())
    np.testing.assert_array_equal(hi.numpy().ravel(), tstats.kraft_hpd_interval(Nf, Bf, device="cpu")[1].numpy())


def test_kraft_median_matches_scipy():
    pdf = tstats.kraft_pdf(a=0, b=35)
    cases = [(0, 0.0), (1, 0.5), (3, 1.2), (7, 4.0), (14, 9.3), (5, 0.0)]
    med = tstats.kraft_posterior_median([c[0] for c in cases], [c[1] for c in cases], device="cpu").numpy()
    for i, (N, B) in enumerate(cases):
        np.testing.assert_allclose(med[i], pdf(N, B).median(), rtol=1e-6, atol=1e-8)


def test_kraft_hpd_interval_mass_and_ends():
    cases = [(0, 0.0), (2, 0.5), (6, 3.0), (12, 8.0)]
    lo, hi = (v.numpy() for v in tstats.kraft_hpd_interval([c[0] for c in cases], [c[1] for c in cases], cl=0.68, device="cpu"))
    for i, (N, B) in enumerate(cases):
        mass, _ = scipy.integrate.quad(_np_kraft_pdf, lo[i], hi[i], args=(N, B))
        np.testing.assert_allclose(mass, 0.68, atol=2e-3)
        if lo[i] > 1e-6:
            np.testing.assert_allclose(_np_kraft_pdf(lo[i], N, B), _np_kraft_pdf(hi[i], N, B), rtol=1e-3)
        else:  # the upper-limit case
            assert _np_kraft_pdf(0.0, N, B) >= _np_kraft_pdf(hi[i], N, B) * 0.999


def test_kraft_hpd_is_minimal_width():
    N, B = 4, 1.5
    lo, hi = (float(v[0]) for v in tstats.kraft_hpd_interval([float(N)], [B], cl=0.68, device="cpu"))
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = rng.uniform(0, 8)
        total, _ = scipy.integrate.quad(_np_kraft_pdf, a, 60, args=(N, B))
        if total < 0.68:
            continue
        b = brentq(lambda b: scipy.integrate.quad(_np_kraft_pdf, a, b, args=(N, B))[0] - 0.68, a, 60)
        assert b - a >= (hi - lo) - 5e-3


def test_host_statistics_match_jax():
    rng = np.random.default_rng(1)
    data, model = rng.uniform(0.5, 3.0, 9), rng.uniform(0.5, 3.0, 9)
    sig = rng.uniform(0.1, 0.5, 9)
    inv_cov = np.linalg.inv(np.diag(sig**2) + 0.01)
    for nyq in (False, True):
        np.testing.assert_allclose(tstats.chi_log_likehood(data, model, nyq),
                                   float(jstats.chi_log_likehood(data, model, nyq)), rtol=1e-12)
    np.testing.assert_allclose(tstats.chi_log_likehood_nonyq(data, model),
                               float(jstats.chi_log_likehood_nonyq(data, model)), rtol=1e-12)
    np.testing.assert_allclose(tstats.chi_square(data, model, sig), float(jstats.chi_square(data, model, sig)),
                               rtol=1e-12)
    np.testing.assert_allclose(tstats.chi_cov(data, model, inv_cov), float(jstats.chi_cov(data, model, inv_cov)),
                               rtol=1e-12)
    # chi_square with the diagonal covariance is chi_cov (test_stats.py's check)
    np.testing.assert_allclose(tstats.chi_square(data, model, sig), tstats.chi_cov(data, model, np.diag(sig**-2)),
                               rtol=1e-12)
    for args in ((-10.0, 100, 3), (5.5, 40, 2)):
        assert tstats.bic(*args) == jstats.bic(*args)
        assert tstats.aicc(*args) == jstats.aicc(*args)
        assert tstats.aic(args[0], args[2]) == jstats.aic(args[0], args[2])
    np.testing.assert_allclose(tstats.fit_N(lambda n: (n - 2.5) ** 2), jstats.fit_N(lambda n: (n - 2.5) ** 2))
    # kept as the JAX package has it: the call raises in both
    for mod in (tstats, jstats):
        with pytest.raises(TypeError):
            mod.chi_square_N(data, model, sig)


def test_rv_classes_match_jax():
    x = np.linspace(0.0, 12.0, 7)
    for xi in x:  # the reference's _pdf takes a scalar N, so one x at a time
        assert tstats.kraft_pdf(a=0, b=35)(3, 1.2).pdf(xi) == jstats.kraft_pdf(a=0, b=35)(3, 1.2).pdf(xi)
    np.testing.assert_array_equal(tstats.lognormal(a=0)(0.2, 0.7).pdf(x[1:]), jstats.lognormal(a=0)(0.2, 0.7).pdf(x[1:]))
