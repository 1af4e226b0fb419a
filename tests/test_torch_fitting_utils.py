"""The port's copies of ``fitting`` and ``utils`` (numpy and scipy only)
against the JAX package's modules, on the inputs of
tests/test_fitting_utils.py: every function's results equal to rtol 1e-12
(the two run the same numpy code, so they agree to the last bit unless a
library call reorders a sum), and the JAX suite's own checks, run on the
port.  ``simulate_ar1`` takes numpy generators, so the same seed gives the
same draws in both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mind_the_gaps_tpu import fitting as jfit  # noqa: E402
from mind_the_gaps_tpu import utils as jutils  # noqa: E402
from mind_the_gaps_tpu_torch import fitting, utils  # noqa: E402


def _close(got, ref):
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _close(got[k], ref[k])
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _close(a, b)
    elif isinstance(ref, jfit.FitResult):
        assert isinstance(got, fitting.FitResult)
        _close((got.params, got.param_errs, got.chisqr, got.ndata, got.nvarys, got.errorbars, got.bic),
               (ref.params, ref.param_errs, ref.chisqr, ref.ndata, ref.nvarys, ref.errorbars, ref.bic))
    else:
        np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(ref, dtype=float), rtol=1e-12, atol=0)


def _powerlaw(seed=0, n=200, slope=-1.5, scale=0.05):
    rng = np.random.default_rng(seed)
    f = np.logspace(-2, 0, n)
    return f, 3.0 * f**slope * np.exp(rng.normal(0, scale, f.size))


def _broken(seed=2):
    rng = np.random.default_rng(seed)
    f = np.logspace(-3, 0, 300)
    return f, np.where(f < 0.05, (f / 0.05) ** -2.0, 1.0) * np.exp(rng.normal(0, 0.1, f.size))


def _chi2_periodogram(seed=3):
    rng = np.random.default_rng(seed)
    f = np.logspace(-2, 0, 500)
    return f, 5.0 * f**-1.2 * rng.exponential(1.0, f.size)


def _sine(seed=6):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 40, 400))
    return t, 5.0 + 1.5 * np.sin(2 * np.pi * 0.25 * t + 0.4) + rng.normal(0, 0.2, t.size)


def _ar1_times(seed=7, n=3000):
    return np.cumsum(np.random.default_rng(seed).uniform(0.5, 1.5, n))


FITTING_CASES = {
    "linear_fit": lambda m: m.linear_fit(*_powerlaw()),
    "linear_fit_break": lambda m: m.linear_fit_break(*_broken()),
    "chose_ls_model_broken": lambda m: m.chose_ls_model(*_broken()),
    "chose_ls_model_plain": lambda m: m.chose_ls_model(*_powerlaw(1, 100, -1.0, 0.2)),
    "chose_frequency_range": lambda m: m.chose_frequency_range(*_broken()),
    "brokenpl": lambda m: m.brokenpl(np.linspace(-3, 1, 50), 0.5, -1.7, -0.4),
    "s_statistic": lambda m: m.s_statistic(_chi2_periodogram()[1], 5.0 * _chi2_periodogram()[0] ** -1.2),
    "s_stat_powerlaw": lambda m: m.s_stat_powerlaw(np.array([4.0, -1.1]), *_chi2_periodogram()),
    "minimize_powerlaw": lambda m: m.minimize_powerlaw(*_chi2_periodogram()),
    "fit_lomb_scargle": lambda m: m.fit_lomb_scargle(*_powerlaw(1, 100, -1.0, 0.2)),
    "fit_lomb_scargle_3sigma": lambda m: m.fit_lomb_scargle(*_powerlaw(1, 100, -1.0, 0.2), sigma=3),
    "fit_psd_powerlaw": lambda m: m.fit_psd_powerlaw(*_powerlaw()),
}

UTILS_CASES = {
    "phase_fold": lambda m: m.phase_fold(*_phase_data(), 0.25, dy=np.full(500, 0.1), n_bins=10),
    "phase_fold_no_dy": lambda m: m.phase_fold(*_phase_data(), 0.25, time_0=3.0, n_bins=7),
    "fit_sines": lambda m: _sines(m.fit_sines(*_sine(), frequency=0.25, dy=np.full(400, 0.2))),
    "fit_sines_guess": lambda m: _sines(m.fit_sines(*_sine(), max_sines=3)),
    "detrend": lambda m: m.detrend(*_trend()),
    "detrend_weighted": lambda m: m.detrend(*_trend(), stds=np.linspace(0.05, 0.2, 200)),
    "psd_ar1": lambda m: m.psd_ar1(10.0, 1.0, 0.5 / 255, np.linspace(0.001, 0.5, 256), 2.5),
    "mudelsee_residuals": lambda m: m.mudelsee_residuals(_ar1_times(), _ar1_series(), 20.0),
    "mudelsee_least_squares": lambda m: [m.mudelsee_least_squares(a, np.diff(_ar1_times()) / 20.0,
                                                                  _ar1_series()[:-1], _ar1_series()[1:])
                                         for a in (0.7, -0.3, 0.0)],
    "mudelsee_fit": lambda m: m.mudelsee_fit(_ar1_times(), _ar1_series()),
    "simulate_ar1": lambda m: m.simulate_ar1(20.0, _ar1_times(n=400), variance=4.0, mean=1.0,
                                             trend=np.linspace(0, 1, 400), nsimulations=5,
                                             rng=np.random.default_rng(11)),
}


def _phase_data():
    rng = np.random.default_rng(4)
    t = np.sort(rng.uniform(0, 100, 500))
    return t, 2.0 + np.sin(2 * np.pi * 0.25 * t)


def _sines(fit):
    return fit.params, fit.frequencies, fit.chisqr, fit.bic, fit.eval(np.linspace(0, 40, 64))


def _trend():
    rng = np.random.default_rng(5)
    t = np.linspace(0, 10, 200)
    return t, 3.0 + 0.7 * t + rng.normal(0, 0.1, t.size)


def _ar1_series():
    return jutils.simulate_ar1(20.0, _ar1_times(), variance=4.0, nsimulations=1, rng=np.random.default_rng(7))[0]


def test_every_function_has_a_case():
    assert fitting.__all__ == jfit.__all__ and utils.__all__ == jutils.__all__
    cases = set(FITTING_CASES) | set(UTILS_CASES)
    for name in fitting.__all__ + utils.__all__:  # FitResult: the result of linear_fit's case
        assert name == "FitResult" or any(c == name or c.startswith(name + "_") for c in cases), name


@pytest.mark.parametrize("name", sorted(FITTING_CASES))
def test_fitting_matches_jax(name):
    case = FITTING_CASES[name]
    _close(case(fitting), case(jfit))


@pytest.mark.parametrize("name", sorted(UTILS_CASES))
def test_utils_matches_jax(name):
    case = UTILS_CASES[name]
    _close(case(utils), case(jutils))


def test_detrend_plot_writes_figure(tmp_path):
    pytest.importorskip("matplotlib")
    t, y = _trend()
    detrended, trend = utils.detrend(t, y, stds=np.full(t.size, 0.1), plot=True, outdir=str(tmp_path))
    _close((detrended, trend), jutils.detrend(t, y, stds=np.full(t.size, 0.1)))
    assert (tmp_path / "linear_fit.png").stat().st_size > 1000


def test_jax_suite_checks_on_the_port():
    """The assertions of tests/test_fitting_utils.py, on the port's modules."""
    f, powers = _powerlaw()
    slope, slope_err, norm, norm_err = fitting.fit_psd_powerlaw(f, powers)
    assert abs(slope + 1.5) < 0.05 and slope_err > 0 and norm_err > 0
    assert norm > 10 ** fitting.linear_fit(f, powers).params["pow_intercept"]
    f, powers = _broken()
    assert fitting.chose_ls_model(f, powers).nvarys == 3
    assert 0.01 < fitting.chose_frequency_range(f, powers)[1] < 0.3
    f, powers = _chi2_periodogram()
    norm, slope = fitting.minimize_powerlaw(f, powers)
    assert abs(slope + 1.2) < 0.15
    assert fitting.s_statistic(powers, norm * f**slope) <= fitting.s_statistic(powers, 5.0 * f**-1.2) + 1.0
    means, _, bins = utils.phase_fold(*_phase_data(), 0.25, dy=np.full(500, 0.1), n_bins=10)
    assert len(means) == 20 and len(bins) == 20 and means.max() - means.min() > 1.0
    t, y = _sine()
    assert np.std(y - utils.fit_sines(t, y, frequency=0.25, dy=np.full(400, 0.2)).eval(t)) < 0.35
    x = utils.simulate_ar1(20.0, _ar1_times(), variance=4.0, nsimulations=1, rng=np.random.default_rng(7))[0]
    assert abs(np.var(x) - 4.0) / 4.0 < 0.3
    tau, residuals = utils.mudelsee_fit(_ar1_times(), x)
    assert 10.0 < tau < 40.0 and len(residuals) == 2999
    freqs = np.linspace(0.001, 0.5, 256)
    g = utils.psd_ar1(10.0, 1.0, freqs[1] - freqs[0], freqs, 2.5)
    np.testing.assert_allclose(np.sum(g) * (freqs[1] - freqs[0]), 2.5, rtol=1e-10)
