"""Miscellaneous time-series utilities.

The port's own copy of ``mind_the_gaps_tpu/utils.py`` (numpy and scipy
only, so the port need not import the JAX package), itself a rebuild of
reference mind_the_gaps/utils.py:12-262: phase folding,
BIC-driven harmonic fitting, detrending, and the Schulz & Mudelsee (2002)
AR(1) toolchain — host-side numpy/scipy (these are small diagnostics, not
hot paths), with the lmfit harmonic ladder replaced by scipy least
squares.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import least_squares, minimize

__all__ = [
    "phase_fold",
    "fit_sines",
    "detrend",
    "psd_ar1",
    "mudelsee_residuals",
    "mudelsee_fit",
    "mudelsee_least_squares",
    "simulate_ar1",
]


def phase_fold(timestamps, y, folding_frequency, dy=None, time_0=0, n_bins=10):
    """Fold a lightcurve at the given frequency into phase bins
    (reference utils.py:12-49); returns (bin_means, bin_stds,
    two_phase_bins) for two cycles."""
    timestamps = np.asarray(timestamps)
    y = np.asarray(y)
    phases = (timestamps - time_0) * folding_frequency
    phases = phases % 1
    phased_bins = np.floor(phases * n_bins).astype(int)
    bins = np.arange(0, n_bins)
    bin_means = [y[phased_bins == i].mean() for i in bins]
    if dy is None:
        dy = np.ones_like(y)
    bin_stds = [
        np.sqrt(np.sum(dy[phased_bins == i] ** 2)) / max(np.count_nonzero(phased_bins == i), 1)
        for i in bins
    ]
    bin_means = np.hstack([bin_means, bin_means])
    bin_stds = np.hstack([bin_stds, bin_stds])
    bins = bins / n_bins + 0.05
    two_phase_bins = np.hstack([bins, bins + 1])
    return bin_means, bin_stds, two_phase_bins


def _sine_series(t, params, frequencies):
    """constant + sum_i A_i sin(f_i t + shift) (shared phase like the
    reference's tied sine%d_shift)."""
    c = params[0]
    shift = params[1]
    amps = params[2:]
    out = np.full_like(t, c, dtype=float)
    for amp, f in zip(amps, frequencies):
        out = out + amp * np.sin(f * t + shift)
    return out


class SineFitResult:
    def __init__(self, params, frequencies, chisqr, ndata):
        self.params = params
        self.frequencies = frequencies
        self.chisqr = chisqr
        self.ndata = ndata
        self.nvarys = len(params)

    @property
    def bic(self):
        return self.ndata * np.log(self.chisqr / self.ndata) + self.nvarys * np.log(self.ndata)

    def eval(self, x):
        return _sine_series(np.asarray(x), self.params, self.frequencies)


def fit_sines(timestamps, rates, frequency=None, dy=None, max_sines=5):
    """BIC-driven ladder of harmonics (reference utils.py:51-76): keep
    adding sine components (harmonics of ``frequency`` if given) while
    the BIC improves."""
    timestamps = np.asarray(timestamps, dtype=float)
    rates = np.asarray(rates, dtype=float)
    w = 1.0 / np.asarray(dy) if dy is not None else np.ones_like(rates)
    if frequency is None:
        # crude fundamental guess from the periodogram
        dtm = np.median(np.diff(timestamps))
        freqs = np.fft.rfftfreq(len(timestamps), dtm)[1:]
        p = np.abs(np.fft.rfft(rates - rates.mean())[1:]) ** 2
        frequency = freqs[np.argmax(p)]
    base = 2 * np.pi * frequency

    best = None
    for i in range(1, max_sines + 1):
        frequencies = [base * (k + 1) for k in range(i)]

        def resid(p):
            return (_sine_series(timestamps, p, frequencies) - rates) * w

        p0 = np.concatenate([[rates.mean(), 0.0], np.full(i, rates.std())])
        res = least_squares(resid, p0)
        fit = SineFitResult(res.x, frequencies, float(np.sum(res.fun**2)), len(rates))
        if best is not None and fit.bic >= best.bic:
            break
        best = fit
    return best


def detrend(t, y, stds=None, plot=False, outdir="."):
    """Subtract a weighted linear fit (reference utils.py:78-115).
    Returns (detrended, trend)."""
    w = 1.0 / np.asarray(stds) if stds is not None else None
    p = np.polyfit(t, y, deg=1, w=w)
    trend = p[0] * np.asarray(t) + p[1]
    if plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 1, sharex=True, gridspec_kw={"hspace": 0, "wspace": 0})
        axes[0].errorbar(t, y, yerr=stds, ls="None", color="black", fmt="+")
        axes[0].plot(t, trend, color="red", lw=2, label="Linear fit")
        axes[0].legend()
        axes[1].errorbar(t, y - trend, yerr=stds, fmt="+", ls="None", color="black")
        axes[1].axhline(y=0, ls="--", color="blue")
        fig.savefig(f"{outdir}/linear_fit.png")
        plt.close(fig)
    return y - trend, trend


def psd_ar1(tau, dt, df, frequencies, data_variance):
    """Theoretical AR(1) PSD, Schulz & Mudelsee (2002) Eq. 2
    (reference utils.py:118-138)."""
    rho = np.exp(-dt / tau)
    rho_2 = rho**2
    gredth = (1 - rho_2) / (1 - 2 * rho * np.cos(np.linspace(0, np.pi, len(frequencies))) + rho_2)
    gredth = data_variance / (np.sum(gredth) * df) * gredth
    return gredth


def mudelsee_residuals(timestamps, rates, tau):
    """AR(1) innovations (Mudelsee 2002 Eq. 6; reference utils.py:141-155)."""
    timestamps = np.asarray(timestamps)
    rates = np.asarray(rates)
    return rates[1:] - rates[:-1] * np.exp(-(timestamps[1:] - timestamps[:-1]) / tau)


def mudelsee_least_squares(a, time_diff, timeseriesMNP, timeseriesM1, stds=None):
    """Least-squares objective of Mudelsee (2002) Eq. 3
    (reference utils.py:196-221)."""
    if stds is None:
        stds = np.ones(len(timeseriesMNP))
    if a > 0:
        tmp = timeseriesM1 - timeseriesMNP * a**time_diff
    elif a < 0:
        tmp = timeseriesM1 + timeseriesMNP * (-a) ** time_diff
    else:
        tmp = timeseriesM1
    return np.sum((tmp / stds) ** 2)


def mudelsee_fit(timestamps, detrended_data, errors=None):
    """Estimate the AR(1) timescale tau by the Mudelsee (2002)
    least-squares method (reference utils.py:158-193).
    Returns (tau, residuals)."""
    timestamps = np.asarray(timestamps, dtype=float)
    detrended_data = np.asarray(detrended_data, dtype=float)
    time_diff = np.diff(timestamps)
    avg_dt = np.mean(time_diff)
    a_0 = np.exp(-1)
    std_rate = np.std(detrended_data)
    xscalt = detrended_data / std_rate
    timeseriesMNP = xscalt[:-1]
    timeseriesM1 = xscalt[1:]
    rho = np.sum(timeseriesMNP * timeseriesM1) / np.sum(timeseriesMNP * timeseriesMNP)
    scalt = -np.log(rho) / avg_dt
    tscalt = timestamps * scalt
    res_lsq = minimize(
        mudelsee_least_squares,
        a_0,
        args=(np.diff(tscalt), timeseriesMNP, timeseriesM1, None),
        bounds=[(0, 1)],
        tol=3e-10,
    )
    if res_lsq.success:
        a = res_lsq.x[0]
        tau = -1 / (np.log(a) * scalt)
        residuals = mudelsee_residuals(timestamps, detrended_data, tau)
        return tau, residuals
    raise RuntimeError(res_lsq.message)


def simulate_ar1(tau, timestamps, variance, mean=0, trend=None, nsimulations=10, rng=None):
    """Simulate AR(1) series over irregular timestamps
    (reference utils.py:224-262), vectorized over simulations.
    Returns (nsimulations, len(timestamps))."""
    timestamps = np.asarray(timestamps, dtype=float)
    rng = np.random.default_rng() if rng is None else rng
    n = len(timestamps)
    decays = np.exp(-np.diff(timestamps) / tau)
    noise_std = np.sqrt((1 - decays**2) * variance)
    ar1 = np.empty((nsimulations, n))
    ar1[:, 0] = rng.normal(0, 1, nsimulations) * np.sqrt(variance)
    noise = rng.normal(0, 1, (nsimulations, n - 1)) * noise_std
    for i in range(1, n):
        ar1[:, i] = ar1[:, i - 1] * decays[i - 1] + noise[:, i - 1]
    out = ar1 + mean
    if trend is not None:
        out = out + trend
    return out
