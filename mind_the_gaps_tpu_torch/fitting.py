"""Periodogram fitting utilities.

The port's own copy of ``mind_the_gaps_tpu/fitting.py`` (numpy and scipy
only, so the port need not import the JAX package), itself a rebuild of
reference mind_the_gaps/fitting.py:12-178 without the lmfit
dependency: log-log linear / broken-linear fits via bounded least squares
(scipy), with a small result object exposing the pieces the reference's
callers use (params, bic, nvarys, errorbars).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
from scipy.optimize import least_squares, minimize

__all__ = [
    "FitResult",
    "chose_ls_model",
    "chose_frequency_range",
    "brokenpl",
    "linear_fit_break",
    "linear_fit",
    "s_statistic",
    "s_stat_powerlaw",
    "minimize_powerlaw",
    "fit_lomb_scargle",
    "fit_psd_powerlaw",
]


@dataclass
class FitResult:
    """Minimal stand-in for lmfit's ModelResult."""

    params: Dict[str, float]
    param_errs: Dict[str, float]
    chisqr: float
    ndata: int
    nvarys: int
    errorbars: bool = True
    extra: dict = field(default_factory=dict)

    @property
    def bic(self) -> float:
        # lmfit convention: n*log(chisqr/n) + k*log(n)
        return self.ndata * math.log(self.chisqr / self.ndata) + self.nvarys * math.log(self.ndata)

    def get(self, name, default=None):
        return self.params.get(name, default)


def _values(x):
    return x.value if hasattr(x, "unit") else np.asarray(x)


def brokenpl(x, intercept, slope, x_break):
    """Broken power law (in log space) that flattens above the break
    (reference fitting.py:39-48)."""
    x = np.asarray(x)
    return np.where(x < x_break, intercept + slope * (x - x_break), intercept)


def linear_fit(frequencies, powers) -> FitResult:
    """Powerlaw fit = linear fit in log10-log10 space
    (reference fitting.py:71-89; slope bounded to [-4, 0.5])."""
    log_f = np.log10(_values(frequencies))
    log_p = np.log10(_values(powers))

    def resid(p):
        return p[0] * log_f + p[1] - log_p

    res = least_squares(resid, x0=[-1.0, np.mean(log_p)], bounds=([-4, -np.inf], [0.5, np.inf]))
    n = len(log_f)
    chisqr = float(np.sum(res.fun**2))
    # OLS standard errors (sigma^2 estimated from residuals)
    dof = max(n - 2, 1)
    s2 = chisqr / dof
    sxx = np.sum((log_f - log_f.mean()) ** 2)
    slope_err = math.sqrt(s2 / sxx) if sxx > 0 else np.inf
    inter_err = math.sqrt(s2 * (1.0 / n + log_f.mean() ** 2 / sxx)) if sxx > 0 else np.inf
    return FitResult(
        params={"pow_slope": float(res.x[0]), "pow_intercept": float(res.x[1])},
        param_errs={"pow_slope": slope_err, "pow_intercept": inter_err},
        chisqr=chisqr,
        ndata=n,
        nvarys=2,
    )


def linear_fit_break(frequencies, powers) -> FitResult:
    """Broken-linear fit in ln-ln space (reference fitting.py:50-68)."""
    log_f = np.log(_values(frequencies))
    log_p = np.log(_values(powers))

    def resid(p):
        return brokenpl(log_f, p[0], p[1], p[2]) - log_p

    res = least_squares(
        resid,
        x0=[1.0, -1.0, float(np.mean(log_f))],
        bounds=([-np.inf, -4.0, float(np.min(log_f))], [np.inf, 0.0, float(np.max(log_f))]),
    )
    n = len(log_f)
    chisqr = float(np.sum(res.fun**2))
    return FitResult(
        params={"intercept": float(res.x[0]), "slope": float(res.x[1]), "x_break": float(res.x[2])},
        param_errs={},
        chisqr=chisqr,
        ndata=n,
        nvarys=3,
        errorbars=False,
    )


def chose_ls_model(frequencies, powers) -> FitResult:
    """BIC selection between plain and broken powerlaw fits
    (reference fitting.py:12-20)."""
    outfit_break = linear_fit_break(frequencies, powers)
    outfit = linear_fit(frequencies, powers)
    if outfit_break.bic < outfit.bic:
        return outfit_break
    return outfit


def chose_frequency_range(frequencies, power):
    """High-frequency cutoff from a broken-powerlaw break if one is
    preferred (reference fitting.py:23-36)."""
    best_model = chose_ls_model(frequencies, power)
    if best_model.nvarys == 3:
        maximum_frequency = np.exp(best_model.params["x_break"])
        if hasattr(frequencies, "unit"):
            maximum_frequency = maximum_frequency * frequencies.unit
    else:
        maximum_frequency = np.max(frequencies)
    return best_model, maximum_frequency


def s_statistic(observed_powers, model_powers):
    """Whittle S statistic, Vaughan+2003 Eq. A.3 (reference fitting.py:92-95)."""
    return np.sum(np.log(model_powers) + observed_powers / model_powers)


def s_stat_powerlaw(x, frequencies, observed_powers):
    model_powers = x[0] * frequencies ** x[1]
    return s_statistic(observed_powers, model_powers)


def minimize_powerlaw(frequencies, observed_powers):
    """Powerlaw fit by minimizing the S statistic (reference fitting.py:104-109)."""
    bnds = ((0, np.inf), (-4, 0))
    res = minimize(
        s_stat_powerlaw,
        [np.mean(observed_powers), -1],
        args=(frequencies, observed_powers),
        bounds=bnds,
        method="L-BFGS-B",
    )
    return res.x


def fit_lomb_scargle(frequencies, powers, sigma=1):
    """Powerlaw fit of a Lomb-Scargle periodogram with 1-sigma-scaled
    uncertainties (reference fitting.py:111-138)."""
    out_fit = linear_fit(frequencies, powers)
    psd_slope = out_fit.params["pow_slope"]
    psd_norm = 10 ** out_fit.params["pow_intercept"]
    if out_fit.errorbars and sigma > 0:
        psd_slope_err = sigma * out_fit.param_errs["pow_slope"]
        ie = sigma * out_fit.param_errs["pow_intercept"]
        psd_norm_err = abs(10 ** (out_fit.params["pow_intercept"] + ie) - 10 ** (out_fit.params["pow_intercept"] - ie)) / 2
    else:
        psd_slope_err = 0.0
        psd_norm_err = 0.0
    return psd_slope, psd_slope_err, psd_norm, psd_norm_err


def fit_psd_powerlaw(frequencies, powers):
    """Vaughan+2005 periodogram powerlaw fit with analytic errors and the
    +0.25068 log-normalization bias correction (reference fitting.py:140-177).

    The 0-frequency (and Nyquist, for even series) terms must be removed
    before calling.
    """
    out_fit = linear_fit(frequencies, powers)
    n_prime = len(_values(powers))
    sigma_2 = np.pi**2 / (6 * np.log(10) ** 2)
    log_f = np.log10(_values(frequencies))
    log_f_2_sum = np.sum(np.power(log_f, 2))
    delta = n_prime * log_f_2_sum - np.sum(log_f) ** 2
    psd_slope_err = np.sqrt(n_prime * sigma_2 / delta)
    psd_log10norm_err = np.sqrt(sigma_2 * log_f_2_sum / delta)
    psd_slope = out_fit.params["pow_slope"]
    lognorm = out_fit.params["pow_intercept"] + 0.25068
    dlog_conf = lognorm - psd_log10norm_err
    psd_norm = 10**lognorm
    psd_norm_err = psd_norm - 10**dlog_conf
    return psd_slope, psd_slope_err, psd_norm, psd_norm_err
