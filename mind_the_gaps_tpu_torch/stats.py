"""Statistics: distributions, periodogram fit statistics, information
criteria and the Kraft+91 posterior of a source with a known background.

PyTorch port of ``mind_the_gaps_tpu/stats.py``:

- host tier (numpy/scipy, copied): ``kraft_pdf`` and ``lognormal`` (scipy
  ``rv_continuous`` classes), ``create_log_normal`` /
  ``create_uniform_distribution`` (moment-matched scipy distributions),
  the periodogram statistics ``chi_cov``, ``chi_log_likehood(_nonyq)``,
  ``chi_square(_N)``, ``fit_N`` and the information criteria;
- ``sample_pdf``: moment-matched draws of the target flux PDF on tensors,
  from a ``torch.Generator`` or from given standard draws (normals for the
  lognormal and the Gaussian, uniforms on [0, 1) for the uniform), so a
  test can give both packages the same random numbers; drawn on the card
  unless a tensor ``std``, a generator or ``device="cpu"`` says otherwise;
- the Kraft, Burrows & Nousek (1991) posterior median
  (``kraft_posterior_median``) and 68% highest-density interval
  (``kraft_hpd_interval``) on float64 tensors (the card unless the caller
  passes CPU tensors or ``device="cpu"``), by
  fixed-iteration bisections over regularized incomplete gamma functions,
  with the JAX package's iteration counts (70 inner, 60 on the level) and
  brackets: on a card in one launch of ``ops.kraft``'s kernel, elsewhere as
  eager PyTorch operations (``kraft_posterior_median_plain``,
  ``kraft_hpd_interval_plain``).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from scipy import special, stats
from scipy.optimize import minimize
from scipy.stats import lognorm, uniform

from mind_the_gaps_tpu_torch.ops import kraft as _kraft_op

__all__ = [
    "kraft_pdf",
    "lognormal",
    "chi_cov",
    "chi_log_likehood",
    "chi_log_likehood_nonyq",
    "chi_square",
    "chi_square_N",
    "create_log_normal",
    "create_uniform_distribution",
    "fit_N",
    "bic",
    "aic",
    "aicc",
    "neg_log_like",
    "sample_pdf",
    "kraft_posterior_median",
    "kraft_hpd_interval",
    "kraft_posterior_median_plain",
    "kraft_hpd_interval_plain",
]


class kraft_pdf(stats.rv_continuous):
    """Kraft, Burrows & Nousek (1991) posterior for a source with N total
    observed counts and known background B:
    f(x) = C e^{-(x+B)} (x+B)^N / N!, x >= 0."""

    def _argcheck(self, N, B):
        return (N >= 0) and (B >= 0)

    def _pdf(self, x, N, B):
        n = np.arange(N + 1)
        C = (np.sum(np.exp(-B) * B**n / special.factorial(n))) ** -1
        return C * np.exp(-x - B) * (x + B) ** N / special.factorial(N)


class lognormal(stats.rv_continuous):
    """Log-normal parameterized by (center, sigma) of log-flux."""

    def _argcheck(self, center, sigma):
        return sigma >= 0

    def _pdf(self, x, center, sigma):
        return (
            1.0
            / (sigma * x * np.sqrt(2 * np.pi))
            * np.exp(-((np.log(x) - center) ** 2) / (2 * sigma**2))
        )


def create_log_normal(mean, std):
    """Moment-matched scipy lognorm with the given mean and std."""
    var = std**2
    mu = np.log((mean**2) / np.sqrt(var + mean**2))
    sigma = np.sqrt(np.log(var / (mean**2) + 1))
    return lognorm(sigma, scale=np.exp(mu))


def create_uniform_distribution(mean, std):
    """Moment-matched scipy uniform with the given mean and std."""
    var = std**2
    b = np.sqrt(3 * var) + mean
    a = 2 * mean - b
    return uniform(loc=a, scale=b - a)


def standard_draws(pdf: str, shape, generator: Optional[torch.Generator] = None, device=None):
    """The standard float64 draws of ``sample_pdf`` for ``pdf``: uniform on
    [0, 1) for 'uniform', else standard normal; on ``device``, by default
    the generator's, or the card without a generator."""
    draw = torch.rand if pdf.lower() == "uniform" else torch.randn
    if device is None:
        device = generator.device if generator is not None else "cuda"
    return draw(tuple(shape), generator=generator, dtype=torch.float64, device=device)


def sample_pdf(pdf: str, mean, std, shape, generator: Optional[torch.Generator] = None, draws=None,
               device="cuda"):
    """Moment-matched draws of ``shape`` from the flux PDF ``pdf``
    ('gaussian' | 'lognormal' | 'uniform'), matched in mean and std.

    ``mean`` and ``std`` are floats or tensors that broadcast against
    ``shape`` (per-row values as (B, 1)).  ``draws`` replaces the standard
    draws from ``generator``; without it they are float64 on ``std``'s
    device when ``std`` is a tensor, else on the generator's device, else
    on ``device`` (the card unless the caller asks for the CPU).
    """
    pdf = pdf.lower()
    if pdf not in ("gaussian", "lognormal", "uniform"):
        raise ValueError("pdf must be one of 'gaussian', 'lognormal', 'uniform'")
    if draws is None:
        if torch.is_tensor(std):
            device = std.device
        elif generator is not None:
            device = generator.device
        draws = standard_draws(pdf, shape, generator, device)
    mean = torch.as_tensor(mean, dtype=draws.dtype, device=draws.device)
    std = torch.as_tensor(std, dtype=draws.dtype, device=draws.device)
    if pdf == "gaussian":
        return mean + std * draws
    if pdf == "lognormal":
        var = std**2
        mu = torch.log(mean**2 / torch.sqrt(var + mean**2))
        sigma = torch.sqrt(torch.log(var / mean**2 + 1.0))
        return torch.exp(mu + sigma * draws)
    b = math.sqrt(3.0) * std + mean
    a = 2.0 * mean - b
    return a + (b - a) * draws


# ---------------------------------------------------------------------- #
# periodogram fit statistics and information criteria (host, numpy)
# ---------------------------------------------------------------------- #
def chi_cov(powers_data, model_powers=None, inv_cov=None):
    """Uttley+2002 chi^2 with full covariance."""
    d = np.asarray(powers_data) - np.asarray(model_powers)
    return d @ np.asarray(inv_cov) @ d


def chi_log_likehood_nonyq(powers_data, model_pows=None):
    """Whittle statistic, Vaughan+2005 Eq. A.3 / Emmanoulopoulos+2013 A11,
    excluding the Nyquist term."""
    powers_data = np.asarray(powers_data)
    model_pows = np.asarray(model_pows)
    return 2.0 * np.sum(np.log(model_pows) + powers_data / model_pows)


def chi_log_likehood(powers_data, model_pows=None, nyquist=False):
    """Whittle statistic; if ``nyquist`` the last frequency gets the
    chi^2_1 (real-valued Nyquist) contribution."""
    powers_data = np.asarray(powers_data)
    model_pows = np.asarray(model_pows)
    if nyquist:
        ll = chi_log_likehood_nonyq(powers_data[:-1], model_pows[:-1])
        return ll + np.log(np.pi * powers_data[-1] * model_pows[-1]) + 2.0 * powers_data[-1] / model_pows[-1]
    return chi_log_likehood_nonyq(powers_data, model_pows)


def chi_square(powers_data, model_powers=None, sigmas=None):
    """Uttley+2002 chi^2 with per-frequency uncertainties."""
    return np.sum(((np.asarray(model_powers) - np.asarray(powers_data)) / np.asarray(sigmas)) ** 2)


def fit_N(loglikehood, log_like_args=()):
    """Minimize a normalization for the given statistic (host BFGS)."""
    res = minimize(loglikehood, 1, args=log_like_args, method="BFGS")
    return res.x


def chi_square_N(powers_data, model_power=None, std_power=None):
    """Chi-square at the best-fit normalization.

    Kept as the JAX package has it, argument order included: ``fit_N``
    hands ``chi_square`` the normalization as a fourth positional argument,
    so the call raises ``TypeError`` in both packages.  Do not use in new
    code."""
    N = fit_N(chi_square, (powers_data, model_power, std_power))
    return chi_square(N, powers_data, model_power, std_power)


def bic(loglikehood, n, k):
    """Bayesian Information Criterion."""
    return -2.0 * loglikehood + k * np.log(n)


def aic(loglikehood, k):
    """Akaike Information Criterion."""
    return 2 * k - 2 * loglikehood


def aicc(loglikehood, n, k):
    """AIC corrected for finite sample size."""
    return aic(loglikehood, k) + 2 * k * (k + 1) / (n - k - 1)


def neg_log_like(params, y, gp):
    """The negated log-likelihood of ``y`` under ``gp`` (any object with
    ``set_parameter_vector`` and ``log_likelihood(y)``) at ``params``; kept
    for parity with reference stats.py:149."""
    gp.set_parameter_vector(params)
    return -gp.log_likelihood(y)


# ---------------------------------------------------------------------- #
# the Kraft+91 posterior on tensors
# ---------------------------------------------------------------------- #
# CDF(x | N, B) = 1 - Q(N+1, x+B) / Q(N+1, B), with Q the regularized upper
# incomplete gamma function (sum_{n<=N} e^{-B} B^n / n! = Q(N+1, B)).
class _KraftPosterior:
    """log pdf and CDF of the Kraft posterior at (N, B), float64 tensors of
    one shape, with the terms that do not depend on x taken once (the same
    values at the same arguments as the JAX package's ``_kraft_log_pdf``
    and ``_kraft_cdf``, in the same order of operations)."""

    def __init__(self, N, B):
        self.N, self.B = N, B
        self.qB = torch.special.gammaincc(N + 1.0, B)
        self.log_norm = torch.special.gammaln(N + 1.0)
        self.log_qB = torch.log(self.qB)

    def cdf(self, x):
        return 1.0 - torch.special.gammaincc(self.N + 1.0, x + self.B) / self.qB

    def log_pdf(self, x):
        # N log(x+B) with the N = 0 convention 0 log(0) = 0 (pdf = C e^-x)
        log_term = torch.where(self.N > 0, self.N * torch.log(torch.clamp(x + self.B, min=1e-300)), 0.0)
        return -(x + self.B) + log_term - self.log_norm - self.log_qB


def _bisect(f, lo, hi, iters: int = 70):
    """Fixed-iteration bisection for ``f`` increasing in x: solves f(x) = 0
    on [lo, hi], elementwise."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = f(mid) < 0.0
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def _counts_and_background(N, B, device):
    """``N`` and ``B`` as broadcast float64 tensors: on ``N``'s device when
    ``N`` is a tensor, else on ``device``."""
    N = torch.as_tensor(N, dtype=torch.float64, device=N.device if torch.is_tensor(N) else torch.device(device))
    B = torch.as_tensor(B, dtype=torch.float64, device=N.device)
    return torch.broadcast_tensors(N, B)


def kraft_posterior_median(N, B, upper: float = 200.0, device="cuda"):
    """Median of the Kraft posterior at counts ``N`` and background ``B``
    (float64 tensors or arrays that broadcast; on ``N``'s device if it is a
    tensor, else on ``device``): 70 bisection steps of the CDF on
    [0, ``upper``].  On a card, one launch of ``ops.kraft``'s kernel (whole
    counts); elsewhere ``kraft_posterior_median_plain``."""
    N, B = _counts_and_background(N, B, device)
    if N.device.type == "cuda":
        return _kraft_op.kraft_quantities(N, B, upper=upper, hpd=False)[0]
    return kraft_posterior_median_plain(N, B, upper)


def kraft_posterior_median_plain(N, B, upper: float = 200.0):
    """``kraft_posterior_median``'s bisections as eager PyTorch operations
    on float64 tensors ``N`` and ``B`` of one shape, on their device."""
    post = _KraftPosterior(N, B)
    return _bisect(lambda x: post.cdf(x) - 0.5, torch.zeros_like(N), torch.full_like(N, upper))


def kraft_hpd_interval(N, B, cl: float = 0.68, upper: float = 200.0, level_iters: int = 60, device="cuda"):
    """Highest-posterior-density (minimal-width) interval ``(lo, hi)`` of
    the Kraft posterior at confidence ``cl`` (astropy's
    'kraft-burrows-nousek' interval), elementwise over ``N`` and ``B``
    (on ``N``'s device if it is a tensor, else on ``device``).

    The posterior is unimodal with its mode at max(N - B, 0): bisect
    ``level_iters`` times on the density level lambda (the interval's mass
    falls as lambda rises); at each level the ends a <= mode <= b solve
    pdf(x) = lambda by 70-step bisections, a = 0 where pdf(0) < lambda.  The
    two ends run as one bisection on a stacked tensor: b's function is
    a's with its sign flipped, the same numbers as two bisections.  On a
    card, one launch of ``ops.kraft``'s kernel (whole counts); elsewhere
    ``kraft_hpd_interval_plain``."""
    N, B = _counts_and_background(N, B, device)
    if N.device.type == "cuda":
        return tuple(_kraft_op.kraft_quantities(N, B, upper=upper, cl=cl, level_iters=level_iters, median=False))
    return kraft_hpd_interval_plain(N, B, cl, upper, level_iters)


def kraft_hpd_interval_plain(N, B, cl: float = 0.68, upper: float = 200.0, level_iters: int = 60):
    """``kraft_hpd_interval``'s bisections as eager PyTorch operations on
    float64 tensors ``N`` and ``B`` of one shape, on their device."""
    post = _KraftPosterior(N, B)
    zeros = torch.zeros_like(N)
    mode = torch.clamp(N - B, min=0.0)
    log_pmax = post.log_pdf(mode)
    log_p0 = post.log_pdf(zeros)
    sign = torch.tensor([1.0, -1.0], dtype=torch.float64, device=N.device).reshape((2,) + (1,) * N.dim())
    lo_ends = torch.stack([zeros, mode])
    hi_ends = torch.stack([mode, torch.full_like(N, upper)])

    def interval_mass(log_lam):
        ends = _bisect(lambda x: sign * (post.log_pdf(x) - log_lam), lo_ends, hi_ends)
        a = torch.where(log_p0 >= log_lam, 0.0, ends[0])
        b = ends[1]
        return post.cdf(b) - post.cdf(a), a, b

    lo, hi = log_pmax - 60.0, log_pmax  # level -> 0: mass -> 1
    for _ in range(level_iters):
        mid = 0.5 * (lo + hi)
        mass, _, _ = interval_mass(mid)
        too_small = mass < cl  # the level is too high
        lo, hi = torch.where(too_small, lo, mid), torch.where(too_small, mid, hi)
    _, a, b = interval_mass(0.5 * (lo + hi))
    return a, b
