"""What the validation programs share.

- the null-true DRW observing pattern (gaps uniform in [2, 8), errors 0.3,
  mean 10, S0 = 4, omega0 = 0.05) and its null and alternative kernels;
- the exact truth draws: dense Cholesky of the covariance plus the error
  variance, mean + (L z).T from a ``numpy.random.Generator``;
- the batched fits of both models and their T statistics;
- the posterior-predictive simulations: the PSD of the fitted null at each
  theta, repeated ``nsims`` times, drawn and noised on the device;
- the exact bootstrap p-value (1 + #{T_sim >= T_obs}) / (nsims + 1) and
  the KS test of the p-values against Uniform(0, 1).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.stats import kstest

from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, Lorentzian
from mind_the_gaps_tpu_torch.lrt import fit_lightcurves_batch
from mind_the_gaps_tpu_torch.models import psd_models
from mind_the_gaps_tpu_torch.simulator import Simulator

SIGMA = 0.3
MEAN = 10.0
TRUE_S0, TRUE_W0 = 4.0, 0.05
DRW_BOUNDS = [(-5, 8), (-8, 2)]
QPO_BOUNDS = [(-8, 5), (0, 6), (-5, 0)]
# the production plateau rule of the refits: (tol, patience)
EARLY_STOP = (0.01, 50)
# the seeds of the batched programs: observed null / alternative fits,
# generation, noise, null / alternative refits
SEED_OBS_NULL, SEED_OBS_ALT, SEED_GEN, SEED_NOISE, SEED_SIM_NULL, SEED_SIM_ALT = 1, 2, 4, 5, 6, 7


def observing_pattern(rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` irregular times, the gaps uniform in [2, 8)."""
    return np.cumsum(rng.uniform(2.0, 8.0, n))


def null_kernel():
    return DampedRandomWalk(np.log(TRUE_S0), np.log(TRUE_W0), bounds=DRW_BOUNDS)


def alt_kernel(log_q: float = 2.0, log_wqpo: float = -1.5):
    return null_kernel() + Lorentzian(-1.0, log_q, log_wqpo, bounds=QPO_BOUNDS)


def covariance(kernel, times) -> np.ndarray:
    """The (n, n) float64 covariance k(|t_i - t_j|) of ``kernel`` at its
    parameter vector."""
    tau = np.abs(times[:, None] - times[None, :])
    return kernel.covariance(tau).numpy()


def truth_factor(cov: np.ndarray, noise_var: float = SIGMA**2) -> np.ndarray:
    """The Cholesky factor of ``cov`` plus the error variance."""
    return np.linalg.cholesky(cov + np.diag(np.full(len(cov), noise_var)))


def truth_draws(rng: np.random.Generator, factor: np.ndarray, k=None, mean: float = MEAN) -> np.ndarray:
    """Exact Gaussian draws ``mean + (factor @ z).T``: (k, n) from z of
    shape (n, k), or one (n,) draw when ``k`` is None."""
    n = factor.shape[0]
    return mean + (factor @ rng.normal(size=n if k is None else (n, k))).T


def t_statistics(null, alt, times, ys, dys, seeds, walkers, steps, early_stop, device, chunk=512):
    """T = -2 (logL_null - logL_alt) of each row of ``ys`` by the batched
    float32 fits of both models (``fit_lightcurves_batch``, seeded
    ``seeds[0]`` and ``seeds[1]``); returns (T (B,), the null optima (B, D))."""
    kw = dict(walkers=walkers, n_steps=steps, dtype=torch.float32, early_stop=early_stop, chunk=chunk,
              device=device)
    ll0, best_null = fit_lightcurves_batch(null, times, ys, dys, null.get_parameter_vector(), seed=seeds[0], **kw)
    ll1, _ = fit_lightcurves_batch(alt, times, ys, dys, alt.get_parameter_vector(), seed=seeds[1], **kw)
    return -2.0 * (ll0.astype(float) - ll1.astype(float)), best_null


def simulator(times, pdf: str, random_state: int, device) -> Simulator:
    """The posterior-predictive simulator of the validation programs: the
    true bending power law, exposures 1, mean 10, Gaussian errors of
    ``SIGMA``, a grid twice the observation."""
    return Simulator(psd_models.BendingPowerlaw(S0=TRUE_S0, omega0=TRUE_W0), times, 1.0, MEAN, pdf,
                     sigma_noise=SIGMA, extension_factor=2, random_state=random_state, device=device)


def psd_batch(kernel, omega, thetas, repeats: int, device) -> torch.Tensor:
    """(B * repeats, n_freq) float64 PSDs on ``device``: ``kernel``'s PSD at
    each of the B rows of ``thetas`` over ``omega[1:]``, a zero at
    ``omega[0]``, each row repeated ``repeats`` times in place."""
    om = torch.as_tensor(np.asarray(omega[1:]), dtype=torch.float64, device=device)
    vals = kernel.get_psd(om, torch.as_tensor(np.asarray(thetas), dtype=torch.float64, device=device))
    psd = torch.cat([vals.new_zeros((vals.shape[0], 1)), vals], dim=1)
    return psd.repeat_interleave(repeats, dim=0)


def posterior_predictive(sim: Simulator, kernel, best_null, nsims: int, device):
    """``nsims`` noisy lightcurves from each fitted null theta: numpy
    (rates (B * nsims, n), dy (B * nsims, n))."""
    psd = psd_batch(kernel, sim.omega, best_null, nsims, device)
    rates = sim.simulate_batch(psd, generator=torch.Generator(device).manual_seed(SEED_GEN))
    noisy, dy = sim.add_noise_batch(rates, generator=torch.Generator(device).manual_seed(SEED_NOISE))
    return noisy.cpu().numpy(), dy.cpu().numpy()


def bootstrap_pvalues(t_obs, t_sim) -> np.ndarray:
    """The exact p-value of each T_obs against its nsims simulated T (the
    last axis of ``t_sim``): (1 + #{T_sim >= T_obs}) / (nsims + 1)."""
    t_obs, t_sim = np.asarray(t_obs), np.asarray(t_sim)
    return (1.0 + np.sum(t_sim >= t_obs[..., None], axis=-1)) / (t_sim.shape[-1] + 1.0)


def ks_uniform(p):
    """(D, p-value) of the KS test of ``p`` against Uniform(0, 1)."""
    ks = kstest(np.asarray(p), "uniform")
    return float(ks.statistic), float(ks.pvalue)
