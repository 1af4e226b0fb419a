"""Observational noise models on tensors.

PyTorch port of ``mind_the_gaps_tpu/simulator/noise.py``.  Each model has
two entry points:

- ``add_noise_torch(rates, generator, counts=None)``: the batched path,
  ``rates`` of shape (..., N) on any device, draws from ``generator``;
  ``counts`` (Poisson models) replaces the Poisson draw of the total
  counts, so a test can give both packages the same draws;
- ``add_noise(rates)``: the host API, numpy in and out, drawing from the
  model's own generator on its ``device`` (``seed`` reseeds it).

``KraftNoise`` replaces low-count bins by the Kraft+91 posterior median
and HPD half-width.  Both depend only on the bin's counts N and its
background B, B is fixed for the model and a low bin's N is an integer
below ``kraft_counts``, so the model tabulates them once, per bin, for
N = 0..ceil(kraft_counts), on its device when it is built
(``stats.kraft_posterior_median`` / ``kraft_hpd_interval``); a draw then
gathers from the tables: the same function at the same arguments as the
JAX package's elementwise evaluation.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from mind_the_gaps_tpu_torch.stats import kraft_hpd_interval, kraft_posterior_median

__all__ = ["BaseNoise", "PoissonNoise", "KraftNoise", "GaussianNoise", "kraft_tables"]


class BaseNoise:
    def __init__(self, name: str, device="cuda"):
        self.name = name
        self.device = torch.device(device)
        self._seed = int(np.random.SeedSequence().entropy % (2**63))
        self._generator = None  # made at first use, on the device

    def seed(self, seed: int) -> None:
        """Reseed the generator of the host API ``add_noise``."""
        self._seed = int(seed)
        self._generator = None

    def add_noise(self, rates):
        """Host API: (noisy rates, dy) numpy arrays of ``rates``' shape."""
        if self._generator is None:
            self._generator = torch.Generator(self.device).manual_seed(self._seed)
        r = torch.as_tensor(np.asarray(rates, dtype=np.float64), device=self.device)
        noisy, dy = self.add_noise_torch(r, self._generator)
        return noisy.cpu().numpy(), dy.cpu().numpy()

    def add_noise_torch(self, rates, generator: Optional[torch.Generator] = None):
        raise NotImplementedError


class PoissonNoise(BaseNoise):
    """Poisson counting noise with optional background: draw total counts,
    subtract the background, errors sqrt(counts)/exposure (+ bkg err)."""

    def __init__(self, exposures, background_counts=None, bkg_rate_err=None, device="cuda"):
        super().__init__(name="Poisson", device=device)
        self.exposures = np.asarray(exposures, dtype=float)
        n = len(self.exposures)
        self.background_counts = (
            np.zeros(n) if background_counts is None else np.asarray(background_counts, dtype=float)
        )
        self.bkg_rate_err = np.zeros(n) if bkg_rate_err is None else np.asarray(bkg_rate_err, dtype=float)

    def add_noise_torch(self, rates, generator: Optional[torch.Generator] = None, counts=None):
        """``counts``: the Poisson-drawn total counts (``rates``' shape),
        else drawn from ``generator``."""
        def tens(x):
            return torch.as_tensor(x, dtype=rates.dtype, device=rates.device)

        exposures, bkg, bkg_err = tens(self.exposures), tens(self.background_counts), tens(self.bkg_rate_err)
        if counts is None:
            total_counts = rates * exposures + bkg
            counts = torch.poisson(torch.clamp(total_counts, min=0.0), generator=generator)
        total_poiss = tens(counts)
        net_counts = total_poiss - bkg
        dy = torch.sqrt((torch.sqrt(total_poiss) / exposures) ** 2 + bkg_err**2)
        return net_counts / exposures, dy


class KraftNoise(PoissonNoise):
    """Poisson noise with the Kraft+91 treatment of low-count bins.

    Bins whose Poisson-drawn total counts fall below ``kraft_counts`` get:
    - rate = the posterior median of the Kraft pdf (N = round(total), B =
      the bin's background counts),
    - dy = half the width of the 68% minimal (HPD) interval (N =
      trunc(total)),
    both clipped at N = 0, as in the JAX package.  The tables of both are
    built on ``device`` at construction (``kraft_tables``).  ``bins_drawn``
    counts the bins ``kraft_step`` has seen and ``bins_replaced`` (a device
    scalar, read without a sync until the caller wants it) those it
    replaced."""

    def __init__(self, exposures, background_counts=None, bkg_rate_err=None, kraft_counts: float = 15,
                 device="cuda"):
        super().__init__(exposures, background_counts, bkg_rate_err, device=device)
        self.name = "Kraft"
        self.kraft_counts = kraft_counts
        self.max_count = max(int(math.ceil(kraft_counts)), 0)
        self.median_table, self.lo_table, self.hi_table = kraft_tables(
            self.background_counts, self.max_count, self.device)
        self.bins_drawn = 0
        self.bins_replaced = torch.zeros((), dtype=torch.int64, device=self.device)

    def add_noise_torch(self, rates, generator: Optional[torch.Generator] = None, counts=None):
        net_rates, dy = super().add_noise_torch(rates, generator, counts)
        return self.kraft_step(net_rates, dy)

    def kraft_step(self, net_rates, dy):
        """The Kraft replacement of ``PoissonNoise``'s (net rates, dy): a
        deterministic function of the drawn counts, which it recovers as
        net rate * exposure + background (the JAX package's arithmetic)."""
        if net_rates.device != self.median_table.device:
            raise ValueError(f"KraftNoise was built on {self.median_table.device}, not {net_rates.device}")

        def tens(x):
            return torch.as_tensor(x, dtype=net_rates.dtype, device=net_rates.device)

        exposures, bkg = tens(self.exposures), tens(self.background_counts)
        total_counts = net_rates * exposures + bkg
        low = total_counts < self.kraft_counts
        self.bins_drawn += low.numel()
        self.bins_replaced = self.bins_replaced + low.sum()
        cols = torch.arange(total_counts.shape[-1], device=net_rates.device)
        # medians use rounded counts, intervals truncated ones
        n_med = torch.clamp(torch.round(total_counts), 0, self.max_count).long()
        n_int = torch.clamp(torch.trunc(total_counts), 0, self.max_count).long()
        med = self.median_table[n_med, cols].to(net_rates.dtype)
        lo = self.lo_table[n_int, cols].to(net_rates.dtype)
        hi = self.hi_table[n_int, cols].to(net_rates.dtype)
        net_rates = torch.where(low, med / exposures, net_rates)
        dy = torch.where(low, (hi - lo) / 2.0 / exposures, dy)
        return net_rates, dy


def kraft_tables(background_counts, max_count: int, device="cuda"):
    """(median, hpd lo, hpd hi) float64 tables of shape (max_count + 1, n)
    on ``device``: row N, column i holds the Kraft quantities at N counts
    and bin i's background."""
    device = torch.device(device)
    B = torch.as_tensor(np.asarray(background_counts, dtype=np.float64), device=device)[None, :]
    N = torch.arange(max_count + 1, dtype=torch.float64, device=device)[:, None]
    N, B = torch.broadcast_tensors(N, B)
    lo, hi = kraft_hpd_interval(N, B, cl=0.68)
    return kraft_posterior_median(N, B), lo, hi


class GaussianNoise(BaseNoise):
    """Additive white Gaussian noise of fixed sigma."""

    def __init__(self, exposures, sigma_noise: float, device="cuda"):
        super().__init__(name="Gaussian", device=device)
        self.exposures = exposures
        self.sigma_noise = float(sigma_noise)

    def add_noise_torch(self, rates, generator: Optional[torch.Generator] = None):
        eps = torch.randn(rates.shape, generator=generator, dtype=rates.dtype, device=rates.device)
        return rates + self.sigma_noise * eps, torch.full_like(rates, self.sigma_noise)
