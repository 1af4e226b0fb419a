"""Flux-PDF distributions for the Emmanoulopoulos+13 (E13) simulation.

PyTorch port of the sampling part of ``mind_the_gaps_tpu/stats.py``:

- ``create_log_normal`` / ``create_uniform_distribution``: the
  moment-matched scipy distributions (copied, scipy only);
- ``sample_pdf``: moment-matched draws of the target flux PDF on tensors,
  from a ``torch.Generator`` or from given standard draws (normals for the
  lognormal and the Gaussian, uniforms on [0, 1) for the uniform), so a
  test can give both packages the same random numbers.

The Kraft+91 posterior median and HPD interval are not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from scipy.stats import lognorm, uniform

__all__ = ["create_log_normal", "create_uniform_distribution", "sample_pdf"]


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


def sample_pdf(pdf: str, mean, std, shape, generator: Optional[torch.Generator] = None, draws=None):
    """Moment-matched draws of ``shape`` from the flux PDF ``pdf``
    ('gaussian' | 'lognormal' | 'uniform'), matched in mean and std.

    ``mean`` and ``std`` are floats or tensors that broadcast against
    ``shape`` (per-row values as (B, 1)).  ``draws`` replaces the standard
    draws from ``generator``; without it they are float64 on ``std``'s
    device when ``std`` is a tensor, else on the generator's device.
    """
    pdf = pdf.lower()
    if pdf not in ("gaussian", "lognormal", "uniform"):
        raise ValueError("pdf must be one of 'gaussian', 'lognormal', 'uniform'")
    if draws is None:
        device = std.device if torch.is_tensor(std) else (generator.device if generator is not None else None)
        draw = torch.rand if pdf == "uniform" else torch.randn
        draws = draw(tuple(shape), generator=generator, dtype=torch.float64, device=device)
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
