"""Mean models for the GP.

PyTorch port of ``mind_the_gaps_tpu/models/mean_models.py``: static
structure (names, bounds, values as numpy) plus ``value(t, theta)`` on
tensors.  ``theta`` is ``(D,)`` or a batch ``(..., D)``, which gives
curves ``(..., N)`` (one a walker in the sampler); ``log_prior`` takes
both too.  ``value`` computes in ``t``'s dtype and device.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "MeanModel",
    "ConstantModel",
    "LinearModel",
    "GaussianModel",
    "SineModel",
    "TwoSineModel",
    "LensingProfile",
]


class MeanModel:
    parameter_names: Tuple[str, ...] = ()

    def __init__(self, *args, bounds: Optional[Sequence[Tuple]] = None, **kwargs):
        values = dict(zip(self.parameter_names, args))
        values.update(kwargs)
        missing = [n for n in self.parameter_names if n not in values]
        if missing:
            raise TypeError(f"Missing parameters {missing} for {type(self).__name__}")
        self._values = np.array([float(values[n]) for n in self.parameter_names])
        if bounds is None:
            bounds = [(None, None)] * len(self.parameter_names)
        self._bounds = [
            (-np.inf if lo is None else float(lo), np.inf if hi is None else float(hi))
            for lo, hi in bounds
        ]
        self._bound_tensors = {}  # (dtype, device) -> (lo, hi), made once for each

    @property
    def ndim(self) -> int:
        return len(self.parameter_names)

    def get_parameter_names(self):
        return tuple(self.parameter_names)

    def get_parameter_vector(self):
        return self._values.copy()

    def set_parameter_vector(self, theta):
        self._values = np.asarray(theta, dtype=float).copy()

    def get_parameter_bounds(self):
        return list(self._bounds)

    def log_prior(self, theta=None):
        theta = torch.as_tensor(self._values if theta is None else theta)
        key = (theta.dtype, theta.device)  # made at every call, the bounds would be a copy from the host
        both = self._bound_tensors.get(key)
        if both is None:
            both = self._bound_tensors[key] = tuple(theta.new_tensor([b[i] for b in self._bounds]) for i in (0, 1))
        lo, hi = both
        inside = torch.all((theta >= lo) & (theta <= hi), dim=-1)
        return torch.where(inside, theta.new_zeros(()), theta.new_full((), -math.inf))

    def value(self, t, theta):
        raise NotImplementedError


def _columns(t, theta, n):
    """``t`` as a tensor and the first ``n`` parameters of ``theta`` (..., D)
    as (..., 1) columns in ``t``'s dtype and device."""
    t = torch.as_tensor(t)
    theta = torch.as_tensor(theta, dtype=t.dtype, device=t.device)
    return t, [theta[..., i : i + 1] for i in range(n)]


class ConstantModel(MeanModel):
    parameter_names = ("value",)

    def value(self, t, theta):
        t, (c,) = _columns(t, theta, 1)
        return c.expand(c.shape[:-1] + t.shape)


class LinearModel(MeanModel):
    """slope * t + intercept."""

    parameter_names = ("slope", "intercept")

    def value(self, t, theta):
        t, (slope, intercept) = _columns(t, theta, 2)
        return slope * t + intercept


class GaussianModel(MeanModel):
    """Gaussian bump + constant; the 3-parameter form fixes the constant
    at 0 (as in the JAX package)."""

    parameter_names = ("mean", "sigma", "amplitude", "constant")

    def __init__(self, *args, bounds: Optional[Sequence[Tuple]] = None, **kwargs):
        if len(args) < 4 and "constant" not in kwargs:
            self.parameter_names = ("mean", "sigma", "amplitude")
        super().__init__(*args, bounds=bounds, **kwargs)

    def value(self, t, theta):
        t, cols = _columns(t, theta, len(self.parameter_names))
        mean, sigma, amplitude = cols[:3]
        constant = cols[3] if len(cols) == 4 else 0.0
        return (
            amplitude / (2 * math.pi * sigma) * torch.exp(-((t - mean) ** 2) / (2 * sigma**2))
            + constant
        )


class SineModel(MeanModel):
    parameter_names = ("constant", "amplitude", "frequency", "phase")

    def value(self, t, theta):
        t, (c, a, f, ph) = _columns(t, theta, 4)
        return c + a * torch.sin(f * t + ph)


class TwoSineModel(MeanModel):
    parameter_names = ("constant", "amplitude0", "phase0", "amplitude1", "phase1", "frequency")

    def value(self, t, theta):
        t, (c, a0, p0, a1, p1, f) = _columns(t, theta, 6)
        return c + a0 * torch.sin(f * t + p0) + a1 * torch.sin(2 * f * t + p1)


class LensingProfile(MeanModel):
    """Placeholder the reference ships unimplemented (returns NaN)."""

    parameter_names = ("lense_mass", "stellar_mass")

    def value(self, t, theta):
        t, (m,) = _columns(t, theta, 1)
        return torch.full(m.shape[:-1] + t.shape, math.nan, dtype=t.dtype, device=t.device)
