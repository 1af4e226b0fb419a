"""Analytic power-spectral-density models.

PyTorch port of ``mind_the_gaps_tpu/models/psd_models.py``: each model is a
small callable with named, settable parameters (so
``Simulator.set_psd_params`` works) that evaluates a tensor, or anything
``torch.as_tensor`` takes, of angular frequencies and returns a tensor.

All PSDs are over angular frequency and carry celerite's sqrt(2/pi)
normalization, so that integrating over positive angular frequencies gives
the variance.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "PSDModel",
    "SHO",
    "Lorentzian",
    "BendingPowerlaw",
    "Matern",
    "Matern32",
    "Matern52",
    "Jitter",
    "PowerLaw",
    "BrokenPowerLaw",
]

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


class PSDModel:
    """Callable PSD with named parameters stored as attributes."""

    parameter_names: tuple = ()
    _defaults: dict = {}

    def __init__(self, *args, **kwargs):
        values = dict(zip(self.parameter_names, args))
        values.update(kwargs)
        for name in self.parameter_names:
            setattr(self, name, float(values.get(name, self._defaults[name])))

    def __call__(self, x):
        raise NotImplementedError

    def __add__(self, other):
        return _SumPSD(self, other)

    def __repr__(self):
        args = ", ".join(f"{n}={getattr(self, n):.6g}" for n in self.parameter_names)
        return f"{type(self).__name__}({args})"


class _SumPSD:
    def __init__(self, a, b):
        self.parts = (a, b)

    def __call__(self, x):
        return self.parts[0](x) + self.parts[1](x)

    def __add__(self, other):
        return _SumPSD(self, other)


class SHO(PSDModel):
    """Eq. 20 of Foreman-Mackey+2017."""

    parameter_names = ("S0", "Q", "omega0")
    _defaults = {"S0": 1.0, "Q": 10.0, "omega0": 1.0}

    def __call__(self, x):
        x = torch.as_tensor(x)
        return (
            _SQRT_2_OVER_PI
            * self.S0
            * self.omega0**4
            / ((x**2 - self.omega0**2) ** 2 + x**2 * self.omega0**2 / self.Q**2)
        )


class Lorentzian(PSDModel):
    """Eq. 11 of Foreman-Mackey+2017."""

    parameter_names = ("S0", "Q", "omega0")
    _defaults = {"S0": 1.0, "Q": 10.0, "omega0": 1.0}

    def __call__(self, x):
        x = torch.as_tensor(x)
        a = self.S0
        c = self.omega0 / 2.0 / self.Q
        return (
            math.sqrt(1.0 / 2.0 / math.pi)
            * a
            / c
            * (1.0 / (1.0 + ((x - self.omega0) / c) ** 2) + 1.0 / (1.0 + ((x + self.omega0) / c) ** 2))
        )


class BendingPowerlaw(PSDModel):
    """PSD of a DampedRandomWalk."""

    parameter_names = ("S0", "omega0", "Q")
    _defaults = {"S0": 1.0, "omega0": 1.0, "Q": 0.5}

    def __call__(self, x):
        x = torch.as_tensor(x)
        c = 0.5 * self.omega0 / self.Q
        return _SQRT_2_OVER_PI * self.S0 / c * (1.0 / (1.0 + (x / c) ** 2))


def Matern(x, sigma: float = 1, rho: float = 1, n: int = 1, nu=3 / 2):
    """Generalized Matern PSD."""
    x = torch.as_tensor(x)
    gamma = lambda z: math.exp(math.lgamma(z))  # noqa: E731
    return (
        1.0
        / math.sqrt(2 * math.pi)
        * sigma**2
        * 2**n
        * math.pi ** (n / 2)
        * gamma(nu + n / 2)
        * (2 * nu) ** nu
        / (gamma(nu) * rho ** (2 * nu))
        * (2 * nu / rho**2 + x**2) ** -(nu + n / 2)
    )


class Matern32(PSDModel):
    """Matern-3/2 PSD."""

    parameter_names = ("sigma", "rho", "n")
    _defaults = {"sigma": 1.0, "rho": 1.0, "n": 1.0}

    def __call__(self, x):
        x = torch.as_tensor(x)
        return (
            1.0
            / math.sqrt(2 * math.pi)
            * self.sigma**2
            * 4.0
            / math.sqrt(3.0)
            * self.rho
            * (1.0 / (1.0 + (x * self.rho / math.sqrt(3.0)) ** 2)) ** 2
        )


class Matern52(PSDModel):
    """Matern-5/2 PSD."""

    parameter_names = ("sigma", "rho")
    _defaults = {"sigma": 1.0, "rho": 1.0}

    def __call__(self, x):
        x = torch.as_tensor(x)
        return (
            1.0
            / math.sqrt(2 * math.pi)
            * self.sigma**2
            * 16.0
            / 3.0
            / math.sqrt(5.0)
            * self.rho
            * (1.0 / (1.0 + (x * self.rho / math.sqrt(5.0)) ** 2)) ** 3
        )


class Jitter(PSDModel):
    """White-noise PSD with the celerite-consistent dilution factors (the
    sqrt(2 pi), df and N factors make its integral tend to sigma^2)."""

    parameter_names = ("sigma",)
    _defaults = {"sigma": 1.0}

    def __call__(self, x):
        x = torch.as_tensor(x)
        N = x.shape[-1]
        df = x[1] - x[0]
        normalization_factor = 2.0 / math.sqrt(2 * math.pi)
        return torch.ones(N, dtype=x.dtype, device=x.device) * self.sigma**2 / normalization_factor / df / N


class PowerLaw(PSDModel):
    """amplitude * (x / x_0)^-alpha (astropy's PowerLaw1D)."""

    parameter_names = ("amplitude", "x_0", "alpha")
    _defaults = {"amplitude": 1.0, "x_0": 1.0, "alpha": 1.0}

    def __call__(self, x):
        x = torch.as_tensor(x)
        return self.amplitude * (x / self.x_0) ** (-self.alpha)


class BrokenPowerLaw(PSDModel):
    """Two-slope broken power law (astropy's BrokenPowerLaw1D)."""

    parameter_names = ("amplitude", "x_break", "alpha_1", "alpha_2")
    _defaults = {"amplitude": 1.0, "x_break": 1.0, "alpha_1": 1.0, "alpha_2": 2.0}

    def __call__(self, x):
        x = torch.as_tensor(x)
        alpha = torch.where(x < self.x_break, x.new_tensor(self.alpha_1), x.new_tensor(self.alpha_2))
        return self.amplitude * (x / self.x_break) ** (-alpha)
