"""Celerite-style kernel terms as functions of a flat parameter tensor.

A celerite kernel is a sum of exponential-(co)sinusoid terms

    k(tau) = sum_r  a_r exp(-c_r tau)
           + sum_c  exp(-c_c tau) * (a_c cos(d_c tau) + b_c sin(d_c tau))

(tau = |t_i - t_j|), whose covariance matrices are semiseparable and admit
an O(N) Cholesky factorization (Foreman-Mackey et al. 2017).

PyTorch port of ``mind_the_gaps_tpu/kernels/terms.py``.  A term holds its
parameter names, bounds and current values (numpy); every numerical
quantity is a function of a parameter tensor ``theta`` of shape ``(D,)``
or ``(..., D)``: a leading batch of parameter draws (walkers x
simulations) gives coefficients of shape ``(..., J)``, priors and jitters
of shape ``(...)``.  The dtype and device of ``theta`` select those of the
results.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "Coefficients",
    "Term",
    "TermSum",
    "RealTerm",
    "ComplexTerm",
    "SHOTerm",
    "Matern32Term",
    "JitterTerm",
    "Lorentzian",
    "Cosinus",
    "DampedRandomWalk",
    "BendingPowerlaw",
]

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


class Coefficients(NamedTuple):
    """Celerite coefficients: ``(ar, cr)`` of shape ``(..., Jr)`` for real
    terms and ``(ac, bc, cc, dc)`` of shape ``(..., Jc)`` for complex ones."""

    ar: torch.Tensor
    cr: torch.Tensor
    ac: torch.Tensor
    bc: torch.Tensor
    cc: torch.Tensor
    dc: torch.Tensor


def _as_theta(theta, values):
    if theta is None:
        return torch.as_tensor(values, dtype=torch.float64)
    return torch.as_tensor(theta)


def _bcast(x, ref):
    """``x`` (a tensor or a Python number) broadcast to ``ref``'s shape,
    dtype and device."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device).expand(ref.shape)


class Term:
    """Base class: subclasses define ``parameter_names`` and
    ``_real(theta)`` / ``_complex(theta)``, which return tuples of tensors
    of the batch shape ``theta.shape[:-1]``."""

    parameter_names: Tuple[str, ...] = ()

    def __init__(self, *args, bounds: Optional[Sequence[Tuple]] = None, **kwargs):
        values = dict(zip(self.parameter_names, args))
        for name in self.parameter_names[len(args):]:
            if name in kwargs:
                values[name] = kwargs.pop(name)
        unknown = set(kwargs) - set(self.parameter_names)
        if unknown:
            raise TypeError(f"Unknown parameters {sorted(unknown)} for {type(self).__name__}")
        values.update(kwargs)
        missing = [n for n in self.parameter_names if n not in values]
        if missing:
            raise TypeError(f"Missing parameters {missing} for {type(self).__name__}")
        self._values = np.array([float(values[n]) for n in self.parameter_names])
        if bounds is None:
            bounds = [(None, None)] * len(self.parameter_names)
        if len(bounds) != len(self.parameter_names):
            raise ValueError("bounds must have one (low, high) pair per parameter")
        self._bounds = [
            (-np.inf if lo is None else float(lo), np.inf if hi is None else float(hi))
            for lo, hi in bounds
        ]
        self._bound_tensors = {}  # (dtype, device) -> (lo, hi), made once for each

    # ------------------------------------------------------------------ #
    # static structure
    # ------------------------------------------------------------------ #
    @property
    def ndim(self) -> int:
        return len(self.parameter_names)

    @property
    def terms(self) -> Tuple["Term", ...]:
        return (self,)

    def get_parameter_names(self) -> Tuple[str, ...]:
        return tuple(self.parameter_names)

    def get_parameter_vector(self) -> np.ndarray:
        return self._values.copy()

    def set_parameter_vector(self, theta) -> None:
        theta = np.asarray(theta, dtype=float)
        if theta.shape != (self.ndim,):
            raise ValueError(f"expected parameter vector of shape ({self.ndim},)")
        self._values = theta.copy()

    def get_parameter_bounds(self):
        return list(self._bounds)

    def __add__(self, other: "Term") -> "TermSum":
        return TermSum(self.terms + other.terms)

    # ------------------------------------------------------------------ #
    # numerics
    # ------------------------------------------------------------------ #
    def _real(self, theta):
        return (), ()

    def _complex(self, theta):
        return (), (), (), ()

    def coefficients(self, theta=None) -> Coefficients:
        theta = _as_theta(theta, self._values)
        ar, cr = self._real(theta)
        ac, bc, cc, dc = self._complex(theta)
        batch = theta.shape[:-1]

        def _stack(vals):
            if len(vals) == 0:
                return theta.new_zeros(batch + (0,))
            return torch.stack([_bcast(v, theta[..., 0]) for v in vals], dim=-1)

        return Coefficients(_stack(ar), _stack(cr), _stack(ac), _stack(bc), _stack(cc), _stack(dc))

    def jitter(self, theta=None):
        """White-noise (diagonal) variance contributed by this term."""
        theta = _as_theta(theta, self._values)
        return theta.new_zeros(theta.shape[:-1])

    def log_prior(self, theta=None):
        """Celerite convention: flat prior, 0 inside bounds, -inf outside."""
        theta = _as_theta(theta, self._values)
        lo, hi = self._bounds_like(theta)
        inside = torch.all((theta >= lo) & (theta <= hi), dim=-1)
        return torch.where(inside, theta.new_zeros(()), theta.new_full((), -math.inf))

    def _bounds_like(self, theta):
        """(lo, hi): the bounds as tensors of ``theta``'s dtype and device,
        made once for each.  Made at every call, they would be a copy from
        the host, which on a card waits for the stream to drain."""
        key = (theta.dtype, theta.device)
        both = self._bound_tensors.get(key)
        if both is None:
            both = self._bound_tensors[key] = tuple(theta.new_tensor([b[i] for b in self._bounds]) for i in (0, 1))
        return both

    def psd(self, omega, theta=None):
        """Celerite PSD over angular frequency, sqrt(2/pi) normalization.

        ``omega`` (M,) with ``theta`` (..., D) gives (..., M)."""
        theta = _as_theta(theta, self._values)
        omega = torch.as_tensor(omega, dtype=theta.dtype, device=theta.device)
        c = self.coefficients(theta)
        w2 = (omega**2)[:, None]  # (M, 1) against coefficients (..., 1, J)
        p = theta.new_zeros(theta.shape[:-1] + omega.shape)
        if c.ar.shape[-1]:
            ar, cr = c.ar.unsqueeze(-2), c.cr.unsqueeze(-2)
            p = p + torch.sum(ar * cr / (cr**2 + w2), dim=-1)
        if c.ac.shape[-1]:
            a, b, cc_, d = (x.unsqueeze(-2) for x in (c.ac, c.bc, c.cc, c.dc))
            c2pd2 = cc_**2 + d**2
            num = (a * cc_ + b * d) * c2pd2 + (a * cc_ - b * d) * w2
            den = w2**2 + 2.0 * (cc_**2 - d**2) * w2 + c2pd2**2
            p = p + torch.sum(num / den, dim=-1)
        return _SQRT_2_OVER_PI * p

    def get_psd(self, omega, theta=None):
        """Alias matching the celerite API."""
        return self.psd(omega, theta)

    def covariance(self, tau, theta=None):
        """k(|tau|) without jitter; ``theta`` (..., D) and ``tau`` of any
        shape S give (..., *S)."""
        theta = _as_theta(theta, self._values)
        tau = torch.as_tensor(tau, dtype=theta.dtype, device=theta.device).abs()
        c = self.coefficients(theta)
        t = tau[..., None]

        def lift(x):  # (..., J) -> (..., 1 x tau.ndim, J)
            return x.reshape(x.shape[:-1] + (1,) * tau.ndim + x.shape[-1:])

        k = theta.new_zeros(theta.shape[:-1] + tau.shape)
        if c.ar.shape[-1]:
            k = k + torch.sum(lift(c.ar) * torch.exp(-lift(c.cr) * t), dim=-1)
        if c.ac.shape[-1]:
            ac, bc, cc, dc = (lift(x) for x in (c.ac, c.bc, c.cc, c.dc))
            k = k + torch.sum(
                torch.exp(-cc * t) * (ac * torch.cos(dc * t) + bc * torch.sin(dc * t)), dim=-1
            )
        return k

    def variance(self, theta=None):
        """k(0) without jitter, the sum of the a_r and a_c: a tensor of the
        batch shape ``theta.shape[:-1]``."""
        c = self.coefficients(theta)
        return c.ar.sum(-1) + c.ac.sum(-1)

    def __repr__(self):
        args = ", ".join(f"{n}={v:.6g}" for n, v in zip(self.parameter_names, self._values))
        return f"{type(self).__name__}({args})"


class TermSum(Term):
    """Sum of terms; the parameter vector is the concatenation in order."""

    def __init__(self, terms: Sequence[Term]):
        self._terms = tuple(terms)
        self.parameter_names = tuple(
            f"terms[{i}]:{name}" for i, t in enumerate(self._terms) for name in t.parameter_names
        )
        self._values = np.concatenate([t._values for t in self._terms])
        self._bounds = [b for t in self._terms for b in t._bounds]

    @property
    def terms(self) -> Tuple[Term, ...]:
        return self._terms

    def set_parameter_vector(self, theta) -> None:
        super().set_parameter_vector(theta)
        for t, sub in zip(self._terms, self._split(np.asarray(theta))):
            t.set_parameter_vector(np.asarray(sub))

    def _split(self, theta):
        out, i = [], 0
        for t in self._terms:
            out.append(theta[..., i : i + t.ndim])
            i += t.ndim
        return out

    def coefficients(self, theta=None) -> Coefficients:
        theta = _as_theta(theta, self._values)
        parts = [t.coefficients(sub) for t, sub in zip(self._terms, self._split(theta))]
        return Coefficients(
            *(torch.cat([getattr(p, f) for p in parts], dim=-1) for f in Coefficients._fields)
        )

    def jitter(self, theta=None):
        theta = _as_theta(theta, self._values)
        return sum(t.jitter(sub) for t, sub in zip(self._terms, self._split(theta)))

    def log_prior(self, theta=None):
        theta = _as_theta(theta, self._values)
        return sum(t.log_prior(sub) for t, sub in zip(self._terms, self._split(theta)))

    def __repr__(self):
        return " + ".join(repr(t) for t in self._terms)


# ---------------------------------------------------------------------- #
# celerite built-in equivalents
# ---------------------------------------------------------------------- #
class RealTerm(Term):
    """a * exp(-c tau) (celerite RealTerm)."""

    parameter_names = ("log_a", "log_c")

    def _real(self, theta):
        return (torch.exp(theta[..., 0]),), (torch.exp(theta[..., 1]),)


class ComplexTerm(Term):
    """exp(-c tau) (a cos(d tau) + b sin(d tau)) (celerite ComplexTerm);
    3 parameters (b fixed to 0) or 4."""

    def __init__(self, *args, bounds=None, **kwargs):
        nargs = len(args) + len([k for k in kwargs if k.startswith("log_")])
        if nargs == 3 and "log_b" not in kwargs:
            self.parameter_names = ("log_a", "log_c", "log_d")
        else:
            self.parameter_names = ("log_a", "log_b", "log_c", "log_d")
        super().__init__(*args, bounds=bounds, **kwargs)

    def _complex(self, theta):
        if len(self.parameter_names) == 3:
            a, c, d = (torch.exp(theta[..., i]) for i in range(3))
            b = torch.zeros_like(a)
        else:
            a, b, c, d = (torch.exp(theta[..., i]) for i in range(4))
        return (a,), (b,), (c,), (d,)


class SHOTerm(Term):
    """Stochastically-driven damped harmonic oscillator (celerite SHOTerm).

    Fixed widths, 2 real + 1 complex slots: the inactive branch (over- vs
    under-damped) is masked to zero coefficients, as in the JAX package."""

    parameter_names = ("log_S0", "log_Q", "log_omega0")

    def _coeffs(self, theta):
        S0 = torch.exp(theta[..., 0])
        Q = torch.exp(theta[..., 1])
        w0 = torch.exp(theta[..., 2])
        under = Q >= 0.5

        fu = torch.sqrt(torch.clamp(4.0 * Q**2 - 1.0, min=1e-300))
        a_c = S0 * w0 * Q
        b_c = a_c / fu
        c_c = 0.5 * w0 / Q
        d_c = c_c * fu

        fo = torch.sqrt(torch.clamp(1.0 - 4.0 * Q**2, min=1e-300))
        base = 0.5 * S0 * w0 * Q
        a1 = base * (1.0 + 1.0 / fo)
        a2 = base * (1.0 - 1.0 / fo)
        c1 = 0.5 * w0 / Q * (1.0 - fo)
        c2 = 0.5 * w0 / Q * (1.0 + fo)

        zero = torch.zeros_like(S0)
        one = torch.ones_like(S0)
        ar = (torch.where(under, zero, a1), torch.where(under, zero, a2))
        cr = (torch.where(under, one, c1), torch.where(under, one, c2))
        ac = (torch.where(under, a_c, zero),)
        bc = (torch.where(under, b_c, zero),)
        cc = (torch.where(under, c_c, one),)
        dc = (torch.where(under, d_c, zero),)
        return (ar, cr), (ac, bc, cc, dc)

    def _real(self, theta):
        return self._coeffs(theta)[0]

    def _complex(self, theta):
        return self._coeffs(theta)[1]


class Matern32Term(Term):
    """Matern-3/2 kernel via celerite's epsilon-regularized complex term:
    k(tau) = sigma^2 (1 + w0 tau) exp(-w0 tau), w0 = sqrt(3)/rho."""

    parameter_names = ("log_sigma", "log_rho")

    def __init__(self, *args, eps: float = 0.01, bounds=None, **kwargs):
        self.eps = float(eps)
        super().__init__(*args, bounds=bounds, **kwargs)

    def _complex(self, theta):
        sigma2 = torch.exp(2.0 * theta[..., 0])
        w0 = math.sqrt(3.0) * torch.exp(-theta[..., 1])
        return (sigma2,), (sigma2 * w0 / self.eps,), (w0,), (torch.full_like(w0, self.eps),)


class JitterTerm(Term):
    """Pure white noise: adds sigma^2 to the covariance diagonal."""

    parameter_names = ("log_sigma",)

    def jitter(self, theta=None):
        theta = _as_theta(theta, self._values)
        return torch.exp(2.0 * theta[..., 0])


# ---------------------------------------------------------------------- #
# the mind_the_gaps custom terms
# ---------------------------------------------------------------------- #
class Lorentzian(Term):
    """Damped cosine: exp(-0.5 w0/Q tau) S0 cos(w0 tau)."""

    parameter_names = ("log_S0", "log_Q", "log_omega0")

    def _complex(self, theta):
        S0 = torch.exp(theta[..., 0])
        Q = torch.exp(theta[..., 1])
        w0 = torch.exp(theta[..., 2])
        return (S0,), (torch.zeros_like(S0),), (0.5 * w0 / Q,), (w0,)


class Cosinus(Term):
    """Undamped cosine: S0 cos(w0 tau)."""

    parameter_names = ("log_S0", "log_omega0")

    def _complex(self, theta):
        S0 = torch.exp(theta[..., 0])
        w0 = torch.exp(theta[..., 1])
        zero = torch.zeros_like(S0)
        return (S0,), (zero,), (zero,), (w0,)


class DampedRandomWalk(Term):
    """S0 exp(-w0 tau) (Eq. 13 of Foreman-Mackey+2017 with Q = 1/2)."""

    parameter_names = ("log_S0", "log_omega0")

    def _real(self, theta):
        return (torch.exp(theta[..., 0]),), (torch.exp(theta[..., 1]),)


class BendingPowerlaw(Term):
    """omega^-2 to omega^-4 bending term, with the positive-definiteness
    prior constraint log_S0 >= log_Q."""

    parameter_names = ("log_S0", "log_Q", "log_omega0")

    def _complex(self, theta):
        w0 = torch.exp(theta[..., 2])
        return (torch.exp(theta[..., 0]),), (torch.exp(theta[..., 1]),), (w0,), (w0,)

    def log_prior(self, theta=None):
        theta = _as_theta(theta, self._values)
        base = super().log_prior(theta)
        return torch.where(theta[..., 0] < theta[..., 1], theta.new_full((), -math.inf), base)
