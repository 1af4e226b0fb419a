"""The plain reference of the Kraft, Burrows & Nousek (1991, ApJ 374, 344)
quantities of a low-count bin: the posterior median of the source counts
and its 68% minimal (highest-posterior-density) interval.

Plain PyTorch, written from the paper's definitions and independent of the
port: it imports nothing of ``mind_the_gaps_tpu_torch`` nor of the JAX
package, and shares none of the port's method (fixed-iteration bisections
of the CDF through ``torch.special.gammaincc``, and of a density level).

With N counts observed over a known background of B counts, the source
counts s >= 0 have the posterior

    p(s) = (s + B)^N e^-(s+B) / (N! Q(N+1, B)),
    F(s) = 1 - Q(N+1, s + B) / Q(N+1, B),

Q the regularized upper incomplete gamma function, for whole N the finite
Poisson sum Q(N+1, x) = e^-x sum_{k<=N} x^k / k!, which is how it is
computed here.  The median solves F(s) = 1/2; the minimal interval [a, b]
of mass ``cl`` is the set where p(s) >= lambda: a = 0 where the interval
[0, F^-1(cl)] already has p(0) >= p(b), else a and b solve the
equal-density condition p(a) = p(b) (a below the mode max(N - B, 0), b
above it) and the mass condition F(b) - F(a) = cl.  Each is solved by a
safeguarded Newton iteration (a Newton step inside the bracket kept so
far, else the bracket's midpoint), run until every iterate has settled to
a few units in its last place:
the mass condition on b, with a(b) from the equal-density condition on
[0, mode] solved inside each step.

Accuracy, float64: the defining equations hold to 1e-11 (F(median) - 1/2,
log p(a) - log p(b) and F(b) - F(a) - cl; the tests hold them there) and
the values are those of the Newton iterations' fixed points, to rounding.
Everything runs in the ``dtype`` it is given: float64 for the reference,
float32 for the cell's control.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["CL", "poisson_q", "log_pdf", "cdf", "median", "hpd_interval", "kraft_tables"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CL = 0.68  # the mass of the interval whose half-width is a Kraft bin's dy
MAX_ITER = 200  # Newton steps at most; they stop once every iterate has settled


def _counts(N, B, device=None, dtype=torch.float64):
    """(N as int64, B as ``dtype``) tensors broadcast to one shape."""
    B = torch.as_tensor(B, dtype=dtype, device=device)
    return torch.broadcast_tensors(torch.as_tensor(N, device=B.device).long(), B)


def poisson_q(N, x):
    """Q(N+1, x) = e^-x sum_{k<=N} x^k / k! for whole N >= 0 (int64 tensor)
    and x >= 0, elementwise."""
    term = torch.exp(-x)
    total = term.clone()
    for k in range(1, int(N.max()) + 1 if N.numel() else 1):
        term = term * x / k
        total = total + torch.where(N >= k, term, torch.zeros_like(term))
    return total


def log_pdf(s, N, B):
    """log p(s) of the posterior of the source counts at N counts over a
    background of B counts (N log(s+B) read as 0 at N = 0)."""
    x = s + B
    log_x = torch.where(N > 0, N * torch.log(x), torch.zeros_like(x))
    return log_x - x - torch.lgamma(N.to(x.dtype) + 1.0) - torch.log(poisson_q(N, B))


def cdf(s, N, B):
    """F(s) of the posterior."""
    return 1.0 - poisson_q(N, s + B) / poisson_q(N, B)


def _newton(f_df, lo, hi, x):
    """The root of an increasing function on [lo, hi], elementwise: Newton
    steps from ``x`` (``f_df(x)`` gives the value and the derivative), each
    kept only inside the bracket so far (else its midpoint), until every
    iterate has settled: it moves by a few units in its last place at most,
    or steps back to where it was two steps ago (the rounding of ``f``
    holding it between two neighbours of the root)."""
    tol = 64.0 * torch.finfo(x.dtype).eps
    prev = torch.full_like(x, math.nan)
    for _ in range(MAX_ITER):
        fx, dfx = f_df(x)
        below = fx < 0
        lo, hi = torch.where(below, x, lo), torch.where(below, hi, x)
        step = x - fx / dfx
        new = torch.where((step >= lo) & (step <= hi), step, 0.5 * (lo + hi))
        new = torch.where(fx == 0, x, new)
        settled = ((new - x).abs() <= tol * torch.clamp(x.abs(), min=1.0)) | (new == prev)
        prev, x = x, new
        if bool(settled.all()):
            break
    return x


def _upper(N, B):
    """A point above which the posterior's mass is below 1e-30 (for N, B of
    a low-count bin)."""
    Nf = N.to(B.dtype)
    return Nf + 12.0 * torch.sqrt(Nf + 1.0) + 70.0


def _quantile(q, N, B):
    """F^-1(q), elementwise."""
    qB = poisson_q(N, B)
    Nf = N.to(B.dtype)

    def f_df(s):
        return q - poisson_q(N, s + B) / qB, torch.exp(log_pdf(s, N, B))  # F(s) - q, p(s)

    lo, hi = torch.zeros_like(B), _upper(N, B)
    return _newton(f_df, lo, hi, torch.clamp(Nf - B + 0.5, min=0.5))


def median(N, B, device=None, dtype=torch.float64):
    """The posterior median of the source counts, elementwise over N (whole
    counts) and B (background counts)."""
    N, B = _counts(N, B, device, dtype)
    return _quantile(0.5, N, B)


def hpd_interval(N, B, cl: float = CL, device=None, dtype=torch.float64):
    """(a, b): the minimal interval of posterior mass ``cl``, elementwise."""
    N, B = _counts(N, B, device, dtype)
    Nf = N.to(B.dtype)
    mode = torch.clamp(Nf - B, min=0.0)
    log_p0 = log_pdf(torch.zeros_like(B), N, B)

    def dlog(s):
        return Nf / (s + B) - 1.0

    def lower_end(b):
        """a(b) in [0, mode] with p(a) = p(b); 0 where p(0) >= p(b)."""
        level = log_pdf(b, N, B)
        a = _newton(lambda s: (log_pdf(s, N, B) - level, dlog(s)), torch.zeros_like(B), mode, 0.5 * mode)
        return torch.where(log_p0 >= level, torch.zeros_like(a), a)

    def mass(b):
        """F(b) - F(a(b)) - cl and its derivative in b: p(b), less p(a) a'(b)
        where a > 0 moves along the equal-density curve, a' = dlog(b) / dlog(a)."""
        a = lower_end(b)
        pb = torch.exp(log_pdf(b, N, B))
        inner = a > 0
        slope = torch.where(inner, pb * (1.0 - dlog(b) / torch.where(inner, dlog(a), torch.ones_like(a))), pb)
        return cdf(b, N, B) - cdf(a, N, B) - cl, slope

    start = torch.clamp(_quantile(0.5 * (1.0 + cl), N, B), min=mode)
    b = _newton(mass, mode, _upper(N, B), start)
    return lower_end(b), b


def kraft_tables(background_counts, max_count: int, device=None, dtype=torch.float64):
    """(median, lo, hi) tables of shape (max_count + 1, n) in ``dtype``: row
    N, column i at N counts over bin i's background counts."""
    B = torch.as_tensor(np.asarray(background_counts, dtype=np.float64), device=device).to(dtype)[None, :]
    N = torch.arange(max_count + 1, device=B.device)[:, None]
    N, B = torch.broadcast_tensors(N, B)
    lo, hi = hpd_interval(N, B, device=B.device, dtype=dtype)
    return median(N, B, device=B.device, dtype=dtype), lo, hi
