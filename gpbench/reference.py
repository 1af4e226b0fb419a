"""The plain reference: celerite GP log-posteriors and their maxima.

Plain PyTorch, written from the published definitions and independent of
the port: it imports nothing of ``mind_the_gaps_tpu_torch`` nor of the
JAX package, and it takes from the program only the answers it judges.

- ``log_likelihood``: log N(r | 0, K + diag) of residual rows r by the
  celerite Cholesky recursion of Foreman-Mackey et al. (2017, section 5),
  in the local-phase form (each complex pair's oscillation folded into the
  step propagator, as ``mind_the_gaps_tpu_torch/solver/numpy_ref.py``
  writes it), batched over rows and sequential over time, summed plainly.
  It runs in the dtype it is given: float64 for the reference, float32 for
  the control.
- ``Model``: a sum of covariance terms (``terms/<kind>.py``) with a flat
  prior inside its bounds, the mean of each row subtracted (the port's
  unfitted constant mean).
- ``maximize``: damped Newton ascent with central-difference gradients and
  Hessians, batched over problems and held inside the box; its final
  negative Hessian gives the Laplace covariance.
- ``flux_skewness``: the skewness of simulated fluxes with their Poisson
  noise's share taken out, beside that of the moment-matched flux pdf
  they were drawn to follow (Emmanoulopoulos et al. 2013).
"""
from __future__ import annotations

import importlib
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

__all__ = ["Model", "log_likelihood", "Evaluator", "maximize", "grid_points", "flux_skewness"]

_TERMS_DIR = Path(__file__).resolve().parent / "terms"


def _term(kind: str):
    if not (_TERMS_DIR / f"{kind}.py").is_file():
        raise ValueError(f"no reference for the covariance term {kind!r} (gpbench/terms/{kind}.py)")
    return importlib.import_module(f"gpbench.terms.{kind}")


@dataclass(frozen=True)
class Model:
    """A sum of covariance terms: ``kinds`` and their parameter ``bounds``
    ((D, 2) numpy), in the order of the parameter vector."""

    kinds: tuple
    bounds: np.ndarray

    @classmethod
    def from_config(cls, spec: dict) -> "Model":
        kinds = tuple(term["kind"] for term in spec["terms"])
        bounds = np.array([b for term in spec["terms"] for b in term["bounds"]], dtype=np.float64)
        return cls(kinds, bounds)

    @property
    def ndim(self) -> int:
        return self.bounds.shape[0]

    def coefficients(self, theta):
        """(ar, cr, ac, bc, cc, dc), each (B, J), of parameters (B, D)."""
        parts = [[] for _ in range(6)]
        at = 0
        for kind in self.kinds:
            term = _term(kind)
            for part, values in zip(parts, term.coefficients(theta[:, at : at + term.N_PARAMS])):
                part.extend(values)
            at += term.N_PARAMS
        empty = theta.new_zeros((theta.shape[0], 0))
        return tuple(torch.stack(p, dim=1) if p else empty for p in parts)


def _pad(coeffs, jr: int, jc: int):
    """Coefficients padded with terms of zero amplitude to ``jr`` real terms
    and ``jc`` complex pairs (a = b = 0, c = d = 1: they add nothing to K)."""
    ar, cr, ac, bc, cc, dc = coeffs
    B = ar.shape[0]

    def grow(x, j, fill):
        return torch.cat([x, x.new_full((B, j - x.shape[1]), fill)], dim=1)

    return (grow(ar, jr, 0.0), grow(cr, jr, 1.0), grow(ac, jc, 0.0), grow(bc, jc, 0.0), grow(cc, jc, 1.0),
            grow(dc, jc, 1.0))


def log_likelihood(coeffs, t, r, diag):
    """(B,) log N(r_b | 0, K_b + diag(diag_b)) for residual rows ``r`` and
    variances ``diag`` (B, N), coefficients (B, J) of one dtype (that of
    the computation), times ``t`` (N,) float64 (the gaps are formed in
    float64, then cast).  -inf where a pivot is not positive."""
    ar, cr, ac, bc, cc, dc = coeffs
    dtype, device = ar.dtype, ar.device
    B, jr = ar.shape
    jc = ac.shape[1]
    R = jr + 2 * jc
    t = torch.as_tensor(t, dtype=torch.float64, device=device)
    N = t.shape[0]
    dt = torch.diff(t).to(dtype)
    r = r.to(dtype)
    a = diag.to(dtype) + (ar.sum(1) + ac.sum(1))[:, None]
    u = torch.cat([ar, torch.stack([ac, bc], 2).reshape(B, 2 * jc)], 1)
    v = torch.cat([torch.ones_like(ar), torch.stack([torch.ones_like(ac), torch.zeros_like(ac)], 2).reshape(B, 2 * jc)], 1)
    # the block-diagonal propagator of every step: P x = pd * x + po * x[swap]
    h = dt[:, None, None]
    er = torch.exp(-cr[None] * h)
    ec = torch.exp(-cc[None] * h)
    cos, sin = ec * torch.cos(dc[None] * h), ec * torch.sin(dc[None] * h)
    pd = torch.cat([er, torch.stack([cos, cos], 3).reshape(N - 1, B, 2 * jc)], 2)
    po = torch.cat([torch.zeros_like(er), torch.stack([-sin, sin], 3).reshape(N - 1, B, 2 * jc)], 2)
    swap = torch.arange(R, device=device)
    swap[jr:] = swap[jr:].reshape(jc, 2).flip(1).reshape(-1)
    rotates = jc > 0

    pd3, po3 = pd[..., None], po[..., None]
    u3 = u[:, :, None]
    D = a[:, 0]
    w = v / D[:, None]
    z = r[:, 0]
    S = ar.new_zeros((B, R, R))
    f = ar.new_zeros((B, R))
    Ds = torch.empty((N, B), dtype=dtype, device=device)  # the pivots and innovations, kept for the sums
    zs = torch.empty((N, B), dtype=dtype, device=device)
    Ds[0], zs[0] = D, z
    for n in range(1, N):
        M = torch.addcmul(S, (D[:, None] * w)[:, :, None], w[:, None, :])
        fw = torch.addcmul(f, w, z[:, None])
        if rotates:  # P M P^T and P fw, each pair rotated
            M = torch.addcmul(pd3[n - 1] * M, po3[n - 1], M[:, swap, :])
            S = torch.addcmul(M * pd[n - 1][:, None, :], M[:, :, swap], po[n - 1][:, None, :])
            f = torch.addcmul(pd[n - 1] * fw, po[n - 1], fw[:, swap])
        else:
            S = M * (pd3[n - 1] * pd[n - 1][:, None, :])
            f = pd[n - 1] * fw
        Su = torch.bmm(S, u3)[:, :, 0]
        D = a[:, n] - torch.bmm(u[:, None, :], Su[:, :, None])[:, 0, 0]
        w = (v - Su) / D[:, None]
        z = r[:, n] - torch.bmm(u[:, None, :], f[:, :, None])[:, 0, 0]
        Ds[n], zs[n] = D, z
    ok = (Ds > 0).all(0)
    ll = -0.5 * ((zs * zs / Ds).sum(0) + torch.log(Ds.abs()).sum(0) + N * math.log(2.0 * math.pi))
    return torch.where(ok, ll, ll.new_full((), -math.inf))


class Evaluator:
    """Log-likelihoods and log-posteriors of several models on a set of
    data rows (``y``, ``dy``: (K, N)) sharing times ``t``, each row's own
    mean subtracted; one recursion for a whole batch of points, every
    model padded to the widest.  ``dtype``: of the computation."""

    def __init__(self, t, y, dy, models, device="cpu", dtype=torch.float64):
        self.device, self.dtype = torch.device(device), dtype
        self.t = torch.as_tensor(np.asarray(t, dtype=np.float64), device=self.device)
        y = torch.as_tensor(np.asarray(y, dtype=np.float64), device=self.device)
        self.r = y - y.mean(1, keepdim=True)
        # celerite adds 1e-12 to dy before squaring
        self.diag = (torch.as_tensor(np.asarray(dy, dtype=np.float64), device=self.device) + 1e-12) ** 2
        self.models = tuple(models)
        coeffs = [m.coefficients(torch.zeros((1, m.ndim), dtype=torch.float64)) for m in self.models]
        self.jr = max(c[0].shape[1] for c in coeffs)
        self.jc = max(c[2].shape[1] for c in coeffs)

    def log_likelihood(self, jobs):
        """``jobs``: a list of (model index, points (P, D) numpy, rows (P,)
        numpy); returns the list of (P,) float64 numpy log-likelihoods."""
        coeffs, rows = [], []
        for m, points, idx in jobs:
            theta = torch.as_tensor(np.asarray(points, dtype=np.float64), device=self.device)
            coeffs.append(_pad(self.models[m].coefficients(theta), self.jr, self.jc))
            rows.append(torch.as_tensor(np.asarray(idx, dtype=np.int64), device=self.device))
        sizes = [len(i) for i in rows]
        if not sum(sizes):
            return [np.empty(0) for _ in jobs]
        rows = torch.cat(rows)
        coeffs = tuple(torch.cat(parts).to(self.dtype) for parts in zip(*coeffs))
        ll = log_likelihood(coeffs, self.t, self.r[rows], self.diag[rows]).double().cpu().numpy()
        return list(np.split(ll, np.cumsum(sizes)[:-1]))

    def log_posterior(self, m, points, rows):
        """Flat prior inside the model's bounds plus the log-likelihood."""
        points = np.asarray(points, dtype=np.float64)
        lo, hi = self.models[m].bounds.T
        inside = np.all((points >= lo) & (points <= hi), axis=1)
        ll = self.log_likelihood([(m, points, rows)])[0]
        return np.where(inside, ll, -np.inf)


def grid_points(bounds, per_axis: int) -> np.ndarray:
    """A regular grid over the box, ``per_axis`` points an axis inset by
    half a cell: (per_axis ** D, D)."""
    axes = [lo + (np.arange(per_axis) + 0.5) * (hi - lo) / per_axis for lo, hi in bounds]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, len(axes))


def _stencil(x, h):
    """The central-difference points around each x (K, D): (K, S, D)."""
    K, D = x.shape
    offsets = [np.zeros(D)]
    for i in range(D):
        for s in (1, -1):
            e = np.zeros(D)
            e[i] = s * h
            offsets.append(e)
    for i in range(D):
        for j in range(i + 1, D):
            for si, sj in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
                e = np.zeros(D)
                e[i], e[j] = si * h, sj * h
                offsets.append(e)
    return x[:, None, :] + np.array(offsets)[None]


def _derivatives(vals, D, h):
    """(value, gradient, Hessian) from the stencil's values (K, S)."""
    K = vals.shape[0]
    f0 = vals[:, 0]
    plus, minus = vals[:, 1 : 1 + 2 * D : 2], vals[:, 2 : 2 + 2 * D : 2]
    g = (plus - minus) / (2 * h)
    H = np.zeros((K, D, D))
    H[:, np.arange(D), np.arange(D)] = (plus - 2 * f0[:, None] + minus) / h**2
    at = 1 + 2 * D
    for i in range(D):
        for j in range(i + 1, D):
            pp, pm, mp, mm = (vals[:, at + k] for k in range(4))
            H[:, i, j] = H[:, j, i] = (pp - pm - mp + mm) / (4 * h**2)
            at += 4
    return f0, g, H


def _newton(x0, lo, hi, h, max_iter, tol):
    """Damped Newton ascent of K problems from x0 (K, D) inside [lo, hi],
    as a generator: it yields stencil points (K, S, D) and is sent their
    log-likelihoods (K, S).  Returns (x, value, Hessian, converged)."""
    K, D = x0.shape
    x = np.clip(x0, lo, hi)
    trial = x.copy()
    best = np.full(K, -np.inf)
    g, H = np.zeros((K, D)), np.zeros((K, D, D))
    lam = np.full(K, 1e-3)
    done = np.zeros(K, dtype=bool)
    for _ in range(max_iter):
        vals = yield _stencil(trial, h)
        f0, g_t, H_t = _derivatives(vals, D, h)
        take = np.isfinite(f0) & (f0 >= best) & ~done
        gain = np.where(take, f0 - best, 0.0)
        x[take], best[take], g[take], H[take] = trial[take], f0[take], g_t[take], H_t[take]
        lam = np.where(take, lam / 3.0, lam * 10.0)
        # a coordinate on a face of the box whose gradient points out stays there
        held = ((x <= lo) & (g < 0)) | ((x >= hi) & (g > 0))
        A = -H
        scale = np.abs(np.diagonal(A, axis1=1, axis2=2)) + 1e-8
        A = A + lam[:, None, None] * np.eye(D)[None] * scale[:, None, :]
        A[held] = 0.0
        A.transpose(0, 2, 1)[held] = 0.0
        A[np.nonzero(held)[0], np.nonzero(held)[1], np.nonzero(held)[1]] = 1.0
        step = np.linalg.solve(A, np.where(held, 0.0, g)[..., None])[..., 0]
        trial = np.clip(x + step, lo, hi)
        small = (np.abs(trial - x).max(1) < tol) | ((take & (gain < 1e-12)) & (np.abs(step).max(1) < 1e-6))
        done = done | (take & small)
        trial[done] = x[done]
        if done.all():
            break
    return x, best, H, done


def maximize(evaluator, problems, h=1e-4, tol=1e-9):
    """Maximize the log-posterior of each problem, all in lock-step.

    ``problems``: a list of (model index, starts (K, D), rows (K,),
    iterations at most: each a batched evaluation).  For
    each problem list it returns (x (K, D), value (K,), Hessian (K, D, D),
    converged (K,)), the value being the log-likelihood at x (the prior is
    flat and x stays inside the bounds)."""
    gens, results = [], [None] * len(problems)
    for m, starts, rows, max_iter in problems:
        lo, hi = evaluator.models[m].bounds.T
        gens.append((m, np.asarray(rows), _newton(np.asarray(starts, dtype=np.float64), lo, hi, h, max_iter, tol)))
    pending = {}
    for i, (_, _, gen) in enumerate(gens):
        pending[i] = next(gen)
    while pending:
        jobs, keys = [], list(pending)
        for i in keys:
            m, rows, _ = gens[i]
            pts = pending[i]
            jobs.append((m, pts.reshape(-1, pts.shape[-1]), np.repeat(rows, pts.shape[1])))
        values = evaluator.log_likelihood(jobs)
        for i, vals in zip(keys, values):
            pts = pending.pop(i)
            try:
                pending[i] = gens[i][2].send(vals.reshape(pts.shape[:2]))
            except StopIteration as stop:
                results[i] = stop.value
    return results


def flux_skewness(y, exposure: float, pdf: str):
    """(measured, target) skewness of the rates under rows of Poisson-noised
    fluxes ``y`` (K, N) (counts / ``exposure``), pooled over the rows.

    For counts Poisson about exposure x rate, the fluxes' cumulants are the
    rate's plus the noise's: k2 = k2x + k1 / e and k3 = k3x + 3 k2x / e +
    k1 / e**2, so the rate's cumulants are read from each row's own moments;
    the measured skewness is the rows' mean k3x over their mean k2x to the
    power 1.5.  The target is the skewness of ``pdf`` matched to the rows'
    mean flux and rate variance: (exp(s2) + 2) sqrt(exp(s2) - 1), s2 = ln(1
    + k2x / k1**2), for "Lognormal"; 0 for "Gaussian" and "Uniform"."""
    y = np.asarray(y, dtype=np.float64)
    e = float(exposure)
    k1 = y.mean(1)
    dev = y - k1[:, None]
    k2x = (dev**2).mean(1) - k1 / e
    k3x = (dev**3).mean(1) - 3.0 * k2x / e - k1 / e**2
    var = max(float(k2x.mean()), 0.0)
    measured = float(k3x.mean()) / var**1.5 if var > 0 else math.inf
    if pdf.lower() == "lognormal":
        s2 = math.log1p(var / float(k1.mean()) ** 2)
        return measured, (math.exp(s2) + 2.0) * math.sqrt(math.expm1(s2))
    if pdf.lower() in ("gaussian", "uniform"):
        return measured, 0.0
    raise ValueError(f"no target skewness for the flux pdf {pdf!r}")
