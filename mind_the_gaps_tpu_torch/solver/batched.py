"""Batched celerite log-likelihood: the plain PyTorch version of the kernel.

PyTorch port of ``mind_the_gaps_tpu/solver/batched.py``.  It computes, for
B parameter draws over one sorted ``t``,

    log N(y_b | mean_b, K(theta_b) + diag_b + extra_diag_b)

with the same recursion as ``csrc/celerite_loglike.cu``, one time step per
Python iteration over the whole batch:

- **Local-phase (rotation-propagator) form.**  The complex-pair columns use
  constant generator rows u = [a, b], v = [1, 0] and fold the oscillation
  into the inter-step propagator P_n = exp(-c dt_n) Rot(d dt_n), so every
  trig argument is a small gap between samples and float32 survives
  t ~ 1e7-1e8:

      S_n = P_n [S_{n-1} + D_{n-1} w w^T] P_n^T
      D_n = A_n - u^T S_n u,   w_n = (v - S_n u)/D_n
      f_n = P_n (f_{n-1} + w_{n-1} z_{n-1}),  z_n = r_n - u^T f_n

- **Chunked sums** of the log-determinant and the quadratic form, in the
  order of the kernel: the terms of each chunk of ``CHUNK`` = 32 steps
  are summed as a pairwise tree of neighbours (``chunk_sums``), and the
  chunk sums are added with Kahan compensation, so float32 keeps the
  log-likelihood to ~1e-3 over 10^4 steps.
- ``dt`` is formed in float64 and then cast to the working dtype.
- The result is -inf wherever a pivot D_n is not positive (or is NaN).

Data layouts (``check_layout``): shared ``y, diag: (N,)``; grouped
``(G, N)`` with ``repeats`` consecutive batch elements per group
(B = G * repeats, the bootstrap layout); per-element ``(B, N)`` (a 2-D
``y`` with ``repeats=1``).  A 1-D ``diag`` may go with a 2-D ``y``.
``mean`` and ``extra_diag`` are optional per-element ``(B,)`` tensors.

This version builds the block-diagonal propagators of all N steps up front
as dense (N, B, R, R) matrices and applies them by batched matmuls (their
zero entries add exact zeros); it is meant for the CPU and for checking
the kernel.  ``ops.celerite`` launches the kernel for CUDA tensors.
"""
from __future__ import annotations

import math

import torch

__all__ = ["batched_log_likelihood", "batched_log_prob_fn", "check_layout", "chunk_sums", "CHUNK"]

CHUNK = 32  # steps per chunk of the sums (the kernel's kChunk)


def check_layout(B: int, N: int, y, diag, repeats: int, mean=None, extra_diag=None):
    """Validate the data layout; raises ValueError on one the recursion
    does not take."""
    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    if y.dim() == 1:
        if y.shape[0] != N:
            raise ValueError(f"y has {y.shape[0]} points, t has {N}")
    elif y.dim() == 2:
        if y.shape[1] != N:
            raise ValueError(f"y has {y.shape[1]} points, t has {N}")
        if y.shape[0] * repeats != B:
            raise ValueError(
                f"2-D y needs y.shape[0] * repeats == B (got {y.shape[0]} * {repeats} != {B})"
            )
    else:
        raise ValueError("y must be (N,) or (G, N)")
    if diag.dim() == 1:
        if diag.shape[0] != N:
            raise ValueError("diag must have N points")
    elif tuple(diag.shape) != tuple(y.shape):
        raise ValueError("a 2-D diag must have the shape of y")
    for name, x in (("mean", mean), ("extra_diag", extra_diag)):
        if x is not None and tuple(x.shape) != (B,):
            raise ValueError(f"{name} must be a (B,) tensor")


def _rows(x, B: int, repeats: int):
    """(N,) or (G, N) data as per-element rows (N, B)."""
    if x.dim() == 1:
        return x[:, None].expand(-1, B)
    col = torch.arange(B, device=x.device) // repeats
    return x.T[:, col]


def _propagators(dt, cr, cc, dc):
    """The block-diagonal P_n of every step as dense (N, B, R, R) matrices:
    exp(-c dt) for real terms, exp(-c dt) Rot(d dt) for complex pairs."""
    B, Jr = cr.shape
    Jc = cc.shape[1]
    R = Jr + 2 * Jc
    h = dt[:, None, None]
    P = cr.new_zeros((dt.shape[0], B, R, R))
    j = torch.arange(Jr, device=cr.device)
    P[:, :, j, j] = torch.exp(-cr[None] * h)
    ecd = torch.exp(-cc[None] * h)
    cos, sin = ecd * torch.cos(dc[None] * h), ecd * torch.sin(dc[None] * h)
    a = Jr + 2 * torch.arange(Jc, device=cr.device)
    P[:, :, a, a] = cos
    P[:, :, a, a + 1] = -sin
    P[:, :, a + 1, a] = sin
    P[:, :, a + 1, a + 1] = cos
    return P


def _kahan_add(s, c, x):
    yk = x - c
    tk = s + yk
    return tk, (tk - s) - yk


def chunk_sums(x):
    """(N, B) per-step terms -> (B,) sums: zero-padded to chunks of CHUNK
    steps, each chunk summed as the pairwise tree ((x0 + x1) + (x2 + x3))
    + ..., the chunk sums added in order with Kahan compensation."""
    N = x.shape[0]
    x = torch.cat([x, x.new_zeros(((-N) % CHUNK,) + tuple(x.shape[1:]))])
    x = x.reshape(-1, CHUNK, *x.shape[1:])
    while x.shape[1] > 1:
        x = x[:, 0::2] + x[:, 1::2]
    s, c = torch.zeros_like(x[0, 0]), torch.zeros_like(x[0, 0])
    for chunk in x[:, 0]:
        s, c = _kahan_add(s, c, chunk)
    return s


def batched_log_likelihood(coeffs, t, y, diag, mean=None, repeats: int = 1, extra_diag=None):
    """(B,) log-likelihoods for coefficients of shape (B, J); the dtype and
    device of ``coeffs`` select those of the computation."""
    ar, cr, ac, bc, cc, dc = coeffs
    B, Jr = ar.shape
    Jc = ac.shape[1]
    R = Jr + 2 * Jc
    dtype, device = ar.dtype, ar.device
    t64 = torch.as_tensor(t, dtype=torch.float64, device=device)
    N = t64.shape[0]
    dt = torch.diff(t64, prepend=t64[:1]).to(dtype)  # small gaps: safe to cast
    y = torch.as_tensor(y, dtype=dtype, device=device)
    diag = torch.as_tensor(diag, dtype=dtype, device=device)
    check_layout(B, N, y, diag, repeats, mean, extra_diag)

    k0 = ar.sum(1) + ac.sum(1)
    if extra_diag is not None:
        k0 = k0 + extra_diag.to(dtype)
    ones_r, ones_c = ar.new_ones(B, Jr), ac.new_ones(B, Jc)
    u = torch.cat([ar, torch.stack([ac, bc], dim=2).reshape(B, 2 * Jc)], dim=1)
    v = torch.cat([ones_r, torch.stack([ones_c, torch.zeros_like(ones_c)], dim=2).reshape(B, 2 * Jc)], dim=1)

    r_rows = _rows(y, B, repeats)
    if mean is not None:
        r_rows = r_rows - mean.to(dtype)[None, :]
    a_rows = _rows(diag, B, repeats) + k0[None, :]

    P = _propagators(dt, cr, cc, dc)
    u_col = u[:, :, None]

    D = a_rows[0]
    W = v / D[:, None]
    z = r_rows[0]
    S = ar.new_zeros(B, R, R)
    f = ar.new_zeros(B, R, 1)
    logs, quads = [torch.log(D.abs())], [z * z / D]
    ok = D > 0.0
    for n in range(1, N):
        Pn = P[n]
        S = torch.baddbmm(S, (D[:, None] * W)[:, :, None], W[:, None, :])
        S = Pn @ S @ Pn.transpose(1, 2)
        f = Pn @ (f + (W * z[:, None])[:, :, None])
        Su = (S @ u_col)[:, :, 0]
        D = a_rows[n] - (u * Su).sum(1)
        W = (v - Su) / D[:, None]
        z = r_rows[n] - (u * f[:, :, 0]).sum(1)
        logs.append(torch.log(D.abs()))
        quads.append(z * z / D)
        ok = ok & (D > 0.0)
    ll = -0.5 * (chunk_sums(torch.stack(quads)) + chunk_sums(torch.stack(logs)) + N * math.log(2.0 * math.pi))
    return torch.where(ok, ll, ll.new_full((), -math.inf))


def batched_log_prob_fn(kernel, t, y, diag, subtract_mean: bool = True, repeats: int = 1, dtype=None, team=None,
                        data_means=None):
    """thetas (B, D) -> log-probs (B,): the kernel's flat prior within its
    bounds plus the batched likelihood of ``ops.celerite_log_likelihood``
    (the CUDA kernel for tensors on a card, this module's recursion on the
    CPU); the sampler's inner loop.

    ``y``/``diag``: (N,) shared or (G, N) per group with B = G *
    ``repeats``.  With ``subtract_mean``, each element's constant mean is
    the mean of its own data (the reference's default unfitted
    ConstantModel), or of the group's entry of ``data_means`` ((G,) or 0-d,
    in ``dtype``) where given: the shards of a batch take the means of the
    whole batch's reduction.  ``dtype`` selects the likelihood's precision
    (default: that of ``y``), ``team`` the kernel's layout
    (``ops.celerite_log_likelihood``).  The data is prepared once, here
    (``ops.celerite._prepare``: ``dt`` and the kernel's batch-last copies),
    and each call launches on it, so a call makes no copy of the data and
    no host-to-device transfer: it can be captured in a CUDA graph."""
    from mind_the_gaps_tpu_torch.ops.celerite import _log_likelihood_prepared, _prepare  # it imports this module

    y = torch.as_tensor(y)
    dtype = y.dtype if dtype is None else dtype
    y = y.to(dtype)
    diag = torch.as_tensor(diag, device=y.device).to(dtype)
    grouped = y.dim() > 1 or diag.dim() > 1
    data = _prepare(t, y, diag, dtype, y.device)
    if subtract_mean and data_means is None:
        data_means = y.mean() if y.dim() == 1 else y.mean(1)
    means = {}  # batch size -> its (B,) means, built once

    def log_prob(thetas):
        B = thetas.shape[0]
        thetas = thetas.to(dtype)
        coeffs = kernel.coefficients(thetas)
        lp = kernel.log_prior(thetas)
        jitter = kernel.jitter(thetas)
        mean = None
        if subtract_mean:
            mean = means.get(B)
            if mean is None:
                mean = data_means.repeat(B) if y.dim() == 1 else data_means.repeat_interleave(repeats)
                means[B] = mean
        ll = _log_likelihood_prepared(coeffs, data, mean=mean, repeats=repeats if grouped else 1, extra_diag=jitter,
                                      team=team)
        return torch.where(torch.isfinite(lp), lp + ll, ll.new_full((), -math.inf))

    return log_prob
