"""O(N R^2) celerite log-likelihood in float64, differentiable by autograd.

PyTorch port of ``build_matrices`` and ``log_likelihood`` of
``mind_the_gaps_tpu/solver/semiseparable.py``.  The celerite covariance

    K = diag(A) + tril(U W^T) + triu(W U^T)

is (R = Jr + 2 Jc)-semiseparable; its LDL^T factor follows a first-order
recursion in time (Foreman-Mackey et al. 2017, Sec. 5), fused here with
the forward substitution so that only R-vectors and an R x R matrix are
carried.

``log_likelihood`` is the plain version of the MAP objective's kernel
(``ops.celerite_grad``): its value, and its exact gradient by autograd.
The recursion is a Python loop, so every step costs autograd nodes; the
generators, decay factors and their outer products are built for all N
points as whole-array ops before the loop, and each step is 14 small ops.
The log-determinant and quadratic form are summed once after the loop.

``factor``, ``solve``, ``inverse_diag``, ``predict``, ``predict_mean`` and
``predict_at`` (with ``_predict_tables``) are the rest of the JAX module:
loops of small tensor ops on the device of their inputs, for prediction
and residuals, not for a hot path.

Times are shifted by t[0] before the trig arguments are formed: k depends
only on differences, and small arguments keep cos/sin accurate.  A
non-positive pivot (K not positive definite) gives -inf.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = [
    "CeleriteMatrices",
    "build_matrices",
    "factor",
    "log_likelihood",
    "solve",
    "predict_mean",
    "inverse_diag",
    "predict_at",
    "predict",
]


class CeleriteMatrices(NamedTuple):
    """U, V: (N, R) generators; P: (N, R) decay factors between consecutive
    points (row 0 is ones); A: (N,) diagonal of K."""

    U: torch.Tensor
    V: torch.Tensor
    P: torch.Tensor
    A: torch.Tensor


def build_matrices(coeffs, t, diag) -> CeleriteMatrices:
    """Assemble U, V, P, A from unbatched celerite coefficients ``(J,)``,
    sorted times ``t`` (N,) and the per-point variance ``diag`` (N,)."""
    ar, cr, ac, bc, cc, dc = coeffs
    dtype = ar.dtype
    t = torch.as_tensor(t, dtype=torch.float64, device=ar.device)
    tc = (t - t[0]).to(dtype)
    dt = torch.diff(t, prepend=t[:1]).to(dtype)  # dt[0] = 0 -> P row 0 = 1
    n = tc.shape[0]

    blocks_U, blocks_V, blocks_P = [], [], []
    if ar.shape[0]:
        blocks_U.append(ar[None, :].expand(n, -1))
        blocks_V.append(tc.new_ones(n, ar.shape[0]))
        blocks_P.append(torch.exp(-cr[None, :] * dt[:, None]))
    if ac.shape[0]:
        arg = dc[None, :] * tc[:, None]
        cos, sin = torch.cos(arg), torch.sin(arg)
        U1 = ac[None, :] * cos + bc[None, :] * sin
        U2 = ac[None, :] * sin - bc[None, :] * cos
        Pc = torch.exp(-cc[None, :] * dt[:, None])
        jc = ac.shape[0]
        blocks_U.append(torch.stack([U1, U2], dim=-1).reshape(n, 2 * jc))
        blocks_V.append(torch.stack([cos, sin], dim=-1).reshape(n, 2 * jc))
        blocks_P.append(torch.stack([Pc, Pc], dim=-1).reshape(n, 2 * jc))

    U = torch.cat(blocks_U, dim=1)
    V = torch.cat(blocks_V, dim=1)
    P = torch.cat(blocks_P, dim=1)
    A = torch.as_tensor(diag, dtype=dtype, device=ar.device) + ar.sum() + ac.sum()
    return CeleriteMatrices(U, V, P, A.expand(n) if A.dim() == 0 else A)


def log_likelihood(coeffs, t, y, diag, mean=0.0):
    """log N(y | mean, K) by the fused factor-and-solve recursion; -inf
    when K is not positive definite."""
    U, V, P, A = build_matrices(coeffs, t, diag)
    r = (torch.as_tensor(y, device=U.device) - mean).to(U.dtype)
    n, R = U.shape
    PP = P[:, :, None] * P[:, None, :]
    Us, Vs, Ps, PPs, As, rs = (x.unbind(0) for x in (U, V, P, PP, A, r))

    S = U.new_zeros(R, R)
    D = As[0]
    W = Vs[0] / D
    f = U.new_zeros(R)
    z = rs[0]
    Ds, zs = [D], [z]
    for k in range(1, n):
        f = Ps[k] * (f + W * z)
        S = PPs[k] * (S + D * torch.outer(W, W))
        SU = torch.mv(S, Us[k])
        D = As[k] - torch.dot(Us[k], SU)
        W = (Vs[k] - SU) / D
        z = rs[k] - torch.dot(Us[k], f)
        Ds.append(D)
        zs.append(z)
    D = torch.stack(Ds)
    z = torch.stack(zs)
    ll = -0.5 * (torch.sum(z * z / D) + torch.sum(torch.log(D.abs())) + n * math.log(2.0 * math.pi))
    return torch.where(torch.all(D > 0.0), ll, ll.new_full((), -math.inf))


def factor(m: CeleriteMatrices):
    """LDL^T factorization: (D (N,), W (N, R), ok), ok a 0-d bool tensor,
    True iff every pivot is positive."""
    U, V, P, A = m
    N, R = U.shape
    S = U.new_zeros(R, R)
    D = A[0]
    W = V[0] / D
    Ds, Ws = [D], [W]
    for n in range(1, N):
        S = (P[n][:, None] * P[n][None, :]) * (S + D * torch.outer(W, W))
        SU = torch.mv(S, U[n])
        D = A[n] - torch.dot(U[n], SU)
        W = (V[n] - SU) / D
        Ds.append(D)
        Ws.append(W)
    D = torch.stack(Ds)
    return D, torch.stack(Ws), torch.all(D > 0.0)


def solve(m: CeleriteMatrices, D, W, b):
    """K x = b given the factorization (D, W): forward then backward
    substitution, O(N R) each."""
    U, V, P, A = m
    N, R = U.shape
    b = torch.as_tensor(b, dtype=U.dtype, device=U.device)
    f = U.new_zeros(R)
    z = b[0]
    zs = [z]
    for n in range(1, N):  # L z = b
        f = P[n] * (f + W[n - 1] * z)
        z = b[n] - torch.dot(U[n], f)
        zs.append(z)
    zd = torch.stack(zs) / D
    g = U.new_zeros(R)
    x = zd[N - 1]
    xs = [x]
    for n in range(N - 2, -1, -1):  # L^T x = z / D
        g = P[n + 1] * (g + U[n + 1] * x)
        x = zd[n] - torch.dot(W[n], g)
        xs.append(x)
    return torch.stack(xs[::-1])


def predict_mean(coeffs, t, y, diag, jitter=0.0, mean=0.0):
    """GP predictive mean at the training points: y - s K^{-1} (y - mean),
    s = ``diag`` (the per-point noise variance)."""
    m = build_matrices(coeffs, t, diag)
    D, W, _ = factor(m)
    y = torch.as_tensor(y, dtype=m.U.dtype, device=m.U.device)
    alpha = solve(m, D, W, y - mean)
    return y - torch.as_tensor(diag, dtype=m.U.dtype, device=m.U.device) * alpha


def inverse_diag(m: CeleriteMatrices, D, W):
    """diag(K^{-1}) in O(N R^2) by the backward selected-inverse recursion
    of the JAX module:

      diag(K^{-1})_n = 1/D_n + (P_{n+1} w_n)^T H_{n+1} (P_{n+1} w_n),
      H_n = u_n u_n^T / D_n + (I - u_n w_n^T) P H_{n+1} P (I - w_n u_n^T)."""
    U, V, P, A = m
    N, R = U.shape
    eye = torch.eye(R, dtype=U.dtype, device=U.device)
    H = torch.outer(U[N - 1], U[N - 1]) / D[N - 1]
    gs = [U.new_zeros(())]
    for n in range(N - 2, -1, -1):
        HP = (P[n + 1][:, None] * P[n + 1][None, :]) * H
        gs.append(W[n] @ HP @ W[n])
        IW = eye - torch.outer(U[n], W[n])
        H = torch.outer(U[n], U[n]) / D[n] + IW @ HP @ IW.T
    return 1.0 / D + torch.stack(gs[::-1])


def _test_point_generators(coeffs, t0, s):
    """Generator rows U(s), V(s) (M, R) and the decay rates (R,) at test
    times ``s`` (M,), in build_matrices' phase convention and column
    order."""
    ar, cr, ac, bc, cc, dc = coeffs
    sc = (s - t0)[:, None]
    parts_u, parts_v, parts_c = [], [], []
    if ar.shape[0]:
        parts_u.append(ar[None, :].expand(sc.shape[0], -1))
        parts_v.append(torch.ones_like(sc).expand(-1, ar.shape[0]))
        parts_c.append(cr)
    if ac.shape[0]:
        arg = dc[None, :] * sc
        cos, sin = torch.cos(arg), torch.sin(arg)
        jc = ac.shape[0]
        parts_u.append(torch.stack([ac * cos + bc * sin, ac * sin - bc * cos], dim=-1).reshape(-1, 2 * jc))
        parts_v.append(torch.stack([cos, sin], dim=-1).reshape(-1, 2 * jc))
        parts_c.append(torch.stack([cc, cc], dim=-1).reshape(2 * jc))
    return torch.cat(parts_u, dim=1), torch.cat(parts_v, dim=1), torch.cat(parts_c)


def _predict_tables(m: CeleriteMatrices, D, W, alpha):
    """Per-gap R x R quadratic-form tables for O(R^2)-per-point prediction
    (the JAX module's ``_predict_tables``, whose docstring derives them).
    With a test point s in gap p (t_p <= s < t_{p+1}) and a = decayed U(s),
    c = decayed V(s):

        ks^T K^-1 ks = a^T A_p a + 2 a^T B_p c + c^T C_p c
        ks^T K^-1 r  = a^T g_p + c^T h_p

    Returns (A, B, C, g, h) indexed by p = 0..N: (N+1, R, R) x3, (N+1, R) x2."""
    U, V, P, _ = m
    N, R = U.shape
    eye = torch.eye(R, dtype=U.dtype, device=U.device)
    zero_m = U.new_zeros(R, R)
    P1 = torch.cat([P[1:], U.new_ones(1, R)])  # P_{n+1} aligned with row n

    # forward: Ahat_p, Psi_{p+1}, g_p for p = 1..N
    Phi, Ahat, g = zero_m, zero_m, U.new_zeros(R)
    Ahats, Psis, gs = [], [], []
    for n in range(N):
        zeta = V[n] - Phi.T @ U[n]
        Ahat = (P[n][:, None] * P[n][None, :]) * Ahat + torch.outer(zeta, zeta) / D[n]
        g = P[n] * g + V[n] * alpha[n]
        Psi = P1[n][:, None] * (Phi + torch.outer(W[n], zeta))
        Phi = Psi * P1[n][None, :]
        Ahats.append(Ahat)
        Psis.append(Psi)
        gs.append(g)

    # backward: H_{k+1}, C_{k-1}, J_{k-1}, h_{k-1} for k = N..1
    Hn, C, J, h = zero_m, zero_m, zero_m, U.new_zeros(R)
    Hs, Cs, Js, hs = [], [], [], []
    for n in range(N - 1, -1, -1):
        Lam = torch.outer(U[n], U[n]) / D[n]
        M = P1[n][:, None] * (eye - torch.outer(W[n], U[n]))
        Th = P1[n][:, None] * torch.outer(W[n], U[n])
        cross = -(P1[n][:, None] * (J @ Th))
        C_prev = Lam + (P1[n][:, None] * P1[n][None, :]) * C + cross + cross.T + Th.T @ Hn @ Th
        J_prev = Lam + P1[n][:, None] * (J @ M) - Th.T @ Hn @ M
        Hs.append(Hn)
        Hn = Lam + M.T @ Hn @ M
        C, J, h = C_prev, J_prev, U[n] * alpha[n] + P1[n] * h
        Cs.append(C)
        Js.append(J)
        hs.append(h)
    Hn1 = torch.stack(Hs[::-1])  # Hn1[k-1] = H_{k+1}
    C_low = torch.stack(Cs[::-1])  # C_low[k-1] = C_{k-1}
    J_low = torch.stack(Js[::-1])
    h_low = torch.stack(hs[::-1])

    Psi = torch.stack(Psis)
    A_full = torch.stack(Ahats) + torch.einsum("nji,njk,nkl->nil", Psi, Hn1, Psi)
    J_full = torch.cat([J_low[1:], zero_m[None]])  # J_p for p = 1..N
    B_full = -torch.einsum("nji,nkj->nik", Psi, J_full)
    A = torch.cat([zero_m[None], A_full])
    B = torch.cat([zero_m[None], B_full])
    C = torch.cat([C_low, zero_m[None]])
    g = torch.cat([U.new_zeros(1, R), torch.stack(gs)])
    h = torch.cat([h_low, U.new_zeros(1, R)])
    return A, B, C, g, h


def predict_at(coeffs, t, y, diag, t_pred, mean=0.0, return_var: bool = True):
    """GP predictive mean (and variance) at test times ``t_pred`` (M,), the
    celerite ``gp.predict(y, t_pred)``, through the per-gap tables of
    ``_predict_tables``: O((N + M) R^2)."""
    m = build_matrices(coeffs, t, diag)
    dtype, device = m.U.dtype, m.U.device
    t = torch.as_tensor(t, dtype=torch.float64, device=device)
    t_pred = torch.as_tensor(t_pred, dtype=torch.float64, device=device)
    D, W, _ = factor(m)
    y = torch.as_tensor(y, dtype=dtype, device=device)
    alpha = solve(m, D, W, y - mean)
    A, B, C, g, h = _predict_tables(m, D, W, alpha)

    ar, cr, ac, bc, cc, dc = coeffs
    k0 = ar.sum() + ac.sum()
    N = t.shape[0]
    p = torch.searchsorted(t, t_pred, right=True)  # 0..N
    u_s, v_s, cvec = _test_point_generators(coeffs, t[0], t_pred)
    lo = torch.clamp(p - 1, 0, N - 1)
    hi = torch.clamp(p, 0, N - 1)
    gap_lo = torch.where(p >= 1, t_pred - t[lo], torch.zeros_like(t_pred)).to(dtype)
    gap_hi = torch.where(p <= N - 1, t[hi] - t_pred, torch.zeros_like(t_pred)).to(dtype)
    a = torch.exp(-cvec[None, :] * gap_lo[:, None]) * u_s
    c = torch.exp(-cvec[None, :] * gap_hi[:, None]) * v_s
    mu = (a * g[p]).sum(1) + (c * h[p]).sum(1)
    if not return_var:
        return mu + mean
    q = (torch.einsum("mi,mij,mj->m", a, A[p], a) + 2.0 * torch.einsum("mi,mij,mj->m", a, B[p], c)
         + torch.einsum("mi,mij,mj->m", c, C[p], c))
    return mu + mean, k0 - q


def predict(coeffs, t, y, diag, mean=0.0):
    """Predictive mean and variance at the training points, O(N R^2):
    var_n = s_n - s_n^2 (K^{-1})_nn with s = ``diag``."""
    m = build_matrices(coeffs, t, diag)
    D, W, _ = factor(m)
    y = torch.as_tensor(y, dtype=m.U.dtype, device=m.U.device)
    alpha = solve(m, D, W, y - mean)
    s = torch.as_tensor(diag, dtype=m.U.dtype, device=m.U.device)
    mu = y - s * alpha
    return mu, s - s**2 * inverse_diag(m, D, W)
