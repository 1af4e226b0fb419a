"""The celerite likelihood as a Kalman filter, sequential and parallel in time.

PyTorch port of ``mind_the_gaps_tpu/solver/kalman.py``, the port's second
oracle for the celerite likelihood (no pipeline path calls it).  The
celerite GP is a stationary linear-Gaussian state-space model (one 1-D OU
block per real term, one 2-D rotation-decay block per complex pair):

    x_k = Phi_k x_{k-1} + q_k,   q_k ~ N(0, Q_k = V - Phi_k V Phi_k^T)
    y_k = H x_k + eps_k,         eps_k ~ N(0, diag_k)

with Phi_k = exp(-c dt) Rot(d dt) per block, stationary V = a for real
terms and [[a, -b], [-b, a]] for complex pairs, and H picking the first
component of each block (then Cov(y_n, y_m) = H Phi_{n<-m} V H^T =
k(t_n - t_m) exactly).

``kalman_log_likelihood`` runs the filter step by step.
``parallel_kalman_log_likelihood`` writes it with the associative
five-tuple elements of Sarkka & Garcia-Fernandez (2021, "Temporal
Parallelization of Bayesian Smoothers") and scans them over the time axis
in ceil(log2 N) rounds of Hillis-Steele doubling (round r combines each
element with the one 2^r before it, all N at once), where the JAX package
calls ``jax.lax.associative_scan``.  The combine inverts small p x p
matrices (p = Jr + 2 Jc) with ``torch.linalg.solve`` on the batch.  Both
run on the device of the coefficients in their dtype (float64 for parity)
and are differentiable by autograd.  Coefficients are unbatched, ``(J,)``.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "state_space_matrices",
    "kalman_log_likelihood",
    "parallel_kalman_log_likelihood",
]


def state_space_matrices(coeffs, t):
    """Per-step transition matrices Phi (N, p, p), the stationary
    covariance V (p, p) and the observation row H (p,)."""
    ar, cr, ac, bc, cc, dc = coeffs
    dtype, dev = ar.dtype, ar.device
    t = torch.as_tensor(t, dtype=dtype, device=dev)
    dt = torch.diff(t, prepend=t[:1])  # dt[0] = 0 -> Phi_0 = I-ish (unused)
    N = t.shape[0]
    Jr, Jc = ar.shape[0], ac.shape[0]
    p = Jr + 2 * Jc

    Phi = t.new_zeros((N, p, p))
    V = t.new_zeros((p, p))
    H = t.new_zeros((p,))
    for j in range(Jr):
        Phi[:, j, j] = torch.exp(-cr[j] * dt)
        V[j, j] = ar[j]
        H[j] = 1.0
    for j in range(Jc):
        i0 = Jr + 2 * j
        e = torch.exp(-cc[j] * dt)
        cth = torch.cos(dc[j] * dt)
        sth = torch.sin(dc[j] * dt)
        Phi[:, i0, i0] = e * cth
        Phi[:, i0, i0 + 1] = -e * sth
        Phi[:, i0 + 1, i0] = e * sth
        Phi[:, i0 + 1, i0 + 1] = e * cth
        V[i0, i0] = ac[j]
        V[i0, i0 + 1] = -bc[j]
        V[i0 + 1, i0] = -bc[j]
        V[i0 + 1, i0 + 1] = ac[j]
        H[i0] = 1.0
    return Phi, V, H


def _loglike_terms(v, s):
    return -0.5 * (torch.log(2.0 * math.pi * s) + v * v / s)


def _model(coeffs, t, y, diag, mean):
    """(Phi, V, H, residual r (N,), noise variances Rn (N,), process
    noise Q (N, p, p))."""
    Phi, V, H = state_space_matrices(coeffs, t)
    r = torch.as_tensor(y, dtype=Phi.dtype, device=Phi.device) - mean
    Rn = torch.as_tensor(diag, dtype=Phi.dtype, device=Phi.device).expand(r.shape)
    Q = V[None] - Phi @ V @ Phi.transpose(1, 2)
    return Phi, V, H, r, Rn, Q


def kalman_log_likelihood(coeffs, t, y, diag, mean=0.0):
    """Sequential Kalman filter log-likelihood (the reference for the
    parallel version; the same O(N) cost class as the celerite recursion)."""
    Phi, V, H, r, Rn, Q = _model(coeffs, t, y, diag, mean)
    # first step: predictive = stationary prior
    s = H @ V @ H + Rn[0]
    K = (V @ H) / s
    m = K * r[0]
    P = V - torch.outer(K, K) * s
    terms = [_loglike_terms(r[0], s)]
    for k in range(1, r.shape[0]):
        m_pred = Phi[k] @ m
        P_pred = Phi[k] @ P @ Phi[k].T + Q[k]
        v = r[k] - H @ m_pred
        s = H @ P_pred @ H + Rn[k]
        K = (P_pred @ H) / s
        m = m_pred + K * v
        P = P_pred - torch.outer(K, K) * s
        terms.append(_loglike_terms(v, s))
    return torch.stack(terms).sum()


def _filter_elements(Phi, Q, H, r, Rn, V):
    """The associative elements (A, b, C, eta, J) of Sarkka &
    Garcia-Fernandez (2021), Lemma 8, one for each step."""
    p = Phi.shape[-1]
    S = torch.einsum("i,nij,j->n", H, Q, H) + Rn  # (N,)
    K = (Q @ H) / S[:, None]
    eye = torch.eye(p, dtype=Phi.dtype, device=Phi.device)
    ImKH = eye[None] - K[:, :, None] * H[None, None, :]
    A = ImKH @ Phi
    b = K * r[:, None]
    C = ImKH @ Q
    PhiTH = torch.einsum("nji,j->ni", Phi, H)  # Phi^T H
    eta = PhiTH * (r / S)[:, None]
    J = PhiTH[:, :, None] * PhiTH[:, None, :] / S[:, None, None]

    # the first element: the full update from the stationary prior
    s0 = H @ V @ H + Rn[0]
    K0 = (V @ H) / s0
    zero_m, zero_v = V.new_zeros((1, p, p)), V.new_zeros((1, p))
    A = torch.cat([zero_m, A[1:]])
    b = torch.cat([(K0 * r[0])[None], b[1:]])
    C = torch.cat([(V - torch.outer(K0, K0) * s0)[None], C[1:]])
    eta = torch.cat([zero_v, eta[1:]])
    J = torch.cat([zero_m, J[1:]])
    return A, b, C, eta, J


def _combine(elem_i, elem_j):
    """Associative composition (i earlier, j later), batched over the
    leading axis."""
    Ai, bi, Ci, etai, Ji = elem_i
    Aj, bj, Cj, etaj, Jj = elem_j
    p = Ai.shape[-1]
    eye = torch.eye(p, dtype=Ai.dtype, device=Ai.device).expand(Ai.shape)
    Minv = torch.linalg.solve(eye + Ci @ Jj, eye)
    AjM = Aj @ Minv
    A = AjM @ Ai
    b = (AjM @ (bi + (Ci @ etaj[..., None])[..., 0])[..., None])[..., 0] + bj
    C = AjM @ Ci @ Aj.transpose(-1, -2) + Cj
    # (I + Jj Ci)^{-1} = Minv^T for symmetric Ci, Jj
    AiT_NinvT = Ai.transpose(-1, -2) @ Minv.transpose(-1, -2)
    eta = (AiT_NinvT @ (etaj - (Jj @ bi[..., None])[..., 0])[..., None])[..., 0] + etai
    J = AiT_NinvT @ Jj @ Ai + Ji
    return A, b, C, eta, J


def _scan(elems):
    """Inclusive scan of the elements over the leading (time) axis by
    Hillis-Steele doubling: ceil(log2 N) rounds of one batched combine."""
    n = elems[0].shape[0]
    offset = 1
    while offset < n:
        later = _combine(tuple(e[:-offset] for e in elems), tuple(e[offset:] for e in elems))
        elems = tuple(torch.cat([e[:offset], x]) for e, x in zip(elems, later))
        offset *= 2
    return elems


def parallel_kalman_log_likelihood(coeffs, t, y, diag, mean=0.0):
    """Log-likelihood with O(log N) depth: a scan of the filtering
    elements, then every step's innovation term at once; -inf when a
    predictive variance is not positive."""
    Phi, V, H, r, Rn, Q = _model(coeffs, t, y, diag, mean)
    _, m_f, P_f, _, _ = _scan(_filter_elements(Phi, Q, H, r, Rn, V))
    # filtered means/covs: m_k|k = b_k, P_k|k = C_k (prior m0 = 0); the
    # innovation of step 0 from the stationary prior, of k >= 1 from the
    # filtered state of step k - 1
    m_pred = torch.einsum("nij,nj->ni", Phi[1:], m_f[:-1])
    P_pred = Phi[1:] @ P_f[:-1] @ Phi[1:].transpose(1, 2) + Q[1:]
    v = r[1:] - m_pred @ H
    s = torch.einsum("i,nij,j->n", H, P_pred, H) + Rn[1:]
    s0 = H @ V @ H + Rn[0]
    ll = torch.sum(_loglike_terms(v, s)) + _loglike_terms(r[0], s0)
    ok = torch.all(s > 0.0) & (s0 > 0.0)
    return torch.where(ok, ll, ll.new_full((), -math.inf))
