"""The port's Kalman solvers (``solver/kalman.py``) against the JAX package's
and against the port's celerite recursion (``solver.log_likelihood``), in
float64 on the CPU, for the terms of tests/test_kalman.py:

- the sequential filter and the parallel (Hillis-Steele scan) filter,
  each within rtol 1e-8 of the JAX function of the same name and of the
  celerite recursion;
- the state-space matrices equal to the JAX package's (rtol 1e-14);
- the parallel filter's gradient by autograd against ``jax.grad`` of the
  JAX parallel filter (rtol 1e-6, atol 1e-8, the JAX suite's tolerances);
- the scan's prefix at every step equal to the sequential filter's
  filtered state (rtol 1e-9);
- a non-positive predictive variance gives -inf.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mind_the_gaps_tpu.kernels as jk  # noqa: E402
import mind_the_gaps_tpu_torch.kernels as tk  # noqa: E402
from mind_the_gaps_tpu.solver import kalman as jkal  # noqa: E402
from mind_the_gaps_tpu_torch.solver import kalman as tkal  # noqa: E402
from mind_the_gaps_tpu_torch.solver import (  # noqa: E402
    kalman_log_likelihood,
    log_likelihood,
    parallel_kalman_log_likelihood,
)

KERNELS = {
    "drw": lambda m: m.DampedRandomWalk(0.5, -2.0),
    "real2": lambda m: m.RealTerm(0.3, -1.2) + m.RealTerm(-0.5, -2.5),
    "lorentzian": lambda m: m.Lorentzian(0.0, 1.5, -1.0),
    "drw+lor": lambda m: m.DampedRandomWalk(0.5, -2.0) + m.Lorentzian(0.0, 1.5, -1.0),
    "sho_hiQ": lambda m: m.SHOTerm(0.2, 1.3, -0.5),
    "sho_loQ_under": lambda m: m.SHOTerm(0.2, np.log(0.6), -0.5),  # b > a regime
    "cosinus": lambda m: m.Cosinus(-0.3, -0.7),
}


def _problem(n=400, seed=0):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.uniform(1.0, 4.0, n)), rng.normal(0.0, 2.0, n), rng.uniform(0.01, 0.1, n)


def _coeffs(name):
    jkern, tkern = KERNELS[name](jk), KERNELS[name](tk)
    return (jkern.coefficients(jnp.asarray(jkern.get_parameter_vector())),
            tkern.coefficients(torch.as_tensor(tkern.get_parameter_vector())))


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("which", ["sequential", "parallel"])
def test_kalman_matches_jax_and_celerite(name, which):
    t, y, diag = _problem(seed=zlib.crc32(name.encode()) % 1000)
    jc, tc = _coeffs(name)
    fn, jfn = {"sequential": (kalman_log_likelihood, jkal.kalman_log_likelihood),
               "parallel": (parallel_kalman_log_likelihood, jkal.parallel_kalman_log_likelihood)}[which]
    got = fn(tc, torch.as_tensor(t), torch.as_tensor(y), torch.as_tensor(diag), mean=0.3)
    assert got.dtype == torch.float64 and got.shape == ()
    ref = float(jax.jit(lambda: jfn(jc, t, y, diag, mean=0.3))())
    np.testing.assert_allclose(float(got), ref, rtol=1e-8)
    np.testing.assert_allclose(float(got), float(log_likelihood(tc, t, y, diag, mean=0.3)), rtol=1e-8)


@pytest.mark.parametrize("name", ["drw+lor", "sho_loQ_under", "real2"])
def test_state_space_matrices_match_jax(name):
    t, _, _ = _problem(n=50, seed=1)
    jc, tc = _coeffs(name)
    for got, ref in zip(tkal.state_space_matrices(tc, torch.as_tensor(t)), jkal.state_space_matrices(jc, t)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-14, atol=1e-300)


def test_parallel_kalman_gradients_match_jax():
    jkern, tkern = KERNELS["drw+lor"](jk), KERNELS["drw+lor"](tk)
    t, y, diag = _problem(n=200, seed=3)
    theta = torch.as_tensor(tkern.get_parameter_vector(), dtype=torch.float64).requires_grad_(True)
    (-parallel_kalman_log_likelihood(tkern.coefficients(theta), t, y, diag)).backward()

    def nll(th):
        return -jkal.parallel_kalman_log_likelihood(jkern.coefficients(th), t, y, diag)

    ref = np.asarray(jax.jit(jax.grad(nll))(jnp.asarray(jkern.get_parameter_vector())))
    np.testing.assert_allclose(theta.grad.numpy(), ref, rtol=1e-6, atol=1e-8)


def test_scan_prefixes_are_the_filtered_states():
    """The k-th element of the scan is the filtered mean and covariance
    after step k, as the sequential filter carries them."""
    t, y, diag = _problem(n=37, seed=4)  # not a power of two: the last round is partial
    _, tc = _coeffs("drw+lor")
    Phi, V, H, r, Rn, Q = tkal._model(tc, torch.as_tensor(t), torch.as_tensor(y), torch.as_tensor(diag), 0.0)
    _, b, C, _, _ = tkal._scan(tkal._filter_elements(Phi, Q, H, r, Rn, V))
    s = H @ V @ H + Rn[0]
    K = (V @ H) / s
    m, P = K * r[0], V - torch.outer(K, K) * s
    for k in range(len(t)):
        if k:
            m_pred, P_pred = Phi[k] @ m, Phi[k] @ P @ Phi[k].T + Q[k]
            s = H @ P_pred @ H + Rn[k]
            K = (P_pred @ H) / s
            m, P = m_pred + K * (r[k] - H @ m_pred), P_pred - torch.outer(K, K) * s
        torch.testing.assert_close(b[k], m, rtol=1e-9, atol=1e-12)
        torch.testing.assert_close(C[k], P, rtol=1e-9, atol=1e-12)


def test_not_positive_definite_gives_minus_inf():
    t, y, diag = _problem(n=60, seed=5)
    _, tc = _coeffs("drw")
    tc = tc._replace(ar=-tc.ar)  # a negative variance
    assert float(parallel_kalman_log_likelihood(tc, t, y, diag)) == -np.inf
