"""``GPModelling.fit_device``: the MAP fit with ``torch.optim.LBFGS`` (strong
Wolfe) on the model's device, iterates projected into the parameter box.

- The JAX package's contract (tests/test_gpmodelling.py,
  ``test_fit_device_matches_scipy``): on its DRW lightcurve (N = 400) the
  fit lands within 1e-3 in nll of ``fit()`` (scipy's L-BFGS-B) and within
  0.05 of its parameters; and within 1e-3 in nll of the JAX package's
  ``fit_device`` (optax L-BFGS).
- An optimum outside the box ends on its face, at the nll of L-BFGS-B
  there (1e-3), for a capped DRW and for the LRT's alternative with its
  log_Q on a bound; a start outside the box is clipped into it; a
  non-finite objective is 1e25 with a zero gradient, so the fit stays where
  it is finite.
- SHOTerm at Q = 0.5 +- 1e-3, where it switches between its over- and
  under-damped branches (``torch.where`` masks the other): the MAP
  objective's gradient is finite and equals the JAX package's
  (``jax.grad`` of its objective) within 1e-8 of its largest component.
- On a CUDA card: the gradient kernel against its plain version at the
  model-selection shapes the card had not run before, R = 2 (Matern32) and
  R = 4 (SHOTerm), B = 1, N = 5000; ``fit_device`` one kernel launch an
  evaluation.

JAX is imported inside the tests that compare with it, so that the ``cuda``
cases also run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fit_device.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import mind_the_gaps_tpu_torch.kernels as tk  # noqa: E402
from mind_the_gaps_tpu_torch import GappyLightcurve  # noqa: E402
from mind_the_gaps_tpu_torch.gpmodelling import GPModelling  # noqa: E402
from mind_the_gaps_tpu_torch.ops.celerite_grad import (  # noqa: E402
    celerite_log_likelihood_and_grad,
    celerite_log_likelihood_and_grad_plain,
)


@pytest.fixture(scope="module")
def drw_data():
    """tests/test_gpmodelling.py's ``drw_lightcurve``: N = 400, an exact DRW
    draw with dy = 0.3."""
    rng = np.random.default_rng(7)
    n = 400
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    true = tk.DampedRandomWalk(log_S0=np.log(4.0), log_omega0=np.log(0.05))
    K = true.covariance(np.abs(t[:, None] - t[None, :])).numpy() + np.diag(np.full(n, 0.09))
    y = 10.0 + np.linalg.cholesky(K) @ rng.normal(size=n)
    return t, y, np.full(n, 0.3)


def _drw(m, bounds=((-5, 10), (-8, 2))):
    return m.DampedRandomWalk(log_S0=0.0, log_omega0=-2.0, bounds=list(bounds))


def test_fit_device_matches_scipy(drw_data):
    gp = GPModelling(GappyLightcurve(*drw_data, exposures=1.0), _drw(tk), device="cpu")
    sol = gp.fit()
    evals = gp.timings["map_fit_evals"]
    params, nll = gp.fit_device()
    assert isinstance(params, np.ndarray) and params.shape == (2,) and isinstance(nll, float)
    assert np.isfinite(nll) and abs(nll - sol.fun) < 1e-3, (nll, sol.fun)
    np.testing.assert_allclose(params, sol.x, rtol=0.05, atol=0.05)
    assert gp.timings["map_fit_evals"] > evals and gp.timings["map_fit_launches"] == 0  # the CPU: no kernel
    np.testing.assert_allclose(-gp._loglike_and_grad(params)[0], nll, rtol=1e-14)


def test_fit_device_matches_jax(drw_data):
    import mind_the_gaps_tpu.kernels as jk
    from mind_the_gaps_tpu import GappyLightcurve as JLightcurve
    from mind_the_gaps_tpu.gpmodelling import GPModelling as JGP

    params, nll = GPModelling(GappyLightcurve(*drw_data, exposures=1.0), _drw(tk), device="cpu").fit_device()
    j_params, j_nll = JGP(JLightcurve(*drw_data, exposures=1.0), _drw(jk)).fit_device()
    assert abs(nll - j_nll) < 1e-3, (nll, j_nll)
    np.testing.assert_allclose(params, j_params, rtol=0.05, atol=0.05)


def test_fit_device_ends_on_a_face_as_lbfgsb(drw_data):
    """log_omega0 capped below its optimum (about -3.1): the fit ends on the
    face at L-BFGS-B's nll (1e-3), from a start above the cap (clipped
    first).  The JAX package's ``fit_device``, which only clips its iterates,
    stalls short of the face's optimum here, and the port's does no worse."""
    import mind_the_gaps_tpu.kernels as jk
    from mind_the_gaps_tpu import GappyLightcurve as JLightcurve
    from mind_the_gaps_tpu.gpmodelling import GPModelling as JGP

    bounds = ((-5, 10), (-8, -3.5))
    gp = GPModelling(GappyLightcurve(*drw_data, exposures=1.0), _drw(tk, bounds=bounds), device="cpu")
    sol = gp.fit(np.array([0.0, -4.0]))
    params, nll = gp.fit_device(initial_params=np.array([0.0, -2.0]))
    _, j_nll = JGP(JLightcurve(*drw_data, exposures=1.0), _drw(jk, bounds=bounds)).fit_device(
        initial_params=np.array([0.0, -2.0]))
    assert params[1] == -3.5 == sol.x[1]
    assert abs(nll - sol.fun) < 1e-3 and nll <= j_nll + 1e-3, (nll, sol.fun, j_nll)


def test_fit_device_qpo_on_a_face():
    """The Gaussian LRT's alternative (DRW + Lorentzian) on DRW-only data
    (the lrt_512 scenario's generator at N = 300): its optimum has log_Q on
    its upper bound, 6; fit_device ends there, at fit()'s nll (1e-3)."""
    rng = np.random.default_rng(0)
    n = 300
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    y = np.empty(n)
    y[0] = rng.normal(0.0, np.sqrt(np.e))
    phi = np.exp(-np.exp(-3.0) * np.diff(t))
    innov = rng.normal(0.0, np.sqrt(np.e * (1.0 - phi**2)))
    for i in range(1, n):
        y[i] = phi[i - 1] * y[i - 1] + innov[i - 1]
    dy = np.full(n, 0.3)
    lc = GappyLightcurve(t, y + 10.0 + rng.normal(0.0, dy), dy, exposures=1.0)
    alt = (tk.DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
           + tk.Lorentzian(log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)]))
    gp = GPModelling(lc, alt, device="cpu")
    sol = gp.fit()
    params, nll = gp.fit_device()
    assert sol.x[3] == 6.0 and params[3] == 6.0
    assert abs(nll - sol.fun) < 1e-3, (nll, sol.fun)


def test_non_finite_objective_is_a_wall(drw_data, monkeypatch):
    """Where the log-likelihood is not finite (here: NaN for log_S0 > 0.8,
    below the optimum's 1.4), the objective is 1e25 with a zero gradient:
    the fit stays inside the finite region and improves on its start there."""
    lc = GappyLightcurve(*(a[:200] for a in drw_data), exposures=1.0)
    gp = GPModelling(lc, _drw(tk), device="cpu")
    real = gp._map_loglike
    monkeypatch.setattr(gp, "_map_loglike", lambda th: torch.where(th[0] > 0.8, torch.nan, real(th)))
    params, nll = gp.fit_device(max_iters=30)
    assert np.isfinite(nll) and params[0] <= 0.8
    assert nll < -gp._loglike_and_grad(gp.initial_params)[0]


@pytest.mark.parametrize("dq", [-1e-3, 0.0, 1e-3])
def test_sho_gradient_finite_at_critical_damping(drw_data, dq):
    import jax
    import jax.numpy as jnp

    import mind_the_gaps_tpu.kernels as jk
    from mind_the_gaps_tpu.solver import log_likelihood as j_loglike

    t, y, dy = (a[:200] for a in drw_data)
    theta = np.array([1.0, np.log(0.5 + dq), -2.5])
    bounds = [(-5, 8), (-3, 5), (-8, 2)]
    gp = GPModelling(GappyLightcurve(t, y, dy, exposures=1.0), tk.SHOTerm(*theta, bounds=bounds), device="cpu")
    ll, grad = gp._loglike_and_grad(theta)
    assert np.isfinite(ll) and np.all(np.isfinite(grad))
    jkern = jk.SHOTerm(*theta, bounds=bounds)

    def f(th):
        return j_loglike(jkern.coefficients(th), t, y - np.mean(y), (dy + 1e-12) ** 2)

    ll_ref, g_ref = jax.value_and_grad(f)(jnp.asarray(theta))
    np.testing.assert_allclose(ll, float(ll_ref), rtol=1e-10)
    assert np.max(np.abs(grad - np.asarray(g_ref))) <= 1e-8 * np.max(np.abs(np.asarray(g_ref)))
    params, nll = gp.fit_device(max_iters=20)
    assert np.isfinite(nll) and np.all(np.isfinite(params))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the gradient kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["matern32", "sho_under", "sho_over"])
def test_gradient_kernel_new_widths_on_card(cuda, name):
    """R = 2 (Matern32's regularised complex term) and R = 4 (SHOTerm's two
    real and one complex slot, either branch live) at the MAP fit's shape."""
    kernel = {"matern32": tk.Matern32Term(0.0, 2.0), "sho_under": tk.SHOTerm(0.0, 1.0, -2.0),
              "sho_over": tk.SHOTerm(0.0, -1.5, -2.0)}[name]
    rng = np.random.default_rng(2)
    t = torch.as_tensor(np.cumsum(rng.uniform(2.0, 8.0, 5000)), device=cuda)
    th = torch.as_tensor(kernel.get_parameter_vector()[None], device=cuda)
    x = dict(coeffs=kernel.coefficients(th), t=t, y=torch.as_tensor(10.0 + rng.normal(0, 2.0, 5000), device=cuda),
             diag=torch.full((5000,), 0.09, dtype=torch.float64, device=cuda),
             mean=torch.full((1,), 10.0, dtype=torch.float64, device=cuda),
             extra_diag=torch.zeros(1, dtype=torch.float64, device=cuda))
    R = x["coeffs"].ar.shape[1] + 2 * x["coeffs"].ac.shape[1]
    assert R == (2 if name == "matern32" else 4)
    before = celerite_log_likelihood_and_grad.launches
    ll, grads = celerite_log_likelihood_and_grad(**x)
    torch.cuda.synchronize()
    assert celerite_log_likelihood_and_grad.launches == before + 1
    ll_ref, g_ref = celerite_log_likelihood_and_grad_plain(**x)
    torch.testing.assert_close(ll, ll_ref, rtol=1e-10, atol=0)
    for g, r in zip(grads, g_ref):
        if r.numel():
            assert float((g - r).abs().max()) <= 1e-8 * float(r.abs().max().clamp_min(1e-300))


@pytest.mark.cuda
def test_fit_device_on_card(cuda, drw_data):
    lc = GappyLightcurve(*drw_data, exposures=1.0)
    cpu_params, cpu_nll = GPModelling(lc, _drw(tk), device="cpu").fit_device()
    gp = GPModelling(lc, _drw(tk), device=cuda)
    params, nll = gp.fit_device()
    assert gp.timings["map_fit_launches"] == gp.timings["map_fit_evals"] > 0
    assert abs(nll - gp.fit().fun) < 1e-3 and abs(nll - cpu_nll) < 1e-6
