"""The port's model selection (``selection.compare_models``) on the CPU.

- The JAX suite's "prefers the true kernel" case (tests/test_selection.py:
  a pure DRW at N = 300, DRW against DRW + QPO, 12 walkers x 400 steps,
  seed 4), run on the port with ``device="cpu"``.
- At the port's own ``max_parameters`` of each candidate: its
  ``max_loglikelihood`` against the JAX solver's log-likelihood there (rtol
  1e-10; the chain's float64 log-probabilities are the celerite
  likelihood inside the flat prior), its residuals against the JAX
  ``GPModelling.loo_residuals`` / ``standarized_residuals`` at the same
  parameters (rtol 1e-8), and the KS statistic of the JAX residuals (abs
  1e-10).  JAX's threefry chains and the port's Philox chains cannot match,
  so the comparison is at shared parameters.
- ``residuals="standardized"`` and the refusal of another value; the LOO
  residuals at the true parameters against the dense K^-1 (the JAX suite's
  calibration case).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import mind_the_gaps_tpu.kernels as jk  # noqa: E402
import mind_the_gaps_tpu_torch.kernels as tk  # noqa: E402
from mind_the_gaps_tpu_torch import GappyLightcurve  # noqa: E402
from mind_the_gaps_tpu_torch.selection import compare_models  # noqa: E402

TRUE = (np.log(4.0), np.log(0.05))


def _kernels(m):
    return {
        "drw": m.DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)]),
        "drw+qpo": m.DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
        + m.Lorentzian(log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)]),
    }


@pytest.fixture(scope="module")
def drw_data():
    """tests/test_selection.py's data: a pure DRW, noise comparable to the
    signal."""
    rng = np.random.default_rng(7)
    n = 300
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    true = jk.DampedRandomWalk(log_S0=TRUE[0], log_omega0=TRUE[1])
    K = np.array(true.covariance(np.abs(t[:, None] - t[None, :]))) + np.diag(np.full(n, 4.0))
    y = 10.0 + np.linalg.cholesky(K) @ rng.normal(size=n)
    return t, y, np.full(n, 2.0)


@pytest.fixture(scope="module")
def results(drw_data):
    lc = GappyLightcurve(*drw_data, exposures=1.0)
    return compare_models(lc, _kernels(tk), max_steps=400, walkers=12, converge=False, seed=4, device="cpu")


def test_compare_models_prefers_true_kernel(results):
    assert [r.name for r in results] != []
    assert results[0].aicc <= results[-1].aicc
    assert abs(sum(r.akaike_weight for r in results) - 1.0) < 1e-12
    assert results[0].name == "drw"
    assert results[0].ks_pvalue > 0.01
    assert np.isfinite(results[0].max_loglikelihood)
    assert results[0].delta_aicc == 0.0
    for r in results:
        assert r.model.device.type == "cpu" and r.model.sampler.iteration == 400 and r.k == r.model.k


def test_candidates_seeded_in_turn(drw_data):
    """Candidate i samples with seed + i: the same walkers and chain as a
    GPModelling of its own given that seed."""
    from mind_the_gaps_tpu_torch.gpmodelling import GPModelling

    t, y, dy = (a[:80] for a in drw_data)
    lc = GappyLightcurve(t, y, dy, exposures=1.0)
    kernels = _kernels(tk)
    got = compare_models(lc, kernels, max_steps=20, walkers=8, converge=False, seed=10, device="cpu")
    for i, (name, kernel) in enumerate(kernels.items()):
        gp = GPModelling(lc, kernel, device="cpu")
        gp.derive_posteriors(max_steps=20, walkers=8, converge=False, seed=10 + i)
        model = next(r.model for r in got if r.name == name)
        np.testing.assert_array_equal(model.sampler.get_chain(), gp.sampler.get_chain())


@pytest.mark.parametrize("name", ["drw", "drw+qpo"])
def test_at_max_parameters_matches_jax(results, drw_data, name):
    from scipy.stats import kstest, norm

    from mind_the_gaps_tpu import GappyLightcurve as JLightcurve
    from mind_the_gaps_tpu.gpmodelling import GPModelling as JGP
    from mind_the_gaps_tpu.solver import log_likelihood as j_loglike

    r = next(r for r in results if r.name == name)
    theta = np.asarray(r.model.max_parameters)
    t, y, dy = drw_data
    jkern = _kernels(jk)[name]
    ll = float(j_loglike(jkern.coefficients(theta), t, y - np.mean(y), (dy + 1e-12) ** 2))
    np.testing.assert_allclose(r.max_loglikelihood, ll, rtol=1e-10)

    jgp = JGP(JLightcurve(t, y, dy, exposures=1.0), jkern)
    loo = np.asarray(jgp.loo_residuals(parameters=theta))
    np.testing.assert_allclose(r.model.loo_residuals(parameters=theta), loo, rtol=1e-8)
    np.testing.assert_allclose(r.model.standarized_residuals(parameters=theta),
                               np.asarray(jgp.standarized_residuals(parameters=theta)), rtol=1e-8)
    assert abs(r.ks_statistic - kstest(loo, norm.cdf).statistic) <= 1e-10


def test_residuals_kwarg(drw_data):
    lc = GappyLightcurve(*drw_data, exposures=1.0)
    kernels = {"drw": _kernels(tk)["drw"]}
    with pytest.raises(ValueError, match="residuals"):
        compare_models(lc, kernels, residuals="nope", device="cpu")
    res = compare_models(lc, kernels, max_steps=100, walkers=8, converge=False, seed=7, residuals="standardized",
                         device="cpu")
    from scipy.stats import kstest, norm

    gp = res[0].model
    assert np.isfinite(res[0].ks_pvalue) and res[0].akaike_weight == 1.0
    ks = kstest(gp.standarized_residuals(parameters=gp.max_parameters), norm.cdf)
    assert res[0].ks_statistic == ks.statistic and res[0].ks_pvalue == ks.pvalue


def test_loo_residuals_calibrated(drw_data):
    from scipy.stats import kstest, norm

    from mind_the_gaps_tpu_torch.gpmodelling import GPModelling

    t, y, dy = drw_data
    lc = GappyLightcurve(t, y, dy, exposures=1.0)
    gp = GPModelling(lc, tk.DampedRandomWalk(log_S0=TRUE[0], log_omega0=TRUE[1]), device="cpu")
    res = gp.loo_residuals()
    assert abs(np.std(res) - 1.0) < 0.15 and kstest(res, norm.cdf).pvalue > 0.01
    true = jk.DampedRandomWalk(log_S0=TRUE[0], log_omega0=TRUE[1])
    K = np.array(true.covariance(np.abs(t[:, None] - t[None, :]))) + np.diag((dy + 1e-12) ** 2)
    Kinv = np.linalg.inv(K)
    np.testing.assert_allclose(res, (Kinv @ (y - lc.mean)) / np.sqrt(np.diag(Kinv)), rtol=1e-7, atol=1e-9)
