"""Port parity: ``GPModelling`` with a fitted mean model, the multi-chain
sampler and the chain diagnostics, against the JAX package on the CPU.

- ``fit`` with the constant, linear and gaussian mean models from the same
  start: the optimum log-likelihood within 1e-6 and the parameters within
  1e-3 (the same objective and exact gradients through scipy's L-BFGS-B);
- ``log_prob_batch`` with each fitted mean model against the JAX package's
  float64 ``_logprob_batch`` at random parameters: rtol 1e-10;
- ``sample_ensemble_grouped`` given the same draws equals C separate
  ``sample_ensemble_impl`` runs bit for bit, and ``max_loglike_ensemble_impl``
  the running maximum of a ``sample_ensemble_impl`` chain; the bootstrap
  refits' run (``lrt._ShardRun``) fed the draws of a grouped run walks its
  chain and ends at each row's running maximum, bit for bit; neither
  sampler writes into its initial state;
- ``derive_posteriors(chains=4)``: the contracts of
  test_gpmodelling.py::test_derive_posteriors_multi_chain at a smaller size
  (50 points, 200 steps);
- ``get_rstat`` (exact) and ``get_autocorr_time`` (the JAX estimator runs
  its FFT in float32: rtol 1e-4) on a chain carried from the JAX package.
"""
import io
import warnings

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import mind_the_gaps_tpu as mtg  # noqa: E402
import mind_the_gaps_tpu.kernels as jk  # noqa: E402
import mind_the_gaps_tpu_torch.kernels as tk  # noqa: E402
from mind_the_gaps_tpu.gpmodelling import GPModelling as JGP  # noqa: E402
from mind_the_gaps_tpu_torch.convert import lightcurve_from_jax, posteriors_from_jax  # noqa: E402
from mind_the_gaps_tpu_torch.gpmodelling import AutocorrError, ChainResult  # noqa: E402
from mind_the_gaps_tpu_torch.gpmodelling import GPModelling as TGP  # noqa: E402
from mind_the_gaps_tpu_torch.sampler import (  # noqa: E402
    max_loglike_ensemble_impl,
    sample_ensemble_grouped,
    sample_ensemble_impl,
    stretch_draws,
)


def _lightcurve(n=100, seed=7, slope=0.01):
    """An exact DRW realization plus noise on a linear trend."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    true = jk.DampedRandomWalk(log_S0=np.log(4.0), log_omega0=np.log(0.05))
    K = np.array(true.covariance(np.abs(t[:, None] - t[None, :]))) + np.diag(np.full(n, 0.09))
    y = 10.0 + slope * (t - t.mean()) + np.linalg.cholesky(K) @ rng.normal(size=n)
    return mtg.GappyLightcurve(t, y, np.full(n, 0.3), exposures=1.0)


def _kernel(m):
    return m.DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])


@pytest.mark.parametrize("mean_model", ["constant", "linear", "gaussian"])
def test_fit_with_a_fitted_mean_matches_jax(mean_model):
    lc = _lightcurve()
    gj = JGP(lc, _kernel(jk), mean_model=mean_model)
    gt = TGP(lightcurve_from_jax(lc), _kernel(tk), mean_model=mean_model, device="cpu")
    np.testing.assert_array_equal(gt.initial_params, gj.initial_params)
    ref, out = gj.fit(), gt.fit()
    assert np.isfinite(out.fun) and gt.timings["map_fit_evals"] == out.nfev
    assert gt.timings["map_fit_launches"] == 0  # the CPU runs the plain version
    np.testing.assert_allclose(-out.fun, -ref.fun, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.x, ref.x, atol=1e-3)


@pytest.mark.parametrize("mean_model", ["constant", "linear", "gaussian"])
def test_log_prob_batch_with_a_fitted_mean_matches_jax(mean_model):
    lc = _lightcurve(n=80, seed=3)
    gj = JGP(lc, _kernel(jk), mean_model=mean_model)
    gt = TGP(lightcurve_from_jax(lc), _kernel(tk), mean_model=mean_model, device="cpu")
    rng = np.random.default_rng(11)
    thetas = gj.initial_params[None, :] * (1.0 + 0.03 * rng.standard_normal((8, gj.k)))
    bounds = np.array(gj.get_parameter_bounds(), dtype=float)
    inside = np.isfinite(bounds).all(1)  # draw those within their bounds (the gaussian's guess lies outside)
    lo, hi = bounds[inside, 0], bounds[inside, 1]
    thetas[:, inside] = lo + (hi - lo) * rng.uniform(0.2, 0.8, (8, inside.sum()))
    thetas[0, 0] = 11.0  # outside the kernel's prior bounds: -inf in both
    ref = np.asarray(gj._logprob_batch(jnp.asarray(thetas)))
    out = gt.log_prob_batch(torch.as_tensor(thetas)).numpy()
    assert out[0] == ref[0] == -np.inf and np.all(np.isfinite(ref[1:]))
    np.testing.assert_allclose(out[1:], ref[1:], rtol=1e-10)


def _logp(theta):  # a row-wise target: the same bits whatever the batch
    return -0.5 * (theta * theta).sum(-1) - 0.1 * theta[..., 0]


def test_grouped_sampler_equals_separate_runs():
    C, W, D, steps = 3, 6, 2, 40
    init = torch.as_tensor(np.random.default_rng(0).normal(size=(C, W, D)))
    draws = stretch_draws(steps, (C, W // 2), torch.float64, "cpu", torch.Generator().manual_seed(5))
    chain, lps, acc, final = sample_ensemble_grouped(_logp, init, steps, draws=draws)
    assert chain.shape == (steps, C, W, D) and lps.shape == (steps, C, W)
    accs = []
    for c in range(C):
        one = sample_ensemble_impl(_logp, init[c], steps, draws=tuple(d[:, :, c] for d in draws))
        torch.testing.assert_close(chain[:, c], one[0], rtol=0, atol=0)
        torch.testing.assert_close(lps[:, c], one[1], rtol=0, atol=0)
        torch.testing.assert_close(final[c], one[3], rtol=0, atol=0)
        accs.append(float(one[2]))
    np.testing.assert_allclose(float(acc), np.mean(accs), rtol=1e-6)  # the fractions are float32


def test_max_loglike_ensemble_is_the_running_maximum():
    W, D, steps = 8, 3, 30
    init = torch.as_tensor(np.random.default_rng(1).normal(size=(W, D)))
    draws = stretch_draws(steps, (W // 2,), torch.float64, "cpu", torch.Generator().manual_seed(2))
    chain, lps, _, final = sample_ensemble_impl(_logp, init, steps, draws=draws)
    best_lp, best_x, state, logp = max_loglike_ensemble_impl(_logp, init, steps, draws=draws)
    all_lp = torch.cat([_logp(init)[None], lps])
    all_x = torch.cat([init[None], chain])
    flat = int(torch.argmax(all_lp.reshape(-1)))
    assert float(best_lp) == float(all_lp.reshape(-1)[flat])
    torch.testing.assert_close(best_x, all_x.reshape(-1, D)[flat], rtol=0, atol=0)
    torch.testing.assert_close(state, final, rtol=0, atol=0)
    torch.testing.assert_close(logp, lps[-1], rtol=0, atol=0)


@pytest.mark.parametrize("tol", [None, 0.05])
def test_refit_run_steps_the_grouped_chain_and_keeps_its_running_maximum(tol):
    from mind_the_gaps_tpu_torch.lrt import _ShardRun

    G, W, D, steps = 3, 6, 2, 25
    init = torch.as_tensor(np.random.default_rng(4).normal(size=(G, W, D)))
    draws = stretch_draws(steps, (G, W // 2), torch.float64, "cpu", torch.Generator().manual_seed(6))
    chain, lps, _, final = sample_ensemble_grouped(_logp, init, steps, draws=draws)
    all_lp = torch.cat([_logp(init)[None], lps])  # (steps + 1, G, W)
    all_x = torch.cat([init[None], chain])
    run = _ShardRun(_logp, init.clone(), slice(0, G))
    for i in range(steps):
        improved = run.step(tuple(d[i : i + 1] for d in draws), 2.0, tol)
        if tol is None:
            assert improved is None
        else:  # some row's best of this step above its best so far by more than tol
            best = all_lp[: i + 1].amax(dim=(0, 2))
            assert bool(improved) == bool(torch.any(all_lp[i + 1].amax(1) > best + tol))
    assert run.launches == 2 * (steps + 1)
    torch.testing.assert_close(run.state, final, rtol=0, atol=0)
    torch.testing.assert_close(run.logp, lps[-1], rtol=0, atol=0)
    flat = torch.argmax(all_lp.transpose(0, 1).reshape(G, -1), dim=1)  # each row's first maximum, step by step
    rows = torch.arange(G)
    torch.testing.assert_close(run.best_lp, all_lp.transpose(0, 1).reshape(G, -1)[rows, flat], rtol=0, atol=0)
    torch.testing.assert_close(run.best_x, all_x.transpose(0, 1).reshape(G, -1, D)[rows, flat], rtol=0, atol=0)


@pytest.mark.parametrize("as_numpy", [False, True], ids=["tensor", "numpy"])
def test_samplers_leave_their_initial_state(as_numpy):
    init = np.random.default_rng(5).normal(size=(2, 6, 3))
    kept = init.copy()
    given = init if as_numpy else torch.as_tensor(init)  # as_tensor shares the array's memory
    final = sample_ensemble_grouped(_logp, given, 10, generator=torch.Generator().manual_seed(7))[3]
    assert not np.array_equal(final.numpy(), kept)  # the walkers moved
    max_loglike_ensemble_impl(_logp, given[0], 10, generator=torch.Generator().manual_seed(8))
    np.testing.assert_array_equal(np.asarray(given), kept)


def test_derive_posteriors_multi_chain():
    lc = lightcurve_from_jax(_lightcurve(n=50, seed=7, slope=0.0))
    kernel = _kernel(tk)
    runs = []
    for _ in range(2):
        gp = TGP(lc, kernel, device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # short chains: "did not converge"
            gp.derive_posteriors(max_steps=200, convergence_steps=100, walkers=8, chains=4, seed=11, fit=False)
        runs.append(gp)
    gp = runs[0]
    samples = gp.mcmc_samples
    assert gp.sampler.get_chain().shape == (200, 32, 2)
    assert samples.shape[1] == 2 and len(samples) > 100
    assert np.all(np.isfinite(gp.loglikelihoods))
    assert abs(gp.median_parameters[0] - np.log(4.0)) < 1.5
    assert abs(gp.median_parameters[1] - np.log(0.05)) < 1.5
    assert gp.get_rstat(burnin=50).shape == (32, 2)
    chain = gp.sampler.get_chain(discard=50)
    per_chain_med = np.median(chain.reshape(chain.shape[0], 4, 8, 2), axis=(0, 2))
    assert np.all(np.ptp(per_chain_med, axis=0) < 2.0)
    np.testing.assert_array_equal(samples, runs[1].mcmc_samples)
    with pytest.raises(ValueError, match="chains, walkers, ndim"):
        gp.derive_posteriors(initial_chain_params=np.zeros((8, 2)), chains=4)


def _ar1_chain(n=400, w=8, d=2, phi=0.9, seed=4):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, w, d))
    eps = rng.normal(size=(n, w, d))
    for i in range(1, n):
        x[i] = phi * x[i - 1] + eps[i]
    return x


def _carried(chain):
    """A JAX GPModelling holding ``chain``, and a port one carrying it."""
    lc = _lightcurve(n=40, seed=9)
    gj = JGP(lc, _kernel(jk))
    buf = io.BytesIO()
    np.savez(buf, chain=chain, log_probs=-0.5 * (chain**2).sum(-1), tau=np.full(2, 9.0), converged=True,
             autocorr=np.array([9.0]), mcmc_samples=chain[100::5].reshape(-1, 2),
             loglikelihoods=-0.5 * (chain[100::5] ** 2).sum(-1).reshape(-1))
    buf.seek(0)
    gj.load_posteriors(buf)
    gt = TGP(lightcurve_from_jax(lc), _kernel(tk), device="cpu")
    posteriors_from_jax(gj, gt)
    return gj, gt


def test_rstat_and_autocorr_time_on_a_carried_chain():
    gj, gt = _carried(_ar1_chain())
    for burnin in (None, 50):
        np.testing.assert_allclose(gt.get_rstat(burnin), gj.get_rstat(burnin), rtol=1e-12)
    tau_t = gt.sampler.get_autocorr_time()
    np.testing.assert_allclose(tau_t, np.asarray(gj.sampler.get_autocorr_time()), rtol=1e-4)
    assert np.all(tau_t > 3.0)
    with pytest.raises(AutocorrError, match="autocorrelation time") as err:
        gt.sampler.get_autocorr_time(tol=1000)
    assert isinstance(err.value, RuntimeError) and err.value.tau.shape == (2,)
    short = ChainResult(np.random.default_rng(1).normal(size=(60, 8, 2)), np.zeros((60, 8)))
    assert short.get_autocorr_time().shape == (2,)
    with pytest.raises(ValueError):
        TGP(gt._lightcurve, _kernel(tk), device="cpu").get_rstat()
