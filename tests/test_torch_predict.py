"""Port parity: the solver's factor / solve / inverse_diag / predict /
predict_at tiers and ``GPModelling.predict`` / ``standarized_residuals`` /
``loo_residuals``, against the JAX package on the configurations of
tests/test_solver.py (solve and log-determinant, predict against dense,
predict_at at test points before, inside and after the data) and a fitted
mean.  Tolerance: rtol 1e-8 in float64 (the same recursions; only the
order of a few sums differs)."""
import zlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import mind_the_gaps_tpu as mtg  # noqa: E402
import mind_the_gaps_tpu.kernels as jk  # noqa: E402
import mind_the_gaps_tpu.solver.semiseparable as jss  # noqa: E402
import mind_the_gaps_tpu_torch.kernels as tk  # noqa: E402
import mind_the_gaps_tpu_torch.solver.semiseparable as tss  # noqa: E402
from mind_the_gaps_tpu.gpmodelling import GPModelling as JGP  # noqa: E402
from mind_the_gaps_tpu_torch.convert import lightcurve_from_jax  # noqa: E402
from mind_the_gaps_tpu_torch.gpmodelling import GPModelling as TGP  # noqa: E402

RTOL = 1e-8

CONFIGS = {  # tests/test_solver.py:116, :171 and :220's three kernels
    "sho_real": (lambda m: m.SHOTerm(0.2, 1.3, -0.5) + m.RealTerm(0.3, -1.2), 300, 100.0),
    "drw": (lambda m: m.DampedRandomWalk(0.5, -1.5), 150, 100.0),
    "complex": (lambda m: m.Lorentzian(-0.5, 1.5, -1.0), 140, 300.0),
    "mixed": (lambda m: m.DampedRandomWalk(0.5, -2.0) + m.Lorentzian(-0.5, 1.5, -1.0) + m.SHOTerm(0.2, 0.3, -1.5),
              140, 300.0),
}


def _data(name):
    make, n, span = CONFIGS[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    t = np.sort(rng.uniform(0, span, n)) + np.arange(n) * 1e-9
    y = rng.normal(0.0, 2.0, n)
    diag = rng.uniform(0.05, 0.2, n)
    kj, kt = make(jk), make(tk)
    return kj, kt, t, y, diag


@pytest.mark.parametrize("name", ["sho_real", "drw"])
def test_factor_solve_inverse_diag_predict_match_jax(name):
    kj, kt, t, y, diag = _data(name)
    cj = kj.coefficients(jnp.asarray(kj.get_parameter_vector()))
    ct = kt.coefficients(torch.as_tensor(kt.get_parameter_vector()))
    mj, mt = jss.build_matrices(cj, t, diag), tss.build_matrices(ct, torch.as_tensor(t), torch.as_tensor(diag))
    Dj, Wj, okj = jss.factor(mj)
    Dt, Wt, okt = tss.factor(mt)
    assert bool(okj) and bool(okt)
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), rtol=RTOL)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), rtol=RTOL, atol=1e-12 * float(np.abs(Wj).max()))
    x = tss.solve(mt, Dt, Wt, torch.as_tensor(y))
    np.testing.assert_allclose(x.numpy(), np.asarray(jss.solve(mj, Dj, Wj, jnp.asarray(y))), rtol=RTOL)
    np.testing.assert_allclose(tss.inverse_diag(mt, Dt, Wt).numpy(), np.asarray(jss.inverse_diag(mj, Dj, Wj)),
                               rtol=RTOL)
    mu, var = tss.predict(ct, torch.as_tensor(t), torch.as_tensor(y), torch.as_tensor(diag), mean=0.4)
    mu_j, var_j = jss.predict(cj, t, y, diag, mean=0.4)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), rtol=RTOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), rtol=RTOL)
    pm = tss.predict_mean(ct, torch.as_tensor(t), torch.as_tensor(y), torch.as_tensor(diag), mean=0.4)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jss.predict_mean(cj, t, y, diag, mean=0.4)), rtol=RTOL)


def test_predict_at_matches_jax():
    """The mixed kernel of tests/test_solver.py:220 (real, complex and SHO
    columns), at test points before, inside and after the data and at
    training times."""
    kj, kt, t, y, diag = _data("mixed")
    n = t.shape[0]
    t_pred = np.sort(np.concatenate([np.linspace(t[0] - 10, t[-1] + 20, 67), t[[3, n // 2, n - 5]], [t[10] + 1e-9]]))
    cj = kj.coefficients(jnp.asarray(kj.get_parameter_vector()))
    ct = kt.coefficients(torch.as_tensor(kt.get_parameter_vector()))
    mu_j, var_j = jss.predict_at(cj, t, y, diag, t_pred, mean=0.2)
    mu, var = tss.predict_at(ct, torch.as_tensor(t), torch.as_tensor(y), torch.as_tensor(diag),
                             torch.as_tensor(t_pred), mean=0.2)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), rtol=RTOL, atol=1e-12)
    mu_only = tss.predict_at(ct, torch.as_tensor(t), torch.as_tensor(y), torch.as_tensor(diag),
                             torch.as_tensor(t_pred), mean=0.2, return_var=False)
    np.testing.assert_allclose(mu_only.numpy(), mu.numpy(), rtol=1e-14)


def _lightcurve(n=120, seed=7):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    true = jk.DampedRandomWalk(log_S0=np.log(4.0), log_omega0=np.log(0.05))
    K = np.array(true.covariance(np.abs(t[:, None] - t[None, :]))) + np.diag(np.full(n, 0.09))
    y = 10.0 + 0.01 * t + np.linalg.cholesky(K) @ rng.normal(size=n)
    return mtg.GappyLightcurve(t, y, np.full(n, 0.3), exposures=1.0)


def test_gpmodelling_predict_and_residuals_match_jax():
    """With a fitted linear mean and a jitter term, at parameters away from
    the current vector."""
    mean_model = "linear"
    lc = _lightcurve()
    kj = jk.DampedRandomWalk(np.log(4.0), np.log(0.05)) + jk.JitterTerm(-2.0)
    kt = tk.DampedRandomWalk(np.log(4.0), np.log(0.05)) + tk.JitterTerm(-2.0)
    gj, gt = JGP(lc, kj, mean_model=mean_model), TGP(lightcurve_from_jax(lc), kt, mean_model=mean_model,
                                                        device="cpu")
    params = gj.get_parameter_vector() * (1.0 + 0.01 * np.arange(gj.k))
    np.testing.assert_allclose(gt.standarized_residuals(parameters=params),
                               gj.standarized_residuals(parameters=params), rtol=RTOL)
    np.testing.assert_allclose(gt.loo_residuals(parameters=params), gj.loo_residuals(parameters=params), rtol=RTOL)
    t_pred = np.linspace(lc.times[5], lc.times[60], 29)
    for a, b in zip(gt.predict(t_pred, parameters=params, include_noise=True),
                    gj.predict(t_pred, parameters=params, include_noise=True)):
        np.testing.assert_allclose(a, b, rtol=RTOL)
    mu_train, var_train = gt.predict(parameters=params)
    res = (lc.y - mu_train) / np.sqrt(var_train + np.exp(2.0 * params[2]))  # the residuals' pieces, jitter added
    np.testing.assert_allclose(res, gt.standarized_residuals(parameters=params), rtol=1e-12)
    np.testing.assert_allclose(gt.predict(t_pred, parameters=params, return_var=False),
                               gt.predict(t_pred, parameters=params)[0], rtol=1e-14)
