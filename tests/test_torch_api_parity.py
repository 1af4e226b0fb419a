"""Public-API parity of the port: every name that tests/test_api_parity.py
locks for the JAX package exists at the same path in
``mind_the_gaps_tpu_torch`` (every module of that list is ported, so the
set of modules not yet ported is empty), as do the names of the modules
and members the port added later, and the numeric ones among the names
added to the port late agree with their JAX functions on the CPU:

- ``stats.neg_log_like``: rtol 1e-10;
- ``sampler.autocorr.autocorr_function``: within 1e-12 of the largest
  value of the JAX function with its float32 rounding lifted (the JAX
  function rounds the series to float32 for the TPU's complex64-only FFT;
  the port keeps float64), and within 1e-6 of it as it is;
- ``sampler.autocorr.integrated_autocorr_time_np``: rtol 1e-12;
- ``solver.batched.batched_log_prob_fn``: rtol 1e-8;
- ``sampler.sample_ensemble`` / ``run_ensemble``: bit-identical to
  ``sample_ensemble_grouped`` with one ensemble from the same draws, and the
  Gaussian-target moments of test_stretch_move_gaussian_target (JAX's
  threefry draws cannot be made in torch);
- ``Simulator.set_psd_params``: the PSD the simulator then uses, rtol 1e-12.
"""
import importlib
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

_spec = importlib.util.spec_from_file_location("_jax_api_parity", Path(__file__).with_name("test_api_parity.py"))
_jax_api = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_jax_api)

JAX, PORT = "mind_the_gaps_tpu", "mind_the_gaps_tpu_torch"

# the names the port added after the JAX package's list was taken
PORT_EXTRA_API = {
    "mind_the_gaps_tpu.sampler": ["sample_ensemble", "run_ensemble", "sample_ensemble_impl",
                                  "max_loglike_ensemble_impl", "integrated_autocorr_time"],
    "mind_the_gaps_tpu.sampler.autocorr": ["autocorr_function", "integrated_autocorr_time_np",
                                           "integrated_autocorr_time", "integrated_autocorr_time_masked"],
    "mind_the_gaps_tpu.solver": ["dense_log_likelihood", "dense_covariance", "CeleriteMatrices", "build_matrices",
                                 "factor", "log_likelihood", "solve", "predict_mean", "predict", "predict_at",
                                 "inverse_diag", "kalman_log_likelihood", "parallel_kalman_log_likelihood"],
    "mind_the_gaps_tpu.solver.batched": ["batched_log_likelihood", "batched_log_prob_fn"],
    "mind_the_gaps_tpu.selection": ["ModelComparison", "compare_models"],
    "mind_the_gaps_tpu.periodogram": ["lomb_scargle", "autofrequency", "ls_false_alarm_level"],
    "mind_the_gaps_tpu.plotting": ["plot_lightcurve", "plot_gp_prediction", "plot_posteriors",
                                   "plot_t_distribution", "plot_standardized_residuals"],
    "mind_the_gaps_tpu.solver.kalman": ["state_space_matrices", "kalman_log_likelihood",
                                        "parallel_kalman_log_likelihood"],
    "mind_the_gaps_tpu.parallel": ["default_mesh", "shard_batch", "pad_to_multiple"],
}

# class members the port added after the JAX package's list was taken
PORT_EXTRA_METHODS = {
    ("mind_the_gaps_tpu.gpmodelling", "GPModelling"): ["fit_device", "loo_residuals", "predict"],
}

# modules of the JAX package the port has not written yet: none
NOT_YET_PORTED = set()


def _port(module):
    return PORT + module[len(JAX):]


def _ported(module):
    return module[len(JAX) + 1:].split(".")[0] not in NOT_YET_PORTED


API = {**_jax_api.REFERENCE_API, **PORT_EXTRA_API}


@pytest.mark.parametrize("module,names", sorted((m, n) for m, n in API.items() if _ported(m)))
def test_port_names_exist(module, names):
    mod = importlib.import_module(_port(module))
    missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, f"{_port(module)} missing names: {missing}"


@pytest.mark.parametrize("target,members", sorted(_jax_api.REFERENCE_METHODS.items()))
def test_port_class_members_exist(target, members):
    module, cls_name = target
    cls = getattr(importlib.import_module(_port(module)), cls_name)
    missing = [m for m in members if not hasattr(cls, m)]
    assert not missing, f"{cls_name} missing members: {missing}"


@pytest.mark.parametrize("target,members", sorted(PORT_EXTRA_METHODS.items()))
def test_port_extra_class_members_exist(target, members):
    module, cls_name = target
    for pkg_module in (module, _port(module)):
        cls = getattr(importlib.import_module(pkg_module), cls_name)
        missing = [m for m in members if not hasattr(cls, m)]
        assert not missing, f"{pkg_module}.{cls_name} missing members: {missing}"


def test_extra_names_are_the_jax_modules_all():
    """The later modules' lists are their JAX modules' ``__all__``, and the
    port's modules export the same."""
    for module in ("selection", "periodogram", "plotting", "solver.kalman"):
        names = PORT_EXTRA_API[f"{JAX}.{module}"]
        assert sorted(names) == sorted(importlib.import_module(f"{JAX}.{module}").__all__)
        assert sorted(names) == sorted(importlib.import_module(f"{PORT}.{module}").__all__)


def _kernels():
    import mind_the_gaps_tpu.kernels as jk
    import mind_the_gaps_tpu_torch.kernels as tk

    def make(m):
        return (m.DampedRandomWalk(0.5, -2.0, bounds=[(-1, 2), (-4, 0)])
                + m.Lorentzian(-1.0, 2.0, -2.0, bounds=[(-8, 5), (0, 6), (-5, 0)])
                + m.JitterTerm(-1.0, bounds=[(-3, 1)]))

    return make(jk), make(tk)


def _problem(n=120, seed=0):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    return t, 10.0 + rng.normal(0.0, 1.0, n), rng.uniform(0.05, 0.15, n)


def test_neg_log_like_matches_jax():
    from mind_the_gaps_tpu.solver import log_likelihood as j_loglike
    from mind_the_gaps_tpu.stats import neg_log_like as j_nll
    from mind_the_gaps_tpu_torch.solver import log_likelihood as t_loglike
    from mind_the_gaps_tpu_torch.stats import neg_log_like

    jkern, tkern = _kernels()
    t, y, diag = _problem()

    class GP:  # the duck type both functions take: a settable vector and log_likelihood(y)
        def __init__(self, kernel, loglike, asarray):
            self.kernel, self.loglike, self.asarray = kernel, loglike, asarray

        def set_parameter_vector(self, p):
            self.theta = self.asarray(np.asarray(p, dtype=np.float64))

        def log_likelihood(self, y):
            c = self.kernel.coefficients(self.theta)
            return float(self.loglike(c, self.asarray(t), self.asarray(y), self.asarray(diag)
                                      + self.kernel.jitter(self.theta)))

    rng = np.random.default_rng(1)
    for _ in range(3):
        p = tkern.get_parameter_vector() + 0.1 * rng.normal(size=tkern.ndim)
        got = neg_log_like(p, y, GP(tkern, t_loglike, torch.as_tensor))
        ref = j_nll(p, y, GP(jkern, j_loglike, jnp.asarray))
        np.testing.assert_allclose(got, ref, rtol=1e-10)


@pytest.mark.parametrize("n", [100, 257, 1000])
def test_autocorr_function_matches_jax(n, monkeypatch):
    from mind_the_gaps_tpu.sampler import autocorr as jac
    from mind_the_gaps_tpu_torch.sampler.autocorr import autocorr_function

    x = np.cumsum(np.random.default_rng(n).normal(size=n))
    got = autocorr_function(x)
    assert isinstance(got, np.ndarray) and got.shape == (n,) and got.dtype == np.float64 and got[0] == 1.0
    assert float(np.max(np.abs(got - np.asarray(jac.autocorr_function(x))))) <= 1e-6
    monkeypatch.setattr(jac.jnp, "float32", jnp.float64)  # the same function without its float32 rounding
    ref = np.asarray(jac.autocorr_function(jnp.asarray(x)))
    assert float(np.max(np.abs(got - ref))) <= 1e-12 * float(np.max(np.abs(ref)))


def test_integrated_autocorr_time_np_matches_jax():
    from mind_the_gaps_tpu.sampler.autocorr import integrated_autocorr_time_np as j_tau
    from mind_the_gaps_tpu_torch.sampler.autocorr import integrated_autocorr_time_np

    rng = np.random.default_rng(4)
    n, w, d = 600, 8, 3
    x = np.zeros((n, w, d))
    eps = rng.normal(size=(n, w, d))
    for i in range(1, n):
        x[i] = np.array([0.5, 0.9, 0.97]) * x[i - 1] + eps[i]
    x[:, 0, 2] = 1.25  # a stuck walker
    got = integrated_autocorr_time_np(x)
    assert isinstance(got, np.ndarray) and got.shape == (d,)
    np.testing.assert_allclose(got, j_tau(x), rtol=1e-12)


@pytest.mark.parametrize("layout", ["shared", "grouped"])
def test_batched_log_prob_fn_matches_jax(layout):
    from mind_the_gaps_tpu.solver.batched import batched_log_prob_fn as j_factory
    from mind_the_gaps_tpu_torch.solver.batched import batched_log_prob_fn

    jkern, tkern = _kernels()
    t, y, diag = _problem(n=150, seed=2)
    rng = np.random.default_rng(3)
    repeats = 3
    if layout == "grouped":
        y = 10.0 + rng.normal(0.0, 1.0, (2, t.size))
        diag = np.broadcast_to(diag, (2, t.size)).copy()
    B = 2 * repeats
    thetas = tkern.get_parameter_vector() + rng.normal(0, 0.1, (B, tkern.ndim))
    thetas[0, 0] = 5.0  # outside its bounds: -inf
    ref = np.asarray(jax.jit(j_factory(jkern, t, y, diag, repeats=repeats))(jnp.asarray(thetas)))
    fn = batched_log_prob_fn(tkern, torch.as_tensor(t), torch.as_tensor(y), torch.as_tensor(diag), repeats=repeats)
    got = fn(torch.as_tensor(thetas)).numpy()
    assert got[0] == ref[0] == -np.inf and np.all(np.isfinite(got[1:]))
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-8)


def test_sample_ensemble_and_run_ensemble_are_the_grouped_sampler():
    from mind_the_gaps_tpu_torch.sampler import run_ensemble, sample_ensemble, sample_ensemble_grouped, stretch_draws

    def logp(theta):
        return -0.5 * (theta**2).sum(-1)

    init = torch.as_tensor(np.random.default_rng(1).normal(size=(8, 3)))
    draws = stretch_draws(40, (1, 4), torch.float64, "cpu", torch.Generator().manual_seed(3))
    ref = sample_ensemble_grouped(logp, init[None], 40, draws=draws)
    one = tuple(d[:, :, 0] for d in draws)
    for fn in (sample_ensemble, run_ensemble):
        out = fn(logp, init, 40, draws=one)
        for a, b in zip(out, (ref[0][:, 0], ref[1][:, 0], ref[2], ref[3][0])):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["sample_ensemble", "run_ensemble"])
def test_sample_ensemble_gaussian_target(name):
    import mind_the_gaps_tpu_torch.sampler as ts

    cov = np.array([[2.0, 0.8], [0.8, 1.0]])
    icov = torch.as_tensor(np.linalg.inv(cov))
    mu = torch.tensor([1.0, -2.0], dtype=torch.float64)

    def logp(theta):
        d = theta - mu
        return -0.5 * torch.einsum("wi,ij,wj->w", d, icov, d)

    init = torch.as_tensor(np.random.default_rng(0).normal(0, 0.1, (64, 2)) + np.array([1.0, -2.0]))
    chain, lps, acc, final = getattr(ts, name)(logp, init, 4000, generator=torch.Generator().manual_seed(5))
    flat = chain[500:].reshape(-1, 2).numpy()
    assert 0.2 < float(acc) < 0.8
    np.testing.assert_allclose(flat.mean(axis=0), [1.0, -2.0], atol=0.05)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.15)


def test_set_psd_params_matches_jax():
    from mind_the_gaps_tpu.models.psd_models import SHO as JSHO
    from mind_the_gaps_tpu.simulator import Simulator as JSimulator
    from mind_the_gaps_tpu_torch.models.psd_models import SHO
    from mind_the_gaps_tpu_torch.simulator import Simulator

    t = np.cumsum(np.random.default_rng(6).uniform(1.0, 3.0, 200))
    new = {"S0": 2.5, "omega0": 0.3, "Q": 4.0}
    a = JSimulator(JSHO(1.0, 10.0, 1.0), t, 1.0, 7.0, "Gaussian", extension_factor=2.0)
    b = Simulator(SHO(1.0, 10.0, 1.0), t, 1.0, 7.0, "Gaussian", extension_factor=2.0, device="cpu")
    fresh = Simulator(SHO(**new), t, 1.0, 7.0, "Gaussian", extension_factor=2.0, device="cpu")
    a.set_psd_params(new)
    b.set_psd_params(new)
    assert all(getattr(b.psd_model, k) == v for k, v in new.items())
    np.testing.assert_allclose(b._psd_values().numpy(), np.asarray(a._psd_values()), rtol=1e-12)
    torch.testing.assert_close(b._psd_values(), fresh._psd_values(), rtol=0, atol=0)
    normals = np.random.default_rng(7).normal(size=(2, b.omega.shape[0]))
    np.testing.assert_array_equal(b.generate_lightcurve(normals=normals, shift=0.0),
                                  fresh.generate_lightcurve(normals=normals, shift=0.0))
