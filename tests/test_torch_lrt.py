"""Port parity for the slice: MAP fit, observed sampling, the float64
refinement, the bootstrap refitter and ``protassov_lrt`` end to end,
against the JAX package on the CPU.

Tolerances:
- MAP fit from the same start: the maximum log-likelihood within 1e-6
  (the same objective and exact gradients through scipy's L-BFGS-B);
- ``loglikes_f64_at``: rtol 1e-9;
- observed sampling and the LRT's T statistics use different random
  streams (threefry against Philox): the maximum posterior log-likelihood
  within 2.0 and T_obs within 4.0 (T is a difference of two short-chain
  maxima, each held to the two-stream atol 2.0 of test_lrt.py);
- the early-stop rule with patience >= n_steps and a seeded LRT repeat
  bit for bit.
"""
import warnings

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import mind_the_gaps_tpu as mtg  # noqa: E402
import mind_the_gaps_tpu.kernels as jk  # noqa: E402
import mind_the_gaps_tpu_torch.kernels as tk  # noqa: E402
from mind_the_gaps_tpu.gpmodelling import GPModelling as JGP  # noqa: E402
from mind_the_gaps_tpu.lrt import loglikes_f64_at as j_loglikes_f64_at  # noqa: E402
from mind_the_gaps_tpu.lrt import protassov_lrt as j_protassov_lrt  # noqa: E402
from mind_the_gaps_tpu_torch.convert import (  # noqa: E402
    kernel_from_jax,
    lightcurve_from_jax,
    posteriors_from_jax,
)
from mind_the_gaps_tpu_torch.gpmodelling import GPModelling as TGP  # noqa: E402
from mind_the_gaps_tpu_torch.lrt import (  # noqa: E402
    _alt_theta0_rows,
    batched_max_loglike,
    fit_lightcurves_batch,
    loglikes_f64_at,
    percentile_of_score,
    protassov_lrt,
)


def _drw_lc(seed=7, n=200):
    """test_lrt.py's lightcurve: an exact DRW realization plus noise."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    true = jk.DampedRandomWalk(log_S0=np.log(4.0), log_omega0=np.log(0.05))
    tau = np.abs(t[:, None] - t[None, :])
    K = np.array(true.covariance(tau)) + np.diag(np.full(n, 0.09))
    y = 10.0 + np.linalg.cholesky(K) @ rng.normal(size=n)
    return mtg.GappyLightcurve(t, y, np.full(n, 0.3), exposures=1.0)


def _kernels(m):
    null = m.DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    alt = m.DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)]) + m.Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)]
    )
    return null, alt


def test_map_fit_matches_jax():
    lc = _drw_lc(n=150)
    kj, _ = _kernels(jk)
    kt, _ = _kernels(tk)
    ref = JGP(lc, kj).fit()
    out = TGP(lightcurve_from_jax(lc), kt, device="cpu").fit()
    assert out.success
    np.testing.assert_allclose(-out.fun, -ref.fun, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.x, ref.x, atol=1e-3)


def test_observed_sampling_matches_jax_by_distribution():
    lc = _drw_lc(seed=3, n=60)
    kj, _ = _kernels(jk)
    kt, _ = _kernels(tk)
    gj, gt = JGP(lc, kj), TGP(lightcurve_from_jax(lc), kt, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # short chains: "did not converge"
        gj.derive_posteriors(seed=3, max_steps=100, convergence_steps=50, walkers=8)
        gt.derive_posteriors(seed=3, max_steps=100, convergence_steps=50, walkers=8)
    assert gt.sampler.get_chain().shape == (100, 8, 2)
    assert gt.mcmc_samples.shape[1] == 2 and np.all(np.isfinite(gt.loglikelihoods))
    np.testing.assert_allclose(gt.max_loglikelihood, gj.max_loglikelihood, atol=2.0)
    # the float64 log-probabilities the sampler reports are those of the op
    best = torch.as_tensor(gt.max_parameters[None])
    np.testing.assert_allclose(float(gt.log_prob_batch(best)[0]), gt.max_loglikelihood, rtol=1e-12)


def test_loglikes_f64_at_matches_jax():
    lc = _drw_lc(seed=4, n=100)
    _, kj = _kernels(jk)
    _, kt = _kernels(tk)
    rng = np.random.default_rng(5)
    ys = lc.y[None, :] + rng.normal(0, 0.3, (6, lc.n))
    dys = np.full((6, lc.n), 0.3)
    thetas = kj.get_parameter_vector() + 0.1 * rng.normal(size=(6, 5))
    thetas[0, 0] = 11.0  # outside the prior bounds: -inf in both
    ref = j_loglikes_f64_at(kj, lc.times, ys, dys, thetas)
    out = loglikes_f64_at(kt, lc.times, ys, dys, thetas, chunk=4, device="cpu")
    assert out[0] == ref[0] == -np.inf
    np.testing.assert_allclose(out[1:], ref[1:], rtol=1e-9)


def test_early_stop_with_long_patience_equals_fixed_budget():
    lc = _drw_lc(seed=6, n=60)
    kt, _ = _kernels(tk)
    rng = np.random.default_rng(6)
    ys = torch.as_tensor(lc.y[None, :] + rng.normal(0, 0.3, (4, lc.n)))
    diags = torch.full((4, lc.n), 0.09, dtype=torch.float64)
    t = torch.as_tensor(lc.times)
    th0 = np.array([1.0, -3.0])
    runs = [
        batched_max_loglike(kt, t, ys, diags, th0, walkers=8, n_steps=20, dtype=torch.float32,
                            early_stop=es, generator=torch.Generator().manual_seed(1))
        for es in (None, (0.01, 20), (0.01, 50))
    ]
    for lp, x in runs[1:]:
        torch.testing.assert_close(lp, runs[0][0], rtol=0, atol=0)
        torch.testing.assert_close(x, runs[0][1], rtol=0, atol=0)
    assert runs[0][0].dtype == torch.float32 and torch.all(torch.isfinite(runs[0][0]))


def test_fit_lightcurves_batch_per_row_starts():
    lc = _drw_lc(seed=8, n=50)
    kt, alt = _kernels(tk)
    rng = np.random.default_rng(8)
    ys = lc.y[None, :] + rng.normal(0, 0.3, (5, lc.n))
    starts = np.array([1.0, -3.0]) + 0.1 * rng.normal(size=(5, 2))
    lls, xs = fit_lightcurves_batch(kt, lc.times, ys, np.full((5, lc.n), 0.3), starts,
                                    walkers=8, n_steps=10, chunk=3, seed=2, device="cpu")
    assert lls.shape == (5,) and xs.shape == (5, 2) and np.all(np.isfinite(lls))
    f64 = loglikes_f64_at(kt, lc.times, ys, np.full((5, lc.n), 0.3), xs, device="cpu")
    np.testing.assert_allclose(lls, f64, rtol=1e-10)  # float64 chains: the same values
    rows = _alt_theta0_rows(kt, alt, starts)
    np.testing.assert_array_equal(rows[:, :2], starts)
    np.testing.assert_array_equal(rows[:, 2:], np.broadcast_to(alt.get_parameter_vector()[2:], (5, 3)))


def test_percentile_of_score_matches_scipy():
    from scipy.stats import percentileofscore

    dist = np.random.default_rng(0).normal(size=300)
    for score in (-2.0, 0.0, dist[3], 2.5):
        assert percentile_of_score(dist, score) == pytest.approx(percentileofscore(dist, score, kind="rank"))


def test_protassov_lrt_ab_against_jax():
    """test_lrt.py's tiny seeded LRT: JAX runs it whole; the port takes the
    JAX observed posteriors (convert.py) and runs the bootstrap."""
    lc = _drw_lc(seed=9, n=96)
    null_j, alt_j = _kernels(jk)
    settings = dict(nsims=8, seed=21, sim_max_steps=40, sim_walkers=8, chunk=8)
    ref = j_protassov_lrt(lc, null_j, alt_j, observed_max_steps=150, observed_walkers=8, **settings)

    lc_t = lightcurve_from_jax(lc)
    null_t, alt_t = kernel_from_jax(null_j), kernel_from_jax(alt_j)
    results = []
    for _ in range(2):
        models = []
        for gj, kern in ((ref.null_model, null_t), (ref.alt_model, alt_t)):
            gt = TGP(lc_t, kern, device="cpu")
            posteriors_from_jax(gj, gt)
            models.append(gt)
        results.append(protassov_lrt(lc_t, null_t, alt_t, null_model=models[0], alt_model=models[1], device="cpu",
                                     **settings))
    a, b = results
    assert a.t_obs_posterior == ref.t_obs_posterior  # the carried posteriors
    np.testing.assert_allclose(a.t_obs, ref.t_obs, atol=4.0)
    assert a.t_dist.shape == (8,) and np.all(np.isfinite(a.t_dist))
    assert 0.0 <= a.p_value <= 1.0
    assert set(a.timings) == {"map_fit_s", "observed_sampling_s", "generation_s", "refits_s", "refine_s",
                              "checkpoint_s", "refit_steps", "refit_graph_steps", "e13_passes",
                              "simulator_s", "kraft_bins", "kraft_bins_replaced"}
    assert a.timings["refit_graph_steps"] == 0  # the CPU steps eagerly
    assert a.t_obs == b.t_obs and a.p_value == b.p_value
    np.testing.assert_array_equal(a.t_dist, b.t_dist)


def test_options_not_ported_are_refused():
    """Every option of ``derive_posteriors`` is ported (mesh mode too, held in
    test_torch_mesh.py; checkpoint/resume in
    test_checkpoint_resume_reproduces_full_run); what is refused is an
    option's value out of its range: ``chains < 1`` raises ValueError, as in
    the JAX package."""
    lc = lightcurve_from_jax(_drw_lc(seed=10, n=30))
    null_t, _ = _kernels(tk)
    gp = TGP(lc, null_t, device="cpu")
    with pytest.raises(ValueError):
        gp.derive_posteriors(chains=0, fit=False, max_steps=10)


def test_checkpoint_resume_reproduces_full_run(tmp_path):
    """test_lrt.py's case in the port: a bootstrap resumed from its
    checkpoint equals the uninterrupted run exactly (each chunk draws from
    generators of its own), and a changed configuration (the seed, or
    sigma_noise, which changes only the simulations) recomputes with a
    warning; an unreadable file too, and keep_simulations ignores the
    checkpoint with a warning."""
    import os

    lc = lightcurve_from_jax(_drw_lc(seed=13, n=80))
    null_t, alt_t = _kernels(tk)
    null_model, alt_model = TGP(lc, null_t, device="cpu"), TGP(lc, alt_t, device="cpu")
    null_model.derive_posteriors(max_steps=150, walkers=8, seed=31, converge=False)
    alt_model.derive_posteriors(max_steps=150, walkers=8, seed=32, converge=False)
    common = dict(nsims=8, chunk=4, seed=5, null_model=null_model, alt_model=alt_model, sim_max_steps=25,
                  sim_walkers=4, sigma_noise=0.3, device="cpu")
    ckpt = str(tmp_path / "boot.npz")
    full = protassov_lrt(lc, null_t, alt_t, **common)
    res1 = protassov_lrt(lc, null_t, alt_t, checkpoint=ckpt, **common)
    np.testing.assert_array_equal(res1.t_dist, full.t_dist)
    assert full.timings["checkpoint_s"] == 0.0 and res1.timings["checkpoint_s"] > 0.0  # timed apart from refine_s
    d = dict(np.load(ckpt))
    assert int(d["chunks_done"]) == 3 and d["null_done"].shape == (9,)  # 8 simulations and the observed row

    # an interruption: the file rewound to 1 completed chunk
    np.savez(ckpt + ".tmp.npz", config_crc=d["config_crc"], chunks_done=np.int64(1),
             null_done=d["null_done"][:4], alt_done=d["alt_done"][:4])
    os.replace(ckpt + ".tmp.npz", ckpt)
    res2 = protassov_lrt(lc, null_t, alt_t, checkpoint=ckpt, **common)
    np.testing.assert_array_equal(res2.t_dist, full.t_dist)
    assert res2.p_value == full.p_value and res2.t_obs == full.t_obs

    for change in ({"seed": 6}, {"sigma_noise": 0.5}):
        other = dict(common, **change)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            res3 = protassov_lrt(lc, null_t, alt_t, checkpoint=ckpt, **other)
        assert any("different" in str(w.message) for w in rec), change
        assert np.isfinite(res3.t_dist).all()

    with open(ckpt, "wb") as fh:
        fh.write(b"not an npz file")
    with pytest.warns(UserWarning, match="unreadable"):
        res4 = protassov_lrt(lc, null_t, alt_t, checkpoint=ckpt, **common)
    np.testing.assert_array_equal(res4.t_dist, full.t_dist)
    with pytest.warns(UserWarning, match="keep_simulations"):
        res5 = protassov_lrt(lc, null_t, alt_t, checkpoint=str(tmp_path / "kept.npz"), keep_simulations=True,
                             **common)
    assert not (tmp_path / "kept.npz").exists() and res5.sim_rates.shape == (8, lc.n)


def test_entry_points_default_to_cuda():
    """Every public function or class of the port that takes ``device``
    runs on the card unless the caller asks for the CPU (signatures only:
    nothing runs here); the MAP fit's op, the samplers, the solver tiers,
    the PSD models and the GPModelling methods of this slice are among the
    functions checked, and take their device from their tensors or model."""
    import importlib
    import inspect
    import pkgutil

    import mind_the_gaps_tpu_torch as pkg

    found, seen = {}, set()
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        mod = importlib.import_module(info.name)
        for name in getattr(mod, "__all__", ()):
            obj = getattr(mod, name)
            fns = [obj] if inspect.isfunction(obj) else [
                f for f in vars(obj).values() if inspect.isfunction(f)
            ] if inspect.isclass(obj) else []
            for fn in fns:
                qual = f"{info.name}.{fn.__qualname__}"
                seen.add(qual)
                param = inspect.signature(fn).parameters.get("device")
                if param is not None and param.default is not inspect.Parameter.empty:
                    found[qual] = param.default
    for entry in ("lrt.protassov_lrt", "lrt.fit_lightcurves_batch", "lrt.loglikes_f64_at",
                  "gpmodelling.GPModelling.__init__", "simulator.core.E13Simulator.__init__",
                  "simulator.core.Simulator.__init__", "simulator.noise.KraftNoise.__init__",
                  "simulator.noise.PoissonNoise.__init__", "simulator.noise.kraft_tables",
                  "ops.fma_probe.probe", "stats.kraft_posterior_median", "stats.kraft_hpd_interval",
                  "periodogram.lomb_scargle", "selection.compare_models"):
        assert f"mind_the_gaps_tpu_torch.{entry}" in found, entry
    for entry in ("ops.celerite_grad.celerite_loglike_fn", "ops.celerite_grad.celerite_log_likelihood_and_grad",
                  "sampler.ensemble.sample_ensemble_grouped", "sampler.ensemble.max_loglike_ensemble_impl",
                  "solver.semiseparable.predict_at", "solver.semiseparable.inverse_diag",
                  "models.psd_models.BrokenPowerLaw.__call__", "gpmodelling.GPModelling.predict",
                  "gpmodelling.GPModelling.loo_residuals", "gpmodelling.GPModelling.get_rstat",
                  "gpmodelling.ChainResult.get_autocorr_time", "gpmodelling.GPModelling.fit_device",
                  "solver.kalman.parallel_kalman_log_likelihood"):
        assert f"mind_the_gaps_tpu_torch.{entry}" in seen, entry
        assert f"mind_the_gaps_tpu_torch.{entry}" not in found, entry
    assert all(default == "cuda" for default in found.values()), found
