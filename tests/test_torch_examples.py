"""The port's validation and tutorial programs
(``mind_the_gaps_tpu_torch.examples``) against the JAX package's
``examples/`` scripts, on the CPU.

The JAX scripts are loaded as modules from their files (their ``main()``
is guarded); where a script computes a number inside ``main()``, the test
computes it as that script does, with the JAX package's functions.

Tolerances:
- the truth draws (dense Cholesky of the covariance from the same
  ``np.random.default_rng`` stream): rtol 1e-12;
- the tutorial's fixed realizations: the lightcurve exactly (dy 1e-15), the
  MAP fits' T rtol 1e-9 and the alternative's parameters atol 1e-6;
- the posterior-predictive PSD batch from the same fitted thetas: rtol 1e-12;
- the bootstrap p-values and the KS statistic of the same T arrays: exact;
- the studies' deterministic numbers: the PSD-integral variance, the
  noise-floor prediction and the FFT slope of a shared numpy series rtol
  1e-9, the absolute periodogram exactly; the Lomb-Scargle power of that
  series rtol 1e-12 and its slope equal to the JAX fit of the same power,
  within rtol 1e-8 of the JAX fit of the JAX power (the least-squares
  solver's own tolerance);
- each module's ``run(device="cpu")`` at a tiny size: finite T, every p in
  [1 / (nsims + 1), 1]; the studies' own assertions at their sizes.
"""
import importlib.util
import json
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from scipy.stats import kstest  # noqa: E402

import mind_the_gaps_tpu.kernels as jk  # noqa: E402
from mind_the_gaps_tpu.fitting import fit_lomb_scargle as j_fit_lomb_scargle  # noqa: E402
from mind_the_gaps_tpu.fitting import fit_psd_powerlaw as j_fit_psd_powerlaw  # noqa: E402
from mind_the_gaps_tpu.models import psd_models as j_psd  # noqa: E402
from mind_the_gaps_tpu.periodogram import lomb_scargle as j_lomb_scargle  # noqa: E402
from mind_the_gaps_tpu.simulator import Simulator as JSimulator  # noqa: E402
from mind_the_gaps_tpu_torch.examples import _common as c  # noqa: E402
from mind_the_gaps_tpu_torch.examples import (  # noqa: E402
    study_celerite_variance,
    study_lomb_scargle_biases,
    study_poisson_level,
    tutorial_model_selection,
    tutorial_ppp,
    validation_detection_power,
    validation_full_pipeline_calibration,
    validation_pvalue_calibration,
)
from mind_the_gaps_tpu_torch.models import psd_models as t_psd  # noqa: E402
from mind_the_gaps_tpu_torch.periodogram import lomb_scargle  # noqa: E402

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


J_MODEL_SELECTION = _jax_script("tutorial_model_selection")
J_POISSON_LEVEL = _jax_script("study_poisson_level")
NF = 2.0 / np.sqrt(2.0 * np.pi)


def _j_null():
    return jk.DampedRandomWalk(np.log(4.0), np.log(0.05), bounds=[(-5, 8), (-8, 2)])


# --------------------------------------------------------------------- #
# (i) the truth draws
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n,k", [(400, 32), (850, 16), (400, None)])
def test_gaussian_truth_equals_the_jax_scripts(n, k):
    """validation_pvalue_calibration.py:94-99 (K draws) and
    validation_full_pipeline_calibration.py:71-77 (one draw)."""
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    times = np.cumsum(rng_j.uniform(2.0, 8.0, n))
    tau = np.abs(times[:, None] - times[None, :])
    L = np.linalg.cholesky(np.array(_j_null().covariance(tau)) + np.diag(np.full(n, 0.3**2)))
    want = 10.0 + (L @ rng_j.normal(size=n if k is None else (n, k))).T

    t_times = c.observing_pattern(rng_t, n)
    got = c.truth_draws(rng_t, c.truth_factor(c.covariance(c.null_kernel(), t_times)), k)
    assert np.array_equal(t_times, times)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("amps", [(0.0, 0.02, 0.05, 0.1, 0.25), (0.0, 0.1, 0.25, 0.5, 1.0)])
def test_qpo_truth_equals_the_jax_script(amps):
    """validation_detection_power.py:62-76 at each strength."""
    n, k, q, wqpo = 400, 4, 20.0, 0.2
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    times = np.cumsum(rng_j.uniform(2.0, 8.0, n))
    tau = np.abs(times[:, None] - times[None, :])
    k_drw = np.array(_j_null().covariance(tau))
    want = []
    for a in amps:
        cov = k_drw + np.array(jk.Lorentzian(np.log(a * 4.0), np.log(q), np.log(wqpo)).covariance(tau)) if a > 0 \
            else k_drw
        L = np.linalg.cholesky(cov + np.diag(np.full(n, 0.3**2)))
        want.append(10.0 + (L @ rng_j.normal(size=(n, k))).T)

    got = validation_detection_power.truth(rng_t, c.observing_pattern(rng_t, n), amps, k, q, wqpo)
    np.testing.assert_allclose(got, np.concatenate(want), rtol=1e-12)


def jax_tutorial_counts():
    """The JAX tutorial's n=800, seed-42 lightcurve with the QPO
    (examples/tutorial_ppp.py:22-41) with its Poisson draw seeded 42: the
    counts of its 2 ks exposures and the JAX (noisy rates, dy).
    ``tutorial_ppp_counts.npz``'s ``jax_seed42`` holds the counts."""
    day = 86400.0
    times = np.cumsum(np.random.default_rng(42).uniform(4000, 9000, 800))
    psd = j_psd.BendingPowerlaw(S0=0.02, omega0=2 * np.pi / (40 * day)) + j_psd.Lorentzian(
        S0=0.01, omega0=2 * np.pi / (10 * day), Q=20)
    sim = JSimulator(psd, times, 2000.0, 0.5, "Gaussian", extension_factor=2, random_state=42)
    sim.noise.seed(42)
    noisy, dy = sim.add_noise(sim.generate_lightcurve())
    return np.rint(noisy * 2000.0), noisy, dy


def test_tutorial_reference_counts_give_the_jax_scripts_lightcurve():
    """The committed ``jax_seed42`` counts are the JAX script's, and the
    port's ``make_lightcurve(counts=)`` turns them into the JAX script's
    lightcurve: its times and rates exactly, dy within 1e-15."""
    counts, noisy, dy = jax_tutorial_counts()
    assert np.array_equal(tutorial_ppp.reference_counts(), counts)
    lc = tutorial_ppp.make_lightcurve(with_qpo=True, device="cpu", counts=tutorial_ppp.reference_counts())
    assert np.array_equal(lc.times, np.cumsum(np.random.default_rng(42).uniform(4000, 9000, 800)))
    assert np.array_equal(lc.y, noisy)
    np.testing.assert_allclose(lc.dy, dy, rtol=1e-15)


def _j_tutorial_kernels():
    """examples/tutorial_ppp.py:56-66, the null and the alternative."""
    day = 86400.0
    bounds = [(-15, 5), (np.log(2 * np.pi / (500 * day)), np.log(2 * np.pi / (2 * day)))]

    def drw():
        return jk.DampedRandomWalk(np.log(0.02), np.log(2 * np.pi / (40 * day)), bounds=bounds)

    qpo = jk.Lorentzian(np.log(0.01), np.log(20), np.log(2 * np.pi / (10 * day)),
                        bounds=[(-15, 5), (0, 8), (np.log(2 * np.pi / (100 * day)), np.log(2 * np.pi / (2 * day)))])
    return drw(), drw() + qpo


@pytest.mark.parametrize("realization", ["jax_seed42", "h100_seed42"])
def test_tutorial_map_t_equals_the_jax_packages(realization):
    """On one fixed realization with the QPO (``tutorial_ppp_counts.npz``: the
    JAX script's, and the port's own on an H100), the JAX package's MAP fits
    and the port's give the same T = 2 (nll_null - nll_alt), rtol 1e-9, and
    the same alternative's parameters, atol 1e-6."""
    from mind_the_gaps_tpu import GappyLightcurve as JGappyLightcurve
    from mind_the_gaps_tpu.gpmodelling import GPModelling as JGPModelling
    from mind_the_gaps_tpu_torch.gpmodelling import GPModelling

    with np.load(tutorial_ppp.COUNTS) as f:
        counts = f[realization]
    lc = tutorial_ppp.make_lightcurve(with_qpo=True, device="cpu", counts=counts)
    j_lc = JGappyLightcurve(lc.times, counts / 2000.0, np.sqrt(counts) / 2000.0, exposures=2000.0)
    want = [JGPModelling(j_lc, kernel).fit() for kernel in _j_tutorial_kernels()]
    got = [GPModelling(lc, kernel, device="cpu").fit() for kernel in tutorial_ppp.kernels()]
    t_want, t_got = 2 * (want[0].fun - want[1].fun), 2 * (got[0].fun - got[1].fun)
    print(f"{realization}: MAP T, the JAX package {t_want:.6f}, the port {t_got:.6f}; the QPO at log_omega0 "
          f"{want[1].x[4]:.4f} / {got[1].x[4]:.4f}")
    assert t_got == pytest.approx(t_want, rel=1e-9)
    np.testing.assert_allclose(got[1].x, want[1].x, rtol=0, atol=1e-6)


def test_model_selection_lightcurve_equals_the_jax_script():
    want = J_MODEL_SELECTION.make_lightcurve()
    got = tutorial_model_selection.make_lightcurve()
    assert np.array_equal(got.times, np.asarray(want.times))
    np.testing.assert_allclose(got.y, np.asarray(want.y), rtol=1e-12)
    np.testing.assert_array_equal(got.dy, np.asarray(want.dy))


# --------------------------------------------------------------------- #
# (ii) the posterior-predictive PSD batch
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n,nsims", [(400, 7), (850, 3)])
def test_psd_batch_equals_the_jax_scripts_vmap(n, nsims):
    """validation_pvalue_calibration.py:131-143: jax.vmap(psd_for) over the
    fitted null thetas, repeated nsims times."""
    rng = np.random.default_rng(5)
    times = np.cumsum(rng.uniform(2.0, 8.0, n))
    thetas = np.log([4.0, 0.05]) + 0.4 * rng.standard_normal((6, 2))
    j_sim = JSimulator(j_psd.BendingPowerlaw(S0=4.0, omega0=0.05), times, 1.0, 10.0, "Gaussian", sigma_noise=0.3,
                       extension_factor=2, random_state=3)
    omega = jnp.asarray(j_sim.omega)
    j_null = _j_null()

    def psd_for(theta):
        vals = j_null.get_psd(omega[1:], jnp.asarray(theta))
        return jnp.concatenate([jnp.zeros((1,), dtype=vals.dtype), vals])

    want = np.asarray(jnp.repeat(jax.vmap(psd_for)(jnp.asarray(thetas, dtype=jnp.float64)), nsims, axis=0))

    t_sim = c.simulator(times, "Gaussian", 3, "cpu")
    assert np.array_equal(t_sim.omega, np.asarray(j_sim.omega))
    got = c.psd_batch(c.null_kernel(), t_sim.omega, thetas, nsims, "cpu")
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


# --------------------------------------------------------------------- #
# (iii) the p-values and the KS statistic
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("k,nsims", [(32, 127), (16, 63), (5, 16)])
def test_pvalues_and_ks_equal_the_jax_scripts(k, nsims):
    """validation_pvalue_calibration.py:167-169 and
    validation_detection_power.py:321-324, on T arrays with ties."""
    rng = np.random.default_rng(k)
    t_obs = np.round(rng.chisquare(2, k), 1)
    t_sim = np.round(rng.chisquare(2, (k, nsims)), 1)
    t_sim[0, :3] = t_obs[0]  # ties count as >=
    want = (1.0 + np.sum(t_sim >= t_obs[:, None], axis=1)) / (nsims + 1.0)
    got = c.bootstrap_pvalues(t_obs, t_sim)
    assert np.array_equal(got, want)
    ks = kstest(want, "uniform")
    assert c.ks_uniform(got) == (ks.statistic, ks.pvalue)

    A = 3  # the power curve's (A, K, nsims) layout
    t_obs3, t_sim3 = t_obs[: k - k % A].reshape(A, -1), t_sim[: k - k % A].reshape(A, -1, nsims)
    want3 = (1.0 + np.sum(t_sim3 >= t_obs3[:, :, None], axis=2)) / (nsims + 1.0)
    assert np.array_equal(c.bootstrap_pvalues(t_obs3, t_sim3), want3)


# --------------------------------------------------------------------- #
# (iv) the studies' deterministic numbers
# --------------------------------------------------------------------- #
def test_psd_integral_variance_equals_the_jax_study():
    """study_celerite_variance.py:37-53."""
    n_points = 2000
    times = np.linspace(0.0, 2000.0, n_points)
    exposures = 0.5 * np.ones(n_points)
    duration = times[-1] + 1.5 * exposures[-1] - (times[0] - exposures[0])
    df = 1.0 / duration
    w_int = np.arange(1.0 / duration, 1.0 / (np.min(exposures) / 2), df) * 2 * np.pi
    j_model = j_psd.BendingPowerlaw(S0=1.0, omega0=2 * np.pi / 100.0)
    want = float(np.sum(np.asarray(j_model(w_int))) * df * 2 * np.pi * NF)
    got = study_celerite_variance.psd_integral_variance(t_psd.BendingPowerlaw(S0=1.0, omega0=2 * np.pi / 100.0),
                                                         times, exposures)
    assert math.isclose(got, want, rel_tol=1e-9)


def test_noise_floor_and_periodogram_equal_the_jax_study():
    """study_poisson_level.py:109-118 and :151-158."""
    rng = np.random.default_rng(3)
    dt, sigma = 1.0, 0.5
    series = np.cumsum(rng.normal(size=2000)) + rng.normal(0, sigma, 2000)
    freqs, power = study_poisson_level.abs_periodogram(series, dt)
    j_freqs, j_power = J_POISSON_LEVEL.abs_periodogram(series, dt)
    assert np.array_equal(freqs, j_freqs) and np.array_equal(power, j_power)
    odd = study_poisson_level.abs_periodogram(series[:-1], dt)
    assert all(np.array_equal(a, b) for a, b in zip(odd, J_POISSON_LEVEL.abs_periodogram(series[:-1], dt)))

    w0 = 2 * np.pi / 50.0
    hi = freqs > 0.25 / dt
    want = 2 * dt * sigma**2 / (2 * np.pi * NF) + np.mean(np.asarray(j_psd.BendingPowerlaw(S0=1.0, omega0=w0)(
        freqs[hi] * 2 * np.pi)))
    got = study_poisson_level.predicted_floor(t_psd.BendingPowerlaw(S0=1.0, omega0=w0), freqs, dt, sigma)
    assert math.isclose(got, float(want), rel_tol=1e-9)


@pytest.mark.parametrize("n_remove", [0, 250, 500])
def test_slopes_equal_the_jax_study(n_remove):
    """study_lomb_scargle_biases.py:222-250 on one shared numpy series: the
    FFT slope and the Lomb-Scargle slope after removing samples."""
    rng = np.random.default_rng(27)
    n_points, dt = 1000, 1.0
    timestamps = np.arange(0, n_points, dt, dtype=float)
    rate = 3.0 + np.cumsum(rng.normal(size=n_points)) * 0.05

    freqs = np.fft.rfftfreq(n_points, dt)
    cut = slice(1, -1) if len(freqs) % 2 == 0 else slice(1, None)  # the script's test of len(freqs)
    want_fft = j_fit_psd_powerlaw(freqs[cut], np.abs(np.fft.rfft(rate)[cut]) ** 2)[0]
    assert math.isclose(study_lomb_scargle_biases.fft_slope(rate, dt), float(want_fft), rel_tol=1e-9)

    ls_freqs = np.linspace(1.0 / (timestamps[-1] - timestamps[0]), 1.0 / (2 * dt), n_points // 2)[:-1]
    keep = np.sort(rng.choice(n_points, n_points - n_remove, replace=False))
    j_power = np.asarray(j_lomb_scargle(timestamps[keep], rate[keep], ls_freqs, normalization="psd"))
    t_power = lomb_scargle(timestamps[keep], rate[keep], ls_freqs, normalization="psd", device="cpu").numpy()
    np.testing.assert_allclose(t_power, j_power, rtol=1e-12)
    got = study_lomb_scargle_biases.ls_slope(timestamps[keep], rate[keep], ls_freqs, "cpu")
    assert got == j_fit_lomb_scargle(ls_freqs, t_power)[0]
    # scipy's least_squares stops at xtol 1e-8, so powers that differ by
    # ~1e-13 may move the slope by ~1e-9 of itself
    assert math.isclose(got, float(j_fit_lomb_scargle(ls_freqs, j_power)[0]), rel_tol=1e-8)


# --------------------------------------------------------------------- #
# (v) each module at a tiny size on the CPU
# --------------------------------------------------------------------- #
def _check_pvalues(p, t, nsims):
    """Finite T; the exact bootstrap p in [1 / (nsims + 1), 1], or with
    ``nsims`` None an LRT's p (a rank percentile, 0 above every simulated
    T) in [0, 1]."""
    p, t = np.asarray(p), np.asarray(t)
    assert np.all(np.isfinite(t))
    assert np.all(p >= (0.0 if nsims is None else 1.0 / (nsims + 1) - 1e-12)) and np.all(p <= 1.0)


def test_pvalue_calibration_main_on_the_cpu(capsys):
    out = validation_pvalue_calibration.main(["--k", "4", "--nsims", "15", "--n", "100", "--steps", "30",
                                              "--device", "cpu"])
    _check_pvalues(out["p_values"], out["t_obs"], 15)
    assert np.all(np.isfinite(out["t_sim"])) and out["t_sim"].shape == (4, 15)
    assert 0.0 <= out["ks_p"] <= 1.0 and 0.0 <= out["ks_d"] <= 1.0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["metric"] == "pvalue_calibration_ks_pvalue" and last["ks_p"] == out["ks_p"]


def test_lognormal_calibration_on_the_cpu():
    out = validation_pvalue_calibration.run(k=3, nsims=7, n=120, steps=20, pdf="Lognormal", device="cpu")
    _check_pvalues(out["p_values"], out["t_obs"], 7)
    assert set(out["e13"]) == {"observed truth draws", "posterior-predictive bootstrap"}
    for stage in out["e13"].values():  # the plain versions on the CPU: no kernel launch
        assert stage["cut_len"] == 2048 and stage["tier"] == ["tile", 1]
        assert stage["rank_remap"] == 0 and stage["sort_kv"] == 0


def test_require_kernel_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="require_kernel"):
        validation_pvalue_calibration.run(k=2, nsims=3, n=60, steps=5, pdf="Lognormal", require_kernel=True,
                                          device="cpu")


def test_detection_power_on_the_cpu():
    out = validation_detection_power.run(amps=(0.0, 0.5), k=2, nsims=7, n=100, steps=20, device="cpu")
    _check_pvalues(out["p_values"], [r["median_T_obs"] for r in out["results"]], 7)
    assert [r["amp"] for r in out["results"]] == [0.0, 0.5]
    assert all(0.0 <= r["detect_frac_p05"] <= 1.0 for r in out["results"])


@pytest.mark.parametrize("pdf,k,seed", [("gaussian", 2, 0), ("lognormal", 1, 1)])
def test_full_pipeline_calibration_on_the_cpu(pdf, k, seed):
    out = validation_full_pipeline_calibration.run(k=k, nsims=15, n=100, observed_max_steps=30, sim_steps=30,
                                                   pdf=pdf, device="cpu", seed=seed)
    _check_pvalues(out["p_values"], out["t_obs"], None)
    assert len(out["p_values"]) == len(out["converged"]) == k and 0.0 <= out["ks_p"] <= 1.0


def test_tutorial_ppp_on_the_cpu():
    out = tutorial_ppp.run(nsims=15, qpo=True, max_steps=30, sim_steps=30, n=120, device="cpu")
    _check_pvalues([out["p_value"], out["p_value_posterior"]], [out["t_obs"], out["t_obs_posterior"]], None)
    assert out["n"] == 120 and math.isfinite(out["t_dist_p99"])


def test_tutorial_model_selection_on_the_cpu():
    out = tutorial_model_selection.run(n=100, max_steps=30, walkers=8, device="cpu")
    rows = out["results"]
    assert sorted(r["name"] for r in rows) == ["DRW", "DRW+QPO", "Matern32", "SHO"]
    assert [r["k"] for r in sorted(rows, key=lambda r: r["name"])] == [2, 5, 2, 3]
    assert rows[0]["delta_aicc"] == 0.0 and math.isclose(sum(r["akaike_weight"] for r in rows), 1.0)
    assert all(math.isfinite(r["max_loglikelihood"]) and 0.0 <= r["ks_pvalue"] <= 1.0 for r in rows)


@pytest.mark.parametrize("study", [study_celerite_variance, study_poisson_level, study_lomb_scargle_biases],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_study_assertions_hold_on_the_cpu(study):
    """Each convention study at its own size: its assertions hold."""
    out = study.run(device="cpu")
    assert all(np.all(np.isfinite(v)) for v in out.values() if isinstance(v, (float, list)))
