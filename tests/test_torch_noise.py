"""Kraft low-count noise and the simulator's single-lightcurve API of the
port, against the JAX package.

- ``KraftNoise``'s Kraft step on the same drawn Poisson totals equals the
  JAX package's formulas (``simulator/noise.py:93-107``: the low mask,
  counts clipped at 0, the median and the HPD half-width) within rtol
  1e-9, both read at the drawn counts: the port gathers from per-bin
  tables of the same functions, at round(total) where the JAX package
  reads the interval at trunc(total), one short where the recovered total
  falls a rounding error below its whole number;
- the ports of ``test_simulator.py``'s Kraft cases, and the paths that
  raised before Kraft noise was ported: ``generate_batch_from_posteriors``
  and ``protassov_lrt(device="cpu")`` on a lightcurve with a background and
  no ``sigma_noise``;
- ``get_fft``, ``get_segment``, ``cut_random_segment``,
  ``add_poisson_noise`` and ``Simulator.downsample`` equal the JAX host
  functions exactly on the same draws and windows (the same numpy
  arithmetic); ``generate_lightcurve`` fed the JAX draws follows the JAX
  one to 1e-6 of the DC level (test_torch_simulator.py's tolerance for the
  pipeline: the JAX spectrum is complex64).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import mind_the_gaps_tpu.simulator.core as jcore  # noqa: E402
from mind_the_gaps_tpu.models import psd_models  # noqa: E402
from mind_the_gaps_tpu.simulator import Simulator as JSimulator  # noqa: E402
from mind_the_gaps_tpu.simulator.regular import RegularLightcurve as JRegular  # noqa: E402
from mind_the_gaps_tpu.stats import kraft_hpd_interval, kraft_posterior_median  # noqa: E402
import mind_the_gaps_tpu_torch.simulator.core as tcore  # noqa: E402
from mind_the_gaps_tpu_torch import GappyLightcurve  # noqa: E402
from mind_the_gaps_tpu_torch.gpmodelling import GPModelling  # noqa: E402
from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, Lorentzian  # noqa: E402
from mind_the_gaps_tpu_torch.lrt import protassov_lrt  # noqa: E402
from mind_the_gaps_tpu_torch.simulator import KraftNoise, PoissonNoise, Simulator  # noqa: E402
from mind_the_gaps_tpu_torch.simulator.regular import RegularLightcurve  # noqa: E402


def _jax_kraft_step(totals, exposures, bkg, bkg_err, kraft_counts=15):
    """JAX KraftNoise.add_noise_jax after its Poisson draw, on given totals,
    with the threshold and the interval read at the drawn counts (round) as
    the median is."""
    net = (totals - bkg) / exposures
    dy = jnp.sqrt((jnp.sqrt(totals) / exposures) ** 2 + bkg_err**2)
    total_counts = net * exposures + bkg
    counts = jnp.clip(jnp.round(total_counts), 0.0, None)
    low = counts < kraft_counts
    med = kraft_posterior_median(counts, jnp.broadcast_to(bkg, totals.shape))
    lo, hi = kraft_hpd_interval(counts, jnp.broadcast_to(bkg, totals.shape), cl=0.68)
    return np.asarray(jnp.where(low, med / exposures, net)), np.asarray(jnp.where(low, (hi - lo) / 2.0 / exposures, dy))


def test_kraft_step_matches_jax_formulas():
    rng = np.random.default_rng(4)
    n = 40
    exposures = rng.uniform(0.5, 3.0, n)
    bkg = rng.uniform(0.0, 6.0, n)
    bkg[:5] = 0.0
    bkg_err = rng.uniform(0.0, 0.1, n)
    rates = rng.uniform(0.0, 12.0, (6, n))
    totals = rng.poisson(rates * exposures + bkg).astype(float)
    totals[-1] = 15.0  # a row at the threshold: some bins' totals are recovered a rounding error below it
    noise = KraftNoise(exposures, bkg, bkg_err, device="cpu")
    assert noise.median_table.shape == (16, n)
    net, dy = noise.add_noise_torch(torch.as_tensor(rates), counts=torch.as_tensor(totals))
    net_j, dy_j = _jax_kraft_step(jnp.asarray(totals), jnp.asarray(exposures), jnp.asarray(bkg), jnp.asarray(bkg_err))
    low = totals < 15
    assert 0.2 < low.mean() < 0.9  # both branches are exercised
    recovered = (totals - bkg) / exposures * exposures + bkg
    assert np.any(low & (np.trunc(recovered) < totals))  # a count that trunc would read one short
    assert np.any((totals == 15) & (recovered < 15))  # a bin of 15 counts that the total would read as low
    np.testing.assert_allclose(net.numpy(), net_j, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(dy.numpy(), dy_j, rtol=1e-9, atol=1e-12)
    assert noise.bins_drawn == totals.size and int(noise.bins_replaced) == int(low.sum())
    # the same draws through the Poisson model: Kraft leaves the high bins alone
    net_p, dy_p = PoissonNoise(exposures, bkg, bkg_err, device="cpu").add_noise_torch(
        torch.as_tensor(rates), counts=torch.as_tensor(totals))
    np.testing.assert_array_equal(net.numpy()[~low], net_p.numpy()[~low])
    np.testing.assert_array_equal(dy.numpy()[~low], dy_p.numpy()[~low])


def test_kraft_noise_low_counts():
    """Low-count bins get Kraft medians and HPD errors; high-count bins
    keep the frequentist treatment (test_simulator.py's case)."""
    n = 1000
    exposures, bkg_counts = np.full(n, 1.0), np.full(n, 1.0)
    noise = KraftNoise(exposures, bkg_counts, np.full(n, 0.1), device="cpu")
    noise.seed(2)
    noisy, dy = noise.add_noise(np.full(n, 3.0))
    assert np.all(np.isfinite(noisy)) and np.all(np.isfinite(dy))
    assert np.all(noisy >= 0)
    np.testing.assert_allclose(np.mean(noisy), 3.7, atol=0.5)

    noise_hi = KraftNoise(exposures, bkg_counts, np.full(n, 0.1), device="cpu")
    noise_hi.seed(3)
    poiss = PoissonNoise(exposures, bkg_counts, np.full(n, 0.1), device="cpu")
    poiss.seed(3)
    n1, d1 = noise_hi.add_noise(np.full(n, 100.0))
    n2, d2 = poiss.add_noise(np.full(n, 100.0))
    np.testing.assert_allclose(n1, n2)
    np.testing.assert_allclose(d1, d2)


def test_generate_batch_with_kraft_noise():
    """The batched path with the Kraft model selected by background rates
    (test_simulator.py's case)."""
    rng = np.random.default_rng(8)
    n = 60
    times = np.cumsum(rng.uniform(40.0, 80.0, n))
    sim = Simulator(psd_models.BendingPowerlaw(S0=0.001, omega0=0.01), times, 10.0, 0.5, "Gaussian",
                    bkg_rate=np.full(n, 0.05), bkg_rate_err=np.full(n, 0.01), extension_factor=2, random_state=1,
                    device="cpu")
    assert sim.noise.name == "Kraft"
    gen = torch.Generator().manual_seed(0)
    rates = sim.simulate_batch(sim._psd_values().expand(6, -1), generator=gen)
    noisy, dy = (v.numpy() for v in sim.add_noise_batch(rates, gen))
    assert noisy.shape == (6, n)
    assert np.all(np.isfinite(noisy)) and np.all(np.isfinite(dy)) and np.all(dy > 0)


def _faint_lightcurve(n=48, seed=3):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    y = np.empty(n)
    y[0] = rng.normal()
    phi = np.exp(-0.05 * np.diff(t))
    innov = rng.normal(0.0, np.sqrt(1.0 - phi**2))
    for i in range(1, n):
        y[i] = phi[i - 1] * y[i - 1] + innov[i - 1]
    return GappyLightcurve(t, 6.0 + y, np.full(n, 0.5), exposures=1.5, bkg_rate=np.full(n, 0.3),
                           bkg_rate_err=np.full(n, 0.03))


def test_posterior_generation_and_lrt_with_background():
    """A background and no sigma_noise select Kraft noise: the posterior
    generator and the LRT run on the CPU (both raised before)."""
    lc = _faint_lightcurve()
    null = DampedRandomWalk(1.0, -3.0, bounds=[(-5, 10), (-8, 2)])
    alt = null + Lorentzian(-1.0, 2.0, -2.0, bounds=[(-8, 5), (0, 6), (-5, 0)])
    gp = GPModelling(lc, null, device="cpu")
    gp.derive_posteriors(max_steps=60, walkers=8, fit=False, converge=False, seed=2)
    rates, dy = gp.generate_batch_from_posteriors(5, seed=4)
    assert gp._simulator.noise.name == "Kraft"
    assert rates.shape == dy.shape == (5, lc.n) and np.all(np.isfinite(rates)) and np.all(dy > 0)
    assert int(gp._simulator.noise.bins_replaced) > 0
    res = protassov_lrt(lc, null, alt, nsims=4, observed_max_steps=60, observed_walkers=8, sim_max_steps=20,
                        sim_walkers=4, chunk=8, seed=1, device="cpu")
    assert res.null_model._simulator.noise.name == "Kraft"
    assert res.t_dist.shape == (4,) and np.all(np.isfinite(res.t_dist)) and 0.0 <= res.p_value <= 1.0


def test_host_functions_equal_jax_on_the_same_draws():
    psd = psd_models.BendingPowerlaw(S0=5.0, omega0=0.05)
    for N in (1000, 1001):
        np.random.seed(5)
        ref = jcore.get_fft(N, 0.5, psd)
        np.random.seed(5)
        normals = np.random.normal(0, size=(2, N // 2 + 1))
        np.testing.assert_array_equal(tcore.get_fft(N, 0.5, psd, normals=normals), ref)
        np.testing.assert_array_equal(tcore.get_fft(N, 0.5, psd, rng=np.random.default_rng(2)),
                                      tcore.get_fft(N, 0.5, psd, normals=np.random.default_rng(2).normal(
                                          0, size=(2, N // 2 + 1))))

    t = np.arange(0.0, 300.0, 0.5)
    rate = np.random.default_rng(1).normal(5, 1, t.size)
    jl, tl = JRegular(t, rate, dt=0.5), RegularLightcurve(t, rate, dt=0.5)
    for k in (0, 2, 5):
        a, b = jcore.get_segment(jl, 40.0, k), tcore.get_segment(tl, 40.0, k)
        np.testing.assert_array_equal(a.time, b.time)
        np.testing.assert_array_equal(a.countrate, b.countrate)
    with pytest.raises(ValueError):
        tcore.get_segment(tl, 40.0, -1)
    np.random.seed(7)
    a = jcore.cut_random_segment(jl, 55.0)
    np.random.seed(7)
    b = tcore.cut_random_segment(tl, 55.0, shift=np.random.uniform(t[0], t[-1] - 55.0))
    np.testing.assert_array_equal(a.time, b.time)
    np.testing.assert_array_equal(a.countrate, b.countrate)

    rates, exposures, bkg, err = rate[:50], np.full(50, 2.0), np.full(50, 0.4), np.full(50, 0.05)
    np.random.seed(9)
    ref = jcore.add_poisson_noise(rates, exposures, bkg, err)
    np.random.seed(9)
    counts = np.random.poisson(rates * exposures + bkg)
    for x, y in zip(tcore.add_poisson_noise(rates, exposures, bkg, err, counts=counts), ref):
        np.testing.assert_array_equal(x, y)


def test_downsample_equals_jax():
    t = np.cumsum(np.random.default_rng(5).uniform(2.0, 8.0, 60))
    psd = psd_models.BendingPowerlaw(S0=5.0, omega0=0.05)
    a = JSimulator(psd, t, 1.0, 7.0, "Gaussian", extension_factor=2.0)
    b = Simulator(psd, t, 1.0, 7.0, "Gaussian", extension_factor=2.0, device="cpu")
    fine = np.arange(t[0] - 5.0, t[-1] + 5.0, 0.25)
    lc_rate = np.random.default_rng(6).normal(7, 1, fine.size)
    out = b.downsample(RegularLightcurve(fine, lc_rate, dt=0.25))
    np.testing.assert_array_equal(out, a.downsample(JRegular(fine, lc_rate, dt=0.25)))
    assert len(out) == t.size and np.all(np.isfinite(out))


def test_generate_lightcurve_with_jax_draws():
    """``generate_lightcurve`` is simulate_batch at B = 1: fed the draws of
    the JAX package's next key, it follows the JAX generate_lightcurve."""
    t = np.cumsum(np.random.default_rng(5).uniform(2.0, 8.0, 60))
    psd_model = psd_models.BendingPowerlaw(S0=5.0, omega0=0.05)
    a = JSimulator(psd_model, t, 1.0, 7.0, "Gaussian", extension_factor=2.0, random_state=3)
    b = Simulator(psd_model, t, 1.0, 7.0, "Gaussian", extension_factor=2.0, random_state=3, device="cpu")
    _, key = jax.random.split(a._key)  # the key generate_lightcurve takes next
    k_fft, k_cut, _ = jax.random.split(key, 3)
    n_freq = a.omega.size
    normals = np.array(jax.random.normal(k_fft, (2, n_freq), dtype=jnp.float64))
    shift = float(jax.random.uniform(k_cut, (), minval=a.sim_timestamps[0],
                                     maxval=a.sim_timestamps[-1] - a.sim_duration, dtype=jnp.float64))
    ref = a.generate_lightcurve()
    out = b.generate_lightcurve(normals=normals, shift=shift)
    assert out.shape == ref.shape == (t.size,)
    n_fft, dt = a.fftndatapoints, a.sim_dt
    dc_level = 1e6 / n_fft * np.sqrt(n_fft * dt * np.sqrt(2 * np.pi)) / dt
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * dc_level)
    # from its own generator: seeded, a fresh draw each call
    c, d = (Simulator(psd_model, t, 1.0, 7.0, "Gaussian", extension_factor=2.0, random_state=3, device="cpu")
            for _ in range(2))
    first = c.generate_lightcurve()
    np.testing.assert_array_equal(first, d.generate_lightcurve())
    assert not np.array_equal(first, c.generate_lightcurve())
