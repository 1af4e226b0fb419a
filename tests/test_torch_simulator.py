"""Port parity: the TK95 simulator (Gaussian flux PDF; the E13 path is in
test_torch_e13.py).

- The geometry (fine-grid step, FFT length, segment length, window starts
  and ends, angular frequencies) equals the JAX package's exactly.
- Fed the JAX package's own draws (the spectral normals and the cut
  shift), the port's TK95 pipeline reproduces the JAX series.  The JAX
  package builds the spectrum in complex64 (a TPU constraint), the port
  in complex128.  The raw series is dominated by the 1e6 DC term, so the
  complex64 rounding is relative to that level: the series agree to 2e-6
  of it (1e-6 of it once the pipeline has subtracted the mean again).
- downsample_cumsum equals the JAX package's.
- Ensemble mean, variance and PSD normalization, as test_simulator.py
  checks them for the JAX package.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mind_the_gaps_tpu.models import psd_models  # noqa: E402
from mind_the_gaps_tpu.simulator import Simulator as JSimulator  # noqa: E402
from mind_the_gaps_tpu.simulator.core import downsample_cumsum as j_downsample  # noqa: E402
from mind_the_gaps_tpu.simulator.core import tk95_rates as j_tk95  # noqa: E402
from mind_the_gaps_tpu_torch.simulator import (  # noqa: E402
    GaussianNoise,
    PoissonNoise,
    Simulator,
    downsample_cumsum,
    tk95_rates,
)


def _pattern(seed=5, n=60):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    return t, 1.0


PATTERNS = {
    "gappy": dict(times=_pattern()[0], exposures=1.0, extension_factor=2.0),
    "regular": dict(times=np.arange(0, 400, 0.8), exposures=0.8, extension_factor=1.05, aliasing_factor=8),
    "ragged_exposures": dict(
        times=_pattern(seed=6, n=40)[0],
        exposures=np.random.default_rng(7).uniform(0.5, 1.5, 40),
        extension_factor=3.0,
    ),
}


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_geometry_equal(name):
    kw = dict(PATTERNS[name])
    times, exposures = kw.pop("times"), kw.pop("exposures")
    psd = psd_models.PowerLaw(amplitude=10, alpha=1)
    a = JSimulator(psd, times, exposures, 5.0, "Gaussian", **kw)
    b = Simulator(psd, times, exposures, 5.0, "Gaussian", device="cpu", **kw)
    assert a.sim_dt == b.sim_dt
    assert a.fftndatapoints == b.fftndatapoints
    assert a._segment_len == b._segment_len
    np.testing.assert_array_equal(a.sim_timestamps, b.sim_timestamps)
    np.testing.assert_array_equal(a._win_starts, b._win_starts)
    np.testing.assert_array_equal(a._win_ends, b._win_ends)
    np.testing.assert_array_equal(a.omega, b.omega)


@pytest.mark.parametrize("n_fft", [1000, 1001])
def test_tk95_rates_with_jax_normals(n_fft):
    dt = 0.5
    omega = 2 * np.pi * np.fft.rfftfreq(n_fft, dt)
    psd = np.concatenate([[0.0], np.asarray(psd_models.BendingPowerlaw(S0=5.0, omega0=0.05)(omega[1:]))])
    key = jax.random.key(3)
    ref = np.asarray(j_tk95(key, jnp.asarray(psd), n_fft, dt))
    normals = np.array(jax.random.normal(key, (2, n_fft // 2 + 1), dtype=jnp.float64))
    out = tk95_rates(torch.as_tensor(psd), n_fft, dt, normals=torch.as_tensor(normals)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6 * np.max(np.abs(ref)))


def test_pipeline_with_jax_draws():
    """The whole Gaussian pipeline (draw, mean shift, cut, downsample)."""
    t, _ = _pattern()
    psd_model = psd_models.BendingPowerlaw(S0=5.0, omega0=0.05)
    a = JSimulator(psd_model, t, 1.0, 7.0, "Gaussian", extension_factor=2.0)
    b = Simulator(psd_model, t, 1.0, 7.0, "Gaussian", extension_factor=2.0, device="cpu")
    psd = np.asarray(a._psd_values())
    keys = jax.random.split(jax.random.key(9), 3)
    normals, shifts, ref = [], [], []
    for k in keys:
        k_fft, k_cut, _ = jax.random.split(k, 3)
        normals.append(np.array(jax.random.normal(k_fft, (2, psd.size), dtype=jnp.float64)))
        shifts.append(float(jax.random.uniform(
            k_cut, (), minval=a.sim_timestamps[0], maxval=a.sim_timestamps[-1] - a.sim_duration,
            dtype=jnp.float64)))
        ref.append(np.asarray(a._pipeline(k, jnp.asarray(psd), jnp.asarray(7.0))))
    ref = np.stack(ref)
    out = b.simulate_batch(
        torch.as_tensor(np.broadcast_to(psd, (3, psd.size)).copy()),
        normals=torch.as_tensor(np.stack(normals)), shifts=torch.as_tensor(shifts),
    ).numpy()
    assert out.shape == (3, t.size)
    n_fft, dt = a.fftndatapoints, a.sim_dt
    dc_level = 1e6 / n_fft * np.sqrt(n_fft * dt * np.sqrt(2 * np.pi)) / dt
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * dc_level)


def test_downsample_cumsum_equal():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 300))
    starts = np.sort(rng.integers(0, 290, 25))
    ends = starts + rng.integers(1, 10, 25)
    ref = np.asarray(j_downsample(jnp.asarray(x), jnp.asarray(starts), jnp.asarray(ends)))
    out = downsample_cumsum(torch.as_tensor(x), torch.as_tensor(starts), torch.as_tensor(ends)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-14, atol=1e-14)


def test_powerspectrum_normalization():
    """Integral of the normalized power spectrum == fractional rms^2."""
    psd_model = psd_models.PowerLaw(amplitude=1e-10, alpha=1)
    exposures = 0.8
    times = np.arange(0, 1000, exposures)
    simu = Simulator(psd_model, times, exposures, 10000, "Gaussian", extension_factor=1.05,
                     aliasing_factor=8, random_state=1, device="cpu")
    lc = simu.simulate_regularly_sampled()
    freqs = np.fft.rfftfreq(lc.n, lc.dt)
    pow_spec = (np.absolute(np.fft.rfft(lc.countrate)[1:])) ** 2
    pow_spec *= 2 * lc.dt / np.mean(lc.countrate) ** 2 / lc.n
    integral = np.median(np.diff(freqs[1:])) * np.sum(pow_spec)
    rms = np.var(lc.countrate) / np.mean(lc.countrate) ** 2
    np.testing.assert_allclose(integral, rms, atol=0.1)


def test_ensemble_mean_and_variance():
    variance, mean = 10, 1
    timestamps = np.arange(0, 8500, 1.0)
    psd_model = psd_models.BendingPowerlaw(S0=variance, omega0=np.exp(-3))
    simu = Simulator(psd_model, timestamps, 1.0, mean, "Gaussian", extension_factor=1.05, aliasing_factor=1,
                     device="cpu")
    psd = simu._psd_values()
    rates = simu.simulate_batch(psd.expand(100, -1), generator=torch.Generator().manual_seed(3)).numpy()
    vars_, means = rates.var(axis=1), rates.mean(axis=1)
    assert abs(variance - np.mean(vars_)) < np.std(vars_)
    assert abs(mean - np.mean(means)) < np.std(means)


def test_noise_models():
    gen = torch.Generator().manual_seed(0)
    rates = torch.full((50, 200), 2.0, dtype=torch.float64)
    noisy, dy = PoissonNoise(np.full(200, 100.0)).add_noise_torch(rates, gen)
    np.testing.assert_allclose(noisy.mean().item(), 2.0, atol=0.01)
    np.testing.assert_allclose(noisy.var().item(), 0.02, rtol=0.05)
    np.testing.assert_allclose(dy.mean().item(), np.sqrt(200) / 100, rtol=0.01)
    noisy, dy = GaussianNoise(np.ones(200), 0.5).add_noise_torch(rates, gen)
    np.testing.assert_allclose(noisy.std().item(), 0.5, rtol=0.05)
    assert torch.all(dy == 0.5)


def test_non_gaussian_pdf_is_refused():
    """Lognormal and uniform PDFs are ported (tests/test_torch_e13.py);
    any other PDF is refused, as in the JAX package."""
    with pytest.raises(ValueError, match="not implemented"):
        Simulator(psd_models.PowerLaw(), np.arange(0, 10, 1.0), 1.0, 5.0, "Cauchy", device="cpu")
