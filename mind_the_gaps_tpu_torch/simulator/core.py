"""TK95 / E13 lightcurve simulator, batched on tensors.

PyTorch port of ``mind_the_gaps_tpu/simulator/core.py``:

- the Timmer & Koenig (1995) frequency-domain draw and ``irfft`` for a
  batch of PSDs (``tk95_rates``), in float64;
- a random segment of the long simulated series is cut and shifted to
  the observation start, after which the fine grid sits at fixed offsets
  from every exposure bin, so resampling is a cumulative sum over static
  index windows (``downsample_cumsum``);
- non-Gaussian flux PDFs: the Emmanoulopoulos+13 amplitude / rank-order
  iteration (``e13_adjust_batch``) in lock-step over a chunk of segments,
  its rank-order remap through ``ops.rank_remap`` (the CUDA sort kernel
  on CUDA tensors);
- observational noise from ``simulator/noise.py``;
- the single-lightcurve API of the JAX package: ``generate_lightcurve``
  (one draw through the batched path), ``add_noise``, ``downsample`` and
  the module functions ``add_poisson_noise``, ``get_fft``, ``get_segment``
  and ``cut_random_segment``, which draw from an explicit
  ``numpy.random.Generator`` (or take their draws) where the JAX package
  used numpy's global state.

The ``Simulator`` geometry (fine-grid step, the next 5-smooth FFT length,
segment length, the E13 power-of-two cut, window starts/ends, angular
frequencies) is computed in numpy exactly as in the JAX package: it
changes the simulated series.

The random numbers (the spectral normals, the cut shifts and the PDF
draws) may be passed in as tensors, so a test can give both packages the
same draws.
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, Optional, Union

import numpy as np
import torch

from mind_the_gaps_tpu_torch.ops import rank_remap, sort_kv
from mind_the_gaps_tpu_torch.simulator.noise import GaussianNoise, KraftNoise, PoissonNoise
from mind_the_gaps_tpu_torch.simulator.regular import RegularLightcurve
from mind_the_gaps_tpu_torch.stats import create_log_normal, create_uniform_distribution, sample_pdf

__all__ = [
    "Simulator",
    "TK95Simulator",
    "E13Simulator",
    "tk95_rates",
    "downsample_cumsum",
    "e13_adjust",
    "e13_adjust_batch",
    "add_poisson_noise",
    "get_fft",
    "get_segment",
    "cut_random_segment",
]

_SQRT_2PI = math.sqrt(2.0 * math.pi)


def tk95_rates(psd_values, n_fft: int, dt: float, normals=None, generator: Optional[torch.Generator] = None):
    """TK95 realizations: count-rate series (..., n_fft).

    ``psd_values`` (..., n_fft // 2 + 1): the PSD at the angular
    frequencies 2 pi rfftfreq(n_fft, dt); entry 0 is not used.
    ``normals`` (..., 2, n_fft // 2 + 1): the real and imaginary standard
    normals (drawn from ``generator`` when not given).  Normalization:
    counts * sqrt(n_fft dt sqrt(2 pi)) / dt (the celerite PSD convention).
    """
    nf = n_fft // 2 + 1
    if normals is None:
        normals = torch.randn(
            psd_values.shape[:-1] + (2, nf), generator=generator,
            dtype=psd_values.dtype, device=psd_values.device,
        )
    amp = torch.sqrt(0.5 * psd_values[..., 1:])
    re = normals[..., 0, 1:] * amp
    im = normals[..., 1, 1:] * amp
    if n_fft % 2 == 0:
        im = torch.cat([im[..., :-1], torch.zeros_like(im[..., -1:])], dim=-1)
    dc = torch.full(re.shape[:-1] + (1,), 1e6, dtype=re.dtype, device=re.device)
    spectrum = torch.complex(torch.cat([dc, re], -1), torch.cat([torch.zeros_like(dc), im], -1))
    counts = torch.fft.irfft(spectrum, n=n_fft, dim=-1)
    return counts * (math.sqrt(n_fft * dt * _SQRT_2PI) / dt)


def downsample_cumsum(segment_rates, starts, ends):
    """Mean of the fine samples in each [start, end) index window, by
    cumulative sums; ``segment_rates`` (..., M)."""
    cs = torch.cumsum(segment_rates, dim=-1)
    cs = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)
    return (cs[..., ends] - cs[..., starts]) / (ends - starts).to(segment_rates.dtype)


def _apply_rank_permutation(order, sorted_draws):
    """``out[b, order[b, i]] = sorted_draws[b, i]``: a scatter within each
    row (float64, outside the kernel, as in the JAX package)."""
    return torch.empty_like(sorted_draws).scatter_(-1, order, sorted_draws)


def e13_adjust_batch(segments, pdf: str, mean, max_iter: int, rtol=1e-4, atol=1e-8,
                     generator: Optional[torch.Generator] = None, draws=None, std=None):
    """Emmanoulopoulos+13 adjustment of a (B, m) chunk of segments, in
    lock-step: returns (adjusted (B, m) float64, iterations (B,) int32).

    Target amplitudes from each segment's spectrum, phases and the value
    ranking from draws of the target PDF, moment-matched to (``mean``, the
    segment's std, or ``std`` when given).  ``draws`` (B, m) are the standard
    draws of ``stats.sample_pdf`` (else drawn from ``generator``).  The
    spectral step and the remap run in float32; every iterate is a
    permutation of the draws, and the output permutes the full-precision
    float64 draws.  A row stops (freezes) once its iterate moves by no more
    than ``atol + rtol |x|`` or after ``max_iter`` iterations, so each row's
    result does not depend on the other rows of the chunk.  The loop checks
    on the host after each iteration whether any row is still active.
    """
    B, m = segments.shape
    namp = m // 2 + 1
    sample_std = (segments.std(dim=-1, correction=0) if std is None
                  else torch.as_tensor(std, dtype=torch.float64, device=segments.device))
    xsim = sample_pdf(pdf, mean, sample_std.reshape(-1, 1), (B, m), generator=generator, draws=draws)
    amplitudes_norm = torch.abs(torch.fft.rfft(segments.float(), dim=-1)) / namp
    # descending float64 draws (a loop constant): every iterate is a
    # permutation of them, so one sort per iteration is enough
    _, sorted_draws = sort_kv(-xsim, xsim)
    sorted_draws32 = sorted_draws.float()

    def spectral_step(x32):
        phases = torch.angle(torch.fft.rfft(x32, dim=-1))
        adj = torch.fft.irfft(amplitudes_norm * torch.exp(1j * phases), n=m, dim=-1)
        order, xnew = rank_remap(adj, sorted_draws32)
        return xnew, order

    def moved(new, old):
        return ~torch.all(torch.abs(new - old) <= atol + rtol * torch.abs(old), dim=-1)

    xprev = xsim.float()
    xadj, order = spectral_step(xprev)
    iters = torch.zeros(B, dtype=torch.int32, device=segments.device)
    active = moved(xadj, xprev) & (max_iter > 0)
    while bool(active.any()):
        xnew, order_new = spectral_step(xadj)
        a = active[:, None]
        xprev = torch.where(a, xadj, xprev)
        xadj = torch.where(a, xnew, xadj)
        order = torch.where(a, order_new, order)
        iters = torch.where(active, iters + 1, iters)
        active = active & moved(xadj, xprev) & (iters < max_iter)
    return _apply_rank_permutation(order, sorted_draws), iters


def e13_adjust(segment_rates, pdf: str, mean, max_iter: int, std=None, rtol=1e-4, atol=1e-8,
               generator: Optional[torch.Generator] = None, draws=None):
    """``e13_adjust_batch`` of one (m,) segment: (adjusted (m,), iterations)."""
    out, iters = e13_adjust_batch(
        segment_rates[None], pdf, mean, max_iter, rtol=rtol, atol=atol, generator=generator,
        draws=None if draws is None else draws[None], std=std,
    )
    return out[0], int(iters[0])


class BaseSimulatorMethod:
    def __init__(self, mean):
        self.meanrate = mean

    def adjust_pdf(self, segment):
        raise NotImplementedError("This method should be implemented by subclasses")


class TK95Simulator(BaseSimulatorMethod):
    """Gaussian flux PDF: the TK95 series already has it; no-op."""

    def __init__(self, mean, random_state=None):
        super().__init__(mean)

    def adjust_pdf(self, segment):
        return segment


class E13Simulator(BaseSimulatorMethod):
    """Non-Gaussian flux PDFs by the E13 iteration, for one regularly
    sampled segment at a time on ``device``."""

    def __init__(self, mean, pdf: str, max_iter: int = 1000, random_state=None, device="cuda"):
        super().__init__(mean)
        if pdf not in ("lognormal", "uniform", "gaussian"):
            raise ValueError("pdf must be one of 'lognormal', 'uniform', 'gaussian'")
        self.pdf = pdf
        self.max_iter = max_iter
        if pdf == "lognormal":
            self.pdfmethod = create_log_normal
        elif pdf == "uniform":
            self.pdfmethod = create_uniform_distribution
        else:
            from scipy.stats import norm

            self.pdfmethod = norm
        self.device = torch.device(device)
        self._seed = int(np.random.SeedSequence(random_state).entropy % (2**63))
        self._generator = None  # made at first use, on the device

    def _adjust(self, lc: RegularLightcurve, mean, max_iter, std=None):
        if self._generator is None:
            self._generator = torch.Generator(self.device).manual_seed(self._seed)
        x = torch.as_tensor(lc.countrate, dtype=torch.float64, device=self.device)
        adjusted, iters = e13_adjust(x, self.pdf, mean, max_iter, std=std, generator=self._generator)
        return RegularLightcurve(lc.time, adjusted.cpu().numpy(), dt=lc.dt), iters

    def adjust_pdf(self, segment: RegularLightcurve) -> RegularLightcurve:
        out, iters = self._adjust(segment, self.meanrate, self.max_iter)
        if iters == self.max_iter:
            warnings.warn(
                "Lightcurve did not converge after %d iterations, PDF might be inaccurate. "
                "Try increase the maximum number of iterations" % iters
            )
        return out

    def adjust_lightcurve_pdf(self, lc: RegularLightcurve, pdf, max_iter: int = 400):
        """The reference's adjust_lightcurve_pdf: ``pdf`` a scipy
        distribution whose mean and std are the targets."""
        return self._adjust(lc, float(pdf.mean()), max_iter, std=float(pdf.std()))[0]


class Simulator:
    """Simulate lightcurves with a given PSD and flux PDF over a real
    observing pattern (timestamps and exposures), with noise.

    The batched path (``simulate_batch``) runs on the device of the PSD
    tensor it is given.  ``simulator`` (the single-segment PDF adjustment
    of the reference's API) runs on ``device``."""

    def __init__(
        self,
        psd_model: Callable,
        times,
        exposures,
        mean: float,
        pdf: str = "gaussian",
        bkg_rate=None,
        bkg_rate_err=None,
        sigma_noise=None,
        aliasing_factor: float = 2,
        extension_factor: float = 10,
        epsilon: float = 1.001,
        max_iter: int = 400,
        random_state: Union[int, None] = None,
        device="cuda",
    ):
        times = np.asarray(times, dtype=float)
        if extension_factor < 1:
            raise ValueError("Extension factor must be greater than 1")
        if epsilon < 1:
            raise ValueError("Epsilon needs to be greater than 1!")
        if np.any(np.asarray(exposures) == 0):
            raise ValueError(
                "Some exposure times are 0! Simulation needs real exposure "
                "times: pass exposures= to GappyLightcurve before get_simulator/the LRT."
            )
        self._exposures = (
            np.full(len(times), exposures) if np.isscalar(exposures) else np.asarray(exposures, dtype=float)
        )
        if pdf.lower() not in ("gaussian", "lognormal", "uniform"):
            raise ValueError("%s not implemented! Currently implemented: Gaussian, Uniform or Lognormal" % pdf)
        seed = int(np.random.SeedSequence(random_state).entropy % (2**63))
        self._generator = torch.Generator().manual_seed(seed)
        self.device = torch.device(device)
        self._seed = seed
        self._device_generator = None  # generate_lightcurve's (a stream of its own), made at first use
        if pdf.lower() == "gaussian":
            self.simulator = TK95Simulator(mean)
        else:  # seeded too, on a stream of its own
            e13_state = None if random_state is None else (seed + 1) % (2**63)
            self.simulator = E13Simulator(mean, pdf.lower(), max_iter=max_iter, random_state=e13_state,
                                          device=device)

        self.sim_dt = float(np.min(self._exposures) / aliasing_factor)
        dt = np.diff(times)
        wrong = np.count_nonzero(dt < self.sim_dt * 0.99)
        if wrong > 0:
            raise ValueError(
                "%d timestamps differences are below the exposure integration time! "
                "Either reduce the exposure times, or space your observations" % wrong
            )
        start_time = times[0] - dt[0] / 1.99
        end_time = times[-1] + dt[-1]
        self.sim_duration = end_time - start_time
        duration = (times[-1] - times[0]) * extension_factor
        self.sim_timestamps = np.arange(
            start_time - self.sim_dt, start_time + duration + self.sim_dt, self.sim_dt
        )
        # the JAX package extends the fine grid to the next 5-smooth
        # length; kept, since it changes the simulated series
        from scipy.fft import next_fast_len

        n_good = next_fast_len(len(self.sim_timestamps), real=True)
        if n_good > len(self.sim_timestamps):
            self.sim_timestamps = self.sim_timestamps[0] + np.arange(n_good) * self.sim_dt
        self.fftndatapoints = len(self.sim_timestamps)
        self.pdf = pdf
        self.psd_model = psd_model
        self._times = times
        self.mean = mean
        self.max_iter = max_iter

        if sigma_noise is None:
            if bkg_rate is None or np.all(np.asarray(bkg_rate) == 0):
                self.noise = PoissonNoise(self._exposures, device=device)
            else:
                self.noise = KraftNoise(self._exposures, np.asarray(bkg_rate) * self._exposures, bkg_rate_err,
                                        device=device)
        else:
            self.noise = GaussianNoise(self._exposures, sigma_noise, device=device)

        half_bins = self._exposures / 2 * epsilon
        self.strategy = [(time - hb, time + hb) for time, hb in zip(times, half_bins)]

        # static segment geometry: after the cut and the shift, the fine
        # grid sits at strategy_start + dt/2 + j dt whatever the cut
        self._segment_len = min(int(np.floor(self.sim_duration / self.sim_dt)) + 1, self.fftndatapoints)
        strategy_start = self.strategy[0][0]
        seg_times = strategy_start + self.sim_dt / 2 + np.arange(self._segment_len) * self.sim_dt
        lo = np.array([b[0] for b in self.strategy])
        hi = np.array([b[1] for b in self.strategy])
        self._win_starts = np.searchsorted(seg_times, lo, side="left").astype(np.int64)
        self._win_ends = np.searchsorted(seg_times, hi, side="left").astype(np.int64)
        self._seg_times = seg_times
        self._omega = 2.0 * np.pi * np.fft.rfftfreq(self.fftndatapoints, self.sim_dt)

        # the E13 cut: a power-of-two window when the fine grid is long
        # enough (the JAX package's rule, kept because it changes the
        # series); the windows only index its first _segment_len samples
        m = self._segment_len
        self._e13_cut_len = m
        if pdf.lower() != "gaussian":
            p2 = 1 << (m - 1).bit_length()
            if p2 <= self.fftndatapoints:
                self._e13_cut_len = p2
        self._nonconv_total = None  # device count of rows that hit max_iter
        self._last_e13_iters = None  # iteration counts of the last batch

    # ------------------------------------------------------------------ #
    def __str__(self):
        return f"Simulator(\n  PSD Model: {self._psd_model}\n  PDF: {self.pdf}\n) Noise: {self.noise.name}"

    @property
    def psd_model(self):
        return self._psd_model

    @psd_model.setter
    def psd_model(self, new_psd_model):
        if not callable(new_psd_model):
            raise ValueError("PSD model must be callable (e.g., a function or a kernel's get_psd).")
        self._psd_model = new_psd_model

    @property
    def omega(self):
        """Angular frequencies of the PSD draw (entry 0, zero, is unused)."""
        return self._omega

    # ------------------------------------------------------------------ #
    # batched path
    # ------------------------------------------------------------------ #
    def _e13_chunk_default(self) -> int:
        """Lock-step chunk width of the E13 batch by cut length: about 4M
        resident elements a chunk, between 128 and 512 rows (the JAX
        package's rule)."""
        m = max(int(self._e13_cut_len or self._segment_len), 1)
        return int(max(128, min(512, 1 << int(math.log2(max(4_194_304 // m, 1))))))

    def report_nonconverged(self, warn: bool = True) -> int:
        """Number of simulated lightcurves whose E13 adjustment hit
        ``max_iter`` since the last report (one fetch from the device);
        warns like the reference's per-lightcurve message."""
        if self._nonconv_total is None:
            return 0
        count = int(self._nonconv_total)
        self._nonconv_total = None
        if count and warn:
            warnings.warn(
                "%d simulated lightcurve(s) did not converge after %d iterations, "
                "PDF might be inaccurate. Try increase the maximum number of "
                "iterations" % (count, self.max_iter)
            )
        return count

    def simulate_batch(self, psd_values_batch, generator: Optional[torch.Generator] = None,
                       mean=None, normals=None, shifts=None, pdf_draws=None,
                       chunk: Optional[int] = None, warn_nonconverged: bool = True):
        """(B, n_freq) PSD values -> (B, n_times) noiseless rates on their
        device.  ``normals`` (B, 2, n_freq), ``shifts`` (B,) in time units
        and, for a non-Gaussian PDF, ``pdf_draws`` (B, cut length) replace
        the draws from ``generator`` when given.

        A non-Gaussian PDF runs the E13 adjustment in lock-step chunks of
        ``chunk`` rows (default ``_e13_chunk_default``).  The count of rows
        that hit ``max_iter`` accumulates on the device and is reported now
        (``warn_nonconverged``) or by a later ``report_nonconverged``; the
        iteration counts of this batch stay in ``_last_e13_iters``."""
        psd = torch.as_tensor(psd_values_batch)
        B, device = psd.shape[0], psd.device
        n_fft, dt, m = self.fftndatapoints, self.sim_dt, self._e13_cut_len
        grid_t0 = float(self.sim_timestamps[0])
        grid_t1 = float(self.sim_timestamps[-1])
        mean_v = float(self.mean if mean is None else mean)

        rate = tk95_rates(psd, n_fft, dt, normals=normals, generator=generator)
        rate = rate - rate.mean(dim=-1, keepdim=True) + mean_v
        if shifts is None:
            u = torch.rand((B,), generator=generator, dtype=rate.dtype, device=device)
            shifts = grid_t0 + u * (grid_t1 - self.sim_duration - grid_t0)
        k0 = torch.ceil((torch.as_tensor(shifts, dtype=rate.dtype, device=device) - grid_t0) / dt)
        k0 = torch.clamp(k0.to(torch.int64), 0, n_fft - m)
        segment = torch.gather(rate, 1, k0[:, None] + torch.arange(m, device=device)[None, :])
        starts = torch.as_tensor(self._win_starts, device=device)
        ends = torch.as_tensor(self._win_ends, device=device)
        if self.pdf.lower() == "gaussian":
            return downsample_cumsum(segment, starts, ends)

        chunk = self._e13_chunk_default() if chunk is None else chunk
        outs, iters = [], []
        for s0 in range(0, B, chunk):
            adj, it = e13_adjust_batch(
                segment[s0 : s0 + chunk], self.pdf.lower(), mean_v, self.max_iter, generator=generator,
                draws=None if pdf_draws is None else pdf_draws[s0 : s0 + chunk],
            )
            outs.append(downsample_cumsum(adj, starts, ends))
            iters.append(it)
        self._last_e13_iters = torch.cat(iters)
        count = torch.sum(self._last_e13_iters >= self.max_iter)
        self._nonconv_total = count if self._nonconv_total is None else self._nonconv_total + count
        if warn_nonconverged:
            self.report_nonconverged()
        return torch.cat(outs)

    def add_noise_batch(self, rates_batch, generator: Optional[torch.Generator] = None):
        return self.noise.add_noise_torch(rates_batch, generator)

    # ------------------------------------------------------------------ #
    # one long realization (host)
    # ------------------------------------------------------------------ #
    def _psd_values(self):
        vals = np.asarray(self._psd_model(self._omega[1:]), dtype=float)
        return torch.as_tensor(np.concatenate([[0.0], vals]))

    def simulate_regularly_sampled(self) -> RegularLightcurve:
        """The long, finely-sampled TK95 lightcurve."""
        rate = tk95_rates(self._psd_values(), self.fftndatapoints, self.sim_dt, generator=self._generator)
        rate = rate.numpy()
        rate = rate - rate.mean() + self.mean
        return RegularLightcurve(self.sim_timestamps, rate, dt=self.sim_dt)

    def generate_lightcurve(self, normals=None, shift=None, pdf_draws=None) -> np.ndarray:
        """One realization resampled onto the input timestamps (numpy (n,)):
        ``simulate_batch`` at B = 1 on ``device``.  ``normals`` (2, n_freq),
        ``shift`` (time units) and ``pdf_draws`` (cut length,) replace the
        draws from the simulator's generator."""
        if self._device_generator is None:
            self._device_generator = torch.Generator(self.device).manual_seed((self._seed + 2) % (2**63))

        def row(x, dtype=torch.float64):
            return None if x is None else torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)[None]

        psd = self._psd_values().to(self.device)[None]
        rates = self.simulate_batch(psd, generator=self._device_generator, normals=row(normals),
                                    shifts=row(shift), pdf_draws=row(pdf_draws))
        return rates[0].cpu().numpy()

    def add_noise(self, rates):
        """Apply the noise model (host API: numpy (noisy rates, dy))."""
        return self.noise.add_noise(rates)

    def downsample(self, lc: RegularLightcurve) -> list:
        """Mean rate of an arbitrary regular lightcurve in each exposure bin
        of the observing strategy (host loop; NaN for an empty bin)."""
        rates = []
        for start, end in self.strategy:
            mask = (lc.time >= start) & (lc.time < end)
            rates.append(np.mean(lc.countrate[mask]) if mask.any() else np.nan)
        return rates


# ---------------------------------------------------------------------- #
# module-level host helpers
# ---------------------------------------------------------------------- #
def add_poisson_noise(rates, exposures, background_counts=None, bkg_rate_err=None,
                      rng: Optional[np.random.Generator] = None, counts=None):
    """Poisson noise and frequentist uncertainties (host path): numpy
    (net rates, dy).  ``counts`` (the drawn total counts) replaces the draw
    from ``rng`` (default: a fresh ``numpy.random.default_rng()``)."""
    rates = np.asarray(rates)
    if background_counts is None:
        background_counts = np.zeros(len(rates), dtype=int)
    if bkg_rate_err is None:
        bkg_rate_err = np.zeros(len(rates), dtype=int)
    total_counts = rates * exposures + background_counts
    if counts is None:
        counts = (np.random.default_rng() if rng is None else rng).poisson(total_counts)
    net_counts = counts - background_counts
    dy = np.sqrt((np.sqrt(counts) / exposures) ** 2 + bkg_rate_err**2)
    return net_counts / exposures, dy


def get_fft(N: int, dt: float, model: Callable, rng: Optional[np.random.Generator] = None,
            normals=None) -> np.ndarray:
    """TK95 frequency-domain draw (host path): complex (N // 2 + 1,).
    ``normals`` (2, N // 2 + 1), the real and imaginary standard normals,
    replace the draw from ``rng`` (default: a fresh generator)."""
    freqs = np.fft.rfftfreq(N, dt) * 2 * np.pi
    if normals is None:
        normals = (np.random.default_rng() if rng is None else rng).normal(0, size=(2, N // 2 + 1))
    real, im = np.asarray(normals, dtype=float)
    complex_fft = np.empty(len(freqs), dtype=complex)
    complex_fft[1:] = (real + im * 1j)[1:] * np.sqrt(0.5 * np.asarray(model(freqs[1:])))
    complex_fft[0] = 1e6
    if N % 2 == 0:
        complex_fft[-1] = np.real(complex_fft[-1])
    return complex_fft


def get_segment(lc: RegularLightcurve, duration: float, N: int) -> RegularLightcurve:
    """The Nth consecutive segment of the given duration."""
    if N < 0:
        raise ValueError("N must be a non-negative integer.")
    start = lc.time[0] + duration * N
    return lc.truncate(start=start, stop=start + duration, method="time")


def cut_random_segment(lc: RegularLightcurve, duration: float, rng: Optional[np.random.Generator] = None,
                       shift=None) -> RegularLightcurve:
    """A random segment of the given duration (host path); ``shift`` (its
    start time) replaces the uniform draw from ``rng``."""
    if shift is None:
        shift = (np.random.default_rng() if rng is None else rng).uniform(lc.time[0], lc.time[-1] - duration)
    return lc.truncate(start=shift, stop=shift + duration, method="time")
