"""Noise floor against the celerite PSD: the script form of the
reference's poisson_level notebook.

Two conventions the package inherits:

1. An absolute-normalized periodogram (P = 2 dt / N |FFT|^2 of the rate)
   overlays the celerite PSD after multiplying the PSD by
   2 pi * 2 / sqrt(2 pi), and the ratio 2 P / PSD follows chi^2 with 2 dof.
2. Measurement noise of std sigma adds a flat floor at
   2 dt sigma^2 / (2 pi * 2 / sqrt(2 pi)) in celerite PSD units: the level a
   JitterTerm must absorb when fitting noisy data.

Asserted: the chi^2(2) distribution of the noiseless periodogram ratio (KS
test), the measured high-frequency floor of the noisy periodogram, and a
MAP fit of DRW + JitterTerm (on the device) recovering sigma.

Run: python -m mind_the_gaps_tpu_torch.examples.study_poisson_level
"""
from __future__ import annotations

import argparse
import json

import numpy as np
from scipy.stats import chi2, ks_1samp

from mind_the_gaps_tpu_torch.gpmodelling import GPModelling
from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, JitterTerm
from mind_the_gaps_tpu_torch.lightcurves import GappyLightcurve
from mind_the_gaps_tpu_torch.models.psd_models import BendingPowerlaw
from mind_the_gaps_tpu_torch.simulator import Simulator

NORMALIZATION_FACTOR = 2.0 / np.sqrt(2.0 * np.pi)


def abs_periodogram(rates, dt):
    """Stingray's 'abs'-normalized periodogram of a rate series, without the
    zero and Nyquist bins (Vaughan+2005)."""
    n = len(rates)
    fft = np.fft.rfft(rates - np.mean(rates))
    freqs = np.fft.rfftfreq(n, dt)
    power = 2.0 * dt / n * np.abs(fft) ** 2
    if n % 2 == 0:
        return freqs[1:-1], power[1:-1]
    return freqs[1:], power[1:]


def predicted_floor(psd_model, freqs, dt: float, sigma: float) -> float:
    """The high-frequency level (freqs > 0.25 / dt) in celerite PSD units:
    the noise floor 2 dt sigma^2 / (2 pi * 2 / sqrt(2 pi)) plus the mean PSD
    there."""
    hi = freqs > 0.25 / dt
    floor = 2 * dt * sigma**2 / (2 * np.pi * NORMALIZATION_FACTOR)
    return float(floor + np.mean(np.asarray(psd_model(freqs[hi] * 2 * np.pi))))


def run(n_points: int = 2000, sigma: float = 0.5, device="cuda", seed: int = 42) -> dict:
    """The three checks; an AssertionError when one fails."""
    rng = np.random.default_rng(seed)
    dt = 1.0
    times = np.arange(n_points) * dt
    S0, w0 = 1.0, 2 * np.pi / 50.0
    psd_model = BendingPowerlaw(S0=S0, omega0=w0)
    simulator = Simulator(psd_model, times, np.ones(n_points) * dt, mean=10.0, pdf="Gaussian", aliasing_factor=2,
                          extension_factor=2, random_state=7, device=device)

    # 1. the TK95 periodogram is chi^2(2)-distributed around the celerite PSD
    #    (x 2 pi * 2 / sqrt(2 pi)), on the finely, regularly sampled series:
    #    with exposure == cadence exposure binning would attenuate the band
    #    near Nyquist, which is physics, not convention
    reg = simulator.simulate_regularly_sampled()
    freqs_r, power_r = abs_periodogram(reg.countrate, reg.dt)
    ratio = 2.0 * power_r / (np.asarray(psd_model(freqs_r * 2 * np.pi)) * 2 * np.pi * NORMALIZATION_FACTOR)
    chi2_p = float(ks_1samp(ratio, chi2(2).cdf).pvalue)
    if not chi2_p > 1e-3:
        raise AssertionError(f"periodogram must be chi^2(2)-distributed around the celerite PSD (KS p {chi2_p})")

    # 2. Gaussian noise adds a flat floor at 2 dt sigma^2 / (2 pi nf)
    rates = simulator.generate_lightcurve()
    noisy = rates + rng.normal(0, sigma, n_points)
    freqs, power_noisy = abs_periodogram(noisy, dt)
    measured = float(np.mean(power_noisy[freqs > 0.25 / dt] / (2 * np.pi * NORMALIZATION_FACTOR)))
    predicted = predicted_floor(psd_model, freqs, dt, sigma)
    if not abs(measured / predicted - 1.0) < 0.25:
        raise AssertionError(f"high-f periodogram level {measured} against the predicted floor {predicted}")

    # 3. a MAP fit of DRW + JitterTerm recovers sigma (errors of 1e-12, as
    #    the notebook's gp.compute)
    lc = GappyLightcurve(times, noisy, np.full(n_points, 1e-12))
    kernel = DampedRandomWalk(log_S0=np.log(np.var(noisy)), log_omega0=np.log(w0),
                              bounds=[(-30, 15), (-25, -1)]) + JitterTerm(log_sigma=np.log(0.3), bounds=[(-10, 20)])
    sigma_fit = float(np.exp(GPModelling(lc, kernel, device=device).fit().x[-1]))
    if not abs(sigma_fit / sigma - 1.0) < 0.2:
        raise AssertionError(f"JitterTerm must absorb the noise floor: fitted sigma {sigma_fit}, input {sigma}")
    return {"metric": "poisson_level", "chi2_ks_p": chi2_p, "measured_floor": measured, "predicted_floor": predicted,
            "sigma": sigma, "sigma_fit": sigma_fit}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(device=args.device)
    print(f"chi^2(2) KS p-value (noiseless periodogram / celerite PSD): {out['chi2_ks_p']:.3f}")
    print(f"high-f periodogram level {out['measured_floor']:.4f} vs predicted floor {out['predicted_floor']:.4f}")
    print(f"fitted jitter sigma: {out['sigma_fit']:.3f} (input {out['sigma']})")
    print("OK: periodogram ~ chi^2(2) * celerite PSD; noise floor 2*dt*sigma^2/(2*pi*2/sqrt(2*pi)) measured and "
          "recovered by JitterTerm")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
