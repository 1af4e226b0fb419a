"""Lomb-Scargle slope biases under data removal: the script form of the
reference's lomb_scargle_biases notebook (the paper's Fig. 1).

Power-law (index beta) lightcurves are simulated on a regular grid on the
device; the FFT periodogram recovers beta without bias, while the
Lomb-Scargle periodogram (on the device) of the same data with ever more
samples removed flattens (|slope| biased low): the reason mind_the_gaps
fits GPs in the time domain instead of periodograms.

Asserted: (1) the mean FFT-periodogram slope is ~ -beta, (2) the LS slope
bias grows with the number of removed samples and exceeds the zero-removal
bias by a clear margin at 50% removal.

Run: python -m mind_the_gaps_tpu_torch.examples.study_lomb_scargle_biases
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mind_the_gaps_tpu_torch.fitting import fit_lomb_scargle, fit_psd_powerlaw
from mind_the_gaps_tpu_torch.models.psd_models import PowerLaw
from mind_the_gaps_tpu_torch.periodogram import lomb_scargle
from mind_the_gaps_tpu_torch.simulator import Simulator


def fft_slope(rate, dt: float) -> float:
    """The Vaughan+2005 power-law slope of the FFT periodogram of a regular
    series (without the zero and Nyquist bins)."""
    freqs = np.fft.rfftfreq(len(rate), dt)
    if len(freqs) % 2 == 0:
        pow_spec, frequencies = np.abs(np.fft.rfft(rate)[1:-1]) ** 2, freqs[1:-1]
    else:
        pow_spec, frequencies = np.abs(np.fft.rfft(rate)[1:]) ** 2, freqs[1:]
    return float(fit_psd_powerlaw(frequencies, pow_spec)[0])


def ls_slope(times, rate, frequencies, device) -> float:
    """The power-law slope of the 'psd'-normalized Lomb-Scargle periodogram
    of (times, rate) at ``frequencies``."""
    power = lomb_scargle(times, rate, frequencies, normalization="psd", device=device)
    return float(fit_lomb_scargle(frequencies, power.cpu().numpy())[0])


def run(n_points: int = 1000, n_sims: int = 64, n_ls: int = 32, removed=(0, 250, 500), beta: float = 1.8,
        device="cuda", seed: int = 27) -> dict:
    """Both checks; an AssertionError when one fails."""
    rng = np.random.default_rng(seed)
    mean, dt = 3.0, 1.0
    timestamps = np.arange(0, n_points, dt, dtype=float)
    simulator = Simulator(PowerLaw(amplitude=1.0, x_0=1.0, alpha=beta), timestamps, np.ones(n_points) * dt, mean,
                          aliasing_factor=1, extension_factor=10, random_state=seed, device=device)
    psd = simulator._psd_values().to(device)[None].expand(n_sims, -1).contiguous()
    rates = simulator.simulate_batch(psd, generator=torch.Generator(device).manual_seed(seed)).cpu().numpy()

    # 1. the FFT periodogram is unbiased
    fft_mean = float(np.mean([fft_slope(rate, dt) for rate in rates]))
    if not abs(fft_mean + beta) < 0.2:
        raise AssertionError(f"FFT periodogram mean slope {fft_mean} must recover the input index -{beta}")

    # 2. the LS slope against the number of removed samples
    ls_freqs = np.linspace(1.0 / (timestamps[-1] - timestamps[0]), 1.0 / (2 * dt), n_points // 2)[:-1]  # no Nyquist
    ls_means = []
    for n_remove in removed:
        slopes = []
        for rate in rates[:n_ls]:
            keep = np.sort(rng.choice(n_points, n_points - n_remove, replace=False))
            slopes.append(ls_slope(timestamps[keep], rate[keep], ls_freqs, device))
        ls_means.append(float(np.mean(slopes)))
    biases = [abs(s + beta) for s in ls_means]
    if not biases[-1] > biases[0] + 0.1:
        raise AssertionError(f"LS slope must flatten (bias grow) as sampling gaps increase: biases {biases}")
    if not ls_means[-1] > ls_means[0]:
        raise AssertionError(f"LS slopes {ls_means} must be biased towards zero (flatter), not steeper")
    return {"metric": "lomb_scargle_biases", "beta": beta, "fft_mean_slope": fft_mean, "removed": list(removed),
            "n_points": n_points, "ls_mean_slopes": ls_means}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(device=args.device)
    print(f"FFT periodogram mean slope: {out['fft_mean_slope']:.2f} (input -{out['beta']})")
    for n_remove, s in zip(out["removed"], out["ls_mean_slopes"]):
        print(f"removed {n_remove:4d}/{out['n_points']}: LS mean slope {s:.2f}")
    print("OK: Lomb-Scargle slopes flatten with missing data; FFT periodogram is unbiased")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
