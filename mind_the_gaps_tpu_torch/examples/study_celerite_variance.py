"""The celerite normalization (variance) contract: the script form of the
reference's celerite_variance notebook.

When a celerite PSD is integrated over positive ordinary frequencies, the
lightcurve variance is

    var = sum(PSD(omega)) * df * 2*pi * (2 / sqrt(2*pi))

where 2/sqrt(2*pi) accounts for the one-sided integration and the
1/sqrt(2*pi) of the Fourier convention, and 2*pi converts the
angular-frequency density.  For a DampedRandomWalk / BendingPowerlaw the
exact variance is k(0) = S0, so the study asserts

  1. the frequency integral of the analytic PSD reproduces S0, and
  2. an ensemble of simulated lightcurves (on the device) has that variance.

Run: python -m mind_the_gaps_tpu_torch.examples.study_celerite_variance
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mind_the_gaps_tpu_torch.models.psd_models import BendingPowerlaw
from mind_the_gaps_tpu_torch.simulator import Simulator

NORMALIZATION_FACTOR = 2.0 / np.sqrt(2.0 * np.pi)


def psd_integral_variance(psd_model, times, exposures, extension_factor: float = 1.0) -> float:
    """sum(PSD) df 2 pi (2 / sqrt(2 pi)) over the band from 1 / duration to
    the simulator's sampling frequency."""
    duration = times[-1] + 1.5 * exposures[-1] - (times[0] - exposures[0])
    sim_dt = np.min(exposures) / 2
    df = 1.0 / (duration * extension_factor)
    w_int = np.arange(1.0 / duration, 1.0 / sim_dt, df) * 2 * np.pi
    return float(np.sum(np.asarray(psd_model(w_int))) * df * 2 * np.pi * NORMALIZATION_FACTOR)


def run(n_points: int = 2000, n_sims: int = 256, device="cuda", seed: int = 45) -> dict:
    """Both checks; an AssertionError when one fails."""
    times = np.linspace(0.0, 2000.0, n_points)
    exposures = 0.5 * np.ones(n_points)
    S0 = 1.0
    psd_model = BendingPowerlaw(S0=S0, omega0=2 * np.pi / 100.0)  # a 100 s break

    # 1. the PSD integrated over the observable band
    var_integral = psd_integral_variance(psd_model, times, exposures)
    if not abs(var_integral / S0 - 1.0) < 0.05:
        raise AssertionError(f"PSD integral {var_integral} must reproduce k(0)=S0={S0}")

    # 2. the ensemble variance of simulated lightcurves
    simulator = Simulator(psd_model, times, exposures, mean=0.0, pdf="Gaussian", extension_factor=1.0,
                          random_state=seed, device=device)
    psd = simulator._psd_values().to(device)[None].expand(n_sims, -1).contiguous()
    rates = simulator.simulate_batch(psd, generator=torch.Generator(device).manual_seed(seed))
    ens_var = float(torch.mean(torch.var(rates, dim=1, correction=0)))
    if not abs(ens_var / var_integral - 1.0) < 0.15:
        raise AssertionError(f"simulated variance {ens_var} must match the PSD integral {var_integral} (the "
                             "sqrt(2*pi) normalization of simulator.tk95_rates)")
    return {"metric": "celerite_variance", "S0": S0, "var_integral": var_integral, "ens_var": ens_var,
            "n_sims": n_sims}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(device=args.device)
    print(f"PSD integral variance: {out['var_integral']:.4f}  (kernel k(0) = S0 = {out['S0']})")
    print(f"ensemble variance of {out['n_sims']} simulated lightcurves: {out['ens_var']:.4f}")
    print("OK: variance = sum(PSD) * df * 2*pi * 2/sqrt(2*pi) = k(0) holds end to end")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
