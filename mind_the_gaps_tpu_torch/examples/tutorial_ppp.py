"""Posterior-predictive likelihood-ratio test (Protassov et al. 2002) on
simulated data: the script form of the reference's tutorial_ppp notebook,
end to end on the device.

The lightcurve is a DRW (40 d bend), plus with ``qpo`` a Lorentzian QPO at
10 d of half its variance, over ~daily irregular sampling with 2 ks
exposures and Poisson noise; the TK95 draw is seeded, the Poisson draw is
not (as in the reference's tutorial).  The QPO's power falls in one or two
Fourier bins of the simulation grid, so how much of it a realization
carries varies from draw to draw.  ``tutorial_ppp_counts.npz`` holds two
fixed realizations with the QPO, as the Poisson counts of the 2 ks
exposures (which alone make the lightcurve): ``jax_seed42``, the JAX
script's seed-42 lightcurve with its Poisson draw seeded 42
(``reference_counts()``), and ``h100_seed42``, this port's on an H100
(``make_lightcurve(with_qpo=True, noise_seed=42)``, which ``chip_smoke.py``
checks on the card).

Run: python -m mind_the_gaps_tpu_torch.examples.tutorial_ppp [--nsims 1000] [--qpo]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, Lorentzian
from mind_the_gaps_tpu_torch.lightcurves import GappyLightcurve
from mind_the_gaps_tpu_torch.lrt import protassov_lrt
from mind_the_gaps_tpu_torch.models import psd_models
from mind_the_gaps_tpu_torch.simulator import Simulator

DAY = 86400.0
COUNTS = Path(__file__).with_name("tutorial_ppp_counts.npz")
EXPOSURE = 2000.0


def reference_counts() -> np.ndarray:
    """The Poisson counts of the JAX script's n=800, seed-42 lightcurve with
    the QPO, its noise seeded 42 (``noise.seed(42)``);
    ``tests/test_torch_examples.py`` holds them against the JAX script."""
    with np.load(COUNTS) as f:
        return f["jax_seed42"]


def make_lightcurve(n: int = 800, seed: int = 42, with_qpo: bool = False, device="cuda", counts=None,
                    noise_seed=None) -> GappyLightcurve:
    """An irregularly sampled lightcurve from a DRW (+ QPO) PSD with Poisson
    noise over a realistic observing pattern.  ``counts``, the exposures'
    Poisson counts, replace both draws; ``noise_seed`` seeds the Poisson
    draw."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(4000, 9000, n))  # ~daily-ish cadence, s
    mean_rate = 0.5

    variance = 0.02
    psd = psd_models.BendingPowerlaw(S0=variance, omega0=2 * np.pi / (40 * DAY))  # 40 d bend
    if with_qpo:
        psd = psd + psd_models.Lorentzian(S0=variance / 2, omega0=2 * np.pi / (10 * DAY), Q=20)  # 10 d QPO

    sim = Simulator(psd, times, EXPOSURE, mean_rate, "Gaussian", extension_factor=2, random_state=seed,
                    device=device)
    if counts is not None:
        counts = torch.as_tensor(np.asarray(counts, dtype=np.float64))
        noisy, dy = (x.numpy() for x in sim.noise.add_noise_torch(counts, counts=counts))
    else:
        if noise_seed is not None:
            sim.noise.seed(noise_seed)
        noisy, dy = sim.add_noise(sim.generate_lightcurve())
    return GappyLightcurve(times, noisy, dy, exposures=EXPOSURE)


def kernels():
    """The tutorial's null (DRW) and alternative (DRW + Lorentzian)."""
    drw_bounds = [(-15, 5), (np.log(2 * np.pi / (500 * DAY)), np.log(2 * np.pi / (2 * DAY)))]

    def drw():
        return DampedRandomWalk(log_S0=np.log(0.02), log_omega0=np.log(2 * np.pi / (40 * DAY)), bounds=drw_bounds)

    qpo = Lorentzian(log_S0=np.log(0.01), log_Q=np.log(20), log_omega0=np.log(2 * np.pi / (10 * DAY)),
                     bounds=[(-15, 5), (0, 8), (np.log(2 * np.pi / (100 * DAY)), np.log(2 * np.pi / (2 * DAY)))])
    return drw(), drw() + qpo


def run(nsims: int = 1000, qpo: bool = False, max_steps: int = 10000, sim_steps: int = 500, n: int = 800,
        device="cuda", seed: int = 42, progress: bool = False, counts=None) -> dict:
    """The tutorial's LRT; returns T_obs (matched and posterior-chain), the
    p-values, the simulated T's median and 99th percentile, and the
    seconds of the LRT.  ``counts``: the lightcurve's Poisson counts
    (``reference_counts()``), else drawn from ``seed``."""
    lc = make_lightcurve(n=n, seed=seed, with_qpo=qpo, device=device, counts=counts)
    if progress:
        print(f"lightcurve: n={lc.n}, duration={lc.duration / DAY:.1f} d, mean={lc.mean:.3f}")
    null, alt = kernels()
    t0 = time.perf_counter()
    res = protassov_lrt(lc, null, alt, nsims=nsims, observed_max_steps=max_steps, sim_max_steps=sim_steps,
                        progress=progress, device=device)
    return {"metric": "tutorial_ppp", "qpo": qpo, "nsims": nsims, "n": lc.n, "t_obs": res.t_obs,
            "t_obs_posterior": res.t_obs_posterior, "p_value": res.p_value, "p_value_posterior": res.p_value_posterior,
            "t_dist_median": float(np.median(res.t_dist)), "t_dist_p99": float(np.percentile(res.t_dist, 99)),
            "converged": [bool(res.null_model.converged), bool(res.alt_model.converged)],
            "timings": res.timings, "wall_s": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nsims", type=int, default=1000)
    ap.add_argument("--qpo", action="store_true", help="inject a QPO into the data")
    ap.add_argument("--max-steps", type=int, default=10000)
    ap.add_argument("--sim-steps", type=int, default=500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(nsims=args.nsims, qpo=args.qpo, max_steps=args.max_steps, sim_steps=args.sim_steps, device=args.device,
              progress=True)
    print(f"\nT_obs (matched) = {out['t_obs']:.2f};  T_obs (posterior chain) = {out['t_obs_posterior']:.2f}")
    print(f"T_dist: median {out['t_dist_median']:.2f}, 99th pct {out['t_dist_p99']:.2f}")
    print(f"p-value = {out['p_value']:.4f} (matched; posterior-chain p = {out['p_value_posterior']:.4f})")
    print(f"({args.nsims} simulations, {out['wall_s']:.1f} s total)")
    if out["p_value"] < 0.01:
        print("=> the QPO term is strongly preferred")
    else:
        print("=> no significant evidence for the QPO term")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
