"""Kernel model selection with AICc and the KS test of the residuals: the
script form of the reference's tutorial_model_selection notebook, each
candidate fit and sampled on the device (``selection.compare_models``).

Run: python -m mind_the_gaps_tpu_torch.examples.tutorial_model_selection
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from mind_the_gaps_tpu_torch.examples import _common as c
from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, Lorentzian, Matern32Term, SHOTerm
from mind_the_gaps_tpu_torch.lightcurves import GappyLightcurve
from mind_the_gaps_tpu_torch.selection import compare_models


def make_lightcurve(n: int = 500, seed: int = 3) -> GappyLightcurve:
    """An exact DRW draw (S0 = 4, omega0 = 0.05, errors 0.3) over gaps
    uniform in [2, 6)."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(2.0, 6.0, n))
    true = DampedRandomWalk(log_S0=np.log(c.TRUE_S0), log_omega0=np.log(c.TRUE_W0))
    y = c.truth_draws(rng, c.truth_factor(c.covariance(true, t), noise_var=0.09))
    return GappyLightcurve(t, y, np.full(n, c.SIGMA), exposures=1.0)


def candidates():
    """The tutorial's four candidates and bounds (R = 1, 4, 2, 3)."""
    return {
        "DRW": DampedRandomWalk(0.0, -2.0, bounds=[(-5, 8), (-8, 2)]),
        "SHO": SHOTerm(0.0, 0.0, -2.0, bounds=[(-5, 8), (-3, 5), (-8, 2)]),
        "Matern32": Matern32Term(0.0, 2.0, bounds=[(-5, 8), (-2, 8)]),
        "DRW+QPO": DampedRandomWalk(0.0, -2.0, bounds=[(-5, 8), (-8, 2)])
        + Lorentzian(-1.0, 2.0, -2.0, bounds=[(-8, 5), (0, 6), (-5, 0)]),
    }


def run(n: int = 500, max_steps: int = 4000, walkers: int = 24, device="cuda", seed: int = 0) -> dict:
    """``compare_models`` over the four candidates; returns each one's
    parameter count, max log-likelihood, AICc, delta AICc, Akaike weight
    and residual KS p, best first, with the wall seconds."""
    lc = make_lightcurve(n=n)
    t0 = time.perf_counter()
    results = compare_models(lc, candidates(), max_steps=max_steps, walkers=walkers, seed=seed, device=device)
    rows = [{"name": r.name, "k": int(r.k), "max_loglikelihood": float(r.max_loglikelihood), "aicc": float(r.aicc),
             "delta_aicc": float(r.delta_aicc), "akaike_weight": float(r.akaike_weight),
             "ks_pvalue": float(r.ks_pvalue)} for r in results]
    return {"metric": "model_selection", "n": n, "results": rows, "wall_s": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(device=args.device)
    print(f"{'model':<10} {'k':>2} {'maxLL':>10} {'AICc':>10} {'dAICc':>8} {'weight':>7} {'KS p':>7}")
    for r in out["results"]:
        print(f"{r['name']:<10} {r['k']:>2} {r['max_loglikelihood']:>10.2f} {r['aicc']:>10.2f} "
              f"{r['delta_aicc']:>8.2f} {r['akaike_weight']:>7.3f} {r['ks_pvalue']:>7.3f}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
