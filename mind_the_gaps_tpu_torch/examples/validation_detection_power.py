"""Detection power of the Protassov LRT pipeline under injected QPOs.

The companion of ``validation_pvalue_calibration``: calibration checks that
p ~ Uniform(0, 1) when no QPO exists; this study measures how often the
pipeline detects a QPO that does exist.  For each relative QPO strength
``a`` (QPO variance as a fraction of the DRW variance), K independent
datasets are drawn from the exact DRW + Lorentzian Gaussian process
(dense Cholesky), each is fit with both models, nsims posterior-predictive
simulations from the fitted null are refit with both models (matched
estimators, the standard Protassov bootstrap), and the detection fraction
at p <= 0.05 is reported per strength.  a = 0 doubles as a calibration
check (expected detection fraction ~0.05).

All A * K observed fits of a model are one ``fit_lightcurves_batch`` and
the A * K * nsims refits run in chunks of 1024 rows, as in the LRT.

Run: python -m mind_the_gaps_tpu_torch.examples.validation_detection_power \
        [--amps 0,0.1,0.25,0.5,1.0 --k 16 --nsims 127]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from mind_the_gaps_tpu_torch.examples import _common as c
from mind_the_gaps_tpu_torch.kernels import Lorentzian


def truth(rng: np.random.Generator, times, amps, k: int, q: float, wqpo: float) -> np.ndarray:
    """(A * K, n) exact draws of the DRW plus, for a > 0, a Lorentzian QPO of
    variance a S0, quality ``q`` and angular frequency ``wqpo``, strength by
    strength from ``rng``."""
    k_drw = c.covariance(c.null_kernel(), times)
    out = []
    for a in amps:
        cov = k_drw + c.covariance(Lorentzian(np.log(a * c.TRUE_S0), np.log(q), np.log(wqpo)), times) if a > 0 \
            else k_drw
        out.append(c.truth_draws(rng, c.truth_factor(cov), k))
    return np.concatenate(out)


def run(amps=(0.0, 0.1, 0.25, 0.5, 1.0), k: int = 16, nsims: int = 127, n: int = 400, steps: int = 300,
        walkers: int = 12, q: float = 20.0, wqpo: float = 0.2, device="cuda", seed: int = 0,
        progress: bool = False) -> dict:
    """The power curve; returns, per strength, the detection fraction at
    p <= 0.05, the median p and the median T_obs, with the wall seconds."""
    log = print if progress else (lambda *a: None)
    amps = [float(a) for a in amps]
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()

    times = c.observing_pattern(rng, n)
    null, alt = c.null_kernel(), c.alt_kernel(np.log(q), np.log(wqpo))
    ys_obs = truth(rng, times, amps, k, q, wqpo)
    dys_obs = np.full_like(ys_obs, c.SIGMA)
    A = len(amps)

    t_obs, best_null = c.t_statistics(null, alt, times, ys_obs, dys_obs, (c.SEED_OBS_NULL, c.SEED_OBS_ALT),
                                      walkers, steps, c.EARLY_STOP, device)
    log(f"observed fits done ({time.perf_counter() - t0:.0f}s); T_obs medians by strength: "
        + ", ".join(f"a={a}: {np.median(t_obs[i * k:(i + 1) * k]):.2f}" for i, a in enumerate(amps)))

    sim = c.simulator(times, "Gaussian", 3, device)
    noisy, dy_sim = c.posterior_predictive(sim, null, best_null, nsims, device)
    log(f"simulated {noisy.shape[0]} lightcurves ({time.perf_counter() - t0:.0f}s)")

    t_sim, _ = c.t_statistics(null, alt, times, noisy, dy_sim, (c.SEED_SIM_NULL, c.SEED_SIM_ALT), walkers, steps,
                              c.EARLY_STOP, device, chunk=1024)
    log(f"bootstrap refits done ({time.perf_counter() - t0:.0f}s)")

    t_obs = t_obs.reshape(A, k)
    p = c.bootstrap_pvalues(t_obs, t_sim.reshape(A, k, nsims))
    results = [{"amp": a, "detect_frac_p05": float(np.mean(p[i] <= 0.05)), "median_p": float(np.median(p[i])),
                "median_T_obs": float(np.median(t_obs[i]))} for i, a in enumerate(amps)]
    return {"metric": "qpo_detection_power", "k": k, "nsims": nsims, "n": n, "q": q, "wqpo": wqpo,
            "results": results, "p_values": p, "wall_s": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--amps", default="0,0.1,0.25,0.5,1.0", help="QPO variance as a fraction of the DRW variance")
    ap.add_argument("--k", type=int, default=16, help="experiments per strength")
    ap.add_argument("--nsims", type=int, default=127, help="bootstrap size per experiment")
    ap.add_argument("--n", type=int, default=400, help="lightcurve points")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--walkers", type=int, default=12)
    ap.add_argument("--q", type=float, default=20.0, help="QPO quality factor")
    ap.add_argument("--wqpo", type=float, default=0.2, help="QPO angular frequency")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(amps=[float(a) for a in args.amps.split(",")], k=args.k, nsims=args.nsims, n=args.n, steps=args.steps,
              walkers=args.walkers, q=args.q, wqpo=args.wqpo, device=args.device, progress=True)
    for r in out["results"]:
        print(f"a={r['amp']:5.2f}: detection fraction (p<=0.05) = {r['detect_frac_p05']:.2f}, "
              f"median p = {r['median_p']:.3f}", flush=True)
    print(json.dumps({key: out[key] for key in ("metric", "k", "nsims", "n", "q", "wqpo", "results", "wall_s")}))
    return out


if __name__ == "__main__":
    main()
