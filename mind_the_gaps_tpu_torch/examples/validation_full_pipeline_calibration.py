"""p-value calibration of the user's ``protassov_lrt`` pipeline.

``validation_pvalue_calibration`` batches K experiments through the
batched fitter directly: fast, but it bypasses the orchestration a user
runs (MAP fits through the gradient kernel, the observed MCMC samplers,
posterior-predictive generation from the fitted null's chain, the
chunked bootstrap, the float64 refine, the matched estimator).  This study
runs K complete ``protassov_lrt`` calls on independent null-true datasets
and KS-tests their p-values against Uniform(0, 1).

``pdf="lognormal"`` runs the non-Gaussian pipeline end to end: the
observed datasets are drawn from the same TK95 + E13 process the bootstrap
uses (a lognormal flux PDF from the DRW PSD, plus Gaussian measurement
noise).  ``seed`` offsets the observed draws and the per-experiment LRT
seeds, so that independent batches can be pooled for a larger K.

Run: python -m mind_the_gaps_tpu_torch.examples.validation_full_pipeline_calibration [--k 12]
     python -m mind_the_gaps_tpu_torch.examples.validation_full_pipeline_calibration --pdf lognormal
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from mind_the_gaps_tpu_torch.examples import _common as c
from mind_the_gaps_tpu_torch.lightcurves import GappyLightcurve
from mind_the_gaps_tpu_torch.lrt import protassov_lrt
from mind_the_gaps_tpu_torch.simulator import Simulator


def run(k: int = 12, nsims: int = 127, n: int = 400, observed_max_steps: int = 2000, observed_walkers: int = 12,
        sim_steps: int = 300, pdf: str = "gaussian", device="cuda", seed: int = 0, progress: bool = False) -> dict:
    """K complete LRTs; returns their p-values, T_obs, the observed chains'
    convergence, the KS D and p, and the wall seconds."""
    log = print if progress else (lambda *a: None)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()

    times = c.observing_pattern(rng, n)
    null_k0 = c.null_kernel()
    if pdf == "gaussian":
        factor = c.truth_factor(c.covariance(null_k0, times))

        def draw_observed():
            return c.truth_draws(rng, factor)
    else:
        theta_true = null_k0.get_parameter_vector()
        sim_obs = Simulator(lambda w: null_k0.get_psd(w, theta_true), times, exposures=1.0, mean=c.MEAN, pdf=pdf,
                            extension_factor=2, random_state=7 + seed, device=device)

        def draw_observed():
            return sim_obs.generate_lightcurve() + rng.normal(0.0, c.SIGMA, n)

    ps, t_obs, converged = [], [], []
    for i in range(k):
        lc = GappyLightcurve(times, draw_observed(), np.full(n, c.SIGMA), exposures=1.0)
        res = protassov_lrt(
            lc, c.null_kernel(), c.alt_kernel(), nsims=nsims, seed=1000 + i + 100_000 * seed,
            observed_max_steps=observed_max_steps, observed_walkers=observed_walkers, sim_max_steps=sim_steps,
            chunk=nsims + 1, pdf=pdf,
            # the observed data carry Gaussian errors of this sigma: the
            # simulations take the same noise model (None would be Poisson)
            sigma_noise=c.SIGMA, device=device,
        )
        ps.append(res.p_value)
        t_obs.append(res.t_obs)
        converged.append((bool(res.null_model.converged), bool(res.alt_model.converged)))
        log(f"[{time.perf_counter() - t0:6.0f}s] experiment {i + 1}/{k}: T_obs={res.t_obs:.2f} p={res.p_value:.3f}")

    ks_d, ks_p = c.ks_uniform(ps)
    return {"metric": "full_pipeline_calibration_ks_pvalue", "value": ks_p, "k": k, "nsims": nsims, "pdf": pdf,
            "seed": seed, "ks_d": ks_d, "ks_p": ks_p, "p_values": ps, "t_obs": t_obs, "converged": converged,
            "wall_s": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=12, help="independent experiments")
    ap.add_argument("--nsims", type=int, default=127)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--observed-max-steps", type=int, default=2000)
    ap.add_argument("--observed-walkers", type=int, default=12)
    ap.add_argument("--sim-steps", type=int, default=300)
    ap.add_argument("--pdf", choices=["gaussian", "lognormal"], default="gaussian")
    ap.add_argument("--seed", type=int, default=0,
                    help="experiment-batch seed: offsets the observed-data draws and the per-experiment LRT seeds, "
                         "so independent batches can be pooled for a higher-K uniformity test")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(k=args.k, nsims=args.nsims, n=args.n, observed_max_steps=args.observed_max_steps,
              observed_walkers=args.observed_walkers, sim_steps=args.sim_steps, pdf=args.pdf, device=args.device,
              seed=args.seed, progress=True)
    print("\np-values:", np.array2string(np.sort(out["p_values"]), precision=3))
    print(f"KS vs Uniform(0,1): D = {out['ks_d']:.3f}, p = {out['ks_p']:.3f}")
    print(json.dumps({key: out[key] for key in ("metric", "value", "k", "nsims", "pdf", "seed", "ks_d", "p_values",
                                                "t_obs", "converged", "wall_s")}))
    if out["ks_p"] < 0.01:
        print("WARNING: calibration rejected at 1% — investigate")
    else:
        print("calibration OK (uniformity not rejected)")
    return out


if __name__ == "__main__":
    main()
