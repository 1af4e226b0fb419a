"""p-value calibration of the Protassov LRT pipeline, batched.

Under the null hypothesis (data generated by the null model) the
posterior-predictive LRT p-value should be ~Uniform(0, 1).  K independent
synthetic experiments run end to end: fit null and alternative, simulate
``nsims`` lightcurves from each fitted null, refit both models to every
simulation (matched short-chain estimators everywhere), and the p-values
are KS-tested against uniformity.

The K observed fits of each model are one ``fit_lightcurves_batch``; the
K * nsims simulations are one ``Simulator.simulate_batch`` and the refits
run in chunks of 1024 rows.  ``pdf="Lognormal"`` draws the truth from the
simulator's own E13 process and runs the E13 generation (the sort kernels
on a card) in both generation stages; ``require_kernel`` fails unless
``ops.rank_remap`` and ``ops.sort_kv`` launched in each of them (at
``n=850`` the cut is 16384, the top of the sort's one-CTA tier).

Run: python -m mind_the_gaps_tpu_torch.examples.validation_pvalue_calibration [--k 16 --nsims 63]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mind_the_gaps_tpu_torch.examples import _common as c
from mind_the_gaps_tpu_torch.ops import rank_remap, sort_kv
from mind_the_gaps_tpu_torch.ops.sort import sort_tier


def _kernel_launches():
    return rank_remap.launches, sort_kv.launches


def _generation_stage(sim, label, before, require_kernel, device, log):
    """The E13 stage's report: its cut length, sort tier and sort-kernel
    launches; under ``require_kernel`` a RuntimeError unless both kernels
    launched on a CUDA device."""
    remaps, sorts = (a - b for a, b in zip(_kernel_launches(), before))
    m = sim._e13_cut_len
    tier = sort_tier(m)
    log(f"E13 generation for {label}: cut length {m}, sort tier {tier}, rank_remap launches {remaps}, "
        f"sort_kv launches {sorts} (device {device})")
    if require_kernel and not (torch.device(device).type == "cuda" and remaps > 0 and sorts > 0):
        raise RuntimeError(
            f"require_kernel: the E13 generation for {label} launched rank_remap {remaps} and sort_kv {sorts} "
            f"times on {device}; the sort kernels run on CUDA tensors only (cut length {m})")
    return {"cut_len": m, "tier": list(tier), "rank_remap": remaps, "sort_kv": sorts}


def run(k: int = 16, nsims: int = 63, n: int = 400, steps: int = 300, walkers: int = 12, pdf: str = "Gaussian",
        early_stop: bool = True, require_kernel: bool = False, device="cuda", seed: int = 0,
        progress: bool = False) -> dict:
    """The calibration study; returns its p-values, T_obs, KS D and p, the
    E13 stages' reports (lognormal) and the wall seconds."""
    log = print if progress else (lambda *a: None)
    stop = c.EARLY_STOP if early_stop else None
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()

    times = c.observing_pattern(rng, n)
    null, alt = c.null_kernel(), c.alt_kernel()
    stages = {}

    # K observed datasets from the null truth
    if pdf == "Gaussian":
        ys_obs = c.truth_draws(rng, c.truth_factor(c.covariance(null, times)), k)
    else:
        sim_obs = c.simulator(times, pdf, 11, device)
        psd = sim_obs._psd_values().to(device)
        before = _kernel_launches()
        clean = sim_obs.simulate_batch(psd[None].expand(k, -1).contiguous(),
                                       generator=torch.Generator(device).manual_seed(40))
        stages["observed truth draws"] = _generation_stage(sim_obs, "observed truth draws", before, require_kernel,
                                                           device, log)
        ys_obs = clean.cpu().numpy() + rng.normal(0.0, c.SIGMA, (k, n))
    dys_obs = np.full((k, n), c.SIGMA)

    # observed fits (both models), batched over K
    t_obs, best_null = c.t_statistics(null, alt, times, ys_obs, dys_obs, (c.SEED_OBS_NULL, c.SEED_OBS_ALT),
                                      walkers, steps, stop, device)
    log(f"observed fits done ({time.perf_counter() - t0:.0f}s); T_obs median {np.median(t_obs):.2f}")

    # nsims simulations a dataset from its fitted null
    sim = c.simulator(times, pdf, 3, device)
    before = _kernel_launches()
    noisy, dy_sim = c.posterior_predictive(sim, null, best_null, nsims, device)
    if pdf != "Gaussian":
        stages["posterior-predictive bootstrap"] = _generation_stage(sim, "posterior-predictive bootstrap", before,
                                                                     require_kernel, device, log)
    log(f"simulated {noisy.shape[0]} lightcurves ({time.perf_counter() - t0:.0f}s)")

    # bootstrap refits, batched over K * nsims
    t_sim, _ = c.t_statistics(null, alt, times, noisy, dy_sim, (c.SEED_SIM_NULL, c.SEED_SIM_ALT), walkers, steps,
                              stop, device, chunk=1024)
    t_sim = t_sim.reshape(k, nsims)
    log(f"bootstrap refits done ({time.perf_counter() - t0:.0f}s)")

    p = c.bootstrap_pvalues(t_obs, t_sim)
    ks_d, ks_p = c.ks_uniform(p)
    return {"metric": "pvalue_calibration_ks_pvalue", "k": k, "nsims": nsims, "n": n, "pdf": pdf,
            "ks_d": ks_d, "ks_p": ks_p, "p_values": p.tolist(), "t_obs": t_obs.tolist(), "t_sim": t_sim,
            "e13": stages, "wall_s": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=16, help="independent experiments")
    ap.add_argument("--nsims", type=int, default=63, help="bootstrap size per experiment")
    ap.add_argument("--n", type=int, default=400, help="lightcurve points")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--walkers", type=int, default=12)
    ap.add_argument("--f32", action="store_true", default=True, help="float32 fits (always on)")
    ap.add_argument("--pdf", default="Gaussian", choices=["Gaussian", "Lognormal"],
                    help="flux PDF of the truth AND of the posterior-predictive bootstrap "
                         "(Lognormal runs the E13 generation end to end)")
    ap.add_argument("--no-early-stop", action="store_true",
                    help="disable the production plateau rule (tol=0.01, patience=50) and run every refit for "
                         "the full fixed step budget")
    ap.add_argument("--require-kernel", action="store_true",
                    help="fail unless each E13 generation stage launched the CUDA sort kernels (rank_remap and "
                         "sort_kv); use --n >= ~850 so the power-of-two cut reaches 16384")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        out = run(k=args.k, nsims=args.nsims, n=args.n, steps=args.steps, walkers=args.walkers, pdf=args.pdf,
                  early_stop=not args.no_early_stop, require_kernel=args.require_kernel, device=args.device,
                  progress=True)
    except RuntimeError as err:
        raise SystemExit(str(err)) from err
    print("\np-values:", np.array2string(np.sort(out["p_values"]), precision=3))
    print(f"KS vs Uniform(0,1): D = {out['ks_d']:.3f}, p = {out['ks_p']:.3f}")
    print(f"total wall time {out['wall_s']:.0f}s")
    if out["ks_p"] < 0.01:
        print("WARNING: calibration rejected at 1% — investigate")
    else:
        print("calibration OK (uniformity not rejected)")
    print(json.dumps({key: out[key] for key in ("metric", "k", "nsims", "n", "pdf", "ks_d", "ks_p", "e13",
                                                "wall_s")}))
    return out


if __name__ == "__main__":
    main()
