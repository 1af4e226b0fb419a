"""Command-line interface for the standard workflows, on the card.

The port of ``mind_the_gaps_tpu/cli.py``:

    python -m mind_the_gaps_tpu_torch.cli fit      LC --kernel drw [...]
    python -m mind_the_gaps_tpu_torch.cli simulate LC --kernel drw --nsims 100 [...]
    python -m mind_the_gaps_tpu_torch.cli lrt      LC --null drw --alt drw+qpo [...]

Lightcurve files: the SimpleLightcurve CSV layout (t/rate/error[...]),
Swift PCCURVE.qdp via --format swift, or a Fermi CSV via --format fermi.
Every command runs on the CUDA card unless given ``--device cpu``, the
one option the JAX CLI does not have.  ``lrt --sim-walkers`` defaults to
12, as ``protassov_lrt`` does (the JAX CLI's default is 16).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

__all__ = ["main"]


def _load(path, fmt):
    from mind_the_gaps_tpu_torch import FermiLightcurve, SimpleLightcurve, SwiftLightcurve

    if fmt == "swift":
        return SwiftLightcurve(path)
    if fmt == "fermi":
        return FermiLightcurve(path)
    return SimpleLightcurve(path)


def _make_kernel(spec: str, lc):
    """Build a kernel from a spec like 'drw', 'sho', 'matern32',
    'drw+qpo', 'drw+sho'.  Initial guesses and bounds are scaled from the
    lightcurve's duration and variance, as in the JAX CLI."""
    from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, Lorentzian, Matern32Term, SHOTerm

    duration = lc.duration
    var = float(np.var(lc.y))
    w_lo, w_hi = 2 * np.pi / (10 * duration), 2 * np.pi / (2 * np.median(np.diff(lc.times)))
    w_mid = np.sqrt(w_lo * w_hi)
    ls0 = np.log(max(var, 1e-12))
    bounds_s = (ls0 - 10, ls0 + 5)
    bounds_w = (np.log(w_lo), np.log(w_hi))

    def part(name):
        name = name.strip().lower()
        if name == "drw":
            return DampedRandomWalk(ls0, np.log(w_mid), bounds=[bounds_s, bounds_w])
        if name == "sho":
            return SHOTerm(ls0, np.log(2.0), np.log(w_mid), bounds=[bounds_s, (-3, 8), bounds_w])
        if name == "matern32":
            return Matern32Term(0.5 * ls0, -np.log(w_mid),
                                bounds=[(0.5 * ls0 - 5, 0.5 * ls0 + 3), (-bounds_w[1], -bounds_w[0])])
        if name in ("qpo", "lorentzian"):
            return Lorentzian(ls0 - 1, np.log(10.0), np.log(w_mid), bounds=[bounds_s, (0, 8), bounds_w])
        raise SystemExit(f"unknown kernel component {name!r} (use drw, sho, matern32, qpo)")

    parts = [part(p) for p in spec.split("+")]
    kernel = parts[0]
    for p in parts[1:]:
        kernel = kernel + p
    return kernel


def cmd_fit(args):
    """MCMC posteriors of one kernel; returns the GPModelling."""
    from mind_the_gaps_tpu_torch import GPModelling

    lc = _load(args.lightcurve, args.format)
    kernel = _make_kernel(args.kernel, lc)
    gp = GPModelling(lc, kernel, mean_model=args.mean_model, device=args.device)
    gp.derive_posteriors(
        max_steps=args.max_steps, walkers=args.walkers, progress=args.progress, seed=args.seed, fast=args.fast,
    )
    out = {
        "kernel": args.kernel,
        "device": args.device,
        "parameter_names": list(gp.parameter_names),
        "max_loglikelihood": float(gp.max_loglikelihood),
        "max_parameters": [float(v) for v in gp.max_parameters],
        "median_parameters": [float(v) for v in gp.median_parameters],
        "tau": [float(v) for v in np.atleast_1d(gp.tau)],
        "converged": bool(gp.converged),
        "n_samples": int(len(gp.mcmc_samples)),
    }
    if args.output:
        gp.save_posteriors(args.output)
        out["chain_file"] = args.output
    print(json.dumps(out, indent=2))
    return gp


def cmd_simulate(args):
    """Posterior-predictive lightcurves; returns (the GPModelling, numpy
    rates, numpy dy)."""
    from mind_the_gaps_tpu_torch import GPModelling

    lc = _load(args.lightcurve, args.format)
    kernel = _make_kernel(args.kernel, lc)
    gp = GPModelling(lc, kernel, mean_model=args.mean_model, device=args.device)
    if args.chain:
        gp.load_posteriors(args.chain)
    else:
        gp.derive_posteriors(
            max_steps=args.max_steps, walkers=args.walkers, progress=args.progress, seed=args.seed, fast=args.fast,
        )
    rates, dy = gp.generate_batch_from_posteriors(
        args.nsims, pdf=args.pdf, extension_factor=args.extension_factor, sigma_noise=args.sigma_noise,
        seed=args.seed,
    )
    np.savez_compressed(args.output, times=lc.times, rates=rates, dy=dy)
    print(json.dumps({"nsims": int(args.nsims), "device": args.device, "output": args.output,
                      "noise": gp._simulator.noise.name, "mean_rate": float(np.mean(rates))}))
    return gp, rates, dy


def cmd_lrt(args):
    """The Protassov posterior-predictive LRT; returns the LRTResult."""
    from mind_the_gaps_tpu_torch.lrt import protassov_lrt

    lc = _load(args.lightcurve, args.format)
    null_kernel = _make_kernel(args.null, lc)
    alt_kernel = _make_kernel(args.alt, lc)
    res = protassov_lrt(
        lc, null_kernel, alt_kernel,
        nsims=args.nsims, pdf=args.pdf, sigma_noise=args.sigma_noise,
        observed_max_steps=args.max_steps, observed_walkers=args.walkers,
        sim_max_steps=args.sim_steps, sim_walkers=args.sim_walkers,
        seed=args.seed, progress=args.progress, observed_fast=args.fast,
        checkpoint=args.checkpoint, device=args.device,
    )
    out = {
        "null": args.null,
        "alt": args.alt,
        "device": args.device,
        "nsims": int(args.nsims),
        "t_obs": res.t_obs,
        "t_obs_posterior": res.t_obs_posterior,
        "p_value": res.p_value,
        "p_value_posterior": res.p_value_posterior,
        "t_dist_median": float(np.median(res.t_dist)),
        "t_dist_p99": float(np.percentile(res.t_dist, 99)),
    }
    if args.output:
        np.savez_compressed(args.output, t_dist=res.t_dist, t_obs=res.t_obs, p_value=res.p_value)
        out["output"] = args.output
    print(json.dumps(out, indent=2))
    return res


def main(argv=None):
    """Run one command; returns what the command computed (see each
    ``cmd_*``), for callers in the same process."""
    ap = argparse.ArgumentParser(prog="mind_the_gaps_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("lightcurve")
        p.add_argument("--format", choices=["simple", "swift", "fermi"], default="simple")
        p.add_argument("--mean-model", default=None, choices=[None, "constant", "linear", "gaussian"])
        p.add_argument("--max-steps", type=int, default=10000)
        p.add_argument("--walkers", type=int, default=32)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument(
            "--fast", action="store_true", default=None,
            help="explore the observed chains in float32, log-probabilities recomputed in float64",
        )
        p.add_argument("--no-fast", dest="fast", action="store_false", help="float64 observed chains (default)")
        p.add_argument("--progress", action="store_true")
        p.add_argument("--device", default="cuda", help="torch device to run on (default: cuda; cpu for the host)")

    p = sub.add_parser("fit", help="MCMC posteriors for one kernel")
    common(p)
    p.add_argument("--kernel", required=True)
    p.add_argument("--output", help=".npz chain checkpoint")
    p.set_defaults(func=cmd_fit)

    p = sub.add_parser("simulate", help="posterior-predictive lightcurves")
    common(p)
    p.add_argument("--kernel", required=True)
    p.add_argument("--chain", help="reuse a saved chain (.npz)")
    p.add_argument("--nsims", type=int, default=100)
    p.add_argument("--pdf", default="Gaussian")
    p.add_argument("--sigma-noise", type=float, default=None)
    p.add_argument("--extension-factor", type=int, default=2)
    p.add_argument("--output", required=True)
    p.set_defaults(func=cmd_simulate)

    p = sub.add_parser("lrt", help="Protassov posterior-predictive LRT")
    common(p)
    p.add_argument("--null", required=True)
    p.add_argument("--alt", required=True)
    p.add_argument("--nsims", type=int, default=1000)
    p.add_argument("--pdf", default="Gaussian")
    p.add_argument("--sigma-noise", type=float, default=None)
    p.add_argument("--sim-steps", type=int, default=500)
    p.add_argument("--sim-walkers", type=int, default=12)
    p.add_argument("--output")
    p.add_argument(
        "--checkpoint",
        help=".npz bootstrap checkpoint: written per chunk; an interrupted "
        "run resumes from the last completed chunk (exact reproduction)",
    )
    p.set_defaults(func=cmd_lrt)

    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    main()
