"""End-to-end wall clock of the complete Protassov LRT on one card: the
production scenario of the JAX repo's ``benchmarks/lrt_10k.py``.

An N = 5,000-point lightcurve, null = DRW, alternative = DRW + Lorentzian
(QPO), ``--nsims`` (default 10,000) posterior-predictive simulations
refit with both models (12 walkers x 500 steps each), observed fits 32
walkers x up to 10,000 steps.  Prints ``LRTResult.timings`` (the observed
fits against the bootstrap), t_obs and p, then one JSON line with the
total.

Cold and warm: a cold run starts from a tree whose
``mind_the_gaps_tpu_torch/_build/`` is empty (a fresh checkout), so nvcc
builds the kernels inside the timed call; a second run in the same tree
is warm (the libraries are loaded from ``_build/``).

Under ``torchrun`` (``WORLD_SIZE`` > 1) every rank joins the process
group, one card a rank, and the bootstrap's refits run over the process
mesh (``protassov_lrt(mesh=parallel.process_mesh())``; rank 0 runs the
observed fits); only rank 0 prints.  One process runs unsharded.

Run: python -m mind_the_gaps_tpu_torch.examples.lrt_10k [--nsims 10000] [--pdf Lognormal] [--device cpu]
     torchrun --nproc-per-node 4 -m mind_the_gaps_tpu_torch.examples.lrt_10k [--chunk 2048]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, Lorentzian
from mind_the_gaps_tpu_torch.lightcurves import GappyLightcurve
from mind_the_gaps_tpu_torch.lrt import protassov_lrt
from mind_the_gaps_tpu_torch.ops._build import BUILD_DIR

# the JSON line's keys, those of the JAX script
KEYS = ("metric", "value", "unit", "nsims", "n_points", "p_value", "t_obs", "backend", "cache_dir")


def scenario(n_points: int = 5000):
    """The scenario's lightcurve and its null and alternative kernels.

    Times ``cumsum(uniform(2, 8))`` from ``default_rng(0)``; the data are an
    exact realization of the null (DRW = OU, S0 = e, w0 = e^-3) plus
    measurement noise (dy 0.3, mean 10, exposures 1 s), so both observed
    fits are well posed and converge as in production (white-noise data
    would leave the QPO's parameters unidentified)."""
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(2.0, 8.0, n_points))
    S0, w0 = np.exp(1.0), np.exp(-3.0)
    y = np.empty(n_points)
    y[0] = rng.normal(0.0, np.sqrt(S0))
    phi = np.exp(-w0 * np.diff(t))
    innov = rng.normal(0.0, np.sqrt(S0 * (1.0 - phi**2)))
    for i in range(1, n_points):
        y[i] = phi[i - 1] * y[i - 1] + innov[i - 1]
    dy = np.full(n_points, 0.3)
    y = y + 10.0 + rng.normal(0.0, dy)
    lc = GappyLightcurve(t, y, dy, exposures=1.0)
    null = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    alt = null + Lorentzian(log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)])
    return lc, null, alt


def backend(device) -> str:
    """The device the run took: ``cpu``, or ``cuda`` with the card's name."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(device)})"
    return device.type


def run(nsims: int = 10_000, n_points: int = 5000, observed_max_steps: int = 10_000, observed_walkers: int = 32,
        sim_steps: int = 500, sim_walkers: int = 12, chunk: int = 512, pdf: str = "Gaussian", seed: int = 0,
        progress: bool = False, device="cuda", mesh=None, null_model=None, alt_model=None) -> dict:
    """One ``protassov_lrt`` of the scenario, timed on the host clock.

    ``null_model`` / ``alt_model``: observed models with posteriors already
    derived (their fits are then not run, nor timed).  ``mesh``: the refits'
    mesh (``parallel.process_mesh()`` under torchrun).  Returns the JSON
    line's values (``KEYS``) and the run's timings, t_obs_posterior, the
    p-values, the T distribution, the chunks and the observed chains'
    convergence."""
    lc, null, alt = scenario(n_points)
    t0 = time.perf_counter()
    res = protassov_lrt(lc, null, alt, nsims=nsims, pdf=pdf, observed_max_steps=observed_max_steps,
                        observed_walkers=observed_walkers, sim_max_steps=sim_steps, sim_walkers=sim_walkers,
                        chunk=chunk, seed=seed, progress=progress, device=device, mesh=mesh,
                        null_model=null_model, alt_model=alt_model)
    total = time.perf_counter() - t0
    return {"metric": f"lrt_{nsims}sim_seconds", "value": total, "unit": "s", "nsims": nsims, "n_points": n_points,
            "p_value": res.p_value, "t_obs": res.t_obs, "backend": backend(device), "cache_dir": str(BUILD_DIR),
            "t_obs_posterior": res.t_obs_posterior, "p_value_posterior": res.p_value_posterior,
            "t_dist": res.t_dist, "timings": res.timings, "chunks": -(-(nsims + 1) // chunk),
            "converged": [bool(res.null_model.converged), bool(res.alt_model.converged)]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nsims", type=int, default=10_000)
    ap.add_argument("--n-points", type=int, default=5_000)
    ap.add_argument("--observed-max-steps", type=int, default=10_000)
    ap.add_argument("--observed-walkers", type=int, default=32)
    ap.add_argument("--sim-steps", type=int, default=500)
    ap.add_argument("--sim-walkers", type=int, default=12)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--pdf", default="Gaussian")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--progress", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device, mesh = args.device, None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from mind_the_gaps_tpu_torch import parallel

        device = parallel.initialize(device=args.device)
        mesh = parallel.process_mesh()
    lead = mesh is None or mesh.process_index == 0
    try:
        out = run(nsims=args.nsims, n_points=args.n_points, observed_max_steps=args.observed_max_steps,
                  observed_walkers=args.observed_walkers, sim_steps=args.sim_steps, sim_walkers=args.sim_walkers,
                  chunk=args.chunk, pdf=args.pdf, seed=args.seed, progress=args.progress and lead, device=device,
                  mesh=mesh)
    finally:
        if mesh is not None:
            parallel.shutdown()
    if lead:
        ranks = 1 if mesh is None else mesh.process_count
        print(f"timings {json.dumps(out['timings'])}; ranks {ranks}, chunks {out['chunks']} of {args.chunk}")
        print(f"t_obs {out['t_obs']!r}, p {out['p_value']!r}, t_obs_posterior {out['t_obs_posterior']!r}, "
              f"p_posterior {out['p_value_posterior']!r}, observed chains converged (null, alt) {out['converged']}, "
              f"total {out['value']!r} s")
        print(json.dumps({key: out[key] for key in KEYS}), flush=True)
    return out


if __name__ == "__main__":
    main()
