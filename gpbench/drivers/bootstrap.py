"""The bootstrap driver: whole ``protassov_lrt`` calls on fitted observed models.

Set-up: the observed null and alternative fits (``derive_posteriors``, the
configuration's ``observed_max_steps`` x ``observed_walkers``, float64),
then one warm-up call of one chunk.  Over a mesh of processes (a cell of
ranks, ``ranks.py``) rank 0 runs the fits and every other rank receives
their posteriors, as ``protassov_lrt`` shares the fits it runs; every rank
then makes the same calls over the mesh (each generates every chunk whole
and refits its own rows; every rank returns the whole result).  A call:
``protassov_lrt(nsims=, chunk=, null_model=, alt_model=)`` with the
configuration's refits, pdf and precisions, keeping its simulations; its
seed comes from the run's seed and the call's index.  The work of a call is its ``nsims``
simulations (the matched observed row is not counted).

``correct``: from each call, one simulated row in each of ``STRATA`` equal
runs of its rows is kept with its two refined log-likelihoods and the
point at which the alternative's refits ended (the refine's input, read
where ``protassov_lrt`` calls ``batched_max_loglike``); after the window,
one call is drawn for each run.  The plain reference (``reference.py``)
maximizes, in float64, the null log-posterior of the observed data and of
each kept row (from the best point of a grid) and the alternative's (from
two starts), and compares:

- ``null_excess``: how far a refined null value lies above the reference's
  maximum (a value above the maximum is a wrong likelihood or refine);
- ``alt_err``: the largest gap between a refined alternative value and the
  reference's log-posterior at the refits' own end point (the refine is
  the float64 log-posterior there: exact to rounding);
- ``null_gap`` / ``alt_gap``: how far the refits' values lie below the
  reference's maxima (refits that do not climb);
- ``gen_dist``: the Mahalanobis distance of each row's null maximum from
  the observed data's, under the sum of the two Laplace covariances (a row
  simulated from the null posterior, with the simulator's own noise, lies
  within a few units);
- ``pdf_skew_gap``, where the configuration states a flux pdf other than
  Gaussian: the gap between the flux skewness of simulated rows, the
  Poisson noise's share taken out, and that of the moment-matched target pdf
  (``reference.flux_skewness``), over ``PDF_ROWS`` rows of each call.

The control, in the program's place: the reference's own null maxima and
the refits' alternative end points evaluated in float32 (one step below
the refine's stated float64).
"""
from __future__ import annotations

import functools
import gc
import sys
from types import SimpleNamespace

import numpy as np
import torch

from gpbench.program import kernel, observed
from gpbench.reference import Evaluator, Model, flux_skewness, grid_points, maximize
from gpbench.scenario import derived_seed

STRATA = 16  # kept rows a call, one in each of 16 equal runs of its rows
PDF_ROWS = 128  # simulated rows a call whose fluxes are kept for pdf_skew_gap (a flux pdf other than Gaussian)
GRID = 16  # points an axis of the null's starting grid
NULL_ITERATIONS, ALT_ITERATIONS = 20, 10  # the reference's Newton iterations at most
LOW_AMPLITUDE = 1.0  # the second alternative start: this far above the extra terms' lowest amplitude


def _strata_rows(n: int, strata: int, rng) -> np.ndarray:
    """One row drawn in each of ``strata`` equal runs of 0 .. n-1."""
    edges = np.linspace(0, n, strata + 1).astype(int)
    return np.array([rng.integers(lo, max(lo + 1, hi)) for lo, hi in zip(edges[:-1], edges[1:])])


def _lrt(ctx, nsims: int, seed: int):
    from mind_the_gaps_tpu_torch.lrt import protassov_lrt

    cfg, s = ctx.config, ctx.state
    return protassov_lrt(
        s.lc, s.null_k, s.alt_k, nsims=nsims, pdf=cfg["pdf"], chunk=cfg["chunk"], seed=seed,
        sim_max_steps=cfg["sim_max_steps"], sim_walkers=cfg["sim_walkers"], sim_dtype=cfg["precision"]["refits"],
        sim_early_stop=tuple(cfg["sim_early_stop"]), extension_factor=cfg["extension_factor"],
        null_model=s.null_m, alt_model=s.alt_m, device=ctx.device, keep_simulations=True, mesh=ctx.mesh)


def _ranks(ctx) -> bool:
    """Whether the run is one of several processes (a rank of a mesh)."""
    return ctx.mesh is not None and ctx.mesh.process_count > 1


def setup(ctx):
    from mind_the_gaps_tpu_torch.gpmodelling import GPModelling
    from mind_the_gaps_tpu_torch.lrt import _broadcast_posteriors

    cfg = ctx.config
    t, y, dy, lc = observed(ctx)
    s = ctx.state = SimpleNamespace(t=t, y=y, dy=dy, lc=lc, null_k=kernel(cfg["null"]), alt_k=kernel(cfg["alt"]))
    fitted = []
    for i, kern in enumerate((s.null_k, s.alt_k)):
        model = None
        if not _ranks(ctx) or ctx.mesh.process_index == 0:
            model = GPModelling(lc, kern, device=ctx.device)
            model.derive_posteriors(fit=True, max_steps=cfg["observed_max_steps"], walkers=cfg["observed_walkers"],
                                    seed=derived_seed(ctx.seed, 1, i))
        if _ranks(ctx):
            model = _broadcast_posteriors(model, lc, kern, ctx.device)
        fitted.append(model)
    s.null_m, s.alt_m = fitted
    _lrt(ctx, cfg["chunk"] - 1, derived_seed(ctx.seed, 2))  # one chunk: every shape of the window


def _refits_end_points(ctx, fn):
    """(fn(), the alternative's refit end points of each chunk): the points
    ``batched_max_loglike`` returns for the alternative's kernel, kept on
    the device as they are (no copy, no synchronisation) while ``fn`` runs."""
    from mind_the_gaps_tpu_torch import lrt

    inner, ends = lrt.batched_max_loglike, []

    @functools.wraps(inner)
    def kept(kern, *args, **kwargs):
        lp, x = inner(kern, *args, **kwargs)
        if kern is ctx.state.alt_k:
            ends.append(x)
        return lp, x

    lrt.batched_max_loglike = kept
    try:
        return fn(), ends
    finally:
        lrt.batched_max_loglike = inner


def call(ctx, index: int) -> dict:
    from mind_the_gaps_tpu_torch.ops import celerite_log_likelihood

    cfg = ctx.config
    nsims = int(cfg["nsims"])
    before = celerite_log_likelihood.launches
    res, ends = _refits_end_points(ctx, lambda: _lrt(ctx, nsims, derived_seed(ctx.seed, 3, index)))
    chunks = -(-(nsims + 1) // cfg["chunk"])
    rng = np.random.default_rng([ctx.seed, 4, index])
    rows = _strata_rows(nsims, STRATA, rng)
    flux = None if cfg["pdf"].lower() == "gaussian" else res.sim_rates[
        rng.choice(nsims, min(PDF_ROWS, nsims), replace=False)]
    return {
        "sims": nsims,
        "timings": dict(res.timings),
        # the refine launches once a model a chunk; the rest are the refits'
        "refit_launches": celerite_log_likelihood.launches - before - 2 * chunks,
        "answers": len(res.t_dist),
        "flux": flux,
        # the chunks' end points in row order (the observed row last), read after the window
        "kept": {"rows": rows, "y": res.sim_rates[rows], "dy": res.sim_dy[rows], "alt_ends": ends,
                 "null": res.null_sim_loglikes[rows], "alt": res.alt_sim_loglikes[rows]},
    }


def libraries(cfg) -> list:
    """The port's kernel libraries (``csrc/<name>.cu``) a run launches: the
    celerite likelihood in float32 (the refits) and float64 (the refine and
    the observed chains), its gradient (the MAP fits), and the sorts for a
    pdf other than Gaussian (E13)."""
    names = ["celerite_loglike_f32", "celerite_loglike_f64", "celerite_grad_f64"]
    return names + ([] if cfg["pdf"].lower() == "gaussian" else ["bitonic_sort"])


def free(ctx):
    """Drop the program's models and simulations (the kept rows stay)."""
    s = ctx.state
    s.null_m = s.alt_m = s.lc = None
    gc.collect()


def launch_shape(ctx, dtype: str, jr: int, jc: int):
    """(B, data columns) of a celerite launch of a call in this process: a
    refit half-step (float32) evaluates its rows' walkers / 2 chains each on
    the row's own data (grouped), over the chunk's rows that this process
    refits (a rank: its block of the mesh, ``torch.tensor_split``'s); the
    refine (float64) evaluates every row of the chunk once, on its own data,
    on every rank."""
    cfg = ctx.config
    if dtype == cfg["precision"]["refits"]:
        rows = cfg["chunk"]
        if ctx.mesh is not None:
            blocks = torch.tensor_split(torch.arange(rows), ctx.mesh.size)
            rows = sum(len(blocks[k]) for k in ctx.mesh.local_positions)
        return rows * (cfg["sim_walkers"] // 2), rows
    return cfg["chunk"], cfg["chunk"]


def _extra_start(cfg, null_dim: int, low: bool) -> np.ndarray:
    """The alternative's parameters beyond the null's, at their stated
    values, or with each extra term's amplitude near its lower bound."""
    extra = []
    for term in cfg["alt"]["terms"]:
        vals = list(term["values"])
        if low:
            vals[0] = term["bounds"][0][0] + LOW_AMPLITUDE
        extra.extend(vals)
    return np.array(extra[null_dim:], dtype=np.float64)


def check(ctx):
    """(the compared numbers with their limits, problems)."""
    cfg, lim, s = ctx.config, ctx.limits, ctx.state
    problems = [f"call {i} returned {r['answers']} answers for {r['sims']} simulations"
                for i, r in enumerate(ctx.records) if r["answers"] != r["sims"]]
    pick = np.random.default_rng([ctx.seed, 5]).integers(0, len(ctx.records), STRATA)
    kept = [ctx.records[c]["kept"] for c in pick]
    ys = np.stack([s.y] + [k["y"][j] for j, k in enumerate(kept)])
    dys = np.stack([s.dy] + [k["dy"][j] for j, k in enumerate(kept)])
    got0 = np.array([k["null"][j] for j, k in enumerate(kept)])
    got1 = np.array([k["alt"][j] for j, k in enumerate(kept)])
    if any(not k["alt_ends"] for k in kept):
        problems.append("no end point of the alternative's refits was seen (protassov_lrt no longer calls "
                        "lrt.batched_max_loglike): alt_err cannot be read")
        return {}, problems
    ends = np.stack([torch.cat(k["alt_ends"])[k["rows"][j]].double().cpu().numpy() for j, k in enumerate(kept)])
    null, alt = Model.from_config(cfg["null"]), Model.from_config(cfg["alt"])
    ev = Evaluator(s.t, ys, dys, [null, alt], device=ctx.device)
    K = ys.shape[0]
    grid = grid_points(null.bounds, GRID)
    vals, at_ends = ev.log_likelihood([(0, np.tile(grid, (K, 1)), np.repeat(np.arange(K), len(grid))),
                                       (1, ends, np.arange(1, K))])
    lo, hi = alt.bounds.T
    at_ends = np.where(np.all((ends >= lo) & (ends <= hi), axis=1), at_ends, -np.inf)
    starts0 = grid[np.argmax(vals.reshape(K, -1), axis=1)]
    starts1 = np.concatenate([np.concatenate([starts0[1:], np.tile(_extra_start(cfg, null.ndim, low), (K - 1, 1))], 1)
                              for low in (False, True)])
    (x0, m0, h0, conv0), (x1, m1, _, _) = maximize(
        ev, [(0, starts0, np.arange(K), NULL_ITERATIONS), (1, starts1, np.tile(np.arange(1, K), 2), ALT_ITERATIONS)])
    best1 = np.argmax(m1.reshape(2, K - 1), axis=0)
    x1 = x1.reshape(2, K - 1, -1)[best1, np.arange(K - 1)]
    m1 = m1.reshape(2, K - 1).max(0)
    if not conv0.all():
        print(f"gpbench: the reference's null maximum did not converge on {int((~conv0).sum())} of {K} rows",
              file=sys.stderr)
    if ctx.control:  # the reference in the program's place, one precision down
        ev32 = Evaluator(s.t, ys, dys, [null, alt], device=ctx.device, dtype=torch.float32)
        got0 = ev32.log_posterior(0, x0[1:], np.arange(1, K))
        got1 = ev32.log_posterior(1, ends, np.arange(1, K))
    # a row's maximum scatters about its draw from the posterior by its own Laplace
    # covariance, the draw about the observed maximum by the observed one
    cov = np.linalg.pinv(-h0)
    d = x0[1:] - x0[0]
    dist = np.sqrt(np.einsum("ki,kij,kj->k", d, np.linalg.pinv(cov[1:] + cov[0]), d))
    with np.errstate(invalid="ignore"):
        alt_err = np.abs(got1 - at_ends)
    numbers = {
        "null_excess": float(max(0.0, np.max(got0 - m0[1:]))),
        "alt_err": float(np.max(np.where(got1 == at_ends, 0.0, alt_err))),
        "null_gap": float(np.max(m0[1:] - got0)),
        "alt_gap": float(np.max(m1 - got1)),
        "gen_dist": float(np.max(dist)),
    }
    if cfg["pdf"].lower() != "gaussian":
        flux = np.concatenate([r["flux"] for r in ctx.records])
        measured, target = flux_skewness(flux, cfg["data"]["exposure"], cfg["pdf"])
        numbers["pdf_skew_gap"] = abs(measured - target)
    return {k: {"value": v, "limit": float(lim[k])} for k, v in numbers.items()}, problems
