"""The observed-fit driver: ``GPModelling.derive_posteriors`` calls on the
run's lightcurve, the null and the alternative in turns.

Set-up: a model of each kind, warmed up by a short fit
(``warmup_steps``).  A call: ``derive_posteriors(fit=True, converge=False,
max_steps=, walkers=)`` (the MAP fit, then the float64 ensemble sampler
for a fixed number of steps), seeded from the run's seed and the call's
index.  The work of a call is its ``max_steps`` sampler steps.  The window
issues whole turns of a null and an alternative call, so it holds as many
of each (an alternative call takes about twice a null one).

``correct``: from each call, ``POINTS`` chain positions (step, walker)
drawn from the seed and the chain's best position are kept with their
log-probabilities, and, for the null, each parameter's spread along the
second half of each walker's chain, pooled over the walkers.  After the window the plain reference
(``reference.py``) computes in float64:

- ``lp_err``: the largest gap between a kept log-probability and the
  reference's log-posterior at that position;
- ``best_gap``: how far each null call's best log-probability lies below
  the reference's maximum (found from a grid and the calls' best
  positions); the alternative's posterior has several modes, and a sound
  2000-step chain's best lies up to ~0.5 below the best mode found, as
  far as a chain that does not move: it is not compared;
- ``width_dev``: the largest |ln(spread / Laplace spread)| of the null's
  parameters, the Laplace spread from the reference's Hessian at its
  maximum (a walker that does not move reads infinity).

The control is the program's own float32 exploration
(``derive_posteriors(fast=True)``): the chain one step below the stated
float64.
"""
from __future__ import annotations

import gc
from types import SimpleNamespace

import numpy as np

from gpbench.program import kernel, observed
from gpbench.reference import Evaluator, Model, grid_points, maximize
from gpbench.scenario import derived_seed

POINTS = 16  # chain positions kept a call
GRID = 16  # points an axis of the null's starting grid
ITERATIONS = 12  # the reference's Newton iterations at most
CALLS_PER_TURN = 2  # a turn is a null and an alternative call: the window ends on whole pairs


def _derive(ctx, model, steps: int, seed: int):
    model.derive_posteriors(fit=True, converge=False, max_steps=steps, walkers=ctx.traffic["walkers"], seed=seed,
                            fast=True if ctx.control else None)


def setup(ctx):
    from mind_the_gaps_tpu_torch.gpmodelling import GPModelling

    cfg = ctx.config
    t, y, dy, lc = observed(ctx)
    kernels = [kernel(cfg["null"]), kernel(cfg["alt"])]
    ctx.state = SimpleNamespace(t=t, y=y, dy=dy, models=[GPModelling(lc, k, device=ctx.device) for k in kernels])
    for i, model in enumerate(ctx.state.models):
        _derive(ctx, model, ctx.traffic["warmup_steps"], derived_seed(ctx.seed, 1, i))


def call(ctx, index: int) -> dict:
    which = index % 2
    model = ctx.state.models[which]
    steps = int(ctx.traffic["max_steps"])
    _derive(ctx, model, steps, derived_seed(ctx.seed, 3, index))
    chain, lp = model.sampler.get_chain(), model.sampler.get_log_prob()
    rng = np.random.default_rng([ctx.seed, 4, index])
    at = [rng.integers(0, chain.shape[0], POINTS), rng.integers(0, chain.shape[1], POINTS)]
    best = np.unravel_index(np.argmax(lp), lp.shape)
    steps_at, walkers_at = np.append(at[0], best[0]), np.append(at[1], best[1])
    return {
        "steps": steps, "model": which,
        "map_fit_s": model.timings["map_fit_s"], "sampling_s": model.timings["sampling_s"],
        "sampling_launches": model.timings["sampling_launches"],
        "points": chain[steps_at, walkers_at], "lp": lp[steps_at, walkers_at],
        # each walker's own spread over the second half, pooled over the walkers
        "spread": np.sqrt(chain[chain.shape[0] // 2 :].var(0).mean(0)),
    }


def free(ctx):
    """Drop the program's models."""
    ctx.state.models = None
    gc.collect()


def launch_shape(ctx, dtype: str, jr: int, jc: int):
    """(B, data columns) of a sampler launch: half the walkers, on the one
    observed lightcurve."""
    return ctx.traffic["walkers"] // 2, 1


def check(ctx):
    """(the compared numbers with their limits, problems)."""
    cfg, lim, s = ctx.config, ctx.limits, ctx.state
    models = [Model.from_config(cfg["null"]), Model.from_config(cfg["alt"])]
    ev = Evaluator(s.t, s.y[None], s.dy[None], models, device=ctx.device)
    grid = grid_points(models[0].bounds, GRID)
    null0 = grid[np.argmax(ev.log_likelihood([(0, grid, np.zeros(len(grid), dtype=int))])[0])]
    starts = np.array([null0] + [r["points"][-1] for r in ctx.records if r["model"] == 0])
    _, best, hessian, _ = maximize(ev, [(0, starts, np.zeros(len(starts), dtype=int), ITERATIONS)])[0]
    top = int(np.argmax(best))
    laplace = np.sqrt(np.diag(np.linalg.inv(-hessian[top])))
    lp_err, best_gap, width_dev = 0.0, -np.inf, 0.0
    refs = ev.log_likelihood([(r["model"], r["points"], np.zeros(len(r["points"]), dtype=int)) for r in ctx.records])
    for r, ref in zip(ctx.records, refs):
        lo, hi = models[r["model"]].bounds.T
        ref = np.where(np.all((r["points"] >= lo) & (r["points"] <= hi), axis=1), ref, -np.inf)
        lp_err = max(lp_err, float(np.max(np.abs(r["lp"] - ref))))
        if r["model"] == 0:
            best_gap = max(best_gap, float(best[top]) - float(np.max(r["lp"])))
            with np.errstate(divide="ignore"):
                width_dev = max(width_dev, float(np.max(np.abs(np.log(r["spread"] / laplace)))))
    numbers = {"lp_err": lp_err, "best_gap": float(best_gap), "width_dev": width_dev}
    return {k: {"value": v, "limit": float(lim[k])} for k, v in numbers.items()}, []
