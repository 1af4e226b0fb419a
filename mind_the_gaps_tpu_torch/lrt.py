"""The Protassov et al. (2002) posterior-predictive likelihood-ratio test.

PyTorch port of ``mind_the_gaps_tpu/lrt.py``:

1. fit the null and alternative GP models to the observed lightcurve
   (MAP fit, then MCMC posteriors);
2. simulate ``nsims`` lightcurves from the null posterior (TK95, the E13
   flux-PDF adjustment for a lognormal or uniform ``pdf``, noise), chunk
   by chunk on the device;
3. refit both models to every simulated lightcurve with short stretch-move
   chains, all (simulation x walker) chains of a chunk in lock-step, each
   half-ensemble update one batched likelihood launch (grouped layout);
   over a mesh (``parallel``) a chunk's rows are cut into blocks, one a
   card, and each card launches its own; a mesh may span processes, one a
   card (``parallel.distributed``);
4. re-evaluate the refit optima in float64 (per-element layout);
5. T = -2 (logL_null - logL_alt); the p-value is the tail fraction of the
   simulated T at the observed T (scipy's percentileofscore, kind='rank').

With the matched estimator (default) the observed lightcurve rides in the
last chunk and is refit by the same short chains as the simulations.
"""
from __future__ import annotations

import io
import math
import os
import time
import warnings
import zipfile
import zlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from mind_the_gaps_tpu_torch import tracing
from mind_the_gaps_tpu_torch.gpmodelling import GPModelling, synchronize
from mind_the_gaps_tpu_torch.lightcurves import GappyLightcurve
from mind_the_gaps_tpu_torch.ops import celerite_log_likelihood
from mind_the_gaps_tpu_torch.ops.celerite import batch_team
from mind_the_gaps_tpu_torch.parallel import (
    Mesh,
    barrier,
    broadcast_bytes,
    default_mesh,
    is_initialized,
    process_allgather,
    process_any,
)
from mind_the_gaps_tpu_torch.sampler.ensemble import (best_walkers, half_log_probs, stretch_draws, stretch_step,
                                                       update_best)
from mind_the_gaps_tpu_torch.sampler.graph import StepGraph
from mind_the_gaps_tpu_torch.simulator.core import e13_adjust_batch
from mind_the_gaps_tpu_torch.solver.batched import batched_log_prob_fn

__all__ = [
    "LRTResult",
    "protassov_lrt",
    "fit_lightcurves_batch",
    "batched_max_loglike",
    "loglikes_f64_at",
    "percentile_of_score",
]


def _derived_generator(device, *words) -> torch.Generator:
    """A generator on ``device`` seeded from integer words, so every chunk
    of a run has its own reproducible stream."""
    seed = int(np.random.SeedSequence([int(w) for w in words]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device).manual_seed(seed)


def _f64_logprob_chunk(kernel, t, ys, diags, thetas):
    """float64 log-posteriors of per-row parameters (B, D) on per-row data
    (B, N): flat prior within bounds plus the likelihood with each row's
    constant mean = the mean of its own data."""
    coeffs = kernel.coefficients(thetas)
    lp = kernel.log_prior(thetas)
    jitter = kernel.jitter(thetas)
    ll = celerite_log_likelihood(coeffs, t, ys, diags, mean=ys.mean(1), repeats=1, extra_diag=jitter)
    return torch.where(torch.isfinite(lp), lp + ll, ll.new_full((), -math.inf))


def loglikes_f64_at(kernel, times, ys, dys, thetas, chunk: int = 4096, device="cuda"):
    """Exact float64 log-posteriors of ``kernel`` at per-lightcurve
    parameters ``thetas`` (B, D) for lightcurves ``ys``/``dys`` (B, N)
    sharing ``times``; numpy (B,)."""
    device = torch.device(device)
    ys = torch.as_tensor(np.asarray(ys, dtype=np.float64), device=device)
    diags = (torch.as_tensor(np.asarray(dys, dtype=np.float64), device=device) + 1e-12) ** 2
    thetas = torch.as_tensor(np.asarray(thetas, dtype=np.float64), device=device)
    t64 = torch.as_tensor(np.asarray(times, dtype=np.float64), device=device)
    out = [
        _f64_logprob_chunk(kernel, t64, ys[s : s + chunk], diags[s : s + chunk], thetas[s : s + chunk])
        for s in range(0, ys.shape[0], chunk)
    ]
    return torch.cat(out).cpu().numpy() if out else np.empty((0,))


def _alt_theta0_rows(null_kernel, alt_kernel, null_rows: np.ndarray) -> np.ndarray:
    """Per-row starting points for the alternative kernel's refits: when
    the alternative nests the null (its leading terms are the null's term
    classes), each row takes its null start in the shared dimensions and
    the alternative's construction-time values in the others; otherwise
    every row starts at the alternative's construction-time vector."""
    alt_init = np.asarray(alt_kernel.get_parameter_vector(), dtype=np.float64)
    B = null_rows.shape[0]
    null_types = [type(t) for t in null_kernel.terms]
    alt_types = [type(t) for t in alt_kernel.terms]
    d_null = null_kernel.ndim
    nests = (
        len(alt_types) >= len(null_types)
        and alt_types[: len(null_types)] == null_types
        and sum(t.ndim for t in alt_kernel.terms[: len(null_types)]) == d_null
    )
    rows = np.broadcast_to(alt_init, (B, alt_init.shape[0])).copy()
    if nests:
        rows[:, :d_null] = null_rows[:, :d_null]
    return rows


def percentile_of_score(dist, score) -> float:
    """scipy.stats.percentileofscore(kind='rank') equivalent."""
    dist = np.asarray(dist)
    n = len(dist)
    left = np.count_nonzero(dist < score)
    right = np.count_nonzero(dist <= score)
    return (left + right + (1 if right > left else 0)) * 50.0 / n


def _checkpoint_crc(lightcurve, dy_obs, *arrays, settings) -> int:
    """CRC-32 of every input that changes the bootstrap's results: the
    observed data (times, y, dy, exposures, background), the posterior
    draws and starting points of the refits, the kernels' bounds and the
    settings tuple."""
    h = 0
    for arr in (lightcurve.times, lightcurve.y, dy_obs, lightcurve.exposures, lightcurve.bkg_rate,
                lightcurve.bkg_rate_err, *arrays):
        h = zlib.crc32(np.ascontiguousarray(arr, dtype=np.float64).tobytes(), h)
    return zlib.crc32(repr(settings).encode(), h)


def _read_checkpoint(path: str, crc: int):
    """(chunks done, [null log-likelihoods], [alt log-likelihoods]) from a
    checkpoint written for ``crc``; (0, [], []) with a warning for a file of
    another configuration or one that cannot be read, and silently when
    there is none."""
    if not os.path.exists(path):
        return 0, [], []
    try:
        with np.load(path) as d:
            if int(d["config_crc"]) != crc:
                warnings.warn(f"checkpoint {path} was written for a different LRT configuration; "
                              "recomputing from scratch")
                return 0, [], []
            return (int(d["chunks_done"]), [np.asarray(d["null_done"], dtype=np.float64)],
                    [np.asarray(d["alt_done"], dtype=np.float64)])
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile) as exc:
        warnings.warn(f"unreadable checkpoint {path} ({exc}); recomputing")
        return 0, [], []


@dataclass
class LRTResult:
    t_obs: float
    t_dist: np.ndarray
    p_value: float
    null_model: GPModelling
    alt_model: GPModelling
    null_sim_loglikes: np.ndarray
    alt_sim_loglikes: np.ndarray
    t_obs_posterior: float = None
    p_value_posterior: float = None
    sim_rates: np.ndarray = field(repr=False, default=None)
    sim_dy: np.ndarray = field(repr=False, default=None)
    timings: dict = field(default_factory=dict)


class _ShardRun:
    """The rows ``span`` of a ``batched_max_loglike`` run on one device: their
    log-probability, the chains' state and the best so far, advanced by the
    sampler's step (``sampler.ensemble.stretch_step``)."""

    def __init__(self, log_prob, state, span):
        self.log_prob, self.state, self.span, self.device = log_prob, state, span, state.device
        self.launches = 0
        self.logp = half_log_probs(self.lp_eval, state)
        self.best_lp, self.best_x = best_walkers(state, self.logp)

    def lp_eval(self, th):  # (B, D) -> (B,), one likelihood launch
        self.launches += 1
        return self.log_prob(th)

    def step(self, draws, a, tol):
        """One step from ``draws`` (``stretch_draws(1, (G, half), ...)``'s, for
        these rows), written into the run's state, log-probabilities and best
        in place; ``update_best``'s improvement flag."""
        u_z, picks, u_acc = draws
        stretch_step(self.state, self.logp, self.lp_eval, u_z[0], picks[0], u_acc[0], a)
        return update_best(self.state, self.logp, self.best_lp, self.best_x, tol)


def _graph_engages(runs, lead) -> bool:
    """Whether a ``batched_max_loglike`` call replays its steps as a CUDA
    graph: when it holds one local run, on the card that holds the data.
    Several runs in one process (a mesh's shards) and the CPU step eagerly."""
    return len(runs) == 1 and lead.type == "cuda" and runs[0][1].device == lead


class _GraphedStep:
    """The steps of ``run`` (alone on its card) after its first, each one
    replay of one captured ``run.step`` with its draws from ``generator``
    (``sampler.graph.StepGraph``).  Each replay moves the launch counters
    as the eager step does."""

    def __init__(self, run, shape, dtype, generator, a, tol):
        op = celerite_log_likelihood
        before = op.launches, dict(op.team_launches), run.launches

        def step():
            draws = stretch_draws(1, shape, dtype, run.device, generator)
            return run.step(tuple(d[:, :, run.span] for d in draws), a, tol)

        self.run, self.graph = run, StepGraph(step, run.device, generator)
        # the capture ran the step's Python, not its work: give its counts back, add them at each replay
        self.launches, self.run_launches = op.launches - before[0], run.launches - before[2]
        self.team_launches = {k: n - before[1][k] for k, n in op.team_launches.items()}
        op.launches, run.launches = before[0], before[2]
        op.team_launches.update(before[1])

    def __call__(self):
        """One step; the improvement flag (None without a ``tol``)."""
        improved = self.graph.replay()
        op = celerite_log_likelihood
        op.launches += self.launches
        for k, n in self.team_launches.items():
            op.team_launches[k] += n
        self.run.launches += self.run_launches
        return improved


def batched_max_loglike(
    kernel, t, ys, diags, theta0, walkers: int = 12, n_steps: int = 500, percent: float = 0.1,
    dtype=None, early_stop=None, generator: Optional[torch.Generator] = None, a: float = 2.0,
    mesh: Optional[Mesh] = None, spmd: str = "gspmd",
):
    """Best log-posterior of ``kernel`` for each of G lightcurves by short
    stretch-move chains, G ensembles of ``walkers`` in lock-step, each step
    the sampler's (``sampler.ensemble.stretch_step``, then ``update_best``).

    ``ys``/``diags``: (G, N) on the device; ``theta0``: (D,) shared or (G,
    D) per-row starts.  Each half-ensemble update is one batched likelihood
    launch of G * walkers/2 elements (the kernel's grouped layout).

    ``early_stop``: optional ``(tol, patience)`` -- stop once no row's best
    log-probability has improved by more than ``tol`` for ``patience``
    consecutive steps (checked on the host, one device sync per
    step); ``patience >= n_steps`` reproduces the fixed budget exactly,
    since each step's draws do not depend on the stopping rule.

    A run that is alone on its card (no mesh, a mesh of one device, this
    process's one position of a process mesh, a "shard_map" shard) takes its
    first step eagerly, captures the next, its draws included, as a CUDA
    graph (``sampler.graph``) and replays it for every step after, the host
    reading the flag as before; the replays give the eager steps' results
    bit for bit.  On the CPU and over several "gspmd" shards in one process
    every step runs eagerly.

    ``mesh`` (``parallel.Mesh``): the G rows are cut into ``mesh.size``
    contiguous blocks (``torch.tensor_split``, so they may be uneven), block
    k on ``mesh.devices[k]``.  ``spmd``:

    - "gspmd" (the default): the result equals the unsharded run's bit for
      bit, whatever the mesh.  Every draw is made on the device of ``ys``
      from ``generator``, with the calls and shapes of the unsharded run,
      and its rows are sliced to the shards; each shard keeps its chains,
      launches its own likelihoods with the layout the whole batch would get
      (``ops.celerite.batch_team``), and the host issues one step of every
      shard before it waits on any of them; the early stop is decided over
      all shards once a step (over every process: ``process_any``), so all
      stop together.
    - "shard_map": shard k is an unsharded run of its rows on its device,
      from ``generator[k]`` (a sequence of one generator a device of this
      process's, on that device) and with its own early stop, the shards run
      one after another; the result depends on the mesh (the JAX package's
      ``fold_in`` of the mesh position), not on how its positions are spread
      over processes.

    Over a mesh of several processes (``parallel.process_mesh``) every
    process passes the same arguments and runs only its own positions'
    rows; the results are gathered (``process_allgather``), so every process
    returns all G rows.  ``batched_max_loglike.shard_launches`` then holds
    the likelihood calls of each of this process's mesh positions (one
    kernel launch each on a card; one entry without a mesh), and
    ``batched_max_loglike.steps`` the stretch-move steps the call took (in
    "shard_map" mode the sum of its shards' runs), ``.graph_steps`` those of
    them that were graph replays.  Returns (best_lp (G,),
    best_x (G, D)) on the device of ``ys``.
    """
    if spmd not in ("gspmd", "shard_map"):
        raise ValueError(f"spmd must be 'gspmd' or 'shard_map', not {spmd!r}")
    if mesh is not None and spmd == "shard_map":
        return _shard_map_max_loglike(kernel, t, ys, diags, theta0, mesh, generator, walkers=walkers,
                                      n_steps=n_steps, percent=percent, dtype=dtype, early_stop=early_stop, a=a)
    dtype = ys.dtype if dtype is None else dtype
    lead = ys.device
    G = ys.shape[0]
    nk = kernel.ndim
    half = walkers // 2
    if 2 * half != walkers:
        raise ValueError("walkers must be even")
    with tracing.span("refits.run", rows=G, params=nk):
        team = None if mesh is None else batch_team(kernel, G * half, lead)
        mesh = Mesh((lead,)) if mesh is None else mesh
        bounds = np.asarray(kernel.get_parameter_bounds(), dtype=np.float64)
        lo = torch.as_tensor(bounds[:, 0], dtype=dtype, device=lead)
        hi = torch.as_tensor(bounds[:, 1], dtype=dtype, device=lead)
        base = torch.as_tensor(theta0, device=lead).to(dtype)
        base = base[:, None, :] if base.dim() == 2 else base
        noise = torch.randn((G, walkers, nk), generator=generator, dtype=dtype, device=lead)
        init = base + base.abs() * percent * noise
        span_lo = torch.where(torch.isfinite(lo), lo + 0.05 * lo.abs(), lo)
        span_hi = torch.where(torch.isfinite(hi), hi - 0.05 * hi.abs(), hi)
        state = torch.minimum(torch.maximum(init, span_lo), span_hi)
        data_means = ys.to(dtype).mean(1)  # over the whole batch, for every shard

        runs, launches = [], [0] * len(mesh.devices)  # an empty block has no run and no launches
        blocks = torch.tensor_split(torch.arange(G), mesh.size)
        for i, (k, dev) in enumerate(zip(mesh.local_positions, mesh.devices)):
            if len(blocks[k]):
                r = slice(int(blocks[k][0]), int(blocks[k][-1]) + 1)
                log_prob = batched_log_prob_fn(kernel, t.to(dev), ys[r].to(dev), diags[r].to(dev), repeats=half,
                                               dtype=dtype, team=team, data_means=data_means[r].to(dev))
                runs.append((i, _ShardRun(log_prob, state[r].to(dev), r)))

        tol = None if early_stop is None else early_stop[0]
        graphed = _graph_engages(runs, lead)
        last_imp, step, replay, replayed = -1, 0, None, 0
        while step < n_steps and (early_stop is None or step - last_imp < early_stop[1]):
            if graphed and step > 0 and replay is None:  # step 0 ran eagerly: the capture's warm-up
                with tracing.span("refits.capture"):
                    replay = _GraphedStep(runs[0][1], (G, half), dtype, generator, a, tol)
            with tracing.span("refits.step"):
                if replay is not None:
                    improved = [replay()]
                    replayed += 1
                else:
                    draws = stretch_draws(1, (G, half), dtype, lead, generator)
                    improved = [run.step(tuple(d[:, :, run.span].to(run.device) for d in draws), a, tol)
                                for _, run in runs]
                if tol is not None:
                    with tracing.span("refits.early_stop"):
                        moved = any(bool(x) for x in improved)  # the host waits here, after every shard's step
                        if mesh.process_count > 1:
                            moved = process_any(moved)
                    if moved:
                        last_imp = step
            step += 1
        for i, run in runs:
            launches[i] = run.launches
        batched_max_loglike.shard_launches = launches
        batched_max_loglike.steps = step
        batched_max_loglike.graph_steps = replayed
        return _gathered([run.best_lp for _, run in runs], [run.best_x for _, run in runs], mesh, state)


batched_max_loglike.shard_launches = []
batched_max_loglike.steps = 0
batched_max_loglike.graph_steps = 0


def _gathered(lps, xs, mesh, like):
    """The best log-probabilities and optima of this process's shards (lists
    in position order) concatenated on ``like``'s device, then gathered over
    the mesh's processes."""
    lp = torch.cat([v.to(like.device) for v in lps]) if lps else like.new_empty((0,))
    x = torch.cat([v.to(like.device) for v in xs]) if xs else like.new_empty((0, like.shape[-1]))
    if mesh.process_count > 1:
        lp, x = process_allgather(lp), process_allgather(x)
    return lp, x


def _shard_map_max_loglike(kernel, t, ys, diags, theta0, mesh, generators, **kw):
    """``batched_max_loglike``'s "shard_map" mode: an unsharded run of each
    of this process's mesh positions' rows on its device from its own
    generator, gathered over the processes."""
    generators = list(generators)
    if len(generators) != len(mesh.devices):
        raise ValueError(f"shard_map takes one generator a device of this process ({len(mesh.devices)}), "
                         f"got {len(generators)}")
    theta0 = torch.as_tensor(theta0)
    blocks = torch.tensor_split(torch.arange(ys.shape[0]), mesh.size)
    lps, xs, launches, steps, graph_steps = [], [], [], 0, 0
    for k, dev, gen in zip(mesh.local_positions, mesh.devices, generators):
        if len(blocks[k]) == 0:
            launches.append(0)
            continue
        r = slice(int(blocks[k][0]), int(blocks[k][-1]) + 1)
        lp, x = batched_max_loglike(kernel, t.to(dev), ys[r].to(dev), diags[r].to(dev),
                                    theta0[r] if theta0.dim() == 2 else theta0, generator=gen, **kw)
        lps.append(lp)
        xs.append(x)
        launches += batched_max_loglike.shard_launches
        steps += batched_max_loglike.steps
        graph_steps += batched_max_loglike.graph_steps
    batched_max_loglike.shard_launches = launches
    batched_max_loglike.steps = steps
    batched_max_loglike.graph_steps = graph_steps
    dtype = ys.dtype if kw.get("dtype") is None else kw["dtype"]
    return _gathered(lps, xs, mesh, ys.new_empty((0, kernel.ndim), dtype=dtype))


def _node_mesh(device) -> Optional[Mesh]:
    """Under an initialized process group, the mesh of the processes
    (``default_mesh()``, each rank's own device); else the mesh of every
    visible card when ``device`` is CUDA without a card index and more than
    one card is visible, else None: a device that names its card keeps the
    work on that card."""
    if is_initialized():
        return default_mesh()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.device_count() > 1:
        return default_mesh()
    return None


def fit_lightcurves_batch(
    kernel, times, ys, dys, theta0, walkers: int = 12, n_steps: int = 500, percent: float = 0.1,
    chunk: int = 512, dtype=None, early_stop=None, seed: int = 0, device="cuda", use_mesh: bool = False,
    spmd: str = "gspmd",
):
    """Max log-likelihood of ``kernel`` fit to each of B lightcurves
    (B, N) sharing ``times``, by ``batched_max_loglike`` over chunks of
    ``chunk`` lightcurves; ``theta0`` (D,) or per-row (B, D).  Chunk ``i``
    draws from a generator seeded from ``(seed, i)``.

    ``use_mesh``: when ``device`` is "cuda" (no card index) and more than
    one card is visible, shard each chunk's rows over them all
    (``parallel.default_mesh``) as ``spmd`` says (``batched_max_loglike``):
    with "gspmd" the result is the one-card result bit for bit; with
    "shard_map" shard k of chunk i draws from a generator seeded from
    ``(seed, i, k)`` on its card.  A device that names its card never
    shards.  Under an initialized process group the chunks shard over the
    processes' mesh (``parallel.process_mesh``) whatever the device: each
    rank holds every row's data and runs the refits of its own rows, and
    every rank returns the whole result.  Off by default (the JAX package's
    default is on): over four cards the sharded refits took longer than one
    card's (PERF.md).

    Returns numpy (best_loglikes (B,), best_params (B, D))."""
    device = torch.device(device)
    mesh = _node_mesh(device) if use_mesh else None
    ys = torch.as_tensor(np.asarray(ys, dtype=np.float64), device=device)
    diags = (torch.as_tensor(np.asarray(dys, dtype=np.float64), device=device) + 1e-12) ** 2
    theta0 = np.asarray(theta0, dtype=np.float64)
    if theta0.ndim == 2 and theta0.shape[0] != ys.shape[0]:
        raise ValueError("per-row theta0 must have one row per lightcurve")
    t = torch.as_tensor(np.asarray(times, dtype=np.float64), device=device)
    lls, xs = [], []
    for ci, s in enumerate(range(0, ys.shape[0], chunk)):
        th0 = theta0[s : s + chunk] if theta0.ndim == 2 else theta0
        if mesh is not None and spmd == "shard_map":
            gen = [_derived_generator(dev, seed, ci, k) for k, dev in zip(mesh.local_positions, mesh.devices)]
        else:
            gen = _derived_generator(device, seed, ci)
        best_lp, best_x = batched_max_loglike(
            kernel, t, ys[s : s + chunk], diags[s : s + chunk], th0, walkers=walkers,
            n_steps=n_steps, percent=percent, dtype=dtype, early_stop=early_stop,
            generator=gen, mesh=mesh, spmd=spmd,
        )
        lls.append(best_lp.cpu().numpy())
        xs.append(best_x.cpu().numpy())
    return np.concatenate(lls), np.concatenate(xs)


def _broadcast_posteriors(model, lightcurve, kernel, device) -> GPModelling:
    """Rank 0's fitted ``model`` on every rank: its posterior state
    (``save_posteriors``) broadcast, loaded into a model of ``kernel`` on the
    other ranks (``model`` None there)."""
    data = None
    if model is not None:
        buf = io.BytesIO()
        model.save_posteriors(buf)
        data = buf.getvalue()
    data = broadcast_bytes(data)
    if model is None:
        model = GPModelling(lightcurve, kernel, device=device)
        model.load_posteriors(io.BytesIO(data))
    return model


@tracing.traced("lrt.protassov_lrt")
def protassov_lrt(
    lightcurve: GappyLightcurve,
    null_kernel,
    alt_kernel,
    nsims: int = 1000,
    pdf: str = "Gaussian",
    sigma_noise=None,
    extension_factor: int = 2,
    observed_max_steps: int = 10000,
    observed_walkers: int = 32,
    sim_max_steps: int = 500,
    sim_walkers: int = 12,
    sim_dtype="float32",
    chunk: int = 512,
    seed: int = 0,
    fit_observed: bool = True,
    null_model: Optional[GPModelling] = None,
    alt_model: Optional[GPModelling] = None,
    progress: bool = False,
    matched_estimator: bool = True,
    observed_fast: Optional[bool] = None,
    keep_simulations: bool = False,
    checkpoint: Optional[str] = None,
    sim_early_stop=(0.01, 50),
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> LRTResult:
    """Run the Protassov LRT end to end on ``device``.

    Pass ``null_model``/``alt_model`` with posteriors derived to skip the
    observed fits.  Seeds: the observed fits use ``seed + 101`` and
    ``seed + 102``, the generation ``seed + 1`` (as the JAX package);
    chunk ``i``'s refits draw from generators seeded from ``(seed, i)``.
    The refits run in ``sim_dtype`` (float32 by default) and their optima
    are re-evaluated in float64.  ``LRTResult.timings`` holds the seconds
    of each phase (``map_fit_s`` and ``observed_sampling_s`` of the observed
    fits run here, ``simulator_s``, the making of the simulator and its noise
    model (with Kraft noise, its tables), ``generation_s``, ``refits_s``,
    ``refine_s``, and ``checkpoint_s``: the checkpoint writes, 0 without one)
    and five counts: ``refit_steps``, the stretch-move steps of every
    ``batched_max_loglike`` run of the call (two a chunk),
    ``refit_graph_steps``, those of them replayed as a CUDA graph,
    ``e13_passes``, the passes of ``e13_adjust_batch``'s loop over the call
    (each ends in a host sync; 0 for Gaussian simulations), and
    ``kraft_bins`` / ``kraft_bins_replaced``, the simulated bins that went
    through the Kraft step and those it replaced (0 without Kraft noise; the
    second read from the card once, after the last chunk's results reached
    the host).  Each phase is a ``tracing`` span (under
    ``lrt.protassov_lrt`` and ``lrt.chunk``), recorded while a
    ``torch.profiler`` session runs.  ``pdf``: the flux PDF of the simulations ("Gaussian",
    "Lognormal" or "Uniform"); a count of E13 adjustments that hit their
    iteration limit is reported (warned) once, at the end.
    ``keep_simulations``: return every simulated lightcurve in
    ``LRTResult.sim_rates`` / ``sim_dy`` (numpy, (nsims, n)).

    ``checkpoint``: an .npz path for the bootstrap.  After each chunk the
    results so far are written to it atomically (a temporary file and
    ``os.replace``); a run that finds a file written for the same inputs
    resumes after its last completed chunk, and since every chunk draws
    from generators of its own, the resumed run equals the uninterrupted
    one bit for bit.  A file written for other inputs (a CRC over the data,
    the posterior draws, the refits' starts and bounds and the settings) or
    one that cannot be read is recomputed with a warning.  Ignored, with a
    warning, under ``keep_simulations``.

    The run stays on ``device`` unless given a ``mesh`` (``parallel.Mesh``,
    e.g. ``parallel.default_mesh()``): then each chunk is generated on
    ``device`` and its rows are sliced to the mesh for the refits
    (``batched_max_loglike``'s "gspmd" mode), so the results equal the
    unsharded run's bit for bit, and a checkpoint written on one card
    resumes bit-identically over a mesh.  The observed fits stay on
    ``device``: each is one dependent chain, no faster over more cards
    (pass models fit with ``derive_posteriors(mesh=)`` to shard them).  Over
    a mesh of one process, its host thread issues every shard's work, and
    over four cards that run took longer than one card's (PERF.md).

    Over a mesh of several processes (``parallel.process_mesh()``, one
    process a card under ``torch.distributed``, each with its own host
    thread) every rank runs this call with the same arguments.  Rank 0 runs
    the observed fits that are not given and broadcasts their posterior
    state (samples, log-probabilities, chain), so every rank holds the same
    models and t_obs; each chunk is generated in full on every rank's
    ``device`` from the chunk's generator, and each rank refits only its
    own rows (the results are gathered); only rank 0 writes the checkpoint,
    and every rank reads it on resume.  Every rank returns the whole result,
    equal to the one-device run's bit for bit.
    """
    if nsims < 1:
        raise ValueError("nsims must be >= 1 (the p-value is the tail fraction of the simulated T distribution)")
    if keep_simulations and checkpoint is not None:
        warnings.warn("checkpoint is only supported without keep_simulations; ignored with keep_simulations=True")
        checkpoint = None
    device = torch.device(device)
    t_start = time.monotonic()

    def _mark(msg):
        if progress:
            print(f"[lrt +{time.monotonic() - t_start:7.1f}s] {msg}", flush=True)

    rank = 0 if mesh is None else mesh.process_index
    spans = mesh is not None and mesh.process_count > 1
    sim_dtype = None if sim_dtype is None else getattr(torch, str(sim_dtype).replace("torch.", ""))
    refine_f64 = sim_dtype is not None and sim_dtype != torch.float64
    timings = {"map_fit_s": 0.0, "observed_sampling_s": 0.0, "generation_s": 0.0,
               "refits_s": 0.0, "refine_s": 0.0, "checkpoint_s": 0.0, "refit_steps": 0, "refit_graph_steps": 0,
               "e13_passes": 0, "simulator_s": 0.0, "kraft_bins": 0, "kraft_bins_replaced": 0}

    # 1. observed fits
    def observed(model, kernel, model_seed, name):
        if model is not None:
            return model
        if rank == 0:
            model = GPModelling(lightcurve, kernel, device=device)
            model.derive_posteriors(
                seed=model_seed, fit=fit_observed, max_steps=observed_max_steps,
                walkers=observed_walkers, progress=progress, fast=observed_fast,
            )
            timings["map_fit_s"] += model.timings["map_fit_s"]
            timings["observed_sampling_s"] += model.timings["sampling_s"]
            _mark(f"observed {name} fit done")
        if spans:
            model = _broadcast_posteriors(model, lightcurve, kernel, device)
        return model

    null_model = observed(null_model, null_kernel, seed + 101, "null")
    alt_model = observed(alt_model, alt_kernel, seed + 102, "alt")
    t_obs = -2.0 * (null_model.max_loglikelihood - alt_model.max_loglikelihood)

    # 2-4. simulations, refits, float64 refinement, chunk by chunk
    gen_rng = torch.Generator(device).manual_seed(seed + 1)
    samples = torch.as_tensor(np.asarray(null_model.mcmc_samples, dtype=np.float64), device=device)
    n_samples = samples.shape[0]
    idx = torch.randint(0, n_samples, (nsims,), generator=gen_rng, device=device)
    idx_obs = torch.randint(0, n_samples, (1,), generator=gen_rng, device=device)
    param_samples = samples[idx]
    nk_null = null_kernel.ndim
    null_starts = param_samples[:, :nk_null].cpu().numpy()
    obs_start = samples[idx_obs][:, :nk_null].cpu().numpy()
    with tracing.phase("lrt.simulator", timings, "simulator_s"):
        gen = null_model.make_device_generator(pdf, extension_factor=extension_factor, sigma_noise=sigma_noise)
    noise = gen.simulator.noise
    kraft_before = (noise.bins_drawn, noise.bins_replaced)
    obs_y = torch.as_tensor(np.asarray(lightcurve.y, dtype=np.float64), device=device)[None, :]
    dy_obs = lightcurve.dy if lightcurve.dy is not None else np.zeros(lightcurve.n)
    obs_dy = torch.as_tensor(np.asarray(dy_obs, dtype=np.float64), device=device)[None, :]
    t64 = torch.as_tensor(np.asarray(lightcurve.times, dtype=np.float64), device=device)

    n_rows = nsims + (1 if matched_estimator else 0)
    n_chunks = -(-n_rows // chunk)
    null_parts, alt_parts, kept_rates, kept_dy = [], [], [], []
    chunks_done, ckpt_crc = 0, None
    if checkpoint is not None:
        bounds = [np.asarray(k.get_parameter_bounds(), dtype=np.float64) for k in (null_kernel, alt_kernel)]
        ckpt_crc = _checkpoint_crc(
            lightcurve, dy_obs, param_samples.cpu().numpy(), obs_start, alt_kernel.get_parameter_vector(), *bounds,
            settings=(nsims, chunk, seed, sim_walkers, sim_max_steps, str(sim_dtype), pdf.lower(), matched_estimator,
                      extension_factor, None if sigma_noise is None else float(np.mean(sigma_noise)),
                      None if sim_early_stop is None else (float(sim_early_stop[0]), int(sim_early_stop[1])),
                      device.type, "per-row-starts-v2"),
        )
        chunks_done, null_parts, alt_parts = _read_checkpoint(checkpoint, ckpt_crc)
        if spans:
            seen = process_allgather(torch.tensor([chunks_done])).tolist()
            if len(set(seen)) > 1:
                raise RuntimeError(f"the ranks read {seen} chunks done from {checkpoint}: every rank must see "
                                   "the same checkpoint file")
        if chunks_done:
            _mark(f"resuming the bootstrap after chunk {chunks_done}/{n_chunks}")
    passes = e13_adjust_batch.passes
    for ci in range(chunks_done, n_chunks):
        s0 = ci * chunk
        count = max(0, min((ci + 1) * chunk, nsims) - s0)
        last = matched_estimator and ci == n_chunks - 1
        with tracing.span("lrt.chunk", rows=count + last):
            with tracing.phase("lrt.generation", timings, "generation_s"):
                if count:
                    rates, dys = gen(param_samples[s0 : s0 + count], _derived_generator(device, seed + 1, ci))
                    if keep_simulations:
                        kept_rates.append(rates.cpu().numpy())
                        kept_dy.append(dys.cpu().numpy())
                    if last:
                        rates, dys = torch.cat([rates, obs_y]), torch.cat([dys, obs_dy])
                else:  # an observed-only final chunk (nsims a multiple of chunk)
                    rates, dys = obs_y, obs_dy
                starts = null_starts[s0 : s0 + count]
                if last:
                    starts = np.concatenate([starts, obs_start])
                diags = (dys + 1e-12) ** 2
                synchronize(device)

            with tracing.phase("lrt.refits", timings, "refits_s"):
                nl, nx = batched_max_loglike(
                    null_kernel, t64, rates, diags, starts, walkers=sim_walkers, n_steps=sim_max_steps,
                    dtype=sim_dtype, early_stop=sim_early_stop, generator=_derived_generator(device, seed, ci, 0),
                    mesh=mesh,
                )
                timings["refit_steps"] += batched_max_loglike.steps
                timings["refit_graph_steps"] += batched_max_loglike.graph_steps
                al, ax = batched_max_loglike(
                    alt_kernel, t64, rates, diags, _alt_theta0_rows(null_kernel, alt_kernel, starts),
                    walkers=sim_walkers, n_steps=sim_max_steps, dtype=sim_dtype, early_stop=sim_early_stop,
                    generator=_derived_generator(device, seed, ci, 1), mesh=mesh,
                )
                timings["refit_steps"] += batched_max_loglike.steps
                timings["refit_graph_steps"] += batched_max_loglike.graph_steps
                synchronize(device)

            with tracing.phase("lrt.refine", timings, "refine_s"):
                if refine_f64:
                    nl = _f64_logprob_chunk(null_kernel, t64, rates, diags, nx.double())
                    al = _f64_logprob_chunk(alt_kernel, t64, rates, diags, ax.double())
                null_parts.append(nl.double().cpu().numpy())
                alt_parts.append(al.double().cpu().numpy())

            if checkpoint is not None:
                with tracing.phase("lrt.checkpoint", timings, "checkpoint_s"):
                    if rank == 0:
                        tmp = checkpoint + ".tmp.npz"
                        np.savez(tmp, config_crc=np.int64(ckpt_crc), chunks_done=np.int64(ci + 1),
                                 null_done=np.concatenate(null_parts), alt_done=np.concatenate(alt_parts))
                        os.replace(tmp, checkpoint)
                    if spans:
                        barrier()
        _mark(f"bootstrap chunk {ci + 1}/{n_chunks} done")
    timings["e13_passes"] = e13_adjust_batch.passes - passes
    # the chunks' results are on the host already: this read adds no sync to the loop
    timings["kraft_bins"] = noise.bins_drawn - kraft_before[0]
    timings["kraft_bins_replaced"] = int(noise.bins_replaced - kraft_before[1])

    null_lls = np.concatenate(null_parts)
    alt_lls = np.concatenate(alt_parts)
    if matched_estimator:
        ll0_obs, ll1_obs = null_lls[-1], alt_lls[-1]
        null_lls, alt_lls = null_lls[:-1], alt_lls[:-1]
    gen.report_nonconverged()

    # 5. T distribution and p-values
    t_dist = -2.0 * (null_lls - alt_lls)
    p_posterior = 1.0 - percentile_of_score(t_dist, t_obs) / 100.0
    if matched_estimator:
        t_main = -2.0 * (float(ll0_obs) - float(ll1_obs))
        p_value = 1.0 - percentile_of_score(t_dist, t_main) / 100.0
    else:
        t_main, p_value = float(t_obs), p_posterior
    return LRTResult(
        t_obs=float(t_main),
        t_dist=t_dist,
        p_value=float(p_value),
        null_model=null_model,
        alt_model=alt_model,
        null_sim_loglikes=null_lls,
        alt_sim_loglikes=alt_lls,
        t_obs_posterior=float(t_obs),
        p_value_posterior=float(p_posterior),
        sim_rates=np.concatenate(kept_rates) if keep_simulations else None,
        sim_dy=np.concatenate(kept_dy) if keep_simulations else None,
        timings=timings,
    )
