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
4. re-evaluate the refit optima in float64 (per-element layout);
5. T = -2 (logL_null - logL_alt); the p-value is the tail fraction of the
   simulated T at the observed T (scipy's percentileofscore, kind='rank').

With the matched estimator (default) the observed lightcurve rides in the
last chunk and is refit by the same short chains as the simulations.
"""
from __future__ import annotations

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

from mind_the_gaps_tpu_torch.gpmodelling import GPModelling, synchronize
from mind_the_gaps_tpu_torch.lightcurves import GappyLightcurve
from mind_the_gaps_tpu_torch.ops import celerite_log_likelihood
from mind_the_gaps_tpu_torch.sampler.ensemble import stretch_draws, stretch_half

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


def batched_max_loglike(
    kernel, t, ys, diags, theta0, walkers: int = 12, n_steps: int = 500, percent: float = 0.1,
    dtype=None, early_stop=None, generator: Optional[torch.Generator] = None, a: float = 2.0,
):
    """Best log-posterior of ``kernel`` for each of G lightcurves by short
    stretch-move chains, all G x ``walkers`` chains in lock-step.

    ``ys``/``diags``: (G, N) data and variance diagonal on the device;
    ``t`` (N,); ``theta0``: (D,) shared or (G, D) per-row starting points.
    Each lightcurve's model is the kernel with the unfitted constant mean
    = the mean of its data.  ``dtype`` (default: that of ``ys``) is the
    chains' and the likelihood's.  ``early_stop``: optional
    ``(tol, patience)``: stop once no lightcurve has improved its best by
    more than ``tol`` for ``patience`` consecutive steps (one host sync a
    step); ``patience >= n_steps`` reproduces the fixed budget exactly,
    since each step's draws do not depend on the stopping rule.

    Returns (best_lp (G,), best_x (G, D)) on the device.
    """
    dtype = ys.dtype if dtype is None else dtype
    device = ys.device
    G = ys.shape[0]
    nk = kernel.ndim
    half = walkers // 2
    if 2 * half != walkers:
        raise ValueError("walkers must be even")
    bounds = np.asarray(kernel.get_parameter_bounds(), dtype=np.float64)
    lo = torch.as_tensor(bounds[:, 0], dtype=dtype, device=device)
    hi = torch.as_tensor(bounds[:, 1], dtype=dtype, device=device)
    ys_c, diags_c = ys.to(dtype), diags.to(dtype)
    mean_b = ys_c.mean(1).repeat_interleave(half)

    def lp_eval(th):  # (G, half, D) -> (G, half)
        th = th.reshape(G * half, nk)
        coeffs = kernel.coefficients(th)
        lp = kernel.log_prior(th)
        jitter = kernel.jitter(th)
        ll = celerite_log_likelihood(coeffs, t, ys_c, diags_c, mean=mean_b, repeats=half, extra_diag=jitter)
        return torch.where(torch.isfinite(lp), lp + ll, ll.new_full((), -math.inf)).reshape(G, half)

    base = torch.as_tensor(theta0, device=device).to(dtype)
    base = base[:, None, :] if base.dim() == 2 else base
    noise = torch.randn((G, walkers, nk), generator=generator, dtype=dtype, device=device)
    init = base + base.abs() * percent * noise
    span_lo = torch.where(torch.isfinite(lo), lo + 0.05 * lo.abs(), lo)
    span_hi = torch.where(torch.isfinite(hi), hi - 0.05 * hi.abs(), hi)
    state = torch.minimum(torch.maximum(init, span_lo), span_hi)

    logp = torch.cat([lp_eval(state[:, :half]), lp_eval(state[:, half:])], dim=1)
    rows = torch.arange(G, device=device)
    i0 = torch.argmax(logp, dim=1)
    best_lp, best_x = logp[rows, i0], state[rows, i0]

    last_imp, step = -1, 0
    while step < n_steps and (early_stop is None or step - last_imp < early_stop[1]):
        u_z, picks, u_acc = stretch_draws(1, (G, half), dtype, device, generator)
        first, second = state[:, :half], state[:, half:]
        first, lp1, _ = stretch_half(first, second, logp[:, :half], lp_eval, u_z[0, 0], picks[0, 0], u_acc[0, 0], a)
        second, lp2, _ = stretch_half(second, first, logp[:, half:], lp_eval, u_z[0, 1], picks[0, 1], u_acc[0, 1], a)
        state = torch.cat([first, second], dim=1)
        logp = torch.cat([lp1, lp2], dim=1)
        i = torch.argmax(logp, dim=1)
        cand_lp, cand_x = logp[rows, i], state[rows, i]
        if early_stop is not None and bool(torch.any(cand_lp > best_lp + early_stop[0])):
            last_imp = step
        better = cand_lp > best_lp
        best_lp = torch.where(better, cand_lp, best_lp)
        best_x = torch.where(better[:, None], cand_x, best_x)
        step += 1
    return best_lp, best_x


def fit_lightcurves_batch(
    kernel, times, ys, dys, theta0, walkers: int = 12, n_steps: int = 500, percent: float = 0.1,
    chunk: int = 512, dtype=None, early_stop=None, seed: int = 0, device="cuda",
):
    """Max log-likelihood of ``kernel`` fit to each of B lightcurves
    (B, N) sharing ``times``, by ``batched_max_loglike`` over chunks of
    ``chunk`` lightcurves; ``theta0`` (D,) or per-row (B, D).  Chunk ``i``
    draws from a generator seeded from ``(seed, i)``.

    Returns numpy (best_loglikes (B,), best_params (B, D))."""
    device = torch.device(device)
    ys = torch.as_tensor(np.asarray(ys, dtype=np.float64), device=device)
    diags = (torch.as_tensor(np.asarray(dys, dtype=np.float64), device=device) + 1e-12) ** 2
    theta0 = np.asarray(theta0, dtype=np.float64)
    if theta0.ndim == 2 and theta0.shape[0] != ys.shape[0]:
        raise ValueError("per-row theta0 must have one row per lightcurve")
    t = torch.as_tensor(np.asarray(times, dtype=np.float64), device=device)
    lls, xs = [], []
    for ci, s in enumerate(range(0, ys.shape[0], chunk)):
        th0 = theta0[s : s + chunk] if theta0.ndim == 2 else theta0
        best_lp, best_x = batched_max_loglike(
            kernel, t, ys[s : s + chunk], diags[s : s + chunk], th0, walkers=walkers,
            n_steps=n_steps, percent=percent, dtype=dtype, early_stop=early_stop,
            generator=_derived_generator(device, seed, ci),
        )
        lls.append(best_lp.cpu().numpy())
        xs.append(best_x.cpu().numpy())
    return np.concatenate(lls), np.concatenate(xs)


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
) -> LRTResult:
    """Run the Protassov LRT end to end on ``device``.

    Pass ``null_model``/``alt_model`` with posteriors derived to skip the
    observed fits.  Seeds: the observed fits use ``seed + 101`` and
    ``seed + 102``, the generation ``seed + 1`` (as the JAX package);
    chunk ``i``'s refits draw from generators seeded from ``(seed, i)``.
    The refits run in ``sim_dtype`` (float32 by default) and their optima
    are re-evaluated in float64.  ``LRTResult.timings`` holds the seconds
    of each phase (``checkpoint_s``: the checkpoint writes, 0 without one).  ``pdf``: the flux PDF of the simulations ("Gaussian",
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

    sim_dtype = None if sim_dtype is None else getattr(torch, str(sim_dtype).replace("torch.", ""))
    refine_f64 = sim_dtype is not None and sim_dtype != torch.float64
    timings = {"map_fit_s": 0.0, "observed_sampling_s": 0.0, "generation_s": 0.0,
               "refits_s": 0.0, "refine_s": 0.0, "checkpoint_s": 0.0}

    # 1. observed fits
    def observed(model, kernel, model_seed, name):
        if model is None:
            model = GPModelling(lightcurve, kernel, device=device)
            model.derive_posteriors(
                seed=model_seed, fit=fit_observed, max_steps=observed_max_steps,
                walkers=observed_walkers, progress=progress, fast=observed_fast,
            )
            timings["map_fit_s"] += model.timings["map_fit_s"]
            timings["observed_sampling_s"] += model.timings["sampling_s"]
            _mark(f"observed {name} fit done")
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
    gen = null_model.make_device_generator(pdf, extension_factor=extension_factor, sigma_noise=sigma_noise)
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
        if chunks_done:
            _mark(f"resuming the bootstrap after chunk {chunks_done}/{n_chunks}")
    for ci in range(chunks_done, n_chunks):
        s0 = ci * chunk
        count = max(0, min((ci + 1) * chunk, nsims) - s0)
        last = matched_estimator and ci == n_chunks - 1
        clock = time.perf_counter()
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
        timings["generation_s"] += time.perf_counter() - clock

        clock = time.perf_counter()
        nl, nx = batched_max_loglike(
            null_kernel, t64, rates, diags, starts, walkers=sim_walkers, n_steps=sim_max_steps,
            dtype=sim_dtype, early_stop=sim_early_stop, generator=_derived_generator(device, seed, ci, 0),
        )
        al, ax = batched_max_loglike(
            alt_kernel, t64, rates, diags, _alt_theta0_rows(null_kernel, alt_kernel, starts),
            walkers=sim_walkers, n_steps=sim_max_steps, dtype=sim_dtype, early_stop=sim_early_stop,
            generator=_derived_generator(device, seed, ci, 1),
        )
        synchronize(device)
        timings["refits_s"] += time.perf_counter() - clock

        clock = time.perf_counter()
        if refine_f64:
            nl = _f64_logprob_chunk(null_kernel, t64, rates, diags, nx.double())
            al = _f64_logprob_chunk(alt_kernel, t64, rates, diags, ax.double())
        null_parts.append(nl.double().cpu().numpy())
        alt_parts.append(al.double().cpu().numpy())
        timings["refine_s"] += time.perf_counter() - clock

        if checkpoint is not None:
            clock = time.perf_counter()
            tmp = checkpoint + ".tmp.npz"
            np.savez(tmp, config_crc=np.int64(ckpt_crc), chunks_done=np.int64(ci + 1),
                     null_done=np.concatenate(null_parts), alt_done=np.concatenate(alt_parts))
            os.replace(tmp, checkpoint)
            timings["checkpoint_s"] += time.perf_counter() - clock
        _mark(f"bootstrap chunk {ci + 1}/{n_chunks} done")

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
