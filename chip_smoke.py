#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --processes-only   # phases 1, 2, 4, 6, 12 and 13, e.g. on four cards
    python3 chip_smoke.py --tobs-spread      # phases 1, 2, then phase 4's LRT at seeds 0-7

Phases, each printed with its seconds:

1. device: the card's name and power limit (nvidia-smi); TF32 is turned
   off for matmuls and cuDNN;
2. build: the CUDA kernels of ``mind_the_gaps_tpu_torch/csrc`` with nvcc,
   one process per source, all started together, into
   ``mind_the_gaps_tpu_torch/_build`` (keyed by a hash of the source);
3. kernels against plain: ``celerite_log_likelihood_and_grad`` (the MAP
   fit's forward + adjoint kernel, a chain lane and two helper warps a
   likelihood: value and every gradient) at N=5000 for R = 1 and 3 (the
   main path's fits), R = 7, a runtime R = 10, a per-element residual with
   a linear mean and a non-positive-definite theta, each launched twice
   (the same bits) and its value held against the forward kernel's, its
   time beside its latency floor; ``celerite_log_likelihood`` (packed and dense-S
   bodies, every layout, the compile-time widths up to R = 8 and the
   runtime-R body), ``rank_remap`` and ``sort_kv`` (the CUDA kernels, every
   tier and its edges) against their plain PyTorch versions on the same
   tensors on the card, at the shapes of the main paths and the bench's
   primary (65,536 rows, where the one-thread layout runs; the rows whose
   bits differ from the 8-lane layout's printed), each with both
   times from CUDA events and, where PERF.md has one, the time before the
   redesign of the hand-written kernels (PERF.md section 6); the sorts
   must be equal to their plain versions (``torch.equal``); then the three
   celerite layouts (32, 8 and 1 lanes per likelihood) timed in turns at
   the batches on either side of each crossover of
   ``ops.celerite.team_size``, each against the plain version and the
   8-lane layout (``ops.layout_sweep``); then the
   MAP fit on the card against the plain version's fit on the CPU at
   N=1000 (the same optimum);
4. Gaussian main path: ``protassov_lrt(..., device="cuda")`` on the lrt_512
   scenario (N=5000 DRW-true data, DRW null, DRW+Lorentzian alternative,
   512 simulations), with the kernels' launch counts over that run and the
   MAP fits' seconds, objective evaluations and milliseconds an evaluation;
   then its bootstrap again with the JAX package's cumulative-sum
   downsampling, the T values, t_obs and p that this moves printed;
5. lognormal main path: the same LRT with ``pdf="Lognormal"`` (E13 cut
   m=65536, lock-step chunks of 128), reusing phase 4's fitted observed
   models, with the E13 iteration counts and the launch counts;
6. tutorial-scale E13 generation: lognormal lightcurves per second at
   n=500, B=256, cut 8192 (``bench.e13_generation_rate``, the JAX repo's
   bench.py scenario);
7. a fitted mean: ``derive_posteriors`` of the DRW with a linear mean model
   on the N=5000 data (its MAP fit through the gradient kernel, then the
   sampler's per-walker residuals through the celerite kernel's
   per-element layout), a short chain;
8. multi-chain: ``derive_posteriors(chains=4)`` of the DRW, a short chain;
9. t_obs provenance: phase 4's LRT again with the observed null chain
   started from the plain version's CPU fit (the fit the port ran on the
   host before its MAP fit moved to the card); at the default sizes its
   t_obs must be the one those runs gave;
10. the CLI on a lightcurve file at full width: phase 4's N=5000 data
   written as a six-column SimpleLightcurve CSV, its rates and errors
   (dy = 0.3) as they are, with exposures of 1.5 s and a background of 0.2
   counts/s added (so about half the simulated bins fall under the Kraft
   threshold of 15 counts; the observed errors stay phase 4's, about 9x
   below the Poisson error of ~15 counts a bin), then
   ``cli.main(["fit" ...])``, ``["simulate" ...]`` (512 simulations) and
   ``["lrt" ...]`` (512, with a checkpoint) in this process at the default
   depths but the observed chains of fit and lrt (2000 steps), with Kraft
   low-count noise on the path; the Kraft tables built
   on the card against the plain version on the CPU (1e-9); then the
   resume check on the lrt's fitted models at chunk=128: the t_dist of a
   run resumed from a checkpoint rewound to 2 chunks must equal the
   uninterrupted run's (``np.array_equal``);
11. model selection and the periodogram at full width, on phase 4's N=5000
   data: ``selection.compare_models`` with the model-selection tutorial's
   four candidates (DRW, SHO, Matern32, DRW+QPO: R = 1, 4, 2, 3), 24
   walkers, max_steps 1000, seed 0, each candidate's max log-likelihood
   against the plain float64 likelihood on the CPU (rtol 1e-10), then the
   gradient kernel against its plain version at the R = 2 and R = 4
   MAP-fit shapes beside its latency floor; ``GPModelling.fit_device``
   against ``fit()`` for phase 4's null and alternative (nll within 1e-3);
   ``periodogram.lomb_scargle`` over ``autofrequency``'s 62,500 frequencies
   with dy, each normalization within 1e-9 x max(power) of the CPU's, with
   its time and peak memory, and the 1% false-alarm level;
12. the mesh: over every visible card when there are two or more, else two
   shards on this card, the refits of a 513-row chunk of phase 4 (512
   simulations from its null posterior + the observed row, 12 walkers, 500
   steps, float32, the DRW+QPO alternative) by ``batched_max_loglike``
   unsharded, "gspmd" and "shard_map" (gspmd equal to unsharded by
   ``torch.equal``; each shard_map shard equal to the unsharded run of its
   rows with its own generator), their seconds and each shard's launches;
   then a 200-step ``derive_posteriors(mesh=)`` of the alternative at 32
   walkers, equal to the unsharded chain bit for bit;
13. processes: phase 4's bootstrap over phase 12's mesh in this process
   (equal to phase 4), then ``max(2, device_count)`` ranks under
   ``torch.distributed`` (gloo; this script re-run with ``--rank-of``, a card a
   rank, both on the one card when there is one), each rank's seconds and
   launches printed: phase 4's full-width bootstrap (its fitted posteriors
   passed through files) whose T distribution, t_obs and p must equal phase
   4's, phase 12's shard_map refits equal to phase 12's, and phase 6's E13
   generation equal to this process's over a mesh of as many positions and
   to phase 6's unsharded call, all bit for bit; each generation step's bits
   on a block of 128 and 64 rows against those rows of the whole batch are
   printed, ``downsample_cumsum``'s must be equal, and a transform that
   rounds a block otherwise (cuFFT's plan for another batch may) is named
   and lifts the check against phase 6.  A rank that
   fails or does not finish within ``RANKS_TIMEOUT_S`` fails the script;
14. validation: the programs of ``mind_the_gaps_tpu_torch.examples`` in
   this process through their ``run()``, at the JAX scripts' widths
   (float32 refits, 12 walkers, 300 steps, early stop (0.01, 50)), each
   check's launches printed ((d) and (e) with their observed chains cut to
   500 and 2000 steps): (a) the batched Gaussian p-value calibration
   at K=32 x 127, n=400, every p in [1/128, 1], failing at a KS p below
   0.001; (b) the batched lognormal calibration at n=850 (E13 cut 16384, the
   sort's one-CTA tier), K=16 x 63, with the sort kernels required in both
   generation stages; (c) the detection-power curve at a = 0, 0.02, 0.05,
   0.1, 0.25, K=16 x 127, failing below a detection fraction of 0.9 at
   a = 0.25; (d) four complete Gaussian ``protassov_lrt`` calls of the
   full-pipeline calibration (p and T_obs finite and in range); (e) the
   posterior-predictive tutorial with the QPO injected at 255 simulations on
   the JAX script's seed-42 realization (its Poisson counts, noise seeded
   42), failing unless p <= 0.01; this card's own seed-42 realization (noise
   seeded 42) must equal the committed ``h100_seed42`` counts, and its MAP
   fits' T is printed; (f) the three convention studies with their own
   assertions;
15. the 10,000-simulation bootstrap: ``examples.lrt_10k.run`` (the JAX
   repo's ``benchmarks/lrt_10k.py``) on phase 4's fitted observed models,
   10,000 simulations in 20 chunks of 512 (the last 272 and the observed
   row), 12 walkers x 500 steps, float32 refits and the float64 refine:
   10,000 finite T, 0 <= p <= 1, t_obs_posterior equal to phase 4's, the
   celerite kernel launched with a warp (the refine) and in the layouts
   ``team_size`` gives the refits' launches (a whole chunk's and the last's), and
   a two-sample KS test of phase 4's 512 T against the 10,000 not rejected
   at p < 0.001 (both are draws of the same null posterior predictive);
16. the bench (``mind_the_gaps_tpu_torch.bench``, the JAX repo's
   ``bench.py``): the primary metric at its size, 65,536 parameter rows x
   N=5000 float32 over one shared data column, with the bench's two gates
   (float32 within 1.0 of float64 on 8 rows; the kernel within 0.5 of its
   plain version over the whole batch) and its launches (4 + 2 reps); the
   bootstrap chunk (512 x 12 walkers, early stop (0.01, 50),
   null and alternative, each model's 512 best log-likelihoods finite) and
   ``derive_posteriors`` with 32 walkers, both cut (100 and 400 steps, from
   the bench's 500 and 4000: phases 4 and 15 run them at full depth); then
   the kernel on the first 1,024 rows against its plain version (rtol
   1e-4, atol 1e-2) and the three layouts (32, 8 and 1 lanes) at the
   primary shape, equal to the 8-lane layout within that tolerance, timed
   in turns beside the bound and the latency floor, with the rows whose
   bits differ from the 8-lane layout's.  Phases 4
   and 6 are the bench's ``lrt_512`` and E13 phases, so they are not run
   again.

Phase 3 also holds the latency probe ``ops/fma_probe.py`` (``csrc/fma_chain.cu``,
dependent multiply-add chains) against its plain version in float32 and
float64, and drives the probe's own entry point (``fma_probe.probe``),
whose ns per iteration give the card's dependent-FMA latency.

The last lines are the card's name and power limit, one JSON line of the
kernels (route, source, launches in the main paths, phase 13's ranks
included, error, times and bound) and ``{"ok": true, "device": {...}}``.  Any failure raises: there is
no CPU path, and the script fails outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CELERITE_SOURCE = "mind_the_gaps_tpu_torch/csrc/celerite_loglike.cuh"
SORT_SOURCE = "mind_the_gaps_tpu_torch/csrc/bitonic_sort.cu"
GRAD_SOURCE = "mind_the_gaps_tpu_torch/csrc/celerite_grad.cuh"
# the MAP fit's gradient, in the JAX package jax.value_and_grad over this
# function (no Pallas kernel computes it)
GRAD_REPLACES = "mind_the_gaps_tpu/solver/semiseparable.py:141"
PROBE_SOURCE = "mind_the_gaps_tpu_torch/csrc/fma_chain.cu"
PROBE_REPLACES = "benchmarks/experiments/sublane_probe.py:29"
# phase 10's file: the exposure (s) and background rate (counts/s) added to
# phase 4's data, with the Kraft threshold of KraftNoise (counts)
CLI_EXPOSURE, CLI_BKG_RATE, CLI_BKG_RATE_ERR, KRAFT_COUNTS = 1.5, 0.2, 0.02, 15
# the Gaussian lrt_512's t_obs in every run whose MAP fits ran on the host
# CPU (PERF.md section 5)
HOST_FIT_T_OBS = 5.060570
# The kernels' times before their redesign, quoted from PERF.md section 6
# (its previous-design column: NVIDIA H100 80GB HBM3 at 700 W; the observed-fit
# time is the ~2.33 ms derived there), printed beside this run's; keyed by
# the start of the case's name
BEFORE_REDESIGN_MS = {
    "observed-fit step": 2.33,
    "bootstrap alt step": 1.904,
    "float64 refine": 2.510,
    "dense-S, bootstrap alt step": 1.791,
    "dense-S, float64 refine": 2.536,
    "bench primary": 10.301,  # 8 lanes a likelihood, the bench's kernel_ms before the one-thread layout
    "rank_remap (128, 65536) one E13 step": 1.452,
    "rank_remap (128, 65536) planted": 1.400,
    "rank_remap (512, 8192)": 0.411,
    "rank_remap (128, 50011)": 1.383,
    "sort_kv (128, 65536) f64": 1.713,
    "sort_kv (128, 16384) f32": 0.220,
    "sort_kv (64, 8) f32": 0.031,
    # the gradient kernel when it ran one thread a likelihood (PERF.md section 6)
    "MAP fit null": 4.607,
    "MAP fit alt": 7.731,
    "R=7 DRW+3 Lorentzians: B=1": 17.517,
    "R=10 runtime-R body: B=1": 183.888,
    "linear mean, per-element residuals: B=2": 7.778,
}
# the gradient kernel's aim: at most this many times its latency floor at
# the MAP fit's shapes (R = 1 and 3)
GRAD_FLOOR_AIM = 3.0
# phase 13: seconds for all its ranks to finish
RANKS_TIMEOUT_S = 600
# depths cut to keep the script within half its time limit (PERF.md section
# 4): the observed chains of phase 10's cli fit and lrt (the CLI's 10,000
# steps) and phase 14 ((d): the script's 2000 steps; (e): the tutorial's
# 10,000), which repeat phase 4's; phase 11's compare_models (4000 steps);
# phase 16's bootstrap chunk (the bench's 500 steps) and derive_posteriors
# (the bench's 4000 steps), which repeat phases 4 and 15
CLI_OBSERVED_STEPS = 2000
SELECTION_STEPS = 1000
VALIDATION_D_OBSERVED_STEPS = 500
VALIDATION_E_OBSERVED_STEPS = 2000
BENCH_BOOT_STEPS = 100
BENCH_DP_STEPS = 400


def before_note(name):
    ms = next((v for k, v in BEFORE_REDESIGN_MS.items() if name.startswith(k)), None)
    return "" if ms is None else f", before the redesign {ms:.3f} ms (PERF.md)"


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def reset_counts():
    """Every kernel wrapper's launch count set to 0."""
    from mind_the_gaps_tpu_torch.ops import celerite_log_likelihood, rank_remap, sort_kv
    from mind_the_gaps_tpu_torch.ops.celerite_grad import celerite_log_likelihood_and_grad

    celerite_log_likelihood.launches = celerite_log_likelihood.dense_launches = 0
    celerite_log_likelihood.team_launches = dict.fromkeys(celerite_log_likelihood.team_launches, 0)
    rank_remap.launches = sort_kv.launches = celerite_log_likelihood_and_grad.launches = 0


def read_counts():
    """The kernel wrappers' launch counts since ``reset_counts``."""
    from mind_the_gaps_tpu_torch.ops import celerite_log_likelihood, rank_remap, sort_kv
    from mind_the_gaps_tpu_torch.ops.celerite_grad import celerite_log_likelihood_and_grad

    return dict(celerite=celerite_log_likelihood.launches, celerite_dense=celerite_log_likelihood.dense_launches,
                celerite_warp=celerite_log_likelihood.team_launches[32],
                celerite_split=celerite_log_likelihood.team_launches[8],
                celerite_lane=celerite_log_likelihood.team_launches[1],
                rank_remap=rank_remap.launches, sort_kv=sort_kv.launches,
                celerite_grad=celerite_log_likelihood_and_grad.launches)


def phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up
    run, from CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """(result, milliseconds) of one run of ``fn()``, from CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def sort_bound(case):
    """Bound of one sort launch: each input read once and each output
    written once; one operation per compare-exchange of the bitonic
    network on the padded row."""
    from mind_the_gaps_tpu_torch.bench import bound

    B, m = case["B"], case["m"]
    n = 1 << max(m - 1, 0).bit_length()
    lg = n.bit_length() - 1
    return bound(B * m * case["bytes_per_elem"], B * (n // 2) * lg * (lg + 1) // 2, case["itemsize"])


def grad_step_ops(jr, jc):
    """Floating-point operations of one time step of one likelihood in
    csrc/celerite_grad.cuh, forward pass and value sums plus the adjoint,
    counted from its loops (an exp, log, sin, cos or division counts as
    one)."""
    R = jr + 2 * jc
    ns = R * (R + 1) // 2
    forward = 2 * R * R + 9 * R + 5 * ns + 2 * jr + 11 * jc + 12
    adjoint = 7.5 * R * R + 23.5 * R + 14 * ns + 4 * jr + 28 * jc + 11
    return forward + adjoint


def grad_bound(case):
    """Bound of one gradient launch: t, y, diag, the coefficients, mean and
    jitter read once, the value and every gradient (the (B, N) residual one
    included) written once; the operations of both passes."""
    from mind_the_gaps_tpu_torch.bench import bound

    B, N, jr, jc, y_numel = case["B"], case["N"], case["jr"], case["jc"], case["y_numel"]
    coef = B * (2 * jr + 4 * jc)
    n_bytes = 8 * (2 * N + y_numel + coef + 2 * B + B + coef + B + B * N)
    return bound(n_bytes, B * N * grad_step_ops(jr, jc), 8)


def grad_case(card, name, a):
    """One gradient-kernel case (``a``: the op's arguments on the card):
    value and gradients against the plain version (value rtol 1e-10, each
    gradient within 1e-8 of its largest component), a second launch bit
    for bit, the value against the forward kernel's (rtol 1e-12), its time
    from CUDA events and its bound."""
    import torch

    from mind_the_gaps_tpu_torch.ops import celerite_log_likelihood
    from mind_the_gaps_tpu_torch.ops.celerite_grad import (
        celerite_log_likelihood_and_grad,
        celerite_log_likelihood_and_grad_plain,
    )

    out = celerite_log_likelihood_and_grad(**a)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref = celerite_log_likelihood_and_grad_plain(**a)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    ll, ll_ref = out[0], ref[0]
    check(bool(torch.isfinite(ll_ref).all()), f"{name}: the plain version is not finite")
    max_abs = float((ll - ll_ref).abs().max())
    ok = bool(((ll - ll_ref).abs() <= 1e-10 * ll_ref.abs()).all())
    worst = 0.0
    for g, g_ref in zip(out[1], ref[1]):
        if g_ref.numel():
            rel = float((g - g_ref).abs().max() / g_ref.abs().max().clamp_min(1e-300))
            worst = max(worst, rel)
    again = celerite_log_likelihood_and_grad(**a)
    same = torch.equal(again[0], out[0]) and all(torch.equal(u, v) for u, v in zip(again[1], out[1]))
    check(same, f"{name}: a second launch on the same inputs gave other bits")
    fwd = celerite_log_likelihood(a["coeffs"], a["t"], a["y"], a["diag"], mean=a.get("mean"),
                                  extra_diag=a["extra_diag"])
    fwd_rel = float(((ll - fwd).abs() / fwd.abs()).max())
    check(fwd_rel <= 1e-12, f"{name}: the value differs from the forward kernel's by {fwd_rel:.3e} (rtol 1e-12)")
    ms = cuda_ms(lambda: celerite_log_likelihood_and_grad(**a), reps=10)
    c = a["coeffs"]
    case = dict(name=name, max_abs_err=max_abs, grad_rel_err=worst, ms=ms, plain_ms=plain_ms, B=c.ar.shape[0],
                N=a["t"].shape[0], jr=c.ar.shape[1], jc=c.ac.shape[1], y_numel=a["y"].numel())
    case["bound_ms"], case["bound_by"] = grad_bound(case)
    print(f"[kernel] celerite_grad {name}: value max_abs_err={max_abs:.3e} (rtol 1e-10), gradients "
          f"{worst:.3e} of their largest (1e-8), repeat launch bit-identical, value against the forward "
          f"kernel {fwd_rel:.3e} (rtol 1e-12), kernel {ms:.3f} ms{before_note(name)}, plain {plain_ms:.1f} ms, "
          f"bound {case['bound_ms']:.5f} ms ({case['bound_by']}) [{card}]", flush=True)
    check(ok and worst <= 1e-8, f"{name}: the gradient kernel disagrees with its plain version")
    return case


def grad_cases(card):
    """Phase 3, the MAP fit's kernel: value and gradients against the plain
    version (autograd through solver/semiseparable.py, on the card) at
    N=5000, R = 1, 3, 7, 10 and 16 (the chunk buffers in the global scratch
    area): value rtol 1e-10, each gradient within 1e-8
    of its largest component; a second launch on the same inputs gives the
    same bits; the value equals the forward kernel's
    (``celerite_log_likelihood``) to rtol 1e-12."""
    import numpy as np
    import torch

    from mind_the_gaps_tpu_torch.kernels import Lorentzian, RealTerm
    from mind_the_gaps_tpu_torch.models.mean_models import LinearModel
    from mind_the_gaps_tpu_torch.ops.celerite_grad import (
        celerite_log_likelihood_and_grad,
        celerite_log_likelihood_and_grad_plain,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    lc, null, alt = scenario()
    t = torch.as_tensor(lc.times, device=dev)
    y = torch.as_tensor(lc.y, dtype=torch.float64, device=dev)
    diag = torch.as_tensor((lc.dy + 1e-12) ** 2, dtype=torch.float64, device=dev)
    drw3l = alt + Lorentzian(-0.8, 1.5, -1.6) + Lorentzian(-0.6, 1.0, -1.2)  # R = 7
    wide10 = drw3l + RealTerm(-0.5, -2.0) + Lorentzian(-1.2, 1.2, -1.0)  # R = 10: runtime-R body
    wide16 = wide10 + Lorentzian(-1.4, 1.1, -0.8) + Lorentzian(-1.6, 0.9, -0.6) + Lorentzian(-1.8, 0.8, -0.4)

    def args(kernel, B=1, per_element_mean=False):
        th = kernel.get_parameter_vector() + 0.05 * rng.normal(size=(B, kernel.ndim))
        coeffs = kernel.coefficients(torch.as_tensor(th, device=dev))
        out = dict(coeffs=coeffs, t=t, diag=diag, extra_diag=torch.full((B,), 1e-3, dtype=torch.float64, device=dev))
        if per_element_mean:  # a linear mean model per draw: residuals (B, N)
            lines = torch.as_tensor(np.stack([rng.normal(0, 1e-5, B), rng.normal(10.0, 0.1, B)], 1), device=dev)
            out["y"] = y - LinearModel(0.0, 10.0).value(t - t[0], lines)
        else:
            out["y"], out["mean"] = y, torch.full((B,), float(np.mean(lc.y)), dtype=torch.float64, device=dev)
        return out

    cases = [
        ("MAP fit null: B=1 N=5000 R=1 (DRW)", args(null)),
        ("MAP fit alt: B=1 N=5000 R=3 (DRW + Lorentzian)", args(alt)),
        ("R=7 DRW+3 Lorentzians: B=1 N=5000", args(drw3l)),
        ("R=10 runtime-R body: B=1 N=5000", args(wide10)),
        ("R=16 runtime-R body, buffers in global scratch: B=1 N=5000", args(wide16)),
        ("linear mean, per-element residuals: B=2 N=5000 R=3", args(alt, B=2, per_element_mean=True)),
    ]
    results = [grad_case(card, name, a) for name, a in cases]

    a = args(alt, B=3)  # the middle draw's DRW amplitude negative: K not positive definite
    a["coeffs"] = a["coeffs"]._replace(ar=a["coeffs"].ar * torch.tensor([[1.0], [-1.0], [1.0]], device=dev))
    ll, grads = celerite_log_likelihood_and_grad(**a)
    ll_ref, _ = celerite_log_likelihood_and_grad_plain(**a)
    check(float(ll[1]) == float(ll_ref[1]) == -math.inf, "non-PD theta must give -inf from the gradient kernel")
    check(bool(torch.isfinite(ll[[0, 2]]).all()), "PD thetas beside a non-PD one must stay finite")
    check(all(bool((g[1] == 0).all()) for g in grads), "non-PD theta must give a zero gradient")
    print("[kernel] celerite_grad non-PD theta: -inf and a zero gradient, its neighbours finite", flush=True)
    return results


def probe_cases(card):
    """Phase 3, the latency probe: ``fma_chain`` against its plain version
    at the JAX script's 16384 elements and 20000 iterations.  float64:
    rtol 1e-9 elementwise.  float32: within 2e-3 of the largest |value| of
    the plain version run in float64 (the kernel fuses each multiply-add,
    the plain version rounds twice, and the recurrence, nearly a rotation,
    carries rounding forward: about iters x 6e-8 relative, 5.6e-4 in a
    numpy emulation of the fused float32 chain).  Returns the float32 case
    (the JAX probe's type) and the float64 one."""
    import torch

    from mind_the_gaps_tpu_torch.bench import bound
    from mind_the_gaps_tpu_torch.ops.fma_probe import ITERS, fma_chain, fma_chain_plain

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(11)
    n, cases = 16384, {}
    for dtype in (torch.float32, torch.float64):
        x = torch.randn(n, generator=gen, dtype=dtype, device=dev)
        out = fma_chain(x, ITERS)
        torch.cuda.synchronize()
        ref = fma_chain_plain(x.double(), ITERS)
        err = (out.double() - ref).abs()
        if dtype == torch.float64:
            ok, tol = bool((err <= 1e-9 * ref.abs()).all()), "rtol 1e-9"
        else:
            ok, tol = float(err.max()) <= 2e-3 * float(ref.abs().max()), "2e-3 of max|f64 plain|"
        plain_ms = cuda_ms(lambda: fma_chain_plain(x, ITERS), reps=1)
        ms = cuda_ms(lambda: fma_chain(x, ITERS), reps=20)
        item = x.element_size()
        case = dict(name=f"fma_chain {str(dtype)[6:]} n={n} iters={ITERS}", max_abs_err=float(err.max()), ms=ms,
                    plain_ms=plain_ms)
        # in and out once; 5 operations an iteration, 3 more for b's start and the sum
        case["bound_ms"], case["bound_by"] = bound(2 * n * item, n * (5 * ITERS + 3), item)
        print(f"[kernel] {case['name']}: max_abs_err={case['max_abs_err']:.3e} ({tol}; max|plain| "
              f"{float(ref.abs().max()):.3e}) kernel {ms:.4f} ms ({ms * 1e6 / ITERS:.3f} ns an iteration), plain "
              f"{plain_ms:.1f} ms, bound {case['bound_ms']:.4f} ms ({case['bound_by']}) [{card}]", flush=True)
        check(ok, f"{case['name']}: the probe kernel disagrees with its plain version")
        cases[item] = case
    return cases[4], cases[8]


def probe_entry(card):
    """Phase 3, the probe's own entry point (``fma_probe.probe``): ns an
    iteration at the JAX script's counts and at 1, 4, 16 and 32 warps an
    SM; the chain is two dependent FMAs an iteration, so at 1 and 4 warps
    an SM (at most one a scheduler) half an iteration is one FMA's latency.
    Returns (launches, {dtype: latency ns})."""
    from mind_the_gaps_tpu_torch.ops.fma_probe import fma_chain, fma_latency_ns, probe

    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    fma_chain.launches = 0
    rows = probe()
    launches = fma_chain.launches
    check(launches > 0, "the probe's entry point never launched the probe kernel")
    for r in rows:
        print(f"[probe] {r['dtype']} n={r['n']} threads={r['threads']} warps/SM={r['warps_per_sm']}: "
              f"{r['ms']:.4f} ms, {r['ns_per_iter']:.4f} ns an iteration [{card}]", flush=True)
    latency = fma_latency_ns(rows)
    print(f"[probe] dependent FMA latency: float32 {latency['float32']:.4f} ns, float64 {latency['float64']:.4f} ns "
          f"(SM clock now, max: {clocks}); {launches} launches [{card}]", flush=True)
    return launches, latency


def fit_check(card, n=1000):
    """Phase 3, the MAP fit on the card (one gradient launch an
    evaluation) against the plain version's fit on the CPU, from the same
    start: the same optimum, log-likelihood within 1e-7 and parameters
    within rtol 1e-5, for the null and the alternative of the lrt_512
    scenario cut to ``n`` points."""
    import numpy as np
    import torch

    from mind_the_gaps_tpu_torch.gpmodelling import GPModelling

    lc, null, alt = scenario(n)
    for name, kernel in (("null", null), ("alt", alt)):
        card_gp, cpu_gp = GPModelling(lc, kernel, device="cuda"), GPModelling(lc, kernel, device="cpu")
        t0 = time.perf_counter()
        a = card_gp.fit()
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = cpu_gp.fit()
        t_cpu = time.perf_counter() - t0
        dll = abs(a.fun - b.fun)
        drel = float(np.max(np.abs(a.x - b.x) / np.maximum(np.abs(b.x), 1e-300)))
        print(f"[fit] {name} N={n}: card -ll {a.fun!r} in {card_gp.timings['map_fit_evals']} evaluations "
              f"({t_card:.3f} s, {card_gp.timings['map_fit_launches']} launches), CPU plain -ll {b.fun!r} in "
              f"{cpu_gp.timings['map_fit_evals']} ({t_cpu:.3f} s); |d ll| {dll:.3e} (1e-7), parameters "
              f"rtol {drel:.3e} (1e-5): card {a.x}, CPU {b.x} [{card}]", flush=True)
        check(card_gp.timings["map_fit_launches"] == card_gp.timings["map_fit_evals"] > 0,
              "the card's fit did not evaluate through the gradient kernel")
        check(dll <= 1e-7 and drel <= 1e-5, f"the card's {name} fit missed the plain fit's optimum")


def kernel_cases(card):
    """Phase 3, celerite: kernel against plain at the main path's shapes."""
    import numpy as np
    import torch

    from mind_the_gaps_tpu_torch.bench import celerite_bound
    from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, Lorentzian, RealTerm
    from mind_the_gaps_tpu_torch.ops import celerite_log_likelihood, celerite_log_likelihood_plain
    from mind_the_gaps_tpu_torch.ops.celerite import _launch, layouts, team_size

    dev = torch.device("cuda")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    t5k = np.cumsum(rng.uniform(2.0, 8.0, 5000))  # the main path's times
    drw = DampedRandomWalk(1.0, -3.0)
    drw_qpo = DampedRandomWalk(1.0, -3.0) + Lorentzian(-1.0, 2.0, -2.0)
    real6 = RealTerm(0.5, -1.0)
    for i in range(1, 6):
        real6 = real6 + RealTerm(0.5 - 0.3 * i, -1.0 - 0.5 * i)
    cplx6 = Lorentzian(-1.0, 2.0, -2.0) + Lorentzian(-0.8, 1.5, -1.6) + Lorentzian(-0.6, 1.0, -1.2)
    slow = DampedRandomWalk(1.0, math.log(2e-6)) + Lorentzian(-1.0, 2.0, math.log(1e-5))
    drw3l = drw_qpo + Lorentzian(-0.8, 1.5, -1.6) + Lorentzian(-0.6, 1.0, -1.2)  # R = 7
    wide10 = drw3l + RealTerm(-0.5, -2.0) + Lorentzian(-1.2, 1.2, -1.0)  # R = 10: runtime-R body

    def inputs(kernel, B, t, layout, dtype, G=None):
        n = len(t)
        th = torch.as_tensor(kernel.get_parameter_vector() + 0.05 * rng.normal(size=(B, kernel.ndim)),
                             dtype=dtype, device=dev)
        rows = {"shared": (n,), "grouped": (G, n), "per": (B, n)}[layout]
        y = torch.as_tensor(10.0 + rng.normal(0.0, 2.0, rows), dtype=dtype, device=dev)
        return dict(
            coeffs=kernel.coefficients(th), t=torch.as_tensor(t, device=dev), y=y,
            diag=torch.full(rows, 0.09, dtype=dtype, device=dev),
            mean=torch.full((B,), 10.0, dtype=dtype, device=dev),
            repeats=(B // G if layout == "grouped" else 1),
            extra_diag=torch.zeros(B, dtype=dtype, device=dev),
        )

    f64, f32 = torch.float64, torch.float32
    cases = [
        # name, kernel, B, t, layout, dtype, G, reference, sym
        ("observed-fit step: shared B=16 N=5000 R=3 f64", drw_qpo, 16, t5k, "shared", f64, None, "same", True),
        ("bootstrap null step: grouped G=513x6 N=5000 R=1 f32", drw, 3078, t5k, "grouped", f32, 513, "same", True),
        ("bootstrap alt step: grouped G=513x6 N=5000 R=3 f32", drw_qpo, 3078, t5k, "grouped", f32, 513, "same", True),
        ("float64 refine: per-element B=513 N=5000 R=3 f64", drw_qpo, 513, t5k, "per", f64, None, "same", True),
        ("R=6 Jc=0: shared B=64 N=37 f64", real6, 64, t5k[:37], "shared", f64, None, "same", True),
        ("R=6 Jr=0: shared B=64 N=37 f64", cplx6, 64, t5k[:37], "shared", f64, None, "same", True),
        ("R=7 DRW+3 Lorentzians: shared B=64 N=5000 f64", drw3l, 64, t5k, "shared", f64, None, "same", True),
        ("R=7 DRW+3 Lorentzians: grouped G=513x6 N=5000 f32", drw3l, 3078, t5k, "grouped", f32, 513, "same",
         True),
        ("R=10 runtime-R body: shared B=16 N=5000 f64", wide10, 16, t5k, "shared", f64, None, "same", True),
        ("R=10 runtime-R body: grouped G=64x2 N=5000 f32", wide10, 128, t5k, "grouped", f32, 64, "same", True),
        ("below the layout crossover: grouped G=176x3 (B=528) N=5000 R=3 f32", drw_qpo, 528, t5k, "grouped",
         f32, 176, "same", True),
        ("above the layout crossover: grouped G=529x1 (B=529) N=5000 R=3 f32", drw_qpo, 529, t5k, "grouped",
         f32, 529, "same", True),
        ("f32 against f64: grouped G=513x6 N=5000 R=3", drw_qpo, 3078, t5k, "grouped", f32, 513, "f64", True),
        ("f32 against f64 at t~5e7: shared B=16 N=5000 R=3", slow, 16,
         5e7 + np.cumsum(rng.uniform(2e4, 1e5, 5000)), "shared", f32, None, "f64", True),
        ("dense-S, bootstrap alt step: grouped G=513x6 N=5000 R=3 f32", drw_qpo, 3078, t5k, "grouped", f32, 513,
         "same", False),
        ("dense-S, float64 refine: per-element B=513 N=5000 R=3 f64", drw_qpo, 513, t5k, "per", f64, None,
         "same", False),
        ("bench primary: shared B=65536 N=5000 R=3 f32", drw_qpo, 65536, t5k, "shared", f32, None, "same", True),
    ]
    results = []
    for name, kernel, B, t, layout, dtype, G, reference, sym in cases:
        args = inputs(kernel, B, t, layout, dtype, G)
        out = celerite_log_likelihood(**args, sym=sym)
        torch.cuda.synchronize()
        if reference == "same":  # the plain version, timed on this one run (CUDA events)
            ref, plain_ms = timed(lambda: celerite_log_likelihood_plain(**args))
        else:  # the same draws in float64
            ref_args = {k: (v.double() if torch.is_tensor(v) and v.is_floating_point() else v)
                        for k, v in args.items()}
            ref_args["coeffs"] = type(args["coeffs"])(*(c.double() for c in args["coeffs"]))
            ref, plain_ms = celerite_log_likelihood_plain(**ref_args), None  # no run of the plain version to time
        ms = cuda_ms(lambda: celerite_log_likelihood(**args, sym=sym), reps=5)
        finite = torch.isfinite(ref)
        check(torch.equal(torch.isfinite(out), finite), f"{name}: -inf pattern differs")
        check(bool(finite.all()), f"{name}: the plain version is not finite")
        err = (out.double() - ref.double()).abs()
        max_abs = float(err.max())
        if reference == "f64":
            ok, tol = max_abs < 0.5, "abs 0.5 against the f64 plain version"
        elif dtype == f64:
            ok = bool((err <= 1e-10 * ref.abs()).all())
            tol = "rtol 1e-10"
        else:
            ok = bool((err <= 1e-2 + 1e-4 * ref.abs()).all())
            tol = "rtol 1e-4, atol 1e-2"
        jr, jc = args["coeffs"].ar.shape[1], args["coeffs"].ac.shape[1]
        case = dict(name=name, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, sym=sym, reference=reference,
                    B=B, N=len(t), jr=jr, jc=jc, cols=1 if args["y"].dim() == 1 else args["y"].shape[0],
                    itemsize=args["y"].element_size())
        case["bound_ms"], case["bound_by"] = celerite_bound(case)
        team = case["team"] = team_size(B, sm_count, jr, jc, sym)
        bits = ""
        if team == 1:  # the same operations in the same order as the teams: the rows whose bits differ
            bits = f", {int((out != _launch(**args, team=8)).sum())} of {B} rows differ from L=8's bits"
        plain = "not timed" if plain_ms is None else f"{plain_ms:.3f} ms"
        print(f"[kernel] {name}: max_abs_err={max_abs:.3e} ({tol}) kernel {ms:.3f} ms (L={team}{before_note(name)}"
              f"{bits}), plain {plain}, bound {case['bound_ms']:.4f} ms ({case['bound_by']}) [{card}]", flush=True)
        check(ok, f"{name}: kernel disagrees with the plain version (max abs err {max_abs})")
        results.append(case)

    # a non-positive-definite theta: -inf from every body and layout and the plain version
    for kernel in (drw, wide10):
        args = inputs(kernel, 16, t5k, "shared", f64)
        args["coeffs"] = args["coeffs"]._replace(ar=-args["coeffs"].ar)
        ref = celerite_log_likelihood_plain(**args)
        check(bool(torch.all(ref == -math.inf)), "non-PD theta must give -inf from the plain version")
        for sym in (True, False):
            c = args["coeffs"]
            for team in layouts(c.ar.shape[1], c.ac.shape[1], sym):
                out = _launch(**args, sym=sym, team=team)
                check(bool(torch.all(out == -math.inf)), f"non-PD theta must give -inf (sym={sym}, L={team})")
    print("[kernel] non-PD theta: -inf from every kernel body and layout and the plain version", flush=True)
    layout_sweep(card, sm_count)
    return results


def layout_sweep(card, sm_count):
    """Phase 3, celerite layouts: every layout (32, 8 and 1 lanes per
    likelihood) at the batches on either side of each of ``team_size``'s
    crossovers, at the bootstrap's (float32 grouped) and the observed
    fit's (float64 shared) data layouts, timed in turns
    (``ops.layout_sweep.sweep_point``): each against the plain version on
    its first rows and against the 8-lane layout on every row (rtol 1e-10
    f64; rtol 1e-4, atol 1e-2 f32; the same -inf rows), and the rows whose
    bits differ from the 8-lane layout's."""
    from mind_the_gaps_tpu_torch.ops.celerite import LANE_LAYOUT_MIN_PER_SM, WARP_TEAM_MAX_PER_SM
    from mind_the_gaps_tpu_torch.ops.layout_sweep import CASES, sweep_point

    for per_sm in (WARP_TEAM_MAX_PER_SM, WARP_TEAM_MAX_PER_SM + 2, LANE_LAYOUT_MIN_PER_SM - 1, LANE_LAYOUT_MIN_PER_SM):
        for layout, dtype in CASES:
            B = per_sm * sm_count
            B -= B % 6 if layout == "grouped" else 0
            row = sweep_point(B, layout, dtype)
            times = ", ".join(f"{k} {v:.3f} ms" for k, v in row["ms"].items())
            print(f"[layout] {layout} R=3 {row['dtype']} B={B} ({row['per_sm']:.2f} per SM): {times}, rule "
                  f"L={row['rule']}; rows whose bits differ from L=8's {row['rows_differ_from_8']}; max abs err "
                  f"against plain {row['max_abs_err']} [{card}]", flush=True)


def e13_step_keys(lc, kernel, B, dev, seed=0):
    """(adj, sorted draws, draws): the keys and draws of one real E13
    spectral step of the lognormal scenario, as
    ``simulator.e13_adjust_batch`` makes them, for ``B`` TK95 segments of
    the E13 cut length on ``dev``."""
    import torch

    from mind_the_gaps_tpu_torch.simulator import tk95_rates
    from mind_the_gaps_tpu_torch.stats import sample_pdf

    sim = lc.get_simulator(kernel.get_psd, "Lognormal", extension_factor=2, device=dev)
    m = sim._e13_cut_len
    gen = torch.Generator(dev).manual_seed(seed)
    omega = torch.as_tensor(sim.omega[1:], dtype=torch.float64, device=dev)
    psd = kernel.get_psd(omega, torch.as_tensor(kernel.get_parameter_vector(), device=dev)[None].expand(B, -1))
    psd = torch.cat([psd.new_zeros((B, 1)), psd], dim=1)
    segments = tk95_rates(psd, sim.fftndatapoints, sim.sim_dt, generator=gen)[:, :m]
    xsim = sample_pdf("lognormal", float(lc.mean), segments.std(dim=-1, correction=0)[:, None], (B, m),
                      generator=gen)
    amplitudes = torch.abs(torch.fft.rfft(segments.float(), dim=-1)) / (m // 2 + 1)
    phases = torch.angle(torch.fft.rfft(xsim.float(), dim=-1))
    adj = torch.fft.irfft(amplitudes * torch.exp(1j * phases), n=m, dim=-1)
    draws = -torch.sort(-xsim.float(), dim=-1).values
    return adj.contiguous(), draws.contiguous(), xsim


def sort_cases(card, lc, kernel):
    """Phase 3, sorts: kernel against plain, equal by ``torch.equal``."""
    import torch

    from mind_the_gaps_tpu_torch.ops import rank_remap, rank_remap_plain, sort_kv, sort_kv_plain
    from mind_the_gaps_tpu_torch.ops.sort import sort_tier

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(7)
    adj65, draws65, xsim65 = e13_step_keys(lc, kernel, 128, dev)
    check(adj65.shape == (128, 65536), f"the lognormal scenario's E13 cut is {tuple(adj65.shape)}, not (128, 65536)")

    def planted(B, m):
        """Keys from few values, +0.0 and -0.0 among them."""
        vals = torch.tensor([-1.5, -0.0, 0.0, 0.0, -0.0, 2.0, 2.0, 3.25], device=dev)
        return vals[torch.randint(0, 8, (B, m), generator=gen, device=dev)]

    def randn(B, m, dtype=torch.float32):
        return torch.randn(B, m, generator=gen, device=dev, dtype=dtype)

    def desc(x):
        return -torch.sort(-x, dim=-1).values

    cases = [
        # name, op, inputs, bytes an element in and out
        ("rank_remap (128, 65536) one E13 step, cluster tier", "remap", (adj65, draws65), 20),
        ("rank_remap (128, 65536) planted ties and +-0.0", "remap", (planted(128, 65536), draws65), 20),
        ("rank_remap (512, 8192) tile tier", "remap", (randn(512, 8192), desc(randn(512, 8192))), 20),
        ("rank_remap (256, 16384) tile tier, phase 14's E13 chunk at n=850", "remap",
         (randn(256, 16384), desc(randn(256, 16384))), 20),
        ("rank_remap (128, 50011) non-power-of-two", "remap", (adj65[:, :50011].contiguous(),
                                                                draws65[:, :50011].contiguous()), 20),
        ("sort_kv (128, 65536) f64, the E13 draws", "sort", (-xsim65, xsim65), 32),
        ("sort_kv (128, 16384) f32", "sort", (randn(128, 16384), randn(128, 16384)), 16),
        ("sort_kv (64, 8) f32 with ties", "sort", (planted(64, 8), randn(64, 8)), 16),
    ]
    for m in (16384, 16385, 65536, 131072, 131073):  # the cluster tier's edges
        def where(dtype):
            tier, ctas = sort_tier(m, dtype)
            return f"{tier} tier, {ctas} CTA{'s' if ctas > 1 else ''} a row"

        f32, f64 = torch.float32, torch.float64
        cases += [
            (f"rank_remap (8, {m}) {where(f32)}", "remap", (planted(8, m), desc(randn(8, m))), 20),
            (f"sort_kv (8, {m}) f32 {where(f32)}", "sort", (planted(8, m), randn(8, m)), 16),
            (f"sort_kv (8, {m}) f64 {where(f64)}", "sort", (planted(8, m).double(), randn(8, m, f64)), 32),
        ]
    results = []
    for name, op, args, bpe in cases:
        fn, plain = (rank_remap, rank_remap_plain) if op == "remap" else (sort_kv, sort_kv_plain)
        out = fn(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        equal = all(torch.equal(a, b) for a, b in zip(out, ref))
        if op == "sort":
            equal = equal and torch.equal(torch.signbit(out[0]), torch.signbit(ref[0]))
        max_abs = max(float((a.double() - b.double()).abs().max()) for a, b in zip(out, ref))
        # a launch-bound case (a few rows of a few elements) gets 100 runs,
        # so that it is timed with the card's clocks up, not ramping
        reps = 100 if args[0].numel() <= 1 << 14 else 10
        plain_ms = cuda_ms(lambda: plain(*args), reps=reps)
        ms = cuda_ms(lambda: fn(*args), reps=reps)
        case = dict(name=name, op=op, ms=ms, plain_ms=plain_ms, max_abs_err=max_abs, equal=equal,
                    B=args[0].shape[0], m=args[0].shape[1], bytes_per_elem=bpe, itemsize=args[0].element_size())
        case["bound_ms"], case["bound_by"] = sort_bound(case)
        print(f"[kernel] {name}: torch.equal={equal}, kernel {ms:.3f} ms{before_note(name)}, plain (library) {plain_ms:.3f} ms, "
              f"bound {case['bound_ms']:.4f} ms ({case['bound_by']}) [{card}]", flush=True)
        check(equal, f"{name}: the kernel is not equal to its plain version")
        results.append(case)
    return results


def cli_phase(card, lc, workdir, reset_counts, read_counts):
    """Phase 10: the CLI end to end on a lightcurve file at N=5000, then the
    checkpoint resume check; returns the launch counts of the three
    commands."""
    import os

    import numpy as np
    import torch

    from mind_the_gaps_tpu_torch import SimpleLightcurve, cli
    from mind_the_gaps_tpu_torch.lrt import protassov_lrt
    from mind_the_gaps_tpu_torch.simulator.noise import KraftNoise, kraft_tables

    # phase 4's data, with exposures and a background, as a six-column
    # SimpleLightcurve CSV at full precision
    csv = workdir / "lc_bkg.csv"
    n = lc.n
    np.savetxt(csv, np.column_stack([lc.times, lc.y, lc.dy, np.full(n, CLI_EXPOSURE), np.full(n, CLI_BKG_RATE),
                                     np.full(n, CLI_BKG_RATE_ERR)]),
               header="t\trate\terror\texposure\tbkg_rate\tbkg_rate_err")
    lc_file = SimpleLightcurve(str(csv))
    check(np.array_equal(lc_file.times, lc.times) and np.array_equal(lc_file.y, lc.y),
          "the CSV does not read back as phase 4's data")

    # the Kraft tables: built on the card, against the plain version on the CPU
    bkg = lc_file.bkg_rate * lc_file.exposures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    noise = KraftNoise(lc_file.exposures, bkg, lc_file.bkg_rate_err, kraft_counts=KRAFT_COUNTS, device="cuda")
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = kraft_tables(bkg, noise.max_count, "cpu")
    t_plain = time.perf_counter() - t0
    worst = 0.0
    for card_t, cpu_t in zip((noise.median_table, noise.lo_table, noise.hi_table), plain):
        worst = max(worst, float(((card_t.cpu() - cpu_t).abs() / cpu_t.abs().clamp_min(1.0)).max()))
    print(f"[cli] Kraft tables {tuple(noise.median_table.shape)} (N = 0..{noise.max_count}, {lc.n} bins): built on the "
          f"card in {t_table:.3f} s, plain on the CPU {t_plain:.3f} s; largest difference {worst:.3e} of "
          f"max(|value|, 1) (1e-9) [{card}]", flush=True)
    check(worst <= 1e-9, "the Kraft tables built on the card disagree with the plain version")

    def run(name, argv):
        reset_counts()
        t0 = time.perf_counter()
        out = cli.main(argv)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
        print(f"[cli] {name}: {sec:.3f} s, launches = {counts} [{card}]", flush=True)
        return out, counts

    chain, sims, ckpt = workdir / "chain.npz", workdir / "sims.npz", workdir / "lrt.npz"
    gp, fit_counts = run("fit", ["fit", str(csv), "--kernel", "drw", "--max-steps", str(CLI_OBSERVED_STEPS),
                                 "--output", str(chain)])
    check(fit_counts["celerite_grad"] > 0 and fit_counts["celerite"] > 0,
          "cli fit did not launch the gradient and celerite kernels")
    check(np.isfinite(gp.max_loglikelihood) and len(gp.mcmc_samples) > 10, "cli fit: no finite posterior")
    print(f"[cli] fit: {gp.sampler.iteration} steps, converged {gp.converged}, max loglike "
          f"{gp.max_loglikelihood:.6f}, MAP {gp.max_parameters}", flush=True)

    (gp_sim, rates, dy), sim_counts = run("simulate", ["simulate", str(csv), "--kernel", "drw", "--chain", str(chain),
                                                       "--nsims", "512", "--output", str(sims)])
    kraft = gp_sim._simulator.noise
    share = int(kraft.bins_replaced) / kraft.bins_drawn
    print(f"[cli] simulate: noise {kraft.name}, {share:.4f} of the {kraft.bins_drawn} simulated bins under "
          f"{KRAFT_COUNTS} counts replaced by Kraft medians and HPD errors", flush=True)
    check(kraft.name == "Kraft" and share >= 0.10, f"Kraft noise replaced {share:.4f} of the bins, not >= 0.10")
    check(rates.shape == (512, lc.n) and bool(np.all(np.isfinite(rates))) and bool(np.all(np.isfinite(dy)))
          and bool(np.all(dy > 0)), "cli simulate: rates or errors not finite")

    res, lrt_counts = run("lrt", ["lrt", str(csv), "--null", "drw", "--alt", "drw+qpo", "--nsims", "512",
                                  "--max-steps", str(CLI_OBSERVED_STEPS), "--checkpoint", str(ckpt)])
    kraft = res.null_model._simulator.noise
    share_lrt = int(kraft.bins_replaced) / kraft.bins_drawn
    for key, sec in res.timings.items():
        print(f"[cli] lrt {key} = {sec:.3f}", flush=True)
    print(f"[cli] lrt: t_obs = {res.t_obs:.6f}, p_value = {res.p_value:.6f}, Kraft share {share_lrt:.4f}, null "
          f"{res.null_model.sampler.iteration} steps, alt {res.alt_model.sampler.iteration} steps", flush=True)
    check(kraft.name == "Kraft" and share_lrt >= 0.10, "cli lrt: Kraft noise not on the path")
    check(lrt_counts["celerite_grad"] > 0 and lrt_counts["celerite_warp"] > 0 and lrt_counts["celerite_split"] > 0
          and lrt_counts["celerite"] > 0,
          "cli lrt did not launch the gradient kernel and both celerite layouts")
    check(res.t_dist.shape == (512,) and bool(np.all(np.isfinite(res.t_dist))) and 0.0 <= res.p_value <= 1.0,
          "cli lrt: t_dist not finite or p-value outside [0, 1]")

    # resume: an uninterrupted checkpointed run, the file rewound to 2 chunks, a resumed run
    common = dict(nsims=512, chunk=128, seed=0, null_model=res.null_model, alt_model=res.alt_model, device="cuda")
    resume = workdir / "resume.npz"
    t0 = time.perf_counter()
    full = protassov_lrt(lc_file, res.null_model.kernel, res.alt_model.kernel, checkpoint=str(resume), **common)
    t_full = time.perf_counter() - t0
    d = dict(np.load(resume))
    check(int(d["chunks_done"]) == 5, f"the checkpoint holds {int(d['chunks_done'])} chunks, not 5")
    np.savez(str(resume) + ".tmp.npz", config_crc=d["config_crc"], chunks_done=np.int64(2),
             null_done=d["null_done"][:256], alt_done=d["alt_done"][:256])
    os.replace(str(resume) + ".tmp.npz", resume)
    t0 = time.perf_counter()
    resumed = protassov_lrt(lc_file, res.null_model.kernel, res.alt_model.kernel, checkpoint=str(resume), **common)
    t_resumed = time.perf_counter() - t0
    equal = np.array_equal(full.t_dist, resumed.t_dist)
    print(f"[cli] resume at chunk=128: uninterrupted {t_full:.3f} s (t_obs {full.t_obs:.6f}, p {full.p_value:.6f}, "
          f"checkpoint writes {full.timings['checkpoint_s']:.3f} s), resumed after 2 of 5 chunks {t_resumed:.3f} s "
          f"(t_obs {resumed.t_obs:.6f}, checkpoint writes {resumed.timings['checkpoint_s']:.3f} s); t_dist equal: "
          f"{equal} [{card}]", flush=True)
    check(equal and full.t_obs == resumed.t_obs and full.p_value == resumed.p_value,
          "the resumed LRT differs from the uninterrupted one")
    return fit_counts, sim_counts, lrt_counts


def scenario(n=5000):
    """The lrt_512 and lrt_10k scenario (``examples.lrt_10k``): N=5000
    DRW-true data, the DRW null and the DRW + Lorentzian alternative."""
    from mind_the_gaps_tpu_torch.examples import lrt_10k

    return lrt_10k.scenario(n)


def e13_generation_rate(card, dev, n_points=500, B=256):
    """Phase 6: the bench's lognormal (E13) generation
    (``bench.e13_generation_rate``: the tutorial-scale segment, cut 8192) on
    ``dev``; returns the rates of the timed call (generator seed 2) and its
    count of rows that hit max_iter."""
    import torch

    from mind_the_gaps_tpu_torch import bench

    run = bench.e13_generation_rate(n_points, B, device=dev)
    sim, out, elapsed = run["e13_simulator"], run["e13_rates"], run["e13_seconds"]
    check(sim._e13_cut_len == 8192, f"tutorial-scale cut is {sim._e13_cut_len}, not 8192")
    iters = sim._last_e13_iters.float()
    check(out.shape == (B, n_points) and bool(torch.all(torch.isfinite(out))) and bool(torch.all(out > 0)),
          "E13 generation: rates not finite and positive")
    print(f"[e13] lognormal generation n={n_points}, B={B}, cut {sim._e13_cut_len}: {elapsed:.4f} s, "
          f"{run['e13_lognormal_lcs_per_sec']:.1f} lightcurves/s, E13 iterations mean {float(iters.mean()):.1f} "
          f"max {int(iters.max())}, remap launches {run['e13_remap_launches']} [{card}]", flush=True)
    return out, int(torch.sum(sim._last_e13_iters >= sim.max_iter))


def selection_phase(card, lc, latency, reset_counts, read_counts):
    """Phase 11, model selection: ``compare_models`` with the tutorial's four
    candidates (R = 1, 4, 2, 3) on phase 4's N=5000 data, walkers=24,
    max_steps=SELECTION_STEPS, seed=0, on the card.  Each candidate's
    ``max_loglikelihood`` against the plain float64 likelihood on the CPU at
    its ``max_parameters`` (rtol 1e-10), its AICc finite, the Akaike weights
    summing to 1 (1e-12); then the gradient kernel against its plain version
    at the R = 2 and R = 4 MAP-fit shapes (B=1, N=5000, at those candidates'
    ``max_parameters``), beside its latency floor.  Returns (the launch
    counts of ``compare_models``, the two gradient cases)."""
    import numpy as np
    import torch

    from mind_the_gaps_tpu_torch import bench
    from mind_the_gaps_tpu_torch.examples.tutorial_model_selection import candidates
    from mind_the_gaps_tpu_torch.gpmodelling import GPModelling
    from mind_the_gaps_tpu_torch.selection import compare_models

    dev = torch.device("cuda")
    kernels = candidates()
    reset_counts()
    t0 = time.perf_counter()
    results = compare_models(lc, kernels, max_steps=SELECTION_STEPS, walkers=24, seed=0, device="cuda")
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = read_counts()
    total = sum(r.akaike_weight for r in results)
    print(f"[select] compare_models, 4 candidates x 24 walkers, max_steps {SELECTION_STEPS}: {sec:.3f} s, launches = "
          f"{counts}, "
          f"Akaike weights sum to 1 {total - 1.0:+.3e} [{card}]", flush=True)
    widths = {}
    for r in results:
        gp = r.model
        c = gp.kernel.coefficients()
        widths[r.name] = (c.ar.shape[-1], c.ac.shape[-1])
        theta = torch.as_tensor(np.asarray(r.model.max_parameters, dtype=np.float64))
        ll_cpu = float(GPModelling(lc, kernels[r.name], device="cpu").log_prob_batch(theta[None])[0])
        rel = abs(r.max_loglikelihood - ll_cpu) / abs(ll_cpu)
        tm = gp.timings
        print(f"[select] {r.name} (R={widths[r.name][0] + 2 * widths[r.name][1]}, k={r.k}): max loglike "
              f"{r.max_loglikelihood!r}, CPU plain at max_parameters {ll_cpu!r} (rtol {rel:.3e}, 1e-10), AICc "
              f"{r.aicc:.6f}, dAICc {r.delta_aicc:.6f}, weight {r.akaike_weight:.6e}, KS p {r.ks_pvalue:.4f}; "
              f"{gp.sampler.iteration} steps (converged {gp.converged}), MAP fit {tm['map_fit_s']:.3f} s in "
              f"{tm['map_fit_evals']} evaluations ({tm['map_fit_launches']} celerite_grad launches), sampling "
              f"{tm['sampling_s']:.3f} s ({tm['sampling_launches']} celerite launches) [{card}]", flush=True)
        check(rel <= 1e-10, f"{r.name}: max_loglikelihood differs from the CPU's plain likelihood by rtol {rel:.3e}")
        check(math.isfinite(r.aicc), f"{r.name}: AICc not finite")
        check(tm["map_fit_launches"] == tm["map_fit_evals"] > 0 and tm["sampling_launches"] > 0,
              f"{r.name}: the MAP fit or the sampler did not go through the kernels")
    check(abs(total - 1.0) <= 1e-12, f"the Akaike weights sum to {total!r}")
    check(sorted(R for R in (jr + 2 * jc for jr, jc in widths.values())) == [1, 2, 3, 4],
          f"the candidates' widths are {widths}, not R = 1, 2, 3, 4")
    check(counts["celerite_warp"] == sum(r.model.timings["sampling_launches"] for r in results)
          and counts["celerite_grad"] == sum(r.model.timings["map_fit_launches"] for r in results),
          "compare_models launched kernels that its models did not count")

    t = torch.as_tensor(lc.times, device=dev)
    y = torch.as_tensor(lc.y, dtype=torch.float64, device=dev)
    diag = torch.as_tensor((lc.dy + 1e-12) ** 2, dtype=torch.float64, device=dev)
    cases = []
    for name in ("Matern32", "SHO"):
        r = next(r for r in results if r.name == name)
        th = torch.as_tensor(np.asarray(r.model.max_parameters, dtype=np.float64)[None], device=dev)
        a = dict(coeffs=r.model.kernel.coefficients(th), t=t, y=y, diag=diag, extra_diag=r.model.kernel.jitter(th),
                 mean=torch.full((1,), float(lc.mean), dtype=torch.float64, device=dev))
        jr, jc = widths[name]
        case = grad_case(card, f"{name} MAP-fit shape: B=1 N=5000 R={jr + 2 * jc}", a)
        case["floor_ms"] = bench.latency_floor_ms(case, latency["float64"], 2)
        print(f"[floor] celerite_grad {case['name']}: latency floor {case['floor_ms']:.4f} ms (chain depth "
              f"{bench.chain_depth(jr, jc)}), kernel {case['ms']:.3f} ms = {case['ms'] / case['floor_ms']:.2f}x the floor "
              f"[{card}]", flush=True)
        cases.append(case)
    return counts, cases


def fit_device_phase(card, lc, null, alt):
    """Phase 11, ``fit_device`` (torch.optim.LBFGS on the card) against
    ``fit()`` (scipy's L-BFGS-B on the host, objective on the card) for phase
    4's null and alternative: nll within 1e-3, the JAX package's contract;
    both one gradient-kernel launch an evaluation; the null fitted twice,
    the second time with the same bits."""
    import numpy as np
    import torch

    from mind_the_gaps_tpu_torch.gpmodelling import GPModelling

    for name, kernel in (("null", null), ("alt", alt)):
        host, dev = GPModelling(lc, kernel, device="cuda"), GPModelling(lc, kernel, device="cuda")
        t0 = time.perf_counter()
        sol = host.fit()
        t_fit = time.perf_counter() - t0
        t0 = time.perf_counter()
        params, nll = dev.fit_device()
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        d = abs(nll - sol.fun)
        print(f"[fit_device] {name}: fit_device nll {nll!r} in {t_dev:.3f} s, {dev.timings['map_fit_evals']} "
              f"evaluations ({dev.timings['map_fit_launches']} launches), params {params}; fit() nll {sol.fun!r} in "
              f"{t_fit:.3f} s, {host.timings['map_fit_evals']} evaluations, params {sol.x}; |d nll| {d:.3e} (1e-3) "
              f"[{card}]", flush=True)
        check(d < 1e-3, f"fit_device's {name} nll is {d:.3e} from fit()'s")
        check(dev.timings["map_fit_launches"] == dev.timings["map_fit_evals"] > 0,
              "fit_device did not evaluate through the gradient kernel")
        if name == "null":  # the process's first optimizer step pays a one-time set-up: time a second fit
            t0 = time.perf_counter()
            again = GPModelling(lc, kernel, device="cuda").fit_device()
            torch.cuda.synchronize()
            print(f"[fit_device] null again: {time.perf_counter() - t0:.3f} s, nll {again[1]!r} [{card}]", flush=True)
            check(again[1] == nll and np.array_equal(again[0], params), "a second fit_device gave other bits")


def periodogram_phase(card, lc):
    """Phase 11, the Lomb-Scargle periodogram on the card at phase 4's
    N=5000 over ``autofrequency``'s grid (F = 62,500), with dy: every
    normalization within 1e-9 x max(power) of the same function on CPU
    tensors, its time from CUDA events and its peak memory; the 1%
    false-alarm level from the card's tensors equal to the CPU's."""
    import numpy as np
    import torch

    from mind_the_gaps_tpu_torch.periodogram import (
        NORMALIZATIONS,
        autofrequency,
        default_chunk,
        lomb_scargle,
        ls_false_alarm_level,
    )

    dev = torch.device("cuda")
    freqs = autofrequency(lc.times)
    n = lc.n
    check(freqs.size == 62_500, f"autofrequency gives {freqs.size} frequencies, not 62,500")
    card_in = [torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev) for a in (lc.times, lc.y, freqs, lc.dy)]
    cpu_in = [a.cpu() for a in card_in]
    standard = None
    for norm in NORMALIZATIONS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        power = lomb_scargle(*card_in[:3], dy=card_in[3], normalization=norm)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ms = cuda_ms(lambda: lomb_scargle(*card_in[:3], dy=card_in[3], normalization=norm), reps=3)
        t0 = time.perf_counter()
        ref = lomb_scargle(*cpu_in[:3], dy=cpu_in[3], normalization=norm)
        cpu_s = time.perf_counter() - t0
        err, scale = float((power.cpu() - ref).abs().max()), float(ref.abs().max())
        print(f"[periodogram] {norm}: F={freqs.size} x N={n} f64 in chunks of {default_chunk(n)} frequencies, card "
              f"{ms:.3f} ms, CPU {cpu_s:.3f} s; max abs diff {err:.3e} = {err / scale:.3e} of max(power) (1e-9); "
              f"max_memory_allocated {peak / 2**20:.1f} MiB ({(peak - before) / 2**20:.1f} MiB above the inputs) "
              f"[{card}]", flush=True)
        check(bool(torch.isfinite(power).all()) and err <= 1e-9 * scale,
              f"lomb_scargle ({norm}) on the card differs from the CPU's by {err / scale:.3e} of max(power)")
        if norm == "standard":
            standard = power
    z_card = ls_false_alarm_level(0.01, n, card_in[2], card_in[0])
    z_cpu = ls_false_alarm_level(0.01, n, freqs, lc.times)
    above = int((standard > z_card).sum())
    print(f"[periodogram] 1% false-alarm level {z_card!r} (CPU {z_cpu!r}); {above} frequencies above it, peak "
          f"power {float(standard.max()):.6f} at {freqs[int(standard.argmax())]:.6e} [{card}]", flush=True)
    check(z_card == z_cpu, "the false-alarm level from the card's tensors differs from the CPU's")


def mesh_phase(card, lc, null, alt, res):
    """Phase 12, the mesh: the refits of phase 4's chunk shape (512
    simulations from phase 4's null posterior + the observed row, 12
    walkers, 500 steps, float32, (0.01, 50) early stop, the DRW+QPO
    alternative) by ``batched_max_loglike`` unsharded, "gspmd" and
    "shard_map" over the mesh of the visible cards (two shards on this card
    when it is the only one), host-clocked around synchronised calls in
    turns; the gspmd result must equal the unsharded one (``torch.equal``),
    each shard_map shard its own unsharded run; then a 200-step
    ``derive_posteriors`` of the alternative at 32 walkers over the mesh
    must equal the unsharded chain bit for bit.  Returns the refits' inputs
    (host arrays) and the shard_map result, for phase 13."""
    import numpy as np
    import torch

    from mind_the_gaps_tpu_torch.gpmodelling import GPModelling
    from mind_the_gaps_tpu_torch.lrt import _alt_theta0_rows, _derived_generator, batched_max_loglike
    from mind_the_gaps_tpu_torch.ops.celerite import batch_team
    from mind_the_gaps_tpu_torch.parallel import Mesh, default_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    n_cards = torch.cuda.device_count()
    mesh = default_mesh() if n_cards >= 2 else Mesh((dev, dev))
    print(f"[mesh] torch.cuda.device_count() = {n_cards}; mesh of {mesh.size} shards on "
          f"{[str(d) for d in mesh.devices]} ({'every visible card' if n_cards >= 2 else 'two shards on one card'})",
          flush=True)

    samples = torch.as_tensor(np.asarray(res.null_model.mcmc_samples, dtype=np.float64), device=dev)
    idx = torch.randint(0, samples.shape[0], (513,), generator=torch.Generator(dev).manual_seed(1), device=dev)
    params = samples[idx]
    rates, dys = res.null_model.make_device_generator("Gaussian")(params[:512], _derived_generator(dev, 1, 0))
    rates = torch.cat([rates, torch.as_tensor(lc.y, device=dev)[None]])
    diags = (torch.cat([dys, torch.as_tensor(lc.dy, device=dev)[None]]) + 1e-12) ** 2
    starts = _alt_theta0_rows(null, alt, params[:, : null.ndim].cpu().numpy())
    t64 = torch.as_tensor(np.asarray(lc.times, dtype=np.float64), device=dev)

    def sync():
        for d in set(mesh.devices):
            torch.cuda.synchronize(d)

    def refit(rows, m, spmd, gen, device=dev):
        sync()
        c = time.perf_counter()
        out = batched_max_loglike(alt, t64.to(device), rates[rows].to(device), diags[rows].to(device), starts[rows],
                                  walkers=12, n_steps=500, dtype=torch.float32, early_stop=(0.01, 50), generator=gen,
                                  mesh=m, spmd=spmd)
        sync()
        return out, time.perf_counter() - c, list(batched_max_loglike.shard_launches)

    every = slice(None)
    sm_gens = [_derived_generator(d, 0, 0, k) for k, d in enumerate(mesh.devices)]
    runs = {}
    for name in ("unsharded", "gspmd", "shard_map", "gspmd", "unsharded"):
        m, spmd = (None, "gspmd") if name == "unsharded" else (mesh, name)
        gen = sm_gens if name == "shard_map" else _derived_generator(dev, 0, 0, 1)
        out, sec, launches = refit(every, m, spmd, gen)
        runs.setdefault(name, []).append((out, sec, launches))
        print(f"[mesh] batched_max_loglike {name}: {sec:.3f} s, launches a shard {launches} [{card}]", flush=True)
    ref = runs["unsharded"][0][0]
    check(torch.equal(runs["unsharded"][1][0][0], ref[0]), "two unsharded refits differ")
    for (lp, x), _, _ in runs["gspmd"]:
        check(torch.equal(lp, ref[0]) and torch.equal(x, ref[1]),
              "the gspmd refits over the mesh differ from the unsharded refits")
    (sm_lp, sm_x), _, sm_launches = runs["shard_map"][0]
    check(bool(torch.isfinite(sm_lp).all()), "the shard_map refits are not finite")
    for k, rows in enumerate(torch.tensor_split(torch.arange(513), mesh.size)):
        r = slice(int(rows[0]), int(rows[-1]) + 1)
        (lp, x), _, launches = refit(r, None, "gspmd", _derived_generator(mesh.devices[k], 0, 0, k), mesh.devices[k])
        check(torch.equal(lp.to(dev), sm_lp[r]) and torch.equal(x.to(dev), sm_x[r]) and launches[0] == sm_launches[k],
              f"shard_map shard {k} differs from the unsharded run of its rows with its generator")
    med = {name: sorted(sec for _, sec, _ in v)[len(v) // 2] for name, v in runs.items()}
    diff = (sm_lp.double() - ref[0].double()).abs()
    print(f"[mesh] refits 513 x 12 walkers, N={lc.n}, float32, layout {batch_team(alt, 513 * 6, dev)} lanes: "
          f"unsharded {[round(s, 3) for _, s, _ in runs['unsharded']]} s, gspmd "
          f"{[round(s, 3) for _, s, _ in runs['gspmd']]} s ({med['gspmd'] / med['unsharded']:.3f}x), shard_map "
          f"{runs['shard_map'][0][1]:.3f} s; gspmd equal to unsharded (torch.equal), each shard_map shard equal to "
          f"its own run; |shard_map - gspmd| best loglike (other random streams): median "
          f"{float(diff.median()):.4f}, max {float(diff.max()):.4f} [{card}]", flush=True)

    init = GPModelling(lc, alt, device=dev).spread_walkers(
        32, res.alt_model.max_parameters, np.array(alt.get_parameter_bounds(), dtype=object),
        rng=np.random.default_rng(12))
    chains = []
    for m in (mesh, None):
        gp = GPModelling(lc, alt, device=dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # a 200-step chain does not converge
            gp.derive_posteriors(initial_chain_params=init, max_steps=200, convergence_steps=100, walkers=32,
                                 seed=12, mesh=m)
        sync()
        chains.append(gp)
        print(f"[mesh] derive_posteriors 32 walkers x 200 steps, {'mesh' if m else 'unsharded'}: sampling "
              f"{gp.timings['sampling_s']:.3f} s, {gp.timings['mesh_shards']} shard(s), launches a shard "
              f"{gp.timings['shard_launches']} [{card}]", flush=True)
    a, b = chains
    check(a.timings["mesh_shards"] == mesh.size and min(a.timings["shard_launches"]) > 0,
          "a shard of the mesh-mode observed fit did not evaluate")
    check(np.array_equal(a.sampler.get_chain(), b.sampler.get_chain())
          and np.array_equal(a.sampler.get_log_prob(), b.sampler.get_log_prob())
          and np.array_equal(a.mcmc_samples, b.mcmc_samples),
          "the mesh-mode chain differs from the unsharded chain")
    print("[mesh] the mesh-mode chain, log-probabilities and samples equal the unsharded run's bit for bit",
          flush=True)
    return dict(t64=t64.cpu().numpy(), rates=rates.cpu().numpy(), diags=diags.cpu().numpy(), starts=starts,
                sm_lp=sm_lp.cpu().numpy(), sm_x=sm_x.cpu().numpy(), size=mesh.size)


def processes_phase(card, lc, null, alt, res, mesh_run, e13_run, workdir, nsims):
    """Phase 13, processes: phase 4's bootstrap (its fitted posteriors passed
    through files in ``workdir``), phase 12's shard_map refits and phase 6's
    E13 generation across ``max(2, device_count)`` ranks, one process each
    (``chip_smoke.py --rank-of W``: torch.distributed, gloo, a card a rank,
    both on the one card when there is one), each equal to its one-process
    run bit for bit (the E13 generation: to this process's over phase 12's
    mesh, whose positions hold the ranks' rows); before them, in this
    process, phase 4's bootstrap over phase 12's one-process mesh, equal to
    phase 4 too.  Returns the launch counts of the ranks (summed) and of the
    one-process mesh run."""
    import os
    import socket

    import numpy as np
    import torch

    from mind_the_gaps_tpu_torch import bench
    from mind_the_gaps_tpu_torch.lrt import protassov_lrt
    from mind_the_gaps_tpu_torch.parallel import Mesh, default_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    n_cards = torch.cuda.device_count()
    world = max(2, n_cards)
    res.null_model.save_posteriors(workdir / "null.npz")
    res.alt_model.save_posteriors(workdir / "alt.npz")
    np.savez(workdir / "mesh_inputs.npz", **{k: mesh_run[k] for k in ("t64", "rates", "diags", "starts")})

    def same_lrt(other, what):
        check(np.array_equal(other.t_dist, res.t_dist) and other.t_obs == res.t_obs and other.p_value == res.p_value
              and other.t_obs_posterior == res.t_obs_posterior, f"{what}: T, t_obs or p differ from phase 4's")

    # PR 8's way: phase 4's bootstrap over a mesh of this one process
    mesh = default_mesh() if n_cards >= 2 else Mesh((dev, dev))
    reset_counts()
    torch.cuda.synchronize()
    clock = time.perf_counter()
    one = protassov_lrt(lc, null, alt, nsims=nsims, seed=0, null_model=res.null_model, alt_model=res.alt_model,
                        sim_max_steps=500, sim_walkers=12, chunk=512, device="cuda", mesh=mesh)
    for d in set(mesh.devices):
        torch.cuda.synchronize(d)
    one_s, one_counts = time.perf_counter() - clock, read_counts()
    same_lrt(one, "the bootstrap over the one-process mesh")
    print(f"[processes] one process, mesh of {mesh.size} on {[str(d) for d in mesh.devices]}: bootstrap "
          f"{one_s:.3f} s (generation {one.timings['generation_s']:.3f}, refits {one.timings['refits_s']:.3f}, refine "
          f"{one.timings['refine_s']:.3f}), launches {one_counts}; T, t_obs and p equal phase 4's (refits there "
          f"{res.timings['refits_s']:.3f} s on one card) [{card}]", flush=True)

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, logs = [], []
    try:
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            logs.append(open(workdir / f"rank{rank}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-of", str(world), "--workdir", str(workdir),
                 "--nsims", str(nsims)], env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        for rank, proc in enumerate(procs):
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {rank} did not finish within {RANKS_TIMEOUT_S} s") from None
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    for rank, proc in enumerate(procs):
        text = (workdir / f"rank{rank}.log").read_text()
        for line in text.splitlines():
            if line.startswith("[rank"):
                print(line, flush=True)
        check(proc.returncode == 0, f"rank {rank} of {world} failed (exit {proc.returncode}):\n{text[-4000:]}")

    reports = [json.loads((workdir / f"rank{rank}.json").read_text()) for rank in range(world)]
    with np.load(workdir / "rank0.npz") as d:
        out = {k: d[k] for k in d.files}
    check(np.array_equal(out["t_dist"], res.t_dist)
          and [float(v) for v in out["scalars"]] == [res.t_obs, res.p_value, res.t_obs_posterior],
          f"the bootstrap across {world} ranks: T, t_obs or p differ from phase 4's")
    check(np.array_equal(out["sm_lp"], mesh_run["sm_lp"]) and np.array_equal(out["sm_x"], mesh_run["sm_x"]),
          f"the shard_map refits across {world} ranks differ from phase 12's over {mesh_run['size']} shards")
    # E13: the ranks against this process over a mesh of as many positions (the same rows a transform), bit for
    # bit; and against phase 6's unsharded call
    sim, psd = bench.e13_problem(dev)
    one_e13 = sim.simulate_batch(psd, generator=torch.Generator(dev).manual_seed(2), mesh=mesh,
                                 warn_nonconverged=False).cpu().numpy()
    one_nonconv = sim.report_nonconverged(warn=False)
    check(np.array_equal(out["e13_rates"], one_e13) and int(out["e13_nonconv"]) == one_nonconv,
          f"the E13 generation across {world} ranks differs from this process's over a mesh of {mesh.size}")
    # where a block's rows can round otherwise: each step of the generation on a block of the batch's rows
    # against those rows of the whole batch
    from mind_the_gaps_tpu_torch.simulator import downsample_cumsum, tk95_rates

    normals = torch.randn(psd.shape[:-1] + (2, sim.fftndatapoints // 2 + 1), dtype=psd.dtype, device=dev,
                          generator=torch.Generator(dev).manual_seed(3))
    m = sim._e13_cut_len
    starts, ends = (torch.as_tensor(w, device=dev) for w in (sim._win_starts, sim._win_ends))
    steps = {
        "TK95 irfft f64": lambda rows: tk95_rates(psd[rows], sim.fftndatapoints, sim.sim_dt, normals=normals[rows]),
        "row mean f64": lambda rows: steps["TK95 irfft f64"](rows).mean(dim=-1),
        "segment std f64": lambda rows: steps["TK95 irfft f64"](rows)[:, :m].std(dim=-1, correction=0),
        "E13 rfft f32": lambda rows: torch.fft.rfft(steps["TK95 irfft f64"](rows)[:, :m].float(), dim=-1),
        "E13 irfft f32": lambda rows: torch.fft.irfft(steps["E13 rfft f32"](rows), n=m, dim=-1),
        "downsample f64": lambda rows: downsample_cumsum(steps["TK95 irfft f64"](rows)[:, :m], starts, ends),
    }
    differ = set()
    for block in (128, 64):
        same = {}
        for name, step in steps.items():
            a, b = step(slice(None))[:block], step(slice(0, block))
            same[name] = "equal" if torch.equal(a, b) else f"max |diff| {float((a - b).abs().max()):.3e}"
            if same[name] != "equal":
                differ.add(name)
        print(f"[processes] generation steps, a {block}-row batch against those rows of the {psd.shape[0]}-row "
              f"batch: {same} [{card}]", flush=True)
    check("downsample f64" not in differ, "downsample_cumsum rounds a block of the batch otherwise")
    e13_rates, e13_nonconv = e13_run
    e13_diff = np.abs(out["e13_rates"] - e13_rates.cpu().numpy())
    print(f"[processes] E13 ({len(e13_diff)} rows, {-(-len(e13_diff) // world)} a rank) across {world} ranks: equal "
          f"to this process's over a mesh of {mesh.size} bit for bit; against phase 6's unsharded call "
          f"{int((e13_diff.max(1) > 0).sum())} rows differ, max |diff| {float(e13_diff.max()):.3e}, non-converged "
          f"{int(out['e13_nonconv'])} against {e13_nonconv} [{card}]", flush=True)
    if differ:  # a transform or reduction of the card that rounds a block otherwise: reported, not gated
        print(f"[processes] E13 against phase 6's unsharded call not gated: the steps {sorted(differ)} round a block "
              f"of the batch otherwise [{card}]", flush=True)
    else:
        check(np.array_equal(out["e13_rates"], e13_rates.cpu().numpy()) and int(out["e13_nonconv"]) == e13_nonconv,
              f"the E13 generation across {world} ranks differs from phase 6's unsharded call")
    for rep_ in reports:
        timings = rep_["timings"]
        print(f"[processes] rank {rep_['rank']} of {world} on {rep_['device']}: bootstrap "
              f"{rep_['bootstrap_s']:.3f} s (generation {timings['generation_s']:.3f}, refits "
              f"{timings['refits_s']:.3f}, refine {timings['refine_s']:.3f}) launches {rep_['bootstrap']}; shard_map "
              f"{rep_['shard_map_s']:.3f} s launches {rep_['shard_map']}; E13 {rep_['e13_s']:.4f} s launches "
              f"{rep_['e13']}; process_any {rep_['process_any_us']:.1f} us a call [{card}]", flush=True)
    print(f"[processes] {nsims}-simulation bootstrap: refits {res.timings['refits_s']:.3f} s on one card (phase 4), "
          f"{one.timings['refits_s']:.3f} s over the one-process mesh of {mesh.size}, "
          f"{[round(r['timings']['refits_s'], 3) for r in reports]} s across {world} ranks; T, t_obs and p equal "
          f"phase 4's, shard_map equal to phase 12's, E13 equal to the one-process mesh's, bit for bit [{card}]",
          flush=True)
    ranks_counts = {k: sum(r[part][k] for r in reports for part in ("bootstrap", "shard_map", "e13"))
                    for k in one_counts}
    return ranks_counts, one_counts


def rank_main(args):
    """One rank of phase 13 (``--rank-of W``): joins the group from the
    environment phase 13 sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT) on its card, runs phase 4's bootstrap, phase 12's shard_map
    refits and phase 6's E13 generation over the processes' mesh, writes its
    seconds and launches to ``rank<r>.json`` and rank 0 the results to
    ``rank0.npz`` in ``--workdir``."""
    import numpy as np
    import torch

    from mind_the_gaps_tpu_torch import bench
    from mind_the_gaps_tpu_torch.gpmodelling import GPModelling
    from mind_the_gaps_tpu_torch.lrt import _derived_generator, batched_max_loglike, protassov_lrt
    from mind_the_gaps_tpu_torch.parallel import initialize, process_any, process_mesh, shutdown

    check(torch.cuda.is_available(), "no CUDA device: a rank of phase 13 runs on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(args.workdir)
    dev = initialize()
    mesh = process_mesh()
    rank = mesh.process_index
    check(mesh.process_count == args.rank_of, f"the group has {mesh.process_count} ranks, not {args.rank_of}")
    report = {"rank": rank, "device": str(dev)}

    def timed(name, fn):
        reset_counts()
        torch.cuda.synchronize(dev)
        clock = time.perf_counter()
        result = fn()
        torch.cuda.synchronize(dev)
        report[name + "_s"], report[name] = time.perf_counter() - clock, read_counts()
        print(f"[rank {rank}] {name}: {report[name + '_s']:.3f} s on {dev}, launches {report[name]}", flush=True)
        return result

    lc, null, alt = scenario()
    models = []
    for kernel, name in ((null, "null"), (alt, "alt")):
        models.append(GPModelling(lc, kernel, device=dev))
        models[-1].load_posteriors(work / f"{name}.npz")
    res = timed("bootstrap", lambda: protassov_lrt(
        lc, null, alt, nsims=args.nsims, seed=0, null_model=models[0], alt_model=models[1], sim_max_steps=500,
        sim_walkers=12, chunk=512, device="cuda", mesh=mesh))
    report["timings"] = res.timings

    with np.load(work / "mesh_inputs.npz") as d:  # host arrays: a rank moves only its own rows to its card
        t64, rates, diags, starts = (torch.as_tensor(d[k]) for k in ("t64", "rates", "diags", "starts"))
    gens = [_derived_generator(d, 0, 0, k) for k, d in zip(mesh.local_positions, mesh.devices)]
    sm_lp, sm_x = timed("shard_map", lambda: batched_max_loglike(
        alt, t64, rates, diags, starts, walkers=12, n_steps=500, dtype=torch.float32, early_stop=(0.01, 50),
        generator=gens, mesh=mesh, spmd="shard_map"))

    sim, psd = bench.e13_problem(dev)
    e13 = timed("e13", lambda: sim.simulate_batch(psd, generator=torch.Generator(dev).manual_seed(2), mesh=mesh,
                                                  warn_nonconverged=False))
    nonconv = sim.report_nonconverged(warn=False)
    check(e13.shape == (256, 500) and bool(torch.isfinite(e13).all()), "the E13 rates are not finite")
    check("jax" not in sys.modules, "the port imported jax")

    # the cost of the early stop's collective alone, one a refit step
    calls = 1000
    clock = time.perf_counter()
    for i in range(calls):
        process_any(i == calls - 1 and rank == 0)
    report["process_any_us"] = (time.perf_counter() - clock) / calls * 1e6
    print(f"[rank {rank}] process_any (gloo all_reduce of one int): {report['process_any_us']:.1f} us a call over "
          f"{calls} calls", flush=True)

    (work / f"rank{rank}.json").write_text(json.dumps(report))
    if rank == 0:
        np.savez(work / "rank0.npz", t_dist=res.t_dist,
                 scalars=np.array([res.t_obs, res.p_value, res.t_obs_posterior]), sm_lp=sm_lp.cpu().numpy(),
                 sm_x=sm_x.cpu().numpy(), e13_rates=e13.cpu().numpy(),
                 e13_nonconv=np.int64(nonconv))
    shutdown()


def validation_phase(card):
    """Phase 14, the validation programs (``mind_the_gaps_tpu_torch.examples``)
    in this process through their ``run()``, at the JAX scripts' widths
    (float32 refits, 12 walkers, 300 steps, early stop (0.01, 50)).  Returns
    each check's launch counts."""
    import numpy as np

    from mind_the_gaps_tpu_torch.examples import (
        study_celerite_variance,
        study_lomb_scargle_biases,
        study_poisson_level,
        tutorial_ppp,
        validation_detection_power,
        validation_full_pipeline_calibration,
        validation_pvalue_calibration,
    )
    from mind_the_gaps_tpu_torch.gpmodelling import GPModelling

    counts = {}

    def counted(label, fn):
        reset_counts()
        clock = time.perf_counter()
        out = fn()
        counts[label] = read_counts()
        print(f"[validation] ({label}) {time.perf_counter() - clock:.3f} s, launches {counts[label]} [{card}]",
              flush=True)
        return out

    def exact_pvalues(out, nsims, what):
        p, t = np.asarray(out["p_values"]), np.asarray(out["t_obs"])
        check(bool(np.all(np.isfinite(t))) and bool(np.all(np.isfinite(out["t_sim"]))), f"{what}: T not finite")
        check(bool(np.all(p >= 1.0 / (nsims + 1))) and bool(np.all(p <= 1.0)),
              f"{what}: a p-value outside [1/{nsims + 1}, 1]")

    # (a) the batched Gaussian calibration at PARITY's size
    a = counted("a", lambda: validation_pvalue_calibration.run(k=32, nsims=127, n=400, device="cuda"))
    exact_pvalues(a, 127, "(a)")
    print(f"[validation] (a) Gaussian calibration, K=32 x 127, n=400: KS D = {a['ks_d']:.6f}, p = {a['ks_p']:.6f}; "
          f"T_obs median {np.median(a['t_obs']):.6f}; p-values {np.round(np.sort(a['p_values']), 4).tolist()} "
          f"[{card}]", flush=True)
    check(a["ks_p"] >= 0.001, f"(a) the p-values are not uniform: KS p {a['ks_p']} < 0.001")

    # (b) the batched lognormal calibration at the 16384 cut, the sort kernels required
    b = counted("b", lambda: validation_pvalue_calibration.run(k=16, nsims=63, n=850, pdf="Lognormal",
                                                               require_kernel=True, device="cuda"))
    exact_pvalues(b, 63, "(b)")
    for label, stage in b["e13"].items():
        print(f"[validation] (b) {label}: cut {stage['cut_len']}, tier {stage['tier']}, rank_remap launches "
              f"{stage['rank_remap']}, sort_kv launches {stage['sort_kv']}", flush=True)
        check(stage["cut_len"] == 16384 and stage["tier"] == ["tile", 1],
              f"(b) {label}: cut {stage['cut_len']} in tier {stage['tier']}, not 16384 in the one-CTA tier")
    print(f"[validation] (b) lognormal calibration, K=16 x 63, n=850: KS D = {b['ks_d']:.6f}, p = {b['ks_p']:.6f} "
          f"[{card}]", flush=True)

    # (c) the power curve at PARITY's strengths
    amps = (0.0, 0.02, 0.05, 0.1, 0.25)
    cc = counted("c", lambda: validation_detection_power.run(amps=amps, k=16, nsims=127, device="cuda"))
    check(bool(np.all(np.isfinite(cc["p_values"]))), "(c) p-values not finite")
    for r in cc["results"]:
        print(f"[validation] (c) a = {r['amp']}: detection fraction (p <= 0.05) {r['detect_frac_p05']:.4f}, median p "
              f"{r['median_p']:.4f}, median T_obs {r['median_T_obs']:.4f} [{card}]", flush=True)
    top = cc["results"][-1]["detect_frac_p05"]
    check(top >= 0.9, f"(c) the detection fraction at a = 0.25 is {top} < 0.9")

    # (d) the full pipeline, Gaussian
    d = counted("d", lambda: validation_full_pipeline_calibration.run(
        k=4, observed_max_steps=VALIDATION_D_OBSERVED_STEPS, device="cuda"))
    p, t = np.asarray(d["p_values"]), np.asarray(d["t_obs"])
    check(bool(np.all(np.isfinite(t))) and bool(np.all((p >= 0.0) & (p <= 1.0))), "(d) a T_obs or p out of range")
    print(f"[validation] (d) full pipeline, K=4 x 127: p {p.tolist()}, T_obs {t.tolist()}, observed chains converged "
          f"(null, alt) {d['converged']}, KS p {d['ks_p']:.6f} [{card}]", flush=True)

    # (e) the tutorial's LRT with the QPO injected, on the JAX script's seed-42 realization (its Poisson counts);
    # the QPO's power falls in one or two Fourier bins, so a realization may carry little of it: this card's own
    # seed-42 realization must be the committed one, whose MAP T the tests hold against the JAX package's
    e = counted("e", lambda: tutorial_ppp.run(nsims=255, qpo=True, max_steps=VALIDATION_E_OBSERVED_STEPS,
                                              device="cuda", counts=tutorial_ppp.reference_counts()))
    print(f"[validation] (e) tutorial_ppp --qpo on the JAX script's realization, 255 simulations: T_obs "
          f"{e['t_obs']:.6f} (posterior chain {e['t_obs_posterior']:.6f}), T_dist median {e['t_dist_median']:.6f}, 99th "
          f"percentile {e['t_dist_p99']:.6f}, p {e['p_value']:.6f}, converged {e['converged']} [{card}]", flush=True)
    check(math.isfinite(e["t_obs"]) and e["p_value"] <= 0.01, f"(e) the injected QPO not detected: p {e['p_value']}")
    own = tutorial_ppp.make_lightcurve(with_qpo=True, device="cuda", noise_seed=42)
    with np.load(tutorial_ppp.COUNTS) as f:
        check(np.array_equal(own.y, f["h100_seed42"] / tutorial_ppp.EXPOSURE),
              "(e) this card's seed-42 realization is not the committed h100_seed42")
    fits = [GPModelling(own, kernel, device="cuda").fit() for kernel in tutorial_ppp.kernels()]
    print(f"[validation] (e) this card's own seed-42 realization (= h100_seed42): MAP fits' T "
          f"{2 * (fits[0].fun - fits[1].fun):.6f}, the alternative's QPO at log_Q {fits[1].x[3]:.4f}, log_omega0 "
          f"{fits[1].x[4]:.4f} (injected: log_omega0 {math.log(2 * math.pi / (10 * tutorial_ppp.DAY)):.4f}) [{card}]",
          flush=True)

    # (f) the convention studies, with their own assertions
    for study in (study_celerite_variance, study_poisson_level, study_lomb_scargle_biases):
        name = study.__name__.rsplit(".", 1)[-1]
        out = counted(f"f {name}", lambda: study.run(device="cuda"))
        print(f"[validation] (f) {name}: {out} [{card}]", flush=True)
    return counts


def cumsum_bootstrap_moves(card, lc, null, alt, res):
    """Phase 4's bootstrap again on its fitted models with the JAX package's
    downsampling (differences of cumulative sums, ``torch.cumsum`` along the
    row, which on the card rounds a row by its batch) in place of the
    port's ordered window sums: how many of the T values and which of t_obs
    and p that choice moves (printed, not gated)."""
    import numpy as np
    import torch

    from mind_the_gaps_tpu_torch.lrt import protassov_lrt
    from mind_the_gaps_tpu_torch.simulator import core

    def by_cumsum(segment_rates, starts, ends):
        cs = torch.cumsum(segment_rates, dim=-1)
        cs = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)
        return (cs[..., ends] - cs[..., starts]) / (ends - starts).to(segment_rates.dtype)

    ordered, core.downsample_cumsum = core.downsample_cumsum, by_cumsum
    try:
        other = protassov_lrt(lc, null, alt, nsims=len(res.t_dist), seed=0, null_model=res.null_model,
                              alt_model=res.alt_model, sim_max_steps=500, sim_walkers=12, chunk=512, device="cuda")
    finally:
        core.downsample_cumsum = ordered
    diff = np.abs(other.t_dist - res.t_dist)
    print(f"[main] the bootstrap with cumulative-sum downsampling (the JAX package's): {int(np.sum(diff > 0))} of "
          f"{len(diff)} T differ, max |diff| {float(diff.max()):.3e}; t_obs {other.t_obs:.6f} ("
          f"{'equal' if other.t_obs == res.t_obs else 'differs'}), p {other.p_value:.6f} ("
          f"{'equal' if other.p_value == res.p_value else 'differs'}) [{card}]", flush=True)


def lrt_10k_phase(card, res):
    """Phase 15, the production bootstrap: ``examples.lrt_10k.run`` with
    10,000 simulations in chunks of 512 (the last 272 + the observed row),
    12 walkers x 500 steps, float32 refits with the float64 refine, on phase
    4's fitted observed models (``res``).  Returns its launch counts."""
    import numpy as np
    import torch
    from scipy.stats import ks_2samp

    from mind_the_gaps_tpu_torch.examples import lrt_10k
    from mind_the_gaps_tpu_torch.ops.celerite import batch_team

    nsims, chunk, walkers = 10_000, 512, 12
    reset_counts()
    out = lrt_10k.run(nsims=nsims, chunk=chunk, sim_steps=500, sim_walkers=walkers, pdf="Gaussian", seed=0,
                      device="cuda", null_model=res.null_model, alt_model=res.alt_model)
    torch.cuda.synchronize()
    counts = read_counts()
    lc, null, alt = scenario()
    last_rows = nsims + 1 - (out["chunks"] - 1) * chunk
    # the layouts of the refits' launches (rows x half the walkers a launch): a whole chunk's and the last one's
    lanes = {(name, rows): batch_team(k, rows * (walkers // 2), "cuda") for name, k in (("null", null), ("alt", alt))
             for rows in (chunk, last_rows)}
    t_dist = out["t_dist"]
    ks = ks_2samp(res.t_dist, t_dist)
    for key, sec in out["timings"].items():
        print(f"[lrt_10k] {key} = {sec:.3f}", flush=True)
    print(f"[lrt_10k] {nsims} simulations in {out['chunks']} chunks of {chunk} (the last {last_rows} rows with the "
          f"observed one; lanes of the refit launches by (model, rows) {lanes}): {out['value']:.3f} s, "
          f"t_obs = {out['t_obs']:.6f}, p_value = {out['p_value']:.6f}, t_obs_posterior = "
          f"{out['t_obs_posterior']:.6f} (phase 4's {res.t_obs_posterior:.6f}), T median {np.median(t_dist):.6f}, "
          f"99th percentile {np.percentile(t_dist, 99):.6f}; KS against phase 4's {len(res.t_dist)} T: D = "
          f"{ks.statistic:.6f}, p = {ks.pvalue:.6f}; launches = {counts} [{card}]", flush=True)
    check(t_dist.shape == (nsims,) and bool(np.all(np.isfinite(t_dist))), "lrt_10k: t_dist not finite")
    check(0.0 <= out["p_value"] <= 1.0, f"lrt_10k: p-value {out['p_value']} outside [0, 1]")
    check(out["t_obs_posterior"] == res.t_obs_posterior,
          "lrt_10k: t_obs_posterior differs from phase 4's (the same observed models)")
    key = {32: "celerite_warp", 8: "celerite_split", 1: "celerite_lane"}
    check(counts["celerite_warp"] > 0 and all(counts[key[team]] > 0 for team in lanes.values()),
          f"lrt_10k: the bootstrap did not launch the celerite kernel with a warp (the refine) and the refits' "
          f"layouts {lanes}: {counts}")
    check(ks.pvalue >= 0.001, f"lrt_10k: its T distribution differs from phase 4's (KS p {ks.pvalue} < 0.001)")
    check("jax" not in sys.modules, "the port imported jax")
    return counts


def bench_phase(card, latency):
    """Phase 16, the port's bench (``mind_the_gaps_tpu_torch.bench``, the JAX
    repo's ``bench.py``): the primary metric at its size (65,536 rows x
    N=5000, float32, one shared data column, with the bench's two gates), the
    bootstrap chunk (512 x 12 walkers x BENCH_BOOT_STEPS steps, null and
    alternative) and a BENCH_DP_STEPS-step x 32-walker ``derive_posteriors``;
    returns their launch counts.  Then, outside the count: the kernel's values
    on the first 1,024 rows against its plain version (rtol 1e-4, atol 1e-2),
    and the three layouts (32, 8 and 1 lanes a likelihood,
    ``ops.celerite._launch``) at the primary shape, equal to the 8-lane
    layout within that tolerance, timed in turns beside the bound and the
    latency floor (``latency``: phase 3's dependent-FMA ns)."""
    import torch

    from mind_the_gaps_tpu_torch import bench
    from mind_the_gaps_tpu_torch.ops import celerite_log_likelihood_plain
    from mind_the_gaps_tpu_torch.ops.celerite import TEAMS, _launch

    t, y, diag, kernel = bench.data()
    reps = 4
    reset_counts()
    clock = time.perf_counter()
    prim = bench.primary(t, y, diag, kernel, reps=reps, device="cuda", latency_ns=latency["float32"])
    prim_s = time.perf_counter() - clock
    boot = bench.bootstrap_chunk_seconds(t, y, diag, n_steps=BENCH_BOOT_STEPS, device="cuda")
    dp = bench.derive_posteriors_seconds(t, y, diag, steps=BENCH_DP_STEPS, device="cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    B = prim["thetas"].shape[0]
    print(f"[bench] primary: {prim['value']:.1f} evals/s ({prim['metric']}), vs_baseline {prim['vs_baseline']:.2f}; "
          f"a sweep of {B} rows {prim['sweep_ms']:.3f} ms, the kernel alone {prim['kernel_ms']:.3f} ms a launch "
          f"(L={prim['team']}; glue {1 - prim['kernel_ms'] / prim['sweep_ms']:.1%} of the sweep), bound "
          f"{prim['bound_ms']:.4f} ms ({prim['bound_by']}), latency floor {prim['latency_floor_ms']:.4f} ms; plain "
          f"version {prim['plain_ms']:.1f} ms; gate 1 (f32 within 1.0 of f64, 8 rows) max |diff| "
          f"{prim['gate_f32_f64_max_abs_err']:.3e}, gate 2 (kernel within 0.5 of plain, {B} rows) "
          f"{prim['gate_kernel_plain_max_abs_err']:.3e}; {prim['launches']} launches, {prim_s:.3f} s [{card}]",
          flush=True)
    print(f"[bench] bootstrap chunk ({boot['bootstrap_chunk_sims']} x {boot['bootstrap_walkers']} walkers x "
          f"{boot['bootstrap_steps']} steps (cut from the bench's 500), early stop "
          f"{boot['bootstrap_early_stop']}): null "
          f"{boot['bootstrap_chunk_seconds_null']:.3f} s in {boot['bootstrap_steps_run_null']} steps, alt "
          f"{boot['bootstrap_chunk_seconds_alt']:.3f} s in {boot['bootstrap_steps_run_alt']} steps; scaled to 10,000 "
          f"simulations {boot['bootstrap_10k_seconds']:.3f} s [{card}]", flush=True)
    print(f"[bench] derive_posteriors {dp['derive_posteriors_walkers']} walkers x {dp['derive_posteriors_steps']} "
          f"steps (cut from the bench's 4000; converge=False, float64): {dp['derive_posteriors_4k_seconds']:.3f} s, "
          f"{dp['derive_posteriors_launches']} launches [{card}]", flush=True)
    print(f"[bench] launches = {counts}", flush=True)
    check(prim["value"] > 0, "bench: the primary metric is not positive")
    check(prim["launches"] == 4 + 2 * reps,
          f"bench: the primary launched the kernel {prim['launches']} times, not {4 + 2 * reps}")
    for name, lls in boot["bootstrap_best_loglikes"].items():
        check(lls.shape == (512,) and bool(torch.isfinite(lls).all()),
              f"bench: the bootstrap chunk's {name} best log-likelihoods are not 512 finite values")
    check(counts["celerite"] > 0, "bench: the celerite kernel never launched")

    data32 = tuple(torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (t, y, diag))
    rows = prim["thetas"][:1024]
    ref = celerite_log_likelihood_plain(kernel.coefficients(rows), *data32).double()
    err = (prim["out"][:1024].double() - ref).abs()
    print(f"[bench] kernel against plain, first 1,024 rows: max_abs_err={float(err.max()):.3e} (rtol 1e-4, atol "
          "1e-2)", flush=True)
    check(bool((err <= 1e-2 + 1e-4 * ref.abs()).all()), "bench: the kernel disagrees with its plain version")
    coeffs = kernel.coefficients(prim["thetas"])
    floor_ms = prim["latency_floor_ms"]
    outs = {team: _launch(coeffs, *data32, team=team) for team in TEAMS}
    for team in TEAMS:
        ref8 = outs[8].double()
        check(bool(((outs[team].double() - ref8).abs() <= 1e-2 + 1e-4 * ref8.abs()).all()),
              f"bench: the layouts disagree at the primary shape (L={team})")
    ms = {team: [] for team in TEAMS}
    for team in TEAMS + TEAMS[::-1]:  # in turns
        ms[team].append(cuda_ms(lambda: _launch(coeffs, *data32, team=team), reps=5))
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    for team in TEAMS:
        mean = sum(ms[team]) / len(ms[team])
        print(f"[layout] bench primary, shared column R=3 float32 B={B} ({B / sm_count:.1f} per SM): L={team} "
              f"{mean:.3f} ms (readings {', '.join(f'{x:.3f}' for x in ms[team])}), {B / mean * 1e3:.1f} evals/s, "
              f"bound {prim['bound_ms']:.4f} ms ({prim['bound_by']}), latency floor {floor_ms:.4f} ms "
              f"({mean / floor_ms:.2f}x), {int((outs[team] != outs[8]).sum())} rows differ from L=8's bits, rule "
              f"L={prim['team']} [{card}]", flush=True)
    if prim["team"] == 1:
        check(counts["celerite_lane"] > 0, "bench: the primary never launched the one-thread layout")
    check("jax" not in sys.modules, "the port imported jax")
    return counts


def tobs_spread(card, args):
    """``--tobs-spread``: phase 4's lrt_512 at seeds 0-7 (each seed moves the
    observed chains' starts and draws, the generation and the refits); each
    run's t_obs, p and the observed chains' convergence, then the spread."""
    import numpy as np

    lc, null, alt = scenario()
    rows = []
    for seed in range(8):
        t0 = time.perf_counter()
        res = gaussian_lrt(lc, null, alt, args, seed=seed)
        rows.append((res.t_obs, res.p_value))
        print(f"[spread] seed {seed}: t_obs = {res.t_obs:.6f}, p_value = {res.p_value:.6f}, t_obs_posterior = "
              f"{res.t_obs_posterior:.6f}, null converged = {res.null_model.converged} after "
              f"{res.null_model.sampler.iteration} steps, alt converged = {res.alt_model.converged} after "
              f"{res.alt_model.sampler.iteration} steps, {time.perf_counter() - t0:.3f} s [{card}]", flush=True)
        check(math.isfinite(res.t_obs) and 0.0 <= res.p_value <= 1.0, f"seed {seed}: t_obs or p out of range")
    t = np.array([r[0] for r in rows])
    print(f"[spread] t_obs over seeds 0-7: min {t.min():.6f}, median {np.median(t):.6f}, max {t.max():.6f}, std "
          f"{t.std(ddof=1):.6f}; p {[r[1] for r in rows]} [{card}]", flush=True)


def gaussian_lrt(lc, null, alt, args, seed=0):
    """Phase 4's run: ``protassov_lrt`` on the lrt_512 scenario on the card."""
    import torch

    from mind_the_gaps_tpu_torch.lrt import protassov_lrt

    res = protassov_lrt(lc, null, alt, nsims=args.nsims, seed=seed, observed_max_steps=args.observed_max_steps,
                        observed_walkers=32, sim_max_steps=500, sim_walkers=12, chunk=512, device="cuda")
    torch.cuda.synchronize()
    return res


def processes_only(card, args):
    """``--processes-only``: phase 13 and what it is held against (phases 4,
    6 and 12), for a run on several cards; no kernel or ``ok`` line."""
    import torch

    lc, null, alt = scenario()
    t0 = time.perf_counter()
    res = gaussian_lrt(lc, null, alt, args)
    print(f"[main] t_obs = {res.t_obs:.6f}, p_value = {res.p_value:.6f}, timings {res.timings}", flush=True)
    phase("Gaussian main path", t0)
    t0 = time.perf_counter()
    e13_run = e13_generation_rate(card, torch.device("cuda"))
    phase("tutorial-scale E13 generation", t0)
    t0 = time.perf_counter()
    mesh_run = mesh_phase(card, lc, null, alt, res)
    phase("mesh", t0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as tmp:
        processes_phase(card, lc, null, alt, res, mesh_run, e13_run, Path(tmp), args.nsims)
    phase("processes", t0)
    print(card, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nsims", type=int, default=512)
    ap.add_argument("--observed-max-steps", type=int, default=10_000)
    ap.add_argument("--rank-of", type=int, default=0,
                    help="run as one rank of phase 13's W ranks (phase 13 sets it)")
    ap.add_argument("--workdir", help="phase 13's work directory (with --rank-of)")
    ap.add_argument("--processes-only", action="store_true",
                    help="run phases 1, 2, 4, 6, 12 and 13 only (phase 13 on several cards); prints no ok line")
    ap.add_argument("--tobs-spread", action="store_true",
                    help="run phases 1 and 2, then phase 4's lrt_512 at seeds 0-7 (t_obs, p, convergence); prints no "
                         "ok line")
    args = ap.parse_args(argv)

    check((ROOT / "mind_the_gaps_tpu_torch" / "csrc").is_dir(),
          "chip_smoke.py runs from a checkout of the repository (mind_the_gaps_tpu_torch/ not found)")
    sys.path.insert(0, str(ROOT))
    if args.rank_of:
        return rank_main(args)
    import numpy as np
    import torch

    from mind_the_gaps_tpu_torch import bench

    # ---- 1. device ---------------------------------------------------- #
    t0 = time.perf_counter()
    check(torch.cuda.is_available(), "no CUDA device: the port's smoke test runs on the card only")
    card = bench.device_line("cuda")
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[device] TF32 off for matmuls and cuDNN (full float32)", flush=True)
    phase("device", t0)

    # ---- 2. build ----------------------------------------------------- #
    t0 = time.perf_counter()
    from mind_the_gaps_tpu_torch.ops import _build

    for lib in _build.build("celerite_loglike_f32", "celerite_loglike_f64", "bitonic_sort", "celerite_grad_f64",
                            "fma_chain"):
        print(f"[build] {lib.relative_to(ROOT)}", flush=True)
    phase("build", t0)
    if args.processes_only:
        return processes_only(card, args)
    if args.tobs_spread:
        return tobs_spread(card, args)

    # ---- 3. kernels against plain ------------------------------------- #
    t0 = time.perf_counter()
    lc, null, alt = scenario()
    grad = grad_cases(card)
    cel_cases = kernel_cases(card)
    srt_cases = sort_cases(card, lc, null)
    probe32 = probe_cases(card)[0]
    probe_launches, latency = probe_entry(card)
    for c in grad:
        c["floor_ms"] = bench.latency_floor_ms(c, latency["float64"], 2)
        print(f"[floor] celerite_grad {c['name']}: latency floor {c['floor_ms']:.4f} ms (forward + adjoint chains "
              f"of depth {bench.chain_depth(c['jr'], c['jc'])} at {latency['float64']:.4f} ns a dependent FMA), kernel "
              f"{c['ms']:.3f} ms = {c['ms'] / c['floor_ms']:.2f}x the floor [{card}]", flush=True)
    for c in cel_cases:
        lat = latency["float64" if c["itemsize"] == 8 else "float32"]
        print(f"[floor] celerite {c['name']}: latency floor {bench.latency_floor_ms(c, lat):.4f} ms (chain depth "
              f"{bench.chain_depth(c['jr'], c['jc'])} at {lat:.4f} ns), kernel {c['ms']:.3f} ms [{card}]", flush=True)
    fit_check(card)
    phase("kernels against plain", t0)

    def fit_line(tag, model):
        sec, evals = model.timings["map_fit_s"], model.timings["map_fit_evals"]
        print(f"[{tag}] MAP fit: map_fit_s = {sec:.3f}, {evals} evaluations, {sec / evals * 1e3:.3f} ms an "
              f"evaluation, {model.timings['map_fit_launches']} gradient-kernel launches [{card}]", flush=True)

    # ---- 4. Gaussian main path ---------------------------------------- #
    t0 = time.perf_counter()
    from mind_the_gaps_tpu_torch.lrt import protassov_lrt

    if args.observed_max_steps != 10_000:
        print(f"[main] observed_max_steps cut from 10000 to {args.observed_max_steps}", flush=True)
    reset_counts()
    res = gaussian_lrt(lc, null, alt, args)
    gauss = read_counts()
    for key, sec in res.timings.items():
        print(f"[main] {key} = {sec:.3f}", flush=True)
    print(f"[main] t_obs = {res.t_obs:.6f}, p_value = {res.p_value:.6f}, "
          f"t_obs_posterior = {res.t_obs_posterior:.6f}, launches = {gauss}", flush=True)
    print(f"[main] null converged = {res.null_model.converged} after {res.null_model.sampler.iteration} steps, "
          f"alt converged = {res.alt_model.converged} after {res.alt_model.sampler.iteration} steps, "
          f"null MAP = {res.null_model.max_parameters}, alt MAP = {res.alt_model.max_parameters}", flush=True)
    for model in (res.null_model, res.alt_model):
        fit_line("main", model)
    check(gauss["celerite_grad"] > 0, "the main path's MAP fits never launched the gradient kernel")
    check(gauss["celerite_grad"] == sum(m.timings["map_fit_evals"] for m in (res.null_model, res.alt_model)),
          "a MAP fit evaluation did not go through the gradient kernel")
    print(f"[main] t_obs {res.t_obs:.6f}; with the MAP fits on the host CPU it was {HOST_FIT_T_OBS:.6f} (the "
          "observed chains start from a walker ball around the MAP optimum, so an optimum that differs in its last "
          "bits gives other chains: phase 9 starts them from the plain fit's optimum)", flush=True)
    check(gauss["celerite"] > 0, "the main path never launched the celerite kernel")
    check(gauss["celerite_warp"] > 0 and gauss["celerite_split"] > 0,
          "the main path did not launch the celerite kernel in both layouts")
    check(res.t_dist.shape == (args.nsims,) and bool(np.all(np.isfinite(res.t_dist))), "t_dist not finite")
    check(0.0 <= res.p_value <= 1.0, f"p-value {res.p_value} outside [0, 1]")
    check(math.isfinite(res.t_obs), "t_obs not finite")
    check("jax" not in sys.modules, "the port imported jax")
    cumsum_bootstrap_moves(card, lc, null, alt, res)
    phase("Gaussian main path", t0)

    # ---- 5. lognormal main path --------------------------------------- #
    t0 = time.perf_counter()
    reset_counts()
    res5 = protassov_lrt(
        lc, null, alt, nsims=args.nsims, pdf="Lognormal", seed=0, null_model=res.null_model,
        alt_model=res.alt_model, sim_max_steps=500, sim_walkers=12, chunk=512, device="cuda",
    )
    torch.cuda.synchronize()
    logn = read_counts()
    sim = res.null_model._simulator
    iters = sim._last_e13_iters
    nonconv = int(torch.sum(iters >= sim.max_iter))
    for key, sec in res5.timings.items():
        print(f"[lognormal] {key} = {sec:.3f}", flush=True)
    print(f"[lognormal] E13 cut {sim._e13_cut_len}, chunk {sim._e13_chunk_default()}, iterations of the "
          f"{iters.numel()} simulations: mean {float(iters.float().mean()):.2f}, max {int(iters.max())}, "
          f"non-converged (hit max_iter={sim.max_iter}) {nonconv}", flush=True)
    print(f"[lognormal] t_obs = {res5.t_obs:.6f}, p_value = {res5.p_value:.6f}, "
          f"t_obs_posterior = {res5.t_obs_posterior:.6f}, launches = {logn}", flush=True)
    check(logn["rank_remap"] > 0 and logn["sort_kv"] > 0, "the lognormal path never launched the sort kernel")
    check(logn["celerite"] > 0, "the lognormal path never launched the celerite kernel")
    check(iters.numel() == args.nsims, "the E13 iteration counts do not cover the simulations")
    check(res5.t_dist.shape == (args.nsims,) and bool(np.all(np.isfinite(res5.t_dist))), "t_dist not finite")
    check(0.0 <= res5.p_value <= 1.0, f"p-value {res5.p_value} outside [0, 1]")
    check("jax" not in sys.modules, "the port imported jax")
    phase("lognormal main path", t0)

    # ---- 6. tutorial-scale E13 generation ----------------------------- #
    t0 = time.perf_counter()
    e13_run = e13_generation_rate(card, torch.device("cuda"))
    phase("tutorial-scale E13 generation", t0)

    # ---- 7. a fitted mean -------------------------------------------- #
    t0 = time.perf_counter()
    from mind_the_gaps_tpu_torch.gpmodelling import GPModelling

    reset_counts()
    gp_mean = GPModelling(lc, null, mean_model="linear", device="cuda")
    gp_mean.derive_posteriors(max_steps=200, convergence_steps=100, walkers=16, seed=7)
    torch.cuda.synchronize()
    mean_counts = read_counts()
    fit_line("mean", gp_mean)
    print(f"[mean] linear mean: {gp_mean.sampler.iteration} steps, max loglike {gp_mean.max_loglikelihood:.6f}, "
          f"median {gp_mean.median_parameters}, sampling {gp_mean.timings['sampling_s']:.3f} s, launches = "
          f"{mean_counts}", flush=True)
    check(gp_mean.mcmc_samples.shape[1] == 4 and bool(np.all(np.isfinite(gp_mean.loglikelihoods))),
          "the fitted-mean run's log-probabilities are not finite")
    check(mean_counts["celerite"] > 0 and mean_counts["celerite_grad"] > 0,
          "the fitted-mean run did not launch both celerite kernels")
    phase("fitted mean", t0)

    # ---- 8. multi-chain ---------------------------------------------- #
    t0 = time.perf_counter()
    reset_counts()
    gp_chains = GPModelling(lc, null, device="cuda")
    gp_chains.derive_posteriors(max_steps=200, convergence_steps=100, walkers=16, chains=4, seed=8)
    torch.cuda.synchronize()
    chain_counts = read_counts()
    print(f"[chains] chains=4 x 16 walkers: chain {gp_chains.sampler.get_chain().shape}, max loglike "
          f"{gp_chains.max_loglikelihood:.6f}, rstat {gp_chains.get_rstat(burnin=50).shape}, sampling "
          f"{gp_chains.timings['sampling_s']:.3f} s, launches = {chain_counts}", flush=True)
    check(gp_chains.sampler.get_chain().shape[1] == 64 and bool(np.all(np.isfinite(gp_chains.loglikelihoods))),
          "the chains=4 run's log-probabilities are not finite")
    check(chain_counts["celerite"] > 0, "the chains=4 run never launched the celerite kernel")
    check("jax" not in sys.modules, "the port imported jax")
    phase("multi-chain", t0)

    # ---- 9. t_obs provenance ------------------------------------------ #
    # The matched estimator's t_obs depends on the observed null chain
    # alone; started from the plain version's CPU fit, with the seeds of
    # phase 4, it must give the t_obs of the runs whose fits ran there.
    t0 = time.perf_counter()
    cpu_fit = GPModelling(lc, null, device="cpu").fit()
    card_x = GPModelling(lc, null, device="cuda").fit().x  # phase 4's null optimum (the fit is deterministic)
    null_cpu_start = GPModelling(lc, null, device="cuda")
    start = null_cpu_start.spread_walkers(32, cpu_fit.x, np.array(null_cpu_start.get_parameter_bounds(), dtype=object),
                                          rng=np.random.default_rng(101))
    null_cpu_start.derive_posteriors(initial_chain_params=start, max_steps=args.observed_max_steps, walkers=32,
                                     seed=101)
    res9 = protassov_lrt(lc, null, alt, nsims=args.nsims, seed=0, null_model=null_cpu_start,
                         alt_model=res.alt_model, sim_max_steps=500, sim_walkers=12, chunk=512, device="cuda")
    d_opt = float(np.max(np.abs(cpu_fit.x - card_x) / np.abs(cpu_fit.x)))
    print(f"[t_obs] null MAP on the CPU {cpu_fit.x!r} (-ll {cpu_fit.fun!r}), on the card {card_x!r}: "
          f"rtol {d_opt:.3e}; null chain from the CPU optimum: {null_cpu_start.sampler.iteration} steps, t_obs = "
          f"{res9.t_obs:.6f}, p_value = {res9.p_value:.6f} (host-CPU fits: {HOST_FIT_T_OBS:.6f}, 1.0; phase 4: {res.t_obs:.6f}) "
          f"[{card}]", flush=True)
    if args.nsims == 512 and args.observed_max_steps == 10_000:
        check(abs(res9.t_obs - HOST_FIT_T_OBS) <= 0.01 and res9.p_value == 1.0,
              "started from the host-CPU fit's optimum, the Gaussian lrt_512 does not give its t_obs / p-value")
    phase("t_obs provenance", t0)

    # ---- 10. the CLI on a lightcurve file ----------------------------- #
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as tmp:
        cli_counts = cli_phase(card, lc, Path(tmp), reset_counts, read_counts)
    check("jax" not in sys.modules, "the port imported jax")
    phase("CLI on a lightcurve file", t0)

    # ---- 11. model selection and periodogram at full width ------------ #
    t0 = time.perf_counter()
    sel_counts, sel_grad = selection_phase(card, lc, latency, reset_counts, read_counts)
    reset_counts()
    fit_device_phase(card, lc, null, alt)
    torch.cuda.synchronize()
    fitdev_counts = read_counts()
    print(f"[fit_device] launches = {fitdev_counts}", flush=True)
    periodogram_phase(card, lc)
    check("jax" not in sys.modules and "matplotlib" not in sys.modules, "the port imported jax or matplotlib")
    phase("model selection and periodogram at full width", t0)

    # ---- 12. the mesh ------------------------------------------------- #
    t0 = time.perf_counter()
    reset_counts()
    mesh_run = mesh_phase(card, lc, null, alt, res)
    torch.cuda.synchronize()
    mesh_counts = read_counts()
    print(f"[mesh] launches = {mesh_counts}", flush=True)
    check(mesh_counts["celerite"] > 0, "the mesh phase never launched the celerite kernel")
    check("jax" not in sys.modules, "the port imported jax")
    phase("mesh", t0)

    # ---- 13. processes ------------------------------------------------ #
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as tmp:
        ranks_counts, one_mesh_counts = processes_phase(card, lc, null, alt, res, mesh_run, e13_run, Path(tmp),
                                                        args.nsims)
    print(f"[processes] launches: the ranks {ranks_counts}, the one-process mesh {one_mesh_counts}", flush=True)
    check(ranks_counts["celerite"] > 0 and ranks_counts["rank_remap"] > 0 and ranks_counts["sort_kv"] > 0,
          "the ranks did not launch the celerite and sort kernels")
    phase("processes", t0)

    # ---- 14. validation ----------------------------------------------- #
    t0 = time.perf_counter()
    val_counts = validation_phase(card)
    for key in ("celerite_warp", "celerite_split", "rank_remap", "sort_kv", "celerite_grad"):
        check(sum(v[key] for v in val_counts.values()) > 0, f"the validation phase never launched {key}")
    check(val_counts["b"]["rank_remap"] > 0 and val_counts["b"]["sort_kv"] > 0,
          "the lognormal calibration did not launch the sort kernels")
    check("jax" not in sys.modules, "the port imported jax")
    phase("validation", t0)

    # ---- 15. the 10,000-simulation bootstrap -------------------------- #
    t0 = time.perf_counter()
    boot_counts = lrt_10k_phase(card, res)
    phase("10,000-simulation bootstrap", t0)

    # ---- 16. the bench ---------------------------------------------- #
    t0 = time.perf_counter()
    bench_counts = bench_phase(card, latency)
    phase("bench", t0)

    # ---- summary ------------------------------------------------------ #
    def row(name, route, source, replaces, launches, case, library_ms):
        return {"name": name, "route": route, "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": case["max_abs_err"], "ms": case["ms"], "plain_ms": case["plain_ms"],
                "bound_ms": case["bound_ms"], "bound_by": case["bound_by"], "library_ms": library_ms}

    def named(cases, prefix):
        return next(c for c in cases if c["name"].startswith(prefix))

    paths = (gauss, logn, mean_counts, chain_counts, *cli_counts, sel_counts, fitdev_counts, mesh_counts,
             ranks_counts, one_mesh_counts, *val_counts.values(), boot_counts, bench_counts)

    def launches(key):
        return sum(p[key] for p in paths)

    grad_alt = named(grad, "MAP fit alt")
    obs = named(cel_cases, "observed-fit step")
    cel = named(cel_cases, "bootstrap alt step")
    dense = named(cel_cases, "dense-S, bootstrap alt step")
    primary = named(cel_cases, "bench primary")
    remap = named(srt_cases, "rank_remap (128, 65536) one E13 step")
    srt = named(srt_cases, "sort_kv (128, 65536) f64")
    for c in (grad_alt, obs, cel, primary, dense, remap, srt):
        print(f"[summary] times of the entry: {c['name']}{before_note(c['name'])}", flush=True)
    print("[summary] launches are the sums over the Gaussian, lognormal, fitted-mean, chains=4, CLI (fit, "
          "simulate, lrt), model-selection, fit_device, mesh, processes (the ranks summed), validation, "
          "10,000-simulation bootstrap and bench paths (the bench's gates included); the probe's "
          "are those of its own entry point (fma_probe.probe) "
          "(the celerite entries: its launches with a warp, with 8 lanes and with a thread per likelihood); the "
          "sorts' plain "
          "versions are the library calls (stable torch.sort / argsort with a gather / scatter); the "
          "gradient kernel's plain version is autograd through solver/semiseparable.py on the card", flush=True)
    print(f"[goal] rank_remap (128, 65536): kernel {remap['ms']:.3f} ms against the library's "
          f"{remap['plain_ms']:.3f} ms: {'met' if remap['ms'] <= remap['plain_ms'] else 'NOT met'}", flush=True)
    print(f"[goal] celerite observed-fit shape: {obs['ms']:.3f} ms against 1.2 ms: "
          f"{'met' if obs['ms'] <= 1.2 else 'NOT met'}", flush=True)
    for c in sel_grad:
        print(f"[summary] celerite_grad {c['name']}: {c['ms']:.3f} ms, {c['ms'] / c['floor_ms']:.2f}x its latency "
              f"floor [{card}]", flush=True)
    for prefix in ("MAP fit null", "MAP fit alt"):
        c = named(grad, prefix)
        ratio = c["ms"] / c["floor_ms"]
        print(f"[goal] celerite_grad {prefix}: {c['ms']:.3f} ms, {ratio:.2f}x its latency floor against "
              f"{GRAD_FLOOR_AIM:.0f}x: {'met' if ratio <= GRAD_FLOOR_AIM else 'NOT met'}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [
        row("celerite_grad, forward + adjoint (MAP fit alt shape)", "cuda", GRAD_SOURCE, GRAD_REPLACES,
            launches("celerite_grad"), grad_alt, None),
        row("celerite_loglike, a warp a likelihood (observed-fit shape)", "cuda", CELERITE_SOURCE,
            "mind_the_gaps_tpu/ops/pallas_celerite.py:520", launches("celerite_warp"), obs, None),
        row("celerite_loglike, 8 lanes a likelihood (bootstrap alt shape)", "cuda", CELERITE_SOURCE,
            "mind_the_gaps_tpu/ops/pallas_celerite.py:520", launches("celerite_split"), cel, None),
        row("celerite_loglike, a thread a likelihood (bench primary shape)", "cuda", CELERITE_SOURCE,
            "mind_the_gaps_tpu/ops/pallas_celerite.py:520", launches("celerite_lane"), primary, None),
        row("celerite_loglike dense-S (bootstrap alt shape)", "cuda", CELERITE_SOURCE,
            "mind_the_gaps_tpu/ops/pallas_celerite.py:48", launches("celerite_dense"), dense, None),
        row("bitonic_sort rank_remap", "cuda", SORT_SOURCE, "mind_the_gaps_tpu/ops/pallas_sort.py:556",
            launches("rank_remap"), remap, remap["plain_ms"]),
        row("bitonic_sort sort_kv", "cuda", SORT_SOURCE, "mind_the_gaps_tpu/ops/pallas_sort.py:460",
            launches("sort_kv"), srt, srt["plain_ms"]),
        row("fma_chain latency probe (f32, 16384 elements)", "cuda", PROBE_SOURCE, PROBE_REPLACES, probe_launches,
            probe32, None),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
