#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printed with its seconds:

1. device: the card's name and power limit (nvidia-smi); TF32 is turned
   off for matmuls and cuDNN;
2. build: the CUDA kernels of ``mind_the_gaps_tpu_torch/csrc`` with nvcc,
   one process per source, all started together, into
   ``mind_the_gaps_tpu_torch/_build`` (keyed by a hash of the source);
3. kernels against plain: ``celerite_log_likelihood_and_grad`` (the MAP
   fit's forward + adjoint kernel: value and every gradient) at N=5000 for
   R = 1 and 3 (the main path's fits), R = 7, a runtime R = 10, a
   per-element residual with a linear mean and a non-positive-definite
   theta; ``celerite_log_likelihood`` (packed and dense-S
   bodies, every layout, the compile-time widths up to R = 8 and the
   runtime-R body), ``rank_remap`` and ``sort_kv`` (the CUDA kernels, every
   tier and its edges) against their plain PyTorch versions on the same
   tensors on the card, at the shapes of the main paths, each with both
   times from CUDA events and, where PERF.md has one, the time before the
   redesign of the hand-written kernels (PERF.md section 6); the sorts
   must be equal to their plain versions (``torch.equal``); then the two
   celerite layouts (32 or 8 lanes per likelihood) timed at the batches
   on either side of the crossover of ``ops.celerite.team_size``; then the
   MAP fit on the card against the plain version's fit on the CPU at
   N=1000 (the same optimum);
4. Gaussian main path: ``protassov_lrt(..., device="cuda")`` on the lrt_512
   scenario (N=5000 DRW-true data, DRW null, DRW+Lorentzian alternative,
   512 simulations), with the kernels' launch counts over that run and the
   MAP fits' seconds, objective evaluations and milliseconds an evaluation;
5. lognormal main path: the same LRT with ``pdf="Lognormal"`` (E13 cut
   m=65536, lock-step chunks of 128), reusing phase 4's fitted observed
   models, with the E13 iteration counts and the launch counts;
6. tutorial-scale E13 generation: lognormal lightcurves per second at
   n=500, B=256, cut 8192 (the JAX package's bench.py scenario);
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
   depths, with Kraft low-count noise on the path; the Kraft tables built
   on the card against the plain version on the CPU (1e-9); then the
   resume check on the lrt's fitted models at chunk=128: the t_dist of a
   run resumed from a checkpoint rewound to 2 chunks must equal the
   uninterrupted run's (``np.array_equal``).

Phase 3 also holds the latency probe ``ops/fma_probe.py`` (``csrc/fma_chain.cu``,
dependent multiply-add chains) against its plain version in float32 and
float64, and drives the probe's own entry point (``fma_probe.probe``),
whose ns per iteration give the card's dependent-FMA latency.

The last lines are the card's name and power limit, one JSON line of the
kernels (route, source, launches in the main paths, error, times and
bound) and ``{"ok": true, "device": {...}}``.  Any failure raises: there is
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
# the card's published peaks (H100 SXM data sheet, at the 700 W limit):
# memory, and float32 / float64 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {4: 67e12, 8: 34e12}
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
    "rank_remap (128, 65536) one E13 step": 1.452,
    "rank_remap (128, 65536) planted": 1.400,
    "rank_remap (512, 8192)": 0.411,
    "rank_remap (128, 50011)": 1.383,
    "sort_kv (128, 65536) f64": 1.713,
    "sort_kv (128, 16384) f32": 0.220,
    "sort_kv (64, 8) f32": 0.031,
}


def before_note(name):
    ms = next((v for k, v in BEFORE_REDESIGN_MS.items() if name.startswith(k)), None)
    return "" if ms is None else f", before the redesign {ms:.3f} ms (PERF.md)"


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def bound(n_bytes, n_ops, itemsize):
    """(bound ms, what sets it): the least time for ``n_bytes`` of memory
    traffic and ``n_ops`` operations on ``itemsize``-byte floats at the
    card's peaks."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / OPS_PER_S[itemsize] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def celerite_step_ops(jr, jc, dense=False):
    """Floating-point operations of one time step of one likelihood in
    csrc/celerite_loglike.cu, counted from its loops (an exp, log, sin, cos
    or division counts as one)."""
    R = jr + 2 * jc
    row = [1] * jr + [3] * (2 * jc)  # one row of P times a vector: real 1, complex 3
    s_ops = R * sum(row) if dense else sum(sum(row[i:]) for i in range(R))
    return (
        2 * jr + 7 * jc  # propagators
        + 3 * (R * R if dense else R * (R + 1) // 2)  # M = S + D W W^T
        + R * sum(row) + s_ops  # P M, then (P M) P^T
        + R * (2 * R - 1) + 2 * R + 2  # S u, u^T S u, D, 1 / D
        + 2 * R + sum(row) + 2 * R + 1 + 2 * R  # f, u^T f, z, W
        + 6  # log|D|, z^2 / D, a tree add for each sum, the pivot test (Kahan: once a chunk)
    )


def celerite_bound(case):
    """Bound of one celerite launch: each input read once (dt, the data
    columns, coefficients, mean, jitter), the output written once; the
    operations of the kernel's recursion."""
    B, N, jr, jc, cols, item = case["B"], case["N"], case["jr"], case["jc"], case["cols"], case["itemsize"]
    n_bytes = item * (N + 2 * N * cols + B * (2 * jr + 4 * jc) + 3 * B)
    return bound(n_bytes, B * (N - 1) * celerite_step_ops(jr, jc, dense=not case["sym"]), item)


def sort_bound(case):
    """Bound of one sort launch: each input read once and each output
    written once; one operation per compare-exchange of the bitonic
    network on the padded row."""
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
    B, N, jr, jc, y_numel = case["B"], case["N"], case["jr"], case["jc"], case["y_numel"]
    coef = B * (2 * jr + 4 * jc)
    n_bytes = 8 * (2 * N + y_numel + coef + 2 * B + B + coef + B + B * N)
    return bound(n_bytes, B * N * grad_step_ops(jr, jc), 8)


def grad_cases(card):
    """Phase 3, the MAP fit's kernel: value and gradients against the plain
    version (autograd through solver/semiseparable.py, on the card) at
    N=5000: value rtol 1e-10, each gradient within 1e-8 of its largest
    component."""
    import numpy as np
    import torch

    from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, Lorentzian, RealTerm
    from mind_the_gaps_tpu_torch.models.mean_models import LinearModel
    from mind_the_gaps_tpu_torch.ops.celerite_grad import (
        celerite_log_likelihood_and_grad,
        celerite_log_likelihood_and_grad_plain,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    lc, null, alt = lrt_scenario()
    t = torch.as_tensor(lc.times, device=dev)
    y = torch.as_tensor(lc.y, dtype=torch.float64, device=dev)
    diag = torch.as_tensor((lc.dy + 1e-12) ** 2, dtype=torch.float64, device=dev)
    drw3l = alt + Lorentzian(-0.8, 1.5, -1.6) + Lorentzian(-0.6, 1.0, -1.2)  # R = 7
    wide10 = drw3l + RealTerm(-0.5, -2.0) + Lorentzian(-1.2, 1.2, -1.0)  # R = 10: runtime-R body
    n = t.shape[0]

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
        ("linear mean, per-element residuals: B=2 N=5000 R=3", args(alt, B=2, per_element_mean=True)),
    ]
    results = []
    for name, a in cases:
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
        ms = cuda_ms(lambda: celerite_log_likelihood_and_grad(**a), reps=10)
        c = a["coeffs"]
        case = dict(name=name, max_abs_err=max_abs, grad_rel_err=worst, ms=ms, plain_ms=plain_ms, B=c.ar.shape[0],
                    N=n, jr=c.ar.shape[1], jc=c.ac.shape[1], y_numel=a["y"].numel())
        case["bound_ms"], case["bound_by"] = grad_bound(case)
        print(f"[kernel] celerite_grad {name}: value max_abs_err={max_abs:.3e} (rtol 1e-10), gradients "
              f"{worst:.3e} of their largest (1e-8), kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
              f"bound {case['bound_ms']:.5f} ms ({case['bound_by']}) [{card}]", flush=True)
        check(ok and worst <= 1e-8, f"{name}: the gradient kernel disagrees with its plain version")
        results.append(case)

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
    from mind_the_gaps_tpu_torch.ops.fma_probe import fma_chain, probe

    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    fma_chain.launches = 0
    rows = probe()
    launches = fma_chain.launches
    check(launches > 0, "the probe's entry point never launched the probe kernel")
    latency = {}
    for r in rows:
        print(f"[probe] {r['dtype']} n={r['n']} threads={r['threads']} warps/SM={r['warps_per_sm']}: "
              f"{r['ms']:.4f} ms, {r['ns_per_iter']:.4f} ns an iteration [{card}]", flush=True)
        if r["warps_per_sm"] in (1, 4):
            latency.setdefault(r["dtype"], []).append(r["ns_per_iter"] / 2)
    latency = {k: min(v) for k, v in latency.items()}
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

    lc, null, alt = lrt_scenario(n)
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

    from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, Lorentzian, RealTerm
    from mind_the_gaps_tpu_torch.ops import celerite_log_likelihood, celerite_log_likelihood_plain
    from mind_the_gaps_tpu_torch.ops.celerite import TEAMS, _launch, team_size

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
    ]
    results = []
    for name, kernel, B, t, layout, dtype, G, reference, sym in cases:
        args = inputs(kernel, B, t, layout, dtype, G)
        out = celerite_log_likelihood(**args, sym=sym)
        torch.cuda.synchronize()
        if reference == "same":
            ref_args = args
        else:  # the same draws in float64
            ref_args = {k: (v.double() if torch.is_tensor(v) and v.is_floating_point() else v)
                        for k, v in args.items()}
            ref_args["coeffs"] = type(args["coeffs"])(*(c.double() for c in args["coeffs"]))
        ref = celerite_log_likelihood_plain(**ref_args)
        ms = cuda_ms(lambda: celerite_log_likelihood(**args, sym=sym), reps=5)
        plain_ms = cuda_ms(lambda: celerite_log_likelihood_plain(**args), reps=1)
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
        team = team_size(B, sm_count, jr, jc)
        print(f"[kernel] {name}: max_abs_err={max_abs:.3e} ({tol}) kernel {ms:.3f} ms (L={team}{before_note(name)}), "
              f"plain {plain_ms:.3f} ms, bound {case['bound_ms']:.4f} ms ({case['bound_by']}) [{card}]", flush=True)
        check(ok, f"{name}: kernel disagrees with the plain version (max abs err {max_abs})")
        results.append(case)

    # a non-positive-definite theta: -inf from every body and layout and the plain version
    for kernel in (drw, wide10):
        args = inputs(kernel, 16, t5k, "shared", f64)
        args["coeffs"] = args["coeffs"]._replace(ar=-args["coeffs"].ar)
        ref = celerite_log_likelihood_plain(**args)
        check(bool(torch.all(ref == -math.inf)), "non-PD theta must give -inf from the plain version")
        for sym in (True, False):
            for team in TEAMS:
                if kernel is wide10 and team != 32:
                    continue
                out = _launch(**args, sym=sym, team=team)
                check(bool(torch.all(out == -math.inf)), f"non-PD theta must give -inf (sym={sym}, L={team})")
    print("[kernel] non-PD theta: -inf from every kernel body and layout and the plain version", flush=True)
    layout_sweep(card, inputs, drw_qpo, t5k, sm_count)
    return results


def layout_sweep(card, inputs, kernel, t, sm_count):
    """Phase 3, celerite layouts: teams of 32 and 8 lanes per likelihood at
    the batches on either side of ``team_size``'s crossover (its setting and
    6 likelihoods an SM), at the bootstrap's and the observed fit's data
    layouts; they must agree (rtol 1e-10 f64; rtol 1e-4, atol 1e-2 f32)."""
    import torch

    from mind_the_gaps_tpu_torch.ops.celerite import TEAMS, WARP_TEAM_MAX_PER_SM, _launch, team_size

    f32, f64 = torch.float32, torch.float64
    for dtype, layout in ((f32, "grouped"), (f64, "shared")):
        for B in (WARP_TEAM_MAX_PER_SM * sm_count, 6 * sm_count):
            args = inputs(kernel, B, t, layout, dtype, G=B // 6 if B % 6 == 0 else B)
            outs = {team: _launch(**args, team=team).double() for team in TEAMS}
            tol = (1e-10 * outs[32].abs()) if dtype == f64 else (1e-2 + 1e-4 * outs[32].abs())
            for team in TEAMS:
                check(bool(((outs[team] - outs[32]).abs() <= tol).all()), f"layouts disagree at B={B} {dtype}")
            ms = {team: cuda_ms(lambda: _launch(**args, team=team), reps=3) for team in TEAMS}
            times = ", ".join(f"L={team} {ms[team]:.3f} ms" for team in TEAMS)
            print(f"[layout] {layout} R=3 {dtype} B={B} ({B / sm_count:.2f} per SM): {times}, "
                  f"rule L={team_size(B, sm_count, 1, 1)} [{card}]", flush=True)


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


def chain_depth(jr, jc):
    """Dependent operations on one step's chain of the celerite recursion
    (csrc/celerite_loglike.cuh, phase B), counting each multiply-add, and
    the reciprocal, as one: W = (v - S u) / D, D W, M = S + D W W^T, P M and
    (P M) P^T (one deep for real terms, two with a complex pair), S u and
    u^T S u (R deep each), D = A - u^T S u, 1 / D.  A lower bound: the
    reciprocal is a sequence of several."""
    R = jr + 2 * jc
    return 2 * R + 5 + 2 * (2 if jc else 1)


def latency_floor_ms(case, latency_ns, passes=1):
    """The least time a launch's chains can take at the measured latency
    of one dependent multiply-add: (N - 1) steps of ``chain_depth``, once
    for the forward kernel, twice (forward and adjoint, the adjoint at
    least as deep) for the gradient kernel."""
    return passes * (case["N"] - 1) * chain_depth(case["jr"], case["jc"]) * latency_ns * 1e-6


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
    gp, fit_counts = run("fit", ["fit", str(csv), "--kernel", "drw", "--output", str(chain)])
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
                                  "--checkpoint", str(ckpt)])
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


def lrt_scenario(n=5000):
    """The lrt_512 scenario: N=5000, t = cumsum(uniform(2, 8)) from
    default_rng(0), an exact DRW realization plus noise (dy=0.3, mean 10)."""
    import numpy as np

    from mind_the_gaps_tpu_torch import GappyLightcurve
    from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, Lorentzian

    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    S0, w0 = np.exp(1.0), np.exp(-3.0)
    y = np.empty(n)
    y[0] = rng.normal(0.0, np.sqrt(S0))
    phi = np.exp(-w0 * np.diff(t))
    innov = rng.normal(0.0, np.sqrt(S0 * (1.0 - phi**2)))
    for i in range(1, n):
        y[i] = phi[i - 1] * y[i - 1] + innov[i - 1]
    dy = np.full(n, 0.3)
    y = y + 10.0 + rng.normal(0.0, dy)
    lc = GappyLightcurve(t, y, dy, exposures=1.0)
    null = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    alt = null + Lorentzian(log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)])
    return lc, null, alt


def e13_generation_rate(card, dev, n_points=500, B=256):
    """Phase 6: lognormal (E13) generation at the tutorial-scale segment
    (~6.6k fine samples -> the 8192 power-of-two cut), the scenario of the
    JAX package's bench.py, on ``dev``."""
    import numpy as np
    import torch

    from mind_the_gaps_tpu_torch.gpmodelling import synchronize
    from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk
    from mind_the_gaps_tpu_torch.ops import rank_remap
    from mind_the_gaps_tpu_torch.simulator import Simulator

    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(4.0, 9.0, n_points))
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0)
    theta0 = kernel.get_parameter_vector()
    sim = Simulator(kernel.get_psd, t, exposures=1.0, mean=10.0, pdf="lognormal", extension_factor=2,
                    max_iter=400, device=dev)
    check(sim._e13_cut_len == 8192, f"tutorial-scale cut is {sim._e13_cut_len}, not 8192")
    omega = torch.as_tensor(sim.omega[1:], dtype=torch.float64, device=dev)
    thetas = torch.as_tensor(theta0[None, :] + 0.15 * rng.standard_normal((B, 2)), device=dev)
    psd = kernel.get_psd(omega, thetas)
    psd = torch.cat([psd.new_zeros((B, 1)), psd], dim=1)
    sim.simulate_batch(psd, generator=torch.Generator(dev).manual_seed(1))  # warm-up
    synchronize(dev)
    launches = rank_remap.launches
    start = time.perf_counter()
    out = sim.simulate_batch(psd, generator=torch.Generator(dev).manual_seed(2))
    synchronize(dev)
    elapsed = time.perf_counter() - start
    iters = sim._last_e13_iters.float()
    check(out.shape == (B, n_points) and bool(torch.all(torch.isfinite(out))) and bool(torch.all(out > 0)),
          "E13 generation: rates not finite and positive")
    print(f"[e13] lognormal generation n={n_points}, B={B}, cut {sim._e13_cut_len}: {elapsed:.4f} s, "
          f"{B / elapsed:.1f} lightcurves/s, E13 iterations mean {float(iters.mean()):.1f} "
          f"max {int(iters.max())}, remap launches {rank_remap.launches - launches} [{card}]", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nsims", type=int, default=512)
    ap.add_argument("--observed-max-steps", type=int, default=10_000)
    args = ap.parse_args(argv)

    check((ROOT / "mind_the_gaps_tpu_torch" / "csrc").is_dir(),
          "chip_smoke.py runs from a checkout of the repository (mind_the_gaps_tpu_torch/ not found)")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    # ---- 1. device ---------------------------------------------------- #
    t0 = time.perf_counter()
    check(torch.cuda.is_available(), "no CUDA device: the port's smoke test runs on the card only")
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[device] TF32 off for matmuls and cuDNN (full float32)", flush=True)
    phase("device", t0)

    # ---- 2. build ----------------------------------------------------- #
    t0 = time.perf_counter()
    from mind_the_gaps_tpu_torch.ops import _build, celerite_log_likelihood, rank_remap, sort_kv
    from mind_the_gaps_tpu_torch.ops.celerite_grad import celerite_log_likelihood_and_grad

    for lib in _build.build("celerite_loglike_f32", "celerite_loglike_f64", "bitonic_sort", "celerite_grad_f64",
                            "fma_chain"):
        print(f"[build] {lib.relative_to(ROOT)}", flush=True)
    phase("build", t0)

    # ---- 3. kernels against plain ------------------------------------- #
    t0 = time.perf_counter()
    lc, null, alt = lrt_scenario()
    grad = grad_cases(card)
    cel_cases = kernel_cases(card)
    srt_cases = sort_cases(card, lc, null)
    probe32 = probe_cases(card)[0]
    probe_launches, latency = probe_entry(card)
    for c in grad:
        print(f"[floor] celerite_grad {c['name']}: latency floor {latency_floor_ms(c, latency['float64'], 2):.4f} ms "
              f"(forward + adjoint chains at {latency['float64']:.4f} ns a dependent FMA), kernel {c['ms']:.3f} ms "
              f"[{card}]", flush=True)
    for c in cel_cases:
        lat = latency["float64" if c["itemsize"] == 8 else "float32"]
        print(f"[floor] celerite {c['name']}: latency floor {latency_floor_ms(c, lat):.4f} ms (chain depth "
              f"{chain_depth(c['jr'], c['jc'])} at {lat:.4f} ns), kernel {c['ms']:.3f} ms [{card}]", flush=True)
    fit_check(card)
    phase("kernels against plain", t0)

    def reset_counts():
        celerite_log_likelihood.launches = celerite_log_likelihood.dense_launches = 0
        celerite_log_likelihood.team_launches = dict.fromkeys(celerite_log_likelihood.team_launches, 0)
        rank_remap.launches = sort_kv.launches = celerite_log_likelihood_and_grad.launches = 0

    def read_counts():
        return dict(celerite=celerite_log_likelihood.launches, celerite_dense=celerite_log_likelihood.dense_launches,
                    celerite_warp=celerite_log_likelihood.team_launches[32],
                    celerite_split=sum(v for k, v in celerite_log_likelihood.team_launches.items() if k != 32),
                    rank_remap=rank_remap.launches, sort_kv=sort_kv.launches,
                    celerite_grad=celerite_log_likelihood_and_grad.launches)

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
    res = protassov_lrt(
        lc, null, alt, nsims=args.nsims, seed=0, observed_max_steps=args.observed_max_steps,
        observed_walkers=32, sim_max_steps=500, sim_walkers=12, chunk=512, device="cuda",
    )
    torch.cuda.synchronize()
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
    e13_generation_rate(card, torch.device("cuda"))
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

    # ---- summary ------------------------------------------------------ #
    def row(name, route, source, replaces, launches, case, library_ms):
        return {"name": name, "route": route, "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": case["max_abs_err"], "ms": case["ms"], "plain_ms": case["plain_ms"],
                "bound_ms": case["bound_ms"], "bound_by": case["bound_by"], "library_ms": library_ms}

    def named(cases, prefix):
        return next(c for c in cases if c["name"].startswith(prefix))

    paths = (gauss, logn, mean_counts, chain_counts, *cli_counts)

    def launches(key):
        return sum(p[key] for p in paths)

    grad_alt = named(grad, "MAP fit alt")
    obs = named(cel_cases, "observed-fit step")
    cel = named(cel_cases, "bootstrap alt step")
    dense = named(cel_cases, "dense-S, bootstrap alt step")
    remap = named(srt_cases, "rank_remap (128, 65536) one E13 step")
    srt = named(srt_cases, "sort_kv (128, 65536) f64")
    for c in (grad_alt, obs, cel, dense, remap, srt):
        print(f"[summary] times of the entry: {c['name']}{before_note(c['name'])}", flush=True)
    print("[summary] launches are the sums over the Gaussian, lognormal, fitted-mean, chains=4 and CLI (fit, "
          "simulate, lrt) paths; the probe's are those of its own entry point (fma_probe.probe) "
          "(the celerite entries: its launches with a warp and with 8 lanes per likelihood); the sorts' plain "
          "versions are the library calls (stable torch.sort / argsort with a gather / scatter); the "
          "gradient kernel's plain version is autograd through solver/semiseparable.py on the card", flush=True)
    print(f"[goal] rank_remap (128, 65536): kernel {remap['ms']:.3f} ms against the library's "
          f"{remap['plain_ms']:.3f} ms: {'met' if remap['ms'] <= remap['plain_ms'] else 'NOT met'}", flush=True)
    print(f"[goal] celerite observed-fit shape: {obs['ms']:.3f} ms against 1.2 ms: "
          f"{'met' if obs['ms'] <= 1.2 else 'NOT met'}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [
        row("celerite_grad, forward + adjoint (MAP fit alt shape)", "cuda", GRAD_SOURCE, GRAD_REPLACES,
            launches("celerite_grad"), grad_alt, None),
        row("celerite_loglike, a warp a likelihood (observed-fit shape)", "cuda", CELERITE_SOURCE,
            "mind_the_gaps_tpu/ops/pallas_celerite.py:520", launches("celerite_warp"), obs, None),
        row("celerite_loglike, 8 lanes a likelihood (bootstrap alt shape)", "cuda", CELERITE_SOURCE,
            "mind_the_gaps_tpu/ops/pallas_celerite.py:520", launches("celerite_split"), cel, None),
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
