"""The port's benchmark: batched GP log-likelihood throughput at N=5000 on
the card, then the bootstrap's and the observed fits' wall clock; the
counterpart of the JAX repo's ``bench.py``.

Primary metric (the JAX bench's, its metric string letter for letter): GP
log-likelihood evaluations a second at N = 5,000 points with the DRW +
Lorentzian kernel, 65,536 parameter rows a sweep in float32 over one shared
data column.  A sweep is ``kernel.coefficients`` of the rows, then
``ops.celerite_log_likelihood`` (the kernel of ``csrc/celerite_loglike.cuh``
on a card); one warm-up sweep, then ``reps`` sweeps on fresh rows between
two CUDA events.  ``vs_baseline`` divides by the reference's CPU pipeline,
8,040 evaluations a second (BASELINE.md, measured by the JAX repo's
``benchmarks/cpu_baseline.py``).  Beside it: the kernel's own ms a launch,
its layout (lanes a likelihood, ``ops.celerite.team_size``), the card's
bound for the launch and its latency floor (the dependent-FMA latency
measured by ``ops.fma_probe.probe`` times the recursion's chain).

Two gates come first, the JAX bench's: the float32 kernel within 1.0 of the
float64 kernel on 8 rows, and the kernel within 0.5 of its plain version
(``solver.batched.batched_log_likelihood``) over the whole batch.  A gate
that fails prints an error record as the JSON line and exits 1.  There is
no fallback to the plain version.

Then, in the JAX bench's order: one bootstrap chunk (512 simulated
lightcurves x 12 walkers x 500 steps, ``lrt.batched_max_loglike`` with the
production early stop, null and alternative timed apart and scaled to
10,000 simulations); lognormal E13 generation at the tutorial scale;
``derive_posteriors`` with 32 walkers x 4000 steps that does not stop at
convergence (float64 chains, the port's default); one measured
``protassov_lrt`` of 512 simulations on ``examples.lrt_10k``'s scenario.

Every phase runs in this thread, one after another; stdout carries only the
JSON line (``KEYS``), phase marks go to stderr.  An exception or a failed
gate ends the run with a non-zero exit code.  On a card every library the
run loads is built first, in parallel (``build_seconds``).

Run: python -m mind_the_gaps_tpu_torch.bench [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from mind_the_gaps_tpu_torch import ops
from mind_the_gaps_tpu_torch.examples import lrt_10k
from mind_the_gaps_tpu_torch.gpmodelling import GPModelling, synchronize
from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, Lorentzian
from mind_the_gaps_tpu_torch.lightcurves import GappyLightcurve
from mind_the_gaps_tpu_torch.lrt import batched_max_loglike, protassov_lrt
from mind_the_gaps_tpu_torch.ops import celerite_log_likelihood
from mind_the_gaps_tpu_torch.ops.celerite import batch_team
from mind_the_gaps_tpu_torch.ops.fma_probe import fma_latency_ns, probe
from mind_the_gaps_tpu_torch.simulator import Simulator
from mind_the_gaps_tpu_torch.solver.batched import batched_log_likelihood

# BASELINE.md: max(88.1 measured, 670 published) evals/s a core x 12 cores
CPU_PIPELINE_BASELINE_EVALS_PER_SEC = 8_040.0
METRIC = "GP loglike evals/sec (N=5k, DRW+QPO kernel, f32 path, f64-checked)"
# the JSON line's keys: the JAX bench's (but its TPU estimate and its
# watchdog's), the card, the primary's kernel numbers and the gates' errors
KEYS = (
    "metric", "value", "unit", "vs_baseline", "device", "build_seconds",
    "kernel_ms", "sweep_ms", "plain_ms", "team", "bound_ms", "latency_floor_ms",
    "gate_f32_f64_max_abs_err", "gate_kernel_plain_max_abs_err",
    "bootstrap_chunk_sims", "bootstrap_walkers", "bootstrap_steps", "bootstrap_early_stop",
    "bootstrap_scaled_from_chunk", "bootstrap_chunk_seconds_null", "bootstrap_chunk_seconds_alt",
    "bootstrap_steps_run_null", "bootstrap_steps_run_alt", "bootstrap_10k_seconds",
    "e13_lognormal_lcs_per_sec",
    "derive_posteriors_4k_seconds", "derive_posteriors_steps", "derive_posteriors_walkers",
    "lrt_512_measured_seconds", "lrt_512_t_obs", "lrt_512_p_value",
)
# every library the run loads on a card
LIBRARIES = ("celerite_loglike_f32", "celerite_loglike_f64", "celerite_grad_f64", "bitonic_sort", "fma_chain")
# the card's published peaks (H100 SXM data sheet, at the 700 W limit):
# memory, and float32 / float64 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {4: 67e12, 8: 34e12}


class GateError(RuntimeError):
    """A gate of the primary metric failed; ``record`` is the JSON line the
    run then prints (the JAX bench's error record)."""

    def __init__(self, message):
        super().__init__(message)
        self.record = {"metric": "GP loglike evals/sec (N=5k)", "value": 0.0, "unit": "evals/s",
                       "vs_baseline": 0.0, "error": message}


# ---------------------------------------------------------------------- #
# the card's bound and latency floor of a celerite launch
# ---------------------------------------------------------------------- #
def bound(n_bytes, n_ops, itemsize):
    """(bound ms, what sets it): the least time for ``n_bytes`` of memory
    traffic and ``n_ops`` operations on ``itemsize``-byte floats at the
    card's peaks."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / OPS_PER_S[itemsize] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def celerite_step_ops(jr, jc, dense=False):
    """Floating-point operations of one time step of one likelihood in
    csrc/celerite_loglike.cuh, counted from its loops (an exp, log, sin, cos
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
    """Bound of one celerite launch (``case``: B, N, jr, jc, cols, itemsize,
    sym): each input read once (dt, the data columns, coefficients, mean,
    jitter), the output written once; the operations of the kernel's
    recursion."""
    B, N, jr, jc, cols, item = case["B"], case["N"], case["jr"], case["jc"], case["cols"], case["itemsize"]
    n_bytes = item * (N + 2 * N * cols + B * (2 * jr + 4 * jc) + 3 * B)
    return bound(n_bytes, B * (N - 1) * celerite_step_ops(jr, jc, dense=not case["sym"]), item)


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


# ---------------------------------------------------------------------- #
# the problem and the primary metric
# ---------------------------------------------------------------------- #
def device_line(device) -> str:
    """The device the run took: ``cpu``, or the card's name and power limit
    as ``nvidia-smi --query-gpu=name,power.limit`` gives them."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def data(n_points: int = 5000):
    """The JAX bench's problem (its ``default_rng(0)`` stream): times
    ``cumsum(uniform(2, 8))``, a data column y ~ N(0, 2), the diagonal 0.09
    (float64 numpy arrays) and the DRW + Lorentzian kernel."""
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(2.0, 8.0, n_points))
    y = rng.normal(0.0, 2.0, n_points)
    diag = np.full(n_points, 0.09)
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0) + Lorentzian(log_S0=-1.0, log_Q=2.0, log_omega0=-2.0)
    return t, y, diag, kernel


def parameter_rows(theta0, batch: int, seed: int, dtype, device):
    """(batch, D) rows theta0 + 0.05 x standard normals in ``dtype``, the
    normals from a ``torch.Generator`` on ``device`` seeded ``seed``."""
    gen = torch.Generator(device).manual_seed(seed)
    noise = torch.randn((batch, len(theta0)), generator=gen, dtype=dtype, device=device)
    return torch.as_tensor(theta0, dtype=dtype, device=device) + 0.05 * noise


def sweep(kernel, thetas, t, y, diag):
    """(B,) log-likelihoods of the parameter rows ``thetas`` (B, D): their
    coefficients, then one call of the op (the JAX bench's
    ``sweep_pallas``)."""
    return celerite_log_likelihood(kernel.coefficients(thetas), t, y, diag)


def gate_f32_f64(kernel, thetas, data64, data32, tol: float = 1.0) -> float:
    """The JAX bench's first gate: the float32 op against the float64 op on
    the float64 rows ``thetas``, the coefficients computed in float64 and
    cast (as its ``gate32``).  Returns the largest |difference|; raises
    GateError when a float64 value is not finite or the difference is not
    within ``tol``."""
    c64 = kernel.coefficients(thetas)
    ll64 = celerite_log_likelihood(c64, *data64)
    ll32 = celerite_log_likelihood(type(c64)(*(c.float() for c in c64)), *data32)
    max_err = float((ll64 - ll32.double()).abs().max())
    if not bool(torch.isfinite(ll64).all()) or not max_err <= tol:
        raise GateError(f"f32/f64 mismatch {max_err}")
    return max_err


def gate_kernel_plain(out, ref, tol: float = 0.5) -> float:
    """The JAX bench's second gate: the op's values ``out`` against the plain
    version's ``ref`` on the same rows.  Returns the largest |difference|
    (equal infinities differ by 0); raises GateError above ``tol`` or on a
    NaN."""
    err = torch.where(out == ref, torch.zeros_like(out), (out - ref).abs())
    max_err = float(err.max())
    if not max_err <= tol:
        raise GateError(f"kernel/plain mismatch {max_err}")
    return max_err


def elapsed_s(device, fn) -> float:
    """Seconds of ``fn()``: between two CUDA events on a card, one
    synchronise at the end; the host clock elsewhere."""
    if device.type != "cuda":
        start = time.perf_counter()
        fn()
        return time.perf_counter() - start
    with torch.cuda.device(device):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3


def primary(t, y, diag, kernel, batch: int = 65_536, reps: int = 4, device="cuda", latency_ns=None) -> dict:
    """The primary metric on ``device``: gate 1 on 8 float64 rows (seed 7),
    the batch's rows (seed 1) through the op and gate 2 against the plain
    version, one warm-up sweep, then ``reps`` sweeps on fresh rows (seeds
    100 + r) timed together; then the op alone on those rows' coefficients.

    ``latency_ns``: the card's float32 dependent-FMA latency for the latency
    floor (measured here with ``ops.fma_probe.probe`` when None).  Off a
    card the kernel numbers (``kernel_ms``, ``team``, ``bound_ms``,
    ``latency_floor_ms``) are None.  Returns the JSON line's primary keys
    and the batch's rows and values (``thetas``, ``out``), the op's launches
    in this call (``launches``: 4 + 2 reps on a card) and the plain
    version's time."""
    dev = torch.device(device)
    theta0 = kernel.get_parameter_vector()
    data64 = tuple(torch.as_tensor(a, dtype=torch.float64, device=dev) for a in (t, y, diag))
    data32 = tuple(a.float() for a in data64)
    launches = ops.celerite_log_likelihood.launches

    gate1 = gate_f32_f64(kernel, parameter_rows(theta0, 8, 7, torch.float64, dev), data64, data32)
    thetas = parameter_rows(theta0, batch, 1, torch.float32, dev)
    out = sweep(kernel, thetas, *data32)
    synchronize(dev)
    start = time.perf_counter()
    ref = batched_log_likelihood(kernel.coefficients(thetas), *data32)
    synchronize(dev)
    plain_ms = (time.perf_counter() - start) * 1e3
    gate2 = gate_kernel_plain(out, ref)

    sweep(kernel, thetas, *data32)  # warm-up
    inputs = [parameter_rows(theta0, batch, 100 + r, torch.float32, dev) for r in range(reps)]
    seconds = elapsed_s(dev, lambda: [sweep(kernel, th, *data32) for th in inputs])
    evals = batch * reps / seconds

    rec = {"metric": METRIC, "value": evals, "unit": "evals/s",
           "vs_baseline": evals / CPU_PIPELINE_BASELINE_EVALS_PER_SEC, "sweep_ms": seconds / reps * 1e3,
           "plain_ms": plain_ms, "kernel_ms": None, "team": None, "bound_ms": None, "bound_by": None,
           "latency_floor_ms": None, "gate_f32_f64_max_abs_err": gate1, "gate_kernel_plain_max_abs_err": gate2,
           "thetas": thetas, "out": out}
    if dev.type == "cuda":
        coeffs = [kernel.coefficients(th) for th in inputs]
        rec["kernel_ms"] = elapsed_s(dev, lambda: [celerite_log_likelihood(c, *data32) for c in coeffs]) / reps * 1e3
        if latency_ns is None:
            latency_ns = fma_latency_ns(probe(device=dev))["float32"]
        c0 = kernel.coefficients()
        case = dict(B=batch, N=len(t), jr=c0.ar.shape[-1], jc=c0.ac.shape[-1], cols=1, itemsize=4, sym=True)
        rec["team"] = batch_team(kernel, batch, dev)
        rec["bound_ms"], rec["bound_by"] = celerite_bound(case)
        rec["latency_floor_ms"] = latency_floor_ms(case, latency_ns)
    rec["launches"] = ops.celerite_log_likelihood.launches - launches
    return rec


# ---------------------------------------------------------------------- #
# the wall-clock phases
# ---------------------------------------------------------------------- #
def bootstrap_rows(y, diag, chunk_sims: int = 512):
    """The bootstrap chunk's simulated rows, the JAX bench's: y + N(0, 0.3)
    from ``default_rng(42)`` as float32 (chunk_sims, N), and the diagonal
    broadcast to them (a read-only float32 view)."""
    rng = np.random.default_rng(42)
    ys = (np.asarray(y)[None, :] + rng.normal(0.0, 0.3, (chunk_sims, len(y)))).astype(np.float32)
    return ys, np.broadcast_to(np.asarray(diag, dtype=np.float32), ys.shape)


def bootstrap_chunk_seconds(t, y, diag, chunk_sims: int = 512, walkers: int = 12, n_steps: int = 500,
                            nsims_total: int = 10_000, device="cuda") -> dict:
    """One production bootstrap chunk: ``lrt.batched_max_loglike`` of the
    ``bootstrap_rows`` with the null (DRW) and then the alternative (DRW +
    Lorentzian) kernel, from the kernel's vector, ``walkers`` x ``n_steps``,
    percent 0.1, the early stop (0.01, 50), float32 (the times float32, as
    the JAX bench's).  Each model warms up with generator seed 0 and is
    timed with seed 1; ``bootstrap_10k_seconds`` is their sum scaled to
    ``nsims_total`` simulations.  Also returns each model's steps run and
    best log-likelihoods (``bootstrap_best_loglikes``)."""
    dev = torch.device(device)
    ys, diags = bootstrap_rows(y, diag, chunk_sims)
    ys_t = torch.as_tensor(ys, device=dev)
    diags_t = torch.as_tensor(np.ascontiguousarray(diags), device=dev)
    tt = torch.as_tensor(t, dtype=torch.float32, device=dev)
    null = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0)
    alt = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0) + Lorentzian(log_S0=-1.0, log_Q=2.0, log_omega0=-2.0)
    out = {"bootstrap_chunk_sims": chunk_sims, "bootstrap_walkers": walkers, "bootstrap_steps": n_steps,
           "bootstrap_early_stop": [0.01, 50], "bootstrap_scaled_from_chunk": True, "bootstrap_best_loglikes": {}}
    total = 0.0
    for name, kernel in (("null", null), ("alt", alt)):
        def refit(seed):
            return batched_max_loglike(kernel, tt, ys_t, diags_t, kernel.get_parameter_vector(), walkers=walkers,
                                       n_steps=n_steps, percent=0.1, dtype=torch.float32, early_stop=(0.01, 50),
                                       generator=torch.Generator(dev).manual_seed(seed))

        refit(0)  # warm-up
        synchronize(dev)
        start = time.perf_counter()
        lls, _ = refit(1)
        synchronize(dev)
        seconds = time.perf_counter() - start
        out[f"bootstrap_chunk_seconds_{name}"] = seconds
        # two likelihood calls start the chains, two a step follow
        out[f"bootstrap_steps_run_{name}"] = batched_max_loglike.shard_launches[0] // 2 - 1
        out["bootstrap_best_loglikes"][name] = lls
        total += seconds
    out["bootstrap_10k_seconds"] = total * nsims_total / chunk_sims
    return out


def e13_problem(device, n_points: int = 500, B: int = 256):
    """The JAX bench's E13 problem on ``device``: the lognormal simulator of
    the tutorial-scale segment (n=500 times ``cumsum(uniform(4, 9))``, ~6.6k
    fine samples -> the 8192 power-of-two cut) and ``B`` DRW PSDs (B,
    n_freq) at theta0 + 0.15 x normals, both from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(4.0, 9.0, n_points))
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0)
    theta0 = kernel.get_parameter_vector()
    sim = Simulator(kernel.get_psd, t, exposures=1.0, mean=10.0, pdf="lognormal", extension_factor=2,
                    max_iter=400, device=device)
    omega = torch.as_tensor(sim.omega[1:], dtype=torch.float64, device=device)
    thetas = torch.as_tensor(theta0[None, :] + 0.15 * rng.standard_normal((B, 2)), device=device)
    psd = kernel.get_psd(omega, thetas)
    return sim, torch.cat([psd.new_zeros((B, 1)), psd], dim=1)


def e13_generation_rate(n_points: int = 500, B: int = 256, device="cuda") -> dict:
    """Lognormal (E13) generation of ``e13_problem``: one warm-up call
    (generator seed 1), then the timed call (seed 2).  Returns the rate
    (``e13_lognormal_lcs_per_sec``), the seconds, the rates, the simulator
    (its cut and iteration counts) and the timed call's ``rank_remap``
    launches."""
    dev = torch.device(device)
    sim, psd = e13_problem(dev, n_points, B)
    sim.simulate_batch(psd, generator=torch.Generator(dev).manual_seed(1))
    synchronize(dev)
    launches = ops.rank_remap.launches
    start = time.perf_counter()
    rates = sim.simulate_batch(psd, generator=torch.Generator(dev).manual_seed(2))
    synchronize(dev)
    seconds = time.perf_counter() - start
    return {"e13_lognormal_lcs_per_sec": B / seconds, "e13_seconds": seconds, "e13_rates": rates,
            "e13_simulator": sim, "e13_remap_launches": ops.rank_remap.launches - launches}


def derive_posteriors_seconds(t, y, diag, steps: int = 4000, walkers: int = 32, device="cuda") -> dict:
    """The observed-fit sampler: ``derive_posteriors`` of the DRW + Lorentzian
    with the JAX bench's bounds on the lightcurve (t, y + 10, sqrt(diag)),
    ``walkers`` walkers spread around the initial parameters (numpy seed 0),
    ``steps`` steps without stopping at convergence; a warm-up run (seed
    11), then the timed run (seed 12).  Returns the seconds and the timed
    run's celerite launches."""
    lc = GappyLightcurve(np.asarray(t), np.asarray(y) + 10.0, np.sqrt(np.asarray(diag)))
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)]) + Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)]
    )
    gp = GPModelling(lc, kernel, device=device)
    init = gp.spread_walkers(walkers, np.asarray(gp.initial_params), np.array(gp.get_parameter_bounds(), dtype=object),
                             rng=np.random.default_rng(0))
    with warnings.catch_warnings():  # converge=False: "did not converge" is expected
        warnings.simplefilter("ignore")
        gp.derive_posteriors(initial_chain_params=init, max_steps=steps, converge=False, seed=11)
        synchronize(gp.device)
        start = time.perf_counter()
        gp.derive_posteriors(initial_chain_params=init, max_steps=steps, converge=False, seed=12)
        synchronize(gp.device)
        seconds = time.perf_counter() - start
    return {"derive_posteriors_4k_seconds": seconds, "derive_posteriors_steps": steps,
            "derive_posteriors_walkers": walkers, "derive_posteriors_launches": gp.timings["sampling_launches"]}


def lrt_512_measured_seconds(n_points: int = 5000, nsims: int = 512, observed_max_steps: int = 10_000,
                             sim_steps: int = 500, device="cuda") -> dict:
    """One measured ``protassov_lrt`` (not chunk-scaled) on
    ``examples.lrt_10k.scenario(n_points)``, the JAX bench's DRW-true data:
    the observed fits (32 walkers, up to ``observed_max_steps`` steps),
    ``nsims`` simulations refit with both models (12 walkers x
    ``sim_steps``, chunk 512), seed 0."""
    lc, null, alt = lrt_10k.scenario(n_points)
    start = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = protassov_lrt(lc, null, alt, nsims=nsims, seed=0, observed_max_steps=observed_max_steps,
                               observed_walkers=32, sim_max_steps=sim_steps, sim_walkers=12, chunk=512,
                               device=device)
    return {"lrt_512_measured_seconds": time.perf_counter() - start, "lrt_512_t_obs": float(result.t_obs),
            "lrt_512_p_value": float(result.p_value)}


def run(device="cuda", n_points: int = 5000, batch: int = 65_536, reps: int = 4, chunk_sims: int = 512,
        boot_walkers: int = 12, boot_steps: int = 500, e13_batch: int = 256, dp_steps: int = 4000,
        dp_walkers: int = 32, lrt_nsims: int = 512, lrt_observed_steps: int = 10_000, lrt_sim_steps: int = 500) -> dict:
    """Every phase on ``device``, in the JAX bench's order; the sizes default
    to its own.  Returns the JSON line's values (``KEYS``) and each phase's
    other results.  Raises GateError when a gate fails."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench runs on the card unless given device='cpu'")
    t0 = time.perf_counter()

    def mark(msg):
        print(f"[bench +{time.perf_counter() - t0:7.1f}s] {msg}", file=sys.stderr, flush=True)

    out = {"device": device_line(dev), "build_seconds": None}
    if dev.type == "cuda":
        from mind_the_gaps_tpu_torch.ops import _build

        _build.build(*LIBRARIES)
        out["build_seconds"] = time.perf_counter() - t0
        mark(f"built {', '.join(LIBRARIES)}")
    t, y, diag, kernel = data(n_points)
    out.update(primary(t, y, diag, kernel, batch=batch, reps=reps, device=dev))
    mark(f"primary: {out['value']:.1f} evals/s")
    out.update(bootstrap_chunk_seconds(t, y, diag, chunk_sims=chunk_sims, walkers=boot_walkers, n_steps=boot_steps,
                                       device=dev))
    mark("bootstrap chunk done")
    out.update(e13_generation_rate(B=e13_batch, device=dev))
    mark("E13 generation done")
    out.update(derive_posteriors_seconds(t, y, diag, steps=dp_steps, walkers=dp_walkers, device=dev))
    mark("derive_posteriors done")
    out.update(lrt_512_measured_seconds(n_points, nsims=lrt_nsims, observed_max_steps=lrt_observed_steps,
                                        sim_steps=lrt_sim_steps, device=dev))
    mark("lrt_512 done")
    return out


def main(argv=None, **sizes):
    """The command line: ``--device`` (default cuda).  ``sizes``: ``run``'s
    keyword sizes (small ones for a test).  Prints the JSON line of ``KEYS``
    and returns ``run``'s dict; a failed gate prints its error record and
    exits 1."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        out = run(device=args.device, **sizes)
    except GateError as e:
        print(json.dumps(e.record), flush=True)
        print(f"[bench] gate failed: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
    print(json.dumps({key: out[key] for key in KEYS}), flush=True)
    return out


if __name__ == "__main__":
    main()
