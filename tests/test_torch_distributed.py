"""The port across processes: ``parallel.distributed`` and the refits and E13
generation over a mesh of processes, two ``gloo`` ranks on the CPU (the
counterpart of tests/test_multihost.py, whose ranks are JAX processes).

One pair of ranks runs every scenario of this file (``_RANK``); each rank
writes its results to one file, and a module-scoped fixture reads both into
the parametrised cases, so that the processes start once.  Each rank joins
the group from the environment that torchrun would set (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).

Contracts, each on both ranks (every rank returns the whole result):
- ``process_allgather`` with uneven blocks, ``process_any`` and
  ``broadcast_bytes`` give every rank the same, exact values;
- under a group ``default_mesh()`` is ``process_mesh()``;
- "shard_map" over 2 processes x 2 CPU devices equals ``Mesh((cpu,) * 4)``
  in one process bit for bit (``torch.equal``), at test_multihost.py's shape
  (48 points, 16 simulations, 8 walkers, 5 steps), with a shared and a
  per-row start;
- "gspmd" over 2 processes (and 2 x 2 devices) equals the unsharded run bit
  for bit, with and without the early stop;
- ``fit_lightcurves_batch(use_mesh=True)`` under the group shards over the
  processes: with "gspmd" it equals the unsharded result exactly; with
  "shard_map" it is held against the JAX package's
  ``fit_lightcurves_batch(spmd="shard_map")``.  The two use other random
  streams (threefry against the port's generators), so that is a statistical
  check, at the tolerance of
  tests/test_torch_mesh.py::test_shard_map_agrees_with_jax_shard_map (rtol
  0.05, atol 2.0);
- E13 ``simulate_batch`` over 2 processes x 2 devices at _CHILD_E13's
  problem (64 points, 16 simulations, Lognormal, extension 1.2, max_iter
  50) equals the single-process call bit for bit, with the same iteration
  counts and non-convergence count, at the default chunk and at chunks of
  3 rows.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

import mind_the_gaps_tpu_torch.kernels as tk  # noqa: E402
from mind_the_gaps_tpu_torch.lrt import _derived_generator, batched_max_loglike, fit_lightcurves_batch  # noqa: E402
from mind_the_gaps_tpu_torch.parallel import Mesh, default_mesh, initialize, process_mesh  # noqa: E402
from mind_the_gaps_tpu_torch.simulator import Simulator  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
RANKS = 2

# the problems, shared by the ranks and the references
PROBLEMS = r"""
import numpy as np
import torch

import mind_the_gaps_tpu_torch.kernels as tk
from mind_the_gaps_tpu_torch.simulator import Simulator

CPU = torch.device("cpu")


def multihost_problem():
    # tests/test_multihost.py's: 48 points, 16 simulations
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(1.0, 3.0, 48))
    ys = rng.normal(5.0, 1.0, (16, 48))
    kernel = tk.DampedRandomWalk(log_S0=1.0, log_omega0=-2.0, bounds=[(-5, 10), (-8, 2)])
    per_row = kernel.get_parameter_vector() + rng.normal(0.0, 0.05, (16, kernel.ndim))
    return (kernel, torch.as_tensor(t), torch.as_tensor(ys), torch.full((16, 48), 0.04, dtype=torch.float64),
            {"shared": kernel.get_parameter_vector(), "per_row": per_row})


def gspmd_problem():
    # tests/test_torch_mesh.py's: 7 lightcurves of 40 points, the DRW+QPO alternative
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(2.0, 8.0, 40))
    ys = 10.0 + rng.normal(0.0, 1.0, (7, 40))
    null = tk.DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    alt = null + tk.Lorentzian(log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)])
    return alt, torch.as_tensor(t), torch.as_tensor(ys), torch.full((7, 40), 0.09, dtype=torch.float64)


def jax_problem():
    # tests/test_torch_mesh.py::test_shard_map_agrees_with_jax_shard_map's
    rng = np.random.default_rng(2)
    n, B = 100, 16
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    y = 10.0 + np.cumsum(rng.normal(0.0, 0.4, n)) * 0.3
    ys = y[None, :] + rng.normal(0, 0.3, (B, n))
    return t, ys, np.full((B, n), 0.3), np.array([np.log(4.0), np.log(0.05)]), [(-5, 10), (-8, 2)]


def e13_problem():
    # tests/test_multihost.py's _CHILD_E13: 64 points, 16 simulations, Lognormal
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(1.0, 3.0, 64))
    kernel = tk.DampedRandomWalk(log_S0=1.0, log_omega0=-2.0)
    theta0 = kernel.get_parameter_vector()
    sim = Simulator(kernel.get_psd, t, exposures=0.5, mean=10.0, pdf="Lognormal", extension_factor=1.2,
                    max_iter=50, device="cpu")
    thetas = torch.as_tensor(theta0[None, :] + 0.1 * rng.standard_normal((16, kernel.ndim)))
    psd = kernel.get_psd(torch.as_tensor(sim.omega[1:]), thetas)
    return sim, torch.cat([psd.new_zeros((16, 1)), psd], dim=1)
"""
_problems = {}
exec(PROBLEMS, _problems)

GSPMD_STOPS = {"none": None, "early": (0.05, 4)}
E13_CHUNKS = {"default": None, "chunk3": 3}

_RANK = PROBLEMS + r"""
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from mind_the_gaps_tpu_torch.lrt import _derived_generator, batched_max_loglike, fit_lightcurves_batch
from mind_the_gaps_tpu_torch.parallel import (
    broadcast_bytes, default_mesh, initialize, process_allgather, process_any, process_mesh, shutdown,
)

out = {}
dev = initialize(device="cpu")  # from RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT
rank, world = int(torch.distributed.get_rank()), int(torch.distributed.get_world_size())
out["rank"], out["world"], out["device"] = rank, world, str(dev)

# collectives: uneven blocks (3 rows on rank 0, 5 on rank 1), three dtypes
n = 3 + 2 * rank
out["gather_f64"] = process_allgather(torch.arange(2 * n, dtype=torch.float64).reshape(n, 2) + 100 * rank).numpy()
out["gather_i32"] = process_allgather(torch.arange(n, dtype=torch.int32) + 10 * rank).numpy()
out["gather_bool"] = process_allgather(torch.arange(n) % 2 == rank).numpy()
out["gather_scalar"] = process_allgather(torch.tensor(float(rank))).numpy()
out["gather_stacked"] = process_allgather(torch.full((2,), rank), tiled=False).numpy()
try:
    process_allgather(torch.zeros(n), tiled=False)
    out["uneven_stack_raises"] = False
except ValueError:
    out["uneven_stack_raises"] = True
out["any_one"] = process_any(torch.tensor(rank == 1))
out["any_none"] = process_any(False)
out["broadcast"] = np.frombuffer(broadcast_bytes(b"rank 0's bytes" if rank == 0 else None), dtype=np.uint8)

mesh = process_mesh((CPU, CPU))
out["mesh"] = np.array([mesh.size, mesh.process_index, mesh.process_count, *mesh.local_positions])
out["default_mesh_is_process_mesh"] = default_mesh() == process_mesh() and default_mesh().size == world

# shard_map over 2 processes x 2 devices
kernel, t, ys, diags, starts = multihost_problem()
for name, theta0 in starts.items():
    gens = [_derived_generator(CPU, 0, 0, k) for k in mesh.local_positions]
    lp, x = batched_max_loglike(kernel, t, ys, diags, theta0, walkers=8, n_steps=5, generator=gens, mesh=mesh,
                                spmd="shard_map")
    out[f"shard_map_{name}_lp"], out[f"shard_map_{name}_x"] = lp.numpy(), x.numpy()

# gspmd over 2 processes, and over 2 x 2 devices
alt, t, ys, diags = gspmd_problem()
for stop_name, stop in (("none", None), ("early", (0.05, 4))):
    for local in (1, 2):
        lp, x = batched_max_loglike(alt, t, ys, diags, alt.get_parameter_vector(), walkers=8, n_steps=40,
                                    early_stop=stop, generator=_derived_generator(CPU, 3, 0),
                                    mesh=process_mesh((CPU,) * local))
        key = f"gspmd_{stop_name}_{local}"
        out[key + "_lp"], out[key + "_x"] = lp.numpy(), x.numpy()
        out[key + "_launches"] = np.array(batched_max_loglike.shard_launches)

# fit_lightcurves_batch(use_mesh=True): the mesh of the processes
t, ys, dys, theta0, bounds = jax_problem()
drw = tk.DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=bounds)
out["fit_shard_map_lls"], out["fit_shard_map_xs"] = fit_lightcurves_batch(
    drw, t, ys, dys, theta0, walkers=8, n_steps=150, use_mesh=True, spmd="shard_map", seed=3, device="cpu")
out["fit_shard_map_launches"] = np.array(batched_max_loglike.shard_launches)
out["fit_gspmd_lls"], out["fit_gspmd_xs"] = fit_lightcurves_batch(
    drw, t, ys[:5], dys[:5], theta0, walkers=8, n_steps=30, chunk=3, seed=2, use_mesh=True, device="cpu")
out["fit_gspmd_launches"] = np.array(batched_max_loglike.shard_launches)

# E13 generation over 2 processes x 2 devices
sim, psd = e13_problem()
for name, chunk in (("default", None), ("chunk3", 3)):
    rates = sim.simulate_batch(psd, generator=torch.Generator().manual_seed(1), chunk=chunk,
                               warn_nonconverged=False, mesh=mesh)
    out[f"e13_{name}_rates"] = rates.numpy()
    out[f"e13_{name}_iters"] = sim._last_e13_iters.numpy()
    out[f"e13_{name}_nonconv"] = sim.report_nonconverged(warn=False)

np.savez(sys.argv[1] + f".rank{rank}.npz", **out)
shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(script: str, out_prefix, ranks: int = RANKS, timeout: float = 180.0):
    """Start ``ranks`` processes of ``script`` (argv[1]: ``out_prefix``) on the
    CPU with torchrun's environment and a free port on 127.0.0.1; wait for
    them (``timeout`` seconds in all), kill any left in ``finally``; returns
    each rank's ``<out_prefix>.rank<r>.npz`` as a dict."""
    port = _free_port()
    procs = []
    try:
        for rank in range(ranks):
            env = dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE=str(ranks), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen([sys.executable, "-c", script, str(out_prefix)], cwd=ROOT, env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    results = []
    for rank in range(ranks):
        with np.load(f"{out_prefix}.rank{rank}.npz") as d:
            results.append({k: d[k] for k in d.files})
    return results


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_RANK, tmp_path_factory.mktemp("distributed") / "out")


def _each(ranks, key):
    return [r[key] for r in ranks]


# --------------------------------------------------------------------------- #
# the module
# --------------------------------------------------------------------------- #
def test_initialize_from_the_environment(ranks):
    assert [int(r["rank"]) for r in ranks] == [0, 1]
    assert all(int(r["world"]) == RANKS and str(r["device"]) == "cpu" for r in ranks)


def test_initialize_refuses_the_cpu_without_asking(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize()
    with pytest.raises(ValueError, match="device"):
        initialize(device="meta")


@pytest.mark.parametrize("key,expected", [
    ("gather_f64", np.concatenate([np.arange(6.0).reshape(3, 2), np.arange(10.0).reshape(5, 2) + 100])),
    ("gather_i32", np.array([0, 1, 2, 10, 11, 12, 13, 14], dtype=np.int32)),
    ("gather_bool", np.array([True, False, True, False, True, False, True, False])),
    ("gather_scalar", np.array([0.0, 1.0], dtype=np.float32)),
    ("gather_stacked", np.array([[0, 0], [1, 1]])),
    ("uneven_stack_raises", np.array(True)),
    ("any_one", np.array(True)),
    ("any_none", np.array(False)),
    ("broadcast", np.frombuffer(b"rank 0's bytes", dtype=np.uint8)),
])
def test_collectives(ranks, key, expected):
    for got in _each(ranks, key):
        assert got.dtype == expected.dtype
        np.testing.assert_array_equal(got, expected)


def test_process_mesh_positions(ranks):
    """Rank p of 2 with 2 devices holds positions 2p and 2p + 1 of 4."""
    for p, got in enumerate(_each(ranks, "mesh")):
        np.testing.assert_array_equal(got, [4, p, 2, 2 * p, 2 * p + 1])
    assert all(bool(v) for v in _each(ranks, "default_mesh_is_process_mesh"))


def test_one_process_mesh():
    mesh = process_mesh((CPU,) * 3)
    assert mesh == Mesh((CPU,) * 3) and mesh.size == 3 and mesh.local_positions == range(3)
    assert default_mesh(devices=[CPU] * 3) == mesh
    with pytest.raises(ValueError, match="process_index"):
        Mesh((CPU,), process_index=2, process_count=2)


def test_observed_fits_refuse_a_mesh_of_processes():
    from mind_the_gaps_tpu_torch import GappyLightcurve
    from mind_the_gaps_tpu_torch.gpmodelling import GPModelling

    t = np.cumsum(np.random.default_rng(0).uniform(1.0, 3.0, 20))
    gp = GPModelling(GappyLightcurve(t, np.full(20, 5.0), np.full(20, 0.2)),
                     tk.DampedRandomWalk(log_S0=1.0, log_omega0=-2.0), device="cpu")
    with pytest.raises(ValueError, match="one process"):
        gp.derive_posteriors(fit=False, max_steps=4, mesh=Mesh((CPU,), process_index=0, process_count=2))


# --------------------------------------------------------------------------- #
# the refits
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("start", ["shared", "per_row"])
def test_shard_map_over_processes_equals_one_process(ranks, start):
    kernel, t, ys, diags, starts = _problems["multihost_problem"]()
    gens = [_derived_generator(CPU, 0, 0, k) for k in range(4)]
    lp, x = batched_max_loglike(kernel, t, ys, diags, starts[start], walkers=8, n_steps=5, generator=gens,
                                mesh=Mesh((CPU,) * 4), spmd="shard_map")
    assert bool(torch.isfinite(lp).all())
    for got_lp, got_x in zip(_each(ranks, f"shard_map_{start}_lp"), _each(ranks, f"shard_map_{start}_x")):
        assert torch.equal(torch.as_tensor(got_lp), lp) and torch.equal(torch.as_tensor(got_x), x)


@pytest.mark.parametrize("local", [1, 2])
@pytest.mark.parametrize("stop", sorted(GSPMD_STOPS))
def test_gspmd_over_processes_equals_unsharded(ranks, stop, local):
    alt, t, ys, diags = _problems["gspmd_problem"]()
    lp, x = batched_max_loglike(alt, t, ys, diags, alt.get_parameter_vector(), walkers=8, n_steps=40,
                                early_stop=GSPMD_STOPS[stop], generator=_derived_generator(CPU, 3, 0))
    (ref_launches,) = batched_max_loglike.shard_launches
    key = f"gspmd_{stop}_{local}"
    for r in ranks:
        assert torch.equal(torch.as_tensor(r[key + "_lp"]), lp) and torch.equal(torch.as_tensor(r[key + "_x"]), x)
        # every position of every rank ran every step: the rule stopped them all together
        np.testing.assert_array_equal(r[key + "_launches"], [ref_launches] * local)
    if stop == "early":
        assert ref_launches < 2 + 2 * 40, "the early stop never stopped early: the case tests nothing"


def test_fit_lightcurves_batch_gspmd_over_processes(ranks):
    t, ys, dys, theta0, bounds = _problems["jax_problem"]()
    drw = tk.DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=bounds)
    ref = fit_lightcurves_batch(drw, t, ys[:5], dys[:5], theta0, walkers=8, n_steps=30, chunk=3, seed=2,
                                device="cpu")
    for r in ranks:
        assert np.array_equal(r["fit_gspmd_lls"], ref[0]) and np.array_equal(r["fit_gspmd_xs"], ref[1])
        assert len(r["fit_gspmd_launches"]) == 1  # one position a rank: the processes' mesh


def test_fit_lightcurves_batch_shard_map_agrees_with_jax(ranks):
    """The 2-process shard_map against the JAX package's shard_map over its
    8 CPU devices (other random streams: a statistical check)."""
    import jax  # noqa: F401

    from mind_the_gaps_tpu.kernels import DampedRandomWalk as JDRW
    from mind_the_gaps_tpu.lrt import fit_lightcurves_batch as j_fit

    t, ys, dys, theta0, bounds = _problems["jax_problem"]()
    ref, _ = j_fit(jax.random.key(3), JDRW(log_S0=1.0, log_omega0=-3.0, bounds=bounds), t, ys, dys, theta0,
                   walkers=8, n_steps=150, spmd="shard_map")
    lls = _each(ranks, "fit_shard_map_lls")
    assert np.array_equal(lls[0], lls[1]) and lls[0].shape == (16,) and np.all(np.isfinite(lls[0]))
    for r in ranks:
        np.testing.assert_array_equal(r["fit_shard_map_launches"], [302])
    np.testing.assert_allclose(lls[0], ref, rtol=0.05, atol=2.0)


# --------------------------------------------------------------------------- #
# E13 generation
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("chunk", sorted(E13_CHUNKS))
def test_e13_generation_over_processes_equals_one_process(ranks, chunk):
    sim, psd = _problems["e13_problem"]()
    rates = sim.simulate_batch(psd, generator=torch.Generator().manual_seed(1), chunk=E13_CHUNKS[chunk],
                               warn_nonconverged=False)
    iters, nonconv = sim._last_e13_iters, sim.report_nonconverged(warn=False)
    assert rates.shape == (16, 64) and bool(torch.isfinite(rates).all())
    for r in ranks:
        assert torch.equal(torch.as_tensor(r[f"e13_{chunk}_rates"]), rates)
        assert torch.equal(torch.as_tensor(r[f"e13_{chunk}_iters"]), iters)
        assert int(r[f"e13_{chunk}_nonconv"]) == nonconv


@pytest.mark.parametrize("size", [4, 3, 32])
def test_e13_generation_over_a_one_process_mesh(size):
    """The mesh path in one process, blocks even, uneven and empty."""
    sim, psd = _problems["e13_problem"]()
    ref = sim.simulate_batch(psd, generator=torch.Generator().manual_seed(4), warn_nonconverged=False)
    iters, nonconv = sim._last_e13_iters, sim.report_nonconverged(warn=False)
    out = sim.simulate_batch(psd, generator=torch.Generator().manual_seed(4), warn_nonconverged=False,
                             mesh=Mesh((CPU,) * size))
    assert torch.equal(out, ref) and torch.equal(sim._last_e13_iters, iters)
    assert sim.report_nonconverged(warn=False) == nonconv
