"""``protassov_lrt`` over a mesh of processes: two ``gloo`` ranks on the CPU,
one position each (``parallel.process_mesh()``), against the run of one
process on one device.

The ranks run once (``_RANK``), every case reads their result files:
1. the whole LRT with a checkpoint: rank 0 runs the observed fits and
   broadcasts their posterior state; each chunk is generated in full on
   every rank and each rank refits its own rows ("gspmd");
2. the checkpoint rewound by rank 0 to 1 of its 3 chunks, then the LRT
   again on the models of 1: every rank reads the file and resumes after
   chunk 1 (2 of the 3 chunks' refits run).

Contract: on both ranks, in both runs, the T distribution, T_obs, the
p-values and the observed posterior samples equal the one-device run's
exactly (N = 200, 16 simulations in chunks of 8).
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import warnings  # noqa: E402

import numpy as np  # noqa: E402

from mind_the_gaps_tpu_torch.lrt import protassov_lrt  # noqa: E402

_spec = importlib.util.spec_from_file_location("_torch_distributed",
                                               Path(__file__).with_name("test_torch_distributed.py"))
_distributed = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_distributed)

PROBLEM = r"""
import numpy as np

import mind_the_gaps_tpu_torch.kernels as tk
from mind_the_gaps_tpu_torch import GappyLightcurve

SETTINGS = dict(nsims=16, chunk=8, observed_max_steps=50, observed_walkers=8, sim_max_steps=15, sim_walkers=8,
                seed=21, device="cpu")


def lrt_problem(n=200):
    # an exact DRW realization (S0 = 4, omega0 = 0.05) plus noise, dy 0.3
    rng = np.random.default_rng(7)
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    phi = np.exp(-0.05 * np.diff(t))
    y = np.empty(n)
    y[0] = rng.normal(0.0, 2.0)
    innov = rng.normal(0.0, np.sqrt(4.0 * (1.0 - phi**2)))
    for i in range(1, n):
        y[i] = phi[i - 1] * y[i - 1] + innov[i - 1]
    lc = GappyLightcurve(t, 10.0 + y + rng.normal(0.0, 0.3, n), np.full(n, 0.3), exposures=1.0)
    null = tk.DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    alt = null + tk.Lorentzian(log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)])
    return lc, null, alt
"""
_problem = {}
exec(PROBLEM, _problem)

_RANK = PROBLEM + r"""
import os
import sys
import warnings

import torch

torch.set_num_threads(1)

from mind_the_gaps_tpu_torch import lrt
from mind_the_gaps_tpu_torch.parallel import barrier, initialize, process_mesh, shutdown

initialize(device="cpu")
rank = torch.distributed.get_rank()
mesh = process_mesh()
lc, null, alt = lrt_problem()
ckpt = os.path.join(os.path.dirname(sys.argv[1]), "boot.npz")
calls = []
refit = lrt.batched_max_loglike


def counted(*args, **kwargs):
    calls.append(kwargs.get("mesh"))
    return refit(*args, **kwargs)


lrt.batched_max_loglike = counted
out = {}
with warnings.catch_warnings():
    warnings.simplefilter("ignore")  # 50-step observed chains do not converge
    full = lrt.protassov_lrt(lc, null, alt, mesh=mesh, checkpoint=ckpt, **SETTINGS)
out["full_calls"] = len(calls)
out["full_meshed"] = all(m is mesh for m in calls)
out["full_launches"] = np.array(lrt.batched_max_loglike.shard_launches)
with np.load(ckpt) as d:
    saved = {k: d[k] for k in d.files}
out["chunks_written"] = int(saved["chunks_done"])
barrier()
if rank == 0:  # an interruption: the file rewound to 1 of its 3 chunks
    np.savez(ckpt + ".tmp.npz", config_crc=saved["config_crc"], chunks_done=np.int64(1),
             null_done=saved["null_done"][:8], alt_done=saved["alt_done"][:8])
    os.replace(ckpt + ".tmp.npz", ckpt)
barrier()
calls.clear()
resumed = lrt.protassov_lrt(lc, null, alt, mesh=mesh, checkpoint=ckpt, null_model=full.null_model,
                            alt_model=full.alt_model, **SETTINGS)
out["resumed_calls"] = len(calls)
for name, res in (("full", full), ("resumed", resumed)):
    out[name + "_t_dist"] = res.t_dist
    out[name + "_scalars"] = np.array([res.t_obs, res.p_value, res.t_obs_posterior, res.p_value_posterior])
    out[name + "_null_samples"] = res.null_model.mcmc_samples
    out[name + "_alt_samples"] = res.alt_model.mcmc_samples
np.savez(sys.argv[1] + f".rank{rank}.npz", **out)
shutdown()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _distributed.run_ranks(_RANK, tmp_path_factory.mktemp("distributed_lrt") / "out")


@pytest.fixture(scope="module")
def reference():
    lc, null, alt = _problem["lrt_problem"]()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return protassov_lrt(lc, null, alt, **_problem["SETTINGS"])


def test_the_ranks_ran_over_the_processes_mesh(ranks):
    for r in ranks:
        assert int(r["full_calls"]) == 6 and bool(r["full_meshed"])  # 3 chunks, null and alternative
        assert int(r["chunks_written"]) == 3
        assert int(r["resumed_calls"]) == 4  # resumed after chunk 1 of 3
        assert len(r["full_launches"]) == 1  # one position a rank


@pytest.mark.parametrize("run", ["full", "resumed"])
def test_protassov_lrt_over_processes_equals_one_device(ranks, reference, run):
    ref = reference
    assert np.all(np.isfinite(ref.t_dist)) and ref.t_dist.shape == (16,)
    for r in ranks:
        assert np.array_equal(r[run + "_t_dist"], ref.t_dist)
        np.testing.assert_array_equal(r[run + "_scalars"],
                                      [ref.t_obs, ref.p_value, ref.t_obs_posterior, ref.p_value_posterior])
        assert np.array_equal(r[run + "_null_samples"], ref.null_model.mcmc_samples)
        assert np.array_equal(r[run + "_alt_samples"], ref.alt_model.mcmc_samples)
