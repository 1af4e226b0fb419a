"""The port's mesh: ``parallel`` (``Mesh``, ``default_mesh``, ``shard_batch``,
``gather``, ``pad_to_multiple``), the sharded refits
(``batched_max_loglike(mesh=, spmd=)``, ``fit_lightcurves_batch(use_mesh=,
spmd=)``), ``GPModelling.derive_posteriors(mesh=)`` and ``protassov_lrt``
over a mesh, on meshes of CPU devices (a device may appear in a mesh more
than once).

Contracts:
- ``pad_to_multiple`` equals the JAX function exactly;
- "gspmd" refits and mesh-mode observed fits equal their unsharded runs bit
  for bit (``torch.equal``), with even and uneven shards, a shared and a
  per-row start, with and without the early stop (the counterparts of
  tests/test_mesh_observed_fits.py's three contracts for the observed fits);
- a "shard_map" shard equals an unsharded run of its rows from its own
  generator, bit for bit; against the JAX package's shard_map (other random
  streams, so a statistical check) within rtol 0.05 and atol 2.0, the
  tolerance of tests/test_lrt.py::test_fit_lightcurves_batch_shard_map;
- ``protassov_lrt`` over a two-device mesh gives the unsharded run's T
  distribution, T_obs and p-value exactly.

The ``cuda`` cases run the same bit-identity checks on one card, with two
or three shards on it:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh.py
"""
import inspect
import warnings

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

import mind_the_gaps_tpu_torch.kernels as tk  # noqa: E402
from mind_the_gaps_tpu_torch import GappyLightcurve, lrt  # noqa: E402
from mind_the_gaps_tpu_torch.gpmodelling import GPModelling  # noqa: E402
from mind_the_gaps_tpu_torch.lrt import (  # noqa: E402
    _derived_generator,
    batched_max_loglike,
    fit_lightcurves_batch,
    protassov_lrt,
)
from mind_the_gaps_tpu_torch.ops import celerite as celerite_op  # noqa: E402
from mind_the_gaps_tpu_torch.parallel import Mesh, default_mesh, gather, pad_to_multiple, shard_batch  # noqa: E402

CPU = torch.device("cpu")


def _kernels():
    null = tk.DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    alt = null + tk.Lorentzian(log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)])
    return null, alt


def _batch(G=7, n=40, seed=0):
    """G lightcurves (G, n) sharing sorted times, dy 0.3."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    ys = 10.0 + rng.normal(0.0, 1.0, (G, n))
    return (torch.as_tensor(t), torch.as_tensor(ys), torch.full((G, n), 0.09, dtype=torch.float64))


# --------------------------------------------------------------------------- #
# parallel
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,multiple", [((5, 3), 4), ((8, 2), 4), ((1,), 8), ((7, 2, 3), 3), ((0, 2), 4)])
def test_pad_to_multiple_matches_jax(shape, multiple):
    from mind_the_gaps_tpu.parallel import pad_to_multiple as j_pad

    x = np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape)
    got, n = pad_to_multiple(x, multiple)
    ref, n_ref = j_pad(x, multiple)
    assert n == n_ref == shape[0]
    assert type(got) is type(ref) and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("rows,size", [(12, 4), (7, 3), (2, 4)])
def test_shard_batch_gather_round_trip(rows, size):
    mesh = Mesh((CPU,) * size)
    x = torch.arange(rows * 3, dtype=torch.float64).reshape(rows, 3)
    blocks = shard_batch(x, mesh)
    assert len(blocks) == size
    assert [len(b) for b in blocks] == [len(b) for b in torch.tensor_split(torch.arange(rows), size)]
    assert all(b.device == d for b, d in zip(blocks, mesh.devices))
    assert torch.equal(gather(blocks, CPU), x)


def test_mesh_and_default_mesh(monkeypatch):
    mesh = Mesh(("cpu", torch.device("cpu")), "walkers")
    assert mesh.size == 2 and mesh.devices == (CPU, CPU) and mesh.axis_name == "walkers"
    assert default_mesh(devices=[CPU] * 3).size == 3
    with pytest.raises(ValueError):
        Mesh(())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_mesh()


def test_node_mesh_needs_several_cards(monkeypatch):
    """``fit_lightcurves_batch(use_mesh=True)`` takes a mesh only on the
    device "cuda" with more than one visible card: none on the CPU, on one
    card, or on a device that names its card."""
    assert lrt._node_mesh("cpu") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert lrt._node_mesh("cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert lrt._node_mesh("cpu") is None
    assert lrt._node_mesh("cuda:1") is None and lrt._node_mesh(torch.device("cuda", 0)) is None
    mesh = lrt._node_mesh("cuda")
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4))


def test_batch_team_is_the_whole_batch_layout(monkeypatch):
    """The pinned layout is ``team_size``'s for the whole batch on the lead
    card, and there is none off a card."""
    null, alt = _kernels()
    assert celerite_op.batch_team(alt, 3078, "cpu") is None
    monkeypatch.setattr(celerite_op, "_sm_count", lambda device: 132)
    assert celerite_op.batch_team(alt, 513 * 6, "cuda") == celerite_op.team_size(3078, 132, 1, 1) == 8
    assert celerite_op.batch_team(null, 16, "cuda") == 32
    # a shard of the batch alone would get the other layout: the pin matters
    assert celerite_op.team_size(3078 // 8, 132, 1, 1) == 32


def test_team_reaches_the_launch(monkeypatch):
    """``batched_log_prob_fn(team=)`` hands the layout to the kernel's launch
    on its prepared data (the launch is replaced by a recorder; tensors on
    the meta device take the launch's branch)."""
    from mind_the_gaps_tpu_torch.solver.batched import batched_log_prob_fn

    seen = []

    def launch(coeffs, data, mean, repeats, extra_diag, sym=True, team=None):
        seen.append(team)
        return torch.zeros(coeffs[0].shape[0], dtype=coeffs[0].dtype, device=coeffs[0].device)

    monkeypatch.setattr(celerite_op, "_launch_prepared", launch)
    _, alt = _kernels()
    meta = torch.device("meta")
    t, ys, diags = (x.to(meta) for x in _batch(G=2, n=10))
    for team in (None, 8, 32):
        batched_log_prob_fn(alt, t, ys, diags, repeats=3, team=team)(torch.zeros((6, alt.ndim), device=meta))
    assert seen == [None, 8, 32]


# --------------------------------------------------------------------------- #
# the refits
# --------------------------------------------------------------------------- #
def _refit(kernel, theta0, mesh=None, generator=None, early_stop=None, spmd="gspmd", rows=slice(None), G=7):
    t, ys, diags = _batch(G=G)
    if generator is None:
        generator = _derived_generator(CPU, 3, 0)
    return batched_max_loglike(kernel, t, ys[rows], diags[rows], theta0, walkers=8, n_steps=40,
                               early_stop=early_stop, generator=generator, mesh=mesh, spmd=spmd)


@pytest.mark.parametrize("size", [4, 3])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("early_stop", [None, (0.05, 4)])
def test_gspmd_equals_unsharded(size, per_row, early_stop):
    _, alt = _kernels()
    theta0 = alt.get_parameter_vector()
    if per_row:
        theta0 = theta0 + np.random.default_rng(1).normal(0.0, 0.05, (7, alt.ndim))
    ref_lp, ref_x = _refit(alt, theta0, early_stop=early_stop)
    (ref_launches,) = batched_max_loglike.shard_launches
    lp, x = _refit(alt, theta0, mesh=Mesh((CPU,) * size), early_stop=early_stop)
    assert torch.equal(lp, ref_lp) and torch.equal(x, ref_x)
    # every shard ran every step, and the rule stopped them all together
    assert batched_max_loglike.shard_launches == [ref_launches] * size
    if early_stop is not None:
        assert ref_launches < 2 + 2 * 40, "the early stop never stopped early: the case tests nothing"


def test_gspmd_with_more_shards_than_rows():
    null, _ = _kernels()
    ref = _refit(null, null.get_parameter_vector(), rows=slice(0, 2))
    out = _refit(null, null.get_parameter_vector(), rows=slice(0, 2), mesh=Mesh((CPU,) * 4))
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert batched_max_loglike.shard_launches[2:] == [0, 0]


@pytest.mark.parametrize("early_stop", [None, (0.05, 4)])
def test_shard_map_shard_equals_its_own_run(monkeypatch, early_stop):
    """``fit_lightcurves_batch(spmd="shard_map")``: shard k of chunk i is an
    unsharded run of its rows from the generator of ``(seed, i, k)``, and
    stops on its own."""
    _, alt = _kernels()
    t, ys, diags = _batch(G=7)
    mesh = Mesh((CPU,) * 3)
    monkeypatch.setattr(lrt, "_node_mesh", lambda device: mesh)
    theta0 = alt.get_parameter_vector()
    lls, xs = fit_lightcurves_batch(alt, t.numpy(), ys.numpy(), np.full((7, 40), 0.3), theta0, walkers=8,
                                    n_steps=40, early_stop=early_stop, seed=5, device="cpu", use_mesh=True,
                                    spmd="shard_map")
    launches = batched_max_loglike.shard_launches
    diags = (torch.full((7, 40), 0.3, dtype=torch.float64) + 1e-12) ** 2
    for k, rows in enumerate(torch.tensor_split(torch.arange(7), 3)):
        r = slice(int(rows[0]), int(rows[-1]) + 1)
        lp, x = batched_max_loglike(alt, t, ys[r], diags[r], theta0, walkers=8, n_steps=40, early_stop=early_stop,
                                    generator=_derived_generator(CPU, 5, 0, k))
        assert np.array_equal(lls[r], lp.numpy()) and np.array_equal(xs[r], x.numpy())
        assert launches[k] == batched_max_loglike.shard_launches[0]
    if early_stop is not None:
        assert len(set(launches)) > 1, "the shards stopped together: the case tests nothing"


def test_shard_map_agrees_with_jax_shard_map(monkeypatch):
    """The port's shard_map over 2 CPU devices against the JAX package's over
    its 8, at the ensemble level (test_lrt.py's shard_map case)."""
    import jax

    from mind_the_gaps_tpu.kernels import DampedRandomWalk as JDRW
    from mind_the_gaps_tpu.lrt import fit_lightcurves_batch as j_fit

    rng = np.random.default_rng(2)
    n, B = 100, 16
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    y = 10.0 + np.cumsum(rng.normal(0.0, 0.4, n)) * 0.3
    ys = y[None, :] + rng.normal(0, 0.3, (B, n))
    dys = np.full((B, n), 0.3)
    theta0 = np.array([np.log(4.0), np.log(0.05)])
    bounds = [(-5, 10), (-8, 2)]
    ref, _ = j_fit(jax.random.key(3), JDRW(log_S0=1.0, log_omega0=-3.0, bounds=bounds), t, ys, dys, theta0,
                   walkers=8, n_steps=150, spmd="shard_map")
    monkeypatch.setattr(lrt, "_node_mesh", lambda device: Mesh((CPU,) * 2))
    lls, xs = fit_lightcurves_batch(tk.DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=bounds), t, ys, dys,
                                    theta0, walkers=8, n_steps=150, use_mesh=True, spmd="shard_map", seed=3,
                                    device="cpu")
    assert lls.shape == (B,) and xs.shape == (B, 2) and np.all(np.isfinite(lls))
    assert batched_max_loglike.shard_launches == [302] * 2
    np.testing.assert_allclose(lls, ref, rtol=0.05, atol=2.0)


def test_fit_lightcurves_batch_mesh_options(monkeypatch):
    """``use_mesh`` and ``spmd`` as the JAX function has them, but the mesh
    off by default (the JAX default is on; over four cards it was slower
    than one); with "gspmd" the sharded result is the unsharded one."""
    from mind_the_gaps_tpu.lrt import fit_lightcurves_batch as j_fit

    ours, theirs = (inspect.signature(f).parameters for f in (fit_lightcurves_batch, j_fit))
    assert ours["spmd"].default == theirs["spmd"].default == "gspmd"
    assert ours["use_mesh"].default is False and theirs["use_mesh"].default is True
    null, _ = _kernels()
    t, ys, _ = _batch(G=5)
    args = (null, t.numpy(), ys.numpy(), np.full((5, 40), 0.3), null.get_parameter_vector())
    kw = dict(walkers=8, n_steps=30, chunk=3, seed=2, device="cpu")
    ref = fit_lightcurves_batch(*args, **kw)
    monkeypatch.setattr(lrt, "_node_mesh", lambda device: Mesh((CPU,) * 2))
    out = fit_lightcurves_batch(*args, use_mesh=True, **kw)
    assert len(batched_max_loglike.shard_launches) == 2
    off = fit_lightcurves_batch(*args, **kw)
    assert len(batched_max_loglike.shard_launches) == 1
    for got in (out, off):
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    with pytest.raises(ValueError, match="spmd"):
        fit_lightcurves_batch(*args, spmd="pmap", **kw)
    with pytest.raises(ValueError, match="generator"):
        _refit(null, null.get_parameter_vector(), mesh=Mesh((CPU,) * 2), spmd="shard_map",
               generator=[_derived_generator(CPU, 1)])


# --------------------------------------------------------------------------- #
# the observed fits
# --------------------------------------------------------------------------- #
def _problem(n=64, seed=0, mean_model=None):
    """test_mesh_observed_fits.py's problem."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(1.0, 3.0, n))
    lc = GappyLightcurve(t, rng.normal(5.0, 1.0, n) + 10.0, np.full(n, 0.2))
    kernel = tk.DampedRandomWalk(log_S0=1.0, log_omega0=-2.0, bounds=[(-5, 10), (-8, 2)])
    return GPModelling(lc, kernel, mean_model=mean_model, device="cpu")


def _derive(gp, init, mesh=None, chains=1):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # converge=False warns by design
        gp.derive_posteriors(initial_chain_params=init, chains=chains, max_steps=8, convergence_steps=4,
                             converge=False, seed=5, mesh=mesh)
    return gp


def _same_run(a, b):
    assert np.array_equal(a._sampler._chain, b._sampler._chain)
    assert np.array_equal(a._sampler._log_probs, b._sampler._log_probs)
    assert np.array_equal(a._loglikelihoods, b._loglikelihoods)
    assert np.array_equal(a._mcmc_samples, b._mcmc_samples)
    assert np.array_equal(a._tau, b._tau)


@pytest.mark.parametrize("mean_model", [None, "linear"])
def test_mesh_mode_is_sharded_and_bit_identical(mean_model):
    gp = _problem(mean_model=mean_model)
    init = gp.spread_walkers(16, gp.initial_params, np.array(gp.get_parameter_bounds(), dtype=object),
                             rng=np.random.default_rng(1))
    sharded = _derive(gp, init, mesh=Mesh((CPU,) * 4))
    # every shard evaluated every half-step: two segments of 4 steps, each 2
    # evaluations at its start and 2 a step
    assert sharded.timings["mesh_shards"] == 4
    assert sharded.timings["shard_launches"] == [2 * (2 + 2 * 4)] * 4
    single = _derive(_problem(mean_model=mean_model), init)
    assert single.timings["mesh_shards"] == 1 and single.timings["shard_launches"] == [2 * (2 + 2 * 4)]
    _same_run(sharded, single)


@pytest.mark.parametrize("chains,walkers,mean_model", [(8, 4, None), (2, 8, "constant")])
def test_mesh_mode_multi_chain_lanes(chains, walkers, mean_model):
    """chains > 1: the independent-chain axis shards (with a fitted mean
    too)."""
    gp = _problem(seed=2, mean_model=mean_model)
    init = gp.spread_walkers(chains * walkers, gp.initial_params, np.array(gp.get_parameter_bounds(), dtype=object),
                             rng=np.random.default_rng(3)).reshape(chains, walkers, -1)
    sharded = _derive(gp, init, mesh=Mesh((CPU,) * 2), chains=chains)
    assert sharded.timings["shard_launches"] == [2 * (2 + 2 * 4)] * 2
    _same_run(sharded, _derive(_problem(seed=2, mean_model=mean_model), init, chains=chains))


def test_mesh_mode_gates_off_indivisible_walkers():
    gp = _problem(seed=4)
    init = gp.spread_walkers(12, gp.initial_params, np.array(gp.get_parameter_bounds(), dtype=object),
                             rng=np.random.default_rng(5))  # 12 walkers do not divide 8 shards
    with pytest.warns(UserWarning, match="mesh mode"):
        gp.derive_posteriors(initial_chain_params=init, max_steps=4, convergence_steps=4, converge=False, seed=5,
                             mesh=Mesh((CPU,) * 8))
    assert gp.timings["mesh_shards"] == 1 and gp.timings["shard_launches"] == [2 + 2 * 4]


# --------------------------------------------------------------------------- #
# the LRT
# --------------------------------------------------------------------------- #
def test_protassov_lrt_over_a_mesh_equals_one_device():
    """``protassov_lrt(mesh=)`` with a two-device mesh (its refits in "gspmd"
    mode; the observed fits stay on the device) gives the unsharded run's
    results; without ``mesh`` it takes none."""
    null, alt = _kernels()
    rng = np.random.default_rng(4)
    n = 40
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    lc = GappyLightcurve(t, 10.0 + rng.normal(0.0, 1.0, n), np.full(n, 0.3), exposures=1.0)
    settings = dict(nsims=4, observed_max_steps=40, observed_walkers=8, sim_max_steps=30, sim_walkers=8, chunk=3,
                    seed=21, device="cpu")
    ref = protassov_lrt(lc, null, alt, **settings)
    assert len(batched_max_loglike.shard_launches) == 1
    out = protassov_lrt(lc, null, alt, mesh=Mesh((CPU,) * 2), **settings)
    assert out.null_model.timings["mesh_shards"] == out.alt_model.timings["mesh_shards"] == 1
    assert len(batched_max_loglike.shard_launches) == 2
    assert np.array_equal(out.t_dist, ref.t_dist)
    assert out.t_obs == ref.t_obs and out.p_value == ref.p_value and out.t_obs_posterior == ref.t_obs_posterior
    assert np.array_equal(out.null_model.mcmc_samples, ref.null_model.mcmc_samples)


# --------------------------------------------------------------------------- #
# on a card: two shards on one card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the celerite kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gspmd_equals_unsharded_on_card(cuda, dtype):
    _, alt = _kernels()
    t, ys, diags = (x.to(cuda) for x in _batch(G=64, n=500))
    theta0 = alt.get_parameter_vector()
    runs = []
    for mesh in (None, Mesh((cuda, cuda)), Mesh((cuda,) * 3)):
        runs.append(batched_max_loglike(alt, t, ys, diags, theta0, walkers=12, n_steps=60, dtype=dtype,
                                        early_stop=(0.01, 20), generator=_derived_generator(cuda, 3, 0), mesh=mesh))
    for lp, x in runs[1:]:
        assert torch.equal(lp, runs[0][0]) and torch.equal(x, runs[0][1])


@pytest.mark.cuda
def test_mesh_mode_is_bit_identical_on_card(cuda):
    gp = _problem(n=500)
    init = gp.spread_walkers(32, gp.initial_params, np.array(gp.get_parameter_bounds(), dtype=object),
                             rng=np.random.default_rng(1))
    runs = []
    for mesh in (Mesh((cuda, cuda)), None):
        model = GPModelling(gp._lightcurve, gp.kernel, device=cuda)
        runs.append(_derive(model, init, mesh=mesh))
    _same_run(*runs)
