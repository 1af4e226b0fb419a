"""The plain reference against the port's own numpy recursion and a dense
Cholesky, and its maximizer on a problem with a known answer."""
import numpy as np
import pytest
import torch

from gpbench.reference import Evaluator, Model, flux_skewness, grid_points, maximize

NULL = {"terms": [{"kind": "DampedRandomWalk", "values": [1.0, -3.0], "bounds": [[-5, 10], [-8, 2]]}]}
ALT = {"terms": NULL["terms"] + [{"kind": "Lorentzian", "values": [-1.0, 2.0, -2.0],
                                 "bounds": [[-8, 5], [0, 6], [-5, 0]]}]}


def _data(n=300, seed=0):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(2, 8, n))
    y = 10 + rng.normal(0, 1.5, n)
    dy = rng.uniform(0.2, 0.5, n)
    return t, y, dy


def _dense(kinds_theta, t, r, diag):
    tau = np.abs(t[:, None] - t[None, :])
    (ls0, lw0), lor = kinds_theta
    K = np.exp(ls0) * np.exp(-np.exp(lw0) * tau)
    if lor is not None:
        s0, q, w0 = np.exp(lor)
        K = K + s0 * np.exp(-0.5 * w0 / q * tau) * np.cos(w0 * tau)
    K[np.diag_indices_from(K)] += diag
    L = np.linalg.cholesky(K)
    a = np.linalg.solve(L, r)
    return -0.5 * (a @ a + 2 * np.log(np.diag(L)).sum() + len(t) * np.log(2 * np.pi))


@pytest.mark.parametrize("which", ["null", "alt"])
def test_log_likelihood_matches_a_dense_cholesky_and_the_port(which):
    from mind_the_gaps_tpu_torch.solver.numpy_ref import numpy_log_likelihood

    t, y, dy = _data()
    theta = np.array([0.7, -2.5, -0.5, 1.5, -1.2]) if which == "alt" else np.array([0.7, -2.5])
    model = Model.from_config(ALT if which == "alt" else NULL)
    ev = Evaluator(t, y[None], dy[None], [model])
    got = ev.log_likelihood([(0, theta[None], np.zeros(1, dtype=int))])[0][0]
    r, diag = y - y.mean(), (dy + 1e-12) ** 2
    dense = _dense((theta[:2], theta[2:] if which == "alt" else None), t, r, diag)
    coeffs = [c[0].numpy() for c in model.coefficients(torch.as_tensor(theta[None]))]
    port = numpy_log_likelihood(coeffs, t, r, diag)
    assert got == pytest.approx(dense, rel=1e-10)
    assert got == pytest.approx(port, rel=1e-12)


def test_float32_differs_from_float64_by_rounding_only():
    t, y, dy = _data(2000, seed=3)
    model = Model.from_config(ALT)
    theta = np.array([[0.7, -2.5, -0.5, 1.5, -1.2]])
    vals = [Evaluator(t, y[None], dy[None], [model], dtype=d).log_likelihood([(0, theta, np.zeros(1, dtype=int))])[0][0]
            for d in (torch.float64, torch.float32)]
    assert 0 < abs(vals[0] - vals[1]) < 1.0


def test_padding_a_model_to_a_wider_one_changes_nothing():
    t, y, dy = _data()
    null, alt = Model.from_config(NULL), Model.from_config(ALT)
    alone = Evaluator(t, y[None], dy[None], [null]).log_likelihood([(0, np.array([[0.3, -2.0]]), [0])])[0]
    padded = Evaluator(t, y[None], dy[None], [null, alt]).log_likelihood([(0, np.array([[0.3, -2.0]]), [0])])[0]
    assert padded[0] == pytest.approx(alone[0], rel=1e-14)


def test_maximize_finds_the_maximum_of_each_row():
    t, _, dy = _data(400, seed=5)
    rng = np.random.default_rng(9)
    # rows drawn from a DRW with known parameters
    tau = np.abs(t[:, None] - t[None, :])
    K = np.e * np.exp(-np.exp(-2.5) * tau) + np.diag(dy**2)
    ys = 5 + rng.multivariate_normal(np.zeros(len(t)), K, size=3)
    null = Model.from_config(NULL)
    ev = Evaluator(t, ys, np.tile(dy, (3, 1)), [null])
    grid = grid_points(null.bounds, 12)
    vals = ev.log_likelihood([(0, np.tile(grid, (3, 1)), np.repeat(np.arange(3), len(grid)))])[0]
    starts = grid[np.argmax(vals.reshape(3, -1), 1)]
    (x, m, H, done), = maximize(ev, [(0, starts, np.arange(3), 30)])
    assert done.all()
    # no point nearby is higher, and the gradient there vanishes
    for k in range(3):
        around = x[k] + np.array([[1e-3, 0], [-1e-3, 0], [0, 1e-3], [0, -1e-3], [1e-2, 1e-2]])
        near = ev.log_likelihood([(0, around, np.full(len(around), k))])[0]
        assert np.all(near <= m[k] + 1e-9)
    assert np.all(np.linalg.eigvalsh(-H) > 0)


@pytest.mark.parametrize("exposure", [1.0, 2.5])
def test_flux_skewness_takes_the_poisson_noise_out(exposure):
    rng = np.random.default_rng(7)
    mean, std = 10.0, 1.65
    sigma = np.sqrt(np.log1p(std**2 / mean**2))
    rates = {"Lognormal": mean * np.exp(sigma * rng.standard_normal((8, 200_000)) - sigma**2 / 2),
             "Gaussian": mean + std * rng.standard_normal((8, 200_000))}
    for pdf, x in rates.items():
        y = rng.poisson(x * exposure) / exposure
        measured, target = flux_skewness(y, exposure, pdf)
        expect = (np.exp(sigma**2) + 2) * np.sqrt(np.expm1(sigma**2)) if pdf == "Lognormal" else 0.0
        assert target == pytest.approx(expect, abs=0.02)
        assert measured == pytest.approx(expect, abs=0.05), pdf
