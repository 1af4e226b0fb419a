"""``simulator.downsample_cumsum``: the window means that turn the fine
simulated series into the observed bins, summed so that a row's result does
not depend on the batch it is in.

- Against a plain loop over each window's samples in order: exact
  (``torch.equal``), at mixed widths, empty batches of rows included.
- A block of a batch's rows against those rows of the whole batch: exact,
  on the CPU and (``cuda``) on a card, at the tutorial-scale E13 geometry
  (n=500, cut 8192) and the lrt scenario's (n=5000); on the card also equal
  to the CPU's result, since each output is the same sequence of float64
  adds and one division.
- Against the JAX package's differences of cumulative sums: within
  4 eps M max|x| (the rounding of a cumulative sum of M samples), on the
  lrt scenario's windows.

JAX is imported inside the test that compares with it, so that the ``cuda``
cases also run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_downsample.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mind_the_gaps_tpu_torch.simulator import Simulator, downsample_cumsum  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _windows(n_points, seed):
    """A simulator's fine-grid windows (starts, ends) and its E13 cut, for
    ``n_points`` times ``cumsum(uniform(2, 8))`` with 1 s exposures."""
    t = np.cumsum(np.random.default_rng(seed).uniform(2.0, 8.0, n_points))
    sim = Simulator(lambda w: np.ones_like(w), t, exposures=1.0, mean=10.0, pdf="Lognormal", device="cpu")
    return torch.as_tensor(sim._win_starts), torch.as_tensor(sim._win_ends), sim._e13_cut_len


def _loop_reference(x, starts, ends):
    out = torch.empty(x.shape[:-1] + starts.shape, dtype=x.dtype)
    for i, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        total = x[..., s]
        for j in range(s + 1, e):
            total = total + x[..., j]
        out[..., i] = total / (e - s)
    return out


@pytest.mark.parametrize("rows", [0, 1, 5])
def test_equals_an_ordered_loop(rows):
    rng = np.random.default_rng(rows)
    x = torch.as_tensor(10.0 + rng.normal(size=(rows, 400)))
    starts = torch.as_tensor(np.sort(rng.integers(0, 380, 40)))
    ends = starts + torch.as_tensor(rng.integers(1, 12, 40))
    assert torch.equal(downsample_cumsum(x, starts, ends), _loop_reference(x, starts, ends))


@pytest.mark.parametrize("n_points", [500, 5000])
def test_rows_do_not_depend_on_the_batch(n_points):
    starts, ends, m = _windows(n_points, 0)
    x = torch.as_tensor(10.0 + np.random.default_rng(1).normal(size=(32, m)))
    whole = downsample_cumsum(x, starts, ends)
    for block in (16, 8, 1):
        assert torch.equal(downsample_cumsum(x[:block], starts, ends), whole[:block])


def test_against_the_jax_package():
    import jax.numpy as jnp

    from mind_the_gaps_tpu.simulator.core import downsample_cumsum as j_downsample

    starts, ends, m = _windows(5000, 0)
    x = 10.0 + np.random.default_rng(2).normal(size=(4, m))
    ref = np.asarray(j_downsample(jnp.asarray(x), jnp.asarray(starts.numpy()), jnp.asarray(ends.numpy())))
    out = downsample_cumsum(torch.as_tensor(x), starts, ends).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=4 * np.finfo(np.float64).eps * m * np.abs(x).max())


@pytest.mark.cuda
@pytest.mark.parametrize("n_points", [500, 5000])
def test_rows_do_not_depend_on_the_batch_on_card(cuda, n_points):
    starts, ends, m = _windows(n_points, 0)
    x = 10.0 + torch.randn(256, m, dtype=torch.float64, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    whole = downsample_cumsum(x, starts.to(cuda), ends.to(cuda))
    for block in (128, 64):
        assert torch.equal(downsample_cumsum(x[:block], starts.to(cuda), ends.to(cuda)), whole[:block])
    assert torch.equal(whole.cpu(), downsample_cumsum(x.cpu(), starts, ends))
