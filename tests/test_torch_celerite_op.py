"""The celerite op: its plain version against the JAX package's Pallas
kernel (interpret mode on the CPU), the float32 contract, the CPU routing
and the launch counters; and, on a CUDA card, the kernel (its packed and
its dense-S body) against its plain version.

Tolerances: float64 rtol 1e-10; float32 rtol 1e-4, atol 1e-2 (those of
tests/test_pallas_grouped.py); float32 against float64 within 0.5 in
absolute log-likelihood (docs/PARITY.md, the f32 fast path contract).

JAX is imported inside the tests that compare with it, so that the
``cuda`` cases also run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_celerite_op.py
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

import mind_the_gaps_tpu_torch.kernels as tk  # noqa: E402
from mind_the_gaps_tpu_torch.ops import (  # noqa: E402
    celerite_log_likelihood,
    celerite_log_likelihood_plain,
)

B = 128  # the Pallas kernel needs B % 128 == 0
N = 77  # ragged: not a multiple of the kernel's time block or of 8


def _kernel(m, jr, jc):
    terms = [m.RealTerm(0.5 - 0.3 * i, -1.0 - 0.5 * i) for i in range(jr)]
    terms += [m.Lorentzian(-1.0 + 0.2 * i, 2.0 - 0.5 * i, -2.0 + 0.4 * i) for i in range(jc)]
    k = terms[0]
    for x in terms[1:]:
        k = k + x
    return k


def _case(jr, jc, layout, dtype, seed=0, n=N):
    """Coefficients, data, mean and jitter: the port's inputs, and the
    same numbers as numpy arrays for the JAX package."""
    rng = np.random.default_rng(seed)
    kt = _kernel(tk, jr, jc)
    th = kt.get_parameter_vector() + 0.05 * rng.normal(size=(B, kt.ndim))
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    if layout == "shared":
        y, d, repeats = rng.normal(0, 2, n), np.full(n, 0.09), 1
    elif layout == "grouped":
        y, d, repeats = rng.normal(0, 2, (16, n)), rng.uniform(0.05, 0.1, (16, n)), 8
    else:  # per-element series with a shared diagonal
        y, d, repeats = rng.normal(0, 2, (B, n)), np.full(n, 0.09), 1
    mean = rng.normal(0, 0.2, B)
    jit = rng.uniform(0.0, 0.02, B)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    numpy_in = dict(th=th.astype(np_dt), t=t, y=y.astype(np_dt), diag=d.astype(np_dt),
                    mean=mean.astype(np_dt), repeats=repeats, extra_diag=jit.astype(np_dt))
    torch_in = dict(
        coeffs=kt.coefficients(torch.as_tensor(th, dtype=dtype)), t=torch.as_tensor(t),
        y=torch.as_tensor(y, dtype=dtype), diag=torch.as_tensor(d, dtype=dtype),
        mean=torch.as_tensor(mean, dtype=dtype), repeats=repeats,
        extra_diag=torch.as_tensor(jit, dtype=dtype),
    )
    return numpy_in, torch_in


CASES = [
    (1, 0, "shared", torch.float64),
    (0, 1, "grouped", torch.float64),
    (1, 1, "per", torch.float64),
    (0, 2, "shared", torch.float64),
    (1, 2, "grouped", torch.float64),
    (6, 0, "per", torch.float64),
    (0, 3, "grouped", torch.float64),
    (1, 0, "grouped", torch.float32),
    (1, 1, "shared", torch.float32),
]


@pytest.mark.parametrize("jr,jc,layout,dtype", CASES)
def test_plain_matches_pallas_interpret(jr, jc, layout, dtype):
    jax = pytest.importorskip("jax")
    import mind_the_gaps_tpu.kernels as jk
    from mind_the_gaps_tpu.ops.pallas_celerite import pallas_log_likelihood

    x, torch_in = _case(jr, jc, layout, dtype)
    ref = np.asarray(pallas_log_likelihood(
        jax.vmap(_kernel(jk, jr, jc).coefficients)(x["th"]), x["t"], x["y"], x["diag"],
        mean=x["mean"], repeats=x["repeats"], extra_diag=x["extra_diag"], interpret=True,
    ))
    out = celerite_log_likelihood(**torch_in)
    assert out.dtype == dtype and out.shape == (B,)
    assert np.all(np.isfinite(ref))
    if dtype == torch.float64:
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10)
    else:
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-2)


def test_f32_tracks_f64_long_baseline():
    """t ~ 5e7 s: dt is formed in float64 before the cast, so float32
    keeps the gaps (the JAX package's long-baseline case)."""
    kt = tk.DampedRandomWalk(1.0, np.log(2e-6)) + tk.Lorentzian(-1.0, 2.0, np.log(1e-5))
    rng = np.random.default_rng(3)
    n = 2000
    t = 5e7 + np.cumsum(rng.uniform(2e4, 1e5, n))
    y = rng.normal(0.0, 2.0, n)
    th = kt.get_parameter_vector() + 0.05 * rng.normal(size=(4, 5))
    out = {}
    for dt in (torch.float64, torch.float32):
        out[dt] = celerite_log_likelihood(
            kt.coefficients(torch.as_tensor(th, dtype=dt)), torch.as_tensor(t),
            torch.as_tensor(y, dtype=dt), torch.full((n,), 0.09, dtype=dt),
        ).double().numpy()
    assert np.all(np.isfinite(out[torch.float64]))
    assert np.max(np.abs(out[torch.float64] - out[torch.float32])) < 0.5


def test_cpu_tensors_use_the_plain_version_and_do_not_count():
    _, torch_in = _case(1, 1, "grouped", torch.float64, seed=5, n=20)
    before = (celerite_log_likelihood.launches, celerite_log_likelihood.dense_launches)
    out = celerite_log_likelihood(**torch_in)
    dense = celerite_log_likelihood(**torch_in, sym=False)
    assert (celerite_log_likelihood.launches, celerite_log_likelihood.dense_launches) == before
    torch.testing.assert_close(out, celerite_log_likelihood_plain(**torch_in), rtol=0, atol=0)
    torch.testing.assert_close(dense, out, rtol=0, atol=0)


def test_non_pd_and_bad_layouts():
    _, torch_in = _case(1, 0, "shared", torch.float64, seed=6, n=20)
    c = torch_in["coeffs"]
    torch_in["coeffs"] = c._replace(ar=c.ar.clone().index_fill_(0, torch.tensor([0, 1]), -100.0))
    out = celerite_log_likelihood(**torch_in).numpy()
    assert out[0] == out[1] == -np.inf and np.all(np.isfinite(out[2:]))
    with pytest.raises(ValueError):
        celerite_log_likelihood(**{**torch_in, "y": torch.zeros(3, 20, dtype=torch.float64), "repeats": 8})
    with pytest.raises(ValueError):
        meta = torch_in["coeffs"]._replace(ar=torch.empty((B, 1), device="meta", dtype=torch.float64))
        celerite_log_likelihood(**{**torch_in, "coeffs": meta})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("jr,jc,layout,dtype", CASES)
def test_kernel_matches_plain_on_card(cuda, jr, jc, layout, dtype):
    _, torch_in = _case(jr, jc, layout, dtype, seed=7)
    on_card = {k: (v.to(cuda) if torch.is_tensor(v) else v) for k, v in torch_in.items()}
    on_card["coeffs"] = type(torch_in["coeffs"])(*(x.to(cuda) for x in torch_in["coeffs"]))
    before = celerite_log_likelihood.launches
    out = celerite_log_likelihood(**on_card)
    torch.cuda.synchronize()
    assert celerite_log_likelihood.launches == before + 1
    ref = celerite_log_likelihood_plain(**on_card)
    tol = dict(rtol=1e-10, atol=0.0) if dtype == torch.float64 else dict(rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(out, ref, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("jr,jc,layout,dtype", CASES)
def test_dense_s_kernel_matches_plain_on_card(cuda, jr, jc, layout, dtype):
    """The dense-S body (``sym=False``) against the plain version."""
    _, torch_in = _case(jr, jc, layout, dtype, seed=8)
    on_card = {k: (v.to(cuda) if torch.is_tensor(v) else v) for k, v in torch_in.items()}
    on_card["coeffs"] = type(torch_in["coeffs"])(*(x.to(cuda) for x in torch_in["coeffs"]))
    before = celerite_log_likelihood.dense_launches
    out = celerite_log_likelihood(**on_card, sym=False)
    torch.cuda.synchronize()
    assert celerite_log_likelihood.dense_launches == before + 1
    ref = celerite_log_likelihood_plain(**on_card)
    tol = dict(rtol=1e-10, atol=0.0) if dtype == torch.float64 else dict(rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(out, ref, **tol)
