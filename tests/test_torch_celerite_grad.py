"""The MAP objective's op: the celerite log-likelihood and its exact
gradient (``ops.celerite_grad``).

- Its plain version against ``jax.value_and_grad`` of the JAX package's
  ``solver.log_likelihood`` with respect to the six coefficient arrays, the
  jitter and the residual, at R = 1, 3, 4, 7 and a runtime R = 10: value
  rtol 1e-10, gradients within 1e-8 of the largest component (float64; the
  two differ only in the order of their sums); a non-positive-definite
  theta gives -inf and a zero gradient.
- The autograd function (``celerite_loglike_fn``) hands on those gradients,
  scaled, to the coefficients, ``y``, ``mean`` and ``extra_diag``.
- On a CUDA card: the kernel (a block of a chain lane and two helper
  warps a likelihood) against its plain version at the same tolerances, at
  R = 1, 3, 4, 7 and the runtime-R body at R = 10, for one likelihood, three
  sharing y and four per-element ones; at R = 14, 16 and 90, where the chunk
  buffers and then the runtime-R state no longer fit in shared memory and
  live in the global scratch area; its launch count; two launches
  on the same inputs give the same bits (the lanes' partial sums are
  reduced in a fixed order); its value against the forward kernel's
  (``ops.celerite_log_likelihood``) to rtol 1e-12; and the refusals.

JAX is imported inside the tests that compare with it, so that the
``cuda`` cases also run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_celerite_grad.py
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

import mind_the_gaps_tpu_torch.kernels as tk  # noqa: E402
from mind_the_gaps_tpu_torch.ops.celerite_grad import (  # noqa: E402
    celerite_log_likelihood_and_grad,
    celerite_log_likelihood_and_grad_plain,
    celerite_loglike_fn,
)

KERNELS = {
    "drw": lambda m: m.DampedRandomWalk(1.0, -3.0),  # R = 1
    "drw_qpo": lambda m: m.DampedRandomWalk(1.0, -3.0) + m.Lorentzian(-1.0, 2.0, -2.0),  # R = 3
    "sho": lambda m: m.SHOTerm(0.5, 1.0, -2.5),  # R = 4, b != 0
    "drw_3qpo": lambda m: (  # R = 7
        m.DampedRandomWalk(1.0, -3.0) + m.Lorentzian(-1.0, 2.0, -2.0)
        + m.Lorentzian(-0.8, 1.5, -1.6) + m.Lorentzian(-0.6, 1.0, -1.2)
    ),
    "runtime_r10": lambda m: (  # R = 10: the kernel's runtime-R body
        m.DampedRandomWalk(1.0, -3.0) + m.RealTerm(-0.5, -2.0) + m.Lorentzian(-1.0, 2.0, -2.0)
        + m.Lorentzian(-0.8, 1.5, -1.6) + m.Lorentzian(-0.6, 1.0, -1.2) + m.Lorentzian(-1.2, 1.2, -1.0)
    ),
}
FIELDS = ("ar", "cr", "ac", "bc", "cc", "dc", "extra_diag", "r")


def _inputs(name, B=2, n=150, seed=0, per_element=False, long_baseline=False):
    rng = np.random.default_rng(seed)
    kt = KERNELS[name](tk)
    th = kt.get_parameter_vector() + 0.05 * rng.normal(size=(B, kt.ndim))
    if long_baseline:
        t = 5e7 + np.cumsum(rng.uniform(2e4, 1e5, n))
        th[:, 1] = np.log(2e-6)
    else:
        t = np.cumsum(rng.uniform(2.0, 8.0, n))
    y = 10.0 + rng.normal(0.0, 2.0, (B, n) if per_element else n)
    return dict(coeffs=kt.coefficients(torch.as_tensor(th)), t=torch.as_tensor(t), y=torch.as_tensor(y),
                diag=torch.as_tensor(rng.uniform(0.05, 0.15, n)), mean=torch.as_tensor(rng.normal(10.0, 0.2, B)),
                extra_diag=torch.as_tensor(rng.uniform(0.0, 0.02, B)))


def _assert_grads_close(got, ref, rtol=1e-8):
    """Each gradient within rtol of its largest component."""
    for name, a, b in zip(FIELDS, got, ref):
        b = torch.as_tensor(np.array(b) if not torch.is_tensor(b) else b, dtype=torch.float64)
        if b.numel() == 0:
            continue
        scale = float(b.abs().max())
        err = float((a.cpu() - b.cpu()).abs().max())
        assert err <= rtol * scale, f"{name}: max abs err {err:.3e} against largest {scale:.3e}"


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_plain_matches_jax_value_and_grad(name):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from mind_the_gaps_tpu.solver import log_likelihood as j_loglike

    x = _inputs(name, seed=len(name))
    t, diag = x["t"].numpy(), x["diag"].numpy()

    def f(ar, cr, ac, bc, cc, dc, extra, r):
        return j_loglike((ar, cr, ac, bc, cc, dc), t, r, diag + extra)

    vg = jax.jit(jax.value_and_grad(f, argnums=tuple(range(8))))
    ll, grads = celerite_log_likelihood_and_grad_plain(**x)
    for b in range(2):
        args = [jnp.asarray(c[b].numpy()) for c in x["coeffs"]]
        args += [jnp.asarray(float(x["extra_diag"][b])), jnp.asarray(x["y"].numpy() - float(x["mean"][b]))]
        v_ref, g_ref = vg(*args)
        np.testing.assert_allclose(float(ll[b]), float(v_ref), rtol=1e-10)
        _assert_grads_close([g[b] for g in grads], [np.asarray(g) for g in g_ref])


def test_non_pd_gives_minus_inf_and_zero_gradient():
    x = _inputs("drw_qpo", B=3, n=60, seed=5)
    x["coeffs"] = x["coeffs"]._replace(ar=x["coeffs"].ar.clone().index_fill_(0, torch.tensor([1]), -50.0))
    ll, grads = celerite_log_likelihood_and_grad(**x)
    assert ll[1] == -np.inf and bool(torch.isfinite(ll[[0, 2]]).all())
    for g in grads:
        assert bool((g[1] == 0).all()) and bool(torch.isfinite(g).all())


def test_autograd_function_scales_the_saved_gradients():
    """Backward of w . ll gives w_b times the op's gradients, summed over
    the batch for a shared y, negated and summed over N for the mean."""
    x = _inputs("drw_qpo", B=3, n=50, seed=2)
    ll_ref, g = celerite_log_likelihood_and_grad_plain(**x)
    leaves = {k: (v.clone().requires_grad_(True) if torch.is_tensor(v) and k != "t" and k != "diag" else v)
              for k, v in x.items() if k != "coeffs"}
    coeffs = [c.clone().requires_grad_(True) for c in x["coeffs"]]
    w = torch.tensor([0.5, -2.0, 3.0], dtype=torch.float64)
    ll = celerite_loglike_fn(coeffs, **leaves)
    torch.testing.assert_close(ll.detach(), ll_ref, rtol=0, atol=0)
    (w * ll).sum().backward()
    for c, gc in zip(coeffs, g[:6]):
        torch.testing.assert_close(c.grad, gc * w[:, None], rtol=1e-14, atol=0)
    torch.testing.assert_close(leaves["extra_diag"].grad, g.extra_diag * w, rtol=1e-14, atol=0)
    torch.testing.assert_close(leaves["y"].grad, (g.r * w[:, None]).sum(0), rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(leaves["mean"].grad, -(g.r * w[:, None]).sum(1), rtol=1e-12, atol=1e-14)


def test_autograd_per_element_residual_reaches_a_mean_model():
    """A fitted linear mean's gradient through dll/dr: against autograd of
    the plain recursion end to end."""
    from mind_the_gaps_tpu_torch.models.mean_models import LinearModel
    from mind_the_gaps_tpu_torch.solver.semiseparable import log_likelihood

    x = _inputs("drw", B=1, n=80, seed=3)
    mean_model = LinearModel(0.0, 10.0)
    th = torch.tensor([1e-3, 9.8], dtype=torch.float64, requires_grad=True)
    resid = x["y"] - mean_model.value(x["t"], th)
    celerite_loglike_fn(x["coeffs"], x["t"], resid[None], x["diag"])[0].backward()
    th2 = th.detach().clone().requires_grad_(True)
    log_likelihood([c[0] for c in x["coeffs"]], x["t"], x["y"] - mean_model.value(x["t"], th2), x["diag"]).backward()
    torch.testing.assert_close(th.grad, th2.grad, rtol=1e-10, atol=0)


def test_refusals_and_the_cpu_route():
    x = _inputs("drw", B=2, n=20, seed=4)
    before = celerite_log_likelihood_and_grad.launches
    ll, _ = celerite_log_likelihood_and_grad(**x)
    assert celerite_log_likelihood_and_grad.launches == before and ll.shape == (2,)
    with pytest.raises(TypeError):
        celerite_log_likelihood_and_grad(**{**x, "coeffs": type(x["coeffs"])(*(c.float() for c in x["coeffs"]))})
    with pytest.raises(ValueError):  # a grouped y: not a layout of this op
        celerite_log_likelihood_and_grad(**{**x, "y": torch.zeros(1, 20, dtype=torch.float64)})
    with pytest.raises(ValueError):  # a per-element diag
        celerite_log_likelihood_and_grad(**{**x, "diag": torch.ones(2, 20, dtype=torch.float64)})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _to(x, device):
    out = {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in x.items()}
    out["coeffs"] = type(x["coeffs"])(*(c.to(device) for c in x["coeffs"]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("per_element,B", [(False, 1), (False, 3), (True, 4)])
def test_kernel_matches_plain_on_card(cuda, name, per_element, B):
    """The MAP fit's shape (B = 1, shared y), several likelihoods sharing y
    (B = 3) and the fitted mean's (B = 4, per-element residuals)."""
    x = _to(_inputs(name, B=B, n=400, seed=6, per_element=per_element), cuda)
    before = celerite_log_likelihood_and_grad.launches
    ll, grads = celerite_log_likelihood_and_grad(**x)
    torch.cuda.synchronize()
    assert celerite_log_likelihood_and_grad.launches == before + 1
    ll_ref, g_ref = celerite_log_likelihood_and_grad_plain(**x)
    torch.testing.assert_close(ll, ll_ref, rtol=1e-10, atol=0)
    for b in range(B):
        _assert_grads_close([g[b] for g in grads], [g[b] for g in g_ref])


@pytest.mark.cuda
@pytest.mark.parametrize("n_qpo,n", [(6, 300), (7, 300), (44, 64)])
def test_kernel_wide_r_on_card(cuda, n_qpo, n):
    """R = 2 + 2 n_qpo = 14 and 16 (the chunk buffers in the global scratch
    area on an H100) and 90 (the runtime-R state there too) against the
    plain version, for two likelihoods."""
    m = tk
    kt = m.DampedRandomWalk(1.0, -3.0) + m.RealTerm(-0.5, -2.0)
    for q in range(n_qpo):
        kt = kt + m.Lorentzian(-1.0 - 0.02 * q, 2.0 - 0.02 * q, -2.0 + 0.02 * q)
    rng = np.random.default_rng(9)
    t = torch.as_tensor(np.cumsum(rng.uniform(2.0, 8.0, n)), device=cuda)
    th = torch.as_tensor(kt.get_parameter_vector() + 0.05 * rng.normal(size=(2, kt.ndim)), device=cuda)
    x = dict(coeffs=kt.coefficients(th), t=t, y=torch.as_tensor(10.0 + rng.normal(0.0, 2.0, n), device=cuda),
             diag=torch.full((n,), 0.1, dtype=torch.float64, device=cuda))
    assert x["coeffs"].ar.shape[1] + 2 * x["coeffs"].ac.shape[1] == 2 + 2 * n_qpo
    ll, grads = celerite_log_likelihood_and_grad(**x)
    ll_ref, g_ref = celerite_log_likelihood_and_grad_plain(**x)
    assert bool(torch.isfinite(ll_ref).all())
    torch.testing.assert_close(ll, ll_ref, rtol=1e-10, atol=0)
    for b in range(2):
        _assert_grads_close([g[b] for g in grads], [g[b] for g in g_ref])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["drw", "drw_qpo", "drw_3qpo", "runtime_r10"])
def test_kernel_repeats_bit_for_bit_on_card(cuda, name):
    x = _to(_inputs(name, B=2, n=1000, seed=10, per_element=True), cuda)
    a = celerite_log_likelihood_and_grad(**x)
    b = celerite_log_likelihood_and_grad(**x)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(u, v) for u, v in zip(a[1], b[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["drw", "drw_qpo", "drw_3qpo", "runtime_r10"])
def test_kernel_value_equals_forward_kernel_on_card(cuda, name):
    """The same log-likelihood as the forward kernel, which sums its terms
    in the same order (the two recursions differ in their last bits: global
    against local phase)."""
    from mind_the_gaps_tpu_torch.ops import celerite_log_likelihood

    x = _to(_inputs(name, B=3, n=2000, seed=11), cuda)
    ll, _ = celerite_log_likelihood_and_grad(**x)
    fwd = celerite_log_likelihood(x["coeffs"], x["t"], x["y"], x["diag"], mean=x["mean"], extra_diag=x["extra_diag"])
    torch.testing.assert_close(ll, fwd, rtol=1e-12, atol=0)


@pytest.mark.cuda
def test_kernel_long_baseline_and_non_pd_on_card(cuda):
    x = _to(_inputs("drw_qpo", B=4, n=1000, seed=7, long_baseline=True), cuda)
    x["coeffs"] = x["coeffs"]._replace(ar=x["coeffs"].ar.clone().index_fill_(0, torch.tensor([2], device=cuda), -50.0))
    ll, grads = celerite_log_likelihood_and_grad(**x)
    ll_ref, g_ref = celerite_log_likelihood_and_grad_plain(**x)
    assert float(ll[2]) == -np.inf and bool(torch.isfinite(ll[[0, 1, 3]]).all())
    torch.testing.assert_close(ll, ll_ref, rtol=1e-10, atol=0)
    for b in range(4):
        _assert_grads_close([g[b] for g in grads], [g[b] for g in g_ref])
    assert all(bool((g[2] == 0).all()) for g in grads)


@pytest.mark.cuda
def test_kernel_raises_rather_than_falls_back(cuda):
    x = _to(_inputs("drw", B=2, n=20, seed=8), cuda)
    with pytest.raises(TypeError):
        celerite_log_likelihood_and_grad(**{**x, "coeffs": type(x["coeffs"])(*(c.float() for c in x["coeffs"]))})
