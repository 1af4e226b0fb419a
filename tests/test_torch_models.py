"""Port parity: the analytic PSD models, ``Term.variance``, the
``celerite_models`` alias and the mean models' batched curves, against the
JAX package at random parameters (float64, rtol 1e-12: the same formulas
in the same order)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import mind_the_gaps_tpu.kernels as jk  # noqa: E402
import mind_the_gaps_tpu.models.mean_models as jmm  # noqa: E402
import mind_the_gaps_tpu.models.psd_models as jpsd  # noqa: E402
import mind_the_gaps_tpu_torch.kernels as tk  # noqa: E402
import mind_the_gaps_tpu_torch.models.mean_models as tmm  # noqa: E402
import mind_the_gaps_tpu_torch.models.psd_models as tpsd  # noqa: E402

PSD_MODELS = ["SHO", "Lorentzian", "BendingPowerlaw", "Matern32", "Matern52", "Jitter", "PowerLaw",
              "BrokenPowerLaw"]


def _random_params(cls, rng):
    return {name: float(rng.uniform(0.3, 3.0)) for name in cls.parameter_names}


@pytest.mark.parametrize("name", PSD_MODELS)
def test_psd_models_match_jax(name):
    rng = np.random.default_rng(len(name))
    omega = np.linspace(0.01, 6.0, 257)
    for _ in range(3):
        params = _random_params(getattr(jpsd, name), rng)
        ref = np.asarray(getattr(jpsd, name)(**params)(jnp.asarray(omega)))
        out = getattr(tpsd, name)(**params)(torch.as_tensor(omega))
        assert torch.is_tensor(out) and out.dtype == torch.float64
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12)
        np.testing.assert_allclose(getattr(tpsd, name)(**params)(omega).numpy(), ref, rtol=1e-12)


def test_psd_sum_defaults_setattr_and_matern():
    omega = np.linspace(0.05, 3.0, 64)
    t_sum = tpsd.Lorentzian(S0=2.0, Q=5.0, omega0=1.0) + tpsd.BendingPowerlaw(S0=3.0, omega0=0.2)
    j_sum = jpsd.Lorentzian(S0=2.0, Q=5.0, omega0=1.0) + jpsd.BendingPowerlaw(S0=3.0, omega0=0.2)
    np.testing.assert_allclose(t_sum(omega).numpy(), np.asarray(j_sum(omega)), rtol=1e-12)
    model = tpsd.SHO()
    assert (model.S0, model.Q, model.omega0) == (1.0, 10.0, 1.0) and "SHO(" in repr(model)
    model.S0 = 4.0
    np.testing.assert_allclose(model(omega).numpy(), np.asarray(jpsd.SHO(S0=4.0)(omega)), rtol=1e-12)
    for kw in ({}, dict(sigma=1.5, rho=0.7, n=2, nu=5 / 2)):
        np.testing.assert_allclose(tpsd.Matern(omega, **kw).numpy(), np.asarray(jpsd.Matern(omega, **kw)),
                                   rtol=1e-12)


KERNELS = {
    "drw": lambda m: m.DampedRandomWalk(1.0, -3.0),
    "drw_qpo": lambda m: m.DampedRandomWalk(1.0, -3.0) + m.Lorentzian(-1.0, 2.0, -2.0),
    "sho": lambda m: m.SHOTerm(0.5, 1.0, -2.5),
    "matern32": lambda m: m.Matern32Term(0.1, 1.2),
    "jitter": lambda m: m.JitterTerm(-1.0) + m.Cosinus(0.2, -1.0),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_term_variance_matches_jax(name):
    kj, kt = KERNELS[name](jk), KERNELS[name](tk)
    rng = np.random.default_rng(7)
    for theta in kj.get_parameter_vector() + 0.2 * rng.normal(size=(3, kj.ndim)):
        ref = float(kj.variance(jnp.asarray(theta)))
        np.testing.assert_allclose(float(kt.variance(torch.as_tensor(theta))), ref, rtol=1e-12)
    np.testing.assert_allclose(float(kt.variance()), float(kj.variance()), rtol=1e-12)
    batch = kj.get_parameter_vector() + 0.2 * rng.normal(size=(4, kj.ndim))
    out = kt.variance(torch.as_tensor(batch))
    assert out.shape == (4,)
    np.testing.assert_allclose(out.numpy(), [float(kj.variance(jnp.asarray(b))) for b in batch], rtol=1e-12)


def test_celerite_models_alias_and_models_namespace():
    from mind_the_gaps_tpu_torch import models
    from mind_the_gaps_tpu_torch.models import celerite_models

    for name in celerite_models.__all__:
        assert getattr(celerite_models, name) is getattr(tk, name)
    assert models.psd_models is tpsd and models.LinearModel is tmm.LinearModel
    assert models.DampedRandomWalk is tk.DampedRandomWalk


MEAN_MODELS = {
    "ConstantModel": [2.5],
    "LinearModel": [0.03, 9.0],
    "GaussianModel": [40.0, 12.0, 300.0],
    "SineModel": [1.0, 0.5, 0.2, 0.3],
    "TwoSineModel": [1.0, 0.5, 0.2, 0.3, 0.1, 0.05],
}


@pytest.mark.parametrize("name", sorted(MEAN_MODELS))
def test_mean_model_curves_match_jax_single_and_batched(name):
    t = np.linspace(0.0, 100.0, 57)
    base = np.asarray(MEAN_MODELS[name])
    mt, mj = getattr(tmm, name)(*base), getattr(jmm, name)(*base)
    thetas = base * (1.0 + 0.1 * np.random.default_rng(3).normal(size=(5, base.size)))
    refs = np.stack([np.asarray(mj.value(jnp.asarray(t), jnp.asarray(th))) for th in thetas])
    single = mt.value(torch.as_tensor(t), torch.as_tensor(thetas[0]))
    batched = mt.value(torch.as_tensor(t), torch.as_tensor(thetas))
    assert single.shape == (57,) and batched.shape == (5, 57)
    np.testing.assert_allclose(single.numpy(), refs[0], rtol=1e-12)
    np.testing.assert_allclose(batched.numpy(), refs, rtol=1e-12)
    np.testing.assert_allclose(mt.log_prior(torch.as_tensor(thetas)).numpy(), np.zeros(5))
