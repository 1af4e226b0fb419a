"""The port's Lomb-Scargle periodogram (``periodogram.py``) against the JAX
package's, on CPU tensors in float64:

- ``lomb_scargle`` against the JAX function for the four normalizations x
  ``fit_mean`` x ``center_data`` x ``dy`` given or not: rtol 1e-10, atol
  1e-12 (the weighted sums are taken in another order by XLA and by torch);
- evaluated in chunks against one chunk: rtol 1e-12 (a chunk changes only
  which rows a matrix product forms at once);
- the direct per-frequency weighted least-squares check of
  tests/test_periodogram.py (rtol 1e-8, atol 1e-10), its peak recovery and
  its normalization identities;
- ``autofrequency`` and ``ls_false_alarm_level`` equal to the JAX package's
  (numpy code in both).

A numpy input goes to the card by default, a tensor keeps its device; the
``cuda`` case holds the card's power against the CPU's at the full N = 5000
grid (``python -m pytest --noconftest -m cuda tests/test_torch_periodogram.py``
on a card).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mind_the_gaps_tpu_torch.periodogram import (  # noqa: E402
    NORMALIZATIONS,
    autofrequency,
    default_chunk,
    lomb_scargle,
    ls_false_alarm_level,
)


def _data(n=120, seed=1, t0=0.0):
    rng = np.random.default_rng(seed)
    t = t0 + np.sort(rng.uniform(0, 50, n))
    y = 2.0 + np.sin(2 * np.pi * 0.3 * t) + rng.normal(0, 0.4, n)
    return t, y, rng.uniform(0.3, 0.6, n)


def _ls_direct(t, y, dy, freq):
    """chi^2 of the weighted LSQ fit of a + b cos + c sin at one frequency
    against the constant-only model; standard normalization (the JAX
    suite's reference)."""
    w = 1.0 / dy**2
    X = np.column_stack([np.ones_like(t), np.cos(2 * np.pi * freq * t), np.sin(2 * np.pi * freq * t)])
    WX = X * w[:, None]
    beta = np.linalg.solve(X.T @ WX, WX.T @ y)
    chi2 = np.sum(w * (y - X @ beta) ** 2)
    ymean = np.sum(w * y) / np.sum(w)
    return 1.0 - chi2 / np.sum(w * (y - ymean) ** 2)


@pytest.mark.parametrize("normalization,fit_mean,center_data,with_dy",
                         list(itertools.product(NORMALIZATIONS, (True, False), (True, False), (True, False))))
def test_lomb_scargle_matches_jax(normalization, fit_mean, center_data, with_dy):
    from mind_the_gaps_tpu.periodogram import lomb_scargle as jls

    t, y, dy = _data()
    freqs = autofrequency(t)
    dy = dy if with_dy else None
    kw = dict(normalization=normalization, fit_mean=fit_mean, center_data=center_data)
    got = lomb_scargle(torch.as_tensor(t), y, freqs, dy=dy, **kw)
    ref = np.asarray(jls(t, y, freqs, dy=dy, **kw))
    assert got.dtype == torch.float64 and got.device.type == "cpu" and got.shape == (freqs.size,)
    assert np.all(np.isfinite(ref))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("normalization", NORMALIZATIONS)
def test_chunks_equal_one_chunk(normalization, monkeypatch):
    import mind_the_gaps_tpu_torch.periodogram as pg

    t, y, dy = _data(n=200, seed=5, t0=5e7)
    freqs = autofrequency(t, samples_per_peak=3)
    one = lomb_scargle(torch.as_tensor(t), y, freqs, dy=dy, normalization=normalization)
    assert default_chunk(200) >= freqs.size
    for chunk in (1, 7, 64):  # CHUNK_BYTES for that many frequencies a chunk
        monkeypatch.setattr(pg, "CHUNK_BYTES", chunk * 4 * 8 * 200)
        assert default_chunk(200) == chunk
        got = lomb_scargle(torch.as_tensor(t), y, freqs, dy=dy, normalization=normalization)
        torch.testing.assert_close(got, one, rtol=1e-12, atol=0)
    monkeypatch.undo()
    assert default_chunk(5000) * 5000 * 8 * 4 <= 1 << 30 < (default_chunk(5000) + 1) * 5000 * 8 * 4


def test_matches_direct_least_squares():
    t, y, dy = _data()
    freqs = np.array([0.05, 0.13, 0.3, 0.77, 1.9])
    power = lomb_scargle(torch.as_tensor(t), y, freqs, dy=dy).numpy()
    ref = np.array([_ls_direct(t, y, dy, f) for f in freqs])
    np.testing.assert_allclose(power, ref, rtol=1e-8, atol=1e-10)


def test_peak_recovery_and_normalizations():
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 100, 400))
    y = 3.0 + 1.5 * np.sin(2 * np.pi * 0.55 * t + 0.3) + rng.normal(0, 0.5, len(t))
    freqs = autofrequency(t)
    power = lomb_scargle(torch.as_tensor(t), y, freqs, dy=np.full(len(t), 0.5)).numpy()
    assert abs(freqs[np.argmax(power)] - 0.55) < 2.0 / 100 and power.max() > 0.5

    t = np.sort(rng.uniform(0, 30, 100))
    y = rng.normal(0, 1, 100)
    freqs = np.linspace(0.05, 2, 50)
    std, model, log = (lomb_scargle(torch.as_tensor(t), y, freqs, normalization=k).numpy()
                       for k in ("standard", "model", "log"))
    np.testing.assert_allclose(model, std / (1 - std), rtol=1e-10)
    np.testing.assert_allclose(log, -np.log(1 - std), rtol=1e-10)
    assert np.all(std >= 0) and np.all(std <= 1)


def test_frequency_grid_and_false_alarm_level_match_jax():
    from mind_the_gaps_tpu.periodogram import autofrequency as jauto
    from mind_the_gaps_tpu.periodogram import ls_false_alarm_level as jfal

    t = np.sort(np.random.default_rng(3).uniform(0, 100, 200))
    for kw in ({}, {"samples_per_peak": 10}, {"maximum_frequency": 0.7}):
        np.testing.assert_array_equal(autofrequency(t, **kw), jauto(t, **kw))
    freqs = autofrequency(t)
    z1, z5 = ls_false_alarm_level(0.01, 200, freqs, t), ls_false_alarm_level(0.05, 200, freqs, t)
    assert 0 < z5 < z1 < 1
    assert z1 == jfal(0.01, 200, freqs, t) and z5 == jfal(0.05, 200, freqs, t)
    assert ls_false_alarm_level(0.01, 200, torch.as_tensor(freqs), torch.as_tensor(t)) == z1


def test_device_rule_and_refusals():
    t, y, dy = _data(n=30)
    assert lomb_scargle(torch.as_tensor(t), y, [0.1, 0.2]).device.type == "cpu"
    assert lomb_scargle(t, y, [0.1, 0.2], device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="normalization"):
        lomb_scargle(torch.as_tensor(t), y, [0.1], normalization="nope")
    if not torch.cuda.is_available():  # a numpy input goes to the card, with no fallback
        with pytest.raises((RuntimeError, AssertionError)):
            lomb_scargle(t, y, [0.1, 0.2])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("normalization", NORMALIZATIONS)
def test_card_matches_cpu_at_full_grid(cuda, normalization):
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(2.0, 8.0, 5000))
    y, dy = 10.0 + rng.normal(0, 1, 5000), np.full(5000, 0.3)
    freqs = autofrequency(t)
    assert freqs.size == 62_500
    got = lomb_scargle(t, y, freqs, dy=dy, normalization=normalization)
    assert got.device.type == "cuda"
    ref = lomb_scargle(torch.as_tensor(t), y, freqs, dy=dy, normalization=normalization)
    assert float((got.cpu() - ref).abs().max()) <= 1e-9 * float(ref.abs().max())
