"""Integrated autocorrelation time on ``torch.fft``.

PyTorch port of ``mind_the_gaps_tpu/sampler/autocorr.py``: the estimator
of emcee's ``get_autocorr_time(tol=0)`` — per-walker FFT autocorrelation,
averaged across walkers, tau = 2 cumsum(rho) - 1 with Sokal's automated
window (c = 5) — in float64 throughout.  ``autocorr_function`` and
``integrated_autocorr_time_np`` are the host (numpy) forms.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "integrated_autocorr_time",
    "integrated_autocorr_time_masked",
    "integrated_autocorr_time_np",
    "autocorr_function",
]


def _next_pow_two(n: int) -> int:
    i = 1
    while i < n:
        i <<= 1
    return i


def autocorr_function(x):
    """Normalized autocorrelation of a 1-D numpy series by FFT, in float64
    (the JAX package rounds the series to float32 first, for the TPU's
    complex64-only FFT)."""
    x = np.asarray(x)
    n = x.shape[0]
    m = 2 * _next_pow_two(n)
    f = np.fft.fft(x - np.mean(x), n=m)
    acf = np.fft.ifft(f * np.conj(f))[:n].real
    return acf / acf[0]


def integrated_autocorr_time_np(chain, c: float = 5.0):
    """tau (D,) of a numpy (n_steps, W, D) chain as numpy, on the host: the
    estimator of ``integrated_autocorr_time``."""
    return integrated_autocorr_time(torch.as_tensor(np.asarray(chain, dtype=np.float64)), c).numpy()


def integrated_autocorr_time_masked(chain_buf, n_valid: int, c: float = 5.0):
    """tau (D,) over the first ``n_valid`` steps of a fixed-size chain
    buffer (S, W, D): the rows at and after ``n_valid`` are left out of
    the mean, zero in the FFT (the 2 * next_pow2(S) transform keeps every
    lag < S exact) and out of the window search.  Constant (stuck)
    walkers count as fully correlated."""
    x = torch.as_tensor(chain_buf).to(torch.float64)
    s = x.shape[0]
    idx = torch.arange(s, device=x.device)
    valid = idx < n_valid
    mask = valid[:, None, None]
    xmean = torch.where(mask, x, 0.0).sum(0) / n_valid
    x = torch.where(mask, x - xmean, 0.0)
    m = 2 * _next_pow_two(s)
    f = torch.fft.rfft(x, n=m, dim=0)
    acf = torch.fft.irfft(f * f.conj(), n=m, dim=0)[:s]
    norm = acf[:1]
    dead = ~(norm > 0)
    acf = torch.where(dead, 1.0, acf / torch.where(dead, 1.0, norm))
    rho = acf.mean(1)  # (S, D)
    taus = 2.0 * torch.cumsum(rho, 0) - 1.0
    crossed = (idx[:, None] >= c * taus) & valid[:, None]
    first = torch.argmax(crossed.to(torch.uint8), dim=0)
    window = torch.where(crossed.any(0), first, torch.full_like(first, n_valid - 1))
    return taus[window, torch.arange(taus.shape[1], device=x.device)]


def integrated_autocorr_time(chain, c: float = 5.0):
    """tau (D,) of a whole (n_steps, W, D) chain."""
    chain = torch.as_tensor(chain)
    return integrated_autocorr_time_masked(chain, chain.shape[0], c)
