"""Lomb-Scargle periodogram on float64 tensors.

PyTorch port of ``mind_the_gaps_tpu/periodogram.py``: the generalized
(floating-mean) Lomb-Scargle of Zechmeister & Kuerster (2009) as dense
(F, N) trigonometric matrices contracted with the weights, the frequency
grid heuristic and the Baluev (2008) false-alarm level.

``lomb_scargle`` evaluates the frequencies in chunks, so that its working
set stays bounded: at N = 5000 and astropy's default grid (F = 12.5 N),
one (F, N) float64 matrix is 2.5 GB and the function holds several at
once.  Each frequency's sums are independent of every other frequency's,
so a chunk changes nothing but the order in which the rows are formed.
The products are plain contractions (``torch.matmul``), as the JAX
package leaves them to XLA; no TPU kernel sits under this module.

Float64 only: t is often ~1e8 s, where omega t reaches ~1e7 rad and float32
cosines are noise.  ``autofrequency`` and ``ls_false_alarm_level`` are the
JAX package's numpy code (they take tensors too).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["lomb_scargle", "autofrequency", "ls_false_alarm_level"]

NORMALIZATIONS = ("standard", "model", "log", "psd")
# bytes of (F_c, N) float64 matrices a chunk may hold: the phases, their
# cosine and sine, and one product
CHUNK_BYTES = 1 << 30
_MATRICES = 4


def _host(x):
    """A numpy array of ``x`` (a tensor on any device, or array-like)."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def autofrequency(times, samples_per_peak: int = 5, nyquist_factor: int = 5, maximum_frequency=None):
    """Heuristic frequency grid (astropy-compatible defaults), numpy."""
    times = _host(times)
    baseline = times.max() - times.min()
    n = len(times)
    df = 1.0 / baseline / samples_per_peak
    if maximum_frequency is None:
        avg_nyquist = 0.5 * n / baseline
        maximum_frequency = nyquist_factor * avg_nyquist
    nf = int(np.floor(maximum_frequency / df))
    return df * (1 + np.arange(nf))


def default_chunk(n: int) -> int:
    """Frequencies a chunk for ``n`` points: its (F_c, n) matrices within
    ``CHUNK_BYTES``."""
    return max(1, CHUNK_BYTES // (_MATRICES * 8 * max(n, 1)))


def lomb_scargle(
    times,
    y,
    frequencies,
    dy=None,
    normalization: str = "standard",
    fit_mean: bool = True,
    center_data: bool = True,
    device="cuda",
):
    """Generalized Lomb-Scargle power (F,) at the given frequencies (in
    1/time units, NOT angular), a float64 tensor on the device of ``times``
    when it is a tensor, else on ``device``.

    normalization: 'standard' (0..1), 'model', 'log', or 'psd'.  The
    frequencies are evaluated ``default_chunk(N)`` at a time."""
    if normalization not in NORMALIZATIONS:
        raise ValueError(f"unknown normalization {normalization!r}")
    dev = times.device if torch.is_tensor(times) else torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    t = torch.as_tensor(times, **f64)
    y = torch.as_tensor(y, **f64)
    f = torch.as_tensor(frequencies, **f64)

    if dy is None:
        w = torch.ones_like(y)
    else:
        w = 1.0 / torch.as_tensor(dy, **f64) ** 2
    w_total = w.sum()
    w = w / w_total

    yc = y - torch.sum(w * y) if (center_data or fit_mean) else y
    wy = w * yc
    yy = torch.sum(wy * yc)
    weights = torch.stack([w, wy], dim=1)  # (N, 2)
    tiny = torch.finfo(torch.float64).tiny

    step = default_chunk(t.shape[0])
    power = []
    for start in range(0, f.shape[0], step):
        omega = 2.0 * torch.pi * f[start : start + step]
        theta = omega[:, None] * t[None, :]  # (F_c, N)
        sin = torch.sin(theta)
        cos = torch.cos_(theta)  # theta's storage
        S, Sy = (sin @ weights).unbind(1)
        C, Cy = (cos @ weights).unbind(1)
        CC = (cos * cos) @ w
        CS = (cos * sin) @ w
        del sin, cos
        SS = 1.0 - CC
        if fit_mean:
            CC = CC - C * C
            SS = SS - S * S
            CS = CS - C * S
        # tan(2 omega tau)-free solution of the 2x2 normal equations
        det = CC * SS - CS * CS
        det = torch.where(det <= 0, det.new_full((), tiny), det)
        power.append((SS * Cy * Cy + CC * Sy * Sy - 2.0 * CS * Cy * Sy) / (yy * det))
    p = torch.cat(power) if power else f.new_zeros(0)

    if normalization == "standard":
        return p
    if normalization == "model":
        return p / (1.0 - p)
    if normalization == "log":
        return -torch.log(1.0 - p)
    return 0.5 * p * yy * w_total


def ls_false_alarm_level(p_fal, n_points, frequencies, times, method: str = "baluev"):
    """False-alarm power threshold (Baluev 2008 aliasing-free upper
    bound), matching astropy's 'baluev' method for the standard
    normalization."""
    times = _host(times)
    fmax = np.max(_host(frequencies))
    n = n_points
    # Baluev 2008: effective bandwidth W = fmax * Teff, Teff = sqrt(4 pi var(t))
    teff = np.sqrt(4 * np.pi * np.var(times))
    W = fmax * teff

    def fap(z):
        # single-frequency FAP for the standard normalization
        p_single = (1 - z) ** ((n - 3) / 2)
        tau = W * np.sqrt(z) * (1 - z) ** ((n - 4) / 2)
        return 1 - (1 - p_single) * np.exp(-tau)

    # solve fap(z) = p_fal by bisection (fap is decreasing in z)
    lo, hi = 1e-10, 1 - 1e-10
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if fap(mid) > p_fal:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
