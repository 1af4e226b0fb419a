"""The benchmark's data: the production scenario of the LRT, made from a seed.

A frozen copy of ``mind_the_gaps_tpu_torch/examples/lrt_10k.py::scenario``
(itself the JAX repo's ``benchmarks/lrt_10k.py``), with its fixed
``default_rng(0)`` replaced by a stream seeded from the run's ``--seed``
and its sizes read from the configuration: times ``cumsum(U(dt_low,
dt_high))``, an exact DRW (Ornstein-Uhlenbeck) realization of variance
S0 and rate w0, Gaussian measurement noise ``dy`` around ``mean``.  Every
seed gives the same number of points and the same model; only the draws
differ.
"""
from __future__ import annotations

import numpy as np

__all__ = ["lightcurve_arrays", "derived_seed"]


def derived_seed(*words) -> int:
    """A 31-bit seed from integer words (the run's ``--seed``, a call's
    index, ...), so that every call of a run has a stream of its own."""
    return int(np.random.SeedSequence([int(w) for w in words]).generate_state(1, np.uint32)[0] >> 1)


def lightcurve_arrays(data: dict, n_points: int, seed: int):
    """(times, y, dy) float64 numpy arrays of ``n_points`` points for the
    ``data`` block of a configuration, from ``seed``."""
    rng = np.random.default_rng([int(seed), 0])
    t = np.cumsum(rng.uniform(data["dt_low"], data["dt_high"], n_points))
    S0, w0 = np.exp(data["log_S0"]), np.exp(data["log_omega0"])
    phi = np.exp(-w0 * np.diff(t))
    innov = rng.normal(0.0, np.sqrt(S0 * (1.0 - phi**2)))
    y = np.empty(n_points)
    y[0] = rng.normal(0.0, np.sqrt(S0))
    for i in range(1, n_points):
        y[i] = phi[i - 1] * y[i - 1] + innov[i - 1]
    dy = np.full(n_points, float(data["dy"]))
    y = y + data["mean"] + rng.normal(0.0, dy)
    return t, y, dy
