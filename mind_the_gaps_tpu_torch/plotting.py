"""Plotting helpers for the standard diagnostics.

PyTorch port of ``mind_the_gaps_tpu/plotting.py``: the same five figures
(matplotlib, imported lazily inside each function, Agg when no display
backend is active).  Whatever the port hands over as a tensor, on any
device, is brought to numpy before matplotlib sees it.  matplotlib is not a
dependency of the package: importing this module does not need it.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "plot_lightcurve",
    "plot_gp_prediction",
    "plot_posteriors",
    "plot_t_distribution",
    "plot_standardized_residuals",
]


def _plt():
    import matplotlib

    backend = matplotlib.get_backend().lower()
    # fall back to Agg only when no working backend is active: GUI
    # backends, the Jupyter inline/nbagg backends ("module://..."), and
    # Agg itself all must be left alone (switching away from inline
    # silently swallows notebook figures)
    if not backend.startswith(
        ("qt", "tk", "macosx", "gtk", "webagg", "nbagg", "module://")
    ) and "agg" not in backend:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x):
    """numpy of ``x``: a tensor on any device, or array-like."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plot_lightcurve(lc, ax=None, **kwargs):
    """Errorbar plot of a GappyLightcurve (times in days)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(9, 3.2))
    kwargs.setdefault("fmt", ".")
    kwargs.setdefault("color", "black")
    kwargs.setdefault("markersize", 3)
    dy = None if lc.dy is None else _np(lc.dy)
    ax.errorbar(_np(lc.times) / 86400.0, _np(lc.y), yerr=dy, ls="None", **kwargs)
    ax.set_xlabel("Time (d)")
    ax.set_ylabel("Rate")
    return ax


def plot_gp_prediction(gp, t_pred=None, n_grid=500, ax=None, color="C0"):
    """Model curve (mean +/- 1 sigma band) over the data, at the kernel's
    current parameters (set gp parameters first, e.g. to max_parameters)."""
    lc = gp._lightcurve
    times = _np(lc.times)
    t_pred = np.linspace(times[0], times[-1], n_grid) if t_pred is None else _np(t_pred)
    mu, var = (_np(v) for v in gp.predict(t_pred))
    sd = np.sqrt(np.maximum(var, 0))
    ax = plot_lightcurve(lc, ax=ax)
    ax.plot(t_pred / 86400.0, mu, color=color, lw=1.5, label="GP mean")
    ax.fill_between(t_pred / 86400.0, mu - sd, mu + sd, color=color, alpha=0.3, lw=0)
    ax.legend()
    return ax


def plot_posteriors(gp, fig=None, bins=40, truths=None):
    """Corner-style pair grid of the MCMC samples (1-D histograms on the
    diagonal, 2-D histograms below)."""
    plt = _plt()
    samples = _np(gp.mcmc_samples)
    names = gp.parameter_names
    d = samples.shape[1]
    if fig is None:
        fig, axes = plt.subplots(d, d, figsize=(2.2 * d, 2.2 * d), squeeze=False)
    else:
        axes = np.array(fig.axes).reshape(d, d)
    if truths is not None:
        truths = _np(truths)
    for i in range(d):
        for j in range(d):
            ax = axes[i][j]
            if j > i:
                ax.axis("off")
                continue
            if i == j:
                ax.hist(samples[:, i], bins=bins, color="C0", histtype="step")
                if truths is not None:
                    ax.axvline(truths[i], color="C3")
            else:
                ax.hist2d(samples[:, j], samples[:, i], bins=bins, cmap="Blues")
                if truths is not None:
                    ax.axvline(truths[j], color="C3")
                    ax.axhline(truths[i], color="C3")
            if i == d - 1:
                ax.set_xlabel(names[j], fontsize=8)
            if j == 0 and i > 0:
                ax.set_ylabel(names[i], fontsize=8)
    fig.tight_layout()
    return fig


def plot_t_distribution(result, ax=None, bins=40):
    """Histogram of the bootstrap T distribution with the observed T
    (the reference's plot_ratio_test figure)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 4))
    t_dist, t_obs, p_value = _np(result.t_dist), float(result.t_obs), float(result.p_value)
    ax.hist(t_dist, bins=bins, color="C0", histtype="stepfilled", alpha=0.6)
    ax.axvline(t_obs, color="C3", lw=2, label=f"T_obs = {t_obs:.2f}")
    ax.set_xlabel(r"$T = -2(\log L_0 - \log L_1)$")
    ax.set_ylabel("simulations")
    ax.set_title(f"p = {p_value:.4f} ({len(t_dist)} simulations)")
    ax.legend()
    return ax


def plot_standardized_residuals(gp, parameters=None, ax=None):
    """Standardized residuals with N(0,1) reference histogram."""
    plt = _plt()
    res = _np(gp.standarized_residuals(parameters=parameters))
    if ax is None:
        _, axes = plt.subplots(1, 2, figsize=(9, 3.2), width_ratios=[3, 1])
        ax, axh = axes
    else:
        axh = None
    lc = gp._lightcurve
    ax.plot(_np(lc.times) / 86400.0, res, ".", color="black", markersize=3)
    ax.axhline(0, color="C0")
    ax.set_xlabel("Time (d)")
    ax.set_ylabel("standardized residual")
    if axh is not None:
        axh.hist(res, bins=30, orientation="horizontal", color="C0", histtype="step", density=True)
        x = np.linspace(-4, 4, 100)
        axh.plot(np.exp(-0.5 * x**2) / np.sqrt(2 * np.pi), x, color="C3")
        axh.set_yticklabels([])
    return ax
