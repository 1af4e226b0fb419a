"""The faint-source bootstrap driver: ``drivers/bootstrap.py``'s closed loop of
whole ``protassov_lrt`` calls, on a faint X-ray source.

The source is counted: each bin of ``exposure`` seconds holds
Poisson(rate x exposure + background counts) counts over a background whose
rate varies by bin (uniform in [``bkg_rate_low``, ``bkg_rate_high``]
counts/s, drawn from the run's seed).  A lightcurve with a background and
no ``sigma_noise`` makes the port's simulator draw the same noise: net rate
(counts - background) / exposure, dy = sqrt(counts) / exposure in
quadrature with ``background_rate_err``, and on each bin under
``kraft_counts`` counts the Kraft, Burrows & Nousek (1991) posterior median
and half the 68% minimal interval, over the exposure (``KraftNoise``; its
tables are built anew in every call, as ``protassov_lrt`` makes a new
simulator).

Set-up: the observed lightcurve, a faint source drawn the same way from
the configuration's noise-free DRW (``scenario.lightcurve_arrays`` with dy
0), its low bins given the plain reference's Kraft values
(``reference_kraft.py``, on the host in float64, at each low bin's own
count only: the reference's tables are built in the check, after the
window, so that set-up holds the data and not the reference); then
``bootstrap.py``'s observed fits and warm-up.  A call is ``bootstrap.py``'s,
and keeps the noise model the call's simulator built, with its tables on
the device as they are (no copy, no sync).

``correct``: ``bootstrap.py``'s five numbers, and after the window:

- ``kraft_table_err``: the largest difference of the kept tables (median,
  lo, hi) from the reference's, relative to max(|value|, 1), over N =
  0..ceil(kraft_counts) and every bin of every call;
- ``noise_err`` (rate units), over every kept simulated row and bin: the
  count is recovered as y x exposure + background counts.  Where that is
  a whole number (within ``WHOLE``) of at least ``kraft_counts``, the bin
  must carry the Poisson dy; elsewhere it must be a Kraft bin: y x exposure
  the reference's median for some N and dy x exposure the half-width of
  the reference's interval at that N.  A whole count under
  ``kraft_counts`` left as it was lies off every median and reads as its
  distance from the nearest one;
- ``kraft_count_err`` (rate units): each kept noise model, the timed
  path's own, given every whole count 0..ceil(kraft_counts) + 1 at every
  bin (``add_noise_torch(..., counts=...)``, which recovers each total as
  a simulation does, a rounding error below its count at some bins): each
  must carry the reference's Kraft values at that count, or at and above
  ``kraft_counts`` the Poisson ones.  ``noise_err`` sees only that a
  bin's (y, dy) belong to one count; this number sees that it is the
  drawn one.

The control, in the program's place: ``bootstrap.py``'s, and the
reference's tables computed in float32 (the configuration states the
tables in float64, ``precision.generation``) in place of the kept ones.
"""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from gpbench import reference_kraft
from gpbench.program import kernel
from gpbench.run import load_module
from gpbench.scenario import derived_seed, lightcurve_arrays

_bootstrap = load_module([Path(__file__).resolve().parents[1]], "drivers", "bootstrap")
libraries, launch_shape, free = _bootstrap.libraries, _bootstrap.launch_shape, _bootstrap.free

WHOLE = 1e-6  # counts: how near a whole number a recovered count lies where the bin took Poisson noise


def _max_count(data) -> int:
    return max(int(np.ceil(data["kraft_counts"])), 0)


def faint_source(data: dict, n_points: int, seed: int):
    """(times, y, dy, background rates, background rate errors) float64
    numpy arrays of a faint source from ``seed``: the reference's Kraft
    values, on the host, at the low bins' counts."""
    t, rates, _ = lightcurve_arrays(dict(data, dy=0.0), n_points, seed)
    exposure = data["exposure"]
    rng = np.random.default_rng([int(seed), 8])
    bkg_rate = background_rates(data, n_points, seed)
    bkg = bkg_rate * exposure
    counts = rng.poisson(np.clip(rates * exposure + bkg, 0.0, None)).astype(np.float64)
    err = np.full(n_points, float(data["background_rate_err"]))
    y = (counts - bkg) / exposure
    dy = np.sqrt((np.sqrt(counts) / exposure) ** 2 + err**2)
    low = counts < data["kraft_counts"]
    n, b = torch.as_tensor(np.clip(counts[low], 0, _max_count(data))).long(), torch.as_tensor(bkg[low])
    lo, hi = reference_kraft.hpd_interval(n, b)
    y[low] = reference_kraft.median(n, b).numpy() / exposure
    dy[low] = (hi - lo).numpy() / 2.0 / exposure
    return t, y, dy, bkg_rate, err


def background_rates(data: dict, n_points: int, seed: int) -> np.ndarray:
    """The background rate of each bin, from ``seed``."""
    rng = np.random.default_rng([int(seed), 7])
    return rng.uniform(data["bkg_rate_low"], data["bkg_rate_high"], n_points)


def setup(ctx):
    from mind_the_gaps_tpu_torch.gpmodelling import GPModelling
    from mind_the_gaps_tpu_torch.lightcurves import GappyLightcurve

    cfg, data = ctx.config, ctx.config["data"]
    n = cfg["n_points"]
    t, y, dy, bkg_rate, err = faint_source(data, n, ctx.seed)
    lc = GappyLightcurve(t, y, dy, exposures=data["exposure"], bkg_rate=bkg_rate, bkg_rate_err=err)
    s = ctx.state = SimpleNamespace(t=t, y=y, dy=dy, lc=lc, null_k=kernel(cfg["null"]), alt_k=kernel(cfg["alt"]),
                                    bkg_counts=bkg_rate * data["exposure"], err=err)
    fitted = []
    for i, kern in enumerate((s.null_k, s.alt_k)):
        model = GPModelling(lc, kern, device=ctx.device)
        model.derive_posteriors(fit=True, max_steps=cfg["observed_max_steps"], walkers=cfg["observed_walkers"],
                                seed=derived_seed(ctx.seed, 1, i))
        fitted.append(model)
    s.null_m, s.alt_m = fitted
    _bootstrap._lrt(ctx, cfg["chunk"] - 1, derived_seed(ctx.seed, 2))  # one chunk: every shape of the window


def call(ctx, index: int) -> dict:
    record = _bootstrap.call(ctx, index)
    record["noise"] = getattr(getattr(ctx.state.null_m, "_simulator", None), "noise", None)
    return record


def _tables(noise) -> tuple:
    return tuple(getattr(noise, name, None) for name in ("median_table", "lo_table", "hi_table"))


def _table_err(got, ref) -> torch.Tensor:
    return max(((g.double() - r).abs() / r.abs().clamp(min=1.0)).max() for g, r in zip(got, ref))


def _noise_err(y, dy, s, data, med, half) -> float:
    """The largest departure of the rows (y, dy) from the noise model, in
    rate units (see the module's docstring)."""
    exposure = data["exposure"]
    cols = np.arange(y.shape[1])
    c = y * exposure + s.bkg_counts
    whole = np.round(c)
    poisson = (np.abs(c - whole) <= WHOLE) & (whole >= data["kraft_counts"])
    dy_poisson = np.sqrt((np.sqrt(np.clip(whole, 0.0, None)) / exposure) ** 2 + s.err**2)
    dist = np.abs(y[:, None, :] * exposure - med[None])  # (rows, N, bins)
    n = dist.argmin(1)
    kraft = np.maximum(np.take_along_axis(dist, n[:, None], 1)[:, 0], np.abs(dy * exposure - half[n, cols]))
    return float(np.max(np.where(poisson, np.abs(dy - dy_poisson), kraft / exposure)))


def _count_err(noise, s, data, med, half) -> float:
    """The largest departure of ``noise``'s answers at known counts from the
    reference's, in rate units (see the module's docstring)."""
    exposure, n_bins = data["exposure"], med.shape[1]
    counts = np.repeat(np.arange(_max_count(data) + 2, dtype=np.float64)[:, None], n_bins, 1)
    c = torch.as_tensor(counts, device=noise.median_table.device)
    y, dy = (x.cpu().numpy() for x in noise.add_noise_torch(torch.zeros_like(c), counts=c))
    n = np.minimum(counts, _max_count(data)).astype(np.int64)
    cols = np.arange(n_bins)
    low = counts < data["kraft_counts"]
    want_y = np.where(low, med[n, cols], counts - s.bkg_counts) / exposure
    want_dy = np.where(low, half[n, cols] / exposure, np.sqrt((np.sqrt(counts) / exposure) ** 2 + s.err**2))
    return float(max(np.abs(y - want_y).max(), np.abs(dy - want_dy).max()))


def check(ctx):
    """(the compared numbers with their limits, problems)."""
    checks, problems = _bootstrap.check(ctx)
    s, data, lim = ctx.state, ctx.config["data"], ctx.limits
    missing = [i for i, r in enumerate(ctx.records) if any(x is None for x in _tables(r["noise"]))]
    if missing:
        problems.append(f"calls {missing} built no Kraft tables: the simulations took no Kraft noise")
        return checks, problems
    ref = reference_kraft.kraft_tables(s.bkg_counts, _max_count(data), device=ctx.device)
    tables = [_tables(r["noise"]) for r in ctx.records]
    if ctx.control:  # the reference's own tables, one precision down, in the program's place
        tables = [reference_kraft.kraft_tables(s.bkg_counts, _max_count(data), device=ctx.device,
                                               dtype=torch.float32)]
    table_err = float(max(_table_err(got, ref) for got in tables))
    med, lo, hi = (x.cpu().numpy() for x in ref)
    half = 0.5 * (hi - lo)
    noise_err = max(_noise_err(r["kept"]["y"], r["kept"]["dy"], s, data, med, half) for r in ctx.records)
    count_err = max(_count_err(r["noise"], s, data, med, half) for r in ctx.records)
    drawn = [r["timings"].get("kraft_bins") for r in ctx.records]
    if all(drawn):
        replaced = sum(r["timings"]["kraft_bins_replaced"] for r in ctx.records)
        print(f"gpbench: Kraft noise on {replaced} of {sum(drawn)} simulated bins ({replaced / sum(drawn):.4f})",
              file=sys.stderr)
    for name, value in (("kraft_table_err", table_err), ("noise_err", noise_err), ("kraft_count_err", count_err)):
        checks[name] = {"value": value, "limit": float(lim[name])}
    return checks, problems
