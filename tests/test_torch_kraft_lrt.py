"""Kraft low-count noise on the port's LRT path, held to the benchmark's plain
Kraft reference (``gpbench/reference_kraft.py``: Newton solves of the
posterior's closed-form CDF, independent of the port's bisections).

- ``kraft_tables`` (median, HPD lo, hi) equal the reference's within 1e-9
  relative, at N = 0..15 over backgrounds that vary by bin;
- ``protassov_lrt`` on a lightcurve with a background puts Kraft noise on
  the path: ``timings["kraft_bins_replaced"]`` > 0 of ``["kraft_bins"]``,
  ``["simulator_s"]`` > 0, and under ``torch.profiler`` the spans
  ``lrt.simulator`` > ``sim.kraft_tables`` (its counts: the tables' cells
  and the Kraft kernel's launches, none on the CPU);
- recording changes no result: ``t_dist`` bit for bit with the profiler on
  and off.

JAX is not imported.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from mind_the_gaps_tpu_torch import GappyLightcurve, tracing  # noqa: E402
from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, Lorentzian  # noqa: E402
from mind_the_gaps_tpu_torch.lrt import protassov_lrt  # noqa: E402
from mind_the_gaps_tpu_torch.simulator.noise import kraft_tables  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BACKGROUNDS = (0.05, 0.3, 1.0, 5.0)
N_POINTS, NSIMS, CHUNK = 64, 6, 4


def _reference():
    spec = importlib.util.spec_from_file_location("reference_kraft", ROOT / "gpbench" / "reference_kraft.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tables():
    """The port's tables and the reference's over bins whose backgrounds
    cycle through ``BACKGROUNDS``, each a little apart."""
    bkg = np.array(BACKGROUNDS * 3) * np.repeat([1.0, 1.013, 0.991], len(BACKGROUNDS))
    return kraft_tables(bkg, 15, "cpu"), _reference().kraft_tables(bkg, 15)


@pytest.mark.parametrize("which", ["median", "lo", "hi"])
def test_kraft_tables_equal_the_plain_reference(tables, which):
    port, ref = tables
    i = ("median", "lo", "hi").index(which)
    assert port[i].shape == ref[i].shape == (16, 3 * len(BACKGROUNDS))
    assert float(((port[i] - ref[i]).abs() / ref[i].abs().clamp(min=1.0)).max()) < 1e-9


def _faint_lightcurve():
    rng = np.random.default_rng(19)
    t = np.cumsum(rng.uniform(2.0, 8.0, N_POINTS))
    bkg_rate = rng.uniform(0.1, 0.3, N_POINTS)
    counts = rng.poisson(10.0 * 1.5 + 1.5 * bkg_rate + rng.normal(0.0, 2.0, N_POINTS).clip(-10, 10))
    y = (counts - 1.5 * bkg_rate) / 1.5
    return GappyLightcurve(t, y, np.sqrt(counts) / 1.5, exposures=1.5, bkg_rate=bkg_rate,
                           bkg_rate_err=np.full(N_POINTS, 0.02))


@pytest.fixture(scope="module")
def runs():
    """The LRT on a faint source, unrecorded and then recorded."""
    lc = _faint_lightcurve()
    null = DampedRandomWalk(1.0, -3.0, bounds=[(-5, 10), (-8, 2)])
    alt = null + Lorentzian(-1.0, 2.0, -2.0, bounds=[(-8, 5), (0, 6), (-5, 0)])

    def lrt():
        return protassov_lrt(lc, null, alt, nsims=NSIMS, observed_max_steps=40, observed_walkers=8,
                             sim_max_steps=20, sim_walkers=4, chunk=CHUNK, seed=5, device="cpu")

    tracing.clear()
    off = lrt()
    with profile(activities=[ProfilerActivity.CPU]):
        on = lrt()
    return dict(off=off, on=on, spans=tracing.spans())


def test_kraft_noise_is_on_the_lrt_path_and_counted(runs):
    timings = runs["off"].timings
    assert timings["kraft_bins"] == NSIMS * N_POINTS  # each simulated row once; the observed row not
    assert 0 < timings["kraft_bins_replaced"] < timings["kraft_bins"]
    assert timings["simulator_s"] > 0
    assert runs["off"].null_model._simulator.noise.name == "Kraft"


def test_the_simulator_and_its_tables_are_recorded_under_the_profiler(runs):
    spans = runs["spans"]
    by_id = {s.id: s for s in spans}
    simulator = [s for s in spans if s.name == "lrt.simulator"]
    tables = [s for s in spans if s.name == "sim.kraft_tables"]
    assert len(simulator) == 1 and by_id[simulator[0].parent].name == "lrt.protassov_lrt"
    assert len(tables) == 1 and tables[0].parent == simulator[0].id
    assert tables[0].counts == {"cells": 16 * N_POINTS, "launches": 0}
    assert simulator[0].start_ns <= tables[0].start_ns <= tables[0].end_ns <= simulator[0].end_ns


def test_recording_changes_no_result_with_kraft_noise(runs):
    off, on = runs["off"], runs["on"]
    for name in ("t_dist", "null_sim_loglikes", "alt_sim_loglikes"):
        assert np.array_equal(getattr(off, name), getattr(on, name))
    assert off.t_obs == on.t_obs and off.p_value == on.p_value
    assert off.timings["kraft_bins_replaced"] == on.timings["kraft_bins_replaced"]
