"""The comparison fails a run whose timed path is broken underneath: each
fault the cells can have, planted at a small size on the host, turns
``correct`` false (the harness's look for a card is skipped; the rest of a
run is driven as on the chip)."""
import pytest

from gpbench.faults import (frozen_refits, frozen_sampler, scaled_generation, shifted_chain, shifted_refine,
                            skipped_e13)
from gpbench_tiny import run_tiny


@pytest.fixture
def planted(monkeypatch):
    """Plant a fault for one test: the patched names are restored after it."""
    from mind_the_gaps_tpu_torch import gpmodelling, lrt
    from mind_the_gaps_tpu_torch.sampler import ensemble
    from mind_the_gaps_tpu_torch.simulator import core

    for obj, name in ((lrt._ShardRun, "step"), (lrt, "_f64_logprob_chunk"), (core, "e13_adjust_batch"),
                      (ensemble, "stretch_half"), (gpmodelling.ChainResult, "get_log_prob"),
                      (gpmodelling.GPModelling, "make_device_generator")):
        monkeypatch.setattr(obj, name, getattr(obj, name))
    return lambda fault: fault()


@pytest.mark.parametrize("cell", ["gauss.bootstrap", "lognormal.bootstrap"])
@pytest.mark.parametrize("fault", [frozen_refits, shifted_refine, scaled_generation],
                         ids=["state_unchanged", "answer_altered", "lightcurve_altered"])
def test_a_bootstrap_fault_is_not_correct(planted, cell, fault):
    planted(fault)
    res = run_tiny(cell)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("fault", [frozen_sampler, shifted_chain], ids=["state_unchanged", "answer_altered"])
def test_an_observed_fault_is_not_correct(planted, fault):
    planted(fault)
    res = run_tiny("gauss.observed")
    assert res["correct"] is False


@pytest.mark.parametrize("skip", [False, True], ids=["sound", "e13_left_out"])
def test_the_e13_adjustment_left_out_fails_the_pdf_check(planted, skip):
    """At the cell's own simulator size (N=5000, cut 65,536) on the host, 64
    rows: the lognormal cell's pdf_skew_gap passes its limit, and fails it
    with the E13 adjustment left out (the rows Gaussian)."""
    import json

    import numpy as np
    import torch

    from gpbench.reference import flux_skewness
    from gpbench.scenario import lightcurve_arrays
    from gpbench_tiny import ROOT
    from mind_the_gaps_tpu_torch import kernels
    from mind_the_gaps_tpu_torch.lightcurves import GappyLightcurve

    if skip:
        planted(skipped_e13)
    cfg = json.loads((ROOT / "gpbench/configs/lrt_lognormal_n5000.json").read_text())
    limit = json.loads((ROOT / "gpbench/limits/lognormal.bootstrap.json").read_text())["pdf_skew_gap"]
    t, y, dy = lightcurve_arrays(cfg["data"], cfg["n_points"], 4)
    lc = GappyLightcurve(t, y, dy, exposures=cfg["data"]["exposure"])
    drw = kernels.DampedRandomWalk(*cfg["null"]["terms"][0]["values"], bounds=cfg["null"]["terms"][0]["bounds"])
    sim = lc.get_simulator(drw.get_psd, cfg["pdf"], extension_factor=cfg["extension_factor"], device="cpu")
    omega = torch.as_tensor(sim.omega[1:], dtype=torch.float64)
    psd = drw.get_psd(omega, torch.tensor([cfg["null"]["terms"][0]["values"]] * 64, dtype=torch.float64))
    gen = torch.Generator().manual_seed(4)
    rates = sim.simulate_batch(torch.cat([psd.new_zeros((64, 1)), psd], 1), generator=gen, warn_nonconverged=False)
    flux, _ = sim.add_noise_batch(rates, gen)
    measured, target = flux_skewness(flux.numpy(), cfg["data"]["exposure"], cfg["pdf"])
    assert (abs(measured - target) > limit) is skip and np.isfinite(measured)
