"""The faint-source cell ``faint.bootstrap`` on the host at a small size: a
sound run is correct, its control and each Kraft fault are not, and the
plain Kraft reference satisfies the equations that define it."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpbench import reference_kraft
from gpbench.faults_kraft import FAULTS, equal_tailed, kraft_left_out, threshold_10, trunc_counts
from gpbench_tiny import ROOT, TINY

CELL = "faint.bootstrap"
# set from runs at these sizes: sound runs read below them, the control and the faults above
TINY_LIMITS = {"null_excess": 1e-7, "alt_err": 1e-8, "null_gap": 1.0, "alt_gap": 20.0, "gen_dist": 20.0,
               "kraft_table_err": 1e-9, "noise_err": 1e-9, "kraft_count_err": 1e-9}
KRAFT = ("noise_err", "kraft_table_err", "kraft_count_err")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _run(seed=3_000_000_019, trace=False, control=False):
    from gpbench.run import run_cell

    overrides = {k: dict(v) for k, v in TINY.items()}
    overrides["limits"] = dict(TINY_LIMITS)
    return run_cell(CELL, seed, 0.5, trace, root=ROOT, device="cpu", overrides=overrides, control=control)


@pytest.fixture
def planted(monkeypatch):
    """Plant a Kraft fault for one test: the patched names are restored after it."""
    from mind_the_gaps_tpu_torch.simulator import noise

    for obj, name in ((noise.KraftNoise, "kraft_step"), (noise.KraftNoise, "__init__"), (noise, "kraft_tables")):
        monkeypatch.setattr(obj, name, getattr(obj, name))
    return lambda fault: fault()


def _names(kind):
    return {m["name"] for m in BENCH[kind] if "workloads" not in m or CELL in m["workloads"]}


def test_a_sound_run_is_correct_and_reports_its_end_to_end_metrics():
    res = _run()
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == _names("end_to_end") == {"sims_per_s", "setup_s"}
    assert set(res["checks"]) == set(TINY_LIMITS)
    assert all(res["checks"][k]["value"] < 1e-12 for k in KRAFT)


def test_a_traced_run_reports_the_simulator_and_the_refits_timings():
    res = _run(trace=True)
    # on the host there is no device trace: the device's metrics have nothing to read
    timed = {"simulator_ms_per_call", "generation_ms_per_sim", "refits_ms_per_sim"}
    assert set(res["metrics"]) == timed and timed <= _names("per_layer")
    assert res["metrics"]["simulator_ms_per_call"]["value"] > 0
    assert res["correct"] is True


def test_the_control_fails_the_table_comparison():
    res = _run(control=True)
    assert res["correct"] is False
    assert res["checks"]["kraft_table_err"]["value"] > TINY_LIMITS["kraft_table_err"]


@pytest.mark.parametrize("fault, fails", [(kraft_left_out, {"noise_err", "kraft_count_err"}),
                                          (threshold_10, {"noise_err", "kraft_count_err"}),
                                          (equal_tailed, set(KRAFT)),
                                          # each bin's (y, dy) belong to one count: only the known counts see it
                                          (trunc_counts, {"kraft_count_err"})],
                         ids=["kraft_left_out", "threshold_10", "equal_tailed", "trunc_counts"])
def test_a_kraft_fault_is_not_correct(planted, fault, fails):
    planted(fault)
    res = _run()
    assert res["correct"] is False
    assert {k for k in KRAFT if res["checks"][k]["value"] > res["checks"][k]["limit"]} == fails


def test_the_faults_command_plants_its_fault_before_the_readings(planted, capsys):
    from gpbench import faults_kraft
    from mind_the_gaps_tpu_torch.simulator import noise

    step = noise.KraftNoise.kraft_step
    assert faults_kraft.main(["kraft_left_out", "--workload", CELL, "--seeds", "", "--device", "cpu"]) == 0
    assert noise.KraftNoise.kraft_step is not step
    assert faults_kraft.main(["no_such_fault"]) == 2
    usage = capsys.readouterr().err
    assert all(name in usage for name in FAULTS)


@pytest.mark.parametrize("background", [0.0, 0.05, 0.3, 1.0, 5.0])
def test_the_reference_satisfies_its_defining_equations(background):
    N = torch.arange(16)
    B = torch.full((16,), background, dtype=torch.float64)
    med = reference_kraft.median(N, B)
    lo, hi = reference_kraft.hpd_interval(N, B)
    assert (reference_kraft.cdf(med, N, B) - 0.5).abs().max() < 1e-11
    assert (reference_kraft.cdf(hi, N, B) - reference_kraft.cdf(lo, N, B) - reference_kraft.CL).abs().max() < 1e-11
    inner = lo > 0
    gap = reference_kraft.log_pdf(lo, N, B) - reference_kraft.log_pdf(hi, N, B)
    assert gap[inner].abs().max() < 1e-11 if inner.any() else True
    # where a = 0 the density at 0 is at least that at b: widening to the left would not shorten the interval
    assert (reference_kraft.log_pdf(torch.zeros_like(B), N, B)[~inner] >= reference_kraft.log_pdf(hi, N, B)[~inner]
            - 1e-11).all()
    mode = torch.clamp(N - B, min=0)
    assert ((lo <= mode) & (mode <= hi) & (lo <= med) & (med <= hi)).all()


def test_the_reference_in_float32_is_one_precision_down():
    bkg = np.array([0.15, 0.3, 0.45, 1.0])
    f64 = reference_kraft.kraft_tables(bkg, 15)
    f32 = reference_kraft.kraft_tables(bkg, 15, dtype=torch.float32)
    err = max(float(((a - b.double()).abs() / a.abs().clamp(min=1)).max()) for a, b in zip(f64, f32))
    assert 1e-9 < err < 1e-4


def test_the_faint_source_takes_the_noise_it_states():
    """The observed lightcurve: whole counts of at least 15 carry the Poisson
    dy, every other bin the reference's Kraft values (the check's own
    comparison, on the observed row, against the reference's tables; the
    set-up solves at the low bins' counts alone), and ~45% of the bins are
    under 15."""
    from types import SimpleNamespace

    from gpbench.run import load_module

    driver = load_module([ROOT / "gpbench"], "drivers", "bootstrap_faint")
    data = json.loads((ROOT / "gpbench/configs/lrt_faint_n5000.json").read_text())["data"]
    n, seed = 2000, 2**31 + 77
    bkg = driver.background_rates(data, n, seed) * data["exposure"]
    ref = [x.numpy() for x in reference_kraft.kraft_tables(bkg, 15)]
    t, y, dy, bkg_rate, err = driver.faint_source(data, n, seed)
    assert np.allclose(bkg_rate * data["exposure"], bkg) and (0.1 <= bkg_rate).all() and (bkg_rate <= 0.3).all()
    counts = y * data["exposure"] + bkg
    whole = np.abs(counts - np.round(counts)) < 1e-6
    assert 0.35 < 1.0 - whole.mean() < 0.55
    s = SimpleNamespace(bkg_counts=bkg, err=err)
    assert driver._noise_err(y[None], dy[None], s, data, ref[0], 0.5 * (ref[2] - ref[1])) < 1e-12
    assert driver._noise_err(y[None], 1.01 * dy[None], s, data, ref[0], 0.5 * (ref[2] - ref[1])) > 1e-4


def test_the_kraft_reference_imports_nothing_of_either_package():
    code = "import sys, gpbench.reference_kraft; print(sorted(m for m in sys.modules if m.startswith('mind_the_gaps')))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]
