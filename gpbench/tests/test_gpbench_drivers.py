"""Each cell run on the host at a small size with the port's plain
versions: the result has the contract's keys, the cell's metrics and
``correct`` true, and the data depend on the seed alone."""
import json

import numpy as np
import pytest

from gpbench.scenario import derived_seed, lightcurve_arrays
from gpbench_tiny import ROOT, run_tiny

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _names(kind, cell):
    return {m["name"] for m in BENCH[kind] if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("cell", ["gauss.bootstrap", "gauss.observed", "lognormal.bootstrap"])
def test_a_run_reports_its_end_to_end_metrics_and_is_correct(cell):
    res = run_tiny(cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == _names("end_to_end", cell)
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["device"]["platform"] == "cpu"
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())


@pytest.mark.parametrize("cell", ["gauss.bootstrap", "gauss.observed"])
def test_a_traced_run_reports_per_layer_metrics_only(cell):
    res = run_tiny(cell, trace=True)
    # on the host there is no device trace: the device's metrics have nothing to read
    timed = {"gauss.bootstrap": {"generation_ms_per_sim", "refits_ms_per_sim"},
             "gauss.observed": {"map_fit_ms_per_fit"}}[cell]
    assert set(res["metrics"]) == timed and timed <= _names("per_layer", cell)
    assert res["breakdown"] == {"device_ops": [], "idle_gaps": []}
    assert res["correct"] is True


def test_the_observed_window_ends_on_whole_pairs_of_calls():
    res = run_tiny("gauss.observed", seconds=0.01)
    assert res["attempted"] == 2 and res["correct"] is True
    assert res["host"]["start"]["probe_ms"] > 0 and res["host"]["end"]["probe_ms"] > 0


def test_the_data_depend_on_the_seed_alone():
    data = json.loads((ROOT / "gpbench/configs/lrt_gauss_n5000.json").read_text())["data"]
    seed = 2**31 + 12345
    a, b = lightcurve_arrays(data, 500, seed), lightcurve_arrays(data, 500, seed)
    c = lightcurve_arrays(data, 500, seed + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1]) and a[0].shape == c[0].shape == (500,)
    assert derived_seed(seed, 3, 0) != derived_seed(seed, 3, 1) and 0 <= derived_seed(seed, 1) < 2**31


@pytest.mark.parametrize("config, sort", [("lrt_gauss_n5000_4rank", False), ("lrt_lognormal_n5000", True)])
def test_the_bootstrap_driver_names_the_libraries_its_runs_launch(config, sort):
    from gpbench.run import PACKAGE_DIR, load_module

    cfg = json.loads((PACKAGE_DIR / "configs" / f"{config}.json").read_text())
    names = load_module([PACKAGE_DIR], "drivers", "bootstrap").libraries(cfg)
    assert all((ROOT / "mind_the_gaps_tpu_torch" / "csrc" / f"{n}.cu").is_file() for n in names)
    assert {"celerite_loglike_f32", "celerite_loglike_f64", "celerite_grad_f64"} <= set(names)
    assert ("bitonic_sort" in names) is sort and "fma_chain" not in names
