"""``examples.lrt_10k`` (the 10,000-simulation LRT) against the JAX repo's
``benchmarks/lrt_10k.py``, on the CPU.

The JAX script is loaded as a module from its file, its
``mind_the_gaps_tpu.lrt.protassov_lrt`` replaced by a stub that records
its arguments (the JAX LRT does not run); the port's ``protassov_lrt`` is
stubbed the same way to compare the settings.

- The scenario: times, y and dy exactly equal, exposures equal, the
  kernels' parameter vectors and bounds equal;
- the command line: the same options and defaults, handed to
  ``protassov_lrt`` as the same settings (at the defaults and at other
  values);
- a real run at a tiny size on the CPU: the last line is a JSON object
  with the JAX script's keys, T finite and p in [1 / (nsims + 1), 1].
"""
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import mind_the_gaps_tpu.lrt as j_lrt  # noqa: E402
from mind_the_gaps_tpu_torch.examples import lrt_10k  # noqa: E402

SCRIPT = Path(__file__).resolve().parent.parent / "benchmarks" / "lrt_10k.py"
SETTINGS = ("nsims", "pdf", "observed_max_steps", "observed_walkers", "sim_max_steps", "sim_walkers", "chunk",
            "seed", "progress")


def _load_jax_script():
    spec = importlib.util.spec_from_file_location("_jax_benchmark_lrt_10k", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _stub(calls):
    def protassov_lrt(lc, null_kernel, alt_kernel, **kwargs):
        calls.append(SimpleNamespace(lc=lc, null=null_kernel, alt=alt_kernel, kwargs=kwargs))
        return SimpleNamespace(p_value=1.0, t_obs=0.0, t_obs_posterior=0.0, p_value_posterior=1.0,
                               t_dist=np.zeros(1), timings={}, null_model=SimpleNamespace(converged=True),
                               alt_model=SimpleNamespace(converged=True))
    return protassov_lrt


def _jax_call(monkeypatch, argv):
    calls = []
    monkeypatch.setattr(j_lrt, "protassov_lrt", _stub(calls))
    monkeypatch.setattr(sys, "argv", [str(SCRIPT), *argv])
    _load_jax_script().main()
    return calls[0]


def _port_call(monkeypatch, argv):
    calls = []
    monkeypatch.setattr(lrt_10k, "protassov_lrt", _stub(calls))
    lrt_10k.main(["--device", "cpu", *argv])
    return calls[0]


@pytest.mark.parametrize("n_points", [300, 5000])
def test_scenario_equals_the_jax_scripts(monkeypatch, capsys, n_points):
    j = _jax_call(monkeypatch, ["--n-points", str(n_points)])
    lc, null, alt = lrt_10k.scenario(n_points)
    for attr in ("times", "y", "dy", "exposures"):
        assert np.array_equal(getattr(lc, attr), np.asarray(getattr(j.lc, attr))), attr
    for mine, theirs in ((null, j.null), (alt, j.alt)):
        assert np.array_equal(mine.get_parameter_vector(), np.asarray(theirs.get_parameter_vector()))
        assert np.array_equal(np.asarray(mine.get_parameter_bounds(), dtype=float),
                              np.asarray(theirs.get_parameter_bounds(), dtype=float))
        assert type(mine).__name__ == type(theirs).__name__


@pytest.mark.parametrize("argv", [
    [],
    ["--nsims", "300", "--n-points", "120", "--observed-max-steps", "77", "--observed-walkers", "10",
     "--sim-steps", "33", "--sim-walkers", "6", "--chunk", "64", "--pdf", "Lognormal", "--seed", "5", "--progress"],
])
def test_run_passes_the_jax_scripts_settings(monkeypatch, capsys, argv):
    j = _jax_call(monkeypatch, argv)
    capsys.readouterr()
    mine = _port_call(monkeypatch, argv)
    assert {k: mine.kwargs[k] for k in SETTINGS} == {k: j.kwargs[k] for k in SETTINGS}
    assert mine.kwargs["device"] == "cpu" and mine.kwargs["mesh"] is None
    assert np.array_equal(mine.lc.y, np.asarray(j.lc.y))


def test_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(j_lrt, "protassov_lrt", _stub([]))
    monkeypatch.setattr(sys, "argv", [str(SCRIPT), "--n-points", "100"])
    _load_jax_script().main()
    jax_keys = set(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))

    nsims = 8
    out = lrt_10k.main(["--device", "cpu", "--nsims", str(nsims), "--n-points", "100", "--observed-max-steps", "100",
                        "--observed-walkers", "8", "--sim-steps", "20", "--sim-walkers", "6", "--chunk", "4"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == jax_keys
    assert line["metric"] == f"lrt_{nsims}sim_seconds" and line["nsims"] == nsims and line["n_points"] == 100
    assert line["backend"] == "cpu" and line["unit"] == "s" and line["value"] > 0
    assert np.isfinite(line["t_obs"]) and np.all(np.isfinite(out["t_dist"])) and out["t_dist"].shape == (nsims,)
    assert 1.0 / (nsims + 1) <= line["p_value"] <= 1.0
    assert out["chunks"] == 3 and set(out["timings"]) >= {"observed_sampling_s", "refits_s"}
