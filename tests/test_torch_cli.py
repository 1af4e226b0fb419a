"""The port's CLI (``mind_the_gaps_tpu_torch/cli.py``) with ``--device cpu``:
the port of ``tests/test_cli.py`` (fit -> chain -> simulate -> lrt on a
small synthetic lightcurve), the same workflow on a faint source's file
(a background and no ``--sigma-noise``: Kraft low-count noise, and the lrt
with a checkpoint), ``_make_kernel``'s initial parameters and bounds equal
to the JAX CLI's for every spec, the defaults that differ from the JAX
CLI (``--device cuda``, ``--sim-walkers 12``), and ``python -m
mind_the_gaps_tpu_torch.cli --help`` in a subprocess.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from mind_the_gaps_tpu import cli as jcli  # noqa: E402
from mind_the_gaps_tpu_torch import cli  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _write_lc(path, n, bkg_rate, seed=0):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    tau = np.abs(t[:, None] - t[None, :])
    K = 4.0 * np.exp(-0.05 * tau) + np.diag(np.full(n, 0.09))
    y = 10.0 + np.linalg.cholesky(K) @ rng.normal(size=n)
    out = np.column_stack([t, y, np.full(n, 0.3), np.full(n, 1.0), np.full(n, bkg_rate), np.full(n, 0.1 * bkg_rate)])
    np.savetxt(path, out, header="t\trate\terror\texposure\tbkg_rate\tbkg_rate_err")
    return str(path)


@pytest.fixture(scope="module")
def lc_file(tmp_path_factory):
    return _write_lc(tmp_path_factory.mktemp("cli") / "lc.dat", 120, 0.0)


def test_cli_fit_simulate_lrt(lc_file, tmp_path, capsys):
    chain = str(tmp_path / "chain.npz")
    gp = cli.main(["fit", lc_file, "--kernel", "drw", "--max-steps", "200", "--walkers", "12", "--output", chain,
                   "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["n_samples"] > 10 and np.isfinite(out["max_loglikelihood"]) and out["device"] == "cpu"
    assert out["max_loglikelihood"] == float(gp.max_loglikelihood)

    sims = str(tmp_path / "sims.npz")
    cli.main(["simulate", lc_file, "--kernel", "drw", "--chain", chain, "--nsims", "6", "--sigma-noise", "0.3",
              "--output", sims, "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    data = np.load(sims)
    assert out["noise"] == "Gaussian" and data["rates"].shape == (6, 120) and np.all(np.isfinite(data["rates"]))

    res = cli.main(["lrt", lc_file, "--null", "drw", "--alt", "drw+qpo", "--nsims", "8", "--max-steps", "200",
                    "--sim-steps", "40", "--sim-walkers", "8", "--sigma-noise", "0.3", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert 0.0 <= out["p_value"] <= 1.0 and np.isfinite(out["t_obs"])
    assert out["p_value"] == res.p_value and res.t_dist.shape == (8,)


def test_cli_on_a_faint_source_file(tmp_path, capsys):
    """A background and no --sigma-noise: simulate and lrt run with Kraft
    noise, and the lrt's checkpoint holds every chunk."""
    path = _write_lc(tmp_path / "faint.dat", 60, 2.0, seed=1)
    chain = str(tmp_path / "chain.npz")
    cli.main(["fit", path, "--kernel", "drw", "--max-steps", "100", "--walkers", "8", "--output", chain,
              "--device", "cpu"])
    capsys.readouterr()
    gp, rates, dy = cli.main(["simulate", path, "--kernel", "drw", "--chain", chain, "--nsims", "5",
                              "--output", str(tmp_path / "sims.npz"), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["noise"] == "Kraft" and gp._simulator.noise.name == "Kraft"
    assert rates.shape == (5, 60) and np.all(np.isfinite(rates)) and np.all(dy > 0)
    ckpt = str(tmp_path / "boot.npz")
    res = cli.main(["lrt", path, "--null", "drw", "--alt", "drw+qpo", "--nsims", "6", "--max-steps", "100",
                    "--walkers", "8", "--sim-steps", "20", "--sim-walkers", "4", "--checkpoint", ckpt,
                    "--output", str(tmp_path / "lrt.npz"), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert res.null_model._simulator.noise.name == "Kraft"
    assert np.all(np.isfinite(res.t_dist)) and 0.0 <= out["p_value"] <= 1.0
    d = np.load(ckpt)
    assert int(d["chunks_done"]) == 1 and d["null_done"].shape == (7,)  # 6 simulations and the observed row
    np.testing.assert_array_equal(np.load(tmp_path / "lrt.npz")["t_dist"], res.t_dist)


SPECS = ["drw", "sho", "matern32", "qpo", "lorentzian", "drw+qpo", "drw+sho", "sho+qpo+drw", " DRW + Matern32 "]


def test_make_kernel_matches_jax_cli(lc_file):
    lc_t, lc_j = cli._load(lc_file, "simple"), jcli._load(lc_file, "simple")
    for spec in SPECS:
        a, b = cli._make_kernel(spec, lc_t), jcli._make_kernel(spec, lc_j)
        np.testing.assert_array_equal(np.asarray(a.get_parameter_vector()), np.asarray(b.get_parameter_vector()))
        assert [tuple(map(float, x)) for x in a.get_parameter_bounds()] == [
            tuple(map(float, x)) for x in b.get_parameter_bounds()], spec
        terms_a = getattr(a, "terms", [a])
        terms_b = getattr(b, "terms", [b])
        assert [type(t).__name__ for t in terms_a] == [type(t).__name__ for t in terms_b], spec
    with pytest.raises(SystemExit):
        cli._make_kernel("weird", lc_t)
    with pytest.raises(SystemExit):
        cli.main(["fit", lc_file, "--kernel", "weird", "--max-steps", "10", "--device", "cpu"])


def test_cli_defaults(lc_file, monkeypatch):
    """The card by default; 12 refit walkers as protassov_lrt (the JAX CLI
    has 16); the JAX CLI's other defaults."""
    seen = {}
    for name in ("cmd_fit", "cmd_simulate", "cmd_lrt"):
        monkeypatch.setattr(cli, name, lambda args: args)
        monkeypatch.setattr(jcli, name, lambda args: seen.__setitem__("args", args))

    def jax_args(argv):  # the JAX CLI's main returns nothing
        jcli.main(argv)
        return seen["args"]

    argv = ["lrt", lc_file, "--null", "drw", "--alt", "drw+qpo"]
    args, jargs = cli.main(argv), jax_args(argv)
    assert args.device == "cuda" and args.sim_walkers == 12 and jargs.sim_walkers == 16
    shared = set(vars(jargs)) - {"func", "sim_walkers"}
    assert {k: vars(args)[k] for k in shared} == {k: vars(jargs)[k] for k in shared}
    for argv in (["fit", lc_file, "--kernel", "drw"], ["simulate", lc_file, "--kernel", "drw", "--output", "x.npz"]):
        args, jargs = cli.main(argv), jax_args(argv)
        assert args.device == "cuda"
        assert {k: v for k, v in vars(args).items() if k not in ("func", "device")} == {
            k: v for k, v in vars(jargs).items() if k != "func"}


def test_cli_help_in_a_subprocess():
    for argv in (["--help"], ["lrt", "--help"]):
        out = subprocess.run([sys.executable, "-m", "mind_the_gaps_tpu_torch.cli", *argv], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert ("--device" if argv[0] == "lrt" else "simulate") in out.stdout
