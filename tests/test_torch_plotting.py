"""The port's plotting helpers (``plotting.py``), Agg backend.

- The five figures of tests/test_plotting.py, drawn from a port
  ``GPModelling`` on the CPU, each written to a PNG.
- The plotted prediction (the GP mean line and its +-1 sigma band) equals
  the JAX package's figure at the same parameters (rtol 1e-8).
- Tensors given in place of arrays are brought to numpy.
- ``import mind_the_gaps_tpu_torch`` and every module of it, plotting
  included, work where matplotlib cannot be imported (the card's machine
  has none); this case needs no matplotlib and runs everywhere.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import mind_the_gaps_tpu.kernels as jk  # noqa: E402
import mind_the_gaps_tpu_torch.kernels as tk  # noqa: E402
from mind_the_gaps_tpu_torch import GappyLightcurve  # noqa: E402
from mind_the_gaps_tpu_torch.gpmodelling import GPModelling  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _data():
    """tests/test_plotting.py's lightcurve: N = 120, a DRW draw."""
    rng = np.random.default_rng(0)
    n = 120
    t = np.cumsum(rng.uniform(2.0, 6.0, n))
    true = jk.DampedRandomWalk(log_S0=np.log(2.0), log_omega0=np.log(0.08))
    K = np.array(true.covariance(np.abs(t[:, None] - t[None, :]))) + np.diag(np.full(n, 0.04))
    y = 5.0 + np.linalg.cholesky(K) @ rng.normal(size=n)
    return t, y, np.full(n, 0.2)


@pytest.fixture(scope="module")
def plt():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    yield plt
    plt.close("all")


def test_plots(plt, tmp_path):
    from mind_the_gaps_tpu_torch import plotting

    lc = GappyLightcurve(*_data(), exposures=1.0)
    gp = GPModelling(lc, tk.DampedRandomWalk(0.0, -2.0, bounds=[(-4, 6), (-6, 1)]), device="cpu")
    gp.derive_posteriors(max_steps=300, convergence_steps=150, walkers=12, seed=1)

    plotting.plot_lightcurve(lc).figure.savefig(tmp_path / "lc.png")
    plotting.plot_gp_prediction(gp, n_grid=80).figure.savefig(tmp_path / "pred.png")
    plotting.plot_posteriors(gp, bins=15, truths=torch.tensor([np.log(2.0), np.log(0.08)])).savefig(
        tmp_path / "corner.png")
    plotting.plot_standardized_residuals(gp).figure.savefig(tmp_path / "res.png")

    class R:  # an LRTResult's fields, given as tensors
        t_dist = torch.as_tensor(np.random.default_rng(0).normal(2, 1, 200))
        t_obs = torch.tensor(4.2)
        p_value = 0.03

    ax = plotting.plot_t_distribution(R())
    assert ax.get_title() == "p = 0.0300 (200 simulations)"
    ax.figure.savefig(tmp_path / "tdist.png")
    for f in ["lc.png", "pred.png", "corner.png", "res.png", "tdist.png"]:
        assert (tmp_path / f).stat().st_size > 1000


def test_prediction_line_matches_jax(plt):
    from mind_the_gaps_tpu import GappyLightcurve as JLightcurve
    from mind_the_gaps_tpu import plotting as jplotting
    from mind_the_gaps_tpu.gpmodelling import GPModelling as JGP
    from mind_the_gaps_tpu_torch import plotting

    t, y, dy = _data()
    theta = np.array([0.45, -2.3])
    gp = GPModelling(GappyLightcurve(t, y, dy, exposures=1.0), tk.DampedRandomWalk(*theta), device="cpu")
    jgp = JGP(JLightcurve(t, y, dy, exposures=1.0), jk.DampedRandomWalk(*theta))
    t_pred = np.linspace(t[0] - 20.0, t[-1] + 20.0, 150)
    ax = plotting.plot_gp_prediction(gp, t_pred=torch.as_tensor(t_pred))
    jax_ax = jplotting.plot_gp_prediction(jgp, t_pred=t_pred)
    line, jline = ax.get_lines()[-1], jax_ax.get_lines()[-1]
    assert line.get_label() == jline.get_label() == "GP mean"
    np.testing.assert_array_equal(line.get_xdata(), jline.get_xdata())
    np.testing.assert_allclose(line.get_ydata(), jline.get_ydata(), rtol=1e-8)
    band, jband = ax.collections[-1].get_paths()[0].vertices, jax_ax.collections[-1].get_paths()[0].vertices
    np.testing.assert_allclose(band, jband, rtol=1e-8)


_IMPORT_WITHOUT_MATPLOTLIB = """
import importlib, pkgutil, sys
sys.modules["matplotlib"] = None
import mind_the_gaps_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from mind_the_gaps_tpu_torch import plotting
print(sorted(k for k in sys.modules if k.split(".")[0] == "matplotlib" and sys.modules[k] is not None))
"""


def test_port_imports_without_matplotlib():
    out = subprocess.run([sys.executable, "-c", _IMPORT_WITHOUT_MATPLOTLIB], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
