"""Generate and execute the tutorial notebooks of the port into
``mind_the_gaps_tpu_torch/examples/notebooks/``.

Five notebooks, the port's counterparts of the JAX repo's
``docs/notebooks/`` (tutorial_ppp, tutorial_model_selection,
celerite_variance, poisson_level, lomb_scargle_biases): the same data,
sizes, storyline and assertions on ``mind_the_gaps_tpu_torch``, every
entry point given ``device="cpu"``, so that they run where matplotlib and
Jupyter are installed and no card is.  Each is executed with nbclient and
written with its outputs (figures embedded).

Run: python -m mind_the_gaps_tpu_torch.examples.make_notebooks [name ...]
(needs nbformat, nbclient, ipykernel and matplotlib; nothing of them is
imported until then).
"""
from __future__ import annotations

import sys
from pathlib import Path

OUT = Path(__file__).resolve().with_name("notebooks")

SETUP = '''\
# Tutorial-scale setup: every entry point runs on the CPU (device="cpu";
# device="cuda" runs it on a card); sizes here are kept tiny.
try:
    import mind_the_gaps_tpu_torch  # noqa: F401
except ImportError:
    import os, sys
    sys.path.insert(0, os.path.abspath(os.path.join(os.getcwd(), "..", "..", "..")))
import warnings
import numpy as np
import torch
import matplotlib.pyplot as plt
# a warning's message and category only, without the source file's path
warnings.formatwarning = lambda message, category, *args, **kwargs: f"{category.__name__}: {message}\\n"
'''

# the 10,000-simulation LRT on one card (examples/lrt_10k.py; PERF.md section 5)
PRODUCTION = """\
Tutorial sizes are tiny (`nsims=32`, on the CPU); production runs use
`nsims=10000`. At N=5000 on one NVIDIA H100 80GB HBM3 (700 W),
`python -m mind_the_gaps_tpu_torch.examples.lrt_10k` took 85.1 s warm
(PERF.md, section 5): 38.6 s of observed fits (MAP fits and samplers) and
44.9 s of bootstrap (generation, refits and the float64 refine)."""


def _nb(cells):
    import nbformat as nbf

    nb = nbf.v4.new_notebook()
    nb.cells = [
        nbf.v4.new_markdown_cell(src) if kind == "md" else nbf.v4.new_code_cell(src)
        for kind, src in cells
    ]
    nb.metadata["kernelspec"] = {"display_name": "Python 3", "language": "python", "name": "python3"}
    return nb


# --------------------------------------------------------------------- #
def tutorial_ppp():
    return _nb([
        ("md", """\
# Posterior-predictive likelihood-ratio test (Protassov et al. 2002)

The full QPO-significance pipeline on a simulated lightcurve, end to
end (the port of the JAX repo's `tutorial_ppp.ipynb`):

1. fit a **null** (damped random walk) and an **alternative**
   (DRW + Lorentzian QPO) Gaussian-process model to the data,
2. simulate lightcurves from the null posteriors (Timmer & König 1995),
3. refit both models to every simulation — here batched launches of the
   celerite likelihood (the CUDA kernel on a card, its plain PyTorch
   version on the CPU) instead of one process per lightcurve — and build
   the distribution of the likelihood-ratio statistic
   $T = -2(\\log L_{\\rm null} - \\log L_{\\rm alt})$,
4. the p-value is the tail fraction of the simulated $T$ at the
   observed $T$.

""" + PRODUCTION),
        ("code", SETUP),
        ("code", '''\
from mind_the_gaps_tpu_torch import GappyLightcurve
from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, Lorentzian

# simulate a pure-DRW lightcurve over an irregular observing pattern
rng = np.random.default_rng(42)
n = 200
times = np.cumsum(rng.uniform(2.0, 8.0, n))
true = DampedRandomWalk(log_S0=np.log(4.0), log_omega0=np.log(0.05))
tau = np.abs(times[:, None] - times[None, :])
K = np.asarray(true.covariance(tau)) + np.diag(np.full(n, 0.09))
y = 10.0 + np.linalg.cholesky(K) @ rng.normal(size=n)
lc = GappyLightcurve(times, y, np.full(n, 0.3), exposures=1.0)

from mind_the_gaps_tpu_torch.plotting import plot_lightcurve
plot_lightcurve(lc)
plt.show()'''),
        ("code", '''\
from mind_the_gaps_tpu_torch.lrt import protassov_lrt

null_kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
alt_kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)]) + \\
    Lorentzian(log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)])

result = protassov_lrt(
    lc, null_kernel, alt_kernel,
    nsims=32,                 # 10,000 in production
    observed_max_steps=600, observed_walkers=16,
    sim_max_steps=120, sim_walkers=8, chunk=32, seed=0,
    device="cpu",
)
print(f"T_obs = {result.t_obs:.2f}   p-value = {result.p_value:.3f}")'''),
        ("md", """\
The data contain no QPO, so the observed $T$ should be unexceptional
within the simulated distribution (p-value not small):"""),
        ("code", '''\
from mind_the_gaps_tpu_torch.plotting import plot_t_distribution
plot_t_distribution(result)
plt.show()
assert result.p_value > 0.01, "pure-noise data must not yield a significant QPO"'''),
        ("code", '''\
# posterior corner plot of the null model (thinned chains)
from mind_the_gaps_tpu_torch.plotting import plot_posteriors
plot_posteriors(result.null_model)
plt.show()'''),
    ])


def tutorial_model_selection():
    return _nb([
        ("md", """\
# Kernel model selection

Rank candidate covariance kernels with corrected Akaike weights and
check goodness of fit with a KS test on the model residuals (the port
of the JAX repo's `tutorial_model_selection.ipynb`).  The KS test
defaults to exact leave-one-out residuals, which are N(0,1) under the
correct model; pass `residuals="standardized"` for the predictive-std
residuals of the original notebook."""),
        ("code", SETUP),
        ("code", '''\
from mind_the_gaps_tpu_torch import GappyLightcurve
from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, Lorentzian, Matern32Term

rng = np.random.default_rng(3)
n = 250
times = np.cumsum(rng.uniform(2.0, 6.0, n))
true = DampedRandomWalk(log_S0=np.log(4.0), log_omega0=np.log(0.05))
tau = np.abs(times[:, None] - times[None, :])
K = np.asarray(true.covariance(tau)) + np.diag(np.full(n, 0.09))
y = 10.0 + np.linalg.cholesky(K) @ rng.normal(size=n)
lc = GappyLightcurve(times, y, np.full(n, 0.3), exposures=1.0)'''),
        ("code", '''\
from mind_the_gaps_tpu_torch.selection import compare_models

kernels = {
    "DRW": DampedRandomWalk(0.0, -2.0, bounds=[(-5, 8), (-8, 2)]),
    "Matern32": Matern32Term(0.0, 2.0, bounds=[(-5, 8), (-2, 8)]),
    "DRW+QPO": DampedRandomWalk(0.0, -2.0, bounds=[(-5, 8), (-8, 2)])
    + Lorentzian(-1.0, 2.0, -2.0, bounds=[(-8, 5), (0, 6), (-5, 0)]),
}
results = compare_models(lc, kernels, max_steps=400, walkers=12, converge=False, seed=0, device="cpu")

print(f"{'model':<10} {'k':>2} {'maxLL':>9} {'AICc':>9} {'dAICc':>7} {'weight':>7} {'KS p':>6}")
for r in results:
    print(f"{r.name:<10} {r.k:>2} {r.max_loglikelihood:>9.2f} {r.aicc:>9.2f} "
          f"{r.delta_aicc:>7.2f} {r.akaike_weight:>7.3f} {r.ks_pvalue:>6.3f}")
assert results[0].name == "DRW", "the generating kernel must win on AICc"'''),
        ("md", "The winning model's GP prediction and residual diagnostics:"),
        ("code", '''\
from mind_the_gaps_tpu_torch.plotting import plot_gp_prediction, plot_standardized_residuals

best = results[0].model
best.set_parameter_vector(best.max_parameters)
fig, axes = plt.subplots(2, 1, figsize=(8, 6), height_ratios=[2, 1])
plot_gp_prediction(best, ax=axes[0])
plot_standardized_residuals(best, ax=axes[1])
plt.tight_layout(); plt.show()'''),
    ])


def celerite_variance():
    return _nb([
        ("md", """\
# The celerite variance-normalization contract

When a celerite PSD is integrated over positive ordinary frequencies,
the lightcurve variance is

$$\\mathrm{var} = \\sum_\\omega P(\\omega)\\,df\\,2\\pi\\,\\frac{2}{\\sqrt{2\\pi}},$$

and for a DRW/BendingPowerlaw kernel the exact variance is
$k(0) = S_0$.  This notebook (the port of the JAX repo's
`celerite_variance.ipynb`) verifies the convention twice: as a
frequency-domain integral, and as the ensemble variance of simulated
lightcurves — the contract `simulator.tk95_rates` is normalized to."""),
        ("code", SETUP),
        ("code", '''\
from mind_the_gaps_tpu_torch.models.psd_models import BendingPowerlaw
from mind_the_gaps_tpu_torch.simulator import Simulator

NORM = 2.0 / np.sqrt(2.0 * np.pi)
n_points = 2000
times = np.linspace(0.0, 2000.0, n_points)
exposures = 0.5 * np.ones(n_points)
duration = times[-1] + 1.5 * exposures[-1] - (times[0] - exposures[0])
sim_dt = np.min(exposures) / 2

S0, w0 = 1.0, 2 * np.pi / 100.0
psd_model = BendingPowerlaw(S0=S0, omega0=w0)

df = 1.0 / duration
int_freq = np.arange(1.0 / duration, 1.0 / sim_dt, df)
var_integral = float(np.sum(np.asarray(psd_model(int_freq * 2 * np.pi))) * df * 2 * np.pi * NORM)
print(f"PSD integral variance: {var_integral:.4f}   (k(0) = S0 = {S0})")
assert abs(var_integral / S0 - 1.0) < 0.05'''),
        ("code", '''\
simulator = Simulator(psd_model, times, exposures, mean=0.0, pdf="Gaussian",
                      extension_factor=1, random_state=45, device="cpu")
n_sims = 192
psd_batch = simulator._psd_values()[None].expand(n_sims, -1).contiguous()
rates = simulator.simulate_batch(psd_batch, generator=torch.Generator("cpu").manual_seed(45)).numpy()
variances = np.var(rates, axis=1)
print(f"ensemble variance of {n_sims} simulated lightcurves: {variances.mean():.4f}")
assert abs(variances.mean() / var_integral - 1.0) < 0.15

fig, axes = plt.subplots(1, 2, figsize=(10, 3.5))
axes[0].loglog(int_freq, np.asarray(psd_model(int_freq * 2 * np.pi)))
axes[0].set_xlabel("frequency"); axes[0].set_ylabel("PSD"); axes[0].set_title("BendingPowerlaw PSD")
axes[1].hist(variances, bins=24)
axes[1].axvline(S0, color="k", ls="--", label="k(0) = S0")
axes[1].set_xlabel("simulated lightcurve variance"); axes[1].legend()
plt.tight_layout(); plt.show()'''),
    ])


def poisson_level():
    return _nb([
        ("md", """\
# Measurement noise in the periodogram and the celerite PSD

(The port of the JAX repo's `poisson_level.ipynb`.)  Three checks:

1. the TK95 periodogram of a simulated series is $\\chi^2(2)$-distributed
   around the celerite PSD (times $2\\pi \\cdot 2/\\sqrt{2\\pi}$),
2. white measurement noise adds a flat floor
   $2\\,\\Delta t\\,\\sigma^2 / (2\\pi \\cdot 2/\\sqrt{2\\pi})$ in celerite units,
3. a `JitterTerm` in the GP model absorbs that floor and recovers
   $\\sigma$."""),
        ("code", SETUP),
        ("code", '''\
from scipy.stats import chi2, ks_1samp
from mind_the_gaps_tpu_torch.models.psd_models import BendingPowerlaw
from mind_the_gaps_tpu_torch.simulator import Simulator

NORM = 2.0 / np.sqrt(2.0 * np.pi)

def abs_periodogram(rates, dt):
    n = len(rates)
    fft = np.fft.rfft(rates - np.mean(rates))
    freqs = np.fft.rfftfreq(n, dt)
    power = 2.0 * dt / n * np.abs(fft) ** 2
    sl = slice(1, -1) if n % 2 == 0 else slice(1, None)
    return freqs[sl], power[sl]

rng = np.random.default_rng(42)
n_points, dt = 1500, 1.0
times = np.arange(n_points) * dt
S0, w0 = 1.0, 2 * np.pi / 50.0
psd_model = BendingPowerlaw(S0=S0, omega0=w0)
simulator = Simulator(psd_model, times, np.ones(n_points) * dt, mean=10.0,
                      pdf="Gaussian", aliasing_factor=2, extension_factor=2, random_state=7,
                      device="cpu")

reg = simulator.simulate_regularly_sampled()
freqs_r, power_r = abs_periodogram(np.asarray(reg.countrate), reg.dt)
model_r = np.asarray(psd_model(freqs_r * 2 * np.pi)) * 2 * np.pi * NORM
ks = ks_1samp(2.0 * power_r / model_r, chi2(2).cdf)
print(f"chi^2(2) KS p-value: {ks.pvalue:.3f}")
assert ks.pvalue > 1e-3'''),
        ("code", '''\
sigma = 0.5
rates = simulator.generate_lightcurve()
noisy = rates + rng.normal(0, sigma, n_points)
freqs, power_noisy = abs_periodogram(noisy, dt)
floor = 2 * dt * sigma**2 / (2 * np.pi * NORM)
model = np.asarray(psd_model(freqs * 2 * np.pi))

plt.figure(figsize=(7, 4))
plt.loglog(freqs, power_noisy / (2 * np.pi * NORM), lw=0.5, label="periodogram (noisy)")
plt.loglog(freqs, model + floor, "k--", label="PSD + noise floor")
plt.axhline(floor, color="C3", ls=":", label=r"$2\\Delta t\\,\\sigma^2/(2\\pi\\cdot 2/\\sqrt{2\\pi})$")
plt.xlabel("frequency"); plt.ylabel("power (celerite units)"); plt.legend(); plt.show()

hi = freqs > 0.25 / dt
measured = np.mean(power_noisy[hi] / (2 * np.pi * NORM))
predicted = floor + np.mean(model[hi])
print(f"high-f level {measured:.4f} vs predicted {predicted:.4f}")
assert abs(measured / predicted - 1.0) < 0.25'''),
        ("code", '''\
from mind_the_gaps_tpu_torch import GappyLightcurve
from mind_the_gaps_tpu_torch.gpmodelling import GPModelling
from mind_the_gaps_tpu_torch.kernels import DampedRandomWalk, JitterTerm

lc = GappyLightcurve(times, noisy, np.full(n_points, 1e-12))
kernel = DampedRandomWalk(log_S0=np.log(np.var(noisy)), log_omega0=np.log(w0),
                          bounds=[(-30, 15), (-25, -1)]) + JitterTerm(
    log_sigma=np.log(0.3), bounds=[(-10, 20)])
gp = GPModelling(lc, kernel, device="cpu")
sol = gp.fit()
sigma_fit = float(np.exp(sol.x[-1]))
print(f"fitted jitter sigma: {sigma_fit:.3f} (input {sigma})")
assert abs(sigma_fit / sigma - 1.0) < 0.2'''),
    ])


def lomb_scargle_biases():
    return _nb([
        ("md", """\
# Lomb-Scargle slope biases under missing data

(The port of the JAX repo's `lomb_scargle_biases.ipynb` — the paper's
Fig. 1.)  The FFT periodogram of a power-law process recovers the
spectral index without bias; the Lomb-Scargle periodogram of the same
process **flattens** (biases toward zero slope) as samples are
removed."""),
        ("code", SETUP),
        ("code", '''\
from mind_the_gaps_tpu_torch.fitting import fit_lomb_scargle, fit_psd_powerlaw
from mind_the_gaps_tpu_torch.models.psd_models import PowerLaw
from mind_the_gaps_tpu_torch.periodogram import lomb_scargle
from mind_the_gaps_tpu_torch.simulator import Simulator

rng = np.random.default_rng(27)
beta, mean, dt, n_points = 1.8, 3.0, 1.0, 1000
timestamps = np.arange(0, n_points, dt, dtype=float)
psd_model = PowerLaw(amplitude=1.0, x_0=1.0, alpha=beta)
simulator = Simulator(psd_model, timestamps, np.ones(n_points) * dt, mean,
                      aliasing_factor=1, extension_factor=10, random_state=27, device="cpu")
n_sims = 32
psd_batch = simulator._psd_values()[None].expand(n_sims, -1).contiguous()
rates = simulator.simulate_batch(psd_batch, generator=torch.Generator("cpu").manual_seed(27)).numpy()

freqs = np.fft.rfftfreq(n_points, dt)
fft_slopes = []
for rate in rates:
    pow_spec = np.abs(np.fft.rfft(rate)[1:-1]) ** 2
    slope, *_ = fit_psd_powerlaw(freqs[1:-1], pow_spec)
    fft_slopes.append(slope)
print(f"FFT periodogram mean slope: {np.mean(fft_slopes):.2f} (input -{beta})")
assert abs(np.mean(fft_slopes) + beta) < 0.2'''),
        ("code", '''\
fmin, fmax = 1.0 / (timestamps[-1] - timestamps[0]), 1.0 / (2 * dt)
ls_freqs = np.linspace(fmin, fmax, n_points // 2)[:-1]
removed_grid = [0, 250, 500]
ls_means = []
for n_remove in removed_grid:
    slopes = []
    for rate in rates[:16]:
        keep = np.sort(rng.choice(n_points, n_points - n_remove, replace=False))
        power = lomb_scargle(timestamps[keep], rate[keep], ls_freqs,
                             normalization="psd", device="cpu").numpy()
        slope, *_ = fit_lomb_scargle(ls_freqs, power)
        slopes.append(slope)
    ls_means.append(float(np.mean(slopes)))
    print(f"removed {n_remove:4d}/{n_points}: LS mean slope {ls_means[-1]:.2f}")

plt.figure(figsize=(6, 4))
plt.plot(removed_grid, ls_means, "o-", label="Lomb-Scargle")
plt.axhline(-beta, color="k", ls="--", label="input slope")
plt.axhline(np.mean(fft_slopes), color="C2", ls=":", label="FFT periodogram")
plt.xlabel("samples removed"); plt.ylabel("fitted slope"); plt.legend(); plt.show()
assert ls_means[2] > ls_means[0], "LS slope must flatten with missing data"'''),
    ])


BUILDERS = {
    "tutorial_ppp": tutorial_ppp,
    "tutorial_model_selection": tutorial_model_selection,
    "celerite_variance": celerite_variance,
    "poisson_level": poisson_level,
    "lomb_scargle_biases": lomb_scargle_biases,
}


def execute(name: str, timeout: int = 900):
    """Build notebook ``name`` and execute it in a fresh kernel whose working
    directory is ``OUT``; returns the executed notebook."""
    from nbclient import NotebookClient

    nb = BUILDERS[name]()
    OUT.mkdir(parents=True, exist_ok=True)
    NotebookClient(nb, timeout=timeout, kernel_name="python3", resources={"metadata": {"path": str(OUT)}}).execute()
    return nb


def main(names=None):
    import nbformat as nbf

    for name in names or list(BUILDERS):
        print(f"executing {name} ...", flush=True)
        nb = execute(name)
        path = OUT / f"{name}.ipynb"
        with open(path, "w") as fh:
            nbf.write(nb, fh)
        print(f"wrote {path}")


if __name__ == "__main__":
    main(sys.argv[1:] or None)
