"""GP inference engine: the user-facing ``GPModelling``.

PyTorch port of ``mind_the_gaps_tpu/gpmodelling.py``:

- ``fit``: the MAP fit, scipy's L-BFGS-B on the float64 objective and its
  exact gradient, evaluated on ``device``: on a CUDA device one launch of
  the forward + adjoint kernel (``ops.celerite_grad``) an evaluation, on
  the CPU the plain version (autograd through ``solver/semiseparable.py``);
- ``derive_posteriors``: the stretch-move ensemble sampler with the
  reference's convergence, discard and thin policy, one ensemble or
  ``chains`` independent ones in lock-step; every step evaluates half the
  ensemble through ``ops.celerite_log_likelihood`` (the CUDA kernel for a
  CUDA ``device``), with a fitted mean model as per-walker residuals; on
  a card each step after the first is one replay of a CUDA graph;
- ``standarized_residuals``, ``loo_residuals``, ``predict``, ``get_rstat``;
- ``make_device_generator``: posterior-predictive lightcurves (TK95, and
  the E13 adjustment for a non-Gaussian flux PDF) for a batch of parameter
  draws, on the device; ``generate_batch_from_posteriors`` /
  ``generate_from_posteriors`` draw them from the posterior samples.

Parameter vector convention: kernel parameters first, then mean-model
parameters when the mean is fitted.
"""
from __future__ import annotations

import math
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy.optimize import minimize

from mind_the_gaps_tpu_torch import tracing
from mind_the_gaps_tpu_torch.lightcurves import GappyLightcurve
from mind_the_gaps_tpu_torch.models.mean_models import (
    ConstantModel,
    GaussianModel,
    LinearModel,
    MeanModel,
)
from mind_the_gaps_tpu_torch.ops import celerite_log_likelihood
from mind_the_gaps_tpu_torch.ops.celerite import _log_likelihood_prepared, _prepare, batch_team
from mind_the_gaps_tpu_torch.ops.celerite_grad import celerite_log_likelihood_and_grad, celerite_loglike_fn
from mind_the_gaps_tpu_torch.parallel import gather, shard_batch
from mind_the_gaps_tpu_torch.sampler import integrated_autocorr_time, integrated_autocorr_time_masked
from mind_the_gaps_tpu_torch.sampler.ensemble import EnsembleChain
from mind_the_gaps_tpu_torch.sampler.graph import StepGraph
from mind_the_gaps_tpu_torch.solver.numpy_ref import numpy_log_likelihood
from mind_the_gaps_tpu_torch.solver.semiseparable import (
    build_matrices,
    factor,
    inverse_diag,
    solve,
)
from mind_the_gaps_tpu_torch.solver.semiseparable import predict as solver_predict
from mind_the_gaps_tpu_torch.solver.semiseparable import predict_at as solver_predict_at

__all__ = ["GPModelling", "ChainResult", "AutocorrError"]

GEN_CHUNK = 512  # lightcurves a generation call of generate_batch_from_posteriors

_NOT_DERIVED = (
    "Posteriors have not been derived. Please run derive_posteriors prior to populate the attributes."
)

try:  # user code catching emcee.autocorr.AutocorrError keeps working
    from emcee.autocorr import AutocorrError as _BaseAutocorrError

    _autocorr_bases = (_BaseAutocorrError, RuntimeError)
except ImportError:  # emcee is not a dependency
    _autocorr_bases = (RuntimeError,)


class AutocorrError(*_autocorr_bases):
    """Chain too short for a reliable autocorrelation-time estimate; carries
    the estimate on ``.tau``, as emcee's does (a subclass of emcee's when
    emcee is importable, and of RuntimeError)."""

    def __init__(self, tau, *args, **kwargs):
        self.tau = tau
        Exception.__init__(self, *args, **kwargs)


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ChainResult:
    """The pieces of emcee's EnsembleSampler the reference relies on:
    get_chain / get_log_prob with discard/thin/flat, get_autocorr_time,
    iteration and acceptance_fraction (each walker's share of accepted
    proposals; None for a chain loaded from a file)."""

    def __init__(self, chain: np.ndarray, log_probs: np.ndarray, acceptance_fraction: Optional[np.ndarray] = None):
        self._chain = chain  # (n_steps, walkers, ndim)
        self._log_probs = log_probs  # (n_steps, walkers)
        self.acceptance_fraction = acceptance_fraction  # (walkers,)

    @property
    def iteration(self) -> int:
        return self._chain.shape[0]

    def get_chain(self, discard: int = 0, thin: int = 1, flat: bool = False):
        c = self._chain[discard :: max(thin, 1)]
        return c.reshape(-1, c.shape[-1]) if flat else c

    def get_log_prob(self, discard: int = 0, thin: int = 1, flat: bool = False):
        lp = self._log_probs[discard :: max(thin, 1)]
        return lp.reshape(-1) if flat else lp

    def get_autocorr_time(self, tol: int = 0):
        """Integrated autocorrelation time per parameter (float64 on the
        CPU).  ``tol`` > 0: as emcee, raise ``AutocorrError`` unless the
        chain is at least ``tol`` autocorrelation times long."""
        tau = integrated_autocorr_time(torch.as_tensor(self._chain, dtype=torch.float64)).numpy()
        if tol > 0:
            n = self._chain.shape[0]
            if np.any(tol * tau > n):
                raise AutocorrError(
                    tau,
                    "The chain is shorter than %d times the integrated "
                    "autocorrelation time for %d parameter(s). Use this estimate "
                    "with caution and run a longer chain!\n"
                    "N/%d = %.0f;\ntau: %s" % (tol, int(np.sum(tol * tau > n)), tol, n / tol, tau)
                )
        return tau


def _graph_engages(device, mesh) -> bool:
    """Whether ``derive_posteriors`` replays its sampler steps as a CUDA
    graph: on a card, without a mesh.  The CPU and a mesh (whose
    log-probabilities gather across cards) step eagerly."""
    return device.type == "cuda" and mesh is None


def _captured(run: EnsembleChain, shard_calls: list):
    """``run.step`` captured as a CUDA graph (``sampler.graph.StepGraph``): a
    function that replays it and moves the celerite op's launch counters
    and ``shard_calls`` as the eager step does."""
    op = celerite_log_likelihood
    before = op.launches, dict(op.team_launches), list(shard_calls)
    graph = StepGraph(run.step, run.state.device)
    # the capture ran the step's Python, not its work: give its counts back, add them at each replay
    launches = op.launches - before[0]
    teams = {k: n - before[1][k] for k, n in op.team_launches.items()}
    calls = [n - m for n, m in zip(shard_calls, before[2])]
    op.launches = before[0]
    op.team_launches.update(before[1])
    shard_calls[:] = before[2]

    def replay():
        graph.replay()
        op.launches += launches
        for k, n in teams.items():
            op.team_launches[k] += n
        for k, n in enumerate(calls):
            shard_calls[k] += n
    return replay


class GPModelling:
    """Gaussian Process modelling of a GappyLightcurve on ``device``.

    ``device``: where the MAP fit, the sampler, their likelihoods and the
    simulations run (a CUDA device by default, or "cpu")."""

    meanmodels = ["linear", "constant", "gaussian"]

    def __init__(self, lightcurve: GappyLightcurve, kernel, mean_model: Optional[str] = None,
                 device="cuda"):
        self._lightcurve = lightcurve
        self.kernel = kernel
        self.device = torch.device(device)
        self.mean_model, self.fit_mean = self._build_mean_model(mean_model)

        dy = lightcurve.dy if lightcurve.dy is not None else np.zeros(lightcurve.n)
        # celerite adds 1e-12 to dy before squaring
        diag = (np.asarray(dy, dtype=np.float64) + 1e-12) ** 2
        self._t_cpu = torch.as_tensor(np.asarray(lightcurve.times, dtype=np.float64))
        self._y_cpu = torch.as_tensor(np.asarray(lightcurve.y, dtype=np.float64))
        self._diag_cpu = torch.as_tensor(diag)
        self._t = self._t_cpu.to(self.device)
        self._data = {}  # (dtype, device) -> the data prepared for the celerite op on that device

        self._nk = kernel.ndim
        self._nm = self.mean_model.ndim if self.fit_mean else 0
        self._ndim = self._nk + self._nm
        self.initial_params = self.get_parameter_vector()

        self._autocorr = []
        self._loglikelihoods = None
        self._mcmc_samples = None
        self._sampler = None
        self._tau = None
        self.converged = False
        self.timings = {}
        self._simulator = None  # that of the last device generator
        self._generator = torch.Generator(self.device).manual_seed(
            int(np.random.SeedSequence().entropy % (2**63))
        )
        if not np.isfinite(self._numpy_loglike(self.initial_params)):
            warnings.warn("GP log-likelihood is not finite at the initial parameters")

    # ------------------------------------------------------------------ #
    def _build_mean_model(self, meanmodel: Optional[str]) -> Tuple[MeanModel, bool]:
        """The reference's mean-model construction and initial guesses."""
        lc = self._lightcurve
        maxy = np.max(lc.y)
        if meanmodel is None:
            return ConstantModel(lc.mean, bounds=[(np.min(lc.y), maxy)]), False
        if meanmodel.lower() not in GPModelling.meanmodels:
            raise ValueError(
                "Input mean model %s not implemented! Only \n %s \n are available"
                % (meanmodel, "\t".join(GPModelling.meanmodels))
            )
        if meanmodel.lower() == "constant":
            return ConstantModel(lc.mean, bounds=[(np.min(lc.y), maxy)]), True
        if meanmodel.lower() == "linear":
            return LinearModel(0, 1.5, bounds=[(None, None), (None, None)]), True
        sigma_guess = lc.duration / 2
        amplitude_guess = (maxy - np.min(lc.y)) * np.sqrt(2 * np.pi) * sigma_guess
        mean_guess = lc.times[len(lc.times) // 2]
        return GaussianModel(
            mean_guess,
            sigma_guess,
            amplitude_guess,
            bounds=[
                (lc.times[0], lc.times[-1]),
                (0, lc.duration),
                (maxy * np.sqrt(2 * np.pi) * lc.duration, 50 * maxy * np.sqrt(2 * np.pi) * lc.duration),
            ],
        ), True

    def _numpy_loglike(self, theta) -> float:
        """One exact float64 evaluation by the numpy recursion."""
        theta = torch.as_tensor(np.asarray(theta, dtype=np.float64))
        th_k = theta[: self._nk]
        coeffs = tuple(c.numpy() for c in self.kernel.coefficients(th_k))
        jitter = float(self.kernel.jitter(th_k))
        y = (self._y_cpu - self._mean_curve(theta, self._t_cpu)).numpy()
        return float(numpy_log_likelihood(coeffs, self._t_cpu.numpy(), y, self._diag_cpu.numpy() + jitter))

    def _mean_curve(self, theta, t):
        """The mean model's curve at times ``t`` for parameters (D,)."""
        return self.mean_model.value(t, self._split_theta(theta)[1])

    # ------------------------------------------------------------------ #
    def get_parameter_bounds(self) -> List[Tuple[float, float]]:
        bounds = list(self.kernel.get_parameter_bounds())
        if self.fit_mean:
            bounds += list(self.mean_model.get_parameter_bounds())
        return bounds

    @property
    def parameter_names(self):
        names = ["kernel:" + n for n in self.kernel.get_parameter_names()]
        if self.fit_mean:
            names += ["mean:" + n for n in self.mean_model.get_parameter_names()]
        return tuple(names)

    def set_parameter_vector(self, theta) -> None:
        theta = np.asarray(theta, dtype=float)
        self.kernel.set_parameter_vector(theta[: self._nk])
        if self.fit_mean:
            self.mean_model.set_parameter_vector(theta[self._nk :])

    def get_parameter_vector(self) -> np.ndarray:
        if self.fit_mean:
            return np.concatenate(
                [self.kernel.get_parameter_vector(), self.mean_model.get_parameter_vector()]
            )
        return self.kernel.get_parameter_vector()

    # ------------------------------------------------------------------ #
    def _split_theta(self, theta):
        """(kernel part, mean-model part) of a parameter tensor (..., D); the
        mean part is the fixed vector when the mean is not fitted."""
        if self.fit_mean:
            return theta[..., : self._nk], theta[..., self._nk :]
        return theta[..., : self._nk], torch.as_tensor(
            self.mean_model.get_parameter_vector(), dtype=theta.dtype, device=theta.device
        )

    def _map_loglike(self, theta):
        """The MAP objective's log-likelihood (0-d) at a float64 parameter
        tensor (D,) on the device, for autograd: the coefficients, jitter and
        mean curve by torch ops, then ``celerite_loglike_fn`` (one kernel
        launch on a CUDA device)."""
        th_k = theta[None, : self._nk]
        y, diag = self._series(torch.float64)
        return celerite_loglike_fn(self.kernel.coefficients(th_k), self._t, y - self._mean_curve(theta, self._t), diag,
                                   extra_diag=self.kernel.jitter(th_k))[0]

    def _loglike_and_grad(self, x):
        """(log-likelihood, its gradient) at one parameter vector ``x``, as
        float64 numpy, by ``_map_loglike`` and autograd back to theta; one
        copy to the host."""
        theta = torch.tensor(np.asarray(x, dtype=np.float64), device=self.device, requires_grad=True)
        ll = self._map_loglike(theta)
        ll.backward()
        out = torch.cat([ll.detach()[None], theta.grad]).cpu().numpy()
        return float(out[0]), out[1:]

    def _box(self):
        """(lower, upper) parameter bounds as float64 numpy (+-inf where unbounded)."""
        box = np.array(self.get_parameter_bounds(), dtype=np.float64).reshape(-1, 2)
        return box[:, 0], box[:, 1]

    def fit(self, initial_params=None):
        """MAP fit with L-BFGS-B under the parameter bounds, with exact
        gradients, on ``device``; a non-finite log-likelihood gives the
        optimizer 1e25 and a zero gradient (as the JAX package's ``fit``).
        ``timings["map_fit_evals"]`` counts the objective evaluations and
        ``timings["map_fit_launches"]`` the kernel launches they made."""
        if initial_params is None:
            initial_params = self.initial_params
        evals, launches = 0, celerite_log_likelihood_and_grad.launches

        def fun(x):
            nonlocal evals
            evals += 1
            ll, g = self._loglike_and_grad(x)
            if not np.isfinite(ll):
                return 1e25, np.zeros_like(np.asarray(x, dtype=float))
            return -ll, np.where(np.isfinite(g), -g, 0.0)

        bounds = [(lo if np.isfinite(lo) else None, hi if np.isfinite(hi) else None) for lo, hi in zip(*self._box())]
        out = minimize(fun, np.asarray(initial_params, dtype=float), jac=True, method="L-BFGS-B", bounds=bounds)
        self._count_map_evals(evals, launches)
        return out

    def _count_map_evals(self, evals, launches_before):
        self.timings["map_fit_evals"] = self.timings.get("map_fit_evals", 0) + evals
        self.timings["map_fit_launches"] = (self.timings.get("map_fit_launches", 0)
                                            + celerite_log_likelihood_and_grad.launches - launches_before)

    def fit_device(self, initial_params=None, max_iters: int = 200, tol: float = 1e-10):
        """MAP fit with the optimizer on the model's device as well:
        ``torch.optim.LBFGS`` with a strong-Wolfe line search over ``fit()``'s
        objective (on a card one gradient-kernel launch an evaluation), one
        iteration a ``step()``.  After each step the iterate is projected into
        the parameter box; the fit stops after ``max_iters`` iterations or
        once an iteration moves no parameter by more than ``tol`` (an
        iteration that LBFGS ends without a move, at a vanishing gradient or
        directional derivative, is such a one).

        On a face of the box, a gradient component that points out of the box
        is zeroed, and the optimizer's history restarts whenever the set of
        parameters on a face changes, so that L-BFGS works in the free
        parameters only (the JAX package's ``fit_device`` only clips: its
        curvature pairs then hold the steps before the projection, and it
        stalls on a face).  A non-finite log-likelihood gives 1e25 and a zero
        gradient, as in the JAX package.  The evaluations are counted as
        ``fit()`` counts them.  Returns (params (ndim,) numpy, nll float)."""
        if initial_params is None:
            initial_params = self.initial_params
        lo_np, hi_np = self._box()
        lo, hi = (torch.as_tensor(b, device=self.device) for b in (lo_np, hi_np))
        theta0 = np.clip(np.asarray(initial_params, dtype=np.float64), lo_np, hi_np)
        theta = torch.tensor(theta0, device=self.device, requires_grad=True)
        evals, launches = 0, celerite_log_likelihood_and_grad.launches

        def closure():
            nonlocal evals
            evals += 1
            theta.grad = None
            ll = self._map_loglike(theta)
            ok = torch.isfinite(ll)
            nll = torch.where(ok, -ll, ll.new_full((), 1e25))
            nll.backward()
            g = theta.grad
            outward = ((theta == lo) & (g > 0)) | ((theta == hi) & (g < 0))
            theta.grad = torch.where(ok & torch.isfinite(g) & ~outward, g, 0.0)
            return nll

        def optimizer():  # max_eval bounds the line search of one step at LBFGS's default 25
            return torch.optim.LBFGS([theta], lr=1.0, max_iter=1, max_eval=26, line_search_fn="strong_wolfe")

        opt = optimizer()
        on_face = (theta == lo) | (theta == hi)
        for _ in range(max_iters):
            before = theta.detach().clone()
            opt.step(closure)
            with torch.no_grad():
                theta.copy_(torch.clamp(theta, lo, hi))
                delta = float((theta - before).abs().max())
                faces = (theta == lo) | (theta == hi)
            if not delta > tol:
                break
            if not torch.equal(faces, on_face):
                opt, on_face = optimizer(), faces
        with torch.no_grad():
            ll = self._map_loglike(theta)
        evals += 1
        self._count_map_evals(evals, launches)
        nll = -float(ll)
        return theta.detach().cpu().numpy(), nll if np.isfinite(nll) else 1e25

    # ------------------------------------------------------------------ #
    def spread_walkers(self, walkers, parameters, bounds, percent=0.1, max_attempts=20, rng=None):
        """Gaussian ball around ``parameters`` clipped into bounds, with the
        reference's 1.05x/0.95x clamping of persistent out-of-bounds
        walkers; ``rng`` an optional ``np.random.Generator`` (else the
        global numpy RNG, as in the reference)."""
        if percent < 0 or percent > 1:
            raise ValueError("The 'percent' parameter must be between 0 and 1 (inclusive).")
        draw = rng.normal if rng is not None else np.random.normal
        parameters = np.asarray(parameters, dtype=float)
        std = np.abs(parameters) * percent
        initial_samples = draw(parameters, std, size=(walkers, len(parameters)))
        bounds = np.array(
            [
                (-np.inf if lower is None else lower, np.inf if upper is None else upper)
                for lower, upper in bounds
            ]
        )
        factors_lower = np.where(bounds[:, 0] > 0, 1.05, 0.95)
        factors_upper = np.where(bounds[:, 1] > 0, 0.95, 1.05)

        for i in range(walkers):
            attempt = 0
            for attempt in range(max_attempts):
                if np.all(
                    np.logical_and(bounds[:, 0] <= initial_samples[i], initial_samples[i] <= bounds[:, 1])
                ):
                    break
                initial_samples[i] = draw(parameters, std)
            if attempt == max_attempts - 1:
                warnings.warn("Some walkers are out of bounds! Setting them to values close to the bounds")
                out_lower = initial_samples[i] < bounds[:, 0]
                out_upper = initial_samples[i] > bounds[:, 1]
                initial_samples[i][out_lower] = (bounds[:, 0] * factors_lower)[out_lower]
                initial_samples[i][out_upper] = (bounds[:, 1] * factors_upper)[out_upper]
        return initial_samples

    # ------------------------------------------------------------------ #
    def _series(self, dtype):
        """(y, diag) on the model's device in ``dtype``, cast once."""
        return self._prepared(dtype, self.device)[1:3]

    def _prepared(self, dtype, device):
        """The data on ``device`` in ``dtype`` as the celerite op takes it
        (``ops.celerite._prepare``: ``t``, ``y``, ``diag``, the gaps and the
        batch-last copies), made once."""
        key = (dtype, torch.device(device))
        if key not in self._data:
            self._data[key] = _prepare(self._t_cpu, self._y_cpu, self._diag_cpu, dtype, device)
        return self._data[key]

    def log_prob_batch(self, thetas, team=None):
        """Log-posteriors (B,) of parameter draws (B, D) on their device (the
        model's, or a mesh shard's), in their dtype: flat priors within
        bounds plus the likelihood through the celerite op (``team``: its
        layout).  An unfitted constant mean enters as the op's per-element
        ``mean``; a fitted mean model as per-walker residual series (B, N),
        formed in float64 and then cast.  The data is the model's, prepared
        once (``_prepared``): a call copies no part of the series but the
        residuals, and so can be captured in a CUDA graph."""
        th_k = thetas[:, : self._nk]
        coeffs = self.kernel.coefficients(th_k)
        lp = self.kernel.log_prior(th_k)
        jitter = self.kernel.jitter(th_k)
        data = self._prepared(thetas.dtype, thetas.device)
        if self.fit_mean:
            th_m = thetas[:, self._nk :]
            lp = lp + self.mean_model.log_prior(th_m)
            resid = self._prepared(torch.float64, thetas.device).y - self.mean_model.value(data.t, th_m)
            resid = resid.to(thetas.dtype)
            data, mean = data._replace(y=resid, y_t=resid.T.contiguous()), None
        else:
            mean = thetas.new_full((thetas.shape[0],), float(self.mean_model.get_parameter_vector()[0]))
        ll = _log_likelihood_prepared(coeffs, data, mean=mean, extra_diag=jitter, team=team)
        return torch.where(torch.isfinite(lp), lp + ll, ll.new_full((), -math.inf))

    def _sampler_log_prob(self, mesh, team, counts):
        """The sampler's log-probability (B, D) -> (B,) on the model's device,
        counting its celerite calls in ``counts``: without a mesh
        ``log_prob_batch``; with one, the rows cut into ``mesh.size`` blocks
        (``parallel.shard_batch``), each evaluated on its device with the
        layout ``team``, all issued before the values are gathered back."""
        if mesh is None:
            def log_prob(thetas):
                counts[0] += 1
                return self.log_prob_batch(thetas)
            return log_prob

        def log_prob(thetas):
            outs = []
            for k, block in enumerate(shard_batch(thetas, mesh)):
                if len(block):
                    counts[k] += 1
                    outs.append(self.log_prob_batch(block, team=team))
            return gather(outs, thetas.device)
        return log_prob

    @tracing.traced("gp.derive_posteriors")
    def derive_posteriors(
        self,
        initial_chain_params=None,
        fit: bool = True,
        converge: bool = True,
        max_steps: int = 10000,
        convergence_steps: int = 500,
        walkers: int = 12,
        cores: int = 6,  # API parity; the parallelism is the batch
        progress: bool = False,
        seed: Optional[int] = None,
        fast: Optional[bool] = None,
        chains: int = 1,
        mesh=None,
    ):
        """Ensemble MCMC with the reference's convergence policy: every
        ``convergence_steps`` compute tau; stop once iteration > 100 tau
        and |dtau|/tau < 1%; then discard/thin by 40 tau (10 tau if over
        budget) / tau/2, or 5 tau / tau/4 when unconverged.

        ``timings`` holds the seconds of the MAP fit and of the sampling, the
        celerite kernel's launches of the sampling (``"sampling_launches"``),
        the shards of the sampler's evaluations (``"mesh_shards"``, 1 without
        a mesh) and each shard's celerite calls (``"shard_launches"``, a list:
        a kernel launch each on a card), and the steps replayed as a CUDA
        graph (``"sampling_graph_steps"``).  While a ``torch.profiler`` session
        runs, the call records ``tracing`` spans: ``gp.derive_posteriors``,
        its two phases ``gp.map_fit`` and ``gp.sampling`` (the timers of
        ``map_fit_s`` and ``sampling_s``), and under the sampling one
        ``sampler.segment`` a ``convergence_steps`` segment (counting its
        ``steps`` and its ``graph_steps``; its half-steps
        ``sampler.half_step``, each with its ``sampler.log_prob``), one
        ``sampler.autocorr`` a convergence check (the host waits there) and
        ``gp.chain_copy``, the chain's copy to the host.  On a card the
        half-step spans are those of the eager first step and of the capture
        only: a replay runs no Python.

        The steps: one ``sampler.ensemble.EnsembleChain`` a call, each
        segment a run of ``sample_ensemble_grouped`` (its steps' draws made
        up front, its walkers' log-probabilities evaluated anew).  On a card
        without a mesh the first step of the call runs eagerly, the next is
        captured as one CUDA graph (``sampler.graph``: both halves'
        ``stretch_step``, the chain's row, the accept counts) and every step
        after is a replay of it, the host waiting only at the convergence
        checks; the replays give the eager steps' chain bit for bit.  On the
        CPU and over a mesh every step runs eagerly.
        ``sampler.acceptance_fraction`` holds each walker's share of accepted
        proposals.

        ``fast``: explore in float32 and recompute the reported
        log-probabilities of the kept samples in float64, both through the
        same op (default False: the chain runs in float64).  ``seed`` seeds
        the walker ball (numpy) and the sampler's ``torch.Generator``.

        ``chains``: the number of independent stretch-move ensembles of
        ``walkers`` walkers each, run in lock-step (as ``sample_ensemble_grouped``:
        one likelihood launch a half-step for all of them); the chain is
        pooled as ``chains * walkers`` walkers.  ``initial_chain_params``
        may be (chains, walkers, ndim).

        ``mesh`` (``parallel.Mesh``): each half-step's log-probabilities are
        evaluated over the mesh, the proposed rows cut into ``mesh.size``
        blocks, each on its device with its own copy of the data and the
        layout the whole half-step would get (``ops.celerite.batch_team``);
        the proposals, the accept step and the autocorrelation stay on the
        model's device.  The chain, its log-probabilities and the samples
        equal the unsharded run's bit for bit.  Ignored, with a warning, when
        the leading axis of the walkers (walkers, or chains with ``chains >
        1``) does not divide into ``mesh.size`` shards.  A mesh of several
        processes is refused: the observed fits run in one process."""
        if chains < 1:
            raise ValueError("chains must be >= 1")
        if mesh is not None and mesh.process_count > 1:
            raise ValueError("derive_posteriors runs in one process; its mesh cannot span processes")
        if seed is not None:
            self._generator = torch.Generator(self.device).manual_seed(int(seed))
        self.timings = {}
        with tracing.phase("gp.map_fit", self.timings, "map_fit_s"):
            if initial_chain_params is None:
                initial_params = self.fit(self.initial_params).x if fit else self.initial_params
                initial_chain_params = self.spread_walkers(
                    chains * walkers, initial_params, np.array(self.get_parameter_bounds(), dtype=object),
                    rng=np.random.default_rng(seed) if seed is not None else None,
                )
                if chains > 1:
                    initial_chain_params = initial_chain_params.reshape(chains, walkers, -1)
        with tracing.phase("gp.sampling", self.timings, "sampling_s"):
            launches = celerite_log_likelihood.launches
            initial_chain_params = np.asarray(initial_chain_params, dtype=float)
            if chains > 1 and (initial_chain_params.ndim != 3 or initial_chain_params.shape[0] != chains):
                raise ValueError("with chains > 1, initial_chain_params must have shape (chains, walkers, ndim)")
            pooled = int(np.prod(initial_chain_params.shape[:-1]))
            if mesh is not None and initial_chain_params.shape[0] % mesh.size != 0:
                warnings.warn(
                    "derive_posteriors mesh mode needs the leading chain axis "
                    f"({initial_chain_params.shape[0]}) to divide the device count "
                    f"({mesh.size}); running unsharded"
                )
                mesh = None
            shard_calls = [0] * (1 if mesh is None else mesh.size)
            team = None if mesh is None else batch_team(self.kernel, pooled // 2, self.device)
            log_prob = self._sampler_log_prob(mesh, team, shard_calls)

            seg_dtype = torch.float32 if fast else torch.float64
            state = torch.as_tensor(initial_chain_params, dtype=seg_dtype, device=self.device)
            state = state.reshape(-1, *state.shape[-2:])  # (chains, walkers, D); one ensemble when chains == 1
            run = EnsembleChain(log_prob, state, max_steps)
            graphed = _graph_engages(state.device, mesh)
            replay, replayed = None, 0

            self.converged = False
            self._autocorr = []
            old_tau = np.inf
            iteration = 0
            tau = np.full(self._ndim, np.inf)
            while iteration < max_steps:
                steps = min(convergence_steps, max_steps - iteration)
                graph_steps = steps - (iteration == 0) if graphed else 0
                with tracing.span("sampler.segment", steps=steps, graph_steps=graph_steps):
                    run.segment(iteration, steps, self._generator)
                    for i in range(iteration, iteration + steps):
                        if graphed and i > 0 and replay is None:  # step 0 ran eagerly: the capture's warm-up
                            replay = _captured(run, shard_calls)
                        (run.step if replay is None else replay)()
                iteration += steps
                replayed += graph_steps
                with tracing.span("sampler.autocorr"):
                    tau = integrated_autocorr_time_masked(run.chain, iteration).cpu().numpy()
                self._autocorr.append(np.mean(tau))
                if progress:
                    accept = float(run.accepted.sum()) / (iteration * pooled)
                    print(f"step {iteration}/{max_steps} (accept {accept:.2f})", flush=True)
                if np.all(tau * 100 < iteration) and np.all(np.abs(old_tau - tau) / tau < 0.01) and converge:
                    if progress:
                        print("Convergence reached after %d samples!" % iteration)
                    self.converged = True
                    break
                old_tau = tau

            with tracing.span("gp.chain_copy"):
                sampler = ChainResult(
                    run.chain[:iteration].cpu().double().numpy(),
                    run.log_probs[:iteration].cpu().double().numpy(),
                    (run.accepted.reshape(-1).double() / iteration).cpu().numpy(),
                )
            self._tau = tau
            mean_tau = np.mean(tau)
            if not np.isfinite(mean_tau):
                warnings.warn("Autocorrelation time is not finite (stuck chains?); using conservative burn-in")
                mean_tau = sampler.iteration / 10.0
                self._tau = np.where(np.isfinite(tau), tau, sampler.iteration)
            if not self.converged:
                warnings.warn(f"The chains did not converge after {sampler.iteration} iterations!")
                thin = max(int(mean_tau / 4), 1)
                discard = int(mean_tau) * 5
            else:
                discard = int(mean_tau * 40)
                if discard > max_steps:
                    discard = int(mean_tau * 10)
                thin = max(int(mean_tau / 2), 1)
            discard = min(discard, sampler.iteration - 1)

            self._loglikelihoods = sampler.get_log_prob(discard=discard, thin=thin, flat=True)
            self._mcmc_samples = sampler.get_chain(discard=discard, thin=thin, flat=True)
            if fast and len(self._mcmc_samples):
                # float64 log-probabilities at the float32-explored samples
                flat = torch.as_tensor(self._mcmc_samples, dtype=torch.float64, device=self.device)
                self._loglikelihoods = torch.cat(
                    [self.log_prob_batch(flat[s : s + 4096]) for s in range(0, flat.shape[0], 4096)]
                ).cpu().numpy()
            self._sampler = sampler
        self.timings["sampling_launches"] = celerite_log_likelihood.launches - launches
        self.timings["sampling_graph_steps"] = replayed
        self.timings["mesh_shards"] = len(shard_calls)
        self.timings["shard_launches"] = shard_calls

    # ------------------------------------------------------------------ #
    def _model_at(self, parameters):
        """(coefficients, jitter, mean curve at the training times, mean-model
        parameters) of a parameter vector (the current one when None), as
        float64 tensors on the device."""
        theta = self.get_parameter_vector() if parameters is None else parameters
        theta = torch.as_tensor(np.asarray(theta, dtype=np.float64), device=self.device)
        th_k, th_m = self._split_theta(theta)
        return (self.kernel.coefficients(th_k), self.kernel.jitter(th_k), self.mean_model.value(self._t, th_m),
                th_m)

    def standarized_residuals(self, include_noise: bool = True, parameters=None):
        """(y - mu) / sqrt(var) at the training points (Kelly+2011 Eq. 49, the
        reference's formula), numpy (N,).  ``parameters`` defaults to the
        current vector."""
        coeffs, jitter, mean, _ = self._model_at(parameters)
        y, diag = self._series(torch.float64)
        mu_res, var = solver_predict(coeffs, self._t, y - mean, diag + jitter)
        if include_noise:
            var = var + jitter
        return ((y - (mu_res + mean)) / torch.sqrt(var)).cpu().numpy()

    def loo_residuals(self, parameters=None):
        """Exact leave-one-out standardized residuals alpha_n / sqrt((K^-1)_nn)
        with alpha = K^-1 (y - mean), by the O(N R^2) selected inverse; ~ N(0, 1)
        under the model (unlike ``standarized_residuals``).  numpy (N,)."""
        coeffs, jitter, mean, _ = self._model_at(parameters)
        y, diag = self._series(torch.float64)
        m = build_matrices(coeffs, self._t, diag + jitter)
        D, W, _ = factor(m)
        alpha = solve(m, D, W, y - mean)
        return (alpha / torch.sqrt(inverse_diag(m, D, W))).cpu().numpy()

    def predict(self, t_pred=None, parameters=None, return_var: bool = True, include_noise: bool = False):
        """GP predictive mean (and variance) at ``t_pred`` (default: the
        training times), celerite's ``gp.predict``; numpy."""
        coeffs, jitter, mean_train, th_m = self._model_at(parameters)
        y, diag = self._series(torch.float64)
        if t_pred is None:
            mu_res, var = solver_predict(coeffs, self._t, y - mean_train, diag + jitter)
            mu = mu_res + mean_train
        else:
            t_pred = torch.as_tensor(np.asarray(t_pred, dtype=np.float64), device=self.device)
            mean_pred = self.mean_model.value(t_pred, th_m)
            out = solver_predict_at(coeffs, self._t, y - mean_train, diag + jitter, t_pred, return_var=return_var)
            if not return_var:
                return (out + mean_pred).cpu().numpy()
            mu, var = out[0] + mean_pred, out[1]
        if not return_var:
            return mu.cpu().numpy()
        if include_noise:
            var = var + jitter
        return mu.cpu().numpy(), var.cpu().numpy()

    def get_rstat(self, burnin: Optional[int] = None):
        """Gelman-Rubin-style ratio (walkers, ndim): each walker's variance over
        that of the pooled chain (the reference's formula)."""
        if self._sampler is None:
            raise ValueError(_NOT_DERIVED)
        if burnin is None:
            burnin = int(np.mean(self.tau)) * 10
        within = np.var(self._sampler.get_chain(discard=burnin), axis=0)
        between = np.var(self._sampler.get_chain(flat=True, discard=burnin), axis=0)
        return within / between[np.newaxis, :]

    # ------------------------------------------------------------------ #
    @property
    def loglikelihoods(self):
        if self._loglikelihoods is None:
            raise AttributeError(_NOT_DERIVED)
        return self._loglikelihoods

    @property
    def autocorr(self):
        return self._autocorr

    @property
    def sampler(self):
        if self._loglikelihoods is None:
            raise AttributeError(_NOT_DERIVED)
        return self._sampler

    @property
    def mcmc_samples(self):
        if self._mcmc_samples is None:
            raise AttributeError(_NOT_DERIVED)
        return self._mcmc_samples

    @property
    def max_loglikelihood(self):
        if self._loglikelihoods is None:
            raise AttributeError(_NOT_DERIVED)
        return np.max(self._loglikelihoods)

    @property
    def max_parameters(self):
        if self._mcmc_samples is None:
            raise AttributeError(_NOT_DERIVED)
        return self._mcmc_samples[np.argmax(self._loglikelihoods)]

    @property
    def median_parameters(self):
        if self._mcmc_samples is None:
            raise AttributeError(_NOT_DERIVED)
        return np.median(self._mcmc_samples, axis=0)

    @property
    def k(self) -> int:
        return self._ndim

    @property
    def tau(self):
        if self._mcmc_samples is None:
            raise AttributeError(_NOT_DERIVED)
        return self._tau

    # ------------------------------------------------------------------ #
    def save_posteriors(self, path) -> None:
        """Persist the MCMC state to an .npz (a path or a binary file),
        in the JAX package's format."""
        if self._sampler is None:
            raise RuntimeError("Posteriors have not been derived; nothing to save.")
        np.savez_compressed(
            path,
            chain=self._sampler._chain,
            log_probs=self._sampler._log_probs,
            tau=self._tau,
            converged=np.asarray(self.converged),
            autocorr=np.asarray(self._autocorr),
            mcmc_samples=self._mcmc_samples,
            loglikelihoods=self._loglikelihoods,
        )

    def load_posteriors(self, path) -> None:
        """Restore the state written by ``save_posteriors`` (of either
        package)."""
        data = np.load(path)
        self._sampler = ChainResult(data["chain"], data["log_probs"])
        self._tau = data["tau"]
        self.converged = bool(data["converged"])
        self._autocorr = list(data["autocorr"])
        self._mcmc_samples = data["mcmc_samples"]
        self._loglikelihoods = data["loglikelihoods"]

    # ------------------------------------------------------------------ #
    def make_device_generator(self, pdf: str = "Gaussian", extension_factor: int = 2, sigma_noise=None):
        """Posterior-predictive generator on the device:
        ``gen(thetas (B, D), generator) -> (rates (B, n), dy (B, n))``,
        the TK95 draw, cut, E13 adjustment (non-Gaussian ``pdf``),
        downsampling and noise of each draw.  The E13 non-convergence
        count accumulates on the device and ``gen.report_nonconverged()``
        fetches it once, at the end of a run.  The simulator stays in
        ``_simulator``."""
        simulator = self._lightcurve.get_simulator(
            self.kernel.get_psd, pdf, sigma_noise=sigma_noise, extension_factor=extension_factor,
            device=self.device,
        )
        omega = torch.as_tensor(simulator.omega[1:], dtype=torch.float64, device=self.device)
        nk = self._nk

        def gen(thetas, generator: Optional[torch.Generator] = None):
            thetas = torch.as_tensor(thetas, dtype=torch.float64, device=self.device)
            psd = self.kernel.get_psd(omega, thetas[:, :nk])
            psd = torch.cat([psd.new_zeros((psd.shape[0], 1)), psd], dim=1)
            rates = simulator.simulate_batch(psd, generator=generator, warn_nonconverged=False)
            return simulator.add_noise_batch(rates, generator)

        gen.simulator = simulator
        gen.report_nonconverged = simulator.report_nonconverged
        self._simulator = simulator
        return gen

    def generate_batch_from_posteriors(self, nsims: int, pdf: str = "Gaussian", extension_factor: int = 2,
                                       sigma_noise=None, seed: Optional[int] = None):
        """numpy (rates (nsims, n), dy (nsims, n)) of lightcurves simulated
        from posterior samples drawn with replacement; ``seed`` reseeds
        the model's generator."""
        if seed is not None:
            self._generator = torch.Generator(self.device).manual_seed(int(seed))
        samples = torch.as_tensor(np.asarray(self.mcmc_samples, dtype=np.float64), device=self.device)
        idx = torch.randint(0, samples.shape[0], (nsims,), generator=self._generator, device=self.device)
        gen = self.make_device_generator(pdf, extension_factor=extension_factor, sigma_noise=sigma_noise)
        noisy_out, dy_out = [], []
        for start in range(0, nsims, GEN_CHUNK):
            noisy, dy = gen(samples[idx[start : start + GEN_CHUNK]], self._generator)
            noisy_out.append(noisy.cpu().numpy())
            dy_out.append(dy.cpu().numpy())
        gen.report_nonconverged()  # one end-of-run E13 non-convergence warning
        return np.concatenate(noisy_out), np.concatenate(dy_out)

    def generate_from_posteriors(self, nsims: int = 10, cpus: int = 8, pdf: str = "Gaussian",
                                 extension_factor: int = 2, sigma_noise=None, seed: Optional[int] = None):
        """Posterior-predictive lightcurves as a list of GappyLightcurve
        (``cpus``: API parity; the batch is the parallelism)."""
        if self._mcmc_samples is None:
            raise RuntimeError(
                "Posteriors have not been derived. Please run derive_posteriors prior to calling this method."
            )
        if nsims >= len(self._mcmc_samples):
            warnings.warn(
                "The number of simulation requested (%d) is higher than the number of posterior samples (%d), "
                "so many samples will be drawn more than once" % (nsims, len(self._mcmc_samples))
            )
        rates, dy = self.generate_batch_from_posteriors(
            nsims, pdf=pdf, extension_factor=extension_factor, sigma_noise=sigma_noise, seed=seed
        )
        times = self._lightcurve.times
        return [GappyLightcurve(times, r, e) for r, e in zip(rates, dy)]
