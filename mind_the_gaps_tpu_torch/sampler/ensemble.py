"""Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch move).

PyTorch port of ``mind_the_gaps_tpu/sampler/ensemble.py`` (emcee's
algorithm): complementary-half updates with the stretch proposal

    z ~ g(z) prop. 1/sqrt(z) on [1/a, a]   (a = 2)
    Y = X_j + z (X_k - X_j),  accept with prob min(1, z^(d-1) e^(dlogp))

so that each step evaluates the log-probability of half the ensemble as
one batch.  ``stretch_step`` is the one step: C ensembles in lock-step,
each half-update one (C W/2, D) batch, written in place so that a CUDA
graph can capture it (``sampler.graph``).  ``EnsembleChain`` records the
chain of such steps in buffers that live for a whole run, reading each
step's draws at a step index on the device, so that a CUDA graph of one
step serves every step: ``sample_ensemble_grouped`` runs it eagerly,
``gpmodelling.derive_posteriors`` replays it on a card.
``max_loglike_ensemble_impl`` and the bootstrap refits (``lrt``) keep the
running best (``update_best``).
The random numbers enter as tensors (``stretch_draws``), so a test can
feed both implementations the same draws; by default they come from a
``torch.Generator``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from mind_the_gaps_tpu_torch import tracing

__all__ = [
    "stretch_draws",
    "stretch_half",
    "stretch_step",
    "half_log_probs",
    "update_best",
    "best_walkers",
    "EnsembleChain",
    "sample_ensemble",
    "sample_ensemble_impl",
    "sample_ensemble_grouped",
    "run_ensemble",
    "max_loglike_ensemble_impl",
]


def stretch_draws(n_steps: int, shape, dtype, device, generator: Optional[torch.Generator] = None):
    """Draws for ``n_steps`` steps of both halves: ``(u_z, picks, u_acc)``,
    each of shape ``(n_steps, 2, *shape)`` where ``shape[-1]`` is the half
    size (``picks`` index the passive half)."""
    shape = tuple(shape)
    u = torch.rand((2, n_steps, 2) + shape, generator=generator, dtype=dtype, device=device)
    picks = torch.randint(0, shape[-1], (n_steps, 2) + shape, generator=generator, device=device)
    return u[0], picks, u[1]


def stretch_half(active, passive, logp_active, log_prob_fn: Callable, u_z, picks, u_acc, a: float = 2.0):
    """One stretch-move update of ``active`` (..., W, D) against
    ``passive`` (..., Wp, D), with uniforms ``u_z``/``u_acc`` (..., W) and
    partner indices ``picks`` (..., W)."""
    with tracing.span("sampler.half_step"):
        d = active.shape[-1]
        z = ((a - 1.0) * u_z + 1.0) ** 2 / a
        partners = torch.take_along_dim(passive, picks[..., None], dim=-2)
        proposal = partners + z[..., None] * (active - partners)
        with tracing.span("sampler.log_prob"):
            logp_new = log_prob_fn(proposal)
        log_accept = (d - 1.0) * torch.log(z) + logp_new - logp_active
        accept = torch.log(u_acc) < log_accept
        new_active = torch.where(accept[..., None], proposal, active)
        new_logp = torch.where(accept, logp_new, logp_active)
        return new_active, new_logp, accept


def _halves(state):
    if state.shape[-2] % 2:
        raise ValueError("number of walkers must be even")
    return state.shape[-2] // 2


def _batched(log_prob_fn):  # (B, D) -> (B,) as (C, H, D) -> (C, H), one (C H, D) batch
    return lambda x: log_prob_fn(x.reshape(-1, x.shape[-1])).reshape(x.shape[:-1])


def half_log_probs(log_prob_fn: Callable, state):
    """The log-probabilities (C, W) of ``state`` (C, W, D), a batch a half."""
    half, lp = _halves(state), _batched(log_prob_fn)
    return torch.cat([lp(state[:, :half]), lp(state[:, half:])], dim=1)


def stretch_step(state, logp, log_prob_fn: Callable, u_z, picks, u_acc, a: float = 2.0):
    """One step of both halves of C ensembles, written into ``state`` (C, W,
    D) and ``logp`` (C, W) with no sync or host copy (a CUDA graph captures
    it), from one step's ``stretch_draws`` (2, C, W/2), the second half
    moving against the first's new walkers; ``log_prob_fn`` is (B, D) ->
    (B,).  Returns the halves' accept masks."""
    half, lp = _halves(state), _batched(log_prob_fn)
    accepts = [None, None]
    for k, (act, pas) in enumerate(((slice(0, half), slice(half, None)), (slice(half, None), slice(0, half)))):
        state[:, act], logp[:, act], accepts[k] = stretch_half(state[:, act], state[:, pas], logp[:, act], lp,
                                                               u_z[k], picks[k], u_acc[k], a)
    return accepts


def best_walkers(state, logp):
    """Each ensemble's best walker (the first of ties): (C,) and (C, D)."""
    i = torch.argmax(logp, dim=1, keepdim=True)
    return torch.take_along_dim(logp, i, dim=1)[:, 0], torch.take_along_dim(state, i[..., None], dim=1)[:, 0]


def update_best(state, logp, best_lp, best_x, tol=None):
    """Write each ensemble's best walker into ``best_lp`` (C,) / ``best_x``
    (C, D) where it beats them; whether one beat them by more than ``tol``
    (a 0-d tensor), None without a ``tol``."""
    cand_lp, cand_x = best_walkers(state, logp)
    improved = None if tol is None else torch.any(cand_lp > best_lp + tol)
    better = cand_lp > best_lp
    best_lp.copy_(torch.where(better, cand_lp, best_lp))
    best_x.copy_(torch.where(better[:, None], cand_x, best_x))
    return improved


class EnsembleChain:
    """A recorded run of C ensembles of W walkers: the walkers (a copy of
    ``state`` (C, W, D)) and their log-probabilities, the chain's rows
    (``chain`` (max_steps, C W, D), ``log_probs`` (max_steps, C W)), the
    draws of every step, each walker's accepted proposals (``accepted``) and,
    on the device, the index of the next step.  All of it lives for the
    whole run, so that one CUDA graph of ``step`` serves every step."""

    def __init__(self, log_prob_fn: Callable, state, max_steps: int, a: float = 2.0):
        c, w, d = state.shape
        self.log_prob, self.state, self.a, self.half = log_prob_fn, state.clone(), a, _halves(state)
        self.logp = state.new_empty((c, w))
        self.chain = state.new_zeros((max_steps, c * w, d))
        self.log_probs = state.new_zeros((max_steps, c * w))
        shape = (max_steps, 2, c, self.half)
        self.draws = (state.new_empty(shape), state.new_empty(shape, dtype=torch.int64), state.new_empty(shape))
        self.accepted = state.new_zeros((c, w), dtype=torch.int64)
        self.index = state.new_zeros((1,), dtype=torch.int64)

    def segment(self, start: int, steps: int, generator: Optional[torch.Generator] = None, draws=None) -> None:
        """Before the steps ``start`` to ``start + steps``: their draws
        (``draws``, else ``stretch_draws(steps, (C, W // 2), ...)`` from
        ``generator``) and the walkers' log-probabilities evaluated anew."""
        if draws is None:
            draws = stretch_draws(steps, (self.state.shape[0], self.half), self.state.dtype, self.state.device,
                                  generator)
        for buf, x in zip(self.draws, draws):
            buf[start : start + steps] = x
        self.logp.copy_(half_log_probs(self.log_prob, self.state))

    def step(self) -> None:
        """The step at ``index``: ``stretch_step`` from its draws, the chain's
        row and the accept counts written, the index moved on; no sync and
        no host copy, so that a CUDA graph can capture it."""
        i = self.index
        u_z, picks, u_acc = (x.index_select(0, i)[0] for x in self.draws)
        acc1, acc2 = stretch_step(self.state, self.logp, self.log_prob, u_z, picks, u_acc, self.a)
        self.accepted[:, : self.half] += acc1
        self.accepted[:, self.half :] += acc2
        self.chain.index_copy_(0, i, self.state.reshape(1, -1, self.state.shape[-1]))
        self.log_probs.index_copy_(0, i, self.logp.reshape(1, -1))
        i += 1


def sample_ensemble_impl(
    log_prob_fn: Callable,
    initial_state,
    n_steps: int,
    generator: Optional[torch.Generator] = None,
    a: float = 2.0,
    draws=None,
):
    """Run the ensemble for ``n_steps``: ``sample_ensemble_grouped`` with
    one ensemble (the same draws, so the same chain).

    ``log_prob_fn``: (W', D) -> (W',) on the device and dtype of
    ``initial_state`` (W, D), W even.  ``draws``: optional
    ``stretch_draws(n_steps, (W // 2,), ...)`` output.

    Returns chain (n_steps, W, D), log_probs (n_steps, W), the acceptance
    fraction (a 0-d tensor) and the final state (W, D).
    """
    draws = None if draws is None else tuple(d[:, :, None] for d in draws)
    chain, log_probs, acc, final = sample_ensemble_grouped(log_prob_fn, torch.as_tensor(initial_state)[None], n_steps,
                                                           generator, a, draws)
    return chain[:, 0], log_probs[:, 0], acc, final[0]


sample_ensemble = run_ensemble = sample_ensemble_impl  # the JAX package's names (API stability)


def sample_ensemble_grouped(
    log_prob_fn: Callable,
    initial_state,
    n_steps: int,
    generator: Optional[torch.Generator] = None,
    a: float = 2.0,
    draws=None,
):
    """``C`` independent stretch-move ensembles advancing in lock-step.

    ``initial_state`` (C, W, D), left as it is.  Each ensemble proposes only
    within its own complementary halves (the statistics of C separate
    ``sample_ensemble_impl`` runs), each step one ``stretch_step``.
    ``draws``: optional ``stretch_draws(n_steps, (C, W // 2), ...)``; chain
    ``c`` given ``draws[k][:, :, c]`` equals a ``sample_ensemble_impl`` run.

    Returns chain (n_steps, C, W, D), log_probs (n_steps, C, W), the
    acceptance fraction (0-d) and the final state (C, W, D).
    """
    run = EnsembleChain(log_prob_fn, torch.as_tensor(initial_state), n_steps, a)
    c, w, d = run.state.shape
    run.segment(0, n_steps, generator, draws)
    for _ in range(n_steps):
        run.step()
    return (run.chain.reshape(n_steps, c, w, d), run.log_probs.reshape(n_steps, c, w),
            run.accepted.sum() / (n_steps * c * w), run.state)


def max_loglike_ensemble_impl(
    log_prob_fn: Callable,
    initial_state,
    n_steps: int,
    generator: Optional[torch.Generator] = None,
    a: float = 2.0,
    draws=None,
):
    """A stretch-move run that keeps only the running maximum log-prob and
    the position attaining it (O(W D) memory instead of O(n_steps W D)),
    with the draws of ``sample_ensemble_impl``.

    Returns (best_lp (0-d), best_x (D,), final state (W, D), final log-probs (W,))."""
    state = torch.as_tensor(initial_state).clone()[None]
    if draws is None:
        draws = stretch_draws(n_steps, (_halves(state),), state.dtype, state.device, generator)
    u_z, picks, u_acc = (d[:, :, None] for d in draws)

    logp = log_prob_fn(state[0])[None]
    best_lp, best_x = best_walkers(state, logp)
    for i in range(n_steps):
        stretch_step(state, logp, log_prob_fn, u_z[i], picks[i], u_acc[i], a)
        update_best(state, logp, best_lp, best_x)
    return best_lp[0], best_x[0], state[0], logp[0]
