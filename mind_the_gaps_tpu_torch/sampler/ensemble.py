"""Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch move).

PyTorch port of ``mind_the_gaps_tpu/sampler/ensemble.py`` (emcee's
algorithm): complementary-half updates with the stretch proposal

    z ~ g(z) prop. 1/sqrt(z) on [1/a, a]   (a = 2)
    Y = X_j + z (X_k - X_j),  accept with prob min(1, z^(d-1) e^(dlogp))

so that each step evaluates the log-probability of half the ensemble as
one batch.  ``sample_ensemble_grouped`` runs C independent ensembles in
lock-step, each half-update one (C W/2, D) batch; ``max_loglike_ensemble_impl``
keeps only the running best.  The random numbers enter as tensors
(``stretch_draws``), so a test can feed both implementations the same
draws; by default they come from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from mind_the_gaps_tpu_torch import tracing

__all__ = [
    "stretch_draws",
    "stretch_half",
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
    w = state.shape[-2]
    half = w // 2
    if 2 * half != w:
        raise ValueError("number of walkers must be even")
    return half


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
    state = torch.as_tensor(initial_state)
    if draws is not None:
        draws = tuple(d[:, :, None] for d in draws)
    chain, log_probs, acc, final = sample_ensemble_grouped(log_prob_fn, state[None], n_steps, generator, a, draws)
    return chain[:, 0], log_probs[:, 0], acc, final[0]


sample_ensemble = sample_ensemble_impl


def run_ensemble(log_prob_fn: Callable, initial_state, n_steps: int,
                 generator: Optional[torch.Generator] = None, a: float = 2.0, draws=None):
    """Alias of ``sample_ensemble`` (API stability)."""
    return sample_ensemble(log_prob_fn, initial_state, n_steps, generator, a, draws)


def sample_ensemble_grouped(
    log_prob_fn: Callable,
    initial_state,
    n_steps: int,
    generator: Optional[torch.Generator] = None,
    a: float = 2.0,
    draws=None,
):
    """``C`` independent stretch-move ensembles advancing in lock-step.

    ``initial_state`` (C, W, D).  Each ensemble proposes only within its own
    complementary halves (the statistics of C separate
    ``sample_ensemble_impl`` runs), and every half-update evaluates one
    (C W/2, D) batch of ``log_prob_fn`` ((B, D) -> (B,) for any B).
    ``draws``: optional ``stretch_draws(n_steps, (C, W // 2), ...)``; chain
    ``c`` given ``draws[k][:, :, c]`` equals a ``sample_ensemble_impl`` run.

    Returns chain (n_steps, C, W, D), log_probs (n_steps, C, W), the
    acceptance fraction (0-d) and the final state (C, W, D).
    """
    state = torch.as_tensor(initial_state)
    c, w, d = state.shape
    half = _halves(state)
    if draws is None:
        draws = stretch_draws(n_steps, (c, half), state.dtype, state.device, generator)
    u_z, picks, u_acc = draws

    def lp(x):  # (C, half, D) -> (C, half)
        return log_prob_fn(x.reshape(c * half, d)).reshape(c, half)

    logp = torch.cat([lp(state[:, :half]), lp(state[:, half:])], dim=1)
    chain = state.new_empty((n_steps, c, w, d))
    log_probs = state.new_empty((n_steps, c, w))
    n_acc = torch.zeros((), dtype=torch.int64, device=state.device)
    for i in range(n_steps):
        first, second = state[:, :half], state[:, half:]
        first, lp1, acc1 = stretch_half(first, second, logp[:, :half], lp, u_z[i, 0], picks[i, 0], u_acc[i, 0], a)
        second, lp2, acc2 = stretch_half(second, first, logp[:, half:], lp, u_z[i, 1], picks[i, 1], u_acc[i, 1], a)
        state = torch.cat([first, second], dim=1)
        logp = torch.cat([lp1, lp2], dim=1)
        chain[i] = state
        log_probs[i] = logp
        n_acc += acc1.sum() + acc2.sum()
    return chain, log_probs, n_acc / (n_steps * c * w), state


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
    state = torch.as_tensor(initial_state)
    half = _halves(state)
    if draws is None:
        draws = stretch_draws(n_steps, (half,), state.dtype, state.device, generator)
    u_z, picks, u_acc = draws

    logp = log_prob_fn(state)
    i0 = torch.argmax(logp)
    best_lp, best_x = logp[i0], state[i0]
    for i in range(n_steps):
        first, second = state[:half], state[half:]
        first, lp1, _ = stretch_half(first, second, logp[:half], log_prob_fn, u_z[i, 0], picks[i, 0], u_acc[i, 0], a)
        second, lp2, _ = stretch_half(second, first, logp[half:], log_prob_fn, u_z[i, 1], picks[i, 1], u_acc[i, 1], a)
        state = torch.cat([first, second])
        logp = torch.cat([lp1, lp2])
        j = torch.argmax(logp)
        better = logp[j] > best_lp
        best_lp = torch.where(better, logp[j], best_lp)
        best_x = torch.where(better, state[j], best_x)
    return best_lp, best_x, state, logp
