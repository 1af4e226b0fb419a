"""The celerite log-likelihood with its exact gradient: CUDA kernel and plain
version, and the autograd function of the MAP fit.

``celerite_log_likelihood_and_grad(coeffs, t, y, diag, mean, extra_diag)``
returns ``(ll (B,), grads)``: the log-likelihoods of
``ops.celerite_log_likelihood`` (-inf where K(theta_b) is not positive
definite; ``dt`` formed from ``t`` in float64) and a ``LogLikelihoodGrads``
of dll/d each coefficient tensor (their (B, Jr) / (B, Jc) shapes),
dll/d``extra_diag`` (B,) and dll/dr (B, N), the gradient with respect to
the residual r = y - mean.  A draw whose K is not positive definite gets a
gradient of zeros.  This is the port of ``jax.value_and_grad`` over
``mind_the_gaps_tpu/solver/semiseparable.py::log_likelihood``, which the
JAX package's ``GPModelling.fit`` runs; no Pallas kernel computes it.

Layouts: ``y`` shared (N,) or per element (B, N), ``diag`` shared (N,);
``mean`` and ``extra_diag`` optional (B,).  float64 only: the MAP objective
is float64 in both packages (a float32 instantiation waits for a path that
needs it).  Any R = Jr + 2 Jc >= 1; from R = 14 on an H100 the kernel's
chunk buffers no longer fit in shared memory and live in a global scratch
area that the wrapper allocates (the size comes from the library), so such
R run slower.

A CPU tensor goes to the plain version
(``celerite_log_likelihood_and_grad_plain``: ``solver.semiseparable``'s
recursion per element, with its autograd gradient).  A CUDA tensor launches
the kernel of ``csrc/celerite_grad.cuh`` (built as ``celerite_grad_f64.cu``)
on the current stream, one block of three warps a likelihood (a chain
lane and two helper warps), or raises: there is no fallback.
``celerite_log_likelihood_and_grad.launches`` counts the launches.

``celerite_loglike_fn`` is the ``torch.autograd.Function`` over the op:
its forward runs the one fused launch, which computes the value and every
gradient, and saves the gradients; its backward scales them by the
incoming gradient.  Every objective evaluation of L-BFGS-B needs both the
value and the gradient, so one launch for the two is the shape the fit
wants.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mind_the_gaps_tpu_torch.ops._build import device_scope, load_library, stream_handle
from mind_the_gaps_tpu_torch.ops.celerite import check_coefficients
from mind_the_gaps_tpu_torch.solver.semiseparable import log_likelihood

__all__ = [
    "LogLikelihoodGrads",
    "celerite_log_likelihood_and_grad",
    "celerite_log_likelihood_and_grad_plain",
    "celerite_loglike_fn",
]

_ENTRY = "celerite_grad_f64"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _I] + [_P] * 3 + [_I] + [_P] * 9 + [_I, _I] + [_P] * 12


class LogLikelihoodGrads(NamedTuple):
    """Gradients of the (B,) log-likelihoods: one row per draw."""

    ar: torch.Tensor
    cr: torch.Tensor
    ac: torch.Tensor
    bc: torch.Tensor
    cc: torch.Tensor
    dc: torch.Tensor
    extra_diag: torch.Tensor  # (B,)
    r: torch.Tensor  # (B, N): with respect to the residual y - mean


def _record_words(R: int) -> int:
    """float64 words the kernel stores per step of one likelihood: D, z,
    W, f and the packed S."""
    return 2 + 2 * R + R * (R + 1) // 2


def _check(coeffs, t, y, diag, mean, extra_diag):
    """(B, Jr, Jc, N, t, y, diag, mean, extra_diag) as float64 tensors on the
    coefficients' device; raises on what the op does not take."""
    ar = coeffs[0]
    if ar.dtype != torch.float64:
        raise TypeError(f"celerite_log_likelihood_and_grad takes float64, not {ar.dtype}")
    B, Jr, Jc = check_coefficients(coeffs)
    device = ar.device
    t = torch.as_tensor(t, dtype=torch.float64, device=device)
    N = t.shape[0]
    y = torch.as_tensor(y, dtype=torch.float64, device=device)
    diag = torch.as_tensor(diag, dtype=torch.float64, device=device)
    if y.dim() == 1:
        ok = y.shape[0] == N
    else:
        ok = y.dim() == 2 and tuple(y.shape) == (B, N)
    if not ok:
        raise ValueError(f"y must be ({N},) or ({B}, {N}), got {tuple(y.shape)}")
    if tuple(diag.shape) != (N,):
        raise ValueError(f"diag must be shared ({N},), got {tuple(diag.shape)}")
    if mean is not None:
        mean = torch.as_tensor(mean, dtype=torch.float64, device=device)
    if extra_diag is not None:
        extra_diag = torch.as_tensor(extra_diag, dtype=torch.float64, device=device)
    for name, x in (("mean", mean), ("extra_diag", extra_diag)):
        if x is not None and tuple(x.shape) != (B,):
            raise ValueError(f"{name} must be a ({B},) tensor")
    return B, Jr, Jc, N, t, y, diag, mean, extra_diag


def celerite_log_likelihood_and_grad_plain(coeffs, t, y, diag, mean=None, extra_diag=None):
    """The plain version: ``solver.semiseparable.log_likelihood`` for each
    draw, and its autograd gradient (zeros where the value is -inf)."""
    B, Jr, Jc, N, t, y, diag, mean, extra_diag = _check(coeffs, t, y, diag, mean, extra_diag)
    zero = coeffs[0].new_zeros(())
    lls, rows = [], []
    with torch.enable_grad():
        for b in range(B):
            cb = [c[b].detach().clone().requires_grad_(True) for c in coeffs]
            e = (zero if extra_diag is None else extra_diag[b]).detach().clone().requires_grad_(True)
            r = (y if y.dim() == 1 else y[b]) - (zero if mean is None else mean[b])
            r = r.detach().clone().requires_grad_(True)
            ll = log_likelihood(cb, t, r, diag + e)
            inputs = [*cb, e, r]
            if torch.isfinite(ll):
                g = torch.autograd.grad(ll, inputs, allow_unused=True)
                g = [torch.zeros_like(x) if gx is None else gx for x, gx in zip(inputs, g)]
            else:
                g = [torch.zeros_like(x) for x in inputs]
            lls.append(ll.detach())
            rows.append(g)
    ll = torch.stack(lls) if lls else coeffs[0].new_empty((0,))
    grads = [torch.stack([row[k] for row in rows]) for k in range(8)] if rows else None
    if grads is None:
        grads = [c.new_empty(c.shape) for c in coeffs] + [zero.new_empty((0,)), zero.new_empty((0, N))]
    return ll, LogLikelihoodGrads(*grads)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = getattr(load_library(_ENTRY), _ENTRY)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _scratch_entry():
    fn = getattr(load_library(_ENTRY), _ENTRY + "_scratch_words")
    fn.argtypes = [_I, _I, _I]
    fn.restype = ctypes.c_longlong
    return fn


def _ptr(x):
    return None if x is None else x.data_ptr()


def celerite_log_likelihood_and_grad(coeffs, t, y, diag, mean=None, extra_diag=None):
    """(ll (B,), LogLikelihoodGrads); see the module docstring."""
    if coeffs[0].device.type == "cpu":
        return celerite_log_likelihood_and_grad_plain(coeffs, t, y, diag, mean=mean, extra_diag=extra_diag)
    return _launch(coeffs, t, y, diag, mean, extra_diag)


def _launch(coeffs, t, y, diag, mean=None, extra_diag=None):
    ar = coeffs[0]
    if ar.device.type != "cuda":
        raise ValueError(f"celerite_log_likelihood_and_grad runs on CPU or CUDA tensors, not {ar.device}")
    B, Jr, Jc, N, t, y, diag, mean, extra_diag = _check(coeffs, t, y, diag, mean, extra_diag)
    R = Jr + 2 * Jc
    device = ar.device
    tc = (t - t[0]).contiguous()
    dt = torch.diff(t, prepend=t[:1]).contiguous()
    y, diag = y.contiguous(), diag.contiguous()
    mean = None if mean is None else mean.contiguous()
    extra_diag = None if extra_diag is None else extra_diag.contiguous()
    cs = [c.contiguous() for c in coeffs]
    ll = torch.empty(B, dtype=torch.float64, device=device)
    grads = LogLikelihoodGrads(*(torch.empty_like(c) for c in cs), torch.empty_like(ll),
                               torch.empty((B, N), dtype=torch.float64, device=device))
    if B == 0:
        return ll, grads
    ws = torch.empty(B * N * _record_words(R), dtype=torch.float64, device=device)
    with device_scope(device):
        words = _scratch_entry()(Jr, Jc, B)
        if words < 0:
            raise RuntimeError(f"celerite_grad scratch query failed (code {-words}; Jr={Jr}, Jc={Jc}, B={B})")
        scratch = torch.empty(words, dtype=torch.float64, device=device) if words else None
        rc = _entry()(
            Jr, Jc, tc.data_ptr(), dt.data_ptr(), y.data_ptr(), 1 if y.dim() == 1 else B, diag.data_ptr(),
            *(c.data_ptr() for c in cs), _ptr(mean), _ptr(extra_diag), B, N, ws.data_ptr(), _ptr(scratch),
            ll.data_ptr(), *(g.data_ptr() for g in grads), stream_handle(device),
        )
    if rc != 0:
        raise RuntimeError(f"celerite_grad kernel launch failed (code {rc}; Jr={Jr}, Jc={Jc}, B={B}, N={N})")
    celerite_log_likelihood_and_grad.launches += 1
    return ll, grads


celerite_log_likelihood_and_grad.launches = 0


class _LogLikelihood(torch.autograd.Function):
    """ll (B,) of ``celerite_log_likelihood_and_grad``, differentiable in
    y, mean, extra_diag and the six coefficient tensors."""

    @staticmethod
    def forward(ctx, t, y, diag, mean, extra_diag, *coeffs):
        ll, grads = celerite_log_likelihood_and_grad(coeffs, t, y, diag, mean=mean, extra_diag=extra_diag)
        ctx.save_for_backward(*grads)
        ctx.y_dim = y.dim()
        return ll

    @staticmethod
    def backward(ctx, g_ll):
        *g_coeffs, g_extra, g_r = ctx.saved_tensors
        g_r = g_r * g_ll[:, None]
        need = ctx.needs_input_grad
        g_y = (g_r if ctx.y_dim == 2 else g_r.sum(0)) if need[1] else None
        g_mean = -g_r.sum(1) if need[3] else None
        g_extra = g_extra * g_ll if need[4] else None
        g_coeffs = [g * g_ll[:, None] if n else None for g, n in zip(g_coeffs, need[5:])]
        return (None, g_y, None, g_mean, g_extra, *g_coeffs)


def celerite_loglike_fn(coeffs, t, y, diag, mean=None, extra_diag=None):
    """(B,) log-likelihoods that autograd differentiates through one fused
    value-and-gradient launch (see the module docstring); ``t`` and
    ``diag`` are data and get no gradient."""
    t = torch.as_tensor(t, dtype=torch.float64, device=coeffs[0].device)
    y = torch.as_tensor(y, dtype=torch.float64, device=coeffs[0].device)
    return _LogLikelihood.apply(t, y, diag, mean, extra_diag, *coeffs)

