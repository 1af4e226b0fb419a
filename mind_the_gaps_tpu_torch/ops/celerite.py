"""The batched celerite log-likelihood op: CUDA kernel and plain version.

``celerite_log_likelihood`` has the semantics of the JAX package's
``pallas_log_likelihood`` (``mind_the_gaps_tpu/ops/pallas_celerite.py``)
without its TPU tiling options: (B,) values of

    log N(y_b | mean_b, K(theta_b) + diag_b + extra_diag_b)

for coefficients of shape (B, J), with the data layouts of
``solver.batched`` (shared (N,), grouped (G, N) with ``repeats`` elements
per group, per-element (B, N)).  ``dt`` is formed from ``t`` in float64
and then cast to the working dtype (float32 or float64, that of the
coefficients).

``sym=False`` selects the kernel body that keeps the state S as the full
R x R instead of packed (the JAX entry's dense-S body); both compute the
same function.

A CPU tensor goes to the plain PyTorch version
(``celerite_log_likelihood_plain``, the recursion of ``solver.batched``)
whatever ``sym``.  A CUDA tensor launches ``csrc/celerite_loglike.cu`` on
the current stream, or raises: there is no fallback.
``celerite_log_likelihood.launches`` counts the launches of the packed
body, ``.dense_launches`` those of the dense-S body.
"""
from __future__ import annotations

import ctypes

import torch

from mind_the_gaps_tpu_torch.ops._build import load_library
from mind_the_gaps_tpu_torch.solver.batched import batched_log_likelihood, check_layout

__all__ = ["celerite_log_likelihood", "celerite_log_likelihood_plain"]

celerite_log_likelihood_plain = batched_log_likelihood

_ENTRY = {torch.float32: "celerite_loglike_f32", torch.float64: "celerite_loglike_f64"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _I, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P]


def _entry(dtype):
    fn = getattr(load_library("celerite_loglike"), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _batch_last(x):
    """(N,) stays; (G, N) becomes the contiguous (N, G) the kernel reads."""
    return (x if x.dim() == 1 else x.T).contiguous()


def _ptr(x):
    return None if x is None else x.data_ptr()


def celerite_log_likelihood(coeffs, t, y, diag, mean=None, repeats: int = 1, extra_diag=None, sym: bool = True):
    """(B,) log-likelihoods; -inf where K(theta_b) is not positive definite."""
    ar = coeffs[0]
    if ar.device.type == "cpu":
        return celerite_log_likelihood_plain(
            coeffs, t, y, diag, mean=mean, repeats=repeats, extra_diag=extra_diag
        )
    if ar.device.type != "cuda":
        raise ValueError(f"celerite_log_likelihood runs on CPU or CUDA tensors, not {ar.device}")
    dtype, device = ar.dtype, ar.device
    if dtype not in _ENTRY:
        raise TypeError(f"celerite_log_likelihood takes float32 or float64, not {dtype}")
    B, Jr = ar.shape
    Jc = coeffs[2].shape[1]
    for name, x, j in zip(("ar", "cr", "ac", "bc", "cc", "dc"), coeffs, (Jr, Jr, Jc, Jc, Jc, Jc)):
        if x.device != device or x.dtype != dtype or tuple(x.shape) != (B, j):
            raise ValueError(f"coefficient {name} must be a ({B}, {j}) {dtype} tensor on {device}")
    if not 1 <= Jr + 2 * Jc <= 6:
        raise ValueError(f"the kernel takes 1 <= Jr + 2 Jc <= 6, got Jr={Jr}, Jc={Jc}")

    t64 = torch.as_tensor(t, dtype=torch.float64, device=device)
    N = t64.shape[0]
    dt = torch.diff(t64, prepend=t64[:1]).to(dtype).contiguous()
    y = torch.as_tensor(y, dtype=dtype, device=device)
    diag = torch.as_tensor(diag, dtype=dtype, device=device)
    mean = None if mean is None else torch.as_tensor(mean, dtype=dtype, device=device).contiguous()
    extra_diag = (
        None if extra_diag is None
        else torch.as_tensor(extra_diag, dtype=dtype, device=device).contiguous()
    )
    check_layout(B, N, y, diag, repeats, mean, extra_diag)
    y_cols = 1 if y.dim() == 1 else y.shape[0]
    d_cols = 1 if diag.dim() == 1 else diag.shape[0]
    y_t, d_t = _batch_last(y), _batch_last(diag)
    cs = [c.contiguous() for c in coeffs]

    out = torch.empty(B, dtype=dtype, device=device)
    if B == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _entry(dtype)(
            Jr, Jc, 0 if sym else 1, dt.data_ptr(), y_t.data_ptr(), y_cols, d_t.data_ptr(), d_cols,
            *(c.data_ptr() for c in cs), _ptr(mean), _ptr(extra_diag),
            B, N, repeats, out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"celerite_loglike kernel launch failed (code {rc})")
    if sym:
        celerite_log_likelihood.launches += 1
    else:
        celerite_log_likelihood.dense_launches += 1
    return out


celerite_log_likelihood.launches = 0
celerite_log_likelihood.dense_launches = 0
