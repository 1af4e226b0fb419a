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
whatever ``sym``.  A CUDA tensor launches the kernel of
``csrc/celerite_loglike.cuh`` (built from ``celerite_loglike_f32.cu`` /
``_f64.cu``) on the current stream, or raises: there is no fallback.
``celerite_log_likelihood.launches`` counts the launches of the packed
body, ``.dense_launches`` those of the dense-S body, and
``.team_launches[L]`` the packed launches with L lanes per likelihood.

Layouts (``team_size``), L lanes per likelihood, chosen from the
likelihoods an SM at crossovers measured on an H100 (PERF.md section 6):
a team of 32 lanes (a warp) up to ``WARP_TEAM_MAX_PER_SM``, where a
chain's latency sets the time; a team of 8 lanes above it; one thread a
likelihood (L = 1) from ``LANE_LAYOUT_MIN_PER_SM``, where the card is
bound by instruction issue and a team's chain phase leaves all but one of
its lanes idle.  The kernel's compile-time bodies (packed and dense-S)
cover the (Jr, Jc) of ``STATIC_WIDTHS``; any other R >= 1 runs its
runtime-R body, which takes the warp layout only, and the dense-S body
keeps the teams (``layouts``).  ``team=`` pins a layout: the shards of a
sharded batch (``parallel``) launch with the layout of the whole batch
(``batch_team``), so that each row gets the bits it gets there.
``_launch`` takes the layout as an argument, for tests that hold each
layout against the plain version.  A caller that passes the same data at
every call (the refits' closure, ``solver.batched.batched_log_prob_fn``)
prepares it once (``_prepare``: ``dt`` and the batch-last copies) and
launches through ``_log_likelihood_prepared``, which does no device work
of its own before the kernel and so can be captured in a CUDA graph.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mind_the_gaps_tpu_torch.ops._build import device_scope, load_library, stream_handle
from mind_the_gaps_tpu_torch.solver.batched import batched_log_likelihood, check_layout

__all__ = ["celerite_log_likelihood", "celerite_log_likelihood_plain", "team_size", "batch_team", "layouts",
           "STATIC_WIDTHS", "WARP_TEAM_MAX_PER_SM", "LANE_LAYOUT_MIN_PER_SM", "TEAMS", "check_coefficients"]

celerite_log_likelihood_plain = batched_log_likelihood

_ENTRY = {torch.float32: "celerite_loglike_f32", torch.float64: "celerite_loglike_f64"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _I, _I, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P]

# (Jr, Jc) with a compile-time body (CELERITE_STATIC_PAIRS in the .cuh):
# every R = Jr + 2 Jc <= 6, and the DRW / Lorentzian sums at R = 7 and 8.
STATIC_WIDTHS = frozenset(
    [(jr, jc) for jc in range(4) for jr in range(7) if 1 <= jr + 2 * jc <= 6] + [(1, 3), (0, 4), (2, 3)]
)
# Likelihoods per SM up to which a warp (32 lanes) serves each likelihood;
# above it 8 lanes do.  Set from chip_smoke.py's layout sweep on the H100
# (PERF.md section 6): at R=3, f32 and f64, L=32 was the faster up to 4 per
# SM and L=8 from 6 per SM.
WARP_TEAM_MAX_PER_SM = 4
# Likelihoods per SM from which one thread serves each likelihood (the
# packed body only).  Set from ``python -m
# mind_the_gaps_tpu_torch.ops.layout_sweep`` on the H100 (PERF.md section 6):
# at R=3, float32 grouped (the bootstrap's), L=8 was the faster up to 93 per
# SM and L=1 from 110; float64 shared crossed lower (between 64 and 80).
LANE_LAYOUT_MIN_PER_SM = 100
TEAMS = (32, 8, 1)  # the layouts: lanes per likelihood


def layouts(jr: int, jc: int, sym: bool = True) -> tuple:
    """The layouts the kernel has for a body: all of TEAMS for the packed
    body at a compile-time width, the teams (32, 8) for its dense-S body,
    the warp (32) for the runtime-R body."""
    if (jr, jc) not in STATIC_WIDTHS:
        return (32,)
    return TEAMS if sym else (32, 8)


def team_size(B: int, sm_count: int, jr: int, jc: int, sym: bool = True) -> int:
    """Lanes per likelihood from the batch per SM: 32 up to
    WARP_TEAM_MAX_PER_SM, 1 from LANE_LAYOUT_MIN_PER_SM, else 8; only a
    layout of ``layouts(jr, jc, sym)``."""
    have = layouts(jr, jc, sym)
    if B <= WARP_TEAM_MAX_PER_SM * sm_count or len(have) == 1:
        return 32
    if B >= LANE_LAYOUT_MIN_PER_SM * sm_count and 1 in have:
        return 1
    return 8


_SM_COUNT: dict = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def batch_team(kernel, B: int, device):
    """The layout (lanes per likelihood) of a launch of ``B`` likelihoods of
    ``kernel`` (a term or term sum) on ``device``; None off a card, where
    there is no layout."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    c = kernel.coefficients()
    return team_size(B, _sm_count(device), c.ar.shape[-1], c.ac.shape[-1])


@functools.lru_cache(maxsize=None)
def _entry(dtype):
    fn = getattr(load_library(_ENTRY[dtype]), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _batch_last(x):
    """(N,) stays; (G, N) becomes the contiguous (N, G) the kernel reads."""
    return (x if x.dim() == 1 else x.T).contiguous()


def _ptr(x):
    return None if x is None else x.data_ptr()


def check_coefficients(coeffs):
    """(B, Jr, Jc) of coefficients the kernel takes: six tensors of one
    float dtype and device, (B, Jr) real and (B, Jc) complex, R >= 1;
    raises otherwise.  Any R = Jr + 2 Jc >= 1 has a body."""
    ar = coeffs[0]
    dtype, device = ar.dtype, ar.device
    if dtype not in _ENTRY:
        raise TypeError(f"celerite_log_likelihood takes float32 or float64, not {dtype}")
    B, Jr = ar.shape
    Jc = coeffs[2].shape[1]
    for name, x, j in zip(("ar", "cr", "ac", "bc", "cc", "dc"), coeffs, (Jr, Jr, Jc, Jc, Jc, Jc)):
        if x.device != device or x.dtype != dtype or tuple(x.shape) != (B, j):
            raise ValueError(f"coefficient {name} must be a ({B}, {j}) {dtype} tensor on {device}")
    if Jr + 2 * Jc == 0:
        raise ValueError("the kernel needs at least one celerite term (R = Jr + 2 Jc >= 1)")
    return B, Jr, Jc


def celerite_log_likelihood(coeffs, t, y, diag, mean=None, repeats: int = 1, extra_diag=None, sym: bool = True,
                            team=None):
    """(B,) log-likelihoods; -inf where K(theta_b) is not positive definite.
    ``team``: the kernel's lanes per likelihood (one of ``layouts``), by default
    ``team_size``'s for this batch; the plain version has no layout and
    ignores it."""
    ar = coeffs[0]
    if ar.device.type == "cpu":
        return celerite_log_likelihood_plain(
            coeffs, t, y, diag, mean=mean, repeats=repeats, extra_diag=extra_diag
        )
    return _launch(coeffs, t, y, diag, mean, repeats, extra_diag, sym, team=team)


class _Data(NamedTuple):
    """The data of launches that share it, made once (``_prepare``): the
    float64 times and ``y`` / ``diag`` in the working dtype as given, the
    gaps ``dt`` (float64 differences cast to the dtype) and the batch-last
    copies the kernel reads."""

    t: torch.Tensor
    y: torch.Tensor
    diag: torch.Tensor
    dt: torch.Tensor
    y_t: torch.Tensor
    d_t: torch.Tensor


def _prepare(t, y, diag, dtype, device) -> _Data:
    """``_Data`` of ``t`` (N,), ``y`` and ``diag`` ((N,) or (G, N)) in
    ``dtype`` on ``device``."""
    t64 = torch.as_tensor(t, dtype=torch.float64, device=device)
    dt = torch.diff(t64, prepend=t64[:1]).to(dtype).contiguous()
    y = torch.as_tensor(y, dtype=dtype, device=device)
    diag = torch.as_tensor(diag, dtype=dtype, device=device)
    return _Data(t64, y, diag, dt, _batch_last(y), _batch_last(diag))


def _checked(coeffs, sym: bool, team):
    """``check_coefficients``, then the layout and the device of a launch;
    (B, Jr, Jc)."""
    B, Jr, Jc = check_coefficients(coeffs)
    if team is not None and team not in layouts(Jr, Jc, sym):
        raise ValueError(f"team must be one of {layouts(Jr, Jc, sym)} lanes for this body (Jr={Jr}, Jc={Jc}, "
                         f"sym={sym}), got {team}")
    if coeffs[0].device.type != "cuda":
        raise ValueError(f"celerite_log_likelihood runs on CPU or CUDA tensors, not {coeffs[0].device}")
    return B, Jr, Jc


def _log_likelihood_prepared(coeffs, data: _Data, mean=None, repeats: int = 1, extra_diag=None, team=None):
    """``celerite_log_likelihood`` (packed body) on data made once by
    ``_prepare`` in the coefficients' dtype and device: a caller that passes
    the same data at every call, as the refits' closure does, builds ``dt``
    and the batch-last copies once and not at every launch."""
    if coeffs[0].device.type == "cpu":
        return celerite_log_likelihood_plain(coeffs, data.t, data.y, data.diag, mean=mean, repeats=repeats,
                                             extra_diag=extra_diag)
    return _launch_prepared(coeffs, data, mean, repeats, extra_diag, team=team)


def _launch(coeffs, t, y, diag, mean=None, repeats: int = 1, extra_diag=None, sym: bool = True, team=None):
    """The kernel on CUDA tensors, with ``team`` lanes per likelihood (one
    of the body's ``layouts``), or ``team_size``'s layout when it is None."""
    ar = coeffs[0]
    _checked(coeffs, sym, team)
    return _launch_prepared(coeffs, _prepare(t, y, diag, ar.dtype, ar.device), mean, repeats, extra_diag, sym, team)


def _launch_prepared(coeffs, data: _Data, mean=None, repeats: int = 1, extra_diag=None, sym: bool = True,
                     team=None):
    """``_launch`` on data made by ``_prepare``."""
    B, Jr, Jc = _checked(coeffs, sym, team)
    ar = coeffs[0]
    dtype, device = ar.dtype, ar.device
    if data.dt.dtype != dtype or data.dt.device != device:
        raise ValueError(f"data prepared in {data.dt.dtype} on {data.dt.device}, coefficients {dtype} on {device}")
    N = data.dt.shape[0]
    mean = None if mean is None else torch.as_tensor(mean, dtype=dtype, device=device).contiguous()
    extra_diag = (
        None if extra_diag is None
        else torch.as_tensor(extra_diag, dtype=dtype, device=device).contiguous()
    )
    check_layout(B, N, data.y, data.diag, repeats, mean, extra_diag)
    y_cols = 1 if data.y.dim() == 1 else data.y.shape[0]
    d_cols = 1 if data.diag.dim() == 1 else data.diag.shape[0]
    cs = [c.contiguous() for c in coeffs]

    out = torch.empty(B, dtype=dtype, device=device)
    if B == 0:
        return out
    if team is None:
        team = team_size(B, _sm_count(device), Jr, Jc, sym)
    with device_scope(device):
        stream = stream_handle(device)
        rc = _entry(dtype)(
            Jr, Jc, 0 if sym else 1, team, data.dt.data_ptr(), data.y_t.data_ptr(), y_cols, data.d_t.data_ptr(),
            d_cols, *(c.data_ptr() for c in cs), _ptr(mean), _ptr(extra_diag),
            B, N, repeats, out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"celerite_loglike kernel launch failed (code {rc}; Jr={Jr}, Jc={Jc}, team={team})")
    if sym:
        celerite_log_likelihood.launches += 1
        celerite_log_likelihood.team_launches[team] += 1
    else:
        celerite_log_likelihood.dense_launches += 1
    return out


celerite_log_likelihood.launches = 0
celerite_log_likelihood.dense_launches = 0
celerite_log_likelihood.team_launches = dict.fromkeys(TEAMS, 0)
