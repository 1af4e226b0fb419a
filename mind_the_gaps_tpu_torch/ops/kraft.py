"""The Kraft+91 posterior median and minimal interval on the card: the
wrapper of ``csrc/kraft_tables.cu``.

``kraft_tables(background_counts, max_count, device)`` builds the
(max_count + 1, n) float64 tables (median, HPD lo, HPD hi) of N = 0..max_count
counts over each bin's background in one launch; ``kraft_quantities(N, B,
...)`` computes the median, the interval or both at given float64 CUDA
tensors of counts and backgrounds (one shape), in one launch.  Both run on
the current stream of the data's card, and raise rather than fall back: the
plain version, the same bisections as eager PyTorch, is
``stats.kraft_posterior_median_plain`` / ``kraft_hpd_interval_plain``, and
``stats`` and ``simulator.noise.kraft_tables`` route CPU tensors there.
``launches`` counts the kernel's launches.

The kernel runs the plain version's bisections with its iteration counts
(70 inner steps, 60 on the level), brackets and tests, in float64; it
differs from the plain version by the last bits of its transcendentals and
of Q(N+1, y), which it sums as the finite Poisson sum of a whole N (a count
that is not a whole number >= 0 reads NaN).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mind_the_gaps_tpu_torch.ops._build import device_scope, load_library, stream_handle

__all__ = ["kraft_tables", "kraft_quantities"]

launches = 0


@functools.lru_cache(maxsize=None)
def _entry():
    fn = load_library("kraft_tables").kraft_tables_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_double,
                   ctypes.c_double, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(counts, background, rows: int, cols: int, upper: float, cl: float, level_iters: int, median: bool,
            hpd: bool):
    """Launch the kernel on a (rows, cols) grid; returns the requested
    (rows, cols) tables, the median first.  An empty grid launches
    nothing."""
    global launches
    device = background.device
    outs = [torch.empty((rows, cols), dtype=torch.float64, device=device) for _ in range(int(median) + 2 * int(hpd))]
    if rows * cols == 0:
        return outs
    med = outs[0] if median else None
    lo, hi = (outs[-2], outs[-1]) if hpd else (None, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with device_scope(device):
        rc = _entry()(ptr(counts), background.data_ptr(), rows, cols, float(upper), float(cl), int(level_iters),
                      ptr(med), ptr(lo), ptr(hi), stream_handle(device))
    if rc != 0:
        raise RuntimeError(f"kraft_tables kernel launch failed (code {rc}; rows={rows}, cols={cols})")
    launches += 1
    return outs


def _check_device(device):
    if device.type != "cuda":
        raise ValueError(f"the Kraft kernel runs on a CUDA card, not {device}")


def kraft_tables(background_counts, max_count: int, device="cuda"):
    """(median, hpd lo, hpd hi) float64 tables of shape (max_count + 1, n)
    on ``device``, a card: row N, column i holds the Kraft quantities (cl
    0.68) at N counts and bin i's background (``background_counts``: n
    numbers, an array or a tensor); one launch."""
    device = torch.device(device)
    _check_device(device)
    background = torch.as_tensor(background_counts, dtype=torch.float64, device=device).reshape(-1)
    return tuple(_launch(None, background, int(max_count) + 1, background.numel(), 200.0, 0.68, 60, True, True))


def kraft_quantities(N, B, upper: float = 200.0, cl: float = 0.68, level_iters: int = 60,
                     median: bool = True, hpd: bool = True):
    """The Kraft median and/or interval ends at float64 CUDA tensors ``N``
    (whole counts) and ``B`` of one shape: a list of tensors of that shape,
    the median first, then lo and hi; one launch."""
    if N.shape != B.shape or N.dtype != torch.float64 or B.dtype != torch.float64 or N.device != B.device:
        raise ValueError("N and B must be float64 tensors of one shape on one device")
    _check_device(N.device)
    outs = _launch(N.contiguous().reshape(-1), B.contiguous().reshape(-1), 1, N.numel(), upper, cl, level_iters,
                   median, hpd)
    return [x.reshape(N.shape) for x in outs]
