"""The Kraft+91 tables' kernel (``csrc/kraft_tables.cu``, ``ops/kraft.py``)
and the routing of ``stats`` and ``simulator.noise`` by device.

- On the CPU, ``kraft_tables``, ``kraft_posterior_median`` and
  ``kraft_hpd_interval`` run the plain bisections: bit for bit the plain
  functions' values (``stats.kraft_*_plain``), and no launch.
- The kernel's per-element routines, compiled for the host with the C++
  compiler where there is one (``__CUDACC__`` undefined), against the plain
  version.
- On a CUDA card: ``kraft_tables`` at the benchmark cell's shape (16 counts x
  5,000 backgrounds in [0.15, 0.45]) and on an edge grid (N = 0..15, B from
  1e-6 to 50, N - B on both sides of 0), and the ``stats`` functions at
  given counts, against the plain version on the CPU; one launch for each
  ``KraftNoise`` built on the card, counted by ``ops.kraft.launches`` and in
  the span ``sim.kraft_tables``, with no PyTorch bisection operation.

Tolerance of the kernel against the plain version: rtol 1e-12, atol 1e-13.
Both run the same bisections in float64, but the kernel sums Q(N+1, y) as a
finite Poisson sum where the plain version calls ``gammaincc`` (whose
log-space prefactor carries ~3e-14 relative at y ~ 200), and its log, exp
and lgamma round their last bits in another order; a bisection moves its
root by such a difference over the function's slope, ~1e-14 here (the host
build reads 7.8e-14 absolute at most, on ends of up to ~25).

The ``cuda`` cases also run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kraft_op.py
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from mind_the_gaps_tpu_torch import stats, tracing  # noqa: E402
from mind_the_gaps_tpu_torch.ops import kraft  # noqa: E402
from mind_the_gaps_tpu_torch.simulator.noise import KraftNoise, kraft_tables  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "mind_the_gaps_tpu_torch" / "csrc" / "kraft_tables.cu"
RTOL, ATOL = 1e-12, 1e-13
# N - B on both sides of 0 for N = 0 (B >= 1e-6 > 0), 1 and 15
EDGE_B = np.concatenate([np.logspace(-6, np.log10(50.0), 24),
                         [0.999999, 1.000001, 14.5, 14.999999, 15.000001, 15.5]])


def _cell_backgrounds(n=5000, seed=20):
    return np.random.default_rng(seed).uniform(0.15, 0.45, n)


def _plain_tables(bkg, max_count):
    """Today's tables: the plain functions over the broadcast (N, B) grid."""
    B = torch.as_tensor(np.asarray(bkg, dtype=np.float64))[None, :]
    N = torch.arange(max_count + 1, dtype=torch.float64)[:, None]
    N, B = torch.broadcast_tensors(N, B)
    lo, hi = stats.kraft_hpd_interval_plain(N, B, cl=0.68)
    return stats.kraft_posterior_median_plain(N, B), lo, hi


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and not np.isnan(want).any()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------- #
# the CPU: the plain path, bit for bit
# ---------------------------------------------------------------------- #
def test_cpu_tables_are_the_plain_functions_bit_for_bit():
    before = kraft.launches
    got = kraft_tables(EDGE_B, 15, "cpu")
    for g, w in zip(got, _plain_tables(EDGE_B, 15)):
        assert g.dtype == torch.float64 and g.shape == (16, len(EDGE_B))
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert kraft.launches == before


@pytest.mark.parametrize("shape", ["flat", "broadcast"])
def test_cpu_stats_functions_are_the_plain_functions_bit_for_bit(shape):
    if shape == "flat":
        N = np.repeat([0.0, 3.0, 15.0], len(EDGE_B))
        B = np.tile(EDGE_B, 3)
    else:
        N, B = np.arange(16.0)[:, None], EDGE_B[None, :8]
    Nt, Bt = torch.broadcast_tensors(torch.as_tensor(N, dtype=torch.float64), torch.as_tensor(B, dtype=torch.float64))
    med = stats.kraft_posterior_median(N, B, device="cpu")
    lo, hi = stats.kraft_hpd_interval(torch.as_tensor(N), B, cl=0.68)
    np.testing.assert_array_equal(med.numpy(), stats.kraft_posterior_median_plain(Nt, Bt).numpy())
    lo_p, hi_p = stats.kraft_hpd_interval_plain(Nt, Bt, cl=0.68)
    np.testing.assert_array_equal(lo.numpy(), lo_p.numpy())
    np.testing.assert_array_equal(hi.numpy(), hi_p.numpy())


def test_the_kernel_wrapper_refuses_cpu_data():
    before = kraft.launches
    with pytest.raises(ValueError):
        kraft.kraft_tables(EDGE_B, 15, "cpu")
    N = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError):
        kraft.kraft_quantities(N, N)
    with pytest.raises(ValueError):
        kraft.kraft_quantities(N, N[:2])
    assert kraft.launches == before


# ---------------------------------------------------------------------- #
# the kernel's routines built for the host, against the plain version
# ---------------------------------------------------------------------- #
HARNESS = """
#include "kraft_tables.cu"
extern "C" void kraft_host(const double* counts, const double* background, long long rows, long long cols,
                           double upper, double cl, int level_iters, double* med, double* lo, double* hi) {
  for (long long i = 0; i < rows * cols; ++i)
    kraft::element(i, counts, background, cols, upper, cl, level_iters, med, lo, hi);
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler to build the kernel's routines for the host")
    work = tmp_path_factory.mktemp("kraft_host")
    (work / "harness.cpp").write_text(HARNESS)
    lib = work / "libkraft_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{CSRC.parent}", "-o", str(lib),
                    str(work / "harness.cpp")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).kraft_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_double,
                   ctypes.c_double, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = None

    def run(bkg, rows, counts=None):
        bkg = np.ascontiguousarray(bkg, dtype=np.float64)
        outs = [np.empty((rows, len(bkg))) for _ in range(3)]
        cptr = None if counts is None else np.ascontiguousarray(counts, dtype=np.float64).ctypes.data
        fn(cptr, bkg.ctypes.data, rows, len(bkg), 200.0, 0.68, 60, *(o.ctypes.data for o in outs))
        return outs
    return run


@pytest.mark.parametrize("grid", ["edge", "cell"])
def test_host_build_of_the_kernel_matches_the_plain_tables(host_kernel, grid):
    bkg = EDGE_B if grid == "edge" else _cell_backgrounds(60)
    for got, want in zip(host_kernel(bkg, 16), _plain_tables(bkg, 15)):
        _close(got, want.numpy())


def test_host_build_reads_nan_at_counts_that_are_not_whole(host_kernel):
    counts = np.array([2.0, 2.5, -1.0, 7.0])
    med, lo, hi = host_kernel(np.full(4, 0.3), 1, counts)
    for out in (med, lo, hi):
        assert np.isnan(out[0, [1, 2]]).all() and np.isfinite(out[0, [0, 3]]).all()
    _close(med[0, [0, 3]], stats.kraft_posterior_median([2.0, 7.0], [0.3, 0.3], device="cpu").numpy())


# ---------------------------------------------------------------------- #
# on a CUDA card: the kernel against the plain version
# ---------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["cell", "edge"])
def test_card_tables_match_the_plain_tables(cuda, grid):
    bkg = _cell_backgrounds() if grid == "cell" else EDGE_B
    before = kraft.launches
    got = kraft_tables(bkg, 15, cuda)
    assert kraft.launches == before + 1
    for g, w in zip(got, _plain_tables(bkg, 15)):
        assert g.device.type == "cuda" and g.dtype == torch.float64 and g.shape == (16, len(bkg))
        _close(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
def test_card_stats_functions_match_the_plain_functions(cuda):
    N = torch.as_tensor(np.repeat([0.0, 15.0], len(EDGE_B)), device=cuda).reshape(2, -1)
    B = torch.as_tensor(np.tile(EDGE_B, 2), device=cuda).reshape(2, -1)
    before = kraft.launches
    med = stats.kraft_posterior_median(N, B)
    lo, hi = stats.kraft_hpd_interval(N, B, cl=0.68)
    assert kraft.launches == before + 2  # each its part, one launch
    lo_p, hi_p = stats.kraft_hpd_interval_plain(N.cpu(), B.cpu(), cl=0.68)
    for got, want in ((med, stats.kraft_posterior_median_plain(N.cpu(), B.cpu())), (lo, lo_p), (hi, hi_p)):
        assert got.shape == (2, len(EDGE_B)) and got.device.type == "cuda"
        _close(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_kraft_noise_on_the_card_launches_the_kernel_once(cuda):
    bkg = _cell_backgrounds(500)
    exposures = np.full(500, 1.5)
    before = kraft.launches
    KraftNoise(exposures, bkg, np.full(500, 0.02), device=cuda)
    assert kraft.launches == before + 1
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        noise = KraftNoise(exposures, bkg, np.full(500, 0.02), device=cuda)
        torch.cuda.synchronize()
    assert kraft.launches == before + 2
    spans = [s for s in tracing.spans() if s.name == "sim.kraft_tables"]
    assert len(spans) == 1 and spans[0].counts == {"cells": 16 * 500, "launches": 1}
    names = {e.name for e in prof.events()}
    assert not any("gammaincc" in n or n == "aten::where" for n in names), sorted(names)
    for got, want in zip((noise.median_table, noise.lo_table, noise.hi_table), _plain_tables(bkg, 15)):
        _close(got.cpu().numpy(), want.numpy())
