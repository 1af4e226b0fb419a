"""A latency probe of dependent multiply-add chains: CUDA kernel and plain
version.

    python -m mind_the_gaps_tpu_torch.ops.fma_probe [--iters 20000]

``fma_chain(x, iters)``: for each element of ``x`` (float32 or float64, any
shape), ``a = x; b = a * 1.000001 + 0.5``, then ``iters`` times
``a = a * 0.999999 + b; b = b * 1.000001 - a * 1e-7``; returns ``a + b``.
It is the recurrence of the JAX package's Pallas probe
(``benchmarks/experiments/sublane_probe.py::make``), which asked how a TPU
lays out 1-D vectors.  On the card it measures the latency of one
dependent multiply-add, the quantity that bounds the celerite kernels'
chains of dependent steps (``csrc/fma_chain.cu`` says why).

A CPU tensor goes to the plain version (``fma_chain_plain``: the same loop
in torch, elementwise, unfused).  A CUDA tensor launches
``csrc/fma_chain.cu`` on the current stream, or raises: there is no
fallback.  ``fma_chain.launches`` counts the launches.  The kernel fuses
each multiply-add, the plain version rounds twice, and the recurrence is
nearly a rotation, so in float32 the two drift apart by about
``iters * 6e-8`` relative: hold the float32 kernel against the plain version
in float64.

``probe`` times the kernel with CUDA events at the JAX script's element
counts (2048 and 16384) and at counts that give each SM 1, 4, 16 or 32 warps
(one block an SM), and reports nanoseconds an iteration; the chain is two
dependent FMAs an iteration, so where the SM's four schedulers each hold
at most one warp an iteration takes two FMA latencies.
"""
from __future__ import annotations

import argparse
import ctypes
import functools

import torch

from mind_the_gaps_tpu_torch.ops._build import device_scope, load_library, stream_handle

__all__ = ["fma_chain", "fma_chain_plain", "block_threads", "probe", "fma_latency_ns", "ITERS", "WARPS_PER_SM"]

ITERS = 20000  # sublane_probe.py's iteration count
JAX_COUNTS = (2048, 16384)  # sublane_probe.py's element counts
WARPS_PER_SM = (1, 4, 16, 32)  # the card-filling counts: warps an SM
_ENTRY = {torch.float32: "fma_chain_f32", torch.float64: "fma_chain_f64"}


def fma_chain_plain(x, iters: int):
    """The plain version: the recurrence in torch, in ``x``'s dtype."""
    a = x
    b = a * 1.000001 + 0.5
    for _ in range(iters):
        a = a * 0.999999 + b
        b = b * 1.000001 - a * 1e-7
    return a + b


def block_threads(n: int, sm_count: int) -> int:
    """Threads a block that spread ``n`` elements one block an SM: the
    elements an SM, rounded up to a warp, between 32 and 1024."""
    per_sm = -(-n // sm_count)
    return int(min(1024, max(32, -(-per_sm // 32) * 32)))


@functools.lru_cache(maxsize=None)
def _entry(dtype):
    fn = getattr(load_library("fma_chain"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fma_chain(x, iters: int):
    """The recurrence on every element of ``x``; see the module docstring.
    The kernel's block is ``block_threads`` of the element count."""
    if x.dtype not in _ENTRY:
        raise TypeError(f"fma_chain takes float32 or float64, not {x.dtype}")
    if iters < 0:
        raise ValueError("iters must be >= 0")
    if x.device.type == "cpu":
        return fma_chain_plain(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"fma_chain runs on CPU or CUDA tensors, not {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    threads = block_threads(n, torch.cuda.get_device_properties(x.device).multi_processor_count)
    with device_scope(x.device):
        rc = _entry(x.dtype)(x.data_ptr(), out.data_ptr(), n, int(iters), int(threads), stream_handle(x.device))
    if rc != 0:
        raise RuntimeError(f"fma_chain kernel launch failed (code {rc}; n={n}, threads={threads})")
    fma_chain.launches += 1
    return out


fma_chain.launches = 0


def probe(iters: int = ITERS, reps: int = 10, device="cuda"):
    """Nanoseconds an iteration of the kernel on ``device`` (a card), for
    float32 and float64 at the JAX script's element counts and at 1, 4, 16
    and 32 warps an SM: a list of dicts (dtype, n, threads, warps_per_sm,
    ms, ns_per_iter).  Each time is the mean of ``reps`` launches after one
    warm-up launch, from CUDA events."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("probe times the kernel on a CUDA card")
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    counts = list(JAX_COUNTS) + [w * 32 * sm_count for w in WARPS_PER_SM]
    gen = torch.Generator(device).manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.float64):
        for n in counts:
            x = torch.randn(n, generator=gen, dtype=dtype, device=device)
            threads = block_threads(n, sm_count)
            fma_chain(x, iters)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fma_chain(x, iters)
            end.record()
            torch.cuda.synchronize(device)
            ms = start.elapsed_time(end) / reps
            blocks = -(-n // threads)
            rows.append(dict(dtype=str(dtype).replace("torch.", ""), n=n, threads=threads,
                             warps_per_sm=threads // 32 * -(-blocks // sm_count), ms=ms,
                             ns_per_iter=ms * 1e6 / max(iters, 1)))
    return rows


def fma_latency_ns(rows):
    """{dtype: nanoseconds of one dependent multiply-add} from ``probe``'s
    rows: half an iteration at 1 and 4 warps an SM (at most one warp a
    scheduler), the least of those rows."""
    latency = {}
    for r in rows:
        if r["warps_per_sm"] in (1, 4):
            latency.setdefault(r["dtype"], []).append(r["ns_per_iter"] / 2)
    return {k: min(v) for k, v in latency.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Latency of dependent multiply-add chains on the card.")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    rows = probe(args.iters, args.reps)
    print(torch.cuda.get_device_name(0))
    for r in rows:
        print(f"{r['dtype']:8s} n={r['n']:7d} threads={r['threads']:4d} warps/SM={r['warps_per_sm']:2d}  "
              f"{r['ms']:8.3f} ms  {r['ns_per_iter']:7.3f} ns/iter")
    return rows


if __name__ == "__main__":
    main()
