"""Operation and byte counts of the celerite likelihood, and the card's peaks.

The count is of the work the likelihoods need, not of the loops of any
kernel: one evaluation of the packed (symmetric-S) celerite recursion of
Foreman-Mackey et al. (2017) at N points and width R = Jr + 2 Jc takes
N - 1 steps of ``step_flops(jr, jc)`` floating-point operations, and reads
each input once and writes its value once.

Convention, matched to the peaks it is divided by: an add, a subtract and
a multiply are one operation each, and a fused multiply-add is two (the
data sheet's FP32 and FP64 rates count an FMA as two FLOPs); a division,
exp, log, sin and cos count as one each (the least they could cost).  The
byte count is the inputs the launch needs (the gaps, each data column it
reads, the coefficients, the means) read once and its values written once.
"""
from __future__ import annotations

__all__ = ["PEAK_FLOPS", "HBM_BYTES_PER_S", "step_flops", "launch_bound_s"]

# NVIDIA H100 SXM5 80 GB data sheet, dense, at the 700 W power limit:
# FP32 and FP64 outside the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "float64": 8}


def step_flops(jr: int, jc: int) -> int:
    """Operations of one step of one likelihood of the packed recursion."""
    R = jr + 2 * jc
    packed = R * (R + 1) // 2
    row = [1] * jr + [3] * (2 * jc)  # a row of the block-diagonal P times a vector
    return (
        2 * jr + 7 * jc  # propagators: c h, exp; c h, d h, exp, sin, cos, two products
        + R + 2 * packed  # M = S + (D w) w^T, packed: D w, then a multiply-add an entry
        + R * sum(row)  # T = P M
        + sum(sum(row[i:]) for i in range(R))  # S = T P^T, packed
        + R * (2 * R - 1)  # S u
        + 2 * R  # D = A - u^T (S u)
        + 1 + 2 * R  # w = (v - S u) / D: a reciprocal, R subtracts, R products
        + 2 * R + sum(row)  # f = P (f + w z)
        + 2 * R  # z = r - u^T f
        + 5  # log D, z * z / D (two), one add into each of the two sums
    )


def launch_bound_s(B: int, N: int, jr: int, jc: int, cols: int, dtype: str):
    """(seconds, what bounds it) of the least time one launch of B
    likelihoods could take on the card: the larger of its operations over
    the peak and its bytes over the bandwidth.  ``cols``: the data columns
    (y and its variances) the launch reads: 1 shared, B / repeats grouped,
    B per-element."""
    item = ITEMSIZE[dtype]
    n_bytes = item * (N + 2 * N * cols + B * (2 * jr + 4 * jc) + 3 * B)
    t_ops = B * (N - 1) * step_flops(jr, jc) / PEAK_FLOPS[dtype]
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
