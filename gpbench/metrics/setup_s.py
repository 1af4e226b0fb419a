"""Seconds from the start of the process to the window's start: imports, CUDA
initialisation, the kernels' libraries, the data, the cell's set-up work and
the warm-up (host clock).  Over ranks: rank 0's, from the launcher's start
(the ranks' start is the user's to pay)."""

OVER_RANKS = "rank0"


def read(ctx):
    return ctx.setup_s
