"""Seconds from the start of the process to the window's start: imports,
CUDA initialisation, the kernels' libraries, the data, the cell's set-up
work and the warm-up (host clock)."""


def read(ctx):
    return ctx.setup_s
