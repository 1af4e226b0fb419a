"""The celerite kernel's share of its roofline in a traced observed call
(``metrics/_roofline.py``), against the H100 SXM data sheet's peaks."""
from gpbench.run import load_module


def read(ctx):
    return load_module(ctx.dirs, "metrics", "_roofline").share(ctx)
