"""The celerite kernel's share of its roofline in a traced bootstrap call
(``metrics/_roofline.py``), against the H100 SXM data sheet's peaks.  Over
ranks: the mean of each card's share (a rank's launches have its own rows,
``launch_shape``)."""
from gpbench.run import load_module


def read(ctx):
    return load_module(ctx.dirs, "metrics", "_roofline").share(ctx)
