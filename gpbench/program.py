"""What the harness builds with the port: its lightcurve and kernels, from
a configuration and the run's data (``scenario``)."""
from __future__ import annotations

from gpbench.scenario import lightcurve_arrays

__all__ = ["observed", "kernel"]


def observed(ctx):
    """(times, y, dy, the port's GappyLightcurve) of the run's data."""
    from mind_the_gaps_tpu_torch.lightcurves import GappyLightcurve

    data = ctx.config["data"]
    t, y, dy = lightcurve_arrays(data, ctx.config["n_points"], ctx.seed)
    return t, y, dy, GappyLightcurve(t, y, dy, exposures=data["exposure"])


def kernel(spec: dict):
    """The port's kernel for a model of the configuration: the sum of its
    terms at their stated values and bounds."""
    from mind_the_gaps_tpu_torch import kernels

    terms = [getattr(kernels, term["kind"])(*term["values"], bounds=[tuple(b) for b in term["bounds"]])
             for term in spec["terms"]]
    total = terms[0]
    for term in terms[1:]:
        total = total + term
    return total

