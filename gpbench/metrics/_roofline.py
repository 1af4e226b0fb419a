"""The celerite kernel's share of its roofline in the traced call: the least
time the card could take for the likelihoods its launches computed
(``roofline.launch_bound_s``: B from the driver's ``launch_shape``, N from
the configuration, dtype and widths from each kernel's template
arguments) over their device time, in %.  None where no launch was traced
or a launch's widths cannot be read."""
from gpbench.roofline import launch_bound_s
from gpbench.run import load_module
from gpbench.trace import celerite_launches


def share(ctx):
    traced = ctx.traced
    launches = celerite_launches(traced.trace.device) if traced is not None else []
    if not launches or any(jr is None for _, jr, _, _ in launches):
        return None
    driver = load_module(ctx.dirs, "drivers", ctx.traffic["driver"])
    bound = 0.0
    for dtype, jr, jc, _ in launches:
        B, cols = driver.launch_shape(ctx, dtype, jr, jc)
        bound += launch_bound_s(B, ctx.config["n_points"], jr, jc, cols, dtype)[0]
    return 100.0 * bound / sum(s for _, _, _, s in launches)
