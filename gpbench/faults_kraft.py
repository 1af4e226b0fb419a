"""Faults planted in the Kraft noise of the timed path, for the tests and for
the readings that set ``faint.bootstrap``'s limits:

    python -m gpbench.faults_kraft <fault> --workload faint.bootstrap --seeds 1,2,3

plants ``<fault>`` in the process, then runs ``python -m gpbench.readings``
with the arguments that follow it.  None is used by a benchmark run.
"""
from __future__ import annotations

import sys


def kraft_left_out():
    """``KraftNoise.kraft_step`` returns its inputs: every bin keeps its
    Poisson answer."""
    from mind_the_gaps_tpu_torch.simulator import noise

    noise.KraftNoise.kraft_step = lambda self, net_rates, dy: (net_rates, dy)


def threshold_10():
    """Kraft noise on the bins under 10 counts, in place of the configured
    threshold."""
    from mind_the_gaps_tpu_torch.simulator import noise

    init = noise.KraftNoise.__init__

    def patched(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.kraft_counts = 10

    noise.KraftNoise.__init__ = patched


def equal_tailed():
    """The Kraft tables' interval ends at the posterior's 16% and 84%
    quantiles, in place of the minimal interval's."""
    import numpy as np
    import torch

    from mind_the_gaps_tpu_torch import stats
    from mind_the_gaps_tpu_torch.simulator import noise

    tables = noise.kraft_tables

    def patched(background_counts, max_count, device="cuda"):
        median, _, _ = tables(background_counts, max_count, device)
        B = torch.as_tensor(np.asarray(background_counts, dtype=np.float64), device=median.device)[None, :]
        N = torch.arange(max_count + 1, dtype=torch.float64, device=median.device)[:, None]
        N, B = torch.broadcast_tensors(N, B)
        post = stats._KraftPosterior(N, B)
        lo, hi = (stats._bisect(lambda x: post.cdf(x) - q, torch.zeros_like(N), torch.full_like(N, 200.0))
                  for q in (0.16, 0.84))
        return median, lo, hi

    noise.kraft_tables = patched


def trunc_counts():
    """The Kraft step reads the count as trunc(total), for the threshold,
    the median and the interval: one count short wherever the recovered
    total falls a rounding error below its whole number (the JAX package
    reads the interval so).  Each bin's (y, dy) still belong to one
    count."""
    import torch

    from mind_the_gaps_tpu_torch.simulator import noise

    step = noise.KraftNoise.kraft_step

    def patched(self, net_rates, dy):
        exposures, bkg = (torch.as_tensor(x, dtype=net_rates.dtype, device=net_rates.device)
                          for x in (self.exposures, self.background_counts))
        counts = torch.trunc(net_rates * exposures + bkg)
        low = counts < self.kraft_counts
        y, d = step(self, (counts - bkg) / exposures, dy)
        return torch.where(low, y, net_rates), torch.where(low, d, dy)

    noise.KraftNoise.kraft_step = patched


FAULTS = {f.__name__: f for f in (kraft_left_out, threshold_10, equal_tailed, trunc_counts)}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in FAULTS:
        print(f"usage: python -m gpbench.faults_kraft {{{','.join(FAULTS)}}} <python -m gpbench.readings's "
              "arguments>", file=sys.stderr)
        return 2
    FAULTS[argv[0]]()
    from gpbench.readings import main as readings

    return readings(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
