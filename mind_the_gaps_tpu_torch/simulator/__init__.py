"""Lightcurve simulation: TK95, the E13 flux-PDF adjustment, observational noise."""
from mind_the_gaps_tpu_torch.simulator.core import (
    E13Simulator,
    Simulator,
    TK95Simulator,
    add_poisson_noise,
    cut_random_segment,
    downsample_cumsum,
    e13_adjust,
    e13_adjust_batch,
    get_fft,
    get_segment,
    tk95_rates,
)
from mind_the_gaps_tpu_torch.simulator.noise import (
    BaseNoise,
    GaussianNoise,
    KraftNoise,
    PoissonNoise,
)
from mind_the_gaps_tpu_torch.simulator.regular import RegularLightcurve

__all__ = [
    "RegularLightcurve",
    "BaseNoise",
    "PoissonNoise",
    "KraftNoise",
    "GaussianNoise",
    "Simulator",
    "TK95Simulator",
    "E13Simulator",
    "tk95_rates",
    "downsample_cumsum",
    "e13_adjust",
    "e13_adjust_batch",
    "add_poisson_noise",
    "get_fft",
    "get_segment",
    "cut_random_segment",
]
