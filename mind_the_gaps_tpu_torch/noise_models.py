"""Alias module mirroring the reference's ``mind_the_gaps.noise_models``
import path (noise models live in simulator/noise.py)."""
from mind_the_gaps_tpu_torch.simulator.noise import (  # noqa: F401
    BaseNoise,
    GaussianNoise,
    KraftNoise,
    PoissonNoise,
)

__all__ = ["BaseNoise", "PoissonNoise", "KraftNoise", "GaussianNoise"]
