"""Lightcurve container and file loaders (host numpy; the compute layers
copy the arrays to tensors on their device once)."""
from mind_the_gaps_tpu_torch.lightcurves.gappylightcurve import (
    ExposureTimeError,
    GappyLightcurve,
)
from mind_the_gaps_tpu_torch.lightcurves.loaders import (
    FermiLightcurve,
    SimpleLightcurve,
    SwiftLightcurve,
    load_lightcurve_directory,
)

__all__ = [
    "GappyLightcurve",
    "ExposureTimeError",
    "SimpleLightcurve",
    "SwiftLightcurve",
    "FermiLightcurve",
    "load_lightcurve_directory",
]
