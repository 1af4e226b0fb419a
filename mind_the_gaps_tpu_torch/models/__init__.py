"""Model namespace: covariance (kernel) terms, mean models, analytic PSDs,
as the JAX package's ``models`` exports them."""
from mind_the_gaps_tpu_torch.kernels import (
    BendingPowerlaw,
    ComplexTerm,
    Cosinus,
    DampedRandomWalk,
    JitterTerm,
    Lorentzian,
    Matern32Term,
    RealTerm,
    SHOTerm,
)
from mind_the_gaps_tpu_torch.models import psd_models
from mind_the_gaps_tpu_torch.models.mean_models import (
    ConstantModel,
    GaussianModel,
    LensingProfile,
    LinearModel,
    MeanModel,
    SineModel,
    TwoSineModel,
)

__all__ = [
    "Lorentzian",
    "Cosinus",
    "DampedRandomWalk",
    "BendingPowerlaw",
    "RealTerm",
    "ComplexTerm",
    "SHOTerm",
    "Matern32Term",
    "JitterTerm",
    "MeanModel",
    "ConstantModel",
    "LinearModel",
    "GaussianModel",
    "SineModel",
    "TwoSineModel",
    "LensingProfile",
    "psd_models",
]
