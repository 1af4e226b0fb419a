"""Alias module for the reference's ``mind_the_gaps.models.celerite_models``
import path (the covariance terms live in kernels/terms.py)."""
from mind_the_gaps_tpu_torch.kernels.terms import (  # noqa: F401
    BendingPowerlaw,
    ComplexTerm,
    Cosinus,
    DampedRandomWalk,
    JitterTerm,
    Lorentzian,
    Matern32Term,
    RealTerm,
    SHOTerm,
    Term,
    TermSum,
)

__all__ = [
    "Term",
    "TermSum",
    "RealTerm",
    "ComplexTerm",
    "SHOTerm",
    "Matern32Term",
    "JitterTerm",
    "Lorentzian",
    "Cosinus",
    "DampedRandomWalk",
    "BendingPowerlaw",
]
