"""Ensemble MCMC: the stretch-move sampler and the autocorrelation time."""
from mind_the_gaps_tpu_torch.sampler.autocorr import (
    integrated_autocorr_time,
    integrated_autocorr_time_masked,
    integrated_autocorr_time_np,
)
from mind_the_gaps_tpu_torch.sampler.ensemble import (
    max_loglike_ensemble_impl,
    run_ensemble,
    sample_ensemble,
    sample_ensemble_grouped,
    sample_ensemble_impl,
    stretch_draws,
    stretch_half,
)

__all__ = [
    "run_ensemble",
    "sample_ensemble",
    "sample_ensemble_impl",
    "sample_ensemble_grouped",
    "max_loglike_ensemble_impl",
    "stretch_draws",
    "stretch_half",
    "integrated_autocorr_time",
    "integrated_autocorr_time_masked",
    "integrated_autocorr_time_np",
]
