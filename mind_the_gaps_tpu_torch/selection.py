"""Kernel model selection.

PyTorch port of ``mind_the_gaps_tpu/selection.py``: the workflow of the
reference's tutorial_model_selection.ipynb as one function.  Each candidate
kernel gets a ``GPModelling`` on ``device`` (a CUDA device by default, or
"cpu"), whose MAP fit and sampler run there (the gradient kernel and the
celerite kernel on a card); the candidates are then ranked by corrected
Akaike weights and checked for goodness of fit with a KS test on the
residuals (Kelly et al. 2011 diagnostics).  The KS test and the AICc read
the N residuals once a candidate, on the host, as in the JAX package.

Deviation from the reference notebook (opt-out via ``residuals``): the
KS test defaults to the exact leave-one-out residuals
(GPModelling.loo_residuals, alpha_n / sqrt(Kinv_nn), which are N(0,1)
under the correct model) instead of the predictive-variance
standardization, whose variance is s^2 Kinv_nn rather than the
s - s^2 Kinv_nn it is divided by — i.e. the reference's KS p-values are
miscalibrated whenever noise and signal amplitudes differ.  Pass
``residuals="standardized"`` to reproduce the reference notebook's
behavior exactly (gpmodelling.py:353-370 residuals into the KS test).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
from scipy.stats import kstest, norm

from mind_the_gaps_tpu_torch.gpmodelling import GPModelling
from mind_the_gaps_tpu_torch.lightcurves import GappyLightcurve
from mind_the_gaps_tpu_torch.stats import aicc

__all__ = ["ModelComparison", "compare_models"]


@dataclass
class ModelComparison:
    name: str
    model: GPModelling
    max_loglikelihood: float
    k: int
    aicc: float
    delta_aicc: float
    akaike_weight: float
    ks_statistic: float
    ks_pvalue: float


def compare_models(
    lightcurve: GappyLightcurve,
    kernels: Dict[str, object],
    mean_model: Optional[str] = None,
    max_steps: int = 10000,
    walkers: int = 32,
    converge: bool = True,
    progress: bool = False,
    seed: Optional[int] = None,
    residuals: str = "loo",
    device="cuda",
) -> List[ModelComparison]:
    """Fit every kernel and rank by AICc (smallest first).

    Returns a list of ModelComparison with Akaike weights normalized over
    the candidate set and the KS p-value of the residuals at the
    maximum-likelihood parameters.  Candidate ``i`` samples with seed
    ``seed + i``.

    ``residuals``: "loo" (default; exact leave-one-out residuals, exactly
    N(0,1) under the correct model) or "standardized" (the reference
    notebook's predictive-std standardization, gpmodelling.py:353-370 —
    use this for reference-parity p-values).
    """
    if residuals not in ("loo", "standardized"):
        raise ValueError("residuals must be 'loo' or 'standardized'")
    fits = []
    for i, (name, kernel) in enumerate(kernels.items()):
        gp = GPModelling(lightcurve, kernel, mean_model=mean_model, device=device)
        gp.derive_posteriors(
            max_steps=max_steps,
            walkers=walkers,
            converge=converge,
            progress=progress,
            seed=None if seed is None else seed + i,
        )
        ll = float(gp.max_loglikelihood)
        a = float(aicc(ll, lightcurve.n, gp.k))
        if residuals == "loo":
            res = gp.loo_residuals(parameters=gp.max_parameters)
        else:
            res = gp.standarized_residuals(parameters=gp.max_parameters)
        ks = kstest(res, norm.cdf)
        fits.append((name, gp, ll, a, ks))

    amin = min(f[3] for f in fits)
    rel = [np.exp(-0.5 * (f[3] - amin)) for f in fits]
    total = sum(rel)

    out = [
        ModelComparison(
            name=name,
            model=gp,
            max_loglikelihood=ll,
            k=gp.k,
            aicc=a,
            delta_aicc=a - amin,
            akaike_weight=r / total,
            ks_statistic=float(ks.statistic),
            ks_pvalue=float(ks.pvalue),
        )
        for (name, gp, ll, a, ks), r in zip(fits, rel)
    ]
    out.sort(key=lambda m: m.aicc)
    return out
