"""mind_the_gaps_tpu_torch: the PyTorch and CUDA port of mind_the_gaps_tpu.

GP modelling of irregularly sampled lightcurves with celerite-style
kernels, TK95 simulation, the stretch-move ensemble sampler and the
Protassov et al. (2002) likelihood-ratio test, on PyTorch tensors.  The
batched celerite log-likelihood (``csrc/celerite_loglike.cuh``), the MAP
fit's log-likelihood with its exact gradient (``csrc/celerite_grad.cuh``)
and the E13 sort (``csrc/bitonic_sort.cu``) are CUDA kernels written for
Hopper, as is ``csrc/fma_chain.cu``, a latency probe of dependent
multiply-adds (``ops/fma_probe.py``); each is built with ``nvcc`` at its
first use on a CUDA device, and on the CPU each op runs its plain PyTorch
version.  ``python -m mind_the_gaps_tpu_torch.cli`` runs the fit /
simulate / lrt workflows on lightcurve files, on the card unless given
``--device cpu``.  ``parallel`` shards the bootstrap refits and the
observed fits over the cards of a node, with results equal to one card's.

The JAX package ``mind_the_gaps_tpu`` is the reference this port is
tested against; this package never imports it.
"""
from mind_the_gaps_tpu_torch.lightcurves import (
    FermiLightcurve,
    GappyLightcurve,
    SimpleLightcurve,
    SwiftLightcurve,
)

__version__ = "0.1.0"

__all__ = [
    "GappyLightcurve",
    "SimpleLightcurve",
    "SwiftLightcurve",
    "FermiLightcurve",
    "GPModelling",
    "AutocorrError",
    "Simulator",
    "protassov_lrt",
    "__version__",
]


def __getattr__(name):
    if name in ("GPModelling", "AutocorrError"):
        from mind_the_gaps_tpu_torch import gpmodelling

        return getattr(gpmodelling, name)
    if name == "Simulator":
        from mind_the_gaps_tpu_torch.simulator import Simulator

        return Simulator
    if name == "protassov_lrt":
        from mind_the_gaps_tpu_torch.lrt import protassov_lrt

        return protassov_lrt
    raise AttributeError(f"module 'mind_the_gaps_tpu_torch' has no attribute {name!r}")
