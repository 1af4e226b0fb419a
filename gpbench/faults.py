"""Faults planted in the timed path, for the tests and for the readings
that set the comparison limits (``python -m gpbench.readings --fault``).

Each is a function that patches the port in the calling process; none is
used by a benchmark run.
"""


def frozen_refits():
    """The refits' step returns its chains' state unchanged."""
    import torch

    from mind_the_gaps_tpu_torch import lrt

    lrt._ShardRun.step = lambda self, draws, a, tol: None if tol is None else torch.tensor(False)


def shifted_refine():
    """Each refined log-likelihood is altered where it is produced."""
    from mind_the_gaps_tpu_torch import lrt

    refine = lrt._f64_logprob_chunk
    lrt._f64_logprob_chunk = lambda *args: refine(*args) + 0.5


def frozen_sampler():
    """The observed sampler's half-step returns its walkers unchanged."""
    import torch

    from mind_the_gaps_tpu_torch.sampler import ensemble

    ensemble.stretch_half = lambda active, passive, logp, *rest, **kw: (
        active, logp, torch.zeros(logp.shape, dtype=torch.bool, device=logp.device))


def shifted_chain():
    """Each log-probability the sampler records is altered where it is
    produced."""
    from mind_the_gaps_tpu_torch import gpmodelling

    get = gpmodelling.ChainResult.get_log_prob
    gpmodelling.ChainResult.get_log_prob = lambda self, *a, **kw: get(self, *a, **kw) + 1e-3


def scaled_generation():
    """Each simulated lightcurve is altered where it is produced: its
    deviations from its mean doubled."""
    from mind_the_gaps_tpu_torch import gpmodelling

    make = gpmodelling.GPModelling.make_device_generator

    def patched(self, *args, **kwargs):
        gen = make(self, *args, **kwargs)

        def scaled(thetas, generator=None):
            rates, dy = gen(thetas, generator)
            return 2.0 * rates - rates.mean(1, keepdim=True), dy

        scaled.simulator, scaled.report_nonconverged = gen.simulator, gen.report_nonconverged
        return scaled

    gpmodelling.GPModelling.make_device_generator = patched


def skipped_e13():
    """The E13 adjustment returns its segments as they came (the TK95 draw,
    Gaussian), where the configuration states another flux pdf."""
    import torch

    from mind_the_gaps_tpu_torch.simulator import core

    core.e13_adjust_batch = lambda segments, *args, **kwargs: (
        segments, torch.zeros(segments.shape[0], dtype=torch.int32, device=segments.device))


def dropped_gather():
    """The exchange between processes left out: the refits' gather
    (``lrt.process_allgather``) returns this rank's block in every rank's
    place."""
    import torch
    import torch.distributed as dist

    from mind_the_gaps_tpu_torch import lrt

    def own_block(x, tiled=True):
        x = torch.as_tensor(x)
        x = x[None] if x.dim() == 0 else x
        blocks = [x] * (dist.get_world_size() if dist.is_initialized() else 1)
        return torch.cat(blocks) if tiled else torch.stack(blocks)

    lrt.process_allgather = own_block


FAULTS = {f.__name__: f for f in (frozen_refits, shifted_refine, scaled_generation, skipped_e13, frozen_sampler,
                                  shifted_chain, dropped_gather)}
