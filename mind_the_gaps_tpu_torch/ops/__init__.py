"""Hand-written CUDA kernels for the hot ops, each beside its plain version."""
from mind_the_gaps_tpu_torch.ops.celerite import (
    celerite_log_likelihood,
    celerite_log_likelihood_plain,
)
from mind_the_gaps_tpu_torch.ops.celerite_grad import (
    celerite_log_likelihood_and_grad,
    celerite_log_likelihood_and_grad_plain,
    celerite_loglike_fn,
)
from mind_the_gaps_tpu_torch.ops.sort import rank_remap, rank_remap_plain, sort_kv, sort_kv_plain

__all__ = [
    "celerite_log_likelihood",
    "celerite_log_likelihood_plain",
    "celerite_log_likelihood_and_grad",
    "celerite_log_likelihood_and_grad_plain",
    "celerite_loglike_fn",
    "sort_kv",
    "sort_kv_plain",
    "rank_remap",
    "rank_remap_plain",
]
