"""GP solvers for celerite-style semiseparable covariance matrices.

- ``dense``: O(N^2) dense Cholesky, the ground truth for tests;
- ``semiseparable``: the O(N R^2) recursion for one parameter vector,
  differentiable by autograd (the MAP objective);
- ``batched``: the O(N R^2) recursion for a batch of B parameter vectors
  in the local-phase form, the plain version of the CUDA kernel;
- ``numpy_ref``: the same recursion in numpy;
- ``kalman``: the same likelihood as a Kalman filter, sequential and
  parallel in time (a second oracle).
"""
from mind_the_gaps_tpu_torch.solver.batched import batched_log_likelihood
from mind_the_gaps_tpu_torch.solver.dense import dense_covariance, dense_log_likelihood
from mind_the_gaps_tpu_torch.solver.kalman import kalman_log_likelihood, parallel_kalman_log_likelihood
from mind_the_gaps_tpu_torch.solver.numpy_ref import numpy_log_likelihood
from mind_the_gaps_tpu_torch.solver.semiseparable import (
    CeleriteMatrices,
    build_matrices,
    factor,
    inverse_diag,
    log_likelihood,
    predict,
    predict_at,
    predict_mean,
    solve,
)

__all__ = [
    "dense_covariance",
    "dense_log_likelihood",
    "CeleriteMatrices",
    "build_matrices",
    "factor",
    "log_likelihood",
    "solve",
    "predict_mean",
    "predict",
    "predict_at",
    "inverse_diag",
    "batched_log_likelihood",
    "numpy_log_likelihood",
    "kalman_log_likelihood",
    "parallel_kalman_log_likelihood",
]
