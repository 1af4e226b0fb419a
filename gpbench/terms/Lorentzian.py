"""Lorentzian (damped cosine) term, S0 exp(-w0 tau / (2 Q)) cos(w0 tau): one
complex celerite term a = S0, b = 0, c = w0 / (2 Q), d = w0.  Parameters
(log_S0, log_Q, log_omega0)."""
import torch

N_PARAMS = 3


def coefficients(theta):
    """Lists of (B,) tensors: ([], []) real, ([a], [b], [c], [d]) complex."""
    S0, Q, w0 = torch.exp(theta[:, 0]), torch.exp(theta[:, 1]), torch.exp(theta[:, 2])
    return [], [], [S0], [torch.zeros_like(S0)], [0.5 * w0 / Q], [w0]
