"""DRW term, S0 exp(-w0 tau) (Foreman-Mackey+17, Eq. 13 with Q = 1/2): one
real celerite term a = S0, c = w0.  Parameters (log_S0, log_omega0)."""
import torch

N_PARAMS = 2


def coefficients(theta):
    """Lists of (B,) tensors: ([a], [c]) real, ([], [], [], []) complex."""
    return [torch.exp(theta[:, 0])], [torch.exp(theta[:, 1])], [], [], [], []
