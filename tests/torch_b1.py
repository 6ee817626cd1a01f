"""Inputs shared by the B1 tests: tests/test_torch_fused_posterior.py on the
CPU and tests/test_torch_kernels_cuda.py on the card. Imports only torch."""

import torch

#: which of B1's six inputs need a gradient: a training step's (the four
#: statistics; the noise is drawn, not learned) and all six
NEEDS = {"statistics": (True,) * 4 + (False,) * 2, "all": (True,) * 6}


def encoder_output(mean_q, logvar_q, mean_p, logvar_p):
    """The [2B, 2L] encoder output that holds the four statistics: rows q
    then p, columns mean then logvar."""
    return torch.cat([torch.cat([mean_q, logvar_q], 1),
                      torch.cat([mean_p, logvar_p], 1)])


def statistics(h):
    """The four statistics as a training step hands them to B1: the column
    halves (mean, logvar) and row halves (q, p) of `h`, row stride 2L."""
    B = h.shape[0] // 2
    mean_all, logvar_all = h.chunk(2, dim=1)
    return mean_all[:B], logvar_all[:B], mean_all[B:], logvar_all[B:]
