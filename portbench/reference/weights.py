"""Self-normalised importance weights as iw_prune.m computes them:
exp(lfex - lfapp) over their mean, independent of the program."""

from __future__ import annotations

import torch


def log_weights(lfex, lfapp):
    """Log of the self-normalised importance weights of a batch."""
    lr = lfex - lfapp
    return lr - torch.logsumexp(lr, dim=0) + torch.log(
        torch.tensor(float(lr.shape[0]), dtype=lr.dtype, device=lr.device))
