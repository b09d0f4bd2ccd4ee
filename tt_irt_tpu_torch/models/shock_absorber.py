"""Shock-absorber reliability model: censored Weibull regression with a
Normal-Gamma prior (counterpart of ``tt_irt_tpu/models/shock_absorber.py``).

Reference: matlab/examples/shock_absorber/{shock_log_prior.m,
shock_log_weibull.m, shock_quantiles.m, test_shock_absorber_tt.m}.  The
covariates of the paper's experiments are the JAX package's data file
``tt_irt_tpu/models/data/shock-xdata-d6.dat``, read in place by path.

Parameter layout theta (M, d+2): [beta_0, beta_1..beta_d, lambda], torch
tensors, vectorized over the sample axis on the tensors' device.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

__all__ = [
    "SHOCK_Y", "SHOCK_CENSORED", "ShockConfig", "log_prior",
    "log_likelihood", "log_posterior", "quantile_qoi", "paper_covariates",
]

# Failure/censoring data from the paper (test_shock_absorber_tt.m:50-54)
SHOCK_Y = np.array([
    6700, 6950, 7820, 8790, 9120, 9660, 9820, 11310, 11690, 11850, 11880,
    12140, 12200, 12870, 13150, 13330, 13470, 14040, 14300, 17520, 17540,
    17890, 18420, 18960, 18980, 19410, 20100, 20100, 20150, 20320, 20900,
    22700, 23490, 26510, 27410, 27490, 27890, 28100], dtype=np.float64)
SHOCK_CENSORED = np.array([
    0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 0, 1, 0, 1, 1, 1, 0, 0, 1, 1, 1,
    1, 1, 1, 0, 1, 1, 1, 0, 0, 1, 0, 1, 0, 1, 1], dtype=np.float64)

_ALPHA = 6.8757   # Normal-Gamma shape (shock_log_prior.m:6)
_BETA = 2.2932    # Normal-Gamma rate  (shock_log_prior.m:7)
_UNDERFLOW_SHIFT = np.log(3.0e4)  # shock_log_weibull.m:19

# The JAX package's data directory, next to this package in the repo.
_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                     "tt_irt_tpu", "models", "data")


def paper_covariates() -> np.ndarray:
    """The (d=6, m=38) covariate matrix used in the paper experiments."""
    return np.loadtxt(os.path.join(_DATA, "shock-xdata-d6.dat"))


@dataclass
class ShockConfig:
    """Grid/domain configuration (test_shock_absorber_tt.m:71-98)."""

    d: int = 6            # number of covariates
    n: int = 17           # grid points per variable
    x: Optional[np.ndarray] = None  # covariates (d, m); None -> random
    seed: int = 0
    y: np.ndarray = field(default_factory=lambda: SHOCK_Y.copy())
    censored: np.ndarray = field(
        default_factory=lambda: SHOCK_CENSORED.copy())

    def __post_init__(self):
        if self.x is None:
            rng = np.random.default_rng(self.seed)
            self.x = rng.standard_normal(
                (self.d, self.y.shape[0])) / self.d
        self.x = np.asarray(self.x, dtype=np.float64)
        self.beta_mean = np.zeros(self.d + 1)
        self.beta_mean[0] = np.log(30796.0)
        self.beta_var = np.ones(self.d + 1)
        self.beta_var[0] = 0.1563
        a = self.beta_mean - 3.0 * np.sqrt(self.beta_var)
        b = 2.0 * self.beta_mean - a
        self.a = np.concatenate([a, [0.0]])
        self.b = np.concatenate([b, [13.0]])

    def grids(self) -> list:
        return [np.linspace(self.a[i], self.b[i], self.n)
                for i in range(self.d + 2)]

    def log_posterior_fn(self):
        """theta (M, d+2) f64 tensor -> log posterior (M,), on theta's
        device."""
        def lpifun(theta):
            def t(a):
                return torch.as_tensor(a, dtype=theta.dtype,
                                       device=theta.device)

            return (log_likelihood(theta, t(self.x), t(self.y),
                                   t(self.censored))
                    + log_prior(theta, t(self.beta_mean),
                                t(self.beta_var)))

        return lpifun


def log_prior(theta, beta_mean, beta_var):
    """Normal-Gamma log prior (shock_log_prior.m:4-10)."""
    lam = theta[:, -1]
    betas = theta[:, :-1]
    quad = -0.5 * torch.sum(
        (betas - beta_mean[None, :]) ** 2 * lam[:, None] / beta_var[None, :],
        dim=1)
    return (_ALPHA - 0.5) * torch.log(lam) - _BETA * lam + quad


def log_likelihood(theta, x, y, censored):
    """Censored Weibull log likelihood, vectorized over samples and data
    (one batched matmul and a masked reduction in place of the
    reference's per-datum loop, shock_log_weibull.m:12-22)."""
    d = theta.shape[1] - 2
    beta0 = theta[:, 0]
    betas = theta[:, 1:d + 1]
    lam = theta[:, -1]
    logeta = beta0[:, None] + betas @ x          # (M, m)
    yeta = y[None, :] / torch.exp(logeta)
    pow_term = yeta ** lam[:, None]
    log_y = torch.log(y)[None, :]
    uncensored = (torch.log(lam)[:, None] - logeta
                  + (lam[:, None] - 1.0) * (log_y - logeta)
                  - pow_term + _UNDERFLOW_SHIFT)
    censored_term = -pow_term
    f = torch.where(censored[None, :] > 0, censored_term, uncensored)
    return torch.sum(f, dim=1)


def log_posterior(theta, config: ShockConfig):
    return config.log_posterior_fn()(theta)


def quantile_qoi(z, x_pred=None, is_weight=None, q: float = 0.05,
                 newton_iters: int = 20):
    """Posterior 95% reliability quantile QoI (shock_quantiles.m):
    returns (mean-of-quantiles, quantile-of-mean-density), the second by
    a fixed number of Newton steps on the mean Weibull CDF (a plain loop
    where the JAX package scans)."""
    z = torch.as_tensor(z, dtype=torch.float64)
    d = z.shape[1] - 2
    if x_pred is None:
        x_pred = torch.zeros((d,), dtype=z.dtype, device=z.device)
    else:
        x_pred = torch.as_tensor(x_pred, dtype=z.dtype, device=z.device)
    theta1 = torch.exp(z[:, 0] + z[:, 1:d + 1] @ x_pred)
    theta2 = z[:, -1]
    if is_weight is not None:
        w = torch.as_tensor(is_weight, dtype=z.dtype, device=z.device)
        zex = torch.sum(w)

        def avg(v):
            return torch.sum(v * w) / zex
    else:
        def avg(v):
            return torch.mean(v)

    qf = theta1 * (-math.log(q)) ** (1.0 / theta2)
    qf = torch.where(qf > 1e7, torch.zeros_like(qf), qf)
    q_post = avg(qf)
    qn = q_post
    for _ in range(newton_iters):
        r = avg(torch.exp(-(qn / theta1) ** theta2)) / q - 1.0
        jac = avg(torch.exp(-(qn / theta1) ** theta2)
                  * (theta2 / theta1) * (qn / theta1) ** (theta2 - 1.0)) / q
        qn = qn + r / jac
    return q_post, qn
