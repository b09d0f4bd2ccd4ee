"""Lorenz-96-type initial-state inference, the exact posterior of the
shipped Lorenz checkpoints (counterpart of
``tt_irt_tpu/models/lorenz.py``): cyclic dynamics with forcing 8, noisy
observations of the even coordinates at t=0.1, a standard-normal prior
around x0true, and the prior-tempered DIRT ratio
ll (b2 - b1) + lprior (b2^0.25 - b1^0.25)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..utils.profiling import span
from .ode import integrate_adaptive, integrate_to

__all__ = ["lorenz_rhs", "lorenz_ll", "LorenzProblem"]

_FORCING = 8.0
_T_OBS = 0.1


def lorenz_rhs(t, x):
    """Cyclic Lorenz RHS on a batched state (M, d):
    f_i = (x_{i+1} - x_{i-2}) x_{i-1} - x_i + 8."""
    xp1 = torch.roll(x, -1, dims=-1)
    xm1 = torch.roll(x, 1, dims=-1)
    xm2 = torch.roll(x, 2, dims=-1)
    return (xp1 - xm2) * xm1 - x + _FORCING


def lorenz_ll(x0, data, sigma_n, steps: int = 40, adaptive: bool = False,
              rtol: float = 1e-6, atol: float = 1e-8):
    """Gaussian log-likelihood of even-coordinate observations at t=0.1:
    fixed-step Dormand-Prince integration, or with ``adaptive=True`` the
    error-controlled pair (ode45's tolerance semantics)."""
    if adaptive:
        y = integrate_adaptive(lorenz_rhs, x0, 0.0, _T_OBS, rtol=rtol,
                               atol=atol)
    else:
        y = integrate_to(lorenz_rhs, x0, 0.0, _T_OBS, steps)
    obs = y[:, 1::2]
    return -0.5 * torch.sum((data[None, :] - obs) ** 2, dim=1) / sigma_n**2


@dataclass
class LorenzProblem:
    """Lorenz inference problem (defaults as in the JAX package: d=10,
    sigma_n=0.1, sigma_truth=0.01, an n=17 grid on [-a, a] = [-10, 10],
    beta = 10^(-4:1/2:0)).  Given ``x0true`` and ``data`` it is the exact
    posterior of a checkpoint's ``*_x0base.npy`` / ``*_data.npy``;
    otherwise both are synthesized from ``seed``."""

    d: int = 10
    sigma_n: float = 0.1
    sigma_truth: float = 0.01
    a: float = 10.0
    n: int = 17
    seed: int = 0
    steps: int = 40
    adaptive: bool = False
    rtol: float = 1e-6
    x0true: Optional[np.ndarray] = None
    data: Optional[np.ndarray] = None
    beta: np.ndarray = field(
        default_factory=lambda: 10.0 ** np.arange(-4, 0.5, 0.5))

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        if self.x0true is None:
            self.x0base = np.ones(self.d)
            self.x0true = self.x0base + \
                self.sigma_truth * rng.standard_normal(self.d)
        else:
            self.x0base = np.asarray(self.x0true, dtype=np.float64)
            self.x0true = self.x0base
        if self.data is None:
            xend = integrate_to(lorenz_rhs,
                                torch.as_tensor(self.x0true)[None, :],
                                0.0, _T_OBS, self.steps)[0]
            self.data = xend[1::2].numpy() + \
                self.sigma_n * rng.standard_normal(self.d // 2)
        self.data = np.asarray(self.data, dtype=np.float64)

    def grids(self) -> list:
        return [np.linspace(-self.a, self.a, self.n) for _ in range(self.d)]

    def log_prior(self, x):
        with span("ttirt.model.log_prior"):
            base = torch.as_tensor(self.x0base, dtype=x.dtype,
                                   device=x.device)
            return -0.5 * torch.sum((x - base[None, :]) ** 2, dim=1)

    def log_likelihood(self, x):
        with span("ttirt.model.log_likelihood"):
            data = torch.as_tensor(self.data, dtype=x.dtype, device=x.device)
            return lorenz_ll(x, data, self.sigma_n, self.steps,
                             adaptive=self.adaptive, rtol=self.rtol)

    def log_posterior_fn(self):
        def lp(x):
            return self.log_likelihood(x) + self.log_prior(x)

        return lp

    def tempered_logratio_fn(self):
        """The prior-tempered DIRT ratio between betas b1 and b2."""
        def fn(x, b1, b2):
            return (self.log_likelihood(x) * (b2 - b1)
                    + self.log_prior(x) * (b2 ** 0.25 - b1 ** 0.25))

        return fn
