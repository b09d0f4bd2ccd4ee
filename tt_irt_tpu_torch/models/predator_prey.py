"""Predator-prey (Lotka-Volterra-Holling) ODE calibration via DIRT
(counterpart of ``tt_irt_tpu/models/predator_prey.py``).

Reference: matlab/examples/predator_prey/{PP_RHS.m, PP_loglikelihood.m,
test_predator_prey_dirt.m, parse_pp_inputs.m}.  The paper's observations
are the JAX package's data file ``tt_irt_tpu/models/data/pp_observables.dat``,
read in place by path.

8 parameters [P0, Q0, r, K, s, a, u, v]; the inference runs in
normalized coordinates x with X = x * xtrue on the inferred subset
(PP_loglikelihood.m:5-6), default subset = all 8 in reversed order.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from .ode import integrate_observed, integrate_observed_adaptive

__all__ = ["pp_rhs", "pp_rhs_factory", "pp_loglikelihood",
           "paper_observables", "PredatorPreyProblem"]

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                     "tt_irt_tpu", "models", "data")


def pp_rhs_factory(params):
    """RHS closure over a batched parameter matrix (M, 8):
    dP = r P (1 - P/K) - s PQ/(a+P); dQ = u PQ/(a+P) - v Q
    (PP_RHS.m:9-23)."""
    r, k, s, a, u, v = (params[:, 2], params[:, 3], params[:, 4],
                        params[:, 5], params[:, 6], params[:, 7])

    def rhs(t, y):
        p, q = y[:, 0], y[:, 1]
        holling = p * q / (a + p)
        dp = r * p * (1.0 - p / k) - s * holling
        dq = u * holling - v * q
        return torch.stack([dp, dq], dim=1)

    return rhs


def pp_rhs(t, y, params):
    return pp_rhs_factory(params)(t, y)


def pp_loglikelihood(x, data, obs_times, sigma_n, xtrue, ind,
                     steps_per_interval: int = 64, adaptive: bool = False,
                     rtol: float = 1e-6, atol: float = 1e-8):
    """Vectorized ODE log-likelihood (PP_loglikelihood.m), on x's device:
    X = xtrue with X[:, ind] = x * xtrue[ind]; integrate the batched
    system through the observation times (fixed Dormand-Prince steps, or
    with ``adaptive=True`` the error-controlled pair at ode45's tolerance
    semantics); Gaussian misfit with variance ``sigma_n``."""
    x = torch.as_tensor(x, dtype=torch.float64)
    dev = x.device
    m = x.shape[0]
    xtrue = torch.as_tensor(xtrue, dtype=x.dtype, device=dev)
    ind = torch.as_tensor(np.asarray(ind), dtype=torch.int64, device=dev)
    # out of place, so that torch.func can map and differentiate it (svn)
    full = xtrue[None, :].repeat(m, 1).index_copy(
        1, ind, x * xtrue[ind][None, :])
    y0 = full[:, :2]
    obs_times = torch.as_tensor(obs_times, dtype=torch.float64)
    if adaptive:
        states = integrate_observed_adaptive(
            pp_rhs_factory(full), y0, obs_times, rtol=rtol,
            atol=atol)                                    # (T, M, 2)
    else:
        states = integrate_observed(pp_rhs_factory(full), y0, obs_times,
                                    steps_per_interval)   # (T, M, 2)
    data = torch.as_tensor(data, dtype=x.dtype, device=dev)   # (T, 2)
    misfit = torch.sum((states - data[:, None, :]) ** 2, dim=(0, 2))
    return -0.5 * misfit / sigma_n


def paper_observables() -> np.ndarray:
    return np.loadtxt(os.path.join(_DATA, "pp_observables.dat"))


@dataclass
class PredatorPreyProblem:
    """Defaults from parse_pp_inputs.m / test_predator_prey_dirt.m:
    sigma_n=2 (variance), xtrue=[50,5,0.6,100,1.2,25,0.5,0.3],
    obs_times=linspace(0,50,13), n=18, R0=13, domain [0.6,1.6],
    beta=10^(-4:1/2:0), reference 'n4', inferred subset 8:-1:1."""

    sigma_n: float = 2.0
    xtrue: np.ndarray = field(default_factory=lambda: np.array(
        [50.0, 5.0, 0.6, 100.0, 1.2, 25.0, 0.5, 0.3]))
    obs_times: np.ndarray = field(
        default_factory=lambda: np.linspace(0.0, 50.0, 13))
    data: Optional[np.ndarray] = None
    use_paper_data: bool = False
    n: int = 18
    domain: tuple = (0.6, 1.6)
    ind: Sequence[int] = field(
        default_factory=lambda: list(range(7, -1, -1)))
    seed: int = 0
    steps_per_interval: int = 64
    adaptive: bool = False
    rtol: float = 1e-6
    beta: np.ndarray = field(
        default_factory=lambda: 10.0 ** np.arange(-4, 0.5, 0.5))

    def __post_init__(self):
        self.xtrue = np.asarray(self.xtrue, dtype=np.float64)
        self.obs_times = np.asarray(self.obs_times, dtype=np.float64)
        if self.data is None:
            if self.use_paper_data:
                self.data = paper_observables()
            else:
                rng = np.random.default_rng(self.seed)
                xt = torch.as_tensor(self.xtrue)[None, :]
                states = integrate_observed(
                    pp_rhs_factory(xt), xt[:, :2],
                    torch.as_tensor(self.obs_times),
                    self.steps_per_interval)[:, 0, :]
                self.data = states.numpy() + \
                    np.sqrt(self.sigma_n) * \
                    rng.standard_normal((len(self.obs_times), 2))
        self.data = np.asarray(self.data, dtype=np.float64)

    @property
    def d(self) -> int:
        return len(self.ind)

    def grids(self) -> list:
        return [np.linspace(self.domain[0], self.domain[1], self.n)
                for _ in range(self.d)]

    def log_posterior_fn(self):
        """x (M, d) f64 tensor -> log-likelihood (M,), on x's device."""
        def lp(x):
            return pp_loglikelihood(x, self.data, self.obs_times,
                                    self.sigma_n, self.xtrue, self.ind,
                                    self.steps_per_interval,
                                    adaptive=self.adaptive, rtol=self.rtol)

        return lp

    def tempered_logratio_fn(self):
        lp = self.log_posterior_fn()

        def fn(x, b1, b2):
            return lp(x) * (b2 - b1)

        return fn
