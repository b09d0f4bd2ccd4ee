"""Batched ODE integrators (counterpart of ``tt_irt_tpu/models/ode.py``):
fixed-step Runge-Kutta loops, and the adaptive Dormand-Prince 5(4) pair
with a PI step controller per row (``integrate_adaptive``, ode45's
error-controlled semantics).  The JAX package's ``lax.scan`` and bounded
``lax.while_loop`` become host loops over batched tensors with the same
step-size control, so the accepted steps agree."""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["rk4", "dopri5_step", "integrate_to", "integrate_observed",
           "integrate_adaptive", "integrate_observed_adaptive"]


def rk4(rhs: Callable, y, t, dt):
    """One classic RK4 step on a batched state y (M, n)."""
    k1 = rhs(t, y)
    k2 = rhs(t + 0.5 * dt, y + 0.5 * dt * k1)
    k3 = rhs(t + 0.5 * dt, y + 0.5 * dt * k2)
    k4 = rhs(t + dt, y + dt * k3)
    return y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


# Dormand-Prince 5(4) coefficients (the ode45 tableau), fixed-step use.
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
)
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0)
_DP_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)


def dopri5_step(rhs: Callable, y, t, dt):
    """One fixed-size Dormand-Prince (ode45) step; 5th-order solution."""
    ks = []
    for i in range(6):
        yi = y
        for aij, kj in zip(_DP_A[i], ks):
            yi = yi + dt * aij * kj
        ks.append(rhs(t + _DP_C[i] * dt, yi))
    out = y
    for bi, ki in zip(_DP_B, ks):
        out = out + dt * bi * ki
    return out


def integrate_to(rhs: Callable, y0, t0: float, t1: float, steps: int,
                 method: str = "dopri5"):
    """Integrate a batched state from t0 to t1 with fixed steps."""
    dt = (t1 - t0) / steps
    stepper = dopri5_step if method == "dopri5" else rk4
    y = y0
    for i in range(steps):
        y = stepper(rhs, y, t0 + i * dt, dt)
    return y


def integrate_observed(rhs: Callable, y0, obs_times,
                       steps_per_interval: int, method: str = "dopri5"):
    """Fixed steps through a sequence of observation times (starting at
    y0's time); the batched states at each time, (T, M, n)."""
    times = torch.as_tensor(obs_times, dtype=torch.float64).reshape(-1)
    times = [float(t) for t in times]
    states = [y0]
    y = y0
    for t0, t1 in zip(times[:-1], times[1:]):
        y = integrate_to(rhs, y, t0, t1, steps_per_interval, method)
        states.append(y)
    return torch.stack(states, dim=0)


# 4th-order embedded weights (ode45's error estimator row); the 7th
# stage is rhs at the 5th-order solution (FSAL).
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)


def _dp45_pair(rhs, y, t, dt):
    """One Dormand-Prince step: (5th-order solution, error vector)."""
    ks = []
    for i in range(6):
        yi = y
        for aij, kj in zip(_DP_A[i], ks):
            yi = yi + dt * aij * kj
        ks.append(rhs(t + _DP_C[i] * dt, yi))
    y5 = y
    for bi, ki in zip(_DP_B, ks):
        y5 = y5 + dt * bi * ki
    ks.append(rhs(t + dt, y5))
    err = torch.zeros_like(y)
    for bi, b4i, ki in zip(_DP_B + (0.0,), _DP_B4, ks):
        err = err + dt * (bi - b4i) * ki
    return y5, err


def integrate_adaptive(rhs: Callable, y0, t0: float, t1: float,
                       rtol: float = 1e-6, atol: float = 1e-8,
                       max_steps: int = 10_000, dt0: float | None = None,
                       return_stats: bool = False):
    """Error-controlled integration of a batched state (M, n) from t0
    to t1.  Every row runs its own accept/shrink loop: dt is a per-row
    vector, the embedded 5(4) error is measured as
    rms(err / (atol + rtol max(|y|, |ynew|))), and a PI controller
    (orders 0.7/0.4 over 5) rescales dt within [0.2, 5]x.  One iteration
    advances every unfinished row (finished rows take a dummy step of
    1e-30 and keep their state); at most ``max_steps`` iterations."""
    y = torch.as_tensor(y0)
    dtype, dev = y.dtype, y.device
    span = t1 - t0
    if dt0 is None:
        dt0 = span / 100.0
    m = y.shape[0]
    t = torch.full((m,), t0, dtype=dtype, device=dev)
    dt = torch.full((m,), dt0, dtype=dtype, device=dev)
    errold = torch.ones((m,), dtype=dtype, device=dev)
    nsteps = torch.zeros((m,), dtype=torch.int32, device=dev)
    beta1, beta2 = 0.7 / 5.0, -0.4 / 5.0
    safety, dmin, dmax = 0.9, 0.2, 5.0
    tiny = torch.tensor(1e-30, dtype=dtype, device=dev)
    end = t1 - 1e-12 * abs(span)
    it = 0
    while it < max_steps and bool((t < end).any()):
        active = t < end
        dtc = torch.where(active, torch.minimum(dt, t1 - t), tiny)
        ynew, errv = _dp45_pair(rhs, y, t[:, None], dtc[:, None])
        sc = atol + rtol * torch.maximum(y.abs(), ynew.abs())
        err = torch.maximum(torch.sqrt(torch.mean((errv / sc) ** 2, dim=1)),
                            tiny)
        bad = ~torch.isfinite(err)
        accept = (err <= 1.0) & active & ~bad
        y = torch.where(accept[:, None], ynew, y)
        t = torch.where(accept, t + dtc, t)
        fac = safety * err ** (-beta1) * errold ** (-beta2)
        fac = torch.where(bad, torch.full_like(fac, dmin),
                          torch.clamp(fac, dmin, dmax))
        dt = torch.where(active, dtc * fac, dt)
        errold = torch.where(accept, err, errold)
        nsteps = nsteps + active.to(torch.int32)
        it += 1
    if return_stats:
        return y, {"nsteps": nsteps, "iters": it, "t": t}
    return y


def integrate_observed_adaptive(rhs: Callable, y0, obs_times,
                                rtol: float = 1e-6, atol: float = 1e-8,
                                max_steps: int = 10_000):
    """Adaptive integration through a sequence of observation times;
    the batched states at each time, (T, M, n)."""
    times = torch.as_tensor(obs_times, dtype=torch.float64).reshape(-1)
    times = [float(t) for t in times]
    states = [torch.as_tensor(y0)]
    y = states[0]
    for ta, tb in zip(times[:-1], times[1:]):
        y = integrate_adaptive(rhs, y, ta, tb, rtol=rtol, atol=atol,
                               max_steps=max_steps)
        states.append(y)
    return torch.stack(states, dim=0)
