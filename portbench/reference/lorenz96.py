"""Plain PyTorch reference of the Lorenz-96 initial-state posterior
(``problem.model`` "lorenz96"), independent of the program.

The model is the MATLAB TT-IRT example (matlab/examples/lorenz:
lorenz_rhs.m, lorenz_ll.m, test_lorenz.m): the cyclic right-hand side
f_i = (x_{i+1} - x_{i-2}) x_{i-1} - x_i + F with F = 8, integrated from
t = 0 to the observation time 0.1 by fixed Dormand-Prince 5 steps,
Gaussian noise on the even coordinates (1-based) and a standard-normal
prior around the base state.  The forcing and the observation time are
the example's, which the program fixes too; the configuration's
``problem`` gives both sides the rest: the base state and data files,
the noise ``sigma_n`` and the number of ``steps``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

FORCING = 8.0
T_OBS = 0.1

# Dormand-Prince 5(4) tableau (ode45), the 5th-order solution.
_A = ((), (1 / 5,), (3 / 40, 9 / 40), (44 / 45, -56 / 15, 32 / 9),
      (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
      (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656))
_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)


def rhs(x):
    return ((torch.roll(x, -1, dims=-1) - torch.roll(x, 2, dims=-1))
            * torch.roll(x, 1, dims=-1) - x + FORCING)


def integrate(x, steps: int):
    dt = T_OBS / steps
    for _ in range(steps):
        ks = []
        for i in range(6):
            xi = x
            for a, k in zip(_A[i], ks):
                xi = xi + dt * a * k
            ks.append(rhs(xi))
        for b, k in zip(_B, ks):
            x = x + dt * b * k
    return x


def arrays(root: str, config: dict) -> tuple:
    """The posterior's base state and data as the files hold them
    (numpy, float64)."""
    prob = config["problem"]
    return tuple(np.load(os.path.join(root, prob[k])).astype(np.float64)
                 for k in ("x0base", "data"))


def log_posterior(z, problem: dict, base, data, block: int = 1 << 16):
    """Unnormalised log-posterior at the rows z (M, d), in z's dtype,
    in blocks of ``block`` rows; ``base`` and ``data`` are tensors."""
    out = []
    for s in range(0, z.shape[0], block):
        x = z[s:s + block]
        y = integrate(x, problem["steps"])
        misfit = data.to(x.dtype)[None, :] - y[:, 1::2]
        ll = -0.5 * torch.sum(misfit ** 2, dim=1) / problem["sigma_n"] ** 2
        prior = -0.5 * torch.sum((x - base.to(x.dtype)[None, :]) ** 2, dim=1)
        out.append(ll + prior)
    return torch.cat(out)


def log_posterior_fn(root: str, config: dict, device,
                     dtype=torch.float64):
    """The reference's log-posterior z -> lp, computed in ``dtype``."""
    base, data = (torch.as_tensor(a, device=device)
                  for a in arrays(root, config))

    def lp(z):
        return log_posterior(z.to(dtype), config["problem"], base, data)

    return lp
