"""Statistical diagnostics (counterpart of
``tt_irt_tpu/samplers/diagnostics.py``): ``essinv`` and ``hellinger`` on
tensors (max-shifted in log space for overflow safety), and ``iact`` and
``tt_marginals``, which are host numpy in the JAX package and stay so
here (a copy)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["essinv", "hellinger", "iact", "tt_marginals"]


def essinv(lfex, lfapp) -> torch.Tensor:
    """N/ESS = 1 + chi^2 divergence estimate from log density pairs
    (max-shifted in log space for overflow safety)."""
    df = torch.as_tensor(lfex) - torch.as_tensor(lfapp)
    df = df - torch.max(df)
    w = torch.exp(df)
    return df.shape[0] * torch.sum(w * w) / torch.sum(w) ** 2


def hellinger(lfex, lfapp) -> torch.Tensor:
    """Sample Hellinger distance: 2H^2 = E_app[sqrt(Fex/Zex/Fapp) - 1]^2
    with the normalising constant estimated from the same samples."""
    df = torch.as_tensor(lfex) - torch.as_tensor(lfapp)
    df = df - torch.max(df)
    lzex = torch.log(torch.mean(torch.exp(df)))
    h2 = torch.mean((torch.exp(0.5 * (df - lzex)) - 1.0) ** 2)
    return torch.sqrt(h2 / 2.0)


def iact(x, s: float = 1.5, return_error: bool = False):
    """Integrated autocorrelation time per chain column, as 2 tau_int
    (the UWerr convention), by the Gamma method with Wolff's automatic
    window: autocovariances by FFT; the window is the first W where
    exp(-W/tau(W)) - tau(W)/sqrt(W N) < 0, with
    tau(W) = s / log((2 tau_int + 1) / (2 tau_int - 1)).

    Accepts (N,) or (N, k) (numpy or a tensor); returns a scalar or a
    (k,) numpy array, and with ``return_error=True`` also Wolff's error
    2 tau_int * 2 sqrt((W + 0.5 - tau_int) / N)."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, dtype=np.float64)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n, k = x.shape
    out = np.empty(k)
    err = np.empty(k)
    for j in range(k):
        v = x[:, j] - x[:, j].mean()
        nfft = int(2 ** np.ceil(np.log2(2 * n)))
        f = np.fft.rfft(v, nfft)
        acov = np.fft.irfft(f * np.conj(f), nfft)[:n].real
        acov /= np.arange(n, 0, -1)
        if acov[0] <= 0:
            out[j], err[j] = 1.0, 0.0
            continue
        rho = acov / acov[0]
        tau_int = 0.5
        wmax = min(n // 2, 10000)
        wopt = wmax
        for w in range(1, wmax):
            tau_int += rho[w]
            if tau_int <= 0.5:
                tau_w = 1e-8          # a noise-dominated chain
            else:
                tau_w = s / np.log((2.0 * tau_int + 1.0)
                                   / (2.0 * tau_int - 1.0))
            if np.exp(-w / tau_w) - tau_w / np.sqrt(w * n) < 0:
                wopt = w
                break
        tau_int = max(tau_int, 0.5)
        out[j] = 2.0 * tau_int
        err[j] = out[j] * 2.0 * np.sqrt(max(wopt + 0.5 - tau_int, 0.0) / n)
    if return_error:
        return (out[0], err[0]) if squeeze else (out, err)
    return out[0] if squeeze else out


def tt_marginals(tt, pair=(0, 1)):
    """The per-dimension contractions of a TT over every other mode,
    m1[k](j), and the 2-D contraction over the dimensions ``pair``
    (for a level's sqrt-ratio TT: its 1-D marginal curves and the 2-D
    marginal surface).  Returns (m1: list of d (n_k,) arrays,
    m2: (n_i, n_j) array), in host numpy."""
    cores = [c.detach().cpu().numpy() if torch.is_tensor(c)
             else np.asarray(c) for c in tt.cores]
    d = len(cores)
    tmats = [c.sum(axis=1) for c in cores]
    left = [np.ones((1, cores[0].shape[0]))]
    for k in range(d - 1):
        left.append(left[-1] @ tmats[k])
    right = [None] * (d + 1)
    right[d] = np.ones((cores[-1].shape[2], 1))
    for k in range(d - 1, -1, -1):
        right[k] = tmats[k] @ right[k + 1]
    m1 = [np.einsum("a,anb,b->n", left[k][0], cores[k], right[k + 1][:, 0])
          for k in range(d)]
    i, j = sorted(pair)
    mid = np.eye(cores[i].shape[2])
    for k in range(i + 1, j):
        mid = mid @ tmats[k]
    m2 = np.einsum("a,anb,bc,cmd,d->nm", left[i][0], cores[i], mid,
                   cores[j], right[j + 1][:, 0])
    return m1, m2
