"""Quasi-Monte Carlo point sets (counterpart of
``tt_irt_tpu/samplers/qmc.py``, numpy, kept line for line so that both
packages give the same nodes bit for bit).

The reference ships a rank-1 lattice with a *downloaded* Kuo generating
vector (matlab/samplers/qmcnodes.m:4 + utils/check_qmc.m — the file
``lattice-39102-1024-1048576.3600.txt`` from the Cools-Kuo-Nuyens
embedded-lattice constructions).  This framework is self-contained, so
instead of shipping someone else's data file we *run the same kind of
construction ourselves*:

* ``cbc_lattice``: fast component-by-component (CBC) construction
  (Nuyens & Cools, Math. Comp. 75 (2006) 903) of a rank-1 lattice
  generating vector for N = 2^m points in the weighted Korobov space
  alpha = 2 with product weights gamma_j = 1/j^2 — the construction
  family and weights behind the reference's downloaded vector.  The
  group (Z/2^m)* = {+-5^a} reduces each CBC step to circular
  correlations over the cyclic factor, done with FFTs: O(N log N) per
  dimension instead of O(N^2).
* default backend: scrambled Sobol digital nets (Joe-Kuo direction
  numbers via scipy.stats.qmc) — equal-or-better equidistribution than
  the lattice for the d <= 40 regime of this library;
* 'lattice' backend: randomly-shifted rank-1 lattice using the CBC
  vector (qmcnodes.m semantics);
* 'korobov' backend: the round-1 power-multiplier fallback, kept for
  reproducibility of earlier results.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["qmcnodes", "cbc_lattice"]

# Korobov multiplier: a classic good choice for N=2^20-scale lattices.
_KOROBOV_A = 17797


def _omega_alpha2(n: int) -> np.ndarray:
    """The alpha=2 Korobov-space kernel at the lattice points:
    omega(x) = 2 pi^2 B_2(x) = 2 pi^2 (x^2 - x + 1/6), evaluated at
    k/N for k = 0..N-1.  Symmetric: omega(1-x) = omega(x)."""
    x = np.arange(n, dtype=np.float64) / n
    return 2.0 * np.pi ** 2 * (x * x - x + 1.0 / 6.0)


@lru_cache(maxsize=8)
def cbc_lattice(m: int, d: int, gamma_decay: float = 2.0) -> tuple:
    """Fast CBC generating vector z (length d) for N = 2^m points.

    Minimizes the worst-case error in the weighted Korobov space
    alpha=2 with product weights gamma_j = j^(-gamma_decay),
    component by component.  Uses the structure of the units group
    mod 2^m: every odd z is +-5^a, and omega's symmetry collapses the
    sign, so the error of all candidates is a sum over 2-adic layers
    of circular correlations in a, each evaluated with one FFT pair
    (Nuyens-Cools fast CBC, non-prime N variant).

    Returns a tuple of ints (hashable for the cache).
    """
    n = 1 << m
    gamma = np.arange(1, d + 1, dtype=np.float64) ** (-gamma_decay)
    om = _omega_alpha2(n)
    kk = np.arange(n, dtype=np.int64)
    p = 1.0 + gamma[0] * om          # z_1 = 1 (standard normalization)
    z = [1]
    if m < 3:
        # tiny N: brute force the remaining components
        for s in range(1, d):
            cands = np.arange(1, n, 2, dtype=np.int64)
            errs = [float(np.sum(om[(kk * c) % n] * p)) for c in cands]
            zs = int(cands[int(np.argmin(errs))])
            z.append(zs)
            p = p * (1.0 + gamma[s] * om[(kk * zs) % n])
        return tuple(z)

    lfull = 1 << (m - 2)
    pow5 = np.empty(lfull, dtype=np.int64)
    pow5[0] = 1
    for a in range(1, lfull):
        pow5[a] = (pow5[a - 1] * 5) % n

    for s in range(1, d):
        ev = np.zeros(lfull)
        for t in range(3, m + 1):
            c = m - t
            lt = 1 << (t - 2)
            o = pow5[:lt] % (1 << t)            # the +5^a class mod 2^t
            w = om[(o << c) % n]                # omega({o z / 2^t}) at a=0
            # p at both sign classes: {+-5^a * 2^c}
            q = p[o << c] + p[((1 << t) - o) << c]
            # E_t(a_z) = sum_a w[(a_z + a) mod lt] q[a]: one FFT pair
            corr = np.fft.irfft(np.fft.rfft(w) * np.conj(np.fft.rfft(q)),
                                lt)
            ev += np.tile(corr, lfull // lt)
        # layers t = 1, 2 and k = 0 are the same for every odd z
        a_star = int(np.argmin(ev))
        zs = int(pow5[a_star])
        z.append(zs)
        p = p * (1.0 + gamma[s] * om[(kk * zs) % n])
    return tuple(z)


def qmcnodes(d: int, log2n: int, seed=0, method: str = "sobol") -> np.ndarray:
    """2^log2n randomized-QMC nodes in [0,1)^d, returned as (N, d).

    (The reference returns d x N; we use the sample-major layout used
    everywhere else in this framework.)  ``method``: 'sobol' (default),
    'lattice' (CBC-constructed randomly-shifted rank-1 lattice,
    qmcnodes.m semantics) or 'korobov' (power-multiplier fallback).
    """
    n = 1 << int(log2n)
    rng = np.random.default_rng(seed)
    if method == "sobol":
        from scipy.stats import qmc

        eng = qmc.Sobol(d, scramble=True, seed=rng)
        return eng.random(n)
    if method in ("lattice", "korobov"):
        if method == "lattice":
            z = np.asarray(cbc_lattice(int(log2n), d), dtype=np.int64)
        else:
            z = np.empty(d, dtype=np.int64)
            z[0] = 1
            for j in range(1, d):
                z[j] = (z[j - 1] * _KOROBOV_A) % n
        k = np.arange(n, dtype=np.float64)[:, None]
        y = k * (z[None, :].astype(np.float64) / n)
        shift = rng.random((1, d))
        return (y + shift) % 1.0
    raise ValueError(f"unknown QMC method {method!r}")
