"""Inverse diffusion: Q1 FEM on the unit square with a cosine KLE
log-coefficient, windowed pressure observations and the exit-flux QoI
(counterpart of ``tt_irt_tpu/models/diffusion.py``; reference
matlab/examples/diffusion/{build_grid_and_kle.m, diffusion_assem_solve.m,
diffusion_likelihood.m, test_diffusion_tt.m}).

The FEM operator is separable,
A[(i1,i2),(j1,j2)] = sum_{k1,k2} C[k1,k2] (Wg[i1,j1,k1] Wm[i2,j2,k2]
                                         + Wm[i1,j1,k1] Wg[i2,j2,k2]),
with the 1-D P1 factor tensors Wg (gradient) and Wm (mass).  The grid,
the KLE, the windowed mass factors and the 1-D factors are numpy, as in
the JAX package; assembly, the Dirichlet elimination and the solves run
in f64 on the problem's device, batched over coefficient fields: dense
operators, ``torch.linalg.cholesky`` + ``torch.cholesky_solve`` (the
reduced operator is SPD).  The JAX package computes these in XLA too,
outside any Pallas kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.tt import TT, _chop_rank
from ..utils.device import resolve_device

__all__ = ["fem1d_factors", "DiffusionProblem", "assemble_matrix", "lgwt"]


def _add_host(a, b):
    """The TT sum of two numpy core lists (block-diagonal cores)."""
    d, cores = len(a), []
    for k, (ca, cb) in enumerate(zip(a, b)):
        if k == 0:
            cores.append(np.concatenate([ca, cb], axis=2))
        elif k == d - 1:
            cores.append(np.concatenate([ca, cb], axis=0))
        else:
            (ra1, n, ra2), (rb1, _, rb2) = ca.shape, cb.shape
            top = np.concatenate([ca, np.zeros((ra1, n, rb2))], axis=2)
            bot = np.concatenate([np.zeros((rb1, n, ra2)), cb], axis=2)
            cores.append(np.concatenate([top, bot], axis=0))
    return cores


def _round_host(cores, eps):
    """TT rounding of numpy cores in numpy, the JAX package's tt_round
    step for step: right-to-left QR, left-to-right truncated SVDs to
    relative accuracy ``eps``, the log-norm spread evenly over the
    cores."""
    cores, d = list(cores), len(cores)
    for k in range(d - 1, 0, -1):
        r1, n, r2 = cores[k].shape
        q, rmat = np.linalg.qr(np.reshape(cores[k], (r1, n * r2)).T)
        cores[k] = np.reshape(q.T, (q.shape[1], n, r2))
        cores[k - 1] = np.einsum("aib,cb->aic", cores[k - 1], rmat)
    # contiguous, as the JAX package's cores are between its two sweeps:
    # np.einsum's summation order depends on the layout
    cores = [np.ascontiguousarray(c) for c in cores]
    delta = eps / np.sqrt(max(d - 1, 1)) * float(
        np.linalg.norm(np.reshape(cores[0], (-1,))))
    for k in range(d - 1):
        r1, n, r2 = cores[k].shape
        u, s, vt = np.linalg.svd(np.reshape(cores[k], (r1 * n, r2)),
                                 full_matrices=False)
        r = _chop_rank(s, delta, None)
        cores[k] = np.reshape(u[:, :r], (r1, n, r))
        cores[k + 1] = np.einsum("ab,bic->aic", s[:r, None] * vt[:r, :],
                                 cores[k + 1])
    logn = np.array([np.log(max(float(np.linalg.norm(c.ravel())), 1e-300))
                     for c in cores])
    shift = logn.mean() - logn
    shift -= shift.mean()
    return [c * math.exp(sh) for c, sh in zip(cores, shift)]


def fem1d_factors(n: int, h: float):
    """Dense 1-D P1 factor tensors Wg[i,j,k] = int phi_k phi_i' phi_j'
    and Wm[i,j,k] = int phi_k phi_i phi_j on a uniform grid of n nodes
    (the stencils of build_grid_and_kle.m:27-156): Wg diag 1/h (boundary
    0.5/h), wings +-0.5/h; Wm diag h/2 (boundary h/4), wings h/12."""
    wg = np.zeros((n, n, n))
    wm = np.zeros((n, n, n))
    i = np.arange(n)
    wg[i, i, i] = 1.0 / h
    wg[0, 0, 0] = wg[n - 1, n - 1, n - 1] = 0.5 / h
    wg[i[:-1], i[:-1], i[:-1] + 1] = 0.5 / h
    wg[i[1:], i[1:], i[1:] - 1] = 0.5 / h
    wg[i[1:], i[1:] - 1, i[1:] - 1] = -0.5 / h
    wg[i[1:], i[1:] - 1, i[1:]] = -0.5 / h
    wg[i[:-1], i[:-1] + 1, i[:-1]] = -0.5 / h
    wg[i[:-1], i[:-1] + 1, i[:-1] + 1] = -0.5 / h
    wm[i, i, i] = h / 2.0
    wm[0, 0, 0] = wm[n - 1, n - 1, n - 1] = h / 4.0
    wm[i[:-1], i[:-1], i[:-1] + 1] = h / 12.0
    wm[i[1:], i[1:], i[1:] - 1] = h / 12.0
    wm[i[1:], i[1:] - 1, i[1:] - 1] = h / 12.0
    wm[i[1:], i[1:] - 1, i[1:]] = h / 12.0
    wm[i[:-1], i[:-1] + 1, i[:-1]] = h / 12.0
    wm[i[:-1], i[:-1] + 1, i[:-1] + 1] = h / 12.0
    return wg, wm


def assemble_matrix(cmat, wg, wm):
    """Dense stiffness matrices of nodal coefficient fields cmat
    (..., n, n): A[(i1,i2),(j1,j2)] = sum_k1k2 C[k1,k2] (Wg x Wm + Wm x
    Wg), shape (..., n*n, n*n)."""
    n = cmat.shape[-1]
    g2 = torch.einsum("ijk,...kl->...ijl", wg, cmat)
    m2 = torch.einsum("ijk,...kl->...ijl", wm, cmat)
    a = (torch.einsum("...ijl,pql->...ipjq", g2, wm)
         + torch.einsum("...ijl,pql->...ipjq", m2, wg))
    return a.reshape(cmat.shape[:-2] + (n * n, n * n))


def _spd_solve(a, b):
    """Cholesky solves of SPD systems a (..., N, N) x = b (..., N)."""
    c = torch.linalg.cholesky(a)
    return torch.cholesky_solve(b.unsqueeze(-1), c).squeeze(-1)


def lgwt(n: int, a: float, b: float):
    """Gauss-Legendre nodes and weights on [a, b], nodes descending (the
    reference's lgwt.m ordering, parse_diffusion_inputs.m:72-84)."""
    x, w = np.polynomial.legendre.leggauss(n)
    x = 0.5 * (b - a) * x + 0.5 * (b + a)
    w = 0.5 * (b - a) * w
    return x[::-1].copy(), w[::-1].copy()


@dataclass
class DiffusionProblem:
    """Grid, KLE and observation set-up (test_diffusion_tt.m defaults:
    sigma=1, corr_length=1, nu=2, sigma_n=1e-2, m0=3, Dirichlet-Neumann
    boundary conditions with u=1 on the left edge and u=0 on the right).
    The numpy fields are the JAX package's; the FEM runs on ``device``
    (default "cuda")."""

    meshlevel: int = 0
    nu: float = 2.0
    corr_length: float = 1.0
    sigma: float = 1.0
    sigma_n: float = 1e-2
    m0: int = 3
    tol_kle: float = 1e-2
    bc_type: str = "dn"
    device: str = "cuda"

    def __post_init__(self):
        self.dev = resolve_device(self.device)
        self.n = 2 ** (4 + self.meshlevel) + 1
        self.h = 2.0 ** (-4 - self.meshlevel)
        n = self.n
        p = np.linspace(0.0, 1.0, n)
        self.p1 = p
        wg, wm = fem1d_factors(n, self.h)
        self.wg = torch.tensor(wg, device=self.dev)
        self.wm = torch.tensor(wm, device=self.dev)
        # boundary nodes (x==0 left Dirichlet=1; x==1 right Dirichlet=0)
        xg, yg = np.meshgrid(p, p, indexing="ij")
        flat_left = np.nonzero(xg.ravel() == 0.0)[0]
        flat_right = np.nonzero(xg.ravel() == 1.0)[0]
        if self.bc_type.lower() == "dn":
            bound = np.concatenate([flat_left, flat_right])
        else:
            others = np.nonzero((yg.ravel() == 0.0) | (yg.ravel() == 1.0))[0]
            bound = np.unique(np.concatenate([flat_left, flat_right,
                                              others]))
        self.bound = bound
        self.bound_left = flat_left
        self.interior = np.setdiff1d(np.arange(n * n), bound)
        # KLE: cosine expansion with algebraic decay (reference :185-218)
        startpos = int(round(1.0 / self.corr_length)) - 1
        tol = self.tol_kle
        ell = int(np.ceil(np.exp(-np.log(tol * 0.1) / (self.nu + 1))))
        ell = min(ell, n * n)
        ind = np.arange(1, ell + 1)
        lam = np.concatenate([np.ones(startpos),
                              ind.astype(float) ** (-self.nu - 1)])
        lam = lam / lam.sum()
        cut = np.nonzero(lam < tol * lam[0])[0]
        ltrunc = int(cut[0]) if cut.size else lam.shape[0]
        lam = lam[:max(ltrunc, 1)]
        kk = np.arange(1, lam.shape[0] + 1)
        s = np.floor(-0.5 + np.sqrt(0.25 + 2 * kk))
        f1 = kk - s * (s + 1) * 0.5
        f2 = s - f1
        self.lam = lam
        # phi columns on the flattened (x-major) grid
        self.phi = (np.cos(2 * np.pi * np.outer(xg.ravel(), f1))
                    * np.cos(2 * np.pi * np.outer(yg.ravel(), f2)))
        self.phil = self.phi * np.sqrt(lam)[None, :]
        # windowed observation mass matrices (reference :223-250)
        self.mass1 = self._windowed_mass1(wm)
        dev = self.dev
        self._phil = torch.tensor(self.phil, device=dev)
        self._interior = torch.tensor(self.interior, device=dev)
        self._left = torch.tensor(self.bound_left, device=dev)
        # observe(): q[k + j m0] = rowsum(M_k) . u . colsum(M_j) (the
        # reference contracts kron(Mass1{j}, Mass1{k}) with u and sums)
        self._obs_rows = torch.tensor(
            np.stack([m.sum(axis=1) for m in self.mass1]), device=dev)
        self._obs_cols = torch.tensor(
            np.stack([m.sum(axis=0) for m in self.mass1]), device=dev)

    @property
    def kle_dim(self) -> int:
        return self.lam.shape[0]

    # ------------------------------------------------------------------
    # The pipeline of examples/run_diffusion.py and run_diffusion_dirt.py
    # ------------------------------------------------------------------
    def gauss_grids(self, ny: int):
        """Anisotropic Gauss-Legendre grids of the KLE coordinates on
        [-sqrt 3, sqrt 3] (test_diffusion_tt.m:66-74): ny nodes for the
        leading mode, down to 2."""
        ni = np.round(ny + (2 - ny) * (np.log(self.lam)
                                       / np.log(self.lam[-1]))).astype(int)
        return [lgwt(n, -np.sqrt(3), np.sqrt(3))[0]
                for n in np.maximum(ni, 2)]

    def log_coefficient_tt(self, ygrids, eps: float = 1e-12) -> TT:
        """Block TT of the log-coefficient sum_i sqrt(sigma) phil_i y_i on
        the device: the spatial core (left boundary rank 1) first, then
        one core per KLE coordinate on ``ygrids``; the ell rank-1 terms
        summed and rounded to ``eps`` on the host in numpy, as the JAX
        package rounds (its tt_round is host LAPACK): the coefficient
        cross downstream is unconverged at the examples' settings, so
        its result, and the surrogate built on it, follow the last bits
        of this TT (PERF.md, phase 24)."""
        terms = []
        for i in range(self.kle_dim):
            cores = [(self.phil[:, i] * np.sqrt(self.sigma))[None, :, None]]
            for j, g in enumerate(ygrids):
                cores.append(np.asarray(g, np.float64)[None, :, None]
                             if j == i else np.ones((1, len(g), 1)))
            terms.append(cores)
        while len(terms) > 1:
            nxt = [_round_host(_add_host(terms[i], terms[i + 1]), eps)
                   for i in range(0, len(terms) - 1, 2)]
            if len(terms) % 2:
                nxt.append(terms[-1])
            terms = nxt
        return TT([torch.from_numpy(c).to(self.dev) for c in terms[0]])

    def observables_tt(self, u: TT) -> TT:
        """The ALS-Cross solution's spatial block contracted with the
        observation operator (test_diffusion_tt.m:119-125): a TT over the
        KLE coordinates whose left boundary rank enumerates the m0^2
        observations."""
        q_cols = self.observe(u.cores[0][0].T).T          # (m0^2, r1)
        core1 = torch.einsum("qa,anb->qnb", q_cols, u.cores[1])
        return TT([core1] + list(u.cores[2:]))

    def observations(self, y0: float, seed: int = 0) -> np.ndarray:
        """Synthetic data: the observations of the solution at y = y0 in
        every coordinate plus N(0, sigma_n) noise from numpy
        ``default_rng(seed)`` (the examples' data)."""
        rng = np.random.default_rng(seed)
        cn = np.exp(np.sqrt(self.sigma)
                    * (self.phil @ np.full(self.kle_dim, y0)))
        q = self.observe(self.solve_one(cn)).cpu().numpy()
        return q + rng.standard_normal(self.m0 ** 2) * np.sqrt(self.sigma_n)

    def _windowed_mass1(self, wm):
        """1-D windowed mass factors: Mass1[i] = Wm contracted with the
        window indicator of cell i, (n, n) each."""
        n, m0 = self.n, self.m0
        out = []
        grid = self.p1
        for i in range(1, m0 + 1):
            ind = ((grid >= (i - 1) / (m0 + 1))
                   & (grid <= (i + 1) / (m0 + 1))).astype(float)
            ind = ind / (0.5 / (m0 + 1))
            m1 = np.einsum("ijk,k->ij", wm, ind)
            # boundary correction of partially covered cells (:228-239)
            nz = np.nonzero(ind)[0]
            if nz.size:
                il, ir = nz[0], nz[-1]
                if il > 0:
                    m1[il - 1, :] = 0.0
                    m1[:, il - 1] = 0.0
                    m1[il, il] = m1[il + 1, il + 1] * 0.5
                if ir < n - 1:
                    m1[ir + 1, :] = 0.0
                    m1[:, ir + 1] = 0.0
                    m1[ir, ir] = m1[ir - 1, ir - 1] * 0.5
            out.append(m1)
        return out

    # ------------------------------------------------------------------
    # Solvers
    # ------------------------------------------------------------------
    def _reduced(self, cb):
        """Nodal coefficient fields cb (B, n*n) -> the reduced operators
        (B, ni, ni) and right-hand sides (B, ni): the u=1 left-edge data
        moved to the right-hand side, rows and columns restricted to the
        interior dofs (diffusion_assem_solve.m:50-56)."""
        n = self.n
        amat = assemble_matrix(cb.reshape(-1, n, n), self.wg, self.wm)
        g = -torch.sum(amat.index_select(2, self._left), dim=2)
        g = g.index_select(1, self._interior)
        ared = amat.index_select(1, self._interior)
        del amat
        return ared.index_select(2, self._interior), g

    def _solve_batch(self, cb):
        """Full solutions (B, n*n), boundary values filled in, of the
        coefficient fields cb (B, n*n)."""
        ared, g = self._reduced(cb)
        u_in = _spd_solve(ared, g)
        del ared
        u = torch.zeros((cb.shape[0], self.n * self.n), dtype=torch.float64,
                        device=cb.device)
        u[:, self._interior] = u_in
        u[:, self._left] = 1.0
        return u

    def solve_one(self, cnodal):
        """Solve for one nodal coefficient field (n*n,) -> the full
        solution (n*n,) on the problem's device."""
        c = torch.as_tensor(cnodal, dtype=torch.float64, device=self.dev)
        return self._solve_batch(c.reshape(1, -1))[0]

    def assem_solve_fun(self, ygrids=None):
        """ALS-Cross spatial callback (diffusion_assem_solve.m API).

        Values mode: Ci (Mc, Nxc, r) coefficient snapshots.  Indices mode
        (als_cross_parametric.m:191-230): an (r, ell) integer matrix of
        0-based parametric grid indices; the coefficient is
        exp(sqrt(sigma) Phi_l y) at the nodes ``ygrids`` (required in
        this mode).  The coefficients are clipped to [1e-8, 1e9]
        (:17-24).  Returns (U (Nxu, r) numpy, A (r, Na, Na) f64 on the
        device, F (Na, r) numpy) on the first call and U alone after.
        The r snapshots assemble and solve in batches small enough for
        the dense operators to fit (the JAX package's chunking)."""
        first = {"done": False}
        chunk = max(1, int(2 ** 26) // (self.n ** 4))

        def fn(ci):
            ci = np.asarray(ci)
            if ci.ndim == 2 and np.issubdtype(ci.dtype, np.integer):
                if ygrids is None:
                    raise ValueError(
                        "indices-mode callback needs the parametric "
                        "grids: assem_solve_fun(ygrids=...)")
                yv = np.stack([np.asarray(ygrids[k])[ci[:, k]]
                               for k in range(ci.shape[1])], axis=1)
                coeff = np.exp(np.sqrt(self.sigma) * (yv @ self.phil.T))
            else:
                coeff = ci[0].T                          # (r, Nxc)
            coeff = torch.tensor(np.clip(coeff, 1e-8, 1e9), device=self.dev)
            r = coeff.shape[0]
            ni = self.interior.shape[0]
            keep = not first["done"]
            ared = (torch.empty((r, ni, ni), dtype=torch.float64,
                                device=self.dev) if keep else None)
            g = torch.empty((r, ni), dtype=torch.float64, device=self.dev)
            u = torch.zeros((r, self.n * self.n), dtype=torch.float64,
                            device=self.dev)
            for s in range(0, r, chunk):
                a_, g_ = self._reduced(coeff[s:s + chunk])
                u[s:s + chunk, self._interior] = _spd_solve(a_, g_)
                g[s:s + chunk] = g_
                if keep:
                    ared[s:s + chunk] = a_
                del a_
            u[:, self._left] = 1.0
            u_out = u.T.cpu().numpy()
            if keep:
                first["done"] = True
                return u_out, ared, g.T.cpu().numpy()
            return u_out

        return fn

    def pua(self):
        """Projector full-dof solution -> interior dofs (the reference's
        Pua, build_grid_and_kle.m:179-181), numpy."""
        n2 = self.n * self.n
        p = np.zeros((self.interior.shape[0], n2))
        p[np.arange(self.interior.shape[0]), self.interior] = 1.0
        return p

    def observe(self, u):
        """Windowed pressure observations: (..., n*n) -> (..., m0^2),
        Q[k + j*m0] = sum(Mass{k,j} u) (diffusion_likelihood.m:53-58)."""
        u = torch.as_tensor(u, dtype=torch.float64, device=self.dev)
        u2 = u.reshape(u.shape[:-1] + (self.n, self.n))
        q = torch.einsum("ka,...ac,jc->...jk", self._obs_rows, u2,
                         self._obs_cols)
        return q.reshape(u.shape[:-1] + (self.m0 * self.m0,))

    def exit_flux(self, cnodal, u):
        """Exit flux at the right edge (diffusion_likelihood.m:61-76),
        batched over leading axes of cnodal (..., n*n) and u (..., n*n)."""
        n = self.n
        cmat = torch.as_tensor(cnodal, dtype=torch.float64,
                               device=self.dev).reshape(
                                   cnodal.shape[:-1] + (n, n))
        u2 = torch.as_tensor(u, dtype=torch.float64,
                             device=self.dev).reshape(u.shape[:-1] + (n, n))
        # the test index summed out: the 1-D column sums of Wg and Wm
        wg_sum = torch.sum(self.wg, dim=0)
        wm_sum = torch.sum(self.wm, dim=0)
        # only the row i1 = n-1 of B[i1, j1, i2] is read
        g2 = torch.einsum("jk,...kl->...jl", self.wg[n - 1], cmat)
        m2 = torch.einsum("jk,...kl->...jl", self.wm[n - 1], cmat)
        b = (torch.einsum("...jl,pl->...jp", g2, wm_sum)
             + torch.einsum("...jl,pl->...jp", m2, wg_sum))
        return -torch.sum(b * u2, dim=(-2, -1))

    def likelihood_fn(self, q_obs, block: int = 128):
        """Exact log-likelihood and QoI columns [logL, flux, flux > 1.5]
        (diffusion_likelihood.m): fn(y (M, ell)) -> (M, 3) on the device,
        computed in blocks of ``block`` rows (assembly, Dirichlet
        elimination, batched Cholesky solves, observations, flux) into a
        preallocated output."""
        sqrt_sigma = float(np.sqrt(self.sigma))
        q_obs = torch.as_tensor(q_obs, dtype=torch.float64, device=self.dev)

        def fn(y):
            y = torch.as_tensor(y, dtype=torch.float64, device=self.dev)
            m = y.shape[0]
            out = torch.empty((m, 3), dtype=torch.float64, device=self.dev)
            for s in range(0, m, block):
                cn = torch.exp(torch.matmul(y[s:s + block], self._phil.T)
                               * sqrt_sigma)
                u = self._solve_batch(cn)
                q = self.observe(u)
                out[s:s + block, 0] = (-torch.sum((q - q_obs) ** 2, dim=1)
                                       / (2.0 * self.sigma_n))
                fl = self.exit_flux(cn, u)
                out[s:s + block, 1] = fl
                out[s:s + block, 2] = (fl > 1.5).to(torch.float64)
            return out

        return fn
