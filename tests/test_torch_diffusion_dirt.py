"""The slice as a whole: examples/run_diffusion_dirt.py's build at
meshlevel 0 (KLE d=5) in both packages, and the port's pipeline end to
end on 2^10 'n4' seeds.

* The ALS-Cross surrogate of the observables, from one coefficient TT
  (the JAX package's), within 1e-10 relative at 32 grid points.
* Level 0 of the Fourier DIRT bit for bit: both builds call one host
  density (the JAX package's surrogate, ``vec="host"``).
* The JAX-built stack served by the port within the spectral bars
  (1e-10 on at least 99% of rows, 1e-6 on every row).
* The port's own pipeline (coefficient cross, ALS-Cross, torch
  surrogate, Fourier DIRT): N/ESS against the exact FEM likelihood under
  2.0 (the JAX package gives 1.167 at these settings on 2^12 rows)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu.models import diffusion as jdf
from tt_irt_tpu.ops.interp import tt_sample_lagrange as jlagrange
from tt_irt_tpu.ops.tt import TT as JTT
from tt_irt_tpu.ops.tt import tt_eval_indices as jeval
from tt_irt_tpu.ops.tt import tt_reverse as jreverse
from tt_irt_tpu.ops.tt import tt_sum_many as jsum
from tt_irt_tpu_torch.models import diffusion as tdf

MESHLEVEL = 0
TOL = 7.6742e-03 * 4.0 ** (-MESHLEVEL - 1)      # htolfun
NY, NPI, RPI, Y0 = 7, 17, 8, 1.5
BETA = 10.0 ** np.arange(-1, 0.5, 0.5)
DIRT_KW = dict(nswp=1, kickrank=0, y0=RPI, boundary=True, stoptol=0.1,
               reference="n4", interpolation="fourier", testsamples=256,
               seed=0)
M = 1 << 10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process: the module's tensors are small and
    its operations many, so parallel test workers of eight threads each
    would oversubscribe the cores.  The caller's setting comes back
    afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_forward(pj, ygrids):
    """Coefficient cross and ALS-Cross in the JAX package; returns the
    coefficient TT and the reversed observables TT."""
    ell = pj.kle_dim
    terms = []
    for i in range(ell):
        cores = [jnp.asarray(
            (pj.phil[:, i] * np.sqrt(pj.sigma))[None, :, None])]
        for j in range(ell):
            cores.append(jnp.asarray(ygrids[j])[None, :, None] if j == i
                         else jnp.ones((1, len(ygrids[j]), 1)))
        terms.append(JTT(cores))
    af = ti.amen_cross_s([jsum(terms, eps=1e-12)],
                         lambda v: np.exp(np.asarray(v)[:, 0]),
                         min(TOL, 1e-4) * 0.1, y0=RPI, nswp=3, kickrank=2)
    u = ti.als_cross_parametric(af.tt, pj.assem_solve_fun(), TOL,
                                pua=pj.pua(), random_init=RPI, nswp=2,
                                kickrank=2).u
    u0 = np.asarray(u.cores[0][0])
    q_cols = np.stack([np.asarray(pj.observe(jnp.asarray(u0[:, j])))
                       for j in range(u0.shape[1])], axis=1)
    core1 = jnp.einsum("qa,anb->qnb", jnp.asarray(q_cols), u.cores[1])
    return af.tt, jreverse(JTT([core1] + list(u.cores[2:])))


def _port_forward(pt, ygrids, coeff=None):
    """The same in the port (from ``coeff`` when given); returns the
    reversed observables TT."""
    if coeff is None:
        coeff = tp.amen_cross_s([pt.log_coefficient_tt(ygrids)],
                                lambda v: torch.exp(v[:, 0]),
                                min(TOL, 1e-4) * 0.1, y0=RPI, nswp=3,
                                kickrank=2, torch_fun=True,
                                device="cpu").tt
    u = tp.als_cross_parametric(coeff, pt.assem_solve_fun(), TOL,
                                pua=pt.pua(), random_init=RPI, nswp=2,
                                kickrank=2, device="cpu").u
    return tp.tt_reverse(pt.observables_tt(u))


@pytest.fixture(scope="module")
def setup():
    pj = jdf.DiffusionProblem(meshlevel=MESHLEVEL, tol_kle=TOL * 3)
    pt = tdf.DiffusionProblem(meshlevel=MESHLEVEL, tol_kle=TOL * 3,
                              device="cpu")
    ygrids = pt.gauss_grids(NY)
    coeff_j, uav_j = _jax_forward(pj, ygrids)
    q_obs = pt.observations(Y0)
    rev_grids = list(reversed(ygrids))

    def surrogate_np(theta, b0, b1):
        vals = np.asarray(jlagrange(uav_j, rev_grids,
                                    jnp.asarray(np.asarray(theta)[:, ::-1])))
        mis = np.sum((vals - q_obs[None, :]) ** 2, axis=1)
        return -(b1 - b0) * mis / (2.0 * pt.sigma_n)

    grids0 = [np.linspace(-np.sqrt(3), np.sqrt(3), NPI)] * pt.kle_dim
    dj = ti.tt_dirt_approx(grids0, surrogate_np, BETA, vec="host",
                           nq=[16] * pt.kle_dim, **DIRT_KW)
    return dict(pj=pj, pt=pt, ygrids=ygrids, coeff_j=coeff_j, uav_j=uav_j,
                q_obs=q_obs, surrogate_np=surrogate_np, grids0=grids0,
                dj=dj)


def _seeds(d, seed=3):
    u = np.random.default_rng(seed).uniform(size=(M, d))
    return tp.uniform_to_tnormal(torch.from_numpy(u), 4.0)


def test_surrogate_matches_jax(setup):
    """The port's ALS-Cross on the JAX package's coefficient TT: the
    observables at 32 grid points within 1e-10 relative."""
    s = setup
    cores = [np.asarray(c) for c in s["coeff_j"].cores]
    rev_t = _port_forward(s["pt"], s["ygrids"],
                          tp.tt_from_numpy(cores, device="cpu"))
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, len(g), 32) for g in s["ygrids"]],
                   axis=1)[:, ::-1].copy()
    a = np.asarray(jeval(s["uav_j"], jnp.asarray(idx)))
    b = tp.tt_eval_indices(rev_t, torch.from_numpy(idx)).numpy()
    assert a.shape == (32, 9)
    assert np.max(np.abs(a - b)) / np.max(np.abs(a)) < 1e-10


def test_level0_bit_for_bit_and_jax_stack_served(setup):
    """The port's build on the same host density: level 0 bit for bit,
    the level grids equal; the JAX-built stack served by the port within
    the spectral bars."""
    s = setup
    pt, dj = s["pt"], s["dj"]
    dt = tp.tt_dirt_approx(s["grids0"], s["surrogate_np"], BETA,
                           vec="host", nq=[16] * pt.kle_dim, device="cpu",
                           **DIRT_KW)
    for a, b in zip(dj.f0.cores, dt.f0.cores):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(dj.x, dt.x):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    carried = tp.dirt_from_numpy(
        [np.asarray(c) for c in dj.f0.cores],
        [[np.asarray(c) for c in f.cores] for f in dj.fs],
        [np.asarray(g) for g in dj.x0], [np.asarray(g) for g in dj.x],
        np.asarray(dj.beta), dj.lfshift, reference=dj.reference,
        interpolation=dj.interpolation, device="cpu")
    q = _seeds(pt.kle_dim)
    zj, lj = ti.tt_dirt_sample(dj, jnp.asarray(q.numpy()))
    zt, lt = tp.tt_dirt_sample(carried, q, device="cpu")
    dz = np.max(np.abs(zt.numpy() - np.asarray(zj)), axis=1)
    dl = np.abs(lt.numpy() - np.asarray(lj))
    off = int(np.sum((dz >= 1e-10) | (dl >= 1e-10)))
    print(f"JAX-built diffusion DIRT in the port: {off} of {M} rows past "
          f"1e-10; largest {dz.max():.3e}, {dl.max():.3e}")
    assert off <= 0.01 * M and dz.max() < 1e-6 and dl.max() < 1e-6


def test_port_pipeline_n_over_ess(setup):
    """The port end to end: its own forward model, torch surrogate and
    Fourier DIRT; N/ESS against the exact FEM likelihood under 2.0, and
    DirtSampler equal to tt_dirt_sample bit for bit."""
    s = setup
    pt = s["pt"]
    rev = _port_forward(pt, s["ygrids"])
    rev_grids = list(reversed(s["ygrids"]))
    q_obs = torch.from_numpy(s["q_obs"])

    def surrogate(theta, b0, b1):
        vals = tp.tt_sample_lagrange(rev, rev_grids, theta.flip(1))
        return -(b1 - b0) * torch.sum((vals - q_obs) ** 2, 1) \
            / (2.0 * pt.sigma_n)

    dirt = tp.tt_dirt_approx(s["grids0"], surrogate, BETA,
                             nq=[16] * pt.kle_dim, device="cpu", **DIRT_KW)
    assert dirt.interpolation == "fourier" and dirt.nlevels == 2
    q = _seeds(pt.kle_dim, seed=4)
    z, lfapp = tp.tt_dirt_sample(dirt, q, device="cpu")
    zs, ls = tp.DirtSampler(dirt, device="cpu")(q)
    assert torch.equal(zs, z) and torch.equal(ls, lfapp)
    out = pt.likelihood_fn(s["q_obs"])(z)
    tau = float(tp.essinv(out[:, 0], lfapp))
    print(f"port diffusion DIRT (meshlevel 0): N/ESS {tau:.4f} on {M} rows")
    assert tau < 2.0, tau
