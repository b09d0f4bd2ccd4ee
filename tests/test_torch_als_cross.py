"""The port's ALS-Cross (constructors/als_cross.py) against the JAX
package's: the batched reduced solves and Galerkin projections on random
operands, the synthetic linear systems of tests/test_als_cross.py, and
the diffusion forward pipeline (tests/test_als_cross.py:133-189), each
on the same coefficient TT (the JAX package's cores) and the same
callbacks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu.constructors import als_cross as jals
from tt_irt_tpu.models import diffusion as jdf
from tt_irt_tpu.ops.tt import TT as JTT
from tt_irt_tpu.ops.tt import tt_eval_indices as jeval
from tt_irt_tpu.ops.tt import tt_full as jfull
from tt_irt_tpu.ops.tt import tt_sum_many as jsum
from tt_irt_tpu_torch.constructors import als_cross as tals
from tt_irt_tpu_torch.models import diffusion as tdf


def _np(t):
    return [np.asarray(c) if not torch.is_tensor(c) else c.numpy()
            for c in t.cores]


def _port_tt(t):
    return tp.tt_from_numpy(_np(t), device="cpu")


@pytest.mark.parametrize("ru,rc,m", [(3, 2, 7), (8, 5, 40)])
def test_blockdiag_kernels_match_jax(ru, rc, m):
    rng = np.random.default_rng(ru)
    base = rng.standard_normal((ru, ru))
    uau = np.stack([base @ base.T + ru * np.eye(ru)
                    + 0.1 * rng.standard_normal((ru, ru)) for _ in range(rc)],
                   axis=2)
    crc = rng.uniform(0.5, 1.5, (rc, m))
    crf = rng.standard_normal((ru, m))
    a = jals.solve_blockdiag(uau, crc, crf)
    b = tals.solve_blockdiag(uau, crc, crf, device="cpu")
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12 * np.abs(a).max())
    n = 5
    core = rng.standard_normal((rc, n, 4))
    cru = rng.standard_normal((ru, n, 6))
    a = jals.project_blockdiag(uau, core, cru)
    b = tals.project_blockdiag(uau, core, cru, device="cpu")
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12 * np.abs(a).max())


# ---- tests/test_als_cross.py's manufactured linear system ----

def _linear_system():
    nx, n1, n2 = 20, 7, 6
    x = np.linspace(0, 1, nx)
    base = 2.0 + np.sin(2 * np.pi * x)
    w1 = 0.3 * np.cos(np.pi * x)
    w2 = 0.2 * x
    y1 = np.linspace(-1, 1, n1)
    y2 = np.linspace(-1, 1, n2)
    c0 = np.stack([base, w1, w2], axis=1)[None]
    p1 = np.zeros((3, n1, 3))
    p1[0, :, 0] = 1.0
    p1[1, :, 1] = y1
    p1[2, :, 2] = 1.0
    p2 = np.zeros((3, n2, 1))
    p2[0, :, 0] = 1.0
    p2[1, :, 0] = 1.0
    p2[2, :, 0] = y2
    dmat = np.eye(nx) * 2.0 - np.eye(nx, k=1) - np.eye(nx, k=-1)
    mmat = np.eye(nx) + 0.1 * np.eye(nx, k=1)

    def coeff_at(i1, i2):
        return base + y1[i1] * w1 + y2[i2] * w2

    def make_assem(indices):
        state = {"first": True}

        def assem(ci):
            ci = np.asarray(ci)
            cs = ([coeff_at(i1, i2) for i1, i2 in ci] if indices
                  else [ci[0, :, j] for j in range(ci.shape[2])])
            amats = [np.diag(c) @ dmat for c in cs]
            fs = [mmat @ c for c in cs]
            us = [np.linalg.solve(a, f) for a, f in zip(amats, fs)]
            if state["first"]:
                state["first"] = False
                return np.stack(us, 1), amats, np.stack(fs, 1)
            return np.stack(us, 1)

        return assem

    full = np.stack([np.stack([np.linalg.solve(np.diag(coeff_at(i1, i2))
                                               @ dmat, mmat @ coeff_at(i1, i2))
                               for i2 in range(n2)], axis=1)
                     for i1 in range(n1)], axis=1)
    return [c0, p1, p2], make_assem, full


CASES = {
    # tests/test_als_cross.py: amen_converges, single_sweep_fixed_rank,
    # indices_mode, random_init_with_kickrank; "exact" is that test's bar
    # on the relative Frobenius error against the exact solution
    "amen": dict(tol=1e-10, exact=1e-10, kw=dict(nswp=5, kickrank=8)),
    "single_sweep": dict(tol=1e-6, exact=1e-2,
                         kw=dict(nswp=1, kickrank=0, random_init=5)),
    "indices": dict(tol=1e-8, exact=1e-6,
                    kw=dict(nswp=3, kickrank=4, funarg="indices")),
    "random_init_kick": dict(tol=1e-10, exact=1e-8,
                             kw=dict(nswp=4, kickrank=4, random_init=5)),
}
# The cases whose spatial rank and solve count the last bits decide: the
# JAX package against itself with its operators moved by one ulp changes
# both (printed by the test).
ULP_DECIDED = ("indices", "random_init_kick")


def _values_close(uj, ut, rng, rel=1e-10, m=64):
    """Values at m random indices within ``rel`` of the largest."""
    idx = np.stack([rng.integers(0, n, m) for n in uj.n], axis=1)
    a = np.asarray(jeval(uj, jnp.asarray(idx)))
    b = tp.tt_eval_indices(ut, torch.from_numpy(idx)).numpy()
    err = np.max(np.abs(a - b)) / np.max(np.abs(a))
    assert err < rel, err


def _one_ulp(assem):
    """The callback with its operators moved by one ulp."""
    def f(ci):
        out = assem(ci)
        if isinstance(out, tuple):
            u, amats, fs = out
            return u, [a * (1.0 + 2.0 ** -52) for a in amats], fs
        return out
    return f


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(a)


@pytest.mark.parametrize("name", sorted(CASES))
def test_synthetic_systems_match_jax(name):
    """Ranks and funevals equal, values at random indices within 1e-10
    relative of the JAX package's solution, and the JAX test's own bar
    against the exact solution.  In the ULP_DECIDED cases (AMEn
    enrichment on a converged residual, then truncation at the
    tolerance) the JAX package misses the first two against itself under
    one ulp; there the port's departure from the JAX solution is held to
    10x the JAX package's own under one ulp, and the exact bar holds."""
    cores, make_assem, full = _linear_system()
    case = CASES[name]
    indices = case["kw"].get("funarg") == "indices"

    def run_jax(assem):
        return ti.als_cross_parametric(JTT([jnp.asarray(c) for c in cores]),
                                       assem, case["tol"], **case["kw"])

    rj = run_jax(make_assem(indices))
    rt = tp.als_cross_parametric(tp.tt_from_numpy(cores, device="cpu"),
                                 make_assem(indices), case["tol"],
                                 device="cpu", **case["kw"])
    assert rt.u.device.type == "cpu"
    full_j = np.asarray(jfull(rj.u))
    full_t = tp.tt_full(rt.u).numpy()
    assert _rel(full, full_t) < case["exact"]
    if name not in ULP_DECIDED:
        assert rt.u.ranks == rj.u.ranks and rt.funevals == rj.funevals
        _values_close(rj.u, rt.u, np.random.default_rng(1))
        assert _rel(full_j, full_t) < 1e-10
        return
    ru = run_jax(_one_ulp(make_assem(indices)))
    jax_ulp = _rel(full_j, np.asarray(jfull(ru.u)))
    port = _rel(full_j, full_t)
    print(f"{name}: ranks JAX {rj.u.ranks}, JAX one ulp {ru.u.ranks}, port "
          f"{rt.u.ranks}; funevals {rj.funevals}, {ru.funevals}, "
          f"{rt.funevals}; gap JAX one ulp {jax_ulp:.3e}, port {port:.3e}")
    assert (ru.u.ranks, ru.funevals) != (rj.u.ranks, rj.funevals)
    assert port <= 10.0 * jax_ulp, (port, jax_ulp)


def _diffusion_coeff(prob, ygrids):
    """tests/test_als_cross.py's exp(affine KLE) coefficient TT, built by
    the JAX package (its cores are handed to both ALS-Crosses)."""
    ell = prob.kle_dim
    terms = []
    for i in range(ell):
        cores = [jnp.asarray(
            (prob.phil[:, i] * np.sqrt(prob.sigma))[None, :, None])]
        for j in range(ell):
            cores.append(jnp.asarray(ygrids[j])[None, :, None] if j == i
                         else jnp.ones((1, len(ygrids[j]), 1)))
        terms.append(JTT(cores))
    log_a = jsum(terms, eps=1e-12)
    return ti.amen_cross_s([log_a], lambda v: np.exp(np.asarray(v)[:, 0]),
                           1e-6, y0=8, nswp=4, kickrank=3).tt


def test_diffusion_forward_pipeline_matches_jax():
    """tests/test_als_cross.py::test_diffusion_forward_pipeline in both
    packages on one coefficient TT: ranks and funevals equal, values at
    random indices within 1e-10 relative, and the port's surrogate of
    the observables against direct solves at the JAX test's bars (rtol
    2e-2, atol 1e-4)."""
    pj = jdf.DiffusionProblem(meshlevel=0, tol_kle=3e-2)
    pt = tdf.DiffusionProblem(meshlevel=0, tol_kle=3e-2, device="cpu")
    ni = np.round(8 + (2 - 8) * (np.log(pj.lam)
                                 / np.log(pj.lam[-1]))).astype(int)
    ygrids = [jdf.lgwt(n, -np.sqrt(3), np.sqrt(3))[0]
              for n in np.maximum(ni, 2)]
    coeff = _diffusion_coeff(pj, ygrids)
    kw = dict(random_init=8, nswp=1, kickrank=0)
    rj = ti.als_cross_parametric(coeff, pj.assem_solve_fun(), 1e-5,
                                 pua=pj.pua(), **kw)
    rt = tp.als_cross_parametric(_port_tt(coeff), pt.assem_solve_fun(), 1e-5,
                                 pua=pt.pua(), device="cpu", **kw)
    assert rt.u.ranks == rj.u.ranks and rt.funevals == rj.funevals
    rng = np.random.default_rng(1234)
    _values_close(rj.u, rt.u, rng)
    u = rt.u
    q_cols = pt.observe(u.cores[0][0].T).T                # (m0^2, r1)
    uav = tp.TT([torch.einsum("qa,anb->qnb", q_cols, u.cores[1])]
                + list(u.cores[2:]))
    rev = tp.tt_reverse(uav)
    for _ in range(3):
        idx = np.array([rng.integers(0, len(g)) for g in ygrids])
        yval = np.array([g[i] for g, i in zip(ygrids, idx)])
        pred = tp.tt_eval_indices(
            rev, torch.from_numpy(idx[::-1].copy())[None, :]).numpy()[0]
        cn = np.exp(np.sqrt(pt.sigma) * (pt.phil @ yval))
        qdir = pt.observe(pt.solve_one(cn)).numpy()
        np.testing.assert_allclose(pred, qdir, rtol=2e-2, atol=1e-4)


def test_diffusion_indices_mode_matches_values_mode():
    """tests/test_als_cross.py's indices-mode test in the port: the
    surrogate from parameter indices within 1e-3 (the surrogate
    tolerance) of the values-mode one."""
    pt = tdf.DiffusionProblem(meshlevel=0, tol_kle=5e-2, device="cpu")
    pj = jdf.DiffusionProblem(meshlevel=0, tol_kle=5e-2)
    ygrids = [jdf.lgwt(5, -np.sqrt(3), np.sqrt(3))[0]
              for _ in range(pj.kle_dim)]
    coeff = _port_tt(_diffusion_coeff(pj, ygrids))
    kw = dict(pua=pt.pua(), nswp=2, kickrank=2, device="cpu")
    r1 = tp.als_cross_parametric(coeff, pt.assem_solve_fun(), 1e-6, **kw)
    r2 = tp.als_cross_parametric(coeff, pt.assem_solve_fun(ygrids=ygrids),
                                 1e-6, funarg="indices", **kw)
    f1, f2 = tp.tt_full(r1.u).numpy(), tp.tt_full(r2.u).numpy()
    assert np.linalg.norm(f1 - f2) / np.linalg.norm(f1) < 1e-3
    with pytest.raises(ValueError, match="ygrids"):
        pt.assem_solve_fun()(np.zeros((2, pt.kle_dim), np.int64))


def test_als_cross_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cores, make_assem, _ = _linear_system()
    with pytest.raises(RuntimeError, match="not available"):
        tp.als_cross_parametric(tp.tt_from_numpy(cores, device="cpu"),
                                make_assem(False), 1e-6, nswp=1, kickrank=0)
    with pytest.raises(RuntimeError, match="not available"):
        tdf.DiffusionProblem(meshlevel=0)
