"""The JAX package's figures for chip_smoke.py's inverse-diffusion phases
23 and 24, on the CPU (IEEE f64), at their settings (chip_smoke.DIFF_*):
meshlevel 1 (n = 33, KLE d = 8).

* ``ttmh`` (phase 23, examples/run_diffusion.py's pipeline): coefficient
  cross, ALS-Cross with the FEM callback, the posterior cross of the
  re-interpolated observables, 2^14 uniform seeds through ``tt_irt_lin``,
  the exact FEM likelihood, ``mcmc_prune``, IACT of the flux.
* ``dirt`` (phase 24, examples/run_diffusion_dirt.py's ``build``, run as
  the example module's own function): coefficient cross, ALS-Cross,
  Fourier DIRT; 2^16 'n4' seeds through ``tt_dirt_sample``, the exact
  likelihood, N/ESS, ``mcmc_prune``, IACT of the flux.

The one change from those settings: the exact FEM likelihood (dense
1023-dof Cholesky solves, more than a second a row on an eight-core CPU
running both pipelines) is evaluated on the first ``--rows`` rows
(default 2^10), and N/ESS, the MH chain, IACT and the QoI use those
rows.  Each pipeline runs in a
process of its own, both started together; the JSON records rows and
seconds.  chip_smoke.py reads the gates' reference figures from it.

How far phase 24's build depends on the last bits (``--stacks``): the
JAX package's own build at seed 0, at seed 0 with every value of the
coefficient cross's function moved by one ulp (x (1 + 2^-52)), and at
DIRT seeds 1 and 2, each in a process of its own; every stack is saved
with the JAX package's ``save_dirt`` under tests/data/diffusion_stacks/
(the port's ``load_dirt`` reads it), with the coefficient TT's largest
error against exp(log-coefficient) at 64 random grid points, the
ALS-Cross ranks and solves, and the level history.  On the card,
tools/diffusion_spread.py serves every one of these stacks and
chip_smoke.py phase 24 the seed-0 one, against the exact likelihood on
2^16 rows (the CPU cannot afford that).

Usage: python tests/diffusion_witness.py [--rows 1024] [--out FILE]
[--stacks] (the default FILE is tests/data/diffusion_witness.json; the
witness takes about 30 min on eight cores and 5-10 GB of memory, the
stacks about 2 min).  Not a pytest module.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (DIFF_DIRT, DIFF_MESHLEVEL, DIFF_STACKS,  # noqa: E402
                        DIFF_TTMH, DIFF_WITNESS, diff_tol)

# name -> (DIRT seed, coefficient function values moved by one ulp)
STACKS = {"seed0": (0, False), "seed0_ulp": (0, True), "seed1": (1, False),
          "seed2": (2, False)}


def _jax():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def _chain_stats(ti, jax, y, out, lfapp, key, rows):
    """N/ESS, the MH chain, IACT of the flux and the QoI on the first
    ``rows`` rows."""
    lfapp = lfapp[:rows]
    tau = float(ti.essinv(out[:, 0], lfapp))
    mh = ti.mcmc_prune(y[:rows], out, lfapp, key=jax.random.PRNGKey(key))
    return {"n_over_ess": tau,
            "reject_rate": float(mh.num_rejects) / rows,
            "iact_flux": float(ti.iact(np.asarray(mh.lfex[:, 1]))),
            "qoi_flux": float(np.asarray(mh.lfex[:, 1]).mean()),
            "qoi_p_flux_gt_1p5": float(np.asarray(mh.lfex[:, 2]).mean())}


def ttmh(rows):
    """Phase 23's pipeline in the JAX package (examples/run_diffusion.py
    with --meshlevel 1 and chip_smoke.DIFF_TTMH)."""
    jax = _jax()
    import jax.numpy as jnp

    import tt_irt_tpu as ti
    from tt_irt_tpu.models import diffusion as df
    from tt_irt_tpu.ops.interp import lagrange_matrix
    from tt_irt_tpu.ops.tt import TT, tt_eval_indices, tt_reverse, \
        tt_sum_many

    a = types.SimpleNamespace(**DIFF_TTMH)
    rec = {"rows": rows}
    t_all = time.perf_counter()
    tol = diff_tol(DIFF_MESHLEVEL)
    prob = df.DiffusionProblem(meshlevel=DIFF_MESHLEVEL, tol_kle=tol * 3)
    ell = prob.kle_dim
    ni = np.maximum(np.round(a.ny + (2 - a.ny) * (
        np.log(prob.lam) / np.log(prob.lam[-1]))).astype(int), 2)
    ygrids = [df.lgwt(n, -np.sqrt(3), np.sqrt(3))[0] for n in ni]
    terms = []
    for i in range(ell):
        cores = [jnp.asarray(
            (prob.phil[:, i] * np.sqrt(prob.sigma))[None, :, None])]
        for j in range(ell):
            cores.append(jnp.asarray(ygrids[j])[None, :, None] if j == i
                         else jnp.ones((1, len(ygrids[j]), 1)))
        terms.append(TT(cores))
    log_a = tt_sum_many(terms, eps=1e-12)
    t0 = time.perf_counter()
    af = ti.amen_cross_s([log_a], lambda v: np.exp(np.asarray(v)[:, 0]),
                         min(tol, 1e-4), y0=a.rmax, nswp=1, kickrank=0)
    res = ti.als_cross_parametric(af.tt, prob.assem_solve_fun(), tol,
                                  pua=prob.pua(), random_init=a.rmax,
                                  nswp=1, kickrank=0)
    rec.update(kle_dim=ell, forward_s=time.perf_counter() - t0,
               coeff_ranks=[int(r) for r in af.tt.ranks],
               als_ranks=[int(r) for r in res.u.ranks],
               pde_solves=int(res.funevals))
    u = res.u
    u0 = np.asarray(u.cores[0][0])
    q_cols = np.asarray(prob.observe(jnp.asarray(u0.T))).T
    uav = TT([jnp.einsum("qa,anb->qnb", jnp.asarray(q_cols), u.cores[1])]
             + list(u.cores[2:]))
    rng = np.random.default_rng(0)
    cn = np.exp(np.sqrt(prob.sigma) * (prob.phil @ np.full(ell, a.y0)))
    q_obs = np.asarray(prob.observe(prob.solve_one(jnp.asarray(cn)))) + \
        rng.standard_normal(prob.m0 ** 2) * np.sqrt(prob.sigma_n)
    ys = [np.linspace(-np.sqrt(3), np.sqrt(3), a.npi) for _ in range(ell)]
    uav_uni = TT([jnp.einsum("pm,amb->apb",
                             jnp.asarray(np.asarray(lagrange_matrix(g, y))),
                             c)
                  for g, y, c in zip(ygrids, ys, uav.cores)])
    uav_uni_rev = tt_reverse(uav_uni)
    q_obs_j = jnp.asarray(q_obs)

    def post_fun(ind):
        vals = tt_eval_indices(uav_uni_rev, jnp.asarray(ind)[:, ::-1])
        mis = jnp.sum((vals - q_obs_j[None, :]) ** 2, axis=1)
        return jnp.exp(-mis / (2.0 * prob.sigma_n))

    t0 = time.perf_counter()
    pi = ti.amen_cross_s([a.npi] * ell, post_fun, 0.0, tol_exit=a.delta,
                         y0=a.rmax, kickrank=0, nswp=1, seed=1)
    rec.update(posterior_cross_s=time.perf_counter() - t0,
               posterior_ranks=[int(r) for r in pi.tt.ranks])
    m = 1 << a.log2n
    z = jax.random.uniform(jax.random.PRNGKey(5), (m, ell),
                           dtype=jnp.float64)
    y, lfapp = ti.tt_irt_lin(ys, pi.tt, z)
    t0 = time.perf_counter()
    out = prob.likelihood_fn(q_obs)(y[:rows])
    out.block_until_ready()
    rec["likelihood_s"] = time.perf_counter() - t0
    rec.update(_chain_stats(ti, jax, y, out, lfapp, 6, rows))
    rec["seconds"] = time.perf_counter() - t_all
    return rec


def _example():
    spec = importlib.util.spec_from_file_location(
        "run_diffusion_dirt", os.path.join(ROOT, "examples",
                                           "run_diffusion_dirt.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example


def _build(seed=0, ulp=False):
    """examples/run_diffusion_dirt.py's own ``build`` at chip_smoke's
    settings, with the DIRT seed ``seed`` and, with ``ulp``, the
    coefficient cross's function values moved by one ulp.  Returns (jax,
    the JAX package, the problem, the stack, the observations, a record
    of the coefficient cross, the ALS-Cross and the build)."""
    jax = _jax()
    import jax.numpy as jnp

    import tt_irt_tpu as ti
    from tt_irt_tpu.models import diffusion as df
    from tt_irt_tpu.ops.tt import tt_eval_indices

    example = _example()
    seen = {}
    cross, als, approx = (ti.amen_cross_s, ti.als_cross_parametric,
                          ti.tt_dirt_approx)

    def cross_(inp, fun, *args, **kw):
        if ulp:
            def fun_(v, _f=fun):
                return np.asarray(_f(v)) * (1.0 + 2.0 ** -52)
        else:
            fun_ = fun
        res = cross(inp, fun_, *args, **kw)
        seen["coeff"], seen["log_a"] = res.tt, inp[0]
        return res

    def als_(*args, **kw):
        res = als(*args, **kw)
        seen["als"] = res
        return res

    def approx_(*args, **kw):
        return approx(*args, **dict(kw, seed=seed))

    ti.amen_cross_s, ti.als_cross_parametric, ti.tt_dirt_approx = \
        cross_, als_, approx_
    try:
        a = types.SimpleNamespace(**{k: v for k, v in DIFF_DIRT.items()
                                     if k != "build"})
        tol = diff_tol(DIFF_MESHLEVEL)
        prob = df.DiffusionProblem(meshlevel=DIFF_MESHLEVEL, tol_kle=tol * 3)
        dirt_, q_obs, t_build = example.build(a, prob, prob.kle_dim, tol)
    finally:
        ti.amen_cross_s, ti.als_cross_parametric, ti.tt_dirt_approx = \
            cross, als, approx
    rng = np.random.default_rng(0)
    coeff = seen["coeff"]
    idx = jnp.asarray(np.stack([rng.integers(0, n, 64) for n in coeff.n],
                               axis=1))
    exact = np.exp(np.asarray(tt_eval_indices(seen["log_a"], idx)))
    approx_vals = np.asarray(tt_eval_indices(coeff, idx))
    rec = {"coeff_ranks": [int(r) for r in coeff.ranks],
           "coeff_max_rel_err": float(np.max(np.abs(approx_vals - exact))
                                      / np.max(np.abs(exact))),
           "als_ranks": [int(r) for r in seen["als"].u.ranks],
           "pde_solves": int(seen["als"].funevals),
           "build_s": t_build,
           "level_ranks": [[int(r) for r in f.ranks]
                           for f in [dirt_.f0] + list(dirt_.fs)],
           "history": [{k: h[k] for k in ("level", "attempt", "accepted",
                                          "ranks", "evals", "tau")}
                       for h in (dirt_.history or [])]}
    return jax, ti, prob, dirt_, q_obs, rec


def dirt(rows):
    """Phase 24's pipeline in the JAX package: examples/run_diffusion_dirt.py
    's own ``build`` with --meshlevel 1 and chip_smoke.DIFF_DIRT."""
    t_all = time.perf_counter()
    jax, ti, prob, dirt_, q_obs, rec = _build()
    rec.update(rows=rows, kle_dim=prob.kle_dim)
    m = 1 << DIFF_DIRT["log2n"]
    q = ti.randref("n4", jax.random.PRNGKey(3), (m, prob.kle_dim))
    t0 = time.perf_counter()
    z, lfapp = ti.tt_dirt_sample(dirt_, q)
    z.block_until_ready()
    rec["serve_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = prob.likelihood_fn(q_obs)(z[:rows])
    out.block_until_ready()
    rec["likelihood_s"] = time.perf_counter() - t0
    rec.update(_chain_stats(ti, jax, z, out, lfapp, 4, rows))
    rec["seconds"] = time.perf_counter() - t_all
    return rec


def stack(name):
    """One build of ``STACKS``, saved under DIFF_STACKS."""
    from tt_irt_tpu.utils.checkpoint import save_dirt

    seed, ulp = STACKS[name]
    _, _, _, dirt_, q_obs, rec = _build(seed, ulp)
    save_dirt(os.path.join(DIFF_STACKS, name), dirt_)
    rec.update(seed=seed, ulp=ulp, q_obs=[float(v) for v in q_obs])
    return rec


def _run_all(names, flag, rows):
    """Each named job in a process of its own, all started together;
    returns {name: its JSON record}."""
    procs = {name: subprocess.Popen(
        [sys.executable, __file__, flag, name, "--rows", str(rows)],
        stdout=subprocess.PIPE, text=True) for name in names}
    out = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} failed ({proc.returncode})")
        line = [ln for ln in text.splitlines() if ln.startswith("WITNESS ")]
        out[name] = json.loads(line[-1][len("WITNESS "):])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 10)
    ap.add_argument("--out", default=DIFF_WITNESS)
    ap.add_argument("--one", choices=("ttmh", "dirt"),
                    help="run one pipeline in this process and print its "
                         "JSON")
    ap.add_argument("--stack", choices=sorted(STACKS),
                    help="build one stack in this process and print its "
                         "JSON")
    ap.add_argument("--stacks", action="store_true",
                    help="build and save every stack of STACKS, and add "
                         "their records to FILE")
    args = ap.parse_args()
    if args.one or args.stack:
        rec = ({"ttmh": ttmh, "dirt": dirt}[args.one](args.rows)
               if args.one else stack(args.stack))
        print("WITNESS " + json.dumps(rec), flush=True)
        return
    t0 = time.perf_counter()
    if args.stacks:
        with open(args.out) as fh:
            rec = json.load(fh)
        rec["stacks"] = _run_all(sorted(STACKS), "--stack", args.rows)
        rec["stacks_seconds"] = time.perf_counter() - t0
    else:
        rec = {"settings": {"meshlevel": DIFF_MESHLEVEL, "ttmh": DIFF_TTMH,
                            "dirt": DIFF_DIRT},
               "package": "tt_irt_tpu (JAX) on the CPU, IEEE f64"}
        rec.update(_run_all(("ttmh", "dirt"), "--one", args.rows))
        rec["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
