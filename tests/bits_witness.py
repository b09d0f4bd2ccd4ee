"""How far two constructions of chip_smoke.py depend on the last bits
of their arithmetic, in the JAX package and in the port, on the CPU
(IEEE f64).

Phase 17's cross (bench.py::_cross_bench: d=50, n=192,
(sum (i+1)^2)^-1/2, tol 1e-4, kickrank 4, stop_sweep 1, seed 0) with a
numpy function, in both packages, with the host BLAS at 1, 4 and 8
threads (one process each): evaluations, largest rank and the
Monte-Carlo Frobenius error at 2^16 indices (default_rng(5)), and
whether the two packages' cores are equal bit for bit.

The pushes of one probe batch of grid points through lz10_ck's stack at
f64 in both packages (``probe``).

Phase 19's Lorenz-10 DIRT build (chip_smoke.LZ10_BUILD, f64 pushes).
Each build runs in a process of its own, all started together: the JAX
package's ``tt_dirt_approx`` at seeds 0, 1 and 2, at seed 0 with every pushed probe point moved by one ulp
(x (1 + 2^-52)), and at seed 0 without test samples; the port's at seed
0 with and without test samples.  Each stack that was built is then
served at f64 by the port on one set of 2^14 'n3' seeds, level by level
against that level's tempered target, beside the shipped lz10_ck.  The
two builds without test samples (no random draw in either package) and
the JAX pair seed 0 / one ulp are compared level by level: ranks, and
the largest difference of the level TTs' values at 4096 grid points
relative to their largest value.

Usage: python tests/bits_witness.py [--out FILE] (about 8 min on eight
cores; the default FILE is tests/data/bits_witness.json).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import LZ10_BUILD  # noqa: E402

PROBLEM = os.path.join(ROOT, "examples", "data", "lz10")
BETA = np.concatenate([10.0 ** np.arange(-4, -2, 0.5),
                       10.0 ** np.arange(-2, 0.25, 0.25)])
SETTINGS = {k: v for k, v in LZ10_BUILD.items()
            if k not in ("testsamples", "seed")}
CROSS_THREADS = (1, 4, 8)
BUILDS = {
    "jax_seed0": ("jax", 1000, 0, False),
    "jax_seed0_ulp": ("jax", 1000, 0, True),
    "jax_seed1": ("jax", 1000, 1, False),
    "jax_seed2": ("jax", 1000, 2, False),
    "jax_seed0_ts0": ("jax", 0, 0, False),
    "port_seed0": ("port", 1000, 0, False),
    "port_seed0_ts0": ("port", 0, 0, False),
}


def _problem(pkg):
    x0, data = np.load(PROBLEM + "_x0base.npy"), np.load(PROBLEM + "_data.npy")
    if pkg == "jax":
        from tt_irt_tpu.models.lorenz import LorenzProblem
    else:
        from tt_irt_tpu_torch import LorenzProblem
    return LorenzProblem(d=10, n=17, a=10.0, x0true=x0, data=data)


def build(name, path):
    """One build (in this process); saves every accepted level to
    ``path`` and prints one JSON line."""
    pkg, ntest, seed, ulp = BUILDS[name]
    if pkg == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import tt_irt_tpu as pk
        kw = {}
    else:
        import torch

        torch.set_num_threads(3)
        import tt_irt_tpu_torch as pk
        kw = dict(device="cpu")
    ratio = _problem(pkg).tempered_logratio_fn()

    def logratio(x, b0, b1):
        # probe batches of levels >= 1 (b0 > 0) come out of the pushes
        return ratio(x * (1.0 + 2.0 ** -52) if ulp and b0 > 0 else x, b0, b1)

    t0, gave_up = time.perf_counter(), None
    try:
        dirt = pk.tt_dirt_approx(
            [np.linspace(-10.0, 10.0, 17)] * 10, logratio, BETA,
            testsamples=ntest, seed=seed, checkpoint_path=path, **SETTINGS,
            **kw)
        hist = dirt.history
    except RuntimeError as e:
        gave_up, hist = str(e), None
    print(json.dumps({"seconds": time.perf_counter() - t0,
                      "gave_up": gave_up,
                      "test_n_over_ess": None if hist is None else [
                          [h["level"], h["tau"]] for h in hist
                          if h["tau"] is not None]}))


def cross(threads):
    """Phase 17's cross with a numpy function in both packages at
    ``threads`` BLAS threads; prints one JSON line."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import torch
    from threadpoolctl import threadpool_limits

    import tt_irt_tpu as ti
    import tt_irt_tpu_torch as tp

    def fun(ind):
        x = np.asarray(ind).astype(np.float64) + 1.0
        return np.sqrt(1.0 / np.sum(x * x, axis=1))

    kw = dict(kickrank=4, seed=0, stop_sweep=1)
    with threadpool_limits(threads):
        rj = ti.amen_cross_s([192] * 50, fun, 1e-4, **kw)
        rt = tp.amen_cross_s([192] * 50, fun, 1e-4, device="cpu", **kw)
    idx = np.random.default_rng(5).integers(0, 192, size=(1 << 16, 50))
    approx = tp.tt_eval_indices(rt.tt, torch.from_numpy(idx)).numpy()
    exact = fun(idx)
    print(json.dumps({
        "blas_threads": threads, "evals": int(rt.evalcnt[0]),
        "rank_max": int(max(rt.tt.ranks)),
        "fro_mc": float(np.sqrt(np.mean((approx - exact) ** 2)
                                / np.mean(exact ** 2))),
        "jax_equal_bit_for_bit": rt.evalcnt == rj.evalcnt and all(
            np.array_equal(np.asarray(a), b.numpy())
            for a, b in zip(rj.tt.cores, rt.tt.cores))}))


def probe():
    """The pushes of one probe batch at f64 in both packages: 2048 random
    multi-indices of the 17-node level grid on [-3, 3] (a quarter of the
    rows on its two end nodes only, where the 'n3' reference's CDF is 0
    or 1) through lz10_ck's 13 transforms.  Prints one JSON line: rows
    where both log-densities are finite and the samples agree within
    1e-8, or differ; rows non-finite in one package or in both; and
    whether every differing finite row has an earlier coordinate pushed
    to the box's edge (+-10)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    import tt_irt_tpu as ti
    import tt_irt_tpu_torch as tp
    from tt_irt_tpu.utils.checkpoint import load_dirt

    jd = load_dirt(PROBLEM + "_ck")
    td = tp.load_dirt(PROBLEM + "_ck", device="cpu")
    rng = np.random.default_rng(0)
    ind = rng.integers(0, 17, size=(2048, 10))
    ind[:512] = rng.choice([0, 16], size=(512, 10))
    q = td.x[0].numpy()[ind]
    zj, lj = ti.tt_dirt_sample(jd, jnp.asarray(q))
    zt, lt = tp.tt_dirt_sample(td, torch.from_numpy(q), device="cpu")
    zj, lj, zt, lt = (np.asarray(zj), np.asarray(lj), zt.numpy(),
                      lt.numpy())
    gap = np.max(np.abs(zj - zt), axis=1)
    fin = np.isfinite(lj) & np.isfinite(lt)
    diff = fin & (gap > 1e-8)
    first = [int(np.argmax(np.abs(zj[i] - zt[i]) > 1e-8))
             for i in np.nonzero(diff)[0]]
    edge = [bool(np.any(np.abs(zj[i, :k]) == 10.0))
            for i, k in zip(np.nonzero(diff)[0], first)]
    print(json.dumps({
        "rows": int(q.shape[0]),
        "finite_equal_1e-8": int(np.sum(fin & ~diff)),
        "finite_different": int(np.sum(diff)),
        "finite_different_after_an_edge": int(sum(edge)),
        "nonfinite_jax_only": int(np.sum(~np.isfinite(lj) & np.isfinite(lt))),
        "nonfinite_port_only": int(np.sum(np.isfinite(lj) & ~np.isfinite(lt))),
        "nonfinite_both": int(np.sum(~np.isfinite(lj) & ~np.isfinite(lt))),
        "max_gap_finite_rows": float(gap[fin].max())}))


def _serve_levels(paths):
    """N/ESS of every level of each stack against its own tempered
    target: the port at f64 on the CPU, one seed set for all."""
    import torch

    import tt_irt_tpu_torch as tp

    torch.set_num_threads(8)
    ratio = _problem("port").tempered_logratio_fn()
    q = tp.randref("n3", torch.Generator().manual_seed(11), (1 << 14, 10))
    out = {}
    for name, path in paths.items():
        dirt = tp.load_dirt(path, device="cpu")
        taus = []
        for lvl in range(dirt.nlevels + 1):
            cut = tp.DIRT(dirt.f0, dirt.fs[:lvl], dirt.x0, dirt.x,
                          dirt.beta[:lvl + 1], dirt.lfshift, dirt.reference,
                          dirt.interpolation)
            b = float(dirt.beta[lvl])
            _, lfapp, lfex = tp.tt_dirt_sample(
                cut, q, lambda x, b=b: ratio(x, 0.0, b), device="cpu")
            taus.append(float(tp.essinv(lfex, lfapp)))
        out[name] = taus
    return out


def _compare(path_a, path_b):
    """Level by level: equal ranks, and max |TT_a - TT_b| / max |TT_a| at
    4096 grid points."""
    za, zb = np.load(path_a + ".npz"), np.load(path_b + ".npz")
    na = json.load(open(path_a + ".json"))["nlevels"]
    nb = json.load(open(path_b + ".json"))["nlevels"]
    ind = np.random.default_rng(3).integers(0, 17, size=(4096, 10))

    def values(z, pre):
        v = np.ones((ind.shape[0], 1))
        for k in range(10):
            v = np.einsum("mr,rms->ms", v, z[f"{pre}_{k}"][:, ind[:, k], :])
        return v[:, 0]

    rows = []
    for lvl in range(min(na, nb) + 1):
        pre = "f0" if lvl == 0 else f"lvl{lvl - 1}"
        ra = [za[f"{pre}_{k}"].shape[2] for k in range(9)]
        rb = [zb[f"{pre}_{k}"].shape[2] for k in range(9)]
        va, vb = values(za, pre), values(zb, pre)
        rows.append({"level": lvl, "ranks_equal": ra == rb,
                     "rel_max_diff": float(np.max(np.abs(va - vb))
                                           / np.max(np.abs(va)))})
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tests", "data", "bits_witness.json"))
    ap.add_argument("--build", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--path", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--cross", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--probe", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        return build(args.build, args.path)
    if args.cross:
        return cross(args.cross)
    if args.probe:
        return probe()
    import tempfile

    tmp = tempfile.mkdtemp(prefix="lz10_witness_", dir=os.path.dirname(
        os.path.abspath(args.out)))
    env = dict(os.environ, OMP_NUM_THREADS="3",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    paths = {k: os.path.join(tmp, k) for k in BUILDS}
    procs = {k: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--build", k,
         "--path", paths[k]], env=env, stdout=subprocess.PIPE, text=True)
        for k in BUILDS}
    crosses = []
    for t in CROSS_THREADS:      # one at a time, beside the builds
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--cross", str(t)],
            env=env, stdout=subprocess.PIPE, text=True, check=True).stdout
        crosses.append(json.loads(out.strip().splitlines()[-1]))
        print("cross", crosses[-1], flush=True)
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--probe"],
        env=env, stdout=subprocess.PIPE, text=True, check=True).stdout
    pushes = json.loads(out.strip().splitlines()[-1])
    print("probe", pushes, flush=True)
    builds = {}
    for k, p in procs.items():
        out, _ = p.communicate()
        assert p.returncode == 0, (k, p.returncode)
        builds[k] = json.loads(out.strip().splitlines()[-1])
        print(k, builds[k], flush=True)
    paths = {k: v for k, v in paths.items() if os.path.exists(v + ".npz")}
    paths["lz10_ck"] = PROBLEM + "_ck"
    served = _serve_levels(paths)
    rec = {
        "cross": {"what": "chip_smoke.py phase 17's cross with a numpy "
                          "function on the CPU, by BLAS threads",
                  "runs": crosses},
        "probe_pushes_lz10_ck": pushes,
        "what": "Lorenz-10 DIRT at chip_smoke.py phase 19's settings "
                "(f64 pushes), built on the CPU; served N/ESS by level "
                "(2^14 'n3' seeds, f64, the port)",
        "settings": dict(SETTINGS, beta=[float(b) for b in BETA]),
        "builds": {k: dict(zip(("package", "testsamples", "seed",
                                "pushes_moved_one_ulp"), BUILDS[k]),
                           **builds[k]) for k in BUILDS},
        "served_n_over_ess_by_level": served,
        "levels_jax_vs_port_ts0": _compare(paths["jax_seed0_ts0"],
                                           paths["port_seed0_ts0"]),
        "levels_jax_vs_jax_one_ulp": _compare(paths["jax_seed0"],
                                              paths["jax_seed0_ulp"]),
    }
    with open(args.out, "w") as fh:
        json.dump(rec, fh, indent=1)
    for k, v in served.items():
        print(k, "served N/ESS by level", [round(t, 3) for t in v])
    import shutil

    shutil.rmtree(tmp)


if __name__ == "__main__":
    main()
