"""Which f64 operations on the card round differently by a batch's row
count, and which sharded results follow (on a GPU):

    python3 tools/mesh_probe.py

Each torch operation of the 'f64' serve is run on 4096 rows and on their
first 1024, and the 1024 rows compared; then tt_irt_sqr ('f64', 'f32') on
four shards of one card against one shard, the two-level DIRT build at
'f64' and 'f32' pushes, both crosses, the use_fused=True serve and
tests/test_parallel.py's fine-tuning run.  Prints one JSON object: for
each, (equal bit for bit, largest difference) or the builds' equality.
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import tt_irt_tpu_torch as tp  # noqa: E402
from tt_irt_tpu_torch.ops.rowmath import cumsum_rows  # noqa: E402
from tt_irt_tpu_torch.parallel import sample_mesh, sharded_call  # noqa: E402


def eq(a, b):
    return bool(torch.equal(a, b)), float((a - b).abs().max())


def main():
    if not torch.cuda.is_available():
        print("mesh_probe: torch.cuda is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out = {}
    g = torch.Generator(device=dev).manual_seed(1)

    def rand(*shape):
        return torch.rand(shape, dtype=torch.float64, device=dev,
                          generator=g)

    a, b = rand(4096, 4), rand(4, 36)
    out["mm_4x36"] = eq((a @ b)[:1024], a[:1024] @ b)
    a2, b2 = rand(4096, 23), rand(23, 33 * 23)
    out["mm_23"] = eq((a2 @ b2)[:1024], a2[:1024] @ b2)
    c = rand(4096, 4, 4)
    out["bmm"] = eq(torch.bmm(a[:, None, :], c)[:1024],
                    torch.bmm(a[:1024, None, :], c[:1024]))
    v = rand(4096, 9, 4)
    out["sum_inner"] = eq(torch.sum(v * v, dim=2)[:1024],
                          torch.sum(v[:1024] * v[:1024], dim=2))
    w = rand(4096, 9)
    out["cumsum_rows"] = eq(cumsum_rows(w)[:1024], cumsum_rows(w[:1024]))
    tt = tp.tt_from_numpy(cs.build_tt(6, 9, 4, seed=2), dev)
    grids = [torch.linspace(-2.0, 2.0, 9, dtype=torch.float64,
                            device=dev)] * 6
    q = rand(4096, 6)
    m4, m1 = sample_mesh(devices=["cuda:0"] * 4), sample_mesh()
    for prec in ("f64", "f32"):
        runs = [sharded_call(m, lambda qq, t_: tp.tt_irt_sqr(
            grids, t_, qq, precision=prec, device=qq.device), q, tt)
            for m in (m4, m1)]
        out[f"irt_{prec}_x"] = eq(runs[0][0], runs[1][0])
        out[f"irt_{prec}_lf"] = eq(runs[0][1], runs[1][1])

    def logratio(x, b0, b1):
        quad = torch.sum(x * x, dim=1) + \
            0.5 * torch.sum(x[:, :-1] * x[:, 1:], dim=1)
        return -0.5 * (b1 - b0) * quad

    dgrids = [np.linspace(-4.0, 4.0, 9) for _ in range(4)]
    for prec in (None, "f32"):
        ds = [tp.tt_dirt_approx(dgrids, logratio, [0.1, 1.0], nswp=1,
                                kickrank=2, y0=4, stoptol=0.5,
                                testsamples=32, seed=0, mesh=m,
                                precision=prec, device=dev)
              for m in (m4, m1)]
        out[f"build_{prec}"] = all(torch.equal(x, y) for x, y in zip(
            list(ds[0].f0.cores) + list(ds[0].fs[0].cores),
            list(ds[1].f0.cores) + list(ds[1].fs[0].cores)))
    gvec = torch.linspace(-2.0, 2.0, 9, dtype=torch.float64, device=dev)

    def cfun(ind):
        s = torch.sum(gvec[ind], dim=1)
        return torch.exp(-0.5 * s * s)

    for name, cross, kw in (("amen", tp.amen_cross_s,
                             dict(nswp=4, kickrank=2, seed=0)),
                            ("greedy", tp.greedy_cross,
                             dict(nswp=10, seed=1))):
        rs = [cross([9] * 4, cfun, 1e-8, mesh=m, device=dev, **kw)
              for m in (m4, m1)]
        out[name] = all(torch.equal(x, y) for x, y in zip(rs[0].tt.cores,
                                                         rs[1].tt.cores))
    qd = rand(4096, 4)
    fz = [sharded_call(m, lambda qq, dd: tp.tt_dirt_sample(
        dd, qq, use_fused=True, device=qq.device), qd, ds[1])
        for m in (m4, m1)]
    out["fused_x"] = eq(fz[0][0], fz[1][0])

    def lp(x):
        return -0.5 * (torch.sum(x * x, dim=1)
                       + 1.1 * torch.sum(x[:, :-1] * x[:, 1:], dim=1))

    ft = tp.tt_dirt_approx([np.linspace(-6, 6, 9)] * 3,
                           lambda x, b0, b1: (b1 - b0) * lp(x), [1.0],
                           stoptol=0.5, nswp=1, kickrank=0, y0=2, rmax=2,
                           testsamples=0, seed=5, device=dev)
    runs = [tp.dirt_finetune(ft, lp, steps=4, nsamples=64, lr=1e-3, seed=3,
                             mesh=m, device=dev) for m in (m4, m1)]
    out["finetune_losses"] = [list(map(float, r[1])) for r in runs]
    out["finetune_cores_max_diff"] = max(
        float((x - y).abs().max())
        for x, y in zip(runs[0][0].f0.cores, runs[1][0].f0.cores))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
