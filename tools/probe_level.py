"""dim_step against its plain version through lz40_ck's prepared levels,
on one NVIDIA GPU (sm_90a), run from the root of the repo:

    python3 tools/probe_level.py

For the prepared transforms 5, 4, 1 (rank 16) and 11 (the stack's
last, rank 19), counting level 0's as 0, four seed sets of 2^18 rows
each, and each transform also with its rank index permuted
(index 0 kept first) in B and C: the same transform exactly, with every
f32 sum in another, equally valid order.  Each run goes forward ('sqr')
and back ('rt') through the kernel and through the plain version, and
records their errors against the plain version run in f64 (maximum
and 99th percentile of the row error in seeds; maxima in samples and
log-density).  It tells apart what the f32 summation order does to the
extreme rows from what the kernel does, which sets chip_smoke.py's
rule for the kernel's maxima (at most four times the plain version's).
Prints one JSON line a run and writes them all to
chiprun_out/probe_level.json."""
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
import tt_irt_tpu_torch as tp  # noqa: E402
from tt_irt_tpu_torch.ops import _build  # noqa: E402
from tt_irt_tpu_torch.ops.dim_step import dim_step_cuda, dim_step_ref  # noqa
from tt_irt_tpu_torch.samplers.irt_scan import _fwd  # noqa: E402


def permuted(prep, seed):
    """The prepared level with its rank index permuted, index 0 first."""
    d, r = prep.bmat.shape[:2]
    n = prep.cmat.shape[1]
    g = torch.Generator().manual_seed(seed)
    pi = torch.cat([torch.zeros(1, dtype=torch.long),
                    1 + torch.randperm(r - 1, generator=g)]).to(
                        prep.bmat.device)
    b = prep.bmat.reshape(d, r, n, r)[:, pi][:, :, :, pi]
    c = prep.cmat.reshape(d, n, r, r)[:, :, pi][:, :, :, pi]
    return prep._replace(bmat=b.reshape(d, r, n * r).contiguous(),
                         cmat=c.reshape(d, n, r * r).contiguous())


def main():
    if not torch.cuda.is_available():
        print("probe_level: torch.cuda is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    _build.build_all(["dim_step"])
    dev = torch.device("cuda")
    dirt = tp.load_dirt(cs.CKPT_40, device=dev)
    sampler = tp.DirtSampler(dirt, precision="hi", device=dev)
    preps = [sampler._prep0] + sampler._upper
    rows = []
    for level in (5, 4, 1, 11):
        prep = preps[level]
        for s in range(4):
            q = torch.from_numpy(np.random.default_rng(100 + s).uniform(
                size=(1 << 18, dirt.d))).to(dev)
            x64, l64 = _fwd("sqr", prep, q, step=cs._plain64)
            u64, _ = _fwd("rt", prep, x64, step=cs._plain64)
            for perm in (0, 1):
                p = prep if perm == 0 else permuted(prep, 7 + s)
                rec = {"level": level, "r": prep.bmat.shape[1], "seed": s,
                       "perm": perm}
                for name, st in (("plain", dim_step_ref),
                                 ("kernel", dim_step_cuda)):
                    x, lf = _fwd("sqr", p, q, step=st)
                    u, _ = _fwd("rt", p, x64, step=st)
                    eu = (u - u64).abs().amax(1)
                    ex = (x - x64).abs().amax(1)
                    rec[name] = {
                        "u_max": float(eu.max()),
                        "u_p99": float(torch.quantile(eu.cpu(), .99)),
                        "x_max": float(ex.max()),
                        "lf_max": float((lf - l64).abs().max()),
                        "rt_max": float((u - q).abs().max()),
                        "u_argmax": int(eu.argmax()),
                        "n_u_above_2e-6": int((eu > 2e-6).sum())}
                rows.append(rec)
                print(json.dumps(rec), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/probe_level.json", "w") as fh:
        json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
