"""Cell U's serves timed in turns with another checkout of the package on
one NVIDIA GPU:

    python3 tools/serve_turns.py --baseline DIR [--rows 65536]

DIR is the root of another checkout (e.g. the parent commit's, unpacked
with git archive into a git-ignored directory).  Each turn is a fresh
process that imports the package of one checkout (this one or DIR, in the
order DIR, this, this, DIR, DIR, this; the kernels the serves need built into each
checkout's build/kernels before the first turn, both at once; samples to
build/serve_turns) and times tt_irt_sqr on chip_smoke.py phase 31's TT
(a random positive TT at d=40, n=33, r=96, seeded as there) at 'hi'
with each hi_step and at 'hid', on --rows uniform seeds: the best of five calls after a warm-up,
each ended by torch.cuda.synchronize(); the device time of one more call
(torch.profiler: the sum of its kernels' time); and the host's time to
enqueue one condition_update call at 2^16 rows (the mean of 200, not
synchronised).  The samples of the two checkouts
are compared (largest difference; the cell-grouped readout and the
previous design round differently).  Output: one JSON line a turn and
chiprun_out/serve_turns.json.  The script imports neither jax nor the
JAX package."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = (("hi", "dim"), ("hi", "odim"), ("hi", "bracket"), ("hi", "pair"),
         ("hid", None))

# One turn, run in the checkout under test (argv: rows, output .npz).
TURN = r"""
import json, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import tt_irt_tpu_torch as tp

rows, out = int(sys.argv[1]), sys.argv[2]
d, n, r = 40, 33, 96
rng = np.random.default_rng(31)
cores = [rng.uniform(0.1, 1.0, (1 if k == 0 else r, n, 1 if k == d - 1 else r))
         for k in range(d)]
dev = torch.device("cuda")
tt = tp.tt_from_numpy(cores, dev)
grids = [torch.linspace(-1.0, 1.0, n, dtype=torch.float64, device=dev)] * d
q = torch.rand((rows, d), generator=torch.Generator(device=dev).manual_seed(32),
               dtype=torch.float64, device=dev)
from torch.profiler import ProfilerActivity, profile
from tt_irt_tpu_torch.ops.step import condition_update_cuda

secs, device_ms, samples = {}, {}, {}
for precision, hi_step in CASES:
    kw = {} if hi_step is None else {"hi_step": hi_step}
    tag = precision + ("" if hi_step is None else "_" + hi_step)
    call = lambda: tp.tt_irt_sqr(grids, tt, q, precision=precision, device=dev, **kw)
    z, _ = call()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    secs[tag] = best
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    device_ms[tag] = sum(e.self_device_time_total for e in prof.key_averages()
                         if e.device_type.name == "CUDA") / 1e3
    samples[tag] = z.cpu().numpy()
np.savez(out, **samples)
# the host's time to enqueue one condition_update call at (n, r) and rows
phi = torch.rand((rows, r), device=dev)
phi /= phi.amax(1, keepdim=True)
cmat = torch.rand((n, r * r), device=dev)
i0 = torch.randint(0, n - 1, (rows,), dtype=torch.int32, device=dev)
la = torch.rand(rows, device=dev)
args = (phi, i0, la, 1.0 - la, cmat)
condition_update_cuda(*args)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(200):
    condition_update_cuda(*args)
enqueue_us = (time.perf_counter() - t0) / 200 * 1e6
torch.cuda.synchronize()
print(json.dumps({"s": secs, "device_ms": device_ms,
                  "update_enqueue_us": enqueue_us}))
"""


def _turn(tree, rows, out):
    code = "CASES = " + repr(CASES) + "\n" + TURN
    res = subprocess.run([sys.executable, "-c", code, str(rows), out],
                         cwd=tree, capture_output=True, text=True,
                         check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="the root of another checkout")
    ap.add_argument("--rows", type=int, default=1 << 16)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("serve_turns: torch.cuda is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    base = os.path.abspath(args.baseline)
    build = ("import sys; sys.path.insert(0, '.'); "
             "from tt_irt_tpu_torch.ops import _build; "
             "_build.build_all([s for s in ('factor_wide', 'step', "
             "'cell_readout') if s in _build.sources()])")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=tree)
             for tree in (base, ROOT)]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError("a kernel build failed")
    out_dir = os.path.join(ROOT, "chiprun_out")
    tmp = os.path.join(ROOT, "build", "serve_turns")
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(tmp, exist_ok=True)
    turns = []
    for name, tree in (("baseline", base), ("this", ROOT), ("this", ROOT),
                       ("baseline", base), ("baseline", base),
                       ("this", ROOT)):
        npz = os.path.join(tmp, f"{name}.npz")
        turns.append({"checkout": name, **_turn(tree, args.rows, npz)})
        print(json.dumps(turns[-1]) + f" ({card})", flush=True)
    a = np.load(os.path.join(tmp, "this.npz"))
    b = np.load(os.path.join(tmp, "baseline.npz"))
    diff = {k: float(np.abs(a[k] - b[k]).max()) for k in a.files}
    summary = {}
    for what in ("s", "device_ms"):
        for name in ("baseline", "this"):
            runs = [t[what] for t in turns if t["checkout"] == name]
            summary[f"{name} {what} best"] = {
                k: min(r_[k] for r_ in runs) for k in runs[0]}
            summary[f"{name} {what} median"] = {
                k: float(np.median([r_[k] for r_ in runs])) for k in runs[0]}
    for name in ("baseline", "this"):
        summary[f"{name} update_enqueue_us median"] = float(np.median(
            [t["update_enqueue_us"] for t in turns if t["checkout"] == name]))
    rec = {"card": card, "rows": args.rows, "baseline": base,
           "turns": turns, "summary": summary, "samples_max_diff": diff}
    print("summary of the turns: " + json.dumps(summary) + "; samples' "
          "largest difference: " + json.dumps(diff) + f" ({card})",
          flush=True)
    with open(os.path.join(out_dir, "serve_turns.json"), "w") as fh:
        json.dump(rec, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
