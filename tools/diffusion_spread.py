"""How far chip_smoke.py phase 24's Fourier DIRT depends on its seed and on
the last bits of its coefficient cross, on the card.

    python3 tools/diffusion_spread.py [--seed 1]

Serves, on phase 24's 2^16 'n4' seeds (the same ``--seed``) and against
the exact FEM likelihood on every row (meshlevel 1, blocks of 128):

* the JAX package's own builds saved by tests/diffusion_witness.py
  --stacks (tests/data/diffusion_stacks: seed 0, seed 0 with every value
  of the coefficient cross's function moved by one ulp, seeds 1 and 2);
* the port's builds on the card at DIRT seeds 0, 1 and 2 with the
  example's numpy exp in the coefficient cross (phase 24's build is
  seed 0), and at seed 0 with torch's exp on the card instead.

For each: N/ESS, MH rejection, IACT of the flux, the QoI, the ALS-Cross
ranks and whether the witness's gates (chip_smoke.DIFF_*) are met.
Output also goes to chiprun_out/diffusion_spread.json.  Needs no CUDA
kernel: the builds and the 'f64' serves are plain PyTorch.
"""

import argparse
import json
import os
import sys
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import tt_irt_tpu_torch as tp  # noqa: E402

PORT_BUILDS = [("port numpy exp seed0", False, 0),
               ("port numpy exp seed1", False, 1),
               ("port numpy exp seed2", False, 2),
               ("port torch exp seed0", True, 0)]


def _gates(stats, w):
    rec = {}
    failed = cs._witness_gates(rec, "x", stats, w)
    return rec["x_gates"], not failed


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("diffusion_spread: torch.cuda is not available",
              file=sys.stderr)
        return 2
    card = cs._card()
    print(card, flush=True)
    dev = torch.device("cuda")
    prob = cs._diffusion_problem(types.SimpleNamespace(dev=dev))
    w = cs._witness("dirt")
    with open(cs.DIFF_WITNESS) as fh:
        saved = json.load(fh)["stacks"]
    q = tp.randref("n4", torch.Generator(device=dev).manual_seed(
        args.seed + 24), (1 << cs.DIFF_DIRT["log2n"], prob.kle_dim))
    out = {"card": card, "rows": q.shape[0], "witness": w}
    for k, (name, js) in enumerate(sorted(saved.items())):
        dirt = tp.load_dirt(os.path.join(cs.DIFF_STACKS, name), device=dev)
        stats = cs._served_chain(prob, np.asarray(js["q_obs"]), dirt, q,
                                 args.seed + 200 + k)
        stats["als_ranks"] = js["als_ranks"]
        stats["coeff_max_rel_err"] = js["coeff_max_rel_err"]
        stats["gates"], stats["met"] = _gates(stats, w)
        out["jax " + name] = stats
        print("jax " + name, json.dumps(stats), flush=True)
    for k, (label, torch_fun, seed) in enumerate(PORT_BUILDS):
        t0 = time.perf_counter()
        dirt, res, q_obs, secs, _ = cs._diffusion_dirt_build(
            prob, dev, torch_fun=torch_fun, seed=seed)
        stats = cs._served_chain(prob, q_obs, dirt, q, args.seed + 124 + k)
        stats.update(build_s=secs["build"], als_ranks=list(res.u.ranks),
                     taus=[h["tau"] for h in dirt.history],
                     seconds=time.perf_counter() - t0)
        stats["gates"], stats["met"] = _gates(stats, w)
        out[label] = stats
        print(label, json.dumps(stats), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "diffusion_spread.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
