"""Build the Lorenz-10 DIRT of examples/data/lz10_ck's problem with the
port on the card at several seeds and push precisions, and serve each
stack: how much a build at these settings depends on its seed and on the
precision of its pushes.

    python3 tools/lz10_build_variants.py

Settings: chip_smoke.py's LZ10_BUILD (phase 19; run_lorenz_dirt.py
--fine-ladder --r0 19: 13 betas, n=17 on [-10, 10]), each variant
changing one or two of them.  For each variant it
prints the seconds, every attempt's test N/ESS (or the give-up) and the
N/ESS of the stack served at 'f64' on 2^16 'n3' seeds against the exact
posterior, with lz10_ck served the same way last.  Output also goes to
chiprun_out/lz10_build_variants.json.
"""

import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import tt_irt_tpu_torch as tp  # noqa: E402
from chip_smoke import LZ10_BUILD  # noqa: E402

DATA = os.path.join(ROOT, "examples", "data")
VARIANTS = [("f64 seed1", dict(seed=1)), ("f64 seed2", dict(seed=2)),
            ("ds seed0", dict(seed=0, precision="ds")),
            ("f32 seed0", dict(seed=0, precision="f32")),
            ("f64 seed0 testsamples 0", dict(seed=0, testsamples=0))]


def main():
    if not torch.cuda.is_available():
        print("lz10_build_variants: torch.cuda is not available",
              file=sys.stderr)
        return 2
    prob = tp.LorenzProblem(
        d=10, n=17, a=10.0, x0true=np.load(os.path.join(
            DATA, "lz10_x0base.npy")),
        data=np.load(os.path.join(DATA, "lz10_data.npy")))
    lp = prob.log_posterior_fn()
    beta = tp.load_dirt(os.path.join(DATA, "lz10_ck"),
                        device="cpu").beta.numpy()

    def served(dirt):
        q = tp.randref("n3", torch.Generator(device="cuda").manual_seed(1),
                       (1 << 16, 10))
        z, lf = tp.DirtSampler(dirt, precision="f64")(q)
        return float(tp.essinv(lp(z), lf))

    out = {}
    for label, kw in VARIANTS:
        args = dict(LZ10_BUILD, device="cuda", **kw)
        t0 = time.time()
        try:
            dirt = tp.tt_dirt_approx(prob.grids(), prob.tempered_logratio_fn(),
                                     beta, **args)
            rec = {"seconds": time.time() - t0,
                   "taus": [h["tau"] for h in dirt.history],
                   "served_f64_n_over_ess": served(dirt)}
        except RuntimeError as e:
            rec = {"seconds": time.time() - t0, "gave_up": str(e)}
        out[label] = rec
        print(label, json.dumps(rec), flush=True)
    ck = tp.load_dirt(os.path.join(DATA, "lz10_ck"))
    out["lz10_ck"] = {"served_f64_n_over_ess": served(ck)}
    print("lz10_ck", json.dumps(out["lz10_ck"]), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "lz10_build_variants.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
