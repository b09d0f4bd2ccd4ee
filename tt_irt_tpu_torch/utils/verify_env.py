"""Environment self-check (counterpart of
``tt_irt_tpu/utils/verify_env.py``; the reference's bootstrap layer
matlab/utils/check_*.m and python/verify.py, with nothing downloaded).

Reports the torch version and the CUDA devices, runs the cross + IRT +
diagnostics smoke test on ``device``, reports the native C++ build and
scipy's Sobol generator, and, on a CUDA device, builds the kernels'
libraries (``ops/_build.build_all``: one nvcc a source, all at once) and
reports each source's build seconds.

Run: python -m tt_irt_tpu_torch.utils.verify_env [device]
"""

from __future__ import annotations

import sys


def verify_env(verbose: bool = True, device="cuda") -> dict:
    out = {}

    def log(msg):
        if verbose:
            print(msg)

    import numpy as np
    import torch

    import tt_irt_tpu_torch as tp
    from tt_irt_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    out["torch"] = torch.__version__
    out["cuda"] = torch.version.cuda
    out["devices"] = [torch.cuda.get_device_name(i)
                      for i in range(torch.cuda.device_count())]
    out["tt_irt_tpu_torch"] = tp.__version__
    log(f"torch {out['torch']} (CUDA {out['cuda']})  "
        f"devices={out['devices']}  running on {dev}")

    # smoke: cross + IRT + diagnostics round trip (check_ttirt.m analog)
    grids = [np.linspace(-2, 2, 9)] * 3

    def fun(ind):
        ind = np.asarray(ind)
        x = np.stack([grids[k][ind[:, k]] for k in range(3)], axis=1)
        return np.exp(-0.5 * np.sum(x * x, axis=1))

    res = tp.amen_cross_s([9] * 3, fun, 1e-8, nswp=4, kickrank=2,
                          device=dev)
    q = torch.rand((256, 3), dtype=torch.float64, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
    x, lf = tp.tt_irt_lin([torch.as_tensor(g, device=dev) for g in grids],
                          res.tt, q, device=dev)
    tau = float(tp.essinv(-0.5 * torch.sum(x * x, dim=1), lf))
    out["smoke_ness"] = tau
    assert tau < 1.5, f"smoke test N/ESS too large: {tau}"
    log(f"cross+IRT smoke test: N/ESS = {tau:.4f}  OK")

    from tt_irt_tpu_torch.native import (NATIVE_LIB, build_native,
                                         native_available)

    out["native"] = bool(build_native() and native_available())
    log(f"native C++ kernel: "
        f"{NATIVE_LIB if out['native'] else 'absent'}")

    try:
        from scipy.stats import qmc  # noqa: F401

        out["sobol"] = True
    except ImportError:
        out["sobol"] = False
    log(f"scipy Sobol QMC: {out['sobol']}")

    if dev.type == "cuda":
        from tt_irt_tpu_torch.ops import _build

        reports = _build.build_all(_build.sources())
        out["kernels_built_s"] = {k: s for k, (_, s) in reports.items()}
        log(f"CUDA kernels under {_build.BUILD_DIR}: "
            + (", ".join(f"{k}.cu {s:.1f} s"
                         for k, s in out["kernels_built_s"].items())
               or "all built already"))
    return out


if __name__ == "__main__":
    verify_env(device=sys.argv[1] if len(sys.argv) > 1 else "cuda")
    sys.exit(0)
