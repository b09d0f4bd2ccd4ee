"""Run one benchmark cell of the PyTorch/CUDA port once:

    python3 portbench/run.py --workload lz40n33.serve --seed 7 \
        --seconds 30 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each compared number
beside its limit (also the last lines of standard error).  The run
exits with another code than 0, and prints no result, without a CUDA
card (or with fewer than the cell asks for) and if JAX or the JAX
package is loaded once the window has closed.  Kernel builds and caches
stay inside the checkout, under ``build/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "tt_irt_tpu")


def _caches():
    """Fixed cache directories inside the checkout, so that only a
    checkout's first run builds or compiles; few host threads."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "nv_compute_cache")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "2"


def loaded_forbidden() -> list:
    """Top-level names of JAX or the JAX package in ``sys.modules``,
    compared whole (``tt_irt_tpu_torch`` is not ``tt_irt_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()
    sys.path[0] = ROOT  # the checkout, not this folder: no module shadows
    import torch

    from portbench import discover, harness

    chips = discover.cell(discover.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA device(s); torch sees {seen}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START)
    found = loaded_forbidden()
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
