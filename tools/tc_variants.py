"""Variants of the tensor-core dim_step / cdf_bracket_factor design, timed
and held against the shipped kernels on one NVIDIA GPU (sm_90a):

    python3 tools/tc_variants.py

  - accumulation: v = phi B through the conditional's pieces in the two
    schemes of tools/tc_probe.cu (one accumulator for every product, or
    the shipped split accumulators), fk against the f64 fk beside the
    plain f32 product (torch.matmul in full f32), at five shapes;
  - "one_pass": dim_step with the prefix update inside the first pass,
    each row gathering its two core slices from L2 (the shipped kernel
    stages C in shared memory for a second pass);
  - "wg2": both kernels with at most two warpgroups a block (the shipped
    build runs three at rank tier 24).
The variants are built from the sources in tt_irt_tpu_torch/csrc with
one text edit each (the script stops if an edit no longer applies) into
build/variants, with the package's nvcc flags.  Kernels are timed with
CUDA events, 20 launches after a warm-up, in the order shipped, variant,
variant, shipped, at 2^18 rows on random operands.  The summary goes to
stdout and chiprun_out/tc_variants.json.  The script imports neither jax
nor the JAX package."""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tt_irt_tpu_torch.ops._build import CSRC, NVCC_FLAGS, _nvcc  # noqa: E402
from tt_irt_tpu_torch.ops.dim_step import dim_step_cuda  # noqa: E402
from tt_irt_tpu_torch.ops.step import cdf_bracket_factor_cuda  # noqa: E402

OUT = os.path.join(ROOT, "build", "variants")
P = ctypes.c_void_p
I = ctypes.c_int

FIRST_PASS = """    if (live) write_out9(out9 + row * 9, b, xg + n);
    wg_barrier(wg);      // the fk tile is free for the next tile
  }
"""
ONE_PASS = """    if (live) {
      write_out9(out9 + row * 9, b, xg + n);
      const float la = cell_weight<RT>(b, qp[row]);
      float p[T];
      load_row<T>(p, phi, row, r);
      const float* ca = cmat + static_cast<size_t>(b.i0) * r * r;
      float acc[T];
      prefix_update<T>(p, la, 1.0f - la, ca, ca + r * r, r, acc);
      store_row<T>(phin, row, r, acc);
    }
    wg_barrier(wg);      // the fk tile is free for the next tile
  }
  return;
"""
WARPGROUPS = ("constexpr int wgmma_max_warpgroups(int t) "
              "{ return t == 24 ? 3 : 2; }")


def _edited_copy(name, edits):
    """csrc copied to build/variants/<name>, with (file, old, new) edits."""
    dst = os.path.join(OUT, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(CSRC, dst)
    for fname, old, new in edits:
        path = os.path.join(dst, fname)
        with open(path) as fh:
            src = fh.read()
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: the edit of {fname} no "
                               "longer applies")
        with open(path, "w") as fh:
            fh.write(src.replace(old, new))
    return dst


def _build(jobs):
    """{lib name: source} -> {lib name: path}, all nvcc at once."""
    procs = {}
    for name, src in jobs.items():
        lib = os.path.join(OUT, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", lib, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = lib
    return libs


def _time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _accuracy(lib, stream):
    """fk of the two accumulation schemes and of the plain f32 product
    against f64, relative to the largest fk, on card-test operands."""
    fn = lib.tc_probe_v
    fn.argtypes = [P, P, P, I, I, I, I, P]
    rows = []
    for n, r in ((17, 5), (17, 13), (17, 19), (33, 23), (9, 32)):
        rng = np.random.default_rng(n + r)
        m = 4096 + 7
        phi = rng.uniform(0.05, 1.0, (m, r)).astype(np.float32)
        phi /= phi.max(1, keepdims=True)
        bm = rng.standard_normal((r, n * r)).astype(np.float32)
        tier = 8 if r <= 8 else 16 if r <= 16 else 24 if r <= 24 else 32
        pc, bc = torch.from_numpy(phi).cuda(), torch.from_numpy(bm).cuda()
        v64 = (pc.double() @ bc.double()).reshape(m, n, r)
        f64 = (v64 ** 2).sum(2)
        scale = float(f64.max())
        fp = ((pc @ bc).reshape(m, n, r) ** 2).sum(2)
        row = {"n": n, "r": r,
               "plain_rel": float((fp.double() - f64).abs().max()) / scale}
        for scheme in (0, 1):
            v = torch.zeros((m, n, tier), device="cuda")
            err = fn(pc.data_ptr(), bc.data_ptr(), v.data_ptr(), m, n, r,
                     scheme, stream)
            torch.cuda.synchronize()
            assert err == 0, err
            fk = (v[:, :, :r].double() ** 2).sum(2)
            row[f"scheme{scheme}_rel"] = float((fk - f64).abs().max()) / scale
        rows.append(row)
    return rows


def _operands(m, n, r, rng):
    x = np.sort(rng.uniform(-2.0, 2.0, n))
    x[0], x[-1] = -2.0, 2.0
    phi = rng.uniform(0.05, 1.0, (m, r)).astype(np.float32)
    phi /= phi.max(1, keepdims=True)
    q = rng.uniform(size=m)
    x32 = x.astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
        phi, q.astype(np.float32), (1.0 - q).astype(np.float32),
        rng.standard_normal((r, n * r)).astype(np.float32),
        rng.uniform(0.05, 1.0, (n, r * r)).astype(np.float32),
        np.diff(x).astype(np.float32),
        np.stack([x32, (x - x32.astype(np.float64)).astype(np.float32)]))]


def _timings(libs, stream):
    dim = {}
    for name in ("one_pass", "wg2"):
        lib = ctypes.CDLL(libs[f"dim_{name}"])
        lib.dim_step_launch.argtypes = [P] * 9 + [I] * 5 + [P]
        dim[name] = lib.dim_step_launch
    fac = ctypes.CDLL(libs["factor_wg2"]).cdf_bracket_factor_launch
    fac.argtypes = [P] * 7 + [I] * 5 + [P]
    rng = np.random.default_rng(0)
    rows = []
    for n, r in ((33, 23), (17, 19), (17, 13)):
        m = 1 << 18
        t = _operands(m, n, r, rng)
        phi, qp, _, bm, _, h, xg = t
        pn = torch.empty_like(phi)
        o9 = torch.empty((m, 9), device="cuda")
        i0 = torch.empty((m,), dtype=torch.int32, device="cuda")

        def variant(fn):
            def run():
                assert fn(*(a.data_ptr() for a in t), pn.data_ptr(),
                          o9.data_ptr(), m, n, r, 0, 0, stream) == 0
            return run

        def bracket_wg2():
            assert fac(phi.data_ptr(), qp.data_ptr(), bm.data_ptr(),
                       h.data_ptr(), xg.data_ptr(), o9.data_ptr(),
                       i0.data_ptr(), m, n, r, 0, 0, stream) == 0

        ship_p, ship_o = dim_step_cuda(*t)
        agree = {}
        for name, fn in dim.items():
            variant(fn)()
            torch.cuda.synchronize()
            agree[name] = {"out9_equal": bool(torch.equal(o9, ship_o)),
                           "phin_max_diff": float((pn - ship_p).abs().max())}
        cases = {
            "dim_step": lambda: dim_step_cuda(*t),
            "dim_step_one_pass": variant(dim["one_pass"]),
            "dim_step_wg2": variant(dim["wg2"]),
            "cdf_bracket_factor": lambda: cdf_bracket_factor_cuda(
                phi, qp, bm, h, xg),
            "cdf_bracket_factor_wg2": bracket_wg2,
            "matmul": lambda: torch.matmul(phi, bm)}
        ms = {k: [] for k in cases}
        for order in (list(cases), list(cases)[::-1]):
            for k in order:
                ms[k].append(_time_ms(cases[k]))
        rows.append({"n": n, "r": r, "rows": m, "ms": ms,
                     "variants_vs_shipped": agree})
    return rows


def main():
    if not torch.cuda.is_available():
        print("tc_variants: torch.cuda is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    os.makedirs(OUT, exist_ok=True)
    one = _edited_copy("one_pass", [("dim_step.cu", FIRST_PASS, ONE_PASS)])
    wg2 = _edited_copy("wg2", [("tc_conditional.cuh", WARPGROUPS,
                                WARPGROUPS.replace("t == 24 ? 3 : 2", "2"))])
    libs = _build({"tc_probe": os.path.join(ROOT, "tools", "tc_probe.cu"),
                   "dim_one_pass": os.path.join(one, "dim_step.cu"),
                   "dim_wg2": os.path.join(wg2, "dim_step.cu"),
                   "factor_wg2": os.path.join(wg2, "factor_step.cu")})
    stream = torch.cuda.current_stream().cuda_stream
    rec = {"card": card,
           "accuracy": _accuracy(ctypes.CDLL(libs["tc_probe"]), stream),
           "timings": _timings(libs, stream)}
    for row in rec["accuracy"]:
        print(f"fk vs f64 (n={row['n']}, r={row['r']}): plain f32 "
              f"{row['plain_rel']:.3e}, one accumulator "
              f"{row['scheme0_rel']:.3e}, split accumulators (shipped) "
              f"{row['scheme1_rel']:.3e} ({card})")
    for row in rec["timings"]:
        parts = ", ".join(f"{k} {min(v):.4f}" for k, v in row["ms"].items())
        print(f"ms at n={row['n']}, r={row['r']}, {row['rows']} rows (best "
              f"of 2): {parts}; variants vs shipped "
              f"{json.dumps(row['variants_vs_shipped'])} ({card})")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "tc_variants.json"),
              "w") as fh:
        json.dump(rec, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
