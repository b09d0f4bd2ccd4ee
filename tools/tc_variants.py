"""Variants of the tensor-core factor-family kernels, timed and held
against the shipped kernels on one NVIDIA GPU (sm_90a):

    python3 tools/tc_variants.py [--baseline CSRC]

  - accumulation: v = phi B through the conditional's pieces in the two
    schemes of tools/tc_probe.cu (one accumulator for every product, or
    the shipped split accumulators), fk against the f64 fk beside the
    plain f32 product (torch.matmul in full f32), at five shapes;
  - "one_pass": dim_step with the prefix update inside the first pass,
    each row gathering its two core slices from L2 (the shipped kernel
    stages C in shared memory for a second pass);
  - "wg2": dim_step and cdf_bracket_factor with at most two warpgroups a
    block (the shipped build runs three at rank tier 24);
  - factor_conditional's recompute of the nodes whose tensor-core fk is
    below 2^-8 of its row's largest: shipped (a warp queues its (row,
    node) pairs node by node and runs them 32 at a time, one f32 chain a
    lane, TcStage::thread_node_fk), "no_recompute" (the tensor-core fk as
    it is), "row_recompute" (each thread recomputes its own row's nodes
    by the same chain) and "warp_recompute" (the whole warp on one row and
    node after another, TcStage::warp_node_fk, the CDF stage's way with
    its two nodes);
  - odim_step beside dim_step (the same stages; the second pass stages
    Q's node blocks instead of the core);
  - with --baseline CSRC, odim_step and factor_conditional as built from
    another checkout's tt_irt_tpu_torch/csrc with the same C interface
    (odim_step.cu, and factor_step.cu or factor_conditional.cu, whichever
    holds factor_conditional_launch), e.g. the parent commit's unpacked
    with git archive into a git-ignored directory.
Timed on random operands at three shapes, and at the last level of
examples/data/lz40n33_ck, dimension 20, on the carry that 2^18 uniform
seeds reach there through the kernels (where the small nodes are those a
serve meets; random operands have almost none).
The variants are built from the sources in tt_irt_tpu_torch/csrc with
one text edit each (the script stops if an edit no longer applies) into
build/variants, with the package's nvcc flags, all nvcc at once beside
the package's own build.  Kernels are timed with CUDA events, 20
launches after a warm-up, in the order of the list and again reversed
(shipped, variant, variant, shipped), at 2^18 rows.  The summary goes to
stdout and chiprun_out/tc_variants.json.  The script imports neither jax
nor the JAX package."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tt_irt_tpu_torch.ops._build import (CSRC, NVCC_FLAGS,  # noqa: E402
                                         _nvcc, build_all)
from tt_irt_tpu_torch.ops.dim_step import dim_step_cuda  # noqa: E402
from tt_irt_tpu_torch.ops.odim_step import odim_step_cuda  # noqa: E402
from tt_irt_tpu_torch.ops.step import (cdf_bracket_factor_cuda,  # noqa: E402
                                       factor_conditional_cuda)

OUT = os.path.join(ROOT, "build", "variants")
P = ctypes.c_void_p
I = ctypes.c_int
PACKAGE = ("dim_step", "odim_step", "factor_step", "factor_conditional")

FIRST_PASS = """    if (live) write_out9(out9 + row * 9, b, xg + n);
    wg_barrier(wg);      // the fk tile is free for the next tile
  }
"""
ONE_PASS = """    if (live) {
      write_out9(out9 + row * 9, b, xg + n);
      const float la = cell_weight<RT>(b, qp[row]);
      float p[T];
      load_row<T>(p, phi, row, r);
      const float* ca = slices + static_cast<size_t>(b.i0) * r * r;
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
RECOMPUTE = ("    recompute_small<Stage, T>(smem, fk, phi, row0, m, tid, n, r);"
             "\n")
ROW_RECOMPUTE = """    if (row0 + tid < m) {
      float fmax = 0.0f;
      for (int x = 0; x < n; ++x)
        fmax = fmaxf(fmax, fk[fk_at<true>(x, tid)]);
      const float tiny = kRecompute * fmax;
      float p[T];
      load_row<T>(p, phi, row0 + tid, r);
      for (int x = 0; x < n; ++x) {
        const int at = fk_at<true>(x, tid);
        if (fk[at] < tiny) fk[at] = Stage::thread_node_fk(smem, p, n, r, x);
      }
    }
"""
WARP_RECOMPUTE = """    {
      const long long row = row0 + tid;
      const int lane = threadIdx.x & 31;
      float tiny = 0.0f;
      bool any = false;
      if (row < m) {
        float fmax = 0.0f;
        for (int x = 0; x < n; ++x)
          fmax = fmaxf(fmax, fk[fk_at<true>(x, tid)]);
        tiny = kRecompute * fmax;
        for (int x = 0; x < n; ++x) any |= fk[fk_at<true>(x, tid)] < tiny;
      }
      unsigned todo = __ballot_sync(0xFFFFFFFFu, any);
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const float ts = __shfl_sync(0xFFFFFFFFu, tiny, src);
        const int cs = __shfl_sync(0xFFFFFFFFu, tid, src);
        const long long rs = __shfl_sync(0xFFFFFFFFu, row, src);
        float pv[(T + 31) / 32];
        for (int u = 0; u < (T + 31) / 32; ++u) {
          const int j = lane + 32 * u;
          pv[u] = j < r ? phi[rs * r + j] : 0.0f;
        }
        for (int x = 0; x < n; ++x) {
          const int at = fk_at<true>(x, cs);
          if (fk[at] < ts) {
            const float f = Stage::warp_node_fk(smem, pv, n, r, x);
            if (lane == src) fk[at] = f;
          }
        }
      }
    }
"""


def _edited_copy(name, edits, src=CSRC):
    """src copied to build/variants/<name>, with (file, old, new) edits."""
    dst = os.path.join(OUT, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for fname, old, new in edits:
        path = os.path.join(dst, fname)
        with open(path) as fh:
            text = fh.read()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: the edit of {fname} no "
                               "longer applies")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))
    return dst


def _build_variants(jobs):
    """{lib name: source} -> {lib name: path}, all nvcc at once, beside
    the package's own build of PACKAGE."""
    pool = ThreadPoolExecutor(max_workers=1)
    package = pool.submit(build_all, PACKAGE)
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
    package.result()
    pool.shutdown()
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




def _random_operands(m, n, r, rng):
    """dim_step's operands on random data: phi, qp, um, bmat, cmat, h,
    xg."""
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


def _lz40_operands(m, k=20):
    """dim_step's operands at the last level of lz40n33_ck, dimension k,
    on the carry m uniform seeds reach there through dim_step, and
    odim_step's on the orthonormal cores' carry: (raw, ortho)."""
    import tt_irt_tpu_torch as tp
    from tt_irt_tpu_torch.samplers.dirt import _prepare_level_preps

    dirt = tp.load_dirt(os.path.join(ROOT, "examples", "data", "lz40n33_ck"),
                        device="cuda")
    raw = _prepare_level_preps(dirt, "hi", "dim")[-1]
    ortho = _prepare_level_preps(dirt, "hi", "odim")[-1]
    q = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(dirt.d, m))).cuda()
    qp, um = q.float(), (1.0 - q).float()
    r = raw.bmat.shape[1]
    phi = torch.zeros((m, r), device="cuda")
    phi[:, 0] = 1.0
    psi = phi.clone()
    for j in range(k):
        phi, _ = dim_step_cuda(phi, qp[j], um[j], raw.bmat[j], raw.cmat[j],
                               raw.hrow[j], raw.xg[j])
        psi, _ = odim_step_cuda(psi, qp[j], um[j], ortho.qmat[j],
                                ortho.hrow[j], ortho.xg[j])
    return ([phi, qp[k], um[k], raw.bmat[k], raw.cmat[k], raw.hrow[k],
             raw.xg[k]],
            [psi, qp[k], um[k], ortho.qmat[k], ortho.hrow[k], ortho.xg[k]])


def _launchers(libs):
    """The variants' and baselines' launch functions, typed."""
    out = {}
    for name in ("one_pass", "wg2"):
        f = ctypes.CDLL(libs[f"dim_{name}"]).dim_step_launch
        f.argtypes = [P] * 9 + [I] * 5 + [P]
        out[f"dim_step_{name}"] = f
    f = ctypes.CDLL(libs["factor_wg2"]).cdf_bracket_factor_launch
    f.argtypes = [P] * 7 + [I] * 5 + [P]
    out["cdf_bracket_factor_wg2"] = f
    for name in ("no_recompute", "row_recompute", "warp_recompute", "base"):
        if f"fc_{name}" in libs:
            f = ctypes.CDLL(libs[f"fc_{name}"]).factor_conditional_launch
            f.argtypes = [P, P, P, I, I, I, I, P]
            out[f"factor_conditional_{name}"] = f
    if "odim_base" in libs:
        f = ctypes.CDLL(libs["odim_base"]).odim_step_launch
        f.argtypes = [P] * 8 + [I] * 5 + [P]
        out["odim_step_base"] = f
    return out


def _timings(tag, raw, ortho, fns, stream):
    """Every kernel and variant on dim_step's operands ``raw`` and
    odim_step's ``ortho`` (Q in place of B), in turns; their outputs
    against the shipped kernels'."""
    phi, qp, um, bm, _, h, xg = raw
    m, r = phi.shape
    n = xg.shape[1]
    ptr = [a.data_ptr() for a in raw]
    optr = [a.data_ptr() for a in ortho]
    pn = torch.empty_like(phi)
    o9 = torch.empty((m, 9), device="cuda")
    i0 = torch.empty((m,), dtype=torch.int32, device="cuda")
    fk = torch.empty((m, n), device="cuda")

    def call(name):
        f = fns[name]
        if name.startswith("dim_step"):
            return lambda: f(*ptr, pn.data_ptr(), o9.data_ptr(), m, n, r, 0,
                             0, stream)
        if name.startswith("cdf_bracket"):
            return lambda: f(*ptr[:2], *ptr[3:4], *ptr[5:], o9.data_ptr(),
                             i0.data_ptr(), m, n, r, 0, 0, stream)
        if name.startswith("factor_conditional"):
            return lambda: f(ptr[0], ptr[3], fk.data_ptr(), m, n, r, 0,
                             stream)
        return lambda: f(*optr, pn.data_ptr(), o9.data_ptr(), m, n, r, 0, 0,
                         stream)

    ship = {"dim_step": dim_step_cuda(*raw),
            "odim_step": odim_step_cuda(*ortho),
            "factor_conditional": factor_conditional_cuda(phi, bm)}
    fk_ship = ship["factor_conditional"]
    small = float((fk_ship < 2.0 ** -8 * fk_ship.amax(1, keepdim=True))
                  .double().mean())
    agree = {}
    for name in fns:
        assert call(name)() == 0, name
        torch.cuda.synchronize()
        base = next((k for k in ship if name.startswith(k)), None)
        if base == "factor_conditional":
            agree[name] = {
                "fk_equal": bool(torch.equal(fk, fk_ship)),
                "fk_max_rel_diff": float(((fk - fk_ship).abs()
                                          / fk_ship.amax(1, keepdim=True)
                                          ).max())}
        elif base in ship:
            sp, so = ship[base]
            agree[name] = {"out9_equal": bool(torch.equal(o9, so)),
                           "out_max_diff": float((pn - sp).abs().max())}
    cases = {
        "dim_step": lambda: dim_step_cuda(*raw),
        "dim_step_one_pass": call("dim_step_one_pass"),
        "dim_step_wg2": call("dim_step_wg2"),
        "odim_step": lambda: odim_step_cuda(*ortho),
        "cdf_bracket_factor": lambda: cdf_bracket_factor_cuda(
            phi, qp, bm, h, xg),
        "cdf_bracket_factor_wg2": call("cdf_bracket_factor_wg2"),
        "factor_conditional": lambda: factor_conditional_cuda(phi, bm),
        **{name: call(name) for name in fns
           if name.startswith(("factor_conditional_", "odim_step_"))},
        "matmul": lambda: torch.matmul(phi, bm)}
    ms = {k: [] for k in cases}
    for order in (list(cases), list(cases)[::-1]):
        for k in order:
            ms[k].append(_time_ms(cases[k]))
    return {"operands": tag, "n": n, "r": r, "rows": m, "ms": ms,
            "small_node_share": small, "variants_vs_shipped": agree}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="another checkout's csrc directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tc_variants: torch.cuda is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    os.makedirs(OUT, exist_ok=True)
    one = _edited_copy("one_pass", [("tc_dim.cuh", FIRST_PASS, ONE_PASS)])
    wg2 = _edited_copy("wg2", [("tc_conditional.cuh", WARPGROUPS,
                                WARPGROUPS.replace("t == 24 ? 3 : 2", "2"))])
    none = _edited_copy("no_recompute",
                        [("factor_conditional.cu", RECOMPUTE, "")])
    row = _edited_copy("row_recompute",
                       [("factor_conditional.cu", RECOMPUTE, ROW_RECOMPUTE)])
    warp = _edited_copy("warp_recompute",
                        [("factor_conditional.cu", RECOMPUTE, WARP_RECOMPUTE)])
    jobs = {"tc_probe": os.path.join(ROOT, "tools", "tc_probe.cu"),
            "dim_one_pass": os.path.join(one, "dim_step.cu"),
            "dim_wg2": os.path.join(wg2, "dim_step.cu"),
            "factor_wg2": os.path.join(wg2, "factor_step.cu"),
            "fc_no_recompute": os.path.join(none, "factor_conditional.cu"),
            "fc_row_recompute": os.path.join(row, "factor_conditional.cu"),
            "fc_warp_recompute": os.path.join(warp, "factor_conditional.cu")}
    if args.baseline:
        base = _edited_copy("baseline", [], src=args.baseline)
        jobs["odim_base"] = os.path.join(base, "odim_step.cu")
        for fname in ("factor_conditional.cu", "factor_step.cu"):
            path = os.path.join(base, fname)
            if os.path.exists(path) and "factor_conditional_launch" in open(
                    path).read():
                jobs["fc_base"] = path
                break
    libs = _build_variants(jobs)
    fns = _launchers(libs)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    m = 1 << 18
    timings = []
    for n, r in ((33, 23), (17, 19), (17, 13)):
        raw = _random_operands(m, n, r, rng)
        ortho = [raw[0], raw[1], raw[2], raw[3], raw[5], raw[6]]
        timings.append(_timings("random", raw, ortho, fns, stream))
    timings.append(_timings("lz40n33_ck, last level, dimension 20",
                            *_lz40_operands(m), fns, stream))
    rec = {"card": card, "baseline": args.baseline,
           "accuracy": _accuracy(ctypes.CDLL(libs["tc_probe"]), stream),
           "timings": timings}
    for row in rec["accuracy"]:
        print(f"fk vs f64 (n={row['n']}, r={row['r']}): plain f32 "
              f"{row['plain_rel']:.3e}, one accumulator "
              f"{row['scheme0_rel']:.3e}, split accumulators (shipped) "
              f"{row['scheme1_rel']:.3e} ({card})")
    for row in rec["timings"]:
        parts = ", ".join(f"{k} {min(v):.4f}" for k, v in row["ms"].items())
        print(f"ms on {row['operands']} operands, n={row['n']}, "
              f"r={row['r']}, {row['rows']} rows (best of 2): {parts}; "
              f"share of nodes below 2^-8 of their row's largest fk "
              f"{row['small_node_share']:.4f}; variants vs shipped "
              f"{json.dumps(row['variants_vs_shipped'])} ({card})")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "tc_variants.json"),
              "w") as fh:
        json.dump(rec, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
