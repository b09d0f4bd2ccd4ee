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

    python3 tools/tc_variants.py --step [--baseline CSRC]

times the two Gram-step kernels of csrc/step.cu instead:
  - gram_conditional in its two designs: (b), shipped, register-blocked
    rows on the FP32 cores (gram_rows rows a thread: 4 up to rank tier
    24, 2 at 32, 1 at 64; "gram_rows2": two up to tier 24),
    and (a), "gram_tc", the tensor-core stage of the factor family with a
    Gram epilogue (tools/tc_probe.cu), with each design's fk against the
    f64 fk beside the plain f32 version's, per dimension through a whole
    level;
  - condition_update with its core staged in shared memory at an odd
    node stride (shipped), at the stride r^2 ("update_unpadded"), and
    with the row's loop over i run to the rank tier from registers
    (row_common.cuh's prefix_update, "update_prefix");
  - the shipped kernels through their C entry points and through their
    Python wrappers ("(wrapper)": the host's time per call included);
  - with --baseline, both kernels as the other checkout's step.cu builds
    them, their outputs against the shipped kernels' bit for bit, and
    the four factor-family kernels (dim_step, cdf_bracket_factor,
    factor_conditional, odim_step) of both checkouts on the same
    operands, bit for bit.
On the operands of path A (examples/data/lz20_ck: one level per shape
(n, r) its transforms give, at the middle dimension, on the carry 2^18
uniform seeds reach there through the plain chain), of path B's shape
(17, 13) on random operands, at every rank tier on random operands
(n=9; r = 8, 16, 24, 32, 64: the even node strides), and of
hi_step="bracket" at lz40n33_ck's last level, dimension 20 (33, 23), for
condition_update.  Every variant's ptxas registers and spills are
printed.  Output in chiprun_out/tc_variants_step.json.

    python3 tools/tc_variants.py --stride --baseline CSRC

holds dim_step and odim_step, whose second pass stages its node slices
at an odd stride (r^2 | 1, csrc/tc_dim.cuh), against the other
checkout's builds of dim_step.cu and odim_step.cu (e.g. the parent
commit's, staged at r^2): phi' and out9 bit for bit in 'irt' and 'rt'
modes, and both timed in turns (shipped, baseline, baseline, shipped) at
2^18 rows on random operands at STRIDE_SHAPES, the even ranks (whose
stride r^2 put a warp's nodes in shared banks) and odd ones beside
them.  Output in chiprun_out/tc_variants_stride.json.

    python3 tools/tc_variants.py --wide --baseline CSRC

times the Gram family's wide tiers, which run csrc/tc_gram.cuh's Gram
stage (3xTF32 wgmma on a ring streamed by cp.async.bulk, a Gram
epilogue): gram_conditional past step.cu's tier (csrc/gram_wide.cu) at
GRAM_WIDE_SHAPES and fused_irt_sqr past fused_irt.cu's
(csrc/fused_wide.cu, d = 8, chip_smoke.build_tt's TTs) at
FUSED_WIDE_SHAPES, 2^18 rows, through their C entry points (outputs and
scratch allocated once) and their wrappers, beside the other checkout's
step.cu and fused_wide.cu (e.g. the parent's FP32-core designs), in
turns; gram_conditional also beside its plain version and einsum.  Each
build is held to the plain version run in f64 on the first
WIDE_CHECK_ROWS rows (fk relative to the largest |fk|; samples and
log-densities at the maximum and the 99th percentile over rows), beside
the plain f32 version (twice plus 1e-6), not to the other build bit for
bit (the arithmetic differs); ptxas's lines of both builds.  Output in
chiprun_out/tc_variants_wide.json.

    python3 tools/tc_variants.py --factor-wide --baseline CSRC [--other-arith]

times the factor family's wide tier (csrc/factor_wide.cu: dim_step,
odim_step, cdf_bracket_factor, factor_conditional past n or r of 64, up
to 128) through its C entry points at 2^18 rows on random operands at
FACTOR_WIDE_SHAPES beside the other checkout's factor_wide.cu (e.g. the
tier's previous design; one whose entry points take no scratch is
called so), torch.matmul(phi, B) and factor_conditional's einsum, all in
turns, with the tensor-core and FP32 bounds of chip_smoke.py's phase
31.  It holds every output of the two builds to each other bit for bit;
with --other-arith (a baseline with other arithmetic) it holds each
build instead to the plain versions run in f64 on the first
FACTOR_WIDE_CHECK_ROWS rows (maximum and 99th percentile, beside the
plain f32 versions') and to its own ties.  ptxas's registers, spills and
warnings of both builds.  Output in
chiprun_out/tc_variants_factor_wide.json.

    python3 tools/tc_variants.py --cell-readout --baseline CSRC

times kernel 3's wide tier (condition_update past n or r of 64) and
kernel 7's wide readout (odim_step) as csrc/cell_readout.cu runs them
(the rows grouped by cell, 3xTF32 wgmma; odim_step after factor_wide.cu's
stage) beside the other checkout's step.cu and factor_wide.cu (e.g. the
parent's: a warp a row, the slices read from L2), through their C entry
points with outputs and scratch allocated once, and the new ones through
the package's wrappers too, with cdf_bracket_factor (the stage without a
readout), all in turns at CELL_READOUT_SHAPES and 2^18 rows; kernel 3 also
with every row in one cell.  Each build held to the plain versions run in
f64, beside the plain f32 versions (twice plus 1e-6), with the bounds
(the grouped form on the tensor cores, the row-by-row form on the FP32
cores).  Output in chiprun_out/tc_variants_cell_readout.json.

    python3 tools/tc_variants.py --update-batches

times dim_step's wide tier (2^18 rows, FACTOR_WIDE_SHAPES) with the
edits UPDATE_VARIANTS of its prefix update (the rows unsorted, the
update's batches left out, batches of 1, 2, 8 rows, with and without a
branch around a row's FMAs) beside the shipped build and
cdf_bracket_factor, in turns, phin bit for bit.  Output in
chiprun_out/tc_variants_update.json.

    python3 tools/tc_variants.py --fused [--baseline CSRC]

times the whole-transform kernel of csrc/fused_irt.cu (design CU,
shipped: rows blocked in registers on the FP32 cores, the next
dimension's block copied in while this one computes) beside:
  - design T, tools/fused_tc.cu: the same loop with the Gram contraction
    as 3xTF32 wgmma and a Gram epilogue, one row a thread (rank tiers
    8-32, where its operands fit);
  - one single-edit variant for each of the design's four items:
    "rows1" (one row a thread), "single_buffer" (the block copied in
    between two barriers), "two_buffers" (two wherever they fit) and
    "most_blocks" (of one or two, the plan with more resident blocks; the
    shipped plan counts them up to two an SM, two buffers on a tie),
    "stride_rr" (the shipped kernel on an operand
    packed at core node stride r^2) and "i_to_tier" (the prefix update's
    loop over i unrolled to the rank tier from registers,
    row_common.cuh's prefix_update);
  - the shipped kernel through its C entry point (operand packed once)
    and through its Python wrapper ("(wrapper)": the host's packing of
    the operand and its checks included);
  - with --baseline, the other checkout's fused_irt.cu (the C interface
    of the one-row-a-thread kernel: q, p2, coreu, x, h).
Operands: the bench TT (d=40, n=17, r=13; chip_smoke.build_tt) at 2^18
uniform seeds, and random TTs of the same family (d=16) at every shape
(n, r) of the card tests.  Each variant's samples and log-densities are
held against the baseline's (else the shipped kernel's), bit for bit or
by their largest difference; ptxas registers and spills of every build.
Output in tc_variants_fused.json in chip_smoke.py's output directory.
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
from tt_irt_tpu_torch.ops.step import _lib as step_lib  # noqa: E402
from tt_irt_tpu_torch.ops.step import (cdf_bracket_factor_cuda,  # noqa: E402
                                       condition_update_cuda,
                                       condition_update_ref,
                                       factor_conditional_cuda,
                                       gram_conditional_cuda,
                                       gram_conditional_ref)

OUT = os.path.join(ROOT, "build", "variants")
P = ctypes.c_void_p
I = ctypes.c_int
PACKAGE = ("dim_step", "dim_step_rt", "odim_step", "factor_step",
           "factor_conditional")

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


def _ptxas(report):
    """ptxas's lines on each instance's registers and spills."""
    return [ln.strip() for ln in report.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln
            or "serializ" in ln or "warning" in ln or "(C75" in ln]


def _build_variants(jobs, package_names=PACKAGE, reports=None):
    """{lib name: source} -> {lib name: path}, all nvcc at once, beside
    the package's own build of ``package_names``; ptxas's lines of each
    into ``reports`` when given."""
    pool = ThreadPoolExecutor(max_workers=1)
    package = pool.submit(build_all, package_names)
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
        if reports is not None:
            reports[name] = _ptxas(out)
    built = package.result()
    pool.shutdown()
    if reports is not None:
        for name, (out, _) in built.items():
            reports["package " + name] = _ptxas(out)
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
    ap.add_argument("--step", action="store_true",
                    help="the Gram-step kernels of csrc/step.cu only")
    ap.add_argument("--fused", action="store_true",
                    help="the whole-transform kernel of csrc/fused_irt.cu "
                         "only")
    ap.add_argument("--stride", action="store_true",
                    help="dim_step and odim_step against --baseline's "
                         "(the staged node stride) only")
    ap.add_argument("--factor-wide", action="store_true",
                    help="the factor family's wide tier against "
                         "--baseline's factor_wide.cu only")
    ap.add_argument("--other-arith", action="store_true",
                    help="with --factor-wide: a baseline with other "
                         "arithmetic (each build held to the plain "
                         "version in f64 and to its own ties, not to the "
                         "other build bit for bit)")
    ap.add_argument("--update-batches", action="store_true",
                    help="dim_step's wide prefix update against edits of "
                         "its batching only")
    ap.add_argument("--wide", action="store_true",
                    help="gram_conditional's and fused_irt_sqr's wide "
                         "tiers against --baseline's step.cu and "
                         "fused_wide.cu only")
    ap.add_argument("--cell-readout", action="store_true",
                    help="kernel 3's wide tier and kernel 7's wide readout "
                         "(csrc/cell_readout.cu) against --baseline's "
                         "step.cu and factor_wide.cu only")
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
    if args.step:
        return step_main(args, card)
    if args.cell_readout:
        return cell_readout_main(args, card)
    if args.wide:
        return wide_main(args, card)
    if args.factor_wide:
        return factor_wide_main(args, card)
    if args.update_batches:
        return update_main(args, card)
    if args.fused:
        return fused_main(args, card)
    if args.stride:
        return stride_main(args, card)
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


# ---- the staged node stride of dim_step and odim_step (--stride) ----

STRIDE_SHAPES = ((17, 16), (17, 20), (33, 16), (33, 12), (33, 20),
                 (17, 15), (17, 19), (33, 23), (9, 8), (9, 32))


def stride_main(args, card):
    if not args.baseline:
        raise SystemExit("--stride needs --baseline CSRC")
    base = _edited_copy("baseline", [], src=args.baseline)
    ptxas = {}
    libs = _build_variants({"dim_base": os.path.join(base, "dim_step.cu"),
                            "odim_base": os.path.join(base, "odim_step.cu")},
                           ("dim_step", "odim_step"), ptxas)
    dim_b = ctypes.CDLL(libs["dim_base"]).dim_step_launch
    dim_b.argtypes = [P] * 9 + [I] * 5 + [P]
    od_b = ctypes.CDLL(libs["odim_base"]).odim_step_launch
    od_b.argtypes = [P] * 8 + [I] * 5 + [P]
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(8)
    m = 1 << 18
    rows = []
    for n, r in STRIDE_SHAPES:
        raw = _random_operands(m, n, r, rng)
        ortho = [raw[0], raw[1], raw[2], raw[3], raw[5], raw[6]]
        pn = torch.empty_like(raw[0])
        o9 = torch.empty((m, 9), device="cuda")
        equal = {}
        cases = {}
        for kname, ops, ship, based in (
                ("dim_step", raw, dim_step_cuda, dim_b),
                ("odim_step", ortho, odim_step_cuda, od_b)):
            ptr = [a.data_ptr() for a in ops]
            for rt in (0, 1):
                mode = "rt" if rt else "irt"
                sp, so = ship(*ops, mode=mode)
                assert based(*ptr, pn.data_ptr(), o9.data_ptr(), m, n, r,
                             rt, 0, stream) == 0, (kname, n, r)
                torch.cuda.synchronize()
                equal[f"{kname} {mode}"] = bool(
                    torch.equal(pn, sp) and torch.equal(o9, so))
            cases[kname] = (lambda f=ship, o=ops: f(*o))
            cases[kname + " baseline"] = (
                lambda f=based, p_=ptr: f(*p_, pn.data_ptr(), o9.data_ptr(),
                                          m, n, r, 0, 0, stream))
        ms = {k: [] for k in cases}
        for order in (list(cases), list(cases)[::-1]):
            for k in order:
                ms[k].append(_time_ms(cases[k]))
        rows.append({"n": n, "r": r, "rows": m, "stride": (r * r) | 1,
                     "baseline_stride": r * r, "ms": ms,
                     "equal_to_baseline": equal})
    rec = {"card": card, "baseline": args.baseline, "ptxas": ptxas,
           "timings": rows}
    for name, lines in ptxas.items():
        for ln in lines:
            print(f"ptxas {name}: {ln}")
    for row in rows:
        parts = ", ".join(f"{k} {min(v):.4f}" for k, v in row["ms"].items())
        print(f"ms at n={row['n']}, r={row['r']}, {row['rows']} rows (best "
              f"of 2; stride {row['stride']}, baseline "
              f"{row['baseline_stride']}): {parts}; equal to the baseline "
              f"{json.dumps(row['equal_to_baseline'])} ({card})")
    same = all(all(r_["equal_to_baseline"].values()) for r_ in rows)
    print(f"dim_step and odim_step equal to the baseline's at every shape "
          f"and mode: {same}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "tc_variants_stride.json"),
              "w") as fh:
        json.dump(rec, fh, indent=1)
    return 0 if same else 1


# ---- the Gram-step kernels (--step) ----

GRAM_ROWS = ("constexpr int gram_rows() { return T <= 24 ? 4 : T <= 32 ? 2 "
             ": 1; }")
NODE_STRIDE = "const int stride = STAGED ? odd(rr) : rr;"
UPDATE_ROW = """      update_row<RMAX>(buf + tid * pitch, la[row], lb[row], ca, ca + stride,
                       r, acc);
"""
PREFIX_UPDATE = """      float p[RMAX];
#pragma unroll
      for (int i = 0; i < RMAX; ++i)
        p[i] = (i < r) ? buf[tid * pitch + i] : 0.0f;
      prefix_update<RMAX>(p, la[row], lb[row], ca, ca + stride, r, acc);
"""


def _step_launchers(libs):
    """The shipped step kernels', the variants' and the baseline's launch
    functions, typed: {name: (kind, fn)}, kind "gram" or "update" (the
    baseline's condition_update_launch takes no device argument).  All
    are timed through these C entry points with their outputs allocated
    once, so that the host's time per call (the wrappers' checks and
    allocations) stays out of the kernels' times."""
    ship = step_lib()
    out = {"gram_conditional": ("gram", ship.gram_conditional_launch),
           "condition_update": ("update", ship.condition_update_launch)}
    for name in ("gram_rows2", "update_unpadded", "update_prefix",
                 "step_base"):
        if name not in libs:
            continue
        lib = ctypes.CDLL(libs[name])
        if name in ("gram_rows2", "step_base"):
            f = lib.gram_conditional_launch
            f.argtypes = [P, P, P, I, I, I, I, P]
            out[name.replace("step_base", "gram_base")] = ("gram", f)
        if name != "gram_rows2":
            f = lib.condition_update_launch
            f.argtypes = [P] * 6 + [I] * (3 if name == "step_base" else 4) \
                + [P]
            out[name.replace("step_base", "update_base")] = ("update", f)
    f = ctypes.CDLL(libs["tc_probe"]).gram_tc_launch
    f.argtypes = [P, P, P, I, I, I, I, P]
    out["gram_tc"] = ("gram", f)
    return out


def _gram_operands(m, n, r, rng):
    """Random operands of the two step kernels: a max-normalised phi, a
    general P, a core, brackets and independent weights."""
    phi = rng.standard_normal((m, r)).astype(np.float32)
    phi /= np.max(np.abs(phi), axis=1, keepdims=True)
    return [torch.from_numpy(a).cuda() for a in (
        phi, rng.standard_normal((r * r, n)).astype(np.float32),
        rng.standard_normal((n, r * r)).astype(np.float32),
        rng.integers(0, n - 1, size=m).astype(np.int32),
        rng.uniform(size=m).astype(np.float32),
        rng.uniform(size=m).astype(np.float32))]


def _lz20_levels(m):
    """Path A's operands: for each shape (n, r) the transforms of
    examples/data/lz20_ck give, the last level of that shape ('f32'
    prep, as DirtSampler prepares it), with the plain chain's phi at
    every dimension on m uniform seeds and the CDF's i0, la, lb there:
    {(n, r): (level, [(phi, pmat, cmat, i0, la, lb) per dimension])}."""
    import tt_irt_tpu_torch as tp
    from tt_irt_tpu_torch.samplers.dirt import _prepare_level_preps
    from tt_irt_tpu_torch.samplers.irt import _canon_grid
    from tt_irt_tpu_torch.samplers.irt_scan import (_cdf_invert, _prep,
                                                    stack_padded)

    dirt = tp.load_dirt(os.path.join(ROOT, "examples", "data", "lz20_ck"),
                        device="cuda")
    gs0, f0c = _canon_grid(dirt.x0, dirt.f0)
    preps = [_prep(*stack_padded(f0c, gs0), "f32")] + _prepare_level_preps(
        dirt, "f32")
    shapes = {}
    for level, prep in enumerate(preps):
        _, rr, n = prep.pmat.shape
        shapes[(n, int(round(rr ** 0.5)))] = (level, prep)
    q = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(dirt.d, m))).cuda().float()
    out = {}
    for (n, r), (level, prep) in sorted(shapes.items()):
        phi = torch.zeros((m, r), device="cuda")
        phi[:, 0] = 1.0
        dims = []
        for k in range(dirt.d):
            pm, cm = prep.pmat[k], prep.cmat[k]
            fk = gram_conditional_ref(phi, pm)
            _, _, la, lb, i0 = _cdf_invert("sqr", fk, prep.xs[k],
                                           prep.hs[k], q[k])
            dims.append((phi, pm, cm, i0.to(torch.int32), la, lb))
            phi = condition_update_ref(phi, i0, la, lb, cm)
        out[(n, r)] = (level, dims)
    return out


def _bracket_update_operands(m):
    """condition_update's operands as hi_step="bracket" gives them at
    lz40n33_ck's last level, dimension 20 (33, 23): the carry, the
    bracket of cdf_bracket_factor and the f64 epilogue's weights."""
    from tt_irt_tpu_torch.samplers.irt_scan import _serve_solve

    raw, _ = _lz40_operands(m)
    phi, qp, _, bm, cm, h, xg = raw
    o9, i0 = cdf_bracket_factor_cuda(phi, qp, bm, h, xg)
    _, _, la, lb = _serve_solve("irt", o9, qp.double())
    return [phi, None, cm, i0, la.float(), lb.float()]


def _gram_accuracy(dims, fns, stream):
    """Per dimension of a level, each gram design's fk against the f64
    fk, relative to its largest |fk|, beside the plain f32 version's
    (the card tests' rule: at most 2x the plain's plus 1e-6), and the
    count of fk <= 0 (rows the Gram form rounds to no mass)."""
    worst = {}
    for phi, pm, *_ in dims:
        m, r = phi.shape
        n = pm.shape[1]
        f64 = gram_conditional_ref(phi.double(), pm.double())
        scale = float(f64.abs().max())
        outs = {"plain": gram_conditional_ref(phi, pm),
                "gram_b": gram_conditional_cuda(phi, pm)}
        kind, f = fns["gram_tc"]
        fk = torch.empty((m, n), device="cuda")
        assert f(phi.data_ptr(), pm.data_ptr(), fk.data_ptr(), m, n, r, 0,
                 stream) == 0
        torch.cuda.synchronize()
        outs["gram_tc"] = fk
        for name, v in outs.items():
            e = float((v.double() - f64).abs().max()) / scale
            w = worst.setdefault(name, {"rel_err": 0.0, "nonpositive": 0})
            w["rel_err"] = max(w["rel_err"], e)
            w["nonpositive"] += int((v <= 0).sum())
    for name in ("gram_b", "gram_tc"):
        worst[name]["meets_2x"] = bool(
            worst[name]["rel_err"] <= 2.0 * worst["plain"]["rel_err"] + 1e-6)
    return worst


def _step_timings(tag, ops, fns, stream):
    """Both kernels, their variants and baselines on ops = (phi, pmat,
    cmat, i0, la, lb) (pmat None: condition_update only), in turns; their
    outputs against the shipped kernels' bit for bit."""
    phi, pm, cm, i0, la, lb = ops
    m, r = phi.shape
    n = cm.shape[0]
    fk = torch.empty((m, n), device="cuda")
    pn = torch.empty_like(phi)

    def call(name):
        kind, f = fns[name]
        if kind == "gram":
            return lambda: f(phi.data_ptr(), pm.data_ptr(), fk.data_ptr(),
                             m, n, r, 0, stream)
        ptr = [a.data_ptr() for a in (phi, i0, la, lb, cm)]
        if name == "update_base":
            return lambda: f(*ptr, pn.data_ptr(), m, n, r, stream)
        return lambda: f(*ptr, pn.data_ptr(), m, n, r, 0, stream)

    names = [k for k, (kind, _) in fns.items()
             if pm is not None or kind == "update"]
    cases = {"condition_update (wrapper)": lambda: condition_update_cuda(
        phi, i0, la, lb, cm)}
    agree = {}
    ship_u = condition_update_cuda(phi, i0, la, lb, cm)
    if pm is not None:
        cases["gram_conditional (wrapper)"] = lambda: gram_conditional_cuda(
            phi, pm)
        ship_g = gram_conditional_cuda(phi, pm)
    for name in names:
        err = call(name)()
        torch.cuda.synchronize()
        if err != 0 and name == "gram_tc":     # rank tier 64, or too large
            agree[name] = {"launch_error": err}
            continue
        assert err == 0, (name, err)
        if fns[name][0] == "gram":
            agree[name] = {
                "fk_equal": bool(torch.equal(fk, ship_g)),
                "fk_max_rel_diff": float((fk - ship_g).abs().max()
                                         / ship_g.abs().max())}
        else:
            agree[name] = {"phin_equal": bool(torch.equal(pn, ship_u)),
                           "phin_max_diff": float((pn - ship_u).abs().max())}
        cases[name] = call(name)
    ms = {k: [] for k in cases}
    for order in (list(cases), list(cases)[::-1]):
        for k in order:
            ms[k].append(_time_ms(cases[k]))
    return {"operands": tag, "n": n, "r": r, "rows": m, "ms": ms,
            "staged": None, "vs_shipped": agree}


def _factor_family_vs_baseline(libs, stream):
    """dim_step, cdf_bracket_factor, factor_conditional and odim_step of
    this checkout against the baseline's on lz40n33_ck's operands at
    dimension 20 of the last level and on random ones: equal bit for
    bit?"""
    raw, ortho = _lz40_operands(1 << 16)
    cases = [("lz40n33_ck dim 20", raw, ortho)]
    rng = np.random.default_rng(5)
    for n, r in ((17, 19), (9, 8), (9, 64)):
        rr = _random_operands(1 << 14, n, r, rng)
        cases.append((f"random ({n}, {r})", rr,
                      [rr[0], rr[1], rr[2], rr[3], rr[5], rr[6]]))
    dim_b = ctypes.CDLL(libs["dim_base"]).dim_step_launch
    dim_b.argtypes = [P] * 9 + [I] * 5 + [P]
    cbf_b = ctypes.CDLL(libs["factor_base"]).cdf_bracket_factor_launch
    cbf_b.argtypes = [P] * 7 + [I] * 5 + [P]
    fc_b = ctypes.CDLL(libs["fc_base"]).factor_conditional_launch
    fc_b.argtypes = [P, P, P, I, I, I, I, P]
    od_b = ctypes.CDLL(libs["odim_base"]).odim_step_launch
    od_b.argtypes = [P] * 8 + [I] * 5 + [P]
    out = {}
    for tag, raw, ortho in cases:
        phi, qp, um, bm, cm, h, xg = raw
        m, r = phi.shape
        n = xg.shape[1]
        ptr = [a.data_ptr() for a in raw]
        optr = [a.data_ptr() for a in ortho]
        pn, o9 = torch.empty_like(phi), torch.empty((m, 9), device="cuda")
        i0 = torch.empty((m,), dtype=torch.int32, device="cuda")
        fk = torch.empty((m, n), device="cuda")
        eq = {}
        sp, so = dim_step_cuda(*raw)
        assert dim_b(*ptr, pn.data_ptr(), o9.data_ptr(), m, n, r, 0, 0,
                     stream) == 0
        torch.cuda.synchronize()
        eq["dim_step"] = torch.equal(pn, sp) and torch.equal(o9, so)
        so, si = cdf_bracket_factor_cuda(phi, qp, bm, h, xg)
        assert cbf_b(*ptr[:2], ptr[3], *ptr[5:], o9.data_ptr(),
                     i0.data_ptr(), m, n, r, 0, 0, stream) == 0
        torch.cuda.synchronize()
        eq["cdf_bracket_factor"] = torch.equal(o9, so) and torch.equal(i0, si)
        sf = factor_conditional_cuda(phi, bm)
        assert fc_b(ptr[0], ptr[3], fk.data_ptr(), m, n, r, 0, stream) == 0
        torch.cuda.synchronize()
        eq["factor_conditional"] = torch.equal(fk, sf)
        sp, so = odim_step_cuda(*ortho)
        assert od_b(*optr, pn.data_ptr(), o9.data_ptr(), m, n, r, 0, 0,
                    stream) == 0
        torch.cuda.synchronize()
        eq["odim_step"] = torch.equal(pn, sp) and torch.equal(o9, so)
        out[tag] = {k: bool(v) for k, v in eq.items()}
    return out


def step_main(args, card):
    rows2 = _edited_copy("gram_rows2", [("step.cu", GRAM_ROWS,
                                         GRAM_ROWS.replace("24 ? 4", "24 ? 2"))])
    unpadded = _edited_copy("update_unpadded", [
        ("step.cu", NODE_STRIDE, NODE_STRIDE.replace("odd(rr)", "rr"))])
    prefix = _edited_copy("update_prefix", [("step.cu", UPDATE_ROW,
                                             PREFIX_UPDATE)])
    jobs = {"tc_probe": os.path.join(ROOT, "tools", "tc_probe.cu"),
            "gram_rows2": os.path.join(rows2, "step.cu"),
            "update_unpadded": os.path.join(unpadded, "step.cu"),
            "update_prefix": os.path.join(prefix, "step.cu")}
    if args.baseline:
        base = _edited_copy("baseline", [], src=args.baseline)
        for name, fname in (("step_base", "step.cu"),
                            ("dim_base", "dim_step.cu"),
                            ("factor_base", "factor_step.cu"),
                            ("fc_base", "factor_conditional.cu"),
                            ("odim_base", "odim_step.cu")):
            if os.path.exists(os.path.join(base, fname)):
                jobs[name] = os.path.join(base, fname)
    ptxas = {}
    libs = _build_variants(jobs, PACKAGE + ("step",), ptxas)
    fns = _step_launchers(libs)
    stream = torch.cuda.current_stream().cuda_stream
    m = 1 << 18
    rec = {"card": card, "baseline": args.baseline, "ptxas": ptxas,
           "timings": [], "gram_accuracy": {}}
    for name, lines in ptxas.items():
        for ln in lines:
            print(f"ptxas {name}: {ln}")
    lz20 = _lz20_levels(m)
    for (n, r), (level, dims) in lz20.items():
        tag = f"lz20_ck level {level} (n={n}, r={r})"
        rec["gram_accuracy"][tag] = _gram_accuracy(dims, fns, stream)
        rec["timings"].append(_step_timings(
            f"{tag}, dimension {len(dims) // 2}", dims[len(dims) // 2], fns,
            stream))
    del lz20
    rng = np.random.default_rng(3)
    for n, r in ((17, 13), (9, 8), (9, 16), (9, 24), (9, 32), (9, 64),
                 (17, 19), (33, 23)):
        rec["timings"].append(_step_timings(
            "random", _gram_operands(m, n, r, rng), fns, stream))
    rec["timings"].append(_step_timings(
        "hi_step=\"bracket\", lz40n33_ck last level, dimension 20",
        _bracket_update_operands(m), fns, stream))
    lib = step_lib()
    for row in rec["timings"]:
        row["staged"] = bool(lib.condition_update_staged(row["n"], row["r"]))
    if "dim_base" in libs:
        rec["factor_family_equal_to_baseline"] = _factor_family_vs_baseline(
            libs, stream)
    for tag, acc in rec["gram_accuracy"].items():
        print(f"gram_conditional fk vs f64 per dimension, {tag}: "
              + json.dumps(acc) + f" ({card})")
    for row in rec["timings"]:
        parts = ", ".join(f"{k} {min(v):.4f}" for k, v in row["ms"].items())
        print(f"ms on {row['operands']} operands, n={row['n']}, "
              f"r={row['r']}, {row['rows']} rows (best of 2; core staged: "
              f"{row['staged']}): {parts}; vs shipped "
              f"{json.dumps(row['vs_shipped'])} ({card})")
    if "dim_base" in libs:
        print("factor-family kernels equal to the baseline's: "
              + json.dumps(rec["factor_family_equal_to_baseline"]))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "tc_variants_step.json"),
              "w") as fh:
        json.dump(rec, fh, indent=1)
    return 0


FACTOR_WIDE_SHAPES = ((9, 128), (96, 32), (33, 96), (96, 128))


class _Libraries:
    """Several loaded libraries as one: an attribute is the first
    library's that has it."""

    def __init__(self, *libs):
        self._libs = libs

    def __getattr__(self, name):
        for lib in self._libs:
            if hasattr(lib, name):
                return getattr(lib, name)
        raise AttributeError(name)


def factor_wide_library():
    """The package's wide factor tier as one library: the C functions of
    csrc/factor_wide.cu and csrc/factor_wide_cond.cu (two sources built in
    parallel), as one build of a single factor_wide.cu offered them."""
    from tt_irt_tpu_torch.ops._build import load_library

    return _Libraries(load_library("factor_wide"),
                      load_library("factor_wide_cond"))


def _factor_wide_calls(lib, t, m, n, r, stream, readout=None):
    """{kernel: call} of one factor_wide build's four entry points on the
    operands t; each call returns its outputs.  A build that exports
    factor_wide_scratch_floats takes its scratch last (allocated a call,
    as the package's wrappers do).  With ``readout`` (a cell_readout.cu
    library, typed as ops/cell_readout.py types it) the build's
    odim_step_wide_launch writes each row's cell, and the readout forms
    psin from it and the split (the package's odim_step since the
    cell-grouped readout); without, it writes psin itself."""
    p, i = ctypes.c_void_p, ctypes.c_int
    split = hasattr(lib, "factor_wide_scratch_floats")
    types = {"dim_step_wide_launch": [p] * 9 + [i] * 5 + [p],
             "odim_step_wide_launch": [p] * 8 + [i] * 5 + [p],
             "cdf_bracket_factor_wide_launch": [p] * 7 + [i] * 5 + [p],
             "factor_conditional_wide_launch": [p] * 3 + [i] * 4 + [p]}
    for name, argtypes in types.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes + [p] * split, i
    if split:
        lib.factor_wide_scratch_floats.argtypes = [i, i]
        lib.factor_wide_scratch_floats.restype = ctypes.c_longlong
    dev = t["phi"].device.index
    f32 = dict(dtype=torch.float32, device=t["phi"].device)

    def launch(fn, *args):
        extra = ()
        if split:
            scratch = torch.empty(
                (lib.factor_wide_scratch_floats(n, r),), **f32)
            extra = (scratch.data_ptr(),)
        err = fn(*args, *extra)
        if err != 0:
            raise RuntimeError(f"factor_wide launch failed: cudaError {err}")

    def dim():
        phin, out9 = torch.empty((m, r), **f32), torch.empty((m, 9), **f32)
        launch(lib.dim_step_wide_launch,
               t["phi"].data_ptr(), t["qp32"].data_ptr(),
               t["um32"].data_ptr(), t["bmat"].data_ptr(),
               t["cmat"].data_ptr(), t["hrow"].data_ptr(),
               t["xg"].data_ptr(), phin.data_ptr(), out9.data_ptr(), m, n, r,
               0, dev, stream)
        return phin, out9

    def odim():
        psin, out9 = torch.empty((m, r), **f32), torch.empty((m, 9), **f32)
        if readout is None:
            launch(lib.odim_step_wide_launch,
                   t["phi"].data_ptr(), t["qp32"].data_ptr(),
                   t["um32"].data_ptr(), t["bmat"].data_ptr(),
                   t["hrow"].data_ptr(), t["xg"].data_ptr(),
                   psin.data_ptr(), out9.data_ptr(), m, n, r, 0, dev, stream)
            return psin, out9
        split = torch.empty((lib.factor_wide_scratch_floats(n, r),), **f32)
        cell = torch.empty((2 * m,), dtype=torch.int32, device=psin.device)
        plan = torch.empty((readout.cell_readout_plan_words(m, n),),
                           dtype=torch.int32, device=psin.device)
        err = lib.odim_step_wide_launch(
            t["phi"].data_ptr(), t["qp32"].data_ptr(), t["um32"].data_ptr(),
            t["bmat"].data_ptr(), t["hrow"].data_ptr(), t["xg"].data_ptr(),
            cell.data_ptr(), out9.data_ptr(), m, n, r, 0, dev, stream,
            split.data_ptr())
        err = err or readout.cell_readout_launch(
            t["phi"].data_ptr(), cell.data_ptr(), cell.data_ptr() + 4 * m,
            None, split.data_ptr(), psin.data_ptr(), m, n, r, dev, stream,
            plan.data_ptr())
        if err != 0:
            raise RuntimeError(f"odim_step wide launch failed: cudaError "
                               f"{err}")
        return psin, out9

    def bracket():
        out9 = torch.empty((m, 9), **f32)
        i0 = torch.empty((m,), dtype=torch.int32, device=t["phi"].device)
        launch(lib.cdf_bracket_factor_wide_launch,
               t["phi"].data_ptr(), t["qp32"].data_ptr(),
               t["bmat"].data_ptr(), t["hrow"].data_ptr(),
               t["xg"].data_ptr(), out9.data_ptr(), i0.data_ptr(), m, n, r,
               0, dev, stream)
        return out9, i0

    def cond():
        fk = torch.empty((m, n), **f32)
        launch(lib.factor_conditional_wide_launch,
               t["phi"].data_ptr(), t["bmat"].data_ptr(), fk.data_ptr(), m,
               n, r, dev, stream)
        return (fk,)

    return {"dim_step": dim, "odim_step": odim, "cdf_bracket_factor": bracket,
            "factor_conditional": cond}


# Rows of the accuracy checks of --other-arith (the plain version in f64
# materialises phi B: 0.8 GB at (96, 128) and 2^13 rows).
FACTOR_WIDE_CHECK_ROWS = 1 << 13


def _stats(err):
    """(max, p99) of a non-negative error tensor."""
    err = err.flatten().double()
    return float(err.max()), float(torch.quantile(
        err[torch.randperm(err.numel(), device=err.device)[:1 << 24]], 0.99))


def _factor_wide_accuracy(outs, t, rows):
    """One build's outputs (the first ``rows`` rows of each kernel's) held
    to the plain versions run in f64 on the same f32 operands, beside the
    plain f32 versions' errors: {kernel: {what: numbers}}; and the ties
    within the build (cdf_bracket_factor's out9 equal to dim_step's where
    um32 == 1 - qp32, odim_step's out9 equal to dim_step's,
    factor_conditional's fk at dim_step's bracket nodes equal to its f1
    and f2)."""
    from tt_irt_tpu_torch.ops.dim_step import dim_step_ref
    from tt_irt_tpu_torch.ops.odim_step import odim_step_ref
    from tt_irt_tpu_torch.ops.step import (cdf_bracket_factor_ref,
                                           factor_conditional_ref)

    a = {k: (v[:rows] if k in ("phi", "qp32", "um32") else v)
         for k, v in t.items()}
    pk, d9 = (o[:rows] for o in outs["dim_step"])
    ps, q9 = (o[:rows] for o in outs["odim_step"])
    b9, i0 = (o[:rows] for o in outs["cdf_bracket_factor"])
    fk = outs["factor_conditional"][0][:rows]
    acc = {}
    for name, ref, args, kern in (
            ("dim_step", dim_step_ref, (a["phi"], a["qp32"], a["um32"],
                                        a["bmat"], a["cmat"], a["hrow"],
                                        a["xg"]), (pk, d9)),
            ("odim_step", odim_step_ref, (a["phi"], a["qp32"], a["um32"],
                                          a["bmat"], a["hrow"], a["xg"]),
             (ps, q9))):
        p32, o32 = ref(*args)
        p64, o64 = ref(*(x.double() for x in args))
        same = (kern[1][:, 4] == o32[:, 4]) & (o64[:, 4].float()
                                               == o32[:, 4])
        out = {"brackets_equal_share": float(same.double().mean())}
        for who, p_ in (("kernel", kern[0]), ("plain", p32)):
            e_max, e_p99 = _stats((p_.double() - p64)[same].abs().amax(1))
            out[f"phin_{who}_vs_f64_max"] = e_max
            out[f"phin_{who}_vs_f64_p99"] = e_p99
        acc[name] = out
        del p32, o32, p64, o64
    o32, _ = cdf_bracket_factor_ref(a["phi"], a["qp32"], a["bmat"],
                                    a["hrow"], a["xg"])
    scale = o32.abs().amax(0) + 1e-30
    same = i0 == cdf_bracket_factor_ref(a["phi"], a["qp32"], a["bmat"],
                                        a["hrow"], a["xg"])[1]
    acc["cdf_bracket_factor"] = {
        "brackets_equal_share": float(same.double().mean()),
        "out9_max_rel_to_column_scale": float(
            ((b9 - o32).abs() / scale)[same].max())}
    f64 = factor_conditional_ref(a["phi"].double(), a["bmat"].double())
    fkp = factor_conditional_ref(a["phi"], a["bmat"])
    out = {}
    for who, f_ in (("kernel", fk), ("plain", fkp)):
        for scale_name, sc in (("max", f64.max()),
                               ("row", f64.amax(1, keepdim=True))):
            e_max, e_p99 = _stats((f_.double() - f64).abs() / sc)
            out[f"fk_{who}_vs_f64_rel_{scale_name}_max"] = e_max
            out[f"fk_{who}_vs_f64_rel_{scale_name}_p99"] = e_p99
    acc["factor_conditional"] = out
    eq = a["um32"] == 1.0 - a["qp32"]
    i1 = torch.searchsorted(a["xg"][0].contiguous(), d9[:, 4].contiguous())
    live = ~((d9[:, 2] == 1.0) & (d9[:, 3] == 1.0))
    rr = torch.arange(rows, device=fk.device)
    ties = {"bracket_out9_eq_dim": bool(torch.equal(b9[eq], d9[eq])),
            "odim_out9_eq_dim": bool(torch.equal(q9, d9)),
            "conditional_fk_eq_dim_f1_f2": bool(
                torch.equal(fk[rr, i1][live], d9[:, 2][live])
                and torch.equal(fk[rr, i1 + 1][live], d9[:, 3][live]))}
    return acc, ties


def factor_wide_main(args, card):
    import chip_smoke

    if not args.baseline:
        raise SystemExit("--factor-wide needs --baseline (another csrc)")
    base = _edited_copy("baseline", [], src=args.baseline)
    reports = {}
    jobs = {"factor_wide_base": os.path.join(base, "factor_wide.cu")}
    if os.path.exists(os.path.join(base, "cell_readout.cu")):
        jobs["cell_readout_base"] = os.path.join(base, "cell_readout.cu")
    libs = _build_variants(jobs, ("factor_wide", "factor_wide_cond",
                                  "cell_readout"), reports)
    from tt_irt_tpu_torch.ops.cell_readout import lib as readout_lib
    builds = {"shipped": factor_wide_library(),
              "baseline": ctypes.CDLL(libs["factor_wide_base"])}
    readouts = {"shipped": readout_lib(),
                "baseline": (_typed_readout(libs["cell_readout_base"])
                             if "cell_readout_base" in libs else None)}
    stream = torch.cuda.current_stream().cuda_stream
    m = 1 << 18
    rows = []
    for n, r in FACTOR_WIDE_SHAPES:
        t = chip_smoke._wide_operands(m, n, r, n * r, "cuda")
        calls = {b: _factor_wide_calls(lib, t, m, n, r, stream, readouts[b])
                 for b, lib in builds.items()}
        outs = {b: {k: fn() for k, fn in c.items()}
                for b, c in calls.items()}
        row = {"n": n, "r": r, "rows": m}
        if args.other_arith:
            for b in builds:
                row[f"{b}_accuracy"], row[f"{b}_ties"] = (
                    _factor_wide_accuracy(outs[b], t,
                                          FACTOR_WIDE_CHECK_ROWS))
        else:
            row["equal_to_baseline"] = {
                k: all(torch.equal(a, b) for a, b in zip(
                    outs["shipped"][k], outs["baseline"][k]))
                for k in outs["shipped"]}
        del outs
        torch.cuda.empty_cache()
        phi, bm = t["phi"], t["bmat"]
        b3 = bm.reshape(r, n, r)
        cases = {f"{b} {k}": fn for b, c in calls.items()
                 for k, fn in c.items()}
        cases["matmul"] = lambda: torch.matmul(phi, bm)
        cases["einsum"] = lambda: torch.einsum("mi,ixj,mk,kxj->mx", phi, b3,
                                               phi, b3)
        ms = {k: [] for k in cases}
        for order in (list(cases), list(cases)[::-1]):
            for k in order:
                ms[k].append(_time_ms(cases[k], 3))
                torch.cuda.empty_cache()
        row["ms"] = ms
        row["bounds"] = {}
        for k, (tc, rest, nbytes) in chip_smoke.wide_factor_work(
                m, n, r).items():
            row["bounds"][k] = {
                "tc_ms": chip_smoke._bound_tc(tc, rest, nbytes)[0],
                "fp32_ms": chip_smoke._bound(tc + rest, nbytes)[0]}
        rows.append(row)
        print(f"factor_wide at (n={n}, r={r}), {m} rows, best of 2 in "
              f"turns: " + json.dumps({k: min(v) for k, v in ms.items()})
              + "; " + json.dumps({k: v for k, v in row.items()
                                   if k not in ("ms", "n", "r", "rows")})
              + f" ({card})", flush=True)
        del t, calls, cases
        torch.cuda.empty_cache()
    rec = {"card": card, "baseline": args.baseline, "ptxas": reports,
           "other_arith": bool(args.other_arith), "shapes": rows}
    for name, lines in reports.items():
        for ln in lines:
            print(f"ptxas {name}: {ln}")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "tc_variants_factor_wide.json"),
              "w") as fh:
        json.dump(rec, fh, indent=1)
    if args.other_arith:
        assert all(all(r_[f"{b}_ties"].values()) for r_ in rows
                   for b in builds), rows
    else:
        assert all(all(r_["equal_to_baseline"].values()) for r_ in rows), \
            rows
    return 0


# dim_step's wide prefix update (csrc/factor_wide.cuh, CoreUpdate): the
# shipped batches of up to 4 rows of a cell, no branch among the FMAs,
# beside edits of it.
UPDATE_BATCH = ("constexpr int kBatch = 4;                "
                "// rows of one cell in an update\n")
UPDATE_FMAS = ("              const float pi = __shfl_sync(0xFFFFFFFFu, "
               "pv[k][u0], l0 + d);\n")


def _wide_edit(old, new):
    return ("factor_wide.cuh", old, new)


UPDATE_VARIANTS = {
    # the rows in tile order (a batch only where neighbours share a cell)
    "unsorted": [_wide_edit(
        "    if (tid < rows) sm.order[sm.start[sm.i0[tid]] + rank] = tid;\n",
        "    if (tid < rows) sm.order[tid] = tid + 0 * rank;\n")],
    # the sort and the walk over cells, no batch
    "no_batches": [_wide_edit(
        "      batch<KS / 4>(sm, phi, cmat, phin, row0, r, p, cnt, x);\n",
        "      (void)x;\n")],
    **{f"batch{b}": [_wide_edit(UPDATE_BATCH,
                                f"constexpr int kBatch = {b};\n")]
       for b in (1, 2, 8)},
    # batches of 2 and 8 with a branch around each row's FMAs
    **{f"batch{b}_guarded": [
        _wide_edit(UPDATE_BATCH, f"constexpr int kBatch = {b};\n"),
        _wide_edit(UPDATE_FMAS,
                   "              if (k >= cnt) continue;\n" + UPDATE_FMAS)]
       for b in (2, 8)},
}


def update_main(args, card):
    """dim_step's wide tier with UPDATE_VARIANTS of its prefix update, at
    FACTOR_WIDE_SHAPES and 2^18 rows, in turns with the shipped build and
    cdf_bracket_factor (the kernel without the update); phin of every
    variant that updates held to the shipped one bit for bit (a row's
    chain is its own, whatever its batch)."""
    import chip_smoke
    from tt_irt_tpu_torch.ops._build import load_library

    jobs = {name: os.path.join(_edited_copy(name, edits), "factor_wide.cu")
            for name, edits in UPDATE_VARIANTS.items()}
    reports = {}
    libs = _build_variants(jobs, ("factor_wide", "factor_wide_cond"),
                           reports)
    # each variant's dim_step and odim_step beside the shipped
    # cdf_bracket_factor and factor_conditional (factor_wide_cond.cu)
    cond = load_library("factor_wide_cond")
    builds = {"shipped": factor_wide_library(),
              **{k: _Libraries(ctypes.CDLL(v), cond)
                 for k, v in libs.items()}}
    stream = torch.cuda.current_stream().cuda_stream
    m = 1 << 18
    rows = []
    for n, r in FACTOR_WIDE_SHAPES:
        t = chip_smoke._wide_operands(m, n, r, n * r, "cuda")
        calls = {b: _factor_wide_calls(lib, t, m, n, r, stream)
                 for b, lib in builds.items()}
        ref = calls["shipped"]["dim_step"]()[0]
        equal = {b: bool(torch.equal(c["dim_step"]()[0], ref))
                 for b, c in calls.items() if b != "no_batches"}
        cases = {b: c["dim_step"] for b, c in calls.items()}
        cases["cdf_bracket_factor"] = calls["shipped"]["cdf_bracket_factor"]
        ms = {k: [] for k in cases}
        for order in (list(cases), list(cases)[::-1]):
            for k in order:
                ms[k].append(_time_ms(cases[k], 3))
        rows.append({"n": n, "r": r, "rows": m, "ms": ms,
                     "phin_equal_to_shipped": equal})
        print(f"dim_step's update variants at (n={n}, r={r}), {m} rows, "
              f"best of 2 in turns: " + json.dumps(
                  {k: round(min(v), 4) for k, v in ms.items()})
              + f"; phin equal to the shipped {json.dumps(equal)} ({card})",
              flush=True)
        del t, calls, cases
        torch.cuda.empty_cache()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "tc_variants_update.json"), "w") as fh:
        json.dump({"card": card, "ptxas": reports, "shapes": rows}, fh,
                  indent=1)
    assert all(all(r_["phin_equal_to_shipped"].values()) for r_ in rows)
    return 0


# ---- the Gram family's wide tiers (--wide) ----

GRAM_WIDE_SHAPES = ((9, 128), (96, 32), (33, 96), (96, 128))
FUSED_WIDE_SHAPES = ((9, 128), (96, 32))
FUSED_WIDE_D = 8
WIDE_CHECK_ROWS = 1 << 12


def _gram_wide_calls(base, phi, pmat, m, n, r, stream):
    """{build: call} of gram_conditional past step.cu's tier: the shipped
    Gram stage through its C entry point (csrc/gram_wide.cu, scratch
    allocated once) and through the package's wrapper, and the baseline's
    step.cu (its gram_conditional_launch, which took the wide shapes
    itself); each call returns fk."""
    from tt_irt_tpu_torch.ops.step import _gram_wide_lib

    lib = _gram_wide_lib()
    dev = phi.device.index
    scratch = torch.empty((lib.gram_wide_scratch_floats(n, r),),
                          dtype=torch.float32, device=phi.device)
    base.gram_conditional_launch.argtypes = [P, P, P, I, I, I, I, P]
    outs = {k: torch.empty((m, n), dtype=torch.float32, device=phi.device)
            for k in ("shipped", "baseline")}

    def shipped():
        err = lib.gram_wide_launch(phi.data_ptr(), pmat.data_ptr(),
                                   outs["shipped"].data_ptr(), m, n, r, dev,
                                   stream, scratch.data_ptr())
        if err:
            raise RuntimeError(f"gram_wide_launch failed: {err}")
        return outs["shipped"]

    def baseline():
        err = base.gram_conditional_launch(
            phi.data_ptr(), pmat.data_ptr(), outs["baseline"].data_ptr(), m,
            n, r, dev, stream)
        if err:
            raise RuntimeError(f"the baseline's launch failed: {err}")
        return outs["baseline"]

    return {"shipped": shipped, "baseline": baseline,
            "shipped (wrapper)": lambda: gram_conditional_cuda(phi, pmat)}


def _fused_wide_calls(base, ops, m, d, n, r, stream):
    """{build: call} of fused_irt_sqr past fused_irt.cu's tier: the
    shipped csrc/fused_wide.cu through its C entry point (scratch
    allocated once) and through the package's wrapper, and the
    baseline's fused_wide.cu (taking scratch last if it exports
    fused_wide_scratch_floats); each call returns (out, lf)."""
    from tt_irt_tpu_torch.ops.fused_irt import _wide_lib, fused_irt_sqr_cuda

    lib = _wide_lib()
    dev = ops[0].device.index
    f32 = dict(dtype=torch.float32, device=ops[0].device)
    base_scratch = hasattr(base, "fused_wide_scratch_floats")
    base.fused_wide_launch.argtypes = [P] * 7 + [I] * 5 + [P] * (
        1 + base_scratch)
    if base_scratch:
        base.fused_wide_scratch_floats.argtypes = [I, I, I]
        base.fused_wide_scratch_floats.restype = ctypes.c_longlong
    scratch = {"shipped": torch.empty(
        (lib.fused_wide_scratch_floats(d, n, r),), **f32)}
    if base_scratch:
        scratch["baseline"] = torch.empty(
            (base.fused_wide_scratch_floats(d, n, r),), **f32)
    outs = {k: (torch.empty((m, d), **f32), torch.empty((m,), **f32))
            for k in ("shipped", "baseline")}

    def call(name, fn):
        def run():
            out, lf = outs[name]
            extra = ((scratch[name].data_ptr(),) if name in scratch
                     else ())
            err = fn(*(o.data_ptr() for o in ops), out.data_ptr(),
                     lf.data_ptr(), m, d, n, r, dev, stream, *extra)
            if err:
                raise RuntimeError(f"{name} fused_wide_launch failed: {err}")
            return out, lf
        return run

    return {"shipped": call("shipped", lib.fused_wide_launch),
            "baseline": call("baseline", base.fused_wide_launch),
            "shipped (wrapper)": lambda: fused_irt_sqr_cuda(*ops)}


def wide_main(args, card):
    """gram_conditional's and fused_irt_sqr's wide tiers (the Gram stage
    of csrc/tc_gram.cuh) against --baseline's step.cu and fused_wide.cu
    in turns, each build held to the plain version run in f64."""
    import chip_smoke

    import tt_irt_tpu_torch as tp
    from tt_irt_tpu_torch.ops.fused_irt import fused_irt_sqr_ref

    if not args.baseline:
        raise SystemExit("--wide needs --baseline (another csrc)")
    base = _edited_copy("baseline", [], src=args.baseline)
    ptxas = {}
    libs = _build_variants({"step_base": os.path.join(base, "step.cu"),
                            "fused_wide_base": os.path.join(
                                base, "fused_wide.cu")},
                           ("step", "gram_wide", "fused_wide"), ptxas)
    bases = {k: ctypes.CDLL(v) for k, v in libs.items()}
    stream = torch.cuda.current_stream().cuda_stream
    m, c = 1 << 18, WIDE_CHECK_ROWS
    rec = {"card": card, "baseline": args.baseline, "rows": m,
           "check_rows": c, "ptxas": ptxas, "gram_conditional": [],
           "fused_irt_sqr": []}
    for name, lines in ptxas.items():
        for ln in lines:
            if "_wide_kernel" in ln or "registers" in ln or "C75" in ln:
                print(f"ptxas {name}: {ln}")
    rng = np.random.default_rng(15)
    for n, r in GRAM_WIDE_SHAPES:
        phi = rng.uniform(0.05, 1.0, (m, r)).astype(np.float32)
        phi /= phi.max(axis=1, keepdims=True)
        phi = torch.from_numpy(phi).cuda()
        pmat = torch.from_numpy(rng.standard_normal((r * r, n)).astype(
            np.float32)).cuda()
        p3 = pmat.reshape(r, r, n)
        calls = _gram_wide_calls(bases["step_base"], phi, pmat, m, n, r,
                                 stream)
        f64 = gram_conditional_ref(phi[:c].double(), pmat.double())
        scale = float(f64.abs().max())
        errs = {"plain": float((gram_conditional_ref(phi[:c], pmat).double()
                                - f64).abs().max()) / scale}
        for k in ("shipped", "baseline"):
            errs[k] = float((calls[k]()[:c].double() - f64).abs().max()) \
                / scale
        cases = dict(calls)
        cases["plain"] = lambda: gram_conditional_ref(phi, pmat)
        cases["einsum"] = lambda: torch.einsum("mi,ijx,mj->mx", phi, p3, phi)
        order = ["shipped", "baseline", "shipped (wrapper)", "plain",
                 "einsum"]
        ms = {k: [] for k in order}
        for k in order + order[::-1]:
            ms[k].append(_time_ms(cases[k], 2 if k in ("plain", "einsum")
                                  else 5))
        bound = chip_smoke._bound_tc(m * 2 * r * r * n, m * r * r,
                                     4 * (m * (r + n) + r * r * n))
        row = {"n": n, "r": r, "ms": ms, "err_vs_f64": errs,
               "bars_met": {k: errs[k] <= 2.0 * errs["plain"] + 1e-6
                            for k in ("shipped", "baseline")},
               "bound_ms": bound[0], "bound_by": bound[1]}
        rec["gram_conditional"].append(row)
        print(f"gram_conditional wide n={n} r={r}, {m} rows, ms (best of 2 "
              f"in turns): " + json.dumps({k: min(v) for k, v in ms.items()})
              + f"; TC bound {bound[0]:.4f} ({bound[1]}); fk error against "
              f"f64 on {c} rows relative to the largest |fk|: "
              + json.dumps(errs) + f" ({card})", flush=True)
        del phi, pmat, p3, calls, f64, cases
        torch.cuda.empty_cache()
    d = FUSED_WIDE_D
    for n, r in FUSED_WIDE_SHAPES:
        tt = tp.tt_from_numpy(chip_smoke.build_tt(d, n, r, seed=n + r),
                              "cuda")
        grids = [torch.linspace(-2.0, 2.0, n, dtype=torch.float64,
                                device="cuda")] * d
        data = tp.build_fused_data(tt, grids)
        q = torch.rand((m, d), generator=torch.Generator(device="cuda")
                       .manual_seed(n + r), device="cuda")
        ops = (q, data["p2"], data["coreu"], data["x"], data["h"])
        calls = _fused_wide_calls(bases["fused_wide_base"], ops, m, d, n, r,
                                  stream)
        small = (q[:c].contiguous(), *ops[1:])
        xr, lr = fused_irt_sqr_ref(*small)
        x64, l64 = fused_irt_sqr_ref(*(o.double() for o in small))
        errs = {}
        for k in ("shipped", "baseline", "plain"):
            xk, lk = (xr, lr) if k == "plain" else calls[k]()
            for what, a, ref in (("x", xk[:c], x64), ("lf", lk[:c], l64)):
                e = (a.double() - ref).abs().reshape(c, -1).amax(1)
                errs[f"{k}_{what}_max"] = float(e.max())
                errs[f"{k}_{what}_p99"] = float(torch.quantile(e, 0.99))
        bars = {k: all(errs[f"{k}_{w}_p99"]
                       <= 2.0 * errs[f"plain_{w}_p99"] + 1e-6
                       for w in ("x", "lf")) for k in ("shipped", "baseline")}
        order = ["shipped", "baseline", "shipped (wrapper)"]
        ms = {k: [] for k in order}
        for k in order + order[::-1]:
            ms[k].append(_time_ms(calls[k], 3))
        f_tc = 2 * r * r * n
        f_rest = r * r + (5 * r * r + 2 * r) + 10 * n
        f_bytes = m * (8 * d + 4) + 4 * d * (2 * r * r * n + 2 * n - 1)
        bound = chip_smoke._bound_tc(m * d * f_tc, m * d * f_rest, f_bytes)
        row = {"n": n, "r": r, "d": d, "ms": ms, "err_vs_f64": errs,
               "bars_met": bars, "bound_ms": bound[0],
               "bound_by": bound[1]}
        rec["fused_irt_sqr"].append(row)
        print(f"fused_irt_sqr wide d={d} n={n} r={r}, {m} rows, ms (best of "
              f"2 in turns): " + json.dumps({k: min(v) for k, v in
                                              ms.items()})
              + f"; TC bound {bound[0]:.4f} ({bound[1]}); against f64 on "
              f"{c} rows: " + json.dumps(errs) + f" ({card})", flush=True)
        del tt, data, q, ops, calls, small, xr, lr, x64, l64
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "tc_variants_wide.json"),
              "w") as fh:
        json.dump(rec, fh, indent=1)
    failed = [(kern, row["n"], row["r"]) for kern in ("gram_conditional",
                                                      "fused_irt_sqr")
              for row in rec[kern] if not row["bars_met"]["shipped"]]
    assert not failed, failed
    return 0


# ---- the whole-transform kernel (--fused) ----

FUSED_ROWS = ("constexpr int fused_rows() { return T <= 24 ? 4 : T <= 32 ? 2 "
              ": 1; }")
FUSED_BUFFERS = "constexpr int kBuffers = 2;"
FUSED_CHOICE = "const int score = cap < 2 * sms ? cap : 2 * sms;"
FUSED_UPDATE = """        update_strided<RMAX>(prow, kCol, st[t].la, st[t].lb, ca, ca + cstride,
                             r, acc);
"""
FUSED_PREFIX = """        prefix_update<RMAX>(p[t], st[t].la, st[t].lb, ca, ca + cstride, r,
                            acc);
"""
FUSED_SHAPES = ((17, 5), (17, 13), (17, 19), (33, 23), (9, 40), (9, 8),
                (9, 16), (9, 24), (9, 32))


def _tf32_round(v):
    """csrc/tc_conditional.cuh's tf32_round on an f32 tensor: round to
    10 explicit mantissa bits, ties to even, by integer arithmetic."""
    u = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def pack_tc(p2, coreu, x, h):
    """Design T's operand (d, block) and (cstride, block): per dimension
    P~'s tf32 hi and lo parts (P~[i, x*r + j] = P[i*r + j, x], zero-padded
    to the rank tier T) in the core-matrix layout of
    tc_conditional.cuh's core_offset, the core at node stride r*r made
    odd, the grid and the spacings, padded to a multiple of 32 floats."""
    d, rr, n = p2.shape
    r = int(round(rr ** 0.5))
    t = 8 if r <= 8 else 16 if r <= 16 else 24 if r <= 24 else 32
    i, j = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
    off = ((i >> 2) * (t // 8) + (j >> 3)) * 32 + (j & 7) * 4 + (i & 3)
    pt = torch.zeros((d, n, t, t), device=p2.device)
    pt[:, :, :r, :r] = p2.reshape(d, r, r, n).permute(0, 3, 1, 2)
    v = torch.zeros((d, n, t * t), device=p2.device)
    v[:, :, torch.from_numpy(off.reshape(-1)).to(p2.device)] = pt.reshape(
        d, n, t * t)
    hi = _tf32_round(v)
    lo = v - hi
    cstride = rr | 1
    cn = torch.nn.functional.pad(coreu, (0, cstride - rr))
    pack = torch.cat([hi.reshape(d, -1), lo.reshape(d, -1),
                      cn.reshape(d, -1), x, h], dim=1)
    block = -(-pack.shape[1] // 32) * 32
    return (torch.nn.functional.pad(pack, (0, block - pack.shape[1]))
            .contiguous(), cstride, block)


def _fused_operands(d, n, r, m, seed):
    """build_fused_data of chip_smoke.build_tt(d, n, r, seed) on the grid
    linspace(-2, 2, n), and m uniform seeds."""
    import tt_irt_tpu_torch as tp
    from chip_smoke import build_tt

    tt = tp.tt_from_numpy(build_tt(d, n, r, seed), device="cuda")
    grid = torch.linspace(-2.0, 2.0, n, dtype=torch.float64, device="cuda")
    data = tp.build_fused_data(tt, [grid] * d)
    q = torch.from_numpy(np.random.default_rng(seed + 7).uniform(
        size=(m, d))).float().cuda()
    return q, data


def _fused_launchers(libs):
    """{name: (kind, fn)}: kind "pack" (the shipped C interface),
    "tc" (design T) or "base" (the one-row-a-thread kernel's)."""
    from tt_irt_tpu_torch.ops.fused_irt import _lib as fused_lib

    out = {"shipped": ("pack", fused_lib().fused_irt_launch),
           "stride_rr": ("pack", fused_lib().fused_irt_launch)}
    for name in ("rows1", "single_buffer", "two_buffers", "most_blocks",
                 "i_to_tier"):
        f = ctypes.CDLL(libs[f"fused_{name}"]).fused_irt_launch
        f.argtypes = [P] * 4 + [I] * 7 + [P]
        out[name] = ("pack", f)
    f = ctypes.CDLL(libs["fused_tc"]).fused_tc_launch
    f.argtypes = [P] * 4 + [I] * 7 + [P]
    out["design_T"] = ("tc", f)
    if "fused_base" in libs:
        f = ctypes.CDLL(libs["fused_base"]).fused_irt_launch
        f.argtypes = [P] * 7 + [I] * 4 + [P]
        out["parent"] = ("base", f)
    return out


def _fused_timings(tag, q, data, fns, stream, reps):
    """Every build on one operand set, in turns (list, then reversed);
    each one's outputs against the parent's (else the shipped kernel's)."""
    from tt_irt_tpu_torch.ops.fused_irt import (fused_irt_plan,
                                                fused_irt_sqr_cuda,
                                                fused_layout, pack_fused)

    m, d = q.shape
    n, r = data["n"], data["r"]
    ops = (data["p2"], data["coreu"], data["x"], data["h"])
    packs = {"pack": pack_fused(*ops), "stride_rr": pack_fused(
        *ops, cstride=r * r)}
    lay = {"pack": fused_layout(n, r)[1:],
           "stride_rr": fused_layout(n, r, r * r)[1:]}
    # design T has no instance above rank tier 32
    tc_pack, tc_cs, tc_block = pack_tc(*ops) if r <= 32 else (None, 0, 0)
    outs = {}

    def call(name):
        kind, f = fns[name]
        xo = torch.empty((m, d), device="cuda")
        lo = torch.empty((m,), device="cuda")
        outs[name] = (xo, lo)
        if kind == "base":
            args = [t.data_ptr() for t in (q, *ops)]
            return lambda: f(*args, xo.data_ptr(), lo.data_ptr(), m, d, n, r,
                             stream)
        if kind == "tc":
            return lambda: f(q.data_ptr(), tc_pack.data_ptr(), xo.data_ptr(),
                             lo.data_ptr(), m, d, n, r, tc_cs, tc_block, 0,
                             stream)
        key = "stride_rr" if name == "stride_rr" else "pack"
        cs, block = lay[key]
        pk = packs[key]
        return lambda: f(q.data_ptr(), pk.data_ptr(), xo.data_ptr(),
                         lo.data_ptr(), m, d, n, r, cs, block, 0, stream)

    cases, errors = {}, {}
    for name in fns:
        if name == "design_T" and tc_pack is None:
            errors[name] = "rank tier 64"
            continue
        fn = call(name)
        err = fn()
        torch.cuda.synchronize()
        if err != 0:                  # design T beyond its tiers or memory
            errors[name] = err
            continue
        cases[name] = fn
    cases["shipped (wrapper)"] = lambda: fused_irt_sqr_cuda(q, *ops)
    ref = "parent" if "parent" in cases else "shipped"
    xr, lr = outs[ref]
    agree = {}
    for name in cases:
        if name not in outs or name == ref:
            continue
        xo, lo = outs[name]
        agree[name] = {
            "equal": bool(torch.equal(xo, xr) and torch.equal(lo, lr)),
            "x_max_diff": float((xo - xr).abs().max()),
            "lf_max_diff": float((lo - lr).abs().max()),
            "finite": bool(torch.isfinite(xo).all()
                           and torch.isfinite(lo).all())}
    ms = {k: [] for k in cases}
    for order in (list(cases), list(cases)[::-1]):
        for k in order:
            ms[k].append(_time_ms(cases[k], reps))
    rows, bufs, smem, grid = fused_irt_plan(n, r, m)
    return {"operands": tag, "n": n, "r": r, "d": d, "rows": m, "ms": ms,
            "plan": {"rows_a_thread": rows, "buffers": bufs,
                     "smem_bytes": smem, "grid": grid},
            "launch_errors": errors, "vs": ref, "agree": agree}


def fused_main(args, card):
    rows1 = _edited_copy("fused_rows1", [("fused_irt.cu", FUSED_ROWS,
                                          FUSED_ROWS.replace(
                                              "T <= 24 ? 4 : T <= 32 ? 2 : 1",
                                              "1"))])
    single = _edited_copy("fused_single_buffer", [
        ("fused_irt.cu", FUSED_BUFFERS, FUSED_BUFFERS.replace("2", "1"))])
    tier = _edited_copy("fused_i_to_tier", [("fused_irt.cu", FUSED_UPDATE,
                                             FUSED_PREFIX)])
    two = _edited_copy("fused_two_buffers", [
        ("fused_irt.cu", FUSED_CHOICE, "const int score = b;")])
    most = _edited_copy("fused_most_blocks", [
        ("fused_irt.cu", FUSED_CHOICE, "const int score = cap;")])
    jobs = {"fused_rows1": os.path.join(rows1, "fused_irt.cu"),
            "fused_single_buffer": os.path.join(single, "fused_irt.cu"),
            "fused_i_to_tier": os.path.join(tier, "fused_irt.cu"),
            "fused_two_buffers": os.path.join(two, "fused_irt.cu"),
            "fused_most_blocks": os.path.join(most, "fused_irt.cu"),
            "fused_tc": os.path.join(ROOT, "tools", "fused_tc.cu")}
    if args.baseline:
        base = _edited_copy("fused_baseline", [], src=args.baseline)
        jobs["fused_base"] = os.path.join(base, "fused_irt.cu")
    ptxas = {}
    libs = _build_variants(jobs, ("fused_irt",), ptxas)
    fns = _fused_launchers(libs)
    stream = torch.cuda.current_stream().cuda_stream
    rec = {"card": card, "baseline": args.baseline, "ptxas": ptxas,
           "timings": []}
    for name, lines in ptxas.items():
        for ln in lines:
            print(f"ptxas {name}: {ln}")
    q, data = _fused_operands(40, 17, 13, 1 << 18, 0)
    rec["timings"].append(_fused_timings(
        "bench TT (d=40, n=17, r=13)", q, data, fns, stream, 10))
    del q, data
    for n, r in FUSED_SHAPES:
        q, data = _fused_operands(16, n, r, 1 << 18, n + r)
        rec["timings"].append(_fused_timings(
            f"random TT (d=16, n={n}, r={r})", q, data, fns, stream, 5))
        del q, data
    for row in rec["timings"]:
        parts = ", ".join(f"{k} {min(v):.4f}" for k, v in row["ms"].items())
        print(f"fused ms on {row['operands']}, {row['rows']} rows (best of "
              f"2; plan {json.dumps(row['plan'])}): {parts}; launch errors "
              f"{json.dumps(row['launch_errors'])}; vs {row['vs']}: "
              f"{json.dumps(row['agree'])} ({card})", flush=True)
    from chip_smoke import OUT_DIR

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "tc_variants_fused.json"), "w") as fh:
        json.dump(rec, fh, indent=1)
    return 0


# ---- the cell-grouped readout (--cell-readout) ----

CELL_READOUT_SHAPES = ((9, 128), (96, 32), (33, 96), (96, 128))
CELL_READOUT_CHECK_ROWS = 1 << 13


def _typed_readout(path):
    from tt_irt_tpu_torch.ops.cell_readout import type_library

    return type_library(ctypes.CDLL(path))


def _cell_readout_cases(base_step, base_wide, t, u, m, n, r, stream):
    """{case: call} at (n, r) on mb = m rows: condition_update (kernel 3)
    and odim_step (kernel 7) in their wide tiers, this checkout's
    ("new": csrc/cell_readout.cu after factor_wide.cu's stage for odim)
    and the baseline's ("was": step.cu's update_wide_kernel, factor_wide.cu
    with FactorUpdate), each through its C entry points with its outputs
    and scratch allocated once; the new ones also through the package's
    wrappers ("(wrapper)"), and cdf_bracket_factor (the stage without a
    readout).  Each call returns its first output."""
    from tt_irt_tpu_torch.ops._build import load_library
    from tt_irt_tpu_torch.ops.cell_readout import lib as readout_lib

    cr, wide = readout_lib(), load_library("factor_wide")
    p, i = ctypes.c_void_p, ctypes.c_int
    base_step.condition_update_launch.argtypes = [p] * 6 + [i] * 4 + [p]
    base_wide.odim_step_wide_launch.argtypes = [p] * 8 + [i] * 5 + [p, p]
    base_wide.factor_wide_scratch_floats.argtypes = [i, i]
    base_wide.factor_wide_scratch_floats.restype = ctypes.c_longlong
    wide.odim_step_wide_launch.argtypes = [p] * 8 + [i] * 5 + [p, p]
    wide.factor_wide_scratch_floats.argtypes = [i, i]
    wide.factor_wide_scratch_floats.restype = ctypes.c_longlong
    f32 = dict(dtype=torch.float32, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    out = torch.empty((m, r), **f32)
    out9 = torch.empty((m, 9), **f32)
    cell = torch.empty((2 * m,), **i32)
    split = torch.empty((wide.factor_wide_scratch_floats(n, r),), **f32)
    base_split = torch.empty((base_wide.factor_wide_scratch_floats(n, r),),
                             **f32)
    plan = torch.empty((cr.cell_readout_plan_words(m, n),), **i32)
    scratch = torch.empty((cr.condition_update_wide_scratch_words(m, n, r),),
                          **i32)
    phi, qp, um, bm, cm, h, xg = (t[k] for k in (
        "phi", "qp32", "um32", "bmat", "cmat", "hrow", "xg"))
    i0, la, lb = u
    ptr = [a.data_ptr() for a in (phi, i0, la, lb, cm)]

    def ok(err):
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out

    def update_new():
        return ok(cr.condition_update_wide_launch(
            *ptr, out.data_ptr(), m, n, r, 0, stream, scratch.data_ptr()))

    def update_was():
        return ok(base_step.condition_update_launch(
            *ptr, out.data_ptr(), m, n, r, 0, stream))

    def odim_new():
        err = wide.odim_step_wide_launch(
            phi.data_ptr(), qp.data_ptr(), um.data_ptr(), bm.data_ptr(),
            h.data_ptr(), xg.data_ptr(), cell.data_ptr(), out9.data_ptr(), m,
            n, r, 0, 0, stream, split.data_ptr())
        return ok(err or cr.cell_readout_launch(
            phi.data_ptr(), cell.data_ptr(), cell.data_ptr() + 4 * m, None,
            split.data_ptr(), out.data_ptr(), m, n, r, 0, stream,
            plan.data_ptr()))

    def odim_was():
        return ok(base_wide.odim_step_wide_launch(
            phi.data_ptr(), qp.data_ptr(), um.data_ptr(), bm.data_ptr(),
            h.data_ptr(), xg.data_ptr(), out.data_ptr(), out9.data_ptr(), m,
            n, r, 0, 0, stream, base_split.data_ptr()))

    return {"condition_update new": update_new,
            "condition_update was": update_was,
            "condition_update new (wrapper)": lambda: condition_update_cuda(
                phi, i0, la, lb, cm),
            "odim_step new": odim_new, "odim_step was": odim_was,
            "odim_step new (wrapper)": lambda: odim_step_cuda(
                phi, qp, um, bm, h, xg)[0],
            "cdf_bracket_factor": lambda: cdf_bracket_factor_cuda(
                phi, qp, bm, h, xg)[0]}


def _cell_readout_accuracy(cases, t, u, rows):
    """Each build's kernel 3 and kernel 7 outputs on the first ``rows``
    rows against the plain versions run in f64 on the same f32 operands,
    beside the plain f32 versions (maximum over the rows; kernel 7 on the
    rows whose brackets agree): {kernel: {build or "plain": error}}."""
    from tt_irt_tpu_torch.ops.odim_step import odim_step_ref

    i0, la, lb = (x[:rows] for x in u)
    phi = t["phi"][:rows]
    p64 = condition_update_ref(phi.double(), i0, la.double(), lb.double(),
                               t["cmat"].double())
    acc = {"condition_update": {}, "odim_step": {}}
    for b in ("new", "was"):
        got = cases[f"condition_update {b}"]()[:rows]
        acc["condition_update"][b] = float((got.double() - p64).abs().max())
    acc["condition_update"]["plain"] = float((condition_update_ref(
        phi, i0, la, lb, t["cmat"]).double() - p64).abs().max())
    args = (phi, t["qp32"][:rows], t["um32"][:rows], t["bmat"], t["hrow"],
            t["xg"])
    pr, orf = odim_step_ref(*args)
    q64, o64 = odim_step_ref(*(a.double() for a in args))
    same = o64[:, 4].float() == orf[:, 4]
    for b in ("new", "was"):
        got = cases[f"odim_step {b}"]()[:rows]
        acc["odim_step"][b] = float((got.double() - q64)[same].abs().max())
    acc["odim_step"]["plain"] = float((pr.double() - q64)[same].abs().max())
    acc["odim_step"]["brackets_equal_share"] = float(same.double().mean())
    return acc


def cell_readout_main(args, card):
    """Kernel 3's wide tier (condition_update past n or r of 64) and
    kernel 7's wide readout (odim_step) as this checkout builds them (the
    cell-grouped readout of csrc/cell_readout.cu) and as --baseline's
    step.cu and factor_wide.cu build them (a warp a row, the slices read
    from L2), at CELL_READOUT_SHAPES and 2^18 rows on phase 26's and 31's
    random operands (cells uniform), in turns (the list, then reversed);
    kernel 3 also with every row in one cell (skewed).  Each build held to
    the plain versions run in f64 on the first CELL_READOUT_CHECK_ROWS
    rows, beside the plain f32 versions; the bounds of chip_smoke.py:
    the grouped form's on the tensor cores (cell_readout_work) and the
    row-by-row form's on the FP32 cores.  Output in
    chiprun_out/tc_variants_cell_readout.json."""
    import chip_smoke

    if not args.baseline:
        raise SystemExit("--cell-readout needs --baseline (another csrc)")
    base = _edited_copy("baseline", [], src=args.baseline)
    reports = {}
    libs = _build_variants(
        {"step_base": os.path.join(base, "step.cu"),
         "factor_wide_base": os.path.join(base, "factor_wide.cu")},
        ("step", "factor_wide", "cell_readout", "factor_step"), reports)
    base_step = ctypes.CDLL(libs["step_base"])
    base_wide = ctypes.CDLL(libs["factor_wide_base"])
    stream = torch.cuda.current_stream().cuda_stream
    m = 1 << 18
    rows = []
    for n, r in CELL_READOUT_SHAPES:
        t = chip_smoke._wide_operands(m, n, r, 31 + n * r, "cuda")
        rng = np.random.default_rng(n * r)
        i0 = torch.from_numpy(rng.integers(0, n - 1, m).astype(
            np.int32)).cuda()
        la = torch.from_numpy(rng.uniform(size=m).astype(np.float32)).cuda()
        u = (i0, la, 1.0 - la)
        cases = _cell_readout_cases(base_step, base_wide, t, u, m, n, r,
                                    stream)
        acc = _cell_readout_accuracy(cases, t, u, CELL_READOUT_CHECK_ROWS)
        one = (torch.full_like(i0, (n - 1) // 2), la, 1.0 - la)
        skewed = _cell_readout_cases(base_step, base_wide, t, one, m, n, r,
                                     stream)
        cases["condition_update new, one cell"] = skewed[
            "condition_update new"]
        cases["condition_update was, one cell"] = skewed[
            "condition_update was"]
        ms = {k: [] for k in cases}
        for order in (list(cases), list(cases)[::-1]):
            for k in order:
                ms[k].append(_time_ms(cases[k], 5))
        tc, rest, nbytes = chip_smoke.cell_readout_work(m, n, r)
        best = {k: min(v) for k, v in ms.items()}
        row = {"n": n, "r": r, "rows": m, "ms": ms, "accuracy": acc,
               "readout_ms": {b: best[f"odim_step {b}"]
                              - best["cdf_bracket_factor"]
                              for b in ("new", "was")},
               "bound_tc_ms": chip_smoke._bound_tc(tc, rest, nbytes)[0],
               "bound_tc_by": chip_smoke._bound_tc(tc, rest, nbytes)[1],
               "bound_fp32_ms": chip_smoke._bound(
                   m * (5 * r * r + 2 * r),
                   4 * (m * (2 * r + 3) + n * r * r))[0]}
        rows.append(row)
        print(f"cell readout at (n={n}, r={r}), {m} rows, best of 2 in "
              f"turns: " + json.dumps(best) + "; " + json.dumps(
                  {k: v for k, v in row.items()
                   if k not in ("ms", "n", "r", "rows")}) + f" ({card})",
              flush=True)
        for b in ("new", "was"):
            for k in ("condition_update", "odim_step"):
                a = acc[k]
                assert a[b] <= 2.0 * a["plain"] + 1e-6, (n, r, k, b, a)
        del t, cases, skewed, u, one
        torch.cuda.empty_cache()
    for name, lines in reports.items():
        for ln in lines:
            if "cell_readout" in name or "C75" in ln or "spill" in ln:
                print(f"ptxas {name}: {ln}")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "tc_variants_cell_readout.json"),
              "w") as fh:
        json.dump({"card": card, "baseline": args.baseline,
                   "ptxas": reports, "shapes": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
