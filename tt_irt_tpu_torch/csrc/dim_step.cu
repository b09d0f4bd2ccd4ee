// One whole 'hi' factor-form inverse-Rosenblatt dimension for a tile of
// rows, for Hopper (sm_90a).
//
// Replaces tt_irt_tpu/ops/pallas_dim.py::dim_step (_dim_kernel), whose
// XLA twin is tt_irt_tpu/samplers/irt_scan.py::_step_factor_b +
// _cdf_rows32.  Per row m (all f32):
//   v[x, j] = sum_i phi[m, i] B[i, x*r + j]           (conditional)
//   fk[x]   = sum_j v[x, j]^2
//   dc[k]   = 0.5 (fk[k] + fk[k+1]) h[k]              (trapezoid cells)
//   ck      = prefix sums of dc, cr = suffix sums     (two-sided CDF)
//   i0      = count-based bracket, clipped to [0, n-2]
//   out9    = [c1, cr2, f1, f2, x1h, x1l, x2h, x2l, tot]
//   la      = f32 citardauq weight of the sample inside its cell
//   phi'    = phi (la C[i0] + (1-la) C[i0+1]) / max|.|  (floor 1e-30)
// The batched f64 epilogue (samplers/irt_scan.py::_serve_solve) turns
// out9 into samples and log-densities after all dimensions.
//
// What bounds it: at n=33, r=23 a row does n*r*r = 17.5k multiply-adds
// in the conditional against ~4.4k other operations (the squares, the
// CDF, the prefix update) and ~230 bytes of row traffic.  On the FP32
// CUDA cores that is 0.15 ms at 2^18 rows (67 TFLOP/s); as 3xTF32 on
// the tensor cores (three products at 495 TFLOP/s) the conditional is
// 0.056 ms, the rest 0.017 ms on the CUDA cores and the bytes 0.018 ms,
// so the tensor cores set the floor.  The design: the conditional runs
// on the tensor cores as 3xTF32 (tc_conditional.cuh: wgmma at the rank
// tiers 8-32, mma.sync where the split factor does not fit), for tiles
// of 128 rows per warpgroup, into an fk tile in shared memory; the CDF,
// bracket and readout stay one thread per row (row_common.cuh) and read
// that tile.  Blocks are persistent (B split and staged once per block)
// with up to three warpgroups each, so that one warpgroup's CDF runs on
// the CUDA cores while another's products run on the tensor cores.
// The prefix update reads the two core slices C[i0], C[i0+1] (2 r^2
// values a row) instead of the TPU's w @ C over all n nodes.  Gathered
// per row from L2 inside the first pass it cost more than the rest of
// the kernel, because the split factor leaves too little L1 to hold C.
// So it runs as a second pass over the block's rows once the products
// are done: C is staged into the shared memory the factor held, at an
// odd node stride (tc_dim.cuh, slice_stride), and each row re-forms its
// bracket and cell weight from its out9 (bit for bit) and reads its two
// slices from shared memory.  cdf_bracket_factor
// (factor_step.cu) runs the first pass's stages, so its out9 equals
// this kernel's bit for bit.  The kernel body is tc_dim.cuh's, which
// odim_step.cu shares.  This source holds the instances of mode 'irt';
// dim_step_rt.cu and dim_step_rt_t64.cu those of mode 'rt' (dim_step.cuh:
// the kernel and its launch).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz: subnormal density ratios must survive to the f64 log).

#include "dim_step.cuh"

extern "C" {

// Mode 'irt' (rt == 0; dim_step_rt.cu takes rt == 1): the operands of
// dim_step_launch_mode.
int dim_step_launch(const void* phi, const void* qp, const void* um,
                    const void* bmat, const void* cmat, const void* h,
                    const void* xg, void* phin, void* out9, int m, int n,
                    int r, int rt, int device, void* stream) {
  return dim_step_launch_mode<false, 8, ttirt::kMaxR>(
      phi, qp, um, bmat, cmat, h, xg, phin, out9, m, n, r, rt, device,
      stream);
}

}  // extern "C"
