// The wide tier of dim_step and odim_step (the factor family's 'hi'
// kernels past n or r of 64 or their shared memory), for Hopper
// (sm_90a): the instances of factor_wide.cuh's dim_wide_kernel, and the
// tier's rule, caps, shared memory, scratch and split, which
// factor_wide_cond.cu's two kernels share.  Replaces, at those shapes,
// tt_irt_tpu/ops/pallas_dim.py::dim_step and pallas_odim.py::odim_step;
// the design is documented in factor_wide.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz: subnormal density ratios must survive to the f64 log).

#include "factor_wide.cuh"

extern "C" {

// The tier's caps, and whether a shape within them goes to this tier (1)
// or to the narrow one (0).
int factor_wide_max_n() { return kWideMaxN; }
int factor_wide_max_r() { return kWideMaxR; }
int factor_wide_tier(int n, int r) { return factor_wide(n, r) ? 1 : 0; }
// Shared memory a launch at (n, r) within the caps asks for, in bytes.
long long factor_wide_smem_bytes(int n, int r) {
  return static_cast<long long>(wide_smem_bytes(n, r));
}
// The f32 scratch a launch at (n, r) within the caps needs, in floats:
// the factor split into hi and lo, unit by unit.
long long factor_wide_scratch_floats(int n, int r) {
  return split_floats(n, r);
}

// The split alone (the first of a launch's two kernels), for timing:
// bmat (r, n*r) -> scratch (factor_wide_scratch_floats(n, r) floats).
int factor_wide_split_launch(const void* bmat, void* scratch, int n, int r,
                             int device, void* stream) {
  (void)device;
  if (!in_wide_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(split_launch(
      static_cast<const float*>(bmat), static_cast<float*>(scratch), n, r, r,
      static_cast<long long>(n) * r, static_cast<cudaStream_t>(stream)));
}

// Each launch (and factor_wide_cond.cu's two) takes the operands of its
// narrow tier's entry point (dim_step.cu, odim_step.cu, factor_step.cu,
// factor_conditional.cu),
// device pointers to contiguous f32 arrays (i0: int32) on device
// `device`, which must be the current device, and last `scratch`, device
// memory of factor_wide_scratch_floats(n, r) floats that the launch
// overwrites; it runs two kernels (the split, then the tier's kernel),
// returns the first failing launch's cudaError_t (0 on success) and is
// asynchronous on `stream`.  odim_step's takes `cell` (2m words) where its
// narrow tier takes psin: the stage writes each row's i0 (int32) and la
// there, and leaves the split of Q in `scratch` for the readout that the
// caller launches next on the same stream (cell_readout.cu's
// cell_readout_launch on psi, cell, cell + m and the scratch).
int dim_step_wide_launch(const void* phi, const void* qp, const void* um,
                         const void* bmat, const void* cmat, const void* h,
                         const void* xg, void* phin, void* out9, int m, int n,
                         int r, int rt, int device, void* stream,
                         void* scratch) {
  return dim_like_launch<CoreUpdate>(phi, qp, um, bmat, cmat, h, xg, phin,
                                     out9, m, n, r, rt, device, stream,
                                     scratch);
}

int odim_step_wide_launch(const void* psi, const void* qp, const void* um,
                          const void* qmat, const void* h, const void* xg,
                          void* cell, void* out9, int m, int n, int r, int rt,
                          int device, void* stream, void* scratch) {
  return dim_like_launch<CellWeights>(psi, qp, um, qmat, qmat, h, xg, cell,
                                      out9, m, n, r, rt, device, stream,
                                      scratch);
}

}  // extern "C"
