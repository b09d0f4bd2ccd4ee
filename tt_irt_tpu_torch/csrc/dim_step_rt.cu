// dim_step's instances of mode 'rt' (the sample given: phi' conditions
// on it, and out9 holds its cell) at the rank tiers 8 to 32, for Hopper
// (sm_90a): the kernel of dim_step.cu, built from its own source so that
// the modes compile in parallel (dim_step_rt_t64.cu: tier 64).
// Replaces tt_irt_tpu/ops/pallas_dim.py::dim_step in mode 'rt'; what
// bounds it and its design are dim_step.cu's.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz: subnormal density ratios must survive to the f64 log).

#include "dim_step.cuh"

extern "C" {

// Mode 'rt' (rt == 1; dim_step.cu takes rt == 0) at r <= 32: the
// operands of dim_step_launch_mode.
int dim_step_rt_launch(const void* phi, const void* qp, const void* um,
                       const void* bmat, const void* cmat, const void* h,
                       const void* xg, void* phin, void* out9, int m, int n,
                       int r, int rt, int device, void* stream) {
  return dim_step_launch_mode<true, 8, 32>(phi, qp, um, bmat, cmat, h, xg,
                                           phin, out9, m, n, r, rt, device,
                                           stream);
}

}  // extern "C"
