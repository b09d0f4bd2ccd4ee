// dim_step's instance of mode 'rt' at the rank tier 64, for Hopper
// (sm_90a): the kernel of dim_step.cu, built apart from dim_step_rt.cu's
// tiers 8-32 so that the two parts of the mode, the longest build of the
// port in one source (this instance the longest of them), compile in
// parallel.
// Replaces tt_irt_tpu/ops/pallas_dim.py::dim_step in mode 'rt'; what
// bounds it and its design are dim_step.cu's.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz: subnormal density ratios must survive to the f64 log).

#include "dim_step.cuh"

extern "C" {

// Mode 'rt' (rt == 1) at 32 < r <= 64: the operands of
// dim_step_launch_mode.
int dim_step_rt_t64_launch(const void* phi, const void* qp, const void* um,
                           const void* bmat, const void* cmat,
                           const void* h, const void* xg, void* phin,
                           void* out9, int m, int n, int r, int rt,
                           int device, void* stream) {
  return dim_step_launch_mode<true, 64, ttirt::kMaxR>(
      phi, qp, um, bmat, cmat, h, xg, phin, out9, m, n, r, rt, device,
      stream);
}

}  // extern "C"
