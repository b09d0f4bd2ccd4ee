// The wide tier of cdf_bracket_factor and factor_conditional, for
// Hopper (sm_90a): the instances of factor_wide.cuh's bracket_wide_kernel
// and conditional_wide_kernel, built apart from factor_wide.cu's so that
// the two compile in parallel (factor_wide.cu holds the tier's rule,
// caps, shared memory and scratch size, which these launches share).
// Replaces, at the shapes of factor_wide_tier,
// tt_irt_tpu/ops/pallas_step.py::cdf_bracket_factor and
// factor_conditional; the design is documented in factor_wide.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz: subnormal density ratios must survive to the f64 log).

#include "factor_wide.cuh"

extern "C" {

// The operands of the narrow tiers' entry points (factor_step.cu,
// factor_conditional.cu) as factor_wide.cu's launches take theirs: last
// `scratch`, device memory of factor_wide_scratch_floats(n, r) floats;
// two kernels (the split, then the tier's kernel), asynchronous on
// `stream`; the first failing launch's cudaError_t (0 on success).
int cdf_bracket_factor_wide_launch(const void* phi, const void* qp,
                                   const void* bmat, const void* h,
                                   const void* xg, void* out9, void* i0,
                                   int m, int n, int r, int rt, int device,
                                   void* stream, void* scratch) {
  if (m == 0) return 0;
  if (!in_wide_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  const float* p[5];
  const void* in[5] = {phi, qp, bmat, h, xg};
  for (int k = 0; k < 5; ++k) p[k] = static_cast<const float*>(in[k]);
  const float* sp = static_cast<const float*>(scratch);
  float* o = static_cast<float*>(out9);
  int* ix = static_cast<int*>(i0);
  void* args[] = {&p[0], &p[1], &p[2], &p[3], &p[4], &sp, &o, &ix, &m, &n,
                  &r};
  const void* kern = nullptr;
  TTIRT_FOR_KSTEPS(r, kern = rt ? reinterpret_cast<const void*>(
                                      &bracket_wide_kernel<true, KS>)
                                : reinterpret_cast<const void*>(
                                      &bracket_wide_kernel<false, KS>));
  return static_cast<int>(wide_launch(kern, args, p[2],
                                      static_cast<float*>(scratch), m, n, r,
                                      device, stream));
}

int factor_conditional_wide_launch(const void* phi, const void* bmat,
                                   void* fk, int m, int n, int r, int device,
                                   void* stream, void* scratch) {
  if (m == 0) return 0;
  if (!in_wide_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(phi);
  const float* b = static_cast<const float*>(bmat);
  const float* sp = static_cast<const float*>(scratch);
  float* f = static_cast<float*>(fk);
  void* args[] = {&p, &b, &sp, &f, &m, &n, &r};
  const void* kern = nullptr;
  TTIRT_FOR_KSTEPS(r, kern = reinterpret_cast<const void*>(
                          &conditional_wide_kernel<KS>));
  return static_cast<int>(wide_launch(kern, args, b,
                                      static_cast<float*>(scratch), m, n, r,
                                      device, stream));
}

}  // extern "C"
