// dim_step's kernel instances and the launch of one mode ('irt' or
// 'rt') at a range of rank tiers, shared by its three sources:
// dim_step.cu (mode 'irt', every tier), dim_step_rt.cu (mode 'rt', tiers
// 8-32) and dim_step_rt_t64.cu (mode 'rt', tier 64), one nvcc
// each, built in parallel (14 instances in one source made it the
// longest build of the port, and the 7 of mode 'rt' in one source after
// it).  The kernel is documented in dim_step.cu.

#pragma once

#include "tc_dim.cuh"

namespace {

using namespace ttirt;

template <int T, bool RT, Tc V>
__global__ void __launch_bounds__(tc_kernel_threads<T, V>())
dim_step_kernel(const float* __restrict__ phi, const float* __restrict__ qp,
                const float* __restrict__ um, const float* __restrict__ bmat,
                const float* __restrict__ cmat, const float* __restrict__ h,
                const float* __restrict__ xg, float* __restrict__ phin,
                float* __restrict__ out9, int m, int n, int r) {
  tc_dim_step<T, RT, V, CoreSlices>(phi, qp, um, bmat, cmat, h, xg, phin,
                                    out9, m, n, r);
}

template <bool RT>
struct DimStepKernel {
  template <int T, Tc V>
  struct At {
    static const void* fn() {
      return reinterpret_cast<const void*>(&dim_step_kernel<T, RT, V>);
    }
  };
};

// The launch of mode RT at the rank tiers LO to HI; `rt` must name the
// mode and r's tier lie in the range (the other sources take the rest).  All pointers are device pointers to contiguous f32 arrays:
// phi (m, r), qp/um (m,), bmat (r, n*r), cmat (n, r*r), h (n-1,),
// xg (2, n) -> phin (m, r), out9 (m, 9), all on device `device`, which
// must be the current device.  Returns the launch's cudaError_t (0 on
// success); the launch is asynchronous on `stream`.
template <bool RT, int LO, int HI>
int dim_step_launch_mode(const void* phi, const void* qp, const void* um,
                         const void* bmat, const void* cmat, const void* h,
                         const void* xg, void* phin, void* out9, int m, int n,
                         int r, int rt, int device, void* stream) {
  if ((rt != 0) != RT) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  if (!in_caps(n, r) || slices_bytes(n, r) > tc_smem_bytes(n, r))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* p[7];
  const void* in[7] = {phi, qp, um, bmat, cmat, h, xg};
  for (int k = 0; k < 7; ++k) p[k] = static_cast<const float*>(in[k]);
  float* pn = static_cast<float*>(phin);
  float* o = static_cast<float*>(out9);
  void* args[] = {&p[0], &p[1], &p[2], &p[3], &p[4], &p[5], &p[6], &pn, &o,
                  &m, &n, &r};
  const void* kern = nullptr;
  TTIRT_FOR_TIER(r, if constexpr (TIER >= LO && TIER <= HI)
                        (kern = tc_instance<DimStepKernel<RT>::template At,
                                            TIER>(n, r)));
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tc_launch(kern, args, m, n, r, device,
                                    static_cast<cudaStream_t>(stream)));
}

}  // namespace
