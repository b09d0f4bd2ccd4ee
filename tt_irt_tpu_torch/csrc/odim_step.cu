// One whole 'hi' inverse-Rosenblatt dimension on weighted-orthonormal
// cores for a tile of rows, for Hopper (sm_90a).
//
// Replaces tt_irt_tpu/ops/pallas_odim.py::odim_step (_odim_kernel), whose
// XLA twin is tt_irt_tpu/samplers/irt_scan.py::_step_factor_ob +
// _cdf_rows32.  The prepared cores are Q_k = L_k^{-1} C_k L_{k+1} with
// sum_x w2[x] Q_k(x) Q_k(x)^T = I, and the carried interface is
// psi_k = phi_k L_k.  Per row m (all f32):
//   v[x, j] = sum_i psi[m, i] Q[i, x*r + j]           (conditional)
//   fk[x]   = sum_j v[x, j]^2
//   two-sided trapezoid CDF, count-based bracket i0, out9 (as dim_step)
//   la      = f32 citardauq weight of the sample inside its cell
//   psi'    = (la v[i0] + (1-la) v[i0+1]) / max|.|     (floor 1e-30)
// No core operand: the prefix update is a 2-point readout of v.  The
// batched f64 epilogue (samplers/irt_scan.py::_serve_solve) turns out9
// into samples and log-densities after all dimensions.
//
// What bounds it: the conditional, n*r*r multiply-adds a row (17.5k at
// n=33, r=23) against ~230 bytes of row traffic: 0.15 ms at 2^18 rows
// on the FP32 CUDA cores, 0.056 ms as 3xTF32 on the tensor cores.  The
// design is dim_step.cu's, through the same body (tc_dim.cuh): the
// conditional on the tensor cores for 128-row tiles per warpgroup
// (tc_conditional.cuh, Q as the B operand, staged and split exactly as
// B), the CDF, bracket and out9 one thread per row, so that out9 equals
// cdf_bracket_factor's on (psi, Q) bit for bit wherever um32 == 1 - qp32;
// then a second pass with Q's node blocks staged where the split factor
// was (where dim_step stages its core), from which each row forms
// v[i0] = psi Q_i0 and v[i0+1] by one f32 FMA chain each and reads out
// la v[i0] + (1-la) v[i0+1] (tc_dim.cuh, FactorSlices).  The readout is
// thus not the v whose squares made fk (which the tensor cores formed
// in 3xTF32 and which no longer exists when the bracket is known): the
// first port's kernel recomputed v[i0], v[i0+1] with fk's own FMA order
// and read them out bit for bit, a tie this design gives up.  Its error
// is that of the plain version's f32 readout.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz: subnormal density ratios must survive to the f64 log).

#include "tc_dim.cuh"

namespace {

using namespace ttirt;

template <int T, bool RT, Tc V>
__global__ void __launch_bounds__(tc_kernel_threads<T, V>())
odim_step_kernel(const float* __restrict__ psi, const float* __restrict__ qp,
                 const float* __restrict__ um, const float* __restrict__ qmat,
                 const float* __restrict__ h, const float* __restrict__ xg,
                 float* __restrict__ psin, float* __restrict__ out9, int m,
                 int n, int r) {
  tc_dim_step<T, RT, V, FactorSlices>(psi, qp, um, qmat, qmat, h, xg, psin,
                                      out9, m, n, r);
}

template <bool RT>
struct Kernel {
  template <int T, Tc V>
  struct At {
    static const void* fn() {
      return reinterpret_cast<const void*>(&odim_step_kernel<T, RT, V>);
    }
  };
};

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous f32 arrays:
// psi (m, r), qp/um (m,), qmat (r, n*r), h (n-1,), xg (2, n)
// -> psin (m, r), out9 (m, 9), all on device `device`, which must be the
// current device.  Returns the launch's cudaError_t (0 on success); the
// launch is asynchronous on `stream`.
int odim_step_launch(const void* psi, const void* qp, const void* um,
                     const void* qmat, const void* h, const void* xg,
                     void* psin, void* out9, int m, int n, int r, int rt,
                     int device, void* stream) {
  if (m == 0) return 0;
  if (!in_caps(n, r) || slices_bytes(n, r) > tc_smem_bytes(n, r))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* p[6];
  const void* in[6] = {psi, qp, um, qmat, h, xg};
  for (int k = 0; k < 6; ++k) p[k] = static_cast<const float*>(in[k]);
  float* pn = static_cast<float*>(psin);
  float* o = static_cast<float*>(out9);
  void* args[] = {&p[0], &p[1], &p[2], &p[3], &p[4], &p[5], &pn, &o,
                  &m, &n, &r};
  const void* kern = nullptr;
  if (rt) {
    TTIRT_FOR_TIER(r, (kern = tc_instance<Kernel<true>::At, TIER>(n, r)));
  } else {
    TTIRT_FOR_TIER(r, (kern = tc_instance<Kernel<false>::At, TIER>(n, r)));
  }
  return static_cast<int>(tc_launch(kern, args, m, n, r, device,
                                    static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
