// The factor-form conditional with the two-sided CDF, bracket and
// readout, for Hopper (sm_90a): the first kernel of the split 'hi' step
// hi_step="bracket", followed by condition_update (step.cu).
//
// cdf_bracket_factor replaces
// tt_irt_tpu/ops/pallas_step.py::cdf_bracket_factor
// (_cdf_bracket_kernel): per row the conditional
//   fk[m, x] = sum_j (sum_i phi[m, i] B[i, x*r + j])^2,
// then the f32 trapezoid CDF from both sides, the count-based bracket i0
// and
//   out9 = [c1, cr2, f1, f2, x1h, x1l, x2h, x2l, tot].
// As in the TPU kernel, it takes no f32(1 - seed) operand: the
// right-tail target is (1 - qp) * tot formed in f32, so a seed within
// 2^-25 of 1 gets the target 0 (dim_step and odim_step take um32 for
// that reason).  Wherever um32 == 1 - qp32 in f32, out9 and i0 equal
// dim_step's bit for bit: the stages are the same device functions of
// tc_conditional.cuh and row_common.cuh, in the same variant.
//
// What bounds it: the conditional, n*r*r multiply-adds a row (17.5k at
// n=33, r=23) against 4 (r + 11) bytes of row traffic.  It runs
// dim_step's first pass (tc_dim.cuh, tc_conditional.cuh): the
// conditional as 3xTF32 on the tensor cores for 128-row tiles per
// warpgroup (0.056 ms bound at 2^18 rows, three products at 495
// TFLOP/s), then the CDF one thread per row on the fk tile.  No (M, n*r)
// product, no 0/1 structure matrix and no trapezoid matrix (the TPU
// kernels' seg_sum, dmat and prefix_suffix operands) exists.  The
// conditional alone, factor_conditional, is factor_conditional.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz).

#include "tc_conditional.cuh"

namespace {

using namespace ttirt;

template <int T, bool RT, Tc V>
__global__ void __launch_bounds__(tc_kernel_threads<T, V>())
cdf_bracket_factor_kernel(const float* __restrict__ phi,
                          const float* __restrict__ qp,
                          const float* __restrict__ bmat,
                          const float* __restrict__ h,
                          const float* __restrict__ xg,
                          float* __restrict__ out9, int* __restrict__ i0,
                          int m, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  using Stage = TcStage<T, V>;
  const int wgs = blockDim.x / kTcRows;
  const int wg = threadIdx.x / kTcRows;
  const int tid = threadIdx.x - wg * kTcRows;
  float* fk = Stage::fk_tile(smem, n, r, wg);

  Stage::stage(smem, bmat, n, r);
  __syncthreads();

  const int ntiles = (m + kTcRows - 1) / kTcRows;
  for (int tile = blockIdx.x * wgs + wg; tile < ntiles;
       tile += gridDim.x * wgs) {
    const long long row0 = static_cast<long long>(tile) * kTcRows;
    Stage::conditional(smem, fk, phi, row0, m, n, r, wg);
    const long long row = row0 + tid;
    const bool live = row < m;
    const float q = live ? qp[row] : 0.0f;
    const Bracket b = Stage::template bracket<RT>(
        smem, fk + tid, phi, row, live, h, xg, n, r, q, __fsub_rn(1.0f, q));
    if (live) {
      write_out9(out9 + row * 9, b, xg + n);
      i0[row] = b.i0;
    }
    wg_barrier(wg);      // the fk tile is free for the next tile
  }
}

template <bool RT>
struct Kernel {
  template <int T, Tc V>
  struct At {
    static const void* fn() {
      return reinterpret_cast<const void*>(
          &cdf_bracket_factor_kernel<T, RT, V>);
    }
  };
};

}  // namespace

extern "C" {

// Device pointers to contiguous f32 arrays phi (m, r), qp (m,),
// bmat (r, n*r), h (n-1,), xg (2, n) -> out9 (m, 9) f32 and i0 (m,)
// int32, all on device `device`, which must be the current device.
// Returns the launch's cudaError_t; asynchronous on `stream`.
int cdf_bracket_factor_launch(const void* phi, const void* qp,
                              const void* bmat, const void* h, const void* xg,
                              void* out9, void* i0, int m, int n, int r,
                              int rt, int device, void* stream) {
  if (m == 0) return 0;
  if (!in_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  const float* p[5];
  const void* in[5] = {phi, qp, bmat, h, xg};
  for (int k = 0; k < 5; ++k) p[k] = static_cast<const float*>(in[k]);
  float* o = static_cast<float*>(out9);
  int* ix = static_cast<int*>(i0);
  void* args[] = {&p[0], &p[1], &p[2], &p[3], &p[4], &o, &ix, &m, &n, &r};
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
