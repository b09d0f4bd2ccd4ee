// The factor-form conditional alone, and the conditional with the
// two-sided CDF, bracket and readout, for Hopper (sm_90a): the first
// kernels of the two split 'hi' steps, each followed by
// condition_update (step.cu).
//
// factor_conditional replaces
// tt_irt_tpu/ops/pallas_step.py::factor_conditional (_factor_kernel):
//   fk[m, x] = sum_j (sum_i phi[m, i] B[i, x*r + j])^2
// cdf_bracket_factor replaces
// tt_irt_tpu/ops/pallas_step.py::cdf_bracket_factor
// (_cdf_bracket_kernel): the same conditional, then per row the f32
// trapezoid CDF from both sides, the count-based bracket i0 and
//   out9 = [c1, cr2, f1, f2, x1h, x1l, x2h, x2l, tot].
// As in the TPU kernel, it takes no f32(1 - seed) operand: the
// right-tail target is (1 - qp) * tot formed in f32, so a seed within
// 2^-25 of 1 gets the target 0 (dim_step and odim_step take um32 for
// that reason).  Wherever um32 == 1 - qp32 in f32, out9 and i0 equal
// dim_step's bit for bit: the stages are the same device functions of
// tc_conditional.cuh and row_common.cuh, in the same variant.
//
// What bounds them: the conditional, n*r*r multiply-adds a row (17.5k
// at n=33, r=23) against 4 (r + n) or 4 (r + 11) bytes of row traffic.
// factor_conditional keeps the one-thread-per-row design of the first
// port on the FP32 CUDA cores (0.14 ms bound at 2^18 rows): B staged
// once per persistent block, transposed and zero-padded to the rank
// tier, read as float4 broadcasts; fk in a shared column per thread.
// cdf_bracket_factor runs dim_step.cu's stages (tc_conditional.cuh):
// the conditional as 3xTF32 on the tensor cores for 128-row tiles per
// warpgroup (0.056 ms bound at 2^18 rows, three products at 495
// TFLOP/s), then the CDF one thread per row on the fk tile.  No (M, n*r)
// product, no 0/1 structure matrix and no trapezoid matrix (the TPU
// kernels' seg_sum, dmat and prefix_suffix operands) exists.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz).

#include "tc_conditional.cuh"

namespace {

using namespace ttirt;

template <int RMAX>
__global__ void __launch_bounds__(kThreads)
factor_conditional_kernel(const float* __restrict__ phi,
                          const float* __restrict__ bmat,
                          float* __restrict__ fk, int m, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                                  // (n*r, RMAX)
  float* fcol = smem + n * r * RMAX + threadIdx.x;   // (n, kThreads)

  stage_factor<RMAX>(bs, bmat, n, r);
  __syncthreads();

  const int ntiles = (m + kThreads - 1) / kThreads;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const size_t row = static_cast<size_t>(tile) * kThreads + threadIdx.x;
    if (row >= static_cast<size_t>(m)) continue;
    float p[RMAX];
    load_row<RMAX>(p, phi, row, r);
    factor_conditional_row<RMAX>(bs, p, fcol, n, r);
    for (int x = 0; x < n; ++x) fk[row * n + x] = fcol[x * kThreads];
  }
}

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

template <int RMAX>
cudaError_t launch_conditional(const float* phi, const float* bmat, float* fk,
                               int m, int n, int r, int device,
                               cudaStream_t stream) {
  const size_t smem = factor_smem_bytes(n, r);
  int cap = 0;
  cudaError_t e = grid_cap(
      reinterpret_cast<const void*>(&factor_conditional_kernel<RMAX>), device,
      smem, &cap);
  if (e != cudaSuccess) return e;
  factor_conditional_kernel<RMAX>
      <<<persistent_grid(m, cap), kThreads, smem, stream>>>(phi, bmat, fk, m,
                                                            n, r);
  return cudaGetLastError();
}

template <int T, bool RT, Tc V>
cudaError_t launch_bracket_variant(const float* phi, const float* qp,
                                   const float* bmat, const float* h,
                                   const float* xg, float* out9, int* i0,
                                   int m, int n, int r, int device,
                                   cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(n, r);
  const int threads = tc_threads(n, r);
  int cap = 0;
  cudaError_t e = grid_cap(
      reinterpret_cast<const void*>(&cdf_bracket_factor_kernel<T, RT, V>),
      device, smem, &cap, threads);
  if (e != cudaSuccess) return e;
  cdf_bracket_factor_kernel<T, RT, V>
      <<<tc_grid(m, threads, cap), threads, smem, stream>>>(
          phi, qp, bmat, h, xg, out9, i0, m, n, r);
  return cudaGetLastError();
}

// The variant dim_step.cu's launch picks at the same (n, r), so that
// the two kernels' out9 agree bit for bit.
template <int T, bool RT>
cudaError_t launch_bracket(const float* phi, const float* qp,
                           const float* bmat, const float* h, const float* xg,
                           float* out9, int* i0, int m, int n, int r,
                           int device, cudaStream_t stream) {
  if constexpr (T <= 32) {
    if (use_wgmma(n, r))
      return launch_bracket_variant<T, RT, Tc::kWgmma>(
          phi, qp, bmat, h, xg, out9, i0, m, n, r, device, stream);
  }
  if constexpr (T >= 24) {
    return launch_bracket_variant<T, RT, Tc::kMma>(
        phi, qp, bmat, h, xg, out9, i0, m, n, r, device, stream);
  } else {
    return cudaErrorInvalidValue;   // tiers 8 and 16 always fit wgmma
  }
}

}  // namespace

extern "C" {

// Caps the wrappers check before launching.
int factor_step_max_n() { return kMaxN; }
int factor_step_max_r() { return kMaxR; }
// Shared memory a launch of factor_conditional at (n, r <= kMaxR)
// asks for, and of cdf_bracket_factor.
long long factor_step_smem_bytes(int n, int r) {
  return static_cast<long long>(factor_smem_bytes(n, r));
}
long long cdf_bracket_factor_smem_bytes(int n, int r) {
  return static_cast<long long>(tc_smem_bytes(n, r));
}

// Device pointers to contiguous f32 arrays phi (m, r), bmat (r, n*r)
// -> fk (m, n), all on device `device`, which must be the current
// device.  Returns the launch's cudaError_t (0 on success); the launch
// is asynchronous on `stream`.
int factor_conditional_launch(const void* phi, const void* bmat, void* fk,
                              int m, int n, int r, int device, void* stream) {
  if (m == 0) return 0;
  if (!in_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaErrorInvalidValue;
  TTIRT_FOR_TIER(r, e = launch_conditional<TIER>(
      static_cast<const float*>(phi), static_cast<const float*>(bmat),
      static_cast<float*>(fk), m, n, r, device,
      static_cast<cudaStream_t>(stream)));
  return static_cast<int>(e);
}

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
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out9);
  int* ix = static_cast<int*>(i0);
  cudaError_t e = cudaErrorInvalidValue;
  if (rt) {
    TTIRT_FOR_TIER(r, (e = launch_bracket<TIER, true>(
        f(phi), f(qp), f(bmat), f(h), f(xg), o, ix, m, n, r, device, s)));
  } else {
    TTIRT_FOR_TIER(r, (e = launch_bracket<TIER, false>(
        f(phi), f(qp), f(bmat), f(h), f(xg), o, ix, m, n, r, device, s)));
  }
  return static_cast<int>(e);
}

}  // extern "C"
