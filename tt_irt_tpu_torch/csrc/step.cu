// The two contractions of one Gram-form inverse-Rosenblatt dimension
// ('f32'/'mixed' precision), for Hopper (sm_90a).
//
// gram_conditional replaces
// tt_irt_tpu/ops/pallas_step.py::gram_conditional (_gram_kernel):
//   fk[m, x] = sum_ij phi[m, i] P[i*r + j, x] phi[m, j]
// condition_update replaces
// tt_irt_tpu/ops/pallas_step.py::condition_update (_update_kernel):
//   phi'[m] = phi[m] (la[m] C[i0[m]] + lb[m] C[i0[m]+1]) / max|.|
// with the floor 1e-30 on the divisor.  The CDF build and inversion
// between the two stays in PyTorch (samplers/irt_scan.py::_cdf_invert),
// as it stays in XLA between the two TPU kernels.
//
// What bounds them: the conditional, FP32 arithmetic on the CUDA cores:
// n*r*r FMAs per row (6.1k at n=17, r=19) against 4 (r + n) bytes of row
// traffic.  The update, its bytes: 5 r^2 + 2r operations per row against
// 4 (2r + 3) bytes, which at r=19 take longer at the card's memory rate
// than the arithmetic at its FP32 peak; its design goal is therefore to
// touch phi, phi' and the three scalars once and keep the 2 r^2 core
// values in cache.  The TPU kernels build the outer product, the one-hot
// weights and the batched matvec out of matmuls against 0/1 structure
// matrices because Mosaic cannot reshape or gather; here they are index
// arithmetic and two row reads.
//
// gram_conditional: one thread per row.  P is staged once per resident
// (persistent) block in shared memory, regrouped by node and zero-padded
// to the rank tier, ps[(x*r + i)*RMAX + j] = P[i*r + j, x], and read as
// float4 broadcasts; phi sits in registers for the inner product over j
// and in a shared column per thread for the outer factor phi_i, whose
// index runs over the true rank.  fk[x] = sum_i phi_i (sum_j P phi_j)
// holds for a general P (no symmetry is assumed).
// condition_update: one thread per row, the two core slices read from
// global memory (2 r^2 values, cache-resident), the shared device
// function of dim_step.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz).

#include "row_common.cuh"

namespace {

using namespace ttirt;

template <int RMAX>
__global__ void __launch_bounds__(kThreads)
gram_conditional_kernel(const float* __restrict__ phi,
                        const float* __restrict__ pmat,
                        float* __restrict__ fk, int m, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  float* ps = smem;                        // (n*r, RMAX)
  float* phis = smem + n * r * RMAX;       // (r, kThreads)
  const int tid = threadIdx.x;

  stage_gram<RMAX>(ps, pmat, n, r);
  zero_gram_pad<RMAX>(ps, n, r);
  __syncthreads();

  const int ntiles = (m + kThreads - 1) / kThreads;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row = tile * kThreads + tid;
    if (row >= m) continue;

    float p[RMAX];
#pragma unroll
    for (int i = 0; i < RMAX; ++i)
      p[i] = (i < r) ? phi[static_cast<size_t>(row) * r + i] : 0.0f;
    // this thread's own column: no other thread reads it
#pragma unroll
    for (int i = 0; i < RMAX; ++i)
      if (i < r) phis[i * kThreads + tid] = p[i];

    for (int x = 0; x < n; ++x)
      fk[static_cast<size_t>(row) * n + x] =
          gram_node<RMAX>(ps + x * r * RMAX, phis + tid, p, r);
  }
}

template <int RMAX>
__global__ void __launch_bounds__(kThreads)
condition_update_kernel(const float* __restrict__ phi,
                        const int* __restrict__ i0v,
                        const float* __restrict__ la,
                        const float* __restrict__ lb,
                        const float* __restrict__ cmat,
                        float* __restrict__ phin, int m, int n, int r) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= m) return;
  float p[RMAX];
#pragma unroll
  for (int i = 0; i < RMAX; ++i)
    p[i] = (i < r) ? phi[static_cast<size_t>(row) * r + i] : 0.0f;
  const int i0 = min(max(i0v[row], 0), n - 2);
  const float* ca = cmat + static_cast<size_t>(i0) * r * r;
  float acc[RMAX];
  prefix_update<RMAX>(p, la[row], lb[row], ca, ca + r * r, r, acc);
#pragma unroll
  for (int j = 0; j < RMAX; ++j)
    if (j < r) phin[static_cast<size_t>(row) * r + j] = acc[j];
}

// Dynamic shared memory of one gram_conditional block: P padded to the
// rank tier, plus one phi column per thread.
size_t gram_smem_bytes(int n, int r) {
  return (static_cast<size_t>(n) * r * rank_tier(r)
          + static_cast<size_t>(r) * kThreads) * sizeof(float);
}

template <int RMAX>
cudaError_t launch_gram(const float* phi, const float* pmat, float* fk, int m,
                        int n, int r, int device, cudaStream_t stream) {
  const size_t smem = gram_smem_bytes(n, r);
  int cap = 0;
  cudaError_t e = grid_cap(
      reinterpret_cast<const void*>(&gram_conditional_kernel<RMAX>), device,
      smem, &cap);
  if (e != cudaSuccess) return e;
  const int tiles = (m + kThreads - 1) / kThreads;
  const int grid = tiles < cap ? tiles : cap;
  gram_conditional_kernel<RMAX><<<grid, kThreads, smem, stream>>>(
      phi, pmat, fk, m, n, r);
  return cudaGetLastError();
}

template <int RMAX>
cudaError_t launch_update(const float* phi, const int* i0, const float* la,
                          const float* lb, const float* cmat, float* phin,
                          int m, int n, int r, cudaStream_t stream) {
  const int grid = (m + kThreads - 1) / kThreads;
  condition_update_kernel<RMAX><<<grid, kThreads, 0, stream>>>(
      phi, i0, la, lb, cmat, phin, m, n, r);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Caps the wrappers check before launching.
int step_max_n() { return kMaxN; }
int step_max_r() { return kMaxR; }
// Shared memory a gram_conditional launch at (n, r <= kMaxR) asks for.
long long gram_conditional_smem_bytes(int n, int r) {
  return static_cast<long long>(gram_smem_bytes(n, r));
}

// Device pointers to contiguous f32 arrays phi (m, r), pmat (r*r, n)
// -> fk (m, n), all on device `device`, which must be the current
// device.  Returns the launch's cudaError_t (0 on success); the launch
// is asynchronous on `stream`.
int gram_conditional_launch(const void* phi, const void* pmat, void* fk, int m,
                            int n, int r, int device, void* stream) {
  if (m == 0) return 0;
  if (!in_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(phi);
  const float* b = static_cast<const float*>(pmat);
  float* o = static_cast<float*>(fk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (rank_tier(r)) {
    case 8: e = launch_gram<8>(a, b, o, m, n, r, device, s); break;
    case 16: e = launch_gram<16>(a, b, o, m, n, r, device, s); break;
    case 24: e = launch_gram<24>(a, b, o, m, n, r, device, s); break;
    case 32: e = launch_gram<32>(a, b, o, m, n, r, device, s); break;
    default: e = launch_gram<kMaxR>(a, b, o, m, n, r, device, s); break;
  }
  return static_cast<int>(e);
}

// Device pointers to contiguous arrays phi (m, r) f32, i0 (m,) int32,
// la, lb (m,) f32, cmat (n, r*r) f32 -> phin (m, r) f32 on the current
// device.  Returns the launch's cudaError_t; asynchronous on `stream`.
int condition_update_launch(const void* phi, const void* i0, const void* la,
                            const void* lb, const void* cmat, void* phin,
                            int m, int n, int r, void* stream) {
  if (m == 0) return 0;
  if (!in_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(phi);
  const int* ix = static_cast<const int*>(i0);
  const float* wa = static_cast<const float*>(la);
  const float* wb = static_cast<const float*>(lb);
  const float* c = static_cast<const float*>(cmat);
  float* o = static_cast<float*>(phin);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (rank_tier(r)) {
    case 8: e = launch_update<8>(a, ix, wa, wb, c, o, m, n, r, s); break;
    case 16: e = launch_update<16>(a, ix, wa, wb, c, o, m, n, r, s); break;
    case 24: e = launch_update<24>(a, ix, wa, wb, c, o, m, n, r, s); break;
    case 32: e = launch_update<32>(a, ix, wa, wb, c, o, m, n, r, s); break;
    default: e = launch_update<kMaxR>(a, ix, wa, wb, c, o, m, n, r, s); break;
  }
  return static_cast<int>(e);
}

}  // extern "C"
