// v = phi B for tiles of 128 rows, through the tensor-core conditional's
// pieces (tt_irt_tpu_torch/csrc/tc_conditional.cuh), in two accumulation
// schemes, written out raw for tools/tc_variants.py:
//   scheme 0: every product into one accumulator (lo.hi and hi.lo over
//             the k-steps, then hi.hi);
//   scheme 1: the shipped one (wgmma_unit: small products in one
//             accumulator, hi.hi of each k-step in its own, summed in f32
//             on the CUDA cores).
// And gram_tc, design (a) of gram_conditional (step.cu ships design (b),
// register-blocked rows on the FP32 cores; tools/tc_variants.py times
// both): fk[m, x] = sum_ij phi[m, i] P[i*r + j, x] phi[m, j] as
// v = phi P~ on the tensor cores, P~[i, x*r + j] = P[i*r + j, x] (the
// shape (r, n*r) of the factor B), through the shipped stage's pieces
// (3xTF32 wgmma_unit, split accumulators summed in f32), and a Gram
// epilogue fk[x] = sum_j v[x, j] phi_j in place of the squares of
// reduce_half: each thread multiplies its accumulator columns 8c + 2t,
// +1 of rows g and g + 8 by phi at those rows and columns (loaded once
// per tile), then the quad sums by two lane shuffles.  One warpgroup a
// block, persistent over 128-row tiles, P~'s hi and lo staged once a
// block (rank tiers 8-32, where they fit).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libtc_probe.so tools/tc_probe.cu

#include "../tt_irt_tpu_torch/csrc/tc_conditional.cuh"

namespace {

using namespace ttirt;

template <int T, int SCHEME>
__global__ void __launch_bounds__(128)
probe_v(const float* phi, const float* bmat, float* vout, int m, int n,
        int r) {
  extern __shared__ __align__(16) float smem[];
  stage_factor_wgmma<T>(smem, smem + n * T * T, bmat, n, r);
  __syncthreads();
  const long long row0 = static_cast<long long>(blockIdx.x) * kTcRows;
  uint32_t ahi[2][T / 8][4], alo[2][T / 8][4];
  load_a_split<T / 8>(ahi[0], alo[0], phi, row0, 0, m, r);
  load_a_split<T / 8>(ahi[1], alo[1], phi, row0, 1, m, r);
  const uint32_t bhi = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t blo = static_cast<uint32_t>(
      __cvta_generic_to_shared(smem + n * T * T));
  constexpr uint32_t kLbo = (T / 8) * 128, kSbo = 128;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int x = 0; x < n; ++x) {
    for (int h = 0; h < 2; ++h) {
      float v[T / 2];
      Unit<T> u = {};
      if (SCHEME == 0) {
        const uint32_t node =
            static_cast<uint32_t>(x) * T * T * 4;
        fence_regs(u.small);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < T / 8; ++s)
          Wgmma<T>::mma(u.small, alo[h][s],
                        smem_desc(bhi + node + 2 * s * kLbo, kLbo, kSbo),
                        s > 0);
#pragma unroll
        for (int s = 0; s < T / 8; ++s)
          Wgmma<T>::mma(u.small, ahi[h][s],
                        smem_desc(blo + node + 2 * s * kLbo, kLbo, kSbo), 1);
#pragma unroll
        for (int s = 0; s < T / 8; ++s)
          Wgmma<T>::mma(u.small, ahi[h][s],
                        smem_desc(bhi + node + 2 * s * kLbo, kLbo, kSbo), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(u.small);
#pragma unroll
        for (int e = 0; e < T / 2; ++e) v[e] = u.small[e];
      } else {
        wgmma_unit<T>(u, ahi[h], alo[h], bhi, blo, x);
        wgmma_wait<0>();
        fence_unit(u);
#pragma unroll
        for (int e = 0; e < T / 2; ++e) {
          v[e] = u.small[e];
#pragma unroll
          for (int s = 0; s < T / 8; ++s) v[e] = __fadd_rn(v[e], u.part[s][e]);
        }
      }
#pragma unroll
      for (int e = 0; e < T / 2; ++e) {
        const long long row =
            row0 + 64 * h + 16 * warp + (lane >> 2) + 8 * ((e & 2) >> 1);
        const int col = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        if (row < m) vout[(row * n + x) * T + col] = v[e];
      }
    }
  }
}

template <int T, int SCHEME>
int go(const float* phi, const float* b, float* out, int m, int n, int r,
       void* stream) {
  const size_t smem =
      2 * static_cast<size_t>(n) * T * T * sizeof(float);
  cudaError_t e =
      ensure_smem(reinterpret_cast<const void*>(&probe_v<T, SCHEME>), smem);
  if (e != cudaSuccess) return e;
  probe_v<T, SCHEME><<<(m + kTcRows - 1) / kTcRows, kTcRows, smem,
                       static_cast<cudaStream_t>(stream)>>>(phi, b, out, m,
                                                            n, r);
  return cudaGetLastError();
}

// ---- gram_tc: design (a) of gram_conditional ----

// P~'s hi and lo in the wgmma core-matrix layout of the factor:
// P~[i, x*r + j] = P[i*r + j, x], zero beyond the rank.
template <int T>
__device__ void stage_gram_wgmma(float* bhi, float* blo, const float* pmat,
                                 int n, int r) {
  for (int idx = threadIdx.x; idx < n * T * T; idx += blockDim.x) {
    const int x = idx / (T * T);
    const int rem = idx - x * T * T;
    const int i = rem / T;
    const int j = rem - i * T;
    const float v = (i < r && j < r) ? pmat[(i * r + j) * n + x] : 0.0f;
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    const int o = core_offset<T>(x, i, j);
    bhi[o] = __uint_as_float(hi);
    blo[o] = __uint_as_float(lo);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// phi at this thread's accumulator positions of half h: pe[4c + q] at
// row g + 8 (q >> 1), column 8c + 2t + (q & 1); 0 beyond m and r.
template <int T>
__device__ __forceinline__ void load_epilogue(float (&pe)[T / 2],
                                              const float* phi,
                                              long long row0, int h, int m,
                                              int r) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const long long base = row0 + 64 * h + 16 * warp + (lane >> 2);
#pragma unroll
  for (int e = 0; e < T / 2; ++e) {
    const long long row = base + 8 * (e >> 1 & 1);
    const int col = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
    pe[e] = (row < m && col < r) ? phi[row * r + col] : 0.0f;
  }
}

// The Gram epilogue of unit (x, h): v = ((small + part[0]) + ...) in f32
// as finish_unit, then sum_j v_j phi_j by the order of reduce_half.
template <int T>
__device__ __forceinline__ void gram_finish(Unit<T>& u,
                                            const float (&pe)[T / 2],
                                            float* fk, int x, int h) {
  fence_unit(u);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  float v[T / 2];
#pragma unroll
  for (int e = 0; e < T / 2; ++e) {
    v[e] = u.small[e];
#pragma unroll
    for (int s = 0; s < T / 8; ++s) v[e] = __fadd_rn(v[e], u.part[s][e]);
  }
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int c = 0; c < T / 8; ++c) {
    s0 = fmaf(v[4 * c], pe[4 * c], s0);
    s0 = fmaf(v[4 * c + 1], pe[4 * c + 1], s0);
    s1 = fmaf(v[4 * c + 2], pe[4 * c + 2], s1);
    s1 = fmaf(v[4 * c + 3], pe[4 * c + 3], s1);
  }
  s0 += __shfl_xor_sync(0xFFFFFFFFu, s0, 1);
  s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, 1);
  s0 += __shfl_xor_sync(0xFFFFFFFFu, s0, 2);
  s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, 2);
  if ((lane & 3) == 0) {
    const int i = 64 * h + 16 * warp + (lane >> 2);
    fk[fk_at<true>(x, i)] = s0;
    fk[fk_at<true>(x, i + 8)] = s1;
  }
}

template <int T>
__global__ void __launch_bounds__(kTcRows)
gram_tc(const float* __restrict__ phi, const float* __restrict__ pmat,
        float* __restrict__ out, int m, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  float* fk = smem + 2 * n * T * T;
  stage_gram_wgmma<T>(smem, smem + n * T * T, pmat, n, r);
  __syncthreads();
  const uint32_t bhi = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t blo = static_cast<uint32_t>(
      __cvta_generic_to_shared(smem + n * T * T));
  const int tid = threadIdx.x;
  const int ntiles = (m + kTcRows - 1) / kTcRows;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * kTcRows;
    uint32_t ahi[2][T / 8][4], alo[2][T / 8][4];
    float pe[2][T / 2];
    load_a_split<T / 8>(ahi[0], alo[0], phi, row0, 0, m, r);
    load_a_split<T / 8>(ahi[1], alo[1], phi, row0, 1, m, r);
    load_epilogue<T>(pe[0], phi, row0, 0, m, r);
    load_epilogue<T>(pe[1], phi, row0, 1, m, r);
    Unit<T> u0 = {}, u1 = {};
    wgmma_unit<T>(u0, ahi[0], alo[0], bhi, blo, 0);
    for (int x = 0; x < n; ++x) {
      wgmma_unit<T>(u1, ahi[1], alo[1], bhi, blo, x);
      wgmma_wait<1>();
      gram_finish<T>(u0, pe[0], fk, x, 0);
      if (x + 1 < n) {
        wgmma_unit<T>(u0, ahi[0], alo[0], bhi, blo, x + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      gram_finish<T>(u1, pe[1], fk, x, 1);
    }
    __syncthreads();                 // the fk tile complete
    const long long left = m - row0;
    const int rows = static_cast<int>(left < kTcRows ? left : kTcRows);
    float* dst = out + row0 * n;
    for (int f = tid; f < rows * n; f += kTcRows) {
      const int i = f / n;
      dst[f] = fk[fk_at<true>(f - i * n, i)];
    }
    __syncthreads();                 // the fk tile is free again
  }
}

template <int T>
int go_gram(const float* phi, const float* pmat, float* out, int m, int n,
            int r, int device, void* stream) {
  const size_t smem = (2 * static_cast<size_t>(n) * T * T
                       + static_cast<size_t>(n) * kTcRows) * sizeof(float);
  if (smem > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  int cap = 0;
  cudaError_t e = grid_cap(reinterpret_cast<const void*>(&gram_tc<T>),
                           device, smem, &cap, kTcRows);
  if (e != cudaSuccess) return e;
  const int tiles = (m + kTcRows - 1) / kTcRows;
  const int grid = tiles < cap ? tiles : cap;
  gram_tc<T><<<grid, kTcRows, smem, static_cast<cudaStream_t>(stream)>>>(
      phi, pmat, out, m, n, r);
  return cudaGetLastError();
}

}  // namespace

// fk (m, n) f32 from phi (m, r) and pmat (r*r, n) on the current device
// `device` by design (a); rank tiers 8-32.
extern "C" int gram_tc_launch(const void* phi, const void* pmat, void* fk,
                              int m, int n, int r, int device, void* stream) {
  const float* p = static_cast<const float*>(phi);
  const float* b = static_cast<const float*>(pmat);
  float* o = static_cast<float*>(fk);
  switch (ttirt::rank_tier(r)) {
    case 8: return go_gram<8>(p, b, o, m, n, r, device, stream);
    case 16: return go_gram<16>(p, b, o, m, n, r, device, stream);
    case 24: return go_gram<24>(p, b, o, m, n, r, device, stream);
    case 32: return go_gram<32>(p, b, o, m, n, r, device, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// v (m, n, tier) f32 on the device; rank tiers 8-32.
extern "C" int tc_probe_v(const void* phi, const void* bmat, void* vout,
                          int m, int n, int r, int scheme, void* stream) {
  const float* p = static_cast<const float*>(phi);
  const float* b = static_cast<const float*>(bmat);
  float* o = static_cast<float*>(vout);
  int e = static_cast<int>(cudaErrorInvalidValue);
  switch (2 * ttirt::rank_tier(r) + (scheme ? 1 : 0)) {
    case 16: e = go<8, 0>(p, b, o, m, n, r, stream); break;
    case 17: e = go<8, 1>(p, b, o, m, n, r, stream); break;
    case 32: e = go<16, 0>(p, b, o, m, n, r, stream); break;
    case 33: e = go<16, 1>(p, b, o, m, n, r, stream); break;
    case 48: e = go<24, 0>(p, b, o, m, n, r, stream); break;
    case 49: e = go<24, 1>(p, b, o, m, n, r, stream); break;
    case 64: e = go<32, 0>(p, b, o, m, n, r, stream); break;
    case 65: e = go<32, 1>(p, b, o, m, n, r, stream); break;
    default: break;
  }
  return e;
}
