// v = phi B for tiles of 128 rows, through the tensor-core conditional's
// pieces (tt_irt_tpu_torch/csrc/tc_conditional.cuh), in two accumulation
// schemes, written out raw for tools/tc_variants.py:
//   scheme 0: every product into one accumulator (lo.hi and hi.lo over
//             the k-steps, then hi.hi);
//   scheme 1: the shipped one (wgmma_unit: small products in one
//             accumulator, hi.hi of each k-step in its own, summed in f32
//             on the CUDA cores).
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

}  // namespace

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
