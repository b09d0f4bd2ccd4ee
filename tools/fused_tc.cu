// Design T of the whole-transform kernel: csrc/fused_irt.cu's loop with
// the Gram contraction on the tensor cores, for tools/tc_variants.py
// --fused to time beside the shipped kernel (design CU, the FP32 cores).
//
// A block is one warpgroup and walks tiles of 128 rows, one row a
// thread, through the d dimensions (persistent grid).  Per dimension,
// v = phi P~ runs as 3xTF32 wgmma (tc_conditional.cuh's wgmma_unit, split
// accumulators summed in f32; P~[i, x*r + j] = P[i*r + j, x], the shape
// of the factor B), then a Gram epilogue fk[x] = sum_j v[x, j] phi_j
// (tools/tc_probe.cu's gram_tc) into an (n, 128) fk tile; the CDF,
// inversion and prefix update of each row are the shipped kernel's
// (invert_rows and update_strided at one row a thread).  phi lives in a
// (128, r | 1) tile in shared memory: the A fragments and the epilogue's
// phi are read from it, and each row's update writes it back.  The
// packed operand is pre-split on the host (tc_variants.py: pack_tc):
// per dimension [P~ hi | P~ lo, each n T^2 floats in the no-swizzle
// K-major core-matrix layout | C at stride cstride | x | h | 0], staged
// by cp.async into two buffers where they fit, else one.  fk is not the
// shipped kernel's bit for bit (the tensor-core products round
// differently).  Rank tiers 8-32.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libfused_tc.so tools/fused_tc.cu

#include "../tt_irt_tpu_torch/csrc/tc_conditional.cuh"
#include "../tt_irt_tpu_torch/csrc/fused_irt.cu"

namespace {

using namespace ttirt;

// This thread's A fragments of half h from the phi tile (pitch floats a
// row), split as load_a_split does; columns >= r are 0.
template <int T>
__device__ __forceinline__ void load_a_tile(uint32_t (&hi)[T / 8][4],
                                            uint32_t (&lo)[T / 8][4],
                                            const float* tile, int pitch,
                                            int h, int r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = 64 * h + 16 * warp + (lane >> 2);
#pragma unroll
  for (int s = 0; s < T / 8; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = base + 8 * (e & 1);
      const int col = 8 * s + (lane & 3) + 4 * (e >> 1);
      const float v = col < r ? tile[row * pitch + col] : 0.0f;
      split_tf32(v, hi[s][e], lo[s][e]);
    }
  }
}

// phi at this thread's accumulator positions of half h (gram_tc's
// load_epilogue, from the tile).
template <int T>
__device__ __forceinline__ void load_pe(float (&pe)[T / 2], const float* tile,
                                        int pitch, int h, int r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = 64 * h + 16 * warp + (lane >> 2);
#pragma unroll
  for (int e = 0; e < T / 2; ++e) {
    const int row = base + 8 * (e >> 1 & 1);
    const int col = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
    pe[e] = col < r ? tile[row * pitch + col] : 0.0f;
  }
}

// gram_tc's epilogue of unit (x, h) into the fk tile, node x's column.
template <int T>
__device__ __forceinline__ void gram_epilogue(Unit<T>& u,
                                              const float (&pe)[T / 2],
                                              float* fk, int x, int h) {
  fence_unit(u);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
    fk[fk_at<false>(x, i)] = s0;
    fk[fk_at<false>(x, i + 8)] = s1;
  }
}

template <int T, int B>
__global__ void __launch_bounds__(kTcRows)
fused_tc_kernel(const float* __restrict__ q, const float* __restrict__ pack,
                float* __restrict__ out, float* __restrict__ lfout, int m,
                int d, int n, int r, int cstride, int block) {
  extern __shared__ __align__(128) float smem[];
  float* fkt = smem + B * block;            // (n, 128)
  float* tile = fkt + n * kTcRows;          // (128, pitch)
  const int pitch = r | 1;
  const int tid = threadIdx.x;
  const int ntiles = (m + kTcRows - 1) / kTcRows;
  const int steps = ((ntiles - 1 - blockIdx.x) / gridDim.x + 1) * d;
  float* prow = tile + tid * pitch;

  stage(smem, pack, block);
  for (int i = 0; i < r; ++i) prow[i] = (i == 0) ? 1.0f : 0.0f;
  float lf = 0.0f;
  for (int s = 0; s < steps; ++s) {
    const int k = s % d;
    const long long row =
        static_cast<long long>(blockIdx.x + (s / d) * gridDim.x) * kTcRows
        + tid;
    cp_async_wait_all();
    // the staged P~ is read by wgmma through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (B == 2 && s + 1 < steps)
      stage(smem + ((s + 1) & 1) * block,
            pack + static_cast<size_t>((s + 1) % d) * block, block);
    const float* buf = smem + (B == 2 ? (s & 1) * block : 0);
    const float* cs = buf + 2 * n * T * T;
    const float* xs = cs + n * cstride;
    const float* hs = xs + n;
    const uint32_t bhi = static_cast<uint32_t>(__cvta_generic_to_shared(buf));
    const uint32_t blo = bhi + static_cast<uint32_t>(n * T * T * 4);

    uint32_t ahi[2][T / 8][4], alo[2][T / 8][4];
    float pe[2][T / 2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      load_a_tile<T>(ahi[h], alo[h], tile, pitch, h, r);
      load_pe<T>(pe[h], tile, pitch, h, r);
    }
    Unit<T> u0 = {}, u1 = {};
    wgmma_unit<T>(u0, ahi[0], alo[0], bhi, blo, 0);
    for (int x = 0; x < n; ++x) {
      wgmma_unit<T>(u1, ahi[1], alo[1], bhi, blo, x);
      wgmma_wait<1>();
      gram_epilogue<T>(u0, pe[0], fkt, x, 0);
      if (x + 1 < n) {
        wgmma_unit<T>(u0, ahi[0], alo[0], bhi, blo, x + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      gram_epilogue<T>(u1, pe[1], fkt, x, 1);
    }
    __syncthreads();                        // the fk tile complete

    const float* fcol = fkt + tid;
    float tot[1] = {0.0f};
    for (int x = 1; x < n; ++x)
      tot[0] = __fadd_rn(tot[0], cell(fcol[(x - 1) * kTcRows],
                                      fcol[x * kTcRows], hs[x - 1]));
    const float qk[1] = {row < m ? q[row * d + k] : 0.0f};
    Step st[1];
    invert_rows<1>([&](int x, int) { return fcol[x * kTcRows]; }, tot, xs,
                   hs, n, qk, st);
    lf += st[0].dlf;
    if (row < m) {
      out[row * d + k] = st[0].xk;
      if (k == d - 1) lfout[row] = lf;
    }
    const float* ca = cs + st[0].i0 * cstride;
    float acc[T];
    update_strided<T>(prow, 1, st[0].la, st[0].lb, ca, ca + cstride, r, acc);
    if (k == d - 1) lf = 0.0f;
#pragma unroll
    for (int j = 0; j < T; ++j)
      if (j < r) prow[j] = (k == d - 1) ? (j == 0 ? 1.0f : 0.0f) : acc[j];

    if (B == 1 && s + 1 < steps) {
      __syncthreads();
      stage(smem, pack + static_cast<size_t>((s + 1) % d) * block, block);
    }
  }
  cp_async_wait_all();
}

size_t tc_smem(int n, int r, int block, int buffers) {
  return (static_cast<size_t>(buffers) * block
          + static_cast<size_t>(n) * kTcRows
          + static_cast<size_t>(kTcRows) * (r | 1)) * sizeof(float);
}

template <int T, int B>
int go_tc(const float* q, const float* pack, float* out, float* lf, int m,
          int d, int n, int r, int cstride, int block, int device,
          cudaStream_t stream) {
  const void* kern = reinterpret_cast<const void*>(&fused_tc_kernel<T, B>);
  const size_t smem = tc_smem(n, r, block, B);
  int cap = 0;
  cudaError_t e = grid_cap(kern, device, smem, &cap, kTcRows);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (m + kTcRows - 1) / kTcRows;
  void* args[] = {&q, &pack, &out, &lf, &m, &d, &n, &r, &cstride, &block};
  return static_cast<int>(cudaLaunchKernel(
      kern, dim3(tiles < cap ? tiles : cap), dim3(kTcRows), args, smem,
      stream));
}

template <int T>
int go_tier(const float* q, const float* pack, float* out, float* lf, int m,
            int d, int n, int r, int cstride, int block, int device,
            cudaStream_t stream) {
  if (tc_smem(n, r, block, 2) <= kSmemOptIn)
    return go_tc<T, 2>(q, pack, out, lf, m, d, n, r, cstride, block, device,
                       stream);
  if (tc_smem(n, r, block, 1) <= kSmemOptIn)
    return go_tc<T, 1>(q, pack, out, lf, m, d, n, r, cstride, block, device,
                       stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Buffers design T takes at (n, r) for a packed block of `block` floats
// (0: none fits).
extern "C" int fused_tc_buffers(int n, int r, int block) {
  for (int b = 2; b >= 1; --b)
    if (tc_smem(n, r, block, b) <= ttirt::kSmemOptIn) return b;
  return 0;
}

// As fused_irt_launch, with tools/tc_variants.py's pack_tc operand; rank
// tiers 8-32.
extern "C" int fused_tc_launch(const void* q, const void* pack, void* out,
                               void* lf, int m, int d, int n, int r,
                               int cstride, int block, int device,
                               void* stream) {
  if (m == 0 || d == 0) return 0;
  const float* qf = static_cast<const float*>(q);
  const float* pk = static_cast<const float*>(pack);
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ttirt::rank_tier(r)) {
    case 8: return go_tier<8>(qf, pk, o, l, m, d, n, r, cstride, block, device, s);
    case 16: return go_tier<16>(qf, pk, o, l, m, d, n, r, cstride, block, device, s);
    case 24: return go_tier<24>(qf, pk, o, l, m, d, n, r, cstride, block, device, s);
    case 32: return go_tier<32>(qf, pk, o, l, m, d, n, r, cstride, block, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
