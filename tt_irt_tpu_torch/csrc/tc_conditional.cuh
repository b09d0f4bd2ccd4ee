// The factor conditional of a tile of rows on the tensor cores, shared
// by the four factor-family kernels (dim_step and odim_step through
// tc_dim.cuh, cdf_bracket_factor in factor_step.cu, factor_conditional
// in factor_conditional.cu):
//   fk[row, x] = sum_j v[row, x, j]^2,  v[row, x, :] = phi[row, :] B_x,
// where B_x = B[:, x*r:(x+1)*r] is node x's (r, r) block of the factor.
//
// Precision: 3xTF32.  Each f32 operand is split as hi = tf32(x) (round
// to nearest, ties to even, at 10 explicit mantissa bits, by integer
// arithmetic) and lo = x - hi (exact in f32; the tensor core reads its
// top 10 mantissa bits), so that hi + lo = x; then
// v = lo_phi hi_B + hi_phi lo_B + hi_phi hi_B.  The tensor core sums a
// k8 step's products with its accumulator by truncation, so the small
// products go into one accumulator over every k-step, each k-step's
// large product into an accumulator of its own, and the CUDA cores add
// them in f32 (round to nearest), small first: v = ((S + P_0) + P_1) ...
// That is as accurate as the plain f32 product relative to the largest
// fk, where one accumulator for everything is not (tools/tc_variants.py).
// The missing lo lo term and the truncated lo leave an error of about
// 2^-21 sum_i |phi_i B_ij| in v, so where v cancels by many orders (the
// grid's end nodes, where the density is ~0) the tensor-core fk is far
// less accurate than the f32 chain.  A node whose tensor-core fk is
// below kRecompute of its row's largest is recomputed by the CUDA cores
// in f32, one FMA chain over i per entry of v and one over j for the
// squares (TcStage::warp_node_fk, the arithmetic of the first port's
// CUDA-core kernels), from the f32 factor that the staged hi + lo give
// back exactly: only at the two bracket nodes where the CDF stage
// follows (TcStage::bracket: its f1 and f2 feed the f64 epilogue), at
// every node where fk itself is the output (factor_conditional.cu, by
// TcStage::thread_node_fk, the same chain one thread a node).  Both take
// the same decision on the same values, so factor_conditional's fk at a
// row's bracket nodes equals the f1 and f2 of dim_step's bracket bit
// for bit.
// tests/test_torch_tf32_split.py models this arithmetic on the CPU.
//
// A warpgroup walks tiles of kTcRows = 128 rows: two m64 halves, warp w
// of the warpgroup holding rows 16w..16w+15 of each.  fk leaves the
// stage in a (n, 128) tile in shared memory, one column of kTcRows a
// node (fk_at), for the one-thread-per-row CDF stage or the transposed
// store of factor_conditional.
//
// Two variants, chosen by the shape (use_wgmma):
//  - kWgmma (rank tiers 8-32, where B's hi and lo fit): B split once per
//    block into hi and lo, each node padded to the tier (N = K = tier) in
//    the K-major core-matrix layout that wgmma reads without swizzle;
//    phi's split per tile in registers (the A operand of
//    wgmma.mma_async m64nTk8 .tf32).  A unit of work is one node and
//    one half (one commit group); two register sets, so that unit u+1
//    is on the tensor cores while unit u's squares are summed.  Two or
//    three warpgroups a block share the staged factor
//    (wgmma_max_warpgroups).
//  - kMma (tier 64, and tiers 24 / 32 where hi and lo do not fit): wgmma
//    reads B from shared memory only, so there B is staged once as f32
//    (the layout and size of the CUDA-core kernels, bs[col*T + i],
//    XOR-swizzled on i at tiers 32 and 64) and split per fragment in
//    registers, and the products run as mma.sync m16n8k8 .tf32 (HMMA),
//    one warpgroup a block.

#pragma once

#include <cstdint>

#include "row_common.cuh"

namespace ttirt {

constexpr int kTcRows = 128;     // rows of one warpgroup's tile
// A node's fk below this fraction of its row's largest is recomputed in
// f32 (TcStage::bracket, factor_conditional.cu).
constexpr float kRecompute = 0x1p-8f;

enum class Tc { kWgmma, kMma };

inline size_t tc_fk_bytes(int n, int warpgroups) {
  return static_cast<size_t>(n) * kTcRows * warpgroups * sizeof(float);
}

// Most warpgroups a block of the wgmma variant runs at rank tier t (the
// register budget of __launch_bounds__, tc_kernel_threads): three at
// tier 24, where the staged factor allows one block an SM; two at the
// lower tiers, where two blocks of two fit the registers, and at tier
// 32, where the two register sets take 224 registers.
constexpr int wgmma_max_warpgroups(int t) { return t == 24 ? 3 : 2; }

inline size_t wgmma_smem_bytes(int n, int tier, int warpgroups) {
  return 2 * static_cast<size_t>(n) * tier * tier * sizeof(float)
         + tc_fk_bytes(n, warpgroups);
}

// Warpgroups of a wgmma block at (n, r): as many as fit the shared
// memory, 0 where even one does not (or at tier 64).
inline int wgmma_warpgroups(int n, int r) {
  const int t = rank_tier(r);
  if (t > 32) return 0;
  for (int w = wgmma_max_warpgroups(t); w > 0; --w)
    if (wgmma_smem_bytes(n, t, w) <= kSmemOptIn) return w;
  return 0;
}

inline bool use_wgmma(int n, int r) { return wgmma_warpgroups(n, r) > 0; }

// The mma.sync variant (one warpgroup) needs what the first port's
// CUDA-core kernels needed (the factor padded to the rank tier and one
// fk column a row), so every shape they took runs.
inline size_t mma_smem_bytes(int n, int r) {
  return static_cast<size_t>(n) * r * rank_tier(r) * sizeof(float)
         + tc_fk_bytes(n, 1);
}

inline size_t tc_smem_bytes(int n, int r) {
  const int w = wgmma_warpgroups(n, r);
  return w > 0 ? wgmma_smem_bytes(n, rank_tier(r), w) : mma_smem_bytes(n, r);
}

// Threads of a block at (n, r), and the most a kernel instance takes.
inline int tc_threads(int n, int r) {
  const int w = wgmma_warpgroups(n, r);
  return (w > 0 ? w : 1) * kTcRows;
}

template <int T, Tc V>
constexpr int tc_kernel_threads() {
  return V == Tc::kWgmma ? wgmma_max_warpgroups(T) * kTcRows : kTcRows;
}

// Blocks of a persistent tensor-core kernel: one 128-row tile per
// warpgroup, at most `cap` blocks.
inline int tc_grid(int m, int threads, int cap) {
  const int tiles = (m + kTcRows - 1) / kTcRows;
  const int wgs = threads / kTcRows;
  const int blocks = (tiles + wgs - 1) / wgs;
  return blocks < cap ? blocks : cap;
}

// Launch the instance `kern` (a __global__ function's address; nullptr
// refuses the shape) of a persistent tensor-core kernel at (m, n, r) on
// `stream`: tc_threads(n, r) threads and tc_smem_bytes(n, r) bytes a
// block, as many blocks as the tiles need and the card holds at once.
// `args` are the kernel's arguments as cudaLaunchKernel takes them.
inline cudaError_t tc_launch(const void* kern, void** args, int m, int n,
                             int r, int device, cudaStream_t stream) {
  if (kern == nullptr) return cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes(n, r);
  const int threads = tc_threads(n, r);
  int cap = 0;
  cudaError_t e = grid_cap(kern, device, smem, &cap, threads);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernel(kern, dim3(tc_grid(m, threads, cap)),
                          dim3(threads), args, smem, stream);
}

// The instance that a launch at (n, r) runs, of a kernel whose instance
// at rank tier T and variant V is K<T, V>::fn() (its address): the
// wgmma variant where B's split fits (use_wgmma), else mma.sync, which
// exists at tiers 24-64 only (tiers 8 and 16 always fit wgmma).  Every
// kernel of the family picks its variant here, so that their
// conditionals agree bit for bit at every shape.
template <template <int, Tc> class K, int T>
const void* tc_instance(int n, int r) {
  if constexpr (T <= 32) {
    if (use_wgmma(n, r)) return K<T, Tc::kWgmma>::fn();
  }
  if constexpr (T >= 24) {
    return K<T, Tc::kMma>::fn();
  } else {
    return nullptr;
  }
}

// ---- 3xTF32 split ----

__device__ __forceinline__ float tf32_round(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0xFFFu + ((u >> 13) & 1u);
  return __uint_as_float(u & 0xFFFFE000u);
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const float h = tf32_round(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

// ---- warpgroup helpers ----

__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(wg + 1), "n"(kTcRows) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of an accumulator across the
// asynchronous wgmma that writes it.
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, no swizzle: start address, LBO = the
// byte stride between the two 16-byte K halves of a k8 step, SBO = the
// byte stride between 8-column groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// D (64 x T) (+)= A (64 x 8, registers) B (8 x T, shared memory), tf32
// in, f32 accumulators; scale_d = 0 ignores D's old value.
template <int T>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, "
        "1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<24> {
  __device__ __forceinline__ static void mma(float (&d)[12],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

// D (16 x 8) += A (16 x 8) B (8 x 8), one warp, tf32 in, f32 out.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- fragments and the fk tile ----

// This thread's A fragments of half h (rows 64h + 16w + g and +8) of
// the tile at row0, split: element e of k-step s is at row +8*(e&1),
// column 8s + t + 4*(e>>1) (g = lane/4, t = lane%4).  Rows >= m and
// columns >= r are 0.
template <int KS>
__device__ __forceinline__ void load_a_split(uint32_t (&hi)[KS][4],
                                             uint32_t (&lo)[KS][4],
                                             const float* __restrict__ phi,
                                             long long row0, int h, int m,
                                             int r) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const long long base = row0 + 64 * h + 16 * warp + (lane >> 2);
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long row = base + 8 * (e & 1);
      const int col = 8 * s + (lane & 3) + 4 * (e >> 1);
      const float v = (row < m && col < r) ? phi[row * r + col] : 0.0f;
      split_tf32(v, hi[s][e], lo[s][e]);
    }
  }
}

// Offset of (node x, tile row i) in a warpgroup's fk tile: a column of
// kTcRows a node.  With SWZ, i is XOR-ed with the node's low five bits,
// so that a warp reading the tile across nodes (factor_conditional's
// transposed store) meets 32 different banks; the tile's size is the
// same.
template <bool SWZ>
__device__ __forceinline__ int fk_at(int x, int i) {
  return x * kTcRows + (SWZ ? (i ^ (x & 31)) : i);
}

// fk of this thread's two rows of half h at node x from its
// accumulator fragment (columns 8c + 2t, +1 of rows g and g+8): its own
// squares, then the quad's by two lane shuffles; lane t == 0 writes.
template <int T, bool SWZ>
__device__ __forceinline__ void reduce_half(const float (&d)[T / 2],
                                            float* fk, int x, int h) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int c = 0; c < T / 8; ++c) {
    s0 = fmaf(d[4 * c], d[4 * c], s0);
    s0 = fmaf(d[4 * c + 1], d[4 * c + 1], s0);
    s1 = fmaf(d[4 * c + 2], d[4 * c + 2], s1);
    s1 = fmaf(d[4 * c + 3], d[4 * c + 3], s1);
  }
  s0 += __shfl_xor_sync(0xFFFFFFFFu, s0, 1);
  s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, 1);
  s0 += __shfl_xor_sync(0xFFFFFFFFu, s0, 2);
  s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, 2);
  if ((lane & 3) == 0) {
    const int i = 64 * h + 16 * warp + (lane >> 2);
    fk[fk_at<SWZ>(x, i)] = s0;
    fk[fk_at<SWZ>(x, i + 8)] = s1;
  }
}

// ---- the wgmma variant ----

// Float offset of B[i, x*r + j] (K index i, N index j < T) in a node-
// padded, K-major core-matrix layout: a core matrix is 8 columns x 4 K
// values (128 bytes, column-major within: 16 bytes a column); cores run
// along N first (SBO = 128 bytes), then along K (LBO = T/8 * 128 bytes).
template <int T>
__device__ __forceinline__ int core_offset(int x, int i, int j) {
  return x * T * T + ((i >> 2) * (T / 8) + (j >> 3)) * 32
         + (j & 7) * 4 + (i & 3);
}

// The same layout for one part (hi or lo) of a unit of the wide tier's
// pre-split factor (csrc/factor_wide.cu): K = 8 ks values by N = 8 nc
// columns, cores along N first (SBO = 128 bytes), then along K (LBO =
// nc * 128 bytes); float offset of (K index i, column j < 8 nc).
__host__ __device__ inline int unit_core_offset(int nc, int i, int j) {
  return ((i >> 2) * nc + (j >> 3)) * 32 + (j & 7) * 4 + (i & 3);
}

// The descriptor of k-step s of such a part at shared address `part`.
__device__ __forceinline__ uint64_t unit_desc(uint32_t part, int nc, int s) {
  const uint32_t lbo = static_cast<uint32_t>(nc) * 128;
  return smem_desc(part + 2 * s * lbo, lbo, 128);
}

template <int T>
__device__ __forceinline__ void stage_factor_wgmma(float* bhi, float* blo,
                                                   const float* bmat, int n,
                                                   int r) {
  const int nr = n * r;
  for (int idx = threadIdx.x; idx < n * T * T; idx += blockDim.x) {
    const int x = idx / (T * T);
    const int rem = idx - x * T * T;
    const int i = rem / T;
    const int j = rem - i * T;
    const float v = (i < r && j < r) ? bmat[i * nr + x * r + j] : 0.0f;
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    const int o = core_offset<T>(x, i, j);
    bhi[o] = __uint_as_float(hi);
    blo[o] = __uint_as_float(lo);
  }
  // the staged factor is read by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The registers of one unit (a node and a half): the small products'
// accumulator and one accumulator per k-step of the large product.
template <int T>
struct Unit {
  float small[T / 2];
  float part[T / 8][T / 2];
};

template <int T>
__device__ __forceinline__ void fence_unit(Unit<T>& u) {
  fence_regs(u.small);
#pragma unroll
  for (int s = 0; s < T / 8; ++s) fence_regs(u.part[s]);
}

// Unit (x, h) into u: lo.hi and hi.lo over every k-step into u.small,
// hi.hi of k-step s into u.part[s]; one commit group.
template <int T>
__device__ __forceinline__ void wgmma_unit(Unit<T>& u,
                                           const uint32_t (&ahi)[T / 8][4],
                                           const uint32_t (&alo)[T / 8][4],
                                           uint32_t bhi, uint32_t blo, int x) {
  constexpr uint32_t kLbo = (T / 8) * 128, kSbo = 128;
  const uint32_t node = static_cast<uint32_t>(x) * T * T * 4;
  fence_unit(u);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < T / 8; ++s)
    Wgmma<T>::mma(u.small, alo[s],
                  smem_desc(bhi + node + 2 * s * kLbo, kLbo, kSbo), s > 0);
#pragma unroll
  for (int s = 0; s < T / 8; ++s)
    Wgmma<T>::mma(u.small, ahi[s],
                  smem_desc(blo + node + 2 * s * kLbo, kLbo, kSbo), 1);
#pragma unroll
  for (int s = 0; s < T / 8; ++s)
    Wgmma<T>::mma(u.part[s], ahi[s],
                  smem_desc(bhi + node + 2 * s * kLbo, kLbo, kSbo), 0);
  wgmma_commit();
}

// v = ((small + part[0]) + part[1]) ... in f32, then its squares.
template <int T, bool SWZ>
__device__ __forceinline__ void finish_unit(Unit<T>& u, float* fk, int x,
                                            int h) {
  fence_unit(u);
  float v[T / 2];
#pragma unroll
  for (int e = 0; e < T / 2; ++e) {
    v[e] = u.small[e];
#pragma unroll
    for (int s = 0; s < T / 8; ++s) v[e] = __fadd_rn(v[e], u.part[s][e]);
  }
  reduce_half<T, SWZ>(v, fk, x, h);
}

// Units u = 2x + h in order, two register sets in flight.
template <int T, bool SWZ>
__device__ __forceinline__ void wgmma_conditional(const float* bhi_p,
                                                  const float* blo_p,
                                                  float* fk,
                                                  const float* __restrict__ phi,
                                                  long long row0, int m, int n,
                                                  int r) {
  uint32_t ahi[2][T / 8][4], alo[2][T / 8][4];
  load_a_split<T / 8>(ahi[0], alo[0], phi, row0, 0, m, r);
  load_a_split<T / 8>(ahi[1], alo[1], phi, row0, 1, m, r);
  const uint32_t bhi = static_cast<uint32_t>(__cvta_generic_to_shared(bhi_p));
  const uint32_t blo = static_cast<uint32_t>(__cvta_generic_to_shared(blo_p));
  Unit<T> u0 = {}, u1 = {};
  const int units = 2 * n;
  wgmma_unit<T>(u0, ahi[0], alo[0], bhi, blo, 0);
  for (int k = 0; k < units; k += 2) {       // units is even
    const int x = k >> 1;
    wgmma_unit<T>(u1, ahi[1], alo[1], bhi, blo, x);
    wgmma_wait<1>();
    finish_unit<T, SWZ>(u0, fk, x, 0);
    if (k + 2 < units) {
      wgmma_unit<T>(u0, ahi[0], alo[0], bhi, blo, x + 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    finish_unit<T, SWZ>(u1, fk, x, 1);
  }
}

// ---- the mma.sync variant ----

template <int T>
__device__ __forceinline__ int swz(int col, int i) {
  if constexpr (T % 32 == 0) {
    return i ^ ((col & 7) << 2);   // the 8 columns of a fragment: 8 banks
  } else {
    return i;
  }
}

// bs[col*T + swz(col, i)] = B[i, col], zero for r <= i < T.
template <int T>
__device__ __forceinline__ void stage_factor_mma(float* bs, const float* bmat,
                                                 int n, int r) {
  const int nr = n * r;
  for (int idx = threadIdx.x; idx < r * nr; idx += blockDim.x) {
    const int i = idx / nr;
    const int col = idx - i * nr;
    bs[col * T + swz<T>(col, i)] = bmat[idx];
  }
  for (int idx = threadIdx.x; idx < nr * (T - r); idx += blockDim.x) {
    const int col = idx / (T - r);
    const int i = r + (idx - col * (T - r));
    bs[col * T + swz<T>(col, i)] = 0.0f;
  }
}

template <int T, bool SWZ>
__device__ __forceinline__ void mma_conditional(const float* bs, float* fk,
                                                const float* __restrict__ phi,
                                                long long row0, int m, int n,
                                                int r) {
  constexpr int KS = T / 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ks = (r + 7) / 8;
  for (int h = 0; h < 2; ++h) {
    uint32_t ahi[KS][4], alo[KS][4];
    load_a_split<KS>(ahi, alo, phi, row0, h, m, r);
    for (int x = 0; x < n; ++x) {
      float d[T / 2];
#pragma unroll
      for (int c = 0; c < KS; ++c) {
        float small[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float part[KS][4] = {};
        const int j = 8 * c + g;
        const int col = x * r + j;
        if (8 * c < r) {
          const float* bc = bs + col * T;
          uint32_t bh[KS][2], bl[KS][2];
#pragma unroll
          for (int s = 0; s < KS; ++s) {
            const float b0 = (j < r && s < ks) ? bc[swz<T>(col, 8 * s + t)]
                                               : 0.0f;
            const float b1 = (j < r && s < ks)
                                 ? bc[swz<T>(col, 8 * s + t + 4)] : 0.0f;
            split_tf32(b0, bh[s][0], bl[s][0]);
            split_tf32(b1, bh[s][1], bl[s][1]);
          }
#pragma unroll
          for (int s = 0; s < KS; ++s)
            if (s < ks) mma_tf32(small, alo[s], bh[s][0], bh[s][1]);
#pragma unroll
          for (int s = 0; s < KS; ++s)
            if (s < ks) mma_tf32(small, ahi[s], bl[s][0], bl[s][1]);
#pragma unroll
          for (int s = 0; s < KS; ++s)
            if (s < ks) mma_tf32(part[s], ahi[s], bh[s][0], bh[s][1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = small[e];
#pragma unroll
          for (int s = 0; s < KS; ++s) v = __fadd_rn(v, part[s][e]);
          d[4 * c + e] = v;
        }
      }
      reduce_half<T, SWZ>(d, fk, x, h);
    }
  }
}

// ---- the stage as the kernels call it ----

// SWZ: the fk tile's rows swizzled per node (fk_at), for a kernel that
// reads the tile across nodes; the CDF stage (bracket) reads it
// unswizzled.
template <int T, Tc V, bool SWZ = false>
struct TcStage {
  // Floats of the staged factor in front of the fk tiles.
  __device__ __forceinline__ static int factor_floats(int n, int r) {
    return V == Tc::kWgmma ? 2 * n * T * T : n * r * T;
  }

  // This warpgroup's (n, kTcRows) fk tile.
  __device__ __forceinline__ static float* fk_tile(float* smem, int n, int r,
                                                   int wg) {
    return smem + factor_floats(n, r) + wg * n * kTcRows;
  }

  // Once per block; the caller synchronises.
  __device__ __forceinline__ static void stage(float* smem,
                                               const float* bmat, int n,
                                               int r) {
    if constexpr (V == Tc::kWgmma) {
      stage_factor_wgmma<T>(smem, smem + n * T * T, bmat, n, r);
    } else {
      stage_factor_mma<T>(smem, bmat, n, r);
    }
  }

  // B[i, x*r + j] in f32 from the staged factor.
  __device__ __forceinline__ static float factor(const float* smem, int n,
                                                 int r, int x, int i, int j) {
    if constexpr (V == Tc::kWgmma) {
      const int o = core_offset<T>(x, i, j);
      return smem[o] + smem[n * T * T + o];   // hi + lo, exact
    } else {
      const int col = x * r + j;
      return smem[col * T + swz<T>(col, i)];
    }
  }

  // B[4*i4 .. 4*i4+3, x*r + j] in f32 from the staged factor, by one
  // 16-byte load from each staged part (both layouts keep four
  // consecutive i of a column together and aligned).
  __device__ __forceinline__ static float4 factor4(const float* smem, int n,
                                                   int r, int x, int i4,
                                                   int j) {
    if constexpr (V == Tc::kWgmma) {
      const int o = core_offset<T>(x, 4 * i4, j);
      const float4 hi = *reinterpret_cast<const float4*>(smem + o);
      const float4 lo = *reinterpret_cast<const float4*>(smem + n * T * T + o);
      return make_float4(hi.x + lo.x, hi.y + lo.y, hi.z + lo.z, hi.w + lo.w);
    } else {
      const int col = x * r + j;
      return *reinterpret_cast<const float4*>(smem + col * T
                                              + swz<T>(col, 4 * i4));
    }
  }

  // fk of one row at node x in f32 on the CUDA cores, by one thread (p:
  // the row's phi, 0 beyond the rank): warp_node_fk's FMA chains, each
  // v_j over i in order and then the squares over j in order, so the
  // same value bit for bit.  The r chains of v run side by side (i
  // outer, j inner), so that they overlap in the pipeline.
  __device__ __forceinline__ static float thread_node_fk(const float* smem,
                                                         const float (&p)[T],
                                                         int n, int r, int x) {
    float v[T];
#pragma unroll
    for (int j = 0; j < T; ++j) v[j] = 0.0f;
#pragma unroll
    for (int i4 = 0; i4 < T / 4; ++i4) {
      if (4 * i4 < r) {
#pragma unroll
        for (int j = 0; j < T; ++j) {
          if (j < r) {
            const float4 b = factor4(smem, n, r, x, i4, j);
            v[j] = fmaf(p[4 * i4], b.x, v[j]);
            if (4 * i4 + 1 < r) v[j] = fmaf(p[4 * i4 + 1], b.y, v[j]);
            if (4 * i4 + 2 < r) v[j] = fmaf(p[4 * i4 + 2], b.z, v[j]);
            if (4 * i4 + 3 < r) v[j] = fmaf(p[4 * i4 + 3], b.w, v[j]);
          }
        }
      }
    }
    float f = 0.0f;
#pragma unroll
    for (int j = 0; j < T; ++j)
      if (j < r) f = fmaf(v[j], v[j], f);
    return f;
  }

  // fk of one row at node x in f32 on the CUDA cores, by the whole warp
  // (pv[u] = phi[row, lane + 32u]): lane j forms v_j by one FMA chain
  // over i, then every lane forms sum_j v_j^2 by one FMA chain over j,
  // the arithmetic of the first port's CUDA-core factor_conditional.
  __device__ __forceinline__ static float warp_node_fk(
      const float* smem, const float (&pv)[(T + 31) / 32], int n, int r,
      int x) {
    constexpr int kJ = (T + 31) / 32;
    const int lane = threadIdx.x & 31;
    float v[kJ];
#pragma unroll
    for (int u = 0; u < kJ; ++u) v[u] = 0.0f;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      if (i >= r) continue;
      const float pi = __shfl_sync(0xFFFFFFFFu, pv[i / 32], i % 32);
#pragma unroll
      for (int u = 0; u < kJ; ++u) {
        const int j = lane + 32 * u;
        if (j < r) v[u] = fmaf(pi, factor(smem, n, r, x, i, j), v[u]);
      }
    }
    float f = 0.0f;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      if (j >= r) continue;
      const float vj = __shfl_sync(0xFFFFFFFFu, v[j / 32], j % 32);
      f = fmaf(vj, vj, f);
    }
    return f;
  }

  // The CDF stage of this thread's row (live: row < m) on its fk column.
  // Every thread of the warp calls it.  Where f1 or f2 is below
  // kRecompute of the row's largest fk, it is recomputed by
  // warp_node_fk: such a node's v cancels (the density there is small),
  // and the tensor-core value, good to ~2^-21 of sum_i |phi_i B_ij|,
  // is then far from the f32 chain's.  Elsewhere the tensor-core fk
  // stands: f1, f2 and the CDF sums then carry the same rounding, which
  // recomputing every bracket would break (the f32 chain rounds to
  // nearest, the tensor core truncates; the log-density would drift by
  // ~1e-7 a dimension).
  template <bool RT>
  __device__ __forceinline__ static Bracket bracket(
      const float* smem, const float* fcol, const float* __restrict__ phi,
      long long row, bool live, const float* __restrict__ h,
      const float* __restrict__ xg, int n, int r, float q, float um) {
    static_assert(!SWZ, "the CDF stage reads an unswizzled fk tile");
    constexpr int kJ = (T + 31) / 32;
    const int lane = threadIdx.x & 31;
    Bracket b{};
    int need = 0;                     // bit 0: f1, bit 1: f2
    if (live) {
      b = cdf_bracket<RT>(fcol, kTcRows, h, xg, n, q, um);
      float fmax = 0.0f;
      for (int k = 0; k < n; ++k) fmax = fmaxf(fmax, fcol[k * kTcRows]);
      const float tiny = kRecompute * fmax;
      if (!b.flat) need = (b.f1 < tiny ? 1 : 0) | (b.f2 < tiny ? 2 : 0);
    }
    unsigned todo = __ballot_sync(0xFFFFFFFFu, need != 0);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const long long rs = __shfl_sync(0xFFFFFFFFu, row, src);
      const int is = __shfl_sync(0xFFFFFFFFu, b.i0, src);
      const int which = __shfl_sync(0xFFFFFFFFu, need, src);
      float pv[kJ];
#pragma unroll
      for (int u = 0; u < kJ; ++u) {
        const int j = lane + 32 * u;
        pv[u] = j < r ? phi[rs * r + j] : 0.0f;
      }
      if (which & 1) {
        const float f = warp_node_fk(smem, pv, n, r, is);
        if (lane == src) b.f1 = f;
      }
      if (which & 2) {
        const float f = warp_node_fk(smem, pv, n, r, is + 1);
        if (lane == src) b.f2 = f;
      }
    }
    return b;
  }

  // fk of the tile at row0 into this warpgroup's fk tile; every thread
  // of the warpgroup calls it, and it returns after the warpgroup's
  // barrier, with the tile complete.
  __device__ __forceinline__ static void conditional(const float* smem,
                                                     float* fk,
                                                     const float* phi,
                                                     long long row0, int m,
                                                     int n, int r, int wg) {
    if constexpr (V == Tc::kWgmma) {
      wgmma_conditional<T, SWZ>(smem, smem + n * T * T, fk, phi, row0,
                                m, n, r);
    } else {
      mma_conditional<T, SWZ>(smem, fk, phi, row0, m, n, r);
    }
    wg_barrier(wg);
  }
};

}  // namespace ttirt
