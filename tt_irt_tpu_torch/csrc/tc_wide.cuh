// The pieces of the wide tiers' tensor-core kernels that factor_wide.cu
// (the factor family past n or r of 64), cell_readout.cu (the prefix
// update past 64) and tc_gram.cuh (the Gram stage of gram_wide.cu and
// fused_wide.cu) share: the factor, core or Gram field split once a call
// into tf32 hi and lo units in wgmma's K-major layout
// (split_factor_kernel), the ring of unit stages that a producer warp
// streams by cp.async.bulk through mbarriers, and the register trade
// between the producer warpgroup and the two consumer warpgroups
// (setmaxnreg).  The designs are documented in those sources.

#pragma once

#include "tc_conditional.cuh"

namespace {

using namespace ttirt;

constexpr int kWideMaxN = 128;
constexpr int kWideMaxR = 128;
constexpr int kConsumers = 2 * kTcRows;  // two warpgroups, 64 rows each
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kBlock = kConsumers + kTcRows;  // and the producer's
constexpr int kMaxStages = 6;
constexpr int kParts = 4;                // accumulators of hi.hi a unit

// Run STMT with the constant KS set to the k-steps whose A fragments an
// instance holds at rank r: 4 up to r = 32, 8 up to 64, 16 up to 128.
#define TTIRT_FOR_KSTEPS(r, STMT)                                 \
  switch ((r) <= 32 ? 4 : (r) <= 64 ? 8 : 16) {                   \
    case 4: { constexpr int KS = 4; STMT; } break;                \
    case 8: { constexpr int KS = 8; STMT; } break;                \
    default: { constexpr int KS = 16; STMT; } break;              \
  }

inline bool in_wide_caps(int n, int r) {
  return n >= 2 && n <= kWideMaxN && r >= 1 && r <= kWideMaxR;
}

// The k-steps of rank r, the units a node's columns are cut into (at
// most 4 column groups of 8 a unit), the groups a unit (the last unit
// zero-padded), and the floats of one unit's hi and lo.
__host__ __device__ constexpr int ksteps(int r) { return (r + 7) / 8; }
__host__ __device__ constexpr int node_units(int ks) { return (ks + 3) / 4; }
__host__ __device__ constexpr int unit_groups(int ks) {
  return (ks + node_units(ks) - 1) / node_units(ks);
}
__host__ __device__ constexpr int unit_floats(int ks) {
  return 2 * (8 * ks) * (8 * unit_groups(ks));
}

// Floats of n nodes' (r, r) blocks split into units (a multiple of 128).
__host__ __device__ inline long long split_floats(int n, int r) {
  const int ks = ksteps(r);
  return static_cast<long long>(n) * node_units(ks) * unit_floats(ks);
}

// ---- the ring: mbarriers and bulk copies ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

// Until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst by the bulk
// copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}

// The consumer warpgroups' barrier (the producer warpgroup never
// joins).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// A position in the ring: the stage and the parity of its round.
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// Thread 0 initialises the ring's barriers (full: the producer's one
// arrival and the bytes; empty: the eight consumer warps); every thread
// of the block returns after they are visible.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Registers.  A block of 384 threads compiles to 168 a thread (ptxas
// allocates a block by whole warpgroups); where ks > 4 the consumers need
// more (phi's split and five accumulators: ~230 at ks = 16), so the
// producer warpgroup gives 144 back and each consumer takes 72
// (setmaxnreg; the counts of every such instance are 168, which
// chip_smoke.py checks in ptxas's report).
template <int KS>
__device__ __forceinline__ void producer_registers() {
  if constexpr (KS > 4)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}

template <int KS>
__device__ __forceinline__ void consumer_registers() {
  if constexpr (KS > 4)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

template <int K>
__device__ __forceinline__ void zero(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) d[i] = 0.0f;
}

// ---- the split ----

// The split of `nodes` (r, r) blocks, block x's entry (i, j) at
// bmat[(x / per) * outer + (x % per) * node + i * row + j * col] (the
// factor Q or B (r, n*r): node = r, row = n r, col = 1; the core C (n,
// r*r): node = r^2, row = r, col = 1; the Gram field P (r*r, n): node = 1,
// row = r n, col = n; per = n and outer the floats between the stacked
// fields of several dimensions): unit k = x * nu + u of node x holds its
// hi part, then its lo part, each (8 ks, 8 nc) in unit_core_offset's
// layout; columns u * 8 nc + j past r and K rows past r are zero.
__global__ void split_factor_kernel(const float* __restrict__ bmat,
                                    float* __restrict__ split, int nodes,
                                    int r, long long node, long long row,
                                    long long col, int per,
                                    long long outer) {
  const int ks = ksteps(r), nu = node_units(ks), nc = unit_groups(ks);
  const int cols = 8 * nc, part = (8 * ks) * cols;
  const long long total = static_cast<long long>(nodes) * nu * part;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x)
                       + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long k = idx / part;
    const int rem = static_cast<int>(idx - k * part);
    const int i = rem / cols, jl = rem - i * cols;
    const int x = static_cast<int>(k / nu), u = static_cast<int>(k % nu);
    const int j = cols * u + jl;
    const long long at = (x / per) * outer + (x % per) * node + i * row
                         + j * col;
    const float v = (i < r && j < r) ? bmat[at] : 0.0f;
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    const long long o = 2 * k * part + unit_core_offset(nc, i, jl);
    split[o] = __uint_as_float(hi);
    split[o + part] = __uint_as_float(lo);
  }
}

// The split of `nodes` blocks at the strides above into `split`
// (nodes / n * split_floats(n, r) floats, n = per) on `stream`.
inline cudaError_t split_nodes_launch(const float* bmat, float* split,
                                      int nodes, int r, long long node,
                                      long long row, long long col, int per,
                                      long long outer, cudaStream_t stream) {
  const int ks = ksteps(r);
  const long long total = static_cast<long long>(nodes) * node_units(ks)
                          * (unit_floats(ks) / 2);
  long long blocks = (total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  split_factor_kernel<<<static_cast<int>(blocks), 256, 0, stream>>>(
      bmat, split, nodes, r, node, row, col, per, outer);
  return cudaGetLastError();
}

// The split of n blocks with unit column stride into `split`
// (split_floats(n, r) floats) on `stream`.
inline cudaError_t split_launch(const float* bmat, float* split, int n,
                                int r, long long node, long long row,
                                cudaStream_t stream) {
  return split_nodes_launch(bmat, split, n, r, node, row, 1, n, 0, stream);
}

}  // namespace
