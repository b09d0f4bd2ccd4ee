// The Gram stage of the Gram family's wide tiers, for Hopper (sm_90a):
// gram_wide.cu (gram_conditional past its narrow tier) and fused_wide.cu
// (the whole transform past its narrow tier) run their Gram contraction
//   fk[m, x] = sum_ij phi[m, i] P[i*r + j, x] phi[m, j]
// through these device functions, on tc_wide.cuh's split, ring and
// register trade (the stage of factor_wide.cu, with a Gram epilogue in
// place of the squares).
//
// The design (tools/tc_probe.cu::gram_tc, "design (a)", on the wide
// tier's stage):
//  - P is read as the factor form P~[i, x*r + j] = P[i*r + j, x]: node x's
//    (r, r) block P_x is split once a call into tf32 hi and lo units of at
//    most 32 columns in wgmma's K-major layout (split_factor_kernel at the
//    Gram field's strides: gram_split_launch), so that v[x, j] = sum_i
//    phi_i P_x[i, j] is the product of the factor stage.
//  - A 128-row tile's phi is kept twice in shared memory's view of the
//    consumers: split into hi and lo as the wgmma A fragments of every
//    k-step (registers, 8 ks a thread), and in f32 in a tile of pitch
//    gram_pitch (8 mod 32: the epilogue's float2 reads of a half-warp meet
//    32 banks), which the epilogue reads at its accumulator positions
//    (columns 8c + 2t, +1 of rows g and g + 8).  Beside 128 fragment and
//    80 accumulator registers at rank 128 those 64 values would not fit a
//    thread's registers; read from the tile they cost two float2 loads a
//    column group.
//  - A unit is one commit group of wgmma.mma_async m64nNk8 .tf32 (N = 8
//    nc <= 32): lo.hi and hi.lo over every k-step into one accumulator,
//    hi.hi into at most PARTS more of ceil(ks / PARTS) k-steps each (the
//    tensor core truncates as it accumulates), then v = (((small + P0) +
//    P1) + ...) in f32, formed where it is used (unit_products and
//    unit_value, which fused_wide.cu's prefix update also runs on the
//    core's units).  Both kernels take four parts in the Gram stage, the
//    factor stage's; fused_wide.cu's update one.  The CPU model holds
//    every count used to the card's bar.
//  - The Gram epilogue: per row, f = fmaf(v_j, phi_j, f) over the unit's
//    columns in column-group order, over the node's units in order, then
//    the lane quad's four sums as (s0 + s1) + (s2 + s3) by two shuffles;
//    fk[x] goes to the (n, 128) fk tile (tests/test_torch_tf32_split.py::
//    gram_wide_model is this arithmetic on the CPU).
// Every row's fk depends on its own row of phi and on P only: the zero
// padding of k-steps, column groups and rows past m adds exact zeros.

#pragma once

#include "tc_wide.cuh"

namespace {

using namespace ttirt;

// Columns of a node's units (8 nu nc >= 8 ks, the zero-padded groups
// included) and the pitch of the f32 phi tile: the least multiple of 32
// plus 8 that holds them.
__host__ __device__ constexpr int gram_cols(int ks) {
  return 8 * node_units(ks) * unit_groups(ks);
}
__host__ __device__ constexpr int gram_pitch(int ks) {
  return 32 * ((gram_cols(ks) + 23) / 32) + 8;
}
__host__ __device__ inline int phi_tile_floats(int r) {
  return kTcRows * gram_pitch(ksteps(r));
}

// The split of `fields` Gram fields P (r*r, n), each r*r*n floats after
// the last (fused_wide.cu's p2 (d, r*r, n)), into `split` (fields *
// split_floats(n, r) floats): node x of field k is unit row k*n + x.
inline cudaError_t gram_split_launch(const float* pmat, float* split,
                                     int fields, int n, int r,
                                     cudaStream_t stream) {
  return split_nodes_launch(pmat, split, fields * n, r, 1,
                            static_cast<long long>(r) * n, n, n,
                            static_cast<long long>(r) * r * n, stream);
}

// The ring of unit stages in shared memory (tc_wide.cuh's barriers).
struct Ring {
  float* base;
  uint64_t* full;
  uint64_t* empty;
  int stages, unit;
};

// Stages of the ring beside `fixed` floats of the rest (and the
// barriers): as many units of rank r as fit, at most kMaxStages (at
// least 2 within the caps).
__host__ __device__ inline int gram_ring_stages(long long fixed, int r) {
  const long long room = static_cast<long long>(kSmemOptIn) - 4LL * fixed
                         - 16LL * kMaxStages - 16;
  const long long s = room / (4LL * unit_floats(ksteps(r)));
  return s < kMaxStages ? static_cast<int>(s) : kMaxStages;
}

// The producer (one lane): `count` consecutive units from src, each into
// the next free stage.
__device__ __forceinline__ void stream_units(const Ring& rg, RingPos& pos,
                                             const float* __restrict__ src,
                                             int count) {
  const uint32_t bytes = 4u * static_cast<uint32_t>(rg.unit);
  for (int k = 0; k < count; ++k) {
    mbar_wait(&rg.empty[pos.stage], pos.phase ^ 1u);
    mbar_expect_tx(&rg.full[pos.stage], bytes);
    bulk_load(rg.base + static_cast<size_t>(pos.stage) * rg.unit,
              src + static_cast<size_t>(k) * rg.unit, bytes,
              &rg.full[pos.stage]);
    pos.next(rg.stages);
  }
}

// Run the statement with the constant KSR set to the k-steps of rank r
// (ks, runtime) among those an instance of KS fragments takes.
#define TTIRT_KSR_CASE(K, ...) \
  case K: { constexpr int KSR = K; __VA_ARGS__; } break;
#define TTIRT_WITH_KSR(KS, ks, ...)                                        \
  if constexpr ((KS) == 4) {                                               \
    switch (ks) { TTIRT_KSR_CASE(1, __VA_ARGS__)                           \
                  TTIRT_KSR_CASE(2, __VA_ARGS__)                           \
                  TTIRT_KSR_CASE(3, __VA_ARGS__)                           \
                  default: { constexpr int KSR = 4; __VA_ARGS__; } }       \
  } else if constexpr ((KS) == 8) {                                        \
    switch (ks) { TTIRT_KSR_CASE(5, __VA_ARGS__)                           \
                  TTIRT_KSR_CASE(6, __VA_ARGS__)                           \
                  TTIRT_KSR_CASE(7, __VA_ARGS__)                           \
                  default: { constexpr int KSR = 8; __VA_ARGS__; } }       \
  } else {                                                                 \
    switch (ks) { TTIRT_KSR_CASE(9, __VA_ARGS__)                           \
                  TTIRT_KSR_CASE(10, __VA_ARGS__)                          \
                  TTIRT_KSR_CASE(11, __VA_ARGS__)                          \
                  TTIRT_KSR_CASE(12, __VA_ARGS__)                          \
                  TTIRT_KSR_CASE(13, __VA_ARGS__)                          \
                  TTIRT_KSR_CASE(14, __VA_ARGS__)                          \
                  TTIRT_KSR_CASE(15, __VA_ARGS__)                          \
                  default: { constexpr int KSR = 16; __VA_ARGS__; } }      \
  }

// The tile rows of this thread's accumulator fragments: g and g + 8 of
// its warp's 16 rows of its warpgroup's 64.
__device__ __forceinline__ int frag_row() {
  return 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3)
         + ((threadIdx.x & 31) >> 2);
}

// Rows row0 .. row0 + 127 of phi (m, r) into the tile, zero past m and
// from column r to `cols`; by the consumer threads.
__device__ __forceinline__ void stage_rows(float* tile, int pitch,
                                           const float* __restrict__ phi,
                                           long long row0, int m, int r,
                                           int cols) {
  for (int e = threadIdx.x; e < kTcRows * cols; e += kConsumers) {
    const int i = e / cols, j = e - i * cols;
    const long long row = row0 + i;
    tile[i * pitch + j] = (row < m && j < r) ? phi[row * r + j] : 0.0f;
  }
}

// This warpgroup's 64 rows of the f32 tile as the wgmma A fragments of
// every k-step below ks, split into hi and lo (zero from ks to KS).  A
// warp reads its own 16 rows.
template <int KS>
__device__ __forceinline__ void load_a_tile(uint32_t (&hi)[KS][4],
                                            uint32_t (&lo)[KS][4],
                                            const float* tile, int pitch,
                                            int ks) {
  const int lane = threadIdx.x & 31;
  const int base = frag_row();
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = base + 8 * (e & 1);
      const int col = 8 * s + (lane & 3) + 4 * (e >> 1);
      const float v = s < ks ? tile[row * pitch + col] : 0.0f;
      split_tf32(v, hi[s][e], lo[s][e]);
    }
  }
}

// The accumulators of one unit of KSR k-steps with hi.hi in at most
// PARTS parts.
template <int KSR, int PARTS>
struct UnitShape {
  static constexpr int NU = node_units(KSR);
  static constexpr int NC = unit_groups(KSR);
  static constexpr int G = (KSR + PARTS - 1) / PARTS;  // k-steps a part
  static constexpr int NP = (KSR + G - 1) / G;         // parts
  static constexpr uint32_t kPartBytes = 4u * (8 * KSR) * (8 * NC);
};

// The products of this warpgroup's rows and the unit whose hi part is at
// shared address `hi` (its lo part after it), waited for: one commit
// group of wgmma, lo.hi and hi.lo into `small`, hi.hi into the NP
// `part`s; element 4c + e of each is row g + 8 (e >> 1), column 8c + 2t
// + (e & 1).  unit_value sums them.
template <int KSR, int PARTS, int KS>
__device__ __forceinline__ void unit_products(
    float (&small)[4 * unit_groups(KSR)],
    float (&part)[UnitShape<KSR, PARTS>::NP][4 * unit_groups(KSR)],
    const uint32_t (&ahi)[KS][4], const uint32_t (&alo)[KS][4],
    uint32_t hi) {
  static_assert(KSR >= 1 && KSR <= KS, "k-steps past the fragments held");
  using S = UnitShape<KSR, PARTS>;
  zero(small);
#pragma unroll
  for (int p = 0; p < S::NP; ++p) zero(part[p]);
  const uint32_t lo = hi + S::kPartBytes;
  fence_regs(small);
#pragma unroll
  for (int p = 0; p < S::NP; ++p) fence_regs(part[p]);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KSR; ++s)
    Wgmma<8 * S::NC>::mma(small, alo[s], unit_desc(hi, S::NC, s), s > 0);
#pragma unroll
  for (int s = 0; s < KSR; ++s)
    Wgmma<8 * S::NC>::mma(small, ahi[s], unit_desc(lo, S::NC, s), 1);
#pragma unroll
  for (int s = 0; s < KSR; ++s)
    Wgmma<8 * S::NC>::mma(part[s / S::G], ahi[s], unit_desc(hi, S::NC, s),
                          s % S::G != 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(small);
#pragma unroll
  for (int p = 0; p < S::NP; ++p) fence_regs(part[p]);
}

// Element e of v = phi U: (((small + P0) + P1) + ...) in f32.  Formed
// where it is used, so that the accumulators die one by one.
template <int NP, int W>
__device__ __forceinline__ float unit_value(const float (&small)[W],
                                            const float (&part)[NP][W],
                                            int e) {
  float v = small[e];
#pragma unroll
  for (int p = 0; p < NP; ++p) v = __fadd_rn(v, part[p][e]);
  return v;
}

// The ring's current unit: wait for it to land, its products, release
// the stage to the producer (every consumer warp arrives), advance.  (No
// wgmma under a branch: ptxas then serialized the products and spilled.)
template <int KSR, int PARTS, int KS>
__device__ __forceinline__ void ring_unit(
    const Ring& rg, RingPos& pos, float (&small)[4 * unit_groups(KSR)],
    float (&part)[UnitShape<KSR, PARTS>::NP][4 * unit_groups(KSR)],
    const uint32_t (&ahi)[KS][4], const uint32_t (&alo)[KS][4]) {
  mbar_wait(&rg.full[pos.stage], pos.phase);
  unit_products<KSR, PARTS, KS>(
      small, part, ahi, alo, smem_u32(rg.base) + 4u * pos.stage * rg.unit);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&rg.empty[pos.stage]);
  pos.next(rg.stages);
}

// The Gram stage: fk of this warpgroup's 64 rows of the tile at every
// node x < n into the fk tile (fk_at<SWZ>), from the ring's next n nu
// units (P~'s node blocks in order) and the f32 tile (pitch) of the
// rows whose split the fragments hold; hi.hi in at most PARTS parts.
template <int KSR, int PARTS, bool SWZ, int KS>
__device__ __forceinline__ void gram_nodes(const Ring& rg, RingPos& pos,
                                           const uint32_t (&ahi)[KS][4],
                                           const uint32_t (&alo)[KS][4],
                                           const float* tile, int pitch,
                                           float* fk, int n) {
  using S = UnitShape<KSR, PARTS>;
  const int lane = threadIdx.x & 31;
  const int row = frag_row();
  const float* p0 = tile + row * pitch + 2 * (lane & 3);
  const float* p1 = p0 + 8 * pitch;
  for (int x = 0; x < n; ++x) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int u = 0; u < S::NU; ++u) {
      float small[4 * S::NC], part[S::NP][4 * S::NC];
      ring_unit<KSR, PARTS, KS>(rg, pos, small, part, ahi, alo);
#pragma unroll
      for (int c = 0; c < S::NC; ++c) {
        const int col = 8 * (S::NC * u + c);
        const float2 a = *reinterpret_cast<const float2*>(p0 + col);
        const float2 b = *reinterpret_cast<const float2*>(p1 + col);
        s0 = fmaf(unit_value(small, part, 4 * c), a.x, s0);
        s0 = fmaf(unit_value(small, part, 4 * c + 1), a.y, s0);
        s1 = fmaf(unit_value(small, part, 4 * c + 2), b.x, s1);
        s1 = fmaf(unit_value(small, part, 4 * c + 3), b.y, s1);
      }
    }
    s0 += __shfl_xor_sync(0xFFFFFFFFu, s0, 1);
    s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, 1);
    s0 += __shfl_xor_sync(0xFFFFFFFFu, s0, 2);
    s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, 2);
    if ((lane & 3) == 0) {
      fk[fk_at<SWZ>(x, row)] = s0;
      fk[fk_at<SWZ>(x, row + 8)] = s1;
    }
  }
}

}  // namespace
