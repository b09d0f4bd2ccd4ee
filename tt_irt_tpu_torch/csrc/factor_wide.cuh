// The wide tier of the four factor-family 'hi' kernels, for Hopper
// (sm_90a): dim_step, cdf_bracket_factor, factor_conditional and
// odim_step at every shape with 2 <= n <= 128 and 1 <= r <= 128 that
// their narrow tiers (dim_step.cu, factor_step.cu, factor_conditional.cu,
// odim_step.cu) refuse: n or r above 64, or a narrow shape whose staged
// factor and fk tile pass the 227 KB shared-memory opt-in
// (tc_smem_bytes; (33, 33)-(33, 64) or (17, 64), for example).
//
// Replaces, at those shapes, tt_irt_tpu/ops/pallas_dim.py::dim_step,
// pallas_step.py::cdf_bracket_factor, pallas_step.py::factor_conditional
// and pallas_odim.py::odim_step (their functions are documented in the
// narrow sources).
//
// What bounds it: the conditional, n r^2 multiply-adds a row (1.2M at
// n = 96, r = 128) against 4 (r + 11) bytes of row traffic; as 3xTF32 on
// the tensor cores 5.0 ms at 2^18 rows at (96, 128), 12.3 ms on the FP32
// CUDA cores.  A 128-row tile (as many rows as two warpgroups' registers
// hold) streams the whole split factor, 2 n r^2 floats, from L2 through
// shared memory: 25.8 GB a call at (96, 128) and 2^18 rows, about as long
// at L2's rate as the tensor-core bound.  The design:
//  - One launch ahead of the main kernel, on the same stream, splits the
//    factor once a call (split_factor_kernel): hi = tf32(x) rounded to
//    nearest even, lo = x - hi (tc_conditional.cuh's split_tf32), each
//    node's (r, r) block cut into units of at most 4 column groups (32
//    columns), each unit's hi and lo written in the K-major core-matrix
//    layout that wgmma reads without swizzle (unit_core_offset),
//    zero-padded to whole k-steps and groups, into scratch the caller
//    allocates (2 n nu 8 ks 8 nc floats: factor_wide_scratch_floats;
//    16.8 MB at (128, 128)).
//  - The main kernel is persistent, 384 threads a block: one thread of a
//    producer warpgroup streams the units in order through a ring of
//    shared-memory stages (one unit a stage, up to 6 stages) by
//    cp.async.bulk with mbarriers (full: the bytes landed; empty: the
//    eight consumer warps are done with it), so unit u+1 lands while
//    unit u is on the tensor cores, across nodes and tiles; two consumer
//    warpgroups take 64 rows of the 128-row tile each, with the
//    registers the producer warpgroup gives up (setmaxnreg: 240 a
//    consumer thread, 24 a producer one).
//  - A consumer keeps its rows of phi split into hi and lo in registers
//    as the A fragments of every k-step (8 ks registers, 128 at ks = 16)
//    and runs a unit as one commit group of wgmma.mma_async m64nNk8
//    .tf32 (N = 8 nc <= 32): lo.hi and hi.lo over every k-step into one
//    accumulator, hi.hi into at most four more, G = ceil(ks / 4)
//    consecutive k-steps each; then v = (((small + P0) + P1) + ...) in
//    f32 (round to nearest) and its squares, summed over the node's
//    units in column-group order, then across the lane quad (the narrow
//    tiers' reduce_half order).  The tensor core truncates as it
//    accumulates, so the narrow tiers give each k-step's hi.hi an
//    accumulator of its own; four parts keep fk about as accurate as the
//    plain f32 product (tests/test_torch_tf32_split.py models it; two
//    parts left dim_step's phin at 2.2x the plain version's error against
//    f64 at (128, 128)) at 5 accumulators of 16 registers.  The other
//    warpgroup's products overlap one's waits and squares.
//  - fk leaves the stage in the (n, 128) fk tile in shared memory; the
//    CDF, bracket and readout are row_common.cuh's, one thread a row on
//    the first warpgroup.  A bracket node whose fk is below kRecompute of
//    its row's largest is recomputed in f32 from phi and the factor in
//    global memory by the warp (warp_node_fk: lane j forms v_j by one FMA
//    chain over i, reading B's row coalesced; then one chain over j for
//    the squares, the chain of the narrow tiers' warp_node_fk), so
//    cdf_bracket_factor's out9 equals dim_step's bit for bit (the same
//    device functions, in the same order), and factor_conditional, which
//    recomputes every node below kRecompute by the same chain (a warp a
//    row), gives fk equal to dim_step's f1 and f2 at a row's bracket
//    nodes bit for bit.
//  - dim_step's prefix update sorts the tile's rows by cell in shared
//    memory (a counting sort on i0), and each warp takes 16 sorted rows
//    in batches of up to 4 of one cell: one read of C[i0] and C[i0+1]
//    serves the batch, 32 / L of its rows in flight before their FMAs
//    (L = 1, 2 or 4 columns a lane by the rank), each row one FMA chain
//    over i a column (the chain of step.cu's narrow condition_update),
//    divided by the max-abs over the row (floor 1e-30).  odim_step's
//    readout, la v[i0] + (1 - la) v[i0+1], is not in this kernel: the
//    stage writes each row's cell (i0, la) to memory, and
//    cell_readout.cu's kernel runs it next on the same stream, the rows
//    grouped by cell into dense 3xTF32 products on the units that this
//    launch's split left in the scratch (the slices S[x] of Q are its
//    node blocks).
// The ring, the split and the register trade are in tc_wide.cuh.
// tools/tc_variants.py --update-batches times the update's batching.
// tools/tc_variants.py --factor-wide --baseline DIR --other-arith times
// it against the tier's previous design (mma.sync, the factor split a
// tile) and holds both to the plain version run in f64; PERF.md.
//
// This header holds the kernels and their launch; the instances are
// built from two sources, one nvcc each, in parallel: factor_wide.cu
// (dim_step's and odim_step's stage, 12 instances) and
// factor_wide_cond.cu (cdf_bracket_factor's and factor_conditional's, 9).

#pragma once

#include "tc_wide.cuh"

namespace {

using namespace ttirt;

constexpr int kLanes = kWideMaxR / 32;   // columns a lane in the updates
constexpr int kBatch = 4;                // rows of one cell in an update

// Whether (n, r) goes to this tier: past the narrow tiers' caps or their
// shared memory.
inline bool factor_wide(int n, int r) {
  return !in_caps(n, r) || tc_smem_bytes(n, r) > kSmemOptIn;
}

// Shared memory besides the ring, in floats: the (n, 128) fk tile, and
// la, i0, the sorted rows, the cell counts and starts of the update.
__host__ __device__ inline int fixed_floats(int n) {
  return (n + 5) * kTcRows;
}

// Stages of the ring at (n, r): as many units as fit beside the rest,
// at most kMaxStages (at least 5 within the caps).
__host__ __device__ inline int ring_stages(int n, int r) {
  const long long room = static_cast<long long>(kSmemOptIn)
                         - 4LL * fixed_floats(n) - 16LL * kMaxStages;
  const long long s = room / (4LL * unit_floats(ksteps(r)));
  return s < kMaxStages ? static_cast<int>(s) : kMaxStages;
}

inline size_t wide_smem_bytes(int n, int r) {
  return 4 * (static_cast<size_t>(ring_stages(n, r))
                  * unit_floats(ksteps(r))
              + fixed_floats(n))
         + 16 * kMaxStages;
}

// The block's shared memory: the ring of unit stages, the fk tile, the
// tile's brackets (i0, la) and the update's sort, the ring's barriers.
struct Smem {
  float* ring;
  float* fk;
  float* la;
  int* i0;
  int* order;
  int* count;
  int* start;
  uint64_t* full;
  uint64_t* empty;
  int stages, unit;
  __device__ __forceinline__ Smem(float* smem, int n, int r)
      : stages(ring_stages(n, r)), unit(unit_floats(ksteps(r))) {
    ring = smem;
    fk = ring + stages * unit;
    la = fk + n * kTcRows;
    i0 = reinterpret_cast<int*>(la + kTcRows);
    order = i0 + kTcRows;
    count = order + kTcRows;
    start = count + kTcRows;
    full = reinterpret_cast<uint64_t*>(start + kTcRows);
    empty = full + kMaxStages;
  }
};

// The producer (one lane): every unit of every tile of this block, in
// the consumers' order, into the next free stage.
__device__ __forceinline__ void produce(const Smem& sm,
                                        const float* __restrict__ split,
                                        int m, int n, int r) {
  const int per_tile = n * node_units(ksteps(r));
  const int ntiles = (m + kTcRows - 1) / kTcRows;
  const uint32_t bytes = 4u * static_cast<uint32_t>(sm.unit);
  RingPos pos;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    for (int k = 0; k < per_tile; ++k) {
      mbar_wait(&sm.empty[pos.stage], pos.phase ^ 1u);
      mbar_expect_tx(&sm.full[pos.stage], bytes);
      bulk_load(sm.ring + static_cast<size_t>(pos.stage) * sm.unit,
                split + static_cast<size_t>(k) * sm.unit, bytes,
                &sm.full[pos.stage]);
      pos.next(sm.stages);
    }
  }
}

// ---- the conditional on the tensor cores ----

// fk of this warpgroup's 64 rows of the tile at every node into the fk
// tile, KSR k-steps (KSR <= KS, the fragments held).  A unit is one
// commit group: lo.hi and hi.lo of every k-step into `small`, hi.hi of
// k-steps s into part[s / G] (G k-steps a part, at most kParts parts);
// then v = (((small + P0) + P1) + ...) in f32 and its squares into the
// row sums.
template <int KSR, bool SWZ, int KS>
__device__ __forceinline__ void tile_conditional(
    const Smem& sm, RingPos& pos, const uint32_t (&ahi)[KS][4],
    const uint32_t (&alo)[KS][4], int n) {
  static_assert(KSR >= 1 && KSR <= KS, "k-steps past the fragments held");
  constexpr int NU = node_units(KSR);
  constexpr int NC = unit_groups(KSR);
  constexpr int G = (KSR + kParts - 1) / kParts;
  constexpr int NP = (KSR + G - 1) / G;
  constexpr uint32_t kPart = 4u * (8 * KSR) * (8 * NC);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int row = 64 * (threadIdx.x >> 7) + 16 * warp + (lane >> 2);
  const uint32_t ring = smem_u32(sm.ring);
  for (int x = 0; x < n; ++x) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int u = 0; u < NU; ++u) {
      float small[4 * NC], part[NP][4 * NC];
      zero(small);
#pragma unroll
      for (int p = 0; p < NP; ++p) zero(part[p]);
      mbar_wait(&sm.full[pos.stage], pos.phase);
      const uint32_t hi = ring + 4u * pos.stage * sm.unit;
      const uint32_t lo = hi + kPart;
      fence_regs(small);
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(part[p]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KSR; ++s)
        Wgmma<8 * NC>::mma(small, alo[s], unit_desc(hi, NC, s), s > 0);
#pragma unroll
      for (int s = 0; s < KSR; ++s)
        Wgmma<8 * NC>::mma(small, ahi[s], unit_desc(lo, NC, s), 1);
#pragma unroll
      for (int s = 0; s < KSR; ++s)
        Wgmma<8 * NC>::mma(part[s / G], ahi[s], unit_desc(hi, NC, s),
                           s % G != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(small);
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(part[p]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[pos.stage]);
      pos.next(sm.stages);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = small[4 * c + e];
#pragma unroll
          for (int p = 0; p < NP; ++p)
            v[e] = __fadd_rn(v[e], part[p][4 * c + e]);
        }
        s0 = fmaf(v[0], v[0], s0);
        s0 = fmaf(v[1], v[1], s0);
        s1 = fmaf(v[2], v[2], s1);
        s1 = fmaf(v[3], v[3], s1);
      }
    }
    s0 += __shfl_xor_sync(0xFFFFFFFFu, s0, 1);
    s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, 1);
    s0 += __shfl_xor_sync(0xFFFFFFFFu, s0, 2);
    s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, 2);
    if ((lane & 3) == 0) {
      sm.fk[fk_at<SWZ>(x, row)] = s0;
      sm.fk[fk_at<SWZ>(x, row + 8)] = s1;
    }
  }
}

#define TTIRT_KSR(K) \
  case K: tile_conditional<K, SWZ, KS>(sm, pos, ahi, alo, n); break;

// fk of the tile at row0 at every node into the fk tile, by the two
// consumer warpgroups (every consumer thread calls it; it returns after
// their barrier, with the tile complete).
template <bool SWZ, int KS>
__device__ __forceinline__ void consumer_stage(const Smem& sm, RingPos& pos,
                                               const float* __restrict__ phi,
                                               long long row0, int m, int n,
                                               int r) {
  uint32_t ahi[KS][4], alo[KS][4];
  load_a_split<KS>(ahi, alo, phi, row0, threadIdx.x >> 7, m, r);
  consumer_sync();                  // the last tile's fk tile is done with
  if constexpr (KS == 4) {
    switch (ksteps(r)) { TTIRT_KSR(1) TTIRT_KSR(2) TTIRT_KSR(3)
                         default: TTIRT_KSR(4) }
  } else if constexpr (KS == 8) {
    switch (ksteps(r)) { TTIRT_KSR(5) TTIRT_KSR(6) TTIRT_KSR(7)
                         default: TTIRT_KSR(8) }
  } else {
    switch (ksteps(r)) { TTIRT_KSR(9) TTIRT_KSR(10) TTIRT_KSR(11)
                         TTIRT_KSR(12) TTIRT_KSR(13) TTIRT_KSR(14)
                         TTIRT_KSR(15) default: TTIRT_KSR(16) }
  }
  consumer_sync();                  // every row's fk at every node
}

#undef TTIRT_KSR

// ---- the f32 recompute and the CDF stage ----

// pv[u] = p[lane + 32 u] (0 past r).
template <int L>
__device__ __forceinline__ void load_lanes(float (&pv)[L],
                                           const float* __restrict__ p,
                                           int r) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < L; ++u) {
    const int j = lane + 32 * u;
    pv[u] = j < r ? p[j] : 0.0f;
  }
}

// fk of one row at node x in f32 on the CUDA cores, by the whole warp
// (pv: the row's phi as load_lanes leaves it): lane j forms v_j by one
// FMA chain over i in order, reading B_x's row i coalesced from global
// memory, then every lane forms sum_j v_j^2 by one FMA chain over j in
// order (TcStage::warp_node_fk's chains).
__device__ __forceinline__ float warp_node_fk(const float (&pv)[kLanes],
                                              const float* __restrict__ bmat,
                                              int n, int r, int x) {
  const int lane = threadIdx.x & 31;
  const size_t nr = static_cast<size_t>(n) * r;
  const float* bx = bmat + static_cast<size_t>(x) * r;
  float v[kLanes];
#pragma unroll
  for (int u = 0; u < kLanes; ++u) v[u] = 0.0f;
#pragma unroll
  for (int u0 = 0; u0 < kLanes; ++u0) {
    for (int l = 0; l < 32; ++l) {
      const int i = 32 * u0 + l;
      if (i >= r) break;
      const float pi = __shfl_sync(0xFFFFFFFFu, pv[u0], l);
      const float* bi = bx + i * nr;
#pragma unroll
      for (int u = 0; u < kLanes; ++u) {
        const int j = lane + 32 * u;
        if (j < r) v[u] = fmaf(pi, bi[j], v[u]);
      }
    }
  }
  float f = 0.0f;
#pragma unroll
  for (int u = 0; u < kLanes; ++u) {
    for (int l = 0; l < 32; ++l) {
      if (32 * u + l >= r) break;
      const float vj = __shfl_sync(0xFFFFFFFFu, v[u], l);
      f = fmaf(vj, vj, f);
    }
  }
  return f;
}

// The CDF stage of tile row tid (< kTcRows; live: row < m) on its fk
// column: cdf_bracket, then f1 or f2 below kRecompute of the row's
// largest fk recomputed by warp_node_fk (TcStage::bracket's rule).
// Every thread of the warp calls it.
template <bool RT>
__device__ __forceinline__ Bracket wide_bracket(
    const Smem& sm, int tid, bool live, const float* __restrict__ phi,
    long long row, const float* __restrict__ bmat,
    const float* __restrict__ h, const float* __restrict__ xg, int n, int r,
    float q, float um) {
  const int lane = threadIdx.x & 31;
  Bracket b{};
  int need = 0;                     // bit 0: f1, bit 1: f2
  if (live) {
    const float* fcol = sm.fk + tid;
    b = cdf_bracket<RT>(fcol, kTcRows, h, xg, n, q, um);
    if (!b.flat) {
      float fmax = 0.0f;
      for (int k = 0; k < n; ++k) fmax = fmaxf(fmax, fcol[k * kTcRows]);
      const float tiny = kRecompute * fmax;
      need = (b.f1 < tiny ? 1 : 0) | (b.f2 < tiny ? 2 : 0);
    }
  }
  unsigned todo = __ballot_sync(0xFFFFFFFFu, need != 0);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const long long rs = __shfl_sync(0xFFFFFFFFu, row, src);
    const int is = __shfl_sync(0xFFFFFFFFu, b.i0, src);
    const int which = __shfl_sync(0xFFFFFFFFu, need, src);
    float pv[kLanes];
    load_lanes(pv, phi + rs * r, r);
    if (which & 1) {
      const float f = warp_node_fk(pv, bmat, n, r, is);
      if (lane == src) b.f1 = f;
    }
    if (which & 2) {
      const float f = warp_node_fk(pv, bmat, n, r, is + 1);
      if (lane == src) b.f2 = f;
    }
  }
  return b;
}

// ---- the prefix updates ----

// dim_step's: phi' = phi (la C[i0] + (1 - la) C[i0+1]) / max-abs, each
// column one FMA chain over i in order (prefix_update's chain), for
// the tile's rows sorted by cell so that one read of the two (r, r)
// slices (cmat (n, r*r)) serves a batch of up to kBatch rows of a cell.
// An instance of KS k-steps gives a lane L = KS / 4 columns.
struct CoreUpdate {
  template <int KS>
  __device__ __forceinline__ static void tile(const Smem& sm,
                                              const float* __restrict__ phi,
                                              const float* __restrict__ cmat,
                                              float* __restrict__ phin,
                                              long long row0, int m, int n,
                                              int r) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long left = m - row0;
    const int rows = static_cast<int>(left < kTcRows ? left : kTcRows);
    const int cells = n - 1;
    for (int c = tid; c < cells; c += kConsumers) sm.count[c] = 0;
    consumer_sync();
    int rank = 0;
    if (tid < rows) rank = atomicAdd(&sm.count[sm.i0[tid]], 1);
    consumer_sync();
    if (warp == 0) {                // the cells' starts, 4 cells a lane
      int c4[4], sum = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 4 * lane + k;
        c4[k] = c < cells ? sm.count[c] : 0;
        sum += c4[k];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xFFFFFFFFu, incl, off);
        if (lane >= off) incl += t;
      }
      int run = incl - sum;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 4 * lane + k;
        if (c < cells) sm.start[c] = run;
        run += c4[k];
      }
    }
    consumer_sync();
    if (tid < rows) sm.order[sm.start[sm.i0[tid]] + rank] = tid;
    consumer_sync();
    const int end = min(16 * warp + 16, rows);
    for (int p = 16 * warp; p < end;) {
      const int x = sm.i0[sm.order[p]];
      int cnt = 1;
      while (cnt < kBatch && p + cnt < end && sm.i0[sm.order[p + cnt]] == x)
        ++cnt;
      batch<KS / 4>(sm, phi, cmat, phin, row0, r, p, cnt, x);
      p += cnt;
    }
  }

  // The rows at sorted positions p .. p + cnt - 1, all of cell x (a
  // short batch repeats its first row and stores kBatch - cnt fewer: no
  // branch among the FMAs); rows i of C[x] and C[x+1] are read D = 32 / L
  // at a time, all loaded before their FMAs (2 D L = 64 registers).  The
  // loop's body, not its bytes, sets the time: larger batches are slower
  // (tools/tc_variants.py --update-batches; PERF.md).
  template <int L>
  __device__ __forceinline__ static void batch(const Smem& sm,
                                               const float* __restrict__ phi,
                                               const float* __restrict__ cmat,
                                               float* __restrict__ phin,
                                               long long row0, int r, int p,
                                               int cnt, int x) {
    constexpr int D = 32 / L;
    const int lane = threadIdx.x & 31;
    int row[kBatch];
    float la[kBatch], lb[kBatch], pv[kBatch][L], acc[kBatch][L];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      row[k] = sm.order[p + (k < cnt ? k : 0)];
      la[k] = sm.la[row[k]];
      lb[k] = 1.0f - la[k];
      load_lanes(pv[k], phi + (row0 + row[k]) * r, r);
#pragma unroll
      for (int u = 0; u < L; ++u) acc[k][u] = 0.0f;
    }
    const size_t rr = static_cast<size_t>(r) * r;
    const float* ca = cmat + x * rr;
    const float* cb = ca + rr;
#pragma unroll
    for (int u0 = 0; u0 < L; ++u0) {
      for (int l0 = 0; l0 < 32 && 32 * u0 + l0 < r; l0 += D) {
        float a[D][L], b[D][L];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const int i = 32 * u0 + l0 + d;
#pragma unroll
          for (int u = 0; u < L; ++u) {
            const int j = lane + 32 * u;
            const bool in = i < r && j < r;
            a[d][u] = in ? ca[i * r + j] : 0.0f;
            b[d][u] = in ? cb[i * r + j] : 0.0f;
          }
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
          if (32 * u0 + l0 + d < r) {
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
              const float pi = __shfl_sync(0xFFFFFFFFu, pv[k][u0], l0 + d);
#pragma unroll
              for (int u = 0; u < L; ++u)
                acc[k][u] = fmaf(pi, la[k] * a[d][u] + lb[k] * b[d][u],
                                 acc[k][u]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (k < cnt) store_row(acc[k], phin + (row0 + row[k]) * r, r);
  }

  // acc / max-abs over the row (floor 1e-30) into out (r,).
  template <int L>
  __device__ __forceinline__ static void store_row(const float (&acc)[L],
                                                   float* __restrict__ out,
                                                   int r) {
    const int lane = threadIdx.x & 31;
    float scale = 0.0f;
#pragma unroll
    for (int u = 0; u < L; ++u)
      if (lane + 32 * u < r) scale = fmaxf(scale, fabsf(acc[u]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      scale = fmaxf(scale, __shfl_xor_sync(0xFFFFFFFFu, scale, off));
    const float denom = fmaxf(scale, 1e-30f);
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const int j = lane + 32 * u;
      if (j < r) out[j] = acc[u] / denom;
    }
  }
};

// odim_step's stage ends with each row's cell: i0 (int32) into cell[row]
// and the f32 weight la into cell[m + row] (`out`, 2m words), for the
// cell-grouped readout that follows on the same stream
// (cell_readout.cu: la v[i0] + (1 - la) v[i0+1] on the tensor cores from
// the split that this launch leaves in its scratch).
struct CellWeights {
  template <int KS>
  __device__ __forceinline__ static void tile(const Smem& sm,
                                              const float* __restrict__ phi,
                                              const float* __restrict__ qmat,
                                              float* __restrict__ out,
                                              long long row0, int m, int n,
                                              int r) {
    (void)phi, (void)qmat, (void)n, (void)r;
    const int tid = threadIdx.x;
    const long long row = row0 + tid;
    if (tid < kTcRows && row < m) {
      reinterpret_cast<int*>(out)[row] = sm.i0[tid];
      out[m + row] = sm.la[tid];
    }
  }
};

// ---- the kernels ----

// dim_step (Update = CoreUpdate, slices = cmat) and odim_step's stage
// (Update = CellWeights, slices = bmat = Q): phi (m, r), qp/um (m,), bmat
// (r, n*r), split (the factor as split_factor_kernel leaves it), h
// (n-1,), xg (2, n) -> out9 (m, 9) and phin (m, r), or for CellWeights
// each row's cell (2m words).
template <bool RT, class Update, int KS>
__global__ void __launch_bounds__(kBlock, 1)
dim_wide_kernel(const float* __restrict__ phi, const float* __restrict__ qp,
                const float* __restrict__ um, const float* __restrict__ bmat,
                const float* __restrict__ slices, const float* __restrict__ h,
                const float* __restrict__ xg, const float* __restrict__ split,
                float* __restrict__ phin, float* __restrict__ out9, int m,
                int n, int r) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm(smem, n, r);
  init_ring(sm.full, sm.empty, sm.stages);
  if (threadIdx.x >= kConsumers) {
    producer_registers<KS>();
    if (threadIdx.x == kConsumers) produce(sm, split, m, n, r);
    return;
  }
  consumer_registers<KS>();
  const int tid = threadIdx.x;
  const int ntiles = (m + kTcRows - 1) / kTcRows;
  RingPos pos;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * kTcRows;
    consumer_stage<false, KS>(sm, pos, phi, row0, m, n, r);
    if (tid < kTcRows) {            // the first warpgroup: a thread a row
      const long long row = row0 + tid;
      const bool live = row < m;
      const float q = live ? qp[row] : 0.0f;
      const Bracket b = wide_bracket<RT>(
          sm, tid, live, phi, row, bmat, h, xg, n, r, q,
          (RT || !live) ? 0.0f : um[row]);
      if (live) {
        write_out9(out9 + row * 9, b, xg + n);
        sm.i0[tid] = b.i0;
        sm.la[tid] = cell_weight<RT>(b, q);
      }
    }
    consumer_sync();                // every row's bracket and weight
    Update::template tile<KS>(sm, phi, slices, phin, row0, m, n, r);
  }
}

// cdf_bracket_factor: phi (m, r), qp (m,), bmat, split, h, xg -> out9
// (m, 9), i0 (m,) int32; the right-tail target from f32(1 - qp).
template <bool RT, int KS>
__global__ void __launch_bounds__(kBlock, 1)
bracket_wide_kernel(const float* __restrict__ phi,
                    const float* __restrict__ qp,
                    const float* __restrict__ bmat,
                    const float* __restrict__ h,
                    const float* __restrict__ xg,
                    const float* __restrict__ split, float* __restrict__ out9,
                    int* __restrict__ i0, int m, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm(smem, n, r);
  init_ring(sm.full, sm.empty, sm.stages);
  if (threadIdx.x >= kConsumers) {
    producer_registers<KS>();
    if (threadIdx.x == kConsumers) produce(sm, split, m, n, r);
    return;
  }
  consumer_registers<KS>();
  const int tid = threadIdx.x;
  const int ntiles = (m + kTcRows - 1) / kTcRows;
  RingPos pos;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * kTcRows;
    consumer_stage<false, KS>(sm, pos, phi, row0, m, n, r);
    if (tid < kTcRows) {
      const long long row = row0 + tid;
      const bool live = row < m;
      const float q = live ? qp[row] : 0.0f;
      const Bracket b = wide_bracket<RT>(sm, tid, live, phi, row, bmat, h,
                                         xg, n, r, q, __fsub_rn(1.0f, q));
      if (live) {
        write_out9(out9 + row * 9, b, xg + n);
        i0[row] = b.i0;
      }
    }
  }
}

// factor_conditional: phi (m, r), bmat (r, n*r), split -> fk (m, n).
// Every node below kRecompute of its row's largest is recomputed by
// warp_node_fk (a warp a row), then the tile leaves as the contiguous
// (rows, n) block (the fk tile swizzled per node, fk_at<true>, so that a
// warp's transposed read meets 32 banks).
template <int KS>
__global__ void __launch_bounds__(kBlock, 1)
conditional_wide_kernel(const float* __restrict__ phi,
                        const float* __restrict__ bmat,
                        const float* __restrict__ split,
                        float* __restrict__ fk_out, int m, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm(smem, n, r);
  init_ring(sm.full, sm.empty, sm.stages);
  if (threadIdx.x >= kConsumers) {
    producer_registers<KS>();
    if (threadIdx.x == kConsumers) produce(sm, split, m, n, r);
    return;
  }
  consumer_registers<KS>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (m + kTcRows - 1) / kTcRows;
  RingPos pos;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * kTcRows;
    consumer_stage<true, KS>(sm, pos, phi, row0, m, n, r);
    const long long left = m - row0;
    const int rows = static_cast<int>(left < kTcRows ? left : kTcRows);
    for (int trow = warp; trow < rows; trow += kConsumerWarps) {
      float fmax = 0.0f;
      for (int x = lane; x < n; x += 32)
        fmax = fmaxf(fmax, sm.fk[fk_at<true>(x, trow)]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        fmax = fmaxf(fmax, __shfl_xor_sync(0xFFFFFFFFu, fmax, off));
      const float tiny = kRecompute * fmax;
      float pv[kLanes];
      load_lanes(pv, phi + (row0 + trow) * r, r);
      for (int xb = 0; xb < n; xb += 32) {
        const int x = xb + lane;
        unsigned todo = __ballot_sync(
            0xFFFFFFFFu, x < n && sm.fk[fk_at<true>(x, trow)] < tiny);
        while (todo) {
          const int src = __ffs(todo) - 1;
          todo &= todo - 1;
          const float f = warp_node_fk(pv, bmat, n, r, xb + src);
          if (lane == src) sm.fk[fk_at<true>(x, trow)] = f;
        }
      }
    }
    consumer_sync();                 // every row's nodes final
    float* out = fk_out + row0 * n;
    for (int f = tid; f < rows * n; f += kConsumers) {
      const int i = f / n;
      out[f] = sm.fk[fk_at<true>(f - i * n, i)];
    }
  }
}

// The split, then a persistent launch of kern at (m, n, r): kBlock
// threads and wide_smem_bytes(n, r) a block, one 128-row tile a block at
// a time (one block an SM: the registers and shared memory).
cudaError_t wide_launch(const void* kern, void** args, const float* bmat,
                        float* split, int m, int n, int r, int device,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = split_launch(bmat, split, n, r, r,
                               static_cast<long long>(n) * r, s);
  if (e != cudaSuccess) return e;
  const size_t smem = wide_smem_bytes(n, r);
  int cap = 0;
  e = grid_cap(kern, device, smem, &cap, kBlock);
  if (e != cudaSuccess) return e;
  const int tiles = (m + kTcRows - 1) / kTcRows;
  return cudaLaunchKernel(kern, dim3(tiles < cap ? tiles : cap),
                          dim3(kBlock), args, smem, s);
}

template <class Update>
int dim_like_launch(const void* phi, const void* qp, const void* um,
                    const void* bmat, const void* slices, const void* h,
                    const void* xg, void* phin, void* out9, int m, int n,
                    int r, int rt, int device, void* stream, void* scratch) {
  if (m == 0) return 0;
  if (!in_wide_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  const float* p[7];
  const void* in[7] = {phi, qp, um, bmat, slices, h, xg};
  for (int k = 0; k < 7; ++k) p[k] = static_cast<const float*>(in[k]);
  const float* sp = static_cast<const float*>(scratch);
  float* pn = static_cast<float*>(phin);
  float* o = static_cast<float*>(out9);
  void* args[] = {&p[0], &p[1], &p[2], &p[3], &p[4], &p[5], &p[6], &sp, &pn,
                  &o, &m, &n, &r};
  const void* kern = nullptr;
  TTIRT_FOR_KSTEPS(r, kern = rt ? reinterpret_cast<const void*>(
                                      &dim_wide_kernel<true, Update, KS>)
                                : reinterpret_cast<const void*>(
                                      &dim_wide_kernel<false, Update, KS>));
  return static_cast<int>(wide_launch(kern, args, p[3],
                                      static_cast<float*>(scratch), m, n, r,
                                      device, stream));
}

}  // namespace

