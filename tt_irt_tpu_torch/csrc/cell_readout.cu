// The prefix update past n or r of 64 as a cell-grouped product on the
// tensor cores, for Hopper (sm_90a):
//   phi'[m] = (la[m] v_a[m] + lb[m] v_b[m]) / max_j |.|  (floor 1e-30),
//   v_a[m] = phi[m] S[x],  v_b[m] = phi[m] S[x+1],  x = clip(i0[m], 0, n-2),
// for S the n (r, r) slices of the core C (n, r*r) or of the factor Q
// (r, n*r), 2 <= n <= 128, 1 <= r <= 128.
//
// Replaces tt_irt_tpu/ops/pallas_step.py::condition_update (:238,
// _update_kernel; S = C, la and lb given) at every shape that step.cu's
// update_wide routes past its narrow tier (n or r above 64), and the
// readout of tt_irt_tpu/ops/pallas_odim.py::odim_step (:230; S = Q's node
// blocks, lb = 1 - la) past its narrow tier, after factor_wide.cu's stage
// (the bracket) has written each row's cell and weight.
//
// What bounds it: a row needs 2 r^2 multiply-adds against 8 r bytes of
// phi in and phi' out.  Row by row (a warp a row, each reading its own
// two slices from L2: the first port's design) that was 2 r^2 floats of
// L2 reads a row, 19 GB at (33, 96) and 2^18 rows, and an FP32 chain a
// column; grouped by cell, it is a dense product: the rows of one cell
// times [S[x] | S[x+1]] (r, 2r), as 3xTF32 on the tensor cores (three
// products; at 495 TFLOP/s 0.104 ms at 2^18 rows and r = 128), with the
// bytes of phi and phi' at HBM's rate (0.062 ms at r = 96) and the slices
// read from L2 once a 128-row tile.  The design:
//  - A counting sort of the rows by cell, by hand (no library sort):
//    count_cells_kernel takes a block histogram of the clipped cells in
//    shared memory and adds it to the global counts; plan_tiles_kernel
//    (one block) scans the counts and lists the tiles, up to 128 rows of
//    one cell each, the last of a cell ragged (at most n - 1 more than
//    m / 128 in all, whatever the skew); scatter_rows_kernel ranks each
//    block's rows per cell in shared memory, reserves each cell's range
//    by one atomic a block and scatters the row indices into the
//    permutation.  The rows' order within a cell is whatever the atomics
//    give: every row's arithmetic is its own.
//  - The slices split once a call into tf32 hi and lo units in wgmma's
//    K-major layout (tc_wide.cuh's split_factor_kernel, C's strides);
//    odim_step's readout reuses the split of Q that its stage has just
//    made (factor_wide.cu), so nothing is split twice.
//  - The main kernel is persistent, factor_wide.cu's block: one thread of
//    a producer warpgroup streams, for each tile of the block, column
//    unit u of S[x] and then of S[x+1], u = 0 .. nu-1, through a ring of
//    up to 6 shared-memory stages (cp.async.bulk, mbarriers); these units
//    are shared by every tile of the cell, so they come from L2.  Two
//    consumer warpgroups take 64 rows of the tile each (setmaxnreg: 240
//    registers a consumer thread).  A warp copies its 16 rows in by the
//    permutation, a row as contiguous 16-byte cp.async copies (4-byte
//    where r is not a multiple of 4), into a staging tile in shared
//    memory, and splits them into hi and lo as the wgmma A fragments of
//    every k-step (8 ks registers).
//  - A unit is one commit group of wgmma.mma_async m64nNk8 .tf32 (N = 8
//    nc <= 32): lo.hi and hi.lo over every k-step into one accumulator,
//    hi.hi into four more of ceil(ks / 4) k-steps each (the tensor core
//    truncates as it accumulates; tests/test_torch_tf32_split.py models
//    it), then v = (((small + P0) + P1) + ...) in f32.  v_a of unit u is
//    parked in the staging tile; with v_b of the same columns the
//    epilogue forms la v_a + lb v_b in f32 (each product rounded, then the
//    sum: the plain versions' order) into the staging tile, and keeps the
//    row's running max-abs.  No accumulator is read inside a commit group
//    (ptxas serializes no wgmma).  The quad's max, the 1e-30 floor, and
//    the row leaves divided, 16-byte stores coalesced along the row, to
//    its original position.
//  Each output row depends on its own row of phi and the two slices only,
//  whatever tile, warpgroup or tile position it lands in.  The interpolation
//  comes after the product (kernel 3's plain version interpolates first,
//  odim_step's after); both are held to their plain versions run in f64.
// tools/tc_variants.py --cell-readout --baseline DIR times it in turns
// against another checkout's step.cu and factor_wide.cu (e.g. the
// row-by-row design above); PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz).

#include "tc_wide.cuh"

namespace {

using namespace ttirt;

constexpr int kTileRows = kTcRows;       // rows of one cell a tile
constexpr int kCellSlots = kWideMaxN;    // >= n - 1 cells
constexpr int kPitch = kWideMaxR + 8;    // staging row pitch (8 mod 32:
                                         // the epilogue's float2 stores
                                         // meet 32 banks a half-warp)
constexpr int kSortThreads = 256;
constexpr int kSortRows = 8;             // rows a thread in the sort
constexpr int kSortChunk = kSortThreads * kSortRows;
constexpr int kPlanThreads = 1024;

// ---- the plan: the rows sorted by cell, and the tiles ----

inline long long max_tiles(int m, int n) {
  return (static_cast<long long>(m) + kTileRows - 1) / kTileRows + (n - 1);
}

// The plan's words: the tiles (cell, first sorted position, rows, 0),
// the cells' counts and cursors, the tile count, the permutation.
struct Plan {
  int4* tiles;
  int* counts;
  int* cursor;
  int* ntiles;
  int* perm;
};

__host__ __device__ inline Plan plan_at(int* words, long long cap) {
  Plan p;
  p.tiles = reinterpret_cast<int4*>(words);
  p.counts = words + 4 * cap;
  p.cursor = p.counts + kCellSlots;
  p.ntiles = p.cursor + kCellSlots;
  p.perm = p.ntiles + 4;
  return p;
}

inline long long plan_words(int m, int n) {
  return 4 * max_tiles(m, n) + 2 * kCellSlots + 4
         + ((static_cast<long long>(m) + 3) & ~3LL);
}

__device__ __forceinline__ int cell_of(const int* __restrict__ i0,
                                       long long row, int n) {
  return min(max(i0[row], 0), n - 2);
}

__global__ void __launch_bounds__(kSortThreads)
count_cells_kernel(const int* __restrict__ i0, int m, int n,
                   int* __restrict__ counts) {
  __shared__ int hist[kCellSlots];
  for (int c = threadIdx.x; c < kCellSlots; c += kSortThreads) hist[c] = 0;
  __syncthreads();
  const long long first =
      static_cast<long long>(blockIdx.x) * kSortChunk + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kSortRows; ++k) {
    const long long row = first + k * kSortThreads;
    if (row < m) atomicAdd(&hist[cell_of(i0, row, n)], 1);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n - 1; c += kSortThreads)
    if (hist[c] != 0) atomicAdd(&counts[c], hist[c]);
}

// One block: the cells' first sorted positions (an exclusive scan of the
// counts, which also starts the scatter's cursors), their first tiles,
// then the tile list, a tile a thread at a time (its cell by bisection).
__global__ void __launch_bounds__(kPlanThreads)
plan_tiles_kernel(int* __restrict__ words, long long cap, int n) {
  const Plan p = plan_at(words, cap);
  __shared__ int count[kCellSlots], start[kCellSlots], first[kCellSlots + 1];
  const int cells = n - 1;
  for (int c = threadIdx.x; c < cells; c += kPlanThreads)
    count[c] = p.counts[c];
  __syncthreads();
  if (threadIdx.x == 0) {
    int rows = 0, tiles = 0;
    for (int c = 0; c < cells; ++c) {
      start[c] = rows;
      first[c] = tiles;
      rows += count[c];
      tiles += (count[c] + kTileRows - 1) / kTileRows;
    }
    first[cells] = tiles;
    *p.ntiles = tiles;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += kPlanThreads)
    p.cursor[c] = start[c];
  const int total = first[cells];
  for (int t = threadIdx.x; t < total; t += kPlanThreads) {
    int lo = 0, hi = cells;          // first[lo] <= t < first[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (first[mid] <= t) lo = mid; else hi = mid;
    }
    const int k = t - first[lo];
    p.tiles[t] = make_int4(lo, start[lo] + k * kTileRows,
                           min(kTileRows, count[lo] - k * kTileRows), 0);
  }
}

__global__ void __launch_bounds__(kSortThreads)
scatter_rows_kernel(const int* __restrict__ i0, int m, int n,
                    int* __restrict__ cursor, int* __restrict__ perm) {
  __shared__ int hist[kCellSlots], base[kCellSlots];
  for (int c = threadIdx.x; c < kCellSlots; c += kSortThreads) hist[c] = 0;
  __syncthreads();
  const long long first =
      static_cast<long long>(blockIdx.x) * kSortChunk + threadIdx.x;
  int cell[kSortRows], rank[kSortRows];
#pragma unroll
  for (int k = 0; k < kSortRows; ++k) {
    const long long row = first + k * kSortThreads;
    cell[k] = -1;
    rank[k] = 0;
    if (row < m) {
      cell[k] = cell_of(i0, row, n);
      rank[k] = atomicAdd(&hist[cell[k]], 1);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n - 1; c += kSortThreads)
    if (hist[c] != 0) base[c] = atomicAdd(&cursor[c], hist[c]);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSortRows; ++k)
    if (cell[k] >= 0)
      perm[base[cell[k]] + rank[k]] =
          static_cast<int>(first + k * kSortThreads);
}

// ---- the readout ----

// Stages of the ring at rank r: as many units as fit beside the staging
// tile, at most kMaxStages (4 at r > 96, 6 at r <= 96).
__host__ __device__ inline int readout_stages(int r) {
  const long long room = static_cast<long long>(kSmemOptIn)
                         - 4LL * (kTileRows * kPitch + kTileRows)
                         - 16LL * kMaxStages;
  const long long s = room / (4LL * unit_floats(ksteps(r)));
  return s < kMaxStages ? static_cast<int>(s) : kMaxStages;
}

inline size_t readout_smem_bytes(int r) {
  return 4 * (static_cast<size_t>(readout_stages(r)) * unit_floats(ksteps(r))
              + kTileRows * kPitch + kTileRows)
         + 16 * kMaxStages;
}

// The block's shared memory: the ring of unit stages, the staging tile
// (a row of kPitch floats a tile row), the rows' divisors, the ring's
// barriers.
struct Smem {
  float* ring;
  float* rows;
  float* den;
  uint64_t* full;
  uint64_t* empty;
  int stages, unit;
  __device__ __forceinline__ Smem(float* smem, int r)
      : stages(readout_stages(r)), unit(unit_floats(ksteps(r))) {
    ring = smem;
    rows = ring + stages * unit;
    den = rows + kTileRows * kPitch;
    full = reinterpret_cast<uint64_t*>(den + kTileRows);
    empty = full + kMaxStages;
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

// The producer (one lane): for every tile of this block, unit u of S[x]
// and of S[x+1] for u = 0 .. nu-1, into the next free stage.
__device__ __forceinline__ void produce(const Smem& sm,
                                        const float* __restrict__ split,
                                        const int4* __restrict__ tiles,
                                        int ntiles, int nu) {
  const uint32_t bytes = 4u * static_cast<uint32_t>(sm.unit);
  RingPos pos;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int x = tiles[t].x;
    for (int u = 0; u < nu; ++u) {
      for (int node = 0; node < 2; ++node) {
        mbar_wait(&sm.empty[pos.stage], pos.phase ^ 1u);
        mbar_expect_tx(&sm.full[pos.stage], bytes);
        bulk_load(sm.ring + static_cast<size_t>(pos.stage) * sm.unit,
                  split + (static_cast<size_t>(x + node) * nu + u) * sm.unit,
                  bytes, &sm.full[pos.stage]);
        pos.next(sm.stages);
      }
    }
  }
}

// The warp's 16 tile rows (row k from lane k's `orig`, the original row
// index, -1 past the tile's rows) into its staging rows.
__device__ __forceinline__ void stage_rows(float* rows,
                                           const float* __restrict__ phi,
                                           int orig, int r) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < 16; ++k) {
    const int src = __shfl_sync(0xFFFFFFFFu, orig, k);
    if (src < 0) break;                      // the rest are past the tile
    const float* g = phi + static_cast<long long>(src) * r;
    float* d = rows + k * kPitch;
    if ((r & 3) == 0) {
      if (4 * lane < r) cp_async16(d + 4 * lane, g + 4 * lane);
    } else {
      for (int j = lane; j < r; j += 32) cp_async4(d + j, g + j);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// The warp's 16 rows of the staging tile divided by their divisors to
// their original positions in phin.
__device__ __forceinline__ void store_rows(const float* rows,
                                           const float* den, int orig,
                                           float* __restrict__ phin, int r) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < 16; ++k) {
    const int dst = __shfl_sync(0xFFFFFFFFu, orig, k);
    if (dst < 0) break;
    const float d = den[k];
    const float* s = rows + k * kPitch;
    float* o = phin + static_cast<long long>(dst) * r;
    if ((r & 3) == 0) {
      if (4 * lane < r) {
        float4 v = *reinterpret_cast<const float4*>(s + 4 * lane);
        v.x = __fdiv_rn(v.x, d);
        v.y = __fdiv_rn(v.y, d);
        v.z = __fdiv_rn(v.z, d);
        v.w = __fdiv_rn(v.w, d);
        *reinterpret_cast<float4*>(o + 4 * lane) = v;
      }
    } else {
      for (int j = lane; j < r; j += 32) o[j] = __fdiv_rn(s[j], d);
    }
  }
}

// Every tile of this block, by the consumer warpgroups (KSR = ksteps(r)
// k-steps).  Warp w of warpgroup wg takes tile rows 64 wg + 16 w .. +15;
// a lane's accumulator fragments hold rows g and g + 8 of those (g =
// lane / 4), columns 8c + 2t and + 1 of each group c (t = lane % 4).
template <int KSR>
__device__ __forceinline__ void consume(const Smem& sm,
                                        const float* __restrict__ phi,
                                        const float* __restrict__ la,
                                        const float* __restrict__ lb,
                                        const Plan& plan, int ntiles,
                                        float* __restrict__ phin, int r) {
  constexpr int NU = node_units(KSR);
  constexpr int NC = unit_groups(KSR);
  constexpr int G = (KSR + kParts - 1) / kParts;
  constexpr int NP = (KSR + G - 1) / G;
  constexpr uint32_t kPart = 4u * (8 * KSR) * (8 * NC);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = 64 * (threadIdx.x >> 7) + 16 * warp;
  float* rows = sm.rows + wrow * kPitch;
  float* r0 = rows + g * kPitch + 2 * t4;        // row g, column 2t
  float* r1 = r0 + 8 * kPitch;                   // row g + 8
  const uint32_t ring = smem_u32(sm.ring);
  RingPos pos;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int4 tile = plan.tiles[t];
    const int live = tile.z - wrow;              // this warp's rows in it
    const int orig = lane < 16 && lane < live ? plan.perm[tile.y + wrow + lane]
                                              : -1;
    stage_rows(rows, phi, orig, r);
    const int o0 = __shfl_sync(0xFFFFFFFFu, orig, g);
    const int o1 = __shfl_sync(0xFFFFFFFFu, orig, g + 8);
    uint32_t ahi[KSR][4], alo[KSR][4];
#pragma unroll
    for (int s = 0; s < KSR; ++s) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * s + t4 + 4 * (e >> 1);
        const bool in = ((e & 1) ? o1 : o0) >= 0 && col < r;
        const float v = in ? rows[(g + 8 * (e & 1)) * kPitch + col] : 0.0f;
        split_tf32(v, ahi[s][e], alo[s][e]);
      }
    }
    float wa0 = 0.0f, wb0 = 0.0f, wa1 = 0.0f, wb1 = 0.0f;
    if (o0 >= 0) {
      wa0 = la[o0];
      wb0 = lb != nullptr ? lb[o0] : __fsub_rn(1.0f, wa0);
    }
    if (o1 >= 0) {
      wa1 = la[o1];
      wb1 = lb != nullptr ? lb[o1] : __fsub_rn(1.0f, wa1);
    }
    __syncwarp();                   // every lane's fragments are read
    float mx0 = 0.0f, mx1 = 0.0f;
    for (int u = 0; u < NU; ++u) {
#pragma unroll
      for (int node = 0; node < 2; ++node) {
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
          const int col = 8 * NC * u + 8 * c;
          float2* p0 = reinterpret_cast<float2*>(r0 + col);
          float2* p1 = reinterpret_cast<float2*>(r1 + col);
          if (node == 0) {                       // v_a, parked
            *p0 = make_float2(v[0], v[1]);
            *p1 = make_float2(v[2], v[3]);
          } else {                               // la v_a + lb v_b
            const float2 a0 = *p0, a1 = *p1;
            const float w0 = __fadd_rn(__fmul_rn(wa0, a0.x),
                                       __fmul_rn(wb0, v[0]));
            const float w1 = __fadd_rn(__fmul_rn(wa0, a0.y),
                                       __fmul_rn(wb0, v[1]));
            const float w2 = __fadd_rn(__fmul_rn(wa1, a1.x),
                                       __fmul_rn(wb1, v[2]));
            const float w3 = __fadd_rn(__fmul_rn(wa1, a1.y),
                                       __fmul_rn(wb1, v[3]));
            *p0 = make_float2(w0, w1);
            *p1 = make_float2(w2, w3);
            mx0 = fmaxf(mx0, fmaxf(fabsf(w0), fabsf(w1)));
            mx1 = fmaxf(mx1, fmaxf(fabsf(w2), fabsf(w3)));
          }
        }
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, 2));
    if (t4 == 0) {
      sm.den[wrow + g] = fmaxf(mx0, 1e-30f);
      sm.den[wrow + g + 8] = fmaxf(mx1, 1e-30f);
    }
    __syncwarp();                   // the rows and divisors are complete
    store_rows(rows, sm.den + wrow, orig, phin, r);
    __syncwarp();                   // the staging rows are free
  }
}

#define TTIRT_KSR(K) \
  case K: consume<K>(sm, phi, la, lb, plan, ntiles, phin, r); break;

// phi (m, r), la (m,), lb (m,) or nullptr (then 1 - la), split (the
// slices as split_factor_kernel leaves them), the plan (plan_tiles_kernel
// and scatter_rows_kernel's) -> phin (m, r).
template <int KS>
__global__ void __launch_bounds__(kBlock, 1)
cell_readout_kernel(const float* __restrict__ phi,
                    const float* __restrict__ la,
                    const float* __restrict__ lb,
                    const float* __restrict__ split, int* words,
                    long long cap, float* __restrict__ phin, int r) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm(smem, r);
  init_ring(sm.full, sm.empty, sm.stages);
  const Plan plan = plan_at(words, cap);
  const int ntiles = *plan.ntiles;
  if (threadIdx.x >= kConsumers) {
    producer_registers<KS>();
    if (threadIdx.x == kConsumers)
      produce(sm, split, plan.tiles, ntiles, node_units(ksteps(r)));
    return;
  }
  consumer_registers<KS>();
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
}

#undef TTIRT_KSR

// The sort and the tile plan of i0 (m,) into `words` on `stream`.
cudaError_t plan_launch(const int* i0, int m, int n, int* words,
                        cudaStream_t s) {
  const long long cap = max_tiles(m, n);
  const Plan p = plan_at(words, cap);
  cudaError_t e = cudaMemsetAsync(p.counts, 0, kCellSlots * sizeof(int), s);
  if (e != cudaSuccess) return e;
  const int blocks = static_cast<int>((m + kSortChunk - 1LL) / kSortChunk);
  count_cells_kernel<<<blocks, kSortThreads, 0, s>>>(i0, m, n, p.counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  plan_tiles_kernel<<<1, kPlanThreads, 0, s>>>(words, cap, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  scatter_rows_kernel<<<blocks, kSortThreads, 0, s>>>(i0, m, n, p.cursor,
                                                      p.perm);
  return cudaGetLastError();
}

// The plan, then a persistent launch of the readout: kBlock threads and
// readout_smem_bytes(r) a block, as many blocks as the most tiles the
// plan can list or the card holds at once (blocks past the plan's tiles
// return at once).
cudaError_t readout_launch(const float* phi, const int* i0, const float* la,
                           const float* lb, const float* split, float* phin,
                           int m, int n, int r, int device, cudaStream_t s,
                           int* words) {
  cudaError_t e = plan_launch(i0, m, n, words, s);
  if (e != cudaSuccess) return e;
  const void* kern = nullptr;
  TTIRT_FOR_KSTEPS(r, kern = reinterpret_cast<const void*>(
                          &cell_readout_kernel<KS>));
  const size_t smem = readout_smem_bytes(r);
  int cap = 0;
  e = grid_cap(kern, device, smem, &cap, kBlock);
  if (e != cudaSuccess) return e;
  long long tiles = max_tiles(m, n);
  void* args[] = {&phi, &la, &lb, &split, &words, &tiles, &phin, &r};
  return cudaLaunchKernel(kern, dim3(static_cast<unsigned>(
                                     tiles < cap ? tiles : cap)),
                          dim3(kBlock), args, smem, s);
}

}  // namespace

extern "C" {

// Shared memory a readout launch at (n, r) within the caps (as the wide
// tiers': 2 <= n <= 128, 1 <= r <= 128) asks for, in bytes.
long long cell_readout_smem_bytes(int n, int r) {
  (void)n;
  return static_cast<long long>(readout_smem_bytes(r));
}
// The plan's 32-bit words for m rows on n nodes: the tile list (4 words
// a tile, at most cell_readout_max_tiles(m, n) tiles), the cells' counts
// and cursors (128 each), the tile count (then 3 unused words), the
// permutation (m words, rounded up to 4).
long long cell_readout_plan_words(int m, int n) { return plan_words(m, n); }
long long cell_readout_max_tiles(int m, int n) { return max_tiles(m, n); }
// The scratch of condition_update_wide_launch, in 32-bit words: the core
// split into units (a multiple of 128 floats), then the plan.
long long condition_update_wide_scratch_words(int m, int n, int r) {
  return split_floats(n, r) + plan_words(m, n);
}

// All pointers are device pointers to contiguous arrays on device
// `device`, which must be the current device; each launch returns the
// first failing launch's cudaError_t (0 on success) and is asynchronous
// on `stream`.
//
// The sort and tile plan alone: i0 (m,) int32 -> plan
// (cell_readout_plan_words(m, n) words).
int cell_readout_plan_launch(const void* i0, int m, int n, int device,
                             void* stream, void* plan) {
  (void)device;
  if (m == 0) return 0;
  if (!in_wide_caps(n, 1)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(plan_launch(static_cast<const int*>(i0), m, n,
                                      static_cast<int*>(plan),
                                      static_cast<cudaStream_t>(stream)));
}

// The readout on slices already split (split_factor_kernel's units of S,
// e.g. the scratch that factor_wide.cu's odim_step_wide_launch leaves):
// phi (m, r) f32, i0 (m,) int32, la (m,) f32, lb (m,) f32 or null (then
// lb = 1 - la in f32), split -> phin (m, r) f32; plan
// (cell_readout_plan_words(m, n) words) is overwritten.  Four launches
// after a memset: the count, the plan, the scatter, the readout.
int cell_readout_launch(const void* phi, const void* i0, const void* la,
                        const void* lb, const void* split, void* phin, int m,
                        int n, int r, int device, void* stream, void* plan) {
  if (m == 0) return 0;
  if (!in_wide_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(readout_launch(
      static_cast<const float*>(phi), static_cast<const int*>(i0),
      static_cast<const float*>(la), static_cast<const float*>(lb),
      static_cast<const float*>(split), static_cast<float*>(phin), m, n, r,
      device, static_cast<cudaStream_t>(stream), static_cast<int*>(plan)));
}

// condition_update past the narrow tier (step.cu's update_wide shapes):
// phi (m, r), i0 (m,) int32, la, lb (m,), cmat (n, r*r) -> phin (m, r);
// scratch (condition_update_wide_scratch_words(m, n, r) words) is
// overwritten: the core's split, then the plan.
int condition_update_wide_launch(const void* phi, const void* i0,
                                 const void* la, const void* lb,
                                 const void* cmat, void* phin, int m, int n,
                                 int r, int device, void* stream,
                                 void* scratch) {
  if (m == 0) return 0;
  if (!in_wide_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* split = static_cast<float*>(scratch);
  cudaError_t e = split_launch(static_cast<const float*>(cmat), split, n, r,
                               static_cast<long long>(r) * r, r, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(readout_launch(
      static_cast<const float*>(phi), static_cast<const int*>(i0),
      static_cast<const float*>(la), static_cast<const float*>(lb), split,
      static_cast<float*>(phin), m, n, r, device, s,
      reinterpret_cast<int*>(split + split_floats(n, r))));
}

}  // extern "C"
