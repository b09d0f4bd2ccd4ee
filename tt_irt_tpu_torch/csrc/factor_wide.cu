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
// CUDA cores.  At rank 128 neither the split factor (2 n r^2 floats) nor
// the f32 factor (n r^2) fits shared memory, and a row's phi no longer
// fits a thread's registers, so the narrow tiers' design (the factor
// staged once a persistent block, phi split in registers) does not
// carry over.  The design here, 256 threads a block and a tile of 128
// rows at a time, a warp 16 of them:
//  - A warp keeps its 16 rows of phi in registers as the m16n8k8 A
//    fragments of every k-step, in f32 (4 KS registers: KS = 4, 8 or 16
//    k-steps by the rank, an instance each; split per k-step as it is
//    used), and the factor comes in a node at a time: B_x, node x's
//    (r, r) block, split once into hi and lo (hi = tf32(x) rounded to
//    nearest even, lo = x - hi, as tc_conditional.cuh's split_tf32) and
//    staged zero-padded to whole k-steps at a pitch of 8 mod 32 floats
//    (the B fragments, 4 K rows by 8 columns, meet 32 banks), between
//    two barriers, for the block's 8 warps.  At (128, 128) that is 136 KB
//    of B_x and the 64 KB (n, 128) fk tile; the KS = 16 instances spill
//    160-236 bytes a thread at 255 registers.
//  - The products run as 3xTF32 mma.sync m16n8k8 (HMMA), as the narrow
//    kMma variant's.  A warp holds v = phi B_x for its 16 rows and all r
//    columns in 4 KS registers: a first walk over the k-steps sums the
//    small products lo.hi and hi.lo into v, a second adds each k-step's
//    large product hi.hi, formed in an accumulator of its own, in f32
//    (round to nearest), k-step after k-step: the narrow tiers' scheme
//    (the tensor core truncates as it accumulates).
//  - fk = sum_j v^2 goes into the (n, 128) fk tile as the narrow stage's
//    reduce_half leaves it; the CDF, bracket and readout are
//    row_common.cuh's, one thread a row.  A bracket node whose fk is
//    below kRecompute of its row's largest is recomputed in f32 from phi
//    and the factor in global memory (node_fk: one FMA chain over i for
//    each v_j, one over j for the squares, the chain of the narrow tiers'
//    warp_node_fk and thread_node_fk), so cdf_bracket_factor's out9
//    equals dim_step's bit for bit (the same device functions, in the
//    same order), and factor_conditional, which recomputes every node
//    below kRecompute by the same chain, gives fk equal to dim_step's f1
//    and f2 at a row's bracket nodes bit for bit.
//  - The prefix update runs a warp a row after the tile's CDF (the
//    bracket and weight of each row through shared memory): dim_step
//    interpolates C[i0] and C[i0+1] read from L2 and forms one FMA chain
//    over i a column (step.cu's update_wide_kernel); odim_step forms
//    v[i0] and v[i0+1] from Q in L2, one chain each, and reads out
//    la v[i0] + (1 - la) v[i0+1] (tc_dim.cuh's FactorSlices).  Both
//    divide by the max-abs over the row (floor 1e-30).
// The same arithmetic in the same order as this tier's first design (4
// warps a block, phi staged in shared memory, B split per fragment in
// the inner loop), so the same bits, in 0.24-0.76x its time
// (`tools/tc_variants.py --factor-wide --baseline DIR`; PERF.md).
// The factor is still staged with no copy in flight while the tensor
// cores run.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz: subnormal density ratios must survive to the f64 log).

#include "tc_conditional.cuh"

namespace {

using namespace ttirt;

constexpr int kWideMaxN = 128;
constexpr int kWideMaxR = 128;
constexpr int kLanes = kWideMaxR / 32;   // columns a lane in the update
constexpr int kWarps = kTcRows / 16;     // a warp takes 16 rows of the tile
constexpr int kBlock = 32 * kWarps;

// Run STMT with the constant KS set to the k-steps (and column groups)
// an instance unrolls at rank r: 4 up to r = 32, 8 up to 64, 16 up to
// 128, so that a warp's A fragments and sums take 32 KS registers.
#define TTIRT_FOR_KSTEPS(r, STMT)                                 \
  switch ((r) <= 32 ? 4 : (r) <= 64 ? 8 : 16) {                   \
    case 4: { constexpr int KS = 4; STMT; } break;                \
    case 8: { constexpr int KS = 8; STMT; } break;                \
    default: { constexpr int KS = 16; STMT; } break;              \
  }

inline bool in_wide_caps(int n, int r) {
  return n >= 2 && n <= kWideMaxN && r >= 1 && r <= kWideMaxR;
}

// Whether (n, r) goes to this tier: past the narrow tiers' caps or their
// shared memory.
inline bool factor_wide(int n, int r) {
  return !in_caps(n, r) || tc_smem_bytes(n, r) > kSmemOptIn;
}

// The rank padded to whole k-steps, and the pitch of the staged B_x
// (8 mod 32 floats: the B fragments, 4 K rows by 8 columns, meet 32
// banks).
__host__ __device__ inline int padded_rank(int r) { return 8 * ((r + 7) / 8); }
__host__ __device__ inline int node_pitch(int r) {
  return ((padded_rank(r) + 23) / 32) * 32 + 8;
}

inline size_t wide_smem_bytes(int n, int r) {
  const int rp = padded_rank(r);
  return (static_cast<size_t>(n) * kTcRows
          + 2 * static_cast<size_t>(rp) * node_pitch(r) + 2 * kTcRows)
         * sizeof(float);
}

// The block's shared memory: the (n, 128) fk tile, node x's B_x split
// into hi and lo, and the bracket (i0, la) of each tile row.
struct Smem {
  float* fk;
  float* bhi;
  float* blo;
  float* la;
  int* i0;
  int rp, bp;
  __device__ __forceinline__ Smem(float* smem, int n, int r)
      : rp(padded_rank(r)), bp(node_pitch(r)) {
    fk = smem;
    bhi = fk + n * kTcRows;
    blo = bhi + rp * bp;
    la = blo + rp * bp;
    i0 = reinterpret_cast<int*>(la + kTcRows);
  }
};

// This warp's rows of the tile at row0 as its A fragments, in f32: ax[s]
// holds k-step s (element e: row 16w + g + 8 (e & 1), column 8s + t +
// 4 (e >> 1)); zero past row m and column r.
template <int KS>
__device__ __forceinline__ void load_ax(float (&ax)[KS][4],
                                        const float* __restrict__ phi,
                                        long long row0, int m, int r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = row0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long row = base + 8 * (e & 1);
      const int col = 8 * s + (lane & 3) + 4 * (e >> 1);
      ax[s][e] = (row < m && col < r) ? phi[row * r + col] : 0.0f;
    }
  }
}

// Node x's (r, r) block of the factor into bhi / blo, split, zero up to
// the padded rank; a warp a row, lanes along the row.
__device__ __forceinline__ void stage_node(const Smem& sm,
                                           const float* __restrict__ bmat,
                                           int n, int r, int x) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t nr = static_cast<size_t>(n) * r;
  for (int i = warp; i < sm.rp; i += kWarps) {
    for (int j = lane; j < sm.rp; j += 32) {
      const float v = (i < r && j < r) ? bmat[i * nr + x * r + j] : 0.0f;
      uint32_t hi, lo;
      split_tf32(v, hi, lo);
      sm.bhi[i * sm.bp + j] = __uint_as_float(hi);
      sm.blo[i * sm.bp + j] = __uint_as_float(lo);
    }
  }
}

// fk of this warp's 16 rows at node x (B_x staged) into the fk tile
// (fk_at<SWZ>).  The small products lo.hi and hi.lo of every k-step go
// into v first, then each k-step's large product hi.hi, formed in an
// accumulator of its own, is added in f32 in k-step order.
template <bool SWZ, int KS>
__device__ __forceinline__ void node_conditional(const Smem& sm,
                                                 const float (&ax)[KS][4],
                                                 int ks, int x) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float v[KS][4];
#pragma unroll
  for (int c = 0; c < KS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[c][e] = 0.0f;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if (s < ks) {
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(ax[s][e], ahi[e], alo[e]);
      const float* bh = sm.bhi + (8 * s + t) * sm.bp + g;
      const float* bl = sm.blo + (8 * s + t) * sm.bp + g;
#pragma unroll
      for (int c = 0; c < KS; ++c) {
        if (c < ks) {
          mma_tf32(v[c], alo, __float_as_uint(bh[8 * c]),
                   __float_as_uint(bh[4 * sm.bp + 8 * c]));
          mma_tf32(v[c], ahi, __float_as_uint(bl[8 * c]),
                   __float_as_uint(bl[4 * sm.bp + 8 * c]));
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if (s < ks) {
      uint32_t ahi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) ahi[e] = __float_as_uint(tf32_round(ax[s][e]));
      const float* bh = sm.bhi + (8 * s + t) * sm.bp + g;
#pragma unroll
      for (int c = 0; c < KS; ++c) {
        if (c < ks) {
          float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_tf32(p, ahi, __float_as_uint(bh[8 * c]),
                   __float_as_uint(bh[4 * sm.bp + 8 * c]));
#pragma unroll
          for (int e = 0; e < 4; ++e) v[c][e] = __fadd_rn(v[c][e], p[e]);
        }
      }
    }
  }
  // the squares of rows 16w + g (s0) and 16w + g + 8 (s1): reduce_half's
  // order, then the quad's sums
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int c = 0; c < KS; ++c) {
    if (c < ks) {
      s0 = fmaf(v[c][0], v[c][0], s0);
      s0 = fmaf(v[c][1], v[c][1], s0);
      s1 = fmaf(v[c][2], v[c][2], s1);
      s1 = fmaf(v[c][3], v[c][3], s1);
    }
  }
  s0 += __shfl_xor_sync(0xFFFFFFFFu, s0, 1);
  s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, 1);
  s0 += __shfl_xor_sync(0xFFFFFFFFu, s0, 2);
  s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, 2);
  if (t == 0) {
    sm.fk[fk_at<SWZ>(x, 16 * warp + g)] = s0;
    sm.fk[fk_at<SWZ>(x, 16 * warp + g + 8)] = s1;
  }
}

// fk of the tile at row0 at every node into the fk tile, B_x staged
// node by node.  Every thread of the block calls it; it returns after a
// barrier, with the fk tile complete.
template <bool SWZ, int KS>
__device__ __forceinline__ void wide_conditional(const Smem& sm,
                                                 const float* __restrict__ phi,
                                                 const float* __restrict__ bmat,
                                                 long long row0, int m, int n,
                                                 int r) {
  float ax[KS][4];
  load_ax<KS>(ax, phi, row0, m, r);
  const int ks = sm.rp / 8;
  for (int x = 0; x < n; ++x) {
    __syncthreads();                 // the last node's B_x is done with
    stage_node(sm, bmat, n, r, x);
    __syncthreads();
    node_conditional<SWZ, KS>(sm, ax, ks, x);
  }
  __syncthreads();
}

// fk of one row at node x in f32 on the CUDA cores, by one thread (p:
// the row's phi): for each j one FMA chain over i in order, then one
// over j for the squares; the chain of TcStage::warp_node_fk and
// thread_node_fk, read from the factor in global memory.
__device__ __forceinline__ float node_fk(const float* p,
                                         const float* __restrict__ bmat,
                                         int n, int r, int x) {
  const size_t nr = static_cast<size_t>(n) * r;
  const float* bx = bmat + x * r;
  float f = 0.0f;
  for (int j = 0; j < r; ++j) {
    float v = 0.0f;
    for (int i = 0; i < r; ++i) v = fmaf(p[i], bx[i * nr + j], v);
    f = fmaf(v, v, f);
  }
  return f;
}

// The CDF stage of tile row tid (row = row0 + tid < m) on its fk column:
// cdf_bracket, then f1 or f2 below kRecompute of the row's largest fk
// recomputed by node_fk (TcStage::bracket's rule).
template <bool RT>
__device__ __forceinline__ Bracket wide_bracket(const Smem& sm, int tid,
                                                const float* p,
                                                const float* __restrict__ bmat,
                                                const float* __restrict__ h,
                                                const float* __restrict__ xg,
                                                int n, int r, float q,
                                                float um) {
  const float* fcol = sm.fk + tid;
  Bracket b = cdf_bracket<RT>(fcol, kTcRows, h, xg, n, q, um);
  if (!b.flat) {
    float fmax = 0.0f;
    for (int k = 0; k < n; ++k) fmax = fmaxf(fmax, fcol[k * kTcRows]);
    const float tiny = kRecompute * fmax;
    if (b.f1 < tiny) b.f1 = node_fk(p, bmat, n, r, b.i0);
    if (b.f2 < tiny) b.f2 = node_fk(p, bmat, n, r, b.i0 + 1);
  }
  return b;
}

// dim_step's prefix update: acc_j = sum_i p_i (la Ca[i, j] + lb Cb[i, j])
// over i in order, Ca and Cb the (r, r) core slices C[i0], C[i0+1]
// (cmat (n, r*r)); update_wide_kernel's chain.
struct CoreUpdate {
  __device__ __forceinline__ static void row(const float* p,
                                             const float* __restrict__ cmat,
                                             int n, int r, int i0, float la,
                                             float (&acc)[kLanes]) {
    const int lane = threadIdx.x & 31;
    const size_t rr = static_cast<size_t>(r) * r;
    const float* ca = cmat + i0 * rr;
    const float* cb = ca + rr;
    const float lb = 1.0f - la;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) acc[k] = 0.0f;
    for (int i = 0; i < r; ++i) {
      const float pi = p[i];
#pragma unroll
      for (int k = 0; k < kLanes; ++k) {
        const int j = lane + 32 * k;
        if (j < r) {
          const float b = la * ca[i * r + j] + lb * cb[i * r + j];
          acc[k] = fmaf(pi, b, acc[k]);
        }
      }
    }
  }
};

// odim_step's readout: va_j = sum_i p_i Q[i, i0*r + j] and vb_j at
// i0 + 1, one chain each over i in order, then la va + (1 - la) vb
// (FactorSlices' order), Q (r, n*r).
struct FactorUpdate {
  __device__ __forceinline__ static void row(const float* p,
                                             const float* __restrict__ qmat,
                                             int n, int r, int i0, float la,
                                             float (&acc)[kLanes]) {
    const int lane = threadIdx.x & 31;
    const size_t nr = static_cast<size_t>(n) * r;
    const float* qa = qmat + i0 * r;
    const float* qb = qa + r;
    float vb[kLanes];
#pragma unroll
    for (int k = 0; k < kLanes; ++k) acc[k] = vb[k] = 0.0f;
    for (int i = 0; i < r; ++i) {
      const float pi = p[i];
#pragma unroll
      for (int k = 0; k < kLanes; ++k) {
        const int j = lane + 32 * k;
        if (j < r) {
          acc[k] = fmaf(pi, qa[i * nr + j], acc[k]);
          vb[k] = fmaf(pi, qb[i * nr + j], vb[k]);
        }
      }
    }
    const float lb = 1.0f - la;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) acc[k] = la * acc[k] + lb * vb[k];
  }
};

// The prefix update of this warp's 16 tile rows (their i0 and la in
// shared memory), a warp a row: Update's sums, then / max-abs over the
// row (floor 1e-30).
template <class Update>
__device__ __forceinline__ void warp_update(const Smem& sm,
                                            const float* __restrict__ phi,
                                            const float* __restrict__ slices,
                                            float* __restrict__ phin,
                                            long long row0, int m, int n,
                                            int r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < 16; ++k) {
    const int trow = 16 * warp + k;
    const long long row = row0 + trow;
    if (row >= m) break;                      // uniform across the warp
    float acc[kLanes];
    Update::row(phi + row * r, slices, n, r, sm.i0[trow], sm.la[trow], acc);
    float scale = 0.0f;
#pragma unroll
    for (int u = 0; u < kLanes; ++u)
      if (lane + 32 * u < r) scale = fmaxf(scale, fabsf(acc[u]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      scale = fmaxf(scale, __shfl_xor_sync(0xFFFFFFFFu, scale, off));
    const float denom = fmaxf(scale, 1e-30f);
#pragma unroll
    for (int u = 0; u < kLanes; ++u) {
      const int j = lane + 32 * u;
      if (j < r) phin[row * r + j] = acc[u] / denom;
    }
  }
}

// dim_step (Update = CoreUpdate, slices = cmat) and odim_step (Update =
// FactorUpdate, slices = bmat = Q): phi (m, r), qp/um (m,), bmat (r, n*r),
// h (n-1,), xg (2, n) -> phin (m, r), out9 (m, 9).
template <bool RT, class Update, int KS>
__global__ void __launch_bounds__(kBlock)
dim_wide_kernel(const float* __restrict__ phi, const float* __restrict__ qp,
                const float* __restrict__ um, const float* __restrict__ bmat,
                const float* __restrict__ slices, const float* __restrict__ h,
                const float* __restrict__ xg, float* __restrict__ phin,
                float* __restrict__ out9, int m, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm(smem, n, r);
  const int tid = threadIdx.x;
  const int ntiles = (m + kTcRows - 1) / kTcRows;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * kTcRows;
    wide_conditional<false, KS>(sm, phi, bmat, row0, m, n, r);
    const long long row = row0 + tid;
    if (tid < kTcRows && row < m) {
      const float q = qp[row];
      const Bracket b = wide_bracket<RT>(sm, tid, phi + row * r, bmat, h, xg,
                                         n, r, q, RT ? 0.0f : um[row]);
      write_out9(out9 + row * 9, b, xg + n);
      sm.i0[tid] = b.i0;
      sm.la[tid] = cell_weight<RT>(b, q);
    }
    __syncthreads();                 // every row's bracket and weight
    warp_update<Update>(sm, phi, slices, phin, row0, m, n, r);
  }
}

// cdf_bracket_factor: phi (m, r), qp (m,), bmat, h, xg -> out9 (m, 9),
// i0 (m,) int32; the right-tail target from f32(1 - qp).
template <bool RT, int KS>
__global__ void __launch_bounds__(kBlock)
bracket_wide_kernel(const float* __restrict__ phi,
                    const float* __restrict__ qp,
                    const float* __restrict__ bmat,
                    const float* __restrict__ h,
                    const float* __restrict__ xg, float* __restrict__ out9,
                    int* __restrict__ i0, int m, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm(smem, n, r);
  const int tid = threadIdx.x;
  const int ntiles = (m + kTcRows - 1) / kTcRows;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * kTcRows;
    wide_conditional<false, KS>(sm, phi, bmat, row0, m, n, r);
    const long long row = row0 + tid;
    if (tid < kTcRows && row < m) {
      const float q = qp[row];
      const Bracket b = wide_bracket<RT>(sm, tid, phi + row * r, bmat, h, xg,
                                         n, r, q, __fsub_rn(1.0f, q));
      write_out9(out9 + row * 9, b, xg + n);
      i0[row] = b.i0;
    }
  }
}

// factor_conditional: phi (m, r), bmat (r, n*r) -> fk (m, n).  Every
// node below kRecompute of its row's largest is recomputed by node_fk
// (the row's own thread), then the tile leaves as the contiguous
// (rows, n) block (the fk tile swizzled per node, fk_at<true>, so that a
// warp's transposed read meets 32 banks).
template <int KS>
__global__ void __launch_bounds__(kBlock)
conditional_wide_kernel(const float* __restrict__ phi,
                        const float* __restrict__ bmat,
                        float* __restrict__ fk_out, int m, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm(smem, n, r);
  const int tid = threadIdx.x;
  const int ntiles = (m + kTcRows - 1) / kTcRows;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * kTcRows;
    wide_conditional<true, KS>(sm, phi, bmat, row0, m, n, r);
    if (tid < kTcRows && row0 + tid < m) {
      float fmax = 0.0f;
      for (int x = 0; x < n; ++x)
        fmax = fmaxf(fmax, sm.fk[fk_at<true>(x, tid)]);
      const float tiny = kRecompute * fmax;
      const float* p = phi + (row0 + tid) * r;
      for (int x = 0; x < n; ++x)
        if (sm.fk[fk_at<true>(x, tid)] < tiny)
          sm.fk[fk_at<true>(x, tid)] = node_fk(p, bmat, n, r, x);
    }
    __syncthreads();                 // every row's nodes final
    const long long left = m - row0;
    const int rows = static_cast<int>(left < kTcRows ? left : kTcRows);
    float* out = fk_out + row0 * n;
    for (int f = tid; f < rows * n; f += kBlock) {
      const int i = f / n;
      out[f] = sm.fk[fk_at<true>(f - i * n, i)];
    }
  }
}

// A persistent launch of kern at (m, n, r): kBlock threads and
// wide_smem_bytes(n, r) a block, one 128-row tile a block at a time.
cudaError_t wide_launch(const void* kern, void** args, int m, int n, int r,
                        int device, void* stream) {
  const size_t smem = wide_smem_bytes(n, r);
  int cap = 0;
  cudaError_t e = grid_cap(kern, device, smem, &cap, kBlock);
  if (e != cudaSuccess) return e;
  const int tiles = (m + kTcRows - 1) / kTcRows;
  return cudaLaunchKernel(kern, dim3(tiles < cap ? tiles : cap),
                          dim3(kBlock), args, smem,
                          static_cast<cudaStream_t>(stream));
}

template <class Update>
int dim_like_launch(const void* phi, const void* qp, const void* um,
                    const void* bmat, const void* slices, const void* h,
                    const void* xg, void* phin, void* out9, int m, int n,
                    int r, int rt, int device, void* stream) {
  if (m == 0) return 0;
  if (!in_wide_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  const float* p[7];
  const void* in[7] = {phi, qp, um, bmat, slices, h, xg};
  for (int k = 0; k < 7; ++k) p[k] = static_cast<const float*>(in[k]);
  float* pn = static_cast<float*>(phin);
  float* o = static_cast<float*>(out9);
  void* args[] = {&p[0], &p[1], &p[2], &p[3], &p[4], &p[5], &p[6], &pn, &o,
                  &m, &n, &r};
  const void* kern = nullptr;
  TTIRT_FOR_KSTEPS(r, kern = rt ? reinterpret_cast<const void*>(
                                      &dim_wide_kernel<true, Update, KS>)
                                : reinterpret_cast<const void*>(
                                      &dim_wide_kernel<false, Update, KS>));
  return static_cast<int>(wide_launch(kern, args, m, n, r, device, stream));
}

}  // namespace

extern "C" {

// The tier's caps, and whether a shape within them goes to this tier (1)
// or to the narrow one (0).
int factor_wide_max_n() { return kWideMaxN; }
int factor_wide_max_r() { return kWideMaxR; }
int factor_wide_tier(int n, int r) { return factor_wide(n, r) ? 1 : 0; }
// Shared memory a launch at (n, r) within the caps asks for, in bytes.
long long factor_wide_smem_bytes(int n, int r) {
  return static_cast<long long>(wide_smem_bytes(n, r));
}

// Each launch takes the operands of its narrow tier's entry point
// (dim_step.cu, odim_step.cu, factor_step.cu, factor_conditional.cu),
// device pointers to contiguous f32 arrays (i0: int32) on device
// `device`, which must be the current device; it returns the launch's
// cudaError_t (0 on success) and is asynchronous on `stream`.
int dim_step_wide_launch(const void* phi, const void* qp, const void* um,
                         const void* bmat, const void* cmat, const void* h,
                         const void* xg, void* phin, void* out9, int m, int n,
                         int r, int rt, int device, void* stream) {
  return dim_like_launch<CoreUpdate>(phi, qp, um, bmat, cmat, h, xg, phin,
                                     out9, m, n, r, rt, device, stream);
}

int odim_step_wide_launch(const void* psi, const void* qp, const void* um,
                          const void* qmat, const void* h, const void* xg,
                          void* psin, void* out9, int m, int n, int r, int rt,
                          int device, void* stream) {
  return dim_like_launch<FactorUpdate>(psi, qp, um, qmat, qmat, h, xg, psin,
                                       out9, m, n, r, rt, device, stream);
}

int cdf_bracket_factor_wide_launch(const void* phi, const void* qp,
                                   const void* bmat, const void* h,
                                   const void* xg, void* out9, void* i0,
                                   int m, int n, int r, int rt, int device,
                                   void* stream) {
  if (m == 0) return 0;
  if (!in_wide_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  const float* p[5];
  const void* in[5] = {phi, qp, bmat, h, xg};
  for (int k = 0; k < 5; ++k) p[k] = static_cast<const float*>(in[k]);
  float* o = static_cast<float*>(out9);
  int* ix = static_cast<int*>(i0);
  void* args[] = {&p[0], &p[1], &p[2], &p[3], &p[4], &o, &ix, &m, &n, &r};
  const void* kern = nullptr;
  TTIRT_FOR_KSTEPS(r, kern = rt ? reinterpret_cast<const void*>(
                                      &bracket_wide_kernel<true, KS>)
                                : reinterpret_cast<const void*>(
                                      &bracket_wide_kernel<false, KS>));
  return static_cast<int>(wide_launch(kern, args, m, n, r, device, stream));
}

int factor_conditional_wide_launch(const void* phi, const void* bmat,
                                   void* fk, int m, int n, int r, int device,
                                   void* stream) {
  if (m == 0) return 0;
  if (!in_wide_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(phi);
  const float* b = static_cast<const float*>(bmat);
  float* f = static_cast<float*>(fk);
  void* args[] = {&p, &b, &f, &m, &n, &r};
  const void* kern = nullptr;
  TTIRT_FOR_KSTEPS(r, kern = reinterpret_cast<const void*>(
                          &conditional_wide_kernel<KS>));
  return static_cast<int>(wide_launch(kern, args, m, n, r, device, stream));
}

}  // extern "C"
