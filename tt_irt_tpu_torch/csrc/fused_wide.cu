// The wide tier of the whole f32 SIRT transform, for Hopper (sm_90a):
// every shape with 2 <= n <= 128 and 1 <= r <= 128 that fused_irt.cu
// refuses (n or r above 64, or no launch plan of its within the 227 KB
// shared-memory opt-in).
//
// Replaces, at those shapes, tt_irt_tpu/ops/pallas_irt.py::pallas_irt_sqr
// (:217, _kernel :92): per row, phi = e_0, lf = 0, and for k = 0..d-1 the
// Gram conditional fk[x] = sum_ij phi_i P_k[i*r + j, x] phi_j, the
// one-sided trapezoid CDF (uniform where it has no mass), the count
// bracket, the one-sided cancelling root x1 + (-f1 + sqrt|dq|) / 2aq (the
// aq == 0 and f1 == 0 branches as the TPU kernel), lf += log(max(f1 la +
// f2 lb, 1e-30)) and phi = phi (la C_k[i0] + lb C_k[i0+1]) / max|.|
// (floor 1e-30); fused_irt.cu documents the same function.
//
// What bounds it: d n r^2 multiply-adds a row for the Gram contraction
// and d 2 r^2 for the prefix update, against 8 d + 4 bytes of row
// traffic: 3.75 ms at d = 8, (9, 128) and 2^18 rows with the products as
// 3xTF32 on the tensor cores, 12.3 ms on the FP32 CUDA cores (the
// previous design, a register-blocked FP32 GEMM a rank slice and a warp
// a row for the update, ran at 17-40% of the latter).  One launch for the
// whole transform after the split, the stage of factor_wide.cu and
// gram_wide.cu (tc_gram.cuh), a 128-row tile carrying its phi through
// all d dimensions:
//  - Two launches ahead of the main kernel, on the same stream, split
//    every dimension's Gram field P_k (as the factor form P~, its node
//    blocks P_x) and core C_k (its node blocks C_k[c]) once a call into
//    tf32 hi and lo units (gram_split_launch, split_nodes_launch), into
//    scratch the caller allocates (fused_wide_scratch_floats(d, n, r):
//    2 d split_floats(n, r), 1.34 GB at (128, 128), d = 40).
//  - The main kernel is persistent, 384 threads a block: a producer
//    thread streams, for each dimension of each tile of the block, the n
//    nu units of P~_k, then the units of C_k that the tile's rows need,
//    through a ring of up to 6 shared-memory stages (cp.async.bulk,
//    mbarriers); two consumer warpgroups take 64 rows each, phi split
//    into hi and lo in registers as the A fragments of every k-step and
//    in f32 in a tile of shared memory (setmaxnreg: 240 registers a
//    consumer thread).
//  - Per dimension: the Gram stage (tc_gram.cuh::gram_nodes, the device
//    functions gram_wide.cu runs, hi.hi in four parts) writes fk to a
//    (n, 128) tile; the CDF, bracket, readout, root and log-density
//    run one thread a row (invert_row: the previous design's sums in its
//    order) on the first warpgroup, and mark the cells i0 and i0 + 1 of
//    each 64-row slab in a bit mask; the consumers' warps then arrive on
//    an mbarrier that the producer waits on before streaming the units of
//    the nodes in either slab's mask (the tile's).
//  - The prefix update on the tensor cores, dense-weighted: phi' =
//    sum_c w_c (phi C_k[c]) over the nodes that the tile's rows touch,
//    w_c = la where c = i0, lb where c = i0 + 1, 0 elsewhere, unit by
//    unit of phi''s columns: v = phi C_k[c] (3xTF32, hi.hi in one part),
//    then acc = acc + w_c v in f32 (the product rounded, then the sum:
//    kernel 3's cell-grouped readout's blend, la v_a + lb v_b).  The tile
//    skips every node none of its 128 rows touches (at most n r^2
//    multiply-adds a row, the Gram's count, about as many at small n,
//    where every cell is touched; both warpgroups run every streamed
//    node: a wgmma under a per-slab branch made ptxas serialize and
//    spill).  A zero weight adds an exact zero, so a row's phi' depends
//    on its own row only, whatever rows share its tile.  Then the row's
//    max-abs by the lane quad, the division (floor 1e-30), and the A
//    fragments from the tile for the next dimension; a warp touches its
//    own 16 rows only.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz).

#include "tc_gram.cuh"

namespace {

using namespace ttirt;

// hi.hi accumulators of the update (the Gram stage's are gram_wide.cu's
// kParts): at 16 k-steps the consumers hold 128 fragment registers and
// the update's accumulator beside the products'.
constexpr int kUpdateParts = 1;
constexpr int kMaskWords = kWideMaxN / 32;

// Shared memory besides the ring, in floats: the (n, 128) fk tile, the
// f32 phi tile, the rows' la, lb, i0, and two dimensions' masks of the
// two slabs' cells.
__host__ __device__ inline long long fixed_floats(int n, int r) {
  return static_cast<long long>(n) * kTcRows + phi_tile_floats(r)
         + 3 * kTcRows + 2 * 2 * kMaskWords;
}

inline size_t wide_smem_bytes(int n, int r) {
  const int stages = gram_ring_stages(fixed_floats(n, r), r);
  return 4 * (static_cast<size_t>(stages) * unit_floats(ksteps(r))
              + fixed_floats(n, r))
         + 16 * kMaxStages + 16;
}

struct Smem {
  Ring ring;
  float* fk;
  float* phi;
  float* la;
  float* lb;
  int* i0;
  uint32_t* cells;                   // [parity][slab][kMaskWords]
  uint64_t* ready;                   // the cells are marked
  __device__ __forceinline__ Smem(float* smem, int n, int r) {
    ring.stages = gram_ring_stages(fixed_floats(n, r), r);
    ring.unit = unit_floats(ksteps(r));
    ring.base = smem;
    fk = smem + ring.stages * ring.unit;
    phi = fk + n * kTcRows;
    la = phi + phi_tile_floats(r);
    lb = la + kTcRows;
    i0 = reinterpret_cast<int*>(lb + kTcRows);
    cells = reinterpret_cast<uint32_t*>(i0 + kTcRows);
    ring.full = reinterpret_cast<uint64_t*>(cells + 2 * 2 * kMaskWords);
    ring.empty = ring.full + kMaxStages;
    ready = ring.empty + kMaxStages;
  }
};

__device__ __forceinline__ bool has_cell(const uint32_t* mask, int c) {
  return (mask[c >> 5] >> (c & 31)) & 1u;
}

// The producer: for each tile of the block and each dimension k, the
// units of P~_k in order, then (once the consumers have marked the
// tile's cells) unit u of every marked node of C_k, u = 0 .. nu-1.
__device__ __forceinline__ void produce(const Smem& sm,
                                        const float* __restrict__ psplit,
                                        const float* __restrict__ csplit,
                                        int m, int d, int n, int r) {
  const int nu = node_units(ksteps(r));
  const long long field = split_floats(n, r);
  const int ntiles = (m + kTcRows - 1) / kTcRows;
  RingPos pos;
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    for (int k = 0; k < d; ++k, ++it) {
      stream_units(sm.ring, pos, psplit + k * field, n * nu);
      mbar_wait(sm.ready, it & 1u);
      const uint32_t* cw = sm.cells + 2 * kMaskWords * (it & 1u);
      const float* ck = csplit + k * field;
      for (int u = 0; u < nu; ++u)
        for (int c = 0; c < n; ++c)
          if (has_cell(cw, c) || has_cell(cw + kMaskWords, c))
            stream_units(sm.ring, pos, ck + static_cast<size_t>(c * nu + u)
                                                 * sm.ring.unit, 1);
    }
  }
}

__device__ __forceinline__ float cell(float a, float b, float h) {
  return __fmul_rn(__fmul_rn(0.5f, __fadd_rn(a, b)), h);
}

// What the CDF stage leaves of a row.
struct Step {
  float xk, la, lb, dlf;
  int i0;
};

// The CDF, bracket, readout and one-sided inversion of one row whose fk
// is fk[x * stride] (x < n): fused_irt.cu's invert_rows at one row, its
// sums in its order.
__device__ __forceinline__ Step invert_row(const float* fk, int stride,
                                           const float* __restrict__ xs,
                                           const float* __restrict__ hs,
                                           int n, float qk) {
  float tot = 0.0f;
  for (int x = 1; x < n; ++x)
    tot = __fadd_rn(tot, cell(fk[(x - 1) * stride], fk[x * stride],
                              hs[x - 1]));
  const float x0 = xs[0];
  const bool bad = tot <= 0.0f;
  const float total = bad ? xs[n - 1] - x0 : tot;
  const float target = qk * total;
  float c = 0.0f;
  int cnt = 0;
  for (int j = 0; j < n; ++j) {
    const float xj = xs[j] - x0;
    cnt += ((bad ? xj : c) < target) ? 1 : 0;
    if (j < n - 1)
      c = __fadd_rn(c, cell(fk[j * stride], fk[(j + 1) * stride], hs[j]));
  }
  const int i0 = min(max(cnt - 1, 0), n - 2);
  c = 0.0f;
  for (int j = 0; j < i0; ++j)
    c = __fadd_rn(c, cell(fk[j * stride], fk[(j + 1) * stride], hs[j]));
  const float cv = bad ? xs[i0] - x0 : c;
  const float c1 = cv / total;
  const float f1 = (bad ? 1.0f : fk[i0 * stride]) / total;
  const float f2 = (bad ? 1.0f : fk[(i0 + 1) * stride]) / total;
  const float x1 = xs[i0];
  const float x2 = xs[i0 + 1];

  // one-sided quadratic inversion inside the cell
  const float h3 = x2 - x1;
  const float aq = 0.5f * (f2 - f1) / h3;
  const float t = qk - c1;
  const float dq = f1 * f1 + 4.0f * aq * t;
  float xk;
  if (aq == 0.0f) {
    xk = (f1 == 0.0f) ? x1 : x1 + t / f1;
  } else {
    xk = x1 + (-f1 + sqrtf(fabsf(dq))) / (2.0f * aq);
  }
  xk = fminf(fmaxf(xk, x1), x2);
  const float la = (x2 - xk) / h3;
  const float lb = (xk - x1) / h3;
  return Step{xk, la, lb, logf(fmaxf(f1 * la + f2 * lb, 1e-30f)), i0};
}

// The weight of node c in the update of a row whose cell is i0: la at
// i0, lb at i0 + 1, 0 elsewhere (i0 < 0 for rows past m).
__device__ __forceinline__ float weight(int c, int i0, float la, float lb) {
  return c == i0 ? la : (c == i0 + 1 ? lb : 0.0f);
}

// phi' of this warpgroup's rows into the f32 tile, divided by each row's
// max-abs (floor 1e-30), from the ring's units of C_k (unit u of every
// node in either slab's mask of `cw`, u outer): per unit u, acc = acc +
// w_c (phi C_k[c])_u over those nodes c in order, then the unit's columns
// of acc to the tile.  Both warpgroups run every streamed unit, a node
// outside their slab's cells with zero weights: a wgmma under a branch
// made ptxas serialize the products and spill at 4 and 16 k-steps.  A
// thread holds rows g (cell ia, weights laa, lba) and g + 8 (ib, lab,
// lbb) at the columns of its accumulator fragments.
template <int KSR, int KS>
__device__ __forceinline__ void update_units(
    const Ring& rg, RingPos& pos, const uint32_t (&ahi)[KS][4],
    const uint32_t (&alo)[KS][4], float* tile, int pitch,
    const uint32_t* cw, int n, int ia, float laa, float lba, int ib,
    float lab, float lbb) {
  using S = UnitShape<KSR, kUpdateParts>;
  constexpr int W = 4 * S::NC;
  const int lane = threadIdx.x & 31;
  float* p0 = tile + frag_row() * pitch + 2 * (lane & 3);
  float* p1 = p0 + 8 * pitch;
  float mx0 = 0.0f, mx1 = 0.0f;
  for (int u = 0; u < S::NU; ++u) {
    float acc[W];
    zero(acc);
    for (int c = 0; c < n; ++c) {
      if (!has_cell(cw, c) && !has_cell(cw + kMaskWords, c)) continue;
      float small[W], part[S::NP][W];
      ring_unit<KSR, kUpdateParts, KS>(rg, pos, small, part, ahi, alo);
      const float w0 = weight(c, ia, laa, lba);
      const float w1 = weight(c, ib, lab, lbb);
#pragma unroll
      for (int e = 0; e < W; ++e)
        acc[e] = __fadd_rn(acc[e], __fmul_rn((e & 2) ? w1 : w0,
                                             unit_value(small, part, e)));
    }
#pragma unroll
    for (int g = 0; g < S::NC; ++g) {
      const int col = 8 * (S::NC * u + g);
      *reinterpret_cast<float2*>(p0 + col) =
          make_float2(acc[4 * g], acc[4 * g + 1]);
      *reinterpret_cast<float2*>(p1 + col) =
          make_float2(acc[4 * g + 2], acc[4 * g + 3]);
      mx0 = fmaxf(mx0, fmaxf(fabsf(acc[4 * g]), fabsf(acc[4 * g + 1])));
      mx1 = fmaxf(mx1, fmaxf(fabsf(acc[4 * g + 2]), fabsf(acc[4 * g + 3])));
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, 2));
  const float d0 = fmaxf(mx0, 1e-30f), d1 = fmaxf(mx1, 1e-30f);
  for (int u = 0; u < S::NU; ++u) {
#pragma unroll
    for (int g = 0; g < S::NC; ++g) {
      const int col = 8 * (S::NC * u + g);
      float2* a = reinterpret_cast<float2*>(p0 + col);
      float2* b = reinterpret_cast<float2*>(p1 + col);
      const float2 va = *a, vb = *b;
      *a = make_float2(va.x / d0, va.y / d0);
      *b = make_float2(vb.x / d1, vb.y / d1);
    }
  }
}

// q (m, d), psplit and csplit (every dimension's P~_k and C_k as the
// split leaves them), x (d, n), h (d, n-1) -> out (m, d), lfout (m,).
template <int KS>
__global__ void __launch_bounds__(kBlock, 1)
fused_wide_kernel(const float* __restrict__ q,
                  const float* __restrict__ psplit,
                  const float* __restrict__ csplit,
                  const float* __restrict__ xg, const float* __restrict__ hg,
                  float* __restrict__ out, float* __restrict__ lfout, int m,
                  int d, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm(smem, n, r);
  if (threadIdx.x < 2 * 2 * kMaskWords) sm.cells[threadIdx.x] = 0u;
  if (threadIdx.x == 0) mbar_init(sm.ready, kConsumerWarps);
  init_ring(sm.ring.full, sm.ring.empty, sm.ring.stages);
  if (threadIdx.x >= kConsumers) {
    producer_registers<KS>();
    if (threadIdx.x == kConsumers) produce(sm, psplit, csplit, m, d, n, r);
    return;
  }
  consumer_registers<KS>();
  const int tid = threadIdx.x, lane = tid & 31;
  const int ks = ksteps(r), pitch = gram_pitch(ks), cols = gram_cols(ks);
  const int ntiles = (m + kTcRows - 1) / kTcRows;
  const int fr = frag_row();
  RingPos pos;
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * kTcRows;
    const long long row = row0 + tid;  // the CDF's row (tid < kTcRows)
    const bool live = tid < kTcRows && row < m;
    consumer_sync();                   // the last tile's phi tile is read
    for (int e = tid; e < kTcRows * cols; e += kConsumers) {
      const int i = e / cols;
      sm.phi[i * pitch + e - i * cols] = e - i * cols == 0 ? 1.0f : 0.0f;
    }
    consumer_sync();
    uint32_t ahi[KS][4], alo[KS][4];
    load_a_tile<KS>(ahi, alo, sm.phi, pitch, ks);
    float lf = 0.0f;
    for (int k = 0; k < d; ++k, ++it) {
      TTIRT_WITH_KSR(KS, ks, gram_nodes<KSR, kParts, false, KS>(
                                 sm.ring, pos, ahi, alo, sm.phi, pitch,
                                 sm.fk, n));
      consumer_sync();                 // every row's fk at every node
      uint32_t* cw = sm.cells + 2 * kMaskWords * (it & 1u);
      if (tid < kTcRows) {
        int i0 = -2;
        float la = 0.0f, lb = 0.0f;
        if (live) {
          const Step st = invert_row(
              sm.fk + tid, kTcRows, xg + static_cast<size_t>(k) * n,
              hg + static_cast<size_t>(k) * (n - 1), n, q[row * d + k]);
          out[row * d + k] = st.xk;
          lf += st.dlf;
          if (k == d - 1) lfout[row] = lf;
          i0 = st.i0;
          la = st.la;
          lb = st.lb;
          uint32_t* slab = cw + kMaskWords * (tid >> 6);
          atomicOr(&slab[i0 >> 5], 1u << (i0 & 31));
          atomicOr(&slab[(i0 + 1) >> 5], 1u << ((i0 + 1) & 31));
        }
        sm.i0[tid] = i0;
        sm.la[tid] = la;
        sm.lb[tid] = lb;
      } else if (tid < kTcRows + 2 * kMaskWords) {
        // the next dimension's masks (the producer has read them as
        // this dimension's before last)
        sm.cells[2 * kMaskWords * ((it + 1) & 1u) + tid - kTcRows] = 0u;
      }
      consumer_sync();                 // the cells, weights and masks
      if (lane == 0) mbar_arrive(sm.ready);
      const int ia = sm.i0[fr], ib = sm.i0[fr + 8];
      const float laa = sm.la[fr], lba = sm.lb[fr];
      const float lab = sm.la[fr + 8], lbb = sm.lb[fr + 8];
      TTIRT_WITH_KSR(KS, ks, update_units<KSR, KS>(
                                 sm.ring, pos, ahi, alo, sm.phi, pitch, cw,
                                 n, ia, laa, lba, ib, lab, lbb));
      __syncwarp();                    // the warp's rows of phi' complete
      load_a_tile<KS>(ahi, alo, sm.phi, pitch, ks);
    }
  }
}

// Floats of the scratch: every dimension's P~_k, then its C_k, split.
inline long long scratch_floats(int d, int n, int r) {
  return 2LL * d * split_floats(n, r);
}

}  // namespace

extern "C" {

// The tier's caps.
int fused_wide_max_n() { return kWideMaxN; }
int fused_wide_max_r() { return kWideMaxR; }
// Shared memory a launch at (n, r) within the caps asks for.
long long fused_wide_smem_bytes(int n, int r) {
  return static_cast<long long>(wide_smem_bytes(n, r));
}
// The f32 scratch a launch of d dimensions at (n, r) within the caps
// needs, in floats: every P~_k and C_k split into hi and lo.
long long fused_wide_scratch_floats(int d, int n, int r) {
  return scratch_floats(d, n, r);
}

// The split alone (the first two of a launch's three kernels), for
// timing: p2 (d, r*r, n), coreu (d, n, r*r) -> scratch.
int fused_wide_split_launch(const void* p2, const void* coreu, int d, int n,
                            int r, int device, void* stream, void* scratch) {
  (void)device;
  if (!in_wide_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(scratch);
  cudaError_t e = gram_split_launch(static_cast<const float*>(p2), ps, d, n,
                                    r, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rr = static_cast<long long>(r) * r;
  return static_cast<int>(split_nodes_launch(
      static_cast<const float*>(coreu), ps + d * split_floats(n, r), d * n,
      r, rr, r, 1, n, n * rr, s));
}

// Device pointers to contiguous f32 arrays q (m, d), p2 (d, r*r, n),
// coreu (d, n, r*r), x (d, n), h (d, n-1) -> out (m, d), lf (m,), all on
// device `device`, which must be the current device, and last `scratch`,
// device memory of fused_wide_scratch_floats(d, n, r) floats that the
// launch overwrites.  Three kernels (the two splits, then the
// transform); returns the first failing launch's cudaError_t (0 on
// success); asynchronous on `stream`.
int fused_wide_launch(const void* q, const void* p2, const void* coreu,
                      const void* x, const void* h, void* out, void* lf,
                      int m, int d, int n, int r, int device, void* stream,
                      void* scratch) {
  if (m == 0 || d == 0) return 0;
  if (!in_wide_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  int e = fused_wide_split_launch(p2, coreu, d, n, r, device, stream,
                                  scratch);
  if (e != 0) return e;
  const float* qp = static_cast<const float*>(q);
  const float* ps = static_cast<const float*>(scratch);
  const float* cs = ps + d * split_floats(n, r);
  const float* xp = static_cast<const float*>(x);
  const float* hp = static_cast<const float*>(h);
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lf);
  void* args[] = {&qp, &ps, &cs, &xp, &hp, &o, &l, &m, &d, &n, &r};
  const void* kern = nullptr;
  TTIRT_FOR_KSTEPS(r, kern = reinterpret_cast<const void*>(
                          &fused_wide_kernel<KS>));
  const size_t smem = wide_smem_bytes(n, r);
  int cap = 0;
  cudaError_t err = grid_cap(kern, device, smem, &cap, kBlock);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (m + kTcRows - 1) / kTcRows;
  return static_cast<int>(cudaLaunchKernel(
      kern, dim3(tiles < cap ? tiles : cap), dim3(kBlock), args, smem,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
