// The factor-form conditional alone, for Hopper (sm_90a): the first
// kernel of the split steps hi_step="pair" and 'hid', followed by the
// CDF in PyTorch and condition_update (step.cu).
//
// Replaces tt_irt_tpu/ops/pallas_step.py::factor_conditional
// (_factor_kernel):
//   fk[m, x] = sum_j (sum_i phi[m, i] B[i, x*r + j])^2.
//
// What bounds it: the product, n*r*r multiply-adds a row (17.5k at
// n=33, r=23) against 4 (r + n) bytes of row traffic: 0.14 ms at 2^18
// rows on the FP32 CUDA cores, 0.056 ms as 3xTF32 on the tensor cores.
// The design is the conditional stage of dim_step and cdf_bracket_factor
// (tc_conditional.cuh, in the same variant at the same shape): B split
// and staged once per persistent block, 128-row tiles per warpgroup
// through the tensor cores into an fk tile in shared memory.  Two things
// are its own:
//  - No CDF follows in the kernel, so it cannot know the bracket whose
//    f1 and f2 dim_step recomputes in f32 where the tensor-core value
//    has cancelled.  It recomputes every node whose fk is below
//    kRecompute of its row's largest (recompute_small), by the same
//    decision and arithmetic, so that its fk at a row's bracket nodes
//    equals the f1 and f2 of dim_step's bracket bit for bit, and each fk
//    is as accurate relative to its row's largest as the plain f32
//    product.  Such nodes are 5-20% of a row's on lz40n33_ck's levels,
//    unevenly spread over the rows, so a warp queues its (row, node)
//    pairs node by node and runs them 32 at a time, one f32 chain a lane
//    (TcStage::thread_node_fk), mostly on one node (its staged factor read
//    by all lanes at once).  Each thread taking its own row's nodes was
//    2% slower, the whole warp on one row and node after another
//    (TcStage::warp_node_fk, as the CDF stage does for its two) 3x slower
//    (tools/tc_variants.py).
//  - fk leaves as the contiguous (rows, n) block of the tile: consecutive
//    threads write consecutive floats (store_tile).  The tile's column
//    stride of 128 floats would put a warp's transposed read in one
//    bank, so the tile is swizzled (fk_at<true>).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz).

#include "tc_conditional.cuh"

namespace {

using namespace ttirt;

// fk of the tile row trow at node x recomputed in place in f32 by
// Stage::thread_node_fk.
template <class Stage, int T>
__device__ __forceinline__ void recompute_node(const float* smem, float* fk,
                                               const float* __restrict__ phi,
                                               long long row0, int trow,
                                               int x, int n, int r) {
  float p[T];
  load_row<T>(p, phi, row0 + trow, r);
  fk[fk_at<true>(x, trow)] = Stage::thread_node_fk(smem, p, n, r, x);
}

// Every node of the tile at row0 whose tensor-core fk is below
// kRecompute of its row's largest, recomputed in place in f32: the CDF
// stage's decision and chain, taken at every node.  The warp walks the
// nodes in order; at each it takes the rows that need it (one ballot, on
// values not yet rewritten: only nodes already walked are) and queues
// those (row, node) pairs, one a lane; a full queue of 32 runs at once,
// one chain a lane.  Every thread of the warpgroup calls it; tid is its
// tile row.
template <class Stage, int T>
__device__ __forceinline__ void recompute_small(const float* smem, float* fk,
                                                const float* __restrict__ phi,
                                                long long row0, int m,
                                                int tid, int n, int r) {
  const int lane = threadIdx.x & 31;
  float tiny = 0.0f;                          // fk >= 0: nothing below 0
  if (row0 + tid < m) {
    float fmax = 0.0f;
    for (int x = 0; x < n; ++x) fmax = fmaxf(fmax, fk[fk_at<true>(x, tid)]);
    tiny = kRecompute * fmax;
  }
  int qx = 0, qrow = 0, filled = 0;           // this lane's queued pair
  for (int x = 0; x < n; ++x) {
    unsigned need = __ballot_sync(0xFFFFFFFFu,
                                  fk[fk_at<true>(x, tid)] < tiny);
    while (need) {
      const int took = min(__popc(need), 32 - filled);
      const int k = lane - filled;            // this lane's pick, if any
      if (k >= 0 && k < took) {
        unsigned w = need;
        for (int c = 0; c < k; ++c) w &= w - 1;
        qx = x;
        qrow = tid - lane + __ffs(w) - 1;
      }
      for (int c = 0; c < took; ++c) need &= need - 1;
      filled += took;
      if (filled == 32) {
        recompute_node<Stage, T>(smem, fk, phi, row0, qrow, qx, n, r);
        filled = 0;
      }
    }
  }
  if (lane < filled)
    recompute_node<Stage, T>(smem, fk, phi, row0, qrow, qx, n, r);
}

// The first `rows` rows of a warpgroup's swizzled fk tile as the
// contiguous block out[i*n + x] (tid: this thread's index in the
// warpgroup).
__device__ __forceinline__ void store_tile(const float* fk,
                                           float* __restrict__ out, int rows,
                                           int n, int tid) {
  const int di = kTcRows / n, dx = kTcRows - di * n;
  int i = tid / n, x = tid - i * n;             // tid = i*n + x
  for (int f = tid; f < rows * n; f += kTcRows) {
    out[f] = fk[fk_at<true>(x, i)];
    i += di;
    x += dx;
    if (x >= n) {
      x -= n;
      ++i;
    }
  }
}

template <int T, Tc V>
__global__ void __launch_bounds__(tc_kernel_threads<T, V>())
factor_conditional_kernel(const float* __restrict__ phi,
                          const float* __restrict__ bmat,
                          float* __restrict__ fk_out, int m, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  using Stage = TcStage<T, V, true>;
  const int wgs = blockDim.x / kTcRows;
  const int wg = threadIdx.x / kTcRows;
  const int tid = threadIdx.x - wg * kTcRows;
  float* fk = Stage::fk_tile(smem, n, r, wg);

  Stage::stage(smem, bmat, n, r);
  __syncthreads();

  const int ntiles = (m + kTcRows - 1) / kTcRows;
  for (int tile = blockIdx.x * wgs + wg; tile < ntiles;
       tile += gridDim.x * wgs) {
    const long long row0 = static_cast<long long>(tile) * kTcRows;
    Stage::conditional(smem, fk, phi, row0, m, n, r, wg);
    recompute_small<Stage, T>(smem, fk, phi, row0, m, tid, n, r);
    wg_barrier(wg);      // every row's nodes final
    const long long left = m - row0;
    store_tile(fk, fk_out + row0 * n,
               static_cast<int>(left < kTcRows ? left : kTcRows), n, tid);
    wg_barrier(wg);      // the fk tile is free for the next tile
  }
}

template <int T, Tc V>
struct Kernel {
  static const void* fn() {
    return reinterpret_cast<const void*>(&factor_conditional_kernel<T, V>);
  }
};

}  // namespace

extern "C" {

// Device pointers to contiguous f32 arrays phi (m, r), bmat (r, n*r)
// -> fk (m, n), all on device `device`, which must be the current
// device.  Returns the launch's cudaError_t (0 on success); the launch
// is asynchronous on `stream`.
int factor_conditional_launch(const void* phi, const void* bmat, void* fk,
                              int m, int n, int r, int device, void* stream) {
  if (m == 0) return 0;
  if (!in_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(phi);
  const float* b = static_cast<const float*>(bmat);
  float* f = static_cast<float*>(fk);
  void* args[] = {&p, &b, &f, &m, &n, &r};
  const void* kern = nullptr;
  TTIRT_FOR_TIER(r, (kern = tc_instance<Kernel, TIER>(n, r)));
  return static_cast<int>(tc_launch(kern, args, m, n, r, device,
                                    static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
