// The wide tier of gram_conditional, for Hopper (sm_90a): every shape
// with 2 <= n <= 128 and 1 <= r <= 128 that step.cu's narrow tier refuses
// (gram_wide: n or r above 64, or P past the 227 KB shared-memory opt-in;
// (64, 64), for example).
//
// Replaces, at those shapes, tt_irt_tpu/ops/pallas_step.py::
// gram_conditional (:180, _gram_kernel :171):
//   fk[m, x] = sum_ij phi[m, i] P[i*r + j, x] phi[m, j].
//
// What bounds it: n r^2 multiply-adds a row for v = phi P_x and n r for
// the epilogue (1.2M at n = 96, r = 128), against 4 (r + n) bytes of row
// traffic; as 3xTF32 on the tensor cores 5.0 ms at 2^18 rows at (96, 128)
// (three products at 495 TFLOP/s), 12.4 ms on the FP32 CUDA cores, where
// the previous design (a register-blocked GEMM a rank slice) ran at
// 44-46% of that.  The design is factor_wide.cu's stage with a Gram
// epilogue, tc_gram.cuh's, which fused_wide.cu runs too:
//  - One launch ahead of the main kernel, on the same stream, splits P
//    once a call into tf32 hi and lo units of its node blocks P_x (the
//    factor form P~[i, x*r + j] = P[i*r + j, x]; gram_split_launch) into
//    scratch the caller allocates (gram_wide_scratch_floats(n, r);
//    16.8 MB at (128, 128)).
//  - The main kernel is persistent, 384 threads a block: one thread of a
//    producer warpgroup streams the n nu units of every tile of the block
//    through a ring of up to 6 shared-memory stages (cp.async.bulk,
//    mbarriers); two consumer warpgroups take 64 rows of the 128-row tile
//    each (setmaxnreg: 240 registers a consumer thread).
//  - A tile's rows come into an f32 tile in shared memory (coalesced
//    along the rows), from which each consumer splits its rows into the A
//    fragments of every k-step; the Gram stage (tc_gram.cuh::gram_nodes:
//    3xTF32 wgmma m64nNk8, hi.hi in four parts, the epilogue fk[x] =
//    sum_j v[x, j] phi_j reading phi from the f32 tile) leaves fk in a
//    (n, 128) tile, XOR-swizzled per node so that the (rows, n) block
//    leaves coalesced.
//  - At n = 9, r = 128 a node is 4 units of 32 columns (N = 32, the
//    stage's widest wgmma); at r = 32 one unit of 32.  The N width is
//    the unit's, whatever n is: n sets only how many units a tile takes.
// The accumulation order is the tensor core's (truncating sums of k-steps
// of 8) and the epilogue's, not the narrow tier's FP32 chain: fk is held
// to the plain version run in f64 (twice the plain f32 version's error +
// 1e-6 of the largest |fk|), as the narrow tier is.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz).

#include "tc_gram.cuh"

namespace {

using namespace ttirt;

// The block's shared memory: the ring of unit stages, the (n, 128) fk
// tile, the f32 phi tile, the ring's barriers.
__host__ __device__ inline long long fixed_floats(int n, int r) {
  return static_cast<long long>(n) * kTcRows + phi_tile_floats(r);
}

inline size_t wide_smem_bytes(int n, int r) {
  const int stages = gram_ring_stages(fixed_floats(n, r), r);
  return 4 * (static_cast<size_t>(stages) * unit_floats(ksteps(r))
              + fixed_floats(n, r))
         + 16 * kMaxStages;
}

struct Smem {
  Ring ring;
  float* fk;
  float* phi;
  __device__ __forceinline__ Smem(float* smem, int n, int r) {
    ring.stages = gram_ring_stages(fixed_floats(n, r), r);
    ring.unit = unit_floats(ksteps(r));
    ring.base = smem;
    fk = smem + ring.stages * ring.unit;
    phi = fk + n * kTcRows;
    ring.full = reinterpret_cast<uint64_t*>(phi + phi_tile_floats(r));
    ring.empty = ring.full + kMaxStages;
  }
};

// phi (m, r), split (P as gram_split_launch leaves it) -> fk (m, n).
template <int KS>
__global__ void __launch_bounds__(kBlock, 1)
gram_wide_kernel(const float* __restrict__ phi,
                 const float* __restrict__ split, float* __restrict__ fk_out,
                 int m, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm(smem, n, r);
  init_ring(sm.ring.full, sm.ring.empty, sm.ring.stages);
  const int ks = ksteps(r);
  const int ntiles = (m + kTcRows - 1) / kTcRows;
  if (threadIdx.x >= kConsumers) {
    producer_registers<KS>();
    if (threadIdx.x == kConsumers) {
      RingPos pos;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
        stream_units(sm.ring, pos, split, n * node_units(ks));
    }
    return;
  }
  consumer_registers<KS>();
  const int tid = threadIdx.x;
  const int pitch = gram_pitch(ks), cols = gram_cols(ks);
  RingPos pos;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * kTcRows;
    consumer_sync();                 // the last tile's phi and fk are read
    stage_rows(sm.phi, pitch, phi, row0, m, r, cols);
    consumer_sync();
    uint32_t ahi[KS][4], alo[KS][4];
    load_a_tile<KS>(ahi, alo, sm.phi, pitch, ks);
    TTIRT_WITH_KSR(KS, ks, gram_nodes<KSR, kParts, true, KS>(
                               sm.ring, pos, ahi, alo, sm.phi, pitch, sm.fk,
                               n));
    consumer_sync();                 // every row's fk at every node
    const long long left = m - row0;
    const int rows = static_cast<int>(left < kTcRows ? left : kTcRows);
    float* out = fk_out + row0 * n;
    for (int f = tid; f < rows * n; f += kConsumers) {
      const int i = f / n;
      out[f] = sm.fk[fk_at<true>(f - i * n, i)];
    }
  }
}

// The split, then a persistent launch: kBlock threads and
// wide_smem_bytes(n, r) a block, one 128-row tile a block at a time.
cudaError_t gram_launch(const float* phi, const float* pmat, float* fk,
                        float* split, int m, int n, int r, int device,
                        cudaStream_t s) {
  cudaError_t e = gram_split_launch(pmat, split, 1, n, r, s);
  if (e != cudaSuccess) return e;
  const void* kern = nullptr;
  TTIRT_FOR_KSTEPS(r, kern = reinterpret_cast<const void*>(
                          &gram_wide_kernel<KS>));
  const size_t smem = wide_smem_bytes(n, r);
  int cap = 0;
  e = grid_cap(kern, device, smem, &cap, kBlock);
  if (e != cudaSuccess) return e;
  const float* sp = split;
  void* args[] = {&phi, &sp, &fk, &m, &n, &r};
  const int tiles = (m + kTcRows - 1) / kTcRows;
  return cudaLaunchKernel(kern, dim3(tiles < cap ? tiles : cap),
                          dim3(kBlock), args, smem, s);
}

}  // namespace

extern "C" {

// Shared memory a launch at (n, r) within the caps asks for, in bytes.
long long gram_wide_smem_bytes(int n, int r) {
  return static_cast<long long>(wide_smem_bytes(n, r));
}
// The f32 scratch a launch at (n, r) within the caps needs, in floats: P
// split into hi and lo, unit by unit.
long long gram_wide_scratch_floats(int n, int r) {
  return split_floats(n, r);
}

// The split alone (the first of a launch's two kernels), for timing:
// pmat (r*r, n) -> scratch (gram_wide_scratch_floats(n, r) floats).
int gram_wide_split_launch(const void* pmat, void* scratch, int n, int r,
                           int device, void* stream) {
  (void)device;
  if (!in_wide_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(gram_split_launch(
      static_cast<const float*>(pmat), static_cast<float*>(scratch), 1, n,
      r, static_cast<cudaStream_t>(stream)));
}

// Device pointers to contiguous f32 arrays phi (m, r), pmat (r*r, n) ->
// fk (m, n), on device `device`, which must be the current device, and
// last `scratch`, device memory of gram_wide_scratch_floats(n, r) floats
// that the launch overwrites (P's split).  Two kernels (the split, then
// the Gram stage); returns the first failing launch's cudaError_t (0 on
// success); asynchronous on `stream`.
int gram_wide_launch(const void* phi, const void* pmat, void* fk, int m,
                     int n, int r, int device, void* stream, void* scratch) {
  if (m == 0) return 0;
  if (!in_wide_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(gram_launch(
      static_cast<const float*>(phi), static_cast<const float*>(pmat),
      static_cast<float*>(fk), static_cast<float*>(scratch), m, n, r, device,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
