// One whole 'hi' factor-form inverse-Rosenblatt dimension for a tile of
// rows, for Hopper (sm_90a).
//
// Replaces tt_irt_tpu/ops/pallas_dim.py::dim_step (_dim_kernel), whose
// XLA twin is tt_irt_tpu/samplers/irt_scan.py::_step_factor_b +
// _cdf_rows32.  Per row m (all f32):
//   v[x, j] = sum_i phi[m, i] B[i, x*r + j]           (conditional)
//   fk[x]   = sum_j v[x, j]^2
//   dc[k]   = 0.5 (fk[k] + fk[k+1]) h[k]              (trapezoid cells)
//   ck      = prefix sums of dc, cr = suffix sums     (two-sided CDF)
//   i0      = count-based bracket, clipped to [0, n-2]
//   out9    = [c1, cr2, f1, f2, x1h, x1l, x2h, x2l, tot]
//   la      = f32 citardauq weight of the sample inside its cell
//   phi'    = phi (la C[i0] + (1-la) C[i0+1]) / max|.|  (floor 1e-30)
// The batched f64 epilogue (samplers/irt_scan.py::_serve_solve) turns
// out9 into samples and log-densities after all dimensions.
//
// What bounds it: at n=33, r=23 a row does n*r*r = 17.5k multiply-adds
// in the conditional against ~4.4k other operations (the squares, the
// CDF, the prefix update) and ~230 bytes of row traffic.  On the FP32
// CUDA cores that is 0.15 ms at 2^18 rows (67 TFLOP/s); as 3xTF32 on
// the tensor cores (three products at 495 TFLOP/s) the conditional is
// 0.056 ms, the rest 0.017 ms on the CUDA cores and the bytes 0.018 ms,
// so the tensor cores set the floor.  The design: the conditional runs
// on the tensor cores as 3xTF32 (tc_conditional.cuh: wgmma at the rank
// tiers 8-32, mma.sync where the split factor does not fit), for tiles
// of 128 rows per warpgroup, into an fk tile in shared memory; the CDF,
// bracket and readout stay one thread per row (row_common.cuh) and read
// that tile.  Blocks are persistent (B split and staged once per block)
// with up to three warpgroups each, so that one warpgroup's CDF runs on
// the CUDA cores while another's products run on the tensor cores.
// The prefix update reads the two core slices C[i0], C[i0+1] (2 r^2
// values a row) instead of the TPU's w @ C over all n nodes.  Gathered
// per row from L2 inside the first pass it cost more than the rest of
// the kernel, because the split factor leaves too little L1 to hold C.
// So it runs as a second pass over the block's rows once the products
// are done: C is staged into the shared memory the factor held, and each
// row re-forms its bracket and cell weight from its out9 (bit for bit)
// and reads its two slices from shared memory.  cdf_bracket_factor
// (factor_step.cu) runs the first pass's stages, so its out9 equals
// this kernel's bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz: subnormal density ratios must survive to the f64 log).

#include "tc_conditional.cuh"

namespace {

using namespace ttirt;

// The bracket of a row as the first pass left it in out9 (with the f32
// targets re-formed from the seed by the same products), so that
// cell_weight gives the first pass's la bit for bit.
template <bool RT>
__device__ __forceinline__ Bracket bracket_from_out9(const float* o,
                                                     const float* x32, int n,
                                                     float q, float um) {
  Bracket b;
  b.c1 = o[0];
  b.cr2 = o[1];
  b.f1 = o[2];
  b.f2 = o[3];
  b.x1 = o[4];
  b.x2 = o[6];
  b.tot = o[8];
  b.right = !RT && q > 0.5f;
  b.qt = RT ? 0.0f : q * b.tot;
  b.ut = RT ? 0.0f : um * b.tot;
  int i0 = 0;                       // x1 = x32[i0] on a rising grid
  for (int k = 0; k < n; ++k) i0 += (x32[k] < b.x1) ? 1 : 0;
  b.i0 = i0;
  return b;
}

template <int T, bool RT, Tc V>
__global__ void __launch_bounds__(tc_kernel_threads<T, V>())
dim_step_kernel(const float* __restrict__ phi, const float* __restrict__ qp,
                const float* __restrict__ um, const float* __restrict__ bmat,
                const float* __restrict__ cmat, const float* __restrict__ h,
                const float* __restrict__ xg, float* __restrict__ phin,
                float* __restrict__ out9, int m, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  using Stage = TcStage<T, V>;
  const int wgs = blockDim.x / kTcRows;
  const int wg = threadIdx.x / kTcRows;
  const int tid = threadIdx.x - wg * kTcRows;
  float* fk = Stage::fk_tile(smem, n, r, wg);

  Stage::stage(smem, bmat, n, r);
  __syncthreads();

  // first pass, over the block's tiles: conditional, two-sided CDF,
  // bracket and readout (the stages that cdf_bracket_factor runs)
  const int ntiles = (m + kTcRows - 1) / kTcRows;
  for (int tile = blockIdx.x * wgs + wg; tile < ntiles;
       tile += gridDim.x * wgs) {
    const long long row0 = static_cast<long long>(tile) * kTcRows;
    Stage::conditional(smem, fk, phi, row0, m, n, r, wg);
    const long long row = row0 + tid;
    const bool live = row < m;
    const Bracket b = Stage::template bracket<RT>(
        smem, fk + tid, phi, row, live, h, xg, n, r, live ? qp[row] : 0.0f,
        (live && !RT) ? um[row] : 0.0f);
    if (live) write_out9(out9 + row * 9, b, xg + n);
    wg_barrier(wg);      // the fk tile is free for the next tile
  }

  // second pass, over the same rows: the prefix update, with the core
  // staged where the factor was (n r^2 floats never exceed the factor's
  // staging), so that the two slices a row reads come from shared memory
  __syncthreads();       // every out9 row written, the factor done with
  for (int idx = threadIdx.x; idx < n * r * r; idx += blockDim.x)
    smem[idx] = cmat[idx];
  __syncthreads();
  for (int tile = blockIdx.x * wgs; tile < ntiles; tile += gridDim.x * wgs) {
    const long long row = static_cast<long long>(tile) * kTcRows + threadIdx.x;
    if (row >= m) continue;
    const float q = qp[row];
    const Bracket b = bracket_from_out9<RT>(out9 + row * 9, xg, n, q,
                                            RT ? 0.0f : um[row]);
    const float la = cell_weight<RT>(b, q);
    float p[T];
    load_row<T>(p, phi, row, r);
    const float* ca = smem + b.i0 * r * r;
    float acc[T];
    prefix_update<T>(p, la, 1.0f - la, ca, ca + r * r, r, acc);
    store_row<T>(phin, row, r, acc);
  }
}

template <int T, bool RT, Tc V>
cudaError_t launch_variant(const float* phi, const float* qp, const float* um,
                           const float* bmat, const float* cmat,
                           const float* h, const float* xg, float* phin,
                           float* out9, int m, int n, int r, int device,
                           cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(n, r);
  const int threads = tc_threads(n, r);
  int cap = 0;
  cudaError_t e = grid_cap(
      reinterpret_cast<const void*>(&dim_step_kernel<T, RT, V>), device, smem,
      &cap, threads);
  if (e != cudaSuccess) return e;
  dim_step_kernel<T, RT, V>
      <<<tc_grid(m, threads, cap), threads, smem, stream>>>(
          phi, qp, um, bmat, cmat, h, xg, phin, out9, m, n, r);
  return cudaGetLastError();
}

template <int T, bool RT>
cudaError_t launch(const float* phi, const float* qp, const float* um,
                   const float* bmat, const float* cmat, const float* h,
                   const float* xg, float* phin, float* out9, int m, int n,
                   int r, int device, cudaStream_t stream) {
  if constexpr (T <= 32) {
    if (use_wgmma(n, r))
      return launch_variant<T, RT, Tc::kWgmma>(phi, qp, um, bmat, cmat, h, xg,
                                               phin, out9, m, n, r, device,
                                               stream);
  }
  if constexpr (T >= 24) {
    return launch_variant<T, RT, Tc::kMma>(phi, qp, um, bmat, cmat, h, xg,
                                           phin, out9, m, n, r, device,
                                           stream);
  } else {
    return cudaErrorInvalidValue;   // tiers 8 and 16 always fit wgmma
  }
}

}  // namespace

extern "C" {

// Caps the wrapper checks before launching.
int dim_step_max_n() { return kMaxN; }
int dim_step_max_r() { return kMaxR; }
// Shared memory a launch at (n, r <= kMaxR) asks for, in bytes.
long long dim_step_smem_bytes(int n, int r) {
  return static_cast<long long>(tc_smem_bytes(n, r));
}

// All pointers are device pointers to contiguous f32 arrays:
// phi (m, r), qp/um (m,), bmat (r, n*r), cmat (n, r*r), h (n-1,),
// xg (2, n) -> phin (m, r), out9 (m, 9), all on device `device`, which
// must be the current device.  Returns the launch's cudaError_t (0 on
// success); the launch is asynchronous on `stream`.
int dim_step_launch(const void* phi, const void* qp, const void* um,
                    const void* bmat, const void* cmat, const void* h,
                    const void* xg, void* phin, void* out9, int m, int n,
                    int r, int rt, int device, void* stream) {
  if (m == 0) return 0;
  if (!in_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pn = static_cast<float*>(phin);
  float* o = static_cast<float*>(out9);
  cudaError_t e = cudaErrorInvalidValue;
  if (rt) {
    TTIRT_FOR_TIER(r, (e = launch<TIER, true>(
        f(phi), f(qp), f(um), f(bmat), f(cmat), f(h), f(xg), pn, o, m, n, r,
        device, s)));
  } else {
    TTIRT_FOR_TIER(r, (e = launch<TIER, false>(
        f(phi), f(qp), f(um), f(bmat), f(cmat), f(h), f(xg), pn, o, m, n, r,
        device, s)));
  }
  return static_cast<int>(e);
}

}  // extern "C"
