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
// What bounds it: FP32 arithmetic on the CUDA cores.  The conditional
// is n*r*r FMAs per row (17.5k at n=33, r=23) against ~230 bytes of
// row traffic (phi in and out, two seeds, out9), so the kernel sits far
// above the memory roofline.  The design keeps every per-row
// intermediate on chip: B is staged once per block, transposed and
// zero-padded to RMAX, in dynamic shared memory (69.8 KB of data at
// r=23, n=33) and read as float4 broadcasts; fk lives in shared memory
// column-per-thread; the CDF rows are recomputed by short sequential
// sums instead of being stored; the prefix update reads only the two
// core slices C[i0], C[i0+1] (2 r^2 values) instead of the TPU's w @ C
// over all n nodes.  The conditional and the CDF / bracket / readout are
// device functions of row_common.cuh, shared bit for bit with
// odim_step.cu and factor_step.cu.  Blocks are persistent (grid-stride over row tiles)
// so B is staged once per resident block, not once per tile.  Moving
// phi @ B onto the tensor cores (3xTF32 or a bf16 three-way split) is
// the next step and is not done here.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz: subnormal density ratios must survive to the f64 log).

#include "row_common.cuh"

namespace {

using namespace ttirt;

template <int RMAX, bool RT>
__global__ void __launch_bounds__(kThreads)
dim_step_kernel(const float* __restrict__ phi, const float* __restrict__ qp,
                const float* __restrict__ um, const float* __restrict__ bmat,
                const float* __restrict__ cmat, const float* __restrict__ h,
                const float* __restrict__ xg, float* __restrict__ phin,
                float* __restrict__ out9, int m, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                   // (n*r, RMAX): bs[col*RMAX+i] = B[i, col]
  float* fcol = smem + n * r * RMAX + threadIdx.x;   // fk of this thread's row

  stage_factor<RMAX>(bs, bmat, n, r);
  __syncthreads();

  const int ntiles = (m + kThreads - 1) / kThreads;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const size_t row = static_cast<size_t>(tile) * kThreads + threadIdx.x;
    if (row >= static_cast<size_t>(m)) continue;

    float p[RMAX];
    load_row<RMAX>(p, phi, row, r);
    // conditional, two-sided CDF, bracket and readout: the stages of
    // row_common.cuh that odim_step.cu and factor_step.cu share
    factor_conditional_row<RMAX>(bs, p, fcol, n, r);
    const float q = qp[row];
    const Bracket b = cdf_bracket<RT>(fcol, h, xg, n, q, RT ? 0.0f : um[row]);
    write_out9(out9 + row * 9, b, xg + n);
    const float la = cell_weight<RT>(b, q);

    // prefix update from the two bracketing core slices
    const float* ca = cmat + static_cast<size_t>(b.i0) * r * r;
    float acc[RMAX];
    prefix_update<RMAX>(p, la, 1.0f - la, ca, ca + r * r, r, acc);
    store_row<RMAX>(phin, row, r, acc);
  }
}

template <int RMAX, bool RT>
cudaError_t launch(const float* phi, const float* qp, const float* um,
                   const float* bmat, const float* cmat, const float* h,
                   const float* xg, float* phin, float* out9, int m, int n,
                   int r, int device, cudaStream_t stream) {
  const size_t smem = factor_smem_bytes(n, r);
  int cap = 0;
  cudaError_t e = grid_cap(
      reinterpret_cast<const void*>(&dim_step_kernel<RMAX, RT>), device, smem,
      &cap);
  if (e != cudaSuccess) return e;
  dim_step_kernel<RMAX, RT>
      <<<persistent_grid(m, cap), kThreads, smem, stream>>>(
          phi, qp, um, bmat, cmat, h, xg, phin, out9, m, n, r);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Caps the wrapper checks before launching.
int dim_step_max_n() { return kMaxN; }
int dim_step_max_r() { return kMaxR; }
// Shared memory a launch at (n, r <= kMaxR) asks for, in bytes.
long long dim_step_smem_bytes(int n, int r) {
  return static_cast<long long>(factor_smem_bytes(n, r));
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
