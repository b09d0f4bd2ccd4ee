// One whole 'hi' inverse-Rosenblatt dimension on weighted-orthonormal
// cores for a tile of rows, for Hopper (sm_90a).
//
// Replaces tt_irt_tpu/ops/pallas_odim.py::odim_step (_odim_kernel), whose
// XLA twin is tt_irt_tpu/samplers/irt_scan.py::_step_factor_ob +
// _cdf_rows32.  The prepared cores are Q_k = L_k^{-1} C_k L_{k+1} with
// sum_x w2[x] Q_k(x) Q_k(x)^T = I, and the carried interface is
// psi_k = phi_k L_k.  Per row m (all f32):
//   v[x, j] = sum_i psi[m, i] Q[i, x*r + j]           (conditional)
//   fk[x]   = sum_j v[x, j]^2
//   two-sided trapezoid CDF, count-based bracket i0, out9 (as dim_step)
//   la      = f32 citardauq weight of the sample inside its cell
//   psi'    = (la v[i0] + (1-la) v[i0+1]) / max|.|     (floor 1e-30)
// No core operand and no second contraction: the prefix update is a
// 2-point readout of v.  The batched f64 epilogue
// (samplers/irt_scan.py::_serve_solve) turns out9 into samples and
// log-densities after all dimensions.
//
// What bounds it: FP32 arithmetic on the CUDA cores, n*r*r FMAs per row
// (17.5k at n=33, r=23) against ~230 bytes of row traffic.  The design
// is dim_step.cu's (one thread per row; Q staged once per persistent
// block, transposed and zero-padded to the rank tier, read as float4
// broadcasts; fk in a shared column per thread; CDF rows rebuilt by
// sequential sums), with one difficulty of its own: the readout needs
// rows i0 and i0+1 of v after the bracket is known, and v (n*r floats a
// row, 388 KB for 128 rows at n=33, r=23) fits neither registers nor
// shared memory.  Writing it to global memory would bring back the
// traffic the TPU kernel was written to remove, so the two rows are
// recomputed from the staged Q after the bracket: 2 r^2 FMAs, 3% of the
// conditional.  The recomputation calls the same factor_dot as the
// first pass (same FMA order), so the v it reads out is bit for bit the
// v whose squares made fk.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz: subnormal density ratios must survive to the f64 log).

#include "row_common.cuh"

namespace {

using namespace ttirt;

template <int RMAX, bool RT>
__global__ void __launch_bounds__(kThreads)
odim_step_kernel(const float* __restrict__ psi, const float* __restrict__ qp,
                 const float* __restrict__ um, const float* __restrict__ qmat,
                 const float* __restrict__ h, const float* __restrict__ xg,
                 float* __restrict__ psin, float* __restrict__ out9, int m,
                 int n, int r) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // (n*r, RMAX): qs[col*RMAX+i] = Q[i, col]
  float* fcol = smem + n * r * RMAX + threadIdx.x;   // fk of this thread's row

  stage_factor<RMAX>(qs, qmat, n, r);
  __syncthreads();

  const int ntiles = (m + kThreads - 1) / kThreads;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const size_t row = static_cast<size_t>(tile) * kThreads + threadIdx.x;
    if (row >= static_cast<size_t>(m)) continue;

    float p[RMAX];
    load_row<RMAX>(p, psi, row, r);
    factor_conditional_row<RMAX>(qs, p, fcol, n, r);
    const float q = qp[row];
    const Bracket b = cdf_bracket<RT>(fcol, kThreads, h, xg, n, q,
                                      RT ? 0.0f : um[row]);
    write_out9(out9 + row * 9, b, xg + n);
    const float la = cell_weight<RT>(b, q);
    const float lb = 1.0f - la;

    // 2-point readout: rows i0 and i0+1 of v, recomputed
    const float* qa = qs + b.i0 * r * RMAX;
    const float* qb = qa + r * RMAX;
    float acc[RMAX];
#pragma unroll
    for (int j = 0; j < RMAX; ++j) {
      acc[j] = 0.0f;
      if (j < r)
        acc[j] = la * factor_dot<RMAX>(qa + j * RMAX, p)
                 + lb * factor_dot<RMAX>(qb + j * RMAX, p);
    }
    normalize_row<RMAX>(acc, r);
    store_row<RMAX>(psin, row, r, acc);
  }
}

template <int RMAX, bool RT>
cudaError_t launch(const float* psi, const float* qp, const float* um,
                   const float* qmat, const float* h, const float* xg,
                   float* psin, float* out9, int m, int n, int r, int device,
                   cudaStream_t stream) {
  const size_t smem = factor_smem_bytes(n, r);
  int cap = 0;
  cudaError_t e = grid_cap(
      reinterpret_cast<const void*>(&odim_step_kernel<RMAX, RT>), device,
      smem, &cap);
  if (e != cudaSuccess) return e;
  odim_step_kernel<RMAX, RT>
      <<<persistent_grid(m, cap), kThreads, smem, stream>>>(
          psi, qp, um, qmat, h, xg, psin, out9, m, n, r);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Caps the wrapper checks before launching.
int odim_step_max_n() { return kMaxN; }
int odim_step_max_r() { return kMaxR; }
// Shared memory a launch at (n, r <= kMaxR) asks for, in bytes.
long long odim_step_smem_bytes(int n, int r) {
  return static_cast<long long>(factor_smem_bytes(n, r));
}

// All pointers are device pointers to contiguous f32 arrays:
// psi (m, r), qp/um (m,), qmat (r, n*r), h (n-1,), xg (2, n)
// -> psin (m, r), out9 (m, 9), all on device `device`, which must be the
// current device.  Returns the launch's cudaError_t (0 on success); the
// launch is asynchronous on `stream`.
int odim_step_launch(const void* psi, const void* qp, const void* um,
                     const void* qmat, const void* h, const void* xg,
                     void* psin, void* out9, int m, int n, int r, int rt,
                     int device, void* stream) {
  if (m == 0) return 0;
  if (!in_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pn = static_cast<float*>(psin);
  float* o = static_cast<float*>(out9);
  cudaError_t e = cudaErrorInvalidValue;
  if (rt) {
    TTIRT_FOR_TIER(r, (e = launch<TIER, true>(
        f(psi), f(qp), f(um), f(qmat), f(h), f(xg), pn, o, m, n, r, device,
        s)));
  } else {
    TTIRT_FOR_TIER(r, (e = launch<TIER, false>(
        f(psi), f(qp), f(um), f(qmat), f(h), f(xg), pn, o, m, n, r, device,
        s)));
  }
  return static_cast<int>(e);
}

}  // extern "C"
