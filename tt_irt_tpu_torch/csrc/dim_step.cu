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
// over all n nodes.  Blocks are persistent (grid-stride over row tiles)
// so B is staged once per resident block, not once per tile.  Moving
// phi @ B onto the tensor cores (3xTF32 or a bf16 three-way split) is
// the next step and is not done here.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz: subnormal density ratios must survive to the f64 log).

#include "row_common.cuh"

namespace {

using namespace ttirt;

__device__ __forceinline__ float invert_quadratic(float f1, float f2,
                                                  float c1, float q,
                                                  float x1, float x2) {
  const float h3 = x2 - x1;
  const float aq = 0.5f * (f2 - f1) / h3;
  const float t = q - c1;
  const float dq = f1 * f1 + 4.0f * aq * t;
  const float den = f1 + sqrtf(fmaxf(dq, 0.0f));
  const float xk = (den <= 0.0f) ? x1 : x1 + 2.0f * t / den;
  return fminf(fmaxf(xk, x1), x2);
}

template <int RMAX, bool RT>
__global__ void __launch_bounds__(kThreads)
dim_step_kernel(const float* __restrict__ phi, const float* __restrict__ qp,
                const float* __restrict__ um, const float* __restrict__ bmat,
                const float* __restrict__ cmat, const float* __restrict__ h,
                const float* __restrict__ xg, float* __restrict__ phin,
                float* __restrict__ out9, int m, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  const int nr = n * r;
  float* bs = smem;                   // (n*r, RMAX): bs[col*RMAX+i] = B[i, col]
  float* fks = smem + nr * RMAX;      // (n, kThreads): fk of this thread's row
  const int tid = threadIdx.x;

  // Stage B transposed; reads follow B's row-major order (coalesced).
  for (int idx = tid; idx < r * nr; idx += blockDim.x) {
    const int i = idx / nr;
    const int col = idx - i * nr;
    bs[col * RMAX + i] = bmat[idx];
  }
  for (int idx = tid; idx < nr * (RMAX - r); idx += blockDim.x) {
    const int col = idx / (RMAX - r);
    const int i = r + (idx - col * (RMAX - r));
    bs[col * RMAX + i] = 0.0f;
  }
  __syncthreads();

  const float* x32 = xg;
  const float* xlo = xg + n;
  const int ntiles = (m + kThreads - 1) / kThreads;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row = tile * kThreads + tid;
    if (row >= m) continue;

    float p[RMAX];
#pragma unroll
    for (int i = 0; i < RMAX; ++i)
      p[i] = (i < r) ? phi[static_cast<size_t>(row) * r + i] : 0.0f;

    // ---- conditional fk[x] = sum_j (phi . B[:, x*r+j])^2 ----
    for (int x = 0; x < n; ++x) {
      float f = 0.0f;
      for (int j = 0; j < r; ++j) {
        const float4* bc =
            reinterpret_cast<const float4*>(bs + (x * r + j) * RMAX);
        float v = 0.0f;
#pragma unroll
        for (int i4 = 0; i4 < RMAX / 4; ++i4) {
          const float4 b = bc[i4];
          v = fmaf(p[4 * i4 + 0], b.x, v);
          v = fmaf(p[4 * i4 + 1], b.y, v);
          v = fmaf(p[4 * i4 + 2], b.z, v);
          v = fmaf(p[4 * i4 + 3], b.w, v);
        }
        f = fmaf(v, v, f);
      }
      fks[x * kThreads + tid] = f;
    }

    // ---- two-sided trapezoid CDF (degenerate rows -> uniform) ----
    // The _rn intrinsics keep these sums free of FMA contraction, so
    // every pass below rebuilds bit-identical ck/cr values.
    auto cell = [&](float a, float b, int k) {
      return __fmul_rn(__fmul_rn(0.5f, __fadd_rn(a, b)), h[k]);
    };
    float total = 0.0f;
    for (int k = 0; k < n - 1; ++k)
      total = __fadd_rn(total, cell(fks[k * kThreads + tid],
                                    fks[(k + 1) * kThreads + tid], k));
    const bool bad = total <= 0.0f;
    auto fval = [&](int k) { return bad ? 1.0f : fks[k * kThreads + tid]; };
    auto dcv = [&](int k) { return bad ? h[k] : cell(fval(k), fval(k + 1), k); };
    float tot = 0.0f;                       // ck[n-1]
    for (int k = 0; k < n - 1; ++k) tot = __fadd_rn(tot, dcv(k));

    const float q = qp[row];
    bool right = false;
    float qt = 0.0f, ut = 0.0f;
    int cnt = 0;
    if (RT) {
      for (int k = 0; k < n; ++k) cnt += (x32[k] < q) ? 1 : 0;
    } else {
      right = q > 0.5f;                     // the f32 seed, as the epilogue
      qt = q * tot;
      ut = um[row] * tot;
      if (right) {
        float s = 0.0f;                     // cr[k], summed from the right
        cnt = (s > ut) ? 1 : 0;             // cr[n-1] = 0
        for (int k = n - 2; k >= 0; --k) {
          s = __fadd_rn(s, dcv(k));
          cnt += (s > ut) ? 1 : 0;
        }
      } else {
        float c = 0.0f;                     // ck[k], summed from the left
        for (int k = 0; k < n; ++k) {
          cnt += (c < qt) ? 1 : 0;
          if (k < n - 1) c = __fadd_rn(c, dcv(k));
        }
      }
    }
    const int i0 = min(max(cnt - 1, 0), n - 2);

    // ---- readout: the same sequential sums up to the bracket ----
    float c1 = 0.0f;
    for (int k = 0; k < i0; ++k) c1 = __fadd_rn(c1, dcv(k));
    float cr2 = 0.0f;
    for (int k = n - 2; k > i0; --k) cr2 = __fadd_rn(cr2, dcv(k));
    const float f1 = fval(i0);
    const float f2 = fval(i0 + 1);
    const float x1 = x32[i0];
    const float x2 = x32[i0 + 1];
    float* o = out9 + static_cast<size_t>(row) * 9;
    o[0] = c1;
    o[1] = cr2;
    o[2] = f1;
    o[3] = f2;
    o[4] = x1;
    o[5] = xlo[i0];
    o[6] = x2;
    o[7] = xlo[i0 + 1];
    o[8] = tot;

    // ---- f32 weight solve (for the prefix update only) ----
    float xk;
    if (RT) {
      xk = q;
    } else if (right) {
      xk = -invert_quadratic(f2, f1, cr2, ut, -x2, -x1);
    } else {
      xk = invert_quadratic(f1, f2, c1, qt, x1, x2);
    }
    const float la = fminf(fmaxf((x2 - xk) / (x2 - x1), 0.0f), 1.0f);
    const float lb = 1.0f - la;

    // ---- prefix update from the two bracketing core slices ----
    const float* ca = cmat + static_cast<size_t>(i0) * r * r;
    float acc[RMAX];
    prefix_update<RMAX>(p, la, lb, ca, ca + r * r, r, acc);
#pragma unroll
    for (int j = 0; j < RMAX; ++j)
      if (j < r) phin[static_cast<size_t>(row) * r + j] = acc[j];
  }
}

// Dynamic shared memory of one block: B padded to the rank tier, plus
// one fk column per thread.
size_t smem_bytes(int n, int r) {
  return (static_cast<size_t>(n) * r * rank_tier(r)
          + static_cast<size_t>(n) * kThreads) * sizeof(float);
}

template <int RMAX, bool RT>
cudaError_t launch(const float* phi, const float* qp, const float* um,
                   const float* bmat, const float* cmat, const float* h,
                   const float* xg, float* phin, float* out9, int m, int n,
                   int r, int device, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, r);
  int cap = 0;
  cudaError_t e = grid_cap(
      reinterpret_cast<const void*>(&dim_step_kernel<RMAX, RT>), device, smem,
      &cap);
  if (e != cudaSuccess) return e;
  const int tiles = (m + kThreads - 1) / kThreads;
  const int grid = tiles < cap ? tiles : cap;
  dim_step_kernel<RMAX, RT><<<grid, kThreads, smem, stream>>>(
      phi, qp, um, bmat, cmat, h, xg, phin, out9, m, n, r);
  return cudaGetLastError();
}

template <bool RT>
cudaError_t dispatch(const float* phi, const float* qp, const float* um,
                     const float* bmat, const float* cmat, const float* h,
                     const float* xg, float* phin, float* out9, int m, int n,
                     int r, int dev, cudaStream_t s) {
  switch (rank_tier(r)) {
    case 8: return launch<8, RT>(phi, qp, um, bmat, cmat, h, xg, phin, out9, m, n, r, dev, s);
    case 16: return launch<16, RT>(phi, qp, um, bmat, cmat, h, xg, phin, out9, m, n, r, dev, s);
    case 24: return launch<24, RT>(phi, qp, um, bmat, cmat, h, xg, phin, out9, m, n, r, dev, s);
    case 32: return launch<32, RT>(phi, qp, um, bmat, cmat, h, xg, phin, out9, m, n, r, dev, s);
    default: return launch<kMaxR, RT>(phi, qp, um, bmat, cmat, h, xg, phin, out9, m, n, r, dev, s);
  }
}

}  // namespace

extern "C" {

// Caps the wrapper checks before launching.
int dim_step_max_n() { return kMaxN; }
int dim_step_max_r() { return kMaxR; }
// Shared memory a launch at (n, r <= kMaxR) asks for, in bytes.
long long dim_step_smem_bytes(int n, int r) {
  return static_cast<long long>(smem_bytes(n, r));
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
  if (n < 2 || n > kMaxN || r < 1 || r > kMaxR)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      rt ? dispatch<true>(f(phi), f(qp), f(um), f(bmat), f(cmat), f(h), f(xg),
                          static_cast<float*>(phin), static_cast<float*>(out9),
                          m, n, r, device, s)
         : dispatch<false>(f(phi), f(qp), f(um), f(bmat), f(cmat), f(h),
                           f(xg), static_cast<float*>(phin),
                           static_cast<float*>(out9), m, n, r, device, s);
  return static_cast<int>(e);
}

}  // extern "C"
