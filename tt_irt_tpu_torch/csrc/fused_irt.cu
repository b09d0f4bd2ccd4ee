// The whole f32 SIRT inverse-Rosenblatt transform in one launch, for
// Hopper (sm_90a).
//
// Replaces tt_irt_tpu/ops/pallas_irt.py::pallas_irt_sqr (_kernel).  Per
// row m, with phi = e_0 and lf = 0, for each dimension k = 0..d-1 (all
// f32):
//   fk[x]  = sum_ij phi_i P_k[i*r + j, x] phi_j          (Gram conditional)
//   C[j]   = sum_{c<j} 0.5 (fk[c] + fk[c+1]) h_k[c]      (one-sided CDF)
//   rows with C[n-1] <= 0: C[j] = x[j] - x[0], fk = 1     (uniform fix)
//   i0     = clip(#{C < q C[n-1]} - 1, 0, n-2)            (bracket)
//   c1, f1, f2 = C[i0], fk[i0], fk[i0+1], each / C[n-1]
//   xk     = root of aq t^2 + f1 t = q - c1 in the cell (aq == 0 and
//            f1 == 0 branches as the TPU kernel), clipped into [x1, x2]
//   lf    += log(max(f1 la + f2 lb, 1e-30))
//   phi    = phi (la C_k[i0] + lb C_k[i0+1]) / max|.|     (floor 1e-30)
// Outputs: samples (m, d) and lf (m,).  The inversion is ONE-sided
// (against q * total, from the left), unlike the per-dimension path.
//
// What bounds it: FP32 arithmetic on the CUDA cores, d * (n r^2 + 2 r^2)
// FMAs per row (1.3e5 at d=40, n=17, r=13) against 8 d + 4 bytes of row
// traffic.  The TPU kernel keeps all d dimensions' operands in VMEM and
// turns the cumsum, the bracket readout and the core gather into
// matmuls against scum / one-hot matrices; here one thread owns one row,
// phi and lf stay in registers across the loop over d, and per dimension
// the block stages P_k (regrouped by node, padded to the rank tier),
// the core C_k, the grid and the spacings in shared memory (all d at
// once do not fit).  The cumsum is a sequential sum with
// __fadd_rn/__fmul_rn, so the counting pass and the readout rebuild
// bit-identical values; there is no scum operand.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz).

#include "row_common.cuh"

namespace {

using namespace ttirt;

template <int RMAX>
__global__ void __launch_bounds__(kThreads)
fused_irt_kernel(const float* __restrict__ q, const float* __restrict__ p2,
                 const float* __restrict__ coreu, const float* __restrict__ xg,
                 const float* __restrict__ hg, float* __restrict__ out,
                 float* __restrict__ lfout, int m, int d, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  const int rr = r * r;
  float* ps = smem;                         // (n*r, RMAX)  P_k by node
  float* cs = ps + n * r * RMAX;            // (n, r*r)     C_k
  float* fks = cs + n * rr;                 // (n, kThreads)
  float* phis = fks + n * kThreads;         // (r, kThreads)
  float* xs = phis + r * kThreads;          // (n,)
  float* hs = xs + n;                       // (n-1,)
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kThreads + tid;
  const bool active = row < m;

  float p[RMAX];
#pragma unroll
  for (int i = 0; i < RMAX; ++i) p[i] = (i == 0) ? 1.0f : 0.0f;
  float lf = 0.0f;

  // padded lanes of ps stay zero for every dimension
  zero_gram_pad<RMAX>(ps, n, r);

  for (int k = 0; k < d; ++k) {
    __syncthreads();                        // readers of dimension k-1 done
    stage_gram<RMAX>(ps, p2 + static_cast<size_t>(k) * rr * n, n, r);
    const float* ck = coreu + static_cast<size_t>(k) * n * rr;
    for (int idx = tid; idx < n * rr; idx += blockDim.x) cs[idx] = ck[idx];
    for (int idx = tid; idx < n; idx += blockDim.x) xs[idx] = xg[k * n + idx];
    for (int idx = tid; idx < n - 1; idx += blockDim.x)
      hs[idx] = hg[k * (n - 1) + idx];
    __syncthreads();
    if (!active) continue;

#pragma unroll
    for (int i = 0; i < RMAX; ++i)
      if (i < r) phis[i * kThreads + tid] = p[i];

    // ---- Gram conditional ----
    for (int x = 0; x < n; ++x)
      fks[x * kThreads + tid] =
          gram_node<RMAX>(ps + x * r * RMAX, phis + tid, p, r);

    // ---- one-sided trapezoid CDF, rebuilt by the same sums each pass ----
    auto cell = [&](int c) {
      return __fmul_rn(__fmul_rn(0.5f, __fadd_rn(fks[c * kThreads + tid],
                                                 fks[(c + 1) * kThreads + tid])),
                       hs[c]);
    };
    float total = 0.0f;
    for (int c = 0; c < n - 1; ++c) total = __fadd_rn(total, cell(c));
    const bool bad = total <= 0.0f;
    const float x0 = xs[0];
    if (bad) total = xs[n - 1] - x0;
    const float qk = q[static_cast<size_t>(row) * d + k];
    const float target = qk * total;
    int cnt = 0;
    if (bad) {
      for (int j = 0; j < n; ++j) cnt += ((xs[j] - x0) < target) ? 1 : 0;
    } else {
      float c = 0.0f;
      for (int j = 0; j < n; ++j) {
        cnt += (c < target) ? 1 : 0;
        if (j < n - 1) c = __fadd_rn(c, cell(j));
      }
    }
    const int i0 = min(max(cnt - 1, 0), n - 2);
    float cv;
    if (bad) {
      cv = xs[i0] - x0;
    } else {
      cv = 0.0f;
      for (int c = 0; c < i0; ++c) cv = __fadd_rn(cv, cell(c));
    }
    const float c1 = cv / total;
    const float f1 = (bad ? 1.0f : fks[i0 * kThreads + tid]) / total;
    const float f2 = (bad ? 1.0f : fks[(i0 + 1) * kThreads + tid]) / total;
    const float x1 = xs[i0];
    const float x2 = xs[i0 + 1];

    // ---- one-sided quadratic inversion inside the cell ----
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
    out[static_cast<size_t>(row) * d + k] = xk;
    const float la = (x2 - xk) / h3;
    const float lb = (xk - x1) / h3;
    lf += logf(fmaxf(f1 * la + f2 * lb, 1e-30f));

    // ---- prefix update from the two bracketing core slices ----
    float acc[RMAX];
    prefix_update<RMAX>(p, la, lb, cs + i0 * rr, cs + (i0 + 1) * rr, r, acc);
#pragma unroll
    for (int j = 0; j < RMAX; ++j) p[j] = acc[j];
  }
  if (active) lfout[row] = lf;
}

// Dynamic shared memory of one block: P_k padded to the rank tier, C_k,
// one fk and one phi column per thread, the grid and the spacings.
size_t smem_bytes(int n, int r) {
  return (static_cast<size_t>(n) * r * rank_tier(r)
          + static_cast<size_t>(n) * r * r
          + static_cast<size_t>(n + r) * kThreads + 2 * n) * sizeof(float);
}

// One block per kThreads rows (not persistent: every block restages each
// dimension's operands anyway).  The shared-memory limit is raised to
// the same constant on every launch, so launches at different sizes
// from different host threads cannot undercut each other.
template <int RMAX>
cudaError_t launch(const float* q, const float* p2, const float* coreu,
                   const float* xg, const float* hg, float* out, float* lf,
                   int m, int d, int n, int r, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, r);
  if (smem > kSmemOptIn) return cudaErrorInvalidValue;
  cudaError_t e = ensure_smem(
      reinterpret_cast<const void*>(&fused_irt_kernel<RMAX>), kSmemOptIn);
  if (e != cudaSuccess) return e;
  const int grid = (m + kThreads - 1) / kThreads;
  fused_irt_kernel<RMAX><<<grid, kThreads, smem, stream>>>(
      q, p2, coreu, xg, hg, out, lf, m, d, n, r);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Caps the wrapper checks before launching.
int fused_irt_max_n() { return kMaxN; }
int fused_irt_max_r() { return kMaxR; }
// Shared memory a launch at (n, r <= kMaxR) asks for, in bytes.
long long fused_irt_smem_bytes(int n, int r) {
  return static_cast<long long>(smem_bytes(n, r));
}

// Device pointers to contiguous f32 arrays q (m, d), p2 (d, r*r, n),
// coreu (d, n, r*r), xg (d, n), hg (d, n-1) -> out (m, d), lf (m,), all
// on the current device.  Returns the launch's cudaError_t (0 on
// success); asynchronous on `stream`.
int fused_irt_launch(const void* q, const void* p2, const void* coreu,
                     const void* xg, const void* hg, void* out, void* lf,
                     int m, int d, int n, int r, void* stream) {
  if (m == 0 || d == 0) return 0;
  if (n < 2 || n > kMaxN || r < 1 || r > kMaxR)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (rank_tier(r)) {
    case 8: e = launch<8>(f(q), f(p2), f(coreu), f(xg), f(hg), o, l, m, d, n, r, s); break;
    case 16: e = launch<16>(f(q), f(p2), f(coreu), f(xg), f(hg), o, l, m, d, n, r, s); break;
    case 24: e = launch<24>(f(q), f(p2), f(coreu), f(xg), f(hg), o, l, m, d, n, r, s); break;
    case 32: e = launch<32>(f(q), f(p2), f(coreu), f(xg), f(hg), o, l, m, d, n, r, s); break;
    default: e = launch<kMaxR>(f(q), f(p2), f(coreu), f(xg), f(hg), o, l, m, d, n, r, s); break;
  }
  return static_cast<int>(e);
}

}  // extern "C"
