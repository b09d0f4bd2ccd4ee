// The wide tier of the whole f32 SIRT transform, for Hopper (sm_90a):
// every shape with 2 <= n <= 128 and 1 <= r <= 128 that fused_irt.cu
// refuses (n or r above 64, or no launch plan of its within the 227 KB
// shared-memory opt-in).
//
// Replaces, at those shapes, tt_irt_tpu/ops/pallas_irt.py::pallas_irt_sqr
// (_kernel): per row, phi = e_0, lf = 0, and for k = 0..d-1 the Gram
// conditional fk[x] = sum_ij phi_i P_k[i*r + j, x] phi_j, the one-sided
// trapezoid CDF (uniform where it has no mass), the count bracket, the
// one-sided cancelling root x1 + (-f1 + sqrt|dq|) / 2aq (the aq == 0 and
// f1 == 0 branches as the TPU kernel), lf += log(max(f1 la + f2 lb,
// 1e-30)) and phi = phi (la C_k[i0] + lb C_k[i0+1]) / max|.| (floor
// 1e-30); fused_irt.cu documents the same function.
//
// What bounds it: FP32 arithmetic, d (n r^2 + 3 r^2) FMAs a row (1.3M at
// d = 8, (9, 128)) against 8 d + 4 bytes of row traffic.  At rank 128 a
// row's phi no longer fits a thread's registers and one dimension's P
// (n r^2 floats) no longer fits shared memory, so the narrow kernel's
// design (R rows a thread carried in registers, the dimension's operand
// block staged whole) does not carry over.  Here, one launch for the
// whole transform, 256 threads a block carrying a tile of BM rows through
// all d dimensions:
//  - the tile's phi lives in shared memory transposed (phiT[j][row],
//    pitch BM + 4) for the whole transform;
//  - per dimension the Gram contraction runs as step.cu's
//    gram_wide_kernel at S = 1: P's rank slices P_i (r x n) stream in by
//    cp.async through a ring of two, one barrier a slice, and a thread
//    holds a 4 x 4 tile of (row, node) sums, each j step two float4
//    reads of shared memory for 16 FMAs.  Each (row, x) keeps the chain
//    v_i = fmaf(phi_j, P_ij, v_i) over j in order, then f = fmaf(phi_i,
//    v_i, f) over i in order, so fk equals gram_conditional's (every
//    tier of step.cu) bit for bit on the same phi;
//  - fk goes to a (BM, n | 1) tile; the CDF, bracket, readout, root and
//    log-density run one thread a row, the narrow kernel's sums
//    (invert_rows) in its order;
//  - the prefix update runs a warp a row with C_k's two slices read from
//    L2 (interpolate, then one FMA chain a column: prefix_update's
//    operations in its order) and writes phi' back into phiT.
// BM is 4 rows a row group, as many row groups as 256 threads over
// ceil(n / 4) node groups give, fewer where phiT would pass shared
// memory (wide_plan).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz).

#include <cstdint>

#include "row_common.cuh"

namespace {

using namespace ttirt;

constexpr int kWideMaxN = 128;
constexpr int kWideMaxR = 128;
constexpr int kBlock = 256;          // threads a block
constexpr int kTM = 4;               // rows of a thread's tile
constexpr int kTN = 4;               // nodes of a thread's tile
constexpr int kLanes = kWideMaxR / 32;

inline bool in_wide_caps(int n, int r) {
  return n >= 2 && n <= kWideMaxN && r >= 1 && r <= kWideMaxR;
}

// The block's layout at (n, r): ng node groups of kTN, bm rows (rg row
// groups of kTM), phiT's pitch, the fk tile's pitch (odd), and the
// floats of each part.
struct WidePlan {
  int ng, bn;        // node groups; P slice's floats a rank (kTN ng)
  int rg, bm, bmp;   // row groups; rows a block; phiT's pitch
  int fp;            // fk tile's pitch
  size_t smem;       // bytes
};

__host__ __device__ inline size_t plan_floats(int n, int r, int bm, int bn) {
  return static_cast<size_t>(r) * (bm + 4) + 2 * static_cast<size_t>(r) * bn
         + static_cast<size_t>(bm) * (n | 1) + 4 * static_cast<size_t>(bm);
}

__host__ __device__ inline WidePlan wide_plan(int n, int r) {
  WidePlan p;
  p.ng = (n + kTN - 1) / kTN;
  p.bn = kTN * p.ng;
  p.rg = kBlock / p.ng;
  const size_t words = kSmemOptIn / sizeof(float);
  while (p.rg > 1 && plan_floats(n, r, kTM * p.rg, p.bn) > words) --p.rg;
  p.bm = kTM * p.rg;
  p.bmp = p.bm + 4;
  p.fp = n | 1;
  p.smem = plan_floats(n, r, p.bm, p.bn) * sizeof(float);
  return p;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rank slice i of P_k into dst: dst[j * bn + x] = P_k[i*r + j, x], the
// slots past n zero; one commit group.
__device__ __forceinline__ void load_slice(float* dst, const float* pk,
                                           int i, int n, int r, int bn) {
  for (int e = threadIdx.x; e < r * bn; e += blockDim.x) {
    const int j = e / bn;
    const int x = e - j * bn;
    if (x < n)
      cp_async4(dst + e, pk + (static_cast<size_t>(i) * r + j) * n + x);
    else
      dst[e] = 0.0f;
  }
  cp_async_commit();
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
// is fk[x] (x < n): fused_irt.cu's invert_rows at one row, its sums in
// its order.
__device__ __forceinline__ Step invert_row(const float* fk,
                                           const float* __restrict__ xs,
                                           const float* __restrict__ hs,
                                           int n, float qk) {
  float tot = 0.0f;
  for (int x = 1; x < n; ++x)
    tot = __fadd_rn(tot, cell(fk[x - 1], fk[x], hs[x - 1]));
  const float x0 = xs[0];
  const bool bad = tot <= 0.0f;
  const float total = bad ? xs[n - 1] - x0 : tot;
  const float target = qk * total;
  float c = 0.0f;
  int cnt = 0;
  for (int j = 0; j < n; ++j) {
    const float xj = xs[j] - x0;
    cnt += ((bad ? xj : c) < target) ? 1 : 0;
    if (j < n - 1) c = __fadd_rn(c, cell(fk[j], fk[j + 1], hs[j]));
  }
  const int i0 = min(max(cnt - 1, 0), n - 2);
  c = 0.0f;
  for (int j = 0; j < i0; ++j) c = __fadd_rn(c, cell(fk[j], fk[j + 1], hs[j]));
  const float cv = bad ? xs[i0] - x0 : c;
  const float c1 = cv / total;
  const float f1 = (bad ? 1.0f : fk[i0]) / total;
  const float f2 = (bad ? 1.0f : fk[i0 + 1]) / total;
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

// q (m, d), p2 (d, r*r, n), coreu (d, n, r*r), x (d, n), h (d, n-1)
// -> out (m, d), lfout (m,).
__global__ void __launch_bounds__(kBlock)
fused_wide_kernel(const float* __restrict__ q, const float* __restrict__ p2,
                  const float* __restrict__ coreu,
                  const float* __restrict__ xg, const float* __restrict__ hg,
                  float* __restrict__ out, float* __restrict__ lfout, int m,
                  int d, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  const WidePlan pl = wide_plan(n, r);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* pht = smem;                                   // (r, bmp)
  float* ps = pht + static_cast<size_t>(r) * pl.bmp;   // 2 x (r, bn)
  float* fkt = ps + 2 * static_cast<size_t>(r) * pl.bn;  // (bm, fp)
  float* lfs = fkt + static_cast<size_t>(pl.bm) * pl.fp;  // (bm,)
  float* las = lfs + pl.bm;
  float* lbs = las + pl.bm;
  int* i0s = reinterpret_cast<int*>(lbs + pl.bm);
  const int slice = r * pl.bn;
  const int rg = tid / pl.ng, xgp = tid - rg * pl.ng;
  const bool active = rg < pl.rg;
  const size_t rr = static_cast<size_t>(r) * r;
  const int ntiles = (m + pl.bm - 1) / pl.bm;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * pl.bm;
    __syncthreads();                   // the last tile is done with smem
    for (int e = tid; e < r * pl.bm; e += kBlock) {
      const int j = e / pl.bm;
      const int row = e - j * pl.bm;
      pht[j * pl.bmp + row] = j == 0 ? 1.0f : 0.0f;
    }
    for (int row = tid; row < pl.bm; row += kBlock) lfs[row] = 0.0f;
    for (int k = 0; k < d; ++k) {
      const float* pk = p2 + static_cast<size_t>(k) * rr * n;
      const float* xs = xg + static_cast<size_t>(k) * n;
      const float* hs = hg + static_cast<size_t>(k) * (n - 1);
      __syncthreads();                 // phiT written; the ring is free
      load_slice(ps, pk, 0, n, r, pl.bn);

      // ---- the Gram conditional of the tile, a rank slice a step ----
      float f[kTM][kTN];
#pragma unroll
      for (int a = 0; a < kTM; ++a)
#pragma unroll
        for (int c = 0; c < kTN; ++c) f[a][c] = 0.0f;
      const float* pa = pht + rg * kTM;
      for (int i = 0; i < r; ++i) {
        cp_async_wait_all();           // slice i has landed
        __syncthreads();               // ... for every thread; i-1 free
        if (i + 1 < r)
          load_slice(ps + ((i + 1) & 1) * slice, pk, i + 1, n, r, pl.bn);
        if (!active) continue;
        const float* pb = ps + (i & 1) * slice + kTN * xgp;
        float v[kTM][kTN];
#pragma unroll
        for (int a = 0; a < kTM; ++a)
#pragma unroll
          for (int c = 0; c < kTN; ++c) v[a][c] = 0.0f;
#pragma unroll 4
        for (int j = 0; j < r; ++j) {
          const float4 w = *reinterpret_cast<const float4*>(pa + j * pl.bmp);
          const float4 b = *reinterpret_cast<const float4*>(pb + j * pl.bn);
          const float av[kTM] = {w.x, w.y, w.z, w.w};
          const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int a = 0; a < kTM; ++a)
#pragma unroll
            for (int c = 0; c < kTN; ++c)
              v[a][c] = fmaf(av[a], bv[c], v[a][c]);
        }
        const float4 w = *reinterpret_cast<const float4*>(pa + i * pl.bmp);
        const float ai[kTM] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int a = 0; a < kTM; ++a)
#pragma unroll
          for (int c = 0; c < kTN; ++c) f[a][c] = fmaf(ai[a], v[a][c], f[a][c]);
      }
      if (active) {
#pragma unroll
        for (int a = 0; a < kTM; ++a)
#pragma unroll
          for (int c = 0; c < kTN; ++c) {
            const int x = kTN * xgp + c;
            if (x < n) fkt[(rg * kTM + a) * pl.fp + x] = f[a][c];
          }
      }
      __syncthreads();                 // the fk tile is complete

      // ---- CDF, bracket, inversion: one thread a row ----
      for (int row = tid; row < pl.bm; row += kBlock) {
        const long long grow = row0 + row;
        if (grow >= m) continue;
        const Step st = invert_row(fkt + row * pl.fp, xs, hs, n,
                                   q[grow * d + k]);
        out[grow * d + k] = st.xk;
        lfs[row] += st.dlf;
        if (k == d - 1) lfout[grow] = lfs[row];
        las[row] = st.la;
        lbs[row] = st.lb;
        i0s[row] = st.i0;
      }
      __syncthreads();

      // ---- the prefix update: a warp a row, C_k's slices from L2 ----
      const float* ck = coreu + static_cast<size_t>(k) * n * rr;
      for (int row = warp; row < pl.bm; row += kBlock / 32) {
        if (row0 + row >= m) continue;
        const float la = las[row], lb = lbs[row];
        const float* ca = ck + i0s[row] * rr;
        const float* cb = ca + rr;
        float acc[kLanes];
#pragma unroll
        for (int u = 0; u < kLanes; ++u) acc[u] = 0.0f;
        for (int i = 0; i < r; ++i) {
          const float pi = pht[i * pl.bmp + row];
#pragma unroll
          for (int u = 0; u < kLanes; ++u) {
            const int j = lane + 32 * u;
            if (j < r) {
              const float b = la * ca[i * r + j] + lb * cb[i * r + j];
              acc[u] = fmaf(pi, b, acc[u]);
            }
          }
        }
        float scale = 0.0f;
#pragma unroll
        for (int u = 0; u < kLanes; ++u)
          if (lane + 32 * u < r) scale = fmaxf(scale, fabsf(acc[u]));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          scale = fmaxf(scale, __shfl_xor_sync(0xFFFFFFFFu, scale, off));
        const float denom = fmaxf(scale, 1e-30f);
        __syncwarp();                  // every lane has read the old phi
#pragma unroll
        for (int u = 0; u < kLanes; ++u) {
          const int j = lane + 32 * u;
          if (j < r) pht[j * pl.bmp + row] = acc[u] / denom;
        }
      }
    }
  }
  cp_async_wait_all();
}

}  // namespace

extern "C" {

// The tier's caps.
int fused_wide_max_n() { return kWideMaxN; }
int fused_wide_max_r() { return kWideMaxR; }
// Shared memory a launch at (n, r) within the caps asks for.
long long fused_wide_smem_bytes(int n, int r) {
  return static_cast<long long>(wide_plan(n, r).smem);
}

// Device pointers to contiguous f32 arrays q (m, d), p2 (d, r*r, n),
// coreu (d, n, r*r), x (d, n), h (d, n-1) -> out (m, d), lf (m,), all on
// device `device`, which must be the current device.  Returns the
// launch's cudaError_t (0 on success); asynchronous on `stream`.
int fused_wide_launch(const void* q, const void* p2, const void* coreu,
                      const void* x, const void* h, void* out, void* lf,
                      int m, int d, int n, int r, int device, void* stream) {
  if (m == 0 || d == 0) return 0;
  if (!in_wide_caps(n, r)) return static_cast<int>(cudaErrorInvalidValue);
  const WidePlan pl = wide_plan(n, r);
  if (pl.smem > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  const float* p[5];
  const void* in[5] = {q, p2, coreu, x, h};
  for (int k = 0; k < 5; ++k) p[k] = static_cast<const float*>(in[k]);
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lf);
  void* args[] = {&p[0], &p[1], &p[2], &p[3], &p[4], &o, &l, &m, &d, &n, &r};
  const void* kern = reinterpret_cast<const void*>(&fused_wide_kernel);
  int cap = 0;
  cudaError_t e = grid_cap(kern, device, pl.smem, &cap, kBlock);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (m + pl.bm - 1) / pl.bm;
  return static_cast<int>(cudaLaunchKernel(
      kern, dim3(tiles < cap ? tiles : cap), dim3(kBlock), args, pl.smem,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
