// Pieces shared by the port's row kernels (dim_step.cu, odim_step.cu,
// factor_step.cu, factor_conditional.cu, step.cu, fused_irt.cu): the
// rank tiers, the two-sided CDF with its bracket and readout, the f32
// cell weight, the prefix update, the shared-memory opt-in, and the
// cached launch geometry of a persistent kernel.  tc_conditional.cuh
// has the factor conditional of a tile on the tensor cores.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>

namespace ttirt {

constexpr int kThreads = 128;    // one row per thread
constexpr int kMaxN = 64;
constexpr int kMaxR = 64;
constexpr int kCacheSize = 32;   // launch configurations kept per library
// Dynamic shared memory one block may opt in to on sm_90 (227 KB); the
// wrappers refuse shapes that need more.
constexpr size_t kSmemOptIn = 227 * 1024;

// Rank tier of the kernel instantiated for rank r (r <= kMaxR).
inline int rank_tier(int r) {
  return r <= 8 ? 8 : r <= 16 ? 16 : r <= 24 ? 24 : r <= 32 ? 32 : kMaxR;
}

// Run STMT with the constant TIER set to the rank tier of r.
#define TTIRT_FOR_TIER(r, STMT)                                   \
  switch (ttirt::rank_tier(r)) {                                  \
    case 8: { constexpr int TIER = 8; STMT; } break;              \
    case 16: { constexpr int TIER = 16; STMT; } break;            \
    case 24: { constexpr int TIER = 24; STMT; } break;            \
    case 32: { constexpr int TIER = 32; STMT; } break;            \
    default: { constexpr int TIER = ttirt::kMaxR; STMT; } break;  \
  }

inline bool in_caps(int n, int r) {
  return n >= 2 && n <= kMaxN && r >= 1 && r <= kMaxR;
}

// One row's prefix into registers, zero beyond the true rank.
template <int RMAX>
__device__ __forceinline__ void load_row(float (&p)[RMAX], const float* phi,
                                         size_t row, int r) {
#pragma unroll
  for (int i = 0; i < RMAX; ++i) p[i] = (i < r) ? phi[row * r + i] : 0.0f;
}

// Solve A (x-x1)^2 + f1 (x-x1) = q - c1 on [x1, x2] in the citardauq
// form, clipped into the cell.
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

// What the two-sided CDF stage leaves of one row: the bracket, the nine
// scalars of the f64 epilogue (the grid's low parts are read at i0 by
// write_out9) and the f32 targets of the cell-weight solve.
struct Bracket {
  int i0;
  bool right;
  bool flat;                 // no mass: the uniform conditional (fk = 1)
  float qt, ut;              // f32 targets q * tot and um * tot
  float c1, cr2, f1, f2, x1, x2, tot;
};

// Two-sided trapezoid CDF of the row whose conditional sits in the
// shared column fcol (fcol[k * stride] at node k), count-based bracket
// and readout.
// Degenerate rows (no mass) take the uniform density.  The CDF rows are
// never stored: every pass rebuilds them by the same sequential sums,
// and the _rn intrinsics keep those sums free of FMA contraction, so
// the counting pass and the readout see bit-identical ck / cr values.
// RT: the bracket is that of the point q on the grid; otherwise that of
// the seed q, with um its complement (from the left for q <= 0.5, from
// the right above it).
template <bool RT>
__device__ __forceinline__ Bracket cdf_bracket(const float* fcol, int stride,
                                               const float* __restrict__ h,
                                               const float* __restrict__ x32,
                                               int n, float q, float um) {
  auto cell = [&](float a, float b, int k) {
    return __fmul_rn(__fmul_rn(0.5f, __fadd_rn(a, b)), h[k]);
  };
  float total = 0.0f;
  for (int k = 0; k < n - 1; ++k)
    total = __fadd_rn(total, cell(fcol[k * stride],
                                  fcol[(k + 1) * stride], k));
  const bool bad = total <= 0.0f;
  auto fval = [&](int k) { return bad ? 1.0f : fcol[k * stride]; };
  auto dcv = [&](int k) { return bad ? h[k] : cell(fval(k), fval(k + 1), k); };
  Bracket b;
  b.flat = bad;
  b.tot = 0.0f;                             // ck[n-1]
  for (int k = 0; k < n - 1; ++k) b.tot = __fadd_rn(b.tot, dcv(k));

  b.right = false;
  b.qt = 0.0f;
  b.ut = 0.0f;
  int cnt = 0;
  if (RT) {
    for (int k = 0; k < n; ++k) cnt += (x32[k] < q) ? 1 : 0;
  } else {
    b.right = q > 0.5f;                     // the f32 seed, as the epilogue
    b.qt = q * b.tot;
    b.ut = um * b.tot;
    if (b.right) {
      float s = 0.0f;                       // cr[k], summed from the right
      cnt = (s > b.ut) ? 1 : 0;             // cr[n-1] = 0
      for (int k = n - 2; k >= 0; --k) {
        s = __fadd_rn(s, dcv(k));
        cnt += (s > b.ut) ? 1 : 0;
      }
    } else {
      float c = 0.0f;                       // ck[k], summed from the left
      for (int k = 0; k < n; ++k) {
        cnt += (c < b.qt) ? 1 : 0;
        if (k < n - 1) c = __fadd_rn(c, dcv(k));
      }
    }
  }
  b.i0 = min(max(cnt - 1, 0), n - 2);

  // readout: the same sequential sums up to the bracket
  b.c1 = 0.0f;
  for (int k = 0; k < b.i0; ++k) b.c1 = __fadd_rn(b.c1, dcv(k));
  b.cr2 = 0.0f;
  for (int k = n - 2; k > b.i0; --k) b.cr2 = __fadd_rn(b.cr2, dcv(k));
  b.f1 = fval(b.i0);
  b.f2 = fval(b.i0 + 1);
  b.x1 = x32[b.i0];
  b.x2 = x32[b.i0 + 1];
  return b;
}

// out9 = [c1, cr2, f1, f2, x1h, x1l, x2h, x2l, tot] of one row.
__device__ __forceinline__ void write_out9(float* o, const Bracket& b,
                                           const float* __restrict__ xlo) {
  o[0] = b.c1;
  o[1] = b.cr2;
  o[2] = b.f1;
  o[3] = b.f2;
  o[4] = b.x1;
  o[5] = xlo[b.i0];
  o[6] = b.x2;
  o[7] = xlo[b.i0 + 1];
  o[8] = b.tot;
}

// f32 weight la of the left node of the bracket (for the prefix update
// only; samples and log-density come from the f64 epilogue).  The right
// node's weight is 1 - la, taken after the clip.
template <bool RT>
__device__ __forceinline__ float cell_weight(const Bracket& b, float q) {
  float xk;
  if (RT) {
    xk = q;
  } else if (b.right) {
    xk = -invert_quadratic(b.f2, b.f1, b.cr2, b.ut, -b.x2, -b.x1);
  } else {
    xk = invert_quadratic(b.f1, b.f2, b.c1, b.qt, b.x1, b.x2);
  }
  return fminf(fmaxf((b.x2 - xk) / (b.x2 - b.x1), 0.0f), 1.0f);
}

// acc /= max|acc| over the true rank (floor 1e-30).
template <int RMAX>
__device__ __forceinline__ void normalize_row(float (&acc)[RMAX], int r) {
  float scale = 0.0f;
#pragma unroll
  for (int j = 0; j < RMAX; ++j)
    if (j < r) scale = fmaxf(scale, fabsf(acc[j]));
  const float denom = fmaxf(scale, 1e-30f);
#pragma unroll
  for (int j = 0; j < RMAX; ++j)
    if (j < r) acc[j] = acc[j] / denom;
}

// One row's r entries back to global memory.
template <int RMAX>
__device__ __forceinline__ void store_row(float* out, size_t row, int r,
                                          const float (&acc)[RMAX]) {
#pragma unroll
  for (int j = 0; j < RMAX; ++j)
    if (j < r) out[row * r + j] = acc[j];
}

// acc = p (la Ca + lb Cb) / max|.| (floor 1e-30), where Ca and Cb are two
// (r, r) row-major core slices (global or shared memory) and p holds the
// row's prefix in its first r entries.  Entries j >= r of acc are 0.
template <int RMAX>
__device__ __forceinline__ void prefix_update(const float (&p)[RMAX], float la,
                                              float lb, const float* ca,
                                              const float* cb, int r,
                                              float (&acc)[RMAX]) {
#pragma unroll
  for (int j = 0; j < RMAX; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < RMAX; ++i) {
    if (i < r) {
#pragma unroll
      for (int j = 0; j < RMAX; ++j) {
        if (j < r) {
          const float b = la * ca[i * r + j] + lb * cb[i * r + j];
          acc[j] = fmaf(p[i], b, acc[j]);
        }
      }
    }
  }
  normalize_row<RMAX>(acc, r);
}

// Allow kern (a __global__ function's address) `smem` bytes of dynamic
// shared memory on the current device.
inline cudaError_t ensure_smem(const void* kern, size_t smem) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Grid size of one persistent kernel (a __global__ function's address)
// on one device at one shared-memory size and block size: resident
// blocks per SM times SMs.  The shared-memory attribute and the
// residency depend only on these, so they are asked once and kept, not
// on every launch.  The attribute is set to the largest size cached for
// that kernel and device, so it covers every cached size.
inline cudaError_t grid_cap(const void* kern, int device, size_t smem,
                            int* cap, int threads = kThreads) {
  struct Entry {
    const void* kern;
    int device;
    size_t smem;
    int threads;
    int cap;
  };
  static std::mutex mu;
  static Entry table[kCacheSize];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  size_t attr = smem;
  for (int i = 0; i < used; ++i) {
    if (table[i].kern != kern || table[i].device != device) continue;
    if (table[i].smem == smem && table[i].threads == threads) {
      *cap = table[i].cap;
      return cudaSuccess;
    }
    if (table[i].smem > attr) attr = table[i].smem;
  }
  cudaError_t e = ensure_smem(kern, attr);
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  table[next] = Entry{kern, device, smem, threads, per_sm * sms};
  next = (next + 1) % kCacheSize;
  used = used < kCacheSize ? used + 1 : kCacheSize;
  *cap = per_sm * sms;
  return cudaSuccess;
}

}  // namespace ttirt
