// Pieces shared by the port's row kernels (dim_step.cu, step.cu,
// fused_irt.cu): the rank tiers, the Gram conditional and the prefix
// update of one row, the shared-memory opt-in, and the cached launch
// geometry of a persistent kernel.

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

// Stage a Gram field P (r*r, n), P[i*r + j, x], into shared memory
// regrouped by node: ps[(x*r + i)*RMAX + j] = P[i*r + j, x].  Reads
// follow P's row-major order.  The lanes j >= r are not written:
// zero_gram_pad clears them once.
template <int RMAX>
__device__ __forceinline__ void stage_gram(float* ps, const float* pmat,
                                           int n, int r) {
  const int rr = r * r;
  for (int idx = threadIdx.x; idx < rr * n; idx += blockDim.x) {
    const int ij = idx / n;
    const int x = idx - ij * n;
    const int i = ij / r;
    const int j = ij - i * r;
    ps[(x * r + i) * RMAX + j] = pmat[idx];
  }
}

template <int RMAX>
__device__ __forceinline__ void zero_gram_pad(float* ps, int n, int r) {
  for (int idx = threadIdx.x; idx < n * r * (RMAX - r); idx += blockDim.x) {
    const int xi = idx / (RMAX - r);
    const int j = r + (idx - xi * (RMAX - r));
    ps[xi * RMAX + j] = 0.0f;
  }
}

// fk at one grid node for this thread's row: sum_i phi_i (sum_j P_ij
// phi_j), for a general P.  pnode is the node's (r, RMAX) block of the
// staged field, read as float4 broadcasts; p holds phi in registers for
// the inner product over j, phicol is the thread's phi column in shared
// memory (stride kThreads) for the outer factor, whose index runs over
// the true rank.
template <int RMAX>
__device__ __forceinline__ float gram_node(const float* pnode,
                                           const float* phicol,
                                           const float (&p)[RMAX], int r) {
  float f = 0.0f;
  for (int i = 0; i < r; ++i) {
    const float4* pc = reinterpret_cast<const float4*>(pnode + i * RMAX);
    float v = 0.0f;
#pragma unroll
    for (int j4 = 0; j4 < RMAX / 4; ++j4) {
      const float4 b = pc[j4];
      v = fmaf(p[4 * j4 + 0], b.x, v);
      v = fmaf(p[4 * j4 + 1], b.y, v);
      v = fmaf(p[4 * j4 + 2], b.z, v);
      v = fmaf(p[4 * j4 + 3], b.w, v);
    }
    f = fmaf(phicol[i * kThreads], v, f);
  }
  return f;
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
  float scale = 0.0f;
#pragma unroll
  for (int j = 0; j < RMAX; ++j)
    if (j < r) scale = fmaxf(scale, fabsf(acc[j]));
  const float denom = fmaxf(scale, 1e-30f);
#pragma unroll
  for (int j = 0; j < RMAX; ++j)
    if (j < r) acc[j] = acc[j] / denom;
}

// Allow kern (a __global__ function's address) `smem` bytes of dynamic
// shared memory on the current device.
inline cudaError_t ensure_smem(const void* kern, size_t smem) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Grid size of one persistent kernel (a __global__ function's address)
// on one device at one shared-memory size: resident blocks per SM times
// SMs.  The shared-memory attribute and the residency depend only on
// the kernel, smem and the device, so they are asked once and kept, not
// on every launch.  The attribute is set to the largest size cached for
// that kernel and device, so it covers every cached size.
inline cudaError_t grid_cap(const void* kern, int device, size_t smem,
                            int* cap) {
  struct Entry {
    const void* kern;
    int device;
    size_t smem;
    int cap;
  };
  static std::mutex mu;
  static Entry table[kCacheSize];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  size_t attr = smem;
  for (int i = 0; i < used; ++i) {
    if (table[i].kern != kern || table[i].device != device) continue;
    if (table[i].smem == smem) {
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
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  table[next] = Entry{kern, device, smem, per_sm * sms};
  next = (next + 1) % kCacheSize;
  used = used < kCacheSize ? used + 1 : kCacheSize;
  *cap = per_sm * sms;
  return cudaSuccess;
}

}  // namespace ttirt
