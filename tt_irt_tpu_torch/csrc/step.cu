// The two contractions of one Gram-form inverse-Rosenblatt dimension
// ('f32'/'mixed'/'gs' precision), for Hopper (sm_90a); condition_update
// is also the last kernel of the split factor steps ('hi' at
// hi_step="bracket"/"pair", 'hid').
//
// gram_conditional replaces
// tt_irt_tpu/ops/pallas_step.py::gram_conditional (:188, _gram_kernel):
//   fk[m, x] = sum_ij phi[m, i] P[i*r + j, x] phi[m, j]
// condition_update replaces
// tt_irt_tpu/ops/pallas_step.py::condition_update (:238, _update_kernel):
//   phi'[m] = phi[m] (la[m] C[i0[m]] + lb[m] C[i0[m]+1]) / max|.|
// with the floor 1e-30 on the divisor.  The CDF build and inversion
// between the two, which stays in XLA between the two TPU kernels, is
// csrc/cdf_invert.cu at an f32 CDF and PyTorch otherwise (ops/cdf.py).
// The TPU kernels build the outer product, the one-hot weights and the
// batched matvec out of matmuls against 0/1 structure matrices because
// Mosaic cannot reshape or gather; here they are index arithmetic and
// shared-memory reads.
//
// gram_conditional: n r^2 FMAs a row (6.1k at n=17, r=19) against
// 4 (r + n) bytes of row traffic, so the FP32 pipe bounds it (0.049 ms
// at 2^18 rows).  P is staged once per persistent block in shared
// memory, regrouped by node and read as float4 broadcasts.  One thread
// a row made it bound by shared-memory issue instead: each float4 fed 4
// FMAs, and the outer factor phi_i came from a shared column per thread.
// Here each thread takes R rows (gram_rows: 4 up to tier 24, in 128
// registers at tier 24; 2 at tier 32 and 1 at tier 64, 64 phi registers
// each; tools/tc_variants.py --step times R = 2 beside R = 4) with their
// phi in registers, and both loops run unrolled over the rank tier with
// the true rank as a uniform guard, so that phi_i is a register too and
// shared memory holds P alone (ps[(x*r + i)*rj + j] = P[i*r + j, x],
// rj = r rounded up to 4, zero-padded): each float4 feeds 4R FMAs, the
// inner loop stops at rj, and blocks are small enough to keep many warps
// resident.  Every row's sum is the one-row-a-thread chain of the
// first port's kernel (fused_irt.cu's Gram loop runs the same one):
// v_i = sum_j P_ij phi_j by fmaf over j in order, f = fmaf(phi_i, v_i, f)
// over i in order, so fk equals that chain's bit for bit (the padding
// adds exact zeros).  Work goes out by
// warp: a warp takes 32R consecutive rows at a time.  fk leaves by rows
// (n floats a row).
//
// condition_update: 5 r^2 + 2r operations a row (an FMA counts two)
// against 4 (2r + 3) bytes, so HBM bounds it (0.0128 ms at 2^18 rows,
// r=19; the FP32 pipe would take 0.0072 ms) if the core's two slices
// (2 r^2 floats a row) come from shared memory; read from L2 they took
// 0.134 ms.  The whole core, n r^2 floats (24.5 KB at n=17, r=19; 69.8 KB
// at n=33, r=23), is staged once per persistent block by cp.async, and
// the rows read their slices from there; shared-memory bandwidth then
// bounds the kernel (2 r^2 four-byte reads a row, 0.026 ms at 2^18 rows
// and r=19).  The 32 lanes of a warp read the same (i, j) of different
// nodes, a node stride apart: the stride is r^2 made odd (+1 where r is
// even), so that distinct nodes fall in distinct banks (r^2 mod 32 = 0
// at r=16 would put all 32 lanes in one bank).  Rows stay one a thread,
// with prefix_update's arithmetic (interpolate first, then one FMA chain
// a column), so phi' equals the L2-reading kernel's bit for bit; the
// row's prefix is read from the staged tile (update_row), so that the
// loop over i runs to the true rank, not to the tier.  Each 128-row tile
// of phi comes in by cp.async as whole lines into a shared buffer (odd
// row pitch: conflict-free one-row-a-thread reads) while the tile before
// it is computed, and phi' goes out through the same buffer as whole
// lines.  A core larger than shared memory beside the two tiles (n=64 at
// r >= 29, for example) is read from global memory (the kernel's
// STAGED = false instance); no shipped stack comes near that.
//
// The wide tier: every shape with n <= 128 and r <= 128 that the tiers
// above refuse (n or r above 64, or gram_conditional's P past the
// shared-memory opt-in).  At rank 128 neither the core (n r^2 floats,
// 590 KB at n=9) nor P fits shared memory, and a row's phi no longer
// fits one thread's registers:
//   condition_update past n or r of 64 (update_wide) is not in this
//   library: cell_readout.cu groups the rows by cell and runs the update
//   as 3xTF32 products on the tensor cores (its own source and scratch;
//   ops/step.py routes the shapes, and condition_update_launch here
//   refuses them).
//   gram_conditional past its narrow tier (gram_wide) is not in this
//   library either: gram_wide.cu runs it as 3xTF32 products on the
//   tensor cores (tc_gram.cuh's Gram stage, which fused_wide.cu shares;
//   its own source and scratch; ops/step.py routes the shapes, and
//   gram_conditional_launch here refuses them).
// Past n or r of 128 the launch returns cudaErrorInvalidValue and the
// wrappers raise first, naming the caps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz).

#include <cstdint>

#include "row_common.cuh"

namespace {

using namespace ttirt;

constexpr int kWarps = kThreads / 32;
// The wide tier's caps.
constexpr int kWideMaxN = 128;
constexpr int kWideMaxR = 128;

// Rows of one thread of gram_conditional at rank tier T.
template <int T>
constexpr int gram_rows() { return T <= 24 ? 4 : T <= 32 ? 2 : 1; }

__host__ __device__ inline int round4(int r) { return (r + 3) & ~3; }

// Rows a thread takes at rank r.
int gram_rows_at(int r) {
  int rows = 0;
  TTIRT_FOR_TIER(r, rows = gram_rows<TIER>());
  return rows;
}

// Dynamic shared memory of one block: P padded to rj (147 KB at n=64,
// r=24).
size_t gram_smem_bytes(int n, int r) {
  return static_cast<size_t>(n) * r * round4(r) * sizeof(float);
}

template <int RMAX, int R>
__global__ void __launch_bounds__(kThreads)
gram_conditional_kernel(const float* __restrict__ phi,
                        const float* __restrict__ pmat,
                        float* __restrict__ fk, int m, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  const int rj = round4(r);
  float* ps = smem;                        // (n*r, rj)
  const int tid = threadIdx.x, lane = tid & 31;

  // ps[(x*r + i)*rj + j] = P[i*r + j, x], reads in P's order
  for (int idx = tid; idx < r * r * n; idx += kThreads) {
    const int ij = idx / n;
    const int x = idx - ij * n;
    const int i = ij / r;
    ps[(x * r + i) * rj + ij - i * r] = pmat[idx];
  }
  for (int idx = tid; idx < n * r * (rj - r); idx += kThreads) {
    const int xi = idx / (rj - r);
    ps[xi * rj + r + idx - xi * (rj - r)] = 0.0f;
  }
  __syncthreads();

  const int jobs = (m + 32 * R - 1) / (32 * R);
  for (int job = blockIdx.x * kWarps + (tid >> 5); job < jobs;
       job += gridDim.x * kWarps) {
    // this lane's rows: base + 32k, k < R
    const long long base = static_cast<long long>(job) * 32 * R + lane;
    float p[R][RMAX];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long row = base + 32 * k;
#pragma unroll
      for (int i = 0; i < RMAX; ++i)
        p[k][i] = (row < m && i < r) ? phi[row * r + i] : 0.0f;
    }
    for (int x = 0; x < n; ++x) {
      const float* pnode = ps + x * r * rj;
      float f[R];
#pragma unroll
      for (int k = 0; k < R; ++k) f[k] = 0.0f;
#pragma unroll
      for (int i = 0; i < RMAX; ++i) {
        if (i < r) {
          const float4* pc = reinterpret_cast<const float4*>(pnode + i * rj);
          float v[R];
#pragma unroll
          for (int k = 0; k < R; ++k) v[k] = 0.0f;
#pragma unroll
          for (int j4 = 0; j4 < RMAX / 4; ++j4) {
            if (4 * j4 < r) {
              const float4 b = pc[j4];
#pragma unroll
              for (int k = 0; k < R; ++k) {
                v[k] = fmaf(p[k][4 * j4 + 0], b.x, v[k]);
                v[k] = fmaf(p[k][4 * j4 + 1], b.y, v[k]);
                v[k] = fmaf(p[k][4 * j4 + 2], b.z, v[k]);
                v[k] = fmaf(p[k][4 * j4 + 3], b.w, v[k]);
              }
            }
          }
#pragma unroll
          for (int k = 0; k < R; ++k) f[k] = fmaf(p[k][i], v[k], f[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const long long row = base + 32 * k;
        if (row < m) fk[row * n + x] = f[k];
      }
    }
  }
}

// ---- condition_update ----

// cp.async of one 4-byte word, global -> shared, and its groups.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Odd strides: the staged core's node stride and the tiles' row pitch.
__host__ __device__ inline int odd(int k) { return k | 1; }

inline size_t update_tiles_floats(int r) {
  return 2 * static_cast<size_t>(kThreads) * odd(r);
}

// The core staged in shared memory at (n, r): it fits beside the tiles.
bool update_staged(int n, int r) {
  return (update_tiles_floats(r) + static_cast<size_t>(n) * odd(r * r))
             * sizeof(float) <= kSmemOptIn;
}

size_t update_smem_bytes(int n, int r) {
  return (update_tiles_floats(r)
          + (update_staged(n, r) ? static_cast<size_t>(n) * odd(r * r) : 0))
         * sizeof(float);
}

// The phi rows of the tile at row0 (at most kThreads) into buf, pitch
// odd(r), by cp.async: consecutive threads copy consecutive words.
__device__ __forceinline__ void load_tile(float* buf,
                                          const float* __restrict__ phi,
                                          long long row0, int m, int r) {
  const long long left = m - row0;
  const int words = static_cast<int>(left < kThreads ? left : kThreads) * r;
  const float* src = phi + row0 * r;
  for (int e = threadIdx.x; e < words; e += kThreads) {
    const int row = e / r;
    cp_async4(buf + row * odd(r) + e - row * r, src + e);
  }
}

// prefix_update (row_common.cuh) with the row's prefix read from shared
// memory (prow), so that its loop over i runs to the true rank, not to
// the tier: acc = p (la Ca + lb Cb) / max|.|, the same operations in the
// same order.
template <int RMAX>
__device__ __forceinline__ void update_row(const float* prow, float la,
                                           float lb, const float* ca,
                                           const float* cb, int r,
                                           float (&acc)[RMAX]) {
#pragma unroll
  for (int j = 0; j < RMAX; ++j) acc[j] = 0.0f;
  for (int i = 0; i < r; ++i) {
    const float pi = prow[i];
#pragma unroll
    for (int j = 0; j < RMAX; ++j) {
      if (j < r) {
        const float b = la * ca[i * r + j] + lb * cb[i * r + j];
        acc[j] = fmaf(pi, b, acc[j]);
      }
    }
  }
  normalize_row<RMAX>(acc, r);
}

template <int RMAX, bool STAGED>
__global__ void __launch_bounds__(kThreads)
condition_update_kernel(const float* __restrict__ phi,
                        const int* __restrict__ i0v,
                        const float* __restrict__ la,
                        const float* __restrict__ lb,
                        const float* __restrict__ cmat,
                        float* __restrict__ phin, int m, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int rr = r * r, pitch = odd(r);
  float* tiles = smem;                       // 2 x (kThreads, pitch)
  float* cs = smem + 2 * kThreads * pitch;   // (n, odd(rr))
  const int stride = STAGED ? odd(rr) : rr;
  const float* core = STAGED ? cs : cmat;

  if (STAGED) {
    for (int idx = tid; idx < n * rr; idx += kThreads) {
      const int x = idx / rr;
      cp_async4(cs + x * stride + idx - x * rr, cmat + idx);
    }
  }
  const int ntiles = (m + kThreads - 1) / kThreads;
  if (blockIdx.x < ntiles)
    load_tile(tiles, phi, static_cast<long long>(blockIdx.x) * kThreads, m,
              r);
  cp_async_commit();                 // the core and the first tile

  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    float* buf = tiles + (it & 1) * kThreads * pitch;
    const int next = tile + gridDim.x;
    if (next < ntiles)
      load_tile(tiles + ((it + 1) & 1) * kThreads * pitch, phi,
                static_cast<long long>(next) * kThreads, m, r);
    cp_async_commit();
    cp_async_wait<1>();              // all but the next tile have landed
    __syncthreads();

    const long long row0 = static_cast<long long>(tile) * kThreads;
    const long long row = row0 + tid;
    if (row < m) {
      const int i0 = min(max(i0v[row], 0), n - 2);
      const float* ca = core + static_cast<size_t>(i0) * stride;
      float acc[RMAX];
      update_row<RMAX>(buf + tid * pitch, la[row], lb[row], ca, ca + stride,
                       r, acc);
#pragma unroll
      for (int j = 0; j < RMAX; ++j)
        if (j < r) buf[tid * pitch + j] = acc[j];
    }
    __syncthreads();                 // the tile's phi' complete
    const long long left = m - row0;
    const int words = static_cast<int>(left < kThreads ? left : kThreads) * r;
    float* dst = phin + row0 * r;
    for (int e = tid; e < words; e += kThreads) {
      const int rw = e / r;
      dst[e] = buf[rw * pitch + e - rw * r];
    }
    __syncthreads();                 // buf is free for the tile after next
  }
  cp_async_wait<0>();
}

// ---- the wide tier ----

inline bool in_wide_caps(int n, int r) {
  return n >= 2 && n <= kWideMaxN && r >= 1 && r <= kWideMaxR;
}

// Whether (n, r) goes past this library's tiers (gram_wide.cu,
// cell_readout.cu).
bool gram_wide(int n, int r) {
  return !in_caps(n, r) || gram_smem_bytes(n, r) > kSmemOptIn;
}
bool update_wide(int n, int r) { return !in_caps(n, r); }

// Persistent launch of kern at `smem` bytes, `blocks` wanted.
inline cudaError_t launch_persistent(const void* kern, void** args,
                                     int blocks, size_t smem, int device,
                                     cudaStream_t stream) {
  int cap = 0;
  cudaError_t e = grid_cap(kern, device, smem, &cap);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernel(kern, dim3(blocks < cap ? blocks : cap),
                          dim3(kThreads), args, smem, stream);
}

template <int RMAX>
cudaError_t launch_gram(const float* phi, const float* pmat, float* fk, int m,
                        int n, int r, int device, cudaStream_t stream) {
  void* args[] = {&phi, &pmat, &fk, &m, &n, &r};
  const size_t smem = gram_smem_bytes(n, r);
  constexpr int R = gram_rows<RMAX>();
  const int jobs = (m + 32 * R - 1) / (32 * R);
  return launch_persistent(
      reinterpret_cast<const void*>(&gram_conditional_kernel<RMAX, R>), args,
      (jobs + kWarps - 1) / kWarps, smem, device, stream);
}

template <int RMAX>
cudaError_t launch_update(const float* phi, const int* i0, const float* la,
                          const float* lb, const float* cmat, float* phin,
                          int m, int n, int r, int device,
                          cudaStream_t stream) {
  void* args[] = {&phi, &i0, &la, &lb, &cmat, &phin, &m, &n, &r};
  const void* kern =
      update_staged(n, r)
          ? reinterpret_cast<const void*>(&condition_update_kernel<RMAX, true>)
          : reinterpret_cast<const void*>(
                &condition_update_kernel<RMAX, false>);
  return launch_persistent(kern, args, (m + kThreads - 1) / kThreads,
                           update_smem_bytes(n, r), device, stream);
}

}  // namespace

extern "C" {

// Caps the wrappers check before launching: the wide tiers'.
int step_max_n() { return kWideMaxN; }
int step_max_r() { return kWideMaxR; }
// Whether gram_conditional at (n, r) within the caps goes past this
// library's tier (1: gram_wide.cu's gram_wide_launch takes it) or to it
// (0).
int gram_conditional_tier(int n, int r) { return gram_wide(n, r) ? 1 : 0; }
// Shared memory a gram_conditional launch of this library at (n, r)
// asks for (0 past its tier), and the rows a thread takes there (0 past
// its tier).
long long gram_conditional_smem_bytes(int n, int r) {
  return gram_wide(n, r) ? 0
                         : static_cast<long long>(gram_smem_bytes(n, r));
}
int gram_conditional_rows(int n, int r) {
  return gram_wide(n, r) ? 0 : gram_rows_at(r);
}
// Whether condition_update at (n, r) within the caps goes past this
// library's tier (1: n or r above 64; cell_readout.cu's
// condition_update_wide_launch takes it) or to it (0).
int condition_update_tier(int n, int r) { return update_wide(n, r) ? 1 : 0; }
// Shared memory a condition_update launch of this library at (n, r) asks
// for (0 past its tier), and whether it stages the core (1) or reads it
// from global memory (0; 0 past its tier).
long long condition_update_smem_bytes(int n, int r) {
  return update_wide(n, r) ? 0
                           : static_cast<long long>(update_smem_bytes(n, r));
}
int condition_update_staged(int n, int r) {
  return !update_wide(n, r) && update_staged(n, r);
}

// Device pointers to contiguous f32 arrays phi (m, r), pmat (r*r, n)
// -> fk (m, n), all on device `device`, which must be the current
// device.  Returns the launch's cudaError_t (cudaErrorInvalidValue past
// this library's tier: gram_conditional_tier); asynchronous on `stream`.
int gram_conditional_launch(const void* phi, const void* pmat, void* fk, int m,
                            int n, int r, int device, void* stream) {
  if (m == 0) return 0;
  if (!in_wide_caps(n, r) || gram_wide(n, r))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(phi);
  const float* b = static_cast<const float*>(pmat);
  float* o = static_cast<float*>(fk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  TTIRT_FOR_TIER(r, e = launch_gram<TIER>(a, b, o, m, n, r, device, s));
  return static_cast<int>(e);
}

// Device pointers to contiguous arrays phi (m, r) f32, i0 (m,) int32,
// la, lb (m,) f32, cmat (n, r*r) f32 -> phin (m, r) f32, all on device
// `device`, which must be the current device.  Returns the launch's
// cudaError_t (cudaErrorInvalidValue past this library's tier:
// condition_update_tier); asynchronous on `stream`.
int condition_update_launch(const void* phi, const void* i0, const void* la,
                            const void* lb, const void* cmat, void* phin,
                            int m, int n, int r, int device, void* stream) {
  if (m == 0) return 0;
  if (!in_wide_caps(n, r) || update_wide(n, r))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(phi);
  const int* ix = static_cast<const int*>(i0);
  const float* wa = static_cast<const float*>(la);
  const float* wb = static_cast<const float*>(lb);
  const float* c = static_cast<const float*>(cmat);
  float* o = static_cast<float*>(phin);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  TTIRT_FOR_TIER(r, e = launch_update<TIER>(a, ix, wa, wb, c, o, m, n, r,
                                            device, s));
  return static_cast<int>(e);
}

}  // extern "C"
