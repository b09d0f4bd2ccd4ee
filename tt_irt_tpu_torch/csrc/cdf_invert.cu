// The Gram family's CDF build, bracket and in-cell solve on f32 rows, for
// Hopper (sm_90a): ops/cdf.py::cdf_invert_ref's function in one launch.
//
// It replaces no TPU kernel: the JAX package computes this step in plain
// jnp (tt_irt_tpu/samplers/irt_scan.py::_cdf_invert) between its two
// Pallas kernels, and the port did the same in PyTorch, about a hundred
// device operations a dimension, many of them whole passes over fk.  Per
// row of fk (n nodes, unnormalised):
//   dc_j = 0.5 (f_j + f_{j+1}) h_{j+1}, tot = sum_j dc_j; a row with
//   tot <= 0 takes the uniform density (dc_j = x_{j+1} - x_j, f = 1);
//   dc_j /= tot, f_j /= tot; ck_j the running sum from the left, cr_j the
//   running sum from the right (ck_0 = cr_{n-1} = 0);
//   the count-based bracket: i0 = #{j: ck_j < q} - 1 for q <= 0.5,
//   #{j: cr_j > 1 - q} - 1 above it, #{j: x_j < q} - 1 in mode 'rt',
//   clipped to [0, n-2]; at 'f32' fk may be slightly negative and ck not
//   monotone, so the bracket counts (a first-crossing walk would pick
//   another cell);
//   the citardauq solve in the cell from the bracket's side (in mode
//   'rt' the CDF at the point), the node weights la, lb and
//   dlf = log(f1 la + f2 lb).
// Every operation is the plain version's, in its order, with the _rn
// intrinsics (no FMA contraction) and NaN-propagating min / max; the
// running sums are sequential in both (PyTorch's scan along the outer
// dimension on the card).  The one difference is the row's total, a
// tree sum in PyTorch: here a compensated (Kahan) sum in order, whose
// error does not grow with n, so that the kernel is as accurate as the
// plain version (a plain sum in order was not, at the 99th percentile,
// by n = 128).  Rows whose sums are exact in f32 give the plain
// version's results bit for bit (tests/test_torch_cuda.py).
//
// Bound: bytes.  A row reads n + 2 floats (fk, the seed, lf) and writes
// five words (the sample, lf, la, lb, i0): 4 (n + 7) bytes, 100.7 MB at
// 2^20 rows and n = 17, 30.0 us at 3.35 TB/s, against about 7 operations
// a node.
// One thread a row reading fk from device memory would not coalesce (a
// row is 68 bytes at n = 17), so a block first stages a contiguous tile
// of rows with 16-byte loads into shared memory, at an odd row pitch so
// that the one-row-a-thread reads that follow fall in distinct banks;
// the grid, its spacings and the cell widths sit beside it.  Each thread
// then runs its row from shared memory: the CDF rows are never stored,
// every pass (the total, the count, the readout) rebuilds the same
// sequential sums, so the count and the readout see identical values.
// The outputs go out once, coalesced across the block's threads: the
// sample into the caller's row, dlf added into the running lf, la, lb
// (f32) and i0 (int32), what condition_update takes.
//
// Caps: 2 <= n <= 128 (gram_conditional's on the card); past them the
// launch returns cudaErrorInvalidValue and the wrapper raises first.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxN = 128;

// Rows (and threads) of a block: the tile stays under the 48 KB of
// shared memory a block gets without an opt-in.
inline int block_rows(int n) { return n <= 64 ? 128 : 64; }

size_t smem_bytes(int n) {
  return sizeof(float) *
         (static_cast<size_t>(block_rows(n)) * (n | 1) + 3 * n);
}

// torch.maximum / torch.minimum: a NaN operand gives NaN.
__device__ __forceinline__ float tmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// rowmath.invert_quadratic: A (x-x1)^2 + f1 (x-x1) = q - c1 on [x1, x2]
// in the citardauq form, clipped into the cell.
__device__ __forceinline__ float invert_quadratic(float f1, float f2,
                                                  float c1, float q,
                                                  float x1, float x2) {
  const float aq = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(f2, f1)),
                             __fsub_rn(x2, x1));
  const float t = __fsub_rn(q, c1);
  const float dq = __fadd_rn(__fmul_rn(f1, f1),
                             __fmul_rn(__fmul_rn(4.0f, aq), t));
  const float den = __fadd_rn(f1, __fsqrt_rn(tmax(dq, 0.0f)));
  const float xk = (den <= 0.0f)
                       ? x1
                       : __fadd_rn(x1, __fdiv_rn(__fmul_rn(2.0f, t), den));
  return tmin(tmax(xk, x1), x2);
}

// One term of a compensated (Kahan) sum: s += v, carrying in c the
// rounding error of the running sum (nvcc keeps IEEE order without
// fast-math, so c is not optimised away).
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = __fsub_rn(v, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

template <bool RT>
__global__ void cdf_invert_kernel(const float* __restrict__ fk,
                                  const float* __restrict__ xp,
                                  const float* __restrict__ h,
                                  const float* __restrict__ qp,
                                  float* __restrict__ out,
                                  float* __restrict__ lf,
                                  float* __restrict__ la,
                                  float* __restrict__ lb,
                                  int* __restrict__ i0, int m, int n) {
  extern __shared__ float smem[];
  const int rows = blockDim.x;
  const int pitch = n | 1;
  float* tile = smem;
  float* xs = tile + rows * pitch;
  float* hs = xs + n;
  float* gd = hs + n;            // cell widths x_{j+1} - x_j
  const size_t row0 = static_cast<size_t>(blockIdx.x) * rows;
  const int nrows = min(rows, static_cast<int>(m - row0));
  const float* src = fk + row0 * n;
  const int count = nrows * n;

  for (int k = threadIdx.x; k < n; k += rows) {
    xs[k] = xp[k];
    hs[k] = h[k];
    if (k < n - 1) gd[k] = __fsub_rn(xp[k + 1], xp[k]);
  }
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* v = reinterpret_cast<const float4*>(src);
    const int nv = count >> 2;
    for (int k = threadIdx.x; k < nv; k += rows) {
      const float4 a = v[k];
      const float e4[4] = {a.x, a.y, a.z, a.w};
      int r = (4 * k) / n;
      int c = 4 * k - r * n;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        tile[r * pitch + c] = e4[u];
        if (++c == n) {
          c = 0;
          ++r;
        }
      }
    }
    done = 4 * nv;
  }
  for (int e = done + threadIdx.x; e < count; e += rows) {
    const int r = e / n;
    tile[r * pitch + e - r * n] = src[e];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= nrows) return;

  const size_t row = row0 + threadIdx.x;
  const float* f = tile + threadIdx.x * pitch;
  auto cell = [&](int k) {
    return __fmul_rn(__fmul_rn(0.5f, __fadd_rn(f[k], f[k + 1])), hs[k + 1]);
  };
  float tot = 0.0f, comp = 0.0f;
  for (int k = 0; k < n - 1; ++k) kahan_add(tot, comp, cell(k));
  const bool bad = tot <= 0.0f;
  if (bad) {
    tot = 0.0f;
    comp = 0.0f;
    for (int k = 0; k < n - 1; ++k) kahan_add(tot, comp, gd[k]);
  }
  auto dcn = [&](int k) { return __fdiv_rn(bad ? gd[k] : cell(k), tot); };
  auto fkn = [&](int k) { return __fdiv_rn(bad ? 1.0f : f[k], tot); };

  const float q = qp[row];
  int j0;
  float f1, f2, x1, x2, xk, o;
  if (RT) {
    int cnt = 0;
    for (int k = 0; k < n; ++k) cnt += (xs[k] < q) ? 1 : 0;
    j0 = min(max(cnt - 1, 0), n - 2);
    float c1 = 0.0f;                         // ck_{j0}
    for (int k = 0; k < j0; ++k) c1 = __fadd_rn(c1, dcn(k));
    float cr2 = 0.0f;                        // cr_{j0+1}
    for (int k = n - 2; k > j0; --k) cr2 = __fadd_rn(cr2, dcn(k));
    f1 = fkn(j0);
    f2 = fkn(j0 + 1);
    x1 = xs[j0];
    x2 = xs[j0 + 1];
    xk = q;
    const float aq = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(f2, f1)),
                               __fsub_rn(x2, x1));
    const float t = __fsub_rn(xk, x1);
    const float cl = __fadd_rn(
        __fadd_rn(__fmul_rn(aq, __fmul_rn(t, t)), __fmul_rn(f1, t)), c1);
    const float yk = __fsub_rn(x2, xk);
    const float crv = __fsub_rn(
        1.0f, __fadd_rn(__fsub_rn(__fmul_rn(f2, yk),
                                  __fmul_rn(__fmul_rn(aq, yk), yk)),
                        cr2));
    o = (cl > 0.5f) ? crv : cl;
  } else {
    // One loop for both sides, so that a warp whose rows straddle the
    // median does not run both: ck_k < q counted from the left, or
    // cr_k > 1 - q from the right (term i is dc_i, or dc_{n-2-i}).
    const bool right = q > 0.5f;
    const float ta = right ? __fsub_rn(1.0f, q) : q;
    auto term = [&](int i) { return dcn(right ? n - 2 - i : i); };
    auto hit = [&](float c) { return (right ? c > ta : c < ta) ? 1 : 0; };
    float c = 0.0f;                          // ck_0 or cr_{n-1}
    int cnt = hit(c);
    for (int i = 0; i < n - 1; ++i) {
      c = __fadd_rn(c, term(i));
      cnt += hit(c);
    }
    j0 = min(max(cnt - 1, 0), n - 2);
    // readout: the same sum up to the bracket, ck_{j0} or cr_{j0+1}
    const int terms = right ? n - 2 - j0 : j0;
    float ca = 0.0f;
    for (int i = 0; i < terms; ++i) ca = __fadd_rn(ca, term(i));
    f1 = fkn(j0);
    f2 = fkn(j0 + 1);
    x1 = xs[j0];
    x2 = xs[j0 + 1];
    // from the right the plain version solves the mirrored cell,
    // xk = -invert_quadratic(f2, f1, cr2, 1 - q, -x2, -x1)
    const float xm = invert_quadratic(right ? f2 : f1, right ? f1 : f2, ca,
                                      ta, right ? -x2 : x1,
                                      right ? -x1 : x2);
    xk = right ? -xm : xm;
    o = xk;
  }
  const float w = __fsub_rn(x2, x1);
  const float wa = __fdiv_rn(__fsub_rn(x2, xk), w);
  const float wb = __fdiv_rn(__fsub_rn(xk, x1), w);
  out[row] = o;
  lf[row] = __fadd_rn(lf[row],
                      logf(__fadd_rn(__fmul_rn(f1, wa), __fmul_rn(f2, wb))));
  la[row] = wa;
  lb[row] = wb;
  i0[row] = j0;
}

}  // namespace

extern "C" {

// Device pointers to contiguous arrays fk (m, n), xp (n,), h (n,),
// qp (m,) f32 -> out (m,) f32 written, lf (m,) f32 added to in place,
// la, lb (m,) f32 and i0 (m,) int32 written, all on the current device;
// rt != 0 selects mode 'rt'.  Returns the launch's cudaError_t
// (cudaErrorInvalidValue past the caps); asynchronous on `stream`.
int cdf_invert_launch(const void* fk, const void* xp, const void* h,
                      const void* qp, void* out, void* lf, void* la, void* lb,
                      void* i0, int m, int n, int rt, void* stream) {
  if (m == 0) return 0;
  if (m < 0 || n < 2 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = block_rows(n);
  const dim3 grid((m + rows - 1) / rows);
  const size_t smem = smem_bytes(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(fk);
  const float* x = static_cast<const float*>(xp);
  const float* hh = static_cast<const float*>(h);
  const float* q = static_cast<const float*>(qp);
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lf);
  float* wa = static_cast<float*>(la);
  float* wb = static_cast<float*>(lb);
  int* ix = static_cast<int*>(i0);
  if (rt)
    cdf_invert_kernel<true><<<grid, rows, smem, s>>>(a, x, hh, q, o, l, wa,
                                                     wb, ix, m, n);
  else
    cdf_invert_kernel<false><<<grid, rows, smem, s>>>(a, x, hh, q, o, l, wa,
                                                      wb, ix, m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
