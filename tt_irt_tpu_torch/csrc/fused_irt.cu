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
// (against q * total, from the left), in the TPU kernel's cancelling
// form x1 + (-f1 + sqrt|dq|) / 2aq, unlike the per-dimension path.
//
// What bounds it: FP32 arithmetic on the CUDA cores, d (n r^2 + 3 r^2)
// FMAs a row (1.4e5 at d=40, n=17, r=13) against 8 d + 4 bytes of row
// traffic.  The TPU kernel keeps all d dimensions' operands in VMEM and
// turns the cumsum, the bracket readout and the core gather into
// matmuls against scum / one-hot matrices.  Here:
//  - Rows are blocked in registers: a thread carries R rows (fused_rows:
//    4 up to rank tier 24, 2 at 32, 1 at 64) through all d dimensions
//    with their phi in registers, so that each float4 of P read from
//    shared memory feeds 4R FMAs.  The Gram contraction is
//    gram_conditional's (step.cu): both loops unrolled over the tier
//    with the true rank as a uniform guard, phi_i a register, P alone in
//    shared memory, padded to rj = r rounded up to 4.  Each row's chain
//    is v_i = sum_j fmaf(P_ij, phi_j) over j in order, then
//    f = fmaf(phi_i, v_i, f) over i in order, as the one-row-a-thread
//    kernel this replaced, so fk is that kernel's bit for bit.
//  - A block walks tiles of 32 R kWarps rows (a warp takes 32 R rows,
//    lane l rows l + 32k) and takes each tile through the d dimensions;
//    the grid is persistent (grid_cap), a warp wholly past the last row
//    idles.  Dimension k's operands are one
//    contiguous block of the packed operand (ops/fused_irt.py::
//    pack_fused: P regrouped by node and padded, C at an odd node
//    stride, the grid and the spacings), copied into shared memory by
//    cp.async while the dimension before it computes (two buffers, B =
//    2), or between two barriers into one buffer (B = 1) where two
//    leave room for fewer blocks an SM, up to two, than one does, or do
//    not fit beside the fk columns at all (plan_tier).  Where even one
//    does not fit with R rows a thread, one row a thread takes the shape
//    (every (n, r) the one-row-a-thread kernel took still runs).
//  - fk has no room in registers (R n values a thread, n known at run
//    time): each row's n values go to a column of shared memory
//    (slots), conflict-free across the warp.  The CDF total is summed
//    as the Gram loop produces the nodes, and the counting pass and the
//    readout then run jointly over the R rows, with the same
//    __fadd_rn/__fmul_rn sums in the same order, so the bracket and c1
//    are the parent kernel's bit for bit.
//  - The prefix update reads the row's prefix from its slot column,
//    so that its loop over i runs to the true rank (step.cu's
//    update_row): the same operations in prefix_update's order, phi'
//    bit for bit.  The staged core's node stride is r^2 made odd, so that
//    the 32 rows of a warp, at 32 different nodes, read 32 banks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz).

#include <cstdint>

#include "row_common.cuh"

namespace {

using namespace ttirt;

constexpr int kWarps = kThreads / 32;
// Most staging buffers a block takes (1: the dimension's operands are
// always copied in between two barriers).
constexpr int kBuffers = 2;

// Rows a thread carries at rank tier T.
template <int T>
constexpr int fused_rows() { return T <= 24 ? 4 : T <= 32 ? 2 : 1; }

__host__ __device__ inline int round4(int r) { return (r + 3) & ~3; }

// Launch plan of one shape: rows a thread, staging buffers, the shared
// memory of one block and the resident blocks on the card (rows = 0: no
// plan fits).
struct Plan {
  int rows;
  int buffers;
  size_t smem;
  int cap;
};

// Shared memory at R rows a thread and B buffers of `block` floats: the
// buffers and R slot columns of max(n, r) floats a thread.
size_t smem_bytes(int n, int r, int block, int rows, int buffers) {
  const int w = n > r ? n : r;
  return (static_cast<size_t>(buffers) * block
          + static_cast<size_t>(rows) * w * kThreads) * sizeof(float);
}

// ---- cp.async ----

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One dimension's block of the packed operand (a multiple of 4 floats,
// 16-byte aligned) into dst, consecutive threads on consecutive 16 bytes.
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int block) {
  for (int e = 4 * threadIdx.x; e < block; e += 4 * blockDim.x)
    cp_async16(dst + e, src + e);
  cp_async_commit();
}

// ---- one row's CDF, inversion and prefix update ----

__device__ __forceinline__ float cell(float a, float b, float h) {
  return __fmul_rn(__fmul_rn(0.5f, __fadd_rn(a, b)), h);
}

// What the CDF stage leaves of a row: its sample, the cell weights and
// the bracket's left node, and its log-density term.
struct Step {
  float xk, la, lb, dlf;
  int i0;
};

// The CDF, bracket, readout and one-sided inversion of R rows at once:
// fk(x, k) reads node x of row k, tot[k] is the row's CDF total (summed
// in node order), qk[k] its seed.  The counting pass and the readout are
// joint loops over the R rows; each row's sums are its own sequential
// __fadd_rn chain, as in the one-row-a-thread kernel.
template <int R, class FK>
__device__ __forceinline__ void invert_rows(FK fk, const float (&tot)[R],
                                            const float* xs, const float* hs,
                                            int n, const float (&qk)[R],
                                            Step (&st)[R]) {
  const float x0 = xs[0];
  bool bad[R];
  float total[R], target[R], c[R], prev[R];
  int cnt[R], i0[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    bad[k] = tot[k] <= 0.0f;
    total[k] = bad[k] ? xs[n - 1] - x0 : tot[k];
    target[k] = qk[k] * total[k];
    c[k] = 0.0f;
    cnt[k] = 0;
    prev[k] = fk(0, k);
  }
  for (int j = 0; j < n; ++j) {
    const float xj = xs[j] - x0;
#pragma unroll
    for (int k = 0; k < R; ++k)
      cnt[k] += ((bad[k] ? xj : c[k]) < target[k]) ? 1 : 0;
    if (j < n - 1) {
      const float h = hs[j];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float next = fk(j + 1, k);
        c[k] = __fadd_rn(c[k], cell(prev[k], next, h));
        prev[k] = next;
      }
    }
  }
  int top = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    i0[k] = min(max(cnt[k] - 1, 0), n - 2);
    top = max(top, i0[k]);
    c[k] = 0.0f;
    prev[k] = fk(0, k);
  }
  for (int j = 0; j < top; ++j) {
    const float h = hs[j];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float next = fk(j + 1, k);
      if (j < i0[k]) c[k] = __fadd_rn(c[k], cell(prev[k], next, h));
      prev[k] = next;
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const float cv = bad[k] ? xs[i0[k]] - x0 : c[k];
    const float c1 = cv / total[k];
    const float f1 = (bad[k] ? 1.0f : fk(i0[k], k)) / total[k];
    const float f2 = (bad[k] ? 1.0f : fk(i0[k] + 1, k)) / total[k];
    const float x1 = xs[i0[k]];
    const float x2 = xs[i0[k] + 1];

    // one-sided quadratic inversion inside the cell
    const float h3 = x2 - x1;
    const float aq = 0.5f * (f2 - f1) / h3;
    const float t = qk[k] - c1;
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
    st[k] = Step{xk, la, lb, logf(fmaxf(f1 * la + f2 * lb, 1e-30f)), i0[k]};
  }
}

// acc = p (la Ca + lb Cb) / max|.| with p_i = prow[i * ps], its loop over
// i to the true rank: prefix_update's operations in its order (step.cu's
// update_row, at a stride).
template <int RMAX>
__device__ __forceinline__ void update_strided(const float* prow, int ps,
                                               float la, float lb,
                                               const float* ca,
                                               const float* cb, int r,
                                               float (&acc)[RMAX]) {
#pragma unroll
  for (int j = 0; j < RMAX; ++j) acc[j] = 0.0f;
  for (int i = 0; i < r; ++i) {
    const float pi = prow[i * ps];
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

// ---- the kernel ----

template <int RMAX, int R, int B>
__global__ void __launch_bounds__(kThreads)
fused_irt_kernel(const float* __restrict__ q, const float* __restrict__ pack,
                 float* __restrict__ out, float* __restrict__ lfout, int m,
                 int d, int n, int r, int cstride, int block) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kTile = 32 * R * kWarps;
  constexpr int kCol = R * kThreads;       // slot stride between nodes
  const int rj = round4(r);
  float* slots = smem + B * block;         // (max(n, r), R, kThreads)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (m + kTile - 1) / kTile;
  const int steps = ((ntiles - 1 - blockIdx.x) / gridDim.x + 1) * d;
  float* col = slots + tid;  // node x of row t: col[x*kCol + t*kThreads]

  stage(smem, pack, block);
  float p[R][RMAX];
  float lf[R];
  for (int s = 0; s < steps; ++s) {
    const int k = s % d;
    const long long row0 =
        static_cast<long long>(blockIdx.x + (s / d) * gridDim.x) * kTile
        + warp * 32 * R;                   // this warp's first row
    const long long base = row0 + lane;
    cp_async_wait_all();
    __syncthreads();                       // step s's block has landed
    if (B == 2 && s + 1 < steps)
      stage(smem + ((s + 1) & 1) * block,
            pack + static_cast<size_t>((s + 1) % d) * block, block);
    const float* ps = smem + (B == 2 ? (s & 1) * block : 0);
    const float* cs = ps + n * r * rj;
    const float* xs = cs + n * cstride;
    const float* hs = xs + n;
    if (row0 < m) {                        // a warp past the end idles
      if (k == 0) {
#pragma unroll
        for (int t = 0; t < R; ++t) {
          lf[t] = 0.0f;
#pragma unroll
          for (int i = 0; i < RMAX; ++i) p[t][i] = (i == 0) ? 1.0f : 0.0f;
        }
      }

      // ---- Gram conditional, node by node; the CDF total as it goes ----
      float tot[R], prev[R];
#pragma unroll
      for (int t = 0; t < R; ++t) tot[t] = 0.0f;
      for (int x = 0; x < n; ++x) {
        const float* pnode = ps + x * r * rj;
        float f[R];
#pragma unroll
        for (int t = 0; t < R; ++t) f[t] = 0.0f;
#pragma unroll
        for (int i = 0; i < RMAX; ++i) {
          if (i < r) {
            const float4* pc =
                reinterpret_cast<const float4*>(pnode + i * rj);
            float v[R];
#pragma unroll
            for (int t = 0; t < R; ++t) v[t] = 0.0f;
#pragma unroll
            for (int j4 = 0; j4 < RMAX / 4; ++j4) {
              if (4 * j4 < r) {
                const float4 b = pc[j4];
#pragma unroll
                for (int t = 0; t < R; ++t) {
                  v[t] = fmaf(p[t][4 * j4 + 0], b.x, v[t]);
                  v[t] = fmaf(p[t][4 * j4 + 1], b.y, v[t]);
                  v[t] = fmaf(p[t][4 * j4 + 2], b.z, v[t]);
                  v[t] = fmaf(p[t][4 * j4 + 3], b.w, v[t]);
                }
              }
            }
#pragma unroll
            for (int t = 0; t < R; ++t) f[t] = fmaf(p[t][i], v[t], f[t]);
          }
        }
#pragma unroll
        for (int t = 0; t < R; ++t) {
          col[x * kCol + t * kThreads] = f[t];
          if (x > 0)
            tot[t] = __fadd_rn(tot[t], cell(prev[t], f[t], hs[x - 1]));
          prev[t] = f[t];
        }
      }

      // ---- CDF, bracket and inversion of the R rows ----
      float qk[R];
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const long long row = base + 32 * t;
        qk[t] = row < m ? q[row * d + k] : 0.0f;
      }
      Step st[R];
      invert_rows<R>(
          [&](int x, int t) { return col[x * kCol + t * kThreads]; }, tot,
          xs, hs, n, qk, st);

      // ---- outputs and the prefix update from the two core slices ----
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const long long row = base + 32 * t;
        lf[t] += st[t].dlf;
        if (row < m) {
          out[row * d + k] = st[t].xk;
          if (k == d - 1) lfout[row] = lf[t];
        }
        float* prow = col + t * kThreads;    // the row's fk is read out
#pragma unroll
        for (int i = 0; i < RMAX; ++i)
          if (i < r) prow[i * kCol] = p[t][i];
        const float* ca = cs + st[t].i0 * cstride;
        float acc[RMAX];
        update_strided<RMAX>(prow, kCol, st[t].la, st[t].lb, ca, ca + cstride,
                             r, acc);
#pragma unroll
        for (int j = 0; j < RMAX; ++j) p[t][j] = acc[j];
      }
    }

    if (B == 1 && s + 1 < steps) {
      __syncthreads();                     // every read of the block done
      stage(smem, pack + static_cast<size_t>((s + 1) % d) * block, block);
    }
  }
  cp_async_wait_all();
}

// The kernel instance of a plan at rank tier T.
template <int T>
const void* instance(int rows, int buffers) {
  constexpr int RT = fused_rows<T>();
  if (rows == RT)
    return buffers == 2
               ? reinterpret_cast<const void*>(&fused_irt_kernel<T, RT, 2>)
               : reinterpret_cast<const void*>(&fused_irt_kernel<T, RT, 1>);
  return buffers == 2
             ? reinterpret_cast<const void*>(&fused_irt_kernel<T, 1, 2>)
             : reinterpret_cast<const void*>(&fused_irt_kernel<T, 1, 1>);
}

// The plan at (n, r) on `device`: of the instances whose shared memory
// fits (the rank tier's rows a thread where any does, else one row), the
// one with more resident blocks (grid_cap) up to two an SM, two buffers on
// a tie.  Two buffers hide the copy of the next dimension, but one block
// of four warps an SM stalls at every dimension's barrier: at (17, 19) two
// buffers leave room for one block, one buffer for two, and one buffer
// takes 0.59x the time; at (17, 13) two blocks with two buffers take
// 0.87-0.89x the time of three with one (tools/tc_variants.py --fused).
template <int T>
cudaError_t plan_tier(int n, int r, int block, int device, Plan* pl) {
  constexpr int RT = fused_rows<T>();
  int sms = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  *pl = Plan{0, 0, smem_bytes(n, r, block, 1, 1), 0};
  int best = 0;
  const int rows[2] = {RT, 1};
  for (int k = 0; k < 2 && pl->rows == 0; ++k) {
    for (int b = kBuffers; b >= 1; --b) {
      const size_t smem = smem_bytes(n, r, block, rows[k], b);
      if (smem > kSmemOptIn) continue;
      int cap = 0;
      e = grid_cap(instance<T>(rows[k], b), device, smem, &cap);
      if (e != cudaSuccess) return e;
      const int score = cap < 2 * sms ? cap : 2 * sms;
      if (score > best) {
        *pl = Plan{rows[k], b, smem, cap};
        best = score;
      }
    }
  }
  return cudaSuccess;
}

cudaError_t make_plan(int n, int r, int block, int device, Plan* pl) {
  cudaError_t e = cudaSuccess;
  TTIRT_FOR_TIER(r, e = plan_tier<TIER>(n, r, block, device, pl));
  return e;
}

// Blocks of a launch of m rows: all resident, none without a tile.
int grid_of(const Plan& pl, int m) {
  const int tile = 32 * pl.rows * kWarps;
  const int tiles = (m + tile - 1) / tile;
  return tiles < pl.cap ? tiles : pl.cap;
}

}  // namespace

extern "C" {

// Caps the wrapper checks before launching.
int fused_irt_max_n() { return kMaxN; }
int fused_irt_max_r() { return kMaxR; }

// The launch plan at (n, r <= kMaxR) for a packed block of `block`
// floats and m rows on device `device`: rows a thread, staging buffers
// and blocks of the grid (all 0 where no plan fits in shared memory),
// and the bytes of shared memory a block asks for (where nothing fits,
// those of the smallest plan); -1 on a CUDA error.
long long fused_irt_smem_bytes(int n, int r, int block, int m, int device,
                               int* rows, int* buffers, int* grid) {
  Plan pl;
  if (make_plan(n, r, block, device, &pl) != cudaSuccess) return -1;
  *rows = pl.rows;
  *buffers = pl.buffers;
  *grid = pl.rows > 0 ? grid_of(pl, m) : 0;
  return static_cast<long long>(pl.smem);
}

// Device pointers to contiguous f32 arrays q (m, d) and pack (d, block)
// (ops/fused_irt.py::pack_fused, node stride cstride >= r*r of the core)
// -> out (m, d), lf (m,), all on device `device`, which must be the
// current device.  Returns the launch's cudaError_t (0 on success);
// asynchronous on `stream`.
int fused_irt_launch(const void* q, const void* pack, void* out, void* lf,
                     int m, int d, int n, int r, int cstride, int block,
                     int device, void* stream) {
  if (m == 0 || d == 0) return 0;
  if (!in_caps(n, r) || cstride < r * r || block % 4 != 0
      || block < n * r * round4(r) + n * cstride + 2 * n - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  cudaError_t e = make_plan(n, r, block, device, &pl);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (pl.rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&q, &pack, &out, &lf, &m, &d, &n, &r, &cstride, &block};
  const void* kern = nullptr;
  TTIRT_FOR_TIER(r, kern = instance<TIER>(pl.rows, pl.buffers));
  return static_cast<int>(cudaLaunchKernel(
      kern, dim3(grid_of(pl, m)), dim3(kThreads), args, pl.smem,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
