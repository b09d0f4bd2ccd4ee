// The body of the two whole-dimension 'hi' kernels, dim_step.cu (raw
// factor B and core C) and odim_step.cu (weighted-orthonormal cores Q),
// which differ only in what the second pass stages:
//   first pass, over the block's 128-row tiles per warpgroup: the
//     conditional v = phi B on the tensor cores (tc_conditional.cuh),
//     fk = sum_j v^2, the two-sided CDF, the bracket and out9 (the
//     stages of cdf_bracket_factor, factor_step.cu);
//   second pass, over the same rows: the node slices S_x (r, r) staged
//     into the shared memory the factor and the fk tiles held, at the
//     odd node stride slice_stride(r) = r^2 | 1 (n (r^2 + 1) floats never
//     exceed it), then phi' from phi, S_i0, S_i0+1 and the cell weight
//     la, with the bracket and la re-formed from out9 bit for bit.  A
//     warp's rows read the same (i, j) of their own nodes; at an even
//     stride r^2 those words share banks (at r = 16 all of them one bank),
//     which the odd stride spreads (csrc/step.cu stages its core so too).
// dim_step stages the core, S_x = C[:, x, :], and forms
// phi' = phi (la S_i0 + (1 - la) S_i0+1) / max|.| (prefix_update, the
// plain version's order).  odim_step stages Q's own node blocks,
// S_x = Q[:, x*r:(x+1)*r], so that phi S_x = v[x], and forms the 2-point
// readout (la v[i0] + (1 - la) v[i0+1]) / max|.| with v[i0] and v[i0+1]
// each one f32 FMA chain over i (the plain version's order: it reads
// the two rows out of v).  Interpolating Q first, as dim_step does C,
// leaves psi' 2.6x further from f64 on lz40n33_ck in 'rt' mode, where
// the two rows of v cancel (tests/test_torch_odim_slices.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math,
// no -ftz: subnormal density ratios must survive to the f64 log).

#pragma once

#include "tc_conditional.cuh"

namespace ttirt {

// The bracket of a row as the first pass left it in out9 (with the f32
// targets re-formed from the seed by the same products), so that
// cell_weight gives the first pass's la bit for bit.
template <bool RT>
__device__ __forceinline__ Bracket bracket_from_out9(const float* o,
                                                     const float* x32, int n,
                                                     float q, float um) {
  Bracket b;
  b.c1 = o[0];
  b.cr2 = o[1];
  b.f1 = o[2];
  b.f2 = o[3];
  b.x1 = o[4];
  b.x2 = o[6];
  b.tot = o[8];
  b.right = !RT && q > 0.5f;
  b.qt = RT ? 0.0f : q * b.tot;
  b.ut = RT ? 0.0f : um * b.tot;
  int i0 = 0;                       // x1 = x32[i0] on a rising grid
  for (int k = 0; k < n; ++k) i0 += (x32[k] < b.x1) ? 1 : 0;
  b.i0 = i0;
  return b;
}

// Floats between two nodes' slices in the second pass: odd, so that the
// nodes of a warp's rows fall in distinct banks.
__host__ __device__ inline int slice_stride(int r) { return (r * r) | 1; }

// Bytes of the staged slices at (n, r); the launchers check that they fit
// the block's shared memory (the factor and the fk tiles, free by then).
inline size_t slices_bytes(int n, int r) {
  return static_cast<size_t>(n) * slice_stride(r) * sizeof(float);
}

// The second pass's node slices, s[x*S + i*r + j] = S_x[i, j] with
// S = slice_stride(r) (stage),
// and the update of a row p from the two slices sa, sb of its bracket
// (update; entries j >= r of acc are 0).
// CoreSlices: the core as it comes, cmat (n, r*r), cmat[x, i*r + j] =
// C[i, x, j]; p (la Ca + lb Cb) / max|.|.
struct CoreSlices {
  __device__ __forceinline__ static void stage(float* s, const float* cmat,
                                               int n, int r) {
    const int rr = r * r;
    const int stride = slice_stride(r);
    for (int idx = threadIdx.x; idx < n * rr; idx += blockDim.x) {
      const int x = idx / rr;
      s[x * stride + (idx - x * rr)] = cmat[idx];
    }
  }

  template <int T>
  __device__ __forceinline__ static void update(const float (&p)[T],
                                                float la, const float* sa,
                                                const float* sb, int r,
                                                float (&acc)[T]) {
    prefix_update<T>(p, la, 1.0f - la, sa, sb, r, acc);
  }
};

// FactorSlices: node x's (r, r) block of a factor Q (r, n*r),
// S_x[i, j] = Q[i, x*r + j], read in Q's row-major order;
// (la p Qa + lb p Qb) / max|.|, each product one FMA chain over i.
struct FactorSlices {
  __device__ __forceinline__ static void stage(float* s, const float* qmat,
                                               int n, int r) {
    const int nr = n * r;
    const int stride = slice_stride(r);
    for (int idx = threadIdx.x; idx < r * nr; idx += blockDim.x) {
      const int i = idx / nr;
      const int col = idx - i * nr;
      const int x = col / r;
      s[x * stride + i * r + (col - x * r)] = qmat[idx];
    }
  }

  template <int T>
  __device__ __forceinline__ static void update(const float (&p)[T],
                                                float la, const float* sa,
                                                const float* sb, int r,
                                                float (&acc)[T]) {
    float vb[T];
#pragma unroll
    for (int j = 0; j < T; ++j) acc[j] = vb[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      if (i < r) {
#pragma unroll
        for (int j = 0; j < T; ++j) {
          if (j < r) {
            acc[j] = fmaf(p[i], sa[i * r + j], acc[j]);
            vb[j] = fmaf(p[i], sb[i * r + j], vb[j]);
          }
        }
      }
    }
    const float lb = 1.0f - la;
#pragma unroll
    for (int j = 0; j < T; ++j) acc[j] = la * acc[j] + lb * vb[j];
    normalize_row<T>(acc, r);
  }
};

// phi (m, r), qp/um (m,), bmat (r, n*r), slices (the operand Slices
// stages), h (n-1,), xg (2, n) -> phin (m, r), out9 (m, 9).
template <int T, bool RT, Tc V, class Slices>
__device__ __forceinline__ void tc_dim_step(
    const float* __restrict__ phi, const float* __restrict__ qp,
    const float* __restrict__ um, const float* __restrict__ bmat,
    const float* __restrict__ slices, const float* __restrict__ h,
    const float* __restrict__ xg, float* __restrict__ phin,
    float* __restrict__ out9, int m, int n, int r) {
  extern __shared__ __align__(16) float smem[];
  using Stage = TcStage<T, V>;
  const int wgs = blockDim.x / kTcRows;
  const int wg = threadIdx.x / kTcRows;
  const int tid = threadIdx.x - wg * kTcRows;
  float* fk = Stage::fk_tile(smem, n, r, wg);

  Stage::stage(smem, bmat, n, r);
  __syncthreads();

  // first pass, over the block's tiles: conditional, two-sided CDF,
  // bracket and readout (the stages that cdf_bracket_factor runs)
  const int ntiles = (m + kTcRows - 1) / kTcRows;
  for (int tile = blockIdx.x * wgs + wg; tile < ntiles;
       tile += gridDim.x * wgs) {
    const long long row0 = static_cast<long long>(tile) * kTcRows;
    Stage::conditional(smem, fk, phi, row0, m, n, r, wg);
    const long long row = row0 + tid;
    const bool live = row < m;
    const Bracket b = Stage::template bracket<RT>(
        smem, fk + tid, phi, row, live, h, xg, n, r, live ? qp[row] : 0.0f,
        (live && !RT) ? um[row] : 0.0f);
    if (live) write_out9(out9 + row * 9, b, xg + n);
    wg_barrier(wg);      // the fk tile is free for the next tile
  }

  // second pass, over the same rows: the prefix update, with the node
  // slices staged where the factor was, so that the two a row reads come
  // from shared memory
  __syncthreads();       // every out9 row written, the factor done with
  Slices::stage(smem, slices, n, r);
  __syncthreads();
  for (int tile = blockIdx.x * wgs; tile < ntiles; tile += gridDim.x * wgs) {
    const long long row = static_cast<long long>(tile) * kTcRows + threadIdx.x;
    if (row >= m) continue;
    const float q = qp[row];
    const Bracket b = bracket_from_out9<RT>(out9 + row * 9, xg, n, q,
                                            RT ? 0.0f : um[row]);
    const float la = cell_weight<RT>(b, q);
    float p[T];
    load_row<T>(p, phi, row, r);
    const float* sa = smem + b.i0 * slice_stride(r);
    float acc[T];
    Slices::template update<T>(p, la, sa, sa + slice_stride(r), r, acc);
    store_row<T>(phin, row, r, acc);
  }
}

}  // namespace ttirt
