// fused_flow and fused_step_coeffs: the two Gram sweeps of one iteration of
// the two-pass align step.
//
// Replace the JAX package's ops/pallas_gram.py:fused_flow (_flow_body) and
// fused_step_coeffs (_step_body), with A from _pair_tile in each of its
// three forms: se with the color kernel recomputed, se with the color_gram
// cache, and MATLAB's linear mode with the masked ci cache.
//
//   fused_flow:        per fixed row i and chunk of moving columns,
//                      r_i = sum_j A_ij y_j - (sum_j A_ij) x_i, formed in
//                      the thread before any large reduction (difference
//                      form, pallas_gram.py:161-172); then omega*c =
//                      sum x_i x r_i, v*d = sum r_i, sum A |x - y|^2,
//                      nnz = #{A > 0} and sum A.
//   fused_step_coeffs: B, C, D, E of the quartic line search
//                      (cvo.cpp:213-289) given omega and v.
//
// Layout: a block owns RB rows of the fixed cloud, one per thread, and a
// chunk of the moving cloud's columns, staged TJ at a time in shared memory
// together with the cache's [RB, TJ] slice (read row by row, coalesced;
// padded rows, so the column reads are free of bank conflicts).  Each block
// writes its own partial row and int count, and a one-block kernel sums the
// partials in a fixed order: no float atomics, the same bits every run.
//
// The step sweep's per-column fields (xi z .. xi^4 z, |xi z|^2,
// xi z . xi^2 z, epsil_const, and w . y_j for each field w) depend on y_j,
// omega and v alone: they are formed once per column while the tile is
// staged, not per pair as the TPU kernel does.  The per-pair fields
// (w . (x_i - y_j) as x_i . w - w . y_j, then beta .. epsilon) are rounded
// operation by operation in the JAX order, without FMA contraction, so the
// plain torch version repeats them bit for bit.
//
// Bound on the H100: every pair of the N x M sweep is evaluated (the TPU
// kernels have no tile skip), ~37 fp32 operations each for the position
// kernel (+44 where the color kernel is recomputed), plus ~10 (flow) or
// ~60 (step) where A is nonzero; the cache adds 4 bytes a pair.  Without a
// cache the sweep is bound by operations; with it, by the cache's bytes at
// small N.
#include <cuda_runtime.h>

#include "pair_tile.cuh"

namespace {

constexpr int RB = 128;     // fixed rows per block, one per thread; ops/flow.py ROWS
constexpr int TJ = 32;      // moving columns per staged tile; ops/flow.py TILE_J
constexpr int NW = RB / 32;
constexpr int NFLOW = 8;    // flow partial: omega*c 3, v*d 3, sum A d2, sum A
constexpr int NSTEP = 4;    // step partial: B, C, D, E
constexpr int NRED = 256;   // threads of the reduce kernel

enum Mode { SE_FULL = 0, SE_CACHED = 1, LINEAR = 2 };

struct Tile {
  float y[3][TJ];
  float f[TJ][cvo::NFEAT];
  float m[TJ];
  float ck[RB][TJ + 1];
};

// per-column fields of the step sweep
struct Fields {
  float w[4][3][TJ];   // xi z, xi^2 z, xi^3 z, xi^4 z
  float wy[4][TJ];     // each field . y_j
  float nz2[TJ];       // |xi z|^2
  float xz12[TJ];      // -(xi z . xi^2 z)
  float epc[TJ];       // |xi^2 z|^2 + 2 xi z . xi^3 z
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
}

// omega x a (pallas_gram.py:215-216)
__device__ __forceinline__ void wcross(const float* w, const float* a,
                                       float* o) {
  o[0] = sub(mul(w[1], a[2]), mul(w[2], a[1]));
  o[1] = sub(mul(w[2], a[0]), mul(w[0], a[2]));
  o[2] = sub(mul(w[0], a[1]), mul(w[1], a[0]));
}

// Stage the columns [j0, j0 + TJ) of the moving cloud and, with a cache,
// its [i0, i0 + RB) x [j0, j0 + TJ) slice.
template <int MODE>
__device__ void stage(Tile& T, const float* yp, const float* yf,
                      const float* ym, const float* ck, int i0, int j0,
                      int m) {
  __syncthreads();  // the previous tile is consumed
  if (threadIdx.x < TJ) {
    const int t = threadIdx.x, j = j0 + t;
    for (int r = 0; r < 3; ++r) T.y[r][t] = yp[3 * j + r];
    if (MODE == SE_FULL) {
      for (int c = 0; c < cvo::NFEAT; ++c) T.f[t][c] = yf[cvo::NFEAT * j + c];
      T.m[t] = ym[j];
    }
  }
  if (MODE != SE_FULL)
    for (int idx = threadIdx.x; idx < RB * TJ; idx += RB) {
      const int r = idx / TJ, c = idx % TJ;
      T.ck[r][c] = ck[static_cast<size_t>(i0 + r) * m + j0 + c];
    }
}

template <int MODE>
__device__ __forceinline__ float weight(const Tile& T, int jj, float d2,
                                        const float* fx, float xmi,
                                        const float* s) {
  if (MODE == LINEAR) return cvo::pair_linear(d2, T.ck[threadIdx.x][jj], s);
  if (MODE == SE_CACHED) return cvo::pair_cached(d2, T.ck[threadIdx.x][jj], s);
  return cvo::pair_full(d2, fx, xmi, T.f[jj], T.m[jj], s);
}

// Sum of NV values over the block in a fixed order, valid in thread 0.
template <int NV>
__device__ __forceinline__ void block_sum(float* v, float (*red)[NW]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NV; ++q)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[q] += __shfl_down_sync(0xffffffffu, v[q], off);
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < NV; ++q) red[q][warp] = v[q];
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      float s = 0.0f;
      for (int w = 0; w < NW; ++w) s += red[q][w];
      v[q] = s;
    }
}

__device__ __forceinline__ int block_count(int c, int* redi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    c += __shfl_down_sync(0xffffffffu, c, off);
  __syncthreads();
  if (lane == 0) redi[warp] = c;
  __syncthreads();
  int tot = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < NW; ++w) tot += redi[w];
  return tot;
}

// grid (n / RB, n_chunks); part [n_chunks * n / RB, NFLOW], cnt [same]
template <int MODE>
__global__ void __launch_bounds__(RB)
flow_kernel(const float* __restrict__ xp, const float* __restrict__ xf,
            const float* __restrict__ xm, const float* __restrict__ yp,
            const float* __restrict__ yf, const float* __restrict__ ym,
            const float* __restrict__ ck, const float* __restrict__ scal,
            float* __restrict__ part, int* __restrict__ cnt_part, int m,
            int tiles_per_chunk) {
  __shared__ Tile T;
  __shared__ float red[NFLOW][NW];
  __shared__ int redi[NW];
  const int i0 = blockIdx.x * RB;
  const int i = i0 + threadIdx.x;
  const float x0 = xp[3 * i], x1 = xp[3 * i + 1], x2 = xp[3 * i + 2];
  float fx[cvo::NFEAT];
  float xmi = 0.0f;
  if (MODE == SE_FULL) {
#pragma unroll
    for (int c = 0; c < cvo::NFEAT; ++c) fx[c] = xf[cvo::NFEAT * i + c];
    xmi = xm[i];
  }
  const int nbj = m / TJ;
  const int jb0 = blockIdx.y * tiles_per_chunk;
  const int jb1 = min(nbj, jb0 + tiles_per_chunk);
  float sA = 0.0f, s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, sw = 0.0f;
  int cnt = 0;
  for (int jb = jb0; jb < jb1; ++jb) {
    stage<MODE>(T, yp, yf, ym, ck, i0, jb * TJ, m);
    __syncthreads();
    for (int jj = 0; jj < TJ; ++jj) {
      const float d2 =
          cvo::sqdist3(x0, x1, x2, T.y[0][jj], T.y[1][jj], T.y[2][jj]);
      const float a = weight<MODE>(T, jj, d2, fx, xmi, scal);
      if (a != 0.0f) {
        cnt += a > 0.0f;
        sA += a;
        s0 = fmaf(a, T.y[0][jj], s0);
        s1 = fmaf(a, T.y[1][jj], s1);
        s2 = fmaf(a, T.y[2][jj], s2);
        sw = fmaf(a, d2, sw);
      }
    }
  }
  // the row's residual over this chunk, before any large reduction
  const float r0 = s0 - sA * x0, r1 = s1 - sA * x1, r2 = s2 - sA * x2;
  float v[NFLOW] = {x1 * r2 - x2 * r1, x2 * r0 - x0 * r2, x0 * r1 - x1 * r0,
                    r0, r1, r2, sw, sA};
  block_sum<NFLOW>(v, red);
  const int tot = block_count(cnt, redi);
  if (threadIdx.x == 0) {
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    for (int q = 0; q < NFLOW; ++q) part[b * NFLOW + q] = v[q];
    cnt_part[b] = tot;
  }
}

// grid (n / RB, n_chunks); wv [omega 3, v 3]; part [n_chunks * n / RB, 4]
template <int MODE>
__global__ void __launch_bounds__(RB)
step_kernel(const float* __restrict__ xp, const float* __restrict__ xf,
            const float* __restrict__ xm, const float* __restrict__ yp,
            const float* __restrict__ yf, const float* __restrict__ ym,
            const float* __restrict__ ck, const float* __restrict__ scal,
            const float* __restrict__ wv, float* __restrict__ part, int m,
            int tiles_per_chunk) {
  __shared__ Tile T;
  __shared__ Fields F;
  __shared__ float red[NSTEP][NW];
  const int i0 = blockIdx.x * RB;
  const int i = i0 + threadIdx.x;
  const float x0 = xp[3 * i], x1 = xp[3 * i + 1], x2 = xp[3 * i + 2];
  float fx[cvo::NFEAT];
  float xmi = 0.0f;
  if (MODE == SE_FULL) {
#pragma unroll
    for (int c = 0; c < cvo::NFEAT; ++c) fx[c] = xf[cvo::NFEAT * i + c];
    xmi = xm[i];
  }
  const float om[3] = {wv[0], wv[1], wv[2]};
  const float vv[3] = {wv[3], wv[4], wv[5]};
  // tc = 1 / (2 ell^2); -2 tc, 2 tc and -tc are exact
  const float tc = scal[cvo::S_INV_2L2];
  const int nbj = m / TJ;
  const int jb0 = blockIdx.y * tiles_per_chunk;
  const int jb1 = min(nbj, jb0 + tiles_per_chunk);
  float sB = 0.0f, sC = 0.0f, sD = 0.0f, sE = 0.0f;
  for (int jb = jb0; jb < jb1; ++jb) {
    stage<MODE>(T, yp, yf, ym, ck, i0, jb * TJ, m);
    if (threadIdx.x < TJ) {
      // the column's fields (pallas_gram.py:218-229)
      const int t = threadIdx.x;
      const float y[3] = {yp[3 * (jb * TJ + t)], yp[3 * (jb * TJ + t) + 1],
                          yp[3 * (jb * TJ + t) + 2]};
      float f[4][3];
      wcross(om, y, f[0]);
      for (int r = 0; r < 3; ++r) f[0][r] = add(f[0][r], vv[r]);
      wcross(om, f[0], f[1]);
      wcross(om, f[1], f[2]);
      wcross(om, f[2], f[3]);
      for (int k = 0; k < 4; ++k) {
        for (int r = 0; r < 3; ++r) F.w[k][r][t] = f[k][r];
        F.wy[k][t] = dot3(f[k], y);
      }
      F.nz2[t] = dot3(f[0], f[0]);
      F.xz12[t] = -dot3(f[0], f[1]);
      F.epc[t] = add(dot3(f[1], f[1]), mul(2.0f, dot3(f[0], f[2])));
    }
    __syncthreads();
    for (int jj = 0; jj < TJ; ++jj) {
      const float d2 =
          cvo::sqdist3(x0, x1, x2, T.y[0][jj], T.y[1][jj], T.y[2][jj]);
      const float a = weight<MODE>(T, jj, d2, fx, xmi, scal);
      if (a == 0.0f) continue;
      float df[4];  // w . (x_i - y_j) as x_i . w - w . y_j (:231-235)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        df[k] = sub(add(add(mul(x0, F.w[k][0][jj]), mul(x1, F.w[k][1][jj])),
                        mul(x2, F.w[k][2][jj])),
                    F.wy[k][jj]);
      const float beta = mul(-2.0f * tc, df[0]);
      const float gamma = mul(-tc, add(F.nz2[jj], mul(2.0f, df[1])));
      const float delta = mul(2.0f * tc, sub(F.xz12[jj], df[2]));
      const float epsil = mul(-tc, add(F.epc[jj], mul(2.0f, df[3])));
      const float beta2 = mul(beta, beta);
      const float bg = mul(beta, gamma);
      // (:245-253)
      sB = fmaf(a, beta, sB);
      sC = fmaf(a, add(gamma, mul(0.5f, beta2)), sC);
      sD = fmaf(a, add(add(delta, bg), __fdiv_rn(mul(beta2, beta), 6.0f)), sD);
      const float e = add(
          add(add(add(epsil, mul(beta, delta)), mul(mul(0.5f, beta2), gamma)),
              mul(mul(0.5f, gamma), gamma)),
          __fdiv_rn(mul(beta2, beta2), 24.0f));
      sE = fmaf(a, e, sE);
    }
  }
  float v[NSTEP] = {sB, sC, sD, sE};
  block_sum<NSTEP>(v, red);
  if (threadIdx.x == 0) {
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    for (int q = 0; q < NSTEP; ++q) part[b * NSTEP + q] = v[q];
  }
}

// One block: out[q] = sum over the n_parts partial rows of column q, in a
// fixed order, q < width; with counts, out[width] = their int sum.
__global__ void __launch_bounds__(NRED)
reduce_kernel(const float* __restrict__ part, const int* __restrict__ cnt,
              int n_parts, int width, float* __restrict__ out) {
  __shared__ float s[NFLOW][NRED];
  __shared__ long long sc[NRED];
  const int t = threadIdx.x;
  float acc[NFLOW];
  for (int q = 0; q < NFLOW; ++q) acc[q] = 0.0f;
  long long c = 0;
  for (int b = t; b < n_parts; b += NRED) {
    for (int q = 0; q < width; ++q) acc[q] += part[b * width + q];
    if (cnt != nullptr) c += cnt[b];
  }
  for (int q = 0; q < NFLOW; ++q) s[q][t] = acc[q];
  sc[t] = c;
  __syncthreads();
  for (int h = NRED / 2; h > 0; h >>= 1) {
    if (t < h) {
      for (int q = 0; q < NFLOW; ++q) s[q][t] += s[q][t + h];
      sc[t] += sc[t + h];
    }
    __syncthreads();
  }
  if (t == 0) {
    for (int q = 0; q < width; ++q) out[q] = s[q][0];
    if (cnt != nullptr) out[width] = static_cast<float>(sc[0]);
  }
}

int mode_of(const float* ck, int linear) {
  if (linear) return ck == nullptr ? -1 : LINEAR;
  return ck == nullptr ? SE_FULL : SE_CACHED;
}

}  // namespace

// part: [n_chunks * n / 128, 8] f32 and cnt_part: [n_chunks * n / 128]
// i32 scratch; out: [9] f32 = omega*c 3, v*d 3, sum A d2, sum A, nnz.
// ck may be null (se mode only); linear mode needs ck (the masked ci).
// n must be a multiple of 128 and m of 32.  Returns a cudaError_t.
extern "C" int fused_flow_launch(const float* xp, const float* xf,
                                 const float* xm, const float* yp,
                                 const float* yf, const float* ym,
                                 const float* ck, const float* scal,
                                 float* part, int* cnt_part, float* out, int n,
                                 int m, int tiles_per_chunk, int n_chunks,
                                 int linear, cudaStream_t stream) {
  const dim3 grid(n / RB, n_chunks);
  switch (mode_of(ck, linear)) {
    case SE_FULL:
      flow_kernel<SE_FULL><<<grid, RB, 0, stream>>>(
          xp, xf, xm, yp, yf, ym, ck, scal, part, cnt_part, m, tiles_per_chunk);
      break;
    case SE_CACHED:
      flow_kernel<SE_CACHED><<<grid, RB, 0, stream>>>(
          xp, xf, xm, yp, yf, ym, ck, scal, part, cnt_part, m, tiles_per_chunk);
      break;
    case LINEAR:
      flow_kernel<LINEAR><<<grid, RB, 0, stream>>>(
          xp, xf, xm, yp, yf, ym, ck, scal, part, cnt_part, m, tiles_per_chunk);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<1, NRED, 0, stream>>>(part, cnt_part, grid.x * grid.y,
                                        NFLOW, out);
  return static_cast<int>(cudaGetLastError());
}

// wv: [6] f32 = omega 3, v 3; part: [n_chunks * n / 128, 4] f32 scratch;
// out: [4] f32 = B, C, D, E.  Otherwise as fused_flow_launch.
extern "C" int fused_step_launch(const float* xp, const float* xf,
                                 const float* xm, const float* yp,
                                 const float* yf, const float* ym,
                                 const float* ck, const float* scal,
                                 const float* wv, float* part, float* out,
                                 int n, int m, int tiles_per_chunk,
                                 int n_chunks, int linear,
                                 cudaStream_t stream) {
  const dim3 grid(n / RB, n_chunks);
  switch (mode_of(ck, linear)) {
    case SE_FULL:
      step_kernel<SE_FULL><<<grid, RB, 0, stream>>>(
          xp, xf, xm, yp, yf, ym, ck, scal, wv, part, m, tiles_per_chunk);
      break;
    case SE_CACHED:
      step_kernel<SE_CACHED><<<grid, RB, 0, stream>>>(
          xp, xf, xm, yp, yf, ym, ck, scal, wv, part, m, tiles_per_chunk);
      break;
    case LINEAR:
      step_kernel<LINEAR><<<grid, RB, 0, stream>>>(
          xp, xf, xm, yp, yf, ym, ck, scal, wv, part, m, tiles_per_chunk);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<1, NRED, 0, stream>>>(part, nullptr, grid.x * grid.y,
                                        NSTEP, out);
  return static_cast<int>(cudaGetLastError());
}
