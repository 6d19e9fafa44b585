// align_fused: the whole CVO / adaptive CVO align loop in one launch.
//
// Replaces the JAX package's ops/pallas_align.py:align_fused and both of
// its TPU kernels: _make_kernel (mode "resident", the clouds held whole)
// and _make_tiled_kernel (mode "tiled", the Gram swept in tiles with the
// exact AABB skip).  The TPU kernel is one core running a while_loop on
// scalar carries; here it is one persistent cooperative grid whose blocks
// run every iteration together, separated by grid-wide barriers:
//
//   top     every block reads R, T, ell from its own copy of the state
//           and forms tf = [R', -R'T] and the ell-dependent thresholds
//           1/(2 ell^2) and thres_c ell^2 in the JAX order (:475, :856-857);
//   phase 1 work items over the grid, each writing its own partial:
//           - moment items (j-block of TJ, chunk of i-tiles): momT =
//             Phi(x - c0)^T A and an int nnz, A recomputed per pair with
//             its color kernel (pair_tile.cuh), or in MATLAB's linear color
//             mode (cvo only) with ci = color_scale * (xf . yf) over
//             features 0-2 and the gate k >= sp_thres (:413-415, :811-816);
//             tiled mode skips tiles by
//             the fixed cloud's tile boxes against the box of the item's
//             transformed y, reduced in the block every iteration;
//           - resident only, row items (ROWS rows of x, one per thread,
//             over all of y): the difference-form flow r_i = sum_j A_ij y_j
//             - (sum_j A_ij) x_i (:507-528) and sum A d2;
//           - acvo only, self items: the upper triangle of TW-square tiles
//             of x against x and of y against y, off-diagonal tiles counted
//             twice (:947-1054); y is transformed in tiled mode and not in
//             resident mode (the self distances are rigid-invariant);
//   barrier
//   phase 2 per j-block: momT = sum of the chunk partials in chunk order;
//           tiled mode also forms the moment-form flow terms per j
//           (:915-945).  The last block sums the counts and self partials;
//   barrier
//   phase 3 every block sums the flow partials in a fixed order (omega,
//           v, and acvo's dl), then per j-block contracts the line-search
//           polynomials against momT (:1056-1119);
//   barrier
//   tail    every block sums the B..E partials in a fixed order and runs
//           the scalar tail on its own thread 0: cubic, Exp_SEK3, the two
//           stops, the ell schedule or the acvo dl step.  All blocks compute
//           the same bits, so no fourth barrier is needed; each leaves the
//           loop at the same iteration, because each reads the same state.
//
// Determinism: no float atomics; every partial has its own slot and is
// summed in a fixed order; counts are ints.  The work split does not
// depend on the grid size, so results are the same on any card.
//
// The line-search polynomials are products of four affine forms in the
// centered fixed point (:577-593).  Rather than expanding them, the kernel
// contracts each affine factor into the moments: for a form L,
// (m L)_e = sum_k L_k m[e + u_k], with e + u_k read from the shift table
// the wrapper builds from core/step_factored.py:M_INDEX.  Then
// <L1 L2 ... , m> is a chain of such contractions.
//
// Bound on the H100: ~80 fp32 operations per pair the function needs
// (the Gram with its color kernel; chip_smoke.py's OPS_PAIR + OPS_COLOR),
// each pair once an iteration (the linear color weight costs ~8 where the
// se color kernel costs 44), plus 70 per gated pair of the moment sweep
// (35 FMAs); the clouds (a few hundred KB) stay in L2, so the sweep is
// bound by operations.  Resident mode evaluates each pair twice (the row
// sweep, then the moment sweep), which the bound does not count.  Three
// grid barriers per iteration are the fixed cost.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "align_scalar.cuh"
#include "pair_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;     // threads per block
constexpr int TJ = 128;     // j per moment item; ops/moments.py TILE_J
constexpr int TI = 64;      // i per staged x tile; ops/moments.py TILE_I
constexpr int TW = 64;      // self-sweep tile; ops/wsq.py TILE_W
constexpr int ROWS = 128;   // rows per row item; ops/align_fused.py ROWS
constexpr int NW = NT / 32;
constexpr int NMOM = 35;
constexpr int NSH = 4;
constexpr int NFLOW = 8;    // flow partial stride
constexpr int BLOCKS_PER_SM = 4;
constexpr float SKIP_MARGIN = 1e-5f;

// per-align constants; ops/align_fused.py C_*
enum Const {
  C_S2 = 0,
  C_CS2,
  C_INV2CL2,
  C_D2_C_THRES,
  C_THRES_C,
  C_SP_THRES,
  C_INV_C,
  C_INV_D,
  C_EPS,
  C_EPS_2,
  C_MIN_STEP,
  C_MAX_STEP,
  C_MAX_ITER,
  C_DL_STEP,
  C_ELL_MIN,
  C_ELL_SHRINK,
  C_ELL_MAX_INIT,
  C_COLOR_SCALE,
  C_LINEAR,
  N_CONST
};

struct Args {
  const float *xp, *xf, *xm, *yp, *yf, *ym, *phi;
  const int* shift;                    // [35, 4] monomial shift table
  const float *xb, *md_xx, *md_yy;     // tile boxes / self bounds, or null
  const float *consts, *init;          // [N_CONST], [R0 9, T0 3, c0 3, ell0]
  const float* sched;                  // [n_sched, 2] (after k, ell) pairs
  float* mom_part;                     // [n_chunks, 35, m]
  int* cnt_part;                       // [n_chunks * nbj]
  float* mom;                          // [35, m]
  float* flow_part;                    // [n_flow, NFLOW]
  float* self_w;                       // [n_self]
  int* self_c;                         // [n_self]
  float* red;                          // [8] counts and self sums
  float* bcde_part;                    // [nbj, 4]
  float* out;                          // [33] result row
  int n, m, per, n_chunks, n_sched;
};

// the block's copy of the loop state and per-iteration scalars
struct State {
  float R[9], T[3], c0[3], ell, ell_max;
  float Rt[9], tT[3];                  // tf = [Rt | -tT]
  float om[3], v[3], dl;
  int k, conv;
};

struct Shared {
  State st;
  float scal[cvo::N_SCAL];
  float c[N_CONST];
  int sh[NMOM * NSH];
  float box[6];
  float x[3][TI];
  float f[TI][cvo::NFEAT];
  float xm[TI];
  float phi[TI][NMOM];
  float y[3][TJ];
  float yf[TJ][cvo::NFEAT];
  float ym[TJ];
  float red[8 * NW];
  int redi[NW];
  float tw[NT];
  long long tc[NT];
};

__device__ __forceinline__ void transform(const State& s, const float* p,
                                          float* o) {
  // tf * y in the JAX order, each product and sum rounded on its own
#pragma unroll
  for (int r = 0; r < 3; ++r)
    o[r] = __fsub_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(s.Rt[3 * r], p[0]),
                            __fmul_rn(s.Rt[3 * r + 1], p[1])),
                  __fmul_rn(s.Rt[3 * r + 2], p[2])),
        s.tT[r]);
}

// Sum of NV values over the block in a fixed order; the result is valid
// in thread 0.  Every thread of the block must call it.
template <int NV>
__device__ __forceinline__ void block_sum(float* v, Shared& S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[i] += __shfl_down_sync(0xffffffffu, v[i], off);
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < NV; ++i) S.red[i * NW + warp] = v[i];
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float s = 0.0f;
      for (int w = 0; w < NW; ++w) s += S.red[i * NW + w];
      v[i] = s;
    }
}

__device__ __forceinline__ int block_count(int c, Shared& S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    c += __shfl_down_sync(0xffffffffu, c, off);
  __syncthreads();
  if (lane == 0) S.redi[warp] = c;
  __syncthreads();
  int tot = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < NW; ++w) tot += S.redi[w];
  return tot;
}

// (sum of w[lo:hi], sum of c[lo:hi]) over the block in a fixed order,
// valid in thread 0; w may be null.
__device__ void block_range_sum(const float* w, const int* c, int lo, int hi,
                                Shared& S, float* out_w, long long* out_c) {
  float sw = 0.0f;
  long long sc = 0;
  for (int t = lo + threadIdx.x; t < hi; t += NT) {
    if (w != nullptr) sw += w[t];
    sc += c[t];
  }
  __syncthreads();
  S.tw[threadIdx.x] = sw;
  S.tc[threadIdx.x] = sc;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      S.tw[threadIdx.x] += S.tw[threadIdx.x + s];
      S.tc[threadIdx.x] += S.tc[threadIdx.x + s];
    }
    __syncthreads();
  }
  *out_w = S.tw[0];
  *out_c = S.tc[0];
}

// Box (lo 3, hi 3) of the valid transformed points of a block into S.box,
// +inf / -inf when none is valid (core/cloud.py:block_bounds).
__device__ void block_box(const float* ty, bool valid, Shared& S) {
  float v[6];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    v[r] = valid ? ty[r] : INFINITY;
    v[3 + r] = valid ? ty[r] : -INFINITY;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      v[r] = fminf(v[r], __shfl_down_sync(0xffffffffu, v[r], off));
      v[3 + r] = fmaxf(v[3 + r], __shfl_down_sync(0xffffffffu, v[3 + r], off));
    }
  __syncthreads();
  if (lane == 0)
    for (int r = 0; r < 6; ++r) S.red[r * NW + warp] = v[r];
  __syncthreads();
  if (threadIdx.x == 0)
    for (int r = 0; r < 3; ++r) {
      float lo = S.red[r * NW], hi = S.red[(3 + r) * NW];
      for (int w = 1; w < NW; ++w) {
        lo = fminf(lo, S.red[r * NW + w]);
        hi = fmaxf(hi, S.red[(3 + r) * NW + w]);
      }
      S.box[r] = lo;
      S.box[3 + r] = hi;
    }
  __syncthreads();
}

// Lower bound on d2 between a fixed-cloud tile box [lo 3, hi 3] and S.box.
__device__ __forceinline__ float box_gap(const float* xb, const float* yb) {
  float md = 0.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float gap = fmaxf(fmaxf(yb[r] - xb[3 + r], xb[r] - yb[3 + r]), 0.0f);
    md += gap * gap;
  }
  return md;
}

// A_ij of the align's color mode (pallas_align.py:473-483, :805-824): the
// full se gate, or the linear weight ci of features 0-2 (rounded in the
// JAX order) gated on k >= sp_thres and the masks.  `linear` is uniform.
__device__ __forceinline__ float pair_weight(bool linear, float d2,
                                             const float* fx, float xm,
                                             const float* fy, float ym,
                                             const Shared& S) {
  if (!linear) return cvo::pair_full(d2, fx, xm, fy, ym, S.scal);
  if (!(xm > 0.0f && ym > 0.0f)) return 0.0f;
  const float dot = __fadd_rn(
      __fadd_rn(__fmul_rn(fx[0], fy[0]), __fmul_rn(fx[1], fy[1])),
      __fmul_rn(fx[2], fy[2]));
  return cvo::pair_linear(d2, __fmul_rn(S.c[C_COLOR_SCALE], dot), S.scal);
}

template <bool RESIDENT>
__device__ void moment_item(const Args& a, Shared& S, int jb, int chunk) {
  const int nbi = a.n / TI, nbj = a.m / TJ;
  const int j = jb * TJ + threadIdx.x;
  float ty[3];
  transform(S.st, a.yp + 3 * j, ty);
  float fy[cvo::NFEAT];
#pragma unroll
  for (int c = 0; c < cvo::NFEAT; ++c) fy[c] = a.yf[cvo::NFEAT * j + c];
  const float ymj = a.ym[j];
  const bool use_skip = !RESIDENT && a.xb != nullptr;
  const bool linear = S.c[C_LINEAR] != 0.0f;
  if (use_skip) block_box(ty, ymj > 0.0f, S);
  const float skip_thres = S.scal[cvo::S_D2_THRES] + SKIP_MARGIN;

  float acc[NMOM];
#pragma unroll
  for (int k = 0; k < NMOM; ++k) acc[k] = 0.0f;
  int cnt = 0;
  const int ib0 = chunk * a.per;
  const int ib1 = min(nbi, ib0 + a.per);
  for (int ib = ib0; ib < ib1; ++ib) {
    // block-uniform: S.box and the bounds are the same for every thread
    if (use_skip && box_gap(a.xb + 6 * ib, S.box) > skip_thres) continue;
    __syncthreads();
    const int i0 = ib * TI;
    for (int t = threadIdx.x; t < TI * NMOM; t += NT)
      S.phi[t / NMOM][t % NMOM] = a.phi[static_cast<size_t>(i0) * NMOM + t];
    for (int t = threadIdx.x; t < TI * 3; t += NT)
      S.x[t % 3][t / 3] = a.xp[3 * i0 + t];
    for (int t = threadIdx.x; t < TI * cvo::NFEAT; t += NT)
      S.f[t / cvo::NFEAT][t % cvo::NFEAT] = a.xf[cvo::NFEAT * i0 + t];
    for (int t = threadIdx.x; t < TI; t += NT) S.xm[t] = a.xm[i0 + t];
    __syncthreads();
    for (int ii = 0; ii < TI; ++ii) {
      const float d2 =
          cvo::sqdist3(S.x[0][ii], S.x[1][ii], S.x[2][ii], ty[0], ty[1], ty[2]);
      const float w = pair_weight(linear, d2, S.f[ii], S.xm[ii], fy, ymj, S);
      // a linear weight may be negative: it enters the sums, and only
      // w > 0 is counted
      if (w != 0.0f) {
        cnt += w > 0.0f;
#pragma unroll
        for (int k = 0; k < NMOM; ++k) acc[k] = fmaf(w, S.phi[ii][k], acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NMOM; ++k)
    a.mom_part[(static_cast<size_t>(chunk) * NMOM + k) * a.m + j] = acc[k];
  const int tot = block_count(cnt, S);
  if (threadIdx.x == 0) a.cnt_part[chunk * nbj + jb] = tot;
}

// Resident mode: ROWS rows of x over all of y, the direct-form flow.
template <bool ADAPTIVE>
__device__ void row_item(const Args& a, Shared& S, int rb) {
  const int i = rb * ROWS + threadIdx.x;
  const float x0 = a.xp[3 * i], x1 = a.xp[3 * i + 1], x2 = a.xp[3 * i + 2];
  float fx[cvo::NFEAT];
#pragma unroll
  for (int c = 0; c < cvo::NFEAT; ++c) fx[c] = a.xf[cvo::NFEAT * i + c];
  const float xmi = a.xm[i];
  const bool linear = S.c[C_LINEAR] != 0.0f;
  float sA = 0.0f, s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, sxy = 0.0f;
  for (int j0 = 0; j0 < a.m; j0 += TJ) {
    __syncthreads();
    {
      const int j = j0 + threadIdx.x;
      float ty[3];
      transform(S.st, a.yp + 3 * j, ty);
      for (int r = 0; r < 3; ++r) S.y[r][threadIdx.x] = ty[r];
      for (int c = 0; c < cvo::NFEAT; ++c)
        S.yf[threadIdx.x][c] = a.yf[cvo::NFEAT * j + c];
      S.ym[threadIdx.x] = a.ym[j];
    }
    __syncthreads();
    for (int jj = 0; jj < TJ; ++jj) {
      const float d2 = cvo::sqdist3(x0, x1, x2, S.y[0][jj], S.y[1][jj],
                                    S.y[2][jj]);
      const float w = pair_weight(linear, d2, fx, xmi, S.yf[jj], S.ym[jj], S);
      if (w != 0.0f) {
        sA += w;
        s0 = fmaf(w, S.y[0][jj], s0);
        s1 = fmaf(w, S.y[1][jj], s1);
        s2 = fmaf(w, S.y[2][jj], s2);
        if (ADAPTIVE) sxy = fmaf(w, d2, sxy);
      }
    }
  }
  const float r0 = s0 - sA * x0, r1 = s1 - sA * x1, r2 = s2 - sA * x2;
  float v[7] = {r0, r1, r2, x1 * r2 - x2 * r1, x2 * r0 - x0 * r2,
                x0 * r1 - x1 * r0, sxy};
  block_sum<7>(v, S);
  if (threadIdx.x == 0)
    for (int q = 0; q < 7; ++q) a.flow_part[rb * NFLOW + q] = v[q];
}

// acvo: one upper-triangle TW-square tile of a self-Gram.
template <bool RESIDENT>
__device__ void self_item(const Args& a, Shared& S, int item, int t) {
  const int nbx = a.n / TW;
  const int tri_x = nbx * (nbx + 1) / 2;
  const bool on_y = t >= tri_x;
  if (on_y) t -= tri_x;
  const int nb = on_y ? a.m / TW : nbx;
  int bi = 0, row = nb;
  while (t >= row) {  // block-uniform
    t -= row;
    --row;
    ++bi;
  }
  const int bj = bi + t;
  const float* md = on_y ? a.md_yy : a.md_xx;
  if (md != nullptr &&
      md[bi * nb + bj] > S.scal[cvo::S_D2_THRES] + SKIP_MARGIN) {
    if (threadIdx.x == 0) {
      a.self_w[item] = 0.0f;
      a.self_c[item] = 0;
    }
    return;
  }
  const float* P = on_y ? a.yp : a.xp;
  const float* F = on_y ? a.yf : a.xf;
  const float* M = on_y ? a.ym : a.xm;
  // the moving cloud is transformed in tiled mode (pallas_align.py:993-1013)
  const bool moved = !RESIDENT && on_y;
  __syncthreads();
  for (int r = threadIdx.x; r < TW; r += NT) {
    const int i = bi * TW + r;
    float p[3] = {P[3 * i], P[3 * i + 1], P[3 * i + 2]};
    if (moved) {
      float q[3];
      transform(S.st, p, q);
      p[0] = q[0], p[1] = q[1], p[2] = q[2];
    }
    for (int c = 0; c < 3; ++c) S.x[c][r] = p[c];
    for (int c = 0; c < cvo::NFEAT; ++c) S.f[r][c] = F[cvo::NFEAT * i + c];
    S.xm[r] = M[i];
  }
  __syncthreads();
  const int jj = threadIdx.x % TW;
  const int j = bj * TW + jj;
  float py[3] = {P[3 * j], P[3 * j + 1], P[3 * j + 2]};
  if (moved) {
    float q[3];
    transform(S.st, py, q);
    py[0] = q[0], py[1] = q[1], py[2] = q[2];
  }
  float fy[cvo::NFEAT];
#pragma unroll
  for (int c = 0; c < cvo::NFEAT; ++c) fy[c] = F[cvo::NFEAT * j + c];
  const float ymj = M[j];
  float acc = 0.0f;
  int cnt = 0;
  for (int ii = threadIdx.x / TW; ii < TW; ii += NT / TW) {
    const float d2 =
        cvo::sqdist3(S.x[0][ii], S.x[1][ii], S.x[2][ii], py[0], py[1], py[2]);
    const float w = cvo::pair_full(d2, S.f[ii], S.xm[ii], fy, ymj, S.scal);
    if (w > 0.0f) {
      ++cnt;
      acc = fmaf(w, d2, acc);
    }
  }
  float v[1] = {acc};
  block_sum<1>(v, S);
  const int tot = block_count(cnt, S);
  if (threadIdx.x == 0) {
    const int weight = bj != bi ? 2 : 1;
    a.self_w[item] = static_cast<float>(weight) * v[0];
    a.self_c[item] = weight * tot;
  }
}

// Tiled mode, per j: momT from the chunk partials and the moment-form
// flow terms (core/moments.py:flow_from_moments).
template <bool RESIDENT>
__device__ void column_item(const Args& a, Shared& S, int jb) {
  const int j = jb * TJ + threadIdx.x;
  for (int k = 0; k < NMOM; ++k) {
    float s = 0.0f;
    for (int c = 0; c < a.n_chunks; ++c)
      s += a.mom_part[(static_cast<size_t>(c) * NMOM + k) * a.m + j];
    a.mom[static_cast<size_t>(k) * a.m + j] = s;
  }
  if (RESIDENT) return;
  const int* sh = S.sh;
  const float* mj = a.mom + j;
  const size_t m = a.m;
  const float S0 = mj[0];
  const float S1[3] = {mj[sh[1] * m], mj[sh[2] * m], mj[sh[3] * m]};
  const float S2tr = mj[sh[sh[1] * NSH + 1] * m] + mj[sh[sh[2] * NSH + 2] * m] +
                     mj[sh[sh[3] * NSH + 3] * m];
  float ty[3], tyc[3];
  transform(S.st, a.yp + 3 * j, ty);
  for (int r = 0; r < 3; ++r) tyc[r] = ty[r] - S.st.c0[r];
  float v[7];
  for (int r = 0; r < 3; ++r) v[r] = S0 * tyc[r] - S1[r];
  v[3] = S1[1] * tyc[2] - S1[2] * tyc[1];
  v[4] = S1[2] * tyc[0] - S1[0] * tyc[2];
  v[5] = S1[0] * tyc[1] - S1[1] * tyc[0];
  v[6] = S2tr - 2.0f * (S1[0] * tyc[0] + S1[1] * tyc[1] + S1[2] * tyc[2]) +
         S0 * (tyc[0] * tyc[0] + tyc[1] * tyc[1] + tyc[2] * tyc[2]);
  block_sum<7>(v, S);
  if (threadIdx.x == 0)
    for (int q = 0; q < 7; ++q) a.flow_part[jb * NFLOW + q] = v[q];
}

__device__ __forceinline__ void wcross(const float* w, const float* p,
                                       float* o) {
  o[0] = w[1] * p[2] - w[2] * p[1];
  o[1] = w[2] * p[0] - w[0] * p[2];
  o[2] = w[0] * p[1] - w[1] * p[0];
}

// <L, v> for an affine form L over (1, x0, x1, x2)
__device__ __forceinline__ float dot_aff(const float* L, const float* v,
                                         const int* sh) {
  return L[0] * v[sh[0]] + L[1] * v[sh[1]] + L[2] * v[sh[2]] + L[3] * v[sh[3]];
}

// (m L)_e for the first ne monomials e
__device__ __forceinline__ void shift(const float* L, const float* m, int ne,
                                      const int* sh, float* out) {
  for (int e = 0; e < ne; ++e) out[e] = dot_aff(L, m, sh + NSH * e);
}

// Per j: B..E of the quartic line search (cvo.cpp:249-289) contracted
// against momT[:, j] (pallas_align.py:1059-1119).
__device__ void contract_item(const Args& a, Shared& S, int jb) {
  const int j = jb * TJ + threadIdx.x;
  const int* sh = S.sh;
  float mv[NMOM];
  for (int k = 0; k < NMOM; ++k) mv[k] = a.mom[static_cast<size_t>(k) * a.m + j];
  float ty[3], tyc[3];
  transform(S.st, a.yp + 3 * j, ty);
  for (int r = 0; r < 3; ++r) tyc[r] = ty[r] - S.st.c0[r];
  const float* w = S.st.om;
  float xiz[3], xi2z[3], xi3z[3], xi4z[3];
  wcross(w, ty, xiz);
  for (int r = 0; r < 3; ++r) xiz[r] += S.st.v[r];
  wcross(w, xiz, xi2z);
  wcross(w, xi2z, xi3z);
  wcross(w, xi3z, xi4z);
  const float tc = S.scal[cvo::S_INV_2L2];
  const float normxiz2 = cvo::dot3(xiz, xiz);
  const float xzx2 = -cvo::dot3(xiz, xi2z);
  const float eps_c = cvo::dot3(xi2z, xi2z) + 2.0f * cvo::dot3(xiz, xi3z);
  const float beta[4] = {2.0f * tc * cvo::dot3(xiz, tyc), -2.0f * tc * xiz[0],
                         -2.0f * tc * xiz[1], -2.0f * tc * xiz[2]};
  const float gamma[4] = {-tc * normxiz2 + 2.0f * tc * cvo::dot3(xi2z, tyc),
                          -2.0f * tc * xi2z[0], -2.0f * tc * xi2z[1],
                          -2.0f * tc * xi2z[2]};
  const float delta[4] = {2.0f * tc * xzx2 + 2.0f * tc * cvo::dot3(xi3z, tyc),
                          -2.0f * tc * xi3z[0], -2.0f * tc * xi3z[1],
                          -2.0f * tc * xi3z[2]};
  const float epsil[4] = {-tc * eps_c + 2.0f * tc * cvo::dot3(xi4z, tyc),
                          -2.0f * tc * xi4z[0], -2.0f * tc * xi4z[1],
                          -2.0f * tc * xi4z[2]};
  float mb[20], mbb[10], mbbb[4], mg[4];
  shift(beta, mv, 20, sh, mb);      // m beta: degree <= 3
  shift(beta, mb, 10, sh, mbb);     // m beta^2
  shift(beta, mbb, 4, sh, mbbb);    // m beta^3
  shift(gamma, mv, 4, sh, mg);      // m gamma
  const float mbbbb = dot_aff(beta, mbbb, sh);
  float v[4];
  v[0] = dot_aff(beta, mv, sh);
  v[1] = dot_aff(gamma, mv, sh) + 0.5f * mbb[0];
  v[2] = dot_aff(delta, mv, sh) + dot_aff(gamma, mb, sh) + mbbb[0] / 6.0f;
  v[3] = dot_aff(epsil, mv, sh) + dot_aff(delta, mb, sh) +
         0.5f * dot_aff(gamma, mbb, sh) + 0.5f * dot_aff(gamma, mg, sh) +
         mbbbb / 24.0f;
  block_sum<4>(v, S);
  if (threadIdx.x == 0)
    for (int q = 0; q < 4; ++q) a.bcde_part[jb * 4 + q] = v[q];
}

// Thread 0: tf and the ell-dependent scalar row from the state.
__device__ void top_of_iteration(Shared& S) {
  State& s = S.st;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) s.Rt[3 * r + c] = s.R[3 * c + r];
  for (int r = 0; r < 3; ++r)
    s.tT[r] = __fadd_rn(__fadd_rn(__fmul_rn(s.Rt[3 * r], s.T[0]),
                                  __fmul_rn(s.Rt[3 * r + 1], s.T[1])),
                        __fmul_rn(s.Rt[3 * r + 2], s.T[2]));
  const float ell = s.ell;
  S.scal[cvo::S_ELL] = ell;
  S.scal[cvo::S_S2] = S.c[C_S2];
  S.scal[cvo::S_CS2] = S.c[C_CS2];
  S.scal[cvo::S_INV_2L2] = 1.0f / (2.0f * ell * ell);
  S.scal[cvo::S_INV_2CL2] = S.c[C_INV2CL2];
  S.scal[cvo::S_D2_THRES] = S.c[C_THRES_C] * ell * ell;
  S.scal[cvo::S_D2_C_THRES] = S.c[C_D2_C_THRES];
  S.scal[cvo::S_SP_THRES] = S.c[C_SP_THRES];
}

// Thread 0: omega, v (and acvo's dl) from the flow partials.
template <bool RESIDENT, bool ADAPTIVE>
__device__ void flow_scalars(const Args& a, Shared& S) {
  const int n_flow = RESIDENT ? a.n / ROWS : a.m / TJ;
  float acc[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int b = 0; b < n_flow; ++b)
    for (int q = 0; q < 7; ++q) acc[q] += a.flow_part[b * NFLOW + q];
  State& s = S.st;
  const float inv_c = S.c[C_INV_C], inv_d = S.c[C_INV_D];
  const float* c0 = s.c0;
  if (RESIDENT) {
    for (int r = 0; r < 3; ++r) s.om[r] = acc[3 + r] * inv_c;
  } else {
    s.om[0] = (acc[3] + c0[1] * acc[2] - c0[2] * acc[1]) * inv_c;
    s.om[1] = (acc[4] + c0[2] * acc[0] - c0[0] * acc[2]) * inv_c;
    s.om[2] = (acc[5] + c0[0] * acc[1] - c0[1] * acc[0]) * inv_c;
  }
  for (int r = 0; r < 3; ++r) s.v[r] = acc[r] * inv_d;
  if (ADAPTIVE) {
    // red: n_xy, s_xx, n_xx, s_yy, n_yy (adaptive_cvo.cpp:222-271)
    const float ell = s.ell;
    float denom = a.red[2] + a.red[4] - 2.0f * a.red[0];
    if (denom == 0.0f) denom = 1.0f;
    s.dl = (a.red[3] - 2.0f * acc[6] + a.red[1]) / (ell * ell * ell) / denom;
  }
}

// Thread 0: the step, the update, both stops and the ell update.
template <bool ADAPTIVE>
__device__ void tail(const Args& a, Shared& S) {
  const int nbj = a.m / TJ;
  float bc[4] = {0, 0, 0, 0};
  for (int b = 0; b < nbj; ++b)
    for (int q = 0; q < 4; ++q) bc[q] += a.bcde_part[b * 4 + q];
  State& s = S.st;
  const float* c = S.c;
  const float step = cvo::cubic_step(4.0f * bc[3], 3.0f * bc[2], 2.0f * bc[1],
                                     bc[0], c[C_MIN_STEP], c[C_MAX_STEP]);
  // stop 1 BEFORE the update (cvo.cpp:380)
  const bool stop1 = sqrtf(cvo::dot3(s.om, s.om)) < c[C_EPS] &&
                     sqrtf(cvo::dot3(s.v, s.v)) < c[C_EPS];
  float dR[9], dT[3];
  cvo::exp_sek3(s.om, s.v, step, dR, dT);
  if (!stop1) {
    float Rn[9], RdT[3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Rn[3 * i + j] = s.R[3 * i] * dR[j] + s.R[3 * i + 1] * dR[3 + j] +
                        s.R[3 * i + 2] * dR[6 + j];
    cvo::mat3_vec(s.R, dT, RdT);
    for (int i = 0; i < 9; ++i) s.R[i] = Rn[i];
    for (int i = 0; i < 3; ++i) s.T[i] = RdT[i] + s.T[i];
  }
  // stop 2 AFTER the update (cvo.cpp:402)
  const bool conv = stop1 || cvo::dist_se3(dR, dT) < c[C_EPS_2];
  if (!conv) {
    if (ADAPTIVE) {
      // ell step, shrinking ceiling, floor (adaptive_cvo.cpp:537-545)
      float ell = s.ell + c[C_DL_STEP] * s.dl;
      if (ell >= s.ell_max) {
        s.ell_max = s.ell_max * c[C_ELL_SHRINK];
        ell = s.ell_max;
      }
      s.ell = fmaxf(ell, c[C_ELL_MIN]);
    } else {
      // schedule (cvo.cpp:408-410)
      for (int q = 0; q < a.n_sched; ++q)
        if (static_cast<float>(s.k) > a.sched[2 * q]) s.ell = a.sched[2 * q + 1];
    }
  }
  s.conv = conv ? 1 : 0;
  s.k += 1;
}

template <bool RESIDENT, bool ADAPTIVE>
__global__ void __launch_bounds__(NT) align_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Shared S;
  const int tid = threadIdx.x;
  for (int t = tid; t < NMOM * NSH; t += NT) S.sh[t] = a.shift[t];
  for (int t = tid; t < N_CONST; t += NT) S.c[t] = a.consts[t];
  if (tid == 0) {
    State& s = S.st;
    for (int i = 0; i < 9; ++i) s.R[i] = a.init[i];
    for (int i = 0; i < 3; ++i) s.T[i] = a.init[9 + i];
    for (int i = 0; i < 3; ++i) s.c0[i] = a.init[12 + i];
    s.ell = a.init[15];
    s.ell_max = a.consts[C_ELL_MAX_INIT];
    for (int i = 0; i < 9; ++i) s.Rt[i] = (i % 4 == 0) ? 1.0f : 0.0f;
    for (int i = 0; i < 3; ++i) s.tT[i] = s.om[i] = s.v[i] = 0.0f;
    s.dl = 0.0f;
    s.k = 0;
    s.conv = 0;
  }
  __syncthreads();

  const int nbj = a.m / TJ;
  const int n_mom = nbj * a.n_chunks;
  const int n_rows = RESIDENT ? a.n / ROWS : 0;
  const int nbx = a.n / TW, nby = a.m / TW;
  const int tri_x = nbx * (nbx + 1) / 2;
  const int n_self = ADAPTIVE ? tri_x + nby * (nby + 1) / 2 : 0;
  const int n_items = n_mom + n_rows + n_self;
  const int max_iter = static_cast<int>(S.c[C_MAX_ITER]);
  const bool reducer = blockIdx.x == gridDim.x - 1;

  while (S.st.k < max_iter && S.st.conv == 0) {
    if (tid == 0) top_of_iteration(S);
    __syncthreads();

    // ---- phase 1: the sweeps ----
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      if (item < n_mom) {
        moment_item<RESIDENT>(a, S, item % nbj, item / nbj);
      } else if (item < n_mom + n_rows) {
        row_item<ADAPTIVE>(a, S, item - n_mom);
      } else {
        const int t = item - n_mom - n_rows;
        self_item<RESIDENT>(a, S, t, t);
      }
    }
    grid.sync();

    // ---- phase 2: momT, tiled flow terms, counts and self sums ----
    for (int jb = blockIdx.x; jb < nbj; jb += gridDim.x)
      column_item<RESIDENT>(a, S, jb);
    if (reducer) {
      float w;
      long long cnt;
      block_range_sum(nullptr, a.cnt_part, 0, n_mom, S, &w, &cnt);
      if (tid == 0) a.red[0] = static_cast<float>(cnt);
      if (ADAPTIVE) {
        block_range_sum(a.self_w, a.self_c, 0, tri_x, S, &w, &cnt);
        if (tid == 0) {
          a.red[1] = w;
          a.red[2] = static_cast<float>(cnt);
        }
        block_range_sum(a.self_w, a.self_c, tri_x, n_self, S, &w, &cnt);
        if (tid == 0) {
          a.red[3] = w;
          a.red[4] = static_cast<float>(cnt);
        }
      }
    }
    grid.sync();

    // ---- phase 3: omega, v, dl; the line-search contraction ----
    if (tid == 0) flow_scalars<RESIDENT, ADAPTIVE>(a, S);
    __syncthreads();
    for (int jb = blockIdx.x; jb < nbj; jb += gridDim.x)
      contract_item(a, S, jb);
    grid.sync();

    // ---- tail: every block, the same bits ----
    if (tid == 0) tail<ADAPTIVE>(a, S);
    __syncthreads();
  }

  if (blockIdx.x == 0 && tid == 0) {
    const State& s = S.st;
    float* o = a.out;
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) o[4 * r + c] = s.Rt[3 * r + c];
      o[4 * r + 3] = -s.tT[r];
    }
    for (int i = 0; i < 9; ++i) o[12 + i] = s.R[i];
    for (int i = 0; i < 3; ++i) o[21 + i] = s.T[i];
    o[24] = static_cast<float>(s.k);
    o[25] = static_cast<float>(s.conv);
    o[26] = s.ell;
    for (int i = 0; i < 3; ++i) o[27 + i] = s.om[i];
    for (int i = 0; i < 3; ++i) o[30 + i] = s.v[i];
  }
}

template <bool RESIDENT, bool ADAPTIVE>
int launch(Args a, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(align_kernel<RESIDENT, ADAPTIVE>);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, align_kernel<RESIDENT, ADAPTIVE>, NT, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int grid = sms * (per_sm < BLOCKS_PER_SM ? per_sm : BLOCKS_PER_SM);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(NT), params, 0,
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

Args pack(const float* xp, const float* xf, const float* xm, const float* yp,
          const float* yf, const float* ym, const float* phi,
          const int* shift, const float* xb, const float* md_xx,
          const float* md_yy, const float* consts, const float* init,
          const float* sched, float* mom_part, int* cnt_part, float* mom,
          float* flow_part, float* self_w, int* self_c, float* red,
          float* bcde_part, float* out, int n, int m, int per, int n_chunks,
          int n_sched) {
  Args a;
  a.xp = xp, a.xf = xf, a.xm = xm, a.yp = yp, a.yf = yf, a.ym = ym;
  a.phi = phi, a.shift = shift, a.xb = xb, a.md_xx = md_xx, a.md_yy = md_yy;
  a.consts = consts, a.init = init, a.sched = sched, a.mom_part = mom_part;
  a.cnt_part = cnt_part, a.mom = mom, a.flow_part = flow_part;
  a.self_w = self_w, a.self_c = self_c, a.red = red, a.bcde_part = bcde_part;
  a.out = out, a.n = n, a.m = m, a.per = per, a.n_chunks = n_chunks;
  a.n_sched = n_sched;
  return a;
}

}  // namespace

#define ALIGN_FUSED_ARGS                                                     \
  const float *xp, const float *xf, const float *xm, const float *yp,        \
      const float *yf, const float *ym, const float *phi, const int *shift,  \
      const float *xb, const float *md_xx, const float *md_yy,               \
      const float *consts, const float *init, const float *sched,            \
      float *mom_part, int *cnt_part, float *mom, float *flow_part,          \
      float *self_w, int *self_c, float *red, float *bcde_part, float *out,  \
      int n, int m, int per, int n_chunks, int n_sched, int adaptive,        \
      cudaStream_t stream

#define ALIGN_FUSED_PACK                                                     \
  pack(xp, xf, xm, yp, yf, ym, phi, shift, xb, md_xx, md_yy, consts, init,   \
       sched, mom_part, cnt_part, mom, flow_part, self_w, self_c, red,       \
       bcde_part, out, n, m, per, n_chunks, n_sched)

// Tiled mode: xb [n / 64, 6] tile boxes or null (no skip); for acvo,
// md_xx / md_yy the self bounds at 64 or null.  Scratch shapes are those
// of ops/align_fused.py:align_fused_cuda.  Returns a cudaError_t.
extern "C" int align_fused_tiled_launch(ALIGN_FUSED_ARGS) {
  const Args a = ALIGN_FUSED_PACK;
  return adaptive ? launch<false, true>(a, stream)
                  : launch<false, false>(a, stream);
}

// Resident mode: no tile skip (xb, md_xx, md_yy are ignored).
extern "C" int align_fused_resident_launch(ALIGN_FUSED_ARGS) {
  Args a = ALIGN_FUSED_PACK;
  a.xb = a.md_xx = a.md_yy = nullptr;
  return adaptive ? launch<true, true>(a, stream)
                  : launch<true, false>(a, stream);
}
