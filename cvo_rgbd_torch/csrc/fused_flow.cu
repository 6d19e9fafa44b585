// fused_flow and fused_step_coeffs: the two Gram sweeps of one iteration of
// the two-pass align step.
//
// Replace the JAX package's ops/pallas_gram.py:fused_flow (_flow_body) and
// fused_step_coeffs (_step_body), with A from _pair_tile in each of its
// three forms: se with the color kernel recomputed, se with the color_gram
// cache, and MATLAB's linear mode with the masked ci cache.
//
//   fused_flow:        per fixed row i and column tile, r_i = sum_j A_ij
//                      y_j - (sum_j A_ij) x_i, formed in the thread before
//                      any large reduction (difference form,
//                      pallas_gram.py:161-172); then omega*c = sum x_i x
//                      r_i, v*d = sum r_i, sum A |x - y|^2, nnz = #{A > 0}
//                      and sum A.
//   fused_step_coeffs: B, C, D, E of the quartic line search
//                      (cvo.cpp:213-289) given omega and v.
//
// Work split: a work item is one (row block of RB fixed rows, column tile
// of TJ moving columns) pair, and one block of RB threads runs one item,
// a thread a fixed row walking the tile's columns in order.  The split
// follows from the shapes alone, and an item's partial does not depend on
// the block that runs it, so the sums are the same bits on any card.  The
// few kept tiles of the kd-sorted clouds each get their own block, side by
// side on their own SMs: no block walks a chain of them.  (Blocks that
// take up to 4 tiles of a row block each, in a scrambled tile order, with
// the next kept tile's slice copied while the current one is swept, were
// built and measured slower: the blocks that drew 2-3 kept tiles set the
// time; PERF.md §6.)
//
// Tile skip (exact): the block tests the box of its valid moving columns
// against the box of its row block's valid fixed rows (a warp's share
// each, then combined; min and max are exact, so every thread gets the
// same bits), and keeps the tile when the squared gap is at most d2_thres
// + SKIP_MARGIN, the rule of ops/moments.py.  A skipped item loads no
// cache, computes no pair and flags itself skipped.  An all-invalid tile
// has an empty box and is always skipped.  Skip on and off give the same
// bits: a skipped tile holds only A = 0 (in se mode the float32 d2 of a
// pair is never below the float32 gap, rounding being monotone; in linear
// mode the margin covers exp_neg and __expf at the gate, pair_tile.cuh),
// so its partial would be zero, and a zero term changes no sum but the
// sign of an all-zero one, which the last write makes +0.
//
// Copies: a kept item's columns and [RB, TJ] ck slice arrive with
// cp.async in two column halves, and the first half is swept while the
// second arrives.  The slice is copied 16 bytes at a time, chunk c of row
// r at chunk c ^ (r & 7) (the pattern of TMA's 128-byte swizzle), so a
// thread reads its row a float4 at a time with no bank conflict.
//
// The step sweep's per-column fields (xi z .. xi^4 z, |xi z|^2,
// xi z . xi^2 z, epsil_const, and w . y_j for each field w) depend on y_j,
// omega and v alone: they are formed once per kept item, warp k forming
// field k of the 32 columns while the copies are in flight, so no warp
// waits while one computes.  The fields and the per-pair terms
// (w . (x_i - y_j) as x_i . w - w . y_j, then beta .. epsilon) are rounded
// operation by operation in the JAX order, without FMA contraction, so
// the plain torch version repeats them bit for bit.
//
// Reduction, one launch a call and no float atomics: each item writes its
// flag (-1 skipped, else its count) and, kept, its partial row (the
// block's fixed-order tree over its rows); the block that takes the last
// ticket (an acquire-release atomic of its thread 0, the only thread that
// writes) sums the kept items' partials in item order (items t, t + RB,
// ... in thread t, then the block's tree) and leaves the ticket zero for
// the next launch.
//
// Bound on the H100: the pairs of kept tiles, ~37 fp32 operations each for
// the position kernel (+44 where the color kernel is recomputed), plus
// ~10 (flow) or ~60 (step) where A is nonzero, and with a cache the kept
// tiles' 4 bytes a pair; without the skip, every pair of the N x M sweep
// (the TPU kernels have no tile skip).  At 6-20% of the tiles kept, what
// is left is latency: the launch (~5-6 us by CUDA events for an empty
// kernel on the H100), the box test, a kept item's copies and 32 columns,
// the ticket and the last block's sum (PERF.md §6).
#include <cuda_runtime.h>

#include "moment_tile.cuh"
#include "pair_tile.cuh"

namespace {

constexpr int RB = 128;       // fixed rows per item, one per thread; ops/flow.py ROWS
constexpr int TJ = 32;        // moving columns per item; ops/flow.py TILE_J
constexpr int NW = RB / 32;   // warps; also the step sweep's four fields
constexpr int NCH = TJ / 4;   // 16-byte chunks in a row of the ck slice
constexpr int HALF = NCH / 2; // chunks of each of the two copy groups
constexpr int NFLOW = 8;      // flow partial: omega*c 3, v*d 3, sum A d2, sum A
constexpr int NSTEP = 4;      // step partial: B, C, D, E
constexpr float SKIP_MARGIN = 1e-5f;  // ops/moments.py SKIP_MARGIN

#ifdef FLOW_PHASE_TIMERS
// Per-block marks, compiled in only for the timing tool's own build
// (cvo_rgbd_torch/time_fused.py --flow; the main library has none):
// thread 0 reads %globaltimer at the block's start, after the skip test,
// after the sweep, after the ticket and at the end, in ns, and the
// item's kept flag last.
constexpr int NMARK = 6, MARK_BLOCKS = 8192;
__device__ unsigned long long g_marks[MARK_BLOCKS][NMARK];
#define MARK(k, value)                                  \
  if (threadIdx.x == 0 && blockIdx.x < MARK_BLOCKS) {   \
    unsigned long long t_;                              \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
    g_marks[blockIdx.x][k] = (k) == NMARK - 1 ? (value) : t_; \
  }
#else
#define MARK(k, value)
#endif

enum Mode { SE_FULL = 0, SE_CACHED = 1, LINEAR = 2 };

struct Args {
  const float *xp, *xf, *xm, *yp, *yf, *ym, *ck, *scal;
  const float* wv;  // omega 3, v 3 (step sweep)
  float* part;      // [items, NV] partials of the kept items
  int* cnt;         // [items]: -1 for a skipped item, else its count
  int* ticket;      // [1], zero at launch and left zero
  float* out;
  int n, m, skip;
};

// The item's staged moving columns and, with a cache, its swizzled ck
// slice.
template <int MODE>
struct Cols {
  float y[TJ][3];
  float f[MODE == SE_FULL ? TJ : 1][cvo::NFEAT];
  float m[MODE == SE_FULL ? TJ : 1];
  float4 ck[MODE == SE_FULL ? 1 : RB][NCH];
};

// per-column fields of the step sweep
struct Fields {
  float w[4][3][TJ];   // xi z, xi^2 z, xi^3 z, xi^4 z
  float wy[4][TJ];     // each field . y_j
  float nz2[TJ];       // |xi z|^2
  float xz12[TJ];      // -(xi z . xi^2 z)
  float epc[TJ];       // |xi^2 z|^2 + 2 xi z . xi^3 z
};

struct Red {
  float v[NFLOW][NW];
  long long c[NW];
  float xbox[NW][6];  // each warp's share of the row block's box
  int last;
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

// lo (box[0..2]) and hi (box[3..5]) of the valid points among the 32 from
// `base`, one a lane, in every lane of the warp.  No valid point gives
// lo = +inf and hi = -inf (core/cloud.block_bounds).
__device__ __forceinline__ void warp_box(const float* __restrict__ p,
                                         const float* __restrict__ msk,
                                         int base, float* box) {
  const int i = base + (threadIdx.x & 31);
  const bool ok = msk[i] > 0.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float v = p[3 * i + r];
    box[r] = ok ? v : INFINITY;
    box[3 + r] = ok ? v : -INFINITY;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const float o = __shfl_xor_sync(0xffffffffu, box[r], off);
      box[r] = r < 3 ? fminf(box[r], o) : fmaxf(box[r], o);
    }
}

// Whether item (row block ib, column tile jt) is swept: always without the
// skip, else unless the squared gap of the boxes (core/cloud.aabb_min_d2)
// passes the gate.  Block-uniform.
__device__ bool kept_item(const Args& a, Red& R, int ib, int jt) {
  if (!a.skip) return true;
  const int w = threadIdx.x >> 5;
  float bx[6], by[6];
  warp_box(a.xp, a.xm, ib * RB + 32 * w, bx);
  warp_box(a.yp, a.ym, jt * TJ, by);
  if ((threadIdx.x & 31) == 0)
    for (int r = 0; r < 6; ++r) R.xbox[w][r] = bx[r];
  __syncthreads();
  float g = 0.0f;
  for (int r = 0; r < 3; ++r) {
    float lo = R.xbox[0][r], hi = R.xbox[0][3 + r];
    for (int v = 1; v < NW; ++v) {
      lo = fminf(lo, R.xbox[v][r]);
      hi = fmaxf(hi, R.xbox[v][3 + r]);
    }
    const float d = fmaxf(fmaxf(by[r] - hi, lo - by[3 + r]), 0.0f);
    g += d * d;
  }
  return !(g > a.scal[cvo::S_D2_THRES] + SKIP_MARGIN);
}

// Start the copies of the item's columns and ck slice: group 0 the
// columns and the slice's first half, group 1 its second half (empty
// without a cache).
template <int MODE>
__device__ __forceinline__ void stage(Cols<MODE>& C, const Args& a, int i0,
                                      int j0) {
  for (int t = threadIdx.x; t < 3 * TJ; t += RB)
    cvo::mt::cp_async4(&C.y[0][0] + t, a.yp + 3 * j0 + t);
  if constexpr (MODE == SE_FULL) {
    for (int t = threadIdx.x; t < cvo::NFEAT * TJ; t += RB)
      cvo::mt::cp_async4(&C.f[0][0] + t, a.yf + cvo::NFEAT * j0 + t);
    for (int t = threadIdx.x; t < TJ; t += RB)
      cvo::mt::cp_async4(&C.m[t], a.ym + j0 + t);
  }
  for (int g = 0; g < 2; ++g) {
    if constexpr (MODE != SE_FULL) {
      const float* src = a.ck + static_cast<size_t>(i0) * a.m + j0;
      for (int k = threadIdx.x; k < RB * HALF; k += RB) {
        const int r = k / HALF, c = g * HALF + k % HALF;
        cvo::mt::cp_async16(&C.ck[r][c ^ (r & 7)],
                            src + static_cast<size_t>(r) * a.m + 4 * c);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
}

template <int PENDING>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
  __syncthreads();
}

// Columns [4 q0, 4 q1) of the staged item, in order: body(jj, d2, a) for
// each pair whose weight a is not zero.
template <int MODE, bool FAST, class Body>
__device__ __forceinline__ void sweep(const Cols<MODE>& C, int q0, int q1,
                                      const float* x, const float* fx,
                                      float xmi, const float* s,
                                      Body&& body) {
  const int t = threadIdx.x;
  for (int q = q0; q < q1; ++q) {
    float cv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (MODE != SE_FULL) {
      const float4 c4 = C.ck[t][q ^ (t & 7)];
      cv[0] = c4.x, cv[1] = c4.y, cv[2] = c4.z, cv[3] = c4.w;
    }
    // the four weights first, side by side, then their terms in order
    float d2[4], w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jj = 4 * q + e;
      d2[e] = cvo::sqdist3(x[0], x[1], x[2], C.y[jj][0], C.y[jj][1],
                           C.y[jj][2]);
      if constexpr (MODE == LINEAR)
        w[e] = cvo::pair_linear<FAST>(d2[e], cv[e], s);
      else if constexpr (MODE == SE_CACHED)
        w[e] = cvo::pair_cached<FAST>(d2[e], cv[e], s);
      else
        w[e] = cvo::pair_full<FAST>(d2[e], fx, xmi, C.f[jj], C.m[jj], s);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (w[e] != 0.0f) body(4 * q + e, d2[e], w[e]);
  }
}

// All columns of the staged item, the first half while the second
// arrives.
template <int MODE, bool FAST, class Body>
__device__ __forceinline__ void sweep_item(const Cols<MODE>& C,
                                           const float* x, const float* fx,
                                           float xmi, const float* s,
                                           Body&& body) {
  if constexpr (MODE == SE_FULL) {
    wait_groups<0>();
    sweep<MODE, FAST>(C, 0, NCH, x, fx, xmi, s, body);
  } else {
    wait_groups<1>();
    sweep<MODE, FAST>(C, 0, HALF, x, fx, xmi, s, body);
    wait_groups<0>();
    sweep<MODE, FAST>(C, HALF, NCH, x, fx, xmi, s, body);
  }
}

// The thread's fixed row: position, and features and mask when the color
// kernel is recomputed; the scalar row.
template <int MODE>
__device__ __forceinline__ void load_row(const Args& a, int i, float* x,
                                         float* fx, float* xmi, float* s) {
  for (int r = 0; r < 3; ++r) x[r] = a.xp[3 * i + r];
  *xmi = 0.0f;
  if constexpr (MODE == SE_FULL) {
    for (int c = 0; c < cvo::NFEAT; ++c) fx[c] = a.xf[cvo::NFEAT * i + c];
    *xmi = a.xm[i];
  }
  for (int k = 0; k < cvo::N_SCAL; ++k) s[k] = a.scal[k];
}
// Sum of NV values over the block in a fixed order, valid in thread 0.
template <int NV>
__device__ __forceinline__ void block_sum(float* v, Red& R) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NV; ++q)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[q] += __shfl_down_sync(0xffffffffu, v[q], off);
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < NV; ++q) R.v[q][warp] = v[q];
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      float s = 0.0f;
      for (int w = 0; w < NW; ++w) s += R.v[q][w];
      v[q] = s;
    }
}

__device__ __forceinline__ long long block_count(long long c, Red& R) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    c += __shfl_down_sync(0xffffffffu, c, off);
  __syncthreads();
  if (lane == 0) R.c[warp] = c;
  __syncthreads();
  long long tot = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < NW; ++w) tot += R.c[w];
  return tot;
}

// Thread 0 writes the item's flag (-1 skipped, else `count`) and, kept,
// its partial row v, then takes a ticket: true in every thread of the
// last block of the grid, which resets it.  Thread 0 is the only thread
// that writes to global memory, so its acquire-release atomic orders
// every write of the grid before the last block's reads (at L2, __ldcg,
// after the barrier).
template <int NV>
__device__ bool last_block(const Args& a, Red& R, int item, bool kept,
                           const float* v, long long count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (kept)
      for (int q = 0; q < NV; ++q)
        a.part[static_cast<size_t>(item) * NV + q] = v[q];
    a.cnt[item] = kept ? static_cast<int>(count) : -1;
    int old;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(old) : "l"(a.ticket) : "memory");
    R.last = old == static_cast<int>(gridDim.x) - 1;
    if (R.last) atomicExch(a.ticket, 0);
  }
  __syncthreads();
  return R.last;
}

// out = the sum of the kept items' partials (NV wide) in item order:
// items t, t + RB, ... in thread t, then the block's tree; +0 for an
// all-zero sum; with counts, their sum after.  A thread issues the loads
// of U items at once (a skipped item's slot is read and not used).
template <int NV>
__device__ void final_sum(const Args& a, Red& R, bool counts) {
  constexpr int U = 8, NV4 = NV / 4;
  const int items = (a.n / RB) * (a.m / TJ);
  const float4* part = reinterpret_cast<const float4*>(a.part);
  float v[NV];
#pragma unroll
  for (int q = 0; q < NV; ++q) v[q] = 0.0f;
  long long c = 0;
  for (int k0 = threadIdx.x; k0 < items; k0 += U * RB) {
    int f[U];
    float4 p[U][NV4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * RB;
      f[u] = k < items ? __ldcg(a.cnt + k) : -1;
#pragma unroll
      for (int h = 0; h < NV4; ++h)
        p[u][h] = __ldcg(part + static_cast<size_t>(min(k, items - 1)) * NV4 +
                         h);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (f[u] < 0) continue;
      c += f[u];
#pragma unroll
      for (int h = 0; h < NV4; ++h) {
        v[4 * h] += p[u][h].x;
        v[4 * h + 1] += p[u][h].y;
        v[4 * h + 2] += p[u][h].z;
        v[4 * h + 3] += p[u][h].w;
      }
    }
  }
  block_sum<NV>(v, R);
  c = block_count(c, R);
  if (threadIdx.x == 0) {
    for (int q = 0; q < NV; ++q) a.out[q] = __fadd_rn(v[q], 0.0f);
    if (counts) a.out[NV] = static_cast<float>(c);
  }
}

// one block per item: row block blockIdx.x / (m / TJ), column tile the rest
template <int MODE, bool FAST>
__global__ void __launch_bounds__(RB) flow_kernel(const Args a) {
  __shared__ Cols<MODE> C;
  __shared__ Red R;
  const int nbj = a.m / TJ, item = blockIdx.x;
  const int ib = item / nbj, jt = item % nbj;
  MARK(0, 0);
  const bool kept = kept_item(a, R, ib, jt);
  MARK(1, 0);
  MARK(5, kept);
  float v[NFLOW];
  long long c = 0;
  if (kept) {
    stage<MODE>(C, a, ib * RB, jt * TJ);
    float x[3], fx[cvo::NFEAT], xmi, s[cvo::N_SCAL];
    load_row<MODE>(a, ib * RB + threadIdx.x, x, fx, &xmi, s);
    float sA = 0.0f, s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, sw = 0.0f;
    int cnt = 0;
    sweep_item<MODE, FAST>(C, x, fx, xmi, s, [&](int jj, float d2, float w) {
      cnt += w > 0.0f;
      sA += w;
      s0 = fmaf(w, C.y[jj][0], s0);
      s1 = fmaf(w, C.y[jj][1], s1);
      s2 = fmaf(w, C.y[jj][2], s2);
      sw = fmaf(w, d2, sw);
    });
    MARK(2, 0);
    // the row's residual over this tile, before any large reduction
    const float r0 = s0 - sA * x[0], r1 = s1 - sA * x[1], r2 = s2 - sA * x[2];
    v[0] = x[1] * r2 - x[2] * r1;
    v[1] = x[2] * r0 - x[0] * r2;
    v[2] = x[0] * r1 - x[1] * r0;
    v[3] = r0, v[4] = r1, v[5] = r2, v[6] = sw, v[7] = sA;
    block_sum<NFLOW>(v, R);
    c = block_count(cnt, R);
  }
  const bool last = last_block<NFLOW>(a, R, item, kept, v, c);
  MARK(3, 0);
  if (last) final_sum<NFLOW>(a, R, true);
  MARK(4, 0);
}

// Warp k forms field k of the item's 32 columns (pallas_gram.py:218-229);
// warps 0-2 also one of the scalar fields.
__device__ __forceinline__ void column_fields(Fields& F, const Args& a,
                                              int j0) {
  const int t = threadIdx.x & 31, k = threadIdx.x >> 5;
  const int j = j0 + t;
  const float om[3] = {a.wv[0], a.wv[1], a.wv[2]};
  const float y[3] = {a.yp[3 * j], a.yp[3 * j + 1], a.yp[3 * j + 2]};
  float f[4][3];
  wcross(om, y, f[0]);
  for (int r = 0; r < 3; ++r) f[0][r] = add(f[0][r], a.wv[3 + r]);
#pragma unroll
  for (int q = 1; q < 4; ++q)
    if (q <= k) wcross(om, f[q - 1], f[q]);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q == k) {
      for (int r = 0; r < 3; ++r) F.w[q][r][t] = f[q][r];
      F.wy[q][t] = dot3(f[q], y);
    }
  if (k == 0) F.nz2[t] = dot3(f[0], f[0]);
  if (k == 1) F.xz12[t] = -dot3(f[0], f[1]);
  if (k == 2)
    F.epc[t] = add(dot3(f[1], f[1]), mul(2.0f, dot3(f[0], f[2])));
}

template <int MODE, bool FAST>
__global__ void __launch_bounds__(RB) step_kernel(const Args a) {
  __shared__ Cols<MODE> C;
  __shared__ Fields F;
  __shared__ Red R;
  const int nbj = a.m / TJ, item = blockIdx.x;
  const int ib = item / nbj, jt = item % nbj;
  MARK(0, 0);
  const bool kept = kept_item(a, R, ib, jt);
  MARK(1, 0);
  MARK(5, kept);
  float v[NSTEP];
  if (kept) {
    stage<MODE>(C, a, ib * RB, jt * TJ);
    column_fields(F, a, jt * TJ);
    float x[3], fx[cvo::NFEAT], xmi, s[cvo::N_SCAL];
    load_row<MODE>(a, ib * RB + threadIdx.x, x, fx, &xmi, s);
    // tc = 1 / (2 ell^2); -2 tc, 2 tc and -tc are exact
    const float tc = s[cvo::S_INV_2L2];
    float sB = 0.0f, sC = 0.0f, sD = 0.0f, sE = 0.0f;
    sweep_item<MODE, FAST>(C, x, fx, xmi, s, [&](int jj, float, float w) {
      float df[4];  // w . (x_i - y_j) as x_i . w - w . y_j (:231-235)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        df[k] = sub(add(add(mul(x[0], F.w[k][0][jj]), mul(x[1], F.w[k][1][jj])),
                        mul(x[2], F.w[k][2][jj])),
                    F.wy[k][jj]);
      const float beta = mul(-2.0f * tc, df[0]);
      const float gamma = mul(-tc, add(F.nz2[jj], mul(2.0f, df[1])));
      const float delta = mul(2.0f * tc, sub(F.xz12[jj], df[2]));
      const float epsil = mul(-tc, add(F.epc[jj], mul(2.0f, df[3])));
      const float beta2 = mul(beta, beta);
      const float bg = mul(beta, gamma);
      // (:245-253)
      sB = fmaf(w, beta, sB);
      sC = fmaf(w, add(gamma, mul(0.5f, beta2)), sC);
      sD = fmaf(w, add(add(delta, bg), __fdiv_rn(mul(beta2, beta), 6.0f)), sD);
      const float e = add(
          add(add(add(epsil, mul(beta, delta)), mul(mul(0.5f, beta2), gamma)),
              mul(mul(0.5f, gamma), gamma)),
          __fdiv_rn(mul(beta2, beta2), 24.0f));
      sE = fmaf(w, e, sE);
    });
    MARK(2, 0);
    v[0] = sB, v[1] = sC, v[2] = sD, v[3] = sE;
    block_sum<NSTEP>(v, R);
  }
  const bool last = last_block<NSTEP>(a, R, item, kept, v, 0);
  MARK(3, 0);
  if (last) final_sum<NSTEP>(a, R, false);
  MARK(4, 0);
}

int mode_of(const float* ck, int linear) {
  if (linear) return ck == nullptr ? -1 : LINEAR;
  return ck == nullptr ? SE_FULL : SE_CACHED;
}

template <int MODE, bool FAST>
struct Flow {
  static void run(int grid, cudaStream_t s, const Args& a) {
    flow_kernel<MODE, FAST><<<grid, RB, 0, s>>>(a);
  }
};

template <int MODE, bool FAST>
struct Step {
  static void run(int grid, cudaStream_t s, const Args& a) {
    step_kernel<MODE, FAST><<<grid, RB, 0, s>>>(a);
  }
};

// One block per item, in the color mode's form with exp_neg or __expf.
template <template <int, bool> class K, bool FAST>
int launch_mode(const Args& a, int linear, cudaStream_t stream) {
  const int grid = (a.n / RB) * (a.m / TJ);
  switch (mode_of(a.ck, linear)) {
    case SE_FULL:
      K<SE_FULL, FAST>::run(grid, stream, a);
      break;
    case SE_CACHED:
      K<SE_CACHED, FAST>::run(grid, stream, a);
      break;
    case LINEAR:
      K<LINEAR, FAST>::run(grid, stream, a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <template <int, bool> class K>
int launch(const Args& a, int linear, int fast, cudaStream_t stream) {
  return fast ? launch_mode<K, true>(a, linear, stream)
              : launch_mode<K, false>(a, linear, stream);
}

}  // namespace

// part: [items, 8] f32 and cnt_part: [items] i32 scratch, items =
// (n / 128) * (m / 32); ticket: [1] i32, zero, and left zero; out: [9]
// f32 = omega*c 3, v*d 3, sum A d2, sum A, nnz.  ck may be null (se mode
// only); linear mode needs ck (the masked ci), 16-byte aligned.  n must be
// a multiple of 128 and m of 32; skip turns the tile skip on; fast takes
// the hardware exp (params.exp_mode="fast").  Returns a cudaError_t.
extern "C" int fused_flow_launch(const float* xp, const float* xf,
                                 const float* xm, const float* yp,
                                 const float* yf, const float* ym,
                                 const float* ck, const float* scal,
                                 float* part, int* cnt_part, int* ticket,
                                 float* out, int n, int m, int skip,
                                 int linear, int fast, cudaStream_t stream) {
  const Args a{xp,   xf,       xm,     yp,  yf, ym, ck, scal, nullptr,
               part, cnt_part, ticket, out, n,  m,  skip};
  return launch<Flow>(a, linear, fast, stream);
}

// wv: [6] f32 = omega 3, v 3; part: [items, 4] f32 scratch; out: [4] f32
// = B, C, D, E.  Otherwise as fused_flow_launch.
extern "C" int fused_step_launch(const float* xp, const float* xf,
                                 const float* xm, const float* yp,
                                 const float* yf, const float* ym,
                                 const float* ck, const float* scal,
                                 const float* wv, float* part, int* cnt_part,
                                 int* ticket, float* out, int n, int m,
                                 int skip, int linear, int fast,
                                 cudaStream_t stream) {
  const Args a{xp,   xf,       xm,     yp,  yf, ym, ck, scal, wv,
               part, cnt_part, ticket, out, n,  m,  skip};
  return launch<Step>(a, linear, fast, stream);
}

#ifdef FLOW_PHASE_TIMERS
// Copies the marks of the last launch's first n blocks into host `out`
// [n, 6].  Returns a cudaError_t.
extern "C" int fused_flow_marks(unsigned long long* out, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_marks, sizeof(unsigned long long) * NMARK * n));
}
#endif
