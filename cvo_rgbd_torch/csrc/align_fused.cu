// align_fused: the whole CVO / adaptive CVO align loop in one launch.
//
// Replaces the JAX package's ops/pallas_align.py:align_fused and both of
// its TPU kernels: _make_kernel (mode "resident", the clouds held whole)
// and _make_tiled_kernel (mode "tiled", the Gram swept in tiles with the
// exact AABB skip).  The TPU kernel is one core running a while_loop on
// scalar carries; here it is one persistent cooperative grid whose blocks
// run every iteration together, separated by two grid-wide barriers:
//
//   top     every block reads R, T, ell from its own copy of the state
//           and forms tf = [R', -R'T] and the ell-dependent thresholds
//           1/(2 ell^2) and thres_c ell^2 in the JAX order (:475, :856-857);
//           in resident mode it also derives every live lane's kept tiles
//           (kept_bitmaps), which all its items then read;
//   phase 1 work items over the grid, each writing its own partial:
//           - moment items (an i-tile of TI by a j-block of TJ): the
//             item's momT = Phi(x - c0)^T A and an int nnz
//             (moment_tile.cuh), A recomputed per pair with its color
//             kernel (pair_tile.cuh), or in MATLAB's linear color mode
//             (cvo only) with ci = color_scale * (xf . yf) over features
//             0-2 and the gate k >= sp_thres (:413-415, :811-816); a tile
//             is skipped by its box in the fixed cloud against a box that
//             holds the j-block's transformed points (its untransformed
//             box through tf, moved_box), a few flops an item, so a
//             skipped item costs no barrier and no load of y.  Resident
//             mode's items also store every weight they compute in a
//             lane scratch W [n, m]: each pair is evaluated once an
//             iteration, as JAX's resident kernel forms A once (:479-483);
//           - acvo only, self items: the upper triangle of TW-square tiles
//             of x against x and of y against y, off-diagonal tiles counted
//             twice (:947-1054); y is transformed in tiled mode and not in
//             resident mode (the self distances are rigid-invariant);
//   phase 2 inside phase 1, by tickets: the block that runs the last
//           moment item of a j-block's kept tiles (an int ticket per
//           j-block, taken after a __threadfence, against the kept count
//           every block derives by the same rule), or its first item when
//           it keeps none, sums that j-block's kept partials in i-tile
//           order; tiled mode also forms the moment-form flow terms per j
//           (:915-945).  Resident mode's row blocks (ROWS rows of x) have
//           tickets too: the last moment item of a row block's kept
//           tiles, or its first item when it keeps none, reads the row
//           block's weights back from W, one thread a row walking its
//           kept tiles in j order, and forms the difference-form flow
//           r_i = sum_j A_ij y_j - (sum_j A_ij) x_i (:507-528) and sum A
//           d2 (row_flow).  For acvo the last column or self item of a
//           lane (a ticket of its own) sums the counts and self sums.
//           Items run in a scrambled order, so kept tiles spread over
//           blocks;
//   barrier
//   phase 3 every block sums the flow partials in a fixed order (omega,
//           v, and acvo's dl), then per j-block contracts the line-search
//           polynomials against momT (:1056-1119);
//   barrier
//   tail    every block sums the B..E partials in a fixed order and runs
//           the scalar tail on its own thread 0: cubic, Exp_SEK3, the two
//           stops, the ell schedule or the acvo dl step.  All blocks compute
//           the same bits, so no third barrier is needed; each leaves the
//           loop at the same iteration, because each reads the same state.
//
// Lanes (align_fused_batched, the JAX package's vmap of align_fused): one
// launch registers B independent pairs.  Every block keeps every lane's
// loop state in dynamic shared memory and computes each live lane's top of
// iteration, flow scalars and tail on one thread per lane, so the scalar
// tail does not grow B-fold.  Phase 1-3 work items run over (lane, item);
// every input, partial and result has a leading lane axis the wrapper
// allocates.  A lane that has converged or run max_iter iterations is
// frozen: its items are skipped and its state no longer changes.  The loop
// runs while any lane is live, and every block reads the same lane states,
// so all blocks leave it together.
//
// Determinism: no float atomics; every partial has its own slot and is
// summed in a fixed order; counts are ints.  The work split does not
// depend on the grid size or on the number of lanes, so a lane's results
// are the same bits as its pair's single-pair launch, on any card.
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
// (35 FMAs); the clouds (a few hundred KB)
// stay in L2, so the sweep is bound by operations.  Resident mode
// evaluates each pair once, in the moment sweep, and its row flow reads
// the kept tiles' weights back (4 bytes and 5 FMAs a pair, from L2: W is
// at most 4 MB a lane, N*M <= 2^20 in both resident budgets).  Two grid
// barriers per iteration are the fixed cost.
//
// Every form (resident or tiled, cvo or acvo) is compiled twice: with
// exp_neg and, for params.exp_mode="fast", with the hardware __expf in
// every exponential of a pair, position and color (FAST, pair_tile.cuh;
// pallas_align.py:359-360, 715-716).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "align_scalar.cuh"
#include "moment_tile.cuh"
#include "pair_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;     // threads per block
constexpr int TJ = cvo::mt::TJ;  // j per moment item; ops/moments.py TILE_J
constexpr int TI = cvo::mt::TI;  // i per moment item; ops/moments.py TILE_I
constexpr int TW = 64;      // self-sweep tile; ops/wsq.py TILE_W
constexpr int ROWS = 128;   // rows per row block; ops/align_fused.py ROWS
constexpr int NW = NT / 32;
constexpr int NMOM = cvo::mt::NMOM;
constexpr int NSH = 4;
constexpr int NFLOW = 8;    // flow partial stride
constexpr int NINIT = 16;   // init row: R0 9, T0 3, c0 3, ell0
constexpr int NOUT = 33;    // result row; ops/align_fused.py OUT_LEN
constexpr int BLOCKS_PER_SM = 4;
constexpr float SKIP_MARGIN = 1e-5f;
// row_flow's copies of W: a ring of NSTAGE stages a warp, each the
// warp's 32 rows by JC columns, rows WLD floats apart (16-byte copies;
// the float4 reads of 8 threads then fall on 32 distinct banks)
constexpr int JC = 16;
constexpr int NSTAGE = 4;
constexpr int WLD = JC + 4;
constexpr int PER_ROW = ROWS / TI;  // i-tiles of a row block
static_assert(PER_ROW == 2 && TI % 32 == 0,
              "row_flow: two i-tiles of whole warps");
// a moment item's weights fit in row_flow's rings
static_assert(TI * TJ <= NW * NSTAGE * 32 * WLD, "wsm in the rings");

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

// Pointers of lane 0; lane L's slices follow at the strides of at_lane.
struct Args {
  const float *xp, *xf, *xm, *yp, *yf, *ym, *phi;
  const int* shift;                    // [35, 4] monomial shift table
  const float *xb, *yb;                // x and untransformed y tile boxes
  const float *md_xx, *md_yy;          // self bounds, or null
  const float *consts, *init;          // [N_CONST], [R0 9, T0 3, c0 3, ell0]
  const float* sched;                  // [n_sched, 2] (after k, ell) pairs
  float* mom_part;                     // [n / TI, 35, m] item partials
  int* cnt_part;                       // [n / TI, nbj] kept tiles' counts
  int* cnt_col;                        // [nbj] a j-block's kept count
  int* ticket;                         // [nbj + 1 (+ n / ROWS resident)],
                                       // zero at launch
  float* mom;                          // [35, m]
  float* flow_part;                    // [n_flow, NFLOW]
  float* self_w;                       // [n_self]
  int* self_c;                         // [n_self]
  float* red;                          // [8] counts and self sums
  float* bcde_part;                    // [nbj, 4]
  float* w;                            // resident: [n, m] weights, or null
  float* out;                          // [33] result row
  int n, m, n_sched, lanes;
};

// the block's copy of the loop state and per-iteration scalars
struct State {
  float R[9], T[3], c0[3], ell, ell_max;
  float Rt[9], tT[3];                  // tf = [Rt | -tT]
  float om[3], v[3], dl;
  int k, conv;
};

// a lane's loop state and its ell-dependent scalar row
struct Lane {
  State st;
  float scal[cvo::N_SCAL];
};

struct Shared {
  // the ell-dependent scalar row of the lane whose items the block runs
  // in phase 1, copied from its Lane: the sweeps read it at a fixed
  // address, which keeps it in registers through their inner loops
  float scal[cvo::N_SCAL];
  float c[N_CONST];
  int sh[NMOM * NSH];
  // a moment item's i-tile; a self item stages its rows in t.x and t.f
  cvo::mt::Tile t;
  cvo::mt::ColumnScratch cs;
  float red[8 * NW];
  int redi[NW];
  int last;
  float tw[NT];
  long long tc[NT];
};

#ifdef ALIGN_PHASE_TIMERS
// Per-phase timers, compiled in only for the timing tool's own build
// (cvo_rgbd_torch/time_fused.py --phases; the main library has none):
// thread 0 of block 0 reads %globaltimer at the top of every iteration
// and after each barrier, and sums the spans here, in ns, with the
// number of iterations in the last slot.
constexpr int NPHASE = 4;
__device__ unsigned long long g_phase_ns[NPHASE + 1];

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE_TOP()                                          \
  if (blockIdx.x == 0 && threadIdx.x == 0) t_phase = global_ns();
#define PHASE_MARK(slot)                                     \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                 \
    const unsigned long long now = global_ns();              \
    g_phase_ns[slot] += now - t_phase;                       \
    if ((slot) == NPHASE - 1) g_phase_ns[NPHASE] += 1;       \
    t_phase = now;                                           \
  }
// Phase 1's work by kind (moment item of a kept tile, moment item of a
// skipped tile, column sum, counts, a resident row block's flow from W,
// self item): ns and items
// over all blocks, and each block's busy ns; thread 0 of each block
// reads the timer around each.
constexpr int NKIND = 6;
constexpr int MAX_TIMED_GRID = 4096;
__device__ unsigned long long g_kind_ns[2 * NKIND];
__device__ unsigned long long g_busy_ns[MAX_TIMED_GRID];
#define ITEM_START()                                            \
  unsigned long long t_item = threadIdx.x == 0 ? global_ns() : 0;
#define ITEM_DONE(kind)                                          \
  if (threadIdx.x == 0) {                                        \
    const unsigned long long now = global_ns();                  \
    atomicAdd(&g_kind_ns[kind], now - t_item);                   \
    atomicAdd(&g_kind_ns[NKIND + (kind)], 1ull);                 \
    if (blockIdx.x < MAX_TIMED_GRID)                             \
      g_busy_ns[blockIdx.x] += now - t_item;                     \
    t_item = now;                                                \
  }
#else
#define PHASE_TOP()
#define PHASE_MARK(slot)
#define ITEM_START()
#define ITEM_DONE(kind)
#endif

__device__ __forceinline__ bool live(const Lane& ln, int max_iter) {
  return ln.st.k < max_iter && ln.st.conv == 0;
}

// The slices of lane L (scratch strides as ops/align_fused.py allocates).
template <bool RESIDENT, bool ADAPTIVE>
__device__ Args at_lane(const Args& a, int L) {
  const size_t l = L, n = a.n, m = a.m;
  const int nbj = a.m / TJ, nbx = a.n / TW, nby = a.m / TW;
  const int n_flow = RESIDENT ? a.n / ROWS : nbj;
  const int n_self = ADAPTIVE ? nbx * (nbx + 1) / 2 + nby * (nby + 1) / 2 : 0;
  Args o = a;
  o.xp += l * n * 3;
  o.xf += l * n * cvo::NFEAT;
  o.xm += l * n;
  o.yp += l * m * 3;
  o.yf += l * m * cvo::NFEAT;
  o.ym += l * m;
  o.phi += l * n * NMOM;
  if (o.xb != nullptr) o.xb += l * (a.n / TI) * 6;
  if (o.yb != nullptr) o.yb += l * nbj * 6;
  if (o.md_xx != nullptr) o.md_xx += l * nbx * nbx;
  if (o.md_yy != nullptr) o.md_yy += l * nby * nby;
  o.init += l * NINIT;
  o.mom_part += l * (a.n / TI) * NMOM * m;
  o.cnt_part += l * (a.n / TI) * nbj;
  o.cnt_col += l * nbj;
  o.ticket += l * (nbj + 1 + (RESIDENT ? a.n / ROWS : 0));
  o.mom += l * NMOM * m;
  o.flow_part += l * max(n_flow, 1) * NFLOW;
  o.self_w += l * max(n_self, 1);
  o.self_c += l * max(n_self, 1);
  o.red += l * 8;
  o.bcde_part += l * nbj * 4;
  if (o.w != nullptr) o.w += l * n * m;
  o.out += l * NOUT;
  return o;
}

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
// valid in thread 0; w may be null.  Other blocks wrote them.
__device__ void block_range_sum(const float* w, const int* c, int lo, int hi,
                                Shared& S, float* out_w, long long* out_c) {
  float sw = 0.0f;
  long long sc = 0;
  for (int t = lo + threadIdx.x; t < hi; t += NT) {
    if (w != nullptr) sw += __ldcg(w + t);
    sc += __ldcg(c + t);
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

// A box holding j-block jb's valid transformed points: the untransformed
// tile box yb (core/cloud.py:block_bounds) mapped through tf = [Rt, -tT]
// as its center and |Rt| times its half-widths, widened by far more than
// the rounding of `transform`.  Every block computes the same bits; an
// empty block (lo > hi) gives an empty box, which no tile reaches.
__device__ __forceinline__ void moved_box(const State& st, const float* yb,
                                          float* box) {
  if (!(yb[0] <= yb[3])) {
    for (int r = 0; r < 3; ++r) box[r] = INFINITY, box[3 + r] = -INFINITY;
    return;
  }
  float c[3], h[3];
  for (int r = 0; r < 3; ++r) {
    c[r] = 0.5f * (yb[r] + yb[3 + r]);
    h[r] = 0.5f * (yb[3 + r] - yb[r]);
  }
  for (int r = 0; r < 3; ++r) {
    const float* R = st.Rt + 3 * r;
    const float cc = R[0] * c[0] + R[1] * c[1] + R[2] * c[2] - st.tT[r];
    const float hh = fabsf(R[0]) * h[0] + fabsf(R[1]) * h[1] +
                     fabsf(R[2]) * h[2];
    const float slack =
        1e-4f + 1e-5f * (fabsf(cc) + hh + fabsf(st.tT[r]));
    box[r] = cc - hh - slack;
    box[3 + r] = cc + hh + slack;
  }
}

// Lower bound on d2 between a fixed-cloud tile box [lo 3, hi 3] and yb.
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
template <bool FAST>
__device__ __forceinline__ float pair_weight(bool linear, float d2,
                                             const float* fx, float xm,
                                             const float* fy, float ym,
                                             const float* scal,
                                             float color_scale) {
  if (!linear) return cvo::pair_full<FAST>(d2, fx, xm, fy, ym, scal);
  if (!(xm > 0.0f && ym > 0.0f)) return 0.0f;
  const float dot = __fadd_rn(
      __fadd_rn(__fmul_rn(fx[0], fy[0]), __fmul_rn(fx[1], fy[1])),
      __fmul_rn(fx[2], fy[2]));
  return cvo::pair_linear<FAST>(d2, __fmul_rn(color_scale, dot), scal);
}

// A_ij of the thread's j and a tile row (moment_tile.cuh).
template <bool FAST>
struct AlignWeight {
  bool linear;
  float color_scale;
  const float* s;
  float y[3];
  float fy[cvo::NFEAT];
  float ym;

  __device__ __forceinline__ float operator()(int ii, float4 xi,
                                              const float* fi) const {
    const float d2 = cvo::sqdist3(xi.x, xi.y, xi.z, y[0], y[1], y[2]);
    return pair_weight<FAST>(linear, d2, fi, xi.w, fy, ym, s, color_scale);
  }
};

// The tile skip: i-tile c of lane a against the box of a j-block's
// transformed points is kept unless its lower bound on d2 passes the
// gate; every tile is kept without boxes (p.tile_skip off).  A box that
// holds the points keeps every tile the exact box keeps, and the tiles
// it keeps besides hold only zero weights.
__device__ __forceinline__ bool kept_tile(const float* xb, const float* box,
                                          float thres, int c) {
  return xb == nullptr || !(box_gap(xb + 6 * c, box) > thres);
}

// Resident mode's kept tiles: a bitmap a lane, bit ib * nbj + jb, that
// every block derives at the top of each iteration for every live lane
// (kept_bitmaps) and every caller reads: an item's own test, the kept
// counts of a column and of a row block, the column sum and the row
// flow.  All blocks compute each bit with the same instructions from the
// same state, so all agree on every tile; an item's test is a bit, and
// a skipped tile's item costs nothing.
__host__ __device__ constexpr int kept_words(int n, int m) {
  return ((n / TI) * (m / TJ) + 31) / 32;
}

__device__ __forceinline__ bool kept_bit(const unsigned* bits, int nbj,
                                         int ib, int jb) {
  const int t = ib * nbj + jb;
  return (bits[t >> 5] >> (t & 31)) & 1u;
}

// Every live lane's bitmap, by the rule of kept_tile against moved_box,
// over (lane, tile) pairs spread on the block's threads; every thread of
// the block calls it, after top_of_iteration.
__device__ void kept_bitmaps(const Args& a, const Lane* lanes,
                             unsigned* bits, int max_iter) {
  const int nbj = a.m / TJ, tiles = (a.n / TI) * nbj;
  const int words = kept_words(a.n, a.m);
  for (int t = threadIdx.x; t < a.lanes * words; t += NT) bits[t] = 0u;
  __syncthreads();
  for (int t = threadIdx.x; t < a.lanes * tiles; t += NT) {
    const int L = t / tiles, k = t % tiles;
    const Lane& ln = lanes[L];
    if (!live(ln, max_iter)) continue;
    const Args la = at_lane<true, false>(a, L);
    float box[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (la.yb != nullptr) moved_box(ln.st, la.yb + 6 * (k % nbj), box);
    const float thres = ln.scal[cvo::S_D2_THRES] + SKIP_MARGIN;
    if (kept_tile(la.xb, box, thres, k / nbj))
      atomicOr(bits + L * words + (k >> 5), 1u << (k & 31));
  }
  __syncthreads();
}

// The number of t < total that kept(t) keeps, in every thread.
template <class Kept>
__device__ int count_kept(int total, const Kept& kept) {
  int k = 0;
  for (int c0 = 0; c0 < total; c0 += NT) {
    const int c = c0 + threadIdx.x;
    k += __syncthreads_count(c < total && kept(c));
  }
  return k;
}

// One moment item, a kept tile: i-tile ib against j-block jb, its
// partial momT and count; with STORE_W (resident mode) also the tile's
// weights, into W at its rows and columns.  The sweep stores them in
// shared memory, `wsm` [TI][TJ] (row_flow's, free while an item runs),
// and the block copies them out after it in 16-byte pieces: a global
// store in the sweep's loop, which the compiler cannot tell from the
// moments' stack copy, would make it write the 35 sums back every row.
template <bool FAST, bool STORE_W>
__device__ void moment_item(const Args& a, Shared& S, const Lane& ln, int jb,
                            int ib, float* wsm) {
  const int nbj = a.m / TJ;
  const int j = jb * TJ + threadIdx.x;
  __syncthreads();  // the last item no longer reads S.t
  cvo::mt::stage_begin(S.t, a.xp, a.xf, a.xm, a.phi, ib * TI, true);
  AlignWeight<FAST> w;
  w.linear = S.c[C_LINEAR] != 0.0f;
  w.color_scale = S.c[C_COLOR_SCALE];
  w.s = S.scal;
  transform(ln.st, a.yp + 3 * j, w.y);
#pragma unroll
  for (int c = 0; c < cvo::NFEAT; ++c) w.fy[c] = a.yf[cvo::NFEAT * j + c];
  w.ym = a.ym[j];
  cvo::mt::stage_end();
  float acc[NMOM];
#pragma unroll
  for (int k = 0; k < NMOM; ++k) acc[k] = 0.0f;
  const int cnt = cvo::mt::sweep<AlignWeight<FAST>, STORE_W>(
      S.t, w, acc, wsm + threadIdx.x, TJ);
  cvo::mt::store(acc, a.mom_part + static_cast<size_t>(ib) * NMOM * a.m, a.m,
                 jb * TJ);
  if constexpr (STORE_W) {
    __syncthreads();  // the tile's weights are all in wsm
    float* dst = a.w + static_cast<size_t>(ib) * TI * a.m + jb * TJ;
    for (int p = threadIdx.x; p < TI * TJ / 4; p += NT) {
      const int r = p / (TJ / 4), q = 4 * (p % (TJ / 4));
      *reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * a.m + q) =
          *reinterpret_cast<const float4*>(wsm + r * TJ + q);
    }
  }
  const int tot = block_count(cnt, S);
  if (threadIdx.x == 0) a.cnt_part[ib * nbj + jb] = tot;
}

// After an item's writes: true in every thread of the block whose item
// is the last of `total` to take a ticket at *ticket, which it resets
// for the next iteration.  The writes of the items before it are then
// visible to the block (read them at L2, __ldcg).
__device__ bool last_arrival(int* ticket, int total, Shared& S) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    S.last = atomicAdd(ticket, 1) == total - 1;
    if (S.last) atomicExch(ticket, 0);
  }
  __syncthreads();
  const bool last = S.last;
  if (last) __threadfence();
  return last;
}

// Bytes of the lanes' states in dynamic shared memory, and after them,
// in resident mode, the lanes' kept bitmaps and row_flow's: each warp's
// ring of W copies and staged transformed j-block, the kept j-blocks of
// each i-tile of a row block and their counts by warp.
__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) & ~size_t{15};
}
__host__ __device__ constexpr size_t lanes_bytes(int lanes) {
  return align16(static_cast<size_t>(lanes) * sizeof(Lane));
}
__host__ __device__ constexpr size_t bitmap_bytes(int lanes, int n, int m) {
  return align16(sizeof(unsigned) * static_cast<size_t>(lanes) *
                 kept_words(n, m));
}
__host__ __device__ constexpr size_t row_flow_bytes(int nbj) {
  return sizeof(float) * NW * (NSTAGE * 32 * WLD + 3 * TJ) +
         sizeof(int) * (PER_ROW * (static_cast<size_t>(nbj) + NW));
}

// Resident mode, once a row block's moment items have all run: ROWS rows
// of x, one a thread, the direct-form flow r_i = sum_j A_ij y_j - (sum_j
// A_ij) x_i and acvo's sum A d2, from the weights those items stored in W
// (read at L2: other blocks wrote them).  A row walks the j-blocks its
// i-tile keeps (bits, the lane's bitmap), in j order, and sums the
// nonzero weights with the FMAs of the row sweep this replaces: each
// row's sums and the ROWS-row block sum are then its bits, and a dropped
// tile, whose weights are all zero and unwritten, is the same sum.  After
// the kept lists, each warp runs on its own (its 32 rows lie in one
// i-tile): its W columns stream through its ring by cp.async, NSTAGE - 1
// stages ahead, and each j-block's tf * y through its buffer, the
// positions loaded half a j-block ahead.  `mem` is row_flow_bytes of
// dynamic shared memory.
template <bool ADAPTIVE>
__device__ void row_flow(const Args& a, Shared& S, const State& st, int rb,
                         const unsigned* bits, unsigned char* mem) {
  constexpr int CPB = TJ / JC;  // stages of a j-block
  constexpr int YC = TJ / 32;   // a lane's columns of a j-block
  const int nbj = a.m / TJ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* ring = reinterpret_cast<float*>(mem) + warp * NSTAGE * 32 * WLD;
  float* tyb = reinterpret_cast<float*>(mem) + NW * NSTAGE * 32 * WLD +
               warp * 3 * TJ;
  int* lists = reinterpret_cast<int*>(reinterpret_cast<float*>(mem) +
                                      NW * (NSTAGE * 32 * WLD + 3 * TJ));
  int* counts = lists + PER_ROW * nbj;  // [PER_ROW][NW]
  // each i-tile's kept j-blocks, in order
  int n_kept[PER_ROW] = {};
  for (int t0 = 0; t0 < nbj; t0 += NT) {
    const int jb = t0 + tid;
    int f = 0;
    if (jb < nbj)
      for (int h = 0; h < PER_ROW; ++h)
        f |= kept_bit(bits, nbj, PER_ROW * rb + h, jb) << h;
    unsigned ball[PER_ROW];
    for (int h = 0; h < PER_ROW; ++h)
      ball[h] = __ballot_sync(0xffffffffu, (f >> h) & 1);
    __syncthreads();  // the last window's counts are read
    if (lane == 0)
      for (int h = 0; h < PER_ROW; ++h)
        counts[h * NW + warp] = __popc(ball[h]);
    __syncthreads();
    for (int h = 0; h < PER_ROW; ++h) {
      int at = n_kept[h] + __popc(ball[h] & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) at += counts[h * NW + w];
      if ((f >> h) & 1) lists[h * nbj + at] = jb;
      for (int w = 0; w < NW; ++w) n_kept[h] += counts[h * NW + w];
    }
  }
  __syncthreads();
  // from here on each warp alone: its i-tile's list
  const int h = warp * 32 / TI;
  const int* list = lists + h * nbj;
  const int n_mine = h == 0 ? n_kept[0] : n_kept[PER_ROW - 1];
  const int total = n_mine * CPB;
  const int row0 = rb * ROWS + warp * 32;
  const float* wsrc = a.w + static_cast<size_t>(row0) * a.m;
  // stage s: columns JC (s % CPB) of kept j-block s / CPB of the warp's
  // rows into ring slot s % NSTAGE; one copy group each
  auto copy_stage = [&](int s) {
    if (s < total) {
      const float* src = wsrc + list[s / CPB] * TJ + (s % CPB) * JC;
      float* dst = ring + (s % NSTAGE) * 32 * WLD;
      for (int p = lane; p < 32 * JC / 4; p += 32) {
        const int r = p / (JC / 4), q = 4 * (p % (JC / 4));
        cvo::mt::cp_async16(dst + r * WLD + q,
                            src + static_cast<size_t>(r) * a.m + q);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // kept j-block k's positions, YC a lane, into py; then tf * y (as the
  // moment items transform them) into the warp's buffer
  float py[YC][3];
  auto load_y = [&](int k) {
    if (k >= n_mine) return;
    const float* yp = a.yp + 3 * list[k] * TJ;
    for (int c = 0; c < YC; ++c)
      for (int r = 0; r < 3; ++r) py[c][r] = yp[3 * (lane + 32 * c) + r];
  };
  auto put_y = [&]() {
    for (int c = 0; c < YC; ++c) {
      float ty[3];
      transform(st, py[c], ty);
      for (int r = 0; r < 3; ++r) tyb[r * TJ + lane + 32 * c] = ty[r];
    }
  };
  for (int s = 0; s < NSTAGE - 1; ++s) copy_stage(s);
  load_y(0);
  const int i = row0 + lane;
  const float x0 = a.xp[3 * i], x1 = a.xp[3 * i + 1], x2 = a.xp[3 * i + 2];
  float sA = 0.0f, s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, sxy = 0.0f;
  for (int s = 0; s < total; ++s) {
    copy_stage(s + NSTAGE - 1);  // into the slot stage s - 1 read
    // a j-block's first stage: its tf * y into the buffer, which the
    // last j-block's stages are done with; half-way, the next one's
    // positions on their way
    if (s % CPB == 0) put_y();
    if (s % CPB == CPB / 2) load_y(s / CPB + 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTAGE - 1));
    __syncwarp();  // stage s and tf * y are in place, from every lane
    const float* wr = ring + (s % NSTAGE) * 32 * WLD + lane * WLD;
    const float* y = tyb + (s % CPB) * JC;
#pragma unroll
    for (int c = 0; c < JC; c += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(wr + c);
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float w = wv[q];
        if (w != 0.0f) {
          const float y0 = y[c + q], y1 = y[TJ + c + q],
                      y2 = y[2 * TJ + c + q];
          sA += w;
          s0 = fmaf(w, y0, s0);
          s1 = fmaf(w, y1, s1);
          s2 = fmaf(w, y2, s2);
          if (ADAPTIVE)
            sxy = fmaf(w, cvo::sqdist3(x0, x1, x2, y0, y1, y2), sxy);
        }
      }
    }
    __syncwarp();  // slot s % NSTAGE and the buffer are read
  }
  const float r0 = s0 - sA * x0, r1 = s1 - sA * x1, r2 = s2 - sA * x2;
  float v[7] = {r0, r1, r2, x1 * r2 - x2 * r1, x2 * r0 - x0 * r2,
                x0 * r1 - x1 * r0, sxy};
  block_sum<7>(v, S);
  if (threadIdx.x == 0)
    for (int q = 0; q < 7; ++q) a.flow_part[rb * NFLOW + q] = v[q];
}

// acvo: one upper-triangle TW-square tile of a self-Gram.
template <bool RESIDENT, bool FAST>
__device__ void self_item(const Args& a, Shared& S, const Lane& ln, int item,
                          int t) {
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
      transform(ln.st, p, q);
      p[0] = q[0], p[1] = q[1], p[2] = q[2];
    }
    S.t.x[r] = make_float4(p[0], p[1], p[2], M[i]);
    for (int c = 0; c < cvo::NFEAT; ++c) S.t.f[r][c] = F[cvo::NFEAT * i + c];
  }
  __syncthreads();
  const int jj = threadIdx.x % TW;
  const int j = bj * TW + jj;
  float py[3] = {P[3 * j], P[3 * j + 1], P[3 * j + 2]};
  if (moved) {
    float q[3];
    transform(ln.st, py, q);
    py[0] = q[0], py[1] = q[1], py[2] = q[2];
  }
  float fy[cvo::NFEAT];
#pragma unroll
  for (int c = 0; c < cvo::NFEAT; ++c) fy[c] = F[cvo::NFEAT * j + c];
  const float ymj = M[j];
  float acc = 0.0f;
  int cnt = 0;
  for (int ii = threadIdx.x / TW; ii < TW; ii += NT / TW) {
    const float4 xi = S.t.x[ii];
    const float d2 = cvo::sqdist3(xi.x, xi.y, xi.z, py[0], py[1], py[2]);
    const float w =
        cvo::pair_full<FAST>(d2, S.t.f[ii], xi.w, fy, ymj, S.scal);
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

// Per j of a j-block whose moment items have all run: momT, the kept
// tiles' partials summed in i-tile order (a skipped tile's partial is
// zero and unwritten; kept(c) says whether i-tile c is kept), the
// j-block's count of A > 0, and in tiled mode the moment-form flow terms
// (core/moments.py:flow_from_moments).
template <bool RESIDENT, class Kept>
__device__ void column_item(const Args& a, Shared& S, const Lane& ln, int jb,
                            const Kept& kept) {
  const int j = jb * TJ + threadIdx.x;
  const int nbj = a.m / TJ;
  float sum[NMOM];
#pragma unroll
  for (int k = 0; k < NMOM; ++k) sum[k] = 0.0f;
  cvo::mt::column_sum(a.mom_part, a.n / TI, a.m, j, 0, kept, S.cs, sum);
#pragma unroll
  for (int k = 0; k < NMOM; ++k)
    a.mom[static_cast<size_t>(k) * a.m + j] = sum[k];
  // the kept tiles' item counts (n / TI <= NT, as fused_mode gives n <=
  // 8192: column_sum's one window left them in S.cs.list)
  int cnt = 0;
  if (threadIdx.x < S.cs.n)
    cnt = __ldcg(a.cnt_part + S.cs.list[threadIdx.x] * nbj + jb);
  const int tot = block_count(cnt, S);
  if (threadIdx.x == 0) a.cnt_col[jb] = tot;
  if (RESIDENT) return;
  const int* sh = S.sh;
  const float* mj = a.mom + j;
  const size_t m = a.m;
  const float S0 = mj[0];
  const float S1[3] = {mj[sh[1] * m], mj[sh[2] * m], mj[sh[3] * m]};
  const float S2tr = mj[sh[sh[1] * NSH + 1] * m] + mj[sh[sh[2] * NSH + 2] * m] +
                     mj[sh[sh[3] * NSH + 3] * m];
  float ty[3], tyc[3];
  transform(ln.st, a.yp + 3 * j, ty);
  for (int r = 0; r < 3; ++r) tyc[r] = ty[r] - ln.st.c0[r];
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
__device__ void contract_item(const Args& a, Shared& S, const Lane& ln,
                              int jb) {
  const int j = jb * TJ + threadIdx.x;
  const int* sh = S.sh;
  float mv[NMOM];
  for (int k = 0; k < NMOM; ++k) mv[k] = a.mom[static_cast<size_t>(k) * a.m + j];
  float ty[3], tyc[3];
  transform(ln.st, a.yp + 3 * j, ty);
  for (int r = 0; r < 3; ++r) tyc[r] = ty[r] - ln.st.c0[r];
  const float* w = ln.st.om;
  float xiz[3], xi2z[3], xi3z[3], xi4z[3];
  wcross(w, ty, xiz);
  for (int r = 0; r < 3; ++r) xiz[r] += ln.st.v[r];
  wcross(w, xiz, xi2z);
  wcross(w, xi2z, xi3z);
  wcross(w, xi3z, xi4z);
  const float tc = ln.scal[cvo::S_INV_2L2];
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

// Copies lane L's scalar row into S.scal, where the sweeps read it at a
// fixed address that keeps it in registers through their inner loops.
__device__ __forceinline__ void stage(Shared& S, const Lane& ln, int& staged,
                                      int L) {
  // no thread reads the last lane's row any more
  __syncthreads();
  for (int t = threadIdx.x; t < cvo::N_SCAL; t += NT) S.scal[t] = ln.scal[t];
  __syncthreads();
  staged = L;
}

// A permutation of [0, total): odd multiplies and xor-shifts, each a
// bijection of the `bits`-bit integers, walked until the value falls
// below total.  It scatters runs of neighbouring items, whatever the
// grid and the lane count.
__device__ __forceinline__ int scramble(int k, int total, int bits) {
  const unsigned mask = (bits >= 32 ? 0u : 1u << bits) - 1u;
  const int sh = bits / 2 + 1;
  unsigned x = static_cast<unsigned>(k);
  do {
    x = (x * 0x9E3779B1u) & mask;
    x ^= x >> sh;
    x = (x * 0x85EBCA6Bu) & mask;
    x ^= x >> sh;
  } while (x >= static_cast<unsigned>(total));
  return static_cast<int>(x);
}

// One thread a lane: tf and the ell-dependent scalar row from the state.
__device__ void top_of_iteration(Lane& ln, const float* c) {
  State& s = ln.st;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) s.Rt[3 * r + c] = s.R[3 * c + r];
  for (int r = 0; r < 3; ++r)
    s.tT[r] = __fadd_rn(__fadd_rn(__fmul_rn(s.Rt[3 * r], s.T[0]),
                                  __fmul_rn(s.Rt[3 * r + 1], s.T[1])),
                        __fmul_rn(s.Rt[3 * r + 2], s.T[2]));
  const float ell = s.ell;
  float* scal = ln.scal;
  scal[cvo::S_ELL] = ell;
  scal[cvo::S_S2] = c[C_S2];
  scal[cvo::S_CS2] = c[C_CS2];
  scal[cvo::S_INV_2L2] = 1.0f / (2.0f * ell * ell);
  scal[cvo::S_INV_2CL2] = c[C_INV2CL2];
  scal[cvo::S_D2_THRES] = c[C_THRES_C] * ell * ell;
  scal[cvo::S_D2_C_THRES] = c[C_D2_C_THRES];
  scal[cvo::S_SP_THRES] = c[C_SP_THRES];
}

// One thread a lane: omega, v (and acvo's dl) from the flow partials.
template <bool RESIDENT, bool ADAPTIVE>
__device__ void flow_scalars(const Args& a, Lane& ln, const float* c) {
  const int n_flow = RESIDENT ? a.n / ROWS : a.m / TJ;
  float acc[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int b = 0; b < n_flow; ++b)
    for (int q = 0; q < 7; ++q) acc[q] += a.flow_part[b * NFLOW + q];
  State& s = ln.st;
  const float inv_c = c[C_INV_C], inv_d = c[C_INV_D];
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

// One thread a lane: the step, the update, both stops and the ell update.
template <bool ADAPTIVE>
__device__ void tail(const Args& a, Lane& ln, const float* c) {
  const int nbj = a.m / TJ;
  float bc[4] = {0, 0, 0, 0};
  for (int b = 0; b < nbj; ++b)
    for (int q = 0; q < 4; ++q) bc[q] += a.bcde_part[b * 4 + q];
  State& s = ln.st;
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

template <bool RESIDENT, bool ADAPTIVE, bool FAST>
__global__ void __launch_bounds__(NT, 3) align_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Shared S;
  // every lane's state: a.lanes Lane records
  extern __shared__ __align__(16) unsigned char lane_mem[];
  Lane* lanes = reinterpret_cast<Lane*>(lane_mem);
  const int tid = threadIdx.x;
  for (int t = tid; t < NMOM * NSH; t += NT) S.sh[t] = a.shift[t];
  for (int t = tid; t < N_CONST; t += NT) S.c[t] = a.consts[t];
  for (int L = tid; L < a.lanes; L += NT) {
    State& s = lanes[L].st;
    const float* init = a.init + static_cast<size_t>(L) * NINIT;
    for (int i = 0; i < 9; ++i) s.R[i] = init[i];
    for (int i = 0; i < 3; ++i) s.T[i] = init[9 + i];
    for (int i = 0; i < 3; ++i) s.c0[i] = init[12 + i];
    s.ell = init[15];
    s.ell_max = a.consts[C_ELL_MAX_INIT];
    for (int i = 0; i < 9; ++i) s.Rt[i] = (i % 4 == 0) ? 1.0f : 0.0f;
    for (int i = 0; i < 3; ++i) s.tT[i] = s.om[i] = s.v[i] = 0.0f;
    s.dl = 0.0f;
    s.k = 0;
    s.conv = 0;
  }
  __syncthreads();

  // resident mode's kept bitmaps and row_flow scratch, after the lanes'
  // states
  unsigned* kept_bits =
      reinterpret_cast<unsigned*>(lane_mem + lanes_bytes(a.lanes));
  unsigned char* flow_mem = lane_mem + lanes_bytes(a.lanes) +
                            bitmap_bytes(a.lanes, a.n, a.m);
  const int words = kept_words(a.n, a.m);
  const int nbj = a.m / TJ;
  const int nbi = a.n / TI;
  const int n_mom = nbi * nbj;
  const int nbx = a.n / TW, nby = a.m / TW;
  const int tri_x = nbx * (nbx + 1) / 2;
  const int n_self = ADAPTIVE ? tri_x + nby * (nby + 1) / 2 : 0;
  const int n_items = n_mom + n_self;
  const int max_iter = static_cast<int>(S.c[C_MAX_ITER]);
#ifdef ALIGN_PHASE_TIMERS
  unsigned long long t_phase = 0;
#endif

  while (true) {
    PHASE_TOP();
    int any_live = 0;
    for (int L = tid; L < a.lanes; L += NT)
      if (live(lanes[L], max_iter)) {
        top_of_iteration(lanes[L], S.c);
        any_live = 1;
      }
    // every block reads the same lane states: all leave together
    if (!__syncthreads_or(any_live)) break;
    if constexpr (RESIDENT) kept_bitmaps(a, lanes, kept_bits, max_iter);

    // ---- phases 1-2: the sweeps, items over (lane, item) in a scrambled
    // order, so that the kept tiles, which cluster in item order, spread
    // over the blocks; a skipped tile's item costs its box test.  A
    // j-block's last kept moment item (by its ticket) or, when it keeps
    // none, its first item sums the j-block's partials, and in resident
    // mode a row block's the same forms its rows' flow; acvo's last
    // column or self item of a lane sums the counts and self sums ----
    int staged = -1;  // the lane whose scalar row S.scal holds
    const int total = a.lanes * n_items;
    const int bits = 32 - __clz(total);
    for (int k = blockIdx.x; k < total; k += gridDim.x) {
      const int item = scramble(k, total, bits);
      const int L = item / n_items, i = item % n_items;
      const Lane& ln = lanes[L];
      if (!live(ln, max_iter)) continue;  // block-uniform
      const Args la = at_lane<RESIDENT, ADAPTIVE>(a, L);
      ITEM_START();
      if (L != staged && i >= n_mom) stage(S, ln, staged, L);
      if (i < n_mom) {
        const int ib = i / nbj, jb = i % nbj;
        const unsigned* bits = kept_bits + L * words;
        float box[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        const float thres = ln.scal[cvo::S_D2_THRES] + SKIP_MARGIN;
        // whether i-tile c keeps this j-block
        const auto kept_c = [&](int c) {
          if constexpr (RESIDENT)
            return kept_bit(bits, nbj, c, jb);
          else
            return kept_tile(la.xb, box, thres, c);
        };
        if (!RESIDENT && la.yb != nullptr)
          moved_box(ln.st, la.yb + 6 * jb, box);
        const bool kept = kept_c(ib);
        // resident: a row block's first item stays too, to form the row
        // block's flow when the row block keeps no tile
        const bool row_head = RESIDENT && jb == 0 && ib % PER_ROW == 0;
        if (!kept && ib != 0 && !row_head) {  // block-uniform
          ITEM_DONE(1);
          continue;
        }
        if (L != staged) stage(S, ln, staged, L);
        const int n_kept = count_kept(nbi, kept_c);
        if (kept) {
          moment_item<FAST, RESIDENT>(la, S, ln, jb, ib,
                                      reinterpret_cast<float*>(flow_mem));
          ITEM_DONE(0);
        }
        const bool col = kept ? last_arrival(la.ticket + jb, n_kept, S)
                              : ib == 0 && n_kept == 0;
        if (col) {
          column_item<RESIDENT>(la, S, ln, jb, kept_c);
          ITEM_DONE(2);
        }
        if constexpr (RESIDENT) {
          // the moment items of the row block's kept tiles
          const int rb = ib / PER_ROW;
          const int r_kept = count_kept(PER_ROW * nbj, [&](int t) {
            return kept_bit(bits, nbj, PER_ROW * rb + t / nbj, t % nbj);
          });
          if (kept ? last_arrival(la.ticket + nbj + 1 + rb, r_kept, S)
                   : row_head && r_kept == 0) {
            row_flow<ADAPTIVE>(la, S, ln.st, rb, bits, flow_mem);
            ITEM_DONE(4);
          }
        }
        if (!col) continue;
      } else if constexpr (ADAPTIVE) {
        const int t = i - n_mom;
        self_item<RESIDENT, FAST>(la, S, ln, t, t);
        ITEM_DONE(5);
      }
      if (!ADAPTIVE || !last_arrival(la.ticket + nbj, nbj + n_self, S))
        continue;
      float w;
      long long cnt;
      block_range_sum(nullptr, la.cnt_col, 0, nbj, S, &w, &cnt);
      if (tid == 0) la.red[0] = static_cast<float>(cnt);
      block_range_sum(la.self_w, la.self_c, 0, tri_x, S, &w, &cnt);
      if (tid == 0) {
        la.red[1] = w;
        la.red[2] = static_cast<float>(cnt);
      }
      block_range_sum(la.self_w, la.self_c, tri_x, n_self, S, &w, &cnt);
      if (tid == 0) {
        la.red[3] = w;
        la.red[4] = static_cast<float>(cnt);
      }
      ITEM_DONE(3);
    }
    grid.sync();
    PHASE_MARK(0);

    // ---- phase 3: omega, v, dl; the line-search contraction ----
    for (int L = tid; L < a.lanes; L += NT)
      if (live(lanes[L], max_iter))
        flow_scalars<RESIDENT, ADAPTIVE>(at_lane<RESIDENT, ADAPTIVE>(a, L),
                                         lanes[L], S.c);
    __syncthreads();
    for (int item = blockIdx.x; item < a.lanes * nbj; item += gridDim.x) {
      const int L = item / nbj;
      const Lane& ln = lanes[L];
      if (!live(ln, max_iter)) continue;
      contract_item(at_lane<RESIDENT, ADAPTIVE>(a, L), S, ln, item % nbj);
    }
    grid.sync();
    PHASE_MARK(2);

    // ---- tail: every block, one thread a lane, the same bits ----
    for (int L = tid; L < a.lanes; L += NT)
      if (live(lanes[L], max_iter))
        tail<ADAPTIVE>(at_lane<RESIDENT, ADAPTIVE>(a, L), lanes[L], S.c);
    __syncthreads();
    PHASE_MARK(3);
  }

  if (blockIdx.x == 0)
    for (int L = tid; L < a.lanes; L += NT) {
      const State& s = lanes[L].st;
      float* o = a.out + static_cast<size_t>(L) * NOUT;
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

template <bool RESIDENT, bool ADAPTIVE, bool FAST>
int launch_form(Args a, cudaStream_t stream) {
  const auto kernel = align_kernel<RESIDENT, ADAPTIVE, FAST>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  // the lanes' states, and resident mode's row_flow scratch
  const size_t dyn =
      lanes_bytes(a.lanes) +
      (RESIDENT ? bitmap_bytes(a.lanes, a.n, a.m) + row_flow_bytes(a.m / TJ)
                : 0);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  // static and dynamic shared memory above 48 KB only after opting in
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dyn));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, NT, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int grid = sms * (per_sm < BLOCKS_PER_SM ? per_sm : BLOCKS_PER_SM);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(NT), params, dyn,
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The form of the launch: adaptive or not, exp_neg or __expf.
template <bool RESIDENT>
int launch(const Args& a, int adaptive, int fast, cudaStream_t stream) {
  if (adaptive)
    return fast ? launch_form<RESIDENT, true, true>(a, stream)
                : launch_form<RESIDENT, true, false>(a, stream);
  return fast ? launch_form<RESIDENT, false, true>(a, stream)
              : launch_form<RESIDENT, false, false>(a, stream);
}

Args pack(const float* xp, const float* xf, const float* xm, const float* yp,
          const float* yf, const float* ym, const float* phi,
          const int* shift, const float* xb, const float* yb,
          const float* md_xx, const float* md_yy, const float* consts,
          const float* init, const float* sched, float* mom_part,
          int* cnt_part, int* cnt_col, int* ticket, float* mom,
          float* flow_part, float* self_w, int* self_c, float* red,
          float* bcde_part, float* w, float* out, int n, int m, int n_sched,
          int lanes) {
  Args a;
  a.xp = xp, a.xf = xf, a.xm = xm, a.yp = yp, a.yf = yf, a.ym = ym;
  a.phi = phi, a.shift = shift, a.xb = xb, a.yb = yb;
  a.md_xx = md_xx, a.md_yy = md_yy;
  a.consts = consts, a.init = init, a.sched = sched, a.mom_part = mom_part;
  a.cnt_part = cnt_part, a.cnt_col = cnt_col, a.ticket = ticket;
  a.mom = mom, a.flow_part = flow_part;
  a.self_w = self_w, a.self_c = self_c, a.red = red, a.bcde_part = bcde_part;
  a.w = w, a.out = out, a.n = n, a.m = m;
  a.n_sched = n_sched, a.lanes = lanes;
  return a;
}

}  // namespace

#define ALIGN_FUSED_ARGS                                                     \
  const float *xp, const float *xf, const float *xm, const float *yp,        \
      const float *yf, const float *ym, const float *phi, const int *shift,  \
      const float *xb, const float *yb, const float *md_xx,                  \
      const float *md_yy, const float *consts, const float *init,            \
      const float *sched, float *mom_part, int *cnt_part, int *cnt_col,      \
      int *ticket, float *mom, float *flow_part, float *self_w, int *self_c, \
      float *red, float *bcde_part, float *w, float *out, int n, int m,      \
      int n_sched, int adaptive, int fast, int lanes, cudaStream_t stream

#define ALIGN_FUSED_PACK                                                     \
  pack(xp, xf, xm, yp, yf, ym, phi, shift, xb, yb, md_xx, md_yy, consts,     \
       init, sched, mom_part, cnt_part, cnt_col, ticket, mom, flow_part,     \
       self_w, self_c, red, bcde_part, w, out, n, m, n_sched, lanes)

// Both modes: xb [lanes, n / 64, 6] and yb [lanes, m / 128, 6] tile
// boxes of the clouds or null (no skip); for acvo, md_xx / md_yy the
// self bounds at 64 or null.  Every array has a
// leading axis of `lanes`, but consts and sched, which all lanes share;
// scratch shapes are those of ops/align_fused.py:lane_scratch, the
// tickets zeroed, w null in tiled mode; fast takes the hardware exp
// (params.exp_mode="fast").  Returns a cudaError_t.
extern "C" int align_fused_tiled_launch(ALIGN_FUSED_ARGS) {
  const Args a = ALIGN_FUSED_PACK;
  return launch<false>(a, adaptive, fast, stream);
}

#ifdef ALIGN_PHASE_TIMERS
// Copies the phase sums [4] and the iteration count into host `out` [5]
// and, when `reset`, zeroes them.  Returns a cudaError_t.
extern "C" int align_fused_phase_ns(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_ns, sizeof(g_phase_ns));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[NPHASE + 1] = {};
    err = cudaMemcpyToSymbol(g_phase_ns, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}

// Copies phase 1's work by item kind [2 * 6] (ns, then items) and each
// block's busy ns [4096] into host `out` and, when `reset`, zeroes them.
extern "C" int align_fused_item_ns(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_kind_ns, sizeof(g_kind_ns));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out + 2 * NKIND, g_busy_ns, sizeof(g_busy_ns));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[MAX_TIMED_GRID] = {};
    err = cudaMemcpyToSymbol(g_kind_ns, zero, sizeof(g_kind_ns));
    if (err == cudaSuccess)
      err = cudaMemcpyToSymbol(g_busy_ns, zero, sizeof(g_busy_ns));
  }
  return static_cast<int>(err);
}
#endif

extern "C" int align_fused_resident_launch(ALIGN_FUSED_ARGS) {
  const Args a = ALIGN_FUSED_PACK;
  return launch<true>(a, adaptive, fast, stream);
}
