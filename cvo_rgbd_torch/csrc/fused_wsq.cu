// fused_wsq: the lean self-kernel sweep of adaptive CVO.
//
// Replaces the JAX package's ops/pallas_moments.py:fused_wsq (_wsq_body,
// A tile from pallas_gram.py:_pair_tile):
//   wsq = sum_ij A_ij * d2_ij      nnz = #{(i, j) : A_ij > 0}
// the only two quantities the adaptive dl reduction needs from the
// self-kernels Axx / Ayy (adaptive_cvo.cpp:222-271).  A is gated exactly
// as in fused_moments.cu (pair_tile.cuh), with the same exact AABB skip
// of tiles whose lower bound on d2 exceeds d2_thres + SKIP_MARGIN, and is
// compiled with exp_neg and, for params.exp_mode="fast", with __expf.
//
// Bound on the H100: per kept pair ~37 fp32 operations (d2, exp, gate,
// the a*d2 FMA) and 4 bytes of ck when the color kernel is cached; the
// inputs are a few hundred KB.  At acvo's length-scales only the
// near-diagonal band of a kd-sorted self-pair is kept (71-109 of 1176
// tiles on the 3072 render pair), well under a microsecond of work, so what
// is left is latency: the launch, finding the kept tiles, one tile's
// sweep and the final sum.  The design serves that chain:
//   - sweeps: one launch takes S sweeps, each its own clouds, ck, tile
//     order, scalar row, partials, ticket and output pair (acvo's exact
//     iteration: Axx and Ayy, S = 2; the Chebyshev tables: both clouds
//     at each of K nodes, S = 2K);
//   - a kept prefix: the wrapper sorts a sweep's tile ids by their
//     bound once per align (stably, ties by id), and the bounds of a
//     self-pair never change within an align (self distances are
//     rigid-invariant), so the tiles kept at any ell are a prefix of
//     that order.  Every block finds each sweep's prefix length with two
//     rounds of warp loads (kept_prefix), with no host sync;
//   - a persistent grid of two blocks an SM (ops/wsq.py BLOCKS_PER_SM:
//     2, 4 and 8 ran within 1 us of each other on the card, 2 the least
//     on an iteration's two sweeps): block b sweeps the kept tiles b,
//     b + grid, ... of all sweeps' prefixes laid end to end, so the kept
//     tiles spread over the SMs and no block walks a chain of them while
//     the others have exited;
//   - a tile's arithmetic is the parent design's, bit for bit: square TW
//     x TW tiles, with `symmetric` only the upper triangle (bj >= bi,
//     ids row by row) and off-diagonal tiles weighted 2
//     (pallas_moments.py:270-275); a thread holds one y column and rows
//     r0, r0 + 4, ...; a warp reads one x row as a broadcast and 32
//     consecutive ck entries of that row, coalesced; each thread sums
//     a*d2 in fp32 and counts gates as an int, then warp shuffles and
//     the warps in order give the tile's partial;
//   - the reduction folded in: a kept tile writes its partial at its
//     tile id and takes its sweep's ticket (an acquire-release atomic);
//     the block that takes the last one sums the sweep's kept partials
//     in the order of the parent's second kernel (thread t over ids t,
//     t + 256, ..., then a shared-memory tree), and leaves the ticket
//     zero.  A skipped tile's partial was +0 and every partial is >= +0,
//     so leaving it out changes no bit.  No float atomics: wsq, and
//     through dl the ell trajectory and the iteration counts, are the
//     same from run to run.
#include <cuda_runtime.h>

#include "pair_tile.cuh"

namespace {

constexpr int TW = 64;               // tile width; must match ops/wsq.py TILE_W
constexpr int THREADS = 256;
constexpr int ROWS_PER_PASS = THREADS / TW;  // 4 row groups
constexpr int ROWS_PER_THREAD = TW / ROWS_PER_PASS;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SWEEPS = 32;       // ops/wsq.py MAX_SWEEPS
constexpr float SKIP_MARGIN = 1e-5f;  // ops/moments.py SKIP_MARGIN

}  // namespace

// One sweep of a launch; the layout of ops/wsq.py _SweepArgs.
struct WsqSweep {
  const float *xp, *xf, *xm, *yp, *yf, *ym;
  const float* ck;         // [n, m] color cache, or null (recompute)
  const float* scal;       // [8] scalar row
  const int* order;        // [n_tiles] tile ids, bound ascending; null: no skip
  const float* md_sorted;  // [n_tiles] the bounds in that order
  const float* md_by_id;   // [n_tiles] the bounds in tile-id order
  float* out;              // [2]: wsq, nnz
  int n, m, symmetric, n_tiles, part0;  // part0: first slot in the partials
};

namespace {

struct WsqSweeps {
  WsqSweep s[MAX_SWEEPS];
  int count;
};
// passed by value: with the other three arguments, within the 4 KB of
// kernel parameters every CUDA 12 toolkit takes
static_assert(sizeof(WsqSweeps) + 3 * sizeof(void*) <= 4096,
              "too many sweeps for one launch's parameters");

__device__ __forceinline__ float keep_thres(const WsqSweep& S) {
  return S.scal[cvo::S_D2_THRES] + SKIP_MARGIN;
}

// Count of md[0..n) <= thr, md ascending, by one warp: the first entry of
// each of 32 segments, then the one segment where the kept prefix ends.
__device__ int kept_prefix(const float* md, int n, float thr, int lane) {
  const int seg = (n + 31) / 32;
  const int k = lane * seg;
  const bool first = k < n && md[k] <= thr;
  const int p = __popc(__ballot_sync(0xffffffffu, first));
  if (p == 0) return 0;
  const int base = (p - 1) * seg;
  const int end = min(base + seg, n);
  int kept = base;
  for (int t0 = base; t0 < end; t0 += 32) {
    const int t = t0 + lane;
    kept += __popc(__ballot_sync(0xffffffffu, t < end && md[t] <= thr));
  }
  return kept;
}

// The tile of id `id`: upper triangle row by row when symmetric (the
// loop is block-uniform and at most nbj long), else row-major.
__device__ __forceinline__ void tile_of(int id, int nbj, int symmetric,
                                        int* bi, int* bj) {
  if (symmetric) {
    int t = id, row = nbj, b = 0;
    while (t >= row) {
      t -= row;
      --row;
      ++b;
    }
    *bi = b;
    *bj = b + t;
  } else {
    *bi = id / nbj;
    *bj = id - *bi * nbj;
  }
}

struct Smem {
  float x[3][TW];
  float f[TW][cvo::NFEAT];
  float m[TW];
  float wsq[WARPS];
  int cnt[WARPS];
  int kept[MAX_SWEEPS + 1];  // prefix sums of the sweeps' kept tiles
  float red_w[THREADS];
  long long red_c[THREADS];
  int last;
};

// One tile's weighted partial (valid in thread 0), the parent's
// wsq_partial_kernel body.
// The column's loads and its ck entries are all issued before the rows
// are staged, so the tile waits for one round of loads, not one a row.
template <bool USE_CK, bool FAST>
__device__ void sweep_tile(const WsqSweep& S, int bi, int bj, Smem& sm,
                           float* w_out, int* c_out) {
  const int i0 = bi * TW;
  const int jj = threadIdx.x % TW;
  const int r0 = threadIdx.x / TW;
  const int j = bj * TW + jj;
  const float* yp = S.yp;
  const float y0 = yp[3 * j], y1 = yp[3 * j + 1], y2 = yp[3 * j + 2];
  float fy[cvo::NFEAT];
  float ymj = 0.0f;
  float ckv[USE_CK ? ROWS_PER_THREAD : 1];
  if constexpr (USE_CK) {
#pragma unroll
    for (int k = 0; k < ROWS_PER_THREAD; ++k)
      ckv[k] = __ldg(S.ck +
                     static_cast<size_t>(i0 + r0 + k * ROWS_PER_PASS) * S.m +
                     j);
  } else {
#pragma unroll
    for (int c = 0; c < cvo::NFEAT; ++c) fy[c] = S.yf[cvo::NFEAT * j + c];
    ymj = S.ym[j];
  }
  for (int t = threadIdx.x; t < TW * 3; t += THREADS)
    sm.x[t % 3][t / 3] = S.xp[3 * i0 + t];
  if constexpr (!USE_CK) {
    for (int t = threadIdx.x; t < TW * cvo::NFEAT; t += THREADS)
      sm.f[t / cvo::NFEAT][t % cvo::NFEAT] = S.xf[cvo::NFEAT * i0 + t];
    for (int t = threadIdx.x; t < TW; t += THREADS) sm.m[t] = S.xm[i0 + t];
  }
  __syncthreads();

  const float* scal = S.scal;
  float acc = 0.0f;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int ii = r0 + k * ROWS_PER_PASS;
    const float d2 =
        cvo::sqdist3(sm.x[0][ii], sm.x[1][ii], sm.x[2][ii], y0, y1, y2);
    float a;
    if constexpr (USE_CK) {
      a = cvo::pair_cached<FAST>(d2, ckv[k], scal);
    } else {
      a = cvo::pair_full<FAST>(d2, sm.f[ii], sm.m[ii], fy, ymj, scal);
    }
    if (a > 0.0f) {
      ++cnt;
      acc = fmaf(a, d2, acc);
    }
  }

  // fixed-order block reduction
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  if ((threadIdx.x & 31) == 0) {
    sm.wsq[threadIdx.x >> 5] = acc;
    sm.cnt[threadIdx.x >> 5] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float w = 0.0f;
    int c = 0;
    for (int k = 0; k < WARPS; ++k) {
      w += sm.wsq[k];
      c += sm.cnt[k];
    }
    // off-diagonal tiles of a symmetric sweep stand for their transpose
    const int weight = (S.symmetric && bj != bi) ? 2 : 1;
    *w_out = static_cast<float>(weight) * w;
    *c_out = weight * c;
  }
}

// The sweep's output from its kept tiles' partials, in the parent's
// wsq_reduce_kernel order: thread t over ids t, t + THREADS, ..., then
// the shared-memory tree.  The partials were written by other blocks
// before their release; this block's acquire made them visible, and
// __ldcg reads them at L2.  A thread issues the loads of U ids at once
// (a skipped tile's slot is read and not used).
__device__ void final_sum(const WsqSweep& S, const float* part,
                          const int* cnt, Smem& sm) {
  constexpr int U = 8;
  const float thr = keep_thres(S);
  const int last = S.n_tiles - 1;
  float w = 0.0f;
  long long c = 0;
  for (int t0 = threadIdx.x; t0 < S.n_tiles; t0 += U * THREADS) {
    float md[U], pw[U];
    int pc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = min(t0 + u * THREADS, last);
      md[u] = S.md_by_id == nullptr ? 0.0f : S.md_by_id[t];
      pw[u] = __ldcg(part + S.part0 + t);
      pc[u] = __ldcg(cnt + S.part0 + t);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u * THREADS < S.n_tiles &&
          (S.md_by_id == nullptr || md[u] <= thr)) {
        w += pw[u];
        c += pc[u];
      }
    }
  }
  sm.red_w[threadIdx.x] = w;
  sm.red_c[threadIdx.x] = c;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sm.red_w[threadIdx.x] += sm.red_w[threadIdx.x + s];
      sm.red_c[threadIdx.x] += sm.red_c[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    S.out[0] = sm.red_w[0];
    S.out[1] = static_cast<float>(sm.red_c[0]);
  }
  __syncthreads();
}

template <bool USE_CK, bool FAST>
__global__ void __launch_bounds__(THREADS)
wsq_kernel(const __grid_constant__ WsqSweeps sw, float* __restrict__ part,
           int* __restrict__ cnt, int* __restrict__ tickets) {
  __shared__ Smem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // each sweep's kept prefix, a warp a sweep
  for (int s = warp; s < sw.count; s += WARPS) {
    const WsqSweep& S = sw.s[s];
    const int k = S.order == nullptr
                      ? S.n_tiles
                      : kept_prefix(S.md_sorted, S.n_tiles, keep_thres(S),
                                    lane);
    if (lane == 0) sm.kept[s + 1] = k;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm.kept[0] = 0;
    for (int s = 0; s < sw.count; ++s) {
      // a sweep that keeps no tile takes no ticket: its output is the
      // parent's sum of +0 partials, written by one block
      if (sm.kept[s + 1] == 0 && s % gridDim.x == blockIdx.x) {
        sw.s[s].out[0] = 0.0f;
        sw.s[s].out[1] = 0.0f;
      }
      sm.kept[s + 1] += sm.kept[s];
    }
  }
  __syncthreads();

  const int total = sm.kept[sw.count];
  int s = 0;
  for (int f = blockIdx.x; f < total; f += gridDim.x) {
    while (f >= sm.kept[s + 1]) ++s;
    const WsqSweep& S = sw.s[s];
    const int k = f - sm.kept[s];
    const int id = S.order == nullptr ? k : S.order[k];
    int bi, bj;
    tile_of(id, S.m / TW, S.symmetric, &bi, &bj);
    float w;
    int c;
    sweep_tile<USE_CK, FAST>(S, bi, bj, sm, &w, &c);
    if (threadIdx.x == 0) {
      part[S.part0 + id] = w;
      cnt[S.part0 + id] = c;
      int old;
      asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                   : "=r"(old) : "l"(tickets + s) : "memory");
      sm.last = old == sm.kept[s + 1] - sm.kept[s] - 1;
      if (sm.last) atomicExch(tickets + s, 0);
    }
    __syncthreads();
    if (sm.last) final_sum(S, part, cnt, sm);
  }
}

}  // namespace

// sweeps: [count] host array, count <= MAX_SWEEPS, every sweep with ck
// (use_ck) or none; part / cnt: [sum of n_tiles] f32 / i32 scratch;
// tickets: [count] i32, zero at launch and left zero; blocks: the grid;
// fast takes the hardware exp (params.exp_mode="fast").
extern "C" int fused_wsq_launch(const WsqSweep* sweeps, int count,
                                float* part, int* cnt, int* tickets,
                                int use_ck, int fast, int blocks,
                                cudaStream_t stream) {
  if (count < 1 || count > MAX_SWEEPS) return cudaErrorInvalidValue;
  WsqSweeps sw;
  for (int s = 0; s < count; ++s) sw.s[s] = sweeps[s];
  sw.count = count;
  const auto fn = use_ck ? (fast ? wsq_kernel<true, true>
                                 : wsq_kernel<true, false>)
                         : (fast ? wsq_kernel<false, true>
                                 : wsq_kernel<false, false>);
  fn<<<blocks, THREADS, 0, stream>>>(sw, part, cnt, tickets);
  return static_cast<int>(cudaGetLastError());
}
