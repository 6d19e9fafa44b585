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
//   - lanes: the S sweeps of B pairs (the batched align loop, JAX's
//     vmap of the Pallas kernel over align_batched's lanes) in the same
//     launch.  A sweep describes its B lanes as stacked tensors, a lane
//     of each at the lane stride its shape gives (clouds [B, n, *], ck
//     [B, n, m], the tile order [B, tiles]), its scalar row at the
//     launch's scalar lane stride; a (lane, sweep) unit has its own
//     partials, ticket and output pair, so each unit is the bits of the
//     one-pair launch of that sweep.  A lane whose `live` byte is 0 (a
//     converged lane of the batched loop, frozen whatever it gets) keeps
//     no tile and takes no ticket: its outputs are zero;
//   - a kept prefix: the wrapper sorts a sweep's tile ids by their
//     bound once per align (stably, ties by id), and the bounds of a
//     self-pair never change within an align (self distances are
//     rigid-invariant), so the tiles kept at any ell are a prefix of
//     that order.  Every block finds each unit's prefix length with two
//     rounds of warp loads (kept_prefix, a warp a unit: B S / 8 rounds a
//     block), with no host sync, then lays the units end to end by a
//     block-wide scan (a warp taking four units at once, their loads in
//     flight together, ran a one-pair launch 0.3-0.5 us slower);
//   - a persistent grid (ops/wsq.py persistent_grid: two blocks an SM,
//     as many as 128 registers a thread leave room for, at most one a
//     swept tile) whose blocks split the kept tiles laid
//     end to end into contiguous runs of ceil(kept / grid) (the device
//     sizes the work a block takes by the batch's kept tiles, which the
//     host does not know): one pair's few kept tiles one a block, side
//     by side on their SMs; a batch's thousands a run of them a block;
//   - a block's tiles overlap: the next kept tile's ck and y are loaded
//     into registers and its x rows copied (cp.async) into a second
//     shared buffer while the block sweeps the current one, so a tile
//     waits for no load of its own after the first;
//   - a tile's arithmetic is the parent design's, bit for bit: square TW
//     x TW tiles, with `symmetric` only the upper triangle (bj >= bi,
//     ids row by row) and off-diagonal tiles weighted 2
//     (pallas_moments.py:270-275); a thread holds one y column and rows
//     r0, r0 + 4, ...; a warp reads one x row as a broadcast and 32
//     consecutive ck entries of that row, coalesced; each thread sums
//     a*d2 in fp32 and counts gates as an int, then warp shuffles and
//     the warps in order give the tile's partial;
//   - the reduction folded in: a kept tile writes its partial at its
//     tile id; a block takes its unit's ticket (an acquire-release
//     atomic) once for each run of that unit's tiles it swept, adding
//     the run's length; the block whose run brings the ticket to the
//     unit's kept count sums the unit's kept partials in the order of
//     the parent's second kernel (thread t over ids t, t + 256, ...,
//     then its tree: the same pairs, the last five steps in warp 0's
//     shuffles, not behind barriers), and leaves the ticket zero.  A skipped
//     tile's partial was +0 and every partial is >= +0, so leaving it
//     out changes no bit.  No float atomics: wsq, and through dl the ell
//     trajectory and the iteration counts, are the same from run to run.
#include <cuda_runtime.h>

#include "pair_tile.cuh"

namespace {

constexpr int TW = 64;               // tile width; must match ops/wsq.py TILE_W
constexpr int THREADS = 256;
constexpr int ROWS_PER_PASS = THREADS / TW;  // 4 row groups
constexpr int ROWS_PER_THREAD = TW / ROWS_PER_PASS;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SWEEPS = 32;       // ops/wsq.py MAX_SWEEPS
// (lane, sweep) units a launch, ops/wsq.py MAX_UNITS: their kept
// prefixes live in shared memory (8 KB), and a 63-lane batch of the
// Chebyshev tables (63 x 24 units) fits
constexpr int MAX_UNITS = 2048;
constexpr float SKIP_MARGIN = 1e-5f;  // ops/moments.py SKIP_MARGIN

}  // namespace

// One sweep of a launch, lane 0's pointers; the layout of ops/wsq.py
// _SweepArgs.  Lane b of a tensor lies b times its per-lane size
// further on (clouds n or m rows, ck n m entries, the tile order
// n_tiles ids), its scalar row b times the launch's scal_ls floats.
struct WsqSweep {
  const float *xp, *xf, *xm, *yp, *yf, *ym;
  const float* ck;         // [n, m] color cache, or null (recompute)
  const float* scal;       // [8] scalar row
  const int* order;        // [n_tiles] tile ids, bound ascending; null: no skip
  const float* md_sorted;  // [n_tiles] the bounds in that order
  const float* md_by_id;   // [n_tiles] the bounds in tile-id order
  int n, m, symmetric, n_tiles, part0;  // part0: first slot in a lane's partials
};

namespace {

// The launch's description, passed by value.
struct WsqLaunch {
  WsqSweep s[MAX_SWEEPS];
  int count;         // sweeps S
  int lanes;         // B; units B S, lane-major
  int scal_ls;       // floats from one lane's scalar rows to the next's
  int part_ls;       // partial slots of a lane (every sweep's tiles)
  int out_ls;        // floats from one lane's outputs to the next's
};
// with the other five arguments, within the 4 KB of kernel parameters
// every CUDA 12 toolkit takes
static_assert(sizeof(WsqLaunch) + 5 * sizeof(void*) <= 4096,
              "too many sweeps for one launch's parameters");

__device__ __forceinline__ float keep_thres(const float* scal) {
  return scal[cvo::S_D2_THRES] + SKIP_MARGIN;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
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

// One staged tile's x rows (and, recomputing the color kernel, its
// features and mask).
struct XTile {
  float x[3][TW];
  float f[TW][cvo::NFEAT];
  float m[TW];
};

struct Smem {
  XTile xt[2];              // this tile's rows and the next one's
  float wsq[WARPS];
  int cnt[WARPS];
  int kept[MAX_UNITS + 1];  // prefix sums of the units' kept tiles
  int scan[THREADS];
  float red_w[THREADS];
  long long red_c[THREADS];
  int last;                 // a unit whose last run this block swept, or -1
};

// One kept tile as a block sweeps it: its unit, lane, sweep and place.
struct TileRef {
  const WsqSweep* S;
  const float* scal;  // the lane's scalar row of the sweep
  size_t b;           // lane
  int u, id, bi, bj;
};

// The id of the k-th kept tile of unit u, read from the unit's order
// (issued ahead of its use: the loads of the tile wait on it).
__device__ __forceinline__ int tile_id(const WsqLaunch& L, int u, int k) {
  const int lb = u / L.count;
  const WsqSweep& S = L.s[u - lb * L.count];
  return S.order == nullptr
             ? k
             : __ldg(S.order + static_cast<size_t>(lb) * S.n_tiles + k);
}

// The ref of the kept tile `id` of unit u.
__device__ __forceinline__ TileRef tile_ref(const WsqLaunch& L, int u,
                                            int id) {
  TileRef r;
  const int lb = u / L.count;
  r.S = &L.s[u - lb * L.count];
  r.b = lb;
  r.u = u;
  r.id = id;
  r.scal = r.S->scal + r.b * L.scal_ls;
  tile_of(id, r.S->m / TW, r.S->symmetric, &r.bi, &r.bj);
  return r;
}

// A tile's loads: the thread's y column (and, recomputing, its features
// and mask) and its ck entries into registers, the tile's x rows into a
// shared buffer with cp.async (waited for by the caller).
template <bool USE_CK>
struct TileLoads {
  float y[3];
  float fy[cvo::NFEAT];
  float ym;
  float ck[USE_CK ? ROWS_PER_THREAD : 1];

  __device__ __forceinline__ void issue(const TileRef& r, XTile& xt) {
    const WsqSweep& S = *r.S;
    const int i0 = r.bi * TW;
    const int jj = threadIdx.x % TW;
    const int r0 = threadIdx.x / TW;
    const int j = r.bj * TW + jj;
    const float* yp = S.yp + r.b * S.m * 3;
    y[0] = yp[3 * j];
    y[1] = yp[3 * j + 1];
    y[2] = yp[3 * j + 2];
    if constexpr (USE_CK) {
#pragma unroll
      for (int k = 0; k < ROWS_PER_THREAD; ++k)
        ck[k] = __ldg(S.ck + r.b * S.n * S.m +
                      static_cast<size_t>(i0 + r0 + k * ROWS_PER_PASS) * S.m +
                      j);
    } else {
      const float* yf = S.yf + r.b * S.m * cvo::NFEAT;
#pragma unroll
      for (int c = 0; c < cvo::NFEAT; ++c) fy[c] = yf[cvo::NFEAT * j + c];
      ym = S.ym[r.b * S.m + j];
    }
    const float* xp = S.xp + r.b * S.n * 3;
    for (int t = threadIdx.x; t < TW * 3; t += THREADS)
      cp_async4(&xt.x[t % 3][t / 3], xp + 3 * i0 + t);
    if constexpr (!USE_CK) {
      const float* xf = S.xf + r.b * S.n * cvo::NFEAT;
      const float* xm = S.xm + r.b * S.n;
      for (int t = threadIdx.x; t < TW * cvo::NFEAT; t += THREADS)
        cp_async4(&xt.f[t / cvo::NFEAT][t % cvo::NFEAT],
                  xf + cvo::NFEAT * i0 + t);
      for (int t = threadIdx.x; t < TW; t += THREADS)
        cp_async4(&xt.m[t], xm + i0 + t);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
};

// One tile's weighted partial (valid in thread 0), the parent's
// wsq_partial_kernel body, from its loads and staged rows: each thread
// its rows in order, warp shuffles, then thread 0 sums the warps in
// order.  Ends behind a barrier that leaves the x buffer free.
template <bool USE_CK, bool FAST>
__device__ __forceinline__ void sweep_tile(const TileRef& r,
                                           const TileLoads<USE_CK>& ld,
                                           const XTile& xt, Smem& sm,
                                           float* w_out, int* c_out) {
  const int r0 = threadIdx.x / TW;
  float acc = 0.0f;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int ii = r0 + k * ROWS_PER_PASS;
    const float d2 = cvo::sqdist3(xt.x[0][ii], xt.x[1][ii], xt.x[2][ii],
                                  ld.y[0], ld.y[1], ld.y[2]);
    float a;
    if constexpr (USE_CK) {
      a = cvo::pair_cached<FAST>(d2, ld.ck[k], r.scal);
    } else {
      a = cvo::pair_full<FAST>(d2, xt.f[ii], xt.m[ii], ld.fy, ld.ym, r.scal);
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
    const int weight = (r.S->symmetric && r.bj != r.bi) ? 2 : 1;
    *w_out = static_cast<float>(weight) * w;
    *c_out = weight * c;
  }
}

// The unit's output from its kept tiles' partials, in the parent's
// wsq_reduce_kernel order: thread t over ids t, t + THREADS, ..., then
// the shared-memory tree.  The partials were written by other blocks
// before their release; this block's acquire made them visible, and
// __ldcg reads them at L2.  A thread issues the loads of U ids at once
// (a skipped tile's slot is read and not used).
__device__ void final_sum(const WsqSweep& S, size_t b, const float* scal,
                          const float* part, const int* cnt, float* out,
                          Smem& sm) {
  constexpr int U = 8;
  const float* md_by_id =
      S.md_by_id == nullptr ? nullptr : S.md_by_id + b * S.n_tiles;
  const float thr = keep_thres(scal);
  const int last = S.n_tiles - 1;
  float w = 0.0f;
  long long c = 0;
  for (int t0 = threadIdx.x; t0 < S.n_tiles; t0 += U * THREADS) {
    float md[U], pw[U];
    int pc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = min(t0 + u * THREADS, last);
      md[u] = md_by_id == nullptr ? 0.0f : md_by_id[t];
      pw[u] = __ldcg(part + t);
      pc[u] = __ldcg(cnt + t);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u * THREADS < S.n_tiles &&
          (md_by_id == nullptr || md[u] <= thr)) {
        w += pw[u];
        c += pc[u];
      }
    }
  }
  sm.red_w[threadIdx.x] = w;
  sm.red_c[threadIdx.x] = c;
  __syncthreads();
  // the tree: thread t adds t + s for s = 128, 64, 32 in shared memory,
  // then 16 .. 1 in warp 0's registers (the same pairs, in the same
  // order)
  for (int s = THREADS / 2; s >= 32; s >>= 1) {
    if (threadIdx.x < s) {
      sm.red_w[threadIdx.x] += sm.red_w[threadIdx.x + s];
      sm.red_c[threadIdx.x] += sm.red_c[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    w = sm.red_w[threadIdx.x];
    c = sm.red_c[threadIdx.x];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      w += __shfl_down_sync(0xffffffffu, w, s);
      c += __shfl_down_sync(0xffffffffu, c, s);
    }
    if (threadIdx.x == 0) {
      out[0] = w;
      out[1] = static_cast<float>(c);
    }
  }
  __syncthreads();
}

// Unit u's output, by final_sum over its lane's partial slots.
__device__ __forceinline__ void close_unit(const WsqLaunch& L, int u,
                                           const float* part, const int* cnt,
                                           float* out, Smem& sm) {
  const int lb = u / L.count;
  const WsqSweep& S = L.s[u - lb * L.count];
  const size_t b = lb;
  final_sum(S, b, S.scal + b * L.scal_ls, part + b * L.part_ls + S.part0,
            cnt + b * L.part_ls + S.part0,
            out + b * L.out_ls + 2 * (u - lb * L.count), sm);
}

// sm.kept[1..units] from each unit's count to its inclusive prefix sum,
// sm.kept[0] = 0.  Up to 32 units (one pair's sweeps, a few lanes'), a
// shuffle scan by warp 0 behind one barrier; more, thread t sums a run
// of consecutive units, a Hillis-Steele scan of the runs, then each
// run's prefix.
__device__ void scan_kept(Smem& sm, int units) {
  if (units <= 32) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int v = lane < units ? sm.kept[lane + 1] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += t;
      }
      if (lane < units) sm.kept[lane + 1] = v;
      if (lane == 0) sm.kept[0] = 0;
    }
    __syncthreads();
    return;
  }
  const int per = (units + THREADS - 1) / THREADS;
  const int u0 = threadIdx.x * per, u1 = min(u0 + per, units);
  int run = 0;
  for (int u = u0; u < u1; ++u) run += sm.kept[u + 1];
  sm.scan[threadIdx.x] = run;
  __syncthreads();
  for (int off = 1; off < THREADS; off <<= 1) {
    const int v = threadIdx.x >= off ? sm.scan[threadIdx.x - off] : 0;
    __syncthreads();
    sm.scan[threadIdx.x] += v;
    __syncthreads();
  }
  int base = threadIdx.x > 0 ? sm.scan[threadIdx.x - 1] : 0;
  for (int u = u0; u < u1; ++u) {
    base += sm.kept[u + 1];
    sm.kept[u + 1] = base;
  }
  if (threadIdx.x == 0) sm.kept[0] = 0;
  __syncthreads();
}

template <bool USE_CK, bool FAST>
__global__ void __launch_bounds__(THREADS)
wsq_kernel(const __grid_constant__ WsqLaunch L,
           const unsigned char* __restrict__ live, float* __restrict__ part,
           int* __restrict__ cnt, int* __restrict__ tickets,
           float* __restrict__ out) {
  __shared__ Smem sm;
  const int units = L.lanes * L.count;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // each unit's kept prefix, a warp a unit; a frozen lane keeps none
  for (int u = warp; u < units; u += WARPS) {
    const int b = u / L.count;
    int k = 0;
    if (live == nullptr || live[b]) {
      const WsqSweep& W = L.s[u - b * L.count];
      if (W.order == nullptr) {
        k = W.n_tiles;
      } else {
        const size_t lb = b;
        k = kept_prefix(W.md_sorted + lb * W.n_tiles, W.n_tiles,
                        keep_thres(W.scal + lb * L.scal_ls), lane);
      }
    }
    if (lane == 0) sm.kept[u + 1] = k;
  }
  if (threadIdx.x == 0) sm.last = -1;
  __syncthreads();
  // a unit that keeps no tile takes no ticket: its output is the
  // parent's sum of +0 partials, written by one block
  for (int u = threadIdx.x; u < units; u += THREADS) {
    if (sm.kept[u + 1] == 0 && u % gridDim.x == blockIdx.x) {
      const int b = u / L.count;
      float* o = out + static_cast<size_t>(b) * L.out_ls +
                 2 * (u - b * L.count);
      o[0] = 0.0f;
      o[1] = 0.0f;
    }
  }
  scan_kept(sm, units);

  // this block's run of the kept tiles laid end to end
  const int total = sm.kept[units];
  const int per = (total + gridDim.x - 1) / gridDim.x;
  const int f0 = blockIdx.x * per, f1 = min(f0 + per, total);
  if (f0 >= f1) return;
  int u = 0;
  while (f0 >= sm.kept[u + 1]) ++u;
  TileRef cur = tile_ref(L, u, tile_id(L, u, f0 - sm.kept[u]));
  TileLoads<USE_CK> ld;
  ld.issue(cur, sm.xt[0]);
  // the id of the tile after the next one is read an iteration ahead
  int nu = u, nid = 0;
  if (f0 + 1 < f1) {
    while (f0 + 1 >= sm.kept[nu + 1]) ++nu;
    nid = tile_id(L, nu, f0 + 1 - sm.kept[nu]);
  }
  int run = 0;  // tiles of the current unit swept since its last ticket
  for (int f = f0; f < f1; ++f) {
    const int buf = (f - f0) & 1;
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    // a unit this block closed on the last tile: its output
    if (sm.last >= 0) {
      close_unit(L, sm.last, part, cnt, out, sm);
      if (threadIdx.x == 0) sm.last = -1;
    }
    // the next tile's loads, under this tile's sweep
    const TileLoads<USE_CK> now = ld;
    TileRef next = cur;
    if (f + 1 < f1) {
      next = tile_ref(L, nu, nid);
      ld.issue(next, sm.xt[buf ^ 1]);
      if (f + 2 < f1) {
        while (f + 2 >= sm.kept[nu + 1]) ++nu;
        nid = tile_id(L, nu, f + 2 - sm.kept[nu]);
      }
    }
    float w;
    int c;
    sweep_tile<USE_CK, FAST>(cur, now, sm.xt[buf], sm, &w, &c);
    ++run;
    if (threadIdx.x == 0) {
      float* part_u = part + cur.b * L.part_ls + cur.S->part0;
      int* cnt_u = cnt + cur.b * L.part_ls + cur.S->part0;
      part_u[cur.id] = w;
      cnt_u[cur.id] = c;
      // the run ends here: take the unit's ticket for all its tiles
      if (f + 1 == f1 || next.u != cur.u) {
        int old;
        asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;\n"
                     : "=r"(old) : "l"(tickets + cur.u), "r"(run)
                     : "memory");
        if (old + run == sm.kept[cur.u + 1] - sm.kept[cur.u]) {
          atomicExch(tickets + cur.u, 0);
          sm.last = cur.u;
        }
      }
    }
    if (f + 1 == f1 || next.u != cur.u) run = 0;
    cur = next;
  }
  __syncthreads();
  if (sm.last >= 0) close_unit(L, sm.last, part, cnt, out, sm);
}

}  // namespace

// sweeps: [count] host array, count <= MAX_SWEEPS, every sweep with ck
// (use_ck) or none, lane 0's pointers of `lanes` lanes (lanes * count
// <= MAX_UNITS); live: [lanes] bytes (0: a frozen lane, not swept) or
// null; scal_ls: floats between two lanes' scalar rows; part / cnt:
// [lanes, part_ls] f32 / i32 scratch, a sweep's slots from its part0;
// tickets: [lanes * count] i32, zero at launch and left zero; out:
// lane b's sweep s at out[b * out_ls + 2 s], wsq then nnz; blocks: the
// grid (ops/wsq.py persistent_grid); fast takes the hardware exp
// (params.exp_mode="fast").
extern "C" int fused_wsq_launch(const WsqSweep* sweeps, int count, int lanes,
                                const unsigned char* live, int scal_ls,
                                float* part, int* cnt, int part_ls,
                                int* tickets, float* out, int out_ls,
                                int use_ck, int fast, int blocks,
                                cudaStream_t stream) {
  if (count < 1 || count > MAX_SWEEPS || lanes < 1 ||
      lanes * count > MAX_UNITS || blocks < 1)
    return cudaErrorInvalidValue;
  WsqLaunch L;
  for (int s = 0; s < count; ++s) L.s[s] = sweeps[s];
  L.count = count;
  L.lanes = lanes;
  L.scal_ls = scal_ls;
  L.part_ls = part_ls;
  L.out_ls = out_ls;
  const auto fn = use_ck ? (fast ? wsq_kernel<true, true>
                                 : wsq_kernel<true, false>)
                         : (fast ? wsq_kernel<false, true>
                                 : wsq_kernel<false, false>);
  fn<<<blocks, THREADS, 0, stream>>>(L, live, part, cnt, tickets, out);
  return static_cast<int>(cudaGetLastError());
}
