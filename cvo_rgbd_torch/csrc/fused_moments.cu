// fused_moments: one sweep of the gated Gram per align iteration, for
// one pair or for the B pairs of a batch in one launch.
//
// Replaces the JAX package's ops/pallas_moments.py:fused_moments
// (_moments_body, A tile from pallas_gram.py:_pair_tile), and its vmap
// over the lanes of parallel/sharded.py:align_batched:
//   Mom[j, k] = sum_i A_ij * Phi[i, k]   (35 monomials of x_i - c0)
//   nnz       = #{(i, j) : A_ij > 0}
// with A_ij gated on d2 < d2_thres, a > sp_thres and the masks (se color
// mode), or A_ij = ci_ij k_ij gated on k >= sp_thres with ci the masked
// linear color weights (MATLAB's linear mode, ck holding ci), and an
// exact AABB skip of (i-tile, j-block) pairs whose lower bound on d2
// exceeds d2_thres + SKIP_MARGIN (such tiles hold only zeros: k < sp_thres
// there too, by a margin far above the fp32 rounding of k and the error of
// the hardware exp, pair_tile.cuh).  Each form is compiled with exp_neg
// and, for params.exp_mode="fast", with __expf (FAST).
//
// Bound on the H100: per pair of a kept tile ~35 fp32 operations (d2,
// exp, gate; 44 more for a recomputed color kernel) and 4 bytes of ck
// when the color kernel is cached, plus the contraction (see
// moment_tile.cuh, which holds the sweep and its design):
//   - one block per item, an (i-tile of 64, j-block of 128) pair, so
//     the few kept tiles of the kd-sorted clouds run side by side on
//     their own SMs; a skipped tile costs one bound compare and writes
//     count 0;
//   - a thread owns one j, its 35 moments in registers, and walks the
//     tile's rows in order (moment_tile.cuh); the ck tile is copied with
//     cp.async beside the i-tile (one wait for the tile's bytes);
//   - a second small kernel, a block per (j-block, 5 moment columns),
//     sums a column's kept tile partials in i-tile order (the skip's own
//     rule picks them: a skipped tile's partial is zero and unwritten)
//     and the int counts.  No float atomics: the sums, and through the
//     gates the iteration counts, are the same from run to run.
// The lane (pair) is grid z of both kernels, as in color_gram.cu: each
// lane reads its own slices of the inputs and writes its own scratch
// slices, so a lane's Mom and nnz are the bits of the one-pair launch on
// it.  A lane whose `live` flag is 0 (a converged lane of the batched
// loop, frozen whatever it gets) sweeps nothing: its tile blocks return
// at entry and its reduce blocks write zeros.
#include <cuda_runtime.h>

#include "moment_tile.cuh"
#include "pair_tile.cuh"

namespace {

using cvo::mt::NMOM;
using cvo::mt::TI;
using cvo::mt::TJ;
constexpr float SKIP_MARGIN = 1e-5f;
// moment columns a thread of the reduce kernel sums
constexpr int KPB = 5;

// The tile kernel's shared memory: the i-tile and, when the color kernel
// or linear ci is cached, its [TI, TJ] tile.
template <bool USE_CK>
struct Smem {
  cvo::mt::Tile T;
  float ck[USE_CK ? TI : 1][TJ];
  int cnt[cvo::mt::NW];
};

// A_ij of the thread's j: se (color kernel cached or recomputed) or
// linear (ck the masked ci), as pair_tile.cuh computes it.
template <bool USE_CK, bool LINEAR, bool FAST>
struct Weight {
  const float (*ck)[TJ];   // the staged ck tile
  float y[3];
  float fy[cvo::NFEAT];
  float ym;
  const float* s;

  __device__ __forceinline__ float operator()(int ii, float4 xi,
                                              const float* fi) const {
    const float d2 = cvo::sqdist3(xi.x, xi.y, xi.z, y[0], y[1], y[2]);
    if constexpr (LINEAR) {
      return cvo::pair_linear<FAST>(d2, ck[ii][threadIdx.x], s);
    } else if constexpr (USE_CK) {
      return cvo::pair_cached<FAST>(d2, ck[ii][threadIdx.x], s);
    } else {
      return cvo::pair_full<FAST>(d2, fi, xi.w, fy, ym, s);
    }
  }
};

// The tile skip: the lower bound on d2 of (i-tile c, j-block jb) beyond
// the gate; no bound, no skip.
__device__ __forceinline__ bool kept_tile(const float* md, const float* scal,
                                          int c, int nbj, int jb) {
  return md == nullptr ||
         !(md[c * nbj + jb] > scal[cvo::S_D2_THRES] + SKIP_MARGIN);
}

// One block per tile: j-block blockIdx.x, i-tile blockIdx.y.  Writes
// the tile's partial and count, or count 0 alone when the skip drops it.
template <bool USE_CK, bool LINEAR, bool FAST>
__global__ void __launch_bounds__(cvo::mt::NT)
moments_tile_kernel(const float* __restrict__ xp,
                    const float* __restrict__ xf,
                    const float* __restrict__ xm,
                    const float* __restrict__ yp,
                    const float* __restrict__ yf,
                    const float* __restrict__ ym,
                    const float* __restrict__ phi,
                    const float* __restrict__ ck,
                    const float* __restrict__ md,
                    const float* __restrict__ scal,
                    const unsigned char* __restrict__ live,
                    float* __restrict__ part, int* __restrict__ cnt_part,
                    int n, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<USE_CK>& S = *reinterpret_cast<Smem<USE_CK>*>(smem);

  // this block's lane: a frozen lane sweeps nothing
  const size_t lane = blockIdx.z;
  if (live != nullptr && !live[lane]) return;
  const int jb = blockIdx.x, ib = blockIdx.y;
  const int nbi = n / TI, nbj = m / TJ;
  const int tid = threadIdx.x;
  xp += lane * n * 3;
  xf += lane * n * cvo::NFEAT;
  xm += lane * n;
  yp += lane * m * 3;
  yf += lane * m * cvo::NFEAT;
  ym += lane * m;
  phi += lane * n * NMOM;
  if (ck != nullptr) ck += lane * n * m;
  if (md != nullptr) md += lane * nbi * nbj;
  scal += lane * cvo::N_SCAL;
  part += lane * nbi * NMOM * m;
  cnt_part += lane * nbi * nbj;
  int* count = cnt_part + ib * nbj + jb;
  // block-uniform: every thread takes the same branch
  if (!kept_tile(md, scal, ib, nbj, jb)) {
    if (tid == 0) *count = 0;
    return;
  }
  const int i0 = ib * TI, j0 = jb * TJ;
  cvo::mt::stage_begin(S.T, xp, xf, xm, phi, i0, !USE_CK && !LINEAR);
  if constexpr (USE_CK) {
    // the [TI, TJ] ck tile in 16-byte pieces (ck is 16-byte aligned: the
    // wrapper checks)
    const float* src = ck + static_cast<size_t>(i0) * m + j0;
    for (int t = tid; t < TI * TJ / 4; t += cvo::mt::NT) {
      const int r = t / (TJ / 4), c = 4 * (t % (TJ / 4));
      cvo::mt::cp_async16(&S.ck[r][c], src + static_cast<size_t>(r) * m + c);
    }
  }
  Weight<USE_CK, LINEAR, FAST> w;
  w.ck = S.ck;
  w.s = scal;
  {
    const int j = j0 + tid;
    for (int r = 0; r < 3; ++r) w.y[r] = yp[3 * j + r];
    if constexpr (!USE_CK) {
      for (int c = 0; c < cvo::NFEAT; ++c) w.fy[c] = yf[cvo::NFEAT * j + c];
      w.ym = ym[j];
    }
  }
  cvo::mt::stage_end();
  float acc[NMOM];
#pragma unroll
  for (int k = 0; k < NMOM; ++k) acc[k] = 0.0f;
  int cnt = cvo::mt::sweep(S.T, w, acc);
  cvo::mt::store(acc, part + static_cast<size_t>(ib) * NMOM * m, m, j0);

  // integer block count: exact in any order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if ((tid & 31) == 0) S.cnt[tid >> 5] = cnt;
  __syncthreads();
  if (tid == 0) {
    int tot = 0;
    for (int v = 0; v < cvo::mt::NW; ++v) tot += S.cnt[v];
    *count = tot;
  }
}

// Block (jb, g, lane): one thread per j of j-block jb sums KPB moment
// columns from g * KPB over the kept tiles in i-tile order; block
// (0, 0, lane) also sums every item's count.  A frozen lane's blocks
// write zeros.
__global__ void __launch_bounds__(cvo::mt::NT)
moments_reduce_kernel(const float* __restrict__ part,
                      const int* __restrict__ cnt_part,
                      const float* __restrict__ md,
                      const float* __restrict__ scal,
                      const unsigned char* __restrict__ live,
                      float* __restrict__ mom, float* __restrict__ nnz, int m,
                      int nbi) {
  __shared__ cvo::mt::ColumnScratch cs;
  __shared__ long long s_tot[cvo::mt::NW];
  const size_t lane = blockIdx.z;
  const int nbj = m / TJ, jb = blockIdx.x;
  const int j = jb * TJ + threadIdx.x;
  const int k0 = blockIdx.y * KPB;
  mom += lane * m * NMOM;
  nnz += lane;
  // block-uniform: every thread takes the same branch
  if (live != nullptr && !live[lane]) {
#pragma unroll
    for (int k = 0; k < KPB; ++k)
      if (k0 + k < NMOM) mom[static_cast<size_t>(j) * NMOM + k0 + k] = 0.0f;
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) nnz[0] = 0.0f;
    return;
  }
  part += lane * nbi * NMOM * m;
  cnt_part += lane * nbi * nbj;
  if (md != nullptr) md += lane * nbi * nbj;
  scal += lane * cvo::N_SCAL;
  float sum[KPB];
#pragma unroll
  for (int k = 0; k < KPB; ++k) sum[k] = 0.0f;
  cvo::mt::column_sum(
      part, nbi, m, j, k0,
      [=](int c) { return kept_tile(md, scal, c, nbj, jb); }, cs, sum);
#pragma unroll
  for (int k = 0; k < KPB; ++k)
    if (k0 + k < NMOM) mom[static_cast<size_t>(j) * NMOM + k0 + k] = sum[k];
  if (blockIdx.x != 0 || blockIdx.y != 0) return;
  long long tot = 0;
  for (int c = threadIdx.x; c < nbi * nbj; c += cvo::mt::NT)
    tot += cnt_part[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    tot += __shfl_down_sync(0xffffffffu, tot, off);
  if ((threadIdx.x & 31) == 0) s_tot[threadIdx.x >> 5] = tot;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int v = 1; v < cvo::mt::NW; ++v) tot += s_tot[v];
    nnz[0] = static_cast<float>(tot);
  }
}

template <bool USE_CK, bool LINEAR, bool FAST>
cudaError_t launch_tiles(dim3 grid, cudaStream_t stream, const float* xp,
                         const float* xf, const float* xm, const float* yp,
                         const float* yf, const float* ym, const float* phi,
                         const float* ck, const float* md, const float* scal,
                         const unsigned char* live, float* part,
                         int* cnt_part, int n, int m) {
  const auto fn = moments_tile_kernel<USE_CK, LINEAR, FAST>;
  const int bytes = sizeof(Smem<USE_CK>);
  // above 48 KB only after opting in
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  fn<<<grid, cvo::mt::NT, bytes, stream>>>(xp, xf, xm, yp, yf, ym, phi, ck,
                                           md, scal, live, part, cnt_part, n,
                                           m);
  return cudaGetLastError();
}

using TileLaunch = decltype(&launch_tiles<false, false, false>);

// The tile kernel's launch for the color mode: linear (ck the ci), se
// with the cached color kernel, or se recomputing it.
template <bool FAST>
TileLaunch tile_launchers(int linear, bool use_ck) {
  if (linear) return launch_tiles<true, true, FAST>;
  return use_ck ? launch_tiles<true, false, FAST>
                : launch_tiles<false, false, FAST>;
}

}  // namespace

// For b lanes (b = 1: one pair), each input with a leading lane axis of
// b, contiguous: xp [b, n, 3], xf [b, n, 5], xm [b, n], yp/yf/ym the
// same at m, phi [b, n, 35], ck [b, n, m], md [b, n / 64, m / 128],
// scal [b, 8]; live [b] bytes (0: a frozen lane) or null (every lane
// live).  part: [b, n / 64, 35, m] f32 scratch, one slot per kept tile;
// cnt_part: [b, n / 64, m / 128] i32 scratch; mom: [b, m, 35] f32;
// nnz: [b] f32.  ck or md may be null; linear mode needs ck (the masked
// ci).  fast takes the hardware exp (params.exp_mode="fast").  b is grid
// z: at most 65535 lanes.
extern "C" int fused_moments_launch(
    const float* xp, const float* xf, const float* xm, const float* yp,
    const float* yf, const float* ym, const float* phi, const float* ck,
    const float* md, const float* scal, const unsigned char* live,
    float* part, int* cnt_part, float* mom, float* nnz, int n, int m,
    int linear, int fast, int b, cudaStream_t stream) {
  if (b < 1 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(m / TJ, n / TI, b);
  if (linear && ck == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const TileLaunch fn = fast ? tile_launchers<true>(linear, ck != nullptr)
                            : tile_launchers<false>(linear, ck != nullptr);
  const cudaError_t err = fn(grid, stream, xp, xf, xm, yp, yf, ym, phi, ck,
                             md, scal, live, part, cnt_part, n, m);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 rgrid(m / TJ, (NMOM + KPB - 1) / KPB, b);
  moments_reduce_kernel<<<rgrid, cvo::mt::NT, 0, stream>>>(
      part, cnt_part, md, scal, live, mom, nnz, m, n / TI);
  return static_cast<int>(cudaGetLastError());
}
