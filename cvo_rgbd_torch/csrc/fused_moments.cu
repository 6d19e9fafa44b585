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
// when the color kernel is cached, plus the contraction (35 FMAs where
// the pair passes the gate).  Two regimes: one pair keeps a few dozen
// tiles, each on its own SM, and waits on a tile's chain of rows; a
// batch (the lane axis) keeps a thousand or more, five blocks an SM,
// and is bound by the SM's instruction issue.  The design:
//   - one block per item, an (i-tile of 64, j-block of 128) pair; a
//     skipped tile costs one bound compare and writes count 0;
//   - a thread owns one j, its 35 moments in registers, and walks the
//     tile's rows in order, one fused multiply-add a moment where the
//     weight is not zero: a tile's partial is the bits of the
//     moment_tile.cuh sweep it replaced (that of align_fused.cu);
//   - the staged Phi rows are padded to 36 floats, so that a row's 35
//     coefficients are 9 16-byte shared loads, broadcast to the warp
//     (the 140-byte rows took 35 4-byte loads: as many shared loads as
//     FMAs, a third of the row's instructions);
//   - the weights of RG rows are computed before their FMAs: RG
//     independent exp chains in flight, where one row's chain left the
//     one-pair tile waiting ~100 cycles a row; none at all where every
//     pair of the RG rows and the warp's 32 j lies beyond the gate (the
//     weights are zero there, as the tile skip has it for whole tiles);
//     the scalar row is read into registers once (the gate's sp_thres
//     was a global load inside the row loop);
//   - the ck tile is copied with cp.async beside the i-tile (one wait
//     for the tile's bytes);
//   - a second small kernel, a block per 32 j of a lane (a warp per 7
//     moments), sums a column's kept tile partials in i-tile order (the
//     skip's own rule picks them: a skipped tile's partial is zero and
//     unwritten), the loads of U tiles issued before their adds, and
//     stores its 32 rows of Mom as one contiguous run (one block's
//     scattered 20-byte pieces of rows cost a 32-byte sector each);
//     block 0 sums the int counts, their loads issued first.  No float
//     atomics: the sums, and through the gates the iteration counts, are
//     the same from run to run.
// moment_tile.cuh keeps the align kernel's sweep as it was: its tiles
// run inside one cooperative launch whose shared memory and registers
// its other phases size, and its bits are held in turns on their own.
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
using cvo::mt::NT;
using cvo::mt::NW;
constexpr float SKIP_MARGIN = 1e-5f;
// a staged Phi row: 35 floats padded to 9 float4
constexpr int PHI_Q = (NMOM + 3) / 4;
// rows whose weights are computed before their FMAs
constexpr int RG = 4;
// kept tiles whose partials the reduce loads before adding them
constexpr int U = 4;

// The tile kernel's shared memory: the i-tile (Phi rows padded, x and
// the mask, the features) and, when the color kernel or linear ci is
// cached, its [TI, TJ] tile.
template <bool USE_CK>
struct Smem {
  float4 phi[TI][PHI_Q];
  float4 x[TI];           // x0, x1, x2, mask
  alignas(16) float ck[USE_CK ? TI : 1][TJ];
  float f[USE_CK ? 1 : TI][cvo::NFEAT];
  int cnt[NW];
};

// A_ij of the thread's j: se (color kernel cached or recomputed) or
// linear (ck the masked ci), as pair_tile.cuh computes it, from the
// pair's d2; `s` the scalar row in registers.
template <bool USE_CK, bool LINEAR, bool FAST>
struct Weight {
  const float (*ck)[TJ];   // the staged ck tile
  float y[3];
  float fy[cvo::NFEAT];
  float ym;
  float s[cvo::N_SCAL];

  __device__ __forceinline__ float dist(float4 xi) const {
    return cvo::sqdist3(xi.x, xi.y, xi.z, y[0], y[1], y[2]);
  }

  // whether the pair may pass the gate: beyond it A is zero (in linear
  // mode, where no d2 gate applies, beyond d2_thres + SKIP_MARGIN, where
  // k is far below sp_thres: the tile skip's own argument)
  __device__ __forceinline__ bool near(float d2) const {
    return LINEAR ? d2 <= s[cvo::S_D2_THRES] + SKIP_MARGIN
                  : d2 < s[cvo::S_D2_THRES];
  }

  __device__ __forceinline__ float at(int ii, float d2, float4 xi,
                                      const float* fi) const {
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

// The sweep of a staged tile for the thread's j: acc[k] += A_ij Phi[i, k]
// over the tile's rows in order, one fused multiply-add each, where the
// weight is not zero; returns the count of A > 0.  The weights of RG
// rows are computed together, and not at all where every pair of the
// RG rows and the warp's 32 j lies beyond the gate (all zero).
template <bool USE_CK, class W>
__device__ __forceinline__ int sweep(const Smem<USE_CK>& S, const W& weight,
                                     float (&acc)[NMOM]) {
  int cnt = 0;
  for (int i0 = 0; i0 < TI; i0 += RG) {
    float d2[RG];
    bool near = false;
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      d2[r] = weight.dist(S.x[i0 + r]);
      near |= weight.near(d2[r]);
    }
    if (!__any_sync(0xffffffffu, near)) continue;
    float w[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r)
      w[r] = weight.at(i0 + r, d2[r], S.x[i0 + r],
                       S.f[USE_CK ? 0 : i0 + r]);
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      // a linear weight may be negative: it enters the moments, and
      // only w > 0 is counted
      if (w[r] != 0.0f) {
        cnt += w[r] > 0.0f;
        const float4* p = S.phi[i0 + r];
#pragma unroll
        for (int q = 0; q < PHI_Q; ++q) {
          const float4 v = p[q];
          const float c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * q + e < NMOM)
              acc[4 * q + e] = fmaf(w[r], c[e], acc[4 * q + e]);
        }
      }
    }
  }
  return cnt;
}

// One block per tile: j-block blockIdx.x, i-tile blockIdx.y.  Writes
// the tile's partial and count, or count 0 alone when the skip drops it.
template <bool USE_CK, bool LINEAR, bool FAST>
__global__ void __launch_bounds__(NT)
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
  constexpr bool FEAT = !USE_CK && !LINEAR;

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
  // the tile's Phi rows (4-byte copies into the padded rows), x, the
  // mask and, recomputing the color kernel, the features
  {
    const float* src = phi + static_cast<size_t>(i0) * NMOM;
    for (int t = tid; t < TI * NMOM; t += NT) {
      const int r = t / NMOM;
      cvo::mt::cp_async4(reinterpret_cast<float*>(S.phi[r]) + (t - r * NMOM),
                         src + t);
    }
    for (int t = tid; t < TI * 3; t += NT)
      cvo::mt::cp_async4(reinterpret_cast<float*>(&S.x[t / 3]) + t % 3,
                         xp + 3 * i0 + t);
    for (int t = tid; t < TI; t += NT)
      cvo::mt::cp_async4(reinterpret_cast<float*>(&S.x[t]) + 3, xm + i0 + t);
    if constexpr (FEAT)
      for (int t = tid; t < TI * cvo::NFEAT; t += NT)
        cvo::mt::cp_async4(&S.f[0][0] + t, xf + cvo::NFEAT * i0 + t);
  }
  if constexpr (USE_CK) {
    // the [TI, TJ] ck tile in 16-byte pieces (ck is 16-byte aligned: the
    // wrapper checks)
    const float* src = ck + static_cast<size_t>(i0) * m + j0;
    for (int t = tid; t < TI * TJ / 4; t += NT) {
      const int r = t / (TJ / 4), c = 4 * (t % (TJ / 4));
      cvo::mt::cp_async16(&S.ck[r][c], src + static_cast<size_t>(r) * m + c);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  Weight<USE_CK, LINEAR, FAST> w;
  w.ck = S.ck;
#pragma unroll
  for (int k = 0; k < cvo::N_SCAL; ++k) w.s[k] = scal[k];
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
  int cnt = sweep(S, w, acc);
  cvo::mt::store(acc, part + static_cast<size_t>(ib) * NMOM * m, m, j0);

  // integer block count: exact in any order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if ((tid & 31) == 0) S.cnt[tid >> 5] = cnt;
  __syncthreads();
  if (tid == 0) {
    int tot = 0;
    for (int v = 0; v < NW; ++v) tot += S.cnt[v];
    *count = tot;
  }
}

// The reduce kernel: a block per 32 j of a lane, warp g summing the RK
// moments from RK g of its 32 j, so that the block's output is 32
// whole rows of Mom, one contiguous run it stores in 16-byte pieces.
constexpr int RJ = 32;
constexpr int RK = 7;
constexpr int RW = NMOM / RK;
constexpr int RT = RJ * RW;
static_assert(RW * RK == NMOM, "the reduce warps split the moments");
// counts a thread of block 0 loads before the column sum
constexpr int CU = 8;

struct ReduceScratch {
  int list[RT];   // kept i-tiles of a window of RT, in order
  int warp[RW];
  int n;
  alignas(16) float out[RJ * NMOM];
  long long tot[RW];
};

// Block (j0 / RJ, 0, lane): thread (jl, g) sums moments RK g .. RK g +
// RK - 1 of j = j0 + jl over the kept tiles of j's j-block in i-tile
// order (the skip's own rule picks them: a skipped tile's partial is
// zero and unwritten), the loads of U tiles issued before any is added:
// each sum the bits of the one-block-a-column sum it replaced.  Block
// (0, 0, lane) also sums every item's count, its loads issued first.  A
// frozen lane's blocks write zeros.
__global__ void __launch_bounds__(RT)
moments_reduce_kernel(const float* __restrict__ part,
                      const int* __restrict__ cnt_part,
                      const float* __restrict__ md,
                      const float* __restrict__ scal,
                      const unsigned char* __restrict__ live,
                      float* __restrict__ mom, float* __restrict__ nnz, int m,
                      int nbi) {
  __shared__ ReduceScratch rs;
  const size_t lane = blockIdx.z;
  const int nbj = m / TJ;
  const int j0 = blockIdx.x * RJ, jb = j0 / TJ;
  const int jl = threadIdx.x % RJ, g = threadIdx.x / RJ;
  const int j = j0 + jl, k0 = g * RK;
  float* out = mom + lane * m * NMOM + static_cast<size_t>(j0) * NMOM;
  nnz += lane;
  // block-uniform: every thread takes the same branch
  if (live != nullptr && !live[lane]) {
    for (int t = threadIdx.x; t < RJ * NMOM; t += RT) out[t] = 0.0f;
    if (blockIdx.x == 0 && threadIdx.x == 0) nnz[0] = 0.0f;
    return;
  }
  part += lane * nbi * NMOM * m;
  cnt_part += lane * nbi * nbj;
  if (md != nullptr) md += lane * nbi * nbj;
  scal += lane * cvo::N_SCAL;
  const bool counts = blockIdx.x == 0;
  const int items = nbi * nbj;
  int cv[CU];
  if (counts) {
#pragma unroll
    for (int q = 0; q < CU; ++q) {
      const int c = threadIdx.x + q * RT;
      cv[q] = c < items ? __ldcg(cnt_part + c) : 0;
    }
  }
  float sum[RK];
#pragma unroll
  for (int k = 0; k < RK; ++k) sum[k] = 0.0f;
  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c0 = 0; c0 < nbi; c0 += RT) {
    // this window's kept tiles, compacted in order
    const int c = c0 + threadIdx.x;
    const bool keep = c < nbi && kept_tile(md, scal, c, nbj, jb);
    const unsigned bits = __ballot_sync(0xffffffffu, keep);
    __syncthreads();  // the last window's list is consumed
    if (wl == 0) rs.warp[warp] = __popc(bits);
    __syncthreads();
    int at = __popc(bits & ((1u << wl) - 1u));
    for (int w = 0; w < warp; ++w) at += rs.warp[w];
    if (keep) rs.list[at] = c;
    if (threadIdx.x == 0) {
      int n = 0;
      for (int w = 0; w < RW; ++w) n += rs.warp[w];
      rs.n = n;
    }
    __syncthreads();
    const int n = rs.n;
    for (int q0 = 0; q0 < n; q0 += U) {
      float v[U][RK];
#pragma unroll
      for (int q = 0; q < U; ++q) {
        // past the list: a kept tile's slot again, loaded and not added
        const float* p =
            part + (static_cast<size_t>(rs.list[min(q0 + q, n - 1)]) * NMOM +
                    k0) * m + j;
#pragma unroll
        for (int k = 0; k < RK; ++k) v[q][k] = __ldcg(p + k * m);
      }
#pragma unroll
      for (int q = 0; q < U; ++q)
        if (q0 + q < n) {
#pragma unroll
          for (int k = 0; k < RK; ++k) sum[k] += v[q][k];
        }
    }
  }
#pragma unroll
  for (int k = 0; k < RK; ++k) rs.out[jl * NMOM + k0 + k] = sum[k];
  __syncthreads();
  // the block's 32 rows are one run of 1120 floats (16-byte aligned: m
  // and j0 are multiples of 32)
  const float4* src = reinterpret_cast<const float4*>(rs.out);
  float4* dst = reinterpret_cast<float4*>(out);
  for (int t = threadIdx.x; t < RJ * NMOM / 4; t += RT) dst[t] = src[t];
  if (!counts) return;
  long long tot = 0;
#pragma unroll
  for (int q = 0; q < CU; ++q) tot += cv[q];
  for (int c = threadIdx.x + CU * RT; c < items; c += RT)
    tot += __ldcg(cnt_part + c);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    tot += __shfl_down_sync(0xffffffffu, tot, off);
  if (wl == 0) rs.tot[warp] = tot;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < RW; ++w) tot += rs.tot[w];
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
  fn<<<grid, NT, bytes, stream>>>(xp, xf, xm, yp, yf, ym, phi, ck, md, scal,
                                  live, part, cnt_part, n, m);
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
  const dim3 rgrid(m / RJ, 1, b);
  moments_reduce_kernel<<<rgrid, RT, 0, stream>>>(
      part, cnt_part, md, scal, live, mom, nnz, m, n / TI);
  return static_cast<int>(cudaGetLastError());
}
